#!/usr/bin/env python3
"""Smoke test of smelter_tpu_torch, the PyTorch/CUDA port, on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA H100, the CUDA
toolkit (`nvcc`) and PyTorch built for CUDA. It imports nothing of JAX and
nothing of the JAX package. Phases, each printing a line that starts with
its number:

1. environment: the card's name and power limit, torch and CUDA versions,
   and the build of every kernel from `smelter_tpu_torch/csrc/`, all
   `nvcc` processes at once;
2. kernels against their plain PyTorch versions on the card, at the
   ResNet-50 head shape and at a serving GEMM shape, with their device
   times (CUDA-graph replay of many launches), the host cost of one call,
   the plain versions' times, a PyTorch library call's time as a
   yardstick, and the least time the card could take (the bound);
3. the main path at full width: ResNet-50 (batch 128, 224 px, random
   weights from a seed) exported to ONNX bytes with the port's writer,
   loaded back, and run through `compile(..., quant="int8")` on the card in
   f32, bf16 and bf16 with int8 activations, checked against the port's CPU
   run of the same graph, timed in images/s;
4. the server: `serve(..., max_batch=16)` answers 32 threaded requests.

Every kernel wrapper counts its launches. Each path (bf16, bf16 with int8
activations, the server) sets the counts to 0 just before it compiles and
runs, reads them just after, and must have launched the kernel it routes
to and no other. The last three lines are the kernels' JSON line, the card's name and power
limit, and `{"ok": true, "device": {...}}`. Any failed check exits non-zero
before those lines. A JSON report of every number goes to
`build/chip_smoke/report.json`.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit.
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
FULL_POWER_W = 700.0
L2_BYTES = 50 * 2**20

HEAD = (128, 2048, 1000)          # ResNet-50 classifier at batch 128 (M, K, N)
SERVING = (8192, 4096, 4096)      # serving GEMM (M, K, N)

REPORT: dict = {}


class SmokeError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def say(phase, text: str) -> None:
    print(f"[{phase}] {text}", flush=True)


def bound(nbytes: float, ops: float, kind: str, power_w: float):
    """Least time (ms) for the work: bytes over HBM rate vs operations over
    the peak rate of their type, the peak scaled down by a lower power
    limit. Returns (ms, "bytes" | "operations")."""
    t_mem = nbytes / HBM_BYTES_S
    t_ops = ops / PEAK_OPS_S[kind] * max(1.0, FULL_POWER_W / power_w)
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops else "operations")


def time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean time of fn(i) over `iters` calls issued from Python, by CUDA
    events: the device time where a call outlasts its launch, else the
    host's cost of a call."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, side, fn, iters: int, replays: int = 5) -> float:
    """Mean device time of fn(i), from replays of one CUDA graph that holds
    `iters` calls, so that no host launch cost stands between them. `side`
    is the stream the graph is captured on; one for all graphs, so that
    cuBLAS keeps one workspace for them."""
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for i in range(iters):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (iters * replays)
    del graph
    return ms


# -- phase 1 ---------------------------------------------------------------

def phase_environment(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    power_w = float(smi.split(",")[-1].strip().split()[0])
    from smelter_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build()
    build_s = time.perf_counter() - t0
    REPORT["environment"] = {"nvidia_smi": smi, "power_limit_w": power_w,
                             "torch": torch.__version__, "cuda": torch.version.cuda,
                             "device": torch.cuda.get_device_name(0),
                             "build_s": build_s, "ptxas": logs}
    say(1, f"card: {smi} | torch {torch.__version__} CUDA {torch.version.cuda} | "
           f"kernels built in {build_s:.1f} s ({', '.join(logs) or 'already built'})")
    return smi, power_w


# -- phase 2 ---------------------------------------------------------------

def _copies(nbytes: int) -> int:
    """Operand sets to rotate through so that no launch finds its operands
    in the 50 MB L2 cache."""
    return max(1, math.ceil(2 * L2_BYTES / nbytes))


def phase_kernels(torch, power_w: float) -> dict:
    from smelter_tpu_torch.kernels import dequant_matmul as dm
    from smelter_tpu_torch.kernels import int8_matmul as im

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    side = torch.cuda.Stream()
    rows = {}
    for label, (M, K, N) in (("head", HEAD), ("serving", SERVING)):
        iters = 50 if label == "head" else 10

        def operands(dtype):
            per_call = M * K * 2 + K * N + N * 4 + M * N * 2
            sets = []
            for _ in range(_copies(per_call)):
                x = torch.randn(M, K, device="cuda", generator=gen).to(dtype)
                w = torch.randint(-127, 128, (K, N), device="cuda", generator=gen,
                                  dtype=torch.int8)
                s = torch.rand(N, device="cuda", generator=gen) * 0.02 + 1e-3
                sets.append((x, w, s))
            return sets

        # dequant_matmul, bf16 (the main path's type) and f32
        for dtype, kind, rel in ((torch.bfloat16, "bf16", 1e-2), (torch.float32, "f32", 1e-5)):
            sets = operands(dtype)
            x, w, s = sets[0]
            got = dm.dequant_matmul(x, w, s)
            ref = dm.dequant_matmul_plain(x, w, s)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            check(got.dtype == dtype and got.shape == (M, N), "dequant_matmul output")
            check(math.isfinite(err) and err <= rel * scale,
                  f"dequant_matmul {label} {kind}: max-abs {err} > {rel} x {scale}")
            n = len(sets)
            ms = graph_ms(torch, side, lambda i: dm.dequant_matmul(*sets[i % n]), iters)
            call_ms = time_ms(torch, lambda i: dm.dequant_matmul(*sets[i % n]), iters)
            plain_ms = graph_ms(torch, side, lambda i: dm.dequant_matmul_plain(*sets[i % n]),
                                iters)
            w_deq = [(w_.float() * s_).to(dtype) for _, w_, s_ in sets]
            lib_ms = graph_ms(torch, side, lambda i: torch.matmul(sets[i % n][0], w_deq[i % n]),
                              iters)
            nbytes = M * K * x.element_size() + K * N + N * 4 + M * N * x.element_size()
            b_ms, b_by = bound(nbytes, 2 * M * N * K, kind, power_w)
            rows[("dequant_matmul", label, kind)] = dict(
                name="dequant_matmul", shape=[M, K, N], dtype=kind, max_abs_err=err,
                tolerance=f"{rel} x max|plain| = {rel * scale:.4g}", ms=ms, call_ms=call_ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
            del sets, w_deq

        # int8_matmul on quantize_rows of bf16 activations, bf16 out
        sets = []
        for x, w, s in operands(torch.bfloat16):
            xq, sr = im.quantize_rows(x)
            sets.append((xq, w, sr, s))
        xq, w, sr, s = sets[0]
        acc = im.int8_matmul(xq, w, sr, s, out_dtype=torch.int32)
        check(torch.equal(acc, im.int8_matmul_plain(xq, w, sr, s, out_dtype=torch.int32)),
              f"int8_matmul {label}: int32 sums differ from the plain version")
        got = im.int8_matmul(xq, w, sr, s, out_dtype=torch.bfloat16)
        ref = im.int8_matmul_plain(xq, w, sr, s, out_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        check(torch.equal(got, ref), f"int8_matmul {label}: outputs differ ({err})")
        n = len(sets)
        ms = graph_ms(torch, side, lambda i: im.int8_matmul(*sets[i % n]), iters)
        call_ms = time_ms(torch, lambda i: im.int8_matmul(*sets[i % n]), iters)
        plain_ms = graph_ms(torch, side, lambda i: im.int8_matmul_plain(*sets[i % n]), iters)
        w_cm = [w_.t().contiguous().t() for _, w_, _, _ in sets]  # column-major for cuBLASLt

        def int_mm(i):
            xq_, _, sr_, s_ = sets[i % n]
            return (torch._int_mm(xq_, w_cm[i % n]).float() * sr_ * s_).to(torch.bfloat16)

        lib_ms = graph_ms(torch, side, int_mm, iters)
        nbytes = M * K + K * N + M * 4 + N * 4 + M * N * 2
        b_ms, b_by = bound(nbytes, 2 * M * N * K, "int8", power_w)
        rows[("int8_matmul", label, "int8")] = dict(
            name="int8_matmul", shape=[M, K, N], dtype="int8->bf16", max_abs_err=err,
            tolerance="int32 sums exact, outputs equal", ms=ms, call_ms=call_ms,
            plain_ms=plain_ms,
            library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
        del sets, w_cm

    for (name, label, kind), r in rows.items():
        say(2, f"{name} {label} {r['shape']} {kind}: err {r['max_abs_err']:.3g} "
               f"({r['tolerance']}) | kernel {r['ms']:.4f} ms (host cost of a call "
               f"{r['call_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, "
               f"library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
               f"({r['bound_by']}) = {100 * r['bound_ms'] / r['ms']:.1f}% of bound")
    REPORT["kernels_vs_plain"] = [dict(r, case=f"{k[1]}/{k[2]}") for k, r in rows.items()]
    return rows


# -- phase 3 ---------------------------------------------------------------

def _top1(a, b) -> float:
    return float((a.argmax(1) == b.argmax(1)).mean())


def _profile(torch, model, xg) -> dict:
    """Device time by kernel over three forwards (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            model.run_device(xg)
        torch.cuda.synchronize()
    kernels, ops = {}, {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        if not t or t <= 0:
            continue
        # A kernel's time shows on its own entry and again on the host op
        # that launched it: keep the two apart.
        side = kernels if str(getattr(e, "device_type", "")).endswith("CUDA") else ops
        side[e.key] = side.get(e.key, 0.0) + t / 3e3  # us over 3 steps -> ms a step
    return kernels, ops


def _counts() -> dict:
    from smelter_tpu_torch.kernels import dequant_matmul as dm
    from smelter_tpu_torch.kernels import int8_matmul as im

    return {"dequant_matmul": dm.launches, "int8_matmul": im.launches}


def _zero_counts() -> None:
    from smelter_tpu_torch.kernels import dequant_matmul as dm
    from smelter_tpu_torch.kernels import int8_matmul as im

    dm.launches = im.launches = 0


def _check_routed(label: str, counts: dict, routed: str) -> None:
    """The path launched the kernel it routes to, and no other."""
    check(counts[routed] > 0, f"{label}: {routed} never launched ({counts})")
    check(all(n == 0 for k, n in counts.items() if k != routed),
          f"{label}: a kernel other than {routed} launched ({counts})")


def phase_main(torch, np, stt) -> dict:
    from smelter_tpu_torch.models import resnet50

    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    onnx_path = out_dir / "resnet50_b128.onnx"
    t0 = time.perf_counter()
    g, _module, shape = resnet50.build(batch=128, image_size=224)
    stt.save_model(g, onnx_path)  # the port's wire writer
    export_s = time.perf_counter() - t0
    check(stt.load_model(onnx_path).initializers.keys() == g.initializers.keys(),
          "ONNX bytes do not load back")
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    say(3, f"ResNet-50 {shape} exported and loaded back in {export_s:.1f} s "
           f"({onnx_path.stat().st_size / 1e6:.1f} MB)")
    res: dict = {"export_s": export_s}

    # f32 at batch 8 against the port's CPU run, TF32 off everywhere
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu32 = stt.compile(onnx_path, stt.Config(), quant="int8", device="cpu")
    gpu32 = stt.compile(onnx_path, stt.Config(), quant="int8", device="cuda")
    ref8, got8 = cpu32(x[:8])[0], gpu32(x[:8])[0]
    err = float(np.abs(got8 - ref8).max())
    scale = float(np.abs(ref8).max())
    check(got8.shape == (8, 1000) and np.isfinite(got8).all(), "f32 logits")
    # cuDNN and the CPU sum in other orders through 53 convolutions: 1e-3.
    check(err <= 1e-3 * scale, f"f32 logits: max-abs {err} > 1e-3 x {scale}")
    say(3, f"f32 batch 8 vs CPU: max-abs {err:.3g} (bound 1e-3 x {scale:.3g})")
    res["f32_b8"] = {"max_abs_err": err, "max_abs_ref": scale}
    t0 = time.perf_counter()
    ref = cpu32(x)[0]
    say(3, f"CPU f32 reference at batch 128 in {time.perf_counter() - t0:.1f} s")
    torch.backends.cudnn.allow_tf32 = True
    del gpu32

    xg = torch.from_numpy(x).cuda()
    for label, cfg, routed in (
            ("bf16", stt.Config(compute_dtype="bfloat16"), "dequant_matmul"),
            ("bf16_int8act", stt.Config(compute_dtype="bfloat16", int8_activations=True),
             "int8_matmul")):
        _zero_counts()
        model = stt.compile(onnx_path, cfg, quant="int8", device="cuda")
        got = model(x)[0]
        launches = _counts()
        _check_routed(label, launches, routed)
        check(got.shape == (128, 1000) and np.isfinite(got).all(), f"{label} logits")
        agree = _top1(got, ref)
        top2 = np.sort(ref, axis=1)[:, -2:]
        gap = float(np.median(top2[:, 1] - top2[:, 0]))
        err = float(np.abs(got - ref).max())
        check(agree >= 0.99, f"{label}: top-1 agreement {agree} < 0.99")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_ms = time_ms(torch, lambda i: model.run_device(xg), 20)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        per, by_op = _profile(torch, model, xg)
        busy = sum(per.values())
        ours = {k: v for k, v in per.items() if "dequant_matmul" in k or "int8_matmul" in k}
        top = sorted(per.items(), key=lambda kv: -kv[1])[:8]
        top_ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:8]
        r = {"launches": launches, "top1_vs_cpu_f32": agree, "max_abs_vs_cpu_f32": err,
             "median_top2_gap": gap, "step_ms": step_ms, "images_per_s": 128e3 / step_ms, "peak_mem_gb": peak_gb,
             "device_busy_ms": busy, "idle_share": max(0.0, 1 - busy / step_ms),
             "port_kernel_ms": ours, "port_kernel_share": sum(ours.values()) / step_ms,
             "top_kernels_ms": top, "top_host_ops_ms": top_ops}
        res[label] = r
        say(3, f"{label} batch 128: launches in compile + one forward {launches} | "
               f"top-1 vs CPU f32 {agree:.4f} (median top-2 gap {gap:.3g}, "
               f"max-abs {err:.3g}) | {r['images_per_s']:.1f} images/s, step {step_ms:.3f} ms, "
               f"peak {peak_gb:.2f} GB | port kernels {sum(ours.values()):.4f} ms = "
               f"{100 * r['port_kernel_share']:.3f}% of the step | profiled busy {busy:.3f} ms")
        say(3, "  device ms a step by host op: "
               + "; ".join(f"{k} {v:.3f}" for k, v in top_ops))
        del model
    return res


# -- phase 4 ---------------------------------------------------------------

def phase_serve(torch, np, stt) -> dict:
    onnx_path = ROOT / "build" / "chip_smoke" / "resnet50_b128.onnx"
    cfg = stt.Config(compute_dtype="bfloat16")
    xs = np.random.default_rng(1).standard_normal((32, 3, 224, 224)).astype(np.float32)
    direct = stt.compile(onnx_path, cfg, quant="int8", device="cuda")(xs)[0]
    _zero_counts()
    server = stt.serve(onnx_path, cfg, quant="int8", device="cuda", max_batch=16)
    results = [None] * len(xs)
    try:
        check(server.wait_ready(600), "server buckets did not warm up")
        def ask(i):
            results[i] = server.infer(xs[i])[0]

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(len(xs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        stats = server.stats()
    finally:
        server.shutdown()
    launches = _counts()
    _check_routed("server", launches, "dequant_matmul")
    check(all(r is not None for r in results), "server left requests unanswered")
    got = np.stack(results)
    err = float(np.abs(got - direct).max())
    scale = float(np.abs(direct).max())
    agree = _top1(got, direct)
    check(stats["requests"] == 32 and stats["errors"] == 0, f"server stats {stats}")
    # bf16 outputs of other batch sizes (other cuDNN algorithms): 5e-2.
    check(err <= 5e-2 * scale, f"served vs direct: max-abs {err} > 5e-2 x {scale}")
    say(4, f"served {stats['requests']} requests in {stats['batches']} batches, "
           f"launches {launches} (bucket warm-ups included) | "
           f"p50 {stats['latency_ms_p50']:.1f} ms, p95 {stats['latency_ms_p95']:.1f} ms | "
           f"vs direct: top-1 {agree:.4f}, max-abs {err:.3g} (bound 5e-2 x {scale:.3g})")
    return {"launches": launches, "stats": stats, "top1_vs_direct": agree,
            "max_abs_vs_direct": err}


# -- main -------------------------------------------------------------------

def main() -> int:
    import numpy as np
    import torch

    check(torch.cuda.is_available(), "no CUDA card: this smoke test runs only on the card")
    check((ROOT / "smelter_tpu_torch" / "__init__.py").exists(),
          f"{ROOT} holds no smelter_tpu_torch package: run from a checkout")
    sys.path.insert(0, str(ROOT))
    import smelter_tpu_torch as stt

    check(Path(stt.__file__).resolve().parent == ROOT / "smelter_tpu_torch",
          f"imported smelter_tpu_torch from {stt.__file__}, not from {ROOT}")
    t_start = time.perf_counter()
    smi, power_w = phase_environment(torch)
    rows = phase_kernels(torch, power_w)

    main_path = REPORT["main_path"] = phase_main(torch, np, stt)
    REPORT["serve"] = phase_serve(torch, np, stt)
    # Each kernel's launches on the path that routes to it.
    launches = {"dequant_matmul": main_path["bf16"]["launches"]["dequant_matmul"],
                "int8_matmul": main_path["bf16_int8act"]["launches"]["int8_matmul"]}
    say(5, f"main-path launches {launches} | total {time.perf_counter() - t_start:.1f} s")

    sources = {"dequant_matmul": ("smelter_tpu_torch/csrc/dequant_matmul.cu",
                                  "smelter_tpu/kernels/dequant_matmul.py:104", "bf16"),
               "int8_matmul": ("smelter_tpu_torch/csrc/int8_matmul.cu",
                               "smelter_tpu/kernels/int8_matmul.py:125", "int8")}
    kernels = []
    for name, (src, replaces, kind) in sources.items():
        r = rows[(name, "head", kind)]  # the shape the main path gives it
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    REPORT["kernels"] = kernels
    out = ROOT / "build" / "chip_smoke"
    out.mkdir(parents=True, exist_ok=True)
    (out / "report.json").write_text(json.dumps(REPORT, indent=1, default=str))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
