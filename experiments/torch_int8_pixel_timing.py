#!/usr/bin/env python3
"""`pixel_conv_rowdot`'s wgmma form beside its earlier mma.sync kernel and
cuDNN, and `int8_matmul`'s two wgmma forms beside `torch._int_mm`, timed on
one card in one process by CUDA-graph replay (`chip_smoke.graph_ms`,
operands rotated past the 50 MB L2):

- rowdot at ESRGAN x4's eight PixelConv shapes at batch 8, bf16, LeakyReLU
  0.2, with the executor's operands (the packed weight's OIHW view, a bf16
  bias): the wrapper (the form `pixel_plan` picks), the same entry point
  with form 0 (the mma.sync kernel every shape took before), in turns (new,
  old, old, new), the form's other variant where it fits (the weights a
  stage at a time where the plan keeps them resident, resident where it
  streams them), and `F.conv2d` channels-last + `F.leaky_relu`; each summed
  over a forward's 349 calls (the streamed sum: every conv with its weights
  a stage at a time);
- int8_matmul at the ResNet-50 head (M 128, K 2048, N 1000) and the serving
  GEMM (M 8192, K 4096, N 4096), bf16 out, beside `torch._int_mm` with the
  same epilogue.

    python3 experiments/torch_int8_pixel_timing.py

Prints the card's name and power limit, one line a row, and a JSON summary
(about 1 minute on an H100 with the build).
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from smelter_tpu_torch.kernels import _build, wgmma_plan  # noqa: E402
from smelter_tpu_torch.kernels import int8_matmul as im  # noqa: E402
from smelter_tpu_torch.kernels import pixel_conv as pc  # noqa: E402


def pixel_rows(side, gen, power_w: float) -> list[dict]:
    B, bf16 = cs.ESRGAN_BATCH, torch.bfloat16
    rows = []
    for (cin, cout, px), calls in cs.ESRGAN_CONVS.items():
        shape = (B, px, cin, px)
        nbytes = B * px * px * (cin + cout) * 2 + 9 * cin * cout * 2 + cout * 2
        sets = []
        for _ in range(cs._copies(nbytes)):
            x = torch.randn(shape, device="cuda", generator=gen).to(bf16)
            w = (torch.randn(cout, cin, 3, 3, device="cuda", generator=gen)
                 / (3 * cin ** 0.5)).to(bf16)
            wp = w.permute(2, 3, 0, 1).contiguous()  # [3][3][C_out][C_in]
            b = torch.randn(cout, device="cuda", generator=gen).to(bf16)
            out = torch.empty(B, px, cout, px, device="cuda", dtype=bf16)
            sets.append((x, wp.permute(2, 3, 0, 1), b, wp, out))
        n = len(sets)
        p = pc.plan(sets[0][0], sets[0][1])
        # the form's other variant where it fits: the weights a stage at a
        # time, or resident with the stages it leaves
        if p.resident:
            other = dataclasses.replace(p, resident=False, stages=wgmma_plan.pixel_stages(cout),
                                        smem=wgmma_plan.pixel_smem(cout))
        elif wgmma_plan.pixel_resident_stages(cin, cout) >= 2:
            other = dataclasses.replace(p, resident=True,
                                        stages=wgmma_plan.pixel_resident_stages(cin, cout),
                                        smem=wgmma_plan.pixel_resident_smem(cin, cout))
        else:
            other = None

        def new(i):
            x, w, b, _, _ = sets[i % n]
            return pc.pixel_conv_rowdot(x, w, b, alpha=0.2)

        def old(i):
            x, _, b, wp, out = sets[i % n]
            pc._launch(x, wp, b, None, out, 0.2, 1.0, False)

        def alt(i):
            x, _, b, wp, out = sets[i % n]
            pc._launch(x, wp, b, None, out, 0.2, 1.0, False, p=other)

        xl = [s[0].permute(0, 2, 1, 3).contiguous(memory_format=torch.channels_last) for s in sets]
        wl = [s[1].contiguous(memory_format=torch.channels_last) for s in sets]

        def lib(i):
            return F.leaky_relu(F.conv2d(xl[i % n], wl[i % n], sets[i % n][2], padding=1), 0.2)

        ref = pc.pixel_conv_rowdot_plain(*sets[0][:3], alpha=0.2)
        for check in (old, alt) if other is not None else (old,):
            check(0)
            for got in (new(0), sets[0][4]):
                torch.cuda.synchronize()
                err = (got.float() - ref.float()).abs().max().item()
                assert err <= 1e-2 * ref.float().abs().max().item(), (shape, err)
        t = {"new": [], "old": []}
        for which in ("new", "old", "old", "new"):
            t[which].append(cs.graph_ms(torch, side, new if which == "new" else old, 10))
        row = {"shape": [B, px, cin, px, cout], "calls": calls, "form": p.form,
               "resident": p.resident, "stages": p.stages, "ms": statistics.mean(t["new"]),
               "mma_ms": statistics.mean(t["old"]),
               "other_stages": other.stages if other is not None else None,
               "other_ms": cs.graph_ms(torch, side, alt, 10) if other is not None else None,
               "cudnn_ms": cs.graph_ms(torch, side, lib, 10),
               "bound_ms": cs.bound(nbytes, 2 * B * px * px * 9 * cin * cout, "bf16", power_w)[0]}
        rows.append(row)
        kind = "resident weight" if p.resident else "weights a stage"
        also = "" if other is None else (
            f", {'weights a stage' if p.resident else 'resident weight'} ({other.stages} "
            f"stages) {row['other_ms']:.4f}")
        print(f"rowdot {row['shape']} x{calls} ({p.form}, {kind}, {p.stages} stages): "
              f"{row['ms']:.4f} ms (runs "
              f"{t['new']}), mma.sync {row['mma_ms']:.4f} ({t['old']}){also}, cuDNN + leaky "
              f"{row['cudnn_ms']:.4f}, bound {row['bound_ms']:.4f}", flush=True)
        del sets, xl, wl
    return rows


def int8_rows(side, gen, power_w: float) -> list[dict]:
    rows = []
    for label, (M, K, N) in (("head", cs.HEAD), ("serving", cs.SERVING)):
        nbytes = M * K + K * N + M * 4 + N * 4 + M * N * 2
        sets = []
        for _ in range(cs._copies(nbytes)):
            xq = torch.randint(-127, 128, (M, K), device="cuda", generator=gen, dtype=torch.int8)
            w = torch.randint(-127, 128, (K, N), device="cuda", generator=gen, dtype=torch.int8)
            sr = torch.rand(M, 1, device="cuda", generator=gen) * 1e-2 + 1e-3
            s = torch.rand(N, device="cuda", generator=gen) * 1e-2 + 1e-3
            sets.append((xq, w, sr, s, w.t().contiguous().t()))
        n = len(sets)
        xq, w, sr, s, _ = sets[0]
        assert torch.equal(im.int8_matmul(xq, w, sr, s), im.int8_matmul_plain(xq, w, sr, s))
        iters = 50 if label == "head" else 10
        ms = cs.graph_ms(torch, side, lambda i: im.int8_matmul(*sets[i % n][:4]), iters)

        def int_mm(i):
            xq_, _, sr_, s_, wcm = sets[i % n]
            return (torch._int_mm(xq_, wcm).float() * sr_ * s_).to(torch.bfloat16)

        row = {"case": label, "shape": [M, K, N], "form": im.plan(xq, w).form, "ms": ms,
               "int_mm_ms": cs.graph_ms(torch, side, int_mm, iters),
               "bound_ms": cs.bound(nbytes, 2 * M * N * K, "int8", power_w)[0]}
        rows.append(row)
        print(f"int8_matmul {label} {row['shape']} ({row['form']}): {ms:.4f} ms, "
              f"_int_mm + epilogue {row['int_mm_ms']:.4f}, bound {row['bound_ms']:.4f}",
              flush=True)
        del sets
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    power_w = float(smi.split(",")[-1].strip().split()[0])
    _build.build(["pixel_conv", "int8_matmul"])
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(5)
    side = torch.cuda.Stream()
    prow = pixel_rows(side, gen, power_w)
    summary = {"card": smi, "int8_matmul": int8_rows(side, gen, power_w),
               "pixel_conv_rowdot": prow}
    for key in ("ms", "mma_ms", "cudnn_ms", "bound_ms"):
        summary[f"rowdot_forward_{key}"] = sum(r[key] * r["calls"] for r in prow)
    summary["rowdot_forward_streamed_ms"] = sum(
        (r["other_ms"] if r["resident"] else r["ms"]) * r["calls"] for r in prow)
    print("forward (349 calls): " + ", ".join(
        f"{k[len('rowdot_forward_'):]} {v:.3f}" for k, v in summary.items()
        if k.startswith("rowdot_forward_")), flush=True)
    print("SUMMARY " + json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
