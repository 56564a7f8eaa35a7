#!/usr/bin/env python3
"""`pixel_conv_rowdot_q`'s int8 wgmma form and `mlp_block` on the wgmma GEMM
core, each beside the kernel it replaces, on one card in one process:

- rowdot_q at ESRGAN x4's eight PixelConv shapes at batch 8 (LeakyReLU 0.2,
  int8 out under requant, and bf16 out): the wrapper (the form
  `wgmma_plan.pixel_plan` picks) and the same entry point with form 0 (the
  mma.sync kernel every call took before), both `torch.equal` to the plain
  version, then at edge shapes of both forms; timed by CUDA-graph replay
  (`chip_smoke.graph_ms`, operands rotated past the 50 MB L2) in turns
  (new, old, old, new), and summed over a forward's 349 calls;
- mlp_block at ViT-B/16 b128 (M 25,216, D 768, F 3072) in bf16: the
  wrapper (`gemm_tma` for FC1 and FC2 where `mlp_block.plans` says "tma")
  and `legacy_plans()` (csrc/gemm.cuh's mma.sync GEMM) within 1e-2 of
  max|plain|, in turns, beside the library chain (F.layer_norm,
  torch.addmm, F.gelu, torch.addmm, the residual add); then the forms
  against the plain version at SD-UNet-like widths, in f16, with f32 and
  bf16 biases, pre_ln 0/1, both GELU forms and residual 0/1.

    python3 experiments/torch_pixel_q_mlp_timing.py [--check | --split]

--check stops after the build and the comparisons (about 1 minute on an
H100 with the build; the whole run about 1.5); --split only profiles one
mlp_block call by launch (LN, FC1, FC2) on both forms. Prints the card's
name and power limit, one line a row, and a JSON summary.
"""

from __future__ import annotations

import argparse
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
from smelter_tpu_torch.kernels import _build  # noqa: E402
from smelter_tpu_torch.kernels import mlp_block as mb  # noqa: E402
from smelter_tpu_torch.kernels import pixel_conv as pc  # noqa: E402

# (B, H, C_in, W, C_out): the int8 form's edges (a ragged row block and
# pixel tile, the smallest boxes, C_in past the last 32-channel step, the
# resident weight's zero-filled chunk) and shapes the plan keeps on mma.sync
EDGES = [(2, 7, 48, 112, 32), (1, 6, 32, 96, 64), (1, 9, 208, 160, 32), (3, 10, 64, 144, 64),
         (2, 8, 96, 80, 32), (1, 8, 64, 72, 32), (1, 5, 64, 128, 64), (2, 8, 24, 128, 32),
         (1, 8, 64, 128, 48)]


def q_operands(shape, cout, gen):
    B, H, cin, W = shape
    x = torch.randint(-127, 128, shape, device="cuda", generator=gen, dtype=torch.int8)
    wq = torch.randint(-127, 128, (cout, cin, 3, 3), device="cuda", generator=gen,
                       dtype=torch.int8)
    wq = wq.permute(2, 3, 0, 1).contiguous().permute(2, 3, 0, 1)  # the executor's layout
    sc = torch.rand(cout, device="cuda", generator=gen) * 1e-3 / cin ** 0.5
    b = torch.randn(cout, device="cuda", generator=gen)
    return x, wq, sc, b


def q_old(x, wq, sc, b, **kw):
    """The entry point's form 0 (the mma.sync kernel) on the wrapper's operands."""
    requant = kw.get("requant", True)
    out = torch.empty(x.shape[0], x.shape[1], wq.shape[0], x.shape[3], device="cuda",
                      dtype=torch.int8 if requant else kw["out_dtype"])
    pc._launch(x, pc._packed_weight(wq), b.float(), sc.float(), out, kw.get("alpha"),
               kw.get("inv_sy", 1.0), requant)
    return out


def q_checks(gen) -> list[str]:
    """Both forms equal to the plain version at ESRGAN's shapes and the edges."""
    lines = []
    kinds = (("int8", dict(alpha=0.2, inv_sy=0.5, requant=True)),
             ("bf16", dict(alpha=0.2, requant=False, out_dtype=torch.bfloat16)),
             ("f16", dict(alpha=None, requant=False, out_dtype=torch.float16)))
    shapes = [(cs.ESRGAN_BATCH, px, cin, px, cout) for cin, cout, px in cs.ESRGAN_CONVS]
    for B, H, cin, W, cout in shapes + EDGES:
        x, wq, sc, b = q_operands((B, H, cin, W), cout, gen)
        for label, kw in kinds:
            if label == "f16" and (B, H, cin, W, cout) not in EDGES[:3]:
                continue
            ref = pc.pixel_conv_rowdot_q_plain(x, wq, sc, b, **kw)
            got, old = pc.pixel_conv_rowdot_q(x, wq, sc, b, **kw), q_old(x, wq, sc, b, **kw)
            torch.cuda.synchronize()
            p = pc.plan(x, wq, out_dtype=ref.dtype)
            ok = torch.equal(got, ref) and torch.equal(old, ref)
            bad = (got != ref).sum().item()
            lines.append(f"rowdot_q {[B, H, cin, W, cout]} {label}: {p.form}"
                         f"{' resident' if p.resident else ''} {p.stages} stages: "
                         f"{'equal' if ok else f'DIFFERS ({bad} elements)'}")
            print(lines[-1], flush=True)
            assert ok, lines[-1]
    return lines


def mlp_operands(B, N, D, Fh, dtype, gen, bias_dtype=torch.float32):
    def rnd(*shape, s=1.0):
        return torch.randn(*shape, device="cuda", generator=gen) * s

    return (rnd(B, N, D).to(dtype), (1 + rnd(D, s=0.1)).to(bias_dtype),
            rnd(D, s=0.1).to(bias_dtype), rnd(D, Fh, s=D ** -0.5).to(dtype),
            rnd(Fh, s=0.1).to(bias_dtype), rnd(Fh, D, s=Fh ** -0.5).to(dtype),
            rnd(D, s=0.1).to(bias_dtype))


def mlp_err(got, ref) -> float:
    torch.cuda.synchronize()
    return (got.float() - ref.float()).abs().max().item() / ref.float().abs().max().item()


def mlp_checks(gen) -> list[str]:
    lines = []
    cases = [((8, 197, 768, 3072), torch.bfloat16, torch.float32, {}),
             ((8, 197, 768, 3072), torch.float16, torch.float16, dict(approximate=True)),
             ((2, 4096, 320, 1280), torch.bfloat16, torch.bfloat16, dict(residual=False)),
             ((2, 1024, 640, 2560), torch.bfloat16, torch.float32,
              dict(pre_ln=False, approximate=True)),
             ((1, 100, 256, 1024), torch.bfloat16, torch.float32, {}),   # M 100: gemm.cuh
             ((4, 50, 64, 256), torch.bfloat16, torch.float32, {}),      # D 64 for FC2's N
             ((8, 197, 768, 3072), torch.float32, torch.float32, {})]
    for (B, N, D, Fh), dtype, bdt, kw in cases:
        args = mlp_operands(B, N, D, Fh, dtype, gen, bdt)
        kw = dict(dict(eps=1e-6), **kw)
        ref = mb.mlp_block_plain(*args, **kw)
        err = mlp_err(mb.mlp_block(*args, **kw), ref)
        old = mlp_err(mb._launch(*args, mb.legacy_plans(), **dict(
            dict(approximate=False, residual=True, pre_ln=True), **kw)), ref)
        forms = [p.form for p in mb.plans(B * N, D, Fh, dtype)]
        tol = 1e-5 if dtype == torch.float32 else 1e-2
        lines.append(f"mlp_block {[B * N, D, Fh]} {str(dtype)[6:]} bias {str(bdt)[6:]} {kw}: "
                     f"forms {forms}, err {err:.3g} (gemm.cuh {old:.3g}) of max|plain|, "
                     f"tolerance {tol}")
        print(lines[-1], flush=True)
        assert err <= tol and old <= tol, lines[-1]
    return lines


def q_rows(side, gen, power_w: float) -> list[dict]:
    rows = []
    B = cs.ESRGAN_BATCH
    for (cin, cout, px), calls in cs.ESRGAN_CONVS.items():
        for label, kw in (("int8", dict(alpha=0.2, inv_sy=0.5, requant=True)),
                          ("bf16", dict(alpha=0.2, requant=False, out_dtype=torch.bfloat16))):
            es = 1 if label == "int8" else 2
            nbytes = B * px * px * (cin + cout * es) + 9 * cin * cout + cout * 8
            sets = [q_operands((B, px, cin, px), cout, gen) for _ in range(cs._copies(nbytes))]
            n = len(sets)
            p = pc.plan(sets[0][0], sets[0][1], out_dtype=torch.int8 if label == "int8"
                        else torch.bfloat16)

            def new(i, kw=kw):
                return pc.pixel_conv_rowdot_q(*sets[i % n], **kw)

            def old(i, kw=kw):
                return q_old(*sets[i % n], **kw)

            t = {"new": [], "old": []}
            for which in ("new", "old", "old", "new"):
                t[which].append(cs.graph_ms(torch, side, new if which == "new" else old, 10))
            row = {"shape": [B, px, cin, px, cout], "out": label, "calls": calls,
                   "form": p.form, "resident": p.resident, "stages": p.stages,
                   "ms": statistics.mean(t["new"]), "mma_ms": statistics.mean(t["old"]),
                   "runs": t, "bound_ms": cs.bound(nbytes, 2 * B * px * px * 9 * cin * cout,
                                                   "int8", power_w)[0]}
            rows.append(row)
            print(f"rowdot_q {row['shape']} {label} x{calls} ({p.form}"
                  f"{', resident weight' if p.resident else ''}, {p.stages} stages): "
                  f"{row['ms']:.4f} ms ({t['new']}), mma.sync {row['mma_ms']:.4f} "
                  f"({t['old']}), bound {row['bound_ms']:.4f}", flush=True)
            del sets
    return rows


def mlp_rows(side, gen, power_w: float) -> dict:
    B, N, D, Fh = cs.VIT_BATCH, 197, 768, 3072
    M = B * N
    nbytes = 2 * (2 * M * D + 2 * D * Fh) + 4 * (3 * D + Fh)
    sets = [mlp_operands(B, N, D, Fh, torch.bfloat16, gen) for _ in range(cs._copies(nbytes))]
    n = len(sets)
    kw = dict(eps=1e-12, approximate=False, residual=True, pre_ln=True)
    lib_p = [[t.to(torch.bfloat16) for t in (g, b, b1, b2)] for _, g, b, _, b1, _, b2 in sets]

    def new(i):
        return mb.mlp_block(*sets[i % n], **kw)

    def old(i):
        return mb._launch(*sets[i % n], mb.legacy_plans(), **kw)

    def lib(i):
        x, _, _, w1, _, w2, _ = sets[i % n]
        g, b, b1, b2 = lib_p[i % n]
        x2 = x.reshape(M, D)
        h = F.gelu(torch.addmm(b1, F.layer_norm(x2, (D,), g, b, 1e-12), w1))
        return torch.addmm(b2, h, w2) + x2

    t = {"new": [], "old": []}
    for which in ("new", "old", "old", "new"):
        t[which].append(cs.graph_ms(torch, side, new if which == "new" else old, 5))
    row = {"shape": [M, D, Fh], "forms": [p.form for p in mb.plans(M, D, Fh, torch.bfloat16)],
           "ms": statistics.mean(t["new"]), "mma_ms": statistics.mean(t["old"]), "runs": t,
           "library_ms": cs.graph_ms(torch, side, lib, 5),
           "bound_ms": cs.bound(nbytes, 4 * M * D * Fh, "bf16", power_w)[0]}
    print(f"mlp_block {row['shape']} bf16 ({row['forms']}): {row['ms']:.4f} ms ({t['new']}), "
          f"gemm.cuh {row['mma_ms']:.4f} ({t['old']}), library chain {row['library_ms']:.4f}, "
          f"bound {row['bound_ms']:.4f}", flush=True)
    return row


def mlp_split(gen) -> dict:
    """One mlp_block call at ViT-B/16 b128 split by launch (LN, FC1, FC2),
    on the plans' forms and on gemm.cuh, from one torch.profiler session
    over 5 calls of each."""
    from torch.profiler import ProfilerActivity, profile

    B, N, D, Fh = cs.VIT_BATCH, 197, 768, 3072
    args = mlp_operands(B, N, D, Fh, torch.bfloat16, gen)
    kw = dict(eps=1e-12, approximate=False, residual=True, pre_ln=True)
    runs = {"new": lambda: mb.mlp_block(*args, **kw),
            "old": lambda: mb._launch(*args, mb.legacy_plans(), **kw)}
    for fn in runs.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for fn in runs.values():
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        t = getattr(e, "self_cuda_time_total", 0.0) if t is None else t
        if str(getattr(e, "device_type", "")).endswith("CUDA") and e.count and t > 0:
            split[e.key[:110]] = {"calls": e.count, "ms_each": t / e.count / 1e3}
    print("mlp_block split by launch (ms each): " + "; ".join(
        f"{k} {v['ms_each']:.4f} x{v['calls']}" for k, v in split.items()), flush=True)
    return split


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true", help="build and compare, no timing")
    ap.add_argument("--split", action="store_true", help="only mlp_block's split by launch")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    power_w = float(smi.split(",")[-1].strip().split()[0])
    logs = _build.build(["pixel_conv", "mlp_block"])
    for name, log in logs.items():
        keep = [ln for ln in log.splitlines()
                if "pixel_conv_wgmma_s8" in ln or "gemm_tma" in ln or "Used" in ln
                or "spill" in ln]
        print(f"{name} ptxas:\n" + "\n".join(keep[-60:]), flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(16)
    if args.split:
        print("SUMMARY " + json.dumps({"card": smi, "mlp_split": mlp_split(gen)}))
        return 0
    summary = {"card": smi, "checks": q_checks(gen) + mlp_checks(gen)}
    if not args.check:
        side = torch.cuda.Stream()
        qrows = q_rows(side, gen, power_w)
        summary["rowdot_q"] = qrows
        summary["mlp_block"] = mlp_rows(side, gen, power_w)
        for label in ("int8", "bf16"):
            rs = [r for r in qrows if r["out"] == label]
            for key in ("ms", "mma_ms", "bound_ms"):
                summary[f"rowdot_q_{label}_forward_{key}"] = sum(r[key] * r["calls"] for r in rs)
        print("forward (349 calls): " + ", ".join(
            f"{k[len('rowdot_q_'):]} {v:.3f}" for k, v in summary.items()
            if k.startswith("rowdot_q_")), flush=True)
    print("SUMMARY " + json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
