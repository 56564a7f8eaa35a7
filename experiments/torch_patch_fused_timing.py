#!/usr/bin/env python3
"""`pixel_conv_patch` on the wgmma conv core at flat NCHW strides, and
`dequant_matmul_int8_fused` and `_fused2` on their int8 forms, each beside the
designs it was chosen from, timed on one card in one process by CUDA-graph
replay (`chip_smoke.graph_ms`, operands rotated past the 50 MB L2), the
kernel variants in turns (A B B A):

- patch at ESRGAN x4's eight PixelConv shapes at batch 8, bf16, LeakyReLU
  0.2: the 8-row tile where it fits, the 4-row tile, both at NCHW strides;
  blockdot's chosen tile on the same map in NHCW (what the NCHW stores
  cost); form 0 (the mma.sync kernel patch ran before); then cuDNN NCHW +
  `F.leaky_relu`; each checked against the plain version within 1e-2 of
  its largest output; summed over a forward's 349 calls;
- the fused GEMMs at the ResNet-50 head, the serving GEMM, the serving
  GEMM's size at K 4,104 (which the panel form turns down) and 2,048 x
  4,096 x 512 (64 panel units), bf16: the form each plan picks
  (`dequant_matmul_int8_fused`'s and `_fused2`'s), the cluster form at its
  own split and, where the TMA maps can read the shape, the revisit form
  on 256- and 128-column tiles, the mma.sync kernel and the panel form on 4
  and 8 ranks (where its chunks fit), then `_fused2` through its entry
  point, each checked bit-equal to the plain version; then the two-pass
  `dequant_matmul_int8`, the library chain (`quantize_rows`,
  `torch._int_mm`, the epilogue) and the row scales' plain pass alone.
  Every kernel time includes the row scales' pass, as the entry points do.

    python3 experiments/torch_patch_fused_timing.py [--only patch|fused]

Prints the card's name and power limit, one line a row, and a JSON summary.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from smelter_tpu_torch.kernels import int8_matmul as im  # noqa: E402
from smelter_tpu_torch.kernels import pixel_conv as pc  # noqa: E402
from smelter_tpu_torch.kernels import wgmma_plan  # noqa: E402


def _turns(side, fns: dict, iters: int) -> dict:
    """Each fn timed twice, in the order a b b a (a b c c b a ...)."""
    order = list(fns) + list(fns)[::-1]
    times = {k: [] for k in fns}
    for k in order:
        times[k].append(cs.graph_ms(torch, side, fns[k], iters))
    return {k: sum(v) / len(v) for k, v in times.items()}


def _err(got, ref, label):
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    cs.check(got.shape == ref.shape and err <= 1e-2 * scale,
             f"{label}: max-abs {err} > 1e-2 x {scale}")
    return err


def patch_rows(side, gen, power_w: float) -> list[dict]:
    B, bf16 = cs.ESRGAN_BATCH, torch.bfloat16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for (cin, cout, px), calls in cs.ESRGAN_CONVS.items():
        hw = px * px
        nbytes = B * hw * (cin + cout) * 2 + 9 * cin * cout * 2 + cout * 2
        sets = []
        for _ in range(cs._copies(nbytes)):
            x = torch.randn(B, cin, hw, device="cuda", generator=gen).to(bf16)
            w = (torch.randn(cout, cin, 3, 3, device="cuda", generator=gen)
                 / (3 * cin ** 0.5)).to(bf16)
            b = torch.randn(cout, device="cuda", generator=gen).to(bf16)
            sets.append((x, w.permute(2, 3, 0, 1).contiguous(), b, w,
                         x.reshape(B, cin, px, px).permute(0, 2, 1, 3).contiguous()))
        n = len(sets)
        xs, os_ = (cin * hw, px, hw), (cout * hw, px, hw)
        plans = {"rows8": wgmma_plan.pixel_tall_plan(B, px, px, cin, cout, sms),
                 "rows4": wgmma_plan.pixel_plan(B, px, px, cin, cout, xs, "bfloat16", sms=sms,
                                                out_strides=os_),
                 "mma": None}
        cs.check(plans["rows8"] is not None and plans["rows4"].form == "wgmma",
                 f"patch {(cin, cout, px)}: plans {plans}")

        def run(p):
            def fn(i):
                x, wpk, b, _, _ = sets[i % n]
                out = torch.empty(B, cout, hw, device="cuda", dtype=bf16)
                pc._launch(x, wpk, b, None, out, 0.2, 1.0, False, dims=(B, px, cin, px, cout),
                           x_strides=xs, out_strides=os_, p=p)
                return out
            return fn

        nhcw_plan = pc.plan(sets[0][4], sets[0][3], tall=True)

        def nhcw(i):
            x, wpk, b, _, xn = sets[i % n]
            out = torch.empty(B, px, cout, px, device="cuda", dtype=bf16)
            pc._launch(xn, wpk, b, None, out, 0.2, 1.0, False, p=nhcw_plan)
            return out

        def lib(i):
            x, _, b, w, _ = sets[i % n]
            return F.leaky_relu(F.conv2d(x.reshape(B, cin, px, px), w, b, padding=1), 0.2)

        ref = pc.pixel_conv_patch_plain(sets[0][0], sets[0][3], sets[0][2], width=px, alpha=0.2)
        fns = {k: run(p) for k, p in plans.items()}
        errs = {k: _err(fn(0), ref, f"patch {(cin, cout, px)} {k}") for k, fn in fns.items()}
        fns["nhcw"] = nhcw
        t = _turns(side, fns, 10)
        t["cudnn"] = cs.graph_ms(torch, side, lib, 10)
        b_ms, b_by = cs.bound(nbytes, 2 * B * hw * 9 * cin * cout, "bf16", power_w)
        chosen = pc.patch_plan(sets[0][0], sets[0][3], px)
        row = {"name": "pixel_conv_patch", "shape": [B, cin, px, px, cout], "calls": calls,
               "chosen_rows": chosen.rows, "chosen_form": chosen.form, "ms": t, "err": errs,
               "bound_ms": b_ms, "bound_by": b_by, "nhcw_rows": nhcw_plan.rows,
               "plans": {k: f"{p.rows} rows, {p.stages} stages, "
                            f"{'resident' if p.resident else 'streamed'}, {p.smem} B"
                         for k, p in plans.items() if p is not None}}
        print(f"patch {(cin, cout, px)}: 8-row {t['rows8']:.4f} ms ({row['plans']['rows8']}), "
              f"4-row {t['rows4']:.4f} ({row['plans']['rows4']}), NHCW ({nhcw_plan.rows}-row) "
              f"{t['nhcw']:.4f}, form 0 {t['mma']:.4f}, cuDNN NCHW {t['cudnn']:.4f}, bound "
              f"{b_ms:.4f}; the plan takes {chosen.form} {chosen.rows} rows", flush=True)
        rows.append(row)
        del sets
    return rows


def fused_rows(side, gen, power_w: float) -> list[dict]:
    bf16 = torch.bfloat16
    rows = []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, (M, K, N), iters in (("head", cs.HEAD, 50), ("serving", cs.SERVING, 10),
                                    ("serving_k4104", (8192, 4104, 4096), 10),
                                    ("rows2048_n512", (2048, 4096, 512), 20)):
        nbytes = M * K * 2 + K * N + N * 4 + M * N * 2
        sets = [(torch.randn(M, K, device="cuda", generator=gen).to(bf16),
                 torch.randint(-127, 128, (K, N), device="cuda", generator=gen,
                               dtype=torch.int8),
                 torch.rand(N, device="cuda", generator=gen) * 0.02 + 1e-3)
                for _ in range(cs._copies(nbytes))]
        n = len(sets)
        x, w, s = sets[0]
        ref = im.dequant_matmul_int8_fused_plain(x, w, s)
        plans = {"chosen": im.fused_plan(x, w), "chosen2": im.fused_plan(x, w, fused2=True),
                 "cluster": wgmma_plan._cluster_form(M, N, K, sms)}
        if label != "head":  # the shapes the TMA maps can read
            plans.update({f"revisit{c}": wgmma_plan.revisit_form(M, N, K, 2, cols=c, sms=sms)
                          for c in (256, 128)})
            plans["mma"] = wgmma_plan.mma_plan(M, N, K)
            plans.update({f"panel{sp}": p for sp in wgmma_plan.QP_SPLITS
                          if (p := wgmma_plan._panel_form(M, N, K, sp)) is not None})

        def run(p):
            def fn(i):  # what the fused entry points do, on the plan `p`
                x, w, s = sets[i % n]
                out = torch.empty(M, N, device="cuda", dtype=bf16)
                im._launch(x, w, im.quantize_rows_scales(x), s, out, p, "fused")
                return out
            return fn

        fns = {k: run(p) for k, p in plans.items()}
        fns["fused2"] = lambda i: im.dequant_matmul_int8_fused2(*sets[i % n])
        for k, fn in fns.items():
            got = fn(0)
            torch.cuda.synchronize()
            cs.check(torch.equal(got, ref), f"fused {label} {k}: differs from the plain version")
        t = _turns(side, fns, iters)
        t["two_pass"] = cs.graph_ms(torch, side, lambda i: im.dequant_matmul_int8(*sets[i % n]),
                                    iters)
        t["library"] = cs.graph_ms(
            torch, side, lambda i: im.dequant_matmul_int8_reference(*sets[i % n]), iters)
        t["scales"] = cs.graph_ms(
            torch, side, lambda i: im.quantize_rows_scales(sets[i % n][0]), iters)
        b_ms, b_by = cs.bound(nbytes, 2 * M * N * K, "int8", power_w)
        row = {"name": "dequant_matmul_int8_fused", "label": label, "shape": [M, K, N],
               "ms": t, "bound_ms": b_ms, "bound_by": b_by,
               "plans": {k: f"{p.form}, split {p.split}, k_chunk {p.k_chunk}, {p.stages} "
                            f"stages, grid {p.grid}, {p.cols} columns, {p.smem} B"
                         for k, p in plans.items()}}
        print(f"fused {label} {[M, K, N]}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in t.items())
              + f", bound {b_ms:.4f} ({b_by}); plans {row['plans']}", flush=True)
        rows.append(row)
        del sets, ref
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("patch", "fused"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    power_w = float(smi.split(",")[1].strip().split()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(12)
    side = torch.cuda.Stream()
    out = {"device": smi}
    if args.only != "patch":
        out["dequant_matmul_int8_fused"] = fused_rows(side, gen, power_w)
    if args.only != "fused":
        rows = patch_rows(side, gen, power_w)
        fw = {k: sum(r["ms"][k] * r["calls"] for r in rows)
              for k in ("rows8", "rows4", "nhcw", "mma", "cudnn")}
        fw["chosen"] = sum(r["ms"]["rows8" if r["chosen_rows"] == 8 else "rows4"] * r["calls"]
                           for r in rows)
        fw["bound"] = sum(r["bound_ms"] * r["calls"] for r in rows)
        print("patch over ESRGAN x4 b8's 349 calls: " +
              ", ".join(f"{k} {v:.3f} ms" for k, v in fw.items()), flush=True)
        out["pixel_conv_patch"], out["patch_forward"] = rows, fw
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
