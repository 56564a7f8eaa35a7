#!/usr/bin/env python3
"""`cross_attn_block`'s wgmma form beside its mma.sync form, and
`pixel_conv_blockdot`'s 8-row wgmma tile beside its 4-row tile (rowdot's),
timed on one card in one process by CUDA-graph replay
(`chip_smoke.graph_ms`, operands rotated past the 50 MB L2), each pair in
turns (A B B A):

- cross_attn_block at SD-UNet's two b8 shapes ((N 1024, D 128) and (N 256,
  D 256), 8 heads, 16 keys), k/v per image and shared, bf16: the wrapper's
  form (wgmma) and form 0 (mma.sync) of the same entry point, the library
  chain (`torch.matmul`, SDPA, `torch.addmm`), the plain version, each
  checked against the plain version within 1e-2 of its largest output;
  summed over a forward's 5 calls (2 + 3);
- blockdot at ESRGAN x4's eight PixelConv shapes at batch 8, bf16, LeakyReLU
  0.2: the 8-row tile (`wgmma_plan.pixel_tall_plan`), the 4-row tile
  (rowdot's plan) and cuDNN channels-last + `F.leaky_relu`; summed over a
  forward's 349 calls.

    python3 experiments/torch_xattn_blockdot_timing.py [--only xattn|blockdot]

Prints the card's name and power limit, one line a row, and a JSON summary
(about 2 minutes on an H100 with the build).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from smelter_tpu_torch.kernels import cross_attn_block as xa  # noqa: E402
from smelter_tpu_torch.kernels import pixel_conv as pc  # noqa: E402
from smelter_tpu_torch.kernels import wgmma_plan  # noqa: E402


def _err(got, ref, label):
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    cs.check(err <= 1e-2 * scale, f"{label}: max-abs {err} > 1e-2 x {scale}")
    return err


def _turns(side, fns: dict, iters: int) -> dict:
    """Each fn timed twice, in the order a b b a (a b c c b a ...)."""
    order = list(fns) + list(fns)[::-1]
    times = {k: [] for k in fns}
    for k in order:
        times[k].append(cs.graph_ms(torch, side, fns[k], iters))
    return {k: sum(v) / len(v) for k, v in times.items()}


def xattn_rows(side, gen, power_w: float) -> list[dict]:
    bf16, H, S, B = torch.bfloat16, cs.SD_UNET["heads"], cs.SD_UNET["ctx_len"], cs.SD_UNET_BATCH
    rows = []
    for N, D, calls in ((1024, 128, 2), (256, 256, 3)):
        hd = D // H
        nbytes = 2 * (2 * B * N * D + 2 * D * D + 2 * B * H * S * hd) + 4 * D
        for bk in (B, 1):
            sets = [(torch.randn(B, N, D, device="cuda", generator=gen).to(bf16),
                     (torch.randn(D, D, device="cuda", generator=gen) * D ** -0.5).to(bf16),
                     torch.randn(bk, H, S, hd, device="cuda", generator=gen).to(bf16),
                     torch.randn(bk, H, S, hd, device="cuda", generator=gen).to(bf16),
                     (torch.randn(D, D, device="cuda", generator=gen) * D ** -0.5).to(bf16),
                     torch.randn(D, device="cuda", generator=gen) * 0.1)
                    for _ in range(cs._copies(nbytes))]
            n = len(sets)
            p = xa.plan(sets[0][0], sets[0][2], H)
            mma = dataclasses.replace(p, form="mma")
            lib_b = [a[5].to(bf16) for a in sets]

            def lib(i, N=N, D=D, hd=hd):
                x, wq, k, v, wp, _ = sets[i % n]
                q = torch.matmul(x, wq).reshape(B, N, H, hd).transpose(1, 2)
                kk, vv = k.expand(B, -1, -1, -1), v.expand(B, -1, -1, -1)
                a = F.scaled_dot_product_attention(q, kk, vv).transpose(1, 2).reshape(B * N, D)
                return torch.addmm(lib_b[i % n], a, wp)

            ref = xa.cross_attn_block_plain(*sets[0], heads=H)
            errs = {"wgmma": _err(xa.cross_attn_block(*sets[0], heads=H), ref, f"xattn {N} wgmma"),
                    "mma": _err(xa._launch(*sets[0], H, None, mma), ref, f"xattn {N} mma")}
            t = _turns(side, {"wgmma": lambda i: xa.cross_attn_block(*sets[i % n], heads=H),
                              "mma": lambda i: xa._launch(*sets[i % n], H, None, mma)}, 20)
            t["library"] = cs.graph_ms(torch, side, lib, 20)
            t["plain"] = cs.graph_ms(torch, side,
                                     lambda i: xa.cross_attn_block_plain(*sets[i % n], heads=H), 5)
            b_ms, b_by = cs.bound(nbytes, {"bf16": B * (4 * N * D * D + 4 * N * S * D)}, None,
                                  power_w)
            row = {"name": "cross_attn_block", "N": N, "D": D, "bk": bk, "calls": calls,
                   "grid": list(p.grid), "cluster": p.cluster, "ms": t, "err": errs,
                   "bound_ms": b_ms, "bound_by": b_by}
            print(f"cross_attn_block N {N} D {D} Bk {bk}: wgmma {t['wgmma']:.4f} ms (grid "
                  f"{list(p.grid)}, clusters of {p.cluster}), mma.sync {t['mma']:.4f}, library "
                  f"{t['library']:.4f}, plain {t['plain']:.4f}, bound {b_ms:.4f} ({b_by})",
                  flush=True)
            rows.append(row)
            del sets, lib_b
    return rows


def blockdot_rows(side, gen, power_w: float) -> list[dict]:
    B, bf16 = cs.ESRGAN_BATCH, torch.bfloat16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for (cin, cout, px), calls in cs.ESRGAN_CONVS.items():
        nbytes = B * px * px * (cin + cout) * 2 + 9 * cin * cout * 2 + cout * 2
        sets = []
        for _ in range(cs._copies(nbytes)):
            x = torch.randn(B, px, cin, px, device="cuda", generator=gen).to(bf16)
            w = (torch.randn(cout, cin, 3, 3, device="cuda", generator=gen)
                 / (3 * cin ** 0.5)).to(bf16)
            b = torch.randn(cout, device="cuda", generator=gen).to(bf16)
            sets.append((x, w.permute(2, 3, 0, 1).contiguous(), b, w))
        n = len(sets)
        plans = {"rows8": wgmma_plan.pixel_tall_plan(B, px, px, cin, cout, sms),
                 "rows4": pc.plan(sets[0][0], sets[0][3])}

        def run(p):
            def fn(i):
                x, wpk, b, _ = sets[i % n]
                out = torch.empty(B, px, cout, px, device="cuda", dtype=bf16)
                pc._launch(x, wpk, b, None, out, 0.2, 1.0, False, p=p)
                return out
            return fn

        xl = [s[0].permute(0, 2, 1, 3).contiguous(memory_format=torch.channels_last) for s in sets]
        wl = [s[3].contiguous(memory_format=torch.channels_last) for s in sets]

        def lib(i):
            return F.leaky_relu(F.conv2d(xl[i % n], wl[i % n], sets[i % n][2], padding=1), 0.2)

        ref = pc.pixel_conv_blockdot_plain(sets[0][0], sets[0][3], sets[0][2], alpha=0.2)
        errs = {k: _err(run(p)(0), ref, f"blockdot {(cin, cout, px)} {k}")
                for k, p in plans.items()}
        t = _turns(side, {k: run(p) for k, p in plans.items()}, 10)
        t["cudnn"] = cs.graph_ms(torch, side, lib, 10)
        b_ms, b_by = cs.bound(nbytes, 2 * B * px * px * 9 * cin * cout, "bf16", power_w)
        chosen = pc.plan(sets[0][0], sets[0][3], tall=True)
        row = {"name": "pixel_conv_blockdot", "shape": [B, px, cin, px, cout], "calls": calls,
               "chosen_rows": chosen.rows, "ms": t, "err": errs, "bound_ms": b_ms,
               "plans": {k: f"{p.rows} rows, {p.stages} stages, "
                            f"{'resident' if p.resident else 'streamed'}, {p.smem} B"
                         for k, p in plans.items()}}
        print(f"blockdot {(cin, cout, px)}: 8-row {t['rows8']:.4f} ms ({row['plans']['rows8']}), "
              f"4-row {t['rows4']:.4f} ({row['plans']['rows4']}), cuDNN {t['cudnn']:.4f}, bound "
              f"{b_ms:.4f}; the plan takes {chosen.rows} rows", flush=True)
        rows.append(row)
        del sets, xl, wl
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("xattn", "blockdot"))
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
    gen = torch.Generator(device="cuda").manual_seed(11)
    side = torch.cuda.Stream()
    out = {"device": smi}
    if args.only != "blockdot":
        rows = xattn_rows(side, gen, power_w)
        fw = {k: sum(r["ms"][k] * r["calls"] for r in rows if r["bk"] > 1)
              for k in ("wgmma", "mma", "library", "plain")}
        fw["bound"] = sum(r["bound_ms"] * r["calls"] for r in rows if r["bk"] > 1)
        print(f"cross_attn_block over SD-UNet b8's 5 calls (Bk = B): " +
              ", ".join(f"{k} {v:.4f} ms" for k, v in fw.items()), flush=True)
        out["cross_attn_block"], out["cross_attn_forward"] = rows, fw
    if args.only != "xattn":
        rows = blockdot_rows(side, gen, power_w)
        fw = {k: sum(r["ms"][k] * r["calls"] for r in rows) for k in ("rows8", "rows4", "cudnn")}
        fw["chosen"] = sum(r["ms"]["rows8" if r["chosen_rows"] == 8 else "rows4"] * r["calls"]
                           for r in rows)
        fw["bound"] = sum(r["bound_ms"] * r["calls"] for r in rows)
        print(f"blockdot over ESRGAN x4 b8's 349 calls: " +
              ", ".join(f"{k} {v:.3f} ms" for k, v in fw.items()), flush=True)
        out["pixel_conv_blockdot"], out["blockdot_forward"] = rows, fw
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
