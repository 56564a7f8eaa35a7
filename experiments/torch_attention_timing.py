#!/usr/bin/env python3
"""Two checkouts' attention kernels timed on one card in turns, A B B A, each
run in a process of its own: `short_attention` at ViT-B/16 224 px b128 (B
128, H 12, N 197, hd 64) and at N 128 and 256, `flash_attention` at 384 px
b64 (N 577) and at the auto-flash shapes (B 2, N 2,048 and 4,096), all in
bf16 on the (B, H, N, hd) views of (B, N, H, hd) tensors the HF-layout
ViT's graph hands over, each beside one `F.scaled_dot_product_attention`
call on the same views; and `vit_attention_block` at ViT-B/16 b128 bf16.
Kernel times by CUDA-graph replay (`chip_smoke.graph_ms`), operand sets
rotated past the 50 MB L2 cache.

    python3 experiments/torch_attention_timing.py PARENT_ROOT CHANGE_ROOT

Run it on a machine with one CUDA card; each root holds a checkout with its
`smelter_tpu_torch` and `chip_smoke.py` (unpack the parent with `git
archive`). Prints the card, one JSON line a run ([kernel ms, SDPA ms] for
each attention shape) and the change's median over the parent's for each
kernel (about 3 minutes on an H100, the builds included).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

CHILD = r"""
import json, sys
root = sys.argv[1]
sys.path.insert(0, root)
import numpy as np
import torch
import torch.nn.functional as F
import chip_smoke as cs
from smelter_tpu_torch.kernels import attention_short as sa, flash_attention as fa
from smelter_tpu_torch.kernels import vit_block as vb
from smelter_tpu_torch.passes.vit_block import pack_qkv_weights

dev = torch.device("cuda")
gen = torch.Generator(device="cuda").manual_seed(0)
side = torch.cuda.Stream()
H, hd = 12, 64


def bnhd(B, N):
    return (torch.randn(B, N, H, hd, device=dev, generator=gen).to(torch.bfloat16)
            .permute(0, 2, 1, 3))


out = {"root": root}
for name, fn, B, N in (("short", sa.short_attention, 128, 197),
                       ("short", sa.short_attention, 128, 128),
                       ("short", sa.short_attention, 128, 256),
                       ("flash", fa.flash_attention, 64, 577),
                       ("flash", fa.flash_attention, 2, 2048),
                       ("flash", fa.flash_attention, 2, 4096)):
    sets = [tuple(bnhd(B, N) for _ in range(3))
            for _ in range(cs._copies(2 * B * H * 4 * N * hd))]
    n, iters = len(sets), (10 if B * N * N < 2e7 else 5)
    out[f"{name} B{B} N{N}"] = [
        cs.graph_ms(torch, side, lambda i: fn(*sets[i % n], scale=0.125), iters),
        cs.graph_ms(torch, side, lambda i: F.scaled_dot_product_attention(
            *sets[i % n], scale=0.125), iters)]
    del sets
D, B, N = H * hd, 128, 197


def vit_args(seed):
    rng = np.random.default_rng(seed)

    def t(a, dt=torch.bfloat16):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev, dt)

    wpk, bpk = pack_qkv_weights(rng.standard_normal((D, 3 * D)) / np.sqrt(D),
                                rng.standard_normal(3 * D) * 0.02, H)
    return [t(rng.standard_normal((B, N, D)) * 0.5), t(np.ones(D), torch.float32),
            t(np.zeros(D), torch.float32), t(wpk), t(bpk, torch.float32),
            t(rng.standard_normal((D, D)) / np.sqrt(D)), t(np.zeros(D), torch.float32)]


vsets = [vit_args(s) for s in range(2)]
out["vit_attention_block b128"] = [cs.graph_ms(
    torch, side, lambda i: vb.vit_attention_block(*vsets[i % 2], heads=H), 10), None]
print("RESULT " + json.dumps(out), flush=True)
"""


def run(root: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", CHILD, root], capture_output=True, text=True,
                          check=False)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    if proc.returncode != 0 or not lines:
        sys.exit(f"{root} failed ({proc.returncode}):\n{proc.stdout[-3000:]}\n"
                 f"{proc.stderr[-3000:]}")
    return json.loads(lines[-1][len("RESULT "):])


def main() -> int:
    parent, change = sys.argv[1], sys.argv[2]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    runs = {parent: [], change: []}
    for root in (parent, change, change, parent):
        r = run(root)
        runs[root].append(r)
        print(json.dumps(r), flush=True)
    keys = [k for k in runs[parent][0] if k != "root"]
    summary = {k: {"parent": [r[k][0] for r in runs[parent]],
                   "change": [r[k][0] for r in runs[change]],
                   "change_over_parent": statistics.median(r[k][0] for r in runs[change])
                   / statistics.median(r[k][0] for r in runs[parent])} for k in keys}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
