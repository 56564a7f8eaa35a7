#!/usr/bin/env python3
"""`convnext_block` and `ragged_decode_attention` of two checkouts, and the
paths that run them, on one CUDA card, A B B A.

    python3 experiments/torch_convnext_ragged_timing.py PARENT_ROOT CHANGE_ROOT

Each root runs four times in all (parent, change, change, parent), each run
in a process of its own that imports that root's `smelter_tpu_torch` and
`chip_smoke` (unpack the parent with `git archive`): `convnext_block` at
ConvNeXt-T's three fused stages at batch 64 in bf16 (CUDA-graph replay over
operand copies that outrun the L2 cache, summed over a forward's 3 + 3 + 9
calls); `ragged_decode_attention` at `chip_smoke`'s four decode cases
(`_ragged_case`: graph replay, bf16, int8 caches); the fused ConvNeXt-T b64
bf16 forward (CUDA events over 20 forwards, idle share from a profile of
2, the block kernels' device ms); and llama_1b's `FusedGenerator` (ms a
token, K-differenced over 16 -> 272 new tokens, and the decode attention
kernels' device ms a token from a profile of 20 replays). Prints the card's
name and power limit, one JSON line a run, then the medians (about 12
minutes on an H100 with both builds).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

RUN = r"""
import json, sys, time
root = sys.argv[1]
sys.path.insert(0, root)
import numpy as np
import torch
import chip_smoke as cs
import smelter_tpu_torch as stt
from smelter_tpu_torch.kernels import convnext_block as cb
from smelter_tpu_torch.runtime.executor import CompiledModel
from smelter_tpu_torch.runtime.generate import FusedGenerator

torch.backends.cuda.matmul.allow_tf32 = False
gen = torch.Generator(device="cuda").manual_seed(7)
side = torch.cuda.Stream()
bf16, f32 = torch.bfloat16, torch.float32
res = {"root": root}


def rnd(*shape, s=1.0, dtype=bf16):
    return (torch.randn(*shape, device="cuda", generator=gen) * s).to(dtype)


# convnext_block at the three fused stages, a forward's calls
stages, total = [], 0.0
for (hw, C), calls in zip(((56, 96), (28, 192), (14, 384)), (3, 3, 9)):
    B, Fh = 64, 4 * C
    nbytes = 2 * (2 * B * hw * hw * C + 49 * C + 2 * C * Fh)
    sets = [(rnd(B, hw, hw, C), rnd(7, 7, 1, C, s=1 / 7), rnd(C, s=0.1, dtype=f32),
             1 + rnd(C, s=0.1, dtype=f32), rnd(C, s=0.1, dtype=f32), rnd(C, Fh, s=C ** -0.5),
             rnd(Fh, s=0.1, dtype=f32), rnd(Fh, C, s=Fh ** -0.5), rnd(C, s=0.1, dtype=f32),
             0.5 + rnd(C, s=0.1, dtype=f32)) for _ in range(cs._copies(nbytes))]
    n = len(sets)
    ms = cs.graph_ms(torch, side, lambda i: cb.convnext_block(*sets[i % n]), 5)
    stages.append({"shape": [B, hw, hw, C], "calls": calls, "ms": ms})
    total += calls * ms
    del sets
res["convnext_block"] = {"stages": stages, "forward_ms": total}

# ragged_decode_attention at chip_smoke's decode cases
spread = [0, 73, 127, 128, 292, 365, 438, 511]
res["ragged"] = {}
for label, B, c, L, pos in (("b8_l512", 8, 1, 512, spread), ("c5_b1_pos511", 1, 5, 512, [511]),
                            ("b8_l4096", 8, 1, 4096, [p * 8 for p in spread[:-1]] + [4095]),
                            ("b1_l512_pos280", 1, 1, 512, [280])):
    r = cs._ragged_case(torch, gen, side, 700.0, label, B, c, L, pos, bf16, 1e-2, 0)
    res["ragged"][label] = {k: r[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")}

# the fused ConvNeXt-T b64 forward
g = cs._prepared(stt, cs._convnext_graph(torch, 64), fuse_convnext=True)
model = CompiledModel(g, stt.Config(compute_dtype="bfloat16"))
xg = torch.from_numpy(np.random.default_rng(14).standard_normal(
    (64, 3, 224, 224)).astype(np.float32)).cuda()
model.run_device(xg)
step = cs.time_ms(torch, lambda i: model.run_device(xg), 20, warmup=1)
per, _, n_k = cs._profile(torch, lambda: model.run_device(xg), steps=2)
busy = sum(per.values())
res["convnext_t_fused"] = {
    "step_ms": step, "images_per_s": 64e3 / step, "busy_ms": busy,
    "idle_share": max(0.0, 1 - busy / step), "kernels_per_forward": n_k,
    "block_kernels_ms": sum(v for k, v in per.items() if cs._PORT_BLOCK_KERNEL.search(k)),
    "top_kernels_ms": sorted(per.items(), key=lambda kv: -kv[1])[:6]}
del model, g, xg
torch.cuda.empty_cache()

# llama_1b's FusedGenerator
step_g, pfs = cs._static_graphs(cs.LLAMA_1B["layers"])
fg = FusedGenerator(step_g, stt.Config(compute_dtype="bfloat16", ragged_attention=True),
                    prefill_graph=pfs)
prompt = list(range(1, 9))
fg.generate(prompt, 16)


def best(n):
    t = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        fg.generate(prompt, n)
        t = min(t, time.perf_counter() - t0)
    return t


per_tok = (best(272) - best(16)) / 256
kern, _, _ = cs._profile(torch, fg._graph(False, 0).replay, steps=20)
res["fused_generator"] = {
    "ms_per_token": 1e3 * per_tok, "busy_ms_per_token": sum(kern.values()),
    "decode_attention_ms_per_token": sum(v for k, v in kern.items()
                                         if "decode_attention::" in k)}
print("RESULT " + json.dumps(res), flush=True)
"""


def run(root: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", RUN, root], capture_output=True, text=True,
                          check=False, cwd=root)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    if proc.returncode != 0 or not lines:
        sys.exit(f"{root} failed ({proc.returncode}):\n{proc.stdout[-3000:]}\n"
                 f"{proc.stderr[-3000:]}")
    return json.loads(lines[-1][len("RESULT "):])


def main() -> int:
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    parent, change = sys.argv[1], sys.argv[2]
    runs = {parent: [], change: []}
    for root in (parent, change, change, parent):
        r = run(root)
        runs[root].append(r)
        print(json.dumps(r), flush=True)
    keys = {"convnext_block_forward_ms": lambda r: r["convnext_block"]["forward_ms"],
            "convnext_t_fused_step_ms": lambda r: r["convnext_t_fused"]["step_ms"],
            "fused_generator_ms_per_token": lambda r: r["fused_generator"]["ms_per_token"],
            "decode_attention_ms_per_token":
                lambda r: r["fused_generator"]["decode_attention_ms_per_token"]}
    keys.update({f"ragged_{c}_ms": (lambda r, c=c: r["ragged"][c]["ms"])
                 for c in runs[parent][0]["ragged"]})
    print(json.dumps({"median": {name: {"parent": statistics.median(f(r) for r in runs[parent]),
                                        "change": statistics.median(f(r) for r in runs[change])}
                                 for name, f in keys.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
