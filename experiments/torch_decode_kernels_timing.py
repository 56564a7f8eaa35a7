#!/usr/bin/env python3
"""`int4_matmul` and `paged_decode_attention` of two checkouts, and the
llama_1b decode paths that run them, on one CUDA card, A B B A.

    python3 experiments/torch_decode_kernels_timing.py PARENT_ROOT CHANGE_ROOT

Each root runs four times in all (parent, change, change, parent), each run
in a process of its own that imports that root's `smelter_tpu_torch` and
`chip_smoke` (unpack the parent with `git archive`): `int4_matmul` at each
of llama_1b's five decode shapes (int4-g128, bf16 x and out) at M 8 and
M 1 (CUDA-graph replay over operand copies that outrun the L2 cache; a
step's 169 calls summed); a paged step's 24 `paged_decode_attention` calls
(8 slots, int8 pools of 128-row pages, positions spread over 0-511, graph
replay); the 24-layer paged decode step (host-timed ms and device-busy ms
from a profile); and `FusedGenerator` (ms a token, K-differenced over 16 ->
272 new tokens, and device-busy ms a token from a profile of 20 replays).
Prints the card's name and power limit, one JSON line a run, then the
medians (about 10 minutes on an H100 with both builds).
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
from smelter_tpu_torch.kernels import int4_matmul as i4
from smelter_tpu_torch.kernels import paged_decode_attention as pda
from smelter_tpu_torch.runtime.executor import Executor
from smelter_tpu_torch.runtime.generate import FusedGenerator

torch.backends.cuda.matmul.allow_tf32 = False
gen = torch.Generator(device="cuda").manual_seed(7)
side = torch.cuda.Stream()
bf16 = torch.bfloat16
G = cs.GROUP
res = {"root": root, "int4": {}}

# int4_matmul at each decode shape, M 8 and M 1
for (N, K), calls in cs.DECODE_GEMMS.items():
    ws = [(torch.randint(-128, 128, (K // 2, N), device="cuda", generator=gen, dtype=torch.int8),
           torch.rand(K // G, N, device="cuda", generator=gen) * 0.02 + 1e-3)
          for _ in range(cs._copies(K * N // 2 + K // G * N * 4))]
    n = len(ws)
    for M in (8, 1):
        xs = [torch.randn(M, K, device="cuda", generator=gen).to(bf16) for _ in ws]
        ms = cs.graph_ms(torch, side, lambda i: i4.int4_matmul(
            xs[i % n], *ws[i % n], group=G, out_dtype=bf16), 20)
        res["int4"][f"m{M}_n{N}_k{K}"] = {"ms": ms, "calls": calls}
    del ws, xs
res["int4_step_ms"] = {f"m{M}": sum(v["ms"] * v["calls"] for k, v in res["int4"].items()
                                    if k.startswith(f"m{M}_")) for M in (8, 1)}

# a paged step's 24 attention calls at chip_smoke's decode shape
kvh, g, hd = cs.LLAMA_1B["kv_heads"], cs.LLAMA_1B["heads"] // cs.LLAMA_1B["kv_heads"], 128
P_ = 1 + cs.SLOTS * cs.NPG
pos = torch.tensor([0, 73, 127, 128, 292, 365, 438, 511], device="cuda")
table = (1 + torch.randperm(P_ - 1, device="cuda", generator=gen)).reshape(cs.SLOTS, cs.NPG)
table = table.to(torch.int32)
kw = dict(c=1, kv_heads=kvh, scale=hd ** -0.5)
sets = []
for _ in range(cs._copies(2 * P_ * cs.PAGE * kvh * hd)):
    q = torch.randn(cs.SLOTS, kvh, g, hd, device="cuda", generator=gen).to(bf16)
    k, v = (torch.randint(-127, 128, (P_, cs.PAGE, kvh * hd), device="cuda", generator=gen,
                          dtype=torch.int8) for _ in range(2))
    ks, vs = ((torch.rand(P_, cs.PAGE, 1, device="cuda", generator=gen) * 0.02 + 1e-3).to(bf16)
              for _ in range(2))
    sets.append((q, k, v, table, pos, ks, vs))
n = len(sets)
ms = cs.graph_ms(torch, side, lambda i: pda.paged_decode_attention(*sets[i % n], **kw), 50)
res["paged_attention"] = {"ms": ms, "step_ms": ms * cs.LLAMA_1B["layers"]}
del sets

# the 24-layer paged decode step
g24 = cs._llama_graph(cs.LLAMA_1B["layers"])
by = cs._step_inputs(np, g24)
ex = Executor(g24, stt.Config(compute_dtype="bfloat16"))
params = ex.cast_params(ex.init_params())
fn = ex.build_fn()
dev_in = [torch.from_numpy(by[v.name]).cuda() for v in g24.inputs]
dev_in = [t.to(bf16) if t.is_floating_point() else t for t in dev_in]
step_ms = cs.time_ms(torch, lambda i: fn(params, *dev_in), 10)
kern, _, _ = cs._profile(torch, lambda: fn(params, *dev_in))
res["paged_step"] = {"step_ms": step_ms, "busy_ms": sum(kern.values()),
                     "int4_ms": sum(v for k, v in kern.items() if "int4_matmul" in k),
                     "attention_ms": sum(v for k, v in kern.items() if "decode_attention::" in k)}
del g24, ex, params, fn, dev_in
torch.cuda.empty_cache()

# FusedGenerator
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
    "int4_ms_per_token": sum(v for k, v in kern.items() if "int4_matmul" in k)}
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
    keys = {"int4_step_m8_ms": lambda r: r["int4_step_ms"]["m8"],
            "int4_step_m1_ms": lambda r: r["int4_step_ms"]["m1"],
            "paged_attention_step_ms": lambda r: r["paged_attention"]["step_ms"],
            "paged_step_ms": lambda r: r["paged_step"]["step_ms"],
            "paged_step_busy_ms": lambda r: r["paged_step"]["busy_ms"],
            "fused_generator_ms_per_token": lambda r: r["fused_generator"]["ms_per_token"],
            "fused_generator_busy_ms_per_token":
                lambda r: r["fused_generator"]["busy_ms_per_token"]}
    keys.update({f"int4_{c}_ms": (lambda r, c=c: r["int4"][c]["ms"])
                 for c in runs[parent][0]["int4"]})
    print(json.dumps({"card": smi,
                      "median": {name: {"parent": statistics.median(f(r) for r in runs[parent]),
                                        "change": statistics.median(f(r) for r in runs[change])}
                                 for name, f in keys.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
