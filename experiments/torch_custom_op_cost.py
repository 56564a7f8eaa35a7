#!/usr/bin/env python3
"""Host cost of calling `int4_matmul` through its `torch.library` custom op,
on one CUDA card.

    python experiments/torch_custom_op_cost.py [--layers 24] [--steps 20]

The kernel wrappers of `smelter_tpu_torch/kernels/` are custom ops so that
`torch.func.vmap` can fold a vmapped decode step onto one launch (their
vmap rules); a call that is not vmapped can instead launch the kernel
directly. This script measures what the custom op's dispatch costs the
host, in runs ordered direct, op, op, direct:

- per call: host time of 2,000 calls of `int4_matmul` at M 8, N 2048,
  K 2048, bf16, straight to the launch (`_call`) or through the op (`_op`);
- per step: the eager llama_1b paged decode step of `chip_smoke.py` phase
  5 (full width, int4-g128, int8 KV pools, bf16, 169 `int4_matmul` calls),
  with the step's `int4_matmul` calls routed one way or the other.

Prints one JSON object with every run and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
import smelter_tpu_torch as stt  # noqa: E402
from smelter_tpu_torch.kernels import int4_matmul as i4  # noqa: E402
from smelter_tpu_torch.ops import fused_ops  # noqa: E402
from smelter_tpu_torch.runtime.executor import Executor  # noqa: E402


def direct(x, pk, s, *, group, out_dtype=torch.float32):
    return i4._call(x, pk, s, int(group), out_dtype)


def through_op(x, pk, s, *, group, out_dtype=torch.float32):
    return i4._op(x, pk, s, int(group), out_dtype)


ROUTES = {"direct": direct, "op": through_op}
ORDER = ("direct", "op", "op", "direct")


def host_ms(fn, n: int) -> float:
    """Wall ms of n calls of fn from the host, the card drained on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / n


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=cs.LLAMA_1B["layers"])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--calls", type=int, default=2000)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(8, 2048, device="cuda", generator=gen).to(torch.bfloat16)
    pk = torch.randint(-128, 128, (1024, 2048), device="cuda", generator=gen, dtype=torch.int8)
    sc = torch.rand(16, 2048, device="cuda", generator=gen) * 0.02 + 1e-3
    res = {"card": smi, "per_call_ms": [], "per_step_ms": []}
    for route in ORDER:
        fn = ROUTES[route]
        host_ms(lambda: fn(x, pk, sc, group=128, out_dtype=torch.bfloat16), 50)
        res["per_call_ms"].append(
            (route, host_ms(lambda: fn(x, pk, sc, group=128, out_dtype=torch.bfloat16), a.calls)))

    g = cs._llama_graph(a.layers)
    by = cs._step_inputs(np, g)
    ex = Executor(g, stt.Config(compute_dtype="bfloat16"))
    params = ex.cast_params(ex.init_params())
    step = ex.build_fn()
    ins = [torch.from_numpy(by[v.name]).cuda() for v in g.inputs]
    ins = [t.to(torch.bfloat16) if t.is_floating_point() else t for t in ins]
    for route in ORDER:
        fused_ops.int4_matmul = ROUTES[route]
        host_ms(lambda: step(params, *ins), 3)
        res["per_step_ms"].append((route, host_ms(lambda: step(params, *ins), a.steps)))
    fused_ops.int4_matmul = i4.int4_matmul

    def mean(rows, route):
        return float(np.mean([ms for r, ms in rows if r == route]))

    for key in ("per_call_ms", "per_step_ms"):
        rows = res[key]
        res[key + "_op_minus_direct"] = mean(rows, "op") - mean(rows, "direct")
        res[key + "_spread_within_route"] = max(
            abs(rows[0][1] - rows[3][1]), abs(rows[1][1] - rows[2][1]))
    res["int4_calls_a_step"] = 7 * a.layers + 1
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
