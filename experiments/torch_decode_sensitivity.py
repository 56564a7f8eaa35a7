#!/usr/bin/env python3
"""How far a last-bit change moves the port's paged decode step, on the CPU.

    python experiments/torch_decode_sensitivity.py --layers 2           # llama_1b width
    python experiments/torch_decode_sensitivity.py --layers 24 --dim 512 --ffn 1408 \
        --heads 4 --kv-heads 2 --vocab 2048

Builds the llama_style paged step graph as `chip_smoke.py` phase 5 does
(int4-g128 weights, int8 KV pools, its step inputs), runs one f32 step on
the CPU with the kernels' plain versions, runs it again with the int4
products summed in f64 instead of f32, and prints the largest logit change
over the largest logit. The rounding of activations to bf16 (in each int4
product) and of the KV rows to int8 turns such last-bit changes into whole
steps, which the layers carry on; `chip_smoke.py` sets its f32 bounds for
the card's step from these numbers.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
import smelter_tpu_torch as stt  # noqa: E402
from smelter_tpu_torch.kernels import int4_matmul as i4  # noqa: E402
from smelter_tpu_torch.runtime.executor import Executor  # noqa: E402


def int4_matmul_f64(x, pk, s, *, group, out_dtype=torch.float32):
    """int4_matmul_plain with the group dots and their sum in f64."""
    m, k = x.shape
    ng = k // group
    xg = x.to(torch.bfloat16).double().reshape(m, ng, group).transpose(0, 1)
    wg = i4.unpack_int4_half(pk).double().reshape(ng, group, pk.shape[1])
    part = torch.bmm(xg, wg) * s.double().reshape(ng, 1, pk.shape[1])
    return (part[: ng // 2] + part[ng // 2:]).sum(0).to(out_dtype)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=2)
    for k in ("vocab", "dim", "heads", "kv_heads", "ffn"):
        ap.add_argument("--" + k.replace("_", "-"), type=int, default=cs.LLAMA_1B[k])
    ap.add_argument("--threads", type=int, default=4)
    a = ap.parse_args()
    torch.set_num_threads(a.threads)
    cs.LLAMA_1B = dict(vocab=a.vocab, dim=a.dim, heads=a.heads, kv_heads=a.kv_heads, ffn=a.ffn,
                       layers=a.layers)
    g = cs._llama_graph(a.layers)
    by = cs._step_inputs(np, g)
    names = [v.name for v in g.inputs]

    def step():
        ex = Executor(g, stt.Config(device="cpu"))
        out = ex.build_fn()(ex.init_params(), *[torch.from_numpy(by[n].copy()) for n in names])
        return out[0].numpy()[:, -1]

    ref = step()
    i4.int4_matmul_plain = int4_matmul_f64
    got = step()
    rel = float(np.abs(got - ref).max() / np.abs(ref).max())
    print(f"{cs.LLAMA_1B}: int4 sums in f64 move the f32 logits by {rel:.3g} of the largest "
          f"(top-1 agreement {float((got.argmax(1) == ref.argmax(1)).mean()):.3f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
