#!/usr/bin/env python3
"""How `vit_attention_block`'s time divides among its launches (pre-LN, the
QKV GEMM, attention, the output projection), on one CUDA card, on the
wrapper's forms and on the earlier mma.sync kernels.

    python experiments/torch_vit_block_split.py

Builds `csrc/vit_block.cu` only and runs `chip_smoke.vit_split_all`: ViT-B/16
at B 128 (N 197, D 768, 12 heads) and SD-UNet's self-attention at B 8 (hd 16
over 1024 tokens, hd 32 over 256), bf16 activations and params, each on both
routes, split by launch from one torch.profiler session and timed by
CUDA-graph replay. `chip_smoke.py` phase 2 prints the same split. Prints
one JSON object with the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from smelter_tpu_torch.kernels import _build  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    _build.build(["vit_block"])
    out = cs.vit_split_all(torch, np)
    for label, runs in out.items():
        print(label, "; ".join(f"{r['route']} {r['ms']:.4f} ms ("
                                + ", ".join(f"{k} {v['ms']:.4f}" for k, v in r["split"].items())
                                + ")" for r in runs), flush=True)
    print(json.dumps({"card": smi, **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
