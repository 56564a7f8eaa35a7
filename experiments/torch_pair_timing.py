#!/usr/bin/env python3
"""Two checkouts of the port timed on one card in turns, A B B A, each run
in a process of its own: the image kernels' rows of the checkout's own
`chip_smoke.py` phase 2 (`pixel_conv_rowdot` and `pixel_conv_rowdot_q`
summed over an ESRGAN x4 batch-8 forward's 349 calls, CUDA-graph replay)
and a ResNet-50 batch-128 int8 forward in bf16 (default routing, then
`use_pallas`), CUDA events over 20 forwards.

    python3 experiments/torch_pair_timing.py PARENT_ROOT CHANGE_ROOT

Run it on a machine with one CUDA card; each root holds a checkout with
its `smelter_tpu_torch` and `chip_smoke.py` (unpack the parent with
`git archive`). Prints the card, one JSON line a run, and the change's
median over the parent's for each number (about 9 minutes on an H100).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

CHILD = r"""
import copy, json, sys
root = sys.argv[1]
sys.path.insert(0, root)
import numpy as np
import torch
import chip_smoke as cs
import smelter_tpu_torch as stt
from smelter_tpu_torch.models import resnet50

out = {"root": root}
rows = cs.phase_image_kernels(torch, 700.0)
for name in ("pixel_conv_rowdot", "pixel_conv_rowdot_q"):
    out[name + "_ms"] = cs.per_forward(rows, name)["ms"]
g, _, shape = resnet50.build(batch=128, image_size=224)
x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
xg = torch.from_numpy(x).cuda()
for label, cfg in (("resnet50_bf16_default", stt.Config(compute_dtype="bfloat16")),
                   ("resnet50_bf16_use_pallas",
                    stt.Config(compute_dtype="bfloat16", use_pallas=True))):
    model = stt.compile(copy.deepcopy(g), cfg, quant="int8", device="cuda")
    model(x[:8])
    out[label + "_ms"] = cs.time_ms(torch, lambda i: model.run_device(xg), 20)
    del model
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
    keys = [k for k in runs[parent][0] if k.endswith("_ms")]
    summary = {k: {"parent": [r[k] for r in runs[parent]], "change": [r[k] for r in runs[change]],
                   "change_over_parent": statistics.median(r[k] for r in runs[change])
                   / statistics.median(r[k] for r in runs[parent])} for k in keys}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
