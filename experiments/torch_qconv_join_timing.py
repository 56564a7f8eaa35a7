#!/usr/bin/env python3
"""`qlinear_conv` and `int8_join` at ResNet-50's batch-128 shapes, and the
int8-static ResNet-50 forward, on one CUDA card.

    python3 experiments/torch_qconv_join_timing.py [PARENT_ROOT CHANGE_ROOT]

Without arguments, in this checkout: each of ResNet-50's 23 distinct convs
on the form `wgmma_plan.qconv_plan` picks, on the mma.sync kernel (form 0
of `csrc/qlinear_conv.cu`, called through the library on the same
operands; its output checked equal) and as cuDNN's bf16 conv, CUDA-graph
replay, summed over a forward's 53 calls; each residual join shape on the
join kernel and on its plain version (the unfused chain), over a forward's
16. With two checkout roots (unpack the parent with `git archive`), also
the int8-static ResNet-50 b128 bf16 forward of each, A B B A, each in a
process of its own: images/s by CUDA events over 20 forwards, the idle
share and the top kernels from a profile of 2. Prints the card's name and
power limit, then one JSON line a result (about 5 minutes on an H100).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

FORWARD = r"""
import json, sys, time
root = sys.argv[1]
sys.path.insert(0, root)
import numpy as np
import torch
import chip_smoke as cs
import smelter_tpu_torch as stt
from smelter_tpu_torch.models import resnet50

g, _, shape = resnet50.build(batch=128, image_size=224)
x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
calib = [(np.random.default_rng(s).standard_normal((8,) + shape[1:]).astype(np.float32),)
         for s in (10, 11)]
model = stt.compile(g, stt.Config(compute_dtype="bfloat16"), quant="int8-static",
                    calibration_data=calib, device="cuda")
xg = torch.from_numpy(x).cuda()
model.run_device(xg)
step = cs.time_ms(torch, lambda i: model.run_device(xg), 20)
per, by_op, n_k = cs._profile(torch, lambda: model.run_device(xg), steps=2)
busy = sum(per.values())
print("RESULT " + json.dumps({
    "root": root, "step_ms": step, "images_per_s": 128e3 / step, "busy_ms": busy,
    "idle_share": max(0.0, 1 - busy / step), "kernels_per_forward": n_k,
    "top_kernels_ms": sorted(per.items(), key=lambda kv: -kv[1])[:6]}), flush=True)
"""


def forward(root: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", FORWARD, root], capture_output=True,
                          text=True, check=False)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    if proc.returncode != 0 or not lines:
        sys.exit(f"{root} failed ({proc.returncode}):\n{proc.stdout[-3000:]}\n"
                 f"{proc.stderr[-3000:]}")
    return json.loads(lines[-1][len("RESULT "):])


def kernels(power_w: float) -> None:
    import torch
    import torch.nn.functional as F

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from smelter_tpu_torch.kernels import _build
    from smelter_tpu_torch.kernels import int8_join as ij
    from smelter_tpu_torch.kernels import qlinear_conv as qc
    from smelter_tpu_torch.kernels import wgmma_plan

    gen = torch.Generator(device="cuda").manual_seed(7)
    side = torch.cuda.Stream()
    cl, i8, B = torch.channels_last, torch.int8, 128
    lib = _build.library("qlinear_conv")
    sums = {"form": 0.0, "mma": 0.0, "cudnn": 0.0, "bound": 0.0}
    for (cin, cout, k, s, h), calls in cs.resnet50_convs().items():
        p = k // 2
        ho = (h + 2 * p - k) // s + 1
        x = torch.randint(-128, 128, (B, cin, h, h), device="cuda", generator=gen,
                          dtype=i8).contiguous(memory_format=cl)
        w = torch.randint(-127, 128, (cout, cin, k, k), device="cuda", generator=gen,
                          dtype=i8).contiguous(memory_format=cl)
        m = (torch.rand(cout, device="cuda", generator=gen) + 0.5) * 0.0074 / (k * k * cin) ** 0.5
        b = (torch.rand(cout, device="cuda", generator=gen) - 0.5) * 40
        kw = dict(stride=(s, s), pads=((p, p), (p, p)))
        plan = wgmma_plan.qconv_plan(B, h, h, cin, cout, k, k, s, s, kw["pads"])
        out = torch.empty((B, cout, ho, ho), dtype=i8, device="cuda", memory_format=cl)
        wp = w.permute(0, 2, 3, 1)

        def mma(i):
            rc = lib.smelter_qlinear_conv(x.data_ptr(), wp.data_ptr(), m.data_ptr(), b.data_ptr(),
                                          out.data_ptr(), B, h, h, cin, ho, ho, cout, k, k, s, s,
                                          p, p, 0, 0, 64, 128, 0, _build.stream_of(x))
            _build.check(lib, rc, "qlinear_conv mma.sync")

        got = qc.qlinear_conv(x, w, m, b, **kw)
        mma(0)
        torch.cuda.synchronize()
        assert torch.equal(got, out), (cin, cout, k, s, h)
        xl, wl = x.to(torch.bfloat16), w.to(torch.bfloat16)
        nbytes = B * h * h * cin + cout * k * k * cin + 8 * cout + B * ho * ho * cout
        r = {"shape": [B, cin, h, h, cout, k, s], "form": plan.form, "calls": calls,
             "form_ms": cs.graph_ms(torch, side, lambda i: qc.qlinear_conv(x, w, m, b, **kw), 10),
             "mma_ms": cs.graph_ms(torch, side, mma, 10),
             "cudnn_bf16_ms": cs.graph_ms(torch, side, lambda i: F.conv2d(
                 xl, wl, stride=s, padding=p), 10),
             "bound_ms": cs.bound(nbytes, 2 * B * ho * ho * cout * k * k * cin, "int8",
                                  power_w)[0]}
        for key, col in (("form", "form_ms"), ("mma", "mma_ms"), ("cudnn", "cudnn_bf16_ms"),
                         ("bound", "bound_ms")):
            sums[key] += r[col] * calls
        print(json.dumps(r), flush=True)
        del x, w, xl, wl, out, got
    print(json.dumps({"qlinear_conv_a_forward_ms": sums}), flush=True)
    jsum = {"kernel": 0.0, "plain": 0.0, "bound": 0.0}
    for (c, hw, q8), calls in cs.RESNET_JOINS.items():
        a, b_ = (torch.randint(-128, 128, (B, c, hw, hw), device="cuda", generator=gen,
                               dtype=i8).contiguous(memory_format=cl) for _ in range(2))
        inv = 1 / 0.0643 if q8 else None
        assert torch.equal(ij.int8_join(a, b_, 0.0371, 0.0517, inv),
                           ij.int8_join_plain(a, b_, 0.0371, 0.0517, inv))
        el = B * c * hw * hw
        r = {"shape": [B, c, hw, hw], "out": "int8" if q8 else "f32", "calls": calls,
             "kernel_ms": cs.graph_ms(torch, side, lambda i: ij.int8_join(
                 a, b_, 0.0371, 0.0517, inv), 10),
             "plain_ms": cs.graph_ms(torch, side, lambda i: ij.int8_join_plain(
                 a, b_, 0.0371, 0.0517, inv), 3),
             "bound_ms": cs.bound(el * (3 if q8 else 6), 7 * el, "f32", power_w)[0]}
        r["gb_s"] = el * (3 if q8 else 6) / r["kernel_ms"] / 1e6
        for key in jsum:
            jsum[key] += r[key + "_ms"] * calls
        print(json.dumps(r), flush=True)
        del a, b_
    print(json.dumps({"int8_join_a_forward_ms": jsum}), flush=True)


def main() -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    kernels(float(smi.splitlines()[0].split(",")[-1].strip().split()[0]))
    if len(sys.argv) == 3:
        parent, change = sys.argv[1], sys.argv[2]
        runs = {parent: [], change: []}
        for root in (parent, change, change, parent):
            r = forward(root)
            runs[root].append(r)
            print(json.dumps(r), flush=True)
        med = {k: statistics.median(r["step_ms"] for r in v) for k, v in runs.items()}
        print(json.dumps({"step_ms_median": med, "change_over_parent": med[change] / med[parent]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
