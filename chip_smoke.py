#!/usr/bin/env python3
"""Smoke test of smelter_tpu_torch, the PyTorch/CUDA port, on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA H100, the CUDA
toolkit (`nvcc`) and PyTorch built for CUDA. It imports nothing of JAX and
nothing of the JAX package. Phases, each printing a line that starts with
its number:

1. environment: the card's name and power limit, torch and CUDA versions,
   and the build of every kernel from `smelter_tpu_torch/csrc/`, all
   `nvcc` processes at once;
2. kernels against their plain PyTorch versions on the card, with their
   device times (CUDA-graph replay of many launches), the host cost of one
   call, the plain versions' times, a PyTorch library call's time as a
   yardstick, and the least time the card could take (the bound):
   `dequant_matmul` and `int8_matmul` at the ResNet-50 head shape and at a
   serving GEMM shape, `dequant_matmul` also at odd shapes in bf16, f16 and
   with f32 out (two calls bit-equal); `int4_matmul` at M = 8 and at M = 1
   (FusedGenerator's single stream) for each N x K of llama_1b's decode
   step, each on its wgmma form, with the step's sums, checked also at the
   prefill graphs' M of 64 and 256, `paged_decode_attention` at its decode
   shape (8 slots, int8 pools, positions spread over 0-511; its split plan
   named, two calls bit-equal) and at SpecPagedDecodeServer's verify
   (g 2 x c 5 = 10 query rows a KV head), and `ragged_decode_attention`
   at the static-cache step's (8 slots over a 512-row int8 cache), at a
   chunk c 5 of one slot at row 511 with g 1, over 4096 rows, at
   FusedGenerator's one slot at row 280, at SpecDecodeServer's verify (8
   slots, g 2 x c 5) and at its tiny draft's step (8 slots, 4 KV heads of
   32, bf16 caches) (its split-KV kernels);
   `fused_layer_norm` and `residual_layer_norm` over ViT-B/16's batch-128
   activations (25,216 rows of 768) and `vit_attention_block` at B 128,
   N 197, D 768, 12 heads (and in f32 at batch 8), plus small shapes for
   pre_ln=0, both mask forms and head dim 32, and its time split by launch
   (one torch.profiler session in a process of its own: `chip_smoke.py
   --vit-split`) at ViT-B/16 b128 and SD-UNet's two shapes, on the earlier
   mma.sync kernels and on the wgmma cores; `pixel_conv_rowdot` (bf16,
   and f32 at batch 1) and `pixel_conv_rowdot_q` (int8 and bf16 out, on
   its int8 wgmma form; one int8 conv at W 72, which the plan keeps on
   mma.sync, too) at each of ESRGAN x4's PixelConv shapes at batch 8, each
   with its form, `max_unpool2x2` at
   SegNet's three unpools at batch 16, and, on (B, H, N, hd) views of
   (B, N, H, hd) tensors as the HF-layout ViT hands them over,
   `short_attention` at ViT-B/16 224 px (B 128, H 12, N 197, hd 64; f32 at
   batch 8), `flash_attention` at 384 px (B 64, N 577) and at N 2048 and
   4096 (B 2; small in f32), and `mlp_block` at 25,216 rows of 768 with F
   3072 (FC1 and FC2 on gemm_tma; f32 at batch 8 on its FMA kernel, plus a
   small pre_ln=0 / tanh case); the image
   models' block kernels: `convnext_block` at ConvNeXt-T's three fused
   stages at batch 64 (f32 at batch 2), each stage's time split by launch
   (depthwise + LN, FC1, FC2; `chip_smoke.py --convnext-split` in a process
   of its own), `cross_attn_block` at SD-UNet's
   two shapes at batch 8 with k/v per image and shared (its wgmma form's
   grid and clusters, and its mma.sync form timed beside it), and
   `vit_attention_block` at SD-UNet's self-attention (hd 16 over 1024
   tokens, hd 32 over 256); `qlinear_conv` (int8 outputs equal to the
   plain version's, with and without its Relu epilogue; cuDNN's bf16 conv
   as the yardstick) at each of ResNet-50's 23 distinct conv shapes at
   batch 128, each on its wgmma form, and `int8_join` (int8 and f32 out
   equal to the plain version's) at ResNet-50's four join shapes at batch
   128 against its bytes bound, and `dequant_conv`'s
   entry point at ResNet-50's four stride-1 3x3 shapes at batch 128 in bf16
   (its launches: no path of either package reaches it), held there to its
   plain version and in f32 and bf16 at small and odd shapes; and the
   four kernels no path reaches, each through its own entry point, called
   first once at its main shapes (its launches): `dequant_matmul_int8_fused`
   and `_fused2` at the ResNet-50 head and the serving GEMM in bf16 (equal
   to their plain version and to `dequant_matmul_int8`, timed beside it,
   `dequant_matmul_int8_reference` on `torch._int_mm` as the yardstick),
   `pixel_conv_blockdot` (NHCW) and `pixel_conv_patch` (flat NCHW) at each
   of ESRGAN x4's PixelConv shapes at batch 8 in bf16 and at batch 1 in
   f32 (each on the tile its plan chose; blockdot's both wgmma tiles, 8
   rows and 4, timed beside it; every patch call at batch 8 on the wgmma
   form, `_fused` on the panel form at the serving GEMM and the cluster
   form at the head, `_fused2` on the revisit form (persistent TMA-fed int8
   wgmma) at the serving GEMM, beside the mma.sync kernel it ran on before,
   and the cluster form at the head, each call's form recorded), then small odd
   shapes, and a profile showing one kernel a `patch` call (no layout copy);
3. the ResNet-50 path at full width: ResNet-50 (batch 128, 224 px, random
   weights from a seed) exported to ONNX bytes with the port's writer,
   loaded back, and run through `compile(..., quant="int8")` on the card in
   f32 (default routing), bf16 and bf16 with int8 activations under
   `use_pallas=True` (the head on `dequant_matmul` or `int8_matmul`), and
   bf16 on the default routing (the head on its composite, no port kernel),
   checked against the port's CPU run of the same graph, timed in images/s;
4. the server: `serve(..., use_pallas=True, max_batch=16)` answers 32
   threaded requests;
12. (run right after 4) ResNet-50 int8-static on phase 3's ONNX bytes:
   `compile(..., quant="int8-static")` calibrated on the card with two
   batches of 8; (a) batch 8 in f32, the same quantized graph on the CPU
   and on the card: every int8 edge before the global pool equal, the
   head's within one step in 1 % of its elements, logits within 1e-3;
   the card's node-by-node walk and its fused walk (every int8 edge it
   makes, the chain ends among them, equal to the CPU's); (b) batch 128
   in bf16 (53 `qlinear_conv` launches a forward, all on the wgmma forms,
   and 16 `int8_join`, no Relu launched): top-1 against the CPU's
   f32-compute run, images/s, idle share, peak memory, profile, layout
   copies a forward; (c) `serve(..., max_batch=16)` answering 32 threaded
   requests within the bf16 bound;
5. the paged decode serving path at llama_1b's full width and depth (vocab
   32000, dim 2048, 16 heads, 8 KV heads, ffn 5632, 24 layers; random
   weights from a seed), int4-g128 weights, int8 KV pools of 128-row pages,
   bf16: one step against the port's CPU f32 run of the same graph and
   inputs, the step's idle share and the device ms of each host op, then,
   on the first SERVE_LAYERS (4) layers, `PagedDecodeServer` (8 slots)
   serving 34 requests at tick_steps 1 with tokens equal to solo runs, and
   a short run at tick_steps 4; tok/s, ms a tick, peak memory;
7. the static-cache decode path at llama_1b's full width and depth (int4-
   g128, int8 KV caches of 512 rows, bf16, `ragged_attention=True`, prefill
   graphs of 64 and 256 tokens): one step and one 256-token prefill
   forward (logits and int8 cache rows) against the port's CPU f32 runs;
   `FusedGenerator` (the step as a CUDA graph, one replay a token) against
   `Generator`'s tokens, single-stream tok/s K-differenced over n_new
   16->272 as `bench.py --decode` does; on the first SERVE_LAYERS (4)
   layers, `DecodeServer` (8 slots, the step vmapped over slots) serving `bench.py --serve-decode`'s 32 requests plus
   a 100- and a 300-token prompt, every prompt admitted by a prefill, with
   tokens equal to solo runs and to tick_steps 4; and `PagedDecodeServer`
   with the same prefill graphs on phase 5's traffic;
8. ViT-B/16 at full width and depth (224 px, patch 16, dim 768, 12 heads,
   12 layers, MLP 3072, 1000 classes; random weights from seed 0), built by
   the port's zoo builder: (a) batch 8 on the card in f32 against the
   port's CPU f32 run and in bf16 (top-1 on the clear rows); at batch 128
   in bf16, images/s, idle share, top ops and peak memory for (b) the
   default configuration (12 `vit_attention_block` launches a forward, no
   LayerNorm kernel), (c) `use_pallas=True` (12 blocks and 13
   `residual_layer_norm`), (d) the graph without passes under
   `fused_layernorm=True` (25 `fused_layer_norm`, no block), each within
   the bf16 bound of (b); (e) `serve(..., max_batch=16)` answering 32
   threaded requests;
9. ESRGAN x4 (RRDBNet at RealESRGAN_x4plus's width and depth: nf 64, gc
   32, 23 RRDBs; 128 px in; random weights from seed 0), built by the
   port's zoo builder: (a) gates at the zoo's depth 4 and batch 1 against
   the port's CPU runs of the same graph: f32, bf16 within 3x the CPU's own
   bf16 error, and int8-pixel (calibrated on the CPU) with its int8 edges
   compared element for element; (b) at depth 23 and batch 8, images/s,
   idle share, peak memory and a profile of the default bf16 routing (349
   `pixel_conv_rowdot` a forward), of `quant="int8-pixel"` calibrated on
   the card (349 `pixel_conv_rowdot_q`) and of the graph without passes
   (cuDNN's convs, no port kernel); (c) both served; then SegNet (base 32,
   depth 3, 2 classes, 256 px, batch 16): (d) f32 against the CPU's walk
   on the card's pool indices (the indices equal the CPU's own but at
   near-ties) and bf16 within 3x the CPU's bf16 error; (e) the default
   bf16 routing (3 `max_unpool2x2`) and the graph without passes; (f) the
   server;
10. ViT-B/16 in the Hugging Face layout (`tests/torch_hf_vit.py`: separate
   q/k/v Linears, the attention as one unmarked FusedAttention a layer; the
   published widths of google/vit-base-patch16-224 and -384, 12 layers,
   random weights from seed 0), exported on the card by the port's
   exporter: gates at 224 px batch 8 and 384 px batch 2 (f32 and bf16 on
   the card under `use_pallas=True` against the port's CPU f32 run, as
   phase 8); then images/s, idle share, top ops and peak memory of (c) 224
   px b128 bf16 on the default config (library attention, no port kernel),
   (a) the same under `use_pallas` (12 `short_attention`, one
   `residual_layer_norm` per SkipLayerNormalization), (b) 384 px b64 under
   `use_pallas` (12 `flash_attention`), (d) (c)'s graph and the zoo's
   ViT-B/16 with `fuse_mlp_block` (12 `mlp_block`; the zoo also 12
   `vit_attention_block`), each within the bf16 bound of its default; (e) a
   one-node FusedAttention graph at N 4096 and 2048 through `compile` in
   bf16 on the default config (1 `flash_attention` each, against SDPA); (f)
   `serve(..., use_pallas=True, max_batch=16)` answering 32 requests;
11. ConvNeXt-T (the zoo default at facebook/convnext-tiny-224's widths:
   dims 96/192/384/768, depths 3/3/9/3, 1000 classes, 224 px; random
   weights from seed 0, layer scales from [0.2, 0.6)) and SD-UNet (the
   zoo's 256 px configuration: latent 32, base 128, a 16 x 256 context, 8
   heads, the context baked at batch 8), both exported on the card: gates
   at batch 8 for each routing (ConvNeXt-T: the default passes, with 18
   barriers and no port kernel, and `fuse_convnext_block` run after
   `_prepare`, 15 `convnext_block`; SD-UNet: the default, 5
   `vit_attention_block` and the cross-attention on the library
   attention, and the cross branch on, 5 `cross_attn_block` besides),
   as phase 8's; images/s, idle share, top ops and peak memory of each
   routing in bf16 (ConvNeXt-T at batch 64, also under `use_pallas`;
   SD-UNet at 8); the fused ConvNeXt-T served at `max_batch=16`, and the
   cross-on SD-UNet with `buckets=(8,)`, short batches padded;
13. (run right after 2) the ring kernels, W ranks of a `Mesh` on one card
   (the slot transfers are on-card copies, not NVLink): (a)
   `collective_matmul_ag`, `_rs` and `ring_attention_rdma` against their
   plain versions at W 1, 2, 4 and 8 on odd shapes, f32 (TF32 off) within
   1e-5 x max|plain| and bf16 within 1e-2, int8 `ag` equal with sums that
   wrap and int8 `rs` equal with sums that clamp; (b) the Megatron TP MLP at ViT-B/16's widths, batch 128, over 4
   ranks (`tp_allgather_matmul`, tanh GELU, `tp_reducescatter_matmul`; 16
   launches of each kernel) against the product in f32 on the card, timed
   against the partitioner's form, and each kernel alone there; (c) each
   GEMM alone at llama_1b's FFN widths, M 4096; (d)
   `sequence_sharded_attention_rdma` at llama_1b's 16 heads of 128, B 1, N
   32,768 over 4 ranks in bf16 (16 launches), held head by head to the
   plain ring, SDPA over the full sequence as the yardstick, f32 at N 4096;
   a profile of how much of the slot copies' time lies under a step kernel;
14. (run right after 7) speculative decoding at llama_1b's width (int4-
   g128, int8 KV, bf16, ragged attention; gamma 4 and bench.py's tiny
   independent draft: dim 256, 8 heads over 4 KV heads, ffn 1024, 4
   layers, seed 7, unquantized): (b) the 24-layer chunk-5 verify step
   against the port's CPU f32 run, as 7 (a); (c) `SpeculativeGenerator`'s
   greedy tokens equal to `FusedGenerator`'s in f32 on a 2-layer cut, with
   the tiny draft and a self-draft, and at 24 layers in bf16 its ms a
   token, rounds, acceptance and a round's time split into draft steps
   and verify; (d) on a 2-layer f32 cut, `SpecDecodeServer` (rounds 1 and
   4 a tick) and `SpecPagedDecodeServer` with target and draft prefill
   ladders give `DecodeServer`'s tokens, then on the first SERVE_LAYERS
   (4) layers in bf16 each serves phase 7's 34 requests (SPEC_N_NEW new
   tokens each): tok/s, ms a tick, acceptance, a round's time and idle
   share split into draft steps and verify; (e) `BucketedDecodeServer`
   with a 128-row plain bucket and a 512-row speculative one: routing,
   spill-up, and the weights held once in device memory;
6. printed last: each kernel's launches on its path, and the total time.

Every kernel wrapper counts its launches. Each path (bf16, bf16 with int8
activations, the ResNet server, the decode steps, the decode serving runs,
the ViT, ESRGAN and SegNet forwards and servers) sets the counts to 0 just
before it runs, reads them just after, and must have launched the kernels
it routes to and no other: a decode step 169 int4_matmul and 24 attention
launches (paged or ragged), a prefill 169 int4_matmul, a ViT-B/16 forward
12 blocks (and 13 residual or 25 plain LayerNorms where the configuration
routes them), an ESRGAN x4 forward 349 pixel convs, a SegNet forward 3
unpools, an HF-layout ViT-B/16 forward 12 short or flash attentions or 12
MLPs, a one-node attention graph at N >= 2048 one flash attention, a fused
ConvNeXt-T forward 15 ConvNeXt blocks, an SD-UNet forward 5 ViT blocks and,
with the cross branch on, 5 cross-attention blocks, a ResNet-50 int8-static
forward 53 int8 convs and 16 residual joins; `dequant_conv`'s entry point, called at its four
shapes, 4; the fused GEMMs' entry points 2 each (head, serving), blockdot's
and patch's 8 each (ESRGAN x4's eight PixelConv shapes); the Megatron pair
over 4 ranks 16 all-gather and 16 reduce-scatter GEMM steps, the
sequence-sharded ring attention 16 merge steps (a step a rank a launch); a
speculative round 7 x layers + 1 int4_matmul (the verify) and (gamma + 1)
x 4 draft ragged_decode_attention launches (a catch-up step and gamma
drafts) plus one a target layer (ragged, or paged for the paged server),
each target prefill the prefill graph's int4_matmul.
`FusedGenerator` replays a CUDA graph, whose launches the wrappers count
once, at capture. The last three lines are the kernels'
JSON line, the card's name and power limit, and `{"ok": true, "device":
{...}}`. Any failed check exits non-zero before those lines. A JSON report
of every number goes to `build/chip_smoke/report.json`.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit.
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
FULL_POWER_W = 700.0
L2_BYTES = 50 * 2**20

RESNET_BATCH, RESNET_IMAGE = 128, 224  # ResNet-50 as the README's row serves it
HEAD = (128, 2048, 1000)          # ResNet-50 classifier at batch 128 (M, K, N)
SERVING = (8192, 4096, 4096)      # serving GEMM (M, K, N)

# llama_1b as bench.py serves it paged (bench.py:179, 400-528).
LLAMA_1B = dict(vocab=32000, dim=2048, heads=16, kv_heads=8, ffn=5632, layers=24)
# The decode servers of phases 5 and 7 run llama_1b's first SERVE_LAYERS
# layers (full width): at 24 their host-bound ticks took over half of the
# run's 1,200 s limit (PERF.md §6). The step and prefill checks against the
# CPU, the step profile and FusedGenerator keep all 24.
SERVE_LAYERS = 4
SLOTS, PAGE, NPG = 8, 128, 4      # max_len 512; pool 1 + SLOTS * NPG pages
GROUP = 128                       # int4-g128
# int4_matmul calls of one decode step: (N, K) -> calls (q, k, v, o; gate,
# up, down: 7 a layer; the head once).
DECODE_GEMMS = {(2048, 2048): 2 * 24, (1024, 2048): 2 * 24, (5632, 2048): 2 * 24,
                (2048, 5632): 24, (32000, 2048): 1}
BUCKETS = (64, 256)  # the prefill ladder bench.py --serve-decode builds
# Speculative decoding as bench.py --serve-decode runs it: gamma 4
# (bench.py:571) and its tiny independent draft, unquantized with float KV,
# from seed 7 (bench.py:369-377).
SPEC_GAMMA = 4
SPEC_DRAFT = dict(vocab=32000, dim=256, heads=8, kv_heads=4, ffn=1024, layers=4)
# ViT-B/16 as the JAX package's zoo builds it (`vit_b16`, bench.py --model
# vit_b16 --quant none): 224 px, patch 16, dim 768, 12 heads, 12 layers,
# MLP 3072, 1000 classes; served at batch 128 in bf16.
VIT_B16 = dict(image_size=224, patch=16, dim=768, depth=12, heads=12, num_classes=1000)
VIT_BATCH = 128
# ViT-B/16 in the Hugging Face layout (tests/torch_hf_vit.py: the published
# widths of google/vit-base-patch16-224 and -384), served at batch 128 at
# 224 px and batch 64 at 384 px (N 577); the f32 gates at batch 8 and 2.
HF_384_BATCH = 64
# ESRGAN x4 at the width and depth of ESRGAN / Real-ESRGAN's RealESRGAN_x4plus
# (nf 64, gc 32, 23 RRDBs), the zoo's RRDBNet, 128 px in, served at batch 8
# (the README's ESRGAN row); the CPU gates run the zoo's default depth, 4.
ESRGAN = dict(nf=64, nb=23, scale=4, image_size=128)
ESRGAN_BATCH, ESRGAN_GATE_NB = 8, 4
# Its PixelConvs a forward, (C_in, C_out, map side) -> calls: five dense-
# block convs x 3 blocks x nb, conv_body at 128 px, upconv1 at 256,
# upconv2 and conv_hr at 512 (conv_first and conv_last stay on cuDNN).
ESRGAN_CONVS = {**{(64 + 32 * i, 32 if i < 4 else 64, 128): 3 * ESRGAN["nb"] for i in range(5)},
                (64, 64, 128): 1, (64, 64, 256): 1, (64, 64, 512): 2}
# SegNet as the zoo builds it (base 32, depth 3, 2 classes), 256 px, served
# at batch 16 (the README's row); its three unpools' inputs (B, C, h, w).
SEGNET = dict(base=32, depth=3, num_classes=2, image_size=256)
SEGNET_BATCH = 16
SEGNET_UNPOOLS = [(16, 128, 32, 32), (16, 64, 64, 64), (16, 32, 128, 128)]
# ConvNeXt-T as the JAX package's zoo builds it by default (`convnext`: the
# widths of facebook/convnext-tiny-224, dims 96/192/384/768, depths 3/3/9/3,
# 1000 classes), 224 px, served at batch 64 in bf16 (the README's row); the
# gates at batch 8. fuse_convnext_block fuses 15 of its 18 blocks.
CONVNEXT = dict(image_size=224, num_classes=1000, dims=(96, 192, 384, 768),
                depths=(3, 3, 9, 3))
CONVNEXT_BATCH, CONVNEXT_GATE_BATCH, CONVNEXT_FUSED = 64, 8, 15
# SD-UNet at the zoo's 256 px configuration (`sd_unet`: latent 32, base 128,
# a 16 x 256 context, 8 heads; the README's row), its context baked at
# batch 8.
SD_UNET = dict(latent=32, base=128, ctx_dim=256, ctx_len=16, heads=8)
SD_UNET_BATCH = 8
# The ring kernels (phase 13): 4 ranks of a Mesh on one card; the Megatron
# TP MLP at ViT-B/16's widths at batch 128 (197 tokens an image, dim 768,
# MLP 3072); each GEMM alone at llama_1b's FFN widths (dim 2048, ffn 5632)
# at M 4096; ring attention at llama_1b's heads (16 of 128) over a 32,768-
# token sequence, and in f32 over 4,096.
RING_W = 4
MEGATRON = (VIT_BATCH * 197, 768, 3072)
LLAMA_FFN = (4096, LLAMA_1B["dim"], LLAMA_1B["ffn"])
RING_ATTN = (1, 16, 32768, 128)
RING_ATTN_F32_N = 4096
# Each kernel's launch counter: name -> (module under
# smelter_tpu_torch/kernels, counter).
KERNELS = {"dequant_matmul": ("dequant_matmul", "launches"),
           "int8_matmul": ("int8_matmul", "launches"),
           "int4_matmul": ("int4_matmul", "launches"),
           "paged_decode_attention": ("paged_decode_attention", "launches"),
           "ragged_decode_attention": ("ragged_decode_attention", "launches"),
           "fused_layer_norm": ("layer_norm", "fused_launches"),
           "residual_layer_norm": ("layer_norm", "residual_launches"),
           "vit_attention_block": ("vit_block", "launches"),
           "pixel_conv_rowdot": ("pixel_conv", "launches"),
           "pixel_conv_rowdot_q": ("pixel_conv", "q_launches"),
           "max_unpool2x2": ("max_unpool", "launches"),
           "short_attention": ("attention_short", "launches"),
           "flash_attention": ("flash_attention", "launches"),
           "mlp_block": ("mlp_block", "launches"),
           "convnext_block": ("convnext_block", "launches"),
           "cross_attn_block": ("cross_attn_block", "launches"),
           "qlinear_conv": ("qlinear_conv", "launches"),
           "int8_join": ("int8_join", "launches"),
           "dequant_conv": ("dequant_conv", "launches"),
           "dequant_matmul_int8_fused": ("int8_matmul", "fused_launches"),
           "dequant_matmul_int8_fused2": ("int8_matmul", "fused2_launches"),
           "pixel_conv_blockdot": ("pixel_conv", "blockdot_launches"),
           "pixel_conv_patch": ("pixel_conv", "patch_launches"),
           "collective_matmul_ag": ("collective_matmul", "ag_launches"),
           "collective_matmul_rs": ("collective_matmul", "rs_launches"),
           "ring_attention_rdma": ("ring_attention_rdma", "launches")}

REPORT: dict = {}
_START = time.perf_counter()
PHASE_END_S: dict = {}  # seconds from the start to each phase's last line


class SmokeError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def say(phase, text: str) -> None:
    PHASE_END_S[str(phase)] = round(time.perf_counter() - _START, 1)
    print(f"[{phase}] {text}", flush=True)


def bound(nbytes: float, ops, kind: str | None, power_w: float):
    """Least time (ms) for the work: bytes over HBM rate vs operations over
    the peak rate of their type (`ops` of `kind`, or a {kind: ops} dict for
    work of several types, each at its own rate), the peak scaled down by a
    lower power limit. Returns (ms, "bytes" | "operations")."""
    t_mem = nbytes / HBM_BYTES_S
    by_kind = ops if isinstance(ops, dict) else {kind: ops}
    t_ops = (sum(n / PEAK_OPS_S[k] for k, n in by_kind.items())
             * max(1.0, FULL_POWER_W / power_w))
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops else "operations")


def time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean time of fn(i) over `iters` calls issued from Python, by CUDA
    events: the device time where a call outlasts its launch, else the
    host's cost of a call."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, side, fn, iters: int, replays: int = 5) -> float:
    """Mean device time of fn(i), from replays of one CUDA graph that holds
    `iters` calls, so that no host launch cost stands between them. `side`
    is the stream the graph is captured on; one for all graphs, so that
    cuBLAS keeps one workspace for them."""
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for i in range(iters):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (iters * replays)
    del graph
    return ms


# -- phase 1 ---------------------------------------------------------------

def phase_environment(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    power_w = float(smi.split(",")[-1].strip().split()[0])
    from smelter_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build()
    build_s = time.perf_counter() - t0
    REPORT["environment"] = {"nvidia_smi": smi, "power_limit_w": power_w,
                             "torch": torch.__version__, "cuda": torch.version.cuda,
                             "device": torch.cuda.get_device_name(0),
                             "build_s": build_s, "ptxas": logs}
    say(1, f"card: {smi} | torch {torch.__version__} CUDA {torch.version.cuda} | "
           f"kernels built in {build_s:.1f} s ({', '.join(logs) or 'already built'})")
    return smi, power_w


# -- phase 2 ---------------------------------------------------------------

def _copies(nbytes: int) -> int:
    """Operand sets to rotate through so that no launch finds its operands
    in the 50 MB L2 cache."""
    return max(1, math.ceil(2 * L2_BYTES / nbytes))


def phase_kernels(torch, power_w: float) -> dict:
    from smelter_tpu_torch.kernels import dequant_matmul as dm
    from smelter_tpu_torch.kernels import int8_matmul as im

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    side = torch.cuda.Stream()
    rows = {}
    for label, (M, K, N) in (("head", HEAD), ("serving", SERVING)):
        iters = 50 if label == "head" else 10

        def operands(dtype):
            per_call = M * K * 2 + K * N + N * 4 + M * N * 2
            sets = []
            for _ in range(_copies(per_call)):
                x = torch.randn(M, K, device="cuda", generator=gen).to(dtype)
                w = torch.randint(-127, 128, (K, N), device="cuda", generator=gen,
                                  dtype=torch.int8)
                s = torch.rand(N, device="cuda", generator=gen) * 0.02 + 1e-3
                sets.append((x, w, s))
            return sets

        # dequant_matmul, bf16 (the main path's type) and f32
        for dtype, kind, rel in ((torch.bfloat16, "bf16", 1e-2), (torch.float32, "f32", 1e-5)):
            sets = operands(dtype)
            x, w, s = sets[0]
            got = dm.dequant_matmul(x, w, s)
            ref = dm.dequant_matmul_plain(x, w, s)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            check(got.dtype == dtype and got.shape == (M, N), "dequant_matmul output")
            check(math.isfinite(err) and err <= rel * scale,
                  f"dequant_matmul {label} {kind}: max-abs {err} > {rel} x {scale}")
            n = len(sets)
            ms = graph_ms(torch, side, lambda i: dm.dequant_matmul(*sets[i % n]), iters)
            call_ms = time_ms(torch, lambda i: dm.dequant_matmul(*sets[i % n]), iters)
            plain_ms = graph_ms(torch, side, lambda i: dm.dequant_matmul_plain(*sets[i % n]),
                                iters)
            w_deq = [(w_.float() * s_).to(dtype) for _, w_, s_ in sets]
            lib_ms = graph_ms(torch, side, lambda i: torch.matmul(sets[i % n][0], w_deq[i % n]),
                              iters)
            nbytes = M * K * x.element_size() + K * N + N * 4 + M * N * x.element_size()
            b_ms, b_by = bound(nbytes, 2 * M * N * K, kind, power_w)
            rows[("dequant_matmul", label, kind)] = dict(
                name="dequant_matmul", shape=[M, K, N], dtype=kind, max_abs_err=err,
                tolerance=f"{rel} x max|plain| = {rel * scale:.4g}", ms=ms, call_ms=call_ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
            del sets, w_deq

        # int8_matmul on quantize_rows of bf16 activations, bf16 out
        sets = []
        for x, w, s in operands(torch.bfloat16):
            xq, sr = im.quantize_rows(x)
            sets.append((xq, w, sr, s))
        xq, w, sr, s = sets[0]
        form = im.plan(xq, w).form  # wgmma_plan.int8_plan: "tma" or "cluster"
        acc = im.int8_matmul(xq, w, sr, s, out_dtype=torch.int32)
        check(torch.equal(acc, im.int8_matmul_plain(xq, w, sr, s, out_dtype=torch.int32)),
              f"int8_matmul {label} ({form} form): int32 sums differ from the plain version")
        for out_dtype in (torch.float32, torch.float16):
            check(torch.equal(im.int8_matmul(xq, w, sr, s, out_dtype=out_dtype),
                              im.int8_matmul_plain(xq, w, sr, s, out_dtype=out_dtype)),
                  f"int8_matmul {label} ({form} form): {out_dtype} outputs differ")
        got = im.int8_matmul(xq, w, sr, s, out_dtype=torch.bfloat16)
        ref = im.int8_matmul_plain(xq, w, sr, s, out_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        check(torch.equal(got, ref), f"int8_matmul {label} ({form} form): outputs differ ({err})")
        n = len(sets)
        ms = graph_ms(torch, side, lambda i: im.int8_matmul(*sets[i % n]), iters)
        call_ms = time_ms(torch, lambda i: im.int8_matmul(*sets[i % n]), iters)
        plain_ms = graph_ms(torch, side, lambda i: im.int8_matmul_plain(*sets[i % n]), iters)
        w_cm = [w_.t().contiguous().t() for _, w_, _, _ in sets]  # column-major for cuBLASLt

        def int_mm(i):
            xq_, _, sr_, s_ = sets[i % n]
            return (torch._int_mm(xq_, w_cm[i % n]).float() * sr_ * s_).to(torch.bfloat16)

        lib_ms = graph_ms(torch, side, int_mm, iters)
        nbytes = M * K + K * N + M * 4 + N * 4 + M * N * 2
        b_ms, b_by = bound(nbytes, 2 * M * N * K, "int8", power_w)
        rows[("int8_matmul", label, "int8")] = dict(
            name="int8_matmul", shape=[M, K, N], dtype="int8->bf16", max_abs_err=err, form=form,
            tolerance="int32 sums exact, outputs equal", ms=ms, call_ms=call_ms,
            plain_ms=plain_ms,
            library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
        del sets, w_cm

    # dequant_matmul's wgmma forms (kernels/wgmma_plan.py) at odd shapes, each
    # dtype pair, two calls bit-equal
    from smelter_tpu_torch.kernels import wgmma_plan

    odd = []
    for M, N, K in ((1, 8, 8), (7, 1001, 72), (129, 4096, 2056), (37, 100, 70), (300, 1001, 99),
                    (1024, 4096, 2048)):
        for dtype, out_dtype, rel in ((torch.bfloat16, None, 1e-2), (torch.float16, None, 2e-3),
                                      (torch.bfloat16, torch.float32, 1e-5)):
            x = torch.randn(M, K, device="cuda", generator=gen).to(dtype)
            w = torch.randint(-127, 128, (K, N), device="cuda", generator=gen, dtype=torch.int8)
            s = torch.rand(N, device="cuda", generator=gen) * 0.02 + 1e-3
            got = dm.dequant_matmul(x, w, s, out_dtype=out_dtype)
            again = dm.dequant_matmul(x, w, s, out_dtype=out_dtype)
            ref = dm.dequant_matmul_plain(x, w, s, out_dtype=out_dtype)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            form = wgmma_plan.plan(M, N, K, int8_b=True).form
            check(torch.equal(got, again) and math.isfinite(err) and err <= rel * scale,
                  f"dequant_matmul {M}x{N}x{K} {dtype}->{out_dtype} ({form}): max-abs {err} > "
                  f"{rel} x {scale}, or two calls differ")
            odd.append([M, N, K, str(dtype), str(out_dtype or dtype), form, err])
    say(2, f"dequant_matmul at odd shapes vs plain (bf16 1e-2, f16 2e-3, f32 out 1e-5 x "
           f"max|plain|; two calls bit-equal): {odd}")
    REPORT["dequant_matmul_odd"] = odd

    for (name, label, kind), r in rows.items():
        form = f" ({r['form']} form)" if "form" in r else ""
        if "bf16_out_form" in r:
            form = f" ({r['form']} form; bf16 out: {r['bf16_out_form']})"
        say(2, f"{name} {label} {r['shape']} {kind}{form}: err {r['max_abs_err']:.3g} "
               f"({r['tolerance']}) | kernel {r['ms']:.4f} ms (host cost of a call "
               f"{r['call_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, "
               f"library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
               f"({r['bound_by']}) = {100 * r['bound_ms'] / r['ms']:.1f}% of bound")
    REPORT["kernels_vs_plain"] = [dict(r, case=f"{k[1]}/{k[2]}") for k, r in rows.items()]
    return rows


def _int4_case(torch, side, power_w, i4, sets, M, N, K) -> dict:
    """int4_matmul at (M, K, N) on the operand copies `sets` (x, pk, sc)
    against its plain version (f32 out within 1e-5 of max|plain|, bf16 out
    within 1e-2), and timed in bf16 out: the kernel and the plain version by
    graph replay, the host cost of a call, the library yardstick (bf16
    torch.matmul on the dequantized weight) and the bytes bound."""
    bf16 = torch.bfloat16
    n = len(sets)
    x, pk, sc = sets[0]
    errs = {}
    for out_dtype, rel in ((torch.float32, 1e-5), (bf16, 1e-2)):
        got = i4.int4_matmul(x, pk, sc, group=GROUP, out_dtype=out_dtype)
        ref = i4.int4_matmul_plain(x, pk, sc, group=GROUP, out_dtype=out_dtype)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        check(got.shape == (M, N) and math.isfinite(err) and err <= rel * scale,
              f"int4_matmul M {M} N {N} K {K} {out_dtype}: max-abs {err} > {rel} x {scale}")
        errs[str(out_dtype).split(".")[-1]] = (err, f"{rel} x max|plain| = {rel * scale:.4g}")

    def call(i):
        return i4.int4_matmul(*sets[i % n], group=GROUP, out_dtype=bf16)

    nbytes = M * K * 2 + K * N // 2 + K // GROUP * N * 4 + M * N * 2
    ms = graph_ms(torch, side, call, 20)
    call_ms = time_ms(torch, call, 20)
    plain_ms = graph_ms(torch, side, lambda i: i4.int4_matmul_plain(
        *sets[i % n], group=GROUP, out_dtype=bf16), 5)
    w_deq = [(i4.unpack_int4_half(pk_).float() * sc_.repeat_interleave(GROUP, 0)).to(bf16)
             for _, pk_, sc_ in sets]
    lib_ms = graph_ms(torch, side, lambda i: torch.matmul(sets[i % n][0], w_deq[i % n]), 20)
    del w_deq
    b_ms, b_by = bound(nbytes, 2 * M * N * K, "bf16", power_w)
    return dict(shape=[M, K, N], max_abs_err=errs["float32"][0], tolerance=errs["float32"][1],
                bf16_out_err=errs["bfloat16"][0], ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                library_ms=lib_ms, library="bf16 torch.matmul on the dequantized weight",
                bound_ms=b_ms, bound_by=b_by, bytes=nbytes)


def phase_decode_kernels(torch, power_w: float, smi: str) -> dict:
    """int4_matmul at each decode GEMM of llama_1b (M = 8 slots and M = 1,
    FusedGenerator's single stream; bf16 x) and paged_decode_attention at
    its decode shape, against their plain versions, with device, host,
    plain, library and bound times."""
    import torch.nn.functional as F

    from smelter_tpu_torch.kernels import int4_matmul as i4
    from smelter_tpu_torch.kernels import paged_decode_attention as pda
    from smelter_tpu_torch.kernels.wgmma_plan import int4_plan

    gen = torch.Generator(device="cuda").manual_seed(1)
    side = torch.cuda.Stream()
    bf16 = torch.bfloat16
    rows = {}
    for (N, K), calls in DECODE_GEMMS.items():
        plan = int4_plan(N, K, GROUP)
        check(plan.form == "wgmma", f"int4_matmul N {N} K {K}: plan {plan}, not the wgmma form")
        weights = []
        for _ in range(_copies(K * N // 2 + K // GROUP * N * 4)):
            pk = torch.randint(-128, 128, (K // 2, N), device="cuda", generator=gen,
                               dtype=torch.int8)
            sc = torch.rand(K // GROUP, N, device="cuda", generator=gen) * 0.02 + 1e-3
            weights.append((pk, sc))
        forms = dict(i4.forms)
        for M, key in ((SLOTS, "int4_matmul"), (1, "int4_matmul_m1")):
            sets = [(torch.randn(M, K, device="cuda", generator=gen).to(bf16), pk, sc)
                    for pk, sc in weights]
            r = _int4_case(torch, side, power_w, i4, sets, M, N, K)
            rows[(key, N, K)] = dict(r, name=key, calls_per_step=calls, form=plan.form,
                                     plan=f"{plan.chunks} K chunks a tile, {plan.items} items "
                                          f"on {plan.grid} CTAs")
            del sets
        check(i4.forms["mma"] == forms["mma"], f"int4_matmul N {N} K {K}: an mma.sync launch")
        # the prefill graphs' M (64 and 256 prompt rows, several 32-row
        # passes) with the same tolerances; device time of the bf16 call
        prefill = {}
        pk, sc = weights[0]
        for m in BUCKETS:
            xm = torch.randn(m, K, device="cuda", generator=gen).to(bf16)
            for out_dtype, rel in ((torch.float32, 1e-5), (bf16, 1e-2)):
                got = i4.int4_matmul(xm, pk, sc, group=GROUP, out_dtype=out_dtype)
                ref = i4.int4_matmul_plain(xm, pk, sc, group=GROUP, out_dtype=out_dtype)
                torch.cuda.synchronize()
                err = (got.float() - ref.float()).abs().max().item()
                scale = ref.float().abs().max().item()
                check(got.shape == (m, N) and math.isfinite(err) and err <= rel * scale,
                      f"int4_matmul M {m} N {N} K {K} {out_dtype}: max-abs {err} > "
                      f"{rel} x {scale}")
                prefill[f"m{m}_{str(out_dtype).split('.')[-1]}_err"] = err
            prefill[f"m{m}_ms"] = graph_ms(torch, side, lambda i: i4.int4_matmul(
                xm, *weights[i % len(weights)], group=GROUP, out_dtype=bf16), 10)
        rows[("int4_matmul", N, K)]["prefill_m"] = prefill
        del weights

    # paged_decode_attention: 8 slots, 8 KV heads of 128 (g 2), int8 pools
    # of 128-row pages, 4 pages a slot, positions spread over 0-511: the
    # paged step (c 1) and SpecPagedDecodeServer's verify (c 5, g*c 10, up to
    # the last round that fits)
    kvh, g, hd = LLAMA_1B["kv_heads"], LLAMA_1B["heads"] // LLAMA_1B["kv_heads"], 128
    P_ = 1 + SLOTS * NPG
    table = (1 + torch.randperm(P_ - 1, device="cuda", generator=gen)).reshape(SLOTS, NPG)
    table = table.to(torch.int32)
    spread = [0, 73, 127, 128, 292, 365, 438, 511]
    for case, c, at, calls, per_round in (
            ("", 1, spread, LLAMA_1B["layers"], 0),
            ("verify_", SPEC_GAMMA + 1, spread[:-1] + [NPG * PAGE - 1 - SPEC_GAMMA], 0,
             LLAMA_1B["layers"])):
        pos = torch.tensor(at, device="cuda")
        kw = dict(c=c, kv_heads=kvh, scale=hd ** -0.5)
        live = int((pos + c).sum())
        for dtype, kind, rel in ((bf16, "bf16", 1e-2), (torch.float32, "f32", 1e-5)):
            nbytes = (2 * live * kvh * hd + 2 * live * 2 + 2 * SLOTS * kvh * g * c * hd * 2
                      + SLOTS * NPG * 4 + SLOTS * 8) if dtype == bf16 else None
            sets = []
            for _ in range(_copies(2 * P_ * PAGE * kvh * hd)):
                q = torch.randn(SLOTS, kvh, g * c, hd, device="cuda", generator=gen).to(dtype)
                k, v = (torch.randint(-127, 128, (P_, PAGE, kvh * hd), device="cuda",
                                      generator=gen, dtype=torch.int8) for _ in range(2))
                ks, vs = ((torch.rand(P_, PAGE, 1, device="cuda", generator=gen) * 0.02
                           + 1e-3).to(dtype) for _ in range(2))
                sets.append((q, k, v, table, pos, ks, vs))
            n = len(sets)
            got = pda.paged_decode_attention(*sets[0], **kw)
            again = pda.paged_decode_attention(*sets[0], **kw)
            ref = pda.paged_decode_attention_plain(*sets[0], **kw)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            check(got.shape == sets[0][0].shape and math.isfinite(err) and err <= rel * scale,
                  f"paged_decode_attention {case}{kind}: max-abs {err} > {rel} x {scale}")
            check(torch.equal(got, again),
                  f"paged_decode_attention {case}{kind}: two calls differ")
            if dtype != bf16:
                rows[("paged_decode_attention", case + "f32")] = dict(
                    case=case + "f32", max_abs_err=err, tolerance=f"{rel} x {scale:.4g}")
                continue

            def call(i):
                return pda.paged_decode_attention(*sets[i % n], **kw)

            ms = graph_ms(torch, side, call, 50)
            call_ms = time_ms(torch, call, 50)
            plain_ms = graph_ms(torch, side, lambda i: pda.paged_decode_attention_plain(
                *sets[i % n], **kw), 10)
            # library yardstick: SDPA over the gathered, dequantized caches,
            # query row i of a slot masked to rows <= pos + i % c
            L = NPG * PAGE
            limit = pos[:, None] + torch.arange(g * c, device="cuda")[None] % c
            mask = (torch.arange(L, device="cuda")[None, None] <= limit[..., None])[:, None]
            dense = []
            for q, k, v, _, _, ks, vs in sets:
                kd, vd = ((pda.paged_gather_reference(a, table, L).float()
                           * pda.paged_gather_reference(sa, table, L).float())
                          .reshape(SLOTS, L, kvh, hd).transpose(1, 2).to(dtype).contiguous()
                          for a, sa in ((k, ks), (v, vs)))
                dense.append((q, kd, vd))
            lib_ms = graph_ms(torch, side, lambda i: F.scaled_dot_product_attention(
                *dense[i % n], attn_mask=mask, scale=kw["scale"]), 50)
            b_ms, b_by = bound(nbytes, 4 * kvh * g * c * hd * live, "bf16", power_w)
            split_rows, _, nblk = pda.paged_split_plan(SLOTS, kvh, NPG, PAGE)
            rows[("paged_decode_attention", case + "bf16")] = dict(
                name="paged_decode_attention", shape=[SLOTS, kvh, g * c, hd, PAGE, NPG],
                plan=f"{split_rows} rows a block, {nblk} blocks a slot, "
                     f"{SLOTS * kvh * nblk * -(-g * c // 16)} CTAs",
                calls_per_step=calls, calls_per_round=per_round, live_rows=live,
                max_abs_err=err, tolerance=f"{rel} x max|plain| = {rel * scale:.4g}", ms=ms,
                call_ms=call_ms, plain_ms=plain_ms, library_ms=lib_ms,
                library="F.scaled_dot_product_attention over the gathered, dequantized cache",
                bound_ms=b_ms, bound_by=b_by, bytes=nbytes)
            del sets, dense

    for key, r in rows.items():
        if "ms" not in r:
            say(2, f"paged_decode_attention {r['case']}: err {r['max_abs_err']:.3g} "
                   f"({r['tolerance']}), two calls bit-equal")
            continue
        what = (f"{r['form']} form, {r['plan']}" if "form" in r
                else f"split-KV: {r['plan']}; two calls bit-equal")
        say(2, f"{r['name']} {r['shape']} bf16 ({what}): err {r['max_abs_err']:.3g} "
               f"({r['tolerance']}) | kernel {r['ms']:.4f} ms (host cost of a call "
               f"{r['call_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, library "
               f"{r['library_ms']:.4f} ms ({r['library']}), bound {r['bound_ms']:.5f} ms "
               f"({r['bound_by']}, {r['bytes']} bytes) = {100 * r['bound_ms'] / r['ms']:.1f}% "
               f"of bound | {r['calls_per_step']} calls a step"
               + (f", {r['calls_per_round']} a speculative round" if r.get("calls_per_round")
                  else "") + f" | {smi}")
        if "prefill_m" in r:
            p = r["prefill_m"]
            say(2, "  at the prefill's M: " + "; ".join(
                f"M {m} err f32 {p[f'm{m}_float32_err']:.3g}, bf16 {p[f'm{m}_bfloat16_err']:.3g}"
                f", kernel {p[f'm{m}_ms']:.4f} ms" for m in BUCKETS))
    for key, m in (("int4_matmul", SLOTS), ("int4_matmul_m1", 1)):
        st = per_step(rows, key)
        say(2, f"int4_matmul at M {m}, a step's {7 * LLAMA_1B['layers'] + 1} calls: kernel "
               f"{st['ms']:.4f} ms, plain {st['plain_ms']:.4f} ms, library "
               f"{st['library_ms']:.4f} ms, bound {st['bound_ms']:.4f} ms ({st['bound_by']}) = "
               f"{100 * st['bound_ms'] / st['ms']:.1f}% of bound | {smi}")
    REPORT["decode_kernels"] = [dict(r, case=str(k)) for k, r in rows.items()]
    return rows


def _ragged_case(torch, gen, side, power_w, label, B, c, L, pos, dtype, rel, calls, g=None,
                 kvh=None, hd=128, quant=True, calls_per_round=0):
    """ragged_decode_attention at one shape against its plain version: int8
    caches with per-row scales in q's dtype (or float caches in q's dtype
    where not `quant`), caches full of values past every frontier. llama_1b's
    KV heads and, at c 1, its g unless given. Timed for bf16 (the path's
    type): kernel by graph replay, the host cost of a call, the plain
    version, SDPA over the dequantized cache with the same mask, and the
    bound (live bytes)."""
    import torch.nn.functional as F

    from smelter_tpu_torch.kernels import ragged_decode_attention as rda

    kvh = kvh or LLAMA_1B["kv_heads"]
    if g is None:
        g = LLAMA_1B["heads"] // kvh if c == 1 else 1
    kvd, gc = kvh * hd, g * c
    pos = torch.tensor(pos, dtype=torch.int64, device="cuda")
    kw = dict(c=c, kv_heads=kvh, scale=hd ** -0.5)
    sets = []
    for _ in range(_copies(2 * B * L * kvd)):
        q = torch.randn(B, kvh, gc, hd, device="cuda", generator=gen).to(dtype)
        if quant:
            k, v = (torch.randint(-127, 128, (B, L, kvd), device="cuda", generator=gen,
                                  dtype=torch.int8) for _ in range(2))
            ks, vs = ((torch.rand(B, L, 1, device="cuda", generator=gen) * 0.02 + 1e-3)
                      .to(dtype) for _ in range(2))
        else:
            k, v = (torch.randn(B, L, kvd, device="cuda", generator=gen).to(dtype)
                    for _ in range(2))
            ks = vs = None
        sets.append((q, k, v, pos, ks, vs))
    n = len(sets)
    got = rda.ragged_decode_attention(*sets[0], **kw)
    ref = rda.ragged_decode_attention_reference(*sets[0], **kw)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    check(got.shape == sets[0][0].shape and math.isfinite(err) and err <= rel * scale,
          f"ragged_decode_attention {label}: max-abs {err} > {rel} x {scale}")
    r = dict(name="ragged_decode_attention", case=label, shape=[B, kvh, gc, hd, L],
             dtype=str(dtype).split(".")[-1], calls_per_step=calls,
             calls_per_round=calls_per_round, kv="int8" if quant else "bf16",
             max_abs_err=err, tolerance=f"{rel} x max|plain| = {rel * scale:.4g}")
    if dtype != torch.bfloat16:
        return r

    def call(i):
        return rda.ragged_decode_attention(*sets[i % n], **kw)

    r["ms"] = graph_ms(torch, side, call, 50)
    r["call_ms"] = time_ms(torch, call, 50)
    r["plain_ms"] = graph_ms(torch, side, lambda i: rda.ragged_decode_attention_reference(
        *sets[i % n], **kw), 5)
    # library yardstick: SDPA over the dequantized caches, row i of a slot
    # masked to rows <= pos + i % c
    rows = torch.arange(L, device="cuda")
    limit = pos[:, None] + torch.arange(gc, device="cuda")[None] % c  # (B, gc)
    mask = (rows[None, None] <= limit[..., None])[:, None]  # (B, 1, gc, L)
    def deq(a, sa):  # (B, kvh, L, hd) in q's dtype; a KV head's g*c query rows attend it
        a = a.float() * sa.float() if sa is not None else a.float()
        return a.reshape(B, L, kvh, hd).transpose(1, 2).to(dtype).contiguous()

    dense = [(q_, deq(k_, ks_), deq(v_, vs_)) for q_, k_, v_, _, ks_, vs_ in sets]
    r["library_ms"] = graph_ms(torch, side, lambda i: F.scaled_dot_product_attention(
        *dense[i % n], attn_mask=mask, scale=kw["scale"]), 50)
    r["library"] = "F.scaled_dot_product_attention over the dequantized cache"
    live = int(torch.clamp(pos + c, max=L).sum())
    r["live_rows"] = live
    r["bytes"] = (2 * live * (kvd + 2) if quant else 2 * live * kvd * 2) \
        + 2 * B * kvh * gc * hd * 2 + B * 8
    r["bound_ms"], r["bound_by"] = bound(r["bytes"], 4 * kvh * gc * hd * live, "bf16", power_w)
    del sets, dense
    return r


def phase_ragged_kernel(torch, power_w: float) -> dict:
    """ragged_decode_attention at the shapes of the static-cache decode path:
    8 slots spread over a 512-row cache (the DecodeServer's step, 24 calls),
    the chunk c 5 of one slot at its last row with g 1, a 4096-row cache,
    and FusedGenerator's one slot at row 280 of 512; and at the speculative
    path's: SpecDecodeServer's verify (8 slots, g 2 x c 5 = 10 query rows a
    KV head, 24 calls a round) and its tiny draft's step (8 slots, 4 KV
    heads of 32, g 2, bf16 caches, 4 layers x 5 steps = 20 calls a round)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    side = torch.cuda.Stream()
    spread = [0, 73, 127, 128, 292, 365, 438, 511]
    verify_at = spread[:-1] + [PAGE * NPG - 1 - SPEC_GAMMA]  # the last round that fits
    dh = SPEC_DRAFT["dim"] // SPEC_DRAFT["heads"]
    rows = {}
    for label, B, c, L, pos, calls, extra in (
            ("b8_l512", SLOTS, 1, 512, spread, LLAMA_1B["layers"], {}),
            ("c5_b1_pos511", 1, 5, 512, [511], 0, {}),
            ("b8_l4096", SLOTS, 1, 4096, [p * 8 for p in spread[:-1]] + [4095], 0, {}),
            ("b1_l512_pos280", 1, 1, 512, [280], 0, {}),
            ("verify_b8_g2_c5_l512", SLOTS, SPEC_GAMMA + 1, 512, verify_at, 0,
             dict(g=2, calls_per_round=LLAMA_1B["layers"])),
            ("draft_b8_kvh4_g2_hd32", SLOTS, 1, 512, spread, 0,
             dict(g=SPEC_DRAFT["heads"] // SPEC_DRAFT["kv_heads"], kvh=SPEC_DRAFT["kv_heads"],
                  hd=dh, quant=False,
                  calls_per_round=(SPEC_GAMMA + 1) * SPEC_DRAFT["layers"]))):
        for dtype, rel in ((torch.bfloat16, 1e-2), (torch.float32, 1e-5)):
            r = _ragged_case(torch, gen, side, power_w, label, B, c, L, pos, dtype, rel, calls,
                             **extra)
            rows[(label, r["dtype"])] = r
    for r in rows.values():
        if "ms" not in r:
            say(2, f"ragged_decode_attention {r['case']} f32: err {r['max_abs_err']:.3g} "
                   f"({r['tolerance']})")
            continue
        say(2, f"ragged_decode_attention {r['case']} {r['shape']} bf16: err "
               f"{r['max_abs_err']:.3g} ({r['tolerance']}) | kernel {r['ms']:.4f} ms (host "
               f"cost of a call {r['call_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, library "
               f"{r['library_ms']:.4f} ms ({r['library']}), bound {r['bound_ms']:.5f} ms "
               f"({r['bound_by']}, {r['bytes']} bytes, {r['live_rows']} live rows) = "
               f"{100 * r['bound_ms'] / r['ms']:.1f}% of bound | {r['calls_per_step']} calls "
               f"a step, {r['calls_per_round']} a speculative round | {r['kv']} KV")
    REPORT["ragged_kernel"] = [dict(r) for r in rows.values()]
    return rows


def _vit_weights(np, D: int, heads: int, seed: int):
    """A ViT block's weights from a numpy seed, f32 on the host: LN gamma
    and beta, the (D, 3D) QKV weight and bias, the projection and its bias,
    as the JAX package's kernel test makes them."""
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal(D) * 0.1 + 1).astype(np.float32),
            (rng.standard_normal(D) * 0.1).astype(np.float32),
            (rng.standard_normal((D, 3 * D)) / np.sqrt(D)).astype(np.float32),
            (rng.standard_normal(3 * D) * 0.02).astype(np.float32),
            (rng.standard_normal((D, D)) / np.sqrt(D)).astype(np.float32),
            (rng.standard_normal(D) * 0.02).astype(np.float32))


def _vit_case(torch, np, gen, B, N, D, heads, dtype, p_dtype, seed=0):
    """Operands of vit_attention_block: x (B, N, D) from `gen` on the card,
    the weights packed by the port's pass (passes/vit_block.py), the small
    params in p_dtype as a compiled graph hands them over."""
    from smelter_tpu_torch.passes.vit_block import pack_qkv_weights

    g, b, wqkv, bqkv, wp, bp = _vit_weights(np, D, heads, seed)
    wpk, bpk = pack_qkv_weights(wqkv, bqkv, heads)

    def t(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a)).to("cuda", dt)

    x = (torch.randn(B, N, D, device="cuda", generator=gen) * 0.5).to(dtype)
    return ((x, t(g, p_dtype), t(b, p_dtype), t(wpk, dtype), t(bpk, p_dtype), t(wp, dtype),
             t(bp, p_dtype)), (t(wqkv, dtype), t(bqkv, dtype), t(wp, dtype), t(bp, dtype)))


def phase_vit_kernels(torch, np, power_w: float) -> dict:
    """The ViT-B/16 path's kernels against their plain versions:
    fused_layer_norm and residual_layer_norm over the batch-128 activations
    (M 25,216 rows of D 768) and vit_attention_block at B 128, N 197, D 768,
    12 heads, in bf16 with bf16 params (as the bf16 graph hands them over)
    and in f32 (the block at batch 8); the block also at small shapes for
    pre_ln=0, both mask forms and head dim 32. Timed in bf16: kernel by graph
    replay, host cost of a call, plain version, library yardstick, bound."""
    import torch.nn.functional as F

    from smelter_tpu_torch.kernels import layer_norm as ln
    from smelter_tpu_torch.kernels import vit_block as vb

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(4)
    side = torch.cuda.Stream()
    bf16, f32 = torch.bfloat16, torch.float32
    B, D, H = VIT_BATCH, VIT_B16["dim"], VIT_B16["heads"]
    N = (VIT_B16["image_size"] // VIT_B16["patch"]) ** 2 + 1
    M, eps = B * N, 1e-6
    rows = {}

    def err_of(got, ref, rel, label):
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        check(got.shape == ref.shape and got.dtype == ref.dtype and math.isfinite(err)
              and err <= rel * scale, f"{label}: max-abs {err} > {rel} x {scale}")
        return err, f"{rel} x max|plain| = {rel * scale:.4g}"

    # -- the LayerNorm kernels over (M, D) ----------------------------------
    for name, n_in in (("fused_layer_norm", 1), ("residual_layer_norm", 2)):
        nbytes = 2 * n_in * M * D * 2 + 2 * D * 2
        r = {"name": name, "shape": [M, D], "calls_per_forward": 25 if n_in == 1 else 13}
        for dtype, p_dtype, rel in ((bf16, bf16, 1e-2), (f32, f32, 1e-5)):
            g = (1 + 0.1 * torch.randn(D, device="cuda", generator=gen)).to(p_dtype)
            b = (0.1 * torch.randn(D, device="cuda", generator=gen)).to(p_dtype)
            sets = [[(torch.randn(M, D, device="cuda", generator=gen) * 2 + 0.5).to(dtype)
                     for _ in range(n_in)] for _ in range(_copies(nbytes) if dtype == bf16 else 1)]
            n = len(sets)
            if n_in == 1:
                def call(i, fn=ln.fused_layer_norm):
                    return fn(sets[i % n][0], g, b, eps=eps)

                def plain(i):
                    return ln.layer_norm_plain(sets[i % n][0], g, b, eps=eps)

                def lib(i):
                    return F.layer_norm(sets[i % n][0], (D,), g, b, eps)
            else:
                def call(i, fn=ln.residual_layer_norm):
                    return fn(*sets[i % n], g, b, eps=eps)

                def plain(i):
                    return ln.residual_layer_norm_plain(*sets[i % n], g, b, eps=eps)

                def lib(i):
                    s = sets[i % n][0] + sets[i % n][1]
                    return s, F.layer_norm(s, (D,), g, b, eps)
            got, ref = call(0), plain(0)
            if n_in == 2:
                check(torch.equal(got[0], ref[0]), f"{name}: the carry differs from the plain sum")
                got, ref = got[1], ref[1]
            kind = "bf16" if dtype == bf16 else "f32"
            r[f"{kind}_err"], r[f"{kind}_tolerance"] = err_of(got, ref, rel, f"{name} {kind}")
            if dtype != bf16:
                continue
            r["ms"] = graph_ms(torch, side, call, 20)
            r["call_ms"] = time_ms(torch, call, 20)
            r["plain_ms"] = graph_ms(torch, side, plain, 5)
            r["library_ms"] = graph_ms(torch, side, lib, 20)
            r["library"] = ("F.layer_norm" if n_in == 1
                            else "x + skip, then F.layer_norm (two library calls)")
            r["bytes"] = nbytes
            r["bound_ms"], r["bound_by"] = bound(nbytes, 8 * n_in * M * D, "f32", power_w)
            del sets
        r["max_abs_err"] = r["bf16_err"]
        rows[name] = r
    # rows outside the JAX entry points' TPU tiling rule (D % 128, rows % 8)
    # still launch the kernels: batch 1's 197 rows, and rows of 96
    odd = {}
    for Ms, Ds in ((N, D), (12, 96)):
        x, skip = ((torch.randn(Ms, Ds, device="cuda", generator=gen) * 2 + 0.5).to(bf16)
                   for _ in range(2))
        g = 1 + 0.1 * torch.randn(Ds, device="cuda", generator=gen)
        b = 0.1 * torch.randn(Ds, device="cuda", generator=gen)
        before = (ln.fused_launches, ln.residual_launches)
        y = ln.fused_layer_norm(x, g, b, eps=eps)
        s_, y2 = ln.residual_layer_norm(x, skip, g, b, eps=eps)
        check((ln.fused_launches, ln.residual_launches) == (before[0] + 1, before[1] + 1),
              f"layer_norm at {Ms}x{Ds}: the kernels did not launch")
        s_ref, y2_ref = ln.residual_layer_norm_plain(x, skip, g, b, eps=eps)
        check(torch.equal(s_, s_ref), f"residual_layer_norm at {Ms}x{Ds}: the carry differs")
        odd[f"{Ms}x{Ds}"] = [err_of(y, ln.layer_norm_plain(x, g, b, eps=eps), 1e-2,
                                    f"fused_layer_norm {Ms}x{Ds}")[0],
                             err_of(y2, y2_ref, 1e-2, f"residual_layer_norm {Ms}x{Ds}")[0]]
    rows["fused_layer_norm"]["odd_rows_err"] = odd

    # -- vit_attention_block ------------------------------------------------
    hd = D // H
    r = {"name": "vit_attention_block", "shape": [B, N, D, H], "calls_per_forward": 12}
    nbytes = 2 * B * N * D * 2 + 4 * D * D * 2 + 6 * D * 2
    sets, libw = [], []
    for k in range(_copies(nbytes)):
        args, lw = _vit_case(torch, np, gen, B, N, D, H, bf16, bf16, seed=k)
        sets.append(args)
        libw.append(lw)
    n = len(sets)
    kw = dict(heads=H, eps=eps)

    def call(i):
        return vb.vit_attention_block(*sets[i % n], **kw)

    def plain(i):
        return vb.vit_attention_block_plain(*sets[i % n], **kw)

    def lib(i):
        """The block as a composite of library calls: F.layer_norm,
        torch.addmm, F.scaled_dot_product_attention, torch.addmm."""
        x, g, b = sets[i % n][:3]
        wqkv, bqkv, wp, bp = libw[i % n]
        xn = F.layer_norm(x, (D,), g, b, eps).reshape(M, D)
        q, k, v = torch.addmm(bqkv, xn, wqkv).reshape(B, N, 3, H, hd).permute(2, 0, 3, 1, 4)
        a = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(M, D)
        return torch.addmm(bp, a, wp)

    r["max_abs_err"], r["tolerance"] = err_of(call(0), plain(0), 1e-2, "vit_attention_block bf16")
    r["ms"] = graph_ms(torch, side, call, 10)
    r["call_ms"] = time_ms(torch, call, 10)
    r["plain_ms"] = graph_ms(torch, side, plain, 3)
    r["library_ms"] = graph_ms(torch, side, lib, 10)
    r["library"] = ("composite of library calls: F.layer_norm, torch.addmm, "
                    "F.scaled_dot_product_attention, torch.addmm")
    r["bytes"] = nbytes
    r["flops"] = B * (6 * N * D * D + 4 * N * N * D + 2 * N * D * D)
    r["bound_ms"], r["bound_by"] = bound(nbytes, r["flops"], "bf16", power_w)
    del sets, libw
    # f32 at batch 8, and the small forms the path does not reach
    args, _ = _vit_case(torch, np, gen, 8, N, D, H, f32, f32, seed=7)
    r["f32_b8_err"], r["f32_tolerance"] = err_of(vb.vit_attention_block(*args, **kw),
                                                 vb.vit_attention_block_plain(*args, **kw),
                                                 1e-5, "vit_attention_block f32 b8")
    small = {}
    for label, (Bs, Ns, Ds, Hs), extra in (
            ("pre_ln=0", (2, 50, 192, 6), dict(pre_ln=False)),
            ("keep2d", (2, 50, 192, 6), dict(mask="keep2d")),
            ("len1d", (2, 197, 128, 4), dict(mask="len1d")),
            ("hd32", (2, 197, 128, 4), {})):
        for dtype, rel in ((bf16, 1e-2), (f32, 1e-5)):
            args, _ = _vit_case(torch, np, gen, Bs, Ns, Ds, Hs, dtype, f32, seed=8)
            kws = dict(heads=Hs, eps=eps, pre_ln=extra.get("pre_ln", True))
            lens = torch.tensor([Ns // 3, Ns], dtype=torch.int32, device="cuda")
            mask = {"len1d": lens, "keep2d": (torch.arange(Ns, device="cuda")[None]
                                              < lens[:, None]).float(), None: None}[
                extra.get("mask")]
            small[f"{label} {Bs}x{Ns}x{Ds}/{Hs} {str(dtype)[6:]}"] = err_of(
                vb.vit_attention_block(*args, mask, **kws),
                vb.vit_attention_block_plain(*args, mask, **kws), rel,
                f"vit_attention_block {label} {dtype}")[0]
    r["small_forms_err"] = small
    rows["vit_attention_block"] = r

    for r in rows.values():
        extra = (f"f32 b8 err {r['f32_b8_err']:.3g} ({r['f32_tolerance']})"
                 if "f32_b8_err" in r else f"f32 err {r['f32_err']:.3g} ({r['f32_tolerance']})")
        say(2, f"{r['name']} {r['shape']} bf16: err {r['max_abs_err']:.3g} "
               f"({r.get('tolerance', r.get('bf16_tolerance'))}); {extra} | kernel "
               f"{r['ms']:.4f} ms (host cost of a call {r['call_ms']:.4f} ms), plain "
               f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms ({r['library']}), "
               f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}, {r['bytes']} bytes) = "
               f"{100 * r['bound_ms'] / r['ms']:.1f}% of bound | {r['calls_per_forward']} "
               f"calls a forward")
    say(2, "fused_layer_norm, residual_layer_norm outside the TPU tiling rule, bf16 vs "
           "plain (1e-2 x max|plain|): " + "; ".join(f"{k} {v[0]:.3g}, {v[1]:.3g}"
                                                     for k, v in odd.items()))
    say(2, "vit_attention_block at small shapes vs plain: "
           + "; ".join(f"{k} {v:.3g}" for k, v in small.items()))
    rows["vit_attention_block"]["split"] = phase_vit_split()
    REPORT["vit_kernels"] = list(rows.values())
    return rows


def phase_image_kernels(torch, power_w: float) -> dict:
    """The image-to-image path's kernels against their plain versions at
    the shapes the main path gives them: pixel_conv_rowdot (bf16, and f32 at
    batch 1) and pixel_conv_rowdot_q (int8 out, and bf16 out) at each
    PixelConv shape of ESRGAN x4 at batch 8, and max_unpool2x2 at SegNet's
    three unpools at batch 16. Timed in the path's types: kernel by graph
    replay, host cost of a call, plain version, library yardstick, bound."""
    import torch.nn.functional as F

    from smelter_tpu_torch.kernels import max_unpool as mu
    from smelter_tpu_torch.kernels import pixel_conv as pc

    torch.backends.cudnn.allow_tf32 = False  # the plain versions' convs in full f32
    gen = torch.Generator(device="cuda").manual_seed(5)
    side = torch.cuda.Stream()
    bf16, i8 = torch.bfloat16, torch.int8
    B = ESRGAN_BATCH
    rows = {}

    def err_of(got, ref, rel, label):
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        check(got.shape == ref.shape and got.dtype == ref.dtype and math.isfinite(err)
              and err <= rel * scale, f"{label}: max-abs {err} > {rel} x {scale}")
        return err

    for (cin, cout, side_px), calls in ESRGAN_CONVS.items():
        shape = (B, side_px, cin, side_px)
        flops = 2 * B * side_px * side_px * 9 * cin * cout
        for name, dtype in (("pixel_conv_rowdot", bf16), ("pixel_conv_rowdot_q", i8)):
            es = 2 if dtype == bf16 else 1
            nbytes = (B * side_px * side_px * (cin + cout) * es + 9 * cin * cout * es
                      + cout * 4 * (1 if dtype == bf16 else 2))
            sets = []
            for _ in range(_copies(nbytes)):
                w = torch.randn(cout, cin, 3, 3, device="cuda", generator=gen) / (3 * cin ** 0.5)
                b = torch.randn(cout, device="cuda", generator=gen)
                if dtype == bf16:
                    x = torch.randn(shape, device="cuda", generator=gen).to(bf16)
                    w = w.to(bf16).permute(2, 3, 0, 1).contiguous().permute(2, 3, 0, 1)
                    sets.append((x, w, b.to(bf16)))
                else:
                    x = torch.randint(-127, 128, shape, device="cuda", generator=gen, dtype=i8)
                    wq = torch.randint(-127, 128, (cout, cin, 3, 3), device="cuda",
                                       generator=gen, dtype=i8)
                    wq = wq.permute(2, 3, 0, 1).contiguous().permute(2, 3, 0, 1)
                    sc = torch.rand(cout, device="cuda", generator=gen) * 1e-3 / cin ** 0.5
                    sets.append((x, wq, sc, b))
            n = len(sets)
            r = {"name": name, "shape": [B, side_px, cin, side_px, cout],
                 "calls_per_forward": calls, "bytes": nbytes, "flops": flops}
            if dtype == bf16:
                kw = dict(alpha=0.2)
                p = pc.plan(sets[0][0], sets[0][1])  # wgmma_plan.pixel_plan
                r["form"] = p.form + (" resident-weight" if p.resident else "")
                call = lambda i: pc.pixel_conv_rowdot(*sets[i % n], **kw)  # noqa: E731
                plain = lambda i: pc.pixel_conv_rowdot_plain(*sets[i % n], **kw)  # noqa: E731
                # bf16 outputs of f32 sums in other orders: 1e-2 of the largest
                r["max_abs_err"] = err_of(call(0), plain(0), 1e-2, f"{name} {shape} bf16")
                r["tolerance"] = "1e-2 x max|plain| (bf16)"
                # f32 at batch 1, the same operands: 1e-5 (sums in other orders)
                x1, w1, b1 = sets[0][0][:1].float(), sets[0][1].float(), sets[0][2].float()
                r["f32_b1_err"] = err_of(pc.pixel_conv_rowdot(x1, w1, b1, **kw),
                                         pc.pixel_conv_rowdot_plain(x1, w1, b1, **kw), 1e-5,
                                         f"{name} {shape} f32 b1")
                xl = [s_[0].permute(0, 2, 1, 3).contiguous(memory_format=torch.channels_last)
                      for s_ in sets]
                wl = [s_[1].contiguous(memory_format=torch.channels_last) for s_ in sets]

                def lib(i):
                    return F.leaky_relu(F.conv2d(xl[i % n], wl[i % n], sets[i % n][2],
                                                 padding=1), 0.2)

                r["library"] = "F.conv2d channels-last bf16 with bias, then F.leaky_relu"
                kind = "bf16"
            else:
                kw = dict(alpha=0.2, inv_sy=0.5, requant=True)
                call = lambda i: pc.pixel_conv_rowdot_q(*sets[i % n], **kw)  # noqa: E731
                plain = lambda i: pc.pixel_conv_rowdot_q_plain(*sets[i % n], **kw)  # noqa: E731
                # wgmma_plan.pixel_plan, int8 out and bf16 out
                p8, p16 = (pc.plan(sets[0][0], sets[0][1], out_dtype=od) for od in (i8, bf16))
                r["form"] = p8.form + (" resident-weight" if p8.resident else "")
                r["bf16_out_form"] = p16.form + (" resident-weight" if p16.resident else "")
                check(p8.form == p16.form == "wgmma",
                      f"{name} {shape}: plans {p8.form}/{p16.form}, not the int8 wgmma form")
                got, ref = call(0), plain(0)
                torch.cuda.synchronize()
                check(torch.equal(got, ref), f"{name} {shape}: int8 outputs differ")
                kw16 = dict(kw, requant=False, out_dtype=bf16)
                check(torch.equal(pc.pixel_conv_rowdot_q(*sets[0], **kw16),
                                  pc.pixel_conv_rowdot_q_plain(*sets[0], **kw16)),
                      f"{name} {shape}: bf16 outputs differ")
                r["max_abs_err"] = (got.float() - ref.float()).abs().max().item()
                r["tolerance"] = "int8 and bf16 outputs equal"
                r["int8_levels_used"] = int(torch.unique(got).numel())
                lib, xl, wl = None, [], []
                r["library"] = "none: PyTorch has no int8 convolution on the card"
                kind = "int8"
            r["ms"] = graph_ms(torch, side, call, 10)
            r["call_ms"] = time_ms(torch, call, 10)
            r["plain_ms"] = graph_ms(torch, side, plain, 3)
            r["library_ms"] = graph_ms(torch, side, lib, 10) if lib is not None else None
            r["bound_ms"], r["bound_by"] = bound(nbytes, flops, kind, power_w)
            rows[(name, cin, cout, side_px)] = r
            del sets, xl, wl

    # rowdot_q at a shape the plan keeps on mma.sync (W 72: narrower than the
    # int8 form's 96-pixel box), int8 and bf16 out, equal to the plain version
    mshape = (B, 16, 64, 72)
    xm = torch.randint(-127, 128, mshape, device="cuda", generator=gen, dtype=i8)
    wm = torch.randint(-127, 128, (32, 64, 3, 3), device="cuda", generator=gen, dtype=i8)
    mops = (xm, wm, torch.rand(32, device="cuda", generator=gen) * 1e-4,
            torch.randn(32, device="cuda", generator=gen))
    mform = pc.plan(xm, wm, out_dtype=i8).form
    check(mform == "mma", f"pixel_conv_rowdot_q {list(mshape)}: plan {mform}, not mma.sync")
    for kw in (dict(alpha=0.2, inv_sy=0.5, requant=True),
               dict(alpha=0.2, requant=False, out_dtype=bf16)):
        check(torch.equal(pc.pixel_conv_rowdot_q(*mops, **kw),
                          pc.pixel_conv_rowdot_q_plain(*mops, **kw)),
              f"pixel_conv_rowdot_q {list(mshape)} (mma form): outputs differ")
    say(2, f"pixel_conv_rowdot_q {list(mshape) + [32]} ({mform} form): int8 and bf16 outputs "
           f"equal the plain version")
    REPORT["rowdot_q_mma_check"] = {"shape": list(mshape) + [32], "form": mform, "equal": True}

    for shape in SEGNET_UNPOOLS:
        Bs, C, h, w = shape
        nbytes = Bs * C * h * w * (2 + 8 + 4 * 2)
        sets = []
        for _ in range(_copies(nbytes)):
            full = torch.randn(Bs, C, 2 * h, 2 * w, device="cuda", generator=gen).to(bf16)
            val, plane = F.max_pool2d(full, 2, 2, return_indices=True)
            flat = plane + torch.arange(Bs * C, device="cuda").reshape(Bs, C, 1, 1) * 4 * h * w
            sets.append((val, flat, plane))
        n = len(sets)
        got = mu.max_unpool2x2(*sets[0][:2])
        ref = mu.max_unpool2x2_plain(*sets[0][:2])
        torch.cuda.synchronize()
        check(torch.equal(got, ref), f"max_unpool2x2 {shape}: outputs differ from the plain")
        lib_out = F.max_unpool2d(sets[0][0], sets[0][2], 2, 2)
        check(torch.equal(got, lib_out), f"max_unpool2x2 {shape}: outputs differ from "
                                         "F.max_unpool2d")
        r = {"name": "max_unpool2x2", "shape": list(shape), "calls_per_forward": 1,
             "bytes": nbytes, "max_abs_err": 0.0,
             "tolerance": "outputs equal (plain version and F.max_unpool2d)",
             "library": "F.max_unpool2d on per-plane indices"}
        r["ms"] = graph_ms(torch, side, lambda i: mu.max_unpool2x2(*sets[i % n][:2]), 20)
        r["call_ms"] = time_ms(torch, lambda i: mu.max_unpool2x2(*sets[i % n][:2]), 20)
        r["plain_ms"] = graph_ms(torch, side, lambda i: mu.max_unpool2x2_plain(
            *sets[i % n][:2]), 5)
        r["library_ms"] = graph_ms(torch, side, lambda i: F.max_unpool2d(
            sets[i % n][0], sets[i % n][2], 2, 2), 20)
        r["bound_ms"], r["bound_by"] = bound(nbytes, Bs * C * h * w * 4, "bf16", power_w)
        rows[("max_unpool2x2",) + shape] = r
        del sets

    for r in rows.values():
        lib = ("none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms")
        extra = f"; f32 b1 err {r['f32_b1_err']:.3g} (1e-5 x max)" if "f32_b1_err" in r else ""
        form = f" ({r['form']} form)" if "form" in r else ""
        if "bf16_out_form" in r:
            form = f" ({r['form']} form; bf16 out: {r['bf16_out_form']})"
        say(2, f"{r['name']} {r['shape']}{form}: err {r['max_abs_err']:.3g} ({r['tolerance']})"
               f"{extra} | kernel {r['ms']:.4f} ms (host cost of a call {r['call_ms']:.4f} ms), "
               f"plain {r['plain_ms']:.4f} ms, library {lib} ({r['library']}), bound "
               f"{r['bound_ms']:.4f} ms ({r['bound_by']}) = "
               f"{100 * r['bound_ms'] / r['ms']:.1f}% of bound | {r['calls_per_forward']} "
               f"calls a forward")
    torch.backends.cudnn.allow_tf32 = True
    REPORT["image_kernels"] = [dict(r, case=str(k)) for k, r in rows.items()]
    return rows


def phase_encoder_kernels(torch, power_w: float) -> dict:
    """The transformer encoder's kernels against their plain versions, on
    operands laid out as the HF-layout ViT's graph hands them over ((B, H,
    N, hd) views of (B, N, H, hd) tensors): short_attention at ViT-B/16
    224 px (B 128, H 12, N 197, hd 64) in bf16 and at batch 8 in f32;
    flash_attention at 384 px (B 64, N 577) and at the auto-flash shapes (B
    2, N 2048 and 4096) in bf16, and small in f32; mlp_block at 224 px
    batch 128 (25,216 rows, D 768, F 3072) in bf16 and at batch 8 in f32,
    plus a small pre_ln=0 / tanh case. Timed in bf16: kernel by graph
    replay, host cost of a call, plain version, library yardstick (SDPA;
    F.layer_norm, addmm, gelu, addmm and the add), bound."""
    import torch.nn.functional as F

    from smelter_tpu_torch.kernels import attention_short as sa
    from smelter_tpu_torch.kernels import flash_attention as fa
    from smelter_tpu_torch.kernels import mlp_block as mb

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(6)
    side = torch.cuda.Stream()
    bf16, f32 = torch.bfloat16, torch.float32
    H, hd, D, Fh = VIT_B16["heads"], VIT_B16["dim"] // VIT_B16["heads"], VIT_B16["dim"], 3072
    rows = {}

    def err_of(got, ref, rel, label):
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        check(got.shape == ref.shape and got.dtype == ref.dtype and math.isfinite(err)
              and err <= rel * scale, f"{label}: max-abs {err} > {rel} x {scale}")
        return err, f"{rel} x max|plain| = {rel * scale:.4g}"

    def bnhd(B, N, dtype):
        return (torch.randn(B, N, H, hd, device="cuda", generator=gen)
                .to(dtype).permute(0, 2, 1, 3))

    def timed(r, call, plain, lib, nbytes, flops, iters):
        r["ms"] = graph_ms(torch, side, call, iters)
        r["call_ms"] = time_ms(torch, call, iters)
        r["plain_ms"] = graph_ms(torch, side, plain, max(1, iters // 4))
        r["library_ms"] = graph_ms(torch, side, lib, iters)
        r["bytes"], r["flops"] = nbytes, flops
        r["bound_ms"], r["bound_by"] = bound(nbytes, flops, "bf16", power_w)

    # -- the attention kernels: (name, module, B, Nq, Nk, calls a forward, path)
    for name, mod, B, Nq, Nk, calls, path in (
            ("short_attention", sa, VIT_BATCH, 197, 197, 12, "224 px b128"),
            ("flash_attention", fa, HF_384_BATCH, 577, 577, 12, "384 px b64"),
            ("flash_attention", fa, 2, 2048, 2048, 1, "auto flash N 2048"),
            ("flash_attention", fa, 2, 4096, 4096, 1, "auto flash N 4096")):
        fn = sa.short_attention if mod is sa else fa.flash_attention
        plain_fn = sa.short_attention_plain if mod is sa else fa.flash_attention_plain
        scale = hd ** -0.5
        nbytes = 2 * B * H * (2 * Nq + 2 * Nk) * hd
        sets = [(bnhd(B, Nq, bf16), bnhd(B, Nk, bf16), bnhd(B, Nk, bf16))
                for _ in range(_copies(nbytes))]
        n = len(sets)
        r = {"name": name, "shape": [B, H, Nq, Nk, hd], "calls_per_forward": calls,
             "path": path, "library": "F.scaled_dot_product_attention on the same views",
             "form": mod.plan(*sets[0], torch.empty_like(sets[0][0])).form}
        check(r["form"] == ("one_pass" if mod is sa else "streaming"),
              f"{name} {path}: plan {r['form']}, not csrc/wgmma_attention.cuh's form")
        # bf16: p is rounded to bf16 before p V in the kernel (both kernels)
        # and not in flash's plain version; sums in other orders: 1e-2
        r["max_abs_err"], r["tolerance"] = err_of(fn(*sets[0], scale=scale),
                                                  plain_fn(*sets[0], scale=scale), 1e-2,
                                                  f"{name} {path} bf16")
        timed(r, lambda i: fn(*sets[i % n], scale=scale),
              lambda i: plain_fn(*sets[i % n], scale=scale),
              lambda i: F.scaled_dot_product_attention(*sets[i % n], scale=scale),
              nbytes, 4 * B * H * Nq * Nk * hd, 10 if B * Nq * Nk < 2e7 else 5)
        del sets
        rows[(name, path)] = r
    # f32 (full f32, sums in other orders: 1e-5) at the path's f32 gates' shapes
    for name, fn, plain_fn, B, N in (
            ("short_attention", sa.short_attention, sa.short_attention_plain, 8, 197),
            ("flash_attention", fa.flash_attention, fa.flash_attention_plain, 2, 577)):
        args = (bnhd(B, N, f32), bnhd(B, N, f32), bnhd(B, N, f32))
        r = next(r for k, r in rows.items() if k[0] == name)
        r[f"f32_b{B}_err"], r["f32_tolerance"] = err_of(
            fn(*args, scale=0.125), plain_fn(*args, scale=0.125), 1e-5, f"{name} f32 b{B}")
        r["f32_form"] = (sa if name == "short_attention" else fa).plan(
            *args, torch.empty_like(args[0])).form
        check(r["f32_form"] == "mma", f"{name} f32: plan {r['f32_form']}, not the f32 kernel")

    # -- mlp_block ---------------------------------------------------------
    def mlp_args(B, N, dtype, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)

        def rnd(*shape, s=1.0):
            return torch.randn(*shape, device="cuda", generator=g) * s

        return (rnd(B, N, D).to(dtype), 1 + rnd(D, s=0.1), rnd(D, s=0.1),
                rnd(D, Fh, s=D ** -0.5).to(dtype), rnd(Fh, s=0.1),
                rnd(Fh, D, s=Fh ** -0.5).to(dtype), rnd(D, s=0.1))

    B, N = VIT_BATCH, 197
    M = B * N
    kw = dict(eps=1e-12)
    nbytes = 2 * (2 * M * D + 2 * D * Fh) + 4 * (3 * D + Fh)
    sets = [mlp_args(B, N, bf16, 10 + i) for i in range(_copies(nbytes))]
    n = len(sets)
    fc1, fc2 = mb.plans(M, D, Fh, bf16)
    r = {"name": "mlp_block", "shape": [M, D, Fh], "calls_per_forward": 12,
         "path": "224 px b128", "form": f"FC1 {fc1.form}, FC2 {fc2.form}",
         "library": "F.layer_norm, torch.addmm, F.gelu, torch.addmm, the residual add"}
    check(fc1.form == fc2.form == "tma", f"mlp_block {[M, D, Fh]}: {r['form']}, not gemm_tma")

    lib_params = [[t.to(bf16) for t in (g, b, b1, b2)] for _, g, b, _, b1, _, b2 in sets]

    def lib(i):
        x, _, _, w1, _, w2, _ = sets[i % n]
        g, b, b1, b2 = lib_params[i % n]
        x2 = x.reshape(M, D)
        h = F.gelu(torch.addmm(b1, F.layer_norm(x2, (D,), g, b, 1e-12), w1))
        return torch.addmm(b2, h, w2) + x2

    # bf16: xn and h round to bf16 after sums in other orders: 1e-2
    r["max_abs_err"], r["tolerance"] = err_of(mb.mlp_block(*sets[0], **kw),
                                              mb.mlp_block_plain(*sets[0], **kw), 1e-2,
                                              "mlp_block bf16")
    timed(r, lambda i: mb.mlp_block(*sets[i % n], **kw),
          lambda i: mb.mlp_block_plain(*sets[i % n], **kw), lib, nbytes, 4 * M * D * Fh, 5)
    del sets, lib_params
    args = mlp_args(8, N, f32, 30)
    r["f32_b8_err"], r["f32_tolerance"] = err_of(mb.mlp_block(*args, **kw),
                                                 mb.mlp_block_plain(*args, **kw), 1e-5,
                                                 "mlp_block f32 b8")
    r["f32_form"] = mb.plans(8 * N, D, Fh, f32)[0].form
    check(r["f32_form"] == "mma", f"mlp_block f32: plan {r['f32_form']}, not the f32 kernel")
    small = {}
    for dtype, rel in ((bf16, 1e-2), (f32, 1e-5)):
        args = mlp_args(2, 50, dtype, 31)
        kws = dict(eps=1e-6, pre_ln=False, approximate=True, residual=False)
        small[f"pre_ln=0 tanh 2x50 {str(dtype)[6:]}"] = err_of(
            mb.mlp_block(*args, **kws), mb.mlp_block_plain(*args, **kws), rel,
            f"mlp_block pre_ln=0 {dtype}")[0]
    r["small_forms_err"] = small
    rows[("mlp_block", "224 px b128")] = r

    for r in rows.values():
        f32 = "; ".join(f"{k[:-4]} err {v:.3g} ({r['f32_tolerance']})"
                        for k, v in r.items() if k.startswith("f32_b") and k.endswith("_err"))
        form = (f" | {r['form']} form (f32: {r['f32_form']})" if "f32_form" in r else
                f" | {r['form']} form" if "form" in r else "")
        say(2, f"{r['name']} {r['path']} {r['shape']} bf16: err {r['max_abs_err']:.3g} "
               f"({r['tolerance']}){'; ' + f32 if f32 else ''}{form} | kernel {r['ms']:.4f} ms "
               f"(host cost of a call {r['call_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, "
               f"library {r['library_ms']:.4f} ms ({r['library']}), bound {r['bound_ms']:.4f} ms "
               f"({r['bound_by']}, {r['bytes']} bytes, {r['flops']:.4g} operations) = "
               f"{100 * r['bound_ms'] / r['ms']:.1f}% of bound, "
               f"{r['flops'] / r['ms'] / 1e9:.1f} TF/s | {r['calls_per_forward']} calls a "
               f"forward")
    say(2, "mlp_block at small shapes vs plain: "
           + "; ".join(f"{k} {v:.3g}" for k, v in small.items()))
    REPORT["encoder_kernels"] = [dict(r) for r in rows.values()]
    return rows


def phase_block_kernels(torch, np, power_w: float) -> dict:
    """The opt-in block kernels of the image models against their plain
    versions: convnext_block at ConvNeXt-T's three fused stages at batch 64
    (56 x 56 x 96, 28 x 28 x 192, 14 x 14 x 384) in bf16 and at batch 2 in
    f32; cross_attn_block at SD-UNet's two shapes at batch 8 ((N 1024, D 128)
    and (N 256, D 256), 8 heads, 16 keys), k/v per image (Bk = B, the path's)
    and shared (Bk = 1, timed too), in bf16 and f32; vit_attention_block at
    SD-UNet's self-attention shapes (hd 16 in one head group of 8, hd 32 in
    groups of 4). Timed in bf16: kernel by graph replay, host cost of a call, plain
    version, library yardstick, bound (the depthwise taps count at the f32
    CUDA-core rate, the products at the bf16 tensor-core rate)."""
    import torch.nn.functional as F

    from smelter_tpu_torch.kernels import convnext_block as cb
    from smelter_tpu_torch.kernels import cross_attn_block as xa
    from smelter_tpu_torch.kernels import vit_block as vb

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(7)
    side = torch.cuda.Stream()
    bf16, f32 = torch.bfloat16, torch.float32
    rows = {}

    def err_of(got, ref, rel, label):
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        check(got.shape == ref.shape and got.dtype == ref.dtype and math.isfinite(err)
              and err <= rel * scale, f"{label}: max-abs {err} > {rel} x {scale}")
        return err, f"{rel} x max|plain| = {rel * scale:.4g}"

    def rnd(*shape, s=1.0, dtype=bf16):
        return (torch.randn(*shape, device="cuda", generator=gen) * s).to(dtype)

    def timed(r, call, plain, lib, nbytes, ops, iters):
        r["ms"] = graph_ms(torch, side, call, iters)
        r["call_ms"] = time_ms(torch, call, iters)
        r["plain_ms"] = graph_ms(torch, side, plain, max(1, iters // 4))
        r["library_ms"] = graph_ms(torch, side, lib, iters)
        r["bytes"], r["flops"] = nbytes, sum(ops.values())
        r["bound_ms"], r["bound_by"] = bound(nbytes, ops, None, power_w)

    # -- convnext_block ----------------------------------------------------
    def cnx_args(B, H, W, C, dtype):
        """A block's operands; a layer scale of 0.5 (not the 1e-6 init), so
        the MLP shows in the output."""
        Fh = 4 * C
        return (rnd(B, H, W, C, dtype=dtype), rnd(7, 7, 1, C, s=1 / 7, dtype=dtype),
                rnd(C, s=0.1, dtype=f32), 1 + rnd(C, s=0.1, dtype=f32), rnd(C, s=0.1, dtype=f32),
                rnd(C, Fh, s=C ** -0.5, dtype=dtype), rnd(Fh, s=0.1, dtype=f32),
                rnd(Fh, C, s=Fh ** -0.5, dtype=dtype), rnd(C, s=0.1, dtype=f32),
                0.5 + rnd(C, s=0.1, dtype=f32))

    B = CONVNEXT_BATCH
    for stage, (hw, C) in enumerate(((56, 96), (28, 192), (14, 384))):
        M, Fh = B * hw * hw, 4 * C
        nbytes = 2 * (2 * M * C + 49 * C + 2 * C * Fh) + 4 * (5 * C + Fh)
        sets = [cnx_args(B, hw, hw, C, bf16) for _ in range(_copies(nbytes))]
        n = len(sets)
        lib_w = [(dw.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last),
                  db.to(bf16), g.to(bf16), b.to(bf16), b1.to(bf16), b2.to(bf16), gm.to(bf16))
                 for _, dw, db, g, b, _, b1, _, b2, gm in sets]
        path = f"stage {stage + 1} b{B}"
        r = {"name": "convnext_block", "shape": [B, hw, hw, C],
             "calls_per_forward": CONVNEXT["depths"][stage], "path": path,
             "library": "channels-last depthwise F.conv2d, F.layer_norm, torch.addmm, F.gelu, "
                        "torch.addmm, the layer-scale mul and the residual add"}

        def lib(i, hw=hw, C=C, M=M):
            x, _, _, _, _, w1, _, w2, _, _ = sets[i % n]
            dw, db, g, b, b1, b2, gm = lib_w[i % n]
            y = F.conv2d(x.permute(0, 3, 1, 2), dw, db, padding=3, groups=C).permute(0, 2, 3, 1)
            xn = F.layer_norm(y, (C,), g, b, 1e-6).reshape(M, C)
            h = F.gelu(torch.addmm(b1, xn, w1))
            return x + (torch.addmm(b2, h, w2) * gm).reshape(x.shape)

        # bf16: xn, h and the output round to bf16 after sums in other orders
        r["max_abs_err"], r["tolerance"] = err_of(cb.convnext_block(*sets[0]),
                                                  cb.convnext_block_plain(*sets[0]), 1e-2,
                                                  f"convnext_block {path} bf16")
        timed(r, lambda i: cb.convnext_block(*sets[i % n]),
              lambda i: cb.convnext_block_plain(*sets[i % n]), lib, nbytes,
              {"bf16": 16 * M * C * C, "f32": 2 * 49 * M * C}, 5)
        del sets, lib_w
        # f32 at batch 2: every tap and product in full f32 (TF32 off for
        # the plain version's cuDNN conv), sums in other orders: 1e-5
        torch.backends.cudnn.allow_tf32 = False
        args = cnx_args(2, hw, hw, C, f32)
        r["f32_b2_err"], r["f32_tolerance"] = err_of(cb.convnext_block(*args),
                                                     cb.convnext_block_plain(*args), 1e-5,
                                                     f"convnext_block {path} f32 b2")
        torch.backends.cudnn.allow_tf32 = True
        rows[("convnext_block", path)] = r

    splits = phase_convnext_split()
    for r, split in zip((r for r in rows.values() if r["name"] == "convnext_block"),
                        splits.values()):
        r["split"] = split

    # -- cross_attn_block --------------------------------------------------
    S, H = SD_UNET["ctx_len"], SD_UNET["heads"]
    for N, D, calls in ((1024, 128, 2), (256, 256, 3)):
        B, hd = SD_UNET_BATCH, D // H

        def xa_args(bk, dtype):
            return (rnd(B, N, D, dtype=dtype), rnd(D, D, s=D ** -0.5, dtype=dtype),
                    rnd(bk, H, S, hd, dtype=dtype), rnd(bk, H, S, hd, dtype=dtype),
                    rnd(D, D, s=D ** -0.5, dtype=dtype), rnd(D, s=0.1, dtype=f32))

        nbytes = 2 * (2 * B * N * D + 2 * D * D + 2 * B * H * S * hd) + 4 * D
        sets = [xa_args(B, bf16) for _ in range(_copies(nbytes))]
        n = len(sets)
        lib_b = [a[5].to(bf16) for a in sets]
        path = f"N {N} D {D} b{B}"
        r = {"name": "cross_attn_block", "shape": [B, N, D, H, S], "calls_per_forward": calls,
             "path": path, "library": "torch.matmul, F.scaled_dot_product_attention, "
                                      "torch.addmm"}

        def lib(i, B=B, N=N, D=D, hd=hd):
            x, wq, k, v, wp, _ = sets[i % n]
            q = torch.matmul(x, wq).reshape(B, N, H, hd).transpose(1, 2)
            a = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(B * N, D)
            return torch.addmm(lib_b[i % n], a, wp)

        # bf16: q, p and the attention output round to bf16 after sums in
        # other orders: 1e-2
        r["max_abs_err"], r["tolerance"] = err_of(xa.cross_attn_block(*sets[0], heads=H),
                                                  xa.cross_attn_block_plain(*sets[0], heads=H),
                                                  1e-2, f"cross_attn_block {path} bf16")
        timed(r, lambda i: xa.cross_attn_block(*sets[i % n], heads=H),
              lambda i: xa.cross_attn_block_plain(*sets[i % n], heads=H), lib, nbytes,
              {"bf16": B * (4 * N * D * D + 4 * N * S * D)}, 20)
        p = xa.plan(sets[0][0], sets[0][2], H)
        check(p.form == "wgmma" and p.ctas >= 128, f"cross_attn_block {path}: plan {p}")
        # the mma.sync form (one block a 64-row tile), the design it replaces,
        # on the same inputs in this run
        mma = dataclasses.replace(p, form="mma")
        err_of(xa._launch(*sets[0], H, None, mma), xa.cross_attn_block_plain(*sets[0], heads=H),
               1e-2, f"cross_attn_block {path} mma.sync form")
        r["mma_form_ms"] = graph_ms(torch, side, lambda i: xa._launch(*sets[i % n], H, None, mma),
                                    20)
        r["form"] = (f"{p.form} form: grid {list(p.grid)} = {p.ctas} CTAs of 64 rows x "
                     f"{p.heads} heads, clusters of {p.cluster}, {p.smem} bytes of shared "
                     f"memory; mma.sync form {r['mma_form_ms']:.4f} ms")
        del sets, lib_b
        for bk in (1, B):  # shared and per-image k/v, bf16 and f32
            for dtype, rel in ((bf16, 1e-2), (f32, 1e-5)):
                args = xa_args(bk, dtype)
                r[f"bk{bk}_{str(dtype)[6:]}_err"] = err_of(
                    xa.cross_attn_block(*args, heads=H), xa.cross_attn_block_plain(*args, heads=H),
                    rel, f"cross_attn_block {path} Bk {bk} {dtype}")[0]
        # the shared context (Bk = 1) timed too: kernel, host cost, plain
        sets = [xa_args(1, bf16) for _ in range(_copies(nbytes))]
        n = len(sets)
        r["bk1_ms"] = graph_ms(torch, side, lambda i: xa.cross_attn_block(*sets[i % n], heads=H),
                               20)
        r["bk1_call_ms"] = time_ms(torch, lambda i: xa.cross_attn_block(*sets[i % n], heads=H),
                                   20)
        r["bk1_plain_ms"] = graph_ms(
            torch, side, lambda i: xa.cross_attn_block_plain(*sets[i % n], heads=H), 5)
        del sets
        r["f32_tolerance"] = "1e-5 x max|plain|"
        rows[("cross_attn_block", path)] = r

    # -- vit_attention_block at SD-UNet's self-attention --------------------
    for N, D, calls in ((1024, 128, 2), (256, 256, 3)):
        B = SD_UNET_BATCH
        kw = dict(heads=H, eps=1e-5)
        nbytes = 2 * B * N * D * 2 + 4 * D * D * 2 + 6 * D * 2
        sets, libw = [], []
        for k in range(_copies(nbytes)):
            args, lw = _vit_case(torch, np, gen, B, N, D, H, bf16, bf16, seed=20 + k)
            sets.append(args)
            libw.append(lw)
        n = len(sets)
        path = f"SD-UNet N {N} D {D} b{B}"
        r = {"name": "vit_attention_block", "shape": [B, N, D, H], "calls_per_forward": calls,
             "path": path, "library": "F.layer_norm, torch.addmm, "
                                      "F.scaled_dot_product_attention, torch.addmm"}

        def lib(i, B=B, N=N, D=D):
            x, g, b = sets[i % n][:3]
            wqkv, bqkv, wp, bp = libw[i % n]
            xn = F.layer_norm(x, (D,), g, b, 1e-5).reshape(B * N, D)
            q, k, v = torch.addmm(bqkv, xn, wqkv).reshape(B, N, 3, H, D // H).permute(2, 0, 3,
                                                                                       1, 4)
            a = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(B * N, D)
            return torch.addmm(bp, a, wp)

        r["max_abs_err"], r["tolerance"] = err_of(vb.vit_attention_block(*sets[0], **kw),
                                                  vb.vit_attention_block_plain(*sets[0], **kw),
                                                  1e-2, f"vit_attention_block {path} bf16")
        timed(r, lambda i: vb.vit_attention_block(*sets[i % n], **kw),
              lambda i: vb.vit_attention_block_plain(*sets[i % n], **kw), lib, nbytes,
              {"bf16": B * (8 * N * D * D + 4 * N * N * D)}, 10)
        del sets, libw
        args, _ = _vit_case(torch, np, gen, B, N, D, H, f32, f32, seed=30)
        r["f32_b8_err"], r["f32_tolerance"] = err_of(vb.vit_attention_block(*args, **kw),
                                                     vb.vit_attention_block_plain(*args, **kw),
                                                     1e-5, f"vit_attention_block {path} f32")
        rows[("vit_attention_block", path)] = r

    for r in rows.values():
        f32s = "; ".join(f"{k[:-4]} err {v:.3g}" for k, v in r.items()
                         if k.endswith("_err") and k != "max_abs_err")
        bk1 = (f"; Bk 1: kernel {r['bk1_ms']:.4f} ms (host cost {r['bk1_call_ms']:.4f}), plain "
               f"{r['bk1_plain_ms']:.4f}" if "bk1_ms" in r else "")
        bk1 += f" | {r['form']}" if "form" in r else ""
        say(2, f"{r['name']} {r['path']} {r['shape']} bf16: err {r['max_abs_err']:.3g} "
               f"({r['tolerance']}); {f32s} ({r['f32_tolerance']}) | kernel {r['ms']:.4f} ms "
               f"(host cost of a call {r['call_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, "
               f"library {r['library_ms']:.4f} ms ({r['library']}), bound "
               f"{r['bound_ms']:.4f} ms ({r['bound_by']}, {r['bytes']} bytes, "
               f"{r['flops']:.4g} operations) = {100 * r['bound_ms'] / r['ms']:.1f}% of bound "
               f"| {r['calls_per_forward']} calls a forward{bk1}")
    fw = per_forward(rows, "cross_attn_block")
    fw["mma_form_ms"] = sum(r["mma_form_ms"] * r["calls_per_forward"] for r in rows.values()
                            if r["name"] == "cross_attn_block")
    say(2, f"cross_attn_block over an SD-UNet b8 forward's 5 calls: kernel {fw['ms']:.4f} ms "
           f"(mma.sync form {fw['mma_form_ms']:.4f}), plain {fw['plain_ms']:.4f}, library "
           f"{fw['library_ms']:.4f}, bound {fw['bound_ms']:.4f}")
    REPORT["cross_attn_forward"] = fw
    REPORT["block_kernels"] = [dict(r) for r in rows.values()]
    return rows


def resnet50_convs(size: int = RESNET_IMAGE) -> dict:
    """ResNet-50 v1.5's convs (the zoo builder's: the stride on the 3x3):
    (C_in, C_out, k, stride, H_in) -> calls a forward, 53 in all."""
    convs: dict = {}

    def add(*key):
        convs[key] = convs.get(key, 0) + 1

    add(3, 64, 7, 2, size)
    h, cin = size // 4, 64
    for width, blocks, stride in ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)):
        for i in range(blocks):
            s = stride if i == 0 else 1
            h_out = (h - 1) // s + 1
            add(cin, width, 1, 1, h)
            add(width, width, 3, s, h)
            add(width, 4 * width, 1, 1, h_out)
            if i == 0:
                add(cin, 4 * width, 1, s, h)
            cin, h = 4 * width, h_out
    return convs


# ResNet-50's residual joins at batch 128: (C, map side, int8 out) -> calls
# a forward (the last stage's last join writes the f32 edge the pool reads).
RESNET_JOINS = {(256, 56, True): 3, (512, 28, True): 4, (1024, 14, True): 6,
                (2048, 7, True): 2, (2048, 7, False): 1}


def phase_conv_kernels(torch, power_w: float) -> dict:
    """qlinear_conv at each distinct conv shape of ResNet-50 at batch 128
    on its wgmma form (int8 outputs equal to the plain version's, with and
    without the Relu epilogue; the library yardstick is cuDNN's bf16
    channels-last conv, since PyTorch has no int8 conv); int8_join at
    ResNet-50's join shapes at batch 128 (int8 or f32 out equal to the
    plain version's; no single library call computes it); and
    dequant_conv: first its own entry point called at ResNet-50's four
    stride-1 3x3 shapes at batch 128 in bf16 (its launches: no path of
    either package reaches it), then against its plain version there
    (1e-2 of the largest), in f32 at small shapes (1e-5, TF32 off) and at
    the JAX tests' odd cases; the yardstick cuDNN's bf16 channels-last conv
    on the dequantized weight."""
    import torch.nn.functional as F

    from smelter_tpu_torch.kernels import dequant_conv as dc
    from smelter_tpu_torch.kernels import int8_join as ij
    from smelter_tpu_torch.kernels import qlinear_conv as qc
    from smelter_tpu_torch.kernels import wgmma_plan

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(7)
    side = torch.cuda.Stream()
    cl, bf16, i8 = torch.channels_last, torch.bfloat16, torch.int8
    B = RESNET_BATCH
    rows = {}
    convs = resnet50_convs()
    check(sum(convs.values()) == 53, f"ResNet-50 has 53 convs, not {sum(convs.values())}")
    for (cin, cout, k, s, h), calls in convs.items():
        p = k // 2
        ho = (h + 2 * p - k) // s + 1
        K = k * k * cin
        nbytes = B * h * h * cin + cout * K + 8 * cout + B * ho * ho * cout
        ops = 2 * B * ho * ho * cout * K
        sets = []
        for _ in range(_copies(nbytes)):
            x = torch.randint(-128, 128, (B, cin, h, h), device="cuda", generator=gen,
                              dtype=i8).contiguous(memory_format=cl)
            w = torch.randint(-127, 128, (cout, cin, k, k), device="cuda", generator=gen,
                              dtype=i8).contiguous(memory_format=cl)
            # the sums' spread is about 5400 sqrt(K): outputs span the grid
            m = (torch.rand(cout, device="cuda", generator=gen) + 0.5) * 0.0074 / K ** 0.5
            b = (torch.rand(cout, device="cuda", generator=gen) - 0.5) * 40
            sets.append((x, w, m, b))
        n = len(sets)
        kw = dict(stride=(s, s), pads=((p, p), (p, p)))
        plan = wgmma_plan.qconv_plan(B, h, h, cin, cout, k, k, s, s, kw["pads"])
        check(plan.form in ("gemm", "im2col"),
              f"qlinear_conv {(cin, cout, k, s, h)} takes the {plan.form} form")
        call = lambda i: qc.qlinear_conv(*sets[i % n], **kw)  # noqa: E731
        plain = lambda i: qc.qlinear_conv_plain(*sets[i % n], **kw)  # noqa: E731
        got, ref = call(0), plain(0)
        relu_got = qc.qlinear_conv(*sets[0], relu=True, **kw)
        torch.cuda.synchronize()
        check(torch.equal(got, ref), f"qlinear_conv {(cin, cout, k, s, h)}: int8 outputs "
                                     "differ from the plain version")
        check(torch.equal(relu_got, torch.relu(ref)),
              f"qlinear_conv {(cin, cout, k, s, h)}: the Relu epilogue differs from the plain")
        check(got.is_contiguous(memory_format=cl), "qlinear_conv output not channels-last")
        xl = [s_[0].to(bf16) for s_ in sets]
        wl = [s_[1].to(bf16) for s_ in sets]
        r = {"name": "qlinear_conv", "shape": [B, cin, h, h, cout, k, s],
             "form": plan.form, "tile": [wgmma_plan.BM, plan.bn], "k_step": plan.bk,
             "c_in_read": plan.c_in, "tiles": plan.tiles,
             "calls_per_forward": calls, "bytes": nbytes, "ops": ops, "max_abs_err": 0.0,
             "tolerance": "int8 outputs equal",
             "int8_levels_used": int(torch.unique(got).numel()),
             "library": "F.conv2d channels-last bf16 (PyTorch has no int8 conv)"}
        del got, ref, relu_got
        r["ms"] = graph_ms(torch, side, call, 10)
        r["call_ms"] = time_ms(torch, call, 10)
        r["plain_ms"] = graph_ms(torch, side, plain, 2, replays=2)
        r["library_ms"] = graph_ms(torch, side, lambda i: F.conv2d(
            xl[i % n], wl[i % n], stride=s, padding=p), 10)
        r["bound_ms"], r["bound_by"] = bound(nbytes, ops, "int8", power_w)
        rows[("qlinear_conv", cin, cout, k, s, h)] = r
        del sets, xl, wl

    # int8_join at ResNet-50's join shapes: a conv's int8 output and the
    # block's int8 carry, channels-last, in int8 or (the last join) f32
    for (c, hw, q8), calls in RESNET_JOINS.items():
        el = B * c * hw * hw
        nbytes = el * (3 if q8 else 6)
        sets = []
        for _ in range(_copies(nbytes)):
            a, b_ = (torch.randint(-128, 128, (B, c, hw, hw), device="cuda", generator=gen,
                                   dtype=i8).contiguous(memory_format=cl) for _ in range(2))
            sets.append((a, b_))
        n = len(sets)
        s_a, s_b, inv = 0.0371, 0.0517, (1 / 0.0643 if q8 else None)
        call = lambda i: ij.int8_join(*sets[i % n], s_a, s_b, inv)  # noqa: E731
        plain = lambda i: ij.int8_join_plain(*sets[i % n], s_a, s_b, inv)  # noqa: E731
        got, ref = call(0), plain(0)
        torch.cuda.synchronize()
        check(torch.equal(got, ref), f"int8_join {(c, hw, q8)}: outputs differ from the plain")
        check(got.stride() == sets[0][0].stride(), "int8_join output not in its inputs' layout")
        r = {"name": "int8_join", "shape": [B, c, hw, hw], "out": "int8" if q8 else "f32",
             "calls_per_forward": calls, "bytes": nbytes, "ops": 7 * el, "max_abs_err": 0.0,
             "tolerance": "outputs equal",
             "library": "none: no single PyTorch call computes the chain"}
        del got, ref
        r["ms"] = graph_ms(torch, side, call, 10)
        r["call_ms"] = time_ms(torch, call, 10)
        r["plain_ms"] = graph_ms(torch, side, plain, 3)
        r["library_ms"] = None
        r["bound_ms"], r["bound_by"] = bound(nbytes, 7 * el, "f32", power_w)
        rows[("int8_join", c, hw, q8)] = r
        del sets

    # dequant_conv: its entry point once at each of ResNet-50's stride-1 3x3
    # shapes (its launches), then the checks and times at those shapes
    dshapes = [(56, 64), (28, 128), (14, 256), (7, 512)]
    operands = {}
    for hw, c in dshapes:
        x = torch.randn(B, hw, hw, c, device="cuda", generator=gen).to(bf16)
        wq = torch.randint(-127, 128, (3, 3, c, c), device="cuda", generator=gen, dtype=i8)
        sc = (torch.rand(c, device="cuda", generator=gen) + 0.5) * 1e-2 / (9 * c) ** 0.5
        operands[(hw, c)] = [(x, wq, sc)]
    _zero_counts()
    outs = {key: dc.dequant_conv(*ops_[0], pads=((1, 1), (1, 1)))
            for key, ops_ in operands.items()}
    torch.cuda.synchronize()
    entry = _counts()
    _check_routed("dequant_conv entry point", entry, "dequant_conv")
    check(entry["dequant_conv"] == len(dshapes), f"dequant_conv launches {entry}")
    REPORT["dequant_conv_entry_launches"] = entry["dequant_conv"]
    for (hw, c), sets in operands.items():
        nbytes = B * hw * hw * c * 2 * 2 + 9 * c * c + 4 * c
        ops = 2 * B * hw * hw * c * 9 * c
        for _ in range(_copies(nbytes) - 1):
            x = torch.randn(B, hw, hw, c, device="cuda", generator=gen).to(bf16)
            sets.append((x, sets[0][1], sets[0][2]))
        n = len(sets)
        pads = ((1, 1), (1, 1))
        ref = dc.dequant_conv_plain(*sets[0], pads=pads)
        got = outs.pop((hw, c))
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        check(got.shape == ref.shape and got.dtype == bf16 and err <= 1e-2 * scale,
              f"dequant_conv {(hw, c)} bf16: max-abs {err} > 1e-2 x {scale}")
        xl = [s_[0].permute(0, 3, 1, 2) for s_ in sets]  # NCHW views, channels-last
        wd = ((sets[0][1].float() * sets[0][2]).to(bf16).permute(3, 2, 0, 1)
              .contiguous(memory_format=cl))
        plan = wgmma_plan.conv_plan(B, hw, hw, c, c, 3, 3, pads)
        check(plan.form == "wgmma", f"dequant_conv {(hw, c)} takes the {plan.form} form")
        r = {"name": "dequant_conv", "shape": [B, hw, hw, c, c, 3], "calls_per_forward": 1,
             "form": plan.form, "tile": [plan.bm, plan.bn], "tiles": plan.tiles,
             "bytes": nbytes, "ops": ops, "max_abs_err": err,
             "tolerance": f"1e-2 x max|plain| = {1e-2 * scale:.4g} (bf16)",
             "library": "F.conv2d channels-last bf16 on the dequantized weight"}
        del got, ref
        r["ms"] = graph_ms(torch, side, lambda i: dc.dequant_conv(*sets[i % n], pads=pads), 10)
        r["call_ms"] = time_ms(torch, lambda i: dc.dequant_conv(*sets[i % n], pads=pads), 10)
        r["plain_ms"] = graph_ms(torch, side, lambda i: dc.dequant_conv_plain(
            *sets[i % n], pads=pads), 3)
        r["library_ms"] = graph_ms(torch, side, lambda i: F.conv2d(xl[i % n], wd, padding=1), 10)
        r["bound_ms"], r["bound_by"] = bound(nbytes, ops, "bf16", power_w)
        rows[("dequant_conv", hw, c)] = r
        del sets, xl, wd
    # small f32 (1e-5, TF32 off) and bf16 checks, among them the JAX tests'
    # odd cases: 5x5, VALID 11 x 9, W 28 with pad 1, and C_in 3
    checks = []
    for (hw_, c_in, c_out, k, pads) in (((14, 14), 64, 64, 3, ((1, 1), (1, 1))),
                                        ((12, 12), 128, 128, 5, ((2, 2), (2, 2))),
                                        ((11, 9), 128, 128, 3, ((0, 0), (0, 0))),
                                        ((28, 28), 128, 128, 3, ((1, 1), (1, 1))),
                                        ((17, 19), 3, 64, 3, ((1, 1), (1, 1)))):
        wq = torch.randint(-127, 128, (k, k, c_in, c_out), device="cuda", generator=gen, dtype=i8)
        sc = torch.rand(c_out, device="cuda", generator=gen) * 1e-2
        for dtype, rel in ((torch.float32, 1e-5), (bf16, 1e-2)):
            x = torch.randn((2,) + hw_ + (c_in,), device="cuda", generator=gen).to(dtype)
            got = dc.dequant_conv(x, wq, sc, pads=pads)
            ref = dc.dequant_conv_plain(x, wq, sc, pads=pads)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            check(got.shape == ref.shape and err <= rel * scale,
                  f"dequant_conv {hw_, c_in, c_out, k, pads} {dtype}: {err} > {rel} x {scale}")
            checks.append([list(hw_), c_in, c_out, k, str(dtype), err / scale])
    REPORT["dequant_conv_checks"] = checks

    for r in rows.values():
        if r["name"] == "int8_join":
            say(2, f"int8_join {r['shape']} {r['out']} out: equal to the plain version | kernel "
                   f"{r['ms']:.4f} ms (host cost of a call {r['call_ms']:.4f} ms), plain "
                   f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}) = "
                   f"{100 * r['bound_ms'] / r['ms']:.1f}% of bound | {r['calls_per_forward']} "
                   "a forward")
            continue
        if r["name"] == "qlinear_conv":
            say(2, f"qlinear_conv {r['shape']}: {r['form']} form, {r['tiles']} tiles of "
                   f"{r['tile'][0]} x {r['tile'][1]}, K steps of {r['k_step']} bytes over "
                   f"{r['c_in_read']} channels")
        if r["name"] == "dequant_conv":
            say(2, f"dequant_conv {r['shape']}: {r['form']} form, {r['tiles']} tiles of "
                   f"{r['tile'][0]} x {r['tile'][1]} | kernel {r['ms']:.4f} ms, cuDNN "
                   f"{r['library_ms']:.4f} ms")
        say(2, f"{r['name']} {r['shape']}: err {r['max_abs_err']:.3g} ({r['tolerance']}) | "
               f"kernel {r['ms']:.4f} ms (host cost of a call {r['call_ms']:.4f} ms), plain "
               f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms ({r['library']}), "
               f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}) = "
               f"{100 * r['bound_ms'] / r['ms']:.1f}% of bound, "
               f"{r['ops'] / r['ms'] / 1e9:.1f} TOP/s | {r['calls_per_forward']} a forward")
    fw = per_forward(rows, "qlinear_conv")
    fj = per_forward(rows, "int8_join")
    say(2, f"qlinear_conv over a ResNet-50 b128 forward's 53 calls: kernel {fw['ms']:.3f} ms, "
           f"plain {fw['plain_ms']:.3f} ms, cuDNN bf16 {fw['library_ms']:.3f} ms, bound "
           f"{fw['bound_ms']:.3f} ms; int8_join over its 16: kernel {fj['ms']:.3f} ms, plain "
           f"{fj['plain_ms']:.3f} ms, bound {fj['bound_ms']:.3f} ms ({fj['bound_by']}); "
           "dequant_conv small checks (max-abs / max): "
           + ", ".join(f"{c[:4]} {c[4][6:]} {c[5]:.2g}" for c in checks))
    torch.backends.cudnn.allow_tf32 = True
    REPORT["conv_kernels"] = [dict(r, case=str(k)) for k, r in rows.items()]
    return rows


def _fused_form(p) -> str:
    """A fused int8 GEMM plan in words (`wgmma_plan.FusedPlan`)."""
    if p.form == "revisit":
        return f"revisit form, {p.cols}-column tiles, {p.stages} stages, grid {p.grid}"
    if p.form == "mma":
        return f"mma form (mma.sync), grid {p.grid}"
    return f"{p.form} form, split {p.split}, k_chunk {p.k_chunk}, grid {p.grid}"


def phase_variant_kernels(torch, power_w: float) -> dict:
    """The four kernels no path of either package reaches, through their
    own entry points: first each called once at its main shapes (its
    launches: `dequant_matmul_int8_fused` and `_fused2` at the ResNet-50
    head and the serving GEMM, `pixel_conv_blockdot` and `pixel_conv_patch`
    at each of ESRGAN x4's PixelConv shapes at batch 8, all bf16), then held
    to their plain versions there and timed: the fused GEMMs bit-equal to
    the plain version and to the two-pass `dequant_matmul_int8` (whose time
    goes beside them; the yardstick `dequant_matmul_int8_reference`, on
    `torch._int_mm`); blockdot and patch within 1e-2 x max|plain| in bf16
    and 1e-5 in f32 at batch 1 (TF32 off), yardsticks cuDNN's channels-last
    (blockdot, as rowdot) and NCHW (patch) convs + leaky_relu. Then small
    odd shapes, and a profile of one patch call: one kernel, no layout
    copy."""
    import torch.nn.functional as F

    from smelter_tpu_torch.kernels import int8_matmul as im
    from smelter_tpu_torch.kernels import pixel_conv as pc
    from smelter_tpu_torch.kernels import wgmma_plan

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(9)
    side = torch.cuda.Stream()
    bf16, B = torch.bfloat16, ESRGAN_BATCH
    fused = {"dequant_matmul_int8_fused": im.dequant_matmul_int8_fused,
             "dequant_matmul_int8_fused2": im.dequant_matmul_int8_fused2}

    def gemm_operands(M, K, N, dtype=bf16, copies=1):
        return [(torch.randn(M, K, device="cuda", generator=gen).to(dtype),
                 torch.randint(-127, 128, (K, N), device="cuda", generator=gen, dtype=torch.int8),
                 torch.rand(N, device="cuda", generator=gen) * 0.02 + 1e-3)
                for _ in range(copies)]

    def conv_operands(cin, cout, px, batch=B, dtype=bf16, copies=1, width=None):
        """NHCW x of px rows of `width` (px) pixels, the weight as an OIHW
        view of its packed buffer, bias."""
        sets = []
        for _ in range(copies):
            w = torch.randn(cout, cin, 3, 3, device="cuda", generator=gen) / (3 * cin ** 0.5)
            x = torch.randn(batch, px, cin, width or px, device="cuda", generator=gen)
            sets.append((x.to(dtype),
                         w.to(dtype).permute(2, 3, 0, 1).contiguous().permute(2, 3, 0, 1),
                         torch.randn(cout, device="cuda", generator=gen).to(dtype)))
        return sets

    def flat(x):  # NHCW -> flat NCHW (B, C, H*W)
        b_, h_, c_, w_ = x.shape
        return x.permute(0, 2, 1, 3).reshape(b_, c_, h_ * w_).contiguous()

    def err_of(got, ref, rel, label):
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        check(got.shape == ref.shape and got.dtype == ref.dtype and math.isfinite(err)
              and err <= rel * scale, f"{label}: max-abs {err} > {rel} x {scale}")
        return err

    # (a) the entry points, once at each main shape
    gemm_ops = {label: gemm_operands(*shape)[0] for label, shape in
                (("head", HEAD), ("serving", SERVING))}
    conv_ops = {key: conv_operands(*key)[0] for key in ESRGAN_CONVS}
    _zero_counts()
    for forms in (pc.patch_forms, im.fused_forms, im.fused2_forms):
        forms.update({k: 0 for k in forms})
    gemm_forms, patch_forms = {"dequant_matmul_int8_fused": {},
                               "dequant_matmul_int8_fused2": {}}, {}
    for label, (x, w, s) in gemm_ops.items():
        for name, fn in fused.items():
            fn(x, w, s)
            gemm_forms[name][label] = _fused_form(im.fused_plan(
                x, w, fused2=name == "dequant_matmul_int8_fused2"))
    for (cin, cout, px), (x, w, b) in conv_ops.items():
        pc.pixel_conv_blockdot(x, w, b, alpha=0.2)
        xf = flat(x)
        p = pc.patch_plan(xf, w, px)
        patch_forms[str((cin, cout, px))] = f"{p.form}, {p.rows} rows"
        check(p.form == "wgmma", f"pixel_conv_patch {(cin, cout, px)} b{B}: plan {p}")
        pc.pixel_conv_patch(xf, w, b, width=px, alpha=0.2)
    torch.cuda.synchronize()
    entry = _counts()
    expect = {"dequant_matmul_int8_fused": 2, "dequant_matmul_int8_fused2": 2,
              "pixel_conv_blockdot": len(ESRGAN_CONVS), "pixel_conv_patch": len(ESRGAN_CONVS)}
    _check_routed("variant entry points", entry, set(expect))
    check(all(entry[k] == n for k, n in expect.items()), f"variant launches {entry}")
    # every ESRGAN shape's patch call launched the wgmma form; `_fused` the
    # panel form at the serving GEMM and the cluster form at the head,
    # `_fused2` the revisit form at the serving GEMM and the cluster form at
    # the head
    check(pc.patch_forms == {"wgmma": len(ESRGAN_CONVS), "mma": 0},
          f"pixel_conv_patch forms {pc.patch_forms}")
    check(im.fused_forms == {"panel": 1, "cluster": 1, "revisit": 0, "mma": 0},
          f"fused forms {im.fused_forms}")
    check(im.fused2_forms == {"revisit": 1, "cluster": 1, "mma": 0}
          and gemm_forms["dequant_matmul_int8_fused2"]["serving"].startswith("revisit")
          and gemm_forms["dequant_matmul_int8_fused2"]["head"].startswith("cluster"),
          f"fused2 forms {im.fused2_forms}, {gemm_forms['dequant_matmul_int8_fused2']}")
    REPORT["variant_entry_launches"] = {k: entry[k] for k in expect}
    REPORT["variant_forms"] = {"pixel_conv_patch": patch_forms, **gemm_forms}
    del gemm_ops, conv_ops

    rows = {}
    # (b) the fused GEMMs at the head and the serving shape
    for label, (M, K, N) in (("head", HEAD), ("serving", SERVING)):
        iters = 50 if label == "head" else 10
        nbytes = M * K * 2 + K * N + N * 4 + M * N * 2
        sets = gemm_operands(M, K, N, copies=_copies(nbytes))
        n = len(sets)
        x, w, s = sets[0]
        ref = im.dequant_matmul_int8_fused_plain(x, w, s)
        check(torch.equal(ref, im.dequant_matmul_int8(x, w, s)),
              f"fused plain {label}: differs from dequant_matmul_int8")
        two_pass_ms = graph_ms(torch, side, lambda i: im.dequant_matmul_int8(*sets[i % n]), iters)
        lib_ms = graph_ms(torch, side, lambda i: im.dequant_matmul_int8_reference(*sets[i % n]),
                          iters)
        plain_ms = graph_ms(torch, side, lambda i: im.dequant_matmul_int8_fused_plain(
            *sets[i % n]), 2, replays=2)
        # the row scales stay plain PyTorch: their pass, timed apart
        scales_ms = graph_ms(torch, side, lambda i: im.quantize_rows_scales(sets[i % n][0]),
                             iters)
        b_ms, b_by = bound(nbytes, 2 * M * N * K, "int8", power_w)
        for name, fn in fused.items():
            got = fn(x, w, s)
            torch.cuda.synchronize()
            check(got.dtype == bf16 and torch.equal(got, ref),
                  f"{name} {label}: outputs differ from the plain version and "
                  "dequant_matmul_int8")
            rows[(name, label)] = dict(
                name=name, shape=[M, K, N], dtype="bf16", max_abs_err=0.0,
                tolerance="bf16 outputs equal (plain version and dequant_matmul_int8)",
                ms=graph_ms(torch, side, lambda i, fn=fn: fn(*sets[i % n]), iters),
                call_ms=time_ms(torch, lambda i, fn=fn: fn(*sets[i % n]), iters),
                plain_ms=plain_ms, library_ms=lib_ms, two_pass_ms=two_pass_ms,
                scales_ms=scales_ms, form=gemm_forms[name][label],
                library="dequant_matmul_int8_reference (quantize_rows, torch._int_mm, "
                        "epilogue)", bound_ms=b_ms, bound_by=b_by, ops=2 * M * N * K,
                calls_per_forward=1)
        if label == "serving":
            # the mma.sync kernel `_fused2` ran before the revisit form, on a
            # forced plan: the row's "before"
            mp = wgmma_plan.mma_plan(M, N, K)

            def mma_call(i):
                x_, w_, s_ = sets[i % n]
                out = torch.empty(M, N, dtype=bf16, device="cuda")
                im._launch(x_, w_, im.quantize_rows_scales(x_), s_, out, mp, "mma")
                return out

            check(torch.equal(mma_call(0), ref), "fused2 serving, mma.sync kernel: outputs "
                  "differ from the plain version")
            rows[("dequant_matmul_int8_fused2", label)]["mma_ms"] = graph_ms(
                torch, side, mma_call, iters)
        del sets, ref
    checks = []
    for dtype in (torch.float32, bf16):  # small odd shape, f32 out
        x, w, s = gemm_operands(17, 200, 72, dtype)[0]
        ref = im.dequant_matmul_int8_fused_plain(x, w, s, out_dtype=torch.float32)
        for name, fn in fused.items():
            check(torch.equal(fn(x, w, s, out_dtype=torch.float32), ref),
                  f"{name} (17, 200, 72) {dtype}: outputs differ from the plain version")
            checks.append([name, [17, 200, 72], str(dtype), "equal"])

    # (c) blockdot and patch at ESRGAN x4's shapes, batch 8
    for (cin, cout, px), calls in ESRGAN_CONVS.items():
        nbytes = B * px * px * (cin + cout) * 2 + 9 * cin * cout * 2 + cout * 2
        flops = 2 * B * px * px * 9 * cin * cout
        b_ms, b_by = bound(nbytes, flops, "bf16", power_w)
        sets = conv_operands(cin, cout, px, copies=_copies(nbytes))
        n = len(sets)
        x1, w1, b1 = sets[0][0][:1].float(), sets[0][1].float(), sets[0][2].float()
        kw = dict(alpha=0.2)
        for name in ("pixel_conv_blockdot", "pixel_conv_patch"):
            tiles = {}
            if name == "pixel_conv_blockdot":
                ops_ = sets
                call = lambda i: pc.pixel_conv_blockdot(*ops_[i % n], **kw)  # noqa: E731
                plain = lambda i: pc.pixel_conv_blockdot_plain(*ops_[i % n], **kw)  # noqa: E731
                chosen = pc.plan(sets[0][0], sets[0][1], tall=True)
                check(chosen.form == "wgmma", f"{name} {(cin, cout, px)}: plan {chosen}")
                # both tile heights of the wgmma core, each on its own plan:
                # the 8-row tile (where it fits) and the 4-row one (rowdot's)
                sms = torch.cuda.get_device_properties(0).multi_processor_count
                tiles = {8: wgmma_plan.pixel_tall_plan(B, px, px, cin, cout, sms),
                         4: pc.plan(sets[0][0], sets[0][1])}
                check(tiles[8] is not None and tiles[4].rows == 4,
                      f"{name} {(cin, cout, px)}: tile plans {tiles}")
                f32_err = err_of(pc.pixel_conv_blockdot(x1, w1, b1, **kw),
                                 pc.pixel_conv_blockdot_plain(x1, w1, b1, **kw), 1e-5,
                                 f"{name} {(cin, cout, px)} f32 b1")
                xl = [s_[0].permute(0, 2, 1, 3).contiguous(memory_format=torch.channels_last)
                      for s_ in sets]
                wl = [s_[1].contiguous(memory_format=torch.channels_last) for s_ in sets]
                library = "F.conv2d channels-last bf16 with bias, then F.leaky_relu"
            else:
                ops_ = [(flat(x_), w_, b_) for x_, w_, b_ in sets]
                kwp = dict(kw, width=px)
                # the tile the plan chose is timed below; both heights are
                # timed by experiments/torch_patch_fused_timing.py
                chosen = pc.patch_plan(ops_[0][0], ops_[0][1], px)
                check(chosen.form == "wgmma", f"{name} {(cin, cout, px)}: plan {chosen}")
                call = lambda i: pc.pixel_conv_patch(*ops_[i % n], **kwp)  # noqa: E731
                plain = lambda i: pc.pixel_conv_patch_plain(*ops_[i % n], **kwp)  # noqa: E731
                f32_err = err_of(pc.pixel_conv_patch(flat(x1), w1, b1, **kwp),
                                 pc.pixel_conv_patch_plain(flat(x1), w1, b1, **kwp), 1e-5,
                                 f"{name} {(cin, cout, px)} f32 b1")
                xl = [o[0].reshape(B, cin, px, px) for o in ops_]
                wl = [s_[1].contiguous() for s_ in sets]
                library = "F.conv2d NCHW bf16 with bias, then F.leaky_relu"

            def lib(i, xl=xl, wl=wl):
                return F.leaky_relu(F.conv2d(xl[i % n], wl[i % n], sets[i % n][2], padding=1),
                                    0.2)

            r = {"name": name, "shape": [B, px, cin, px, cout], "calls_per_forward": calls,
                 "bytes": nbytes, "flops": flops, "library": library, "f32_b1_err": f32_err,
                 "max_abs_err": err_of(call(0), plain(0), 1e-2, f"{name} {(cin, cout, px)} bf16"),
                 "tolerance": "1e-2 x max|plain| (bf16)"}
            for height, p_ in tiles.items():
                def forced(i, p_=p_):
                    x_, w_, b_ = ops_[i % n]
                    out = torch.empty(B, px, cout, px, dtype=bf16, device="cuda")
                    pc._launch(x_, pc._packed_weight(w_), b_, None, out, 0.2, 1.0, False, p=p_)
                    return out
                err_of(forced(0), plain(0), 1e-2, f"{name} {(cin, cout, px)} {height}-row tile")
                r[f"rows{height}_ms"] = graph_ms(torch, side, forced, 10)
                r[f"rows{height}_plan"] = (f"{p_.stages} stages, "
                                           f"{'resident' if p_.resident else 'streamed'} weight")
            r["form"] = (f"{chosen.form} form, {chosen.rows}-row tiles x {chosen.px} px, "
                         f"{chosen.stages} stages, "
                         f"{'resident' if chosen.resident else 'streamed'} weight, grid "
                         f"{chosen.grid} of {chosen.tiles} tiles")
            if tiles:
                r["form"] += (f"; 8-row {r['rows8_ms']:.4f} ms ({r['rows8_plan']}), 4-row "
                              f"{r['rows4_ms']:.4f} ms ({r['rows4_plan']})")
            r["ms"] = graph_ms(torch, side, call, 10)
            r["call_ms"] = time_ms(torch, call, 10)
            r["plain_ms"] = graph_ms(torch, side, plain, 3)
            r["library_ms"] = graph_ms(torch, side, lib, 10)
            r["bound_ms"], r["bound_by"] = b_ms, b_by
            rows[(name, cin, cout, px)] = r
            del ops_, xl, wl
        del sets
    for alpha in (None, 0.2):  # small odd shape: H 7, W 100, C_in 24, C_out 40
        for dtype, rel in ((torch.float32, 1e-5), (bf16, 1e-2)):
            x, w, b = conv_operands(24, 40, 7, batch=2, dtype=dtype, width=100)[0]
            e1 = err_of(pc.pixel_conv_blockdot(x, w, b, alpha=alpha),
                        pc.pixel_conv_blockdot_plain(x, w, b, alpha=alpha), rel,
                        f"pixel_conv_blockdot (2, 7, 24, 100, 40) {dtype} alpha {alpha}")
            e2 = err_of(pc.pixel_conv_patch(flat(x), w, b, width=100, alpha=alpha),
                        pc.pixel_conv_patch_plain(flat(x), w, b, width=100, alpha=alpha), rel,
                        f"pixel_conv_patch (2, 24, 700) {dtype} alpha {alpha}")
            checks.append(["blockdot, patch", [2, 7, 24, 100, 40], str(dtype), alpha, e1, e2])
    REPORT["variant_checks"] = checks

    # (d) one patch call is one kernel: no layout copy on the way in or out
    x, w, b = conv_operands(64, 32, 128)[0]
    xf = flat(x)
    kernels, _, n_kernels = _profile(torch, lambda: pc.pixel_conv_patch(xf, w, b, width=128,
                                                                       alpha=0.2), steps=1)
    check(n_kernels == 1 and all("pixel_conv_wgmma" in k for k in kernels),
          f"pixel_conv_patch ran {n_kernels} kernels: {sorted(kernels)}")
    REPORT["patch_kernels_a_call"] = {"kernels": n_kernels, "names": sorted(kernels)}

    for r in rows.values():
        extra = (f", dequant_matmul_int8 {r['two_pass_ms']:.4f} ms, row scales' plain pass "
                 f"{r['scales_ms']:.4f} ms, {r['ops'] / r['ms'] / 1e9:.1f} TOP/s"
                 if "two_pass_ms" in r
                 else f"; f32 b1 err {r['f32_b1_err']:.3g} (1e-5 x max)")
        extra += (f", the mma.sync kernel it ran on before {r['mma_ms']:.4f} ms"
                  if "mma_ms" in r else "")
        extra += f" | {r['form']}" if "form" in r else ""
        say(2, f"{r['name']} {r['shape']}: err {r['max_abs_err']:.3g} ({r['tolerance']}) | "
               f"kernel {r['ms']:.4f} ms (host cost of a call {r['call_ms']:.4f} ms), plain "
               f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms ({r['library']})"
               f"{extra}, bound {r['bound_ms']:.4f} ms ({r['bound_by']}) = "
               f"{100 * r['bound_ms'] / r['ms']:.1f}% of bound | {r['calls_per_forward']} "
               "a forward")
    for name in ("pixel_conv_blockdot", "pixel_conv_patch"):
        fw = per_forward(rows, name)
        heights = ""
        if name == "pixel_conv_blockdot":
            for height in (8, 4):
                fw[f"rows{height}_ms"] = sum(r[f"rows{height}_ms"] * r["calls_per_forward"]
                                             for r in rows.values() if r["name"] == name)
            heights = (f" (8-row tile everywhere {fw['rows8_ms']:.3f} ms, 4-row tile "
                       f"{fw['rows4_ms']:.3f} ms)")
        REPORT["blockdot_forward" if name == "pixel_conv_blockdot" else "patch_forward"] = fw
        say(2, f"{name} over an ESRGAN x4 b8 forward's 349 calls: kernel {fw['ms']:.3f} ms"
               f"{heights}, plain {fw['plain_ms']:.3f} ms, library {fw['library_ms']:.3f} ms, "
               f"bound {fw['bound_ms']:.3f} ms")
    say(2, f"entry-point launches {REPORT['variant_entry_launches']}; one pixel_conv_patch "
           f"call: {n_kernels} kernel; small checks: {checks}")
    torch.backends.cudnn.allow_tf32 = True
    REPORT["variant_kernels"] = [dict(r, case=str(k)) for k, r in rows.items()]
    return rows


def per_forward(rows: dict, name: str) -> dict:
    """A kernel's numbers over one forward's calls (calls x per call)."""
    rs = [r for r in rows.values() if r.get("name") == name]
    out = {k: sum(r[k] * r["calls_per_forward"] for r in rs)
           for k in ("ms", "plain_ms", "bound_ms")}
    lib = [r["library_ms"] for r in rs]
    out["library_ms"] = (None if any(v is None for v in lib)
                         else sum(v * r["calls_per_forward"] for v, r in zip(lib, rs)))
    out["max_abs_err"] = max(r["max_abs_err"] for r in rs)
    out["bound_by"] = ("bytes" if sum(r["bound_ms"] * r["calls_per_forward"] for r in rs
                                      if r["bound_by"] == "bytes") >= out["bound_ms"] / 2
                       else "operations")
    return out


def per_step(rows: dict, name: str) -> dict:
    """A decode kernel's numbers over one step's calls (calls x per call)."""
    named = [r for r in rows.values() if r.get("name") == name]
    rs = [r for r in named if "ms" in r]
    out = {k: sum(r[k] * r["calls_per_step"] for r in rs)
           for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    out["max_abs_err"] = max(r["max_abs_err"] for r in named)
    out["bound_by"] = "bytes" if all(r["bound_by"] == "bytes" for r in rs) else "operations"
    return out


# -- phase 3 ---------------------------------------------------------------

def _top1(a, b) -> float:
    return float((a.argmax(1) == b.argmax(1)).mean())


def _profile(torch, run, steps: int = 3, counts: dict | None = None):
    """Device ms a step by kernel and by the host op that launched it, and
    device kernels a step, over `steps` calls of run() (torch.profiler);
    `counts`, where given, receives each device kernel's launches a step."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
    kernels, ops, n_kernels = {}, {}, 0
    for e in prof.key_averages():
        on_card = str(getattr(e, "device_type", "")).endswith("CUDA")
        n_kernels += e.count if on_card else 0
        if on_card and counts is not None:
            counts[e.key] = counts.get(e.key, 0) + e.count / steps
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        if not t or t <= 0:
            continue
        # A kernel's time shows on its own entry and again on the host op
        # that launched it: keep the two apart.
        side = kernels if on_card else ops
        side[e.key] = side.get(e.key, 0.0) + t / (1e3 * steps)  # us in all -> ms a step
    return kernels, ops, n_kernels / steps


VIT_LAUNCHES = ["layer norm", "QKV GEMM", "attention", "projection"]
# the split's shapes: (B, N, D, heads, eps), ViT-B/16 b128 and SD-UNet's two
VIT_SPLIT_SHAPES = {
    "ViT-B/16 b128": (VIT_BATCH, (VIT_B16["image_size"] // VIT_B16["patch"]) ** 2 + 1,
                      VIT_B16["dim"], VIT_B16["heads"], 1e-6),
    "SD-UNet hd 16 N 1024 b8": (SD_UNET_BATCH, 1024, 128, 8, 1e-5),
    "SD-UNet hd 32 N 256 b8": (SD_UNET_BATCH, 256, 256, 8, 1e-5)}


def vit_split_all(torch, np, calls: int = 6) -> dict:
    """vit_attention_block's launches (pre-LN on, bf16) at VIT_SPLIT_SHAPES
    on two routes: "legacy" (every launch on the earlier mma.sync kernels)
    and "plan" (the wrapper's forms). One torch.profiler session holds
    `calls` calls of each (shape, route); its device kernels in start order
    are cut into calls at each LayerNorm kernel and keyed by their
    attention kernel's name (which names the route and the head dim), so a
    call the trace holds only in part (the profiler may miss a kernel) is
    left out; at least half the calls must be whole. Then each (shape,
    route) is timed by graph replay. Calls the launch sequence directly:
    the launch counter does not move."""
    from torch.profiler import ProfilerActivity, profile

    from smelter_tpu_torch.kernels import vit_block as vb

    gen = torch.Generator(device="cuda").manual_seed(4)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    runs = []  # (label, route, forms, call)
    for label, (B, N, D, H, eps) in VIT_SPLIT_SHAPES.items():
        args, _ = _vit_case(torch, np, gen, B, N, D, H, torch.bfloat16, torch.bfloat16)
        for route in ("legacy", "plan"):
            forms = (vb.plans(B, N, D, H, torch.bfloat16, sms=sms) if route == "plan"
                     else vb.legacy_plans())

            def call(i=0, args=args, forms=forms, H=H, eps=eps):
                return vb._launch(*args, None, forms, heads=H, scale=None, eps=eps,
                                  residual=False, pre_ln=True, mask_filter=-10000.0)

            call()
            runs.append((label, route, forms, call))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for *_, call in runs:
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
    spans = sorted((float(e.time_range.start), float(e.time_range.end), e.name)
                   for e in prof.events()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")
                   and not e.name.startswith(("Memcpy", "Memset")))
    starts = [i for i, sp in enumerate(spans) if "layer_norm" in sp[2]]
    by_attention: dict = {}
    for i, j in zip(starts, starts[1:] + [len(spans)]):
        if j - i == len(VIT_LAUNCHES):
            by_attention.setdefault(spans[i + 2][2], []).append(spans[i:j])
    check(len(by_attention) == len(runs), f"launch split: {len(by_attention)} kinds of call "
                                          f"for {len(runs)} runs")
    out: dict = {}
    for (label, route, forms, call), group in zip(runs, by_attention.values()):
        check(2 * len(group) >= calls, f"launch split {label} {route}: {len(group)} whole calls "
                                       f"of {calls} in the trace")
        split = {lab: {"ms": sum(c[k][1] - c[k][0] for c in group) / (1e3 * len(group)),
                       "kernel": group[0][k][2]} for k, lab in enumerate(VIT_LAUNCHES)}
        out.setdefault(label, []).append({
            "route": route, "forms": [f.form for f in forms], "whole_calls": len(group),
            "ms": graph_ms(torch, torch.cuda.Stream(), call, 10), "split": split})
    return out


def phase_vit_split() -> dict:
    """vit_split_all in a process of its own (`chip_smoke.py --vit-split`),
    so that its profiler session leaves this process's untouched; prints
    phase 2's lines of the per-launch split, before (legacy) and after."""
    splits = _split_in_child("--vit-split")
    for label, runs in splits.items():
        say(2, f"vit_attention_block {label} by launch (torch.profiler; before/after this "
               f"slice's cores): " + "; ".join(
                   f"{r['route']} ({' / '.join(r['forms'])}) {r['ms']:.4f} ms: "
                   + ", ".join(f"{k} {v['ms']:.4f}" for k, v in r["split"].items())
                   for r in runs))
    REPORT["vit_split"] = splits
    return splits


CONVNEXT_LAUNCHES = ["dw_ln", "FC1", "FC2"]
CONVNEXT_STAGES = ((56, 96), (28, 192), (14, 384))  # ConvNeXt-T's fused stages (side, C)


def convnext_split_all(torch, calls: int = 6) -> dict:
    """convnext_block's launches (bf16, batch CONVNEXT_BATCH) at the three
    fused stages on the wrapper's forms. One torch.profiler session holds
    `calls` calls of each stage, stages apart by a marker kernel; each
    stage's device kernels in start order are cut into calls at each
    depthwise kernel, and a call the trace holds only in part (the profiler
    may miss a kernel) is left out; at least half the calls must be whole.
    Then each stage is timed by graph replay. Calls the launch sequence
    directly: the launch counter does not move."""
    from torch.profiler import ProfilerActivity, profile

    from smelter_tpu_torch.kernels import convnext_block as cb

    gen = torch.Generator(device="cuda").manual_seed(5)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bf16, f32 = torch.bfloat16, torch.float32

    def rnd(*shape, s=1.0, dtype=bf16):
        return (torch.randn(*shape, device="cuda", generator=gen) * s).to(dtype)

    runs = []  # (label, forms, call, M, C)
    B = CONVNEXT_BATCH
    for k, (hw, C) in enumerate(CONVNEXT_STAGES):
        Fh, M = 4 * C, B * hw * hw
        args = (rnd(B, hw, hw, C), rnd(7, 7, 1, C, s=1 / 7), rnd(C, s=0.1, dtype=f32),
                1 + rnd(C, s=0.1, dtype=f32), rnd(C, s=0.1, dtype=f32),
                rnd(C, Fh, s=C ** -0.5), rnd(Fh, s=0.1, dtype=f32), rnd(Fh, C, s=Fh ** -0.5),
                rnd(C, s=0.1, dtype=f32), 0.5 + rnd(C, s=0.1, dtype=f32))
        forms = cb.plans(M, C, Fh, bf16, sms=sms)

        def call(i=0, args=args, forms=forms):
            return cb._launch(*args, forms, eps=1e-6)

        call()
        runs.append((f"stage {k + 1} {hw}x{hw}x{C} b{B}", forms, call, M, C))
    marker = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for *_, call, _, _ in runs:
            for _ in range(calls):
                call()
            marker.add_(1)
        torch.cuda.synchronize()
    spans = sorted((float(e.time_range.start), float(e.time_range.end), e.name)
                   for e in prof.events()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")
                   and not e.name.startswith(("Memcpy", "Memset")))
    segments, cur = [], []
    for sp in spans:
        if "dw_ln" in sp[2] or "gemm" in sp[2]:
            cur.append(sp)
        else:
            segments.append(cur)
            cur = []
    check(len(segments) == len(runs), f"convnext split: {len(segments)} stages in the trace")
    out: dict = {}
    for (label, forms, call, M, C), seg in zip(runs, segments):
        starts = [i for i, sp in enumerate(seg) if "dw_ln" in sp[2]]
        group = [seg[i:j] for i, j in zip(starts, starts[1:] + [len(seg)])
                 if j - i == len(CONVNEXT_LAUNCHES)]
        check(2 * len(group) >= calls, f"convnext split {label}: {len(group)} whole calls of "
                                       f"{calls} in the trace")
        split = {lab: {"ms": sum(c[k][1] - c[k][0] for c in group) / (1e3 * len(group)),
                       "kernel": group[0][k][2]} for k, lab in enumerate(CONVNEXT_LAUNCHES)}
        for lab in ("FC1", "FC2"):  # 8 M C^2 flops each
            split[lab]["tflops"] = 8 * M * C * C / (split[lab]["ms"] * 1e9)
        out[label] = {"forms": [f.form for f in forms], "whole_calls": len(group),
                      "ms": graph_ms(torch, torch.cuda.Stream(), call, 5), "split": split}
    return out


def _split_child(which: str) -> int:
    """`chip_smoke.py --vit-split` / `--convnext-split`: the split's result
    as one JSON line."""
    import numpy as np
    import torch

    check(torch.cuda.is_available(), "no CUDA card")
    sys.path.insert(0, str(ROOT))
    print(json.dumps(vit_split_all(torch, np) if which == "--vit-split"
                     else convnext_split_all(torch)))
    return 0


def _split_in_child(which: str) -> dict:
    """The split in a process of its own, so that its profiler session
    leaves this process's untouched."""
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), which],
                          capture_output=True, text=True, timeout=600, cwd=str(ROOT))
    check(proc.returncode == 0, f"the launch split's process failed: {proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def phase_convnext_split() -> dict:
    """convnext_split_all in a child process; prints phase 2's lines of the
    per-launch split."""
    splits = _split_in_child("--convnext-split")
    total = 0.0
    for k, (label, r) in enumerate(splits.items()):
        calls = CONVNEXT["depths"][k]
        total += calls * sum(v["ms"] for v in r["split"].values())
        say(2, f"convnext_block {label} by launch (torch.profiler, {r['whole_calls']} whole "
               f"calls; FC1/FC2 {' / '.join(r['forms'])}): {r['ms']:.4f} ms a call (graph "
               f"replay) = " + ", ".join(
                   f"{lab} {v['ms']:.4f}" + (f" ({v['tflops']:.0f} TF/s)" if "tflops" in v
                                             else "")
                   for lab, v in r["split"].items()) + f" | {calls} calls a forward")
    say(2, f"convnext_block: a ConvNeXt-T b{CONVNEXT_BATCH} forward's {CONVNEXT_FUSED} calls "
           f"by launch sum to {total:.4f} ms")
    REPORT["convnext_split"] = splits
    return splits


def _counters() -> dict:
    """name -> (kernel module, the name of its launch counter)."""
    import importlib

    return {k: (importlib.import_module(f"smelter_tpu_torch.kernels.{m}"), a)
            for k, (m, a) in KERNELS.items()}


def _counts() -> dict:
    return {k: getattr(m, a) for k, (m, a) in _counters().items()}


def _zero_counts() -> None:
    for m, a in _counters().values():
        setattr(m, a, 0)


def _check_routed(label: str, counts: dict, routed) -> None:
    """The path launched the kernels it routes to, and no other."""
    routed = {routed} if isinstance(routed, str) else set(routed)
    check(all(counts[k] > 0 for k in routed), f"{label}: {routed} not all launched ({counts})")
    check(all(n == 0 for k, n in counts.items() if k not in routed),
          f"{label}: a kernel other than {routed} launched ({counts})")


def phase_main(torch, np, stt) -> dict:
    from smelter_tpu_torch.models import resnet50

    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    onnx_path = out_dir / "resnet50_b128.onnx"
    t0 = time.perf_counter()
    g, _module, shape = resnet50.build(batch=128, image_size=224)
    stt.save_model(g, onnx_path)  # the port's wire writer
    export_s = time.perf_counter() - t0
    check(stt.load_model(onnx_path).initializers.keys() == g.initializers.keys(),
          "ONNX bytes do not load back")
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    say(3, f"ResNet-50 {shape} exported and loaded back in {export_s:.1f} s "
           f"({onnx_path.stat().st_size / 1e6:.1f} MB)")
    res: dict = {"export_s": export_s}

    # f32 at batch 8 against the port's CPU run, TF32 off everywhere
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu32 = stt.compile(onnx_path, stt.Config(), quant="int8", device="cpu")
    gpu32 = stt.compile(onnx_path, stt.Config(), quant="int8", device="cuda")
    ref8, got8 = cpu32(x[:8])[0], gpu32(x[:8])[0]
    err = float(np.abs(got8 - ref8).max())
    scale = float(np.abs(ref8).max())
    check(got8.shape == (8, 1000) and np.isfinite(got8).all(), "f32 logits")
    # cuDNN and the CPU sum in other orders through 53 convolutions: 1e-3.
    check(err <= 1e-3 * scale, f"f32 logits: max-abs {err} > 1e-3 x {scale}")
    say(3, f"f32 batch 8 vs CPU: max-abs {err:.3g} (bound 1e-3 x {scale:.3g})")
    res["f32_b8"] = {"max_abs_err": err, "max_abs_ref": scale}
    t0 = time.perf_counter()
    ref = cpu32(x)[0]
    say(3, f"CPU f32 reference at batch 128 in {time.perf_counter() - t0:.1f} s")
    torch.backends.cudnn.allow_tf32 = True
    del gpu32

    xg = torch.from_numpy(x).cuda()
    # use_pallas routes the int8 head to the kernels, as the JAX package's
    # FusedDequantMatMul lowering does; the default routes to the composites
    for label, cfg, routed in (
            ("bf16", stt.Config(compute_dtype="bfloat16", use_pallas=True), "dequant_matmul"),
            ("bf16_int8act", stt.Config(compute_dtype="bfloat16", int8_activations=True,
                                        use_pallas=True), "int8_matmul"),
            ("bf16_default", stt.Config(compute_dtype="bfloat16"), set())):
        _zero_counts()
        model = stt.compile(onnx_path, cfg, quant="int8", device="cuda")
        got = model(x)[0]
        launches = _counts()
        _check_routed(label, launches, routed)
        check(got.shape == (128, 1000) and np.isfinite(got).all(), f"{label} logits")
        agree = _top1(got, ref)
        top2 = np.sort(ref, axis=1)[:, -2:]
        gap = float(np.median(top2[:, 1] - top2[:, 0]))
        err = float(np.abs(got - ref).max())
        check(agree >= 0.99, f"{label}: top-1 agreement {agree} < 0.99")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_ms = time_ms(torch, lambda i: model.run_device(xg), 20)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        per, by_op, _ = _profile(torch, lambda: model.run_device(xg))
        busy = sum(per.values())
        ours = {k: v for k, v in per.items() if "dequant_matmul" in k or "int8_matmul" in k}
        top = sorted(per.items(), key=lambda kv: -kv[1])[:8]
        top_ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:8]
        r = {"launches": launches, "top1_vs_cpu_f32": agree, "max_abs_vs_cpu_f32": err,
             "median_top2_gap": gap, "step_ms": step_ms, "images_per_s": 128e3 / step_ms, "peak_mem_gb": peak_gb,
             "device_busy_ms": busy, "idle_share": max(0.0, 1 - busy / step_ms),
             "port_kernel_ms": ours, "port_kernel_share": sum(ours.values()) / step_ms,
             "top_kernels_ms": top, "top_host_ops_ms": top_ops}
        res[label] = r
        say(3, f"{label} batch 128: launches in compile + one forward {launches} | "
               f"top-1 vs CPU f32 {agree:.4f} (median top-2 gap {gap:.3g}, "
               f"max-abs {err:.3g}) | {r['images_per_s']:.1f} images/s, step {step_ms:.3f} ms, "
               f"peak {peak_gb:.2f} GB | port kernels {sum(ours.values()):.4f} ms = "
               f"{100 * r['port_kernel_share']:.3f}% of the step | profiled busy {busy:.3f} ms")
        say(3, "  device ms a step by host op: "
               + "; ".join(f"{k} {v:.3f}" for k, v in top_ops))
        del model
    return res, ref


# -- phase 4 ---------------------------------------------------------------

def phase_serve(torch, np, stt) -> dict:
    onnx_path = ROOT / "build" / "chip_smoke" / "resnet50_b128.onnx"
    cfg = stt.Config(compute_dtype="bfloat16", use_pallas=True)
    xs = np.random.default_rng(1).standard_normal((32, 3, 224, 224)).astype(np.float32)
    direct = stt.compile(onnx_path, cfg, quant="int8", device="cuda")(xs)[0]
    _zero_counts()
    server = stt.serve(onnx_path, cfg, quant="int8", device="cuda", max_batch=16)
    results = [None] * len(xs)
    try:
        check(server.wait_ready(600), "server buckets did not warm up")
        def ask(i):
            results[i] = server.infer(xs[i])[0]

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(len(xs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        stats = server.stats()
    finally:
        server.shutdown()
    launches = _counts()
    _check_routed("server", launches, "dequant_matmul")
    check(all(r is not None for r in results), "server left requests unanswered")
    got = np.stack(results)
    err = float(np.abs(got - direct).max())
    scale = float(np.abs(direct).max())
    agree = _top1(got, direct)
    check(stats["requests"] == 32 and stats["errors"] == 0, f"server stats {stats}")
    # bf16 outputs of other batch sizes (other cuDNN algorithms): 5e-2.
    check(err <= 5e-2 * scale, f"served vs direct: max-abs {err} > 5e-2 x {scale}")
    say(4, f"served {stats['requests']} requests in {stats['batches']} batches, "
           f"launches {launches} (bucket warm-ups included) | "
           f"p50 {stats['latency_ms_p50']:.1f} ms, p95 {stats['latency_ms_p95']:.1f} ms | "
           f"vs direct: top-1 {agree:.4f}, max-abs {err:.3g} (bound 5e-2 x {scale:.3g})")
    return {"launches": launches, "stats": stats, "top1_vs_direct": agree,
            "max_abs_vs_direct": err}


# -- phase 12 --------------------------------------------------------------

_PORT_QCONV_KERNEL = re.compile(r"qlinear_conv_mma|qconv_wgmma|int8_join_kernel")


def phase_int8_static(torch, np, stt, ref_f32) -> dict:
    """ResNet-50 int8-static on phase 3's 224 px ONNX bytes: compile(...,
    quant="int8-static") calibrated on the card with two batches of 8, then
    (a) batch 8 in f32 on the CPU and on the card, the same quantized graph:
    every int8 edge up to the global pool equal, the head's within one step
    in at most 1 % of its elements (the pool's mean sums in another order),
    the logits within 1e-3 of the largest, for the card's node-by-node walk
    and for its fused walk (`runtime/chains.py`: 33 conv + Relu, 16 joins),
    whose chain ends are among the edges checked; the CPU's bf16 run gives
    the bf16 bound (3x its error, as phase 8); (b) batch 128 in bf16 against
    the CPU's f32-compute run of the graph: top-1 agreement at least 0.99 on
    the rows whose top-2 gap exceeds twice the max-abs error; 53
    qlinear_conv launches a forward, all on the wgmma forms, 16 int8_join,
    no other port kernel and no Relu kernel; images/s, idle share, peak
    memory, profile, layout copies a forward; top-1 against phase 3's float
    reference (information only); (c) serve(..., max_batch=16) answering
    32 threaded requests within the bf16 bound of the direct forward."""
    import copy

    from smelter_tpu_torch.ir.graph import Node
    from smelter_tpu_torch.kernels import qlinear_conv as qc
    from smelter_tpu_torch.runtime import chains
    from smelter_tpu_torch.runtime.executor import CompiledModel, Executor

    onnx_path = ROOT / "build" / "chip_smoke" / "resnet50_b128.onnx"
    shape = (RESNET_BATCH, 3, RESNET_IMAGE, RESNET_IMAGE)
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    calib = [(np.random.default_rng(s).standard_normal((8,) + shape[1:]).astype(np.float32),)
             for s in (10, 11)]
    res: dict = {}
    cfg16 = stt.Config(compute_dtype="bfloat16")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = stt.compile(onnx_path, cfg16, quant="int8-static", calibration_data=calib,
                        device="cuda")
    res["compile_s"] = time.perf_counter() - t0
    gq = model.graph
    ops: dict = {}
    for node in gq.nodes:
        ops[node.op_type] = ops.get(node.op_type, 0) + 1
    res["ops"] = ops
    convs = {}
    for node in gq.nodes:
        if node.op_type == "QLinearConv":
            co, ci, k, _ = gq.initializers[node.inputs[3]].shape
            key = (ci, co, k, int(node.attr("strides")[0]))
            convs[key] = convs.get(key, 0) + 1
    want = {}
    for (ci, co, k, s, _), n in resnet50_convs().items():
        want[(ci, co, k, s)] = want.get((ci, co, k, s), 0) + n
    check(convs == want and ops.get("QLinearMatMul") == 1,
          f"int8-static graph: QLinearConvs {convs} are not ResNet-50's {want} ({ops})")
    groups = chains.groups(gq)
    n_join = sum(isinstance(grp, chains.Join) for grp in groups)
    alone = [st.op_type for st in chains.plan(gq) if isinstance(st, Node)]
    check(n_join == 16 and len(groups) == 49 and "Relu" not in alone,
          f"int8-static walk: {len(groups)} groups, {n_join} joins; a Relu walks alone")
    res["groups"] = {"conv_relu": len(groups) - n_join, "join": n_join}
    say(12, f"ResNet-50 int8-static compiled in {res['compile_s']:.1f} s (calibrated on the card "
            f"with 2 batches of 8): {ops}")

    # (a) batch 8, f32 compute, the CPU against the card
    x8 = x[:8]
    t0 = time.perf_counter()
    cpu = CompiledModel(copy.deepcopy(gq), stt.Config(device="cpu"))
    ref8 = cpu(x8)[0]
    ref8_16 = CompiledModel(copy.deepcopy(gq), stt.Config(compute_dtype="bfloat16",
                                                          device="cpu"))(x8)[0]
    edges_cpu = _int8_edges(torch, np, stt, copy.deepcopy(gq), x8, "cpu")
    cpu_s = time.perf_counter() - t0
    _zero_counts()
    got8 = CompiledModel(copy.deepcopy(gq), stt.Config(device="cuda"))(x8)[0]
    launches = _counts()
    _check_routed("int8-static b8 f32", launches, {"qlinear_conv", "int8_join"})
    check(launches["qlinear_conv"] == 53 and launches["int8_join"] == 16,
          f"int8-static b8: {launches}")
    ex = Executor(copy.deepcopy(gq), stt.Config(device="cuda"))
    prm = ex.cast_params(ex.init_params())
    env = ex.build_fn(return_all_edges=True)(prm, x8)
    # the Transposes around the pool stay views: no layout copy there
    check(all(env[nd.outputs[0]].data_ptr() == env[nd.inputs[0]].data_ptr()
              for nd in gq.nodes if nd.op_type == "Transpose"), "a Transpose copied its input")
    edges_gpu = {k: v.cpu().numpy() for k, v in env.items() if isinstance(v, torch.Tensor)
                 and v.dtype == torch.int8 and k not in gq.initializers}
    env = ex.build_fn(return_all_edges=True, fuse=True)(prm, x8)
    fused_gpu = {k: v.cpu().numpy() for k, v in env.items() if isinstance(v, torch.Tensor)
                 and v.dtype == torch.int8 and k not in gq.initializers}
    del ex, env, prm
    check(set(edges_cpu) == set(edges_gpu) and len(edges_cpu) >= 100,
          f"int8 edges differ in name ({len(edges_cpu)}, {len(edges_gpu)})")
    ends = {grp.last.outputs[0] for grp in groups
            if not (isinstance(grp, chains.Join) and grp.quant is None)}
    check(len(ends) == 48 and ends <= set(fused_gpu) <= set(edges_cpu),
          f"fused walk: {len(ends)} int8 chain ends, {len(fused_gpu)} int8 edges")
    pool = next(i for i, nd in enumerate(gq.nodes) if nd.op_type == "GlobalAveragePool")
    before_pool = {o for nd in gq.nodes[:pool] for o in nd.outputs}
    pre = [k for k in edges_cpu if k in before_pool]
    post = [k for k in edges_cpu if k not in before_pool]
    pre_flips = sum(int((edges_cpu[k] != edges_gpu[k]).sum()) for k in pre)
    fused_flips = sum(int((edges_cpu[k] != fused_gpu[k]).sum()) for k in pre if k in fused_gpu)
    pre_el = sum(edges_cpu[k].size for k in pre)
    post_el = sum(edges_cpu[k].size for k in post)
    post_flips = sum(int((edges_cpu[k] != edges_gpu[k]).sum()) for k in post)
    post_step = max([int(np.abs(edges_cpu[k].astype(np.int32) - edges_gpu[k]).max())
                     for k in post] or [0])
    check(pre_flips == 0, f"int8-static b8: {pre_flips} of {pre_el} int8 elements before the "
                          "pool differ between the CPU and the card")
    check(fused_flips == 0, f"int8-static b8: {fused_flips} int8 elements of the card's fused "
                            "walk before the pool differ from the CPU's")
    check(post_step <= 1 and post_flips <= 0.01 * post_el,
          f"int8-static b8: {post_flips} of {post_el} head int8 elements differ, by up to "
          f"{post_step}")
    scale8 = float(np.abs(ref8).max())
    err8 = float(np.abs(got8 - ref8).max())
    err_cpu16 = float(np.abs(ref8_16 - ref8).max())
    check(got8.shape == (8, 1000) and np.isfinite(got8).all(), "int8-static b8 logits")
    check(err8 <= 1e-3 * scale8, f"int8-static b8 f32: max-abs {err8} > 1e-3 x {scale8}")
    res["gate_a"] = {"int8_edges": len(edges_cpu), "elements_before_pool": pre_el,
                     "flips_before_pool": pre_flips, "fused_walk_int8_edges": len(fused_gpu),
                     "fused_walk_flips_before_pool": fused_flips, "head_elements": post_el,
                     "head_flips": post_flips, "max_abs_err": err8, "max_abs_ref": scale8,
                     "cpu_bf16_max_abs_err": err_cpu16, "cpu_s": cpu_s}
    say(12, f"(a) batch 8 f32, CPU vs card: {len(edges_cpu)} int8 edges, {pre_flips} of "
            f"{pre_el} elements before the pool differ (bound 0; the fused walk's "
            f"{len(fused_gpu)} int8 edges: {fused_flips}), {post_flips} of {post_el} "
            f"after it (bound 1 step, 1 %); logits max-abs {err8:.3g} (bound "
            f"{1e-3 * scale8:.3g}); CPU bf16 vs f32 {err_cpu16:.3g} | CPU runs {cpu_s:.1f} s")
    del cpu, edges_cpu, edges_gpu, fused_gpu
    bound16_rel = 3 * err_cpu16 / scale8

    # (b) batch 128, bf16 compute, against the CPU's f32-compute run
    t0 = time.perf_counter()
    refq = CompiledModel(copy.deepcopy(gq), stt.Config(device="cpu"))(x)[0]
    res["cpu_b128_s"] = time.perf_counter() - t0
    xg = torch.from_numpy(x).cuda()
    copies, forms = qc.layout_copies, dict(qc.forms)
    model.run_device(xg)
    torch.cuda.synchronize()
    res["layout_copies_a_forward"] = qc.layout_copies - copies
    res["forms_a_forward"] = {k: v - forms[k] for k, v in qc.forms.items()}
    check(res["forms_a_forward"] == {"mma": 0, "gemm": 33, "im2col": 20},
          f"int8-static b128: qlinear_conv forms {res['forms_a_forward']}")
    r = _image_forward(torch, np, model, xg, "int8-static b128", RESNET_BATCH,
                       {"qlinear_conv": 53, "int8_join": 16}, 20, port_re=_PORT_QCONV_KERNEL)
    relu_ms = {k: v for k, v in r["host_ops_ms"].items() if "relu" in k.lower()}
    check(not relu_ms, f"int8-static b128: Relu kernels ran ({relu_ms})")
    got = r.pop("out")
    check(got.shape == (RESNET_BATCH, 1000) and np.isfinite(got).all(), "int8-static logits")
    err = float(np.abs(got - refq).max())
    top2 = np.sort(refq, axis=1)[:, -2:]
    gaps = top2[:, 1] - top2[:, 0]
    clear = gaps > 2 * err
    agree = _top1(got, refq)
    agree_clear = float((got.argmax(1) == refq.argmax(1))[clear].mean()) if clear.any() else 0.0
    check(clear.sum() >= RESNET_BATCH // 4 and agree_clear >= 0.99,
          f"int8-static b128 bf16: top-1 {agree_clear} on {int(clear.sum())} clear rows")
    r.update({"max_abs_vs_cpu_f32": err, "top1_vs_cpu_f32": agree,
              "top1_vs_cpu_f32_clear_rows": agree_clear, "clear_rows": int(clear.sum()),
              "top1_vs_phase3_float": _top1(got, ref_f32),
              "max_abs_vs_phase3_float": float(np.abs(got - ref_f32).max()),
              "cpu_b128_s": res["cpu_b128_s"],
              "layout_copies_a_forward": res["layout_copies_a_forward"],
              "qlinear_conv_forms_a_forward": res["forms_a_forward"]})
    res["b128"] = r
    _say_run(f"(b) ResNet-50 int8-static b{RESNET_BATCH} bf16", r,
             f" | vs the CPU's f32-compute run: top-1 {agree:.4f} ({agree_clear:.4f} on "
             f"{int(clear.sum())} rows with a top-2 gap over 2 x {err:.3g}) | vs phase 3's "
             f"float reference (not gated): top-1 {r['top1_vs_phase3_float']:.4f} | layout "
             f"copies a forward {res['layout_copies_a_forward']} | qlinear_conv forms "
             f"{res['forms_a_forward']}", phase=12)

    # (c) the server on the quantized graph
    xs = x[:32]
    direct = got[:32]
    bound_abs = bound16_rel * float(np.abs(direct).max())
    _zero_counts()
    server = stt.serve(gq, cfg16, quant="int8-static", optimize=False, device="cuda",
                       max_batch=16)
    results = [None] * len(xs)
    try:
        check(server.wait_ready(600), "int8-static server buckets did not warm up")

        def ask(i):
            results[i] = server.infer(xs[i])[0]

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(len(xs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        stats = server.stats()
    finally:
        server.shutdown()
    launches = _counts()
    _check_routed("int8-static server", launches, {"qlinear_conv", "int8_join"})
    check(all(v is not None for v in results), "int8-static server left requests unanswered")
    errs = [float(np.abs(results[i] - direct[i]).max()) for i in range(len(xs))]
    check(stats["requests"] == 32 and stats["errors"] == 0, f"int8-static server stats {stats}")
    check(max(errs) <= bound_abs, f"int8-static served vs direct: max-abs {max(errs)} > "
                                  f"{bound_abs}")
    res["serve"] = {"launches": launches, "stats": stats, "max_abs_vs_direct": max(errs)}
    say(12, f"(c) served {stats['requests']} requests in {stats['batches']} batches of up to 16, "
            f"p50 {stats['latency_ms_p50']:.1f} ms, p95 {stats['latency_ms_p95']:.1f} ms | vs "
            f"direct: max-abs {max(errs):.3g} (bound {bound_abs:.3g}) | launches "
            f"{ {k: v for k, v in launches.items() if v} }")
    del model, xg
    return res


# -- phase 5 ---------------------------------------------------------------

def _llama_graph(layers: int, chunk: int = 1):
    """llama_1b's batched paged step graph (of `chunk` tokens a slot: the
    speculative verify at chunk gamma + 1), int4-g128 weights fused, int8 KV
    pools: random weights from seed 0, quantized and fused by the port. With
    fewer layers, the same weights cut to the first `layers`."""
    from smelter_tpu_torch.models import llama_style as ls
    from smelter_tpu_torch.passes.pass_manager import run_passes
    from smelter_tpu_torch.quant import quantize_weights

    cfg = dict(LLAMA_1B, layers=layers)
    w = ls.make_weights(**cfg, max_len=PAGE * NPG, seed=0)
    g = ls.build_decode_step_paged(w, **cfg, slots=SLOTS, page_size=PAGE,
                                   n_pages=1 + SLOTS * NPG, npg=NPG, kv_quant=True,
                                   chunk=chunk)[0]
    del w
    quantize_weights(g, f"int4-g{GROUP}", min_elements=1 << 16)
    run_passes(g, ["fuse_dequant_matmul", "dce"])
    return g


def _step_inputs(np, g) -> dict:
    """One step's inputs from seed 2: 8 slots at positions on both sides of
    the page boundaries, a shuffled page table, and pools full of int8
    values with per-row scales (as f32; the card's run takes them in bf16)."""
    rng = np.random.default_rng(2)
    by = {"token": rng.integers(1, LLAMA_1B["vocab"] - 1, (SLOTS, 1)).astype(np.int64),
          "pos": np.array([0, 37, PAGE - 1, PAGE, 2 * PAGE - 6, 3 * PAGE - 1, 3 * PAGE,
                           NPG * PAGE - 1], np.int64),
          "page_table": (1 + rng.permutation(SLOTS * NPG)).reshape(SLOTS, NPG)
          .astype(np.int32)}
    for v in g.inputs:
        if v.name.startswith(("k_pool", "v_pool")):
            by[v.name] = rng.integers(-127, 128, tuple(v.type.shape), dtype=np.int8)
        elif v.name.startswith(("k_scale_pool", "v_scale_pool")):
            by[v.name] = rng.uniform(1e-3, 2e-2, tuple(v.type.shape)).astype(np.float32)
    return by


def _expect_decode_launches(label: str, counts: dict, steps: int, layers: int = 0) -> None:
    layers = layers or LLAMA_1B["layers"]
    per = {"int4_matmul": 7 * layers + 1, "paged_decode_attention": layers}
    _check_routed(label, counts, per)
    for k, n in per.items():
        check(counts[k] == n * steps, f"{label}: {k} launched {counts[k]} times in {steps} "
                                      f"steps, not {n} a step")


def _check_step(torch, np, stt, g, layers: int, f32_rel: float) -> dict:
    """One step of `g` on the card in f32 and in bf16 (the path's type)
    against the port's CPU runs of the same graph and inputs in f32 (the
    reference) and bf16. The card's f32 must lie within f32_rel of the
    largest reference logit; its bf16 within 3x the CPU's own bf16 error;
    top-1 must agree wherever the reference's top-2 gap exceeds twice the
    error. Each card run must launch the decode kernels once a layer."""
    from smelter_tpu_torch.runtime.executor import Executor

    by = _step_inputs(np, g)
    names = [v.name for v in g.inputs]

    def step(device, dtype):
        """Last-row logits (B, vocab) of one step, and the step's launches."""
        ex_ = Executor(g, stt.Config(device=device, compute_dtype=dtype))
        ins = [torch.from_numpy(by[n].copy()).to(device) for n in names]
        if dtype == "bfloat16":
            ins = [t.to(torch.bfloat16) if t.is_floating_point() else t for t in ins]
        prm = ex_.cast_params(ex_.init_params())
        _zero_counts()
        out_ = ex_.build_fn()(prm, *ins)[0]
        if device == "cuda":
            torch.cuda.synchronize()
        return out_.float().cpu().numpy()[:, -1], _counts()

    got32, launches32 = step("cuda", "float32")
    got16, launches = step("cuda", "bfloat16")
    _expect_decode_launches(f"{layers}-layer step f32", launches32, 1, layers)
    _expect_decode_launches(f"{layers}-layer step bf16", launches, 1, layers)
    t0 = time.perf_counter()
    ref, _ = step("cpu", "float32")
    ref16, _ = step("cpu", "bfloat16")
    cpu_s = time.perf_counter() - t0
    scale = float(np.abs(ref).max())
    top2 = np.sort(ref, axis=1)[:, -2:]
    gap = top2[:, 1] - top2[:, 0]
    err_cpu16 = float(np.abs(ref16 - ref).max())
    r = {"max_abs_ref": scale, "cpu_bf16_max_abs_err": err_cpu16, "gaps": gap.tolist(),
         "launches": launches, "cpu_s": cpu_s}
    text = []
    for label, a, bound in (("f32", got32, f32_rel * scale), ("bf16", got16, 3 * err_cpu16)):
        check(a.shape == (SLOTS, LLAMA_1B["vocab"]) and np.isfinite(a).all(),
              f"{layers}-layer step {label}: logits")
        err = float(np.abs(a - ref).max())
        agree = a.argmax(1) == ref.argmax(1)
        r[label] = {"max_abs_err": err, "bound": bound, "top1_agree": float(agree.mean())}
        check(err <= bound, f"{layers}-layer step {label}: max-abs {err} > {bound}")
        check(bool(agree[gap > 2 * err].all()),
              f"{layers}-layer step {label}: top-1 differs on a clear row "
              f"(agree {agree.tolist()}, gaps {gap.tolist()})")
        text.append(f"card {label} max-abs {err:.4g} (bound {bound:.4g}), top-1 "
                    f"{int(agree.sum())}/{SLOTS} (clear rows {int((gap > 2 * err).sum())})")
    say(5, f"(a) {layers}-layer step vs the CPU's f32 run (max|ref| {scale:.4g}, CPU bf16 "
           f"max-abs {err_cpu16:.4g}, CPU runs {cpu_s:.1f} s): " + "; ".join(text)
           + f" | launches {launches}")
    return r


def phase_paged(torch, np, stt) -> dict:
    from smelter_tpu_torch.runtime.executor import Executor
    from smelter_tpu_torch.serving.paged_server import PagedDecodeServer

    res: dict = {}
    # (a) one step on the card against the port's CPU runs, on the first 2
    # layers of the weights and at full depth. A last-bit difference moves
    # an activation by a whole step where it is rounded to bf16 (each int4
    # product's x) or to int8 (the KV rows), and the random network carries
    # that on: on the CPU, summing only the int4 products in f64 instead of
    # f32 moves the logits by 4.8e-3 of the largest at 2 layers of this
    # width, and by 1.0e-2 at 24 layers of width 512. So the card's f32 is
    # held to 1e-2 at 2 layers and 5e-2 at 24.
    t0 = time.perf_counter()
    g2 = _llama_graph(2)
    build2_s = time.perf_counter() - t0
    res["step_2_layers"] = _check_step(torch, np, stt, g2, 2, 1e-2)
    del g2
    t0 = time.perf_counter()
    g = _llama_graph(LLAMA_1B["layers"])
    res["build_s"] = time.perf_counter() - t0
    n_i4 = sum(n.op_type == "FusedDequantMatMulI4" for n in g.nodes)
    say(5, f"llama_1b paged step graph, int4-g{GROUP} fused ({n_i4} int4 matmuls), int8 KV, "
           f"built in {res['build_s']:.1f} s (2-layer cut in {build2_s:.1f} s)")
    res["step_vs_cpu_f32"] = _check_step(torch, np, stt, g, LLAMA_1B["layers"], 5e-2)

    by = _step_inputs(np, g)
    names = [v.name for v in g.inputs]
    cfg = stt.Config(compute_dtype="bfloat16")
    ex = Executor(g, cfg)
    params = ex.cast_params(ex.init_params())
    fn = ex.build_fn()
    dev_in = [torch.from_numpy(by[n]).cuda() for n in names]
    dev_in = [t.to(torch.bfloat16) if t.is_floating_point() else t for t in dev_in]

    # (c) a step's device time and where it goes
    step_ms = time_ms(torch, lambda i: fn(params, *dev_in), 10)
    kernels, ops, n_kernels = _profile(torch, lambda: fn(params, *dev_in))
    busy = sum(kernels.values())
    ours = {k: v for k, v in kernels.items() if "int4_matmul" in k or "decode_attention::" in k}
    res["step"] = {"step_ms": step_ms, "device_busy_ms": busy,
                   "idle_share": max(0.0, 1 - busy / step_ms), "port_kernel_ms": ours,
                   "top_kernels_ms": sorted(kernels.items(), key=lambda kv: -kv[1])[:10],
                   "top_host_ops_ms": sorted(ops.items(), key=lambda kv: -kv[1])[:10],
                   "kernel_launches_profiled": n_kernels}
    del params, dev_in, ex, fn
    torch.cuda.empty_cache()
    r = res["step"]
    say(5, f"(c) step {step_ms:.3f} ms (host-timed, 10 steps), profiled device busy "
           f"{busy:.3f} ms, idle share {100 * r['idle_share']:.1f}%, port kernels "
           f"{sum(ours.values()):.3f} ms, ~{r['kernel_launches_profiled']:.0f} device kernels "
           f"a step")
    say(5, "  device ms a step by host op: "
           + "; ".join(f"{k} {v:.3f}" for k, v in r["top_host_ops_ms"]))
    say(5, "  device ms a step by kernel: "
           + "; ".join(f"{k[:60]} {v:.3f}" for k, v in r["top_kernels_ms"][:6]))

    # (b) serving on the first SERVE_LAYERS layers: bench.py's 32 requests
    # (prompts of 8-47 tokens, 64 new each, seed 0; none reaches row 128)
    # and two longer ones (100 and 120 tokens) that cross the page boundary
    del g
    t0 = time.perf_counter()
    g = _llama_graph(SERVE_LAYERS)
    res["serve_build_s"] = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    vocab = LLAMA_1B["vocab"]
    reqs = [[int(t) for t in rng.integers(1, vocab - 1, n)]
            for n in rng.integers(8, min(48, PAGE * NPG // 4), 32)]
    reqs += [[int(t) for t in rng.integers(1, vocab - 1, n)] for n in (PAGE - 28, PAGE - 8)]
    n_new = 64
    server = PagedDecodeServer(g, cfg, tick_steps=1)
    try:
        server.submit(reqs[0][:8], 4).result(timeout=600)  # first use outside the clock
        steps0 = server.stats()["steps"]
        _zero_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        futs = [server.submit(p, n_new) for p in reqs]
        served = [f.result(timeout=900) for f in futs]
        wall = time.perf_counter() - t0
        launches = _counts()
        stats = server.stats()
        steps = stats["steps"] - steps0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        _expect_decode_launches("paged serving", launches, steps, SERVE_LAYERS)
        check(all(len(r) == len(p) + n_new and r[:len(p)] == p for r, p in zip(served, reqs)),
              "paged serving: a request came back short or altered")
        crossed = sum(len(r) > PAGE for r in served)
        check(crossed >= 1, "paged serving: no sequence crossed a page boundary")
        solo_idx = (0, 7, 32, 33)
        for i in solo_idx:  # one active slot
            alone = server.submit(reqs[i], n_new).result(timeout=600)
            check(alone == served[i], f"paged serving: request {i} served != alone")
        cache_gb = server.cache_bytes() / 1e9
    finally:
        server.shutdown()
    del server
    tokens = len(reqs) * n_new
    res["serve_t1"] = {"layers": SERVE_LAYERS, "requests": len(reqs), "tokens": tokens,
                       "wall_s": wall,
                       "tok_s": tokens / wall, "ticks": steps, "ms_per_tick": 1e3 * wall / steps,
                       "peak_mem_gb": peak_gb, "pool_gb": cache_gb, "launches": launches,
                       "page_crossings": crossed, "stall_ticks": stats["stall_ticks"],
                       "solo_equal": list(solo_idx)}
    r = res["serve_t1"]
    say(5, f"(b) {SERVE_LAYERS}-layer cut (built in {res['serve_build_s']:.1f} s): served "
           f"{len(reqs)} requests, {tokens} new tokens in {wall:.2f} s: "
           f"{r['tok_s']:.1f} tok/s, {steps} ticks, {r['ms_per_tick']:.2f} ms a tick, peak "
           f"{peak_gb:.2f} GB (pools {cache_gb:.3f} GB), {crossed} sequences crossed a page, "
           f"stall ticks {stats['stall_ticks']} | launches {launches} | requests {solo_idx} "
           f"alone: equal")

    # a short run at tick_steps 4: the same tokens as at tick_steps 1
    server = PagedDecodeServer(g, cfg, tick_steps=4)
    short, n4 = reqs[:8] + reqs[33:], 16
    try:
        server.submit(reqs[0][:8], 4).result(timeout=600)
        steps0 = server.stats()["steps"]
        _zero_counts()
        t0 = time.perf_counter()
        got4 = [f.result(timeout=600) for f in [server.submit(p, n4) for p in short]]
        wall4 = time.perf_counter() - t0
        launches4 = _counts()
        steps4 = server.stats()["steps"] - steps0
    finally:
        server.shutdown()
    del server
    _expect_decode_launches("paged serving, tick_steps 4", launches4, steps4, SERVE_LAYERS)
    want4 = [served[i][:len(reqs[i]) + n4] for i in list(range(8)) + [33]]
    check(got4 == want4, "paged serving: tick_steps 4 tokens differ from tick_steps 1")
    res["serve_t4"] = {"requests": len(short), "tokens": len(short) * n4, "wall_s": wall4,
                       "tok_s": len(short) * n4 / wall4, "steps": steps4,
                       "launches": launches4}
    say(5, f"(b) tick_steps 4: {len(short)} requests x {n4} tokens in {wall4:.2f} s "
           f"({res['serve_t4']['tok_s']:.1f} tok/s, {steps4} steps), tokens equal to "
           f"tick_steps 1 | launches {launches4}")
    return res, g, reqs, served


# -- phase 7 ---------------------------------------------------------------

def _static_graphs(layers: int, chunk: int = 0, short_len: int = 0):
    """llama_1b's static-cache step graph (max_len 512, int8 KV) and its
    prefill graphs at BUCKETS, int4-g128 weights fused: random weights from seed 0, each graph quantized on its own, as
    bench.py --decode and --serve-decode build them. Returns (step, prefill
    graphs, more): `more` holds, where asked for, the chunk-`chunk` verify
    step ("chunk") and a step over a cache of `short_len` rows ("short"),
    from the same weights."""
    from smelter_tpu_torch.models import llama_style as ls
    from smelter_tpu_torch.passes.pass_manager import run_passes
    from smelter_tpu_torch.quant import quantize_weights

    cfg = dict(LLAMA_1B, layers=layers)
    max_len = PAGE * NPG
    w = ls.make_weights(**cfg, max_len=max_len, seed=0)

    def q(g):
        quantize_weights(g, f"int4-g{GROUP}", min_elements=1 << 16)
        run_passes(g, ["fuse_dequant_matmul", "dce"])
        return g

    step = q(ls.build_decode_step(w, **cfg, max_len=max_len, kv_quant=True)[0])
    pfs = [q(ls.build_prefill(w, prompt_len=p, max_len=max_len, kv_quant=True, **cfg))
           for p in BUCKETS]
    more = {}
    if chunk:
        more["chunk"] = q(ls.build_decode_step(w, **cfg, max_len=max_len, kv_quant=True,
                                               chunk=chunk)[0])
    if short_len:
        more["short"] = q(ls.build_decode_step(w, **cfg, max_len=short_len, kv_quant=True)[0])
    return step, pfs, more


def _check_static_step(torch, np, stt, g, phase: int = 7) -> dict:
    """One static-cache step of `g` with ragged_attention on the card (f32
    and bf16) against the port's CPU runs (f32, the reference, and bf16),
    with phase 5's bounds: f32 within 5e-2 of the largest reference logit at 24
    layers, bf16 within 3x the CPU's own bf16 error, top-1 equal where the
    top-2 gap exceeds twice the error, on each of its c rows (a chunk-c
    verify step takes c tokens from seed 4). Caches hold int8 rows with
    scales up to pos 300, and other values past it."""
    from smelter_tpu_torch.runtime.executor import Executor
    from smelter_tpu_torch.runtime.generate import _decode_graph

    layers = LLAMA_1B["layers"]
    rng = np.random.default_rng(4)
    c = next(v.type.shape[0] for v in g.inputs if v.name == "token")
    by = {"token": (np.array([LLAMA_1B["vocab"] // 7], np.int64) if c == 1 else
                    rng.integers(1, LLAMA_1B["vocab"] - 1, c).astype(np.int64)),
          "pos": np.array([PAGE * NPG * 300 // 512], np.int64)}
    for v in g.inputs:
        if v.name.startswith(("k_cache_scale", "v_cache_scale")):
            by[v.name] = rng.uniform(1e-3, 2e-2, tuple(v.type.shape)).astype(np.float32)
        elif v.name.startswith(("k_cache", "v_cache")):
            by[v.name] = rng.integers(-127, 128, tuple(v.type.shape), dtype=np.int8)

    def step(device, dtype):
        cfg = stt.Config(device=device, compute_dtype=dtype, ragged_attention=True)
        gr = _decode_graph(g, cfg)
        ex_ = Executor(gr, cfg)
        ins = [torch.from_numpy(by[v.name].copy()).to(ex_.device) for v in gr.inputs]
        if dtype == "bfloat16":
            ins = [t.to(torch.bfloat16) if t.is_floating_point() else t for t in ins]
        prm = ex_.cast_params(ex_.init_params())
        _zero_counts()
        out_ = ex_.build_fn()(prm, *ins)[0]
        if ex_.device.type == "cuda":
            torch.cuda.synchronize()
        return out_.float().cpu().numpy()[-c:], _counts()

    per = {"int4_matmul": 7 * layers + 1, "ragged_decode_attention": layers}
    got32, l32 = step("cuda", "float32")
    got16, l16 = step("cuda", "bfloat16")
    for label, counts in (("static step f32", l32), ("static step bf16", l16)):
        _check_routed(label, counts, per)
        check(all(counts[k] == n for k, n in per.items()), f"{label}: launches {counts}")
    t0 = time.perf_counter()
    ref, _ = step("cpu", "float32")
    ref16, _ = step("cpu", "bfloat16")
    cpu_s = time.perf_counter() - t0
    scale = float(np.abs(ref).max())
    top2 = np.sort(ref, axis=1)[:, -2:]
    gaps = top2[:, 1] - top2[:, 0]
    gap = float(gaps.min())
    err_cpu16 = float(np.abs(ref16 - ref).max())
    r = {"max_abs_ref": scale, "cpu_bf16_max_abs_err": err_cpu16, "gap": gap,
         "launches": l16, "cpu_s": cpu_s}
    text = []
    for label, a, lim in (("f32", got32, 5e-2 * scale), ("bf16", got16, 3 * err_cpu16)):
        check(a.shape == (c, LLAMA_1B["vocab"]) and np.isfinite(a).all(),
              f"static step {label}: logits")
        err = float(np.abs(a - ref).max())
        rows_agree = a.argmax(1) == ref.argmax(1)
        agree = bool(rows_agree.all())
        r[label] = {"max_abs_err": err, "bound": lim, "top1_agree": agree}
        check(err <= lim, f"static step {label}: max-abs {err} > {lim}")
        check(bool((rows_agree | (gaps <= 2 * err)).all()),
              f"static step {label}: top-1 differs at gaps {gaps.tolist()}")
        text.append(f"card {label} max-abs {err:.4g} (bound {lim:.4g}), top-1 "
                    + (f"{'equal' if agree else 'differs'} (gap {gap:.3g})" if c == 1 else
                       f"{int(rows_agree.sum())}/{c} rows (least gap {gap:.3g})"))
    say(phase, f"(a) {layers}-layer static {'step' if c == 1 else f'chunk-{c} verify'}, "
               "ragged attention, vs the CPU's f32 run (max|ref| "
           f"{scale:.4g}, CPU bf16 max-abs {err_cpu16:.4g}, CPU runs {cpu_s:.1f} s): "
           + "; ".join(text) + f" | launches {l16}")
    return r


def _check_prefill(torch, np, stt, g) -> dict:
    """One forward of the 256-token prefill graph `g` on the card (f32 and
    bf16) against the port's CPU runs of the same graph (f32, the
    reference, and bf16), with phase 5's bounds, for its logits and for the
    int8 cache rows it emits, taken times their scales. Rows past the
    prompt must be zeros. A forward launches int4_matmul 169 times (M 256)
    and no attention kernel (GroupQueryAttention is SDPA)."""
    from smelter_tpu_torch.runtime.executor import Executor

    layers, T = LLAMA_1B["layers"], BUCKETS[-1]
    tokens = np.random.default_rng(6).integers(1, LLAMA_1B["vocab"] - 1, T).astype(np.int64)
    names = [v.name for v in g.outputs]

    def forward(device, dtype):
        ex_ = Executor(g, stt.Config(device=device, compute_dtype=dtype))
        prm = ex_.cast_params(ex_.init_params())
        _zero_counts()
        out = dict(zip(names, ex_.build_fn()(prm, torch.from_numpy(tokens).to(ex_.device))))
        counts = _counts()
        caches = [(out[f"{kv}_out_{i}"], out[f"{kv}_scale_out_{i}"])
                  for i in range(layers) for kv in "kv"]
        check(all(not q[T:].any() and not s[T:].any() for q, s in caches),
              f"prefill {device} {dtype}: cache rows past the prompt are not zeros")
        rows = torch.stack([q[:T].float() * s[:T].float() for q, s in caches])
        return out[names[0]].float().cpu().numpy(), rows.cpu().numpy(), counts

    got32, rows32, l32 = forward("cuda", "float32")
    got16, rows16, l16 = forward("cuda", "bfloat16")
    for label, counts in (("prefill f32", l32), ("prefill bf16", l16)):
        _check_routed(label, counts, "int4_matmul")
        check(counts["int4_matmul"] == 7 * layers + 1, f"{label}: launches {counts}")
    t0 = time.perf_counter()
    ref, ref_rows, _ = forward("cpu", "float32")
    ref16, ref16_rows, _ = forward("cpu", "bfloat16")
    r = {"prompt": T, "cpu_s": time.perf_counter() - t0, "launches": l16}
    top2 = np.sort(ref, axis=1)[:, -2:]
    gap = top2[:, 1] - top2[:, 0]
    text = []
    for what, a32, a16, want, want16 in (("logits", got32, got16, ref, ref16),
                                         ("cache rows", rows32, rows16, ref_rows, ref16_rows)):
        scale = float(np.abs(want).max())
        err_cpu16 = float(np.abs(want16 - want).max())
        r[what] = {"max_abs_ref": scale, "cpu_bf16_max_abs_err": err_cpu16}
        for label, a, lim in (("f32", a32, 5e-2 * scale), ("bf16", a16, 3 * err_cpu16)):
            check(a.shape == want.shape and np.isfinite(a).all(), f"prefill {what} {label}")
            err = float(np.abs(a - want).max())
            r[what][label] = {"max_abs_err": err, "bound": lim}
            check(err <= lim, f"prefill {what} {label}: max-abs {err} > {lim}")
            note = ""
            if what == "logits":
                agree = a.argmax(1) == want.argmax(1)
                clear = gap > 2 * err
                r[what][label]["top1_agree"] = float(agree.mean())
                check(bool(agree[clear].all()), f"prefill logits {label}: top-1 differs on a "
                                                f"clear row")
                note = f", top-1 {int(agree.sum())}/{T} (clear rows {int(clear.sum())})"
            text.append(f"{what} {label} max-abs {err:.4g} (bound {lim:.4g}{note})")
    say(7, f"(a) {layers}-layer {T}-token prefill vs the CPU's f32 run (max|logit| "
           f"{r['logits']['max_abs_ref']:.4g}, max|row| {r['cache rows']['max_abs_ref']:.4g}, "
           f"CPU runs {r['cpu_s']:.1f} s): " + "; ".join(text) + f" | launches {l16}")
    return r


def _serve_run(torch, server, reqs, n_new, label):
    """Serve `reqs` after a warm-up request; the launches, steps and prefills
    of just this run, its wall time and peak memory."""
    server.submit(reqs[0][:8], 4).result(timeout=600)  # first use outside the clock
    st0 = server.stats()
    gc.collect()  # what earlier phases left, so that the peak is this run's
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    _zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    served = [f.result(timeout=900) for f in [server.submit(p, n_new) for p in reqs]]
    wall = time.perf_counter() - t0
    launches = _counts()
    st1 = server.stats()
    r = {"requests": len(reqs), "tokens": len(reqs) * n_new, "wall_s": wall,
         "tok_s": len(reqs) * n_new / wall, "steps": st1["steps"] - st0["steps"],
         "prefills": st1["prefills"] - st0["prefills"], "launches": launches,
         "resident_gb": resident / 1e9, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    r["ms_per_tick"] = 1e3 * wall / max(1, r["steps"])
    check(all(len(x) == len(p) + n_new and x[:len(p)] == p for x, p in zip(served, reqs)),
          f"{label}: a request came back short or altered")
    # every multi-token prompt was admitted by a prefill forward; each
    # prefill runs the 169 int4 matmuls of the prefill graph once
    check(r["prefills"] == sum(len(p) > 1 for p in reqs),
          f"{label}: {r['prefills']} prefills for {len(reqs)} prompts")
    return served, r


def _expect_serving_launches(label, counts, r, attention, layers: int):
    per = {"int4_matmul": (7 * layers + 1) * (r["steps"] + r["prefills"]),
           attention: layers * r["steps"]}
    _check_routed(label, counts, per)
    for k, n in per.items():
        check(counts[k] == n, f"{label}: {k} launched {counts[k]} times, not {n} "
                              f"({7 * layers + 1} a step and a prefill, {layers} attention a "
                              "step)")


def phase_static(torch, np, stt, paged_graph, paged_reqs, paged_tok_s, keep: dict) -> dict:
    """The static-cache decode path at llama_1b's full width and depth:
    the step and a prefill against the CPU, FusedGenerator (CUDA graph of
    the step); then on the first SERVE_LAYERS layers DecodeServer (a
    vmapped step, prefill ladder) and PagedDecodeServer with the same
    prefill ladder (`paged_graph`, phase 5's cut). `keep` receives the
    graphs phase 14 runs (the step graphs, with their chunk verify twins
    built beside them, and the 128-row step of its bucket ladder)."""
    from smelter_tpu_torch.runtime.generate import FusedGenerator, Generator
    from smelter_tpu_torch.serving.decode_server import DecodeServer
    from smelter_tpu_torch.serving.paged_server import PagedDecodeServer

    res: dict = {}
    t0 = time.perf_counter()
    step, pfs, more = _static_graphs(LLAMA_1B["layers"], chunk=SPEC_GAMMA + 1)
    res["build_s"] = time.perf_counter() - t0
    keep.update(step24=step, chunk24=more["chunk"])
    say(7, f"llama_1b static step graph and prefill graphs {BUCKETS}, int4-g{GROUP} fused, "
           f"int8 KV (and phase 14's chunk-{SPEC_GAMMA + 1} verify graph), built in "
           f"{res['build_s']:.1f} s")
    res["step_vs_cpu_f32"] = _check_static_step(torch, np, stt, step)
    res["prefill_vs_cpu_f32"] = _check_prefill(torch, np, stt, pfs[-1])
    cfg = stt.Config(compute_dtype="bfloat16", ragged_attention=True)

    # (b) FusedGenerator: bench.py --decode's prompt and K-differenced n_new
    prompt = list(range(1, 9))
    n_lo, n_hi, reps = 16, 272, 3
    gen = FusedGenerator(step, cfg, prefill_graph=pfs)
    _zero_counts()
    host = Generator(step, cfg).generate(prompt, 64)
    check(gen.generate(prompt, 64) == host, "FusedGenerator tokens differ from Generator's")
    check(len(gen._graphs) == 1 and gen.step_launches["greedy"] == {
        "int4_matmul": 169, "ragged_decode_attention": 24},
        f"FusedGenerator graph launches {gen.step_launches}")

    def timed(n):
        best = float("inf")
        for _ in range(reps):
            t = time.perf_counter()
            out = gen.generate(prompt, n)
            best = min(best, time.perf_counter() - t)
        check(len(out) == len(prompt) + n, "FusedGenerator output length")
        return best

    timed(n_lo)
    per_tok = (timed(n_hi) - timed(n_lo)) / (n_hi - n_lo)
    # device time a token: one replay's kernels, by torch.profiler
    graph = gen._graph(False, 0)
    kernels, _, n_k = _profile(torch, graph.replay, steps=20)
    busy = sum(kernels.values())
    ragged_ms = sum(v for k, v in kernels.items() if "::split_chunk<" in k
                    or "::split_combine<" in k)
    check(ragged_ms > 0, f"FusedGenerator's replay shows no split-KV kernel: {list(kernels)[:8]}")
    pf_prompt = [int(t) for t in np.random.default_rng(5).integers(
        1, LLAMA_1B["vocab"] - 1, BUCKETS[0])]
    t = time.perf_counter()
    pf_out = gen.generate(pf_prompt, 16)
    pf_s = time.perf_counter() - t
    check(len(pf_out) == BUCKETS[0] + 16, "FusedGenerator prefill output length")
    res["fused"] = {"tok_s": 1 / per_tok, "ms_per_token": 1e3 * per_tok, "n_lo": n_lo,
                    "n_hi": n_hi, "device_busy_ms_per_token": busy,
                    "idle_share": max(0.0, 1 - busy / (1e3 * per_tok)) if n_k else None,
                    "kernels_per_token_profiled": n_k, "step_launches": gen.step_launches,
                    "ragged_device_ms_per_token": ragged_ms,
                    "replays": gen.replays, "prefill64_plus_16_s": pf_s,
                    "tokens_equal_generator": 64}
    r = res["fused"]
    say(7, f"(b) FusedGenerator (CUDA graph of the step, one replay a token): "
           f"{r['tok_s']:.1f} tok/s, {r['ms_per_token']:.3f} ms a token (K-differenced n_new "
           f"{n_lo}->{n_hi}, best of {reps}), profiled device busy {busy:.3f} ms a token "
           f"({n_k:.0f} kernels; ragged_decode_attention's split-KV kernels {ragged_ms:.4f} "
           f"ms of it), idle share "
           + (f"{100 * r['idle_share']:.1f}%" if r["idle_share"] is not None else "not measured")
           + f" | 64 tokens equal Generator's | a replay launches {gen.step_launches['greedy']}"
           f" | prefill 64 + 16 tokens in {pf_s:.3f} s")
    del gen, graph, step, pfs
    torch.cuda.empty_cache()
    # (c) and (d) on the first SERVE_LAYERS layers
    t0 = time.perf_counter()
    step, pfs, more = _static_graphs(SERVE_LAYERS, chunk=SPEC_GAMMA + 1, short_len=PAGE)
    res["serve_build_s"] = time.perf_counter() - t0
    keep.update(step4=step, pfs4=pfs, chunk4=more["chunk"], short4=more["short"])
    del more

    # (c) DecodeServer: bench.py --serve-decode's 32 requests plus a 100- and
    # a 300-token prompt (the last prefills the 256 bucket, then is fed)
    rng = np.random.default_rng(0)
    vocab = LLAMA_1B["vocab"]
    reqs = [[int(t) for t in rng.integers(1, vocab - 1, n)]
            for n in rng.integers(8, min(48, PAGE * NPG // 4), 32)]
    reqs += [[int(t) for t in rng.integers(1, vocab - 1, n)] for n in (100, 300)]
    n_new = 64
    server = DecodeServer(step, slots=SLOTS, config=cfg, prefill_graphs=pfs, tick_steps=1)
    try:
        served, r = _serve_run(torch, server, reqs, n_new, "DecodeServer")
        _expect_serving_launches("DecodeServer", r["launches"], r, "ragged_decode_attention",
                                 SERVE_LAYERS)
        # the prefill graphs share the step graph's weights: only small
        # constants that differ between the graphs (their position ids) are
        # held under a second name
        params = server.shared_weights()[0]
        dup = sorted(n for n, t in params.items()
                     if "__p" in n and t.numel() * t.element_size() > 1 << 20)
        check(not dup, f"DecodeServer holds weights twice: {dup[:5]}")
        r["params_gb"] = sum(t.numel() * t.element_size() for t in params.values()) / 1e9
        del params  # the server's own reference is the one that should hold them
        r["cache_gb"] = server.cache_bytes() / 1e9
        solo = (0, 7, 32, 33)
        for i in solo:
            check(server.submit(reqs[i], n_new).result(timeout=600) == served[i],
                  f"DecodeServer: request {i} served != alone")
        # a tick's device time and where it goes, on the idle server
        tok = torch.ones(SLOTS, 1, dtype=torch.int64, device=server.device)
        posd = torch.tensor([[0], [73], [127], [128], [292], [365], [438], [511]][:SLOTS],
                            device=server.device)
        with torch.inference_mode():
            r["tick_ms_alone"] = time_ms(torch, lambda i: server._run_step(tok, posd), 10)
            kernels, ops, n_k = _profile(torch, lambda: server._run_step(tok, posd))
        r["device_busy_ms"] = sum(kernels.values())
        r["idle_share"] = max(0.0, 1 - r["device_busy_ms"] / r["tick_ms_alone"])
        r["kernels_per_tick"] = n_k
        r["top_host_ops_ms"] = sorted(ops.items(), key=lambda kv: -kv[1])[:8]
    finally:
        server.shutdown()
    del server
    r["layers"] = SERVE_LAYERS
    res["decode_server"] = r
    say(7, f"(c) DecodeServer, {SERVE_LAYERS}-layer cut (built in {res['serve_build_s']:.1f} s; 8 "
           f"slots, vmapped step, prefill {BUCKETS}): {r['requests']} "
           f"requests, {r['tokens']} new tokens in {r['wall_s']:.2f} s: {r['tok_s']:.1f} tok/s, "
           f"{r['steps']} ticks at {r['ms_per_tick']:.2f} ms, {r['prefills']} prefills | a tick "
           f"alone {r['tick_ms_alone']:.3f} ms, device busy {r['device_busy_ms']:.3f} ms, idle "
           f"share {100 * r['idle_share']:.1f}%, ~{n_k:.0f} kernels | peak {r['peak_mem_gb']:.3f}"
           f" GB over {r['resident_gb']:.3f} GB resident (weights {r['params_gb']:.3f} GB held "
           f"once, caches {r['cache_gb']:.3f} GB; the rest is the prefill walk's activations) | "
           f"launches {r['launches']} | requests {solo} alone: equal")

    server = DecodeServer(step, slots=SLOTS, config=cfg, prefill_graphs=pfs, tick_steps=4)
    short, n4 = reqs[:8] + reqs[33:], 16
    try:
        got4, r4 = _serve_run(torch, server, short, n4, "DecodeServer tick_steps 4")
    finally:
        server.shutdown()
    del server
    _expect_serving_launches("DecodeServer tick_steps 4", r4["launches"], r4,
                             "ragged_decode_attention", SERVE_LAYERS)
    check(got4 == [served[i][:len(reqs[i]) + n4] for i in list(range(8)) + [33]],
          "DecodeServer: tick_steps 4 tokens differ from tick_steps 1")
    res["decode_server_t4"] = r4
    say(7, f"(c) tick_steps 4: {len(short)} requests x {n4} tokens in {r4['wall_s']:.2f} s "
           f"({r4['tok_s']:.1f} tok/s, {r4['steps']} steps), tokens equal to tick_steps 1")

    # (d) PagedDecodeServer with the prefill ladder on phase 5's traffic
    server = PagedDecodeServer(paged_graph, stt.Config(compute_dtype="bfloat16"),
                               prefill_graphs=pfs, tick_steps=1)
    try:
        _, rp = _serve_run(torch, server, paged_reqs, n_new, "PagedDecodeServer prefill")
        rp["stall_ticks"] = server.stats()["stall_ticks"]
    finally:
        server.shutdown()
    del server
    _expect_serving_launches("PagedDecodeServer prefill", rp["launches"], rp,
                             "paged_decode_attention", SERVE_LAYERS)
    rp["tok_s_fed_a_token_a_tick"] = paged_tok_s
    res["paged_prefill"] = rp
    say(7, f"(d) PagedDecodeServer with prefill {BUCKETS}, {SERVE_LAYERS}-layer cut: "
           f"{rp['requests']} requests in "
           f"{rp['wall_s']:.2f} s: {rp['tok_s']:.1f} tok/s ({paged_tok_s:.1f} fed a token a "
           f"tick, phase 5), {rp['steps']} ticks at {rp['ms_per_tick']:.2f} ms, "
           f"{rp['prefills']} prefills, peak {rp['peak_mem_gb']:.3f} GB over "
           f"{rp['resident_gb']:.3f} GB resident | launches {rp['launches']}")
    return res


# -- phase 14 --------------------------------------------------------------

# Tokens a request in phase 14's timed serving runs: a speculative tick runs
# gamma + 1 vmapped draft steps and a verify, several times phase 7's tick
# on the host, so phase 7's 64 would outrun the phase's share of the limit.
SPEC_N_NEW = 16


def _draft_graphs():
    """The tiny draft's step graph (max_len 512, bf16 KV) and its prefill
    graphs at BUCKETS, unquantized, from seed 7 (bench.py:369-377)."""
    from smelter_tpu_torch.models import llama_style as ls

    max_len = PAGE * NPG
    w = ls.make_weights(**SPEC_DRAFT, max_len=max_len, seed=7)
    step = ls.build_decode_step(w, **SPEC_DRAFT, max_len=max_len)[0]
    pfs = [ls.build_prefill(w, prompt_len=p, max_len=max_len, **SPEC_DRAFT) for p in BUCKETS]
    return step, pfs


def _spec_per_round(layers: int, paged: bool) -> dict:
    """A speculative round's launches: the verify's 7 int4_matmul a layer
    and the head, its attention a layer (ragged, or paged), and the draft's
    ragged_decode_attention a layer in each of its gamma + 1 steps (gamma
    drafts after a catch-up step at pos - 1)."""
    draft = (SPEC_GAMMA + 1) * SPEC_DRAFT["layers"]
    if paged:
        return {"int4_matmul": 7 * layers + 1, "paged_decode_attention": layers,
                "ragged_decode_attention": draft}
    return {"int4_matmul": 7 * layers + 1, "ragged_decode_attention": layers + draft}


def _spec_serve(torch, server, reqs, n_new, label, layers: int, paged: bool):
    """Serve `reqs` after a warm-up request: the tokens, and the run's
    numbers, its launches held exactly to its rounds and prefills (a target
    prefill launches the 7 x layers + 1 int4_matmul of the prefill graph)."""
    server.submit(reqs[0][:8], 4).result(timeout=600)  # first use outside the clock
    st0 = server.stats()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    _zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    served = [f.result(timeout=900) for f in [server.submit(p, n_new) for p in reqs]]
    wall = time.perf_counter() - t0
    launches = _counts()
    st1 = server.stats()
    ticks, rounds, prefills = (st1[k] - st0[k] for k in ("ticks", "rounds", "prefills"))
    tokens = sum(len(x) - len(p) for x, p in zip(served, reqs))
    check(all(x[:len(p)] == p and len(x) == len(p) + n_new for x, p in zip(served, reqs)),
          f"{label}: a request came back short or altered")
    check(prefills == sum(len(p) > 1 for p in reqs),
          f"{label}: {prefills} prefills for {len(reqs)} prompts")
    want = {k: n * rounds for k, n in _spec_per_round(layers, paged).items()}
    want["int4_matmul"] += (7 * layers + 1) * prefills
    _check_routed(label, launches, want)
    check(all(launches[k] == n for k, n in want.items()),
          f"{label}: launches {launches}, not {want} ({rounds} rounds of "
          f"{_spec_per_round(layers, paged)}, {prefills} prefills)")
    return served, {"requests": len(reqs), "tokens": tokens, "wall_s": wall,
                    "tok_s": tokens / wall, "ticks": ticks, "rounds": rounds,
                    "ms_per_tick": 1e3 * wall / max(1, ticks), "prefills": prefills,
                    "accept_rate": st1["accept_rate"], "launches": launches,
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def _round_split(torch, server, paged: bool) -> dict:
    """One round of an idle server (8 slots spread over the cache, a free
    prompt) timed by CUDA events from the host and profiled: its gamma + 1
    draft steps and its verify apart, each one's device busy time and so
    the idle share."""
    from smelter_tpu_torch.serving.decode_server import _spec_round

    dev, g = server.device, SPEC_GAMMA
    tok = torch.ones(SLOTS, dtype=torch.int64, device=dev)
    pos = torch.tensor([0, 73, 127, 128, 292, 365, 438, 500], device=dev)
    toks = torch.ones(SLOTS, g + 1, dtype=torch.int64, device=dev)
    forced = torch.zeros(SLOTS, g, dtype=torch.int64, device=dev)
    if paged:
        server._table_d = torch.from_numpy(server._table).to(dev)
    parts = {
        "drafts": lambda *_: [server._draft_all(tok[:, None], (pos + j).clamp_min(0)[:, None])
                              for j in range(-1, g)],
        "verify": lambda *_: server._verify_all(toks, pos),
        "round": lambda *_: _spec_round(server._draft_all, server._verify_all, g, tok, tok, pos,
                                        forced, forced[:, 0], tok > 0)}
    with torch.inference_mode():
        return _timed_parts(torch, parts)


def _timed_parts(torch, parts: dict) -> dict:
    """Each part's ms a call by CUDA events from the host (5 calls), its
    device busy ms by torch.profiler, and so its idle share."""
    out = {}
    for name, run in parts.items():
        ms = time_ms(torch, run, 5, warmup=2)
        kernels, _, n_k = _profile(torch, run)
        busy = sum(kernels.values())
        out[name] = {"ms": ms, "device_busy_ms": busy, "idle_share": max(0.0, 1 - busy / ms),
                     "kernels": n_k}
    return out


def phase_spec(torch, np, stt, graphs: dict) -> dict:
    """Speculative decoding at llama_1b's width (int4-g128, int8 KV, bf16,
    ragged attention; gamma 4 and bench.py's tiny draft): (b) the 24-layer
    chunk-5 verify step against the port's CPU f32 run; (c)
    SpeculativeGenerator's greedy tokens equal FusedGenerator's in f32 on
    a 2-layer cut (tiny draft and self-draft), and at 24 layers in bf16 its
    ms a token, rounds and acceptance; (d) on a 2-layer f32 cut
    SpecDecodeServer (rounds 1 and 4) and SpecPagedDecodeServer give
    DecodeServer's tokens, then on the first SERVE_LAYERS layers in bf16
    each serves phase 7's 34 requests (SPEC_N_NEW tokens each) with its
    launches held exactly to its rounds, a round's time split into draft
    steps and verify; (e) BucketedDecodeServer with a 128-row plain bucket
    and a 512-row speculative one: routing, spill-up, and one upload of
    the weights. `graphs`: phase 7's step graphs at 24 and SERVE_LAYERS
    layers with their chunk twins, prefill graphs and 128-row step, which
    it empties."""
    from smelter_tpu_torch.runtime.generate import FusedGenerator
    from smelter_tpu_torch.runtime.speculative import SpeculativeGenerator
    from smelter_tpu_torch.serving.decode_server import (BucketedDecodeServer, DecodeServer,
                                                         SpecDecodeServer)
    from smelter_tpu_torch.serving.paged_server import SpecPagedDecodeServer

    res: dict = {}
    c = SPEC_GAMMA + 1
    cfg32 = stt.Config(compute_dtype="float32", ragged_attention=True)
    cfg16 = stt.Config(compute_dtype="bfloat16", ragged_attention=True)
    t0 = time.perf_counter()
    draft, dpfs = _draft_graphs()
    res["build_s"] = time.perf_counter() - t0
    step, chunk = graphs.pop("step24"), graphs.pop("chunk24")
    say(14, f"the draft ({SPEC_DRAFT}, seed 7, unquantized, bf16 KV) and its prefill graphs "
            f"built in {res['build_s']:.1f} s; phase 7's llama_1b step and chunk-{c} verify "
            "graphs")
    # (b) the verify step against the CPU
    res["verify_vs_cpu_f32"] = _check_static_step(torch, np, stt, chunk, phase=14)

    # (c) SpeculativeGenerator: f32 parity on a 2-layer cut, then 24 layers
    step2, pfs2, more2 = _static_graphs(2, chunk=c)
    prompt = list(range(1, 9))
    want = FusedGenerator(step2, cfg32).generate(prompt, 48)
    gens = {}
    for name, d in (("tiny draft", draft), ("self-draft", step2)):
        gen = SpeculativeGenerator(step2, more2["chunk"], d, cfg32)
        got = gen.generate(prompt, 48)
        check(got == want, f"SpeculativeGenerator ({name}) f32 tokens differ from "
                           f"FusedGenerator's: {got} != {want}")
        gens[name] = {"rounds": gen.last_rounds, "accept_rate": gen.last_accept_rate}
    res["generator_f32_2_layers"] = gens
    gen = SpeculativeGenerator(step, chunk, draft, cfg16)
    fused = FusedGenerator(step, cfg16)
    gen.generate(prompt, 8)  # first use outside the clock
    n = 64
    _zero_counts()
    t = time.perf_counter()
    out = gen.generate(prompt, n)
    wall = time.perf_counter() - t
    launches = _counts()
    per = _spec_per_round(LLAMA_1B["layers"], False)
    steps = len(prompt) - 1  # the prompt's target steps (no plain tail this far from max_len)
    want16 = fused.generate(prompt, n)
    r = {"n_new": n, "wall_s": wall, "ms_per_token": 1e3 * wall / n,
         "rounds": gen.last_rounds, "accept_rate": gen.last_accept_rate,
         "tokens_equal_fused_bf16": sum(a == b for a, b in zip(out[len(prompt):],
                                                             want16[len(prompt):])),
         "launches": launches}
    check(len(out) == len(prompt) + n, "SpeculativeGenerator output length")
    check(launches["int4_matmul"] == per["int4_matmul"] * (gen.last_rounds + steps)
          and launches["ragged_decode_attention"]
          == per["ragged_decode_attention"] * gen.last_rounds
          + LLAMA_1B["layers"] * steps + SPEC_DRAFT["layers"] * (len(prompt) - 1),
          f"SpeculativeGenerator launches {launches} ({gen.last_rounds} rounds, {steps} "
          "target steps)")
    del fused
    # where a round's time goes: gamma + 1 draft steps, the verify
    t_caches = [torch.zeros(s, dtype=d, device="cuda")
                for s, d in zip(gen._cshapes_t, gen._cdts_t)]
    d_caches = [torch.zeros(s, dtype=d, device="cuda")
                for s, d in zip(gen._cshapes_d, gen._cdts_d)]
    one = torch.ones(1, dtype=torch.int64, device="cuda")
    toks = torch.ones(c, dtype=torch.int64, device="cuda")
    r.update(_timed_parts(torch, {
        "drafts": lambda *_: [gen._draft(d_caches, one, 280 + j) for j in range(c)],
        "verify": lambda *_: gen._run(gen._chunk_t, gen._params_t, gen._in_c, gen._cn_t,
                                      t_caches, toks, 280)}))
    res["generator_bf16"] = r
    del gen, t_caches, d_caches, step, chunk
    torch.cuda.empty_cache()
    say(14, f"(c) SpeculativeGenerator f32, 2-layer cut: 48 tokens equal FusedGenerator's "
            f"with the tiny draft ({gens['tiny draft']['rounds']} rounds, acceptance "
            f"{gens['tiny draft']['accept_rate']:.3f}) and a self-draft "
            f"({gens['self-draft']['rounds']} rounds, acceptance "
            f"{gens['self-draft']['accept_rate']:.3f}) | 24 layers bf16, tiny draft: "
            f"{r['ms_per_token']:.2f} ms a token over {n} ({r['rounds']} rounds, acceptance "
            f"{r['accept_rate']:.3f}; {r['tokens_equal_fused_bf16']}/{n} tokens as "
            f"FusedGenerator's in bf16) | a round: {c} draft steps {r['drafts']['ms']:.2f} ms "
            f"(device busy {r['drafts']['device_busy_ms']:.3f}), verify "
            f"{r['verify']['ms']:.2f} ms (device busy {r['verify']['device_busy_ms']:.3f}) | "
            f"launches {launches}")

    # (d) the servers: f32 token parity on the 2-layer cut
    rng = np.random.default_rng(0)
    vocab = LLAMA_1B["vocab"]
    reqs = [[int(t) for t in rng.integers(1, vocab - 1, n_)]
            for n_ in rng.integers(8, min(48, PAGE * NPG // 4), 32)]
    reqs += [[int(t) for t in rng.integers(1, vocab - 1, n_)] for n_ in (100, 300)]
    few, n_few = reqs[:7] + reqs[32:33], 24
    plain = DecodeServer(step2, slots=SLOTS, config=cfg32, prefill_graphs=pfs2)
    try:
        want = [f.result(timeout=600) for f in [plain.submit(p, n_few) for p in few]]
    finally:
        plain.shutdown()
    paged2 = _llama_graph(2, chunk=c)
    parity = {}
    for name, make in (
            ("SpecDecodeServer rounds 1", lambda: SpecDecodeServer(
                step2, more2["chunk"], draft, slots=SLOTS, config=cfg32, prefill_graphs=pfs2,
                draft_prefill_graphs=dpfs)),
            ("SpecDecodeServer rounds 4", lambda: SpecDecodeServer(
                step2, more2["chunk"], draft, slots=SLOTS, config=cfg32, prefill_graphs=pfs2,
                draft_prefill_graphs=dpfs, rounds_per_tick=4)),
            ("SpecPagedDecodeServer", lambda: SpecPagedDecodeServer(
                paged2, draft, config=cfg32, prefill_graphs=pfs2, draft_prefill_graphs=dpfs))):
        server = make()
        try:
            got = [f.result(timeout=600) for f in [server.submit(p, n_few) for p in few]]
            st = server.stats()
        finally:
            server.shutdown()
        check(got == want, f"{name} f32 tokens differ from DecodeServer's")
        parity[name] = {"ticks": st["ticks"], "rounds": st["rounds"],
                        "accept_rate": st["accept_rate"]}
    res["servers_f32_2_layers"] = parity
    del paged2, step2, pfs2, more2
    say(14, f"(d) 2-layer cut, f32: {len(few)} requests x {n_few} tokens equal DecodeServer's "
            "from " + "; ".join(f"{k} ({v['ticks']} ticks, {v['rounds']} rounds)"
                                for k, v in parity.items()))

    # (d) timed on the first SERVE_LAYERS layers, bf16
    t0 = time.perf_counter()
    step4, pfs4, chunk4, short4 = (graphs.pop(k) for k in ("step4", "pfs4", "chunk4", "short4"))
    paged4 = _llama_graph(SERVE_LAYERS, chunk=c)
    res["serve_build_s"] = time.perf_counter() - t0
    runs = {}
    for name, make, paged in (
            ("rounds 1", lambda: SpecDecodeServer(
                step4, chunk4, draft, slots=SLOTS, config=cfg16, prefill_graphs=pfs4,
                draft_prefill_graphs=dpfs), False),
            ("rounds 4", lambda: SpecDecodeServer(
                step4, chunk4, draft, slots=SLOTS, config=cfg16, prefill_graphs=pfs4,
                draft_prefill_graphs=dpfs, rounds_per_tick=4), False),
            ("paged", lambda: SpecPagedDecodeServer(
                paged4, draft, config=cfg16, prefill_graphs=pfs4, draft_prefill_graphs=dpfs),
             True)):
        server = make()
        try:
            _, rr = _spec_serve(torch, server, reqs, SPEC_N_NEW, f"spec serving {name}",
                                SERVE_LAYERS, paged)
            rr["round_alone"] = _round_split(torch, server, paged)
        finally:
            server.shutdown()
        del server
        runs[name] = rr
        a = rr["round_alone"]
        say(14, f"(d) {'SpecPagedDecodeServer' if paged else 'SpecDecodeServer'} {name}, "
                f"{SERVE_LAYERS}-layer cut bf16 (paged verify graph built in "
                f"{res['serve_build_s']:.1f} s): "
                f"{rr['requests']} requests, {rr['tokens']} new tokens in {rr['wall_s']:.2f} s: "
                f"{rr['tok_s']:.1f} tok/s, {rr['ticks']} ticks at {rr['ms_per_tick']:.2f} ms, "
                f"{rr['rounds']} rounds, acceptance {rr['accept_rate']:.3f}, {rr['prefills']} "
                f"prefills, peak {rr['peak_mem_gb']:.3f} GB | a round alone "
                f"{a['round']['ms']:.2f} ms (device busy {a['round']['device_busy_ms']:.3f}, "
                f"idle share {100 * a['round']['idle_share']:.1f}%): {c} draft steps "
                f"{a['drafts']['ms']:.2f} ms (busy {a['drafts']['device_busy_ms']:.3f}), verify "
                f"{a['verify']['ms']:.2f} ms (busy {a['verify']['device_busy_ms']:.3f}) | "
                f"launches {rr['launches']}")
    res["serving"] = runs
    del paged4

    # (e) the bucket ladder: a 128-row plain bucket, a 512-row speculative one
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    ladder = BucketedDecodeServer([
        {"step": short4, "slots": SLOTS},
        {"step": step4, "chunk": chunk4, "draft": draft, "slots": SLOTS,
         "prefills": pfs4, "draft_prefills": dpfs}], config=cfg16)
    try:
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - before
        small, big = ladder._servers
        params = small.shared_weights()[0]
        check(params is big.shared_weights()[0], "the buckets hold two weight sets")
        big_ones = {}  # (shape, dtype) -> the names of the weights over 1 MB
        for k, v in params.items():
            if v.numel() * v.element_size() > 1 << 20:
                big_ones.setdefault((tuple(v.shape), v.dtype), []).append(k)
        dup = [(a, b) for names in big_ones.values() for i, a in enumerate(names)
               for b in names[i + 1:] if torch.equal(params[a], params[b])]
        check(not dup, f"BucketedDecodeServer holds weights twice: {dup[:5]}")
        params_b = sum(v.numel() * v.element_size() for v in params.values())
        caches_b = ladder.cache_bytes()
        check(held <= params_b + caches_b + (64 << 20),
              f"the ladder holds {held} bytes, over its weights {params_b} and caches {caches_b}")
        short = ladder.submit(reqs[0], 16).result(timeout=600)
        steps_small, rounds_big = small.stats()["steps"], big.stats()["rounds"]
        check(len(short) == len(reqs[0]) + 16 and steps_small > 0 and rounds_big == 0,
              "a short request did not go to the 128-row bucket")
        long = ladder.submit(reqs[32], 40).result(timeout=600)
        check(len(long) == len(reqs[32]) + 40 and big.stats()["rounds"] > 0
              and small.stats()["steps"] == steps_small,
              "a 140-token request did not go to the 512-row bucket")
        small.stats = lambda: {"active": SLOTS, "queued": 0, "slots": SLOTS}  # as if full
        rounds_big = big.stats()["rounds"]
        spilled = ladder.submit(reqs[1], 16).result(timeout=600)
        check(len(spilled) == len(reqs[1]) + 16 and big.stats()["rounds"] > rounds_big,
              "a short request did not spill up from a full 128-row bucket")
        res["ladder"] = {"held_gb": held / 1e9, "params_gb": params_b / 1e9,
                         "cache_gb": caches_b / 1e9,
                         "uniform_cache_gb": ladder.uniform_cache_bytes() / 1e9}
    finally:
        ladder.shutdown()
    del ladder, step4, pfs4, chunk4, short4, draft, dpfs
    torch.cuda.empty_cache()
    e = res["ladder"]
    say(14, f"(e) BucketedDecodeServer, {SERVE_LAYERS}-layer cut (a 128-row plain bucket and "
            f"a 512-row speculative one, {SLOTS} slots each): the ladder holds "
            f"{e['held_gb']:.3f} GB on the card, its weights {e['params_gb']:.3f} GB once and "
            f"caches {e['cache_gb']:.3f} GB (flat at 512 rows: {e['uniform_cache_gb']:.3f} GB "
            "of target caches) | a short request went to the 128-row bucket, a 140-token one "
            "to the 512-row bucket, a short one spilled up from a full 128-row bucket")
    return res


# -- phase 8 ---------------------------------------------------------------

def _vit_graph(batch: int):
    """ViT-B/16 (VIT_B16, random weights from seed 0) at `batch`: the class
    token's Expand pins the graph to its batch."""
    from smelter_tpu_torch.models import vit

    return vit.build(batch=batch, seed=0, **VIT_B16)[0]


# The symbols of the transformer kernels (csrc/vit_block.cu, gemm.cuh,
# layer_norm.cuh, attention.cuh, flash_attention.cu, attention_short.cu), as
# the profiler names them (library kernels also hold "gemm" and "attention").
_PORT_VIT_KERNEL = re.compile(r"(smelter|\(anonymous namespace\))::(gemm_mma|gemm_f32|"
                              r"attention_mma|attention_rows|flash_mma|short_mma|"
                              r"layer_norm_rows)<")


def _vit_forward(torch, np, model, xg, label: str, routed: dict) -> dict:
    """One forward of a compiled ViT-B/16 at xg's batch with the launch check
    (exactly `routed` launches, no other kernel), then images/s over 20
    forwards by CUDA events, peak memory and a profile of 3 forwards."""
    batch = xg.shape[0]
    _zero_counts()
    logits = model.run_device(xg)[0].float().cpu().numpy()
    launches = _counts()
    check(all(n == 0 for k, n in launches.items() if k not in routed),
          f"{label}: a kernel other than {set(routed)} launched ({launches})")
    for k, want in routed.items():
        check(launches[k] == want, f"{label}: {k} launched {launches[k]} times, not {want}")
    check(logits.shape == (batch, VIT_B16["num_classes"]) and np.isfinite(logits).all(),
          f"{label}: logits")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(torch, lambda i: model.run_device(xg), 20)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    per, by_op, n_k = _profile(torch, lambda: model.run_device(xg))
    busy = sum(per.values())
    ours = {k: v for k, v in per.items() if _PORT_VIT_KERNEL.search(k)}
    return {"launches": launches, "step_ms": step_ms, "images_per_s": batch * 1e3 / step_ms,
            "peak_mem_gb": peak_gb, "device_busy_ms": busy,
            "idle_share": max(0.0, 1 - busy / step_ms), "kernels_per_forward": n_k,
            "port_kernel_ms": sum(ours.values()),
            "top_kernels_ms": sorted(per.items(), key=lambda kv: -kv[1])[:8],
            "top_host_ops_ms": sorted(by_op.items(), key=lambda kv: -kv[1])[:8],
            "logits": logits}


def phase_vit(torch, np, stt) -> dict:
    """ViT-B/16 at full width and depth: (a) batch 8 on the card in f32
    against the port's CPU f32 run, and in bf16; (b) the default bf16
    configuration at batch 128; (c) `use_pallas=True`; (d) the graph without
    passes under `fused_layernorm=True`, as bench.py's baseline compiles it;
    (e) `serve(...)`. Returns the report and the batch-128 graph without
    passes."""
    import copy

    from smelter_tpu_torch.runtime.executor import CompiledModel

    res: dict = {}
    x = np.random.default_rng(0).standard_normal(
        (VIT_BATCH, 3, VIT_B16["image_size"], VIT_B16["image_size"])).astype(np.float32)
    layers = VIT_B16["depth"]

    # (a) batch 8: f32 on the card (TF32 off) against the CPU's f32 run
    t0 = time.perf_counter()
    g8 = _vit_graph(8)
    res["build_b8_s"] = time.perf_counter() - t0
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    ref = stt.compile(copy.deepcopy(g8), stt.Config(), device="cpu")(x[:8])[0]
    ref16 = stt.compile(copy.deepcopy(g8), stt.Config(compute_dtype="bfloat16"),
                        device="cpu")(x[:8])[0]
    cpu_s = time.perf_counter() - t0
    out = {}
    for label, cfg in (("f32", stt.Config()), ("bf16", stt.Config(compute_dtype="bfloat16"))):
        model = stt.compile(copy.deepcopy(g8), cfg, device="cuda")
        _zero_counts()
        out[label] = model(x[:8])[0]
        launches = _counts()
        _check_routed(f"ViT b8 {label}", launches, "vit_attention_block")
        check(launches["vit_attention_block"] == layers,
              f"ViT b8 {label}: {launches['vit_attention_block']} block launches")
        del model
    torch.backends.cudnn.allow_tf32 = True
    scale = float(np.abs(ref).max())
    top2 = np.sort(ref, axis=1)[:, -2:]
    gap = top2[:, 1] - top2[:, 0]
    err32 = float(np.abs(out["f32"] - ref).max())
    err16 = float(np.abs(out["bf16"] - ref).max())
    err_cpu16 = float(np.abs(ref16 - ref).max())
    for label in out:
        check(out[label].shape == ref.shape and np.isfinite(out[label]).all(),
              f"ViT b8 {label} logits")
    # f32 on the card sums in other orders than the CPU, through 12 blocks,
    # cuBLAS MLP products and cuDNN's patch conv, all in full f32: 1e-3.
    check(err32 <= 1e-3 * scale, f"ViT b8 f32: max-abs {err32} > 1e-3 x {scale}")
    # bf16 on the card (the gemm_mma / attention_mma kernels) is held to 3x
    # the port's own CPU bf16 error against f32, as phase 7 holds the decode
    # step; the bound is fixed by the CPU run, not by the card's error.
    limit16 = 3 * err_cpu16
    check(err16 <= limit16, f"ViT b8 bf16: max-abs {err16} > 3 x the CPU bf16's {err_cpu16}")
    agree16 = out["bf16"].argmax(1) == ref.argmax(1)
    clear = gap > 2 * err16
    check(bool(agree16[clear].all()), f"ViT b8 bf16: top-1 differs on a clear row "
                                      f"(gaps {gap.tolist()}, error {err16})")
    # bf16 logits of two routes at batch 128 may differ by what one route
    # may differ from f32 at batch 8.
    bound16 = limit16
    res["b8"] = {"max_abs_ref": scale, "f32_max_abs_err": err32, "bf16_max_abs_err": err16,
                 "cpu_bf16_max_abs_err": err_cpu16, "bf16_limit": limit16,
                 "gaps": gap.tolist(), "bf16_top1_agree": float(agree16.mean()),
                 "clear_rows": int(clear.sum()), "cpu_s": cpu_s, "bf16_bound_b128": bound16}
    say(8, f"(a) ViT-B/16 batch 8 vs the CPU's f32 run (max|ref| {scale:.4g}, CPU f32 and "
           f"bf16 {cpu_s:.1f} s, graph built in {res['build_b8_s']:.1f} s): card f32 max-abs "
           f"{err32:.4g} (bound {1e-3 * scale:.4g}); bf16 max-abs {err16:.4g} (bound 3 x the "
           f"CPU bf16's {err_cpu16:.4g} = {limit16:.4g}), top-1 {int(agree16.sum())}/8 "
           f"(clear rows {int(clear.sum())}) | {layers} vit_attention_block launches a forward")

    # (b) the default bf16 configuration at batch 128
    t0 = time.perf_counter()
    g = _vit_graph(VIT_BATCH)
    raw = copy.deepcopy(g)
    res["build_s"] = time.perf_counter() - t0
    xg = torch.from_numpy(x).cuda()
    runs = {}
    for label, make, routed in (
            ("default", lambda: stt.compile(copy.deepcopy(g), stt.Config(compute_dtype="bfloat16"),
                                            device="cuda"),
             {"vit_attention_block": layers}),
            ("use_pallas", lambda: stt.compile(g, stt.Config(compute_dtype="bfloat16",
                                                             use_pallas=True), device="cuda"),
             {"vit_attention_block": layers, "residual_layer_norm": layers + 1}),
            ("raw_fused_layernorm", lambda: CompiledModel(raw, stt.Config(
                compute_dtype="bfloat16", fused_layernorm=True)),
             {"fused_layer_norm": 2 * layers + 1})):
        t0 = time.perf_counter()
        model = make()
        compile_s = time.perf_counter() - t0
        r = _vit_forward(torch, np, model, xg, f"ViT {label}", routed)
        r["compile_s"] = compile_s
        if runs:
            base = runs["default"]["logits"]
            r["max_abs_vs_default"] = float(np.abs(r["logits"] - base).max())
            r["top1_vs_default"] = _top1(r["logits"], base)
            check(r["max_abs_vs_default"] <= bound16,
                  f"ViT {label}: logits {r['max_abs_vs_default']} from the default's "
                  f"(bound {bound16})")
        runs[label] = r
        del model
        torch.cuda.empty_cache()
        vs = (f" | vs default: max-abs {r['max_abs_vs_default']:.4g} (bound {bound16:.4g}), "
              f"top-1 {r['top1_vs_default']:.4f}" if "max_abs_vs_default" in r else "")
        say(8, f"({'bcd'[len(runs) - 1]}) {label} bf16 batch {VIT_BATCH}: "
               f"{r['images_per_s']:.1f} images/s, step {r['step_ms']:.3f} ms, idle share "
               f"{100 * r['idle_share']:.1f}% (profiled busy {r['device_busy_ms']:.3f} ms, "
               f"~{r['kernels_per_forward']:.0f} kernels), port kernels "
               f"{r['port_kernel_ms']:.3f} ms, peak {r['peak_mem_gb']:.2f} GB, compiled in "
               f"{compile_s:.1f} s | launches {r['launches']}" + vs)
        say(8, "  device ms a forward by host op: "
               + "; ".join(f"{k} {v:.3f}" for k, v in r["top_host_ops_ms"]))
        say(8, "  device ms a forward by kernel: "
               + "; ".join(f"{k[:50]} {v:.3f}" for k, v in r["top_kernels_ms"][:6]))
    zoo = copy.deepcopy(raw)  # for phase 10's fuse_mlp_block run
    del g, raw, xg
    for r in runs.values():
        r.pop("logits")
    res.update(runs)

    # (e) serve(...): 32 threaded requests, max_batch 16, one bucket of 16 (the
    # graph's Expand pins its batch), against the direct forward
    g16 = _vit_graph(16)
    cfg = stt.Config(compute_dtype="bfloat16")
    xs = x[:32]
    direct_model = stt.compile(copy.deepcopy(g16), cfg, device="cuda")
    direct = np.concatenate([direct_model(xs[:16])[0], direct_model(xs[16:])[0]])
    del direct_model
    _zero_counts()
    server = stt.serve(g16, cfg, device="cuda", max_batch=16, buckets=(16,))
    results = [None] * len(xs)
    try:
        check(server.wait_ready(600), "ViT server bucket did not warm up")

        def ask(i):
            results[i] = server.infer(xs[i])[0]

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(len(xs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        stats = server.stats()
    finally:
        server.shutdown()
    launches = _counts()
    _check_routed("ViT server", launches, "vit_attention_block")
    check(all(r is not None for r in results), "ViT server left requests unanswered")
    got = np.stack(results)
    err = float(np.abs(got - direct).max())
    dscale = float(np.abs(direct).max())
    check(stats["requests"] == 32 and stats["errors"] == 0, f"ViT server stats {stats}")
    check(err <= 5e-2 * dscale, f"ViT served vs direct: max-abs {err} > 5e-2 x {dscale}")
    res["serve"] = {"launches": launches, "stats": stats, "max_abs_vs_direct": err,
                    "top1_vs_direct": _top1(got, direct)}
    say(8, f"(e) served {stats['requests']} requests in {stats['batches']} batches of up to "
           f"16, launches {launches} (bucket warm-up included) | p50 "
           f"{stats['latency_ms_p50']:.1f} ms, p95 {stats['latency_ms_p95']:.1f} ms | vs direct: "
           f"max-abs {err:.3g} (bound 5e-2 x {dscale:.3g}), top-1 "
           f"{res['serve']['top1_vs_direct']:.4f}")
    return res, zoo


# -- phase 9 ---------------------------------------------------------------

# The symbols of csrc/pixel_conv.cu's and csrc/max_unpool.cu's kernels, as
# the profiler names them.
_PORT_IMAGE_KERNEL = re.compile(r"pixel_conv_mma|pixel_conv_f32|max_unpool2x2_kernel")


def _image_forward(torch, np, model, xg, label: str, batch: int, routed: dict,
                   iters: int, port_re=_PORT_IMAGE_KERNEL) -> dict:
    """One forward with the launch check (exactly `routed`, no other kernel),
    then images/s over `iters` forwards by CUDA events, peak memory and a
    profile of 2 forwards; `port_re` names the port's kernels in it."""
    gc.collect()
    torch.cuda.empty_cache()
    _zero_counts()
    out = model.run_device(xg)[0].float().cpu().numpy()
    launches = _counts()
    for k, want in routed.items():
        check(launches[k] == want, f"{label}: {k} launched {launches[k]} times, not {want}")
    check(all(n == 0 for k, n in launches.items() if k not in routed),
          f"{label}: a kernel other than {set(routed)} launched ({launches})")
    check(np.isfinite(out).all(), f"{label}: outputs not finite")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(torch, lambda i: model.run_device(xg), iters, warmup=1)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counts: dict = {}
    per, by_op, n_k = _profile(torch, lambda: model.run_device(xg), steps=2, counts=counts)
    busy = sum(per.values())
    ours = {k: v for k, v in per.items() if port_re.search(k)}
    return {"launches": launches, "step_ms": step_ms, "images_per_s": batch * 1e3 / step_ms,
            "kernel_counts": counts,
            "peak_mem_gb": peak_gb, "device_busy_ms": busy,
            "idle_share": max(0.0, 1 - busy / step_ms), "kernels_per_forward": n_k,
            "port_kernel_ms": sum(ours.values()),
            "top_kernels_ms": sorted(per.items(), key=lambda kv: -kv[1])[:8],
            "top_host_ops_ms": sorted(by_op.items(), key=lambda kv: -kv[1])[:8],
            "host_ops_ms": by_op, "out": out}


def _say_run(label: str, r: dict, extra: str = "", phase: int = 9) -> None:
    say(phase, f"{label}: {r['images_per_s']:.2f} images/s, step {r['step_ms']:.2f} ms, idle share "
           f"{100 * r['idle_share']:.1f}% (profiled busy {r['device_busy_ms']:.2f} ms, "
           f"~{r['kernels_per_forward']:.0f} kernels), port kernels "
           f"{r['port_kernel_ms']:.2f} ms, peak {r['peak_mem_gb']:.2f} GB | launches "
           f"{ {k: v for k, v in r['launches'].items() if v} }" + extra)
    say(phase, "  device ms a forward by host op: "
               + "; ".join(f"{k} {v:.3f}" for k, v in r["top_host_ops_ms"]))
    say(phase, "  device ms a forward by kernel: "
               + "; ".join(f"{k[:60]} {v:.3f}" for k, v in r["top_kernels_ms"][:6]))


def _serve_check(torch, np, stt, g, cfg, xs, batch: int, direct, bound_abs: float, label: str,
                 routed, phase: int = 9) -> dict:
    """serve(...) with one bucket of the graph's batch answers len(xs)
    threaded requests within `bound_abs` of the direct forward. `routed`:
    the kernel (or set of kernels) the served forwards launch."""
    _zero_counts()
    server = stt.serve(g, cfg, optimize=False, device="cuda", max_batch=batch,
                       buckets=(batch,))
    results = [None] * len(xs)
    try:
        check(server.wait_ready(600), f"{label} server bucket did not warm up")

        def ask(i):
            results[i] = server.infer(xs[i])[0]

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(len(xs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        stats = server.stats()
    finally:
        server.shutdown()
    launches = _counts()
    _check_routed(f"{label} server", launches, routed)
    check(all(r is not None for r in results), f"{label} server left requests unanswered")
    err = float(np.abs(np.stack(results) - direct).max())
    check(stats["requests"] == len(xs) and stats["errors"] == 0, f"{label} server stats {stats}")
    check(err <= bound_abs, f"{label} served vs direct: max-abs {err} > {bound_abs}")
    names = {routed} if isinstance(routed, str) else set(routed)
    say(phase, f"{label} server: {stats['requests']} requests in {stats['batches']} batches of "
               f"up to {batch}, p50 {stats['latency_ms_p50']:.1f} ms, p95 "
               f"{stats['latency_ms_p95']:.1f} ms | vs direct: max-abs {err:.3g} (bound "
               f"{bound_abs:.3g}) | launches { {k: launches[k] for k in sorted(names)} }")
    return {"launches": launches, "stats": stats, "max_abs_vs_direct": err}


def _int8_edges(torch, np, stt, gq, x, device: str) -> dict:
    """Every int8 edge of the int8-pixel graph `gq` on `device`, on the host."""
    from smelter_tpu_torch.runtime.executor import Executor

    ex = Executor(gq, stt.Config(device=device))
    env = ex.build_fn(return_all_edges=True)(ex.cast_params(ex.init_params()), x)
    return {k: v.cpu().numpy() for k, v in env.items()
            if isinstance(v, torch.Tensor) and v.dtype == torch.int8 and k not in gq.initializers}


def phase_esrgan(torch, np, stt) -> dict:
    """ESRGAN x4: (a) gates at batch 1 and the zoo's depth 4, against the
    port's CPU runs of the same graphs: f32 on the card, bf16 within 3x the
    CPU bf16's own error, and int8-pixel (calibrated on the CPU) edge for
    edge; (b) at RealESRGAN_x4plus's depth 23 and batch 8: images/s of the
    default bf16 routing (349 pixel_conv_rowdot a forward), int8-pixel
    calibrated on the card (349 pixel_conv_rowdot_q), and the graph without
    passes (cuDNN's convs); (c) serve(...)."""
    import copy

    from smelter_tpu_torch.models import esrgan
    from smelter_tpu_torch.runtime.executor import CompiledModel

    res: dict = {}
    n_pc = 15 * ESRGAN["nb"] + 4
    side_px = ESRGAN["image_size"]
    x = np.random.default_rng(0).standard_normal(
        (ESRGAN_BATCH, 3, side_px, side_px)).astype(np.float32)
    build = dict(nf=ESRGAN["nf"], scale=ESRGAN["scale"], image_size=side_px, seed=0)

    # (a) gates at batch 1, depth 4: 15 x 4 + 4 = 64 PixelConv
    t0 = time.perf_counter()
    g1 = esrgan.build(batch=1, nb=ESRGAN_GATE_NB, **build)[0]
    n_gate = 15 * ESRGAN_GATE_NB + 4
    x1 = x[:1]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu32 = stt.compile(copy.deepcopy(g1), stt.Config(), device="cpu")
    ref = cpu32(x1)[0]
    ref16 = stt.compile(copy.deepcopy(g1), stt.Config(compute_dtype="bfloat16"),
                        device="cpu")(x1)[0]
    gq = stt.compile(copy.deepcopy(g1), quant="int8-pixel", calibration_data=[(x1,)],
                     device="cpu").graph
    refq = CompiledModel(copy.deepcopy(gq), stt.Config(device="cpu"))(x1)[0]
    edges_cpu = _int8_edges(torch, np, stt, copy.deepcopy(gq), x1, "cpu")
    cpu_s = time.perf_counter() - t0
    scale = float(np.abs(ref).max())
    out = {}
    for label, cfg, routed in (("f32", stt.Config(), "pixel_conv_rowdot"),
                               ("bf16", stt.Config(compute_dtype="bfloat16"),
                                "pixel_conv_rowdot")):
        model = stt.compile(copy.deepcopy(g1), cfg, device="cuda")
        _zero_counts()
        out[label] = model(x1)[0]
        launches = _counts()
        _check_routed(f"ESRGAN b1 {label}", launches, routed)
        check(launches[routed] == n_gate, f"ESRGAN b1 {label}: {launches[routed]} launches")
        del model
    _zero_counts()
    outq = CompiledModel(copy.deepcopy(gq), stt.Config(device="cuda"))(x1)[0]
    launches = _counts()
    _check_routed("ESRGAN b1 int8-pixel", launches, "pixel_conv_rowdot_q")
    check(launches["pixel_conv_rowdot_q"] == n_gate, f"ESRGAN b1 int8-pixel: {launches}")
    edges_gpu = _int8_edges(torch, np, stt, copy.deepcopy(gq), x1, "cuda")
    torch.backends.cudnn.allow_tf32 = True
    for label, o in list(out.items()) + [("int8-pixel", outq)]:
        check(o.shape == ref.shape == (1, 3, 4 * side_px, 4 * side_px) and np.isfinite(o).all(),
              f"ESRGAN b1 {label} output")
    err32 = float(np.abs(out["f32"] - ref).max())
    err16 = float(np.abs(out["bf16"] - ref).max())
    err_cpu16 = float(np.abs(ref16 - ref).max())
    errq = float(np.abs(outq - refq).max())
    # f32: the card's kernels and cuDNN in full f32 against the CPU, sums in
    # other orders through 66 convs: 1e-3 of the largest output.
    check(err32 <= 1e-3 * scale, f"ESRGAN b1 f32: max-abs {err32} > 1e-3 x {scale}")
    # bf16: 3x the port's own CPU bf16 error against f32, as phase 8.
    check(err16 <= 3 * err_cpu16, f"ESRGAN b1 bf16: max-abs {err16} > 3 x {err_cpu16}")
    # int8-pixel: the same graph and scales; the int8 edges are equal but
    # where the f32 value before a requant lies within the sum-order noise
    # of a half-way point: such flips move an element one step, in at most
    # 1e-3 of the elements, and the outputs stay within 1e-2 of the largest.
    check(set(edges_cpu) == set(edges_gpu) and edges_cpu, "int8 edges differ in name")
    n_el = sum(a.size for a in edges_cpu.values())
    n_flip = sum(int((edges_cpu[k] != edges_gpu[k]).sum()) for k in edges_cpu)
    max_step = max(int(np.abs(edges_cpu[k].astype(np.int32) - edges_gpu[k]).max())
                   for k in edges_cpu)
    scale_q = float(np.abs(refq).max())
    check(max_step <= 1 and n_flip <= 1e-3 * n_el,
          f"ESRGAN b1 int8-pixel: {n_flip} of {n_el} int8 elements differ, by up to {max_step}")
    check(errq <= 1e-2 * scale_q, f"ESRGAN b1 int8-pixel: max-abs {errq} > 1e-2 x {scale_q}")
    res["gates"] = {"depth": ESRGAN_GATE_NB, "max_abs_ref": scale, "f32_max_abs_err": err32,
                    "bf16_max_abs_err": err16, "cpu_bf16_max_abs_err": err_cpu16,
                    "int8_max_abs_err": errq, "int8_max_abs_ref": scale_q,
                    "int8_elements": n_el, "int8_flips": n_flip, "int8_max_step": max_step,
                    "int8_vs_f32_cpu": float(np.abs(refq - ref).max()), "cpu_s": cpu_s}
    say(9, f"(a) ESRGAN x4 depth {ESRGAN_GATE_NB} batch 1 vs the CPU's runs (max|ref| "
           f"{scale:.4g}, CPU runs {cpu_s:.1f} s): f32 max-abs {err32:.4g} (bound "
           f"{1e-3 * scale:.4g}); bf16 {err16:.4g} (bound 3 x the CPU bf16's {err_cpu16:.4g}); "
           f"int8-pixel {errq:.4g} (bound {1e-2 * scale_q:.4g}), int8 edges: {n_flip} of "
           f"{n_el} differ, by up to {max_step} (bound 1 step, 1e-3 of them); int8 vs f32 on "
           f"the CPU {res['gates']['int8_vs_f32_cpu']:.4g} | {n_gate} launches a forward")
    del cpu32, edges_cpu, edges_gpu
    bound16_rel = 3 * err_cpu16 / scale

    # (b) depth 23, batch 8
    t0 = time.perf_counter()
    g = esrgan.build(batch=ESRGAN_BATCH, nb=ESRGAN["nb"], **build)[0]
    raw = copy.deepcopy(g)
    res["build_s"] = time.perf_counter() - t0
    xg = torch.from_numpy(x).cuda()
    runs = {}
    cfg16 = stt.Config(compute_dtype="bfloat16")
    for label, make, routed in (
            ("default", lambda: stt.compile(copy.deepcopy(g), cfg16, device="cuda"),
             {"pixel_conv_rowdot": n_pc}),
            ("int8_pixel", lambda: stt.compile(copy.deepcopy(g), cfg16, quant="int8-pixel",
                                               calibration_data=[(x,)], device="cuda"),
             {"pixel_conv_rowdot_q": n_pc}),
            ("raw", lambda: CompiledModel(raw, cfg16), {})):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = make()
        compile_s = time.perf_counter() - t0
        compile_peak = torch.cuda.max_memory_allocated() / 1e9
        r = _image_forward(torch, np, model, xg, f"ESRGAN {label}", ESRGAN_BATCH, routed, 5)
        r["compile_s"], r["compile_peak_mem_gb"] = compile_s, compile_peak
        if label == "int8_pixel":
            res["int8_graph"] = model.graph
        extra = ""
        if runs:
            base = runs["default"]["out"]
            r["max_abs_vs_default_rel"] = float(np.abs(r["out"] - base).max()
                                                / np.abs(base).max())
            # reported, not gated: no CPU run stands beside depth 23; the
            # gates of (a) hold each routing to the CPU at depth 4
            extra = (f" | vs default: max-abs {r['max_abs_vs_default_rel']:.4g} of the largest "
                     f"output")
        runs[label] = r
        _say_run(f"(b) ESRGAN x4 depth {ESRGAN['nb']} batch {ESRGAN_BATCH} {label} "
                 f"(compiled in {compile_s:.1f} s, peak {compile_peak:.2f} GB)", r, extra)
        if label != "default":
            del model
        else:
            direct_model = model
    res.update(runs)

    # (c) serve(...): one batch of 8 requests against the direct forward
    direct = runs["default"]["out"]
    del direct_model
    gc.collect()
    torch.cuda.empty_cache()
    g_served = copy.deepcopy(g)
    from smelter_tpu_torch.api import _prepare

    g_served = _prepare(g_served, None, True)
    # the served batch is the direct forward's: within the bf16 bound of (a)
    res["serve"] = _serve_check(torch, np, stt, g_served, cfg16, x, ESRGAN_BATCH, direct,
                                bound16_rel * float(np.abs(direct).max()), "(c) ESRGAN",
                                "pixel_conv_rowdot")
    gq8 = res.pop("int8_graph")
    res["serve_int8"] = _serve_check(torch, np, stt, gq8, cfg16, x, ESRGAN_BATCH,
                                     runs["int8_pixel"]["out"],
                                     bound16_rel * float(np.abs(runs["int8_pixel"]["out"]).max()),
                                     "(c) ESRGAN int8-pixel", "pixel_conv_rowdot_q")
    for r in runs.values():
        r.pop("out")
    del g, raw, xg, g_served, gq8
    return res


def _walk_with(torch, stt, g, x, fixed: dict) -> dict:
    """Every edge of the f32 walk of `g` on the CPU, the edges in `fixed`
    replaced by the given tensors right after the node that makes them."""
    from smelter_tpu_torch.ops.registry import Ctx, lower_node
    from smelter_tpu_torch.runtime.executor import Executor

    ex = Executor(g, stt.Config(device="cpu"))
    params = ex.cast_params(ex.init_params())
    env = {name: params[name] for name in ex.param_names}
    env[g.input_names[0]] = torch.from_numpy(x)
    ctx = Ctx(g, env, ex.config, device="cpu")
    with torch.inference_mode():
        for node in g.nodes:
            lower_node(ctx, node)
            env.update({o: fixed[o] for o in node.outputs if o in fixed})
    return env


def phase_segnet(torch, np, stt) -> dict:
    """SegNet (base 32, depth 3, 2 classes, 256 px): (d) batch 16 on the card
    in f32 against the port's CPU f32 walk on the card's pool indices, which
    equal the CPU's own but at near-ties, and in bf16 within 3x the CPU
    bf16's own error; (e) images/s of the default bf16 routing (3
    max_unpool2x2 a forward) and of the graph without passes; (f)
    serve(...)."""
    import copy

    from smelter_tpu_torch.models import segnet
    from smelter_tpu_torch.runtime.executor import CompiledModel, Executor

    res: dict = {}
    side_px = SEGNET["image_size"]
    x = np.random.default_rng(1).standard_normal(
        (SEGNET_BATCH, 3, side_px, side_px)).astype(np.float32)
    t0 = time.perf_counter()
    g = segnet.build(batch=SEGNET_BATCH, image_size=side_px, base=SEGNET["base"],
                     depth=SEGNET["depth"], num_classes=SEGNET["num_classes"], seed=0)[0]
    raw = copy.deepcopy(g)
    res["build_s"] = time.perf_counter() - t0

    # (a) f32 and bf16 against the CPU, every edge of the f32 runs kept
    torch.backends.cudnn.allow_tf32 = False
    gp = stt.compile(copy.deepcopy(g), stt.Config(), device="cpu").graph
    pools = [n for n in gp.nodes if n.op_type == "MaxPool" and len(n.outputs) > 1]
    envs = {}
    for dev in ("cpu", "cuda"):
        ex = Executor(copy.deepcopy(gp), stt.Config(device=dev))
        _zero_counts()
        env = ex.build_fn(return_all_edges=True)(ex.cast_params(ex.init_params()), x)
        if dev == "cuda":
            _check_routed("SegNet f32", _counts(), "max_unpool2x2")
        envs[dev] = {k: v.cpu() for k, v in env.items() if isinstance(v, torch.Tensor)}
        del env, ex
    # the CPU's f32 walk again, each pool's indices taken from the card's
    # run: the same function of the same pool decisions
    envs["cpu_card_idx"] = _walk_with(torch, stt, gp, x, {
        n.outputs[1]: envs["cuda"][n.outputs[1]] for n in pools})
    ref16 = stt.compile(copy.deepcopy(g), stt.Config(compute_dtype="bfloat16"),
                        device="cpu")(x)[0]
    m16 = stt.compile(copy.deepcopy(g), stt.Config(compute_dtype="bfloat16"), device="cuda")
    got16 = m16(x)[0]
    del m16
    torch.backends.cudnn.allow_tf32 = True
    out_name = gp.output_names[0]
    ref, got32 = envs["cpu"][out_name].numpy(), envs["cuda"][out_name].numpy()
    ref_same = envs["cpu_card_idx"][out_name].numpy()
    scale = float(np.abs(ref).max())
    err32 = float(np.abs(got32 - ref_same).max())
    err32_own = float(np.abs(got32 - ref).max())
    err16 = float(np.abs(got16 - ref).max())
    err_cpu16 = float(np.abs(ref16 - ref).max())
    # The indices: equal, but where a window's two largest values lie within
    # the f32 sum-order noise of each other (1e-5 of the largest input); a
    # flipped index moves its value a pixel, so the outputs are compared
    # with the CPU's walk on the card's indices.
    idx = {}
    for node in pools:
        a, b = envs["cpu"][node.outputs[1]], envs["cuda"][node.outputs[1]]
        check(a.dtype == b.dtype == torch.int64, "SegNet: indices are not int64")
        xin = envs["cpu"][node.inputs[0]].reshape(-1)
        diff = a != b
        near = (xin[a[diff]] - xin[b[diff]]).abs().max().item() if diff.any() else 0.0
        idx[node.outputs[1]] = {"count": a.numel(), "differ": int(diff.sum()),
                                "max_gap_where_differ": near}
        check(near <= 1e-5 * xin.abs().max().item(),
              f"SegNet: indices {node.outputs[1]} differ at windows {near} apart")
    del envs
    check(err32 <= 1e-3 * scale, f"SegNet f32: max-abs {err32} > 1e-3 x {scale}")
    check(err16 <= 3 * err_cpu16, f"SegNet bf16: max-abs {err16} > 3 x {err_cpu16}")
    res["gates"] = {"max_abs_ref": scale, "f32_max_abs_err": err32,
                    "f32_max_abs_err_own_indices": err32_own, "bf16_max_abs_err": err16,
                    "cpu_bf16_max_abs_err": err_cpu16, "indices": idx}
    say(9, f"(d) SegNet batch {SEGNET_BATCH} {side_px} px vs the CPU's f32 run (max|ref| "
           f"{scale:.4g}): f32 max-abs {err32:.4g} on the card's indices (bound "
           f"{1e-3 * scale:.4g}; {err32_own:.4g} on the CPU's own); bf16 {err16:.4g} (bound "
           f"3 x the CPU bf16's {err_cpu16:.4g}); indices differ at "
           + ", ".join(f"{v['differ']} of {v['count']}" for v in idx.values())
           + " (only at near-ties, 1e-5 of the largest input)")

    # (b) images/s
    xg = torch.from_numpy(x).cuda()
    cfg16 = stt.Config(compute_dtype="bfloat16")
    runs = {}
    for label, make, routed in (
            ("default", lambda: stt.compile(copy.deepcopy(g), cfg16, device="cuda"),
             {"max_unpool2x2": 3}),
            ("raw", lambda: CompiledModel(raw, cfg16), {"max_unpool2x2": 3})):
        t0 = time.perf_counter()
        model = make()
        compile_s = time.perf_counter() - t0
        r = _image_forward(torch, np, model, xg, f"SegNet {label}", SEGNET_BATCH, routed, 20)
        r["compile_s"] = compile_s
        extra = ""
        if runs:
            base = runs["default"]["out"]
            r["max_abs_vs_default"] = float(np.abs(r["out"] - base).max())
            extra = f" | vs default: max-abs {r['max_abs_vs_default']:.4g}"
        runs[label] = r
        _say_run(f"(e) SegNet batch {SEGNET_BATCH} {label} (compiled in {compile_s:.1f} s)",
                 r, extra)
        del model
    res.update(runs)
    direct = runs["default"]["out"]
    from smelter_tpu_torch.api import _prepare

    res["serve"] = _serve_check(torch, np, stt, _prepare(copy.deepcopy(g), None, True), cfg16,
                                x, SEGNET_BATCH, direct, 3 * err_cpu16, "(f) SegNet",
                                "max_unpool2x2")
    for r in runs.values():
        r.pop("out")
    return res


# -- phase 10 --------------------------------------------------------------

def _hf_vit_graph(torch, batch: int, image_size: int):
    """ViT-B/16 in the Hugging Face layout (tests/torch_hf_vit.py: 12
    layers at the published widths, random weights from seed 0) at `batch`,
    exported by the port's exporter. The module runs on the card for the
    exporter's shape propagation."""
    import importlib.util

    from smelter_tpu_torch.frontend.torch_export import export_torch

    spec = importlib.util.spec_from_file_location("torch_hf_vit",
                                                  ROOT / "tests" / "torch_hf_vit.py")
    hf = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(hf)
    m = hf.create(batch=batch, seed=0, image_size=image_size).cuda()
    example = torch.zeros(hf.input_shape(batch, image_size), device="cuda")
    return export_torch(m, example, name=f"hf_vit_b16_{image_size}")


def _gate(np, got, ref, ref16, label: str, classes: bool = True) -> dict:
    """f32 on the card within 1e-3 x max|ref| of the CPU's f32 run; bf16
    within 3x the CPU's own bf16 error, and for logits (`classes`) top-1
    equal on the clear rows."""
    scale = float(np.abs(ref).max())
    err32 = float(np.abs(got["f32"] - ref).max())
    err16 = float(np.abs(got["bf16"] - ref).max())
    err_cpu16 = float(np.abs(ref16 - ref).max())
    for k, v in got.items():
        check(v.shape == ref.shape and np.isfinite(v).all(), f"{label} {k} outputs")
    # f32 on the card sums in other orders than the CPU through the whole
    # model (cuBLAS GEMMs, the port's kernels, cuDNN's convs), all in full
    # f32: 1e-3.
    check(err32 <= 1e-3 * scale, f"{label} f32: max-abs {err32} > 1e-3 x {scale}")
    limit16 = 3 * err_cpu16
    check(err16 <= limit16, f"{label} bf16: max-abs {err16} > 3 x the CPU bf16's {err_cpu16}")
    r = {"max_abs_ref": scale, "f32_max_abs_err": err32, "bf16_max_abs_err": err16,
         "cpu_bf16_max_abs_err": err_cpu16, "bf16_limit": limit16}
    if classes:
        gap = np.diff(np.sort(ref, axis=1)[:, -2:], axis=1)[:, 0]
        agree = got["bf16"].argmax(1) == ref.argmax(1)
        clear = gap > 2 * err16
        check(bool(agree[clear].all()), f"{label} bf16: top-1 differs on a clear row")
        r.update(bf16_top1_agree=float(agree.mean()), clear_rows=int(clear.sum()))
    return r


def phase_hf_vit(torch, np, stt, zoo, zoo_bound16: float) -> dict:
    """ViT-B/16 in the Hugging Face layout at full width and depth, its
    attention as unmarked FusedAttention nodes: gates at 224 px batch 8 and
    384 px batch 2 (f32 and bf16 on the card under use_pallas against the
    port's CPU runs); (a) 224 px b128 bf16 use_pallas (12 short_attention a
    forward); (b) 384 px b64 (12 flash_attention); (c) 224 px b128 default
    (the library attention, no port kernel); (d) fuse_mlp_block on (c)'s
    graph (12 mlp_block) and on the zoo's ViT-B/16 (12 mlp_block, 12
    vit_attention_block); (e) a one-node FusedAttention graph at N 4096 and
    2048 through compile in bf16 (1 flash_attention each, no use_pallas);
    (f) serve(..., use_pallas, max_batch=16) answering 32 requests. `zoo` is
    phase 8's ViT-B/16 graph at batch 128 without passes, and zoo_bound16
    phase 8's bf16 bound between its routings."""
    import copy

    import torch.nn.functional as F

    from smelter_tpu_torch.api import _prepare
    from smelter_tpu_torch.ir.build import GraphBuilder
    from smelter_tpu_torch.passes.pass_manager import run_passes
    from smelter_tpu_torch.runtime.executor import CompiledModel

    res: dict = {}
    layers = VIT_B16["depth"]
    pallas32, pallas16 = stt.Config(use_pallas=True), stt.Config(use_pallas=True,
                                                                 compute_dtype="bfloat16")

    def n_sln(g) -> int:
        """SkipLayerNormalization nodes of the prepared graph: each takes
        residual_layer_norm under use_pallas."""
        gp = _prepare(copy.deepcopy(g), None, True, "nhwc")
        return sum(n.op_type == "SkipLayerNormalization" for n in gp.nodes)

    # gates: f32 and bf16 on the card under use_pallas against the CPU
    t0 = time.perf_counter()
    for size, batch, kernel in ((224, 8, "short_attention"), (384, 2, "flash_attention")):
        g = _hf_vit_graph(torch, batch, size)
        x = np.random.default_rng(10).standard_normal((batch, 3, size, size)).astype(np.float32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        ref = stt.compile(copy.deepcopy(g), pallas32, device="cpu")(x)[0]
        ref16 = stt.compile(copy.deepcopy(g), pallas16, device="cpu")(x)[0]
        got = {}
        for label, cfg in (("f32", pallas32), ("bf16", pallas16)):
            model = stt.compile(copy.deepcopy(g), cfg, device="cuda")
            _zero_counts()
            got[label] = model(x)[0]
            launches = _counts()
            check(launches[kernel] == layers, f"HF ViT {size} b{batch} {label}: {kernel} "
                                              f"launched {launches[kernel]} times")
            del model
        torch.backends.cudnn.allow_tf32 = True
        r = res[f"gate_{size}"] = _gate(np, got, ref, ref16, f"HF ViT {size} b{batch}")
        say(10, f"gate {size} px batch {batch} vs the CPU's f32 run (max|ref| "
                f"{r['max_abs_ref']:.4g}): card f32 max-abs {r['f32_max_abs_err']:.4g} (bound "
                f"{1e-3 * r['max_abs_ref']:.4g}); bf16 {r['bf16_max_abs_err']:.4g} (bound 3 x "
                f"the CPU bf16's {r['cpu_bf16_max_abs_err']:.4g}), top-1 "
                f"{r['bf16_top1_agree']:.3f} (clear rows {r['clear_rows']}) | {layers} {kernel} "
                f"a forward")
    res["gates_s"] = time.perf_counter() - t0
    bound16 = res["gate_224"]["bf16_limit"]

    # (a)-(d) at full batch, each profiled
    runs = {}
    x224 = np.random.default_rng(11).standard_normal((VIT_BATCH, 3, 224, 224)).astype(np.float32)
    x384 = np.random.default_rng(12).standard_normal((HF_384_BATCH, 3, 384, 384)).astype(
        np.float32)
    g224 = _hf_vit_graph(torch, VIT_BATCH, 224)
    g384 = _hf_vit_graph(torch, HF_384_BATCH, 384)
    sln224, sln384 = n_sln(g224), n_sln(g384)

    def mlp_fused(g):
        gp = _prepare(copy.deepcopy(g), None, True, "nhwc")
        check(run_passes(gp, ["fuse_mlp_block", "dce"]) is gp, "fuse_mlp_block")
        check(sum(n.op_type == "MlpBlock" for n in gp.nodes) == layers,
              "fuse_mlp_block left an MLP unfused")
        return CompiledModel(gp, stt.Config(compute_dtype="bfloat16"))

    cases = (
        ("c_default_224", lambda: stt.compile(copy.deepcopy(g224),
                                              stt.Config(compute_dtype="bfloat16"),
                                              device="cuda"), x224, {}, None),
        ("a_short_224", lambda: stt.compile(copy.deepcopy(g224), pallas16, device="cuda"),
         x224, {"short_attention": layers, "residual_layer_norm": sln224}, "c_default_224"),
        ("b_flash_384", lambda: stt.compile(copy.deepcopy(g384), pallas16, device="cuda"),
         x384, {"flash_attention": layers, "residual_layer_norm": sln384}, None),
        ("d_mlp_block_224", lambda: mlp_fused(g224), x224, {"mlp_block": layers},
         "c_default_224"),
        ("d_zoo_default", lambda: stt.compile(copy.deepcopy(zoo),
                                              stt.Config(compute_dtype="bfloat16"),
                                              device="cuda"), x224,
         {"vit_attention_block": layers}, None),
        ("d_zoo_mlp_block", lambda: mlp_fused(zoo), x224,
         {"mlp_block": layers, "vit_attention_block": layers}, "d_zoo_default"))
    for label, make, x, routed, versus in cases:
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        model = make()
        compile_s = time.perf_counter() - t0
        xg = torch.from_numpy(x).cuda()
        r = _vit_forward(torch, np, model, xg, f"HF ViT {label}", routed)
        r["compile_s"] = compile_s
        if versus is not None:
            b = zoo_bound16 if versus == "d_zoo_default" else bound16
            base = runs[versus]["logits"]
            r["max_abs_vs"] = float(np.abs(r["logits"] - base).max())
            r["top1_vs"] = _top1(r["logits"], base)
            check(r["max_abs_vs"] <= b, f"HF ViT {label}: logits {r['max_abs_vs']} from "
                                        f"{versus}'s (bound {b})")
        runs[label] = r
        del model, xg
        vs = (f" | vs {versus}: max-abs {r['max_abs_vs']:.4g}, top-1 {r['top1_vs']:.4f}"
              if versus is not None else "")
        say(10, f"({label}) bf16 batch {x.shape[0]}: {r['images_per_s']:.1f} images/s, step "
                f"{r['step_ms']:.3f} ms, idle share {100 * r['idle_share']:.1f}% (profiled busy "
                f"{r['device_busy_ms']:.3f} ms, ~{r['kernels_per_forward']:.0f} kernels), port "
                f"kernels {r['port_kernel_ms']:.3f} ms, peak {r['peak_mem_gb']:.2f} GB, "
                f"compiled in {compile_s:.1f} s | launches "
                f"{ {k: v for k, v in r['launches'].items() if v} }" + vs)
        say(10, "  device ms a forward by host op: "
                + "; ".join(f"{k} {v:.3f}" for k, v in r["top_host_ops_ms"]))
        say(10, "  device ms a forward by kernel: "
                + "; ".join(f"{k[:50]} {v:.3f}" for k, v in r["top_kernels_ms"][:6]))
    for r in runs.values():
        r.pop("logits")
    res.update(runs)
    del g384

    # (e) the default config's auto flash on a one-node graph
    for N in (4096, 2048):
        shape = (2, VIT_B16["heads"], N, VIT_B16["dim"] // VIT_B16["heads"])
        b = GraphBuilder("attn", opset=17)
        q, k, v = (b.input(n, shape) for n in "qkv")
        g = b.finish([b.node("FusedAttention", [q, k, v], scale=0.125)])
        model = stt.compile(g, stt.Config(compute_dtype="bfloat16"), device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(N)
        qkv = [torch.randn(shape, device="cuda", generator=gen) for _ in range(3)]
        _zero_counts()
        out = model.run_device(*qkv)[0]
        launches = _counts()
        check(launches["flash_attention"] == 1 and sum(launches.values()) == 1,
              f"auto flash N {N}: launches {launches}")
        ref = F.scaled_dot_product_attention(*(t.bfloat16() for t in qkv), scale=0.125)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        check(out.shape == shape and err <= 1e-2 * scale,
              f"auto flash N {N}: max-abs {err} vs SDPA > 1e-2 x {scale}")
        ms = time_ms(torch, lambda i: model.run_device(*qkv), 20)
        res[f"e_auto_flash_{N}"] = {"launches": launches, "max_abs_vs_sdpa": err, "ms": ms}
        say(10, f"(e) one-node FusedAttention {list(shape)} bf16, default config: 1 "
                f"flash_attention launch | vs SDPA max-abs {err:.3g} (bound 1e-2 x {scale:.3g}) "
                f"| {ms:.4f} ms a forward (host-timed with the cast of q, k, v)")
        del model, qkv

    # (f) serve(...) on (a)'s routing: one bucket of 16, 32 threaded requests
    g16 = _hf_vit_graph(torch, 16, 224)
    xs = x224[:32]
    direct_model = stt.compile(copy.deepcopy(g16), pallas16, device="cuda")
    direct = np.concatenate([direct_model(xs[:16])[0], direct_model(xs[16:])[0]])
    del direct_model
    _zero_counts()
    server = stt.serve(g16, pallas16, device="cuda", max_batch=16, buckets=(16,))
    results = [None] * len(xs)
    try:
        check(server.wait_ready(600), "HF ViT server bucket did not warm up")

        def ask(i):
            results[i] = server.infer(xs[i])[0]

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(len(xs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        stats = server.stats()
    finally:
        server.shutdown()
    launches = _counts()
    _check_routed("HF ViT server", launches, {"short_attention", "residual_layer_norm"})
    check(all(r is not None for r in results), "HF ViT server left requests unanswered")
    err = float(np.abs(np.stack(results) - direct).max())
    dscale = float(np.abs(direct).max())
    check(stats["requests"] == 32 and stats["errors"] == 0, f"HF ViT server stats {stats}")
    check(err <= 5e-2 * dscale, f"HF ViT served vs direct: max-abs {err} > 5e-2 x {dscale}")
    res["f_serve"] = {"launches": launches, "stats": stats, "max_abs_vs_direct": err}
    say(10, f"(f) served {stats['requests']} requests in {stats['batches']} batches of up to "
            f"16, launches {launches['short_attention']} short_attention (bucket warm-up "
            f"included) | p50 {stats['latency_ms_p50']:.1f} ms, p95 "
            f"{stats['latency_ms_p95']:.1f} ms | vs direct: max-abs {err:.3g} (bound 5e-2 x "
            f"{dscale:.3g})")
    return res


# -- phase 11 --------------------------------------------------------------

# The symbols of the block kernels and of the kernels they share (csrc/
# convnext_block.cu, cross_attn_block.cu, vit_block.cu, gemm.cuh,
# wgmma_gemm.cuh, layer_norm.cuh), as the profiler names them.
_PORT_BLOCK_KERNEL = re.compile(r"(smelter|\(anonymous namespace\))::(gemm_mma|gemm_f32|gemm_tma|"
                                r"dw_ln|dw_ln_staged|xattn_mma|xattn_f32|attention_mma|"
                                r"attention_rows|layer_norm_rows)[<(]")


def _convnext_graph(torch, batch: int):
    """ConvNeXt-T (CONVNEXT, random weights from seed 0) at `batch`, exported
    by the port's exporter with the module on the card. The layer scales are
    drawn from [0.2, 0.6) (seed 1): at the 1e-6 init each block's MLP adds
    too little to change its bf16 input, and no gate would see the blocks."""
    from smelter_tpu_torch.frontend.torch_export import export_torch
    from smelter_tpu_torch.models import convnext

    m = convnext.create_torch(0, CONVNEXT["num_classes"], CONVNEXT["dims"],
                              CONVNEXT["depths"])
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name.endswith("gamma"):
                p.copy_(0.2 + 0.4 * torch.rand(p.shape, generator=gen))
    m = m.cuda()
    side_px = CONVNEXT["image_size"]
    return export_torch(m, torch.zeros(batch, 3, side_px, side_px, device="cuda"),
                        name="convnext")


def _sd_unet_graph(torch, batch: int):
    """SD-UNet at the zoo's 256 px configuration (SD_UNET; weights, timestep
    and context from seed 0, the context baked at `batch`), exported by the
    port's exporter with the module on the card."""
    from smelter_tpu_torch.frontend.torch_export import export_torch
    from smelter_tpu_torch.models import sd_unet

    kw = {k: SD_UNET[k] for k in sd_unet.ZOO_KW}
    check(kw == sd_unet.ZOO_KW, f"SD_UNET {kw} is not the zoo's {sd_unet.ZOO_KW}")
    m = sd_unet.create_torch(batch, seed=0, **kw).cuda()
    side = SD_UNET["latent"]
    return export_torch(m, torch.zeros(batch, 4, side, side, device="cuda"), name="sd_unet")


def _prepared(stt, g, *, fuse_convnext: bool = False, cross: bool = False):
    """`_prepare` with the default passes on a copy of g; then
    fuse_convnext_block explicitly (as tests/test_vit_block_pass.py runs
    it), or fuse_vit_block's cross branch switched on by its module flag."""
    import copy

    from smelter_tpu_torch.api import _prepare
    from smelter_tpu_torch.passes import vit_block as vbp
    from smelter_tpu_torch.passes.pass_manager import run_passes

    flag = vbp._CROSS_ENABLED
    vbp._CROSS_ENABLED = cross
    try:
        gp = _prepare(copy.deepcopy(g), None, True, "nhwc")
    finally:
        vbp._CROSS_ENABLED = flag
    if fuse_convnext:
        run_passes(gp, ["fuse_convnext_block", "dce"])
    return gp


def _routed_of(gp, cfg) -> dict:
    """The launches a forward of prepared graph gp makes on the card under
    Config cfg: its block kernels; a fused_layer_norm for each
    LayerNormalization where cfg.fused_layernorm is True or "auto"; a
    residual_layer_norm for each bias-free SkipLayerNormalization where it is
    True or under use_pallas (ops/nn.py, ops/contrib_ops.py)."""
    ops = [n.op_type for n in gp.nodes]
    fln = cfg.fused_layernorm
    routed = {"convnext_block": ops.count("ConvNeXtBlock"),
              "cross_attn_block": ops.count("CrossAttnBlock"),
              "vit_attention_block": ops.count("VitAttnBlock"),
              "fused_layer_norm": ops.count("LayerNormalization") if fln in (True, "auto")
              else 0,
              "residual_layer_norm": sum(
                  n.op_type == "SkipLayerNormalization" and not (len(n.inputs) > 4
                                                                and n.inputs[4])
                  for n in gp.nodes) if fln is True or cfg.use_pallas else 0}
    return {k: v for k, v in routed.items() if v}


def _gates(torch, np, stt, graphs: dict, x, label: str, classes: bool) -> dict:
    """Each routing's prepared graph in f32 and bf16 on the card, with its
    launches, held by `_gate` to the port's CPU runs of the same graph."""
    import copy

    from smelter_tpu_torch.runtime.executor import CompiledModel

    out = {}
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for routing, gp in graphs.items():
        ref = CompiledModel(copy.deepcopy(gp), stt.Config(device="cpu"))(x)[0]
        ref16 = CompiledModel(copy.deepcopy(gp), stt.Config(device="cpu",
                                                            compute_dtype="bfloat16"))(x)[0]
        got = {}
        for key, dt in (("f32", "float32"), ("bf16", "bfloat16")):
            cfg = stt.Config(compute_dtype=dt)
            model = CompiledModel(copy.deepcopy(gp), cfg)
            _zero_counts()
            got[key] = model(x)[0]
            launches = _counts()
            routed = _routed_of(gp, cfg)
            check({k: v for k, v in launches.items() if v} == routed,
                  f"{label} {routing} {dt}: launches {launches}, not {routed}")
            del model
        r = out[routing] = _gate(np, got, ref, ref16, f"{label} {routing}", classes)
        r["launches"] = routed
        top1 = (f", top-1 {r['bf16_top1_agree']:.3f} (clear rows {r['clear_rows']})"
                if classes else "")
        say(11, f"{label} gate, {routing} (batch {x.shape[0]}) vs the CPU's f32 run (max|ref| "
                f"{r['max_abs_ref']:.4g}): card f32 max-abs {r['f32_max_abs_err']:.4g} (bound "
                f"{1e-3 * r['max_abs_ref']:.4g}); bf16 {r['bf16_max_abs_err']:.4g} (bound 3 x "
                f"the CPU bf16's {r['cpu_bf16_max_abs_err']:.4g}){top1} | launches a forward "
                f"{routed}")
    torch.backends.cudnn.allow_tf32 = True
    return out


def _runs(torch, np, stt, cases, x, label: str, batch: int) -> dict:
    """Each (name, prepared graph, config) at full batch: the launch check,
    images/s, step ms, idle share, kernels a forward, peak memory and a
    profile's top device ops; the bf16 outputs of each against the first's."""
    import copy

    from smelter_tpu_torch.runtime.executor import CompiledModel

    runs = {}
    xg = torch.from_numpy(x).cuda()
    for name, gp, cfg in cases:
        t0 = time.perf_counter()
        model = CompiledModel(copy.deepcopy(gp), cfg)
        compile_s = time.perf_counter() - t0
        r = _image_forward(torch, np, model, xg, f"{label} {name}", batch,
                           _routed_of(gp, cfg), 20, port_re=_PORT_BLOCK_KERNEL)
        r["compile_s"] = compile_s
        extra = ""
        if runs:
            base = next(iter(runs.values()))["out"]
            r["max_abs_vs_first"] = float(np.abs(r["out"] - base).max())
            extra = f" | vs {next(iter(runs))}: max-abs {r['max_abs_vs_first']:.4g}"
        runs[name] = r
        _say_run(f"{label} {name} bf16 batch {batch} (compiled in {compile_s:.1f} s)", r,
                 extra, phase=11)
        del model
    del xg
    for r in runs.values():
        r.pop("out")
    return runs


def phase_convnext(torch, np, stt) -> dict:
    """ConvNeXt-T at full width and depth (224 px, dims 96/192/384/768,
    depths 3/3/9/3, 1000 classes; random weights from seed 0), exported on
    the card: (a) gates at batch 8 on the default passes (the composite
    blocks with their 18 barriers) and with fuse_convnext_block (15
    ConvNeXtBlock, the stage-4 blocks below the tokens x dim gate); (b) at
    batch 64 in bf16 the default (0 convnext_block), fuse_convnext_block (15
    a forward) and use_pallas; (c) the fused graph served at max_batch=16."""
    res: dict = {}
    t0 = time.perf_counter()
    g8 = _convnext_graph(torch, CONVNEXT_GATE_BATCH)
    graphs = {"default": _prepared(stt, g8), "fused": _prepared(stt, g8, fuse_convnext=True)}
    ops = [n.op_type for n in graphs["default"].nodes]
    check(ops.count("OptimizationBarrier") == 18 and ops.count("ConvNeXtBlock") == 0,
          f"ConvNeXt-T default passes: {ops.count('OptimizationBarrier')} barriers")
    n_fused = sum(n.op_type == "ConvNeXtBlock" for n in graphs["fused"].nodes)
    check(n_fused == CONVNEXT_FUSED, f"fuse_convnext_block fused {n_fused} blocks, not "
                                     f"{CONVNEXT_FUSED}")
    side_px = CONVNEXT["image_size"]
    x8 = np.random.default_rng(13).standard_normal(
        (CONVNEXT_GATE_BATCH, 3, side_px, side_px)).astype(np.float32)
    res["gates"] = _gates(torch, np, stt, graphs, x8, "ConvNeXt-T", classes=True)
    res["gates_s"] = time.perf_counter() - t0
    del g8, graphs

    g = _convnext_graph(torch, CONVNEXT_BATCH)
    x = np.random.default_rng(14).standard_normal(
        (CONVNEXT_BATCH, 3, side_px, side_px)).astype(np.float32)
    cfg16 = stt.Config(compute_dtype="bfloat16")
    default = _prepared(stt, g)
    res.update(_runs(torch, np, stt, (
        ("default", default, cfg16),
        ("fuse_convnext_block", _prepared(stt, g, fuse_convnext=True), cfg16),
        ("use_pallas", default, stt.Config(compute_dtype="bfloat16", use_pallas=True))),
        x, "(b) ConvNeXt-T", CONVNEXT_BATCH))
    # the fused forward's profile: each block's FC1 and FC2 on gemm_tma
    # (stage 1's FC2 N 96 too), its depthwise step on dw_ln_staged, and no
    # mma.sync GEMM
    counts = res["fuse_convnext_block"]["kernel_counts"]
    by = {name: sum(n for k, n in counts.items() if re.search(pat, k))
          for name, pat in (("gemm_tma", r"::gemm_tma<"), ("gemm_mma", r"::gemm_mma<"),
                            ("dw_ln_staged", r"::dw_ln_staged<"), ("dw_ln", r"::dw_ln<"))}
    check(by["gemm_mma"] == 0 and by["dw_ln"] == 0 and by["gemm_tma"] > 0
          and by["dw_ln_staged"] > 0,
          f"(b) ConvNeXt-T fuse_convnext_block's kernels a forward: {by}")
    res["fuse_convnext_block"]["block_kernels"] = by
    say(11, f"(b) ConvNeXt-T fuse_convnext_block's block kernels a forward (torch.profiler; "
            f"{CONVNEXT_FUSED} blocks: {2 * CONVNEXT_FUSED} gemm_tma, {CONVNEXT_FUSED} "
            f"dw_ln_staged expected): {by}")
    bound16 = res["gates"]["fused"]["bf16_limit"]
    del g, default

    # (c) the fused graph at batch 16 served: one bucket of 16, 32 requests
    import copy

    from smelter_tpu_torch.runtime.executor import CompiledModel

    g16 = _prepared(stt, _convnext_graph(torch, 16), fuse_convnext=True)
    xs = x[:32]
    direct_model = CompiledModel(copy.deepcopy(g16), cfg16)
    direct = np.concatenate([direct_model(xs[:16])[0], direct_model(xs[16:])[0]])
    del direct_model
    res["serve"] = _serve_check(torch, np, stt, g16, cfg16, xs, 16, direct, bound16,
                                "(c) ConvNeXt-T fused", set(_routed_of(g16, cfg16)), phase=11)
    return res


def phase_sd_unet(torch, np, stt) -> dict:
    """SD-UNet at the zoo's 256 px configuration (latent 32, base 128, a 16 x
    256 context, 8 heads; weights, timestep and context from seed 0, the
    context baked at batch 8), exported on the card: (a) gates at batch 8 on
    the default passes (5 vit_attention_block at hd 16 and 32, the 5 cross
    attentions as native FusedAttention on the library attention) and with
    the cross branch on (5 cross_attn_block besides); (b) both at batch 8 in
    bf16; (c) served with buckets=(8,), the short batches padded, each
    answer held to the direct output of its image in one of the 8 context
    slots."""
    import copy

    from smelter_tpu_torch.runtime.executor import CompiledModel

    res: dict = {}
    B, side = SD_UNET_BATCH, SD_UNET["latent"]
    t0 = time.perf_counter()
    g = _sd_unet_graph(torch, B)
    graphs = {"default": _prepared(stt, g), "cross": _prepared(stt, g, cross=True)}
    want = {"default": {"vit_attention_block": 5},
            "cross": {"vit_attention_block": 5, "cross_attn_block": 5}}
    for routing, gp in graphs.items():
        blocks = {k: v for k, v in _routed_of(gp, stt.Config()).items()
                  if k in ("vit_attention_block", "cross_attn_block")}
        check(blocks == want[routing], f"SD-UNet {routing}: blocks {blocks}, not "
                                       f"{want[routing]}")
    x = np.random.default_rng(15).standard_normal((B, 4, side, side)).astype(np.float32)
    res["gates"] = _gates(torch, np, stt, graphs, x, "SD-UNet", classes=False)
    res["gates_s"] = time.perf_counter() - t0
    cfg16 = stt.Config(compute_dtype="bfloat16")
    res.update(_runs(torch, np, stt, (("default", graphs["default"], cfg16),
                                      ("cross", graphs["cross"], cfg16)),
                     x, "(b) SD-UNet", B))

    # (c) served: 20 requests through one bucket of 8; each image's direct
    # outputs in every slot (its context is the slot's)
    gp = graphs["cross"]
    model = CompiledModel(copy.deepcopy(gp), cfg16)
    xs = np.random.default_rng(16).standard_normal((20, 4, side, side)).astype(np.float32)
    slots = [model(np.stack([xi] * B))[0] for xi in xs]
    del model
    _zero_counts()
    server = stt.serve(gp, cfg16, optimize=False, device="cuda", max_batch=B, buckets=(B,))
    results = [None] * len(xs)
    try:
        check(server.wait_ready(600), "SD-UNet server bucket did not warm up")

        def ask(i):
            results[i] = server.infer(xs[i])[0]

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(len(xs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        stats = server.stats()
    finally:
        server.shutdown()
    launches = _counts()
    _check_routed("SD-UNet server", launches, set(_routed_of(gp, cfg16)))
    check(all(r is not None for r in results), "SD-UNet server left requests unanswered")
    check(stats["requests"] == len(xs) and stats["errors"] == 0, f"SD-UNet server stats {stats}")
    bound16 = res["gates"]["cross"]["bf16_limit"]
    errs = [min(float(np.abs(r - s[j]).max()) for j in range(B)) for r, s in zip(results, slots)]
    check(max(errs) <= bound16, f"SD-UNet served vs direct: max-abs {max(errs)} > {bound16}")
    res["serve"] = {"launches": launches, "stats": stats, "max_abs_vs_direct": max(errs)}
    say(11, f"(c) SD-UNet cross served {stats['requests']} requests in {stats['batches']} "
            f"batches of up to {B} (short ones padded), p50 {stats['latency_ms_p50']:.1f} ms, "
            f"p95 {stats['latency_ms_p95']:.1f} ms | vs the direct output in the nearest "
            f"slot: max-abs {max(errs):.3g} (bound {bound16:.3g}) | launches "
            f"{ {k: v for k, v in launches.items() if v} }")
    return res


# -- phase 13 --------------------------------------------------------------

def _graph_of(torch, side, fn):
    """One call of fn() captured as a CUDA graph on `side` (after a warm-up
    call there)."""
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        fn()
    return graph


def _spans_overlap(torch, run) -> dict:
    """One run() under torch.profiler: the slot copies on the card (device
    events named Memcpy) and how much of their time lies under a kernel's
    (the union of the other device events' intervals, in us)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    spans: dict = {"kernel": [], "copy": []}
    for e in prof.events():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        side = "copy" if e.name.startswith("Memcpy") else (
            None if e.name.startswith("Memset") else "kernel")
        if side:
            spans[side].append((float(e.time_range.start), float(e.time_range.end)))
    union: list = []
    for a, b in sorted(spans["kernel"]):
        if union and a <= union[-1][1]:
            union[-1][1] = max(union[-1][1], b)
        else:
            union.append([a, b])
    under = sum(max(0.0, min(b, ub) - max(a, ua)) for a, b in spans["copy"]
                for ua, ub in union)
    copy_us = sum(b - a for a, b in spans["copy"])
    return {"kernels": len(spans["kernel"]), "copies": len(spans["copy"]),
            "copy_us": copy_us, "copy_us_under_kernels": under,
            "kernel_us": sum(b - a for a, b in union),
            "overlap_share": under / copy_us if copy_us else 0.0}


def phase_ring(torch, power_w: float, smi: str) -> dict:
    """The ring kernels, W ranks on one card (a `Mesh` that repeats
    cuda:0); the slot transfers are on-card copies, not NVLink. (a) each
    kernel against its plain version at W 1, 2, 4 and 8 on odd shapes: f32
    within 1e-5 x max|plain| (TF32 off), bf16 1e-2, int8 `ag` exact with
    sums that wrap, int8 `rs` exact with sums that clamp; (b) the Megatron TP MLP at ViT-B/16's widths, batch 128
    (x 25,216 x 768, w1 768 x 3,072, w2 3,072 x 768, bf16, 4 ranks):
    `tp_allgather_matmul`, tanh GELU on each shard, `tp_reducescatter_matmul`,
    its launches counted (4 x 4 each), checked against the product computed
    directly in f32 at the bf16 bound, timed against the partitioner's form
    (cat of the shards and a matmul a rank; a matmul a rank, sum and split),
    and each kernel alone there (rows 22-23); (c) each kernel alone at
    llama_1b's FFN widths, M 4,096; (d) `sequence_sharded_attention_rdma` at
    llama_1b's heads (H 16, D 128), B 1, N 32,768 over 4 ranks in bf16
    (launches 4 x 4; row 24), checked head by head against the plain ring,
    SDPA over the full sequence as the yardstick, and f32 at N 4,096 (f32
    SDPA beside it); then a profile of the slot copies against the step
    kernels in a replay of one call's CUDA graph. Times are CUDA-graph replays, with the host cost of a
    call (calls issued one by one) beside them."""
    import torch.nn.functional as F

    from smelter_tpu_torch.kernels import attention_plan
    from smelter_tpu_torch.kernels import collective_matmul as cm
    from smelter_tpu_torch.kernels import ring_attention_rdma as ra
    from smelter_tpu_torch.kernels import wgmma_plan
    from smelter_tpu_torch.parallel import Mesh

    gc.collect()  # the earlier phases' garbage and cached blocks stay out of the timings
    torch.cuda.empty_cache()
    side = torch.cuda.Stream()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(13)
    f32, bf16 = torch.float32, torch.bfloat16
    on_card = f"{RING_W} ranks on one card; transfers are on-card copies, not NVLink | {smi}"

    def randn(*shape, dtype=bf16, scale=1.0):
        return (torch.randn(*shape, device="cuda", generator=gen) * scale).to(dtype)

    def ring_of(W, axis="tp"):
        return Mesh(["cuda:0"] * W, (axis,))

    def err_of(got, ref, rel, label):
        torch.cuda.synchronize()
        err = max((g.float() - r.float()).abs().max().item() for g, r in zip(got, ref))
        scale = max(r.float().abs().max().item() for r in ref)
        check(all(g.shape == r.shape and g.dtype == r.dtype for g, r in zip(got, ref))
              and math.isfinite(err) and err <= rel * scale,
              f"{label}: max-abs {err} > {rel} x {scale}")
        return err

    res: dict = {"label": on_card}
    # (a) each kernel against its plain version, W 1-8, odd shapes
    checks = []
    for W in (1, 2, 4, 8):
        ring = ring_of(W).rings("tp")[0]
        for dtype, rel in ((f32, 1e-5), (bf16, 1e-2)):
            xs = [randn(37, 70, dtype=dtype) for _ in range(W)]
            ws = [randn(70, 33, dtype=dtype) for _ in range(W)]
            e_ag = err_of(cm.collective_matmul_ag(xs, ws, ring),
                          cm.collective_matmul_ag_plain(xs, ws, ring), rel, f"ag W {W} {dtype}")
            xs = [randn(37 * W, 70, dtype=dtype) for _ in range(W)]
            e_rs = err_of(cm.collective_matmul_rs(xs, ws, ring),
                          cm.collective_matmul_rs_plain(xs, ws, ring), rel, f"rs W {W} {dtype}")
            e_at = []
            for D in (64, 128):
                qs, ks, vs = ([randn(1, 2, 37, D, dtype=dtype) for _ in range(W)]
                              for _ in range(3))
                e_at.append(err_of(ra.ring_attention_rdma(qs, ks, vs, ring, scale=D ** -0.5),
                                   ra.ring_attention_rdma_plain(qs, ks, vs, ring,
                                                                scale=D ** -0.5),
                                   rel, f"ring attention W {W} {dtype} D {D}"))
            checks.append([W, str(dtype), e_ag, e_rs, max(e_at)])
        xs = [torch.randint(-127, 128, (37, 200), device="cuda", generator=gen,
                            dtype=torch.int8) for _ in range(W)]
        ws = [torch.randint(-127, 128, (200, 33), device="cuda", generator=gen,
                            dtype=torch.int8) for _ in range(W)]
        got = cm.collective_matmul_ag(xs, ws, ring)
        ref = cm.collective_matmul_ag_plain(xs, ws, ring)
        torch.cuda.synchronize()
        wrapped = max((x.double() @ w.double()).abs().max().item() for x, w in zip(xs, ws))
        check(all(torch.equal(g, r) for g, r in zip(got, ref)) and wrapped > 127,
              f"ag W {W} int8: outputs differ from the plain version (largest |sum| {wrapped})")
        xs = [torch.randint(-127, 128, (37 * W, 200), device="cuda", generator=gen,
                            dtype=torch.int8) for _ in range(W)]
        got = cm.collective_matmul_rs(xs, ws, ring)
        ref = cm.collective_matmul_rs_plain(xs, ws, ring)
        torch.cuda.synchronize()
        clamped = sum(int((r.abs() >= 127).sum()) for r in ref)
        check(all(torch.equal(g, r) for g, r in zip(got, ref)) and clamped > 0,
              f"rs W {W} int8: outputs differ from the plain version ({clamped} clamped)")
        checks.append([W, "int8", "ag equal", f"largest |sum| {wrapped:.0f} (wraps)",
                       "rs equal", f"{clamped} outputs clamped"])
    res["checks"] = checks
    say(13, f"(a) kernels vs plain at W 1, 2, 4, 8 (odd M, Nl, N/P): {checks} | {on_card}")

    rows = {}
    # (b) the Megatron TP MLP at ViT-B/16's widths, batch 128
    M, D, Fd = MEGATRON
    mesh = ring_of(RING_W)
    ring = mesh.rings("tp")[0]
    x, w1, w2 = randn(M, D), randn(D, Fd, scale=D ** -0.5), randn(Fd, D, scale=Fd ** -0.5)

    def gelu(t):
        return F.gelu(t, approximate="tanh")

    def pair():
        up = cm.tp_allgather_matmul(x, w1, mesh)
        return cm.tp_reducescatter_matmul(up.map(gelu), w2, mesh)

    _zero_counts()
    down = pair()
    torch.cuda.synchronize()
    counts = _counts()
    _check_routed("Megatron pair", counts, {"collective_matmul_ag", "collective_matmul_rs"})
    check(counts["collective_matmul_ag"] == RING_W ** 2
          and counts["collective_matmul_rs"] == RING_W ** 2, f"Megatron pair launches {counts}")
    res["megatron_launches"] = {k: counts[k] for k in ("collective_matmul_ag",
                                                       "collective_matmul_rs")}
    ref = gelu(x.float() @ w1.float()) @ w2.float()
    got = down.full()
    err = (got.float() - ref).abs().max().item()
    check(got.shape == (M, D) and math.isfinite(err) and err <= 1e-2 * ref.abs().max().item(),
          f"Megatron pair vs f32 on the card: max-abs {err} > 1e-2 x {ref.abs().max().item()}")
    del ref, got, down
    xs, w1s = mesh.shard(x, ("tp", None)), mesh.shard(w1, (None, "tp"))
    w2s = mesh.shard(w2, ("tp", None))
    acts = [gelu(o) for o in cm.collective_matmul_ag(xs, w1s, ring)]

    def lib_ag(xs_, ws_):  # the partitioner's form: gather x, a matmul a rank
        full = torch.cat(xs_)
        return [full @ w for w in ws_]

    def lib_rs(xs_, ws_):  # a matmul a rank, the sum, the split
        return list(torch.stack([a @ w for a, w in zip(xs_, ws_)]).sum(0).chunk(len(xs_)))

    def gemm_row(name, fn, plain, lib, xs_, ws_, shape, rel=1e-2):
        Mg, Kg, Ng = shape
        err_ = err_of(fn(xs_, ws_, ring), plain(xs_, ws_, ring), rel, f"{name} {shape}")
        step = ((Mg // RING_W, Ng // RING_W, Kg) if name == "collective_matmul_ag"
                else (Mg // RING_W, Ng, Kg // RING_W))  # a rank's step (M, N, K)
        form = wgmma_plan.plan(*step, int8_b=False).form
        check(form == "tma", f"{name} {shape}: its steps take the {form} form")
        b_ms, b_by = bound((Mg * Kg + Kg * Ng + Mg * Ng) * 2, 2 * Mg * Ng * Kg, "bf16", power_w)
        ms = graph_ms(torch, side, lambda i: fn(xs_, ws_, ring), 10)
        return dict(name=name, shape=list(shape), dtype="bf16", max_abs_err=err_,
                    tolerance="1e-2 x max|plain| (bf16)", ms=ms,
                    call_ms=time_ms(torch, lambda i: fn(xs_, ws_, ring), 10),
                    plain_ms=graph_ms(torch, side, lambda i: plain(xs_, ws_, ring), 2,
                                      replays=2),
                    library_ms=graph_ms(torch, side, lambda i: lib(xs_, ws_), 10),
                    bound_ms=b_ms, bound_by=b_by, flops=2 * Mg * Ng * Kg,
                    tflops=2 * Mg * Ng * Kg / ms / 1e9, ranks=RING_W, step=list(step),
                    form=form)

    rows["ag"] = gemm_row("collective_matmul_ag", cm.collective_matmul_ag,
                          cm.collective_matmul_ag_plain, lib_ag, xs, w1s, (M, D, Fd))
    rows["rs"] = gemm_row("collective_matmul_rs", cm.collective_matmul_rs,
                          cm.collective_matmul_rs_plain, lib_rs, acts, w2s, (M, Fd, D))

    def lib_pair():
        return lib_rs([gelu(o) for o in lib_ag(xs, w1s)], w2s)

    b_ms = rows["ag"]["bound_ms"] + rows["rs"]["bound_ms"]
    res["megatron"] = {"shape": [M, D, Fd], "max_abs_vs_f32": err,
                       "ms": graph_ms(torch, side, lambda i: pair(), 5),
                       "call_ms": time_ms(torch, lambda i: pair(), 5),
                       "library_ms": graph_ms(torch, side, lambda i: lib_pair(), 5),
                       "bound_ms": b_ms}
    mg = res["megatron"]
    say(13, f"(b) Megatron TP MLP, ViT-B/16 b128 ({M} x {D} -> {Fd} -> {D}, bf16): launches "
            f"{res['megatron_launches']}, vs f32 on the card max-abs {err:.3g} | pair "
            f"{mg['ms']:.4f} ms (host cost of a call {mg['call_ms']:.4f} ms), partitioner's "
            f"form {mg['library_ms']:.4f} ms, bound {b_ms:.4f} ms | {on_card}")
    del acts, xs, w1s, w2s

    # (c) each kernel alone at llama_1b's FFN widths
    Ml, Dl, Fl = LLAMA_FFN
    xa, wa = mesh.shard(randn(Ml, Dl), ("tp", None)), mesh.shard(
        randn(Dl, Fl, scale=Dl ** -0.5), (None, "tp"))
    rows["ag_llama"] = gemm_row("collective_matmul_ag", cm.collective_matmul_ag,
                                cm.collective_matmul_ag_plain, lib_ag, xa, wa, (Ml, Dl, Fl))
    xr, wr = mesh.shard(randn(Ml, Fl), (None, "tp")), mesh.shard(
        randn(Fl, Dl, scale=Fl ** -0.5), ("tp", None))
    rows["rs_llama"] = gemm_row("collective_matmul_rs", cm.collective_matmul_rs,
                                cm.collective_matmul_rs_plain, lib_rs, xr, wr, (Ml, Fl, Dl))
    del xa, wa, xr, wr

    # (d) sequence-sharded ring attention at llama_1b's heads
    B, H, N, Dh = RING_ATTN
    smesh = ring_of(RING_W, "sp")
    sring = smesh.rings("sp")[0]
    scale = Dh ** -0.5
    q, k, v = (randn(B, H, N, Dh) for _ in range(3))
    _zero_counts()
    out = ra.sequence_sharded_attention_rdma(q, k, v, smesh, scale=scale)
    torch.cuda.synchronize()
    counts = _counts()
    _check_routed("sequence_sharded_attention_rdma", counts, "ring_attention_rdma")
    check(counts["ring_attention_rdma"] == RING_W ** 2, f"ring attention launches {counts}")
    res["attention_launches"] = counts["ring_attention_rdma"]
    qs, ks, vs = (smesh.shard(t, (None, None, "sp", None)) for t in (q, k, v))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()  # the plain ring a head at a time: its (Nl, Nl) f32 logits a step
    refs = [ra.ring_attention_rdma_plain(*([t[:, h:h + 1] for t in s] for s in (qs, ks, vs)),
                                         sring, scale=scale) for h in range(H)]
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    err = max((o[:, h:h + 1].float() - r.float()).abs().max().item()
              for h, ref in enumerate(refs) for o, r in zip(out.shards, ref))
    top = max(r.float().abs().max().item() for ref in refs for r in ref)
    check(math.isfinite(err) and err <= 1e-2 * top,
          f"ring attention N {N} bf16: max-abs {err} > 1e-2 x {top}")
    b_ms, b_by = bound(4 * B * H * N * Dh * 2, 4 * B * H * N * N * Dh, "bf16", power_w)
    def attention(i):
        return ra.ring_attention_rdma(qs, ks, vs, sring, scale=scale)

    ms = graph_ms(torch, side, attention, 2, replays=2)
    rows["attention"] = dict(
        name="ring_attention_rdma", shape=[B, H, N, Dh], dtype="bf16", max_abs_err=err,
        tolerance="1e-2 x max|plain| (bf16; p rounded to bf16 before p v)", ms=ms,
        call_ms=time_ms(torch, attention, 2, warmup=1), plain_ms=plain_ms,
        library_ms=graph_ms(torch, side, lambda i: F.scaled_dot_product_attention(
            q, k, v, scale=scale), 2, replays=2),
        bound_ms=b_ms, bound_by=b_by, flops=4 * B * H * N * N * Dh,
        tflops=4 * B * H * N * N * Dh / ms / 1e9, ranks=RING_W,
        form=attention_plan.ring_plan(N // RING_W, B * H, Dh, sixteen_bit=True).form)
    check(rows["attention"]["form"] == "streaming", "ring attention: not the streaming form")
    del out, refs
    Nf = RING_ATTN_F32_N
    qf, kf, vf = ([randn(B, H, Nf // RING_W, Dh, dtype=f32) for _ in range(RING_W)]
                  for _ in range(3))
    got = ra.ring_attention_rdma(qf, kf, vf, sring, scale=scale)
    ref = ra.ring_attention_rdma_plain(qf, kf, vf, sring, scale=scale)
    b32, _ = bound(4 * B * H * Nf * Dh * 4, {"f32": 4 * B * H * Nf * Nf * Dh}, None, power_w)
    qc, kc, vc = (torch.cat(t, dim=2) for t in (qf, kf, vf))  # the full f32 sequence
    res["attention_f32"] = {
        "shape": [B, H, Nf, Dh],
        "max_abs_err": err_of(got, ref, 1e-5, f"ring attention N {Nf} f32"),
        "ms": graph_ms(torch, side, lambda i: ra.ring_attention_rdma(
            qf, kf, vf, sring, scale=scale), 2, replays=2),
        "plain_ms": graph_ms(torch, side, lambda i: ra.ring_attention_rdma_plain(
            qf, kf, vf, sring, scale=scale), 2, replays=2),
        "library_ms": graph_ms(torch, side, lambda i: F.scaled_dot_product_attention(
            qc, kc, vc, scale=scale), 2, replays=2), "bound_ms": b32}
    del got, ref, qf, kf, vf, qc, kc, vc

    # the slot copies against the step kernels, in a replay of one call's
    # CUDA graph (no host launch cost between the steps)
    xs, w1s = mesh.shard(x, ("tp", None)), mesh.shard(w1, (None, "tp"))
    res["overlap"] = {
        "ag": _spans_overlap(torch, _graph_of(
            torch, side, lambda: cm.collective_matmul_ag(xs, w1s, ring)).replay),
        "attention": _spans_overlap(torch, _graph_of(
            torch, side, lambda: attention(0)).replay)}
    for key, o in res["overlap"].items():
        check(o["copies"] == 2 * RING_W * (RING_W - 1) // (2 if key == "ag" else 1)
              and o["kernels"] >= RING_W ** 2,
              f"ring {key} profile: {o['copies']} copies, {o['kernels']} kernels")
    del xs, w1s, q, k, v, qs, ks, vs
    for key, r in rows.items():
        say(13, f"{r['name']} {r['shape']} ({key}): err {r['max_abs_err']:.3g} "
                f"({r['tolerance']}) | "
                + (f"steps of {r['step']} (M, N, K) in the {r['form']} form | " if "step" in r
                   else f"steps in the {r['form']} form | " if "form" in r else "")
                + f"kernel {r['ms']:.4f} ms ({r['tflops']:.1f} TFLOP/s; "
                f"host cost of a call {r['call_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}) = "
                f"{100 * r['bound_ms'] / r['ms']:.1f}% of bound | {on_card}")
    a32 = res["attention_f32"]
    say(13, f"ring_attention_rdma f32 {a32['shape']}: err {a32['max_abs_err']:.3g} (1e-5 x "
            f"max|plain|) | kernel {a32['ms']:.4f} ms, plain {a32['plain_ms']:.4f} ms, library "
            f"{a32['library_ms']:.4f} ms (f32 SDPA over the full sequence), bound "
            f"{a32['bound_ms']:.4f} ms (f32 FMA peak) | {on_card}")
    for key, o in res["overlap"].items():
        say(13, f"profile {key}: {o['copies']} slot copies, {o['copy_us']:.1f} us, of which "
                f"{o['copy_us_under_kernels']:.1f} us ({100 * o['overlap_share']:.1f} %) under "
                f"a step kernel; {o['kernels']} kernels, {o['kernel_us']:.1f} us busy | "
                f"{on_card}")
    torch.cuda.empty_cache()
    res["rows"] = rows
    return res


# -- main -------------------------------------------------------------------

def main() -> int:
    import numpy as np
    import torch

    check(torch.cuda.is_available(), "no CUDA card: this smoke test runs only on the card")
    check((ROOT / "smelter_tpu_torch" / "__init__.py").exists(),
          f"{ROOT} holds no smelter_tpu_torch package: run from a checkout")
    sys.path.insert(0, str(ROOT))
    import smelter_tpu_torch as stt

    check(Path(stt.__file__).resolve().parent == ROOT / "smelter_tpu_torch",
          f"imported smelter_tpu_torch from {stt.__file__}, not from {ROOT}")
    t_start = time.perf_counter()
    smi, power_w = phase_environment(torch)
    rows = phase_kernels(torch, power_w)

    decode_rows = phase_decode_kernels(torch, power_w, smi)
    ragged_rows = phase_ragged_kernel(torch, power_w)
    vit_rows = phase_vit_kernels(torch, np, power_w)
    image_rows = phase_image_kernels(torch, power_w)
    encoder_rows = phase_encoder_kernels(torch, power_w)
    block_rows = phase_block_kernels(torch, np, power_w)
    conv_rows = phase_conv_kernels(torch, power_w)
    variant_rows = phase_variant_kernels(torch, power_w)
    ring = REPORT["ring"] = phase_ring(torch, power_w, smi)

    main_path, ref_f32 = phase_main(torch, np, stt)
    REPORT["main_path"] = main_path
    REPORT["serve"] = phase_serve(torch, np, stt)
    i8s = REPORT["int8_static"] = phase_int8_static(torch, np, stt, ref_f32)
    del ref_f32
    paged, paged_graph, paged_reqs, _ = phase_paged(torch, np, stt)
    REPORT["paged"] = paged
    spec_graphs: dict = {}
    static = REPORT["static"] = phase_static(torch, np, stt, paged_graph, paged_reqs,
                                             paged["serve_t1"]["tok_s"], spec_graphs)
    del paged_graph
    REPORT["spec"] = phase_spec(torch, np, stt, spec_graphs)
    del spec_graphs
    vit, zoo = phase_vit(torch, np, stt)
    REPORT["vit"] = vit
    sr = REPORT["esrgan"] = phase_esrgan(torch, np, stt)
    seg = REPORT["segnet"] = phase_segnet(torch, np, stt)
    hfv = REPORT["hf_vit"] = phase_hf_vit(torch, np, stt, zoo, vit["b8"]["bf16_bound_b128"])
    del zoo
    cnx = REPORT["convnext"] = phase_convnext(torch, np, stt)
    sdu = REPORT["sd_unet"] = phase_sd_unet(torch, np, stt)
    # Each kernel's launches on the path that routes to it.
    launches = {"dequant_matmul": main_path["bf16"]["launches"]["dequant_matmul"],
                "int8_matmul": main_path["bf16_int8act"]["launches"]["int8_matmul"],
                "int4_matmul": paged["serve_t1"]["launches"]["int4_matmul"],
                "paged_decode_attention":
                    paged["serve_t1"]["launches"]["paged_decode_attention"],
                "ragged_decode_attention":
                    static["decode_server"]["launches"]["ragged_decode_attention"],
                "fused_layer_norm": vit["raw_fused_layernorm"]["launches"]["fused_layer_norm"],
                "residual_layer_norm": vit["use_pallas"]["launches"]["residual_layer_norm"],
                "vit_attention_block": vit["default"]["launches"]["vit_attention_block"],
                "pixel_conv_rowdot": sr["default"]["launches"]["pixel_conv_rowdot"],
                "pixel_conv_rowdot_q": sr["int8_pixel"]["launches"]["pixel_conv_rowdot_q"],
                "max_unpool2x2": seg["default"]["launches"]["max_unpool2x2"],
                "short_attention": hfv["a_short_224"]["launches"]["short_attention"],
                "flash_attention": hfv["b_flash_384"]["launches"]["flash_attention"],
                "mlp_block": hfv["d_mlp_block_224"]["launches"]["mlp_block"],
                "convnext_block": cnx["fuse_convnext_block"]["launches"]["convnext_block"],
                "cross_attn_block": sdu["cross"]["launches"]["cross_attn_block"],
                "qlinear_conv": i8s["b128"]["launches"]["qlinear_conv"],
                "int8_join": i8s["b128"]["launches"]["int8_join"],
                "dequant_conv": REPORT["dequant_conv_entry_launches"],
                **REPORT["variant_entry_launches"],
                **ring["megatron_launches"],
                "ring_attention_rdma": ring["attention_launches"]}
    say(6, f"main-path launches {launches} | total {time.perf_counter() - t_start:.1f} s")

    # ResNet-50 kernels: one call at the head shape (its launches from the
    # use_pallas forward). Encoder kernels: one call at the HF-layout
    # ViT-B/16's shapes (224 px b128; flash at 384 px b64). Decode kernels: the
    # sum over one decode step's calls (169 int4_matmul, 24 attention). ViT
    # kernels: one call at ViT-B/16's batch-128 shape. Image kernels: the sum
    # over one forward's calls (349 pixel convs of ESRGAN x4 at batch 8, 3
    # unpools of SegNet at batch 16; the 15 convnext_block calls of a
    # ConvNeXt-T forward at batch 64, the 5 cross_attn_block calls of an
    # SD-UNet forward at batch 8; the 53 qlinear_conv calls of a ResNet-50
    # forward at batch 128); dequant_conv: the sum over its entry point's four
    # calls at ResNet-50's stride-1 3x3 shapes at batch 128, bf16.
    # pixel_conv_rowdot_q has no library call (null); qlinear_conv's is
    # cuDNN's bf16 conv (PyTorch has no int8 conv); int8_join (the 16 joins
    # of that forward; it stands in for XLA's fusion of the chain, no
    # pallas_call) has none.
    sources = {"dequant_matmul": ("smelter_tpu_torch/csrc/dequant_matmul.cu",
                                  "smelter_tpu/kernels/dequant_matmul.py:104",
                                  rows[("dequant_matmul", "head", "bf16")], "call"),
               "int8_matmul": ("smelter_tpu_torch/csrc/wgmma_gemm.cuh",
                               "smelter_tpu/kernels/int8_matmul.py:125",
                               rows[("int8_matmul", "head", "int8")], "call"),
               "int4_matmul": ("smelter_tpu_torch/csrc/int4_matmul.cu",
                               "smelter_tpu/kernels/int4_matmul.py:232",
                               per_step(decode_rows, "int4_matmul"), "decode step"),
               "paged_decode_attention": ("smelter_tpu_torch/csrc/paged_decode_attention.cu",
                                          "smelter_tpu/kernels/paged_decode_attention.py:151",
                                          per_step(decode_rows, "paged_decode_attention"),
                                          "decode step"),
               "ragged_decode_attention": ("smelter_tpu_torch/csrc/ragged_decode_attention.cu",
                                           "smelter_tpu/kernels/ragged_decode_attention.py:178",
                                           per_step(ragged_rows, "ragged_decode_attention"),
                                           "decode step"),
               "fused_layer_norm": ("smelter_tpu_torch/csrc/layer_norm.cu",
                                    "smelter_tpu/kernels/layer_norm.py:44",
                                    vit_rows["fused_layer_norm"], "call"),
               "residual_layer_norm": ("smelter_tpu_torch/csrc/layer_norm.cu",
                                       "smelter_tpu/kernels/layer_norm.py:111",
                                       vit_rows["residual_layer_norm"], "call"),
               "vit_attention_block": ("smelter_tpu_torch/csrc/vit_block.cu",
                                       "smelter_tpu/kernels/vit_block.py:147",
                                       vit_rows["vit_attention_block"], "call"),
               "pixel_conv_rowdot": ("smelter_tpu_torch/csrc/wgmma_conv.cuh",
                                     "smelter_tpu/kernels/pixel_conv.py:140",
                                     per_forward(image_rows, "pixel_conv_rowdot"), "forward"),
               "pixel_conv_rowdot_q": ("smelter_tpu_torch/csrc/wgmma_conv_s8.cuh",
                                       "smelter_tpu/kernels/pixel_conv.py:269",
                                       per_forward(image_rows, "pixel_conv_rowdot_q"),
                                       "forward"),
               "max_unpool2x2": ("smelter_tpu_torch/csrc/max_unpool.cu",
                                 "smelter_tpu/kernels/max_unpool.py:78",
                                 per_forward(image_rows, "max_unpool2x2"), "forward"),
               "short_attention": ("smelter_tpu_torch/csrc/wgmma_attention.cuh",
                                   "smelter_tpu/kernels/attention_short.py:74",
                                   encoder_rows[("short_attention", "224 px b128")], "call"),
               "flash_attention": ("smelter_tpu_torch/csrc/wgmma_attention.cuh",
                                   "smelter_tpu/kernels/flash_attention.py:93",
                                   encoder_rows[("flash_attention", "384 px b64")], "call"),
               "mlp_block": ("smelter_tpu_torch/csrc/mlp_block.cu",
                             "smelter_tpu/kernels/mlp_block.py:79",
                             encoder_rows[("mlp_block", "224 px b128")], "call"),
               "convnext_block": ("smelter_tpu_torch/csrc/convnext_block.cu",
                                  "smelter_tpu/kernels/convnext_block.py:84",
                                  per_forward(block_rows, "convnext_block"), "forward"),
               "cross_attn_block": ("smelter_tpu_torch/csrc/cross_attn_block.cu",
                                    "smelter_tpu/kernels/vit_block.py:295",
                                    per_forward(block_rows, "cross_attn_block"), "forward"),
               "qlinear_conv": ("smelter_tpu_torch/csrc/wgmma_qconv.cuh",
                                "smelter_tpu/ops/quant_ops.py:260",
                                per_forward(conv_rows, "qlinear_conv"), "forward"),
               "int8_join": ("smelter_tpu_torch/csrc/int8_join.cu",
                             "smelter_tpu/quant/static_quant.py:234",
                             per_forward(conv_rows, "int8_join"), "forward"),
               "dequant_conv": ("smelter_tpu_torch/csrc/dequant_conv.cu",
                                "smelter_tpu/kernels/dequant_conv.py:103",
                                per_forward(conv_rows, "dequant_conv"), "four calls"),
               "dequant_matmul_int8_fused": ("smelter_tpu_torch/csrc/int8_matmul_fused.cu",
                                             "smelter_tpu/kernels/int8_matmul.py:232",
                                             variant_rows[("dequant_matmul_int8_fused",
                                                           "serving")], "call"),
               "dequant_matmul_int8_fused2": ("smelter_tpu_torch/csrc/int8_matmul_fused.cu",
                                              "smelter_tpu/kernels/int8_matmul.py:325",
                                              variant_rows[("dequant_matmul_int8_fused2",
                                                            "serving")], "call"),
               "pixel_conv_blockdot": ("smelter_tpu_torch/csrc/wgmma_conv.cuh",
                                       "smelter_tpu/kernels/pixel_conv.py:377",
                                       per_forward(variant_rows, "pixel_conv_blockdot"),
                                       "forward"),
               "pixel_conv_patch": ("smelter_tpu_torch/csrc/wgmma_conv.cuh",
                                    "smelter_tpu/kernels/pixel_conv.py:487",
                                    per_forward(variant_rows, "pixel_conv_patch"), "forward"),
               "collective_matmul_ag": ("smelter_tpu_torch/csrc/collective_matmul.cu",
                                        "smelter_tpu/kernels/collective_matmul.py:148",
                                        ring["rows"]["ag"], "call, 4 ranks on one card"),
               "collective_matmul_rs": ("smelter_tpu_torch/csrc/collective_matmul.cu",
                                        "smelter_tpu/kernels/collective_matmul.py:177",
                                        ring["rows"]["rs"], "call, 4 ranks on one card"),
               "ring_attention_rdma": ("smelter_tpu_torch/csrc/ring_attention.cu",
                                       "smelter_tpu/kernels/ring_attention_rdma.py:120",
                                       ring["rows"]["attention"], "call, 4 ranks on one card")}
    kernels = []
    for name, (src, replaces, r, per) in sources.items():
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"], "per": per})
    REPORT["kernels"] = kernels
    REPORT["phase_end_s"] = PHASE_END_S
    print("seconds from the start to each phase's last line: " + json.dumps(PHASE_END_S))
    out = ROOT / "build" / "chip_smoke"
    out.mkdir(parents=True, exist_ok=True)
    (out / "report.json").write_text(json.dumps(REPORT, indent=1, default=str))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(_split_child(sys.argv[1]) if sys.argv[1:] in (["--vit-split"], ["--convnext-split"])
             else main())
