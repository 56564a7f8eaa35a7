"""`qlinear_conv`'s forms (`kernels/wgmma_plan.py::qconv_plan`,
`csrc/wgmma_qconv.cuh`) without a card: the form each of ResNet-50's 53
convs at batch 128 takes, the plan's sizes against the header's, a replay
in numpy of the kernels' tile walk (an im2col box of 128 output pixels
crossing rows and images, the traversal stride, the tap offsets, zeros in
the padding) equal to `qlinear_conv_plain`, the RGB stem's unfolded copy
and weight, which give the plain output unchanged, and the `relu`
epilogue."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from smelter_tpu_torch.kernels import qlinear_conv as qc
from smelter_tpu_torch.kernels import wgmma_plan as wp

HEADER = (Path(__file__).resolve().parents[1] / "smelter_tpu_torch" / "csrc"
          / "wgmma_qconv.cuh").read_text()


def resnet50_convs(batch: int = 128, size: int = 224) -> list:
    """ResNet-50 v1.5's 53 convs (the zoo builder's: the stride on the 3x3),
    as (N, H, C_in, C_out, k, stride, pad)."""
    convs = [(batch, size, 3, 64, 7, 2, 3)]
    h, cin = size // 4, 64
    for width, blocks, stride in ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)):
        for i in range(blocks):
            s = stride if i == 0 else 1
            h_out = (h - 1) // s + 1
            convs += [(batch, h, cin, width, 1, 1, 0), (batch, h, width, width, 3, s, 1),
                      (batch, h_out, width, 4 * width, 1, 1, 0)]
            if i == 0:
                convs.append((batch, h, cin, 4 * width, 1, s, 0))
            cin, h = 4 * width, h_out
    return convs


def _plan(n, h, cin, cout, k, s, p, **kw):
    return wp.qconv_plan(n, h, h, cin, cout, k, k, s, s, ((p, p), (p, p)), **kw)


def test_resnet50_forms_at_batch_128():
    """All 53 convs take a wgmma form: the 33 1x1 stride-1 convs "gemm",
    the 13 3x3 at stride 1, the 3 at stride 2, the 3 strided projections
    and the stem "im2col" (a 7 x 1 conv over its unfolded copy: 7 x 3
    channels padded to 32, K steps of 32 bytes); C_in 64 steps of 64, the
    rest 128; C_out 64 tiles of 64."""
    convs = resnet50_convs()
    assert len(convs) == 53
    forms: dict = {}
    for n, h, cin, cout, k, s, p in convs:
        plan = _plan(n, h, cin, cout, k, s, p)
        key = ("stem" if cin == 3 else f"{k}x{k}/{s}")
        forms.setdefault(key, set()).add(plan.form)
        assert plan.c_in == (32 if cin == 3 else cin)
        assert plan.bk == (32 if cin == 3 else 64 if cin == 64 else 128)
        assert plan.bn == (64 if cout == 64 else 128)
        assert plan.grid == min(plan.tiles, wp.SMS) and plan.grid > 0
        assert plan.smem <= wp.SMEM_LIMIT and plan.stages >= 6
        assert plan.code == {"gemm": 1, "im2col": 2}[plan.form]
        assert plan.unfold == (cin == 3)
    assert forms == {"stem": {"im2col"}, "1x1/1": {"gemm"}, "3x3/1": {"im2col"},
                     "3x3/2": {"im2col"}, "1x1/2": {"im2col"}}
    count = lambda key: sum(1 for n, h, cin, cout, k, s, p in convs  # noqa: E731
                            if (cin == 3) == (key == "stem")
                            and (key == "stem" or f"{k}x{k}/{s}" == key))
    assert [count(k) for k in ("1x1/1", "3x3/1", "3x3/2", "1x1/2", "stem")] == [33, 13, 3, 3, 1]


@pytest.mark.parametrize("geom,form", [
    ((2, 15, 24, 64, 3, 1, 1), "mma"),    # C_in 24: not a multiple of 32, not padded
    ((2, 15, 48, 64, 3, 1, 1), "mma"),
    ((2, 14, 64, 48, 3, 1, 1), "mma"),    # C_out under 64
    ((2, 14, 64, 72, 3, 1, 1), "mma"),    # C_out not a multiple of 16
    ((1, 7, 256, 512, 1, 2, 0), "mma"),   # 16 output pixels
    ((2, 15, 64, 192, 3, 2, 1), "im2col"),  # odd H at stride 2, C_out 192
    ((2, 15, 3, 64, 7, 2, 3), "im2col"),  # the stem at an odd map
    ((2, 14, 5, 96, 1, 1, 0), "gemm"),    # 5 channels, padded (a 1x1's unfold)
    ((2, 9, 96, 80, 1, 1, 0), "gemm"),    # C_in 96: K steps of 32
])
def test_odd_shapes_take_the_intended_form(geom, form):
    n, h, cin, cout, k, s, p = geom
    plan = _plan(n, h, cin, cout, k, s, p)
    assert plan.form == form
    if form != "mma":
        assert plan.c_in % plan.bk == 0 and cout >= plan.bn and cout % 16 == 0


def test_unaligned_or_unreadable_geometry_keeps_mma_sync():
    assert _plan(128, 56, 256, 64, 1, 1, 0, aligned=False).form == "mma"
    # the stem reads fresh unfolded copies: alignment does not matter
    assert _plan(8, 224, 3, 64, 7, 2, 3, aligned=False).form == "im2col"
    # a pad beyond the corner an im2col map holds, a stride past 8
    assert wp.qconv_plan(1, 300, 300, 64, 64, 3, 3, 1, 1, ((200, 200), (1, 1))).form == "mma"
    assert _plan(2, 64, 64, 64, 1, 9, 0).form == "mma"


def test_plan_sizes_are_the_headers():
    """The stage counts and shared memory the plan computes are the table
    in csrc/wgmma_qconv.cuh, and fit a block."""
    table = re.findall(r"BK (\d+), BN (\d+): (\d+) stages, ([\d,]+)", HEADER)
    assert len(table) == 6
    for bk, bn, stages, smem in table:
        bk, bn = int(bk), int(bn)
        assert wp.qconv_stages(bk, bn) == int(stages)
        assert wp.qconv_smem(bk, bn) == int(smem.replace(",", "")) <= wp.SMEM_LIMIT
    assert f"QC_MAX_STAGES = {wp.QC_MAX_STAGES};" in HEADER


def _replay(x, w, m, b, stride, pads, relu, plan):
    """The wgmma forms' walk in numpy: tiles of 128 output pixels, each box
    starting at its first pixel's window and stepping pixel by pixel with
    the traversal stride (rows and images crossed in order), a K step of bk
    channels of one tap read at the tap's offset, zeros outside the map;
    the weight's (ky, kx, c) rows; the int32 sums; the epilogue."""
    n, c, h, wd = x.shape
    cout, _, kh, kw = w.shape
    (pt, pb), (pl, pr) = pads
    sh, sw = stride
    ho, wo = (h + pt + pb - kh) // sh + 1, (wd + pl + pr - kw) // sw + 1
    M, K = n * ho * wo, kh * kw * c
    xn = x.permute(0, 2, 3, 1).numpy().astype(np.int64)
    wk = w.permute(0, 2, 3, 1).reshape(cout, K).numpy().astype(np.int64)
    acc = np.zeros((wp.cdiv(M, wp.BM) * wp.BM, cout), np.int64)
    for m0 in range(0, M, wp.BM):
        rows = np.arange(m0, m0 + wp.BM)
        img, r = rows // (ho * wo), rows % (ho * wo)
        wi, wj = (r // wo) * sh - pt, (r % wo) * sw - pl
        for k0 in range(0, K, plan.bk):
            tap, c0 = divmod(k0, c)
            ky, kx = divmod(tap, kw)
            hh, ww = wi + ky, wj + kx
            ok = (img < n) & (hh >= 0) & (hh < h) & (ww >= 0) & (ww < wd)
            box = np.zeros((wp.BM, plan.bk), np.int64)
            box[ok] = xn[img[ok], hh[ok], ww[ok], c0:c0 + plan.bk]
            acc[m0:m0 + wp.BM] += box @ wk[:, k0:k0 + plan.bk].T
    acc = torch.from_numpy(acc[:M].astype(np.float64)).float()
    y = (acc * m if b is None else (acc.double() * m.double() + b.double()).float())
    y = torch.clamp(torch.round(y), 0 if relu else -128, 127).to(torch.int8)
    return y.reshape(n, ho, wo, cout).permute(0, 3, 1, 2)


@pytest.mark.parametrize("geom", [(2, 9, 11, 64, 64, 3, 1, 1), (2, 21, 19, 128, 192, 3, 2, 1),
                                  (3, 16, 16, 256, 128, 1, 2, 0), (2, 10, 10, 96, 64, 1, 1, 0),
                                  (2, 19, 23, 3, 64, 7, 2, 3)])
@pytest.mark.parametrize("relu", [False, True])
def test_tile_walk_replay_equals_plain(geom, relu):
    """The replay of the tile walk, on the plan's form, K step and (for the
    stem) padded operands, equals `qlinear_conv_plain` on the original ones
    exactly: boxes crossing rows and images, stride 2 on odd maps, tiles
    past the last pixel."""
    n, h, wd, cin, cout, k, s, p = geom
    rng = np.random.default_rng(sum(geom))
    x = torch.from_numpy(rng.integers(-128, 128, (n, cin, h, wd), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (cout, cin, k, k), dtype=np.int8))
    m = torch.from_numpy((rng.uniform(0.5, 1.5, cout) * 0.0074 / np.sqrt(cin * k * k))
                         .astype(np.float32))
    b = torch.from_numpy(rng.uniform(-20, 20, cout).astype(np.float32))
    pads = ((p, p), (p, p))
    plan = wp.qconv_plan(n, h, wd, cin, cout, k, k, s, s, pads)
    assert plan.form != "mma" and plan.unfold == (cin < 16)
    xp, wpad, stride, pads_k = x, w, (s, s), pads
    if plan.unfold:
        xp = qc.unfold_input(x, k, s, (p, p), plan.c_in)
        wpad, stride, pads_k = qc.unfold_weight(w, plan.c_in), (s, 1), ((p, p), (0, 0))
    got = _replay(xp, wpad, m, b, stride, pads_k, relu, plan)
    want = qc.qlinear_conv_plain(x, w, m, b, stride=(s, s), pads=pads, relu=relu)
    assert torch.equal(got, want)
    assert len(torch.unique(want)) > 20


@pytest.mark.parametrize("geom", [(2, 3, 31, 29, 7, 2, 3), (1, 3, 17, 20, 3, 1, 1),
                                  (2, 5, 12, 13, 1, 1, 0), (1, 4, 9, 16, 5, 2, 2)])
def test_unfolded_stem_gives_the_plain_output(geom):
    """The stem's weight unfolded once (`padded_weight`, OHWI, channels-last)
    holds w[:, c, ky, kx] at channel kx * C + c of tap row ky and zeros past
    kw * C; the input unfolded alike, through a kh x 1 conv with stride
    (sh, 1) and no side pads, gives `qlinear_conv_plain`'s output
    unchanged."""
    n, c, h, wd, k, s, p = geom
    rng = np.random.default_rng(sum(geom))
    x = torch.from_numpy(rng.integers(-128, 128, (n, c, h, wd), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (64, c, k, k), dtype=np.int8))
    w = w.contiguous(memory_format=torch.channels_last)
    m = torch.full((64,), 0.0074 / (k * k * c) ** 0.5)
    b = torch.from_numpy(rng.uniform(-9, 9, 64).astype(np.float32))
    c_unf = -(-k * c // 32) * 32
    wu = qc.padded_weight(w)
    assert wu.shape == (64, c_unf, k, 1) and wu.dtype == torch.int8
    assert wu.is_contiguous(memory_format=torch.channels_last)
    for ky in range(k):
        for kx in range(k):
            assert torch.equal(wu[:, kx * c:(kx + 1) * c, ky, 0], w[:, :, ky, kx])
    assert not wu[:, k * c:].any()
    assert qc.padded_weight(w[:, :1].repeat(1, 32, 1, 1)) is None  # 32 channels: read as is
    xu = qc.unfold_input(x, k, s, (p, p), c_unf)
    wo = (wd + 2 * p - k) // s + 1
    assert xu.shape == (n, c_unf, h, wo) and xu.is_contiguous(memory_format=torch.channels_last)
    assert not xu[:, k * c:].any()
    want = qc.qlinear_conv_plain(x, w, m, b, stride=(s, s), pads=((p, p), (p, p)))
    got = qc.qlinear_conv_plain(xu, wu, m, b, stride=(s, 1), pads=((p, p), (0, 0)))
    assert torch.equal(got, want)
    assert len(torch.unique(want)) > 50


@pytest.mark.parametrize("bias", [True, False])
def test_relu_epilogue_is_relu_of_the_conv(bias):
    """`relu` clips at 0: the int8 Relu of the conv's output, and the CPU
    wrapper call (the plain version) takes it."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.integers(-128, 128, (2, 32, 9, 9), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (64, 32, 3, 3), dtype=np.int8))
    m = torch.full((64,), 0.0074 / 17)
    b = torch.from_numpy(rng.uniform(-20, 20, 64).astype(np.float32)) if bias else None
    kw = dict(stride=(1, 1), pads=((1, 1), (1, 1)))
    plain = qc.qlinear_conv_plain(x, w, m, b, **kw)
    fused = qc.qlinear_conv(x, w, m, b, relu=True, **kw)
    assert (plain < 0).sum() > 100
    assert torch.equal(fused, torch.relu(plain))
