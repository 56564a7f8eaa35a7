"""The SD-UNet compile-and-serve slice of smelter_tpu_torch against smelter_tpu.

The new op lowerings one node at a time (GroupNormalization in both layouts,
Split in its three forms, CrossAttnBlock); the port's SD-UNet builder
graph-equal to the JAX package's; `_prepare` node for node with
`fuse_vit_block`'s gate patched to 0 and the cross branch (`_CROSS_ENABLED`)
off and on in both packages, the fused counts asserted (a missing lowering
makes the pass a silent no-op), and the zoo's 256 px graph at the real gate;
and the small SD-UNet through `compile` and `serve` against the JAX
package's `CompiledModel`. The JAX side runs its Pallas kernels in interpret
mode on the CPU, as its own tests do; the port takes its kernels' plain
versions.
"""

import functools
import threading

import numpy as np
import pytest

import smelter_tpu as st
import smelter_tpu.passes.vit_block as jvbp
import smelter_tpu_torch as stt
import smelter_tpu_torch.passes.vit_block as tvbp
from smelter_tpu.api import _prepare as jax_prepare
from smelter_tpu.models import ZOO
from smelter_tpu.models import sd_unet as jsd
from smelter_tpu_torch.api import _prepare as torch_prepare
from smelter_tpu_torch.kernels import cross_attn_block as xa
from smelter_tpu_torch.kernels import vit_block as vb
from smelter_tpu_torch.models import sd_unet
from torch_port_common import _close, _one_op, assert_graphs_equal

# SD-UNet at test size: latent 16, base 32, 2 heads (D 32 and 64, below the
# 128 that the self-attention branch of fuse_vit_block takes); WIDE: base
# 128 and 8 heads as in the zoo (hd 16 at D 128, hd 32 at D 256) at latent 8.
SMALL = dict(batch=2, image_size=16, base=32, heads=2)
WIDE = dict(batch=2, image_size=8, base=128, ctx_dim=256, ctx_len=16, heads=8)
# constants that fold_constants computes (the timestep embedding's chain),
# each package with its own CPU lowerings: equal to f32 rounding
FOLDED_RTOL = 1e-6


@functools.lru_cache(maxsize=None)
def _unet_bytes(kind: str) -> tuple[bytes, tuple[int, ...]]:
    g, _m, shape = jsd.build(**(SMALL if kind == "small" else WIDE))
    return st.export_model(g), shape


@pytest.fixture
def gate_open(monkeypatch):
    monkeypatch.setattr(jvbp, "_MIN_TOKENS_X_DIM", 0)
    monkeypatch.setattr(tvbp, "_MIN_TOKENS_X_DIM", 0)


@pytest.fixture(params=[False, True], ids=["cross_off", "cross_on"])
def cross(request, monkeypatch):
    """`_CROSS_ENABLED` set alike on both packages' pass modules."""
    monkeypatch.setattr(jvbp, "_CROSS_ENABLED", request.param)
    monkeypatch.setattr(tvbp, "_CROSS_ENABLED", request.param)
    return request.param


def _prepared_pair(kind: str):
    data, shape = _unet_bytes(kind)
    gj = jax_prepare(st.import_model(data), None, True, "nhwc")
    gt = torch_prepare(stt.import_model(data), None, True, "nhwc")
    return gj, gt, shape


def _counts(g) -> dict:
    ops = [n.op_type for n in g.nodes]
    return {k: ops.count(k) for k in ("VitAttnBlock", "CrossAttnBlock", "FusedAttention",
                                      "GroupNormalization", "Split")}


# -- op lowerings ----------------------------------------------------------------

@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("config", [{}, {"compute_dtype": "bfloat16"}])
def test_group_norm_matches_jax(layout, config):
    rng = np.random.default_rng(0)
    shape = (2, 32, 6, 5) if layout == "NCHW" else (2, 6, 5, 32)
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    inits = {"s": (1 + 0.1 * rng.standard_normal(32)).astype(np.float32),
             "b": (0.1 * rng.standard_normal(32)).astype(np.float32)}
    attrs = {"num_groups": 8, "epsilon": 1e-5}
    if layout == "NHWC":
        attrs["data_layout"] = "NHWC"
    got, want = _one_op("GroupNormalization", {"x": x}, attrs, inits, **config)
    _close(got, want, 1e-2 if config else 1e-5)


@pytest.mark.parametrize("form", ["sizes_input", "sizes_attribute", "equal_chunks",
                                  "uneven_chunks"])
def test_split_matches_jax(form):
    x = np.random.default_rng(1).standard_normal((2, 5, 8)).astype(np.float32)
    attrs, inits, opset, n_out = {"axis": -1}, {}, 17, 2
    if form == "sizes_input":
        inits["split"] = np.array([3, 5], np.int64)
    elif form == "sizes_attribute":
        attrs["split"], opset = [6, 2], 11
    elif form == "uneven_chunks":
        n_out = 3  # 3, 3, 2
    got, want = _one_op("Split", {"x": x}, attrs, inits, n_out=n_out, opset=opset)
    assert len(got) == n_out
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("geom", [(2, 20, 128, 8, 16), (2, 12, 256, 8, 16)])
@pytest.mark.parametrize("bk", ["B", 1])
@pytest.mark.parametrize("config", [{}, {"compute_dtype": "bfloat16"}])
def test_cross_attn_block_op_matches_jax(geom, bk, config):
    """The op against the JAX op (the Pallas kernel in interpret mode): hd 16
    and 32, k/v per image and shared; f32 within 1e-5 relative, bf16 within
    1e-2 of the largest output."""
    B, N, D, H, S = geom
    rng = np.random.default_rng(3)
    hd, nk = D // H, B if bk == "B" else 1
    x = rng.standard_normal((B, N, D)).astype(np.float32)
    inits = {"wq": (rng.standard_normal((D, D)) / np.sqrt(D)).astype(np.float32),
             "k": rng.standard_normal((nk, H, S, hd)).astype(np.float32),
             "v": rng.standard_normal((nk, H, S, hd)).astype(np.float32),
             "wp": (rng.standard_normal((D, D)) / np.sqrt(D)).astype(np.float32),
             "bp": (0.1 * rng.standard_normal(D)).astype(np.float32)}
    got, want = _one_op("CrossAttnBlock", {"x": x}, {"num_heads": H, "scale": 0.0}, inits,
                        **config)
    _close(got, want, 1e-2 if config else 1e-5)
    assert xa.launches == 0


# -- graphs ----------------------------------------------------------------------

@pytest.mark.parametrize("kw", [SMALL, WIDE], ids=["small", "wide"])
def test_sd_unet_builder_matches_jax(kw):
    g, _m, shape = sd_unet.build(**kw)
    gj, _mj, shape_j = jsd.build(**kw)
    assert shape == shape_j
    assert_graphs_equal(gj, g)


def test_zoo_form_matches_jax():
    """build_zoo is the JAX package's ZOO["sd_unet"] (256 px -> latent 32)."""
    g, _m, shape = sd_unet.build_zoo(batch=1)
    gj, _mj, shape_j = ZOO["sd_unet"](batch=1)
    assert shape == shape_j == (1, 4, 32, 32)
    assert_graphs_equal(gj, g)


@pytest.mark.parametrize("kind", ["small", "wide"])
def test_prepared_sd_unet_matches_jax(gate_open, cross, kind):
    """Gate at 0: the self-attention fuses to VitAttnBlock where D is a
    multiple of 128 (wide), the cross-attention to CrossAttnBlock where the
    flag is on, each node for node with the JAX package."""
    gj, gt, _ = _prepared_pair(kind)
    assert_graphs_equal(gj, gt, folded_rtol=FOLDED_RTOL)
    want = {"VitAttnBlock": 5 if kind == "wide" else 0, "CrossAttnBlock": 5 if cross else 0,
            "GroupNormalization": 18, "Split": 5}
    want["FusedAttention"] = 10 - want["VitAttnBlock"] - want["CrossAttnBlock"]
    assert _counts(gt) == want


def test_zoo_sd_unet_prepares_as_jax_at_the_real_gate(cross):
    """The zoo's 256 px graph (latent 32, base 128) unpatched: 5 VitAttnBlock
    (1024 x 128 and 256 x 256 tokens x dim clear the 50,000 gate), and 5
    CrossAttnBlock with k/v baked at the batch where the flag is on."""
    g, _m, _ = ZOO["sd_unet"](batch=2)
    data = st.export_model(g)
    gj = jax_prepare(st.import_model(data), None, True, "nhwc")
    gt = torch_prepare(stt.import_model(data), None, True, "nhwc")
    assert_graphs_equal(gj, gt, folded_rtol=FOLDED_RTOL)
    counts = _counts(gt)
    assert counts["VitAttnBlock"] == 5 and counts["CrossAttnBlock"] == (5 if cross else 0)
    assert counts["FusedAttention"] == (0 if cross else 5)
    packs = sorted(gt.initializers[n.inputs[3]].shape for n in gt.nodes
                   if n.op_type == "VitAttnBlock")
    # two blocks at full resolution (D 128, hd 16), three at half (D 256, hd 32)
    assert packs == [(3, 128, 128)] * 2 + [(6, 256, 128)] * 3
    kv = sorted(gt.initializers[n.inputs[2]].shape for n in gt.nodes
                if n.op_type == "CrossAttnBlock")
    assert kv == ([(2, 8, 16, 16)] * 2 + [(2, 8, 16, 32)] * 3 if cross else [])


# -- compile and serve -------------------------------------------------------------

@pytest.mark.parametrize("kind,config", [("small", {}), ("small", {"compute_dtype": "bfloat16"}),
                                         ("wide", {})])
def test_sd_unet_compile_matches_jax(gate_open, cross, kind, config):
    """Each package's CompiledModel on its own prepared graph: f32 within
    1e-4 of the largest output, bf16 within 3e-2 of it."""
    gj, gt, shape = _prepared_pair(kind)
    x = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    want = np.asarray(st.CompiledModel(gj, st.Config(**config))(x)[0], np.float32)
    got = stt.CompiledModel(gt, stt.Config(device="cpu", **config))(x)[0]
    assert got.shape == want.shape and np.isfinite(got).all()
    rel = 3e-2 if config else 1e-4
    assert np.abs(got - want).max() <= rel * np.abs(want).max()
    assert xa.launches == 0 and vb.launches == 0


def test_sd_unet_serve_pads_to_its_baked_batch(cross):
    """serve(..., buckets=(2,)) on the graph whose context is baked at batch
    2 (one context a batch slot): three threaded requests, a short batch
    padded. Which slot a request takes depends on how the requests meet in
    batches, so each answer must equal the JAX package's output for its
    image in one of the two slots."""
    data, shape = _unet_bytes("small")
    xs = np.random.default_rng(5).standard_normal((3,) + shape[1:]).astype(np.float32)
    jm = st.compile(st.import_model(data), st.Config())
    want = [np.asarray(jm(np.stack([x, x]))[0]) for x in xs]  # image i in slots 0 and 1
    assert all(np.abs(w[0] - w[1]).max() > 1e-3 * np.abs(w).max() for w in want)
    server = stt.serve(stt.import_model(data), stt.Config(), device="cpu", max_batch=2,
                       buckets=(2,))
    got = [None] * len(xs)
    try:
        assert server.wait_ready(120)

        def ask(i):
            got[i] = server.infer(xs[i])[0]

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(len(xs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        stats = server.stats()
    finally:
        server.shutdown()
    assert stats["requests"] == 3 and stats["errors"] == 0 and stats["batches"] >= 2
    for g, w in zip(got, want):
        assert min(np.abs(g - w[s]).max() for s in (0, 1)) <= 1e-4 * np.abs(w).max()
