"""The Hopper attention core's shape-to-form choice and addressing, checked
without a card: `smelter_tpu_torch/kernels/attention_plan.py` (the form,
tiles, stages or buffers, grid and shared memory of `csrc/
wgmma_attention.cuh`'s two kernels for `vit_attention_block`, the ring,
`short_attention` and `flash_attention`, and the stride and alignment
conditions of its 4-D maps) and `wgmma_plan.block_plan` (which of
`vit_attention_block`'s projections run `gemm_tma`'s block epilogue); a
numpy replay of the TMA boxes the producers ask for (the packed QKV
weight's 3-D map, the per-image map of the (B, N, 3 D) QKV product, the
(hd, N, H, B) maps of (B, H, N, hd) views and contiguous tensors), each
landing on the element the earlier kernels address, with zeros past the
matrix; and a numpy model of the normalised softmax orders (one pass over
one or two 128-key tiles, two passes over resident tiles) through the
whole block, against `vit_attention_block_plain`."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from smelter_tpu_torch.kernels import attention_plan as ap
from smelter_tpu_torch.kernels import vit_block as vb
from smelter_tpu_torch.kernels import wgmma_plan as wp
from smelter_tpu_torch.passes.vit_block import pack_qkv_weights

HEADER = (Path(__file__).resolve().parents[1] / "smelter_tpu_torch" / "csrc"
          / "wgmma_attention.cuh").read_text()

# (B, N, heads, hd): the paths' shapes (ViT-B/16 at b128, SD-UNet's two
# self-attentions at b8), the card tests' N at every head dim, and odd ones
PATH_SHAPES = [(128, 197, 12, 64), (8, 1024, 8, 16), (8, 256, 8, 32)]
TEST_NS = [1, 63, 64, 65, 197, 256, 257, 577, 1024]
SHAPES = PATH_SHAPES + [(2, n, 4, hd) for n in TEST_NS for hd in ap.HEAD_DIMS] + [
    (1, 385, 2, 128), (3, 769, 2, 64), (1, 1664, 4, 32), (1, 1665, 4, 32), (1, 3456, 2, 16)]


@pytest.mark.parametrize("B,N,heads,hd", SHAPES)
def test_vit_plan_fits_and_covers(B, N, heads, hd):
    """Every key in a resident tile, shared memory within 227 KB, the grid
    no larger than the card or the work; what does not fit goes to mma."""
    p = ap.vit_plan(B, N, heads, hd, sixteen_bit=True)
    tiles = ap.cdiv(N, ap.KEY_TILE)
    staged = ap.STAGED if tiles == 2 else 0
    fits = 1024 + ap.norm_buffer(hd, tiles) + 16 + staged <= ap.SMEM_LIMIT
    if not fits:
        assert p == ap.MMA and p.code == 0
        return
    assert p.form == ("one_pass" if tiles <= 2 else "resident") and p.code == 1
    assert (p.consumers, p.key_tile, p.tiles) == (2, 128, tiles)
    assert p.tiles * p.key_tile >= N > (p.tiles - 1) * p.key_tile
    assert p.stages in (1, 2) and p.smem == ap.norm_smem(hd, tiles, p.stages)
    assert p.smem <= ap.SMEM_LIMIT
    if p.stages == 1:  # a second buffer would not fit
        assert ap.norm_smem(hd, tiles, 2) > ap.SMEM_LIMIT
    items = B * heads * ap.cdiv(N, ap.Q_ROWS)
    assert p.grid == min(items, ap.SMS)
    # f32 (and head dims the core has no swizzle for) keep the earlier kernels
    assert ap.vit_plan(B, N, heads, hd, sixteen_bit=False) == ap.MMA
    assert ap.vit_plan(B, N, heads, 48, sixteen_bit=True) == ap.MMA


def test_vit_plan_at_the_paths_shapes():
    """ViT-B/16's 197 keys and SD-UNet's 256 take one pass over two tiles
    (the first's exps staged), SD-UNet's 1,024 eight resident tiles and two
    passes; the limits of shared memory: hd 64 to 768 keys, hd 128 to 384,
    then today's kernels."""
    got = [ap.vit_plan(*s, sixteen_bit=True) for s in PATH_SHAPES]
    assert [(p.form, p.tiles, p.stages, p.grid, p.smem) for p in got] == [
        ("one_pass", 2, 2, 132, 230_432), ("resident", 8, 2, 132, 140_320),
        ("one_pass", 2, 2, 128, 148_512)]
    assert ap.STAGED == 65_536
    assert ap.vit_plan(2, 128, 4, 64, sixteen_bit=True).form == "one_pass"
    assert (ap.vit_plan(1, 768, 12, 64, sixteen_bit=True).form,
            ap.vit_plan(1, 769, 12, 64, sixteen_bit=True).form) == ("resident", "mma")
    assert (ap.vit_plan(1, 384, 4, 128, sixteen_bit=True).form,
            ap.vit_plan(1, 385, 4, 128, sixteen_bit=True).form) == ("resident", "mma")
    assert ap.vit_plan(1, 577, 12, 64, sixteen_bit=True).stages == 1
    assert ap.vit_plan(128, 197, 12, 64, sixteen_bit=True, sms=64).grid == 64


@pytest.mark.parametrize("hd,stages,smem", [(32, 4, 74_824), (64, 4, 148_552),
                                            (128, 3, 230_456)])
def test_ring_plan(hd, stages, smem):
    """The ring's N 32,768 over 4 ranks: 8,192 query rows of 16 heads a
    step, 1,024 CTAs; stages as many as fit, at most 4."""
    p = ap.ring_plan(8192, 16, hd, sixteen_bit=True)
    assert (p.form, p.code, p.key_tile, p.stages, p.grid, p.smem) == (
        "streaming", 1, 128, stages, 1024, smem)
    assert p.smem <= ap.SMEM_LIMIT
    assert ap.ring_plan(37, 6, hd, sixteen_bit=True).grid == 6
    assert ap.ring_plan(8192, 16, hd, sixteen_bit=False) == ap.MMA
    assert ap.ring_plan(8192, 16, 16, sixteen_bit=True) == ap.MMA


def test_plan_constants_are_the_headers():
    nums = dict(re.findall(r"\b(WG_ROWS|NCONS|KT|SMEM_LIMIT)\s*=\s*(\d+);", HEADER))
    assert {k: int(v) for k, v in nums.items()} == {
        "WG_ROWS": ap.WG_ROWS, "NCONS": ap.CONSUMERS, "KT": ap.KEY_TILE,
        "SMEM_LIMIT": ap.SMEM_LIMIT}
    assert re.search(r"THREADS = 128 \* \(NCONS \+ 1\);", HEADER)
    # the stage and buffer formulas the plan mirrors
    assert "return 1024 + Q_BYTES + 8;" in HEADER and "return 2 * KV_BYTES + 16;" in HEADER
    assert "return Q_BYTES + 2 * tiles * KV_BYTES;" in HEADER
    assert "return 1024 + buffers * (buffer(tiles) + 16) + (tiles == 2 ? STAGED : 0);" in HEADER
    assert "STAGED = NCONS * WG_ROWS * KT * 4;" in HEADER
    assert re.search(r"STAGES = \(SMEM_LIMIT - fixed\(\)\) / stage\(\) > 4", HEADER)


def test_block_plan():
    """vit_attention_block's projections: ViT-B/16 b128's QKV product in
    197 x 18 = 3,546 tiles and its projection in 1,182, both on gemm_tma;
    what its maps cannot read goes to gemm.cuh."""
    qkv = wp.block_plan(25216, 2304, 768, group=128)
    proj = wp.block_plan(25216, 768, 768)
    assert (qkv.form, qkv.code, qkv.grid, qkv.smem) == ("tma", 1, 132, wp.tma_smem(128, False))
    assert wp.cdiv(25216, wp.BM) * wp.cdiv(2304, wp.TMA_BN) == 3546
    assert wp.cdiv(25216, wp.BM) * wp.cdiv(768, wp.TMA_BN) == 1182
    assert proj.form == "tma" and proj.smem <= wp.SMEM_LIMIT
    # SD-UNet's at b8: few tiles, still gemm_tma (the alternative tiles alike)
    assert (wp.block_plan(8192, 128, 128).form, wp.block_plan(2048, 256, 256).grid) == ("tma", 32)
    assert wp.block_plan(100, 576, 192, group=96).form == "mma"      # G % 64
    assert wp.block_plan(64, 384, 128, group=128).form == "mma"      # M < 128
    assert wp.block_plan(600, 96, 96).form == "mma"                  # N < 128
    assert wp.block_plan(600, 768, 768, aligned=False).form == "mma"
    assert wp.block_plan(600, 768, 764).form == "mma"                # K % 8
    assert wp.block_plan(600, 768, 768, group=128).code == 1
    assert wp.block_plan(64, 768, 768).code == 0
    # the wrapper's three plans; f32 keeps every earlier kernel
    plans = vb.plans(128, 197, 768, 12, torch.bfloat16)
    assert [p.form for p in plans] == ["tma", "tma", "one_pass"]
    assert [p.form for p in vb.plans(128, 197, 768, 12, torch.float32)] == ["mma", "mma", "mma"]
    assert [p.code for p in vb.legacy_plans()] == [0, 0, 0]


# -- the TMA walks, replayed ------------------------------------------------

def _box(arr, coords, box):
    """What a TMA load of a 3-D map over arr (d2, d1, d0) returns for the
    box at coords (c0 innermost, c1, c2): zeros where it runs past a dim."""
    (c0, c1, c2), (b0, b1, b2) = coords, box
    out = np.zeros((b2, b1, b0), arr.dtype)
    d2, d1, d0 = arr.shape
    src = arr[max(c2, 0):min(c2 + b2, d2), max(c1, 0):min(c1 + b1, d1),
              max(c0, 0):min(c0 + b0, d0)]
    out[:src.shape[0], :src.shape[1], :src.shape[2]] = src
    return out


@pytest.mark.parametrize("D,heads", [(768, 12), (128, 8), (256, 8), (512, 4), (256, 2)])
def test_packed_weight_map_replay(D, heads):
    """gemm_tma's kEpiQkv producer: for each tile n0, atom j and K step
    kt, the box (64 x 64) at (n % G, kt BK, n / G) of the (3 n_groups, D,
    G) map, laid side by side, is the (D, 3 D) matrix gemm.cuh's b_offset
    addresses (block n / G, row k, column n % G), with zeros past 3 D."""
    hd = D // heads
    G = vb.head_group(heads, hd) * hd
    w = np.arange(3 * D * D, dtype=np.int64).reshape(D, 3 * D)
    wpk, _ = pack_qkv_weights(w, np.zeros(3 * D, np.int64), heads)
    assert wpk.shape == (3 * D // G, D, G) and G % wp.ATOM == 0
    p = wp.block_plan(4096, 3 * D, D, group=G)
    assert p.form == "tma"
    N = 3 * D
    n_tiles = wp.cdiv(N, p.bn)
    got = np.full((wp.cdiv(D, wp.BK) * wp.BK, n_tiles * p.bn), -1, np.int64)
    for nt in range(n_tiles):
        n0 = nt * p.bn
        for kt in range(wp.cdiv(D, wp.BK)):
            for j in range(p.bn // wp.ATOM):
                n = n0 + j * wp.ATOM
                box = _box(wpk, (n % G, kt * wp.BK, n // G), (wp.ATOM, wp.BK, 1))[0]
                got[kt * wp.BK:(kt + 1) * wp.BK, n:n + wp.ATOM] = box
    k, n = np.meshgrid(np.arange(D), np.arange(N), indexing="ij")
    want = wpk[n // G, k, n % G]  # gemm.cuh's b_offset
    assert np.array_equal(got[:D, :N], want)
    # the plain version's (D, 3 D) view of the packed weight is the same matrix
    assert np.array_equal(want, np.transpose(wpk, (1, 0, 2)).reshape(D, -1))
    assert (got[D:] == 0).all() and (got[:, N:] == 0).all()


@pytest.mark.parametrize("B,N,D,heads", [(2, 197, 768, 12), (1, 1024, 128, 8), (2, 256, 256, 8),
                                         (2, 65, 512, 4), (3, 1, 192, 6)])
def test_qkv_map_replay(B, N, D, heads):
    """attn_norm's producer: for each work item (image b, head h, row
    block r), q, k and v, each part of a row and each key tile, the box at
    (3 pair G + {0, G, 2 G} + hl hd + part, row0, b) of the (B, N, 3 D)
    map is what vit_block.cu's attention_mma reads for that head (row b N +
    i, column qc / kc / vc + d), and the plain version's q, k, v; rows past
    N read zeros, never the next image's."""
    hd = D // heads
    group = vb.head_group(heads, hd)
    G = group * hd
    parts = 2 if hd > 64 else 1
    pc = hd // parts
    qkv = np.arange(B * N * 3 * D, dtype=np.int64).reshape(B, N, 3 * D) + 1
    plain = torch.from_numpy(qkv).reshape(B, N, heads // group, 3, group, hd)
    q, k, v = (plain[:, :, :, i].reshape(B, N, heads, hd).transpose(1, 2).numpy()
               for i in range(3))
    tiles = ap.cdiv(N, ap.KEY_TILE)
    for b in range(B):
        for h in range(heads):
            pair, hl = divmod(h, group)
            qc = 3 * pair * G + hl * hd  # vit_block.cu's attention_mma
            for which, c, ref in ((0, qc, q), (1, qc + G, k), (2, qc + 2 * G, v)):
                assert c == 3 * (h // group) * G + (h % group) * hd + which * G
                rows, starts = ((ap.Q_ROWS, range(0, N, ap.Q_ROWS)) if which == 0 else
                                (ap.KEY_TILE, [t * ap.KEY_TILE for t in range(tiles)]))
                for r0 in starts:
                    tile = np.concatenate([_box(qkv, (c + p * pc, r0, b), (pc, rows, 1))[0]
                                           for p in range(parts)], axis=1)
                    live = min(rows, N - r0)
                    assert np.array_equal(tile[:live], ref[b, h, r0:r0 + live])
                    assert np.array_equal(
                        tile[:live], qkv[b, r0:r0 + live, c:c + hd])
                    assert (tile[live:] == 0).all()


# -- the normalised orders, modelled in numpy -------------------------------

def _bf16(a):
    """Round f32 to bf16 (nearest, ties to even), kept in f32."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.view(np.float32)


def _attention_model(q, k, v, scale, rnd):
    """attn_norm's arithmetic for one head: q, k, v (N, hd) f32 holding
    values of the 16-bit type; scores in f32 tile by tile (128 keys); one
    tile: max, then exp and its sum, then p = e * (1 / sum); two: tile 0's
    e0 = e^(s0 - m0) kept, tile 1's e1 = e^(s1 - m) with m = max(m0, m1),
    l = l0 e^(m0 - m) + sum e1, p = e1 (1 / l) and e0 (e^(m0 - m) (1 / l));
    more: pass 1 carries the row max and sum across tiles (l = l e^(m -
    m_new) + sum e^(s - m_new)), pass 2 recomputes each tile's scores, p =
    e^(s - m) (1 / l); p rounded (`rnd`) before p v, sums in f32."""
    N = q.shape[0]
    kt = ap.KEY_TILE
    tiles = ap.cdiv(N, kt)

    def s_of(t):
        s = (q @ k[t * kt:(t + 1) * kt].T).astype(np.float32) * np.float32(scale)
        return np.concatenate([s, np.full((N, kt - s.shape[1]), -np.inf, np.float32)], 1)

    o = np.zeros((N, v.shape[1]), np.float32)
    vpad = np.concatenate([v, np.zeros((tiles * kt - N, v.shape[1]), np.float32)])
    if tiles == 1:
        s = s_of(0)
        m = s.max(1, keepdims=True)
        e = np.exp(s - m)
        p = rnd(e * (np.float32(1) / e.sum(1, keepdims=True)))
        return (p @ vpad).astype(np.float32)
    if tiles == 2:
        s0, s1 = s_of(0), s_of(1)
        m0 = s0.max(1, keepdims=True)
        e0 = np.exp(s0 - m0)
        m = np.maximum(m0, s1.max(1, keepdims=True))
        e1 = np.exp(s1 - m)
        a0 = np.exp(m0 - m)
        l = e0.sum(1, keepdims=True) * a0 + e1.sum(1, keepdims=True)
        inv = np.float32(1) / l
        return (rnd(e1 * inv) @ vpad[kt:] + rnd(e0 * (a0 * inv)) @ vpad[:kt]).astype(np.float32)
    m = np.full((N, 1), -np.inf, np.float32)
    l = np.zeros((N, 1), np.float32)
    for t in range(tiles):
        s = s_of(t)
        mn = np.maximum(m, s.max(1, keepdims=True))
        l = l * np.exp(m - mn) + np.exp(s - mn).sum(1, keepdims=True)
        m = mn
    inv = np.float32(1) / l
    for t in range(tiles):
        p = rnd(np.exp(s_of(t) - m) * inv)
        o += p @ vpad[t * kt:(t + 1) * kt]
    return o


@pytest.mark.parametrize("N", [197, 1024, 100, 300])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_normalised_orders_match_the_plain_block(N, dtype):
    """The block with the model's attention (N 197: two tiles in one pass,
    as ViT-B/16; 1,024: eight resident tiles, as SD-UNet; 100: one tile;
    300: three resident tiles) against
    vit_attention_block_plain. f32: the same products in other orders,
    1e-5 x max|plain|; bf16: q, k, v, p and the output rounded alike, sums
    in other orders, 1e-2 x max|plain| (the card tests' bound)."""
    B, D, heads = 2, 64, 2
    hd = D // heads
    rng = np.random.default_rng(N)
    x = rng.standard_normal((B, N, D)).astype(np.float32) * 0.5
    wqkv = (rng.standard_normal((D, 3 * D)) / np.sqrt(D)).astype(np.float32)
    bqkv = (rng.standard_normal(3 * D) * 0.02).astype(np.float32)
    wp_ = (rng.standard_normal((D, D)) / np.sqrt(D)).astype(np.float32)
    bp = (rng.standard_normal(D) * 0.02).astype(np.float32)
    g = (rng.standard_normal(D) * 0.1 + 1).astype(np.float32)
    b = (rng.standard_normal(D) * 0.1).astype(np.float32)
    wpk, bpk = pack_qkv_weights(wqkv, bqkv, heads)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (x, g, b, wpk, bpk, wp_, bp)]
    args = [t[0].to(dtype), t[1], t[2], t[3].to(dtype), t[4], t[5].to(dtype), t[6]]
    want = vb.vit_attention_block_plain(*args, heads=heads, eps=1e-6)
    rnd = _bf16 if dtype == torch.bfloat16 else (lambda a: a)
    # the launches around attention as the plain version computes them
    xn = vb.layer_norm_plain(args[0], args[1], args[2], eps=1e-6)
    w = args[3].permute(1, 0, 2).reshape(D, -1)
    qkv = (xn.reshape(B * N, D).float() @ w.float() + args[4].reshape(-1)).to(dtype)
    group = vb.head_group(heads, hd)
    qkv = qkv.reshape(B, N, heads // group, 3, group, hd).float().numpy()
    attn = np.zeros((B, N, D), np.float32)
    for bi in range(B):
        for h in range(heads):
            q, k, v = (qkv[bi, :, h // group, i, h % group] for i in range(3))
            attn[bi, :, h * hd:(h + 1) * hd] = _attention_model(q, k, v, hd ** -0.5, rnd)
    a = torch.from_numpy(rnd(attn)).reshape(B * N, D)
    got = (a @ args[5].float() + args[6]).to(dtype).reshape(B, N, D)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item(), err


# -- short_attention's and flash_attention's plans ----------------------------

def _hf_strides(B, H, N, hd):
    """The (batch, head, row) element strides of a (B, H, N, hd) view of a
    (B, N, H, hd) tensor, for q, k, v and out (empty_like keeps them)."""
    return [(N * H * hd, hd, H * hd)] * 4


def _contiguous_strides(B, H, N, hd):
    return [(H * N * hd, N * hd, hd)] * 4


EDGE_NS = [1, 127, 128, 129, 200, 256, 257, 512]
EDGE_HDS = [16, 32, 64, 80, 128]


def test_short_and_flash_plans_at_the_paths_shapes():
    """ViT-B/16 224 px b128 (HF views): one pass over two tiles on the
    persistent grid; 384 px b64 and the auto-flash shapes: the streaming
    form, one CTA a (128 rows, batch, head)."""
    bf16 = torch.bfloat16
    p = ap.short_plan(128, 12, 197, 64, _hf_strides(128, 12, 197, 64), bf16)
    assert (p.form, p.code, p.tiles, p.stages, p.grid, p.smem) == (
        "one_pass", 1, 2, 2, 132, 230_432)
    assert p == ap.vit_plan(128, 197, 12, 64, sixteen_bit=True)  # the ViT block's attention
    for B, N, grid in ((64, 577, 5 * 768), (2, 2048, 16 * 24), (2, 4096, 32 * 24)):
        p = ap.flash_plan(B, 12, N, N, 64, _hf_strides(B, 12, N, 64), bf16)
        assert (p.form, p.code, p.stages, p.grid, p.smem) == ("streaming", 1, 4, grid, 148_552)
        assert p == ap.flash_plan(B, 12, N, N, 64, _contiguous_strides(B, 12, N, 64), bf16)
    assert ap.short_plan(128, 12, 197, 64, _hf_strides(128, 12, 197, 64), bf16, sms=100).grid \
        == 100


@pytest.mark.parametrize("N", EDGE_NS)
@pytest.mark.parametrize("hd", EDGE_HDS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("layout", ["hf", "contiguous"])
def test_short_plan_edges(N, hd, dtype, layout):
    """The normalised form for 16-bit operands at hd 16, 32, 64, 128, one
    pass up to 256 keys, resident tiles past that, where K and V fit (hd
    128 to 384 keys); shared memory as the header sizes it, within 227 KB;
    everything else "mma"."""
    strides = (_hf_strides if layout == "hf" else _contiguous_strides)(2, 3, N, hd)
    p = ap.short_plan(2, 3, N, hd, strides, dtype)
    tiles = ap.cdiv(N, ap.KEY_TILE)
    if dtype == torch.float32 or hd not in ap.HEAD_DIMS or (hd == 128 and N > 384):
        assert p == ap.MMA and p.code == 0
        return
    assert p.form == ("one_pass" if N <= 256 else "resident") and p.code == 1
    assert p.tiles == tiles and p.tiles * p.key_tile >= N > (p.tiles - 1) * p.key_tile
    assert p.smem == ap.norm_smem(hd, tiles, p.stages) <= ap.SMEM_LIMIT
    assert p.grid == min(2 * 3 * ap.cdiv(N, ap.Q_ROWS), ap.SMS)


@pytest.mark.parametrize("Nq,Nk", [(n, n) for n in EDGE_NS] + [(1, 512), (577, 65), (129, 4096)])
@pytest.mark.parametrize("hd", EDGE_HDS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_flash_plan_edges(Nq, Nk, hd, dtype):
    """The streaming form for 16-bit operands at hd 32, 64, 128 and any Nq,
    Nk (Nq != Nk both ways): a grid of (Nq / 128, B H), the header's stages
    and shared memory; f32, hd 16 and 80 "mma"."""
    strides = [(Nq * 3 * hd, hd, 3 * hd), (Nk * 3 * hd, hd, 3 * hd), (Nk * 3 * hd, hd, 3 * hd),
               (Nq * 3 * hd, hd, 3 * hd)]
    p = ap.flash_plan(2, 3, Nq, Nk, hd, strides, dtype)
    if dtype == torch.float32 or hd not in ap.STREAM_HEAD_DIMS:
        assert p == ap.MMA and p.code == 0
        return
    assert (p.form, p.code, p.key_tile) == ("streaming", 1, ap.KEY_TILE)
    assert p.grid == ap.cdiv(Nq, ap.Q_ROWS) * 6
    assert p.stages == ap.stream_stages(hd) and p.smem == ap.stream_smem(hd) <= ap.SMEM_LIMIT


@pytest.mark.parametrize("which", ["q", "k", "v", "out"])
@pytest.mark.parametrize("bad", ["row", "head", "batch", "zero", "base"])
def test_plans_refuse_what_tma_cannot_take(which, bad):
    """A stride that is not a 16-byte multiple (an odd element count), a zero
    stride, or a base off 16 bytes sends either call to "mma"; the rest of
    the operands as the HF graph hands them over."""
    B, H, N, hd = 2, 4, 197, 64
    strides = [list(s) for s in _hf_strides(B, H, N, hd)]
    i = "q k v out".split().index(which)
    if bad == "zero":
        strides[i][0] = 0
    elif bad != "base":
        strides[i]["batch head row".split().index(bad)] += 4  # 8 bytes: not a multiple of 16
    aligned = bad != "base"
    bf16 = torch.bfloat16
    assert ap.short_plan(B, H, N, hd, strides, bf16, aligned=aligned) == ap.MMA
    assert ap.flash_plan(B, H, N, N, hd, strides, bf16, aligned=aligned) == ap.MMA
    assert ap.short_plan(B, H, N, hd, _hf_strides(B, H, N, hd), bf16).code == 1
    assert not ap.views_ok(strides, aligned=aligned)
    assert ap.views_ok([(2 ** 38, 8, 8)]) and not ap.views_ok([(2 ** 39, 8, 8)])


def test_flash_plan_grid_limit():
    """B H past a launch's grid.y keeps the earlier kernel's (Nq, H, B) grid."""
    s = _contiguous_strides(1, 1, 64, 64)
    assert ap.flash_plan(1, 65_535, 64, 64, 64, s, torch.bfloat16).form == "streaming"
    assert ap.flash_plan(2, 65_535, 64, 64, 64, s, torch.bfloat16) == ap.MMA


def test_views_and_entry_points_in_the_sources():
    """The header's 4-D maps and view checks, and the entry points' form
    arguments, as the wrappers pass them."""
    csrc = Path(__file__).resolve().parents[1] / "smelter_tpu_torch" / "csrc"
    gemm = (csrc / "wgmma_gemm.cuh").read_text()
    assert "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier" in gemm
    assert "static int make_map_4d(" in gemm
    assert "return reinterpret_cast<uintptr_t>(base) % 16 == 0 && ok(v.b) && ok(v.h) && ok(v.n);" \
        in HEADER
    assert "s > 0 && s % 8 == 0 && s < (1LL << 39)" in HEADER  # views_ok's, in elements
    assert re.search(r"int x_dtype,\s+int form, int tiles, int buffers, int grid,",
                     (csrc / "attention_short.cu").read_text())
    assert re.search(r"int x_dtype, int form, void\* stream\)",
                     (csrc / "flash_attention.cu").read_text())


# -- the 4-D maps, replayed ---------------------------------------------------

def _box4(flat, base, dims, strides, coords, box):
    """What a TMA load of a 4-D map (dims d0 innermost .. d3, element
    strides s1 .. s3 of dims 1 .. 3) over `flat` returns for the box (b0,
    b1, 1, 1) at coords: zeros where it runs past a dim."""
    (c0, c1, c2, c3), (b0, b1) = coords, box
    out = np.zeros((b1, b0), flat.dtype)
    for r in range(b1):
        for d in range(b0):
            if c1 + r < dims[1] and c0 + d < dims[0]:
                out[r, d] = flat[base + c3 * strides[2] + c2 * strides[1] + (c1 + r) * strides[0]
                                 + c0 + d]
    return out


@pytest.mark.parametrize("hd", [16, 64, 128])
@pytest.mark.parametrize("layout", ["hf", "contiguous"])
@pytest.mark.parametrize("N", [1, 65, 197])
def test_view_map_replay(hd, layout, N):
    """attn_norm's kViews producer and attn_stream's: for each (image,
    head), row block and key tile, the box of each part at (part columns,
    row0, h, b) of the (hd, N, H, B) map at the view's strides is the
    view's q, k or v, with zeros past N (never the next head's or image's
    rows)."""
    B, H = 2, 3
    parts = 2 if hd > 64 else 1
    pc = hd // parts
    if layout == "hf":
        t = torch.arange(B * N * H * hd, dtype=torch.int64).reshape(B, N, H, hd) + 1
        view = t.permute(0, 2, 1, 3)
    else:
        view = torch.arange(B * H * N * hd, dtype=torch.int64).reshape(B, H, N, hd) + 1
    flat = view.contiguous().numpy().ravel() if layout == "contiguous" else t.numpy().ravel()
    sb, sh, sn = view.stride(0), view.stride(1), view.stride(2)
    assert ap.views_ok([(sb, sh, sn)])
    dims = (hd, N, H, B)
    ref = view.numpy()
    for b in range(B):
        for h in range(H):
            for rows in (ap.Q_ROWS, ap.KEY_TILE):
                for r0 in range(0, N, rows):
                    tile = np.concatenate([_box4(flat, 0, dims, (sn, sh, sb), (p * pc, r0, h, b),
                                                 (pc, rows)) for p in range(parts)], axis=1)
                    live = min(rows, N - r0)
                    assert np.array_equal(tile[:live], ref[b, h, r0:r0 + live])
                    assert (tile[live:] == 0).all()
