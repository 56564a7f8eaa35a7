"""The port's ring layer against the JAX package's on the conftest's virtual
8-device CPU mesh: `parallel/mesh.py` (MeshPlan's shapes, sharding),
`parallel/ring_attention.py` (the plain SPMD ring) and the plain versions of
the three ring kernels (`collective_matmul_ag`, `_rs`,
`ring_attention_rdma`) through the port's full-array wrappers, against the
Pallas kernels in interpret mode. The same numpy inputs, made from a seed,
go to both packages; the port's mesh is W ranks on the CPU.

Tolerances: f32 1e-5 of the largest output (the sums run in another order);
bf16 1e-2 of the largest output (both round each output once to bf16 from
f32 sums taken in another order: an ulp); int8 bit-equal, including the
outputs whose int32 sum wraps when cast to int8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from smelter_tpu.kernels import collective_matmul as jcm
from smelter_tpu.kernels import ring_attention_rdma as jra
from smelter_tpu.parallel import MeshPlan as JaxMeshPlan
from smelter_tpu.parallel import sequence_sharded_attention as jax_ssa
from smelter_tpu_torch import MeshPlan
from smelter_tpu_torch.kernels import collective_matmul as cm
from smelter_tpu_torch.kernels import ring_attention_rdma as ra
from smelter_tpu_torch.parallel import Mesh, Ring, ShardedTensor, sequence_sharded_attention

WIDTHS = [1, 2, 4, 8]


def _meshes(n, axis):
    return JaxMesh(np.asarray(jax.devices()[:n]), (axis,)), Mesh(["cpu"] * n, (axis,))


def _close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _operands(rng, shape_x, shape_w, dtype):
    if dtype == "int8":
        x = rng.integers(-127, 128, shape_x).astype(np.int8)
        w = rng.integers(-127, 128, shape_w).astype(np.int8)
        return x, w, x, w
    x = rng.standard_normal(shape_x).astype(np.float32)
    w = (rng.standard_normal(shape_w) * 0.3).astype(np.float32)
    if dtype == "bf16":
        return (x.astype(jnp.bfloat16), w.astype(jnp.bfloat16),
                torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16())
    return x, w, x, w


@pytest.mark.parametrize("n,tp", [(1, None), (2, None), (3, None), (4, None), (6, None),
                                  (8, None), (8, 1), (8, 2), (8, 4), (6, 2), (4, 1), (2, 2)])
def test_meshplan_shapes_match_jax(n, tp):
    want = JaxMeshPlan.for_devices(n, tp=tp, devices=jax.devices()[:n])
    got = MeshPlan.for_devices(n, tp=tp, devices=["cpu"] * n)
    assert got.mesh.shape == dict(want.mesh.shape)
    assert (got.tp_size, got.dp_size) == (want.tp_size, want.dp_size)
    assert got.mesh.axis_names == tuple(want.mesh.axis_names)


@pytest.mark.parametrize("n_devices,given", [(2, 8), (4, 8), (8, 4), (1, 6)])
def test_meshplan_reads_all_given_devices_as_jax(n_devices, given):
    """Given `devices`, both packages take all of them and do not read
    `n_devices`."""
    want = JaxMeshPlan.for_devices(n_devices, devices=jax.devices()[:given])
    got = MeshPlan.for_devices(n_devices, devices=["cpu"] * given)
    assert got.mesh.shape == dict(want.mesh.shape)
    assert got.mesh.size == given


def test_meshplan_without_devices_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default devices are valid")
    with pytest.raises(RuntimeError, match="devices="):
        MeshPlan.for_devices(4)


def test_shard_and_full_round_trip_on_a_2d_mesh():
    plan = MeshPlan.for_devices(8, tp=4, devices=["cpu"] * 8)
    x = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    shards = plan.mesh.shard(x, ("dp", "tp"))
    assert [tuple(s.shape) for s in shards] == [(4, 3)] * 8
    assert torch.equal(shards[5], x[4:8, 3:6])  # rank 5 = (dp 1, tp 1)
    st = ShardedTensor(shards, plan.mesh, ("dp", "tp"), (8, 12))
    assert torch.equal(st.full(), x)
    assert plan.mesh.shard(st, ("dp", "tp"))[3] is shards[3]  # already cut so: passed on
    assert [r.ranks for r in plan.mesh.rings("tp")] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert [r.ranks for r in plan.mesh.rings("dp")] == [[0, 4], [1, 5], [2, 6], [3, 7]]
    with pytest.raises(ValueError, match="does not split"):
        plan.mesh.shard(torch.zeros(8, 10), (None, "tp"))


def test_sequence_sharded_attention_matches_jax(eight_devices):
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((2, 4, 256, 64)).astype(np.float32) for _ in range(3))
    jmesh, mesh = _meshes(8, "sp")
    want = np.asarray(jax_ssa(q, k, v, jmesh, scale=0.125))
    got = sequence_sharded_attention(q, k, v, mesh, scale=0.125)
    assert got.spec == (None, None, "sp", None) and got.shape == (2, 4, 256, 64)
    assert [tuple(s.shape) for s in got.shards] == [(2, 4, 32, 64)] * 8
    _close(got.numpy(), want, 1e-5)


def test_sequence_sharded_attention_extreme_logits_match_jax(eight_devices):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((1, 2, 128, 32)).astype(np.float32) * 20
    k = rng.standard_normal((1, 2, 128, 32)).astype(np.float32) * 20
    v = rng.standard_normal((1, 2, 128, 32)).astype(np.float32)
    jmesh, mesh = _meshes(8, "sp")
    want = np.asarray(jax_ssa(q, k, v, jmesh, scale=1.0))
    got = sequence_sharded_attention(q, k, v, mesh, scale=1.0).numpy()
    assert np.isfinite(got).all()
    # Logits reach ~9e3, where an f32 ulp is ~1e-3: the two packages' dot
    # products, summed in other orders, move a softmax weight by up to that
    # relative amount, so 1e-3 of the largest output here (1e-5 above).
    _close(got, want, 1e-3)


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_allgather_matmul_matches_jax(n, dtype):
    """Odd M/P (3), K (20) and N/P (5)."""
    rng = np.random.default_rng(n)
    jx, jw, x, w = _operands(rng, (3 * n, 20), (20, 5 * n), dtype)
    jmesh, mesh = _meshes(n, "tp")
    want = np.asarray(jcm.tp_allgather_matmul(jx, jw, jmesh)).astype(np.float32)
    got = cm.tp_allgather_matmul(x, w, mesh)
    assert got.shards[0].dtype == (torch.bfloat16 if dtype == "bf16" else torch.float32)
    _close(got.full().float().numpy(), want, 1e-5 if dtype == "f32" else 1e-2)


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_reducescatter_matmul_matches_jax(n, dtype):
    """Odd M/P (5), K/P (3) and N (7); int8 bit-equal, its sums past 127
    saturating as the JAX kernel's cast does."""
    rng = np.random.default_rng(10 + n)
    jx, jw, x, w = _operands(rng, (5 * n, 3 * n), (3 * n, 7), dtype)
    jmesh, mesh = _meshes(n, "tp")
    want = np.asarray(jcm.tp_reducescatter_matmul(jx, jw, jmesh))
    got = cm.tp_reducescatter_matmul(x, w, mesh)
    if dtype == "int8":
        assert got.shards[0].dtype == torch.int8 and np.array_equal(got.numpy(), want)
        assert np.abs(want).max() == 127 or want.min() == -128
        return
    _close(got.full().float().numpy(), want.astype(np.float32),
           1e-5 if dtype == "f32" else 1e-2)


def test_reducescatter_matmul_int8_saturates_as_jax():
    """x (8, 64) and w (64, 6) int8 over 4 ranks: exact sums far past
    127, which the JAX kernel's f32 sum and `astype` clamp to 127 / -128."""
    rng = np.random.default_rng(7)
    x = rng.integers(-127, 128, (8, 64)).astype(np.int8)
    w = rng.integers(-127, 128, (64, 6)).astype(np.int8)
    jmesh, mesh = _meshes(4, "tp")
    want = np.asarray(jcm.tp_reducescatter_matmul(x, w, jmesh))
    got = cm.tp_reducescatter_matmul(x, w, mesh).numpy()
    exact = x.astype(np.int64) @ w.astype(np.int64)
    assert np.abs(exact).max() > 10_000
    assert got.dtype == np.int8 and np.array_equal(got, want)
    assert np.array_equal(got, np.clip(exact, -128, 127))


@pytest.mark.parametrize("n", WIDTHS)
def test_allgather_matmul_int8_wraps_as_jax(n):
    rng = np.random.default_rng(20 + n)
    x = rng.integers(-127, 128, (3 * n, 40)).astype(np.int8)
    w = rng.integers(-127, 128, (40, 5 * n)).astype(np.int8)
    jmesh, mesh = _meshes(n, "tp")
    want = np.asarray(jcm.tp_allgather_matmul(x, w, jmesh))
    got = cm.tp_allgather_matmul(x, w, mesh).numpy()
    exact = x.astype(np.int64) @ w.astype(np.int64)
    assert np.abs(exact).max() > 127  # some sums wrap
    assert got.dtype == np.int8 and np.array_equal(got, want)
    assert np.array_equal(got, exact.astype(np.int8))


def test_output_sharding_matches_jax():
    rng = np.random.default_rng(3)
    mesh = Mesh(["cpu"] * 8, ("tp",))
    x = rng.standard_normal((64, 32)).astype(np.float32)
    w = rng.standard_normal((32, 128)).astype(np.float32)
    out = cm.tp_allgather_matmul(x, w, mesh)
    assert out.shape == (64, 128) and out.spec == (None, "tp")
    assert [tuple(s.shape) for s in out.shards] == [(64, 16)] * 8
    x = rng.standard_normal((64, 64)).astype(np.float32)
    w = rng.standard_normal((64, 32)).astype(np.float32)
    out = cm.tp_reducescatter_matmul(x, w, mesh)
    assert out.shape == (64, 32) and out.spec == ("tp", None)
    assert [tuple(s.shape) for s in out.shards] == [(8, 32)] * 8


def test_megatron_pair_matches_jax():
    """All-gather GEMM, tanh GELU on each shard, reduce-scatter GEMM (the
    JAX tests' TP MLP), against the same pair on the JAX ring kernels."""
    rng = np.random.default_rng(4)
    m, d, h = 32, 64, 128
    x = rng.standard_normal((m, d)).astype(np.float32) * 0.3
    w1 = rng.standard_normal((d, h)).astype(np.float32) * 0.3
    w2 = rng.standard_normal((h, d)).astype(np.float32) * 0.3
    jmesh, mesh = _meshes(4, "tp")
    want = np.asarray(jcm.tp_reducescatter_matmul(
        jax.nn.gelu(jcm.tp_allgather_matmul(x, w1, jmesh)), w2, jmesh))
    up = cm.tp_allgather_matmul(x, w1, mesh)
    act = up.map(lambda t: torch.nn.functional.gelu(t, approximate="tanh"))
    down = cm.tp_reducescatter_matmul(act, w2, mesh)
    assert down.spec == ("tp", None)
    _close(down.numpy(), want, 1e-5)


def test_allgather_matmul_on_a_2d_mesh():
    """A (dp 2, tp 4) plan: one ring a dp row, each row holding the whole
    result. The JAX ring kernels refuse a mesh of two named axes (Pallas'
    LOGICAL device ids), so the port is held to its 1-D ring, which the
    tests above hold to JAX, bit for bit."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((12, 24)).astype(np.float32)
    w = rng.standard_normal((24, 20)).astype(np.float32)
    want = cm.tp_allgather_matmul(x, w, Mesh(["cpu"] * 4, ("tp",))).numpy()
    plan = MeshPlan.for_devices(8, tp=4, devices=["cpu"] * 8)
    got = cm.tp_allgather_matmul(x, w, plan.mesh)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(got.shards[1], got.shards[5])  # both dp rows hold tp rank 1's columns


@pytest.mark.parametrize("n", [2, 4])
def test_ring_attention_rdma_plain_matches_jax(n):
    """Odd Nl (5), D 128."""
    rng = np.random.default_rng(30 + n)
    q, k, v = (rng.standard_normal((1, 2, 5 * n, 128)).astype(np.float32) for _ in range(3))
    jmesh, mesh = _meshes(n, "sp")
    want = np.asarray(jra.sequence_sharded_attention_rdma(q, k, v, jmesh, scale=0.1))
    got = ra.sequence_sharded_attention_rdma(q, k, v, mesh, scale=0.1)
    assert got.spec == (None, None, "sp", None)
    _close(got.numpy(), want, 1e-5)


def _ring(n, device):
    return Mesh([device] * n, ("tp",)).rings("tp")[0]


def test_meta_shards_take_the_plain_versions():
    ring = _ring(4, "meta")
    xs = [torch.empty(3, 20, device="meta", dtype=torch.bfloat16) for _ in range(4)]
    ws = [torch.empty(20, 5, device="meta", dtype=torch.bfloat16) for _ in range(4)]
    outs = cm.collective_matmul_ag(xs, ws, ring)
    assert [(o.shape, o.dtype, o.device.type) for o in outs] == [
        ((12, 5), torch.bfloat16, "meta")] * 4
    xs = [torch.empty(8, 3, device="meta") for _ in range(4)]
    ws = [torch.empty(3, 7, device="meta") for _ in range(4)]
    assert [tuple(o.shape) for o in cm.collective_matmul_rs(xs, ws, ring)] == [(2, 7)] * 4
    qs = [torch.empty(1, 2, 5, 64, device="meta") for _ in range(4)]
    outs = ra.ring_attention_rdma(qs, qs, qs, ring, scale=0.5)
    assert [tuple(o.shape) for o in outs] == [(1, 2, 5, 64)] * 4


def test_foreign_devices_and_bad_shapes_raise():
    with pytest.raises(ValueError, match="CUDA cards, the CPU or `meta`"):
        Mesh(["cpu", "meta"], ("tp",)).rings("tp")
    with pytest.raises(ValueError, match="CUDA cards, the CPU or `meta`"):
        Ring([torch.device("xpu")] * 2, [0, 1], {})
    ring = _ring(2, "cpu")
    meta = [torch.empty(2, 4, device="meta")] * 2
    with pytest.raises(ValueError, match="lie on meta"):
        cm.collective_matmul_ag(meta, [torch.zeros(4, 3)] * 2, ring)
    with pytest.raises(ValueError, match="does not split over 2 ranks"):
        cm.collective_matmul_rs([torch.zeros(5, 4)] * 2, [torch.zeros(4, 3)] * 2, ring)
    with pytest.raises(ValueError, match="does not split"):
        cm.tp_reducescatter_matmul(np.zeros((5, 8), np.float32), np.zeros((8, 3), np.float32),
                                   Mesh(["cpu"] * 2, ("tp",)))
    with pytest.raises(ValueError, match="do not chain"):
        cm.collective_matmul_ag([torch.zeros(2, 4)] * 2, [torch.zeros(5, 3)] * 2, ring)
    with pytest.raises(ValueError, match="ring of 2 ranks"):
        ra.ring_attention_rdma([torch.zeros(1, 1, 2, 32)] * 3, [torch.zeros(1, 1, 2, 32)] * 3,
                               [torch.zeros(1, 1, 2, 32)] * 3, ring)
    with pytest.raises(ValueError, match="no axis"):
        Mesh(["cpu"] * 2, ("tp",)).rings("sp")


def test_launch_counters_stay_zero_on_the_cpu():
    before = (cm.ag_launches, cm.rs_launches, ra.launches)
    mesh = Mesh(["cpu"] * 2, ("tp",))
    x = np.ones((4, 6), np.float32)
    cm.tp_reducescatter_matmul(cm.tp_allgather_matmul(x, np.ones((6, 4), np.float32), mesh),
                               np.ones((4, 6), np.float32), mesh)
    ra.sequence_sharded_attention_rdma(np.ones((1, 1, 4, 32), np.float32),
                                       np.ones((1, 1, 4, 32), np.float32),
                                       np.ones((1, 1, 4, 32), np.float32),
                                       Mesh(["cpu"] * 2, ("sp",)))
    assert (cm.ag_launches, cm.rs_launches, ra.launches) == before
