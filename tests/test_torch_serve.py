"""The port's server, its import hygiene and its device rule, on the CPU."""

import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import smelter_tpu_torch as stt
from torch_port_common import image, small_resnet_bytes

REPO = Path(__file__).resolve().parents[1]


def test_server_answers_concurrent_requests_with_direct_outputs():
    data, shape = small_resnet_bytes()
    xs = image((10,) + shape[1:], seed=5)
    direct = stt.compile(stt.import_model(data), quant="int8", device="cpu")
    server = stt.serve(stt.import_model(data), quant="int8", device="cpu",
                       max_batch=4, max_wait_ms=20.0)
    try:
        assert server.buckets == (1, 2, 4)
        results = [None] * len(xs)

        def ask(i):
            results[i] = server.infer(xs[i])

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(len(xs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        stats = server.stats()
    finally:
        server.shutdown()
    assert not server._thread.is_alive() and not server._warmer.is_alive()
    # The graph's batch is 2; the server pins it per bucket, so compare with
    # the direct model two images at a time.
    ref = np.concatenate([direct(xs[i:i + 2])[0] for i in range(0, len(xs), 2)])
    for i, r in enumerate(results):
        assert r is not None and r[0].shape == (16,)
        # per-row results of a batch do not depend on the other rows, up to
        # f32 summation order in the convolutions of a larger batch
        assert np.abs(r[0] - ref[i]).max() <= 1e-5 * np.abs(ref).max()
    assert stats["requests"] == len(xs) and stats["errors"] == 0
    assert stats["batches"] >= 3  # 10 requests, at most 4 a batch
    assert stats["latency_ms_p95"] >= stats["latency_ms_p50"] > 0


def test_server_pads_a_short_batch_to_its_bucket():
    data, shape = small_resnet_bytes()
    xs = image((3,) + shape[1:], seed=6)
    direct = stt.compile(stt.import_model(data), quant="int8", device="cpu")
    server = stt.serve(stt.import_model(data), quant="int8", device="cpu",
                       max_batch=4, max_wait_ms=500.0, eager_compile=False)
    try:
        futs = [server.submit(x) for x in xs]
        outs = [f.result(60) for f in futs]
        stats = server.stats()
    finally:
        server.shutdown()
    # one batch of three, padded with a zero image to the bucket of 4
    assert stats["requests"] == 3 and stats["batches"] == 1
    assert stats["occupancy"] == 0.75 and list(server._executors) == [4]
    ref = np.concatenate([direct(xs[:2])[0], direct(np.stack([xs[2], xs[2]]))[0][:1]])
    got = np.stack([o[0] for o in outs])
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_import_and_cpu_compile_without_jax_protobuf_or_ml_dtypes(tmp_path):
    data, shape = small_resnet_bytes()
    path = tmp_path / "resnet.onnx"
    path.write_bytes(data)
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["google.protobuf"] = None
        import numpy as np
        import smelter_tpu_torch as stt
        import smelter_tpu_torch.kernels.collective_matmul
        import smelter_tpu_torch.kernels.convnext_block
        import smelter_tpu_torch.kernels.cross_attn_block
        import smelter_tpu_torch.kernels.dequant_conv
        import smelter_tpu_torch.kernels.qlinear_conv
        import smelter_tpu_torch.kernels.ragged_decode_attention
        import smelter_tpu_torch.kernels.ring_attention_rdma
        import smelter_tpu_torch.models.convnext
        import smelter_tpu_torch.models.sd_unet
        import smelter_tpu_torch.ops.misc_ops
        import smelter_tpu_torch.parallel
        import smelter_tpu_torch.passes.ragged_attention
        import smelter_tpu_torch.runtime.generate
        import smelter_tpu_torch.serving.decode_server  # noqa: F401
        m = stt.compile({str(path)!r}, quant="int8", device="cpu")
        y = m(np.zeros({shape!r}, np.float32))[0]
        assert y.shape == ({shape[0]}, 16) and np.isfinite(y).all()
        x = np.random.default_rng(0).standard_normal({shape!r}).astype(np.float32)
        m = stt.compile({str(path)!r}, quant="int8-static", calibration_data=[(x,)],
                        device="cpu")
        assert np.isfinite(m(x)[0]).all()
        bad = sorted(k for k, v in sys.modules.items() if v is not None and (
            k == "smelter_tpu" or k.startswith(("smelter_tpu.", "ml_dtypes", "jax"))))
        assert not bad, bad
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def test_port_sources_name_no_jax_protobuf_or_ml_dtypes():
    import ast

    for f in list((REPO / "smelter_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "smelter_tpu", "ml_dtypes"), (f, name)
                assert not name.startswith("google.protobuf"), (f, name)


def test_default_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    data, _ = small_resnet_bytes()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        stt.compile(stt.import_model(data), quant="int8")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        stt.serve(stt.import_model(data), quant="int8")
