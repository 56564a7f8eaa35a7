"""The whole slice: ResNet-50 int8 logits of the port against the JAX package.

The same ONNX bytes and input go to `smelter_tpu.compile` (on the CPU, with
and without its Pallas kernels in interpret mode) and to
`smelter_tpu_torch.compile(..., device="cpu")`, whose kernel wrappers take
their plain versions on the CPU.
"""

import numpy as np
import pytest
import torch

import smelter_tpu as st
import smelter_tpu_torch as stt
from torch_port_common import image, small_resnet_bytes


def _logits_jax(data, x, **cfg):
    return np.asarray(st.compile(st.import_model(data), st.Config(**cfg),
                                 quant="int8")(x)[0]).astype(np.float32)


def _logits_port(data, x, **cfg):
    return stt.compile(stt.import_model(data), stt.Config(**cfg), quant="int8",
                       device="cpu")(x)[0]


@pytest.mark.parametrize("int8_activations", [False, True])
def test_f32_logits_match_jax(int8_activations):
    data, shape = small_resnet_bytes()
    x = image(shape)
    got = _logits_port(data, x, int8_activations=int8_activations)
    assert got.dtype == np.float32 and got.shape == (shape[0], 16)
    assert np.isfinite(got).all()
    for use_pallas in (False, True):
        ref = _logits_jax(data, x, int8_activations=int8_activations,
                          use_pallas=use_pallas)
        # Same int8 weights and f32 arithmetic, summed in other orders (XLA
        # vs PyTorch convolutions, scale before vs after the head's K sum):
        # differences at f32 rounding level, so 1e-4 of the largest logit.
        assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("int8_activations", [False, True])
def test_bf16_logits_match_jax(int8_activations):
    data, shape = small_resnet_bytes(batch=8)
    x = image(shape, seed=1)
    got = _logits_port(data, x, compute_dtype="bfloat16",
                       int8_activations=int8_activations)
    ref = _logits_jax(data, x, compute_dtype="bfloat16",
                      int8_activations=int8_activations)
    # bf16 keeps 8 mantissa bits and the two frameworks round at different
    # places through 17 convolutions: 5e-2 of the largest logit.
    err = np.abs(got - ref).max()
    assert err <= 5e-2 * np.abs(ref).max()
    # A row's top-1 can only differ where its top-2 gap is below twice the
    # largest logit error; every other row must agree.
    top2 = np.sort(ref, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2 * err
    assert clear.any()
    assert (got.argmax(1) == ref.argmax(1))[clear].all()


def test_params_from_jax_executor_give_the_same_logits():
    data, shape = small_resnet_bytes()
    x = image(shape, seed=2)
    gj = st.api._prepare(st.import_model(data), "int8", True, "nhwc")
    ex = st.Executor(gj)
    arrays = {name: np.asarray(gj.initializers[name]) for name in ex.param_names}
    gt = stt.api._prepare(stt.import_model(data), "int8", True, "nhwc")
    params = stt.params_from_numpy(arrays, "cpu", graph=gt)
    got = stt.CompiledModel(gt, stt.Config(device="cpu"), params=params)(x)[0]
    ref = stt.CompiledModel(gt, stt.Config(device="cpu"))(x)[0]
    assert np.array_equal(got, ref)
    # HWIO conv weights were laid out once for channels-last convolutions
    w = next(params[n.inputs[1]] for n in gt.nodes
             if n.op_type == "Conv" and n.inputs[1] in params)
    assert w.permute(3, 2, 0, 1).is_contiguous(memory_format=torch.channels_last)
