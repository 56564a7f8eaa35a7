"""Engine configuration.

The port's counterpart of `smelter_tpu/runtime/config.py`, with the fields
the port reads, `device`, and one it keeps unread so that configurations
of the JAX package's decode paths carry across: `int4_block_n`.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Config:
    # -- shape resolution ------------------------------------------------
    # dim overrides: str keys match ONNX dim_param names; int keys pin that
    # axis on every graph input.
    dims: dict[str | int, int] = dataclasses.field(default_factory=dict)
    batch_size: int | None = None  # convenience: pins axis 0 of every input

    # -- numerics --------------------------------------------------------
    # Activation compute dtype: "float32" | "bfloat16" | "float16".
    compute_dtype: str = "float32"
    # Gelu form: "auto" takes the tanh approximation under a reduced compute
    # dtype (its error is below bf16 resolution), "exact"/"tanh" force one.
    gelu: str = "auto"

    # -- execution -------------------------------------------------------
    # Where the model runs: "cuda" (default, and None means it) or "cpu".
    # Without a card, only an explicit "cpu" runs; the default raises.
    device: str | None = None
    # The JAX package's switch for its hand-written kernels; the port reads
    # it where the JAX package does. FusedDequantMatMul takes `dequant_matmul`
    # (`int8_matmul` under `int8_activations`) under it, and its composites
    # without it (ops/fused_ops.py). FusedAttention takes `flash_attention`
    # from N 512 and `short_attention` below it under it; without it only
    # the long-sequence gate (N >= 2048, head dim >= 64) reaches
    # `flash_attention`. SkipLayerNormalization takes `residual_layer_norm`
    # under it (ops/contrib_ops.py), and LayerNormalization engages
    # `fused_layer_norm` under it unless `fused_layernorm` is False
    # (ops/nn.py). The ops with only a kernel route (FusedDequantMatMulI4,
    # VitAttnBlock, MlpBlock, ...) take their kernels whatever it says.
    use_pallas: bool = False
    # LayerNorm kernels (kernels/layer_norm.py): True routes every
    # last-axis LayerNormalization and SkipLayerNormalization to them, False
    # keeps LayerNormalization on the composite, "auto" engages them for
    # tensors on the card. The JAX package's default, False, is kept.
    fused_layernorm: bool | str = False
    # Kept, unread: the JAX package's int4 kernel N-block override. The
    # port's int4_matmul kernel fixes its tiles (kernels/int4_matmul.py).
    int4_block_n: int | None = None
    # Static-cache decode (runtime/generate.py, serving/decode_server.py):
    # rewrite the step's dense masked cache attention into
    # RaggedDecodeAttention, whose kernel reads only the live cache rows
    # (kernels/ragged_decode_attention.py). The JAX package's TPU block size
    # (`ragged_block`) has no counterpart: the kernel fixes its row blocks.
    ragged_attention: bool = False
    # Run FusedDequantMatMul on the int8 tensor cores by quantizing the
    # activations per row (kernels/int8_matmul.py); adds one activation
    # rounding step. Off by default: weight-only numerics unchanged.
    int8_activations: bool = False

    def resolve_dim(self, input_name: str, axis: int, dim) -> int | None:
        """Resolve one (possibly symbolic) input dim via overrides."""
        if isinstance(dim, int):
            if axis in self.dims and self.dims[axis] != dim:
                return int(self.dims[axis])
            return dim
        if axis == 0 and self.batch_size is not None:
            return int(self.batch_size)
        if isinstance(dim, str) and dim in self.dims:
            return int(self.dims[dim])
        if axis in self.dims:
            return int(self.dims[axis])
        return None
