"""Engine configuration.

The port's counterpart of `smelter_tpu/runtime/config.py`, with the fields
the port reads, `device`, and two it keeps unread so that configurations
of the JAX package's ResNet and decode paths carry across: `use_pallas` and
`int4_block_n`.
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

    # -- execution -------------------------------------------------------
    # Where the model runs: "cuda" (default, and None means it) or "cpu".
    # Without a card, only an explicit "cpu" runs; the default raises.
    device: str | None = None
    # Kept so configurations carry across from the JAX package. The port
    # ignores it: FusedDequantMatMul always takes the port's kernels on the
    # card and their plain versions on the CPU.
    use_pallas: bool = False
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
