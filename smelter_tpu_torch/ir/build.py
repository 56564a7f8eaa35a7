"""GraphBuilder: programmatic construction of IR graphs.

The environment's torch cannot emit .onnx files (no `onnx` package), so the
model zoo and tests construct graphs directly through this API and
round-trip them through the protobuf layer. Functionally this is the
`onnx.helper` surface the reference's offline tool leans on
(reference: ONNX2MPS.py:1-12 imports onnx.helper/numpy_helper).
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from ..utils import dtypes as dt
from .graph import Dim, Graph, Node, TensorType, ValueInfo


class GraphBuilder:
    def __init__(self, name: str = "graph", opset: int = 17):
        self.graph = Graph(name=name, opset=opset)
        self._counter = 0

    # -- naming ----------------------------------------------------------

    def _auto(self, base: str) -> str:
        self._counter += 1
        return f"{base}_{self._counter}"

    # -- graph interface -------------------------------------------------

    def input(self, name: str, shape: Sequence[Dim], dtype: int = dt.FLOAT) -> str:
        self.graph.inputs.append(ValueInfo(name, TensorType(dtype, tuple(shape))))
        return name

    def output(self, name: str, shape: Sequence[Dim] | None = None, dtype: int = dt.FLOAT) -> str:
        t = TensorType(dtype, tuple(shape)) if shape is not None else None
        self.graph.outputs.append(ValueInfo(name, t))
        return name

    def init(self, value: np.ndarray, name: str | None = None) -> str:
        """Add an initializer (weight/constant) tensor; returns its edge name."""
        name = name or self._auto("const")
        self.graph.initializers[name] = np.asarray(value)
        return name

    def node(
        self,
        op_type: str,
        inputs: Sequence[str],
        outputs: Sequence[str] | int | None = 1,
        name: str = "",
        **attrs: Any,
    ) -> str | list[str]:
        """Append a node. outputs may be explicit names, or an int count to
        auto-name. Returns the single output name, or the list if several."""
        if isinstance(outputs, int):
            outs = [self._auto(op_type.lower()) for _ in range(outputs)]
        elif outputs is None:
            outs = [self._auto(op_type.lower())]
        else:
            outs = list(outputs)
        self.graph.nodes.append(
            Node(
                op_type=op_type,
                inputs=list(inputs),
                outputs=outs,
                attrs={k: v for k, v in attrs.items() if v is not None},
                name=name or self._auto("n"),
            )
        )
        return outs[0] if len(outs) == 1 else outs

    def finish(self, outputs: Sequence[str] | None = None) -> Graph:
        if outputs is not None:
            for o in outputs:
                self.output(o)
        return self.graph

    # -- common op sugar (used heavily by the model zoo) -----------------

    def conv(
        self,
        x: str,
        weight: np.ndarray,
        bias: np.ndarray | None = None,
        strides: Sequence[int] = (1, 1),
        pads: Sequence[int] = (0, 0, 0, 0),
        dilations: Sequence[int] = (1, 1),
        group: int = 1,
        name: str = "",
    ) -> str:
        w = self.init(weight, self._auto("w"))
        ins = [x, w]
        if bias is not None:
            ins.append(self.init(bias, self._auto("b")))
        return self.node(
            "Conv",
            ins,
            name=name,
            strides=list(strides),
            pads=list(pads),
            dilations=list(dilations),
            group=group,
            kernel_shape=list(weight.shape[2:]),
        )

    def gemm(
        self,
        x: str,
        weight: np.ndarray,
        bias: np.ndarray | None = None,
        trans_b: int = 1,
        name: str = "",
    ) -> str:
        w = self.init(weight, self._auto("fc_w"))
        ins = [x, w]
        if bias is not None:
            ins.append(self.init(bias, self._auto("fc_b")))
        return self.node("Gemm", ins, name=name, transB=trans_b, alpha=1.0, beta=1.0)

    def batch_norm(
        self,
        x: str,
        scale: np.ndarray,
        bias: np.ndarray,
        mean: np.ndarray,
        var: np.ndarray,
        epsilon: float = 1e-5,
        name: str = "",
    ) -> str:
        ins = [x, self.init(scale), self.init(bias), self.init(mean), self.init(var)]
        return self.node("BatchNormalization", ins, name=name, epsilon=epsilon)
