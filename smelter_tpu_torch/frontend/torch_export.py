"""torch.fx -> IR exporter: traces a torch nn.Module and emits an ONNX-shaped
IR graph with the module's (inference-mode) weights as initializers.

Why this exists: the reference consumes .onnx files exported by PyTorch
(reference: README.md:7-13 positions the library downstream of ONNX export;
ONNX2MPS.py preprocesses such files). This environment's torch cannot run
`torch.onnx.export` (no `onnx` package), so the model zoo and differential
tests need a first-party exporter. It doubles as a torch frontend for the
engine — any fx-traceable inference model in the supported op set converts.

Scope: inference only, static shapes, the module/function set the zoo needs
(conv/linear/norm/activation/pool/resize/attention-by-matmul/...). Shapes
come from fx ShapeProp over an example input.
"""

from __future__ import annotations

import operator
from typing import Any, Callable

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.fx import symbolic_trace
from torch.fx.passes.shape_prop import ShapeProp

from ..ir.build import GraphBuilder
from ..ir.errors import NotSupportedError
from ..ir.graph import Graph
from ..utils import dtypes as dt


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class _Exporter:
    def __init__(self, module: nn.Module, example, name: str, opset: int = 17):
        self.module = module.eval()
        self.gm = symbolic_trace(self.module)
        examples = example if isinstance(example, (tuple, list)) else (example,)
        ShapeProp(self.gm).propagate(*examples)
        self.b = GraphBuilder(name, opset=opset)
        self.env: dict[torch.fx.Node, Any] = {}
        self.example = examples

    # -- helpers ---------------------------------------------------------

    def val(self, a):
        """fx arg -> edge name (for Node) or python literal."""
        if isinstance(a, torch.fx.Node):
            return self.env[a]
        return a

    def shape_of(self, node: torch.fx.Node) -> tuple[int, ...]:
        meta = node.meta.get("tensor_meta")
        if meta is None:
            raise NotSupportedError(f"no shape metadata for fx node {node}")
        return tuple(meta.shape)

    def const(self, value, name_hint="c") -> str:
        return self.b.init(np.asarray(value), self.b._auto(name_hint))

    # -- module converters ----------------------------------------------

    def conv_nd(self, m: nn.modules.conv._ConvNd, x: str, transpose: bool = False) -> str:
        w = _np(m.weight)
        bias = _np(m.bias) if m.bias is not None else None
        rank = w.ndim - 2
        pads = list(m.padding) * 2 if isinstance(m.padding, (tuple, list)) else [m.padding] * (2 * rank)
        op = "ConvTranspose" if transpose else "Conv"
        wn = self.b.init(w)
        ins = [x, wn]
        if bias is not None:
            ins.append(self.b.init(bias))
        attrs = dict(
            strides=list(m.stride),
            pads=[int(p) for p in pads],
            dilations=list(m.dilation),
            group=m.groups,
            kernel_shape=list(w.shape[2:]),
        )
        if transpose:
            attrs["output_padding"] = list(m.output_padding)
        return self.b.node(op, ins, **attrs)

    def call_module(self, node: torch.fx.Node) -> Any:
        m = self.gm.get_submodule(node.target)
        x = self.val(node.args[0])
        b = self.b
        if isinstance(m, nn.ConvTranspose2d):
            return self.conv_nd(m, x, transpose=True)
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Conv3d)):
            return self.conv_nd(m, x)
        if isinstance(m, nn.Linear):
            in_rank = len(self.shape_of(node.args[0]))
            if in_rank <= 2:
                wb = [b.init(_np(m.weight))]
                if m.bias is not None:
                    wb.append(b.init(_np(m.bias)))
                return b.node("Gemm", [x] + wb, transB=1, alpha=1.0, beta=1.0)
            # Rank>2 (e.g. (B, N, D) transformer activations): ONNX Gemm is
            # strictly 2-D — emit MatMul with a pre-transposed weight + Add,
            # the same graph shape torch.onnx produces.
            y = b.node("MatMul", [x, b.init(_np(m.weight).T.copy())])
            if m.bias is not None:
                y = b.node("Add", [y, b.init(_np(m.bias))])
            return y
        if isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d, nn.BatchNorm3d)):
            return b.node(
                "BatchNormalization",
                [x, b.init(_np(m.weight)), b.init(_np(m.bias)),
                 b.init(_np(m.running_mean)), b.init(_np(m.running_var))],
                epsilon=m.eps,
            )
        if isinstance(m, nn.LayerNorm):
            return b.node(
                "LayerNormalization",
                [x, b.init(_np(m.weight)), b.init(_np(m.bias))],
                axis=-len(m.normalized_shape), epsilon=m.eps,
            )
        if isinstance(m, nn.GroupNorm):
            return b.node(
                "GroupNormalization",
                [x, b.init(_np(m.weight)), b.init(_np(m.bias))],
                num_groups=m.num_groups, epsilon=m.eps,
            )
        if isinstance(m, nn.InstanceNorm2d):
            w_ = _np(m.weight) if m.weight is not None else np.ones(m.num_features, np.float32)
            b_ = _np(m.bias) if m.bias is not None else np.zeros(m.num_features, np.float32)
            return b.node("InstanceNormalization", [x, b.init(w_), b.init(b_)], epsilon=m.eps)
        if isinstance(m, nn.ReLU):
            return b.node("Relu", [x])
        if isinstance(m, nn.ReLU6):
            return b.node("Clip", [x, self.const(np.float32(0)), self.const(np.float32(6))])
        if isinstance(m, nn.SiLU):
            sig = b.node("Sigmoid", [x])
            return b.node("Mul", [x, sig])
        if isinstance(m, nn.GELU):
            return b.node("Gelu", [x], approximate="tanh" if m.approximate == "tanh" else "none")
        if isinstance(m, nn.Sigmoid):
            return b.node("Sigmoid", [x])
        if isinstance(m, nn.Tanh):
            return b.node("Tanh", [x])
        if isinstance(m, nn.LeakyReLU):
            return b.node("LeakyRelu", [x], alpha=m.negative_slope)
        if isinstance(m, nn.PReLU):
            w = _np(m.weight)
            shape = (w.shape[0],) + (1,) * (len(self.shape_of(node)) - 2)
            return b.node("PRelu", [x, b.init(w.reshape(shape))])
        if isinstance(m, nn.ELU):
            return b.node("Elu", [x], alpha=m.alpha)
        if isinstance(m, nn.Hardswish):
            return b.node("HardSwish", [x])
        if isinstance(m, nn.Hardsigmoid):
            return b.node("HardSigmoid", [x], alpha=1.0 / 6.0, beta=0.5)
        if isinstance(m, nn.Softmax):
            return b.node("Softmax", [x], axis=m.dim if m.dim is not None else -1)
        if isinstance(m, nn.MaxPool2d):
            k = m.kernel_size if isinstance(m.kernel_size, tuple) else (m.kernel_size,) * 2
            s = m.stride if isinstance(m.stride, tuple) else (m.stride or m.kernel_size,) * 2
            p = m.padding if isinstance(m.padding, tuple) else (m.padding,) * 2
            d = m.dilation if isinstance(m.dilation, tuple) else (m.dilation,) * 2
            outs = b.node("MaxPool", [x], kernel_shape=list(k), strides=list(s),
                          pads=list(p) * 2, dilations=list(d),
                          ceil_mode=int(m.ceil_mode),
                          outputs=2 if m.return_indices else 1)
            # indices follow ONNX [N,C,*spatial]-flat convention (consumed
            # by the matching MaxUnpool export, not torch's per-plane flat)
            return tuple(outs) if m.return_indices else outs
        if isinstance(m, nn.MaxUnpool2d):
            return self._max_unpool(m.kernel_size, m.stride, m.padding,
                                    x, self.val(node.args[1]), node)
        if isinstance(m, nn.AvgPool2d):
            k = m.kernel_size if isinstance(m.kernel_size, tuple) else (m.kernel_size,) * 2
            s = m.stride if isinstance(m.stride, tuple) else (m.stride or m.kernel_size,) * 2
            p = m.padding if isinstance(m.padding, tuple) else (m.padding,) * 2
            return b.node("AveragePool", [x], kernel_shape=list(k), strides=list(s),
                          pads=list(p) * 2, ceil_mode=int(m.ceil_mode),
                          count_include_pad=int(m.count_include_pad))
        if isinstance(m, nn.AdaptiveAvgPool2d):
            out = m.output_size if isinstance(m.output_size, tuple) else (m.output_size,) * 2
            if tuple(out) == (1, 1):
                return b.node("GlobalAveragePool", [x])
            in_shape = self.shape_of(node.args[0])
            if in_shape[2] % out[0] or in_shape[3] % out[1]:
                raise NotSupportedError("AdaptiveAvgPool2d with non-divisible output")
            k = (in_shape[2] // out[0], in_shape[3] // out[1])
            return b.node("AveragePool", [x], kernel_shape=list(k), strides=list(k))
        if isinstance(m, nn.MultiheadAttention):
            return self._mha_module(node, m)
        if isinstance(m, (nn.LSTM, nn.GRU, nn.RNN)):
            return self._rnn_module(node, m)
        if isinstance(m, nn.Embedding):
            return b.node("Gather", [b.init(_np(m.weight)), x], axis=0)
        if isinstance(m, (nn.Dropout, nn.Identity)):
            return x
        if isinstance(m, nn.Flatten):
            if m.start_dim == 1 and m.end_dim == -1:
                return b.node("Flatten", [x], axis=1)
            return b.node("Reshape", [x, self.const(np.asarray(self.shape_of(node), np.int64))])
        if isinstance(m, nn.PixelShuffle):
            return b.node("DepthToSpace", [x], blocksize=m.upscale_factor, mode="CRD")
        if isinstance(m, nn.Upsample):
            return self._interpolate(x, node, size=m.size, scale_factor=m.scale_factor,
                                     mode=m.mode, align_corners=m.align_corners)
        if isinstance(m, nn.ZeroPad2d):
            p = m.padding  # (left, right, top, bottom)
            pads = [0, 0, p[2], p[0], 0, 0, p[3], p[1]]
            return b.node("Pad", [x, self.const(np.asarray(pads, np.int64))], mode="constant")
        raise NotSupportedError(f"torch module {type(m).__name__}")

    def _rnn_module(self, node: torch.fx.Node, m):
        """nn.LSTM/GRU/RNN -> one ONNX LSTM/GRU/RNN node per layer.

        torch gate orders remapped to ONNX: LSTM i,f,g,o -> i,o,f,c; GRU
        r,z,n -> z,r,n (with linear_before_reset=1, which is exactly the
        torch GRU candidate formula). Returns fx-shaped results so user
        unpacking works: LSTM -> (out, (h_n, c_n)), GRU/RNN -> (out, h_n).
        """
        b = self.b
        if getattr(m, "proj_size", 0):
            raise NotSupportedError("LSTM proj_size is not supported")
        if len(node.args) > 1 and node.args[1] is not None:
            raise NotSupportedError("recurrent module with explicit initial "
                                    "state (pass None / omit hx)")
        is_lstm = isinstance(m, nn.LSTM)
        is_gru = isinstance(m, nn.GRU)
        op = "LSTM" if is_lstm else ("GRU" if is_gru else "RNN")
        n_gates = 4 if is_lstm else (3 if is_gru else 1)
        dirs = 2 if m.bidirectional else 1
        hid = m.hidden_size

        def reorder(a):
            if is_lstm:
                i, f, g, o = np.split(a, 4, axis=0)
                return np.concatenate([i, o, f, g], axis=0)
            if is_gru:
                r, z, n = np.split(a, 3, axis=0)
                return np.concatenate([z, r, n], axis=0)
            return a

        in_shape = self.shape_of(node.args[0])
        if m.batch_first:
            bsz, seq = in_shape[0], in_shape[1]
        else:
            seq, bsz = in_shape[0], in_shape[1]
        x = self.val(node.args[0])
        if m.batch_first:
            x = b.node("Transpose", [x], perm=[1, 0, 2])  # -> (T, B, I)

        h_outs, c_outs = [], []
        for layer in range(m.num_layers):
            ws, rs, bs = [], [], []
            for sfx in ([""] if dirs == 1 else ["", "_reverse"]):
                ws.append(reorder(_np(getattr(m, f"weight_ih_l{layer}{sfx}"))))
                rs.append(reorder(_np(getattr(m, f"weight_hh_l{layer}{sfx}"))))
                if m.bias:
                    bs.append(np.concatenate(
                        [reorder(_np(getattr(m, f"bias_ih_l{layer}{sfx}"))),
                         reorder(_np(getattr(m, f"bias_hh_l{layer}{sfx}")))]))
            ins = [x, b.init(np.stack(ws)), b.init(np.stack(rs))]
            if m.bias:
                ins.append(b.init(np.stack(bs)))
            attrs = dict(hidden_size=hid,
                         direction="bidirectional" if dirs == 2 else "forward")
            if is_gru:
                attrs["linear_before_reset"] = 1
            if op == "RNN" and getattr(m, "nonlinearity", "tanh") == "relu":
                attrs["activations"] = ["Relu"] * dirs
            outs = b.node(op, ins, outputs=3 if is_lstm else 2, **attrs)
            # Y (T, dirs, B, H) -> next layer's (T, B, dirs*H)
            y = b.node("Reshape",
                       [b.node("Transpose", [outs[0]], perm=[0, 2, 1, 3]),
                        self.const(np.asarray([seq, bsz, dirs * hid], np.int64))])
            x = y
            h_outs.append(outs[1])
            if is_lstm:
                c_outs.append(outs[2])

        out = b.node("Transpose", [x], perm=[1, 0, 2]) if m.batch_first else x
        h_n = h_outs[0] if len(h_outs) == 1 else b.node("Concat", h_outs, axis=0)
        if is_lstm:
            c_n = c_outs[0] if len(c_outs) == 1 else b.node("Concat", c_outs, axis=0)
            return (out, (h_n, c_n))
        return (out, h_n)

    def _mha_module(self, node: torch.fx.Node, m: nn.MultiheadAttention):
        """nn.MultiheadAttention (self-attention, batch_first, no mask) ->
        the explicit QKV/attention pattern fuse_attention recognizes."""
        if not m.batch_first or not m._qkv_same_embed_dim:
            raise NotSupportedError("MultiheadAttention: need batch_first=True"
                                    " and same embed dims")
        q_in = self.val(node.args[0])
        k_in = self.val(node.args[1]) if len(node.args) > 1 else q_in
        v_in = self.val(node.args[2]) if len(node.args) > 2 else q_in
        if not (q_in == k_in == v_in):
            raise NotSupportedError("MultiheadAttention: only self-attention")
        b = self.b
        B, N, D = self.shape_of(node.args[0])
        H = m.num_heads
        hd = D // H
        w = _np(m.in_proj_weight)            # (3D, D)
        bias = _np(m.in_proj_bias) if m.in_proj_bias is not None else None
        qkv = b.node("MatMul", [q_in, b.init(w.T.copy())])
        if bias is not None:
            qkv = b.node("Add", [qkv, b.init(bias)])
        qkv = b.node("Reshape", [qkv, self.const(
            np.asarray([B, N, 3, H, hd], np.int64))])
        qkv = b.node("Transpose", [qkv], perm=[2, 0, 3, 1, 4])  # (3,B,H,N,hd)
        parts = []
        for i in range(3):
            sl = b.node("Slice", [qkv, self.const(np.asarray([i], np.int64)),
                                  self.const(np.asarray([i + 1], np.int64)),
                                  self.const(np.asarray([0], np.int64))])
            parts.append(b.node("Squeeze", [sl, self.const(np.asarray([0], np.int64))]))
        qh, kh, vh = parts
        kt = b.node("Transpose", [kh], perm=[0, 1, 3, 2])
        s_ = b.node("MatMul", [qh, kt])
        s_ = b.node("Mul", [s_, self.const(np.float32(hd ** -0.5))])
        p = b.node("Softmax", [s_], axis=-1)
        o = b.node("MatMul", [p, vh])                  # (B,H,N,hd)
        o = b.node("Transpose", [o], perm=[0, 2, 1, 3])
        o = b.node("Reshape", [o, self.const(np.asarray([B, N, D], np.int64))])
        o = b.node("MatMul", [o, b.init(_np(m.out_proj.weight).T.copy())])
        if m.out_proj.bias is not None:
            o = b.node("Add", [o, b.init(_np(m.out_proj.bias))])
        # torch MHA returns (attn_output, attn_weights); expose as a tuple so
        # the caller's getitem(0) unpacks it (weights unsupported -> None).
        return (o, None)

    # -- function/method converters --------------------------------------

    def _max_unpool(self, kernel, stride, padding, x, idx, node):
        """Shared MaxUnpool2d emit. The fx meta already knows the output
        shape (torch resolved output_size), so it is passed explicitly —
        no closed-form ambiguity for k>s cases."""
        k = (kernel, kernel) if isinstance(kernel, int) else tuple(kernel)
        s = stride or k
        s = (s, s) if isinstance(s, int) else tuple(s)
        p = (padding, padding) if isinstance(padding, int) else tuple(padding)
        out_shape = np.asarray(self.shape_of(node), np.int64)
        return self.b.node(
            "MaxUnpool", [x, idx, self.const(out_shape, "unpool_shape")],
            kernel_shape=list(k), strides=list(s), pads=list(p) * 2)

    def _interpolate(self, x, node, size=None, scale_factor=None, mode="nearest",
                     align_corners=None):
        in_shape = self.shape_of(node.args[0] if node.args else node)
        out_shape = self.shape_of(node)
        sizes = np.asarray(out_shape, np.int64)
        if mode == "nearest":
            coord, nm = "asymmetric", "floor"
            onnx_mode = "nearest"
        elif mode in ("bilinear", "linear"):
            onnx_mode = "linear"
            coord = "align_corners" if align_corners else "pytorch_half_pixel"
            nm = "round_prefer_floor"
        else:
            raise NotSupportedError(f"interpolate mode {mode}")
        roi = self.const(np.array([], np.float32), "roi")
        scales = self.const(np.array([], np.float32), "scales")
        szs = self.const(sizes, "sizes")
        return self.b.node("Resize", [x, roi, scales, szs], mode=onnx_mode,
                           coordinate_transformation_mode=coord, nearest_mode=nm)

    def call_function(self, node: torch.fx.Node) -> Any:
        f = node.target
        a = node.args
        b = self.b
        kw = node.kwargs

        def two(op):
            lhs, rhs = self.val(a[0]), self.val(a[1])
            if not isinstance(lhs, str):
                lhs = self.const(np.float32(lhs))
            if not isinstance(rhs, str):
                rhs = self.const(np.float32(rhs))
            return b.node(op, [lhs, rhs])

        if f in (operator.add, torch.add):
            return two("Add")
        if f in (operator.sub, torch.sub):
            return two("Sub")
        if f in (operator.mul, torch.mul):
            return two("Mul")
        if f in (operator.truediv, torch.div):
            return two("Div")
        if f in (torch.matmul, operator.matmul):
            return two("MatMul")
        if f is torch.cat:
            tensors = [self.val(t) for t in a[0]]
            return b.node("Concat", tensors, axis=kw.get("dim", a[1] if len(a) > 1 else 0))
        if f is torch.flatten:
            # torch.flatten(start_dim) keeps leading dims; ONNX Flatten is
            # always 2-D — use Reshape with the statically known out shape.
            return b.node("Reshape", [self.val(a[0]),
                                      self.const(np.asarray(self.shape_of(node), np.int64))])
        if f is torch.transpose:
            return self._transpose(node, a[1], a[2])
        if f is torch.permute:
            return b.node("Transpose", [self.val(a[0])], perm=list(a[1]))
        if f in (F.relu, torch.relu):
            return b.node("Relu", [self.val(a[0])])
        if f is F.relu6:
            return b.node("Clip", [self.val(a[0]), self.const(np.float32(0)), self.const(np.float32(6))])
        if f in (F.silu,):
            x = self.val(a[0])
            return b.node("Mul", [x, b.node("Sigmoid", [x])])
        if f in (torch.sigmoid, F.sigmoid):
            return b.node("Sigmoid", [self.val(a[0])])
        if f in (torch.tanh, F.tanh):
            return b.node("Tanh", [self.val(a[0])])
        if f is torch.sin:
            return b.node("Sin", [self.val(a[0])])
        if f is torch.cos:
            return b.node("Cos", [self.val(a[0])])
        if f is torch.exp:
            return b.node("Exp", [self.val(a[0])])
        if f is torch.log:
            return b.node("Log", [self.val(a[0])])
        if f is torch.sqrt:
            return b.node("Sqrt", [self.val(a[0])])
        if f is F.gelu:
            approx = kw.get("approximate", "none")
            return b.node("Gelu", [self.val(a[0])], approximate=approx)
        if f is F.conv2d:
            x = self.val(a[0])
            w_node = a[1]
            if not (isinstance(w_node, torch.fx.Node) and w_node.op == "get_attr"):
                raise NotSupportedError("F.conv2d with non-parameter weight")
            w_np = _np(self.gm.get_parameter(w_node.target))
            bias = kw.get("bias", a[2] if len(a) > 2 else None)
            stride = kw.get("stride", a[3] if len(a) > 3 else 1)
            padding = kw.get("padding", a[4] if len(a) > 4 else 0)
            dilation = kw.get("dilation", a[5] if len(a) > 5 else 1)
            groups = kw.get("groups", a[6] if len(a) > 6 else 1)
            to2 = lambda v: list(v) if isinstance(v, (tuple, list)) else [v, v]
            ins = [x, b.init(w_np)]
            if isinstance(bias, torch.fx.Node):
                ins.append(b.init(_np(self.gm.get_parameter(bias.target))))
            return b.node("Conv", ins, strides=to2(stride),
                          pads=to2(padding) * 2, dilations=to2(dilation),
                          group=groups, kernel_shape=list(w_np.shape[2:]))
        if f is F.layer_norm:
            x = self.val(a[0])
            norm_shape = a[1]
            weight = kw.get("weight", a[2] if len(a) > 2 else None)
            bias = kw.get("bias", a[3] if len(a) > 3 else None)
            eps = kw.get("eps", 1e-5)
            dim = int(np.prod(norm_shape))
            w_np = (_np(self.gm.get_parameter(weight.target))
                    if isinstance(weight, torch.fx.Node)
                    else np.ones(norm_shape, np.float32))
            b_np = (_np(self.gm.get_parameter(bias.target))
                    if isinstance(bias, torch.fx.Node)
                    else np.zeros(norm_shape, np.float32))
            return b.node("LayerNormalization",
                          [x, b.init(w_np), b.init(b_np)],
                          axis=-len(norm_shape), epsilon=eps)
        if f is F.batch_norm:
            x = self.val(a[0])
            get = lambda v: _np(self.gm.get_parameter(v.target))                 if isinstance(v, torch.fx.Node) else None
            mean, var = get(a[1]), get(a[2])
            weight = get(kw.get("weight", a[3] if len(a) > 3 else None))
            bias = get(kw.get("bias", a[4] if len(a) > 4 else None))
            ch = mean.shape[0]
            weight = weight if weight is not None else np.ones(ch, np.float32)
            bias = bias if bias is not None else np.zeros(ch, np.float32)
            return b.node("BatchNormalization",
                          [x, b.init(weight), b.init(bias), b.init(mean),
                           b.init(var)], epsilon=kw.get("eps", 1e-5))
        if f is F.embedding:
            w_node = a[1]
            w_np = _np(self.gm.get_parameter(w_node.target))
            return b.node("Gather", [b.init(w_np), self.val(a[0])], axis=0)
        if f is F.elu:
            return b.node("Elu", [self.val(a[0])],
                          alpha=kw.get("alpha", a[1] if len(a) > 1 else 1.0))
        if f is F.selu:
            return b.node("Selu", [self.val(a[0])])
        if f is F.hardswish:
            return b.node("HardSwish", [self.val(a[0])])
        if f is F.hardsigmoid:
            return b.node("HardSigmoid", [self.val(a[0])],
                          alpha=1.0 / 6.0, beta=0.5)
        if f is F.mish:
            return b.node("Mish", [self.val(a[0])])
        if f is F.group_norm:
            weight = kw.get("weight", a[2] if len(a) > 2 else None)
            bias = kw.get("bias", a[3] if len(a) > 3 else None)
            num_groups = a[1]
            ch = self.shape_of(node)[1]
            w_np = (_np(self.gm.get_parameter(weight.target))
                    if isinstance(weight, torch.fx.Node) else np.ones(ch, np.float32))
            b_np = (_np(self.gm.get_parameter(bias.target))
                    if isinstance(bias, torch.fx.Node) else np.zeros(ch, np.float32))
            return b.node("GroupNormalization",
                          [self.val(a[0]), b.init(w_np), b.init(b_np)],
                          num_groups=num_groups, epsilon=kw.get("eps", 1e-5))
        if f is F.leaky_relu:
            return b.node("LeakyRelu", [self.val(a[0])], alpha=a[1] if len(a) > 1 else kw.get("negative_slope", 0.01))
        if f in (F.softmax, torch.softmax):
            return b.node("Softmax", [self.val(a[0])], axis=kw.get("dim", a[1] if len(a) > 1 else -1))
        if f is F.interpolate:
            return self._interpolate(
                self.val(a[0]), node,
                size=kw.get("size"), scale_factor=kw.get("scale_factor"),
                mode=kw.get("mode", "nearest"), align_corners=kw.get("align_corners"))
        if f is F.max_pool2d or f is F.max_pool2d_with_indices:
            k = a[1] if len(a) > 1 else kw["kernel_size"]
            k = (k, k) if isinstance(k, int) else tuple(k)
            st_ = kw.get("stride", a[2] if len(a) > 2 else None) or k
            st_ = (st_, st_) if isinstance(st_, int) else tuple(st_)
            pd = kw.get("padding", a[3] if len(a) > 3 else 0)
            pd = (pd, pd) if isinstance(pd, int) else tuple(pd)
            ret_idx = (f is F.max_pool2d_with_indices
                       or bool(kw.get("return_indices",
                                      a[6] if len(a) > 6 else False)))
            outs = b.node("MaxPool", [self.val(a[0])], kernel_shape=list(k),
                          strides=list(st_), pads=list(pd) * 2,
                          ceil_mode=int(kw.get("ceil_mode", False)),
                          outputs=2 if ret_idx else 1)
            return tuple(outs) if ret_idx else outs
        if f is F.max_unpool2d:
            k = a[2] if len(a) > 2 else kw["kernel_size"]
            st_ = kw.get("stride", a[3] if len(a) > 3 else None)
            pd = kw.get("padding", a[4] if len(a) > 4 else 0)
            return self._max_unpool(k, st_, pd, self.val(a[0]),
                                    self.val(a[1]), node)
        if f is F.avg_pool2d:
            k = a[1] if len(a) > 1 else kw["kernel_size"]
            k = (k, k) if isinstance(k, int) else tuple(k)
            st_ = kw.get("stride", a[2] if len(a) > 2 else None) or k
            st_ = (st_, st_) if isinstance(st_, int) else tuple(st_)
            pd = kw.get("padding", a[3] if len(a) > 3 else 0)
            pd = (pd, pd) if isinstance(pd, int) else tuple(pd)
            return b.node("AveragePool", [self.val(a[0])], kernel_shape=list(k),
                          strides=list(st_), pads=list(pd) * 2,
                          count_include_pad=int(kw.get("count_include_pad", True)))
        if f is torch.bmm:
            return two("MatMul")
        if f in (torch.clamp, torch.clip):
            x = self.val(a[0])
            lo = kw.get("min", a[1] if len(a) > 1 else None)
            hi = kw.get("max", a[2] if len(a) > 2 else None)
            ins = [x,
                   self.const(np.float32(lo)) if lo is not None else "",
                   self.const(np.float32(hi)) if hi is not None else ""]
            while ins and ins[-1] == "":
                ins.pop()
            return b.node("Clip", ins)
        if f is F.linear:
            x = self.val(a[0])
            wt = a[1]
            w_np = _np(self.gm.get_parameter(wt.target)) if isinstance(wt, torch.fx.Node) and wt.op == "get_attr" else None
            if w_np is None:
                raise NotSupportedError("F.linear with non-parameter weight")
            y = b.node("MatMul", [x, b.init(w_np.T.copy())])
            if len(a) > 2 and a[2] is not None:
                y = b.node("Add", [y, b.init(_np(self.gm.get_parameter(a[2].target)))])
            return y
        if f is F.adaptive_avg_pool2d:
            out = a[1]
            if out in (1, (1, 1)):
                return b.node("GlobalAveragePool", [self.val(a[0])])
            out = (out, out) if isinstance(out, int) else tuple(out)
            in_shape = self.shape_of(node.args[0])
            if in_shape[2] % out[0] or in_shape[3] % out[1]:
                raise NotSupportedError("adaptive_avg_pool2d with non-divisible output")
            k = (in_shape[2] // out[0], in_shape[3] // out[1])
            return b.node("AveragePool", [self.val(a[0])],
                          kernel_shape=list(k), strides=list(k))
        if f is F.pad:
            pad = a[1] if len(a) > 1 else kw["pad"]
            mode = kw.get("mode", a[2] if len(a) > 2 else "constant")
            x = self.val(a[0])
            rank = len(self.shape_of(node))
            full = [0] * (2 * rank)
            # torch pad is (last dim lo, hi, second-last lo, hi, ...)
            for i in range(len(pad) // 2):
                dim = rank - 1 - i
                full[dim] = pad[2 * i]
                full[rank + dim] = pad[2 * i + 1]
            onnx_mode = {"constant": "constant", "reflect": "reflect", "replicate": "edge"}[mode]
            return b.node("Pad", [x, self.const(np.asarray(full, np.int64))], mode=onnx_mode)
        if f is torch.einsum:
            eq = a[0]
            tensors = [self.val(t) for t in a[1:]]
            return b.node("Einsum", tensors, equation=eq)
        if f is F.scaled_dot_product_attention:
            q, k_, v_ = (self.val(t) for t in a[:3])
            mask = kw.get("attn_mask", a[3] if len(a) > 3 else None)
            d = self.shape_of(node.args[0])[-1]
            scale = kw.get("scale") or d ** -0.5
            ins = [q, k_, v_]
            if kw.get("is_causal", False):
                if mask is not None:
                    raise NotSupportedError("sdpa with both mask and is_causal")
                n = self.shape_of(node.args[0])[-2]
                nk = self.shape_of(node.args[1])[-2]
                ins.append(self.const(
                    np.triu(np.full((n, nk), -1e9, np.float32), 1), "causal_mask"))
            elif mask is not None:
                if isinstance(mask, torch.fx.Node) and mask.op == "get_attr":
                    m_np = _np(self.gm.get_parameter(mask.target))
                    if m_np.dtype == np.bool_:
                        m_np = np.where(m_np, 0.0, -1e9).astype(np.float32)
                    ins.append(b.init(m_np.astype(np.float32)))
                elif isinstance(mask, torch.fx.Node):
                    ins.append(self.val(mask))  # runtime additive mask
                else:
                    raise NotSupportedError("sdpa mask literal")
            return b.node("FusedAttention", ins, scale=float(scale))
        if f is getattr:
            if a[1] == "shape":
                return tuple(self.shape_of(a[0]))
            raise NotSupportedError(f"getattr {a[1]!r}")
        if f is operator.getitem:
            src, idx = a[0], a[1]
            v = self.val(src)
            if isinstance(v, (list, tuple)):
                return v[idx]
            return self._slice_getitem(node, v, idx)
        if f is torch.chunk:
            x = self.val(a[0])
            chunks = a[1]
            dim = kw.get("dim", a[2] if len(a) > 2 else 0)
            return b.node("Split", [x], outputs=chunks, axis=dim)
        if f in (torch.mean,):
            x = self.val(a[0])
            dim = kw.get("dim", a[1] if len(a) > 1 else None)
            keep = kw.get("keepdim", False)
            axes = [dim] if isinstance(dim, int) else list(dim)
            return b.node("ReduceMean", [x], axes=axes, keepdims=int(keep))
        if f is torch.reshape:
            return b.node("Reshape", [self.val(a[0]), self.const(np.asarray(self.shape_of(node), np.int64))])
        raise NotSupportedError(f"torch function {f}")

    def _transpose(self, node, d0, d1):
        rank = len(self.shape_of(node))
        perm = list(range(rank))
        d0, d1 = d0 % rank, d1 % rank
        perm[d0], perm[d1] = perm[d1], perm[d0]
        return self.b.node("Transpose", [self.val(node.args[0])], perm=perm)

    def _slice_getitem(self, node, x: str, idx) -> str:
        rank = len(self.shape_of(node.args[0]))
        if not isinstance(idx, tuple):
            idx = (idx,)
        if all(it is None or it == slice(None) for it in idx):
            # pure newaxis/full-slice indexing -> static reshape
            return self.b.node("Reshape", [x, self.const(
                np.asarray(self.shape_of(node), np.int64))])
        if any(it is None for it in idx):
            raise NotSupportedError("mixed newaxis + slicing getitem")
        starts, ends, axes, steps = [], [], [], []
        squeeze_axes = []
        axis = 0
        for it in idx:
            if it is Ellipsis:
                axis = rank - (len(idx) - idx.index(Ellipsis) - 1)
                continue
            if isinstance(it, slice):
                if it.start is not None or it.stop is not None or it.step is not None:
                    starts.append(it.start or 0)
                    ends.append(it.stop if it.stop is not None else np.iinfo(np.int32).max)
                    axes.append(axis)
                    steps.append(it.step or 1)
                axis += 1
            elif isinstance(it, int):
                starts.append(it)
                ends.append(it + 1 if it != -1 else np.iinfo(np.int32).max)
                axes.append(axis)
                steps.append(1)
                squeeze_axes.append(axis)
                axis += 1
            else:
                raise NotSupportedError(f"getitem index {it!r}")
        out = x
        if starts:
            out = self.b.node("Slice", [
                out,
                self.const(np.asarray(starts, np.int64)),
                self.const(np.asarray(ends, np.int64)),
                self.const(np.asarray(axes, np.int64)),
                self.const(np.asarray(steps, np.int64)),
            ])
        if squeeze_axes:
            out = self.b.node("Squeeze", [out, self.const(np.asarray(squeeze_axes, np.int64))])
        return out

    def call_method(self, node: torch.fx.Node) -> Any:
        name = node.target
        a = node.args
        b = self.b
        x = self.val(a[0])
        if name in ("view", "reshape"):
            return b.node("Reshape", [x, self.const(np.asarray(self.shape_of(node), np.int64))])
        if name == "permute":
            perm = a[1] if isinstance(a[1], (list, tuple)) else a[1:]
            return b.node("Transpose", [x], perm=list(perm))
        if name == "transpose":
            return self._transpose(node, a[1], a[2])
        if name == "flatten":
            return b.node("Reshape", [x, self.const(np.asarray(self.shape_of(node), np.int64))])
        if name == "contiguous":
            return x
        if name in ("mean", "sum", "amax", "amin", "max", "min", "prod"):
            onnx_op = {"mean": "ReduceMean", "sum": "ReduceSum",
                       "amax": "ReduceMax", "max": "ReduceMax",
                       "amin": "ReduceMin", "min": "ReduceMin",
                       "prod": "ReduceProd"}[name]
            dim = node.kwargs.get("dim", a[1] if len(a) > 1 else None)
            keep = node.kwargs.get("keepdim", False)
            if dim is None:
                axes = list(range(len(self.shape_of(node.args[0]))))
            elif name in ("max", "min") and not isinstance(dim, (list, tuple)):
                # x.max(dim) returns (values, indices) — only support the
                # reduce-all form here; dim'd max/min comes via torch.max.
                raise NotSupportedError(f".{name}(dim) returns a tuple; use "
                                        f"torch.a{name} instead")
            else:
                axes = [dim] if isinstance(dim, int) else list(dim)
            if onnx_op == "ReduceSum":  # axes moved to input at opset 13
                return b.node(onnx_op, [x, self.const(np.asarray(axes, np.int64))],
                              keepdims=int(keep))
            return b.node(onnx_op, [x], axes=axes, keepdims=int(keep))
        if name == "chunk":
            chunks = a[1]
            dim = node.kwargs.get("dim", a[2] if len(a) > 2 else 0)
            return b.node("Split", [x], outputs=chunks, axis=dim)
        if name == "unsqueeze":
            return b.node("Unsqueeze", [x, self.const(np.asarray([a[1]], np.int64))])
        if name == "squeeze":
            return b.node("Squeeze", [x, self.const(np.asarray([a[1]], np.int64))])
        if name == "expand":
            return b.node("Expand", [x, self.const(np.asarray(self.shape_of(node), np.int64))])
        if name == "size":
            raise NotSupportedError(".size() — use static shapes in zoo models")
        if name == "softmax":
            return b.node("Softmax", [x], axis=node.kwargs.get("dim", a[1] if len(a) > 1 else -1))
        if name == "mul":
            rhs = self.val(a[1])
            if not isinstance(rhs, str):
                rhs = self.const(np.float32(rhs))
            return b.node("Mul", [x, rhs])
        if name == "add":
            rhs = self.val(a[1])
            if not isinstance(rhs, str):
                rhs = self.const(np.float32(rhs))
            return b.node("Add", [x, rhs])
        raise NotSupportedError(f"torch method .{name}()")

    # -- driver ----------------------------------------------------------

    def run(self) -> Graph:
        out_edges = None
        for node in self.gm.graph.nodes:
            if node.op == "placeholder":
                shape = self.shape_of(node)
                self.env[node] = self.b.input(node.name, shape, dt.FLOAT)
            elif node.op == "get_attr":
                t = self.gm
                for part in node.target.split("."):
                    t = getattr(t, part)
                self.env[node] = self.b.init(_np(t), node.target.replace(".", "_"))
            elif node.op == "call_module":
                self.env[node] = self.call_module(node)
            elif node.op == "call_function":
                self.env[node] = self.call_function(node)
            elif node.op == "call_method":
                self.env[node] = self.call_method(node)
            elif node.op == "output":
                out = node.args[0]
                outs = out if isinstance(out, (tuple, list)) else [out]
                out_edges = [self.val(o) for o in outs]
        g = self.b.finish(out_edges)
        g.toposort()
        g.dead_code_eliminate()
        return g


def export_torch(module: nn.Module, example, name: str = "model",
                 opset: int = 17) -> Graph:
    """Trace `module` in eval mode and convert to an IR graph. `example` is
    one tensor or a tuple of tensors for multi-input modules."""
    with torch.no_grad():
        return _Exporter(module, example, name, opset).run()
