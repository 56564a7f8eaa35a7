"""Model-local ONNX function (FunctionProto) inlining.

The reference engine predates function-carrying models and walks only the
main GraphProto (reference: Sources/Smelter/ONNXGraph.swift:95-155); modern
dynamo-based torch exporters emit every aten op as a model-local function,
so a TPU engine must expand them to load such files at all. Inlining runs
at the proto level (before importer._graph_from_proto) so attribute
reference resolution (`ref_attr_name`) and nested subgraphs reuse the
existing decode path unchanged.

Policy: a call is inlined when the model defines a matching function
(keyed by domain/name/overload) UNLESS the op already has a registered
native lowering in an engine-owned domain — our fused lowerings beat a
primitive expansion (e.g. a model shipping a Gelu function body still gets
the native Gelu). Custom-domain calls always prefer the function body: the
registry is keyed by bare op_type, and a coincidental name match in a
foreign domain must not hijack the call.
"""

from __future__ import annotations

import copy
import warnings

from ..proto import onnx_wire as onnx
from .errors import ImportError_

AttrT = onnx.AttributeProto

# Domains whose op names the registry owns; function bodies for these are
# used only when no native lowering exists.
_ENGINE_DOMAINS = ("", "ai.onnx", "com.microsoft")

_MAX_DEPTH = 32


def _replace_nodes(gp: onnx.GraphProto, nodes) -> None:
    gp.node = list(nodes)


def _graph_local_names(gp: onnx.GraphProto) -> set[str]:
    """Names defined inside a subgraph (they shadow the enclosing function
    scope): formal inputs, initializers, and every node output."""
    local = {vi.name for vi in gp.input}
    local.update(tp.name for tp in gp.initializer)
    for n in gp.node:
        local.update(o for o in n.output if o)
    return local


def _rename_graph(gp: onnx.GraphProto, mapping: dict[str, str], prefix: str,
                  call_attrs: dict[str, onnx.AttributeProto],
                  defaults: dict[str, onnx.AttributeProto]) -> None:
    """Rewrite references to function-scope names inside a subgraph attr.
    Subgraph-local definitions shadow the function scope and stay as-is;
    anything else is a reference into the function body and follows the
    call-site mapping (bound formals) or gets the instantiation prefix.
    Nested nodes may also reference the function's attributes, so
    ref_attr_name resolution applies here too."""
    local = _graph_local_names(gp)

    def fix(name: str) -> str:
        if not name or name in local:
            return name
        return mapping.get(name, prefix + name)

    for n in gp.node:
        n.input[:] = [fix(x) for x in n.input]
        # outputs are subgraph-local by construction (in `local`)
        _resolve_attrs(n, call_attrs, defaults)
        for a in n.attribute:
            if a.type == AttrT.GRAPH:
                _rename_graph(a.g, mapping, prefix, call_attrs, defaults)
            elif a.type == AttrT.GRAPHS:
                for sub in a.graphs:
                    _rename_graph(sub, mapping, prefix, call_attrs, defaults)


def _resolve_attrs(body_node: onnx.NodeProto,
                   call_attrs: dict[str, onnx.AttributeProto],
                   defaults: dict[str, onnx.AttributeProto]) -> None:
    """Resolve ref_attr_name attributes against the call site (falling back
    to the function's declared defaults); unbound optional refs are dropped,
    per ONNX function semantics."""
    kept = []
    for a in body_node.attribute:
        ref = a.ref_attr_name
        if not ref:
            kept.append(a)
            continue
        src = call_attrs.get(ref, defaults.get(ref))
        if src is None:
            continue  # optional attribute left unbound -> absent
        resolved = copy.deepcopy(src)
        resolved.name = a.name
        resolved.ref_attr_name = ""
        kept.append(resolved)
    body_node.attribute = kept


class _Inliner:
    def __init__(self, mp: onnx.ModelProto, is_registered) -> None:
        self.funcs: dict[tuple[str, str, str], onnx.FunctionProto] = {}
        for f in mp.functions:
            self.funcs[(f.domain, f.name, f.overload)] = f
        self.is_registered = is_registered
        self.model_opset = 0
        for osi in mp.opset_import:
            if osi.domain in ("", "ai.onnx"):
                self.model_opset = int(osi.version)
        self.count = 0
        self._serial = 0

    def _lookup(self, n: onnx.NodeProto) -> onnx.FunctionProto | None:
        f = self.funcs.get((n.domain, n.op_type, n.overload))
        if f is None and n.overload:
            f = self.funcs.get((n.domain, n.op_type, ""))
        return f

    def expand(self, nodes, depth: int = 0) -> list[onnx.NodeProto]:
        if depth > _MAX_DEPTH:
            raise ImportError_(
                f"function inlining exceeded depth {_MAX_DEPTH} "
                "(recursive model-local functions?)")
        out: list[onnx.NodeProto] = []
        for n in nodes:
            f = self._lookup(n)
            use_native = (n.domain in _ENGINE_DOMAINS
                          and self.is_registered(n.op_type))
            if f is None or use_native:
                for a in n.attribute:
                    if a.type == AttrT.GRAPH:
                        _replace_nodes(a.g, self.expand(list(a.g.node),
                                                        depth + 1))
                    elif a.type == AttrT.GRAPHS:
                        for sub in a.graphs:
                            _replace_nodes(sub, self.expand(list(sub.node),
                                                            depth + 1))
                out.append(n)
                continue
            out.extend(self.expand(self._instantiate(f, n), depth + 1))
        return out

    def _instantiate(self, f: onnx.FunctionProto,
                     call: onnx.NodeProto) -> list[onnx.NodeProto]:
        for osi in f.opset_import:
            if (osi.domain in ("", "ai.onnx")
                    and self.model_opset
                    and int(osi.version) != self.model_opset):
                warnings.warn(
                    f"function {f.name!r} declares opset {osi.version} but "
                    f"the model imports opset {self.model_opset}; the body "
                    "is lowered at the model opset", stacklevel=2)
        self._serial += 1
        self.count += 1
        prefix = f"{f.name}_{self._serial}/"
        mapping: dict[str, str] = {}
        for formal, actual in zip(f.input, call.input):
            mapping[formal] = actual
        for formal in f.input[len(call.input):]:
            mapping[formal] = ""  # trailing optional inputs left unbound
        for formal, actual in zip(f.output, call.output):
            mapping[formal] = actual
        call_attrs = {a.name: a for a in call.attribute}
        defaults = {a.name: a for a in f.attribute_proto}

        def fix(name: str) -> str:
            if not name:
                return ""
            return mapping.get(name, prefix + name)

        body: list[onnx.NodeProto] = []
        for src in f.node:
            n = copy.deepcopy(src)
            n.input[:] = [fix(x) for x in n.input]
            n.output[:] = [fix(x) for x in n.output]
            n.name = prefix + (n.name or n.op_type)
            _resolve_attrs(n, call_attrs, defaults)
            for a in n.attribute:
                if a.type == AttrT.GRAPH:
                    _rename_graph(a.g, mapping, prefix, call_attrs, defaults)
                elif a.type == AttrT.GRAPHS:
                    for sub in a.graphs:
                        _rename_graph(sub, mapping, prefix, call_attrs,
                                      defaults)
            body.append(n)
        return body


def inline_functions(mp: onnx.ModelProto) -> int:
    """Expand model-local function calls in mp.graph in place. Returns the
    number of call sites inlined."""
    if not mp.functions:
        return 0
    from ..ops.registry import registered_ops

    registered = set(registered_ops())
    inliner = _Inliner(mp, registered.__contains__)
    _replace_nodes(mp.graph, inliner.expand(list(mp.graph.node)))
    mp.functions = []
    return inliner.count
