"""ComputationGraph configuration: the port of
`deeplearning4j_tpu/nn/conf/graph.py`. A graph is data: a dict of vertex
configs (layers and the parameter-free vertices below) and their input
edges, topologically sorted once at `build()`.

The twelve vertex types (MergeVertex, ElementWiseVertex, SubsetVertex,
StackVertex, UnstackVertex, ScaleVertex, ShiftVertex, L2Vertex,
L2NormalizeVertex, PreprocessorVertex, LastTimeStepVertex,
DuplicateToTimeSeriesVertex) each have `apply(inputs, masks)` on tensors,
`output_type(input_types)` and `output_mask(masks)`; with the layer vertex
they make the thirteen. `ComputationGraphConfiguration.to_json` writes the
JAX package's JSON field for field, and `from_json` reads it.

One departure from the JAX builder: a layer vertex given more than one
input raises a named ValueError at `build()` (JAX reads the first input and
drops the others without a word); a MergeVertex in front of the layer is
the way to feed it several.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from . import NeuralNetConfiguration, _fill_n_in
from .base import (LayerConf, conf_from_dict, conf_to_dict,
                   register_aux_dataclass)
from .input_type import InputType
from .preprocessors import infer_preprocessor

__all__ = [
    "GraphVertex", "MergeVertex", "ElementWiseVertex", "SubsetVertex",
    "StackVertex", "UnstackVertex", "ScaleVertex", "ShiftVertex", "L2Vertex",
    "L2NormalizeVertex", "PreprocessorVertex", "LastTimeStepVertex",
    "DuplicateToTimeSeriesVertex", "ComputationGraphConfiguration",
    "GraphBuilder",
]


class GraphVertex:
    """Parameter-free vertex: combines or transforms its input
    activations."""

    def apply(self, inputs: List[torch.Tensor], masks: List = None):
        raise NotImplementedError

    def output_type(self, input_types: List[InputType]) -> InputType:
        raise NotImplementedError

    def output_mask(self, masks: List):
        for m in (masks or []):
            if m is not None:
                return m
        return None


@register_aux_dataclass
@dataclass
class MergeVertex(GraphVertex):
    """Concatenate along the feature axis (the last: NHWC channels)."""

    def apply(self, inputs, masks=None):
        return torch.cat(inputs, dim=-1)

    def output_type(self, its):
        k = its[0].kind
        if k == "cnn":
            return InputType.convolutional(its[0].height, its[0].width,
                                           sum(t.channels for t in its))
        if k in ("rnn", "cnn1d"):
            return InputType.recurrent(sum(t.size for t in its),
                                       its[0].timesteps)
        return InputType.feed_forward(sum(t.flat_size() for t in its))


@register_aux_dataclass
@dataclass
class ElementWiseVertex(GraphVertex):
    """add | subtract | product | average | max."""

    op: str = "add"

    def apply(self, inputs, masks=None):
        op = self.op.lower()
        if op == "add":
            out = inputs[0]
            for x in inputs[1:]:
                out = out + x
            return out
        if op == "subtract":
            if len(inputs) != 2:
                raise ValueError("subtract needs exactly 2 inputs")
            return inputs[0] - inputs[1]
        if op == "product":
            out = inputs[0]
            for x in inputs[1:]:
                out = out * x
            return out
        if op == "average":
            out = inputs[0]
            for x in inputs[1:]:
                out = out + x
            return out / float(len(inputs))
        if op == "max":
            out = inputs[0]
            for x in inputs[1:]:
                out = torch.maximum(out, x)
            return out
        raise ValueError(f"Unknown elementwise op '{self.op}'")

    def output_type(self, its):
        return its[0]


@register_aux_dataclass
@dataclass
class SubsetVertex(GraphVertex):
    """Feature range [from_idx, to_idx], both ends included."""

    from_idx: int = 0
    to_idx: int = 0

    def apply(self, inputs, masks=None):
        return inputs[0][..., self.from_idx:self.to_idx + 1]

    def output_type(self, its):
        n = self.to_idx - self.from_idx + 1
        it = its[0]
        if it.kind in ("rnn", "cnn1d"):
            return InputType.recurrent(n, it.timesteps)
        if it.kind == "cnn":
            return InputType.convolutional(it.height, it.width, n)
        return InputType.feed_forward(n)


@register_aux_dataclass
@dataclass
class StackVertex(GraphVertex):
    """Concatenate along the batch axis."""

    def apply(self, inputs, masks=None):
        return torch.cat(inputs, dim=0)

    def output_type(self, its):
        return its[0]


@register_aux_dataclass
@dataclass
class UnstackVertex(GraphVertex):
    """Slice `from_idx` of `stack_size` equal batch chunks."""

    from_idx: int = 0
    stack_size: int = 1

    def apply(self, inputs, masks=None):
        x = inputs[0]
        step = x.shape[0] // self.stack_size
        return x[self.from_idx * step:(self.from_idx + 1) * step]

    def output_type(self, its):
        return its[0]


@register_aux_dataclass
@dataclass
class ScaleVertex(GraphVertex):
    scale: float = 1.0

    def apply(self, inputs, masks=None):
        return inputs[0] * self.scale

    def output_type(self, its):
        return its[0]


@register_aux_dataclass
@dataclass
class ShiftVertex(GraphVertex):
    shift: float = 0.0

    def apply(self, inputs, masks=None):
        return inputs[0] + self.shift

    def output_type(self, its):
        return its[0]


@register_aux_dataclass
@dataclass
class L2Vertex(GraphVertex):
    """Row-wise L2 distance between two inputs -> [B, 1]."""

    eps: float = 1e-8

    def apply(self, inputs, masks=None):
        a, b = inputs
        d = a.reshape(a.shape[0], -1) - b.reshape(b.shape[0], -1)
        return torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True) + self.eps)

    def output_type(self, its):
        return InputType.feed_forward(1)


@register_aux_dataclass
@dataclass
class L2NormalizeVertex(GraphVertex):
    eps: float = 1e-8

    def apply(self, inputs, masks=None):
        x = inputs[0]
        norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True) + self.eps)
        return x / norm

    def output_type(self, its):
        return its[0]


@register_aux_dataclass
@dataclass
class PreprocessorVertex(GraphVertex):
    preprocessor: object = None

    def apply(self, inputs, masks=None):
        return self.preprocessor.apply(inputs[0])

    def output_type(self, its):
        return self.preprocessor.output_type(its[0])

    def output_mask(self, masks):
        m = super().output_mask(masks)
        return self.preprocessor.apply_mask(m) if m is not None else None


@register_aux_dataclass
@dataclass
class LastTimeStepVertex(GraphVertex):
    """[B, T, F] -> [B, F]: the last unmasked step of each row (step 0 for
    a row with no live step)."""

    def apply(self, inputs, masks=None):
        x = inputs[0]
        m = masks[0] if masks else None
        if m is None:
            return x[:, -1]
        idx = torch.clamp(m.to(torch.int32).sum(dim=1) - 1, 0,
                          x.shape[1] - 1)
        return x[torch.arange(x.shape[0], device=x.device), idx.long()]

    def output_type(self, its):
        return InputType.feed_forward(its[0].size)

    def output_mask(self, masks):
        return None


@register_aux_dataclass
@dataclass
class DuplicateToTimeSeriesVertex(GraphVertex):
    """[B, F] -> [B, T, F], T taken from the second (reference) input."""

    def apply(self, inputs, masks=None):
        x, ref = inputs
        return x[:, None, :].expand(x.shape[0], ref.shape[1], x.shape[1])

    def output_type(self, its):
        return InputType.recurrent(its[0].flat_size(), its[1].timesteps)


# ---------------------------------------------------------------------------


@dataclass
class ComputationGraphConfiguration:
    conf: NeuralNetConfiguration
    network_inputs: List[str] = field(default_factory=list)
    network_outputs: List[str] = field(default_factory=list)
    vertices: Dict[str, object] = field(default_factory=dict)  # LayerConf | GraphVertex
    vertex_inputs: Dict[str, List[str]] = field(default_factory=dict)
    input_types: Optional[List[InputType]] = None
    backprop: bool = True
    pretrain: bool = False
    topological_order: List[str] = field(default_factory=list)
    # per vertex: [preprocessor or None, the InputType it receives] for a
    # layer; [None, [input types]] for a parameter-free vertex
    inferred_input_types: Dict[str, List] = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps({
            "conf": self.conf.to_dict(),
            "network_inputs": self.network_inputs,
            "network_outputs": self.network_outputs,
            "vertices": {k: conf_to_dict(v) for k, v in self.vertices.items()},
            "vertex_inputs": self.vertex_inputs,
            "input_types": conf_to_dict(self.input_types),
            "backprop": self.backprop,
            "pretrain": self.pretrain,
            "topological_order": self.topological_order,
            "inferred_input_types": {k: conf_to_dict(v) for k, v in
                                     self.inferred_input_types.items()},
        }, indent=2)

    @staticmethod
    def from_json(s: str) -> "ComputationGraphConfiguration":
        d = json.loads(s)
        return ComputationGraphConfiguration(
            conf=NeuralNetConfiguration.from_dict(d["conf"]),
            network_inputs=d["network_inputs"],
            network_outputs=d["network_outputs"],
            vertices={k: conf_from_dict(v) for k, v in d["vertices"].items()},
            vertex_inputs={k: list(v) for k, v in d["vertex_inputs"].items()},
            input_types=conf_from_dict(d.get("input_types")),
            backprop=d.get("backprop", True),
            pretrain=d.get("pretrain", False),
            topological_order=d.get("topological_order", []),
            inferred_input_types={k: conf_from_dict(v) for k, v in
                                  d.get("inferred_input_types", {}).items()},
        )


class GraphBuilder:
    """The fluent graph builder (`NeuralNetConfiguration.builder()...
    graph_builder()`)."""

    def __init__(self, conf: NeuralNetConfiguration):
        self._conf = conf
        self._inputs: List[str] = []
        self._outputs: List[str] = []
        self._vertices: Dict[str, object] = {}
        self._vertex_inputs: Dict[str, List[str]] = {}
        self._input_types: Optional[List[InputType]] = None
        self._backprop = True
        self._pretrain = False

    def add_inputs(self, *names: str):
        self._inputs.extend(names)
        return self

    def add_layer(self, name: str, layer: LayerConf, *inputs: str):
        if name in self._vertices:
            raise ValueError(f"Duplicate vertex name '{name}'")
        self._vertices[name] = layer
        self._vertex_inputs[name] = list(inputs)
        return self

    def add_vertex(self, name: str, vertex: GraphVertex, *inputs: str):
        if name in self._vertices:
            raise ValueError(f"Duplicate vertex name '{name}'")
        self._vertices[name] = vertex
        self._vertex_inputs[name] = list(inputs)
        return self

    def set_outputs(self, *names: str):
        self._outputs = list(names)
        return self

    def set_input_types(self, *its: InputType):
        self._input_types = list(its)
        return self

    def backprop(self, b: bool):
        self._backprop = bool(b)
        return self

    def pretrain(self, p: bool):
        self._pretrain = bool(p)
        return self

    # ------------------------------------------------------------------
    def build(self) -> ComputationGraphConfiguration:
        if not self._inputs:
            raise ValueError("Graph needs at least one input (add_inputs)")
        if not self._outputs:
            raise ValueError("Graph needs outputs (set_outputs)")
        for name, ins in self._vertex_inputs.items():
            for i in ins:
                if i not in self._vertices and i not in self._inputs:
                    raise ValueError(
                        f"Vertex '{name}' input '{i}' is not a vertex or "
                        "network input")
        for o in self._outputs:
            if o not in self._vertices:
                raise ValueError(f"Output '{o}' is not a vertex")
        for name, v in self._vertices.items():
            ins = self._vertex_inputs[name]
            if isinstance(v, LayerConf) and len(ins) > 1:
                raise ValueError(
                    f"Layer vertex '{name}' has {len(ins)} inputs {ins}; a "
                    "layer reads exactly one. Add a MergeVertex over them "
                    "and feed the layer from it")

        order = self._topo_sort()

        vertices = {k: (self._conf.resolve_layer(v) if isinstance(v, LayerConf)
                        else v) for k, v in self._vertices.items()}
        inferred: Dict[str, List] = {}
        if self._input_types is not None:
            if len(self._input_types) != len(self._inputs):
                raise ValueError("input_types count != inputs count")
            known: Dict[str, InputType] = dict(zip(self._inputs,
                                                   self._input_types))
            for name in order:
                if name in self._inputs:
                    continue
                v = vertices[name]
                in_types = [known[i] for i in self._vertex_inputs[name]]
                if isinstance(v, LayerConf):
                    it = in_types[0]
                    # the inferred shape adapter is kept beside the input
                    # type and applied by the graph's forward
                    pp = infer_preprocessor(it, v)
                    if pp is not None:
                        it = pp.output_type(it)
                    inferred[name] = [pp, it]
                    v = _fill_n_in(v, it)
                    vertices[name] = v
                    known[name] = v.output_type(it)
                else:
                    inferred[name] = [None, in_types]
                    known[name] = v.output_type(in_types)

        return ComputationGraphConfiguration(
            conf=self._conf, network_inputs=list(self._inputs),
            network_outputs=list(self._outputs), vertices=vertices,
            vertex_inputs=dict(self._vertex_inputs),
            input_types=self._input_types, backprop=self._backprop,
            pretrain=self._pretrain, topological_order=order,
            inferred_input_types=inferred)

    def _topo_sort(self) -> List[str]:
        """Kahn's algorithm with a sorted ready list: a deterministic
        order, the network inputs first."""
        indeg = {name: 0 for name in self._vertices}
        dependents: Dict[str, List[str]] = {}
        for name, ins in self._vertex_inputs.items():
            for i in ins:
                if i in self._vertices:
                    indeg[name] += 1
                    dependents.setdefault(i, []).append(name)
        ready = sorted([n for n, d in indeg.items() if d == 0])
        order = list(self._inputs)
        while ready:
            n = ready.pop(0)
            order.append(n)
            for dep in dependents.get(n, []):
                indeg[dep] -= 1
                if indeg[dep] == 0:
                    ready.append(dep)
            ready.sort()
        if len(order) != len(self._vertices) + len(self._inputs):
            raise ValueError("Graph has a cycle")
        return order
