"""Transfer learning: the port of `deeplearning4j_tpu/nn/transferlearning.py`
(`FineTuneConfiguration`, `TransferLearning.Builder`,
`TransferLearningHelper`, `GraphTransferLearning.GraphBuilder`): copy a
trained network, freeze layers up to a boundary (or a graph vertex and its
ancestors), remove or replace output layers, override training
hyperparameters, and featurize through the frozen part. A frozen layer is
`frozen=True` on its config: its parameters take no gradient and the update
leaves them alone. The edited network is built on the source's device; a
re-initialized layer draws from the new network's own seed.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional

import torch

from .conf import NeuralNetConfiguration
from .conf.base import LayerConf
from .multilayer import MultiLayerNetwork
from .trees import tree_map
from ..datasets.iterators import DataSet

__all__ = ["FineTuneConfiguration", "TransferLearning",
           "GraphTransferLearning", "TransferLearningHelper"]


def _tree_shapes_match(fresh, src) -> bool:
    """Same keys and leaf shapes — the transfer copy guard."""
    if not isinstance(fresh, dict) or not isinstance(src, dict):
        return tuple(fresh.shape) == tuple(src.shape)
    return (set(fresh) == set(src)
            and all(_tree_shapes_match(fresh[k], src[k]) for k in src))


def _copy_tree(t):
    """Deep-copy a parameter or state tree into fresh tensors."""
    return tree_map(lambda a: a.detach().clone(), t)


@dataclass
class FineTuneConfiguration:
    """Hyperparameter overrides applied to all non-frozen layers
    (reference `FineTuneConfiguration.java`)."""

    updater: Optional[object] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    dropout: Optional[float] = None
    seed: Optional[int] = None
    weight_init: Optional[str] = None
    activation: Optional[str] = None

    class Builder:
        def __init__(self):
            self._c = FineTuneConfiguration()

        def updater(self, u, learning_rate=None):
            from . import updaters as _updaters
            self._c.updater = _updaters.get(u, learning_rate); return self

        def l1(self, v):
            self._c.l1 = float(v); return self

        def l2(self, v):
            self._c.l2 = float(v); return self

        def dropout(self, v):
            self._c.dropout = float(v); return self

        def seed(self, s):
            self._c.seed = int(s); return self

        def weight_init(self, w):
            self._c.weight_init = w; return self

        def activation(self, a):
            self._c.activation = a; return self

        def build(self):
            return self._c

    def apply_to_global(self, conf: NeuralNetConfiguration) -> NeuralNetConfiguration:
        kw = {}
        if self.updater is not None:
            kw["updater"] = self.updater
        if self.l1 is not None:
            kw["l1"] = self.l1
            kw["use_regularization"] = True
        if self.l2 is not None:
            kw["l2"] = self.l2
            kw["use_regularization"] = True
        if self.seed is not None:
            kw["seed"] = self.seed
        return replace(conf, **kw) if kw else conf

    def apply_to_layer(self, layer: LayerConf) -> LayerConf:
        kw = {}
        if self.updater is not None:
            kw["updater"] = self.updater
        if self.l1 is not None:
            kw["l1"] = self.l1
        if self.l2 is not None:
            kw["l2"] = self.l2
        if self.dropout is not None:
            kw["dropout"] = self.dropout
        return replace(layer, **kw) if kw else layer


class TransferLearning:
    """`TransferLearning.Builder(model)` fluent API."""

    class Builder:
        def __init__(self, model: MultiLayerNetwork):
            if model.params is None:
                raise ValueError("Model must be initialized/trained first")
            self._model = model
            self._fine_tune: Optional[FineTuneConfiguration] = None
            self._freeze_until: Optional[int] = None
            self._n_out_replacements: Dict[int, tuple] = {}
            self._remove_from: Optional[int] = None
            self._appended: List[LayerConf] = []

        def fine_tune_configuration(self, ftc: FineTuneConfiguration):
            self._fine_tune = ftc
            return self

        def set_feature_extractor(self, layer_idx: int):
            """Freeze layers [0..layer_idx] (reference setFeatureExtractor)."""
            self._freeze_until = int(layer_idx)
            return self

        def nout_replace(self, layer_idx: int, n_out: int,
                         weight_init: Optional[str] = None):
            """Change a layer's n_out and reinit it (+ reinit next layer's
            n_in) — reference nOutReplace."""
            self._n_out_replacements[int(layer_idx)] = (int(n_out), weight_init)
            return self

        def remove_output_layer(self):
            return self.remove_layers_from_output(len(self._model.layers) - 1)

        def remove_layers_from_output(self, idx: int):
            self._remove_from = int(idx)
            return self

        def add_layer(self, layer: LayerConf):
            self._appended.append(layer)
            return self

        def build(self) -> MultiLayerNetwork:
            src = self._model
            layers = [replace(l) for l in src.layers]
            params = [dict(p) for p in src.params]
            reinit = set()

            if self._remove_from is not None:
                layers = layers[:self._remove_from]
                params = params[:self._remove_from]

            for idx, (n_out, w_init) in sorted(self._n_out_replacements.items()):
                if idx >= len(layers):
                    raise ValueError(f"nout_replace index {idx} out of range")
                kw = {"n_out": n_out}
                if w_init:
                    kw["weight_init"] = w_init
                layers[idx] = replace(layers[idx], **kw)
                reinit.add(idx)
                if idx + 1 < len(layers) and hasattr(layers[idx + 1], "n_in"):
                    layers[idx + 1] = replace(layers[idx + 1], n_in=None)
                    reinit.add(idx + 1)

            n_existing = len(layers)
            layers.extend(self._appended)
            params.extend({} for _ in self._appended)
            reinit.update(range(n_existing, len(layers)))

            if self._fine_tune is not None:
                layers = [l if l.frozen else self._fine_tune.apply_to_layer(l)
                          for l in layers]

            if self._freeze_until is not None:
                for i in range(min(self._freeze_until + 1, len(layers))):
                    layers[i] = replace(layers[i], frozen=True)

            g_conf = src.conf.conf
            if self._fine_tune is not None:
                g_conf = self._fine_tune.apply_to_global(g_conf)

            # re-run shape inference over the edited layer list
            from .conf import ListBuilder
            lb = ListBuilder(g_conf)
            for l in layers:
                lb.layer(l)
            if src.conf.input_type is not None:
                lb.set_input_type(src.conf.input_type)
            for i, pp in src.conf.preprocessors.items():
                if i < len(layers):
                    lb.input_pre_processor(i, pp)
            new_conf = lb.build()
            # ListBuilder re-resolves inheritance; keep frozen flags
            new_net = MultiLayerNetwork(new_conf, device=src.device)
            new_net.init()
            # copy kept params AND layer state (BN running mean/var — the
            # reference keeps global stats in the param table, so transfer
            # carries them; without this a transferred frozen feature
            # extractor produces wrong eval outputs until stats re-warm);
            # reinit'ed layers keep fresh values
            new_params = list(new_net.params)
            new_state = list(new_net.state)
            src_state = list(src.state)
            if self._remove_from is not None:
                src_state = src_state[:self._remove_from]
            for i in range(len(new_conf.layers)):
                if i < len(params) and i not in reinit and params[i]:
                    new_params[i] = _copy_tree(params[i])
                if (i < len(src_state) and i not in reinit and src_state[i]
                        and _tree_shapes_match(new_state[i], src_state[i])):
                    new_state[i] = _copy_tree(src_state[i])
            new_net.params = tuple(new_params)
            new_net.state = tuple(new_state)
            return new_net


class TransferLearningHelper:
    """Featurize through the frozen part once; train only the unfrozen tail
    (reference `TransferLearningHelper.java`)."""

    def __init__(self, model: MultiLayerNetwork,
                 frozen_until: Optional[int] = None):
        self.model = model
        if frozen_until is None:
            frozen_until = -1
            for i, l in enumerate(model.layers):
                if l.frozen:
                    frozen_until = i
        self.frozen_until = frozen_until

    def featurize(self, ds: DataSet) -> DataSet:
        """Run the frozen head once and return a DataSet of features for the
        trainable tail."""
        x = self.model._as_input(ds.features)
        with torch.no_grad():
            h, _, _, _ = self.model._forward(
                self.model.params, self.model.state, x, False, None,
                upto=self.frozen_until + 1)
        return DataSet(h.cpu().numpy(), ds.labels, ds.features_mask,
                       ds.labels_mask)

    def unfrozen_graph(self) -> MultiLayerNetwork:
        """A network of only the unfrozen tail (shares param values)."""
        from .conf import ListBuilder
        tail_layers = self.model.layers[self.frozen_until + 1:]
        lb = ListBuilder(self.model.conf.conf)
        for l in tail_layers:
            lb.layer(replace(l))
        net = MultiLayerNetwork(lb.build(), device=self.model.device)
        net.init()
        net.params = tuple(
            _copy_tree(p) for p in self.model.params[self.frozen_until + 1:])
        return net

    def fit_featurized(self, ds: DataSet):
        """Train the tail on featurized data, writing params back."""
        tail = self.unfrozen_graph()
        tail.fit(ds)
        k = self.frozen_until + 1
        new_params = list(self.model.params)
        for i, p in enumerate(tail.params):
            new_params[k + i] = p
        self.model.params = tuple(new_params)
        return self.model


class GraphTransferLearning:
    """`TransferLearning.GraphBuilder` parity
    (`nn/transferlearning/TransferLearning.java` GraphBuilder inner class):
    freeze ancestor subgraphs (setFeatureExtractor), nOutReplace on named
    layers (downstream consumers re-inferred + re-initialized), remove /
    add vertices, change network outputs — then rebuild with shape
    inference and transfer every surviving parameter."""

    class GraphBuilder:
        def __init__(self, graph):
            if graph.params is None:
                raise ValueError("Graph must be initialized/trained first")
            self._graph = graph
            self._fine_tune: Optional[FineTuneConfiguration] = None
            self._freeze_roots: List[str] = []
            self._n_out_replacements: Dict[str, tuple] = {}
            self._removed: List[str] = []
            self._added: List[tuple] = []     # (name, layer_or_vertex, inputs)
            self._outputs: Optional[List[str]] = None

        def fine_tune_configuration(self, ftc: FineTuneConfiguration):
            self._fine_tune = ftc
            return self

        def set_feature_extractor(self, *vertex_names: str):
            """Freeze the named vertices and every ancestor (reference
            setFeatureExtractor: everything up to and including the named
            vertices becomes a frozen feature extractor)."""
            self._freeze_roots.extend(vertex_names)
            return self

        def nout_replace(self, vertex_name: str, n_out: int,
                         weight_init: Optional[str] = None):
            self._n_out_replacements[vertex_name] = (int(n_out), weight_init)
            return self

        def remove_vertex_and_connections(self, name: str):
            self._removed.append(name)
            return self

        def add_layer(self, name: str, layer: LayerConf, *inputs: str):
            self._added.append((name, layer, inputs))
            return self

        def add_vertex(self, name: str, vertex, *inputs: str):
            self._added.append((name, vertex, inputs))
            return self

        def set_outputs(self, *names: str):
            self._outputs = list(names)
            return self

        # -- internals -------------------------------------------------
        def _ancestors(self, conf, roots):
            out = set()
            stack = list(roots)
            while stack:
                n = stack.pop()
                if n in out or n not in conf.vertices:
                    continue
                out.add(n)
                stack.extend(i for i in conf.vertex_inputs.get(n, ())
                             if i in conf.vertices)
            return out

        def build(self):
            from .graph import ComputationGraph

            src = self._graph
            conf = src.conf
            g_conf = conf.conf
            if self._fine_tune is not None:
                g_conf = self._fine_tune.apply_to_global(g_conf)

            removed = set(self._removed)
            vertices, vertex_inputs = {}, {}
            shape_changed = []   # vertices whose OUTPUT width may change
            for n in conf.topological_order:
                if n not in conf.vertices or n in removed:
                    continue
                ins = [i for i in conf.vertex_inputs[n] if i not in removed]
                if len(ins) != len(conf.vertex_inputs[n]) and not ins:
                    raise ValueError(
                        f"removing {sorted(removed)} strands vertex '{n}'")
                if len(ins) != len(conf.vertex_inputs[n]):
                    # narrowed a multi-input vertex (e.g. Merge lost a
                    # branch): its output shape changes downstream
                    shape_changed.append(n)
                v = conf.vertices[n]
                vertices[n] = replace(v) if isinstance(v, LayerConf) else v
                vertex_inputs[n] = ins

            reinit = set()
            for name, (n_out, w_init) in self._n_out_replacements.items():
                if name not in vertices:
                    raise ValueError(f"nout_replace: no vertex '{name}'")
                kw = {"n_out": n_out}
                if w_init:
                    kw["weight_init"] = w_init
                vertices[name] = replace(vertices[name], **kw)
                reinit.add(name)
                shape_changed.append(name)

            # propagate shape changes FORWARD: a consumer layer re-infers
            # its n_in (and is re-initialized, stopping propagation — its
            # n_out is unchanged); non-layer vertices (Merge/ElementWise/
            # ...) transmit the change to their own consumers
            frontier = list(shape_changed)
            seen = set(frontier)
            while frontier:
                src_name = frontier.pop()
                for c, ins in vertex_inputs.items():
                    if src_name not in ins:
                        continue
                    if isinstance(vertices[c], LayerConf):
                        if hasattr(vertices[c], "n_in"):
                            vertices[c] = replace(vertices[c], n_in=None)
                        reinit.add(c)
                    elif c not in seen:
                        seen.add(c)
                        frontier.append(c)

            for name, v, ins in self._added:
                vertices[name] = v
                vertex_inputs[name] = list(ins)
                reinit.add(name)

            frozen = self._ancestors(
                type("C", (), {"vertices": vertices,
                               "vertex_inputs": vertex_inputs})(),
                self._freeze_roots)
            for n in list(vertices):
                v = vertices[n]
                if not isinstance(v, LayerConf):
                    continue
                if self._fine_tune is not None and n not in frozen:
                    vertices[n] = v = self._fine_tune.apply_to_layer(v)
                if n in frozen:
                    vertices[n] = replace(v, frozen=True)

            # rebuild with shape inference through the standard builder,
            # adding vertices in an order where inputs precede consumers
            from .conf.graph import GraphBuilder as _GB
            gb = _GB(g_conf)
            gb.add_inputs(*conf.network_inputs)
            pending = dict(vertices)
            placed = set(conf.network_inputs)
            while pending:
                progressed = False
                for n in list(pending):
                    if all(i in placed for i in vertex_inputs[n]):
                        v = pending.pop(n)
                        if isinstance(v, LayerConf):
                            gb.add_layer(n, v, *vertex_inputs[n])
                        else:
                            gb.add_vertex(n, v, *vertex_inputs[n])
                        placed.add(n)
                        progressed = True
                if not progressed:
                    raise ValueError(
                        f"cannot order vertices {sorted(pending)} — "
                        "dangling inputs after edits")
            outputs = self._outputs or [o for o in conf.network_outputs
                                        if o in vertices]
            if not outputs:
                raise ValueError("no network outputs remain; set_outputs()")
            gb.set_outputs(*outputs)
            if conf.input_types:
                gb.set_input_types(*conf.input_types)
            new_graph = ComputationGraph(gb.build(), device=src.device)
            new_graph.init()
            # transfer surviving params AND layer state, SHAPE-CHECKED:
            # only copy when the fresh init's shapes match the source
            # exactly (belt and braces on top of the forward shape
            # propagation above). State carries BN running mean/var — the
            # reference keeps global stats in the param table, so a
            # transferred frozen feature extractor must keep them or eval/
            # featurize outputs are wrong until the stats re-warm
            new_params = dict(new_graph.params)
            new_state = dict(new_graph.state)
            for n, p in src.params.items():
                if n not in new_params or n in reinit or not p:
                    continue
                if _tree_shapes_match(new_params[n], p):
                    new_params[n] = _copy_tree(p)
            for n, s in src.state.items():
                if n not in new_state or n in reinit or not s:
                    continue
                if _tree_shapes_match(new_state[n], s):
                    new_state[n] = _copy_tree(s)
            new_graph.params = new_params
            new_graph.state = new_state
            return new_graph
