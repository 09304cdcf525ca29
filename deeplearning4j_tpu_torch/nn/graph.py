"""ComputationGraph — the DAG model: the port of
`deeplearning4j_tpu/nn/graph.py`.

Parameters, layer state and updater state are dicts keyed by vertex name
(one entry per layer vertex, `{}` for a layer without parameters), each
value the layer's own tree, as in JAX and in the zip (`k:<vertex>/k:W`).
The forward runs the vertices in the configuration's topological order:
a layer vertex applies its inferred input preprocessor and then the layer
(the same layer objects as `MultiLayerNetwork`, so a GravesLSTM vertex runs
the LSTM sequence kernels on the card and a bf16 [N, C]
BatchNormalization(relu) vertex the BN+ReLU kernels); a parameter-free
vertex combines its inputs. Network outputs that are output layers are
deferred: the forward hands back their input, and the loss (or `output`)
applies them.

Training (`fit` on a DataSet, a MultiDataSet or an iterator of either) is
one optimizer step per batch: the sum of every output's masked-mean loss,
plus l1/l2 over the rows live in any output's mask, plus the MoE router's
auxiliary loss; gradients from autograd; then per vertex the gradient
normalization, scheduled lr, updater and bias-lr rescale
(`apply_vertex_updates`), frozen vertices left as they are. A line-search
`optimization_algo` routes the batch through `GraphLineSearchSolver`.

Mixed precision (`compute_dtype`): floating inputs and every non-output
layer's parameters are cast to the compute dtype; output layers keep their
float32 masters. Remat "layer" / "blocks" put checkpoint boundaries around
each vertex / each segment that ends where one value is live; "full"
checkpoints the whole loss. The numbers stay bit-equal either way.

Dropout draws from torch generators: one for the hidden vertices and one
per network output, each seeded from the configuration's seed. Their
streams are not `jax.random`'s, so only dropout-free graphs compare with
JAX value for value.
"""
from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .conf import OptimizationAlgorithm
from .conf.base import LayerConf, cast_floating
from .conf.graph import ComputationGraphConfiguration
from .conf.input_type import InputType
from .gradnorm import apply_gradient_normalization
from .layers.feedforward import BaseOutputLayerConf
from .multilayer import (_compute_dtype, _rescale_bias_updates,
                         refuse_fit_options)
from .remat import checkpoint_call
from .trees import flat_leaves, tree_map, unflatten_like
from ..datasets.iterators import DataSet, MultiDataSet
from ..eval.evaluation import Evaluation
from ..util.platform import DeviceLike, resolve_device, strict_fp32

__all__ = ["ComputationGraph"]


class ComputationGraph:
    def __init__(self, conf: ComputationGraphConfiguration,
                 device: DeviceLike = None):
        self.conf = conf
        self.device = resolve_device(device)
        strict_fp32()
        self.params: Optional[Dict[str, Dict]] = None
        self.state: Optional[Dict[str, Dict]] = None
        self.updater_state: Optional[Dict[str, Dict]] = None
        self.iteration_count = 0
        self.epoch_count = 0
        self.listeners = []
        self.last_batch_size = 0
        self._score = float("nan")
        self._rnn_carries = None
        self._generators: Optional[List[torch.Generator]] = None
        self._dropout_seed = conf.conf.seed
        self._compute_dtype = _compute_dtype(conf.conf)
        self._line_solver = None

    # ------------------------------------------------------------------
    @property
    def layer_vertices(self) -> Dict[str, LayerConf]:
        return {k: v for k, v in self.conf.vertices.items()
                if isinstance(v, LayerConf)}

    def get_layer(self, name: str):
        return self.conf.vertices[name]

    @property
    def topological_order(self) -> List[str]:
        return self.conf.topological_order

    def init(self, seed: Optional[int] = None,
             generator: Optional[torch.Generator] = None
             ) -> "ComputationGraph":
        """Draw every layer vertex's parameters from `generator` (a fresh
        CPU generator seeded with `seed`, or the config's seed, when None)
        in sorted vertex-name order, place them on the graph's device, and
        give every vertex its updater's zero state."""
        from . import activations
        for layer in self.layer_vertices.values():
            if layer.activation is not None:    # fail fast on bad names
                activations.get(layer.activation)
        seed = self.conf.conf.seed if seed is None else int(seed)
        self._dropout_seed = seed
        self._generators = None
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        params, state = {}, {}
        for name in sorted(self.layer_vertices):
            layer = self.conf.vertices[name]
            it = self._input_type_for(name)
            params[name] = layer.init_params(generator, it, self.device)
            state[name] = layer.init_state(it, self.device)
        order = list(self.layer_vertices)
        self.params = {n: params[n] for n in order}
        self.state = {n: state[n] for n in order}
        self.updater_state = {
            n: self._layer_updater(self.conf.vertices[n]).init(self.params[n])
            for n in order}
        return self

    def _input_type_for(self, name) -> InputType:
        rec = self.conf.inferred_input_types.get(name)
        if rec is not None:
            it = rec[1]
            return it[0] if isinstance(it, list) else it
        layer = self.conf.vertices[name]
        n_in = getattr(layer, "n_in", None)
        if layer.has_params and not n_in:
            raise ValueError(
                f"Vertex '{name}' needs n_in or graph input_types")
        return InputType.feed_forward(n_in or 0)

    def _layer_updater(self, layer):
        return layer.updater or self.conf.conf.updater

    def to(self, device: DeviceLike) -> "ComputationGraph":
        """Move parameters, layer state, updater state and any stateful-RNN
        carries to `device`."""
        self.device = resolve_device(device)
        move = lambda d: tree_map(lambda v: v.to(self.device), d)
        self._generators = None
        if self.params is not None:
            self.params = move(self.params)
            self.state = move(self.state)
            self.updater_state = move(self.updater_state)
        if self._rnn_carries is not None:
            self._rnn_carries = {n: tuple(t.to(self.device) for t in c)
                                 for n, c in self._rnn_carries.items()}
        return self

    # ------------------------------------------------------------------
    # Forward
    # ------------------------------------------------------------------
    def _apply_vertex(self, name, values, masks, new_state, new_carries,
                      params, state, train, generator, cdt, out_set,
                      carries):
        """Apply one vertex, writing its value, mask, layer state and carry
        into the dicts given. Shared by the plain topological loop and the
        remat segments."""
        v = self.conf.vertices[name]
        in_names = self.conf.vertex_inputs[name]
        ins = [values[i] for i in in_names]
        in_masks = [masks.get(i) for i in in_names]
        if isinstance(v, LayerConf):
            x, m = ins[0], in_masks[0]
            rec = self.conf.inferred_input_types.get(name)
            if rec is not None and rec[0] is not None:
                x = rec[0].apply(x)
                m = rec[0].apply_mask(m)
            if name in out_set and isinstance(v, BaseOutputLayerConf):
                values[name] = (x, m)   # the loss or `output` applies it
                masks[name] = m
                return
            p_v = params[name]
            # hidden vertices compute in cdt; output layers keep the
            # master dtype, so the logits and the loss are float32
            if cdt is not None and not isinstance(v, BaseOutputLayerConf):
                p_v = cast_floating(p_v, cdt)
            kw = dict(train=train, generator=generator, mask=m)
            if carries is not None and getattr(v, "is_recurrent", False):
                (y, new_carries[name]), new_state[name] = v.apply(
                    p_v, state[name], x, carry=carries.get(name),
                    return_carry=True, **kw)
            else:
                y, new_state[name] = v.apply(p_v, state[name], x, **kw)
            values[name] = y
            masks[name] = v.output_mask(m)
        else:
            values[name] = v.apply(ins, in_masks)
            masks[name] = v.output_mask(in_masks)

    def _forward_values(self, params, state, inputs: Dict[str, torch.Tensor],
                        train=False, generator=None, fmasks=None,
                        stop_at_outputs=False, carries=None):
        """Run the vertices in topological order. Returns (values, masks,
        new_state, new_carries); `carries` (a dict keyed by recurrent
        vertex name) threads RNN state through `rnn_time_step`."""
        cdt = self._compute_dtype
        if cdt is not None:
            inputs = {k: (v.to(cdt) if v.is_floating_point() else v)
                      for k, v in inputs.items()}
        values: Dict = dict(inputs)
        masks: Dict = dict(fmasks or {})
        for k in self.conf.network_inputs:
            masks.setdefault(k, None)
        new_state = dict(state)
        new_carries: Dict = {}
        layer_names = [n for n in self.conf.topological_order
                       if n in self.conf.vertices]
        out_set = (set(self.conf.network_outputs) if stop_at_outputs
                   else set())
        remat = self.conf.conf.remat
        if remat in ("layer", "blocks") and train and carries is None:
            if all(m is None for m in masks.values()):
                self._forward_segments(remat, layer_names, values, masks,
                                       new_state, params, state, train,
                                       generator, cdt, out_set)
                return values, masks, new_state, new_carries
            warnings.warn(
                f"remat={remat!r} is inactive for this step: segment "
                "checkpointing does not support mask arrays; training "
                "falls back to the save-everything path", stacklevel=3)
        for name in layer_names:
            self._apply_vertex(name, values, masks, new_state, new_carries,
                               params, state, train, generator, cdt,
                               out_set, carries)
        return values, masks, new_state, new_carries

    def _last_use(self, layer_names) -> Dict[str, int]:
        last_use: Dict[str, int] = {}
        for j, n in enumerate(layer_names):
            for src in self.conf.vertex_inputs[n]:
                last_use[src] = max(last_use.get(src, -1), j)
        return last_use

    def _block_segments(self) -> List[List[str]]:
        """The topological order cut into remat segments wherever exactly
        one value is live: for a residual net the skip connection keeps a
        block's input live across the block, so the cuts land on block
        boundaries; a chain is cut at every vertex."""
        layer_names = [n for n in self.conf.topological_order
                       if n in self.conf.vertices]
        pos = {n: i for i, n in enumerate(layer_names)}
        last_use = self._last_use(layer_names)
        outputs = set(self.conf.network_outputs)
        segments, cur = [], []
        for i, n in enumerate(layer_names):
            cur.append(n)
            if i == len(layer_names) - 1:
                cut = True
            else:
                live = {v for v, lu in last_use.items()
                        if lu > i and pos.get(v, -1) <= i}
                live |= {o for o in outputs
                         if pos.get(o, len(layer_names)) <= i}
                cut = live == {n}
            if cut:
                segments.append(cur)
                cur = []
        if cur:
            segments.append(cur)
        return segments

    def _forward_segments(self, remat, layer_names, values, masks, new_state,
                          params, state, train, generator, cdt, out_set):
        """The topological order as checkpointed segments: only the values
        crossing a segment boundary are kept for the backward, the rest is
        recomputed."""
        pos = {n: i for i, n in enumerate(layer_names)}
        segments = ([[n] for n in layer_names] if remat == "layer"
                    else self._block_segments())
        last_use = self._last_use(layer_names)
        for seg in segments:
            seg_set = set(seg)
            seg_end = pos[seg[-1]]
            boundary = {src: values[src] for n in seg
                        for src in self.conf.vertex_inputs[n]
                        if src not in seg_set}
            seg_params = {n: params[n] for n in seg if n in params}
            seg_state = {n: state[n] for n in seg if n in state}
            keep = [n for n in seg
                    if last_use.get(n, -1) > seg_end or n in out_set]

            def seg_fn(boundary, seg_params, seg_state, _seg=tuple(seg),
                       _keep=tuple(keep)):
                vals = dict(boundary)
                msk = {k: None for k in vals}
                ns: Dict = {}
                for name in _seg:
                    self._apply_vertex(name, vals, msk, ns, {}, seg_params,
                                       seg_state, train, generator, cdt,
                                       out_set, None)
                return {n: vals[n] for n in _keep}, ns

            res, ns = checkpoint_call(seg_fn, self.conf.conf.remat_policy,
                                      boundary, seg_params, seg_state,
                                      generator=generator)
            values.update(res)
            masks.update({n: None for n in res})
            new_state.update(ns)

    # ------------------------------------------------------------------
    # Loss and update
    # ------------------------------------------------------------------
    def _reg_score(self, params):
        reg = 0.0
        for name, p in params.items():
            if p:
                reg = reg + self.conf.vertices[name].reg_score(p)
        return reg

    def _loss_fn(self, params, state, inputs, labels, generators=None,
                 fmasks=None, lmasks=None, train=True):
        """Sum of the outputs' losses + l1/l2 over live rows (+ the MoE
        auxiliary loss while training). `labels` and `lmasks` are dicts
        keyed by output name; `generators` is None or [hidden, output 0,
        output 1, ...]. Returns (score, new_state), as JAX's `_loss_fn`."""
        gens = generators or [None] * (1 + len(self.conf.network_outputs))
        values, masks, new_state, _ = self._forward_values(
            params, state, inputs, train, gens[0], fmasks,
            stop_at_outputs=True)
        total = 0.0
        batch = next(iter(inputs.values())).shape[0]
        live = None
        all_masked = True
        for i, name in enumerate(self.conf.network_outputs):
            v = self.conf.vertices[name]
            if not isinstance(v, BaseOutputLayerConf):
                raise ValueError(
                    f"Network output '{name}' must be an output/loss layer "
                    "for training")
            x, m = values[name]
            lm = (lmasks or {}).get(name)
            eff = lm if lm is not None else m
            total = total + v.loss_score(params[name], state[name], x,
                                         labels[name], train=train,
                                         generator=gens[1 + i], mask=eff)
            if eff is None:
                all_masked = False
            else:
                row = eff.to(torch.float32).reshape(eff.shape[0], -1) \
                    .amax(dim=1)
                live = row if live is None else torch.maximum(live, row)
        # l1/l2 normalised by the REAL rows (live in any output's mask),
        # not the padded batch size; an unmasked output counts every row
        if all_masked:
            batch = torch.clamp(live.sum(), min=1.0)
        score = total + self._reg_score(params) / batch
        if train:
            for name, s in new_state.items():
                v = self.conf.vertices.get(name)
                if v is not None and hasattr(v, "aux_score"):
                    score = score + v.aux_score(s)
        return score, new_state

    def _full_remat_loss(self, params, state, inputs, labels, generators=None,
                         fmasks=None, lmasks=None, train=True):
        """`_loss_fn` behind one checkpoint boundary (remat="full")."""
        fn = lambda p, s: self._loss_fn(p, s, inputs, labels, generators,
                                        fmasks, lmasks, train)
        return checkpoint_call(fn, self.conf.conf.remat_policy, params,
                               state, generator=generators)

    def _layer_lr(self, layer, step):
        sched = self.conf.conf.lr_schedule
        base = layer.learning_rate
        if sched is None:
            return base
        lr = sched(step)
        if base is not None and sched.base_lr:
            lr = lr * (base / sched.base_lr)
        return lr

    def apply_vertex_updates(self, params, grads, opt_state, step):
        """Per-vertex gradient normalization, scheduled lr, updater and
        bias-lr rescale; frozen and parameter-free vertices stay as they
        are. Returns (new params, new updater state) as dicts."""
        new_params, new_opt = {}, {}
        for name, p in params.items():
            layer = self.conf.vertices[name]
            g, os = grads[name], opt_state[name]
            if not p or layer.frozen:
                new_params[name], new_opt[name] = p, os
                continue
            g = apply_gradient_normalization(
                layer.gradient_normalization,
                layer.gradient_normalization_threshold or 1.0, g)
            upd = self._layer_updater(layer)
            lr = self._layer_lr(layer, step)
            updates, os = upd.update(g, os, step, lr)
            if layer.bias_learning_rate is not None:
                if lr is None:
                    eff = getattr(upd, "learning_rate", 1.0) or 1.0
                    scale = layer.bias_learning_rate / eff
                else:
                    scale = float(layer.bias_learning_rate / torch.clamp(
                        torch.as_tensor(lr, dtype=torch.float32),
                        min=1e-30))
                updates = _rescale_bias_updates(updates, scale)
            new_params[name] = tree_map(lambda a, u: a - u, p, updates)
            new_opt[name] = os
        return new_params, new_opt

    def _value_and_grad(self, params, inputs, labels, generators, fmasks,
                        lmasks, loss_fn=None):
        """(score, new_state, grads): the loss at `params` and its gradient
        tree (zeros for frozen vertices), with the minimize sign folded
        in."""
        params = {n: tree_map(lambda v, f=self.conf.vertices[n].frozen:
                              v.detach().requires_grad_(not f), p)
                  for n, p in params.items()}
        leaves = [v for v in flat_leaves(params) if v.requires_grad]
        loss_fn = loss_fn or self._loss_fn
        with torch.enable_grad():
            score, new_state = loss_fn(params, self.state, inputs, labels,
                                       generators, fmasks, lmasks,
                                       train=True)
            found = torch.autograd.grad(score, leaves, allow_unused=True) \
                if leaves else ()
        by_leaf = {id(v): d for v, d in zip(leaves, found)}
        sign = 1.0 if self.conf.conf.minimize else -1.0

        def grad_of(v):
            d = by_leaf.get(id(v))
            d = torch.zeros_like(v) if d is None else d
            return d if sign > 0 else -d
        grads = tree_map(grad_of, params)
        return score.detach(), new_state, grads

    def _train_step(self, inputs, labels, fmasks, lmasks):
        """One optimizer step on one batch; stores the new parameters,
        updater state and (detached) layer state. Returns the score."""
        loss_fn = (self._full_remat_loss if self.conf.conf.remat == "full"
                   else self._loss_fn)
        score, new_state, grads = self._value_and_grad(
            self.params, inputs, labels, self._train_generators(), fmasks,
            lmasks, loss_fn)
        detached = tree_map(torch.Tensor.detach, self.params)
        self.params, self.updater_state = self.apply_vertex_updates(
            detached, grads, self.updater_state, self.iteration_count)
        self.state = tree_map(torch.Tensor.detach, new_state)
        return score

    def _train_generators(self) -> Optional[List[torch.Generator]]:
        """[hidden, output 0, ...] dropout generators on the graph's device
        (None when no vertex uses dropout)."""
        if not any(getattr(v, "dropout", None)
                   for v in self.layer_vertices.values()):
            return None
        if self._generators is None:
            n = 1 + len(self.conf.network_outputs)
            self._generators = [
                torch.Generator(device=self.device).manual_seed(
                    self._dropout_seed + i) for i in range(n)]
        return self._generators

    # ------------------------------------------------------------------
    # Data plumbing
    # ------------------------------------------------------------------
    def _as_input(self, a) -> Optional[torch.Tensor]:
        if a is None:
            return None
        return torch.as_tensor(a, dtype=getattr(torch, self.conf.conf.dtype),
                               device=self.device)

    def _to_inputs(self, ds) -> Tuple[Dict, Dict, Dict, Dict]:
        ins, outs = self.conf.network_inputs, self.conf.network_outputs
        t = self._as_input
        if isinstance(ds, DataSet):
            if len(ins) != 1 or len(outs) != 1:
                raise ValueError("DataSet fits single-input/single-output "
                                 "graphs; use MultiDataSet")
            return ({ins[0]: t(ds.features)}, {outs[0]: t(ds.labels)},
                    {ins[0]: t(ds.features_mask)},
                    {outs[0]: t(ds.labels_mask)})
        if isinstance(ds, MultiDataSet):
            fm = ds.features_masks or (None,) * len(ins)
            lm = ds.labels_masks or (None,) * len(outs)
            return ({n: t(a) for n, a in zip(ins, ds.features)},
                    {n: t(a) for n, a in zip(outs, ds.labels)},
                    {n: t(a) for n, a in zip(ins, fm)},
                    {n: t(a) for n, a in zip(outs, lm)})
        raise TypeError(f"Cannot fit on {type(ds)}")

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------
    def fit(self, data, epochs: int = 1, *, superstep=1,
            grad_accumulation: int = 1, prefetch: bool = False,
            pad_ragged: bool = False, time_buckets=None,
            checkpoint_dir: Optional[str] = None, checkpoint_every: int = 0,
            resume: bool = False, guard=None) -> "ComputationGraph":
        """fit(DataSet | MultiDataSet) or fit(iterator): one optimizer step
        per batch. The keyword options after `epochs` are the JAX
        package's; only their defaults are in the port so far, and any
        other value raises."""
        refuse_fit_options(dict(
            superstep=superstep, grad_accumulation=grad_accumulation,
            prefetch=prefetch, pad_ragged=pad_ragged,
            time_buckets=time_buckets, checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every, resume=resume, guard=guard))
        if self.params is None:
            self.init()
        if isinstance(data, (DataSet, MultiDataSet)):
            self._fit_batch(data)
            return self
        if not hasattr(data, "has_next"):
            raise TypeError(f"Cannot fit on {type(data)}")
        for _ in range(epochs):
            data.reset()
            while data.has_next():
                self._fit_batch(data.next())
            self.epoch_count += 1
        return self

    def _fit_batch(self, ds):
        inputs, labels, fmasks, lmasks = self._to_inputs(ds)
        if self.conf.conf.optimization_algo != \
                OptimizationAlgorithm.STOCHASTIC_GRADIENT_DESCENT:
            if self._line_solver is None:
                from ..optimize.solvers import GraphLineSearchSolver
                self._line_solver = GraphLineSearchSolver(
                    self, self.conf.conf.optimization_algo,
                    max_line_search_iterations=
                    self.conf.conf.max_num_line_search_iterations)
            self.params, new_state, score = self._line_solver.fit_batch(
                self.params, self.state, inputs, labels,
                self._train_generators(), fmasks, lmasks)
            self.state = tree_map(torch.Tensor.detach, new_state)
        else:
            score = self._train_step(inputs, labels, fmasks, lmasks)
        self._score = score
        self.last_batch_size = int(next(iter(inputs.values())).shape[0])
        self.iteration_count += 1
        for listener in self.listeners:
            listener.iteration_done(self, self.iteration_count)

    # ------------------------------------------------------------------
    # Inference and scoring
    # ------------------------------------------------------------------
    def _collect_outputs(self, params, state, values):
        """Activate the network outputs from the forward's values."""
        outs = []
        for name in self.conf.network_outputs:
            v = self.conf.vertices[name]
            if isinstance(v, BaseOutputLayerConf):
                x, m = values[name]
                y, _ = v.apply(params[name], state[name], x, mask=m)
            else:
                y = values[name]
            outs.append(y)
        return tuple(outs)

    @property
    def predict_fn(self):
        """The pure inference step `(params, state, inputs, fmasks) ->
        tuple of outputs` (inputs and masks as dicts keyed by input
        name)."""
        def predict(params, state, inputs, fmasks):
            with torch.inference_mode():
                values, _, _, _ = self._forward_values(
                    params, state, inputs, False, None, fmasks,
                    stop_at_outputs=True)
                return self._collect_outputs(params, state, values)
        return predict

    def output(self, *features, features_masks=None
               ) -> Tuple[torch.Tensor, ...]:
        """The network outputs, one tensor per output, on the graph's
        device."""
        if self.params is None:
            self.init()
        ins = self.conf.network_inputs
        inputs = {n: self._as_input(f) for n, f in zip(ins, features)}
        fmasks = {n: None for n in ins}
        if features_masks is not None:
            fmasks = {n: self._as_input(m)
                      for n, m in zip(ins, features_masks)}
        return self.predict_fn(self.params, self.state, inputs, fmasks)

    def output_single(self, *features, **kw) -> torch.Tensor:
        return self.output(*features, **kw)[0]

    def rnn_time_step(self, *features):
        """Feed one step (2-D inputs) or a few (3-D) through the graph,
        carrying every recurrent vertex's state across calls."""
        if self.params is None:
            self.init()
        xs = [self._as_input(f) for f in features]
        squeeze = xs[0].dim() == 2
        xs = [x[:, None, :] if x.dim() == 2 else x for x in xs]
        inputs = dict(zip(self.conf.network_inputs, xs))
        batch = int(xs[0].shape[0])
        carries = self._rnn_carries
        if carries:
            cached = next(iter(carries.values()))[0].shape[0]
            if cached != batch:
                raise ValueError(
                    f"rnn_time_step batch changed from {cached} to "
                    f"{batch}; call rnn_clear_previous_state() first")
        if carries is None:
            rec = {n: v for n, v in self.conf.vertices.items()
                   if getattr(v, "is_recurrent", False)}
            carries, not_stepable = {}, []
            for n, v in rec.items():
                try:
                    carries[n] = v.init_carry(batch, xs[0].dtype,
                                              self.device)
                except ValueError:
                    not_stepable.append(n)
            if not_stepable:
                raise ValueError(
                    f"rnn_time_step unsupported for vertices "
                    f"{not_stepable} (bidirectional layers need the full "
                    "sequence — the reference rejects these too)")
        with torch.inference_mode():
            values, _, _, self._rnn_carries = self._forward_values(
                self.params, self.state, inputs, False, None, None,
                stop_at_outputs=True, carries=carries)
            outs = self._collect_outputs(self.params, self.state, values)
        if squeeze:
            outs = tuple(o[:, 0] if o.dim() == 3 else o for o in outs)
        return outs if len(outs) > 1 else outs[0]

    def rnn_clear_previous_state(self):
        self._rnn_carries = None

    def score(self, ds=None) -> float:
        """The last training step's score, or the score of `ds`."""
        if ds is None:
            return float(self._score)
        inputs, labels, fmasks, lmasks = self._to_inputs(ds)
        with torch.no_grad():
            s, _ = self._loss_fn(self.params, self.state, inputs, labels,
                                 None, fmasks, lmasks, train=False)
        return float(s)

    def score_examples(self, data, add_regularization_terms: bool = True
                       ) -> np.ndarray:
        """Per-example scores summed over every output (time series summed
        over time), with the graph's l1/l2 added to each when asked. Takes
        a DataSet, a MultiDataSet or an iterator of them."""
        if self.params is None:
            self.init()
        if not isinstance(data, (DataSet, MultiDataSet)):
            data.reset()
            outs = []
            while data.has_next():
                outs.append(self.score_examples(data.next(),
                                                add_regularization_terms))
            return (np.concatenate(outs) if outs
                    else np.zeros(0, np.float32))
        inputs, labels, fmasks, lmasks = self._to_inputs(data)
        with torch.no_grad():
            values, _, _, _ = self._forward_values(
                self.params, self.state, inputs, False, None, fmasks,
                stop_at_outputs=True)
            per = None
            for name in self.conf.network_outputs:
                v = self.conf.vertices[name]
                x, m = values[name]
                lm = lmasks.get(name)
                contrib = v.loss_per_example(
                    self.params[name], self.state[name], x, labels[name],
                    mask=lm if lm is not None else m)
                per = contrib if per is None else per + contrib
            if add_regularization_terms:
                per = per + self._reg_score(self.params)
        return per.cpu().numpy()

    def evaluate(self, iterator, labels_list=None, top_n: int = 1
                 ) -> Evaluation:
        ev = Evaluation(labels=labels_list, top_n=top_n)
        iterator.reset()
        while iterator.has_next():
            ds = iterator.next()
            if isinstance(ds, DataSet):
                out = self.output(ds.features,
                                  features_masks=[ds.features_mask])[0]
                ev.eval(ds.labels, out.cpu().numpy(), mask=ds.labels_mask)
            else:
                outs = self.output(*ds.features,
                                   features_masks=ds.features_masks)
                for o, l, m in zip(outs, ds.labels,
                                   ds.labels_masks or [None] * len(ds.labels)):
                    ev.eval(l, o.cpu().numpy(), mask=m)
        return ev

    def set_listeners(self, *listeners):
        self.listeners = list(listeners)
        return self

    # ------------------------------------------------------------------
    # Parameter plumbing
    # ------------------------------------------------------------------
    def num_params(self) -> int:
        return sum(int(leaf.numel()) for p in self.params.values()
                   for leaf in flat_leaves(p))

    def params_flat(self) -> np.ndarray:
        """Every parameter in one flat array (sorted vertex names, then
        sorted key paths)."""
        parts = [leaf.detach().cpu().numpy().ravel()
                 for name in sorted(self.params)
                 for leaf in flat_leaves(self.params[name])]
        return np.concatenate(parts) if parts else np.zeros(0, np.float32)

    def set_params_flat(self, vec: np.ndarray):
        """Inverse of `params_flat`."""
        vec = np.asarray(vec)
        to_leaf = lambda chunk, leaf: torch.tensor(
            chunk.reshape(tuple(leaf.shape)), dtype=leaf.dtype,
            device=leaf.device)
        pos, params = 0, dict(self.params)
        for name in sorted(self.params):
            params[name], pos = unflatten_like(self.params[name], vec, pos,
                                               to_leaf)
        self.params = params

    def clone(self) -> "ComputationGraph":
        """An independent copy: trees deep-copied, counters and the
        dropout generators' states carried over."""
        g = ComputationGraph(self.conf, device=self.device)
        if self.params is not None:
            copy = lambda d: tree_map(lambda v: v.detach().clone(), d)
            g.params = copy(self.params)
            g.state = copy(self.state)
            g.updater_state = copy(self.updater_state)
        g._dropout_seed = self._dropout_seed
        if self._generators is not None:
            g._generators = []
            for gen in self._generators:
                twin = torch.Generator(device=gen.device)
                twin.set_state(gen.get_state())
                g._generators.append(twin)
        g.iteration_count = self.iteration_count
        g.epoch_count = self.epoch_count
        return g
