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
`fit` on an iterator takes JAX's options, as `MultiLayerNetwork.fit` does:
windows of `superstep` steps (CUDA-graph replays on the card),
`grad_accumulation`, the input pipeline, checkpoints and resume, and a
`TrainingGuard` (`nn/superstep.py`, `nn/fitloop.py`).

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
from .multilayer import (MultiLayerNetwork, _compute_dtype, layer_scalars,
                         log, scalar_row, update_layer)
from .remat import checkpoint_call
from .trees import flat_leaves, flatten_tree, tree_map, unflatten_like
from ..datasets.iterators import DataSet, MultiDataSet
from ..eval.evaluation import Evaluation
from ..util.platform import DeviceLike, resolve_device, strict_fp32

__all__ = ["ComputationGraph"]


class ComputationGraph:
    # what a TrainingGuard snapshots and restores
    _fault_state_attrs = ("params", "state", "updater_state", "_generators",
                          "iteration_count", "epoch_count", "_score")
    _entry_name = "graph"

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
        self._batch_signatures = set()
        self.recompile_count = 0

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
        self.__dict__.pop("_captured_steps", None)
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

    def apply_vertex_updates(self, params, grads, opt_state, step,
                             scalars=None):
        """Per-vertex gradient normalization, scheduled lr, updater and
        bias-lr rescale; frozen and parameter-free vertices stay as they
        are. The step's scalars come from the host for `step`, or from
        `scalars`, the step's row (`_step_scalars`). Returns (new params,
        new updater state) as dicts."""
        new_params, new_opt, off = {}, {}, 0
        for name, p in params.items():
            layer = self.conf.vertices[name]
            g, os = grads[name], opt_state[name]
            if not p or layer.frozen:
                new_params[name], new_opt[name] = p, os
                continue
            new_params[name], new_opt[name], off = update_layer(
                self, layer, p, g, os, step, scalars, off)
        return new_params, new_opt

    def _step_scalars(self, step) -> List[float]:
        """The host scalars of every trainable vertex's update at `step`,
        in vertex order: the row a replayed step reads."""
        out = []
        for name, p in self.params.items():
            layer = self.conf.vertices[name]
            if p and not layer.frozen:
                out.extend(layer_scalars(self, layer, step))
        return out

    def apply_updates(self, params, grads, opt_state, step):
        """The UPDATE half on a full gradient tree (the counterpart of
        `grad_step_fn`). Returns (params, updater state) as dicts."""
        return self.apply_vertex_updates(params, grads, opt_state, step,
                                         scalar_row(self, step))

    @property
    def grad_step_fn(self):
        """The GRADIENT half of the train step, `(params, state, inputs,
        labels, fmasks, lmasks) -> (score, new_state, grads)` (dicts keyed
        by input / output name), the loss selection and the minimize sign
        folded in."""
        def grad_step(params, state, inputs, labels, fmasks, lmasks):
            return self._grad_fn(params, state,
                                 (inputs, labels, fmasks, lmasks))[:3]
        return grad_step

    def _value_and_grad(self, params, inputs, labels, generators, fmasks,
                        lmasks, loss_fn=None, state=None):
        """(score, new_state, grads): the loss at `params` (with layer
        state `state`, the graph's own when None) and its gradient tree
        (zeros for frozen vertices), with the minimize sign folded in."""
        state = self.state if state is None else state
        params = {n: tree_map(lambda v, f=self.conf.vertices[n].frozen:
                              v.detach().requires_grad_(not f), p)
                  for n, p in params.items()}
        leaves = [v for v in flat_leaves(params) if v.requires_grad]
        loss_fn = loss_fn or self._loss_fn
        with torch.enable_grad():
            score, new_state = loss_fn(params, state, inputs, labels,
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

    def _grad_fn(self, params, state, batch, carries=None):
        """(score, new_state, grads, None) of one batch `(inputs, labels,
        fmasks, lmasks)`; everything returned is detached."""
        inputs, labels, fmasks, lmasks = batch
        loss_fn = (self._full_remat_loss if self.conf.conf.remat == "full"
                   else self._loss_fn)
        score, new_state, grads = self._value_and_grad(
            params, inputs, labels, self._train_generators(), fmasks,
            lmasks, loss_fn, state=state)
        return (score, tree_map(torch.Tensor.detach, new_state), grads,
                None)

    def _update_fn(self, params, grads, opt_state, scalars):
        """The update with the step's scalar row (a replayed step's)."""
        return self.apply_vertex_updates(
            tree_map(torch.Tensor.detach, params), grads, opt_state, None,
            scalars)

    def _eager_update(self, params, grads, opt_state, step):
        return self.apply_updates(tree_map(torch.Tensor.detach, params),
                                  grads, opt_state, step)

    def _eager_step(self, params, state, opt_state, step, batch):
        score, new_state, grads, _ = self._grad_fn(params, state, batch)
        new_params, new_opt = self._eager_update(params, grads, opt_state,
                                                 step)
        return new_params, new_state, new_opt, score

    def _train_step(self, inputs, labels, fmasks, lmasks):
        """One optimizer step on one batch; stores the new parameters,
        updater state and (detached) layer state. Returns the score."""
        score, new_state, grads, _ = self._grad_fn(
            self.params, self.state, (inputs, labels, fmasks, lmasks))
        self.params, self.updater_state = self._eager_update(
            self.params, grads, self.updater_state, self.iteration_count)
        self.state = new_state
        return score

    # the protocol of nn/superstep.py's windows and captures
    def _carry_trees(self):
        return self.params, self.state, self.updater_state

    def _set_carry_trees(self, params, state, opt_state):
        self.params, self.state, self.updater_state = (
            dict(params), dict(state), dict(opt_state))

    def _dropout_generators(self):
        return list(self._train_generators() or [])

    @property
    def _dtype(self) -> torch.dtype:
        return getattr(torch, self.conf.conf.dtype)

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
        """(inputs, labels, features masks, labels masks) of a DataSet or
        MultiDataSet as dicts of tensors on the graph's device (the
        tensors the device prefetch staged, when it did)."""
        from ..datasets.pipeline import staged_tree
        if not isinstance(ds, (DataSet, MultiDataSet)):
            raise TypeError(f"Cannot fit on {type(ds)}")
        tree = staged_tree(ds, self.device, self._dtype)
        if tree is None:
            from ..datasets.pipeline import batch_tree
            leaves, rebuild = flatten_tree(batch_tree(ds))
            tree = rebuild([self._as_input(a) for a in leaves])
        return self._tree_dicts(ds, tree)

    def _tree_dicts(self, ds, tree):
        """A `datasets.pipeline.batch_tree`-shaped tree of tensors as the
        step's four dicts."""
        ins, outs = self.conf.network_inputs, self.conf.network_outputs
        f, l, fm, lm = tree
        if isinstance(ds, DataSet):
            if len(ins) != 1 or len(outs) != 1:
                raise ValueError("DataSet fits single-input/single-output "
                                 "graphs; use MultiDataSet")
            return ({ins[0]: f}, {outs[0]: l}, {ins[0]: fm}, {outs[0]: lm})
        fm = fm or (None,) * len(ins)
        lm = lm or (None,) * len(outs)
        return (dict(zip(ins, f)), dict(zip(outs, l)), dict(zip(ins, fm)),
                dict(zip(outs, lm)))

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------
    def fit(self, data, epochs: int = 1, *, superstep=1,
            grad_accumulation: int = 1, prefetch: bool = False,
            pad_ragged: bool = False, time_buckets=None,
            checkpoint_dir: Optional[str] = None, checkpoint_every: int = 0,
            resume: bool = False, guard=None) -> "ComputationGraph":
        """fit(DataSet | MultiDataSet) or fit(iterator): one optimizer step
        per batch. The keyword options behave exactly as on
        `MultiLayerNetwork.fit`: `superstep` windows (CUDA-graph replays on
        the card, eager on the CPU, bit-identical to K=1), gradient
        accumulation, the input pipeline (`pad_ragged`, `time_buckets`,
        `prefetch`), crash-safe checkpoints with resume, and a
        `TrainingGuard`. Line-search optimizers fall back to per-batch
        steps."""
        from .superstep import validate_grad_accumulation
        accum_m = validate_grad_accumulation(grad_accumulation)
        if self.params is None:
            self.init()
        if isinstance(data, (DataSet, MultiDataSet)):
            if checkpoint_dir is not None or resume:
                raise ValueError(
                    "checkpoint_dir/resume need an iterator fit (the "
                    "checkpoint records epoch/batch progress)")
            if accum_m != 1:
                raise ValueError(
                    f"grad_accumulation={accum_m} needs an iterator fit "
                    "(M consecutive microbatches form one optimizer step)")
            if superstep != 1:
                log.info("superstep=%r ignored for a single-DataSet fit "
                         "(one batch is one step); pass an iterator to "
                         "window batches", superstep)
            if guard is not None:
                guard.run_step(self, lambda: self._fit_batch(data))
            else:
                self._fit_batch(data)
            return self
        if not hasattr(data, "has_next"):
            raise TypeError(f"Cannot fit on {type(data)}")
        from .fitloop import fit_iterator
        return fit_iterator(
            self, data, epochs, superstep=superstep, accum_m=accum_m,
            prefetch=prefetch, pad_ragged=pad_ragged,
            time_buckets=time_buckets, checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every, resume=resume, guard=guard,
            context={"grad_accumulation": accum_m},
            epoch_listeners=False)

    def fit_scan_arrays(self, xs, ys, epochs: int = 1) -> "ComputationGraph":
        """Device-resident multi-step training: each epoch runs the T steps
        of `xs` / `ys` ([T, batch, ...] arrays for a single-input graph,
        or dicts keyed by input / output name) as one window (CUDA-graph
        replays on the card). Listener caveat: iteration_done is replayed
        after the window, so every call sees the window's final
        parameters."""
        from .fitloop import scan_epochs

        if self.params is None:
            self.init()
        if self.conf.conf.optimization_algo != \
                OptimizationAlgorithm.STOCHASTIC_GRADIENT_DESCENT:
            raise ValueError(
                "fit_scan_arrays supports SGD-updater training only; "
                "line-search optimizers are per-batch sequential — use fit()")
        if not isinstance(xs, dict):
            xs = {self.conf.network_inputs[0]: xs}
        if not isinstance(ys, dict):
            ys = {self.conf.network_outputs[0]: ys}
        xs = {k: self._as_input(v) for k, v in xs.items()}
        ys = {k: self._as_input(v) for k, v in ys.items()}
        n = int(next(iter(xs.values())).shape[0])
        none = lambda names: {k: None for k in names}
        batches = [({k: v[i] for k, v in xs.items()},
                    {k: v[i] for k, v in ys.items()}, none(xs), none(ys))
                   for i in range(n)]
        return scan_epochs(self, batches, None, epochs,
                           epoch_listeners=False)

    def _make_superstep_runner(self, superstep, guard, ckpt, accum_m=1):
        """SuperstepRunner for this fit, or None for the per-batch loop
        (superstep=1 with grad_accumulation=1, or a line-search optimizer,
        which rejects M>1 rather than silently changing the effective
        batch)."""
        from .superstep import (SuperstepRunner, accum_skip_nonfinite,
                                validate_superstep)

        k = validate_superstep(superstep)
        if k == 1 and accum_m == 1:
            return None
        if self.conf.conf.optimization_algo != \
                OptimizationAlgorithm.STOCHASTIC_GRADIENT_DESCENT:
            if accum_m != 1:
                raise ValueError(
                    f"grad_accumulation={accum_m} is not supported with "
                    "line-search optimizers (per-batch sequential)")
            log.info("superstep=%r falls back to per-batch dispatch: "
                     "line-search optimizers are per-batch sequential",
                     superstep)
            return None
        adapter = _GraphSuperstepAdapter(
            self, m=accum_m,
            skip_nonfinite=accum_skip_nonfinite(guard, accum_m))
        return SuperstepRunner(self, adapter, k, guard=guard, ckpt=ckpt,
                               grad_accumulation=accum_m)

    def _track_signature(self, batch):
        sig = tuple(None if a is None else tuple(a.shape)
                    for a in flatten_tree(batch)[0])
        if sig not in self._batch_signatures:
            self._batch_signatures.add(sig)
            self.recompile_count += 1

    _watched_train_step = MultiLayerNetwork._watched_train_step

    def _fit_batch(self, ds):
        from ..telemetry.runtime import active, null_span
        tel = active()
        span = tel.span if tel is not None else null_span
        with span("host/batch_prep"):
            inputs, labels, fmasks, lmasks = self._to_inputs(ds)
        self._track_signature((inputs, labels, fmasks, lmasks))
        if self.conf.conf.optimization_algo != \
                OptimizationAlgorithm.STOCHASTIC_GRADIENT_DESCENT:
            if self._line_solver is None:
                from ..optimize.solvers import GraphLineSearchSolver
                self._line_solver = GraphLineSearchSolver(
                    self, self.conf.conf.optimization_algo,
                    max_line_search_iterations=
                    self.conf.conf.max_num_line_search_iterations)
            with span("device/dispatch", kind="line_search"):
                self.params, new_state, score = self._line_solver.fit_batch(
                    self.params, self.state, inputs, labels,
                    self._train_generators(), fmasks, lmasks)
            self.state = tree_map(torch.Tensor.detach, new_state)
        else:
            with span("device/dispatch", kind="train_step"):
                score = self._watched_train_step(inputs, labels, fmasks,
                                                 lmasks)
        if tel is not None and tel.sync_per_step and score.is_cuda:
            with span("device/sync"):
                torch.cuda.current_stream(score.device).synchronize()
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


class _GraphSuperstepAdapter:
    """SuperstepRunner hooks for ComputationGraph (see nn/superstep.py):
    batches are dicts keyed by input / output name (DataSet or MultiDataSet
    sources), masks are dicts whose values may be None. With `m>1` the
    window trains in groups of m microbatches."""

    def __init__(self, net: ComputationGraph, m: int = 1,
                 skip_nonfinite: bool = False):
        self.net = net
        self.m = int(m)
        self.skip_nonfinite = bool(skip_nonfinite)

    @staticmethod
    def _shape(a):
        return None if a is None else tuple(np.shape(a))

    def signature(self, ds):
        if isinstance(ds, MultiDataSet):
            seq = lambda xs: (None if xs is None else
                              tuple(self._shape(a) for a in xs))
            return (seq(ds.features), seq(ds.labels),
                    seq(ds.features_masks), seq(ds.labels_masks))
        return (self._shape(ds.features), self._shape(ds.labels),
                self._shape(ds.features_mask), self._shape(ds.labels_mask))

    def batch_nbytes(self, ds):
        from ..datasets.pipeline import batch_nbytes, batch_tree
        return batch_nbytes(flatten_tree(batch_tree(ds))[0])

    def stage(self, window):
        from ..datasets.pipeline import stage_window
        trees = stage_window(window, self.net.device, self.net._dtype)
        return [self.net._tree_dicts(ds, t) for ds, t in zip(window, trees)]

    def dispatch(self, staged, n, step0):
        from .superstep import run_window
        return run_window(self.net, staged, step0, self.m,
                          self.skip_nonfinite)

    def on_window_end(self, window):
        last = window[-1]
        feats = (last.features[0] if isinstance(last, MultiDataSet)
                 else last.features)
        self.net.last_batch_size = int(np.shape(feats)[0])
