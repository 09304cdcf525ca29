"""MultiLayerNetwork — the sequential model: the port of
`deeplearning4j_tpu/nn/multilayer.py`'s inference and per-batch training
surface.

The configuration's input preprocessors (`conf.preprocessors[i]`, a reshape
of the input to layer i) run wherever JAX runs them: in the forward, before
the output layer in the loss and `score_examples`, in `feed_forward`, and on
the input types at `init`.

Parameters are a tuple with one dict of tensors per layer (keys as in JAX:
`W`, `b`, `peep`, `gamma`; a GravesBidirectionalLSTM's dict nests one per
direction, and every walk over a tree goes through `nn/trees.py`), held on
the network's device; `state` is a tuple
with one layer-state dict per layer (BatchNormalization's running `mean` and
`var`, empty for the other layers), which the training forward renews and a
training step stores detached; `updater_state` is a tuple with one
updater-state dict per layer. `predict_fn` is the pure
`(params, state, x, fmask) -> out` forward that serving calls;
`rnn_time_step` threads one (h, c) carry per recurrent layer across calls.

Training: `fit(DataSet | DataSetIterator | (features, labels))` runs one
optimizer step per batch (`_fit_batch`; a line-search `optimization_algo`
takes `optimize/solvers.py` instead of the updater), or for a truncated-BPTT
configuration one step per chunk of `tbptt_fwd_length` time steps
(`_fit_tbptt`), with the recurrent carries flowing forward detached. A step
is the masked-mean loss of the output layer plus l1/l2 normalised by live
rows (`_loss_fn`), its gradients from autograd (the LSTM's through its
CUDA adjoint kernels, the transformer block's attention through the flash
dq and dk/dv kernels), then per layer: gradient normalization, the
scheduled per-layer lr, the updater, the bias-lr rescale
(`apply_layer_updates`).

Layerwise pretraining (`pretrain`, `pretrain_layer`, and `fit` on a
pretrain=True configuration) trains each AutoEncoder / RBM / VAE layer on
the activations below it with its own score and gradients. Remat
(`remat` "layer" / "blocks": each hidden layer behind a checkpoint
boundary; "full": the whole loss) goes through `nn/remat.py` and leaves
the numbers bit-equal.

Mixed precision (`compute_dtype`, e.g. "bfloat16", as in JAX): the masters,
the updater state and the layer state stay in the configuration's dtype; a
step casts a floating input and every non-output layer's parameters to the
compute dtype (`cast_floating`, through autograd, so gradients come back in
the master dtype), and the output layers keep master-dtype parameters, so
the logits and the loss are float32.
"""
from __future__ import annotations

import functools
import logging
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .conf import (BackpropType, MultiLayerConfiguration,
                   OptimizationAlgorithm)
from .conf.base import cast_floating
from .conf.input_type import InputType
from .gradnorm import apply_gradient_normalization
from .layers.feedforward import BaseOutputLayerConf
from .remat import checkpoint_call
from .trees import flat_leaves, flatten_tree, tree_map, unflatten_like
from .updaters import smul
from ..datasets.iterators import DataSet, DataSetIterator
from ..eval.evaluation import Evaluation
from ..util.platform import DeviceLike, resolve_device, strict_fp32

__all__ = ["MultiLayerNetwork"]

log = logging.getLogger("deeplearning4j_tpu_torch")


def _rescale_bias_updates(updates, scale):
    """Scale the bias entries (`b`, or a key containing "bias") of a
    layer's (possibly nested) updates: a BiLSTM rescales the biases of both
    directions."""
    if not isinstance(updates, dict):
        return updates
    return {k: (smul(scale, v) if not isinstance(v, dict)
                and (k == "b" or "bias" in k)
                else _rescale_bias_updates(v, scale))
            for k, v in updates.items()}


def _compute_dtype(c) -> Optional[torch.dtype]:
    """The mixed-precision compute dtype, or None when it is off (unset, or
    the same as the master dtype), as JAX's `_compute_dtype`."""
    if c.compute_dtype is None:
        return None
    cdt = getattr(torch, str(c.compute_dtype), None)
    if not isinstance(cdt, torch.dtype):
        raise ValueError(f"compute_dtype={c.compute_dtype!r} is not a torch "
                         "dtype name")
    return None if cdt == getattr(torch, c.dtype) else cdt


def _not_in_port(what: str, item: str):
    return NotImplementedError(
        f"{what} is not in the PyTorch port yet (ROADMAP A{item})")


def _bias_scale(layer, upd, lr) -> float:
    """The bias-lr rescale of a layer's updates: bias_lr / lr (updater
    steps are linear in lr, so rescaling the bias updates is exact), in
    float32 as JAX computes it."""
    if lr is None:
        eff = getattr(upd, "learning_rate", 1.0) or 1.0
        return layer.bias_learning_rate / eff
    return float(layer.bias_learning_rate / torch.clamp(
        torch.as_tensor(lr, dtype=torch.float32), min=1e-30))


def layer_scalars(model, layer, step) -> tuple:
    """The host scalars of one layer's update at `step`: its updater's
    (`Updater.scalars`), then the bias-lr rescale when the layer has a
    bias lr."""
    upd = model._layer_updater(layer)
    lr = model._layer_lr(layer, step)
    sc = tuple(upd.scalars(step, lr))
    if layer.bias_learning_rate is not None:
        sc += (_bias_scale(layer, upd, lr),)
    return sc


def _n_scalars(model, layer) -> int:
    n = len(model._layer_updater(layer).scalars(0, None))
    return n + (layer.bias_learning_rate is not None)


def update_layer(model, layer, p, g, os, step, scalars, off):
    """One layer's update: gradient normalization, then its updater and
    bias-lr rescale with the step's scalars — `layer_scalars(step)` on the
    host when `scalars` is None, else the `off`-th entries of the step's
    scalar row (floats or a 1-D tensor, whose entries come as 0-dim
    tensors). Returns (new params, new updater state, next offset)."""
    g = apply_gradient_normalization(
        layer.gradient_normalization,
        layer.gradient_normalization_threshold or 1.0, g)
    upd = model._layer_updater(layer)
    if scalars is None:
        sc = layer_scalars(model, layer, step)
    else:
        n = _n_scalars(model, layer)
        sc = tuple(scalars[off + j] for j in range(n))
        off += n
    n_upd = len(sc) - (layer.bias_learning_rate is not None)
    updates, os = upd.apply(g, os, sc[:n_upd])
    if layer.bias_learning_rate is not None:
        updates = _rescale_bias_updates(updates, sc[-1])
    return tree_map(lambda a, u: a - u, p, updates), os, off


def scalar_row(model, step):
    """The step's scalar row for the eager step: None on the CPU (the
    updaters compute their floats on the host), a 1-D float32 tensor on a
    CUDA device, the form a replayed step reads, so the eager step and
    the replay run the same arithmetic."""
    if model.device.type != "cuda":
        return None
    from .superstep import _scalar_rows
    return _scalar_rows(model, [step])[0]


class MultiLayerNetwork:
    # what a TrainingGuard snapshots and restores
    _fault_state_attrs = ("params", "state", "updater_state", "_generator",
                          "iteration_count", "epoch_count", "_score")

    def __init__(self, conf: MultiLayerConfiguration,
                 device: DeviceLike = None):
        self.conf = conf
        self.layers = list(conf.layers)
        self.device = resolve_device(device)
        strict_fp32()
        self.params: Optional[Tuple[Dict[str, torch.Tensor], ...]] = None
        self.state: Optional[Tuple[Dict, ...]] = None
        self.updater_state: Optional[Tuple[Dict, ...]] = None
        self.iteration_count = 0
        self.epoch_count = 0
        self.listeners = []
        self.last_batch_size = 0
        self._score = float("nan")
        self._input_types: Optional[List[InputType]] = None
        self._rnn_carries = None
        self._pretrained = False
        self._generator: Optional[torch.Generator] = None
        self._pretrain_gen: Optional[torch.Generator] = None
        self._dropout_seed = conf.conf.seed
        self._compute_dtype = _compute_dtype(conf.conf)
        self._line_solver = None
        self._batch_signatures = set()
        self.recompile_count = 0

    # ------------------------------------------------------------------
    # Initialization and placement
    # ------------------------------------------------------------------
    def init(self, seed: Optional[int] = None,
             generator: Optional[torch.Generator] = None
             ) -> "MultiLayerNetwork":
        """Draw every layer's parameters from `generator` (a fresh CPU
        generator seeded with `seed`, or the config's seed, when None),
        place them on the network's device, and give every layer its
        updater's zero state."""
        from . import activations
        for layer in self.layers:
            if layer.activation is not None:    # fail fast on bad names
                activations.get(layer.activation)
        seed = self.conf.conf.seed if seed is None else int(seed)
        self._dropout_seed = seed
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        it = self.conf.input_type
        self._input_types = []
        params, state = [], []
        for i, layer in enumerate(self.layers):
            if i in self.conf.preprocessors and it is not None:
                it = self.conf.preprocessors[i].output_type(it)
            if it is None:
                n_in = getattr(layer, "n_in", None)
                if layer.has_params and not n_in:
                    raise ValueError(
                        f"Layer {i} ({type(layer).__name__}) needs n_in or a "
                        "network input_type for shape inference")
                it = InputType.feed_forward(n_in or 0)
            self._input_types.append(it)
            params.append(layer.init_params(generator, it, self.device))
            state.append(layer.init_state(it, self.device))
            it = layer.output_type(it)
        self.params = tuple(params)
        self.state = tuple(state)
        self.updater_state = tuple(
            self._layer_updater(l).init(p) for l, p in zip(self.layers,
                                                           params))
        return self

    def _layer_updater(self, layer):
        return layer.updater or self.conf.conf.updater

    def to(self, device: DeviceLike) -> "MultiLayerNetwork":
        """Move parameters, layer state, updater state (and any stateful-RNN
        carries) to `device`."""
        self.device = resolve_device(device)
        move = lambda d: tree_map(lambda v: v.to(self.device), d)
        self._generator = self._pretrain_gen = None
        self.__dict__.pop("_captured_steps", None)
        if self.params is not None:
            self.params = tuple(move(p) for p in self.params)
            self.state = tuple(move(s) for s in self.state)
            self.updater_state = tuple(move(u) for u in self.updater_state)
        if self._rnn_carries is not None:
            self._rnn_carries = tuple(
                None if c is None else tuple(t.to(self.device) for t in c)
                for c in self._rnn_carries)
        return self

    # ------------------------------------------------------------------
    # Forward
    # ------------------------------------------------------------------
    def _forward(self, params, state, x, train=False, generator=None,
                 fmask=None, upto=None, carries=None):
        """Returns (activations, new_state, mask, new_carries) after the
        first `upto` layers (all when None); `new_state` has one entry per
        layer (the layers past `upto` keep theirs). `carries` (one entry per
        layer, None for non-recurrent layers) threads RNN state across TBPTT
        chunks and rnn_time_step calls."""
        new_carries = (list(carries) if carries is not None
                       else [None] * len(self.layers))
        new_state = list(state)
        mask = fmask
        n = len(self.layers) if upto is None else upto
        cdt = self._compute_dtype
        if cdt is not None and x.is_floating_point():
            x = x.to(cdt)
        # per-layer remat ("blocks" is "layer" for a sequential net): each
        # hidden layer behind a checkpoint boundary, where JAX puts one
        use_remat = (self.conf.conf.remat in ("layer", "blocks") and train
                     and carries is None and fmask is None)
        if self.conf.conf.remat in ("layer", "blocks") and train \
                and not use_remat:
            warnings.warn(
                f"remat={self.conf.conf.remat!r} is inactive for this "
                "step: per-layer checkpointing does not support mask "
                "arrays or TBPTT carries; training falls back to the "
                "save-everything path", stacklevel=3)
        for i, layer in enumerate(self.layers[:n]):
            kw = dict(train=train, generator=generator, mask=mask)
            p_i = params[i]
            # hidden layers compute in cdt; output layers keep the master
            # dtype, so the logits and the loss are float32
            if cdt is not None and not isinstance(layer, BaseOutputLayerConf):
                p_i = cast_floating(p_i, cdt)
            x, mask = self._preprocess(i, x, mask)
            if carries is not None and getattr(layer, "is_recurrent", False):
                (x, new_carries[i]), new_state[i] = layer.apply(
                    p_i, state[i], x, carry=carries[i], return_carry=True,
                    **kw)
            elif (use_remat and mask is None
                    and not isinstance(layer, BaseOutputLayerConf)):
                fn = lambda p_, s_, x_, _l=layer: _l.apply(
                    p_, s_, x_, train=train, generator=generator, mask=None)
                x, new_state[i] = checkpoint_call(
                    fn, layer.remat_policy, p_i, state[i], x,
                    generator=generator)
            else:
                x, new_state[i] = layer.apply(p_i, state[i], x, **kw)
            mask = layer.output_mask(mask)
        return x, tuple(new_state), mask, tuple(new_carries)

    def _preprocess(self, i, x, mask):
        """The input preprocessor of layer i, if the configuration has one,
        applied to the activations and the mask."""
        pp = self.conf.preprocessors.get(i)
        if pp is None:
            return x, mask
        return pp.apply(x), pp.apply_mask(mask)

    # ------------------------------------------------------------------
    # Loss and update
    # ------------------------------------------------------------------
    def _reg_score(self, params):
        reg = 0.0
        for layer, p in zip(self.layers, params):
            if p:
                reg = reg + layer.reg_score(p)
        return reg

    def _loss_fn(self, params, state, x, y, generator=None, fmask=None,
                 lmask=None, train=True, carries=None):
        """Scalar score = masked-mean loss of the output layer + l1/l2 over
        the live rows of the batch. Returns (score, (new_state,
        new_carries)), as JAX's `_loss_fn`."""
        out_layer = self.layers[-1]
        if not isinstance(out_layer, BaseOutputLayerConf):
            raise ValueError("Last layer must be an output/loss layer for fit()")
        n = len(self.layers)
        h, new_state, mask, new_carries = self._forward(
            params, state, x, train, generator, fmask=fmask, upto=n - 1,
            carries=carries)
        h, mask = self._preprocess(n - 1, h, mask)
        eff_lmask = lmask if lmask is not None else mask
        loss = out_layer.loss_score(params[-1], state[-1], h, y, train=train,
                                    generator=generator, mask=eff_lmask)
        # l1/l2 normalised by REAL rows (any live mask entry), not the
        # padded batch size
        batch = x.shape[0]
        if eff_lmask is not None:
            live = eff_lmask.to(torch.float32).reshape(
                eff_lmask.shape[0], -1).amax(dim=1)
            batch = torch.clamp(live.sum(), min=1.0)
        score = loss + self._reg_score(params) / batch
        # layer auxiliary losses from the state (the MoE router's load
        # balance), while training only: evaluation state holds a stale one
        if train:
            for layer, st in zip(self.layers, new_state):
                if hasattr(layer, "aux_score"):
                    score = score + layer.aux_score(st)
        return score, (new_state, new_carries)

    def _full_remat_loss(self, params, state, x, y, generator=None,
                         fmask=None, lmask=None, train=True, carries=None):
        """`_loss_fn` behind one checkpoint boundary (remat="full"): only
        the step's inputs are kept, the whole forward is recomputed in the
        backward."""
        fn = lambda p, s: self._loss_fn(p, s, x, y, generator, fmask, lmask,
                                        train, carries)
        return checkpoint_call(fn, self.conf.conf.remat_policy, params,
                               state, generator=generator)

    def _layer_lr(self, layer, step):
        """Scheduled, per-layer learning rate (None = updater default)."""
        sched = self.conf.conf.lr_schedule
        base = layer.learning_rate
        if sched is None:
            return base
        lr = sched(step)
        if base is not None and sched.base_lr:
            lr = lr * (base / sched.base_lr)
        return lr

    def apply_layer_updates(self, layers, params, grads, opt_state, step,
                            scalars=None):
        """Per-layer gradient normalization, scheduled lr, updater and
        bias-lr rescale (frozen and parameter-free layers stay as they
        are). The step's scalars are computed on the host from `step`, or
        read from `scalars`, the step's row (`_step_scalars`; see
        `update_layer`). Returns (new params, new updater state) as
        lists."""
        new_params, new_opt, off = [], [], 0
        for layer, p, g, os in zip(layers, params, grads, opt_state):
            if not p or layer.frozen:
                new_params.append(p)
                new_opt.append(os)
                continue
            p, os, off = update_layer(self, layer, p, g, os, step, scalars,
                                      off)
            new_params.append(p)
            new_opt.append(os)
        return new_params, new_opt

    def _step_scalars(self, step) -> List[float]:
        """The host scalars of every trainable layer's update at `step`,
        in layer order: the row a replayed step reads."""
        out = []
        for layer, p in zip(self.layers, self.params):
            if p and not layer.frozen:
                out.extend(layer_scalars(self, layer, step))
        return out

    def apply_updates(self, params, grads, opt_state, step):
        """The UPDATE half on a full gradient tree (per-layer gradient
        normalization, scheduled lr, bias-lr rescale): the counterpart of
        `grad_step_fn` for callers that schedule the gradient themselves
        (the accumulated mean). Returns (params, updater state) as
        tuples."""
        new_params, new_opt = self.apply_layer_updates(
            self.layers, params, grads, opt_state, step,
            scalar_row(self, step))
        return tuple(new_params), tuple(new_opt)

    @property
    def grad_step_fn(self):
        """The GRADIENT half of the train step, `(params, state, x, y,
        fmask, lmask) -> (score, new_state, grads)`, with the loss
        selection (remat="full") and the minimize sign folded in; the
        dropout draws come from the network's generator."""
        def grad_step(params, state, x, y, fmask, lmask):
            return self._grad_fn(params, state, (x, y, fmask, lmask))[:3]
        return grad_step

    def _grad_fn(self, params, state, batch, carries=None):
        """(score, new_state, grads, new_carries) of one batch (or TBPTT
        chunk) `(x, y, fmask, lmask)`; everything returned is detached."""
        x, y, fmask, lmask = batch
        params = tuple(
            tree_map(lambda v, f=layer.frozen: v.detach().requires_grad_(
                not f), p) for layer, p in zip(self.layers, params))
        leaves = [v for p in params for v in flat_leaves(p)
                  if v.requires_grad]
        loss_fn = self._loss_fn
        if self.conf.conf.remat == "full":
            loss_fn = self._full_remat_loss
        with torch.enable_grad():
            score, (new_state, new_carries) = loss_fn(
                params, state, x, y, self._train_generator(), fmask,
                lmask, train=True, carries=carries)
            found = torch.autograd.grad(score, leaves, allow_unused=True)
        by_leaf = {id(v): d for v, d in zip(leaves, found)}
        sign = 1.0 if self.conf.conf.minimize else -1.0

        def grad_of(v):
            d = by_leaf.get(id(v))
            d = torch.zeros_like(v) if d is None else d
            return d if sign > 0 else -d
        grads = [tree_map(grad_of, p) for p in params]
        new_state = tuple(tree_map(torch.Tensor.detach, s)
                          for s in new_state)
        new_carries = None if carries is None else tuple(
            None if c is None else tuple(t.detach() for t in c)
            for c in new_carries)
        return score.detach(), new_state, grads, new_carries

    def _update_fn(self, params, grads, opt_state, scalars):
        """The update with the step's scalar row (a replayed step's)."""
        detached = tuple(tree_map(torch.Tensor.detach, p) for p in params)
        new_params, new_opt = self.apply_layer_updates(
            self.layers, detached, grads, opt_state, None, scalars)
        return tuple(new_params), tuple(new_opt)

    def _eager_update(self, params, grads, opt_state, step):
        detached = tuple(tree_map(torch.Tensor.detach, p) for p in params)
        return self.apply_updates(detached, grads, opt_state, step)

    def _eager_step(self, params, state, opt_state, step, batch):
        """One optimizer step on a batch tree, out of place: (params,
        state, updater state, score)."""
        score, new_state, grads, _ = self._grad_fn(params, state, batch)
        new_params, new_opt = self._eager_update(params, grads, opt_state,
                                                 step)
        return new_params, new_state, new_opt, score

    def _train_step(self, x, y, fmask, lmask, carries=None):
        """One optimizer step on one batch (or TBPTT chunk); stores the new
        parameters, updater state and layer state (detached, so no step's
        graph outlives it). Returns (score, new carries), both detached."""
        score, new_state, grads, carries = self._grad_fn(
            self.params, self.state, (x, y, fmask, lmask), carries)
        self.params, self.updater_state = self._eager_update(
            self.params, grads, self.updater_state, self.iteration_count)
        self.state = new_state
        return score, carries

    # the protocol of nn/superstep.py's windows and captures
    _entry_name = "nn"

    def _carry_trees(self):
        return self.params, self.state, self.updater_state

    def _set_carry_trees(self, params, state, opt_state):
        self.params = tuple(params)
        self.state = tuple(state)
        self.updater_state = tuple(opt_state)

    def _dropout_generators(self):
        g = self._train_generator()
        return [] if g is None else [g]

    def _train_generator(self) -> Optional[torch.Generator]:
        """The dropout generator, on the network's device (None when no
        layer uses dropout)."""
        if not any(layer.dropout for layer in self.layers):
            return None
        if self._generator is None:
            self._generator = torch.Generator(device=self.device).manual_seed(
                self._dropout_seed)
        return self._generator

    @property
    def predict_fn(self):
        """The pure inference step `(params, state, x, fmask) -> out` that
        serving runs on its own parameter snapshot."""
        def predict(params, state, x, fmask):
            with torch.inference_mode():
                return self._forward(params, state, x, fmask=fmask)[0]
        return predict

    def _as_input(self, x) -> torch.Tensor:
        """`x` as a tensor on the network's device in the parameters' dtype
        (torch's matmul does not promote mixed float types as jnp does)."""
        return torch.as_tensor(x, dtype=getattr(torch, self.conf.conf.dtype),
                               device=self.device)

    def _check_input_width(self, x):
        """Named errors for inputs that do not match the configured
        InputType, instead of a raw matmul or convolution shape error."""
        it = self.conf.input_type
        if it is None:
            return
        if it.kind == "ff" and x.dim() >= 2 and x.shape[-1] != it.flat_size():
            raise ValueError(f"input width {x.shape[-1]} != configured "
                             f"InputType.feed_forward({it.flat_size()})")
        if it.kind == "rnn":
            if x.dim() == 3 and x.shape[-1] != it.size:
                raise ValueError(f"input feature size {x.shape[-1]} != "
                                 f"configured InputType.recurrent({it.size}, ...)")
            if x.dim() == 2:
                raise ValueError(
                    "recurrent network input must be 3-D [batch, time, "
                    f"features]; got 2-D {tuple(x.shape)} (use "
                    "rnn_time_step for single-step inference)")
        if it.kind == "cnn" and x.dim() == 4 and tuple(x.shape[1:]) != (
                it.height, it.width, it.channels):
            raise ValueError(
                f"input shape {tuple(x.shape[1:])} != configured "
                f"InputType.convolutional({it.height}, {it.width}, "
                f"{it.channels}) (NHWC)")
        if (it.kind in ("cnn_flat", "cnn1d") and x.dim() == 2
                and x.shape[-1] != it.flat_size()):
            raise ValueError(
                f"input width {x.shape[-1]} != configured "
                f"{it.kind} InputType flat size {it.flat_size()}")

    def _batch(self, ds: DataSet):
        """(features, labels, features mask, labels mask) of a DataSet as
        tensors on the network's device, in the parameters' dtype (the
        tensors the device prefetch staged, when it did)."""
        from ..datasets.pipeline import staged_tree
        staged = staged_tree(ds, self.device, self._dtype)
        if staged is not None:
            return staged
        return tuple(None if a is None else self._as_input(a)
                     for a in (ds.features, ds.labels, ds.features_mask,
                               ds.labels_mask))

    @property
    def _dtype(self) -> torch.dtype:
        return getattr(torch, self.conf.conf.dtype)

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------
    def fit(self, data, labels=None, epochs: int = 1, *, superstep=1,
            grad_accumulation: int = 1, prefetch: bool = False,
            pad_ragged: bool = False, time_buckets=None,
            checkpoint_dir: Optional[str] = None, checkpoint_every: int = 0,
            resume: bool = False, guard=None) -> "MultiLayerNetwork":
        """fit(DataSetIterator), fit(DataSet) or fit(features, labels):
        one optimizer step per batch, or per TBPTT chunk.

        `superstep=K` (iterator inputs) trains windows of K batches: on the
        card each window is K replays of one captured CUDA graph of the
        step, with the scores read once at its edge; on the CPU the same
        steps run eagerly. Bit-identical to K=1 either way. "auto" sizes
        the window from batch bytes and grows it with the measured
        dispatch share; "epoch" windows the whole epoch. Listeners, the
        guard and checkpoint / SIGTERM saves act at window edges. TBPTT
        and line-search configurations fall back to per-batch steps (a
        log line says so).

        `grad_accumulation=M` (iterator inputs) accumulates M consecutive
        microbatches into one optimizer step (float32 sums, one update on
        their mean: the effective batch is M·b at b's activation memory).
        It composes with `superstep` (windows of K·M microbatches);
        listeners, `iteration_count` and lr schedules count optimizer
        steps; an epoch tail shorter than M trains as one step
        renormalized over its microbatches; resume must use the same M.
        TBPTT and line-search configurations refuse M>1.

        Input pipeline (iterator inputs; `datasets/pipeline.py`):
          pad_ragged    — pad ragged final batches with weight-zero rows:
                          one batch signature (one capture) per fit.
          time_buckets  — also pad the time axis of sequence batches up
                          to these bucket lengths.
          prefetch      — stage each batch on the device on a background
                          thread, through pinned memory on a side stream,
                          one batch ahead.

        Fault tolerance (iterator inputs; `fault/`):
          checkpoint_dir   — directory of crash-safe checkpoints; a
                             SIGTERM during fit snapshots there first.
          checkpoint_every — save every N iterations (0 = at fit end and
                             on SIGTERM only).
          resume           — restore the newest verifiable checkpoint,
                             skip the trained prefix and train what remains
                             of `epochs`: the resumed run matches the
                             uninterrupted one.
          guard            — a `fault.TrainingGuard`: non-finite score
                             policy (warn / skip_batch / rollback / halt)
                             and retry of transient iterator errors."""
        from .superstep import validate_grad_accumulation
        accum_m = validate_grad_accumulation(grad_accumulation)
        if self.params is None:
            self.init()
        if labels is not None:
            data = DataSet(np.asarray(data), np.asarray(labels))
        if isinstance(data, DataSet):
            if checkpoint_dir is not None or resume:
                raise ValueError(
                    "checkpoint_dir/resume need an iterator fit (the "
                    "checkpoint records epoch/batch progress); wrap the "
                    "DataSet in a ListDataSetIterator")
            if accum_m != 1:
                raise ValueError(
                    f"grad_accumulation={accum_m} needs an iterator fit "
                    "(M consecutive microbatches form one optimizer "
                    "step); wrap the DataSet in a ListDataSetIterator or "
                    "split it with datasets.pipeline.split_microbatches")
            if superstep != 1:
                log.info("superstep=%r ignored for a single-DataSet fit "
                         "(one batch is one step); pass an iterator to "
                         "window batches", superstep)
            if guard is not None:
                guard.run_step(self, lambda: self._fit_batch(data))
            else:
                self._fit_batch(data)
            return self
        if not isinstance(data, DataSetIterator):
            raise TypeError(f"Cannot fit on {type(data)}")
        if self.conf.pretrain and not self._pretrained:
            self.pretrain(data)
            self._pretrained = True
        if not self.conf.backprop:
            if (checkpoint_dir is not None or resume or checkpoint_every
                    or guard is not None or accum_m != 1):
                raise ValueError(
                    "checkpoint_dir/checkpoint_every/resume/guard/"
                    "grad_accumulation need a backprop fit — this "
                    "configuration has backprop=False, so none of them "
                    "would take effect")
            return self
        from .fitloop import fit_iterator
        return fit_iterator(
            self, data, epochs, superstep=superstep, accum_m=accum_m,
            prefetch=prefetch, pad_ragged=pad_ragged,
            time_buckets=time_buckets, checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every, resume=resume, guard=guard,
            context={"grad_accumulation": accum_m,
                     **self._precision_remat_context()},
            epoch_listeners=True)

    def _precision_remat_context(self):
        """FitCheckpointer context entries for the policies that shape the
        step's math or memory: resume warns when the restored run's values
        differ (compute_dtype changes the math; remat / remat_policy only
        the memory profile)."""
        c = self.conf.conf
        return {"compute_dtype": c.compute_dtype, "remat": c.remat,
                "remat_policy": c.remat_policy}

    def _make_superstep_runner(self, superstep, guard, ckpt, accum_m=1):
        """SuperstepRunner for this fit, or None for the per-batch loop
        (superstep=1 with grad_accumulation=1, line-search optimizers,
        TBPTT). grad_accumulation>1 always needs the windowed loop; on
        configurations that can't window it raises instead of silently
        training with a different effective batch."""
        from .superstep import (SuperstepRunner, accum_skip_nonfinite,
                                validate_superstep)

        k = validate_superstep(superstep)
        if k == 1 and accum_m == 1:
            return None
        reason = None
        if self.conf.conf.optimization_algo != \
                OptimizationAlgorithm.STOCHASTIC_GRADIENT_DESCENT:
            reason = ("line-search optimizers (CG/LBFGS) are per-batch "
                      "sequential")
        elif self.conf.backprop_type == BackpropType.TRUNCATED_BPTT:
            reason = ("TBPTT chunks each batch on host; use fit_scan for "
                      "device-resident TBPTT epochs")
        if reason is not None:
            if accum_m != 1:
                raise ValueError(
                    f"grad_accumulation={accum_m} is not supported for "
                    f"this configuration: {reason}")
            log.info("superstep=%r falls back to per-batch dispatch: %s",
                     superstep, reason)
            return None
        adapter = _NetworkSuperstepAdapter(
            self, m=accum_m,
            skip_nonfinite=accum_skip_nonfinite(guard, accum_m))
        return SuperstepRunner(self, adapter, k, guard=guard, ckpt=ckpt,
                               grad_accumulation=accum_m)

    def _fit_batch(self, ds: DataSet):
        from ..telemetry.runtime import active, null_span
        tel = active()
        span = tel.span if tel is not None else null_span
        with span("host/batch_prep"):
            x, y, fmask, lmask = self._batch(ds)
            self._check_input_width(x)
        self.last_input = x
        if (self.conf.backprop_type == BackpropType.TRUNCATED_BPTT
                and x.dim() == 3):
            self._fit_tbptt(x, y, fmask, lmask)
            return
        self._track_signature((x, y, fmask, lmask))
        if self.conf.conf.optimization_algo != \
                OptimizationAlgorithm.STOCHASTIC_GRADIENT_DESCENT:
            with span("device/dispatch", kind="line_search"):
                score = self._line_search_step(x, y, fmask, lmask)
        else:
            with span("device/dispatch", kind="train_step"):
                score, _ = self._watched_train_step(x, y, fmask, lmask)
        if tel is not None and tel.sync_per_step and score.is_cuda:
            with span("device/sync"):
                torch.cuda.current_stream(score.device).synchronize()
        self._step_done(score, x)

    @property
    def _watched_train_step(self):
        """`_train_step` behind the active telemetry session's capture
        watcher (`<entry>/train_step`), bound to this model. The wrapper
        is kept on the class: one kept on the model would hold the model
        in a reference cycle."""
        from ..telemetry.compile_watch import watch_compiles
        cls = type(self)
        fn = cls.__dict__.get("_watched_step_fn")
        if fn is None:
            fn = watch_compiles(cls._train_step,
                                f"{self._entry_name}/train_step")
            cls._watched_step_fn = staticmethod(fn)
        return functools.partial(fn, self)

    def _track_signature(self, batch):
        """Count the distinct batch signatures the step has seen
        (`recompile_count`: each would capture the step anew on the
        card); a second one logs the pad_ragged hint, as JAX does."""
        sig = tuple(None if a is None else tuple(a.shape)
                    for a in flatten_tree(batch)[0])
        if sig not in self._batch_signatures:
            self._batch_signatures.add(sig)
            self.recompile_count += 1
            if self.recompile_count == 2:
                log.info(
                    "train step sees a second batch signature %s — ragged "
                    "final batches double the captures; use fit(..., "
                    "pad_ragged=True) (weight-zero padding, a learning "
                    "no-op) or ArrayDataSetIterator(drop_last=True)", sig)

    def _line_search_step(self, x, y, fmask, lmask):
        """One batch of the line-search optimizer (CG, L-BFGS or line
        gradient descent; the updater chain is not used)."""
        if self._line_solver is None:
            from ..optimize.solvers import LineSearchSolver
            self._line_solver = LineSearchSolver(
                self, self.conf.conf.optimization_algo,
                max_line_search_iterations=
                self.conf.conf.max_num_line_search_iterations)
        self.params, new_state, score = self._line_solver.fit_batch(
            self.params, self.state, x, y, self._train_generator(), fmask,
            lmask)
        self.state = tuple(tree_map(torch.Tensor.detach, s)
                           for s in new_state)
        return score

    def _step_done(self, score, x):
        self._score = score
        self.last_batch_size = int(x.shape[0])
        self.iteration_count += 1
        for listener in self.listeners:
            listener.iteration_done(self, self.iteration_count)

    def _fit_tbptt(self, x, y, fmask, lmask):
        """Truncated BPTT: chunks of `tbptt_fwd_length` steps (the last one
        ragged), one optimizer step each; the hidden state flows forward
        between chunks, gradients do not."""
        T = x.shape[1]
        L = self.conf.tbptt_fwd_length
        carries = self._zero_carries(int(x.shape[0]), x.dtype)
        cut = lambda a, sl: None if a is None else a[:, sl]
        for t0 in range(0, T, L):
            sl = slice(t0, min(t0 + L, T))
            chunk = (x[:, sl], y[:, sl], cut(fmask, sl), cut(lmask, sl))
            self._track_signature(chunk)
            score, carries = self._train_step(*chunk, carries)
            self._step_done(score, x)

    # ------------------------------------------------------------------
    # Device-resident epochs
    # ------------------------------------------------------------------
    def fit_scan(self, data, epochs: int = 1, *, pad_ragged: bool = False,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 0, resume: bool = False,
                 guard=None) -> "MultiLayerNetwork":
        """Device-resident epoch training: a thin alias for `fit(...,
        superstep="epoch")` (one window per epoch, bit-identical to the
        per-batch loop), except for the two cases JAX routes specially:
        TBPTT configurations go through `fit_scan_arrays` (hidden state
        flows between a series' chunks and resets at series boundaries; a
        ragged final chunk is padded under a zero label mask, the
        reference's doTruncatedBPTT semantics), and line-search optimizers
        through the per-batch `fit` loop. All batches must share shapes
        (pad_ragged=True, a uniform-batch iterator, or drop the tail)."""
        from ..datasets.iterators import ListDataSetIterator

        if self.params is None:
            self.init()
        if self.conf.conf.optimization_algo != \
                OptimizationAlgorithm.STOCHASTIC_GRADIENT_DESCENT:
            if isinstance(data, DataSet):
                data = ListDataSetIterator([data])
            elif not isinstance(data, DataSetIterator):
                data = ListDataSetIterator(list(data))
            return self.fit(data, epochs=epochs,
                            checkpoint_dir=checkpoint_dir,
                            checkpoint_every=checkpoint_every,
                            resume=resume, guard=guard)
        if isinstance(data, DataSet):
            batches = [data]
        elif isinstance(data, DataSetIterator):
            data.reset()
            batches = []
            while data.has_next():
                batches.append(data.next())
        else:
            batches = list(data)
        if not batches:
            return self
        if pad_ragged:
            from ..datasets.pipeline import pad_dataset
            target = max(b.num_examples() for b in batches)
            batches = [pad_dataset(b, target)[0] for b in batches]
        shapes = {tuple(np.shape(b.features)) for b in batches}
        if len(shapes) != 1:
            raise ValueError(
                f"fit_scan needs uniform batch shapes, got {sorted(shapes)}; "
                "pad the ragged tail (pad_ragged=True — weight-zero rows, "
                "a learning no-op), drop it (ArrayDataSetIterator("
                "drop_last=True)), or use fit()")
        tbptt = (self.conf.backprop_type == BackpropType.TRUNCATED_BPTT
                 and len(np.shape(batches[0].features)) >= 3)
        if not tbptt:
            return self.fit(ListDataSetIterator(batches), epochs=epochs,
                            superstep="epoch",
                            checkpoint_dir=checkpoint_dir,
                            checkpoint_every=checkpoint_every,
                            resume=resume, guard=guard)
        # the batches' arrays, or tensors already on a device, stacked
        stack = lambda arrays: torch.stack([self._as_input(a)
                                            for a in arrays])
        xs = stack([b.features for b in batches])
        ys = stack([b.labels for b in batches])

        def stack_masks(ms, name):
            have = [m is not None for m in ms]
            if not any(have):
                return None
            if not all(have):
                raise ValueError(
                    f"fit_scan needs {name} on every batch or on none "
                    f"(got a mix); mask the full dataset or use fit()")
            return stack(ms)

        fmask = stack_masks([b.features_mask for b in batches],
                            "features_mask")
        lmask = stack_masks([b.labels_mask for b in batches], "labels_mask")
        return self.fit_scan_arrays(xs, ys, fmask, lmask, epochs=epochs,
                                    checkpoint_dir=checkpoint_dir,
                                    checkpoint_every=checkpoint_every,
                                    resume=resume, guard=guard)

    def fit_scan_arrays(self, xs, ys, fmask=None, lmask=None,
                        epochs: int = 1, *,
                        checkpoint_dir: Optional[str] = None,
                        checkpoint_every: int = 0, resume: bool = False,
                        guard=None) -> "MultiLayerNetwork":
        """fit_scan on pre-stacked [S, batch, ...] arrays (numpy, or
        tensors already on the device to skip the copy). Each epoch is one
        window: on the card, replays of the captured step (for TBPTT, of
        the captured chunk step, its recurrent carries zeroed at each
        series' first chunk); on the CPU the same steps eagerly.

        Listener caveat: iteration_done is replayed AFTER the epoch with
        per-step scores, so every call sees the END-OF-EPOCH params —
        per-iteration param/update histograms are not faithful on this
        path (a warning fires for such listeners); use fit() for those."""
        from ..telemetry.runtime import active, null_span
        from .fitloop import scan_epochs

        if self.params is None:
            self.init()
        if self.conf.conf.optimization_algo != \
                OptimizationAlgorithm.STOCHASTIC_GRADIENT_DESCENT:
            raise ValueError(
                "fit_scan_arrays supports SGD-updater training only; "
                "line-search optimizers (CG/LBFGS) are per-batch sequential "
                "— use fit()")
        tel = active()
        span = tel.span if tel is not None else null_span
        with span("host/batch_prep"):
            xs_d, ys_d = self._as_input(xs), self._as_input(ys)
            fm_d = None if fmask is None else self._as_input(fmask)
            lm_d = None if lmask is None else self._as_input(lmask)
        tbptt = (self.conf.backprop_type == BackpropType.TRUNCATED_BPTT
                 and xs_d.dim() >= 4)
        firsts = None
        if tbptt:
            L = self.conf.tbptt_fwd_length
            T_time = xs_d.shape[2]
            pad = (-T_time) % L
            if pad:
                if lm_d is None:
                    lm_d = torch.ones(ys_d.shape[:3], dtype=xs_d.dtype,
                                      device=self.device)
                pad3 = lambda a: torch.nn.functional.pad(
                    a, [0, 0] * (a.dim() - 3) + [0, pad])
                xs_d, ys_d, lm_d = pad3(xs_d), pad3(ys_d), pad3(lm_d)
                if fm_d is not None:
                    fm_d = pad3(fm_d)
            nc = xs_d.shape[2] // L

            def chunked(a):
                # [S, B, nc*L, ...] -> [S*nc, B, L, ...]
                a = a.reshape((a.shape[0], a.shape[1], nc, L)
                              + tuple(a.shape[3:]))
                a = a.movedim(2, 1)
                return a.reshape((a.shape[0] * nc, a.shape[2], L)
                                 + tuple(a.shape[4:]))

            xs_d, ys_d = chunked(xs_d), chunked(ys_d)
            fm_d = chunked(fm_d) if fm_d is not None else None
            lm_d = chunked(lm_d) if lm_d is not None else None
            firsts = [i % nc == 0 for i in range(int(xs_d.shape[0]))]
        batches = [(xs_d[i], ys_d[i],
                    None if fm_d is None else fm_d[i],
                    None if lm_d is None else lm_d[i])
                   for i in range(int(xs_d.shape[0]))]
        return scan_epochs(self, batches, firsts, epochs,
                           checkpoint_dir=checkpoint_dir,
                           checkpoint_every=checkpoint_every, resume=resume,
                           guard=guard,
                           context=self._precision_remat_context())

    # ------------------------------------------------------------------
    # Layerwise pretraining
    # ------------------------------------------------------------------
    def pretrain(self, iterator: DataSetIterator, epochs: int = 1
                 ) -> "MultiLayerNetwork":
        """Greedy layerwise unsupervised pretraining of the AutoEncoder,
        RBM and VariationalAutoencoder layers, in layer order."""
        if self.params is None:
            self.init()
        for i, layer in enumerate(self.layers):
            if getattr(layer, "is_pretrainable", False):
                self.pretrain_layer(i, iterator, epochs)
        return self

    def pretrain_layer(self, i: int, iterator: DataSetIterator,
                       epochs: int = 1) -> "MultiLayerNetwork":
        """Pretrain layer i alone on the activations the layers below it
        give each batch (inference mode): its own score and gradients
        (`pretrain_value_and_grad`), gradient normalization, the scheduled
        lr and its updater, whose state carries over into the layer's
        updater state. A layer that does not pretrain is left as it is."""
        layer = self.layers[i]
        if not getattr(layer, "is_pretrainable", False):
            return self
        if self.params is None:
            self.init()
        upd = self._layer_updater(layer)
        opt_i = self.updater_state[i]
        step = 0
        for _ in range(epochs):
            iterator.reset()
            while iterator.has_next():
                x = self._as_input(iterator.next().features)
                with torch.no_grad():
                    h = x
                    if i > 0:
                        h = self._forward(self.params, self.state, h,
                                          upto=i)[0]
                    h, _ = self._preprocess(i, h, None)
                score, grads = layer.pretrain_value_and_grad(
                    self.params[i], h, self._noise_generator())
                grads = apply_gradient_normalization(
                    layer.gradient_normalization,
                    layer.gradient_normalization_threshold or 1.0, grads)
                updates, opt_i = upd.update(grads, opt_i, step,
                                            self._layer_lr(layer, step))
                params = list(self.params)
                params[i] = tree_map(lambda a, u: (a - u).detach(),
                                     params[i], updates)
                self.params = tuple(params)
                self._score = score.detach()
                step += 1
        opt = list(self.updater_state)
        opt[i] = opt_i
        self.updater_state = tuple(opt)
        return self

    def _noise_generator(self) -> torch.Generator:
        """The generator of the pretraining layers' corruption, Gibbs and
        reparameterization draws, on the network's device."""
        if self._pretrain_gen is None:
            self._pretrain_gen = torch.Generator(
                device=self.device).manual_seed(self._dropout_seed)
        return self._pretrain_gen

    def reconstruction_log_probability(self, x, num_samples: int = 5,
                                       seed: int = 0) -> np.ndarray:
        """Per-example importance-sampled reconstruction log-probability
        of a leading VariationalAutoencoder layer (the VAE anomaly-score
        quantity), its draws from a generator seeded with `seed`."""
        from .layers.generative import VariationalAutoencoder
        if self.params is None:
            self.init()
        layer0 = self.layers[0]
        if not isinstance(layer0, VariationalAutoencoder):
            raise ValueError("reconstruction_log_probability requires the "
                             "first layer to be a VariationalAutoencoder "
                             f"(got {type(layer0).__name__})")
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        with torch.no_grad():
            lp = layer0.reconstruction_probability(
                self.params[0], self._as_input(x), gen,
                num_samples=num_samples)
        return lp.cpu().numpy()

    def reconstruction_probability(self, x, num_samples: int = 5,
                                   seed: int = 0) -> np.ndarray:
        return np.exp(self.reconstruction_log_probability(
            x, num_samples=num_samples, seed=seed))

    def clone(self) -> "MultiLayerNetwork":
        """An independent copy: parameters, layer state and updater state
        deep-copied, the input types, counters and the generators' states
        carried over, so the clone and the original train apart and, given
        the same batches, alike."""
        m = MultiLayerNetwork(self.conf, device=self.device)
        if self.params is not None:
            copy = lambda d: tree_map(lambda v: v.detach().clone(), d)
            m.params = tuple(copy(p) for p in self.params)
            m.state = tuple(copy(s) for s in self.state)
            m.updater_state = tuple(copy(u) for u in self.updater_state)
            m._input_types = list(self._input_types or [])
        m._dropout_seed = self._dropout_seed
        m._pretrained = self._pretrained
        for name in ("_generator", "_pretrain_gen"):
            g = getattr(self, name)
            if g is not None:
                twin = torch.Generator(device=g.device)
                twin.set_state(g.get_state())
                setattr(m, name, twin)
        m.iteration_count = self.iteration_count
        m.epoch_count = self.epoch_count
        return m

    def set_listeners(self, *listeners):
        self.listeners = list(listeners)
        return self

    def add_listeners(self, *listeners):
        self.listeners.extend(listeners)
        return self

    # ------------------------------------------------------------------
    # Inference and scoring
    # ------------------------------------------------------------------
    def output(self, x, features_mask=None) -> torch.Tensor:
        """Network output for `x` (numpy or tensor), on the network's
        device."""
        if self.params is None:
            self.init()
        x = self._as_input(x)
        self._check_input_width(x)
        fm = None if features_mask is None else self._as_input(features_mask)
        return self.predict_fn(self.params, self.state, x, fm)

    def feed_forward(self, x) -> List[torch.Tensor]:
        """Every layer's activations, input first (in the master dtype, as
        JAX's `feed_forward`)."""
        x = self._as_input(x)
        acts = [x]
        with torch.inference_mode():
            for i, layer in enumerate(self.layers):
                x, _ = self._preprocess(i, x, None)
                x, _ = layer.apply(self.params[i], self.state[i], x)
                acts.append(x)
        return acts

    def predict(self, x) -> np.ndarray:
        """Argmax class predictions."""
        return self.output(x).argmax(dim=-1).cpu().numpy()

    def score(self, dataset: Optional[DataSet] = None) -> float:
        """The last training step's score, or the score of `dataset`."""
        if dataset is None:
            return float(self._score)
        x, y, fm, lm = self._batch(dataset)
        with torch.no_grad():
            s, _ = self._loss_fn(self.params, self.state, x, y, None,
                                 fmask=fm, lmask=lm, train=False)
        return float(s)

    def evaluate(self, iterator: DataSetIterator,
                 labels_list: Optional[Sequence[str]] = None,
                 top_n: int = 1) -> Evaluation:
        ev = Evaluation(labels=labels_list, top_n=top_n)
        iterator.reset()
        while iterator.has_next():
            ds = iterator.next()
            out = self.output(ds.features, features_mask=ds.features_mask)
            ev.eval(ds.labels, out.cpu().numpy(), mask=ds.labels_mask)
        return ev

    def score_examples(self, data, add_regularization_terms: bool = True
                       ) -> np.ndarray:
        """Per-example scores, not averaged over the batch (time series
        summed over time); with `add_regularization_terms` the network's
        l1/l2 is added to each, so row i is `score` of example i alone.
        Takes a DataSet or a DataSetIterator (scores concatenated)."""
        if self.params is None:
            self.init()
        if isinstance(data, DataSetIterator):
            data.reset()
            outs = []
            while data.has_next():
                outs.append(self.score_examples(data.next(),
                                                add_regularization_terms))
            return (np.concatenate(outs) if outs
                    else np.zeros(0, np.float32))
        if not isinstance(data, DataSet):
            raise TypeError(f"score_examples needs DataSet/iterator, got "
                            f"{type(data)}")
        x, y, fm, lm = self._batch(data)
        n = len(self.layers)
        with torch.no_grad():
            h, _, mask, _ = self._forward(self.params, self.state, x,
                                          fmask=fm, upto=n - 1)
            h, mask = self._preprocess(n - 1, h, mask)
            per = self.layers[-1].loss_per_example(
                self.params[-1], self.state[-1], h, y,
                mask=lm if lm is not None else mask)
            if add_regularization_terms:
                per = per + self._reg_score(self.params)
        return per.cpu().numpy()

    # ------------------------------------------------------------------
    # Parameter plumbing
    # ------------------------------------------------------------------
    @property
    def num_layers(self) -> int:
        return len(self.layers)

    def get_layer(self, i: int):
        return self.layers[i]

    def num_params(self) -> int:
        return sum(int(leaf.numel()) for p in self.params
                   for leaf in flat_leaves(p))

    def params_flat(self) -> np.ndarray:
        """Every parameter in one flat array (layer order, sorted key paths;
        a BiLSTM's nested tree included)."""
        parts = [leaf.detach().cpu().numpy().ravel()
                 for p in self.params for leaf in flat_leaves(p)]
        return np.concatenate(parts) if parts else np.zeros(0, np.float32)

    def set_params_flat(self, vec: np.ndarray):
        """Inverse of `params_flat`."""
        vec = np.asarray(vec)
        to_leaf = lambda chunk, leaf: torch.tensor(
            chunk.reshape(tuple(leaf.shape)), dtype=leaf.dtype,
            device=leaf.device)
        pos, params = 0, []
        for p in self.params:
            d, pos = unflatten_like(p, vec, pos, to_leaf)
            params.append(d)
        self.params = tuple(params)

    # ------------------------------------------------------------------
    # Stateful RNN inference
    # ------------------------------------------------------------------
    def _zero_carries(self, batch: int, dtype):
        return tuple(
            layer.init_carry(batch, dtype, self.device)
            if getattr(layer, "is_recurrent", False) else None
            for layer in self.layers)

    def rnn_time_step(self, x) -> torch.Tensor:
        """Feed one step [B, F] (or a few, [B, T, F]), carrying hidden state
        across calls."""
        if self.params is None:
            self.init()
        x = self._as_input(x)
        squeeze = x.dim() == 2
        if squeeze:
            x = x[:, None, :]
        if self._rnn_carries is None:
            self._rnn_carries = self._zero_carries(int(x.shape[0]), x.dtype)
        with torch.inference_mode():
            out, _, _, self._rnn_carries = self._forward(
                self.params, self.state, x, carries=self._rnn_carries)
        return out[:, 0] if (squeeze and out.dim() == 3) else out

    def rnn_clear_previous_state(self):
        self._rnn_carries = None

    def rnn_get_previous_state(self, layer_idx: int):
        c = self._rnn_carries
        return None if c is None else c[layer_idx]


class _NetworkSuperstepAdapter:
    """SuperstepRunner hooks for MultiLayerNetwork (see nn/superstep.py):
    array-shaped batches, masks optional. With `m>1` the window trains in
    groups of m microbatches."""

    def __init__(self, net: MultiLayerNetwork, m: int = 1,
                 skip_nonfinite: bool = False):
        self.net = net
        self.m = int(m)
        self.skip_nonfinite = bool(skip_nonfinite)

    @staticmethod
    def _shape(a):
        return None if a is None else tuple(np.shape(a))

    def signature(self, ds):
        self.net._check_input_width(_ShapeOnly(np.shape(ds.features)))
        return (self._shape(ds.features), self._shape(ds.labels),
                self._shape(ds.features_mask), self._shape(ds.labels_mask))

    def batch_nbytes(self, ds):
        from ..datasets.pipeline import batch_nbytes
        return batch_nbytes((ds.features, ds.labels, ds.features_mask,
                             ds.labels_mask))

    def stage(self, window):
        from ..datasets.pipeline import stage_window
        return stage_window(window, self.net.device, self.net._dtype)

    def dispatch(self, staged, n, step0):
        from .superstep import run_window
        return run_window(self.net, staged, step0, self.m,
                          self.skip_nonfinite)

    def on_window_end(self, window):
        net = self.net
        last = window[-1]
        net.last_input = last.features
        net.last_batch_size = int(np.shape(last.features)[0])
        net._track_signature((last.features, last.labels,
                              last.features_mask, last.labels_mask))


class _ShapeOnly:
    """A stand-in with the shape of a batch's features, for the input-width
    check of a batch that is not on the device yet."""

    def __init__(self, shape):
        self.shape = tuple(shape)

    def dim(self):
        return len(self.shape)
