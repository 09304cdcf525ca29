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
from .trees import flat_leaves, tree_map, unflatten_like
from ..datasets.iterators import DataSet, DataSetIterator
from ..eval.evaluation import Evaluation
from ..util.platform import DeviceLike, resolve_device, strict_fp32

__all__ = ["MultiLayerNetwork"]


def _rescale_bias_updates(updates, scale):
    """Scale the bias entries (`b`, or a key containing "bias") of a
    layer's (possibly nested) updates: a BiLSTM rescales the biases of both
    directions."""
    if not isinstance(updates, dict):
        return updates
    return {k: (v * scale if not isinstance(v, dict)
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


#: the keyword options of JAX's `fit` that wait for ROADMAP A8, with their
#: defaults (the only values the port takes so far)
FIT_OPTION_DEFAULTS = {"superstep": 1, "grad_accumulation": 1,
                       "prefetch": False, "pad_ragged": False,
                       "time_buckets": None, "checkpoint_dir": None,
                       "checkpoint_every": 0, "resume": False, "guard": None}


def refuse_fit_options(options: dict):
    """Raise the A8 refusal for any `fit` option given a non-default
    value."""
    for name, value in options.items():
        if value != FIT_OPTION_DEFAULTS[name]:
            raise _not_in_port(f"fit({name}={value!r})", "8")


class MultiLayerNetwork:
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

    def apply_layer_updates(self, layers, params, grads, opt_state, step):
        """Per-layer gradient normalization, scheduled lr, updater and
        bias-lr rescale (frozen and parameter-free layers stay as they
        are). Returns (new params, new updater state) as lists."""
        new_params, new_opt = [], []
        for layer, p, g, os in zip(layers, params, grads, opt_state):
            if not p or layer.frozen:
                new_params.append(p)
                new_opt.append(os)
                continue
            g = apply_gradient_normalization(
                layer.gradient_normalization,
                layer.gradient_normalization_threshold or 1.0, g)
            upd = self._layer_updater(layer)
            lr = self._layer_lr(layer, step)
            updates, os = upd.update(g, os, step, lr)
            if layer.bias_learning_rate is not None:
                # updater steps are linear in lr, so rescaling the bias
                # updates by bias_lr / lr is exact (float32, as in JAX)
                if lr is None:
                    eff = getattr(upd, "learning_rate", 1.0) or 1.0
                    scale = layer.bias_learning_rate / eff
                else:
                    scale = float(layer.bias_learning_rate / torch.clamp(
                        torch.as_tensor(lr, dtype=torch.float32),
                        min=1e-30))
                updates = _rescale_bias_updates(updates, scale)
            new_params.append(tree_map(lambda a, u: a - u, p, updates))
            new_opt.append(os)
        return new_params, new_opt

    def _train_step(self, x, y, fmask, lmask, carries=None):
        """One optimizer step on one batch (or TBPTT chunk); stores the new
        parameters, updater state and layer state (detached, so no step's
        graph outlives it). Returns (score, new carries), both detached."""
        params = tuple(
            tree_map(lambda v, f=layer.frozen: v.detach().requires_grad_(
                not f), p) for layer, p in zip(self.layers, self.params))
        leaves = [v for p in params for v in flat_leaves(p)
                  if v.requires_grad]
        loss_fn = self._loss_fn
        if self.conf.conf.remat == "full":
            loss_fn = self._full_remat_loss
        with torch.enable_grad():
            score, (new_state, new_carries) = loss_fn(
                params, self.state, x, y, self._train_generator(), fmask,
                lmask, train=True, carries=carries)
            found = torch.autograd.grad(score, leaves, allow_unused=True)
        by_leaf = {id(v): d for v, d in zip(leaves, found)}
        sign = 1.0 if self.conf.conf.minimize else -1.0

        def grad_of(v):
            d = by_leaf.get(id(v))
            d = torch.zeros_like(v) if d is None else d
            return d if sign > 0 else -d
        grads = [tree_map(grad_of, p) for p in params]
        detached = tuple(tree_map(torch.Tensor.detach, p) for p in params)
        new_params, new_opt = self.apply_layer_updates(
            self.layers, detached, grads, self.updater_state,
            self.iteration_count)
        self.params, self.updater_state = tuple(new_params), tuple(new_opt)
        self.state = tuple(tree_map(torch.Tensor.detach, s)
                           for s in new_state)
        carries = None if carries is None else tuple(
            None if c is None else tuple(t.detach() for t in c)
            for c in new_carries)
        return score.detach(), carries

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
        tensors on the network's device, in the parameters' dtype."""
        return tuple(None if a is None else self._as_input(a)
                     for a in (ds.features, ds.labels, ds.features_mask,
                               ds.labels_mask))

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------
    def fit(self, data, labels=None, epochs: int = 1, *, superstep=1,
            grad_accumulation: int = 1, prefetch: bool = False,
            pad_ragged: bool = False, time_buckets=None,
            checkpoint_dir: Optional[str] = None, checkpoint_every: int = 0,
            resume: bool = False, guard=None) -> "MultiLayerNetwork":
        """fit(DataSetIterator), fit(DataSet) or fit(features, labels):
        one optimizer step per batch, or per TBPTT chunk. The keyword
        options after `epochs` are the JAX package's; only their defaults
        are in the port so far, and any other value raises."""
        refuse_fit_options(dict(
            superstep=superstep, grad_accumulation=grad_accumulation,
            prefetch=prefetch, pad_ragged=pad_ragged,
            time_buckets=time_buckets, checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every, resume=resume, guard=guard))
        if self.params is None:
            self.init()
        if labels is not None:
            data = DataSet(np.asarray(data), np.asarray(labels))
        if isinstance(data, DataSet):
            self._fit_batch(data)
            return self
        if not isinstance(data, DataSetIterator):
            raise TypeError(f"Cannot fit on {type(data)}")
        if self.conf.pretrain and not self._pretrained:
            self.pretrain(data)
            self._pretrained = True
        if not self.conf.backprop:
            return self
        for _ in range(epochs):
            for listener in self.listeners:
                if hasattr(listener, "on_epoch_start"):
                    listener.on_epoch_start(self)
            data.reset()
            while data.has_next():
                self._fit_batch(data.next())
            for listener in self.listeners:
                if hasattr(listener, "on_epoch_end"):
                    listener.on_epoch_end(self)
            self.epoch_count += 1
        return self

    def _fit_batch(self, ds: DataSet):
        x, y, fmask, lmask = self._batch(ds)
        self._check_input_width(x)
        self.last_input = x
        if (self.conf.backprop_type == BackpropType.TRUNCATED_BPTT
                and x.dim() == 3):
            self._fit_tbptt(x, y, fmask, lmask)
            return
        if self.conf.conf.optimization_algo != \
                OptimizationAlgorithm.STOCHASTIC_GRADIENT_DESCENT:
            score = self._line_search_step(x, y, fmask, lmask)
        else:
            score, _ = self._train_step(x, y, fmask, lmask)
        self._step_done(score, x)

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
            score, carries = self._train_step(
                x[:, sl], y[:, sl], cut(fmask, sl), cut(lmask, sl), carries)
            self._step_done(score, x)

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
