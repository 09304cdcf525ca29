"""MultiLayerNetwork — the sequential model, inference surface of
`deeplearning4j_tpu/nn/multilayer.py`.

Parameters are a tuple with one dict of tensors per layer (keys as in JAX:
`W`, `b`, `peep`), held on the network's device. `predict_fn` is the pure
`(params, state, x, fmask) -> out` forward that serving calls;
`rnn_time_step` threads one (h, c) carry per recurrent layer across calls.
`fit`, `score` and the updaters arrive with the training slice.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .conf import MultiLayerConfiguration
from .conf.input_type import InputType
from ..util.platform import DeviceLike, resolve_device, strict_fp32

__all__ = ["MultiLayerNetwork"]


class MultiLayerNetwork:
    def __init__(self, conf: MultiLayerConfiguration,
                 device: DeviceLike = None):
        c = conf.conf
        if c.compute_dtype is not None and c.compute_dtype != c.dtype:
            raise NotImplementedError(
                f"compute_dtype={c.compute_dtype!r} (mixed precision) is not "
                "in the PyTorch port yet")
        self.conf = conf
        self.layers = list(conf.layers)
        self.device = resolve_device(device)
        strict_fp32()
        self.params: Optional[Tuple[Dict[str, torch.Tensor], ...]] = None
        self.state: Optional[Tuple[Dict, ...]] = None
        self.iteration_count = 0
        self.epoch_count = 0
        self._input_types: Optional[List[InputType]] = None
        self._rnn_carries = None

    # ------------------------------------------------------------------
    # Initialization and placement
    # ------------------------------------------------------------------
    def init(self, seed: Optional[int] = None,
             generator: Optional[torch.Generator] = None
             ) -> "MultiLayerNetwork":
        """Draw every layer's parameters from `generator` (a fresh CPU
        generator seeded with `seed`, or the config's seed, when None) and
        place them on the network's device."""
        from . import activations
        for layer in self.layers:
            if layer.activation is not None:    # fail fast on bad names
                activations.get(layer.activation)
        if generator is None:
            generator = torch.Generator().manual_seed(
                self.conf.conf.seed if seed is None else int(seed))
        it = self.conf.input_type
        self._input_types = []
        params, state = [], []
        for i, layer in enumerate(self.layers):
            if it is None:
                n_in = getattr(layer, "n_in", None)
                if layer.has_params and not n_in:
                    raise ValueError(
                        f"Layer {i} ({type(layer).__name__}) needs n_in or a "
                        "network input_type for shape inference")
                it = InputType.feed_forward(n_in or 0)
            self._input_types.append(it)
            params.append(layer.init_params(generator, it, self.device))
            state.append({})
            it = layer.output_type(it)
        self.params = tuple(params)
        self.state = tuple(state)
        return self

    def to(self, device: DeviceLike) -> "MultiLayerNetwork":
        """Move parameters (and any stateful-RNN carries) to `device`."""
        self.device = resolve_device(device)
        move = lambda d: {k: v.to(self.device) for k, v in d.items()}
        if self.params is not None:
            self.params = tuple(move(p) for p in self.params)
            self.state = tuple(move(s) for s in self.state)
        if self._rnn_carries is not None:
            self._rnn_carries = tuple(
                None if c is None else tuple(t.to(self.device) for t in c)
                for c in self._rnn_carries)
        return self

    # ------------------------------------------------------------------
    # Forward
    # ------------------------------------------------------------------
    def _forward(self, params, state, x, fmask=None, carries=None):
        """Returns (activations, mask, new_carries). `carries` (one entry
        per layer, None for non-recurrent layers) threads RNN state across
        rnn_time_step calls."""
        new_carries = (list(carries) if carries is not None
                       else [None] * len(self.layers))
        mask = fmask
        for i, layer in enumerate(self.layers):
            if carries is not None and getattr(layer, "is_recurrent", False):
                (x, new_carries[i]), _ = layer.apply(
                    params[i], state[i], x, mask=mask, carry=carries[i],
                    return_carry=True)
            else:
                x, _ = layer.apply(params[i], state[i], x, mask=mask)
            mask = layer.output_mask(mask)
        return x, mask, tuple(new_carries)

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
        InputType, instead of a raw matmul shape error."""
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
        """Every layer's activations, input first."""
        x = self._as_input(x)
        acts = [x]
        with torch.inference_mode():
            for i, layer in enumerate(self.layers):
                x, _ = layer.apply(self.params[i], self.state[i], x)
                acts.append(x)
        return acts

    def predict(self, x) -> np.ndarray:
        """Argmax class predictions."""
        return self.output(x).argmax(dim=-1).cpu().numpy()

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
            out, _, self._rnn_carries = self._forward(
                self.params, self.state, x, carries=self._rnn_carries)
        return out[:, 0] if (squeeze and out.dim() == 3) else out

    def rnn_clear_previous_state(self):
        self._rnn_carries = None

    def rnn_get_previous_state(self, layer_idx: int):
        c = self._rnn_carries
        return None if c is None else c[layer_idx]
