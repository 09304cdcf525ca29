"""Convolutional activation visualization (reference
`module/convolutional/ConvolutionalListenerModule.java` + its listener —
renders grids of first-conv-layer activation maps in the UI).

`ConvolutionalIterationListener` samples the network's first 4-D activation
every N iterations, tiles the channels of a few examples into one grayscale
grid, and stores it as a base64 PNG in the stats stream; `activation_grid`
is the reusable tiler (also handy for notebook display).

The port of `deeplearning4j_tpu/ui/convolutional.py`. The port's conv
activations are NHWC, JAX's layout, and live on the model's device: the
listener copies the one activation it renders to the host. Without PIL it
records nothing, as JAX's does."""
from __future__ import annotations

import base64
import io
import time
from typing import Optional

import numpy as np

from ..optimize.listeners import IterationListener
from ..util.host import host_array
from .storage import StatsStorage

__all__ = ["ConvolutionalIterationListener", "activation_grid"]


def activation_grid(acts: np.ndarray, max_channels: int = 16,
                    pad: int = 1) -> np.ndarray:
    """Tile one example's [H, W, C] activation maps (an array, or a tensor
    on any device) into a single grayscale u8 image grid (channels
    left-to-right, wrapped)."""
    acts = host_array(acts, np.float32)
    if acts.ndim != 3:
        raise ValueError(f"need [H, W, C] activations, got {acts.shape}")
    h, w, c = acts.shape
    c = min(c, max_channels)
    cols = int(np.ceil(np.sqrt(c)))
    rows = int(np.ceil(c / cols))
    grid = np.zeros((rows * (h + pad) - pad, cols * (w + pad) - pad),
                    np.float32)
    for i in range(c):
        a = acts[:, :, i]
        lo, hi = float(a.min()), float(a.max())
        a = (a - lo) / (hi - lo) if hi > lo else np.zeros_like(a)
        r, col = divmod(i, cols)
        grid[r * (h + pad):r * (h + pad) + h,
             col * (w + pad):col * (w + pad) + w] = a
    return (grid * 255).astype(np.uint8)


class ConvolutionalIterationListener(IterationListener):
    """Every `frequency` iterations: run the stored last batch forward,
    take the FIRST 4-D (conv) activation, tile `n_examples` grids, PNG-
    encode, and put a report on the stats stream (type 'activations')."""

    def __init__(self, storage: StatsStorage, frequency: int = 10,
                 n_examples: int = 2, max_channels: int = 16,
                 session_id: Optional[str] = None):
        self.storage = storage
        self.frequency = max(1, int(frequency))
        self.n_examples = int(n_examples)
        self.max_channels = int(max_channels)
        self.session_id = session_id or f"conv-{int(time.time())}"

    def _first_conv_activation(self, model, x) -> Optional[np.ndarray]:
        # feed_forward's first element is the INPUT itself (which is
        # already 4-D for CNN data) — skip it, we want layer activations
        for act in model.feed_forward(x)[1:]:
            if act.dim() == 4:       # [B, H, W, C]
                return host_array(act)
        return None

    def iteration_done(self, model, iteration: int):
        if iteration % self.frequency != 0:
            return
        x = getattr(model, "last_input", None)
        if x is None:
            return
        try:
            from PIL import Image
        except ImportError:
            return
        n = min(self.n_examples, int(x.shape[0]))
        acts = self._first_conv_activation(model, x[:n])
        if acts is None:
            return
        images = []
        for i in range(n):
            grid = activation_grid(acts[i], self.max_channels)
            buf = io.BytesIO()
            Image.fromarray(grid, mode="L").save(buf, format="PNG")
            images.append(base64.b64encode(buf.getvalue()).decode())
        self.storage.put_update(
            self.session_id, "activations", "worker-0", time.time(),
            {"iteration": iteration, "pngs_base64": images,
             "shape": list(acts.shape)})
