"""BatchNormalization and LocalResponseNormalization (the forward of
`deeplearning4j_tpu/nn/layers/normalization.py`; the same dataclass fields
and `__layer__` names, so the configuration JSON is identical both ways).

The layer picks an implementation at apply time by JAX's rule
(`_helper`), whose tier names it keeps:

  1. "pallas": the BN+ReLU kernels (`kernels/bn_relu.py`, hand-written CUDA
     on the card) for training-mode [N, C] bf16 / f16 batches with a ReLU
     and learned gamma / beta, where the TPU kernel's budget admits N;
  2. "fused": the one-pass formulation (`kernels/batchnorm.py`) for the
     other sub-f32 training batches (identity activation, NHWC input,
     larger N);
  3. None: the plain two-pass math (numerically exact, Sterbenz-safe), the
     path of every float32 / float64 input and of inference.

Running mean and var live in the layer state (`init_state`), updated with
`decay` from the batch statistics, detached.

LocalResponseNormalization is cross-channel, JAX's `x / (k + alpha *
sum_window x^2)^beta` with no division by n: `F.local_response_norm` (which
divides alpha by n) on the NCHW view, given `alpha * n`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from ..conf.base import LayerConf, register_layer
from ..conf.input_type import InputType

__all__ = ["BatchNormalization", "LocalResponseNormalization"]


@register_layer
@dataclass
class BatchNormalization(LayerConf):
    """Works on FF [B, F] (normalises over the batch) and CNN NHWC
    [B, H, W, C] (over batch and space, per channel)."""

    input_kind = "any"

    n_out: Optional[int] = None     # feature / channel count (inferred)
    decay: float = 0.9              # running-average momentum
    eps: float = 1e-5
    gamma_init: float = 1.0
    beta_init: float = 0.0
    lock_gamma_beta: bool = False   # fixed scale / shift, not trained

    def _nf(self, it: InputType) -> int:
        if self.n_out:
            return self.n_out
        return it.channels if it.kind == "cnn" else it.flat_size()

    def fill_from_input_type(self, it: InputType):
        return {"n_out": self._nf(it)} if not self.n_out else {}

    def output_type(self, it: InputType) -> InputType:
        return it

    @property
    def has_params(self) -> bool:
        return not self.lock_gamma_beta

    def init_params(self, gen, it: InputType, device):
        if self.lock_gamma_beta:
            return {}
        nf = self._nf(it)
        return {"gamma": torch.full((nf,), self.gamma_init,
                                    dtype=torch.float32, device=device),
                "beta": torch.full((nf,), self.beta_init,
                                   dtype=torch.float32, device=device)}

    def init_state(self, it: InputType, device):
        nf = self._nf(it)
        return {"mean": torch.zeros(nf, dtype=torch.float32, device=device),
                "var": torch.ones(nf, dtype=torch.float32, device=device)}

    def _helper(self, x, train, ranks: int = 1) -> Optional[str]:
        """JAX's selection: 'pallas' | 'fused' | None (plain path). x holds
        this rank's rows of a global batch spread evenly over `ranks`
        ranks; the tier is chosen on the global row count, as JAX's GSPMD
        step sees the global batch."""
        act = self.activation or "identity"
        if not train or act not in ("identity", "relu"):
            return None
        if x.element_size() >= 4:
            return None  # f32 / f64: the exact two-pass path (gradchecks)
        if x.dim() == 2 and act == "relu" and not self.lock_gamma_beta:
            from ...kernels.bn_relu import _block_c
            if _block_c(x.shape[1], x.shape[0] * ranks) is not None:
                return "pallas"
        return "fused"

    def _gamma_beta(self, params, nf, dtype, device):
        if self.lock_gamma_beta:
            return (torch.full((nf,), self.gamma_init, dtype=dtype,
                               device=device),
                    torch.full((nf,), self.beta_init, dtype=dtype,
                               device=device))
        return params["gamma"].to(dtype), params["beta"].to(dtype)

    def _running(self, state, mean, var):
        d = self.decay
        return {"mean": d * state["mean"] + (1 - d) * mean.detach(),
                "var": d * state["var"] + (1 - d) * var.detach()}

    def apply(self, params, state, x, *, train=False, generator=None,
              mask=None):
        bg = None
        if train:
            from ...parallel.collectives import active_batch_group
            bg = active_batch_group()
        helper = self._helper(x, train, 1 if bg is None else bg.n)
        if bg is not None:
            return self._apply_global(params, state, x, helper, bg)
        if helper is None:
            return self._apply_plain(params, state, x, train=train)
        gamma, beta = self._gamma_beta(params, x.shape[-1], torch.float32,
                                       x.device)
        if helper == "pallas":
            from ...kernels.bn_relu import fused_bn_relu
            y, mean, var = fused_bn_relu(x, gamma, beta, eps=self.eps)
        else:
            from ...kernels.batchnorm import fused_bn_act
            sdt = self.activation_store_dtype
            if (sdt is None or getattr(torch, sdt).itemsize
                    >= x.element_size()):
                sdt = ""     # exact storage (the compute dtype)
            y, mean, var = fused_bn_act(x, gamma, beta, float(self.eps),
                                        self.activation or "identity",
                                        str(sdt))
        return y, self._running(state, mean, var)   # activation applied

    def _apply_global(self, params, state, x, helper, bg):
        """Training over a batch spread across the ranks of `bg`: the
        statistics of the global batch, as JAX's GSPMD step takes them.
        The kernel tier takes the split kernels (`kernels/bn_split.py`);
        the others their plain versions, with the same merge."""
        from ...kernels.bn_split import split_bn_relu
        gamma, beta = self._gamma_beta(params, x.shape[-1], torch.float32,
                                       x.device)
        act = self.activation or "identity"
        y, mean, var = split_bn_relu(x, gamma, beta, float(self.eps), bg,
                                     relu=act == "relu",
                                     kernel=helper == "pallas")
        if act not in ("identity", "relu"):
            y = self._act(y)
        return y, self._running(state, mean, var)

    def _apply_plain(self, params, state, x, *, train=False):
        dims = tuple(range(x.dim() - 1))    # all but the feature axis
        # statistics in >= f32 (f64 inputs keep f64 for gradient checks)
        cdt = torch.promote_types(x.dtype, torch.float32)
        xc = x.to(cdt)
        if train:
            # two passes, NOT E[x^2] - E[x]^2 (which cancels for channels
            # with a large mean)
            mean = xc.mean(dim=dims)
            var = torch.square(xc - mean).mean(dim=dims)
            new_state = self._running(state, mean, var)
        else:
            mean, var = state["mean"].to(cdt), state["var"].to(cdt)
            new_state = state
        inv = torch.rsqrt(var + self.eps)
        gamma, beta = self._gamma_beta(params, x.shape[-1], cdt, x.device)
        if x.element_size() < 4:
            # bf16 / f16: folded to y = x * scale + shift (x's own mantissa
            # bounds the precision, so folding loses nothing)
            scale = gamma * inv
            y = (xc * scale + (beta - mean * scale)).to(x.dtype)
        else:
            # f32 / f64: (x - mean) kept explicit, exact for large-mean
            # channels (Sterbenz) where the folded form loses digits
            y = ((xc - mean) * (inv * gamma) + beta).to(x.dtype)
        return self._act(y), new_state


@register_layer
@dataclass
class LocalResponseNormalization(LayerConf):
    """Cross-channel LRN: y = x / (k + alpha * sum_{n nearby channels}
    x^2)^beta, NHWC. Defaults as the reference's (k=2, n=5, alpha=1e-4,
    beta=0.75)."""

    input_kind = "cnn"

    k: float = 2.0
    n: int = 5
    alpha: float = 1e-4
    beta: float = 0.75

    def output_type(self, it: InputType) -> InputType:
        return it

    def apply(self, params, state, x, *, train=False, generator=None,
              mask=None):
        if self.n % 2 == 0:
            # JAX's window (n // 2 each side) gives C + 1 sums for an even
            # n, which then fail to broadcast against x
            raise ValueError(
                f"LocalResponseNormalization needs an odd window n, got "
                f"n={self.n}")
        xc = x.permute(0, x.dim() - 1, *range(1, x.dim() - 1))
        y = F.local_response_norm(xc, self.n, alpha=self.alpha * self.n,
                                  beta=self.beta, k=self.k)
        return y.permute(0, *range(2, y.dim()), 1), state
