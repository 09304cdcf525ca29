"""Loss functions, by name: the port of `deeplearning4j_tpu/nn/losses.py`.

Every loss is a function of (labels, logits, activation, weights) giving a
per-example score, reduced over the feature axis with optional per-class
weights; `Loss.score` takes the masked mean of it over the remaining axes
(examples, and time steps for a time series). Gradients come from autograd.

Numerically fused paths, as in JAX: `mcxent` (and `negativeloglikelihood`)
with softmax, and `xent` with sigmoid, are computed from the logits with a
log-softmax / log-sigmoid.
"""
from __future__ import annotations

import torch
import torch.nn.functional as Fn

__all__ = ["get", "LOSSES", "Loss"]

_EPS = 1e-7


def _apply_mask(per_example, mask):
    """per_example: [batch] or [batch, time], already reduced over
    features. The mask broadcasts over it; returns the masked mean (sum
    over live entries over their count, at least 1)."""
    if mask is None:
        return per_example.mean()
    mask = mask.to(per_example.dtype)
    mask = mask.reshape(mask.shape + (1,) * (per_example.dim() - mask.dim()))
    mask = mask.expand(per_example.shape)
    total = (per_example * mask).sum()
    return total / torch.clamp(mask.sum(), min=1.0)


class Loss:
    """A named loss. `score(labels, logits, activation, mask, weights)` is
    the scalar mean score; `per_example` the unreduced scores."""

    def __init__(self, name, fn, fused_with=None):
        self.name = name
        self._fn = fn
        # the activation this loss fuses with when computed from logits
        self.fused_with = fused_with

    def per_example(self, labels, logits, activation=None, weights=None):
        return self._fn(labels, logits, activation, weights)

    def score(self, labels, logits, activation=None, mask=None,
              weights=None):
        return _apply_mask(self.per_example(labels, logits, activation,
                                            weights), mask)

    def __repr__(self):
        return f"Loss({self.name})"


def _activate(logits, activation):
    from . import activations

    if activation is None:
        return logits
    return activations.get(activation)(logits)


def _wsum(per_elem, weights):
    """Reduce the feature axis with optional per-class weights."""
    if weights is not None:
        per_elem = per_elem * torch.as_tensor(weights, dtype=per_elem.dtype,
                                              device=per_elem.device)
    return per_elem.sum(dim=-1)


def _name(activation):
    return str(activation).lower() if activation is not None else None


def _mse(labels, logits, activation, weights):
    out = _activate(logits, activation)
    return _wsum((out - labels) ** 2, weights) / labels.shape[-1]


def _l2(labels, logits, activation, weights):
    out = _activate(logits, activation)
    return _wsum((out - labels) ** 2, weights)


def _mae(labels, logits, activation, weights):
    out = _activate(logits, activation)
    return _wsum((out - labels).abs(), weights) / labels.shape[-1]


def _l1(labels, logits, activation, weights):
    out = _activate(logits, activation)
    return _wsum((out - labels).abs(), weights)


def _mcxent(labels, logits, activation, weights):
    # multi-class cross entropy: from the logits with softmax, else the log
    # of the clipped outputs
    if _name(activation) in (None, "softmax"):
        logp = torch.log_softmax(logits, dim=-1)
    else:
        logp = torch.log(torch.clamp(_activate(logits, activation),
                                     _EPS, 1.0))
    return -_wsum(labels * logp, weights)


def _xent(labels, logits, activation, weights):
    # binary cross entropy per output unit, fused with sigmoid from logits
    if _name(activation) in (None, "sigmoid"):
        logp, lognotp = Fn.logsigmoid(logits), Fn.logsigmoid(-logits)
    else:
        out = torch.clamp(_activate(logits, activation), _EPS, 1.0 - _EPS)
        logp, lognotp = torch.log(out), torch.log1p(-out)
    return -_wsum(labels * logp + (1.0 - labels) * lognotp, weights)


def _nll(labels, logits, activation, weights):
    # NEGATIVELOGLIKELIHOOD is MCXENT (LossNegativeLogLikelihood extends
    # LossMCXENT in ND4J)
    return _mcxent(labels, logits, activation, weights)


def _signed(labels):
    # labels in {-1, +1}; {0, 1} labels are accepted too
    return torch.where(labels <= 0, -1.0, 1.0).to(labels.dtype)


def _hinge(labels, logits, activation, weights):
    out = _activate(logits, activation)
    return _wsum(torch.clamp(1.0 - _signed(labels) * out, min=0.0), weights)


def _squared_hinge(labels, logits, activation, weights):
    out = _activate(logits, activation)
    return _wsum(torch.clamp(1.0 - _signed(labels) * out, min=0.0) ** 2,
                 weights)


def _kld(labels, logits, activation, weights):
    out = torch.clamp(_activate(logits, activation), _EPS, 1.0)
    lab = torch.clamp(labels, _EPS, 1.0)
    return _wsum(lab * (torch.log(lab) - torch.log(out)), weights)


def _poisson(labels, logits, activation, weights):
    out = torch.clamp(_activate(logits, activation), min=_EPS)
    return _wsum(out - labels * torch.log(out), weights)


def _cosine_proximity(labels, logits, activation, weights):
    out = _activate(logits, activation)
    ln = torch.linalg.norm(labels, dim=-1)
    on = torch.linalg.norm(out, dim=-1)
    return -(labels * out).sum(dim=-1) / torch.clamp(ln * on, min=_EPS)


def _mape(labels, logits, activation, weights):
    out = _activate(logits, activation)
    rel = ((labels - out) / torch.clamp(labels.abs(), min=_EPS)).abs()
    return _wsum(rel, weights) * (100.0 / labels.shape[-1])


def _msle(labels, logits, activation, weights):
    out = _activate(logits, activation)
    d = (torch.log1p(torch.clamp(out, min=-1 + _EPS))
         - torch.log1p(torch.clamp(labels, min=-1 + _EPS)))
    return _wsum(d ** 2, weights) / labels.shape[-1]


LOSSES = {
    "mse": Loss("mse", _mse),
    "l2": Loss("l2", _l2),
    "mae": Loss("mae", _mae),
    "l1": Loss("l1", _l1),
    "mcxent": Loss("mcxent", _mcxent, fused_with="softmax"),
    "xent": Loss("xent", _xent, fused_with="sigmoid"),
    "negativeloglikelihood": Loss("negativeloglikelihood", _nll,
                                  fused_with="softmax"),
    "hinge": Loss("hinge", _hinge),
    "squared_hinge": Loss("squared_hinge", _squared_hinge),
    "kl_divergence": Loss("kl_divergence", _kld),
    "poisson": Loss("poisson", _poisson),
    "cosine_proximity": Loss("cosine_proximity", _cosine_proximity),
    "mape": Loss("mape", _mape),
    "msle": Loss("msle", _msle),
}
# aliases of the reference's LossFunctions.LossFunction enum names
LOSSES["squared_loss"] = LOSSES["l2"]
LOSSES["reconstruction_crossentropy"] = LOSSES["xent"]


def get(name):
    """Resolve a loss by name (case-insensitive) or pass a Loss through."""
    if isinstance(name, Loss):
        return name
    key = str(name).lower()
    if key not in LOSSES:
        raise ValueError(f"Unknown loss '{name}'. Available: "
                         f"{sorted(LOSSES)}")
    return LOSSES[key]
