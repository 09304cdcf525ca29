"""Gradient updaters: the port of `deeplearning4j_tpu/nn/updaters.py`.

The classes and their JSON form are JAX's, so a configuration reads and
writes the same `__updater__` records. Each updater is a transform of one
layer's parameter dict:

    state            = updater.init(params)
    updates, state   = updater.update(grads, state, step, lr)
    params           = {k: params[k] - updates[k] for k in params}

State is one dict per layer, keyed as JAX keys it (`m`/`v`, `u`, `h`,
`msg`/`msdx`, `g2`, `v`), each holding a dict shaped like the layer's
parameters, so `updaterState.npz` has the same `i:0/k:m/k:W` paths in both
packages. The scalar step arithmetic (Adam's `t = step + 1` and `b ** t`,
schedules) is done in float32 on the host, as JAX does it in float32;
the tensors are updated out of place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

__all__ = ["Updater", "Sgd", "NoOp", "Adam", "AdaMax", "AdaGrad", "AdaDelta",
           "RmsProp", "Nesterovs", "get", "from_dict", "UPDATERS"]


def _tmap(f, *dicts):
    """Apply `f` key by key over parameter-shaped dicts."""
    return {k: f(*(d[k] for d in dicts)) for k in dicts[0]}


def _zeros_like(params):
    return _tmap(torch.zeros_like, params)


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


def _bias_correction(b: float, step) -> torch.Tensor:
    """1 - b ** (step + 1), in float32 as JAX computes it."""
    return 1.0 - _f32(b) ** (_f32(step) + 1.0)


@dataclass
class Updater:
    """Base. `learning_rate` is the default lr, used when the caller passes
    no scheduled or per-layer lr."""

    learning_rate: float = 0.1

    def init(self, params) -> Dict:
        return {}

    def update(self, grads, state, step, lr=None):
        raise NotImplementedError

    def _lr(self, lr) -> float:
        """The step's lr as a host float (a float32 schedule value stays
        exactly that float32)."""
        return float(self.learning_rate if lr is None else lr)

    def to_dict(self) -> Dict:
        d = {k: getattr(self, k) for k in self.__dataclass_fields__}
        d["type"] = type(self).__name__
        return d


@dataclass
class Sgd(Updater):
    def update(self, grads, state, step, lr=None):
        lr = self._lr(lr)
        return _tmap(lambda g: lr * g, grads), state


@dataclass
class NoOp(Updater):
    """Updater.NONE: gradients applied raw (lr ignored)."""

    def update(self, grads, state, step, lr=None):
        return grads, state


@dataclass
class Adam(Updater):
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    # storage dtype of the first moment m only ("bfloat16", say); v always
    # stays in the gradient dtype (JAX's reasoning: its EMA step is below
    # bf16's resolution)
    state_dtype: Optional[str] = None

    def _m_dtype(self):
        return None if self.state_dtype is None else getattr(
            torch, self.state_dtype)

    def init(self, params):
        z = {"m": _zeros_like(params), "v": _zeros_like(params)}
        dt = self._m_dtype()
        if dt is not None:
            z["m"] = _tmap(lambda a: a.to(dt), z["m"])
        return z

    def update(self, grads, state, step, lr=None):
        lr = self._lr(lr)
        b1, b2, eps = self.beta1, self.beta2, self.epsilon
        m = _tmap(lambda m_, g: b1 * m_.to(g.dtype) + (1 - b1) * g,
                  state["m"], grads)
        v = _tmap(lambda v_, g: b2 * v_ + (1 - b2) * g * g, state["v"], grads)
        # bias-corrected step size (ND4J AdamUpdater's form), float32
        alpha = float(_f32(lr) * torch.sqrt(_bias_correction(b2, step))
                      / _bias_correction(b1, step))
        upd = _tmap(lambda m_, v_: alpha * m_ / (torch.sqrt(v_) + eps), m, v)
        dt = self._m_dtype()
        if dt is not None:
            m = _tmap(lambda a: a.to(dt), m)
        return upd, {"m": m, "v": v}


@dataclass
class AdaMax(Updater):
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init(self, params):
        return {"m": _zeros_like(params), "u": _zeros_like(params)}

    def update(self, grads, state, step, lr=None):
        lr = self._lr(lr)
        b1, b2 = self.beta1, self.beta2
        m = _tmap(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
        u = _tmap(lambda u_, g: torch.maximum(b2 * u_, g.abs()), state["u"],
                  grads)
        alpha = float(_f32(lr) / _bias_correction(b1, step))
        upd = _tmap(lambda m_, u_: alpha * m_ / (u_ + self.epsilon), m, u)
        return upd, {"m": m, "u": u}


@dataclass
class AdaGrad(Updater):
    learning_rate: float = 0.1
    epsilon: float = 1e-6

    def init(self, params):
        return {"h": _zeros_like(params)}

    def update(self, grads, state, step, lr=None):
        lr = self._lr(lr)
        h = _tmap(lambda h_, g: h_ + g * g, state["h"], grads)
        upd = _tmap(lambda g, h_: lr * g / (torch.sqrt(h_) + self.epsilon),
                    grads, h)
        return upd, {"h": h}


@dataclass
class AdaDelta(Updater):
    rho: float = 0.95
    epsilon: float = 1e-6

    def init(self, params):
        return {"msg": _zeros_like(params), "msdx": _zeros_like(params)}

    def update(self, grads, state, step, lr=None):
        rho, eps = self.rho, self.epsilon
        msg = _tmap(lambda a, g: rho * a + (1 - rho) * g * g, state["msg"],
                    grads)
        upd = _tmap(lambda g, a, d: g * torch.sqrt(d + eps)
                    / torch.sqrt(a + eps), grads, msg, state["msdx"])
        msdx = _tmap(lambda d, u: rho * d + (1 - rho) * u * u, state["msdx"],
                     upd)
        return upd, {"msg": msg, "msdx": msdx}


@dataclass
class RmsProp(Updater):
    learning_rate: float = 1e-1
    rms_decay: float = 0.95
    epsilon: float = 1e-8

    def init(self, params):
        return {"g2": _zeros_like(params)}

    def update(self, grads, state, step, lr=None):
        lr = self._lr(lr)
        d = self.rms_decay
        g2 = _tmap(lambda a, g: d * a + (1 - d) * g * g, state["g2"], grads)
        upd = _tmap(lambda g, a: lr * g / (torch.sqrt(a) + self.epsilon),
                    grads, g2)
        return upd, {"g2": g2}


@dataclass
class Nesterovs(Updater):
    """Nesterov momentum (ND4J NesterovsUpdater form): v' = mu v - lr g;
    update = lr g - mu v' under the params -= update convention."""

    learning_rate: float = 0.1
    momentum: float = 0.9

    def init(self, params):
        return {"v": _zeros_like(params)}

    def update(self, grads, state, step, lr=None):
        lr = self._lr(lr)
        mu = self.momentum
        v_new = _tmap(lambda v, g: mu * v - lr * g, state["v"], grads)
        upd = _tmap(lambda vn, g: lr * g - mu * vn, v_new, grads)
        return upd, {"v": v_new}


UPDATERS = {
    "sgd": Sgd, "adam": Adam, "adamax": AdaMax, "adagrad": AdaGrad,
    "adadelta": AdaDelta, "rmsprop": RmsProp, "nesterovs": Nesterovs,
    "none": NoOp, "noop": NoOp,
}


def get(name, learning_rate=None, **kw) -> Updater:
    """Resolve an updater by enum-style name or pass through an instance."""
    if isinstance(name, Updater):
        return name
    cls = UPDATERS.get(str(name).lower())
    if cls is None:
        raise ValueError(f"Unknown updater '{name}'. Available: {sorted(UPDATERS)}")
    if learning_rate is not None and "learning_rate" in cls.__dataclass_fields__:
        kw["learning_rate"] = learning_rate
    return cls(**kw)


def from_dict(d: Dict) -> Updater:
    d = dict(d)
    t = d.pop("type")
    for cls in (Sgd, Adam, AdaMax, AdaGrad, AdaDelta, RmsProp, Nesterovs, NoOp):
        if cls.__name__ == t:
            return cls(**{k: v for k, v in d.items()
                          if k in cls.__dataclass_fields__})
    raise ValueError(f"Unknown updater type '{t}'")
