"""Gradient updaters: the port of `deeplearning4j_tpu/nn/updaters.py`.

The classes and their JSON form are JAX's, so a configuration reads and
writes the same `__updater__` records. Each updater is a transform of one
layer's parameter dict:

    state            = updater.init(params)
    updates, state   = updater.update(grads, state, step, lr)
    params           = {k: params[k] - updates[k] for k in params}

State is one dict per layer, keyed as JAX keys it (`m`/`v`, `u`, `h`,
`msg`/`msdx`, `g2`, `v`), each holding a dict shaped like the layer's
parameters (nested where they are: a BiLSTM's `m/fwd/W`), so `updaterState.npz` has the same `i:0/k:m/k:W` paths in both
packages. The scalar step arithmetic (Adam's `t = step + 1` and `b ** t`,
schedules) is done in float32 on the host, as JAX does it in float32;
the tensors are updated out of place.

Each update is split in two (`update` = `apply` of `scalars`):
`scalars(step, lr)` is the step's host arithmetic, a tuple of float32
values (Adam's bias-corrected step size, the lr), and `apply(grads,
state, sc)` the tensor arithmetic, which takes each of them as a Python
float or as a 0-dim float32 tensor. A training step replayed as a CUDA
graph reads its scalars from a device table the host fills for each step
(`nn/superstep.py`): a float baked into a graph at capture would freeze
the step it was captured at. A multiply by a 0-dim float32 tensor gives
the bits of a multiply by the same value as a Python float (the tests
hold it on the CPU and on the card); `_smul` keeps that true for
bfloat16 and float16 tensors, which would otherwise round the scalar to
their own type first.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from .trees import tree_map

__all__ = ["Updater", "Sgd", "NoOp", "Adam", "AdaMax", "AdaGrad", "AdaDelta",
           "RmsProp", "Nesterovs", "get", "from_dict", "UPDATERS", "smul"]


def _zeros_like(params):
    return tree_map(torch.zeros_like, params)


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


def smul(s, t: torch.Tensor) -> torch.Tensor:
    """`s * t` for a step scalar `s` (a float, or a 0-dim float32 tensor)
    with the bits of the float form: a half-precision `t` is multiplied in
    float32 and rounded once, as torch does for a Python scalar."""
    if (isinstance(s, torch.Tensor) and t.dtype != s.dtype
            and t.dtype in (torch.bfloat16, torch.float16)):
        return (s * t.to(s.dtype)).to(t.dtype)
    return s * t


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

    def scalars(self, step, lr=None) -> tuple:
        """The step's host scalars (float32 values as Python floats)."""
        return ()

    def apply(self, grads, state, sc):
        """(updates, new state) from the gradients and `scalars`' values
        (floats or 0-dim float32 tensors)."""
        raise NotImplementedError

    def update(self, grads, state, step, lr=None):
        return self.apply(grads, state, self.scalars(step, lr))

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
    def scalars(self, step, lr=None):
        return (self._lr(lr),)

    def apply(self, grads, state, sc):
        lr, = sc
        return tree_map(lambda g: smul(lr, g), grads), state


@dataclass
class NoOp(Updater):
    """Updater.NONE: gradients applied raw (lr ignored)."""

    def apply(self, grads, state, sc):
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
            z["m"] = tree_map(lambda a: a.to(dt), z["m"])
        return z

    def scalars(self, step, lr=None):
        # bias-corrected step size (ND4J AdamUpdater's form), float32
        return (float(_f32(self._lr(lr))
                      * torch.sqrt(_bias_correction(self.beta2, step))
                      / _bias_correction(self.beta1, step)),)

    def apply(self, grads, state, sc):
        alpha, = sc
        b1, b2, eps = self.beta1, self.beta2, self.epsilon
        m = tree_map(lambda m_, g: b1 * m_.to(g.dtype) + (1 - b1) * g,
                  state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g * g, state["v"], grads)
        upd = tree_map(lambda m_, v_: smul(alpha, m_) / (torch.sqrt(v_) + eps),
                       m, v)
        dt = self._m_dtype()
        if dt is not None:
            m = tree_map(lambda a: a.to(dt), m)
        return upd, {"m": m, "v": v}


@dataclass
class AdaMax(Updater):
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init(self, params):
        return {"m": _zeros_like(params), "u": _zeros_like(params)}

    def scalars(self, step, lr=None):
        return (float(_f32(self._lr(lr))
                      / _bias_correction(self.beta1, step)),)

    def apply(self, grads, state, sc):
        alpha, = sc
        b1, b2 = self.beta1, self.beta2
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
        u = tree_map(lambda u_, g: torch.maximum(b2 * u_, g.abs()), state["u"],
                  grads)
        upd = tree_map(lambda m_, u_: smul(alpha, m_) / (u_ + self.epsilon),
                       m, u)
        return upd, {"m": m, "u": u}


@dataclass
class AdaGrad(Updater):
    learning_rate: float = 0.1
    epsilon: float = 1e-6

    def init(self, params):
        return {"h": _zeros_like(params)}

    def scalars(self, step, lr=None):
        return (self._lr(lr),)

    def apply(self, grads, state, sc):
        lr, = sc
        h = tree_map(lambda h_, g: h_ + g * g, state["h"], grads)
        upd = tree_map(lambda g, h_: smul(lr, g) / (torch.sqrt(h_)
                                                    + self.epsilon),
                    grads, h)
        return upd, {"h": h}


@dataclass
class AdaDelta(Updater):
    rho: float = 0.95
    epsilon: float = 1e-6

    def init(self, params):
        return {"msg": _zeros_like(params), "msdx": _zeros_like(params)}

    def apply(self, grads, state, sc):
        rho, eps = self.rho, self.epsilon
        msg = tree_map(lambda a, g: rho * a + (1 - rho) * g * g, state["msg"],
                    grads)
        upd = tree_map(lambda g, a, d: g * torch.sqrt(d + eps)
                    / torch.sqrt(a + eps), grads, msg, state["msdx"])
        msdx = tree_map(lambda d, u: rho * d + (1 - rho) * u * u, state["msdx"],
                     upd)
        return upd, {"msg": msg, "msdx": msdx}


@dataclass
class RmsProp(Updater):
    learning_rate: float = 1e-1
    rms_decay: float = 0.95
    epsilon: float = 1e-8

    def init(self, params):
        return {"g2": _zeros_like(params)}

    def scalars(self, step, lr=None):
        return (self._lr(lr),)

    def apply(self, grads, state, sc):
        lr, = sc
        d = self.rms_decay
        g2 = tree_map(lambda a, g: d * a + (1 - d) * g * g, state["g2"], grads)
        upd = tree_map(lambda g, a: smul(lr, g) / (torch.sqrt(a)
                                                   + self.epsilon),
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

    def scalars(self, step, lr=None):
        return (self._lr(lr),)

    def apply(self, grads, state, sc):
        lr, = sc
        mu = self.momentum
        v_new = tree_map(lambda v, g: mu * v - smul(lr, g), state["v"], grads)
        upd = tree_map(lambda vn, g: smul(lr, g) - mu * vn, v_new, grads)
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
