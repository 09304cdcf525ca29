"""Updater hyperparameters, as configuration data.

The classes and their JSON form are those of
`deeplearning4j_tpu/nn/updaters.py`, so a configuration reads and writes the
same `__updater__` records. The update rules themselves arrive with the
training slice; nothing in the inference path reads these values.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

__all__ = ["Updater", "Sgd", "NoOp", "Adam", "AdaMax", "AdaGrad", "AdaDelta",
           "RmsProp", "Nesterovs", "get", "from_dict", "UPDATERS"]


@dataclass
class Updater:
    learning_rate: float = 0.1

    def to_dict(self) -> Dict:
        d = {k: getattr(self, k) for k in self.__dataclass_fields__}
        d["type"] = type(self).__name__
        return d


@dataclass
class Sgd(Updater):
    pass


@dataclass
class NoOp(Updater):
    pass


@dataclass
class Adam(Updater):
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    state_dtype: Optional[str] = None


@dataclass
class AdaMax(Updater):
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8


@dataclass
class AdaGrad(Updater):
    learning_rate: float = 0.1
    epsilon: float = 1e-6


@dataclass
class AdaDelta(Updater):
    rho: float = 0.95
    epsilon: float = 1e-6


@dataclass
class RmsProp(Updater):
    learning_rate: float = 1e-1
    rms_decay: float = 0.95
    epsilon: float = 1e-8


@dataclass
class Nesterovs(Updater):
    learning_rate: float = 0.1
    momentum: float = 0.9


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
