"""Learning-rate schedules: the port of `deeplearning4j_tpu/nn/schedules.py`
(fields, JSON form and the lr(step) of every policy). lr(step) is a 0-d
float32 tensor on the host, computed in float32 as JAX computes it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

__all__ = ["LearningRatePolicy", "Schedule", "make_schedule"]


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


class LearningRatePolicy:
    NONE = "none"
    EXPONENTIAL = "exponential"
    INVERSE = "inverse"
    POLY = "poly"
    SIGMOID = "sigmoid"
    STEP = "step"
    SCHEDULE = "schedule"
    TORCH_STEP = "torchstep"
    SCORE = "score"


@dataclass
class Schedule:
    base_lr: float
    policy: str = LearningRatePolicy.NONE
    decay_rate: float = 0.0
    steps: float = 1.0
    power: float = 1.0
    max_iter: float = 10000.0
    schedule: Optional[Dict[int, float]] = None  # iteration -> lr (SCHEDULE policy)

    def __call__(self, step) -> torch.Tensor:
        p = str(self.policy).lower()
        it = _f32(step)
        base = _f32(self.base_lr)
        if p in (LearningRatePolicy.NONE, LearningRatePolicy.SCORE):
            # SCORE (decay on plateau) is driven by a solver, not here
            return base
        if p == LearningRatePolicy.EXPONENTIAL:
            return base * _f32(self.decay_rate) ** it
        if p == LearningRatePolicy.INVERSE:
            return base / (1.0 + self.decay_rate * it) ** _f32(self.power)
        if p == LearningRatePolicy.POLY:
            frac = torch.clamp(it / self.max_iter, 0.0, 1.0)
            return base * (1.0 - frac) ** _f32(self.power)
        if p == LearningRatePolicy.SIGMOID:
            return base / (1.0 + torch.exp(-self.decay_rate
                                           * (it - self.steps)))
        if p in (LearningRatePolicy.STEP, LearningRatePolicy.TORCH_STEP):
            return base * _f32(self.decay_rate) ** torch.floor(
                it / self.steps)
        if p == LearningRatePolicy.SCHEDULE:
            lr = base
            for k in sorted(self.schedule or {}, key=int):
                if step >= int(k):
                    lr = _f32(self.schedule[k])
            return lr
        raise ValueError(f"Unknown learning rate policy '{self.policy}'")

    def to_dict(self):
        return {
            "base_lr": self.base_lr, "policy": self.policy,
            "decay_rate": self.decay_rate, "steps": self.steps,
            "power": self.power, "max_iter": self.max_iter,
            "schedule": {str(k): v for k, v in (self.schedule or {}).items()} or None,
        }

    @staticmethod
    def from_dict(d):
        d = dict(d)
        if d.get("schedule"):
            d["schedule"] = {int(k): float(v) for k, v in d["schedule"].items()}
        return Schedule(**d)


def make_schedule(base_lr, policy=LearningRatePolicy.NONE, **kw) -> Schedule:
    return Schedule(base_lr=base_lr, policy=policy, **kw)
