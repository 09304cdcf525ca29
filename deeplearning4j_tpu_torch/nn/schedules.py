"""Learning-rate schedule, as configuration data (fields and JSON form of
`deeplearning4j_tpu/nn/schedules.py:Schedule`). Evaluating lr(step) arrives
with the training slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

__all__ = ["LearningRatePolicy", "Schedule"]


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
