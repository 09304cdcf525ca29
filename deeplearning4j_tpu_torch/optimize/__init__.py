"""Training listeners and line-search optimizers of the port."""
from .listeners import (
    IterationListener, TrainingListener, ScoreIterationListener,
    PerformanceListener, CollectScoresIterationListener,
    ComposableIterationListener, ParamAndGradientIterationListener,
)

__all__ = [
    "IterationListener", "TrainingListener", "ScoreIterationListener",
    "PerformanceListener", "CollectScoresIterationListener",
    "ComposableIterationListener", "ParamAndGradientIterationListener",
]
