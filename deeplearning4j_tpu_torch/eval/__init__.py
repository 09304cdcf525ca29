"""Evaluation of the port: classification metrics."""
from .evaluation import ConfusionMatrix, Evaluation, Prediction

__all__ = ["ConfusionMatrix", "Evaluation", "Prediction"]
