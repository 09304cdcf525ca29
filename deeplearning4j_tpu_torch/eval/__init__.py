"""Evaluation of the port: classification, ROC and regression metrics."""
from .evaluation import ConfusionMatrix, Evaluation, Prediction
from .regression import RegressionEvaluation
from .roc import ROC, ROCMultiClass

__all__ = ["ConfusionMatrix", "Evaluation", "Prediction",
           "RegressionEvaluation", "ROC", "ROCMultiClass"]
