"""Evaluation of the port: classification, ROC and regression metrics, and
their HTML charts (`EvaluationTools`)."""
from .evaluation import ConfusionMatrix, Evaluation, Prediction
from .regression import RegressionEvaluation
from .roc import ROC, ROCMultiClass
from .tools import EvaluationTools

__all__ = ["ConfusionMatrix", "Evaluation", "EvaluationTools", "Prediction",
           "RegressionEvaluation", "ROC", "ROCMultiClass"]
