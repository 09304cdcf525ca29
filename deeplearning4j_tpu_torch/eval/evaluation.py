"""Classification evaluation: the port of
`deeplearning4j_tpu/eval/evaluation.py` (accuracy, per-class precision /
recall / F1 with macro averages, confusion matrix, top-N accuracy, masked
time-series evaluation, `stats()`). Accumulation is one [C, C] numpy
matrix, updated once per batch from host arrays.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["Evaluation", "ConfusionMatrix", "Prediction"]


class ConfusionMatrix:
    """Counts matrix, rows = actual class, cols = predicted class."""

    def __init__(self, num_classes: int):
        self.matrix = np.zeros((num_classes, num_classes), dtype=np.int64)

    def add(self, actual: np.ndarray, predicted: np.ndarray,
            weights: Optional[np.ndarray] = None):
        n = self.matrix.shape[0]
        flat = actual * n + predicted
        counts = np.bincount(flat, weights=weights, minlength=n * n)
        self.matrix += counts.reshape(n, n).astype(np.int64)

    def get_count(self, actual: int, predicted: int) -> int:
        return int(self.matrix[actual, predicted])

    def to_csv(self) -> str:
        n = self.matrix.shape[0]
        lines = ["," + ",".join(str(i) for i in range(n))]
        for i in range(n):
            lines.append(f"{i}," + ",".join(str(x) for x in self.matrix[i]))
        return "\n".join(lines)


class Prediction:
    """One example's outcome + its metadata (reference
    `eval/meta/Prediction.java`)."""

    __slots__ = ("actual", "predicted", "meta")

    def __init__(self, actual: int, predicted: int, meta):
        self.actual = actual
        self.predicted = predicted
        self.meta = meta

    def __repr__(self):
        return (f"Prediction(actual={self.actual}, "
                f"predicted={self.predicted}, meta={self.meta!r})")


class Evaluation:
    def __init__(self, num_classes: Optional[int] = None,
                 labels: Optional[Sequence[str]] = None, top_n: int = 1):
        if labels is not None and num_classes is None:
            num_classes = len(labels)
        self.num_classes = num_classes
        self.label_names = list(labels) if labels is not None else None
        self.top_n = int(top_n)
        self.confusion: Optional[ConfusionMatrix] = None
        self.top_n_correct = 0
        self.top_n_total = 0
        # per-example metadata attribution (reference eval/meta/ —
        # Prediction records linking outcomes back to example metadata)
        self.predictions: list = []

    # ------------------------------------------------------------------
    def _ensure(self, c: int):
        if self.num_classes is None:
            self.num_classes = c
        if self.confusion is None:
            self.confusion = ConfusionMatrix(self.num_classes)

    @staticmethod
    def _to_index(arr: np.ndarray) -> np.ndarray:
        arr = np.asarray(arr)
        if arr.ndim >= 2 and arr.shape[-1] > 1:
            return np.argmax(arr, axis=-1)
        if arr.ndim >= 2:
            # single-column output: binary, threshold at 0.5 (DL4J Evaluation
            # semantics for sigmoid/single-unit outputs)
            return (arr[..., 0] > 0.5).astype(np.int64)
        if np.issubdtype(arr.dtype, np.floating) and not np.all(arr == arr.astype(np.int64)):
            return (arr > 0.5).astype(np.int64)
        return arr.astype(np.int64)

    def eval(self, labels, predictions, mask: Optional[np.ndarray] = None,
             meta_data: Optional[Sequence] = None):
        """labels: one-hot [N,C] (or [N,T,C] time series), single-column binary
        [N,1], or index array; predictions: probabilities/scores of same shape.
        mask: [N] or [N,T]. meta_data: optional per-example records (length
        N) kept with each prediction for error attribution (reference
        `eval/meta/` — `evaluate(..., List<RecordMetaData>)`)."""
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if labels.ndim >= 2 and labels.shape[-1] > 1:
            c = labels.shape[-1]
        elif predictions.ndim >= 2 and predictions.shape[-1] > 1:
            c = predictions.shape[-1]
        else:
            c = 2  # single-column / index arrays => binary
        self._ensure(int(c))
        actual = self._to_index(labels).ravel()
        pred = self._to_index(predictions).ravel()
        if meta_data is not None and labels.ndim >= 3:
            # time series: each example contributes T per-timestep
            # predictions — expand per-example metadata to match before any
            # mask filtering
            T = labels.shape[1]
            meta_data = [md for md in meta_data for _ in range(T)]
        if mask is not None:
            m = np.asarray(mask).ravel().astype(bool)
            actual, pred = actual[m], pred[m]
            if meta_data is not None:
                meta_data = [md for md, keep in zip(meta_data, m) if keep]
        if meta_data is not None and len(meta_data) != len(actual):
            # validate BEFORE mutating any accumulator so a caught error
            # leaves the evaluation consistent
            raise ValueError(
                f"meta_data length {len(meta_data)} != examples "
                f"{len(actual)}")
        self.confusion.add(actual, pred)
        if meta_data is not None:
            self.predictions.extend(
                Prediction(int(a), int(p), md)
                for a, p, md in zip(actual, pred, meta_data))
        # top-N accuracy (reference Evaluation topN support)
        if self.top_n > 1 and predictions.ndim >= 2:
            p2 = predictions.reshape(-1, predictions.shape[-1])
            a2 = self._to_index(labels).ravel()
            if mask is not None:
                m = np.asarray(mask).ravel().astype(bool)
                p2, a2 = p2[m], a2[m]
            topk = np.argsort(-p2, axis=1)[:, :self.top_n]
            self.top_n_correct += int((topk == a2[:, None]).any(axis=1).sum())
            self.top_n_total += len(a2)

    def eval_time_series(self, labels, predictions, labels_mask=None):
        self.eval(labels, predictions, mask=labels_mask)

    # -- per-example attribution (reference EvaluationUtils meta queries) --
    def get_prediction_errors(self) -> list:
        """Misclassified examples with their metadata."""
        return [p for p in self.predictions if p.actual != p.predicted]

    def get_predictions_by_actual_class(self, cls: int) -> list:
        return [p for p in self.predictions if p.actual == cls]

    def get_predictions_by_predicted_class(self, cls: int) -> list:
        return [p for p in self.predictions if p.predicted == cls]

    def get_predictions(self, actual: int, predicted: int) -> list:
        """Examples in one confusion-matrix cell."""
        return [p for p in self.predictions
                if p.actual == actual and p.predicted == predicted]

    def merge(self, other: "Evaluation"):
        if other.confusion is None:
            return
        self._ensure(other.num_classes)
        self.confusion.matrix += other.confusion.matrix
        self.top_n_correct += other.top_n_correct
        self.top_n_total += other.top_n_total
        self.predictions.extend(other.predictions)

    # ------------------------------------------------------------------
    @property
    def _m(self) -> np.ndarray:
        return self.confusion.matrix if self.confusion is not None else np.zeros((0, 0))

    def num_examples(self) -> int:
        return int(self._m.sum())

    def true_positives(self) -> np.ndarray:
        return np.diag(self._m)

    def false_positives(self) -> np.ndarray:
        return self._m.sum(axis=0) - np.diag(self._m)

    def false_negatives(self) -> np.ndarray:
        return self._m.sum(axis=1) - np.diag(self._m)

    def accuracy(self) -> float:
        total = self._m.sum()
        return float(np.diag(self._m).sum() / total) if total else 0.0

    def top_n_accuracy(self) -> float:
        return self.top_n_correct / self.top_n_total if self.top_n_total else 0.0

    def precision(self, cls: Optional[int] = None) -> float:
        tp, fp = self.true_positives(), self.false_positives()
        if cls is not None:
            d = tp[cls] + fp[cls]
            return float(tp[cls] / d) if d else 0.0
        per = [self.precision(i) for i in range(self.num_classes)
               if (tp[i] + fp[i] + self.false_negatives()[i]) > 0]
        return float(np.mean(per)) if per else 0.0

    def recall(self, cls: Optional[int] = None) -> float:
        tp, fn = self.true_positives(), self.false_negatives()
        if cls is not None:
            d = tp[cls] + fn[cls]
            return float(tp[cls] / d) if d else 0.0
        per = [self.recall(i) for i in range(self.num_classes)
               if (tp[i] + fn[i] + self.false_positives()[i]) > 0]
        return float(np.mean(per)) if per else 0.0

    def f1(self, cls: Optional[int] = None) -> float:
        p, r = self.precision(cls), self.recall(cls)
        return 2 * p * r / (p + r) if (p + r) else 0.0

    def stats(self) -> str:
        lines = ["", "========================Evaluation Metrics========================"]
        lines.append(f" # of classes:    {self.num_classes}")
        lines.append(f" Examples:        {self.num_examples()}")
        lines.append(f" Accuracy:        {self.accuracy():.4f}")
        if self.top_n > 1:
            lines.append(f" Top {self.top_n} Accuracy:  {self.top_n_accuracy():.4f}")
        lines.append(f" Precision:       {self.precision():.4f}")
        lines.append(f" Recall:          {self.recall():.4f}")
        lines.append(f" F1 Score:        {self.f1():.4f}")
        lines.append("")
        lines.append("=========================Confusion Matrix=========================")
        n = self.num_classes or 0
        names = self.label_names or [str(i) for i in range(n)]
        lines.append("   " + " ".join(f"{i:>6}" for i in range(n)))
        for i in range(n):
            lines.append(f"{i:>2} " + " ".join(f"{self._m[i, j]:>6}" for j in range(n))
                         + f"  | {names[i]}")
        lines.append("==================================================================")
        return "\n".join(lines)

    def confusion_to_string(self) -> str:
        return self.confusion.to_csv() if self.confusion else ""
