"""Regression evaluation: the port of `deeplearning4j_tpu/eval/regression.py`
(per-column MSE, MAE, RMSE, relative squared error and Pearson correlation,
a `stats()` report, masked time series). Sufficient statistics accumulate
on the host in float64; inputs may be numpy arrays or tensors on any
device.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["RegressionEvaluation"]


def _host(a) -> np.ndarray:
    """A numpy array of `a` (a torch tensor on any device, or array-like)."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float64).cpu().numpy()
    return np.asarray(a)


class RegressionEvaluation:
    def __init__(self, column_names: Optional[Sequence[str]] = None,
                 n_columns: Optional[int] = None):
        if column_names is not None:
            n_columns = len(column_names)
        self.column_names = list(column_names) if column_names else None
        self.n = None if n_columns is None else int(n_columns)
        self._init_done = False

    def _ensure(self, c):
        if self._init_done:
            return
        self.n = c if self.n is None else self.n
        z = np.zeros(self.n, np.float64)
        self.count = z.copy()
        self.sum_sq_err = z.copy()
        self.sum_abs_err = z.copy()
        self.sum_label = z.copy()
        self.sum_label_sq = z.copy()
        self.sum_pred = z.copy()
        self.sum_pred_sq = z.copy()
        self.sum_label_pred = z.copy()
        self._init_done = True

    def eval(self, labels, predictions, mask: Optional[np.ndarray] = None):
        labels = _host(labels).astype(np.float64)
        preds = _host(predictions).astype(np.float64)
        c = labels.shape[-1]
        self._ensure(c)
        lab = labels.reshape(-1, c)
        pr = preds.reshape(-1, c)
        if mask is not None:
            m = _host(mask).reshape(-1).astype(bool)
            lab, pr = lab[m], pr[m]
        err = pr - lab
        self.count += lab.shape[0]
        self.sum_sq_err += (err ** 2).sum(axis=0)
        self.sum_abs_err += np.abs(err).sum(axis=0)
        self.sum_label += lab.sum(axis=0)
        self.sum_label_sq += (lab ** 2).sum(axis=0)
        self.sum_pred += pr.sum(axis=0)
        self.sum_pred_sq += (pr ** 2).sum(axis=0)
        self.sum_label_pred += (lab * pr).sum(axis=0)

    def eval_time_series(self, labels, predictions, labels_mask=None):
        self.eval(labels, predictions, mask=labels_mask)

    # ------------------------------------------------------------------
    def mean_squared_error(self, col: int) -> float:
        return float(self.sum_sq_err[col] / self.count[col])

    def mean_absolute_error(self, col: int) -> float:
        return float(self.sum_abs_err[col] / self.count[col])

    def root_mean_squared_error(self, col: int) -> float:
        return float(np.sqrt(self.mean_squared_error(col)))

    def relative_squared_error(self, col: int) -> float:
        n = self.count[col]
        mean_label = self.sum_label[col] / n
        denom = self.sum_label_sq[col] - n * mean_label ** 2
        return float(self.sum_sq_err[col] / denom) if denom else float("inf")

    def pearson_correlation(self, col: int) -> float:
        n = self.count[col]
        cov = self.sum_label_pred[col] - self.sum_label[col] * self.sum_pred[col] / n
        vl = self.sum_label_sq[col] - self.sum_label[col] ** 2 / n
        vp = self.sum_pred_sq[col] - self.sum_pred[col] ** 2 / n
        d = np.sqrt(vl * vp)
        return float(cov / d) if d else 0.0

    def average_mean_squared_error(self) -> float:
        return float(np.mean([self.mean_squared_error(i) for i in range(self.n)]))

    def average_mean_absolute_error(self) -> float:
        return float(np.mean([self.mean_absolute_error(i) for i in range(self.n)]))

    def average_root_mean_squared_error(self) -> float:
        return float(np.mean([self.root_mean_squared_error(i)
                              for i in range(self.n)]))

    def average_pearson_correlation(self) -> float:
        return float(np.mean([self.pearson_correlation(i) for i in range(self.n)]))

    def stats(self) -> str:
        names = self.column_names or [f"col_{i}" for i in range(self.n)]
        lines = ["", f"{'Column':<16}{'MSE':>12}{'MAE':>12}{'RMSE':>12}"
                     f"{'RSE':>12}{'R':>12}"]
        for i, name in enumerate(names):
            lines.append(
                f"{name:<16}{self.mean_squared_error(i):>12.5f}"
                f"{self.mean_absolute_error(i):>12.5f}"
                f"{self.root_mean_squared_error(i):>12.5f}"
                f"{self.relative_squared_error(i):>12.5f}"
                f"{self.pearson_correlation(i):>12.5f}")
        return "\n".join(lines)
