"""ROC / AUC evaluation: the port of `deeplearning4j_tpu/eval/roc.py`
(`ROC`: thresholded binary ROC over a grid of `threshold_steps + 1`
thresholds; `ROCMultiClass`: one-vs-all per class). Counts TP / FP / TN / FN
per threshold batch by batch on the host, so the AUC is exact for the
threshold grid. Labels and probabilities may be numpy arrays or tensors on
any device.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

__all__ = ["ROC", "ROCMultiClass"]


def _host(a) -> np.ndarray:
    """A numpy array of `a` (a torch tensor on any device, or array-like)."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float64).cpu().numpy()
    return np.asarray(a)


class ROC:
    def __init__(self, threshold_steps: int = 100):
        self.threshold_steps = int(threshold_steps)
        self.thresholds = np.linspace(0.0, 1.0, self.threshold_steps + 1)
        self.tp = np.zeros(self.threshold_steps + 1, np.int64)
        self.fp = np.zeros_like(self.tp)
        self.fn = np.zeros_like(self.tp)
        self.tn = np.zeros_like(self.tp)

    def eval(self, labels, probs, mask: Optional[np.ndarray] = None):
        """labels: [N] or [N,1] in {0,1} or one-hot [N,2]; probs: same shape
        (probability of the positive class; for [N,2] the 2nd column)."""
        labels = _host(labels)
        probs = _host(probs)
        if labels.ndim >= 2 and labels.shape[-1] == 2:
            labels = labels[..., 1]
            probs = probs[..., 1]
        labels = labels.reshape(-1)
        probs = probs.reshape(-1)
        if mask is not None:
            m = _host(mask).reshape(-1).astype(bool)
            labels, probs = labels[m], probs[m]
        pos = labels > 0.5
        # vectorized: predictions at each threshold
        pred = probs[None, :] >= self.thresholds[:, None]  # [T+1, N]
        self.tp += (pred & pos[None, :]).sum(axis=1)
        self.fp += (pred & ~pos[None, :]).sum(axis=1)
        self.fn += (~pred & pos[None, :]).sum(axis=1)
        self.tn += (~pred & ~pos[None, :]).sum(axis=1)

    def get_roc_curve(self) -> List[Tuple[float, float, float]]:
        """[(threshold, fpr, tpr)]."""
        out = []
        for i, t in enumerate(self.thresholds):
            p = self.tp[i] + self.fn[i]
            n = self.fp[i] + self.tn[i]
            tpr = self.tp[i] / p if p else 0.0
            fpr = self.fp[i] / n if n else 0.0
            out.append((float(t), float(fpr), float(tpr)))
        return out

    def calculate_auc(self) -> float:
        pts = self.get_roc_curve()
        fprs = np.array([p[1] for p in pts])
        tprs = np.array([p[2] for p in pts])
        order = np.lexsort((tprs, fprs))  # ties in fpr ordered by tpr
        x = np.concatenate([[0.0], fprs[order], [1.0]])
        y = np.concatenate([[0.0], tprs[order], [1.0]])
        return float(np.trapezoid(y, x))

    def get_precision_recall_curve(self):
        """[(threshold, recall, precision)] per threshold (reference
        `getPrecisionRecallCurve`)."""
        out = []
        for i, t in enumerate(self.thresholds):
            denom_p = self.tp[i] + self.fp[i]
            denom_r = self.tp[i] + self.fn[i]
            prec = self.tp[i] / denom_p if denom_p else 1.0
            rec = self.tp[i] / denom_r if denom_r else 0.0
            out.append((float(t), float(rec), float(prec)))
        return out

    def calculate_auprc(self) -> float:
        """Area under precision-recall curve (trapezoid over the grid)."""
        pts = self.get_precision_recall_curve()
        pairs = sorted((r, p) for _, r, p in pts)
        auc = 0.0
        for (r0, p0), (r1, p1) in zip(pairs[:-1], pairs[1:]):
            auc += (r1 - r0) * (p1 + p0) / 2.0
        return float(auc)


class ROCMultiClass:
    """One-vs-all ROC per class (reference `eval/ROCMultiClass.java`)."""

    def __init__(self, threshold_steps: int = 100):
        self.threshold_steps = int(threshold_steps)
        self._rocs: List[ROC] = []

    def eval(self, labels, probs, mask: Optional[np.ndarray] = None):
        labels = _host(labels)
        probs = _host(probs)
        c = labels.shape[-1]
        if not self._rocs:
            self._rocs = [ROC(self.threshold_steps) for _ in range(c)]
        lab2 = labels.reshape(-1, c)
        pr2 = probs.reshape(-1, c)
        m = None if mask is None else _host(mask).reshape(-1)
        for i in range(c):
            self._rocs[i].eval(lab2[:, i], pr2[:, i], mask=m)

    @property
    def num_classes(self) -> int:
        return len(self._rocs)

    def calculate_auc(self, cls: int) -> float:
        return self._rocs[cls].calculate_auc()

    def calculate_average_auc(self) -> float:
        return float(np.mean([r.calculate_auc() for r in self._rocs]))

    def get_roc_curve(self, cls: int):
        return self._rocs[cls].get_roc_curve()
