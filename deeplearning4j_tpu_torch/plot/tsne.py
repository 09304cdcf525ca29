"""t-SNE embedding visualization: the port of `deeplearning4j_tpu/plot/tsne.py`
(reference `deeplearning4j-core/.../plot/BarnesHutTsne.java:64` /
`Tsne.java`: perplexity-calibrated P matrix, early exaggeration, momentum
gradient descent, gain adaptation; van der Maaten's reference schedule).

`Tsne` is exact and runs on the device, as JAX's runs its dense [N, N]
kernels on the accelerator: the P matrix's per-row perplexity search and
every step are torch ops on `device` (the GPU unless the caller asks for
the CPU). The step loop reads nothing on the host until the end, where the
embedding and the last step's KL come back (`host_reads`).

The JAX package's exact `_p_matrix` sets the diagonal of the distances to
infinity before its search, so each row's entropy reads `inf * 0 = NaN`,
every search halves its beta 50 times and P comes out uniform. This port
computes what the docstring above promises: each row's search runs over
the row's N - 1 other points, so its entropy reaches log(perplexity)
(ROADMAP, "Known reference defects"), and over distances taken from the
row's nearest neighbour's, so float32 does not underflow on wide data.

`BarnesHutTsne` stays on the host (numpy, VP and space-partitioning
trees), as JAX and the reference place it.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..clustering.sptree import SpTree
from ..clustering.vptree import VPTree
from ..util.host import host_array
from ..util.platform import DeviceLike, as_device_input, resolve_device

__all__ = ["Tsne", "BarnesHutTsne", "export_tsne_html", "row_entropy"]

SEARCH_ROWS = 2048      # rows of the [N, N] distances searched at once


def _hbeta(d, beta, diag):
    """Entropy and normalised affinities of rows `d` [b, N] at `beta` [b, 1];
    `diag` [b, N] marks each row's own point, which takes no part."""
    p = torch.exp(-d * beta).masked_fill_(diag, 0.0)
    sum_p = p.sum(dim=1, keepdim=True).clamp_min(1e-12)
    h = torch.log(sum_p) + beta * (d * p).sum(dim=1, keepdim=True) / sum_p
    return h, p / sum_p


def _binary_search_perplexity(d, diag, perplexity, iters=50):
    """Per-row beta (1/2sigma^2) search so that H(P_i) = log(perplexity):
    JAX's bisection (`_binary_search_perplexity`), every row at once, with
    each row's own point left out."""
    target = math.log(perplexity)
    rows = d.shape[0]
    beta = torch.ones(rows, 1, dtype=d.dtype, device=d.device)
    lo = torch.zeros_like(beta)
    hi = torch.full_like(beta, math.inf)
    for _ in range(iters):
        h, _ = _hbeta(d, beta, diag)
        too_high = h > target
        lo = torch.where(too_high, beta, lo)
        hi = torch.where(too_high, hi, beta)
        beta = torch.where(
            too_high,
            torch.where(torch.isinf(hi), beta * 2.0, (beta + hi) / 2),
            torch.where(lo <= 0, beta / 2.0, (beta + lo) / 2))
    return _hbeta(d, beta, diag)[1]


def row_entropy(p_rows) -> torch.Tensor:
    """The entropy of each row of conditional affinities [b, N] (0 at the
    row's own point): log(perplexity) where the search converged."""
    tiny = torch.finfo(p_rows.dtype).tiny
    return -(p_rows * torch.log(p_rows.clamp_min(tiny))).sum(dim=1)


class Tsne:
    def __init__(self, max_iter: int = 500, perplexity: float = 30.0,
                 learning_rate: float = 200.0, n_components: int = 2,
                 momentum: float = 0.5, final_momentum: float = 0.8,
                 switch_momentum_iteration: int = 250,
                 stop_lying_iteration: int = 100, exaggeration: float = 12.0,
                 seed: int = 42, theta: float = 0.5,
                 device: DeviceLike = None):
        self.max_iter = int(max_iter)
        self.perplexity = float(perplexity)
        self.learning_rate = float(learning_rate)
        self.n_components = int(n_components)
        self.momentum = momentum
        self.final_momentum = final_momentum
        self.switch_momentum_iteration = switch_momentum_iteration
        self.stop_lying_iteration = stop_lying_iteration
        self.exaggeration = exaggeration
        self.seed = seed
        self.theta = theta  # API parity; exact gradients are used
        self.device = resolve_device(device)
        self.y: Optional[np.ndarray] = None
        self.host_reads = 0

    # ------------------------------------------------------------------
    def _search_rows(self, x, x_sq, r0: int, r1: int):
        """P(j | i) for rows r0..r1 of `x` [N, D] on its device: [r1 - r0, N],
        0 at each row's own point.

        Each row's distances are taken from its nearest neighbour's: the
        same P and entropy (the factor exp(-beta d_min) cancels). Without
        the shift float32's exp(-beta d) underflows once beta d passes ~87;
        the normaliser's floor then reads the underflowed, peaked row as a
        flat one and turns the bisection the wrong way (1,000 points in
        128-D: JAX's float32 search misses log 30 in 105 rows by up to
        0.63; `tests/test_torch_clustering.py` holds both searches)."""
        d = x_sq[r0:r1, None] + x_sq[None, :] - 2.0 * (x[r0:r1] @ x.T)
        diag = torch.zeros_like(d, dtype=torch.bool)
        diag[torch.arange(r1 - r0, device=x.device),
             torch.arange(r0, r1, device=x.device)] = True
        d.masked_fill_(diag, math.inf)
        d -= d.amin(dim=1, keepdim=True)
        d.masked_fill_(diag, 0.0)
        return _binary_search_perplexity(d, diag, self.perplexity)

    def conditional_p(self, x, rows: Optional[slice] = None) -> torch.Tensor:
        """The perplexity-calibrated conditional affinities P(j | i) of the
        rows `rows` of `x` (all by default) before symmetrisation, on the
        device: [b, N], 0 at each row's own point."""
        x = as_device_input(x, self.device)
        rows = rows or slice(0, x.shape[0])
        return self._search_rows(x, torch.sum(x * x, dim=1), rows.start,
                                 rows.stop)

    def _p_matrix(self, x):
        n = x.shape[0]
        x_sq = torch.sum(x * x, dim=1)
        p = torch.empty(n, n, dtype=x.dtype, device=x.device)
        for r0 in range(0, n, SEARCH_ROWS):
            r1 = min(n, r0 + SEARCH_ROWS)
            p[r0:r1] = self._search_rows(x, x_sq, r0, r1)
        p = (p + p.T) / (2.0 * n)
        return p.clamp_min_(1e-12)

    def _initial_y(self, n: int) -> torch.Tensor:
        """The start embedding on the CPU: 1e-4 * N(0, 1) from a
        `torch.Generator` seeded from `seed` (a test may hand JAX's in)."""
        g = torch.Generator().manual_seed(int(self.seed))
        return 1e-4 * torch.randn(n, self.n_components, generator=g,
                                  dtype=torch.float32)

    def _step(self, y, vel, gains, p, scale, momentum, want_kl):
        """One step at exaggeration `scale`; the KL only when asked (the
        loop reads the last step's)."""
        sq = torch.sum(y * y, dim=1)
        num = 1.0 / (1.0 + sq[:, None] + sq[None, :] - 2.0 * (y @ y.T))
        num.fill_diagonal_(0.0)
        q = (num / num.sum()).clamp_min_(1e-12)
        pq = (p * scale - q) * num
        grad = 4.0 * (pq.sum(dim=1, keepdim=True) * y - pq @ y)
        gains = torch.where(torch.sign(grad) != torch.sign(vel),
                            gains + 0.2, gains * 0.8).clamp_min_(0.01)
        vel = momentum * vel - self.learning_rate * gains * grad
        y = y + vel
        y = y - y.mean(dim=0)
        kl = None
        if want_kl:
            p_eff = p * scale
            kl = torch.sum(p_eff * torch.log(p_eff / q))
        return y, vel, gains, kl

    def fit_transform(self, x) -> np.ndarray:
        x = as_device_input(x, self.device)
        n = x.shape[0]
        p = self._p_matrix(x)
        y = self._initial_y(n).to(self.device)
        vel = torch.zeros_like(y)
        gains = torch.ones_like(y)
        kl = torch.full((), math.inf, device=self.device)
        for it in range(self.max_iter):
            scale = (self.exaggeration if it < self.stop_lying_iteration
                     else 1.0)
            momentum = (self.momentum if it < self.switch_momentum_iteration
                        else self.final_momentum)
            y, vel, gains, step_kl = self._step(
                y, vel, gains, p, scale, momentum,
                want_kl=it == self.max_iter - 1)
            if step_kl is not None:
                kl = step_kl
        # the embedding and the KL come back in one copy
        out = torch.cat([y.reshape(-1), kl.reshape(1)]).cpu().numpy()
        self.host_reads = 1
        self.y = out[:-1].reshape(n, self.n_components)
        self.kl_divergence = float(out[-1])
        return self.y

    fit = fit_transform

    def save_as_file(self, labels, path: str):
        """CSV export (reference saveAsFile): x,y[,z],label per row."""
        with open(path, "w") as f:
            for i, row in enumerate(self.y):
                coords = ",".join(f"{v:.6f}" for v in row)
                label = labels[i] if labels is not None and i < len(labels) else i
                f.write(f"{coords},{label}\n")


def _sparse_p(x: np.ndarray, perplexity: float, iters: int = 50):
    """kNN-sparse, symmetrized input similarities (the reference builds the
    same via VPTree + per-row beta search, `BarnesHutTsne.java:64`).
    Returns (rows, cols, values) of P_sym with sum(values) == 1."""
    n = x.shape[0]
    k = min(n - 1, int(3 * perplexity))
    tree = VPTree(x)
    rows = np.empty(n * k, dtype=np.int64)
    cols = np.empty(n * k, dtype=np.int64)
    vals = np.empty(n * k, dtype=np.float64)
    target = np.log(perplexity)
    for i in range(n):
        nbrs = tree.knn(x[i], k + 1)  # includes self at distance 0
        nbrs = [(d, j) for d, j in nbrs if j != i][:k]
        d2 = np.array([d * d for d, _ in nbrs])
        beta, lo, hi = 1.0, 0.0, np.inf
        p = np.exp(-d2 * beta)
        for _ in range(iters):
            sum_p = max(p.sum(), 1e-12)
            h = np.log(sum_p) + beta * float((d2 * p).sum()) / sum_p
            if abs(h - target) < 1e-5:
                break
            if h > target:
                lo = beta
                beta = beta * 2.0 if np.isinf(hi) else (beta + hi) / 2.0
            else:
                hi = beta
                beta = beta / 2.0 if lo <= 0 else (beta + lo) / 2.0
            p = np.exp(-d2 * beta)
        p = p / max(p.sum(), 1e-12)
        sl = slice(i * k, (i + 1) * k)
        rows[sl] = i
        cols[sl] = [j for _, j in nbrs]
        vals[sl] = p
    # symmetrize: P = (P + P^T) / (2N) over the union of edges
    edge = {}
    for r, c, v in zip(rows, cols, vals):
        edge[(r, c)] = edge.get((r, c), 0.0) + v
        edge[(c, r)] = edge.get((c, r), 0.0) + v
    r_out = np.array([rc[0] for rc in edge], dtype=np.int64)
    c_out = np.array([rc[1] for rc in edge], dtype=np.int64)
    v_out = np.array(list(edge.values()), dtype=np.float64) / (2.0 * n)
    v_out = np.maximum(v_out / v_out.sum(), 1e-12)
    return r_out, c_out, v_out


class BarnesHutTsne(Tsne):
    """O(N log N) Barnes-Hut t-SNE (`plot/BarnesHutTsne.java:64`): kNN-sparse
    input similarities from a VPTree, attractive forces over the sparse
    edges, repulsive forces via SpTree traversal with the `theta` criterion
    (theta=0 degenerates to exact). Host/NumPy — a visualization tool, same
    placement as the reference's CPU implementation. It has no device: a
    tensor on any device is copied to the host once."""

    def __init__(self, *args, **kwargs):
        # host numpy throughout: the device is the CPU's, never resolved
        super().__init__(*args, device="cpu", **kwargs)

    def fit_transform(self, x) -> np.ndarray:
        x = host_array(x, np.float64)
        n = x.shape[0]
        rows, cols, p_vals = _sparse_p(x, self.perplexity)
        rng = np.random.default_rng(self.seed)
        y = 1e-4 * rng.normal(size=(n, self.n_components))
        vel = np.zeros_like(y)
        gains = np.ones_like(y)

        for it in range(self.max_iter):
            exag = (self.exaggeration if it < self.stop_lying_iteration
                    else 1.0)
            momentum = (self.momentum if it < self.switch_momentum_iteration
                        else self.final_momentum)
            # attractive forces over sparse edges: p_ij q_ij (y_i - y_j)
            diff = y[rows] - y[cols]
            q = 1.0 / (1.0 + np.sum(diff * diff, axis=1))
            coef = (exag * p_vals * q)[:, None] * diff
            attr = np.zeros_like(y)
            np.add.at(attr, rows, coef)
            # repulsive forces via the space-partitioning tree
            tree = SpTree(y)
            rep = np.empty_like(y)
            sum_q = 0.0
            for i in range(n):
                neg, sq = tree.compute_non_edge_forces(i, self.theta)
                rep[i] = neg
                sum_q += sq
            grad = attr - rep / max(sum_q, 1e-12)
            gains = np.where(np.sign(grad) != np.sign(vel),
                             gains + 0.2, gains * 0.8)
            gains = np.maximum(gains, 0.01)
            vel = momentum * vel - self.learning_rate * gains * grad
            y = y + vel
            y = y - y.mean(axis=0)

        self.y = np.asarray(y, dtype=np.float32)
        # KL over the sparse edges (approximate, like the reference reports),
        # normalized by a tree built on the FINAL embedding so the number is
        # consistent with the returned y (and defined even for max_iter=0)
        final_tree = SpTree(y)
        sum_q = sum(final_tree.compute_non_edge_forces(i, self.theta)[1]
                    for i in range(n))
        diff = y[rows] - y[cols]
        qn = 1.0 / (1.0 + np.sum(diff * diff, axis=1))
        q_norm = np.maximum(qn / max(sum_q, 1e-12), 1e-12)
        self.kl_divergence = float(
            np.sum(p_vals * np.log(p_vals / q_norm)))
        return self.y

    fit = fit_transform

    def get_data(self) -> np.ndarray:
        return self.y


def export_tsne_html(coords, path: str, labels=None,
                     title: str = "t-SNE"):
    """Scatter-plot an embedding to a standalone HTML file (the reference
    UI's TsneModule view, `module/tsne/TsneModule.java`), colored by label
    when given."""
    from ..ui.components import ChartScatter, StyleChart, render_page

    coords = host_array(coords)
    chart = ChartScatter(title, StyleChart(600, 440))
    if labels is None:
        chart.add_series("points", coords[:, 0], coords[:, 1])
    else:
        labels = host_array(labels)
        for lab in np.unique(labels):
            m = labels == lab
            chart.add_series(str(lab), coords[m, 0], coords[m, 1])
    with open(path, "w") as f:
        f.write(render_page(title, [chart]))
