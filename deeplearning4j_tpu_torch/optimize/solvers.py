"""Line-search optimizers: the port of `deeplearning4j_tpu/optimize/solvers.py`
(backtracking line search, line gradient descent, Polak-Ribiere conjugate
gradient, L-BFGS), selected by `optimization_algo`.

A batch is: the score and gradient at the current parameters (autograd of
the model's `_loss_fn`), a direction, Armijo backtracking along it (a few
score evaluations at trial steps) and the step. Directions and dot
products are tree operations on the device; the backtracking decisions are
host scalars, as in JAX. Dot products are float32, summed leaf by leaf in
JAX's leaf order (dicts by sorted key, tuples in order). Every evaluation
of one batch draws the same dropout masks: the model's generators are set
back to their state at the batch's start before each one.
"""
from __future__ import annotations

import math
from collections import deque

import torch

from ..nn.remat import as_generators
from ..nn.trees import flat_leaves, tree_map

__all__ = ["BackTrackLineSearch", "LineSearchSolver",
           "GraphLineSearchSolver"]


def _tree_dot(a, b) -> torch.Tensor:
    total = None
    for x, y in zip(flat_leaves(a), flat_leaves(b)):
        part = torch.dot(x.to(torch.float32).reshape(-1),
                         y.to(torch.float32).reshape(-1))
        total = part if total is None else total + part
    return total


def _axpy(alpha, d, p):
    """p + alpha * d over trees."""
    return tree_map(lambda pi, di: pi + alpha * di, p, d)


def _scale(alpha, d):
    return tree_map(lambda di: alpha * di, d)


class BackTrackLineSearch:
    """Armijo backtracking: shrink alpha by `tau` until f(p + alpha d) <=
    f0 + c1 alpha g.d, at most `max_iterations` trials. Returns (alpha,
    f_alpha); (0, f0) when no trial improves, and the caller then keeps
    the parameters."""

    def __init__(self, max_iterations: int = 5, c1: float = 1e-4,
                 tau: float = 0.5, initial_step: float = 1.0):
        self.max_iterations = int(max_iterations)
        self.c1 = float(c1)
        self.tau = float(tau)
        self.initial_step = float(initial_step)

    def optimize(self, f, f0: float, gd: float):
        """f(alpha) -> loss at p + alpha d; gd = g.d (< 0 for a descent
        direction)."""
        alpha = self.initial_step
        best = (0.0, f0)
        for _ in range(self.max_iterations):
            fa = float(f(alpha))
            if fa <= f0 + self.c1 * alpha * gd and math.isfinite(fa):
                return alpha, fa
            if math.isfinite(fa) and fa < best[1]:
                best = (alpha, fa)
            alpha *= self.tau
        return best


class LineSearchSolver:
    """Per-batch optimizer for LINE_GRADIENT_DESCENT / CONJUGATE_GRADIENT
    / LBFGS on a MultiLayerNetwork. Keeps the algorithm's memory (previous
    gradient and direction, the L-BFGS (s, y) history) across batches;
    `reset()` clears it."""

    def __init__(self, model, algo: str, max_line_search_iterations: int = 5,
                 lbfgs_memory: int = 10):
        self.model = model
        self.algo = algo
        self.line_search = BackTrackLineSearch(
            max_iterations=max_line_search_iterations)
        self.lbfgs_memory = int(lbfgs_memory)
        self.reset()

    def reset(self):
        self._prev_g = None
        self._prev_d = None
        self._history = deque(maxlen=self.lbfgs_memory)   # (s, y) pairs

    @property
    def _sign(self) -> float:
        # minimize=False line-searches the negated score
        return 1.0 if self.model.conf.conf.minimize else -1.0

    def _loss(self, params, state, x, y, gens, fmask, lmask):
        """(score, new_state) of the model's loss."""
        score, (new_state, _) = self.model._loss_fn(
            params, state, x, y, gens, fmask, lmask)
        return score, new_state

    def _vag(self, params, state, x, y, gens, fmask, lmask):
        """(sign f, new state, sign grad) at `params`."""
        p = tree_map(lambda v: v.detach().requires_grad_(), params)
        leaves = flat_leaves(p)
        with torch.enable_grad():
            f, new_state = self._loss(p, state, x, y, gens, fmask, lmask)
            grads = torch.autograd.grad(f, leaves, allow_unused=True)
        by_leaf = {id(v): (torch.zeros_like(v) if d is None else d)
                   for v, d in zip(leaves, grads)}
        g = tree_map(lambda v: self._sign * by_leaf[id(v)], p)
        return self._sign * float(f.detach()), new_state, g

    def _loss_at(self, alpha, params, d, state, x, y, gens, fmask, lmask):
        with torch.no_grad():
            f, _ = self._loss(_axpy(alpha, d, params), state, x, y, gens,
                              fmask, lmask)
        return self._sign * float(f)

    # -- directions -----------------------------------------------------
    def _direction(self, g):
        from ..nn.conf import OptimizationAlgorithm as OA

        neg_g = _scale(-1.0, g)
        if self.algo == OA.LINE_GRADIENT_DESCENT:
            return neg_g
        if self.algo == OA.CONJUGATE_GRADIENT:
            if self._prev_g is None:
                return neg_g
            # Polak-Ribiere with automatic restart (beta < 0 -> steepest)
            num = float(_tree_dot(g, tree_map(lambda a, b: a - b, g,
                                          self._prev_g)))
            den = float(_tree_dot(self._prev_g, self._prev_g))
            beta = max(0.0, num / den) if den > 0 else 0.0
            return _axpy(beta, self._prev_d, neg_g)
        if self.algo == OA.LBFGS:
            if not self._history:
                return neg_g
            q = g                                   # two-loop recursion
            alphas = []
            for s, yv in reversed(self._history):
                rho = 1.0 / float(_tree_dot(yv, s))
                a = rho * float(_tree_dot(s, q))
                alphas.append((a, rho, s, yv))
                q = _axpy(-a, yv, q)
            s_last, y_last = self._history[-1]
            gamma = float(_tree_dot(s_last, y_last)) / float(
                _tree_dot(y_last, y_last))
            r = _scale(gamma, q)
            for a, rho, s, yv in reversed(alphas):
                b = rho * float(_tree_dot(yv, r))
                r = _axpy(a - b, s, r)
            return _scale(-1.0, r)
        raise ValueError(f"No line-search direction for algorithm "
                         f"'{self.algo}'")

    # -- one batch ------------------------------------------------------
    def fit_batch(self, params, state, x, y, gens, fmask, lmask):
        """Returns (new params, new state, score)."""
        from ..nn.conf import OptimizationAlgorithm as OA

        params = tree_map(torch.Tensor.detach, params)
        draws = as_generators(gens)
        start = [g.get_state() for g in draws]

        def rewind():
            for g, s in zip(draws, start):
                g.set_state(s)

        f0, new_state, g = self._vag(params, state, x, y, gens, fmask, lmask)
        after = [gen.get_state() for gen in draws]
        d = self._direction(g)
        gd = float(_tree_dot(g, d))
        if gd >= 0:     # not a descent direction: restart memory, use -g
            self.reset()
            d = _scale(-1.0, g)
            gd = -float(_tree_dot(g, g))

        def f(a):
            rewind()
            return self._loss_at(a, params, d, state, x, y, gens, fmask,
                                 lmask)
        alpha, f_alpha = self.line_search.optimize(f, f0, gd)
        if alpha > 0.0:
            new_params = _axpy(alpha, d, params)
        else:
            new_params = params
            f_alpha = f0
        if self.algo == OA.CONJUGATE_GRADIENT:
            self._prev_g, self._prev_d = g, d
        elif self.algo == OA.LBFGS and alpha > 0.0:
            # curvature pair from one more gradient at the accepted point
            s = _scale(alpha, d)
            rewind()
            _, _, g_new = self._vag(new_params, state, x, y, gens, fmask,
                                    lmask)
            yv = tree_map(lambda a, b: a - b, g_new, g)
            if float(_tree_dot(s, yv)) > 1e-10:   # keep B positive-definite
                self._history.append((s, yv))
        for gen, st in zip(draws, after):
            gen.set_state(st)
        # the raw score: internal values are sign-flipped when maximizing
        return new_params, new_state, self._sign * f_alpha


class GraphLineSearchSolver(LineSearchSolver):
    """The ComputationGraph variant: inputs, labels and masks are dicts,
    and the graph's `_loss_fn` returns (score, new_state)."""

    def _loss(self, params, state, inputs, labels, gens, fmasks, lmasks):
        return self.model._loss_fn(params, state, inputs, labels, gens,
                                   fmasks, lmasks)
