"""Helpers shared by the PyTorch port's ComputationGraph tests: a JAX graph
and its port twin with the same parameters, gradients of both, and tree
comparison.

The port's graph is built from the JAX configuration's JSON and takes the
JAX parameters, layer state and updater state through `from_jax_params`,
so both sides start from the same numbers (the JAX graph initialised by
`jax_reference.jax_init`, JAX's own `init`). The JAX gradients come from a
jitted `jax.value_and_grad` of the graph's `_loss_fn` (one compile per
configuration and shapes, shared by every graph of that configuration)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from deeplearning4j_tpu_torch import from_jax_params
from deeplearning4j_tpu_torch.nn.conf.graph import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.trees import flat_leaves, tree_map
from jax_reference import init_key


def np_tree(tree):
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(np_tree(v) for v in tree)
    return np.asarray(tree)


def port_twin(jg, device="cpu"):
    """The port's graph from the JAX graph's JSON, with its parameters,
    layer state and updater state."""
    g = ComputationGraph(
        ComputationGraphConfiguration.from_json(jg.conf.to_json()),
        device=device).init()
    return from_jax_params(g, np_tree(jg.params), np_tree(jg.updater_state),
                           np_tree(jg.state))


def tree_close(got, want, atol, msg="", rtol=0.0):
    if isinstance(want, dict):
        assert set(got) == set(want), (msg, sorted(got), sorted(want))
        for k in want:
            tree_close(got[k], want[k], atol, f"{msg}/{k}", rtol)
        return
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), msg
        for i, (g, w) in enumerate(zip(got, want)):
            tree_close(g, w, atol, f"{msg}/{i}", rtol)
        return
    if isinstance(got, torch.Tensor):
        got = got.detach().to(torch.float32).cpu().numpy()
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=msg)


def grads_close(got, want, tol, msg=""):
    """Per tensor, |port - JAX| <= tol x the tensor's largest JAX entry."""
    if isinstance(want, dict):
        assert set(got) == set(want), (msg, sorted(got), sorted(want))
        for k in want:
            grads_close(got[k], want[k], tol, f"{msg}/{k}")
        return
    want = np.asarray(want, np.float32)
    got = got.detach().to(torch.float32).cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=msg)


def as_dicts(g, inputs, labels=None, fmasks=None, lmasks=None):
    """Graph-keyed dicts of float32 numpy arrays from lists."""
    ins, outs = g.conf.network_inputs, g.conf.network_outputs
    d = lambda names, arrs: (None if arrs is None else
                             {n: (None if a is None else
                                  np.asarray(a, np.float32))
                              for n, a in zip(names, arrs)})
    return (d(ins, inputs), d(outs, labels), d(ins, fmasks),
            d(outs, lmasks))


_JAX_VG = {}


def jax_grads(jg, inputs, labels, fmasks=None, lmasks=None, train=True):
    """(score, gradient tree) of the JAX graph's `_loss_fn` (no dropout
    key), jitted once per configuration."""
    key = (init_key(jg), bool(train))
    fn = _JAX_VG.get(key)
    if fn is None:
        def loss(p, s, i, l, fm, lm):
            return jg._loss_fn(p, s, i, l, None, fmasks=fm, lmasks=lm,
                               train=train)[0]
        fn = _JAX_VG[key] = jax.jit(jax.value_and_grad(loss))
    a = lambda d: (None if d is None else
                   {k: (None if v is None else jnp.asarray(v))
                    for k, v in d.items()})
    s, g = fn(jg.params, jg.state, a(inputs), a(labels), a(fmasks),
                 a(lmasks))
    return float(s), g


def port_grads(g, inputs, labels, fmasks=None, lmasks=None, train=True):
    """(score, gradient tree) of the port graph's `_loss_fn`."""
    t = lambda d: (None if d is None else
                   {k: (None if v is None else g._as_input(v))
                    for k, v in d.items()})
    params = tree_map(lambda v: v.detach().requires_grad_(), g.params)
    leaves = flat_leaves(params)
    score, _ = g._loss_fn(params, g.state, t(inputs), t(labels), None,
                          t(fmasks), t(lmasks), train=train)
    found = torch.autograd.grad(score, leaves, allow_unused=True)
    by_leaf = {id(v): (torch.zeros_like(v) if d is None else d)
               for v, d in zip(leaves, found)}
    return float(score.detach()), tree_map(lambda v: by_leaf[id(v)], params)
