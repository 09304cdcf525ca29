"""JAX reference computations shared by the PyTorch port's test modules,
made cheap: each is computed once per test process and reused, and a
gradient is one jitted call instead of op-by-op dispatch.

  * `jax_init(jnet)` initialises a JAX MultiLayerNetwork or
    ComputationGraph as JAX's own `init` does, once per configuration (a
    configuration that differs only in its updater reuses it; the updater
    state is the net's own updater's). JAX's `init` is traced, not run:
    run, it draws op by op and compiles at every new shape (about 20
    compiles for a small network, ~27 s for GoogLeNet), and jitted, its
    random draws take seconds of multi-threaded compile. From the trace,
    the leaves that do not depend on the seed (layer state, constant
    biases, gamma and beta), the PRNG key `init` leaves and the input
    types it records are JAX's own, evaluated alone; the leaves JAX draws
    at random are the port's draw for the configuration. Before that, the
    port's `init` is held against the trace: the same tree paths, shapes
    and dtypes of parameters and layer state, and the deterministic
    leaves equal to JAX's.
  * `jax_value_and_grad(jnet, x, y, fmask, lmask)` is the score and the
    gradient tree of a MultiLayerNetwork's `_loss_fn`, through one
    `jax.jit` per configuration (the loss does not depend on the updater).

Op-by-op JAX dispatch runs each operation on the CPU client's worker
threads while the Python thread dispatches the next, so it keeps about two
cores busy per test process; a jitted call and a reused result do not."""
import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
from jax._src.interpreters import partial_eval as pe
from jax.extend import core as jcore

_INITS = {}
_GRADS = {}


def _copy(tree):
    return jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True), tree)


def _strip_updaters(obj):
    if isinstance(obj, dict):
        return {k: ("updater" if k == "__updater__" else _strip_updaters(v))
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_strip_updaters(v) for v in obj]
    return obj


def init_key(jnet) -> str:
    """The configuration's JSON with every updater masked: the part of it
    that decides the drawn parameters and the loss."""
    return type(jnet).__name__ + json.dumps(
        _strip_updaters(json.loads(jnet.conf.to_json())), sort_keys=True)


def _paths(tree, prefix=""):
    """[(path, leaf)] of a tree of dicts, tuples and lists."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in _paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in _paths(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def _seed_free_outputs(closed):
    """The indices of a traced function's outputs that do not depend on
    its inputs (a conservative reading: an equation's outputs depend on
    the inputs when any of its operands does)."""
    jaxpr = closed.jaxpr
    tainted = set(jaxpr.invars)
    for eqn in jaxpr.eqns:
        if any(not isinstance(v, jcore.Literal) and v in tainted
               for v in eqn.invars):
            tainted.update(eqn.outvars)
    return {i for i, v in enumerate(jaxpr.outvars)
            if isinstance(v, jcore.Literal) or v not in tainted}


def _jax_draw(jnet):
    """(params, state, PRNG key, input types) as JAX's `init` leaves them
    for `jnet`'s configuration, with the port's draw in the leaves JAX
    draws at random; the port's `init` checked against JAX's trace."""
    import deeplearning4j_tpu_torch as pt

    fresh = copy.copy(jnet)                     # the trace sets attributes

    def draw(seed):
        fresh.init(seed)
        return fresh.params, fresh.state, fresh._rng

    seed = jnet.conf.conf.seed
    closed, shapes = jax.make_jaxpr(draw, return_shape=True)(seed)
    input_types = getattr(fresh, "_input_types", None)
    n_out = len(closed.jaxpr.outvars)
    keep = _seed_free_outputs(closed)
    keep |= set(range(n_out - len(jax.tree_util.tree_leaves(shapes[2])),
                      n_out))                   # the key
    used = [i in keep for i in range(n_out)]
    pruned, used_in = pe.dce_jaxpr(closed.jaxpr, used, instantiate=True)
    assert len(pruned.constvars) == len(closed.consts)
    args = [seed] if used_in[0] else []
    vals = iter(jax.jit(jcore.jaxpr_as_fun(
        jcore.ClosedJaxpr(pruned, closed.consts)))(*args))
    jax_leaves = [next(vals) if u else None for u in used]
    jax_params, jax_state, rng = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(shapes),
        [v if v is not None else s for v, s in
         zip(jax_leaves, jax.tree_util.tree_leaves(shapes))])

    graph = hasattr(jnet.conf, "vertices")
    cls, conf_cls = ((pt.ComputationGraph, pt.ComputationGraphConfiguration)
                     if graph else
                     (pt.MultiLayerNetwork, pt.MultiLayerConfiguration))
    net = cls(conf_cls.from_json(jnet.conf.to_json()), device="cpu").init()
    out = []
    for what, port, want in (("params", net.params, jax_params),
                             ("state", net.state, jax_state)):
        got, exp = _paths(port), _paths(want)
        assert [p for p, _ in got] == [p for p, _ in exp], (
            what, [p for p, _ in got], [p for p, _ in exp])
        leaves = []
        for (path, g), (_, w) in zip(got, exp):
            g = g.detach().cpu().numpy()
            assert g.shape == tuple(w.shape), (what, path, g.shape, w.shape)
            assert g.dtype == np.dtype(w.dtype), (what, path, g.dtype,
                                                  w.dtype)
            if isinstance(w, jax.ShapeDtypeStruct):      # drawn at random
                leaves.append(jnp.asarray(g))
            else:
                np.testing.assert_array_equal(
                    g, np.asarray(w), err_msg=f"port init {what}{path}")
                leaves.append(w)
        out.append(jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(want), leaves))
    return out[0], out[1], rng, input_types


def jax_init(jnet):
    """Initialise `jnet` as JAX's `init` does, from the draw its
    configuration got before when there is one."""
    key = init_key(jnet)
    hit = _INITS.get(key)
    if hit is None:
        hit = _INITS[key] = _jax_draw(jnet)
    params, state, jnet._rng, input_types = hit
    jnet.params, jnet.state = _copy(params), _copy(state)
    if input_types is not None:
        jnet._input_types = list(input_types)
    if isinstance(jnet.params, dict):                  # ComputationGraph
        jnet.updater_state = {
            name: jnet._layer_updater(jnet.conf.vertices[name]).init(p)
            for name, p in jnet.params.items()}
    else:
        jnet.updater_state = tuple(
            jnet._layer_updater(layer).init(p)
            for layer, p in zip(jnet.layers, jnet.params))
    return jnet


def jax_value_and_grad(jnet, x, y, fmask=None, lmask=None, params=None):
    """(score, gradient tree) of a JAX MultiLayerNetwork's `_loss_fn` at
    `params` (its own when None), jitted once per configuration."""
    key = init_key(jnet)
    fn = _GRADS.get(key)
    if fn is None:
        def loss(p, s, x_, y_, fm, lm):
            return jnet._loss_fn(p, s, x_, y_, None, fmask=fm, lmask=lm)[0]
        fn = _GRADS[key] = jax.jit(jax.value_and_grad(loss))
    a = lambda v: None if v is None else jnp.asarray(v)
    s, g = fn(jnet.params if params is None else params, jnet.state, a(x),
              a(y), a(fmask), a(lmask))
    return float(s), g
