"""PyTorch port, the line-search optimizers on the CPU against the JAX
package (twins of `tests/test_solvers.py`): line gradient descent,
conjugate gradient and L-BFGS on its least-squares problem, iteration by
iteration against JAX's own trajectories, the L-BFGS classifier, the
graph solver, maximisation, and the backtracking search alone.

`tests/test_solvers.py::test_cg_converges_faster_than_plain_line_search`
fails in the JAX package (its ordering gate); the port is held to the JAX
solvers' trajectories, not to that ordering. Tolerances, stated per check:
each iteration's score within 1e-4 of JAX's, relative to the score (the
least-squares scores fall from ~1 to ~1e-4, and a line search compares
float32 scores of two implementations to pick its step), and the final
parameters within 1e-4.
"""
import numpy as np
import pytest

import deeplearning4j_tpu as jx
from deeplearning4j_tpu.nn.conf import OptimizationAlgorithm as JaxOA
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.optimize.solvers import \
    BackTrackLineSearch as JaxBackTrack
import deeplearning4j_tpu_torch as pt
from deeplearning4j_tpu_torch.nn.conf import OptimizationAlgorithm
from deeplearning4j_tpu_torch.optimize.solvers import BackTrackLineSearch
from jax_reference import jax_init
from torch_graph_pair import np_tree, port_twin, tree_close
from torch_threads import one_torch_thread  # noqa: F401

TRAJ_TOL = 1e-4
ALGOS = [OptimizationAlgorithm.CONJUGATE_GRADIENT, OptimizationAlgorithm.LBFGS,
         OptimizationAlgorithm.LINE_GRADIENT_DESCENT]


def _lstsq_problem(seed=0, n=64, d=8):
    """test_solvers.py's problem: a linear least-squares fit with a known
    optimum (its mean squared residual)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float64)
    w_true = rng.normal(size=(d, 1)).astype(np.float64)
    y = x @ w_true + 0.01 * rng.normal(size=(n, 1))
    w_opt, *_ = np.linalg.lstsq(x, y, rcond=None)
    resid = y - x @ w_opt
    return (x.astype(np.float32), y.astype(np.float32),
            float(np.mean(resid ** 2)))


def _linear_pair(algo, seed=1, minimize=True):
    conf = (jx.NeuralNetConfiguration.builder().seed(seed)
            .optimization_algo(algo).max_num_line_search_iterations(8)
            .minimize(minimize).list()
            .layer(jx.OutputLayer(n_out=1, activation="identity", loss="mse",
                                  has_bias=False))
            .set_input_type(jx.InputType.feed_forward(8)).build())
    jnet = jx.MultiLayerNetwork(conf).init()
    net = pt.MultiLayerNetwork(
        pt.MultiLayerConfiguration.from_json(conf.to_json()),
        device="cpu").init()
    return jnet, pt.from_jax_params(net, np_tree(jnet.params))


def _close(score, jscore, what):
    assert abs(score - jscore) <= TRAJ_TOL * max(abs(jscore), 1e-3), \
        (what, score, jscore)


@pytest.mark.parametrize("algo", ALGOS)
def test_solver_trajectory_on_the_lstsq_problem_matches_jax(algo):
    """60 iterations on one batch (test_solvers.py's gate): every score
    against JAX's, the final parameters, and both within 5 % of the
    least-squares optimum."""
    x, y, opt_loss = _lstsq_problem()
    jnet, net = _linear_pair(algo)
    jds, ds = jx.DataSet(x, y), pt.DataSet(x, y)
    for i in range(60):
        jnet.fit(jds)
        net.fit(ds)
        _close(net.score(), float(jnet.score()), f"{algo} iteration {i}")
    np.testing.assert_allclose(net.params[0]["W"].numpy(),
                               np.asarray(jnet.params[0]["W"]), rtol=0,
                               atol=TRAJ_TOL)
    assert net.score() <= opt_loss * 1.05 + 1e-6
    assert float(jnet.score()) <= opt_loss * 1.05 + 1e-6


def test_cg_and_line_gradient_descent_at_fifteen_iterations_match_jax():
    """The reference's ordering gate's setting (seed 0, 15 iterations):
    the port's CG and LGD scores equal JAX's, whatever their order."""
    x, y, opt_loss = _lstsq_problem(seed=0)
    for algo in (OptimizationAlgorithm.CONJUGATE_GRADIENT,
                 OptimizationAlgorithm.LINE_GRADIENT_DESCENT):
        jnet, net = _linear_pair(algo)
        for _ in range(15):
            jnet.fit(jx.DataSet(x, y))
            net.fit(pt.DataSet(x, y))
        _close(net.score(), float(jnet.score()), algo)


def test_lbfgs_trains_classifier_like_jax():
    """test_solvers.py's L-BFGS classifier (Dense(12, tanh) + softmax, 40
    iterations): every score against JAX's, and accuracy >= 0.95."""
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.normal(-1.5, 1, (60, 6)),
                        rng.normal(1.5, 1, (60, 6))]).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[np.array([0] * 60 + [1] * 60)]
    conf = (jx.NeuralNetConfiguration.builder().seed(2)
            .optimization_algo(JaxOA.LBFGS).list()
            .layer(jx.DenseLayer(n_out=12, activation="tanh"))
            .layer(jx.OutputLayer(n_out=2, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(jx.InputType.feed_forward(6)).build())
    jnet = jx.MultiLayerNetwork(conf).init()
    net = pt.from_jax_params(pt.MultiLayerNetwork(
        pt.MultiLayerConfiguration.from_json(conf.to_json()),
        device="cpu").init(), np_tree(jnet.params))
    for i in range(40):
        jnet.fit(jx.DataSet(x, y))
        net.fit(pt.DataSet(x, y))
        _close(net.score(), float(jnet.score()), f"iteration {i}")
    acc = net.evaluate(pt.ArrayDataSetIterator(x, y, batch_size=60))
    assert acc.accuracy() >= 0.95


def test_graph_line_search_solver_matches_jax():
    """test_solvers.py's graph case (CG, 40 iterations, seed 7): every
    score against JAX's, and within 5 % of the optimum."""
    x, y, opt_loss = _lstsq_problem(seed=7)
    b = (jx.NeuralNetConfiguration.builder().seed(4)
         .optimization_algo(JaxOA.CONJUGATE_GRADIENT)
         .graph_builder().add_inputs("in"))
    b.add_layer("out", jx.OutputLayer(n_out=1, activation="identity",
                                      loss="mse", has_bias=False), "in")
    b.set_outputs("out")
    b.set_input_types(jx.InputType.feed_forward(8))
    jg = jax_init(JaxGraph(b.build()))
    g = port_twin(jg)
    for i in range(40):
        jg.fit(jx.DataSet(x, y))
        g.fit(pt.DataSet(x, y))
        _close(g.score(), float(jg.score()), f"iteration {i}")
    tree_close(g.params, np_tree(jg.params), TRAJ_TOL)
    assert g.score() <= opt_loss * 1.05 + 1e-6


@pytest.mark.parametrize("algo", ALGOS)
def test_maximising_line_search_matches_jax(algo):
    """minimize(False) line-searches the negated score: the score climbs,
    as JAX's does, iteration by iteration."""
    x, y, _ = _lstsq_problem(seed=9)
    jnet, net = _linear_pair(algo, minimize=False)
    first = None
    for i in range(5):
        jnet.fit(jx.DataSet(x, y))
        net.fit(pt.DataSet(x, y))
        _close(net.score(), float(jnet.score()), f"{algo} iteration {i}")
        first = net.score() if first is None else first
    assert net.score() > first


def test_sgd_path_unchanged():
    """The default algorithm still takes the updater step (no solver)."""
    x, y, _ = _lstsq_problem(seed=9)
    conf = (pt.NeuralNetConfiguration.builder().seed(1).list()
            .layer(pt.OutputLayer(n_out=1, activation="identity", loss="mse"))
            .set_input_type(pt.InputType.feed_forward(8)).build())
    m = pt.MultiLayerNetwork(conf, device="cpu").init()
    s0 = None
    for _ in range(20):
        m.fit(pt.DataSet(x, y))
        s0 = m.score() if s0 is None else s0
    assert m.score() < s0 and m._line_solver is None


@pytest.mark.parametrize("f,f0,gd,tries", [
    (lambda a: (a - 0.6) ** 2, 0.36, -1.2, 8),     # Armijo accepts alpha 1
    (lambda a: 1.0 + a, 1.0, -0.1, 5),             # every trial ascends
    (lambda a: (a - 0.05) ** 2 - 0.0025 * a, 0.0025, -0.1025, 8),
    (lambda a: float("nan") if a > 0.3 else (a - 0.2) ** 2, 0.04, -0.4, 6)])
def test_backtrack_line_search_matches_jax(f, f0, gd, tries):
    want = JaxBackTrack(max_iterations=tries).optimize(f, f0, gd)
    got = BackTrackLineSearch(max_iterations=tries).optimize(f, f0, gd)
    assert got == want
    alpha, fa = got
    assert alpha == 0.0 or fa <= f0 + 1e-4 * alpha * gd or fa < f0


def test_tree_helpers_walk_a_model_tree_in_jax_leaf_order():
    """The solvers' dot products and steps walk a whole model's tree
    through `nn/trees.py`: a network's tuple of layer dicts, a graph's dict
    of vertex trees, lists, nested dicts. The leaves come in JAX's pytree
    order and `tree_map` keeps the containers (exact)."""
    import jax
    import torch

    from deeplearning4j_tpu_torch.nn.trees import flat_leaves, tree_map
    t = lambda *v: torch.tensor(v, dtype=torch.float32)
    tree = ({"W": t(1.0), "b": t(2.0)}, {},
            {"fwd": {"W": t(3.0), "RW": t(4.0)}, "bwd": {"W": t(5.0)}},
            [t(6.0), (t(7.0), {"z": t(8.0), "a": t(9.0)})])
    want = [float(v) for v in jax.tree_util.tree_leaves(
        tree_map(lambda v: np.float32(v.item()), tree))]
    assert [float(v) for v in flat_leaves(tree)] == want
    doubled = tree_map(lambda a, b: a + b, tree, tree)
    assert type(doubled) is tuple and type(doubled[3]) is list
    assert type(doubled[3][1]) is tuple and doubled[1] == {}
    assert [float(v) for v in flat_leaves(doubled)] == [2 * v for v in want]
    graph = {"out": {"W": t(1.0)}, "dense": {"b": t(2.0), "W": t(3.0)}}
    assert [float(v) for v in flat_leaves(graph)] == [3.0, 2.0, 1.0]
