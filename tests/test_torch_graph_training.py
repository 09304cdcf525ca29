"""PyTorch port, ComputationGraph training on the CPU against the JAX
package: one step of each of the 8 updaters on a graph, l1 / l2 with a
bias learning rate, gradient normalization and an lr schedule, a 20-step
trajectory over an iterator of MultiDataSets (scores collected by the
listeners of both packages), a multi-output graph, `evaluate` and
`score_examples` over an iterator, an encoder-decoder graph in the shape
of dl4j-examples' AdditionRNN (two sequence inputs, GravesLSTM ->
LastTimeStepVertex -> DuplicateToTimeSeriesVertex -> MergeVertex ->
GravesLSTM -> RnnOutputLayer), and the bf16 two-branch BatchNormalization
graph of the card's main path 10 at narrow widths.

Parameters, updater state and layer state cross through
`from_jax_params`; the same numpy batches feed both sides. Tolerances,
stated per check: float32 one step 1e-5, trajectories 1e-4 (the parity
gate's); bf16 compute (ROADMAP's defaults, as the BN-MLP's test): first-
step gradients 2e-2 of each tensor's largest entry, scores 2e-2, and
parameters 5e-2 relative L2 per tensor after the steps.
"""
import jax
import numpy as np
import pytest
import torch

import deeplearning4j_tpu as jx
from deeplearning4j_tpu.datasets.iterators import \
    ExistingDataSetIterator as JaxExisting
from deeplearning4j_tpu.nn import updaters as jax_updaters
from deeplearning4j_tpu.nn.conf import graph as jgraph
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.optimize import listeners as jax_listeners
import deeplearning4j_tpu_torch as pt
from deeplearning4j_tpu_torch.datasets.iterators import \
    ExistingDataSetIterator
from deeplearning4j_tpu_torch.kernels import bn_relu
from deeplearning4j_tpu_torch.nn.trees import flat_leaves
from deeplearning4j_tpu_torch.optimize import listeners
from jax_reference import jax_init
from torch_graph_pair import (as_dicts, grads_close, jax_grads, np_tree,
                              port_grads, port_twin, tree_close)
from torch_threads import one_torch_thread  # noqa: F401

STEP_TOL, TRAJ_TOL = 1e-5, 1e-4
BF16 = {"grad": 2e-2, "score": 2e-2, "param_l2": 5e-2}
UPDATERS = [("Sgd", {"learning_rate": 0.1}), ("Adam", {"learning_rate": 1e-2}),
            ("AdaMax", {"learning_rate": 1e-2}),
            ("AdaGrad", {"learning_rate": 0.1}), ("AdaDelta", {}),
            ("RmsProp", {"learning_rate": 1e-2}),
            ("Nesterovs", {"learning_rate": 0.1, "momentum": 0.9}),
            ("NoOp", {})]


def _data(seed, n=12):
    r = np.random.default_rng(seed)
    return (r.normal(size=(n, 4)).astype(np.float32),
            r.normal(size=(n, 6)).astype(np.float32),
            np.eye(2, dtype=np.float32)[r.integers(0, 2, n)])


def _merge_graph(updater, **glob):
    """Two inputs, a Dense branch each, Merge + ElementWise(add), output."""
    b = jx.NeuralNetConfiguration.builder().seed(2).updater(updater)
    for k, v in glob.items():
        b = getattr(b, k)(*v) if isinstance(v, tuple) else getattr(b, k)(v)
    b = (b.graph_builder().add_inputs("a", "b")
         .add_layer("da", jx.DenseLayer(n_out=6, activation="tanh"), "a")
         .add_layer("db", jx.DenseLayer(n_out=6, activation="tanh"), "b")
         .add_vertex("m", jgraph.MergeVertex(), "da", "db")
         .add_vertex("s", jgraph.ElementWiseVertex("add"), "da", "db")
         .add_vertex("ms", jgraph.MergeVertex(), "m", "s")
         .add_layer("out", jx.OutputLayer(n_out=2, loss="mcxent"), "ms")
         .set_outputs("out")
         .set_input_types(jx.InputType.feed_forward(4),
                          jx.InputType.feed_forward(6)))
    return jax_init(JaxGraph(b.build()))


@pytest.mark.parametrize("name,kw", UPDATERS, ids=[u[0] for u in UPDATERS])
def test_one_step_of_each_updater_on_a_graph_matches_jax(name, kw):
    """One step, parameters and updater state within 1e-5; an updater
    whose first step divides a gradient by its own magnitude (AdaGrad,
    Adam-like) turns a gradient within rounding of 0 into a step of up to
    lr either way, so entries whose JAX gradient is below 1e-4 are held to
    2 lr, as ROADMAP's parity notes hold Adam's."""
    jg = _merge_graph(getattr(jax_updaters, name)(**kw))
    g = port_twin(jg)
    a, b, y = _data(1)
    _, jgr = jax_grads(jg, *as_dicts(jg, [a, b], [y])[:2])
    tiny = {n: [np.abs(np.asarray(v)) < 1e-4
                for v in jax.tree_util.tree_leaves(p)]
            for n, p in jgr.items()}
    jg.fit(jx.MultiDataSet(features=[a, b], labels=[y]))
    g.fit(pt.MultiDataSet(features=[a, b], labels=[y]))
    assert abs(g.score() - float(jg.score())) <= STEP_TOL
    lr = kw.get("learning_rate", 1.0)
    for n in jg.params:
        for got, want, near0 in zip(
                flat_leaves(g.params[n]),
                jax.tree_util.tree_leaves(jg.params[n]), tiny[n]):
            err = np.abs(got.numpy() - np.asarray(want))
            assert err[~near0].max(initial=0) <= STEP_TOL, (name, n)
            assert err[near0].max(initial=0) <= 2 * lr, (name, n)
    tree_close(g.updater_state, np_tree(jg.updater_state), STEP_TOL,
               f"{name} state")


def test_regularised_scheduled_step_matches_jax():
    """l1 / l2 on weights and biases, a layer's bias learning rate, l2
    gradient renormalisation per layer and an exponential lr schedule:
    three steps within 1e-5 of JAX."""
    jg = _merge_graph(jax_updaters.Nesterovs(0.1, 0.9), l1=1e-3, l2=1e-2,
                      l2_bias=1e-3, gradient_normalization=(
                          "renormalize_l2_per_layer",),
                      learning_rate_decay_policy=("exponential", 0.9))
    jg.conf.vertices["da"].bias_learning_rate = 0.02
    g = port_twin(jg)
    assert g.conf.vertices["da"].bias_learning_rate == 0.02
    a, b, y = _data(2)
    for _ in range(3):
        jg.fit(jx.MultiDataSet(features=[a, b], labels=[y]))
        g.fit(pt.MultiDataSet(features=[a, b], labels=[y]))
        assert abs(g.score() - float(jg.score())) <= STEP_TOL
    tree_close(g.params, np_tree(jg.params), STEP_TOL)


def _batches(seed, n_batches, rows):
    r = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        a, b, y = _data(int(r.integers(1 << 30)), rows)
        out.append((a, b, y))
    return out


def test_twenty_step_trajectory_over_an_iterator_matches_jax():
    """Adam 1e-2 over an iterator of 5 MultiDataSets, 4 epochs: the 20
    scores (collected by each package's CollectScoresIterationListener)
    and the final parameters and updater state within 1e-4."""
    jg = _merge_graph(jax_updaters.Adam(1e-2))
    g = port_twin(jg)
    data = _batches(3, 5, 8)
    jit = JaxExisting([jx.MultiDataSet(features=[a, b], labels=[y])
                       for a, b, y in data])
    it = ExistingDataSetIterator([pt.MultiDataSet(features=[a, b],
                                                  labels=[y])
                                  for a, b, y in data])
    jlog = jax_listeners.CollectScoresIterationListener()
    log = listeners.CollectScoresIterationListener()
    jg.set_listeners(jlog)
    g.set_listeners(log)
    jg.fit(jit, epochs=4)
    g.fit(it, epochs=4)
    assert g.iteration_count == jg.iteration_count == 20
    assert g.epoch_count == jg.epoch_count == 4
    assert [i for i, _ in log.scores] == [i for i, _ in jlog.scores]
    np.testing.assert_allclose([s for _, s in log.scores],
                               [s for _, s in jlog.scores], rtol=0,
                               atol=TRAJ_TOL)
    tree_close(g.params, np_tree(jg.params), TRAJ_TOL)
    tree_close(g.updater_state, np_tree(jg.updater_state), TRAJ_TOL)


def test_multi_output_graph_trains_like_jax():
    """test_graph.py's multi-output graph (softmax and mse heads on one
    shared layer): 20 SGD steps, scores and parameters within 1e-4."""
    def conf(m):
        return (m.NeuralNetConfiguration.builder().seed(0)
                .updater(m.Sgd(0.1)).graph_builder().add_inputs("in")
                .add_layer("shared", m.DenseLayer(n_out=8,
                                                  activation="relu"), "in")
                .add_layer("out1", m.OutputLayer(n_out=2, loss="mcxent"),
                           "shared")
                .add_layer("out2", m.OutputLayer(n_out=1,
                                                 activation="identity",
                                                 loss="mse"), "shared")
                .set_outputs("out1", "out2")
                .set_input_types(m.InputType.feed_forward(5)).build())
    jg = jax_init(JaxGraph(conf(jx)))
    g = port_twin(jg)
    r = np.random.default_rng(0)
    x = r.normal(size=(6, 5)).astype(np.float32)
    ys = [np.eye(2, dtype=np.float32)[r.integers(0, 2, 6)],
          r.normal(size=(6, 1)).astype(np.float32)]
    jm = jx.MultiDataSet(features=[x], labels=ys)
    m = pt.MultiDataSet(features=[x], labels=ys)
    assert abs(g.score(m) - jg.score(jm)) <= STEP_TOL
    for _ in range(20):
        jg.fit(jm)
        g.fit(m)
        assert abs(g.score() - float(jg.score())) <= TRAJ_TOL
    tree_close(g.params, np_tree(jg.params), TRAJ_TOL)
    for a, b in zip(g.output(x), jg.output(x)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=TRAJ_TOL)


def test_evaluate_and_score_examples_over_iterators_match_jax():
    """`evaluate` of a single-input graph over a DataSet iterator and of
    the merge graph over a MultiDataSet iterator; `score_examples` over an
    iterator, with and without the regularisation terms."""
    jg = _merge_graph(jax_updaters.Sgd(0.1), l2=1e-2)
    g = port_twin(jg)
    data = _batches(4, 3, 7)
    jit = JaxExisting([jx.MultiDataSet(features=[a, b], labels=[y])
                       for a, b, y in data])
    it = ExistingDataSetIterator([pt.MultiDataSet(features=[a, b],
                                                  labels=[y])
                                  for a, b, y in data])
    ev, jev = g.evaluate(it), jg.evaluate(jit)
    np.testing.assert_array_equal(ev.confusion.matrix, jev.confusion.matrix)
    assert ev.accuracy() == jev.accuracy()
    for reg in (True, False):
        np.testing.assert_allclose(g.score_examples(it, reg),
                                   np.asarray(jg.score_examples(jit, reg)),
                                   rtol=0, atol=STEP_TOL)
    single = (jx.NeuralNetConfiguration.builder().seed(1).graph_builder()
              .add_inputs("in")
              .add_layer("d", jx.DenseLayer(n_out=5, activation="tanh"),
                         "in")
              .add_layer("o", jx.OutputLayer(n_out=3), "d")
              .set_outputs("o").set_input_types(jx.InputType.feed_forward(4))
              .build())
    js = jax_init(JaxGraph(single))
    s = port_twin(js)
    r = np.random.default_rng(5)
    x = r.normal(size=(20, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[r.integers(0, 3, 20)]
    ev = s.evaluate(pt.ArrayDataSetIterator(x, y, batch_size=6))
    jev = js.evaluate(jx.ArrayDataSetIterator(x, y, batch_size=6))
    np.testing.assert_array_equal(ev.confusion.matrix, jev.confusion.matrix)


def _seq2seq(m, v, vocab=7, hidden=8, t=5):
    """dl4j-examples' AdditionRNN shape at narrow widths."""
    return (m.NeuralNetConfiguration.builder().seed(6)
            .updater(m.Adam(2e-2)).graph_builder()
            .add_inputs("encoderInput", "decoderInput")
            .add_layer("encoder", m.GravesLSTM(n_out=hidden), "encoderInput")
            .add_vertex("lastTimeStep", v.LastTimeStepVertex(), "encoder")
            .add_vertex("duplicateTimeStep", v.DuplicateToTimeSeriesVertex(),
                        "lastTimeStep", "decoderInput")
            .add_vertex("merge", v.MergeVertex(), "decoderInput",
                        "duplicateTimeStep")
            .add_layer("decoder", m.GravesLSTM(n_out=hidden), "merge")
            .add_layer("output", m.RnnOutputLayer(n_out=vocab,
                                                  activation="softmax",
                                                  loss="mcxent"), "decoder")
            .set_outputs("output")
            .set_input_types(m.InputType.recurrent(vocab, t),
                             m.InputType.recurrent(vocab, t))
            .build())


def test_seq2seq_graph_trains_and_steps_like_jax():
    """The encoder-decoder graph: JSON equal to JAX's, first-step gradients
    within 1e-5, 10 Adam steps within 1e-4, and `rnn_time_step` fed both
    sequences one step at a time equal to JAX's."""
    from deeplearning4j_tpu_torch.nn.conf import graph as pgraph
    jconf = _seq2seq(jx, jgraph)
    assert pt.ComputationGraphConfiguration.from_json(
        jconf.to_json()).to_json() == _seq2seq(pt, pgraph).to_json()
    jg = jax_init(JaxGraph(jconf))
    g = port_twin(jg)
    r = np.random.default_rng(7)
    eye = np.eye(7, dtype=np.float32)
    enc, dec, y = (eye[r.integers(0, 7, (6, 5))] for _ in range(3))
    _, jgr = jax_grads(jg, *as_dicts(jg, [enc, dec], [y])[:2])
    _, gr = port_grads(g, *as_dicts(g, [enc, dec], [y])[:2])
    tree_close(gr, np_tree(jgr), STEP_TOL)
    for _ in range(10):
        jg.fit(jx.MultiDataSet(features=[enc, dec], labels=[y]))
        g.fit(pt.MultiDataSet(features=[enc, dec], labels=[y]))
        assert abs(g.score() - float(jg.score())) <= TRAJ_TOL
    tree_close(g.params, np_tree(jg.params), TRAJ_TOL)
    for t in range(5):
        np.testing.assert_allclose(
            g.rnn_time_step(enc[:, t], dec[:, t]).numpy(),
            np.asarray(jg.rnn_time_step(enc[:, t], dec[:, t])), rtol=0,
            atol=TRAJ_TOL)


def _two_branch_bn(compute_dtype="bfloat16", width=16, n_in=12):
    """Main path 10's two-branch graph at narrow widths: two inputs, each
    Dense(identity) -> BatchNormalization(relu), Merge, softmax output."""
    v = jgraph
    b = jx.NeuralNetConfiguration.builder().seed(8).updater(
        jax_updaters.Adam(1e-3))
    if compute_dtype:
        b = b.compute_dtype(compute_dtype)
    b = (b.graph_builder().add_inputs("left", "right")
         .add_layer("dl", jx.DenseLayer(n_out=width, activation="identity"),
                    "left")
         .add_layer("bnl", jx.BatchNormalization(activation="relu"), "dl")
         .add_layer("dr", jx.DenseLayer(n_out=width, activation="identity"),
                    "right")
         .add_layer("bnr", jx.BatchNormalization(activation="relu"), "dr")
         .add_vertex("merge", v.MergeVertex(), "bnl", "bnr")
         .add_layer("out", jx.OutputLayer(n_out=3, activation="softmax",
                                          loss="mcxent"), "merge")
         .set_outputs("out")
         .set_input_types(jx.InputType.feed_forward(n_in),
                          jx.InputType.feed_forward(n_in)))
    return jax_init(JaxGraph(b.build()))


def test_bf16_two_branch_bn_graph_matches_jax():
    """bf16 compute: both BN vertices take the BN+ReLU tier on both sides
    (JAX's Pallas kernel in interpret mode, the port's plain versions on
    the CPU, no launch); first-step gradients within 2e-2 of each tensor's
    largest entry (a pre-BN bias, whose exact gradient is 0, within 2e-2
    of its W's largest gradient entry on both sides), three Adam steps'
    scores within 2e-2, parameters and
    running variances within 5e-2 relative L2 per tensor (relative to
    the larger of the tensor's norm and Adam's reach), the pre-BN biases,
    which Adam moves by rounding noise, within Adam's reach (lr a step) on
    both sides."""
    jg = _two_branch_bn()
    g = port_twin(jg)
    layer = g.conf.vertices["bnl"]
    x = torch.zeros(32, 16, dtype=torch.bfloat16)
    assert layer._helper(x, True) == "pallas"
    assert jg.conf.vertices["bnl"]._helper(
        jax.numpy.zeros((32, 16), jax.numpy.bfloat16), True) == "pallas"
    r = np.random.default_rng(9)
    left, right = (r.normal(size=(32, 12)).astype(np.float32)
                   for _ in range(2))
    y = np.eye(3, dtype=np.float32)[r.integers(0, 3, 32)]
    bn_relu.reset_launches()
    i, l, _, _ = as_dicts(jg, [left, right], [y])
    _, jgr = jax_grads(jg, i, l)
    _, gr = port_grads(g, i, l)
    for n in ("dl", "dr"):
        # a pre-BN bias (its exact gradient is 0): rounding noise, held to
        # the bf16 limit of its W's largest gradient entry on both sides
        w_scale = np.abs(np.asarray(jgr[n]["W"])).max()
        for t in (gr[n].pop("b").numpy(), np.asarray(jgr[n].pop("b"))):
            assert np.abs(t).max() <= BF16["grad"] * w_scale, n
    grads_close(gr, np_tree(jgr), BF16["grad"])
    for _ in range(3):
        jg.fit(jx.MultiDataSet(features=[left, right], labels=[y]))
        g.fit(pt.MultiDataSet(features=[left, right], labels=[y]))
        assert abs(g.score() - float(jg.score())) <= BF16["score"]
    assert set(bn_relu.launch_counts().values()) == {0}
    lr, steps = 1e-3, 3
    for n in ("dl", "dr"):      # noise-driven: within Adam's reach, each
        for b in (g.params[n]["b"].numpy(), np.asarray(jg.params[n]["b"])):
            assert np.abs(b).max() <= lr * steps + 1e-6, n
    for n in jg.params:
        for got, want in zip(flat_leaves({k: v for k, v in g.params[n].items()
                                          if not (n in ("dl", "dr")
                                                  and k == "b")}),
                             [v for k, v in sorted(jg.params[n].items())
                              if not (n in ("dl", "dr") and k == "b")]):
            want = np.asarray(want, np.float64)
            scale = max(np.linalg.norm(want), lr * steps * want.size ** 0.5)
            err = np.linalg.norm(got.double().numpy() - want) / scale
            assert err <= BF16["param_l2"], n
    for n in ("bnl", "bnr"):
        for k in ("var",):
            want = np.asarray(jg.state[n][k], np.float64)
            got = g.state[n][k].double().numpy()
            assert np.linalg.norm(got - want) / np.linalg.norm(want) \
                <= BF16["param_l2"], (n, k)
    ev = g.output(left, right)[0]
    assert ev.dtype == torch.float32 and torch.isfinite(ev).all()


def test_listeners_match_jax_and_record_the_graph():
    """ScoreIterationListener, PerformanceListener,
    ParamAndGradientIterationListener and ComposableIterationListener on a
    graph print and record what the JAX package's do (times aside)."""
    jg = _merge_graph(jax_updaters.Sgd(0.1))
    g = port_twin(jg)
    a, b, y = _data(6)
    lines, jlines = [], []
    mk = lambda mod, out: [
        mod.ScoreIterationListener(2, printer=out.append),
        mod.PerformanceListener(frequency=2, report_score=True,
                                printer=out.append),
        mod.ParamAndGradientIterationListener(frequency=3,
                                              printer=out.append)]
    perf = mk(listeners, lines)
    jperf = mk(jax_listeners, jlines)
    g.set_listeners(listeners.ComposableIterationListener(*perf))
    jg.set_listeners(jax_listeners.ComposableIterationListener(*jperf))
    for _ in range(6):
        g.fit(pt.MultiDataSet(features=[a, b], labels=[y]))
        jg.fit(jx.MultiDataSet(features=[a, b], labels=[y]))
    strip = lambda ls: [l.split(":")[0] if "samples/sec" in l else l
                        for l in ls]
    assert len(lines) == len(jlines) == 3 + 3 + 2
    score_lines = [l for l in lines if l.startswith("Score")]
    jscore_lines = [l for l in jlines if l.startswith("Score")]
    for l, jl in zip(score_lines, jscore_lines):
        assert abs(float(l.rsplit(" ", 1)[1])
                   - float(jl.rsplit(" ", 1)[1])) <= STEP_TOL
    assert strip([l for l in lines if "samples/sec" in l]) == \
        strip([l for l in jlines if "samples/sec" in l])
    assert [r["iteration"] for r in perf[1].history] == [2, 4, 6]
    assert perf[1].history[0]["warmup"]
    assert all(abs(r["score"] - j["score"]) <= STEP_TOL
               for r, j in zip(perf[1].history, jperf[1].history))
    param_lines = [l for l in lines if "|params|" in l]
    assert [l.split(":")[0] for l in param_lines] == \
        [l.split(":")[0] for l in jlines if "|params|" in l]
    with pytest.warns(UserWarning, match="per-iteration parameter stats"):
        listeners.warn_scan_replay([listeners.ComposableIterationListener(
            perf[2])])


def test_collect_scores_export_round_trips(tmp_path):
    log = listeners.CollectScoresIterationListener()
    log.scores = [(1, 0.5), (2, 0.25)]
    path = str(tmp_path / "scores.csv")
    log.export_scores(path)
    assert listeners.CollectScoresIterationListener.load_scores(path) == \
        jax_listeners.CollectScoresIterationListener.load_scores(path) == \
        log.scores
