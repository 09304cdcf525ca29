"""PyTorch port, the ComputationGraph on the CPU against the JAX package:
the configuration (JSON both ways, the topological order, the inferred
input types), every vertex type's forward and gradients (masks included),
multi-input and multi-output graphs, `rnn_time_step`, remat, the graph zip
both ways, the zoo's ResNet and GoogLeNet at small sizes, serving, and the
named errors. Twins of the JAX package's `tests/test_graph.py`,
`tests/test_graph_rnn.py` and
`tests/test_graph_vertex_training_sweep.py`.

The same numpy inputs, made from a seed, go through both packages; the
parameters cross through `from_jax_params` or the zip. Tolerances, stated
per check (the parity gate's defaults):
  * float32 forward: 1e-5 (absolute, on outputs of order 1);
  * first-step gradients and one or two optimizer steps: 1e-5;
  * remat against no remat in the port: bit-equal.

One departure, the port's on purpose: a layer vertex with more than one
input raises a named ValueError at `build()`, where JAX reads the first
input and drops the others (ROADMAP "Known reference defects").
"""
import json
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu as jx
from deeplearning4j_tpu.nn.conf import graph as jgraph
from deeplearning4j_tpu.nn.conf.preprocessors import \
    FeedForwardToRnnPreProcessor as JaxFfToRnn
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.util.serializer import \
    ModelSerializer as JaxModelSerializer
import deeplearning4j_tpu_torch as pt
from deeplearning4j_tpu_torch.nn.conf import graph as pgraph
from deeplearning4j_tpu_torch.nn.conf.preprocessors import \
    FeedForwardToRnnPreProcessor
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.serving.registry import ServingError
from jax_reference import jax_init
from torch_graph_pair import (as_dicts, grads_close, jax_grads, np_tree,
                              port_grads, port_twin, tree_close)
from torch_threads import one_torch_thread  # noqa: F401

FWD_TOL = STEP_TOL = 1e-5


def _data(seed, *shapes):
    r = np.random.default_rng(seed)
    return [r.normal(size=s).astype(np.float32) for s in shapes]


def _labels(seed, n, c, t=None):
    r = np.random.default_rng(seed)
    shape = (n,) if t is None else (n, t)
    return np.eye(c, dtype=np.float32)[r.integers(0, c, shape)]


# ---------------------------------------------------------------------------
# the configuration
# ---------------------------------------------------------------------------
def _merge_conf(m):
    """test_graph.py's merge + elementwise graph, in package `m`."""
    v = m if m is jx else pgraph
    return (m.NeuralNetConfiguration.builder().seed(0).updater(m.Sgd(0.1))
            .graph_builder()
            .add_inputs("a", "b")
            .add_layer("da", m.DenseLayer(n_out=8, activation="tanh"), "a")
            .add_layer("db", m.DenseLayer(n_out=8, activation="tanh"), "b")
            .add_vertex("merge", v.MergeVertex(), "da", "db")
            .add_vertex("sum", v.ElementWiseVertex(op="add"), "da", "db")
            .add_vertex("scaled", v.ScaleVertex(scale=0.5), "sum")
            .add_vertex("merged2", v.MergeVertex(), "merge", "scaled")
            .add_layer("out", m.OutputLayer(n_out=2, loss="mcxent"),
                       "merged2")
            .set_outputs("out")
            .set_input_types(m.InputType.feed_forward(4),
                             m.InputType.feed_forward(6))
            .build())


def test_json_topological_order_and_inferred_types_match_jax():
    jconf, conf = _merge_conf(jx), _merge_conf(pt)
    assert conf.topological_order == jconf.topological_order
    assert conf.vertices["out"].n_in == 24
    assert json.loads(conf.to_json()) == json.loads(jconf.to_json())
    back = pt.ComputationGraphConfiguration.from_json(jconf.to_json())
    assert back.to_json() == jconf.to_json()
    jback = jx.ComputationGraphConfiguration.from_json(conf.to_json())
    assert jback.to_json() == conf.to_json()


def test_inferred_preprocessor_and_rnn_types_match_jax():
    def conf(m):
        v = jgraph if m is jx else pgraph
        return (m.NeuralNetConfiguration.builder().seed(1).graph_builder()
                .add_inputs("img", "seq")
                .add_layer("d", m.DenseLayer(n_out=5), "img")
                .add_layer("l", m.GravesLSTM(n_out=4), "seq")
                .add_vertex("last", v.LastTimeStepVertex(), "l")
                .add_vertex("dup", v.DuplicateToTimeSeriesVertex(), "d",
                            "seq")
                .add_vertex("m", v.MergeVertex(), "d", "last")
                .add_layer("o", m.OutputLayer(n_out=3), "m")
                .add_layer("o2", m.RnnOutputLayer(n_out=2), "dup")
                .set_outputs("o", "o2")
                .set_input_types(m.InputType.convolutional(4, 4, 2),
                                 m.InputType.recurrent(3, 6))
                .build())
    assert json.loads(conf(pt).to_json()) == json.loads(conf(jx).to_json())


@pytest.mark.parametrize("mutate,match", [
    ("cycle", "cycle"), ("bad input", "not a vertex"),
    ("bad output", "is not a vertex"), ("no inputs", "at least one input"),
    ("no outputs", "needs outputs"), ("types", "input_types count")])
def test_builder_errors_match_jax(mutate, match):
    def build(m):
        b = m.NeuralNetConfiguration.builder().graph_builder()
        if mutate != "no inputs":
            b.add_inputs("in")
        src = {"cycle": "b", "bad input": "nonexistent"}.get(mutate, "in")
        b.add_layer("a", m.DenseLayer(n_in=4, n_out=4), src)
        b.add_layer("b", m.DenseLayer(n_in=4, n_out=4), "a")
        if mutate != "no outputs":
            b.set_outputs("zz" if mutate == "bad output" else "b")
        if mutate == "types":
            b.set_input_types(m.InputType.feed_forward(4),
                              m.InputType.feed_forward(4))
        return b.build()
    for m in (jx, pt):
        with pytest.raises(ValueError, match=match):
            build(m)
    with pytest.raises(ValueError, match="Duplicate vertex"):
        pt.NeuralNetConfiguration.builder().graph_builder().add_layer(
            "a", pt.DenseLayer(n_out=2)).add_vertex("a", pt.MergeVertex())


def test_multi_input_layer_vertex_raises_where_jax_drops_inputs():
    """JAX builds a layer vertex with two inputs and reads only the first
    (its forward and shape inference take inputs[0]); the port refuses it
    at build() and names the MergeVertex."""
    def builder(m):
        return (m.NeuralNetConfiguration.builder().seed(3).graph_builder()
                .add_inputs("a", "b")
                .add_layer("d", m.DenseLayer(n_out=3), "a", "b")
                .add_layer("o", m.OutputLayer(n_out=2), "d")
                .set_outputs("o")
                .set_input_types(m.InputType.feed_forward(4),
                                 m.InputType.feed_forward(5)))
    jg = jax_init(JaxGraph(builder(jx).build()))
    assert jg.conf.vertices["d"].n_in == 4          # b's width ignored
    a, b = _data(0, (2, 4), (2, 5))
    np.testing.assert_array_equal(np.asarray(jg.output(a, b)[0]),
                                  np.asarray(jg.output(a, 10 * b)[0]))
    with pytest.raises(ValueError, match="MergeVertex"):
        builder(pt).build()


# ---------------------------------------------------------------------------
# the vertices, one by one
# ---------------------------------------------------------------------------
def _vertex_cases():
    x, y = _data(1, (3, 5), (3, 5))
    seq, seq2 = _data(2, (3, 4, 5), (3, 4, 5))
    mask = np.array([[1, 1, 0, 0], [1, 1, 1, 1], [0, 0, 0, 0]], np.float32)
    yield "merge", lambda v: v.MergeVertex(), [x, y[:, :2]], None
    yield "merge rnn", lambda v: v.MergeVertex(), [seq, seq2], None
    for op in ("add", "subtract", "product", "average", "max"):
        yield f"elementwise {op}", lambda v, op=op: v.ElementWiseVertex(
            op=op), [x, y], None
    yield "elementwise add x3", lambda v: v.ElementWiseVertex(op="add"), \
        [x, y, x], None
    yield "subset", lambda v: v.SubsetVertex(from_idx=1, to_idx=3), [x], None
    yield "subset rnn", lambda v: v.SubsetVertex(0, 2), [seq], None
    yield "stack", lambda v: v.StackVertex(), [x, y], None
    yield "unstack", lambda v: v.UnstackVertex(from_idx=1, stack_size=3), \
        [np.concatenate([x, y, x])], None
    yield "scale", lambda v: v.ScaleVertex(scale=-0.3), [x], None
    yield "shift", lambda v: v.ShiftVertex(shift=1.5), [x], None
    yield "l2", lambda v: v.L2Vertex(), [x, y], None
    yield "l2 rnn", lambda v: v.L2Vertex(), [seq, seq2], None
    yield "l2normalize", lambda v: v.L2NormalizeVertex(), [x], None
    yield "preprocessor", lambda v: v.PreprocessorVertex(
        (JaxFfToRnn if v is jgraph else FeedForwardToRnnPreProcessor)()), \
        [x], None
    yield "last time step", lambda v: v.LastTimeStepVertex(), [seq], None
    yield "last time step masked", lambda v: v.LastTimeStepVertex(), \
        [seq], [mask]
    yield "duplicate to time series", \
        lambda v: v.DuplicateToTimeSeriesVertex(), [x, seq], None


@pytest.mark.parametrize("name,make,ins,masks", list(_vertex_cases()))
def test_vertex_apply_and_output_mask_match_jax(name, make, ins, masks):
    jv, v = make(jgraph), make(pgraph)
    jm = None if masks is None else [jnp.asarray(m) for m in masks]
    tm = None if masks is None else [torch.as_tensor(m) for m in masks]
    want = jv.apply([jnp.asarray(a) for a in ins], jm)
    got = v.apply([torch.as_tensor(a) for a in ins], tm)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=FWD_TOL)
    for m_in in (masks, [None] * len(ins)):
        jo = jv.output_mask(None if m_in is None else
                            [None if m is None else jnp.asarray(m)
                             for m in m_in])
        to = v.output_mask(None if m_in is None else
                           [None if m is None else torch.as_tensor(m)
                            for m in m_in])
        assert (jo is None) == (to is None)
        if jo is not None:
            np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


def test_vertex_output_types_match_jax():
    its = {"ff": (jx.InputType.feed_forward(5), pt.InputType.feed_forward(5)),
           "rnn": (jx.InputType.recurrent(5, 4), pt.InputType.recurrent(5, 4)),
           "cnn": (jx.InputType.convolutional(3, 3, 5),
                   pt.InputType.convolutional(3, 3, 5))}
    for name, make, ins, _ in _vertex_cases():
        for kind in ("ff", "rnn", "cnn"):
            if name.startswith(("duplicate", "last")) and kind != "rnn":
                continue
            jt, t = its[kind]
            n = len(ins)
            if name.startswith("duplicate"):
                jin, tin = [its["ff"][0], jt], [its["ff"][1], t]
            else:
                jin, tin = [jt] * n, [t] * n
            want = make(jgraph).output_type(jin)
            got = make(pgraph).output_type(tin)
            assert got.to_dict() == want.to_dict(), (name, kind)


# ---------------------------------------------------------------------------
# every vertex type inside a trained graph (test_graph_vertex_training_sweep)
# ---------------------------------------------------------------------------
def _sweep_graph(case):
    """(JAX graph, features list, labels list) of one sweep case."""
    v, m = jgraph, jx
    b = (m.NeuralNetConfiguration.builder().seed(5).updater(m.Adam(1e-2))
         .graph_builder())
    ff_x = _data(0, (16, 6))[0]
    ff_y = _labels(0, 16, 3)
    two = {"MergeVertex": v.MergeVertex(),
           "ElementWiseVertex-add": v.ElementWiseVertex("add"),
           "ElementWiseVertex-product": v.ElementWiseVertex("product"),
           "ElementWiseVertex-max": v.ElementWiseVertex("max"),
           "L2Vertex": v.L2Vertex()}
    chain = {"SubsetVertex": v.SubsetVertex(0, 3),
             "ScaleVertex": v.ScaleVertex(0.5),
             "ShiftVertex": v.ShiftVertex(1.0),
             "L2NormalizeVertex": v.L2NormalizeVertex()}
    b.add_inputs("in")
    if case in two:
        b.add_layer("ha", m.DenseLayer(n_out=6, activation="tanh"), "in")
        b.add_layer("hb", m.DenseLayer(n_out=6, activation="tanh"), "in")
        b.add_vertex("v", two[case], "ha", "hb")
        b.add_layer("out", m.OutputLayer(n_out=3, loss="mcxent"), "v")
        b.set_input_types(m.InputType.feed_forward(6))
        feats, labels = [ff_x], [ff_y]
    elif case in chain:
        b.add_layer("h", m.DenseLayer(n_out=6, activation="tanh"), "in")
        b.add_vertex("v", chain[case], "h")
        b.add_layer("out", m.OutputLayer(n_out=3, loss="mcxent"), "v")
        b.set_input_types(m.InputType.feed_forward(6))
        feats, labels = [ff_x], [ff_y]
    elif case == "StackUnstack":
        b.add_layer("ha", m.DenseLayer(n_out=6, activation="tanh"), "in")
        b.add_layer("hb", m.DenseLayer(n_out=6, activation="tanh"), "in")
        b.add_vertex("st", v.StackVertex(), "ha", "hb")
        b.add_vertex("u0", v.UnstackVertex(0, 2), "st")
        b.add_vertex("u1", v.UnstackVertex(1, 2), "st")
        b.add_vertex("m", v.MergeVertex(), "u0", "u1")
        b.add_layer("out", m.OutputLayer(n_out=3, loss="mcxent"), "m")
        b.set_input_types(m.InputType.feed_forward(6))
        feats, labels = [ff_x], [ff_y]
    elif case == "PreprocessorVertex":
        b.add_layer("h", m.DenseLayer(n_out=5, activation="tanh"), "in")
        b.add_vertex("v", v.PreprocessorVertex(JaxFfToRnn()), "h")
        b.add_layer("out", m.RnnOutputLayer(n_out=3, activation="softmax",
                                            loss="mcxent"), "v")
        b.set_input_types(m.InputType.feed_forward(6))
        feats, labels = [ff_x], [_labels(1, 16, 3, 1)]
    elif case == "LastTimeStepVertex":
        b.add_layer("h", m.GravesLSTM(n_out=6, activation="tanh"), "in")
        b.add_vertex("v", v.LastTimeStepVertex(), "h")
        b.add_layer("out", m.OutputLayer(n_out=3, loss="mcxent"), "v")
        b.set_input_types(m.InputType.recurrent(5))
        feats, labels = _data(0, (8, 4, 5)), [_labels(2, 8, 3)]
    else:   # DuplicateToTimeSeriesVertex
        b = (m.NeuralNetConfiguration.builder().seed(5)
             .updater(m.Adam(1e-2)).graph_builder())
        b.add_inputs("seq", "ctx")
        b.add_layer("rec", m.GravesLSTM(n_out=6, activation="tanh"), "seq")
        b.add_layer("cd", m.DenseLayer(n_out=6, activation="tanh"), "ctx")
        b.add_vertex("dup", v.DuplicateToTimeSeriesVertex(), "cd", "seq")
        b.add_vertex("m", v.MergeVertex(), "rec", "dup")
        b.add_layer("out", m.RnnOutputLayer(n_out=3, activation="softmax",
                                            loss="mcxent"), "m")
        b.set_input_types(m.InputType.recurrent(5),
                          m.InputType.feed_forward(6))
        feats = _data(0, (8, 4, 5)) + _data(3, (8, 6))
        labels = [_labels(0, 8, 3, 4)]
    b.set_outputs("out")
    return jax_init(JaxGraph(b.build())), feats, labels


SWEEP = ["MergeVertex", "ElementWiseVertex-add", "ElementWiseVertex-product",
         "ElementWiseVertex-max", "SubsetVertex", "ScaleVertex",
         "ShiftVertex", "L2NormalizeVertex", "L2Vertex", "StackUnstack",
         "PreprocessorVertex", "LastTimeStepVertex",
         "DuplicateToTimeSeriesVertex"]


@pytest.mark.parametrize("case", SWEEP)
def test_vertex_type_trains_like_jax(case):
    """Forward, first-step gradients and two Adam steps of the sweep's
    graph, each within 1e-5 of JAX; every layer's parameters move."""
    jg, feats, labels = _sweep_graph(case)
    g = port_twin(jg)
    np.testing.assert_allclose(g.output(*feats)[0].numpy(),
                               np.asarray(jg.output(*feats)[0]), rtol=0,
                               atol=FWD_TOL)
    i, l, _, _ = as_dicts(jg, feats, labels)
    js, jgr = jax_grads(jg, i, l)
    s, gr = port_grads(g, i, l)
    assert abs(s - js) <= STEP_TOL
    tree_close(gr, np_tree(jgr), STEP_TOL, case)
    before = {k: [t.clone() for t in pt.nn.trees.flat_leaves(p)]
              for k, p in g.params.items()}
    jds = (jx.DataSet(feats[0], labels[0]) if len(feats) == 1
           else jx.MultiDataSet(features=feats, labels=labels))
    ds = (pt.DataSet(feats[0], labels[0]) if len(feats) == 1
          else pt.MultiDataSet(features=feats, labels=labels))
    for _ in range(2):
        jg.fit(jds)
        g.fit(ds)
    assert np.isfinite(g.score()) and abs(g.score() - float(jg.score())) \
        <= STEP_TOL
    tree_close(g.params, np_tree(jg.params), STEP_TOL, case)
    for k, leaves in before.items():
        if leaves:
            after = pt.nn.trees.flat_leaves(g.params[k])
            assert any((a - b).abs().max() > 0
                       for a, b in zip(after, leaves)), (case, k)


# ---------------------------------------------------------------------------
# masks, multi-input, multi-output
# ---------------------------------------------------------------------------
def _masked_seq_graph():
    v, m = jgraph, jx
    b = (m.NeuralNetConfiguration.builder().seed(7).updater(m.Adam(1e-2))
         .l2(1e-3).graph_builder()
         .add_inputs("seq")
         .add_layer("l", m.GravesLSTM(n_out=5, activation="tanh"), "seq")
         .add_vertex("last", v.LastTimeStepVertex(), "l")
         .add_layer("cls", m.OutputLayer(n_out=3, loss="mcxent"), "last")
         .add_layer("tag", m.RnnOutputLayer(n_out=2, activation="softmax",
                                            loss="mcxent"), "l")
         .set_outputs("cls", "tag")
         .set_input_types(m.InputType.recurrent(4, 6)))
    return jax_init(JaxGraph(b.build()))


def test_masked_multi_output_graph_matches_jax():
    """A features mask through GravesLSTM and LastTimeStepVertex, a labels
    mask on the time-series head, l2 normalised by the live rows: outputs,
    score, gradients and score_examples within 1e-5 of JAX."""
    jg = _masked_seq_graph()
    g = port_twin(jg)
    x = _data(4, (5, 6, 4))[0]
    fm = (np.arange(6)[None] < np.array([6, 3, 1, 5, 2])[:, None]).astype(
        np.float32)
    lm = fm.copy()
    lm[4] = 0.0                       # a row live in no output's mask
    ys = [_labels(5, 5, 3), _labels(6, 5, 2, 6)]
    jo = jg.output(x, features_masks=[fm])
    o = g.output(x, features_masks=[fm])
    for a, b in zip(o, jo):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=FWD_TOL)
    i, l, f, lmk = as_dicts(jg, [x], ys, [fm], [None, lm])
    js, jgr = jax_grads(jg, i, l, f, lmk)
    s, gr = port_grads(g, i, l, f, lmk)
    assert abs(s - js) <= STEP_TOL
    tree_close(gr, np_tree(jgr), STEP_TOL)
    jmds = jx.MultiDataSet(features=[x], labels=ys, features_masks=[fm],
                           labels_masks=[None, lm])
    mds = pt.MultiDataSet(features=[x], labels=ys, features_masks=[fm],
                          labels_masks=[None, lm])
    np.testing.assert_allclose(g.score_examples(mds),
                               np.asarray(jg.score_examples(jmds)), rtol=0,
                               atol=FWD_TOL)
    np.testing.assert_allclose(
        g.score_examples(mds, add_regularization_terms=False),
        np.asarray(jg.score_examples(jmds, False)), rtol=0, atol=FWD_TOL)
    assert abs(g.score(mds) - jg.score(jmds)) <= STEP_TOL


def test_merge_graph_fit_and_output_match_jax():
    """test_graph.py's multi-input merge graph: MultiDataSet fit steps and
    the output, against JAX."""
    jg = jax_init(JaxGraph(_merge_conf(jx)))
    g = port_twin(jg)
    a, b = _data(0, (5, 4), (5, 6))
    y = _labels(0, 5, 2)
    for _ in range(3):
        jg.fit(jx.MultiDataSet(features=[a, b], labels=[y]))
        g.fit(pt.MultiDataSet(features=[a, b], labels=[y]))
    tree_close(g.params, np_tree(jg.params), STEP_TOL)
    np.testing.assert_allclose(g.output(a, b)[0].numpy(),
                               np.asarray(jg.output(a, b)[0]), rtol=0,
                               atol=FWD_TOL)
    assert g.output_single(a, b).shape == (5, 2)


# ---------------------------------------------------------------------------
# rnn_time_step (test_graph_rnn.py)
# ---------------------------------------------------------------------------
def _lstm_graph(m, vocab=7, hidden=12, seq=10, seed=3):
    b = (m.NeuralNetConfiguration.builder().seed(seed).updater(m.Adam(1e-2))
         .graph_builder().add_inputs("in")
         .set_input_types(m.InputType.recurrent(vocab, seq)))
    b.add_layer("lstm", m.GravesLSTM(n_out=hidden, activation="tanh"), "in")
    b.add_layer("out", m.RnnOutputLayer(n_out=vocab, activation="softmax",
                                        loss="mcxent"), "lstm")
    return b.set_outputs("out").build()


def test_rnn_time_step_matches_full_sequence_and_jax():
    jg = jax_init(JaxGraph(_lstm_graph(jx)))
    g = port_twin(jg)
    x = np.eye(7, dtype=np.float32)[np.random.default_rng(0).integers(
        0, 7, (2, 10))]
    full = g.output(x)[0].numpy()
    np.testing.assert_allclose(full, np.asarray(jg.output(x)[0]), rtol=0,
                               atol=FWD_TOL)
    steps = []
    for t in range(10):
        o = g.rnn_time_step(x[:, t])
        np.testing.assert_allclose(o.numpy(),
                                   np.asarray(jg.rnn_time_step(x[:, t])),
                                   rtol=0, atol=FWD_TOL)
        steps.append(o.numpy())
    np.testing.assert_allclose(np.stack(steps, 1), full, rtol=0,
                               atol=FWD_TOL)
    g.rnn_clear_previous_state()
    np.testing.assert_allclose(g.rnn_time_step(x[:, :3]).numpy(),
                               full[:, :3], rtol=0, atol=FWD_TOL)


def test_rnn_time_step_batch_change_and_bidirectional_raise():
    g = ComputationGraph(_lstm_graph(pt), device="cpu").init()
    x = np.eye(7, dtype=np.float32)[np.zeros((4,), np.int64)]
    g.rnn_time_step(x)
    with pytest.raises(ValueError, match="batch changed"):
        g.rnn_time_step(x[:2])
    g.rnn_clear_previous_state()
    g.rnn_time_step(x[:2])
    b = (pt.NeuralNetConfiguration.builder().seed(1).graph_builder()
         .add_inputs("in").set_input_types(pt.InputType.recurrent(5, 6)))
    b.add_layer("bi", pt.nn.layers.GravesBidirectionalLSTM(n_out=8), "in")
    b.add_layer("out", pt.RnnOutputLayer(n_out=5, activation="softmax",
                                         loss="mcxent"), "bi")
    bi = ComputationGraph(b.set_outputs("out").build(), device="cpu").init()
    with pytest.raises(ValueError, match="bidirectional|full sequence"):
        bi.rnn_time_step(np.zeros((2, 5), np.float32))


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------
def _residual_conf(m, remat=None):
    v = jgraph if m is jx else pgraph
    b = (m.NeuralNetConfiguration.builder().seed(9).updater(m.Adam(1e-2))
         .remat(remat).graph_builder().add_inputs("in")
         .add_layer("d0", m.DenseLayer(n_out=8, activation="tanh"), "in")
         .add_layer("d1", m.DenseLayer(n_out=8, activation="relu"), "d0")
         .add_layer("d2", m.DenseLayer(n_out=8, activation="tanh"), "d1")
         .add_vertex("add", v.ElementWiseVertex("add"), "d0", "d2")
         .add_layer("d3", m.DenseLayer(n_out=8, activation="tanh"), "add")
         .add_layer("out", m.OutputLayer(n_out=3, loss="mcxent"), "d3")
         .set_outputs("out")
         .set_input_types(m.InputType.feed_forward(5)))
    return b.build()


def test_remat_segments_and_full_are_bit_equal_to_no_remat():
    """remat "layer" / "blocks" / "full": gradients and two Adam steps
    bit-equal to no remat in the port; "blocks" cuts the residual graph
    where JAX does; the steps within 1e-5 of JAX's."""
    jg = jax_init(JaxGraph(_residual_conf(jx)))
    x, y = _data(2, (6, 5))[0], _labels(2, 6, 3)
    runs = {}
    for mode in (None, "layer", "blocks", "full"):
        g = ComputationGraph(_residual_conf(pt, mode), device="cpu").init()
        pt.from_jax_params(g, np_tree(jg.params),
                           np_tree(jg.updater_state))
        if mode == "blocks":
            j = JaxGraph(_residual_conf(jx, "blocks"))
            assert g._block_segments() == j._block_segments
            assert g._block_segments() == [["d0"], ["d1", "d2", "add"],
                                           ["d3"], ["out"]]
        loss = g._full_remat_loss if mode == "full" else g._loss_fn
        ins, labels = g._to_inputs(pt.DataSet(x, y))[:2]
        _, _, grads = g._value_and_grad(g.params, ins, labels, None, None,
                                        None, loss)
        for _ in range(2):
            g.fit(pt.DataSet(x, y))
        runs[mode] = (grads, g.params)
    for mode in ("layer", "blocks", "full"):
        for a, b in ((runs[mode][0], runs[None][0]),
                     (runs[mode][1], runs[None][1])):
            for k in b:
                for u, w in zip(pt.nn.trees.flat_leaves(a[k]),
                                pt.nn.trees.flat_leaves(b[k])):
                    assert torch.equal(u, w), (mode, k)
    for _ in range(2):
        jg.fit(jx.DataSet(x, y))
    tree_close(runs["blocks"][1], np_tree(jg.params), STEP_TOL)


# ---------------------------------------------------------------------------
# zips
# ---------------------------------------------------------------------------
def test_graph_zips_cross_both_ways_and_resume(tmp_path):
    """A JAX graph zip (Adam state after 2 steps) restores in the port:
    outputs equal, and one more step equal to JAX's; the port's zip
    restores in JAX the same way."""
    jg = jax_init(JaxGraph(_merge_conf(jx)))
    a, b = _data(8, (5, 4), (5, 6))
    y = _labels(8, 5, 2)
    jmds = jx.MultiDataSet(features=[a, b], labels=[y])
    mds = pt.MultiDataSet(features=[a, b], labels=[y])
    for _ in range(2):
        jg.fit(jmds)
    jpath = str(tmp_path / "jax_graph.zip")
    JaxModelSerializer.write_model(jg, jpath)
    g = pt.ModelSerializer.restore(jpath, device="cpu")
    assert isinstance(g, ComputationGraph) and g.iteration_count == 2
    np.testing.assert_allclose(g.output(a, b)[0].numpy(),
                               np.asarray(jg.output(a, b)[0]), rtol=0,
                               atol=FWD_TOL)
    tree_close(g.updater_state, np_tree(jg.updater_state), 0.0)
    jg.fit(jmds)
    g.fit(mds)
    tree_close(g.params, np_tree(jg.params), STEP_TOL)
    ppath = str(tmp_path / "port_graph.zip")
    pt.ModelSerializer.write_model(g, ppath)
    back = JaxModelSerializer.restore(ppath)
    assert isinstance(back, JaxGraph) and back.iteration_count == 3
    tree_close(np_tree(back.params), np_tree(jg.params), STEP_TOL)
    back.fit(jmds)
    g.fit(mds)
    tree_close(g.params, np_tree(back.params), STEP_TOL)


def test_params_flat_set_params_flat_clone_and_num_params():
    jg = jax_init(JaxGraph(_merge_conf(jx)))
    g = port_twin(jg)
    np.testing.assert_array_equal(g.params_flat(), jg.params_flat())
    assert g.num_params() == jg.num_params()
    vec = np.arange(g.num_params(), dtype=np.float32) / 1000
    g.set_params_flat(vec)
    jg.set_params_flat(vec)
    tree_close(g.params, np_tree(jg.params), 0.0)
    twin = g.clone()
    a, b = _data(1, (3, 4), (3, 6))
    y = _labels(1, 3, 2)
    g.fit(pt.MultiDataSet(features=[a, b], labels=[y]))
    assert not torch.equal(twin.params["da"]["W"], g.params["da"]["W"])
    twin.fit(pt.MultiDataSet(features=[a, b], labels=[y]))
    tree_close(twin.params, g.params, 0.0)


# ---------------------------------------------------------------------------
# the zoo's graphs at small sizes
# ---------------------------------------------------------------------------
def test_tiny_resnet_matches_jax():
    """ResNet-50's topology at blocks (1, 1, 1, 1), width 8, image 32, 10
    classes, float32, batch 8, SGD 0.1 (Adam's first step is lr x the
    gradient's sign, which rounding flips where an entry is near 0; the
    updaters have their own test): forward, score and one step within
    1e-5 of JAX (4-D BN: the exact two-pass tier in both); first-step
    gradients within 2e-5 of each tensor's largest entry: a conv weight's
    gradient sums 2,048 products per entry in another order, behind three
    BN layers that divide by per-channel deviations (measured 1.1e-5). At
    batch 2 the last stage normalises two values a channel (1 x 1 maps),
    which turns float32 rounding of their difference into gaps of order
    1e-3, so the batch is 8."""
    from deeplearning4j_tpu.models.zoo import resnet50 as jax_resnet50
    kw = dict(n_classes=10, image=32, blocks=(1, 1, 1, 1), width=8,
              compute_dtype=None)
    jconf = jax_resnet50(updater=jx.Sgd(0.1), **kw).conf
    conf = pt.resnet50(updater=pt.Sgd(0.1), device="cpu", **kw).conf
    assert json.loads(conf.to_json()) == json.loads(jconf.to_json())
    jg = jax_init(JaxGraph(jconf))
    g = port_twin(jg)
    assert g.num_params() == jg.num_params()
    x = _data(3, (8, 32, 32, 3))[0]
    y = _labels(3, 8, 10)
    np.testing.assert_allclose(g.output(x)[0].numpy(),
                               np.asarray(jg.output(x)[0]), rtol=0,
                               atol=FWD_TOL)
    i, l, _, _ = as_dicts(jg, [x], [y])
    js, jgr = jax_grads(jg, i, l)
    s, gr = port_grads(g, i, l)
    assert abs(s - js) <= STEP_TOL
    grads_close(gr, np_tree(jgr), 2e-5)
    jg.fit(jx.DataSet(x, y))
    g.fit(pt.DataSet(x, y))
    tree_close(g.params, np_tree(jg.params), STEP_TOL)
    tree_close(g.state, np_tree(jg.state), STEP_TOL)


def test_tiny_resnet_bf16_default_stays_within_the_bf16_limit():
    """The zoo default: bf16 compute over float32 masters (4-D BN: the
    "fused" tier in both). At width 8 the batch statistics amplify bf16
    rounding, and the port's bf16 rounds in another order than JAX's, so
    each is held to the float32 score: the training score of both within
    the bf16 limit 2e-2 (relative) of JAX's float32 score, and the
    evaluation output within 2e-2 of JAX's bf16 output."""
    from deeplearning4j_tpu.models.zoo import resnet50 as jax_resnet50
    kw = dict(n_classes=10, image=32, blocks=(1, 1, 1, 1), width=8)
    jg = jax_init(JaxGraph(jax_resnet50(**kw).conf))
    jf = jax_init(JaxGraph(jax_resnet50(compute_dtype=None, **kw).conf))
    g = port_twin(jg)
    x = _data(4, (8, 32, 32, 3))[0]
    y = _labels(4, 8, 10)
    np.testing.assert_allclose(g.output(x)[0].numpy(),
                               np.asarray(jg.output(x)[0]), rtol=0,
                               atol=2e-2)
    i, l, _, _ = as_dicts(jg, [x], [y])
    s_f32 = jax_grads(jf, i, l)[0]
    for s in (port_grads(g, i, l)[0], jax_grads(jg, i, l)[0]):
        assert abs(s - s_f32) <= 2e-2 * abs(s_f32), (s, s_f32)
    g.fit(pt.DataSet(x, y))
    assert np.isfinite(g.score())


def test_googlenet_at_32_matches_jax():
    """GoogLeNet's nine inception modules at image 32, 10 classes, the
    head's dropout stripped: forward within 1e-5 of JAX, and the port's
    score equal to the cross-entropy of JAX's output (1e-5)."""
    from deeplearning4j_tpu.models.zoo import googlenet as jax_googlenet
    jconf = jax_googlenet(n_classes=10, image=32).conf
    jconf.vertices["out"] = replace(jconf.vertices["out"], dropout=None)
    g = pt.googlenet(n_classes=10, image=32, device="cpu")
    assert g.conf.vertices["out"].dropout == 0.6
    g.conf.vertices["out"] = replace(g.conf.vertices["out"], dropout=None)
    assert json.loads(g.conf.to_json()) == json.loads(jconf.to_json())
    jg = jax_init(JaxGraph(jconf))
    g = port_twin(jg)
    x = _data(5, (2, 32, 32, 3))[0]
    y = _labels(5, 2, 10)
    want = np.asarray(jg.output(x)[0])
    np.testing.assert_allclose(g.output(x)[0].numpy(), want, rtol=0,
                               atol=FWD_TOL)
    xent = -np.mean(np.sum(y * np.log(want.astype(np.float64)), axis=1))
    assert abs(g.score(pt.DataSet(x, y)) - xent) <= FWD_TOL


# ---------------------------------------------------------------------------
# serving and the named errors
# ---------------------------------------------------------------------------
def test_registry_serves_a_single_input_graph_zip(tmp_path):
    jg = jax_init(JaxGraph(_lstm_graph(jx)))
    path = str(tmp_path / "g.zip")
    JaxModelSerializer.write_model(jg, path)
    reg = pt.ModelRegistry(buckets=(1, 4), device="cpu")
    v = reg.register("g", path)
    assert v.model_kind == "ComputationGraph"
    assert v.example_shape == (10, 7)
    x = np.eye(7, dtype=np.float32)[np.random.default_rng(1).integers(
        0, 7, (3, 10))]
    out, version = reg.predict("g", x)
    assert version == 1
    np.testing.assert_allclose(out, np.asarray(jg.output(x)[0]), rtol=0,
                               atol=FWD_TOL)


def test_registry_refuses_a_multi_input_graph_with_jax_words():
    g = ComputationGraph(_merge_conf(pt), device="cpu").init()
    reg = pt.ModelRegistry(device="cpu")
    with pytest.raises(ServingError, match="single-input models"):
        reg.register("m", g, input_shape=(4,))


def _merge_batches(n, rows=8, seed=0):
    r = np.random.default_rng(seed)
    return [pt.MultiDataSet(
        features=[r.normal(size=(rows, 4)).astype(np.float32),
                  r.normal(size=(rows, 6)).astype(np.float32)],
        labels=[np.eye(2, dtype=np.float32)[r.integers(0, 2, rows)]])
        for _ in range(n)]


@pytest.mark.parametrize("option,value", [
    ("superstep", 2), ("grad_accumulation", 2), ("prefetch", True),
    ("pad_ragged", True), ("time_buckets", (4,)),
    ("checkpoint_dir", "ckpt"), ("checkpoint_every", 5),
    ("resume", True), ("guard", "skip_batch")])
def test_fit_options_train_a_two_input_graph(option, value, tmp_path):
    """Each of JAX's `fit` options on the two-input graph over an iterator
    of MultiDataSets (four batches of 8 and a ragged one of 3), as JAX
    treats it: superstep windows and prefetch give the per-batch bits,
    gradient accumulation of 2 x 8 rows is the 16-row step (rtol 5e-5),
    padding rows is a learning no-op (1e-5), checkpoint_dir leaves a
    resumable checkpoint, checkpoint_every or resume without a directory
    raise JAX's errors, and a skip_batch guard drops a poisoned batch."""
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ListDataSetIterator
    from deeplearning4j_tpu_torch.fault import FaultyIterator, TrainingGuard
    bs = _merge_batches(4) + [_merge_batches(1, rows=3, seed=1)[0]]
    mk = lambda: ComputationGraph(_merge_conf(pt), device="cpu").init()
    plain = mk()
    plain.fit(ListDataSetIterator(bs))
    g = mk()
    if option in ("checkpoint_every", "resume"):
        with pytest.raises(ValueError, match="need checkpoint_dir"):
            g.fit(ListDataSetIterator(bs), **{option: value})
        return
    if option == "grad_accumulation":
        g.fit(ListDataSetIterator(bs[:4]), grad_accumulation=value)
        ref = mk()
        ref.fit(ListDataSetIterator([pt.MultiDataSet(
            features=[np.concatenate([b.features[i] for b in pair])
                      for i in range(2)],
            labels=[np.concatenate([b.labels[0] for b in pair])])
            for pair in (bs[0:2], bs[2:4])]))
        assert g.iteration_count == ref.iteration_count == 2
        np.testing.assert_allclose(g.params_flat(), ref.params_flat(),
                                   rtol=5e-5, atol=1e-7)
        return
    if option == "guard":
        guard = TrainingGuard(value)
        g.fit(FaultyIterator(ListDataSetIterator(bs), nan_at=1),
              guard=guard)
        assert guard.skipped_batches == 1 and g.iteration_count == 4
        assert np.isfinite(g.params_flat()).all()
        return
    if option == "checkpoint_dir":
        value = str(tmp_path / value)
    g.fit(ListDataSetIterator(bs), **{option: value})
    assert g.iteration_count == plain.iteration_count == 5
    if option in ("pad_ragged", "time_buckets"):
        np.testing.assert_allclose(g.params_flat(), plain.params_flat(),
                                   rtol=0, atol=1e-5)
        return
    np.testing.assert_array_equal(g.params_flat(), plain.params_flat())
    if option == "checkpoint_dir":
        (it, path), = pt.fault.CheckpointManager(value).entries()
        back = mk()
        pt.ModelSerializer.restore_into(back, path)
        assert it == 5 and back.iteration_count == 5
        np.testing.assert_array_equal(back.params_flat(), g.params_flat())


def test_data_errors_match_jax():
    for m, G in ((jx, JaxGraph), (pt, ComputationGraph)):
        kw = {} if m is jx else {"device": "cpu"}
        g = G(_merge_conf(m), **kw).init()
        with pytest.raises(ValueError, match="single-input/single-output"):
            g.fit(m.DataSet(np.zeros((2, 4), np.float32),
                            np.zeros((2, 2), np.float32)))
        with pytest.raises(TypeError, match="Cannot fit"):
            g._to_inputs([1, 2])
    conf = (pt.NeuralNetConfiguration.builder().graph_builder()
            .add_inputs("in").add_layer("d", pt.DenseLayer(n_out=2), "in")
            .set_outputs("d").set_input_types(pt.InputType.feed_forward(3))
            .build())
    g = ComputationGraph(conf, device="cpu").init()
    with pytest.raises(ValueError, match="must be an output/loss layer"):
        g.fit(pt.DataSet(np.zeros((2, 3)), np.zeros((2, 2))))


def test_default_device_is_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ComputationGraph(_merge_conf(pt))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.resnet50(n_classes=10, image=32, blocks=(1, 1, 1, 1), width=8)
