"""PyTorch port, transfer learning, early stopping and the ROC / regression
evaluations on the CPU against the JAX package: twins of
`tests/test_transfer_earlystopping_eval.py` (its parallel-trainer cases
are in `tests/test_torch_parallel_loop.py`; bar its evaluation metadata
and recompile-tracking cases, which belong to other slices).

Transfer learning: both packages edit the same trained network (the port's
twin holds the JAX parameters); the edited configurations' JSON, the
frozen flags and every kept parameter must agree exactly, and after the
re-initialized layers take JAX's values the edited networks train alike
(one-step tolerance 1e-5, frozen parameters bit-unchanged). Early
stopping: the same data through both trainers (each epoch's validation
score within the trajectory tolerance 1e-4, the same epochs, reasons and
best epoch). Evaluations: the same arrays (ROC counts, curves and AUCs
equal; regression statistics within 1e-12 relative, both sum in float64).
"""
import json
import os

import numpy as np
import pytest
import torch

import deeplearning4j_tpu as jx
from deeplearning4j_tpu import earlystopping as jes
from deeplearning4j_tpu.eval.regression import \
    RegressionEvaluation as JaxRegression
from deeplearning4j_tpu.eval.roc import ROC as JaxROC
from deeplearning4j_tpu.eval.roc import ROCMultiClass as JaxROCMultiClass
from deeplearning4j_tpu.nn import transferlearning as jtl
from deeplearning4j_tpu.nn.conf import graph as jgraph
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
import deeplearning4j_tpu_torch as pt
from deeplearning4j_tpu_torch import earlystopping as es
from deeplearning4j_tpu_torch.nn import transferlearning as tl
from jax_reference import jax_init
from torch_graph_pair import np_tree, port_twin, tree_close
from torch_threads import one_torch_thread  # noqa: F401

STEP_TOL, TRAJ_TOL = 1e-5, 1e-4


def _base_pair(seed=0):
    """test_transfer_earlystopping_eval.py's base model in JAX and its port
    twin with the same parameters."""
    conf = (jx.NeuralNetConfiguration.builder().seed(seed)
            .updater(jx.Adam(1e-2)).list()
            .layer(jx.DenseLayer(n_out=16, activation="relu"))
            .layer(jx.DenseLayer(n_out=8, activation="relu"))
            .layer(jx.OutputLayer(n_out=3, loss="mcxent"))
            .set_input_type(jx.InputType.feed_forward(10)).build())
    jnet = jx.MultiLayerNetwork(conf).init()
    net = pt.MultiLayerNetwork(
        pt.MultiLayerConfiguration.from_json(conf.to_json()),
        device="cpu").init()
    return jnet, pt.from_jax_params(net, np_tree(jnet.params),
                                    np_tree(jnet.updater_state))


def _data(classification_data, n=None):
    xs, ys = classification_data
    xs, ys = xs.astype(np.float32), ys.astype(np.float32)
    return (xs, ys) if n is None else (xs[:n], ys[:n])


def _take_jax_params(net, jnet):
    """The JAX edit's parameters, layer state and updater state in the
    port's edit (its re-initialized layers drew from another generator)."""
    return pt.from_jax_params(net, np_tree(jnet.params),
                              np_tree(jnet.updater_state),
                              np_tree(jnet.state))


# --------------------------- transfer learning -----------------------------
def test_transfer_freeze_and_replace_head_matches_jax(classification_data):
    xs, ys = _data(classification_data)
    jsrc, src = _base_pair()
    frozen_w = src.params[0]["W"].clone()

    def edit(m, lib, s):
        return (lib.TransferLearning.Builder(s)
                .fine_tune_configuration(
                    lib.FineTuneConfiguration.Builder()
                    .updater(m.Sgd(0.05)).l2(1e-3).build())
                .set_feature_extractor(1)
                .remove_output_layer()
                .add_layer(m.OutputLayer(n_out=5, loss="mcxent"))
                .build())
    jnew, new = edit(jx, jtl, jsrc), edit(pt, tl, src)
    assert new.conf.to_json() == jnew.conf.to_json()
    assert [l.frozen for l in new.layers] == [True, True, False]
    assert new.layers[2].n_in == 8 and new.device == src.device
    assert torch.equal(new.params[0]["W"], frozen_w)
    tree_close(new.params[:2], np_tree(jnew.params[:2]), 0.0)
    _take_jax_params(new, jnew)
    y5 = np.eye(5, dtype=np.float32)[np.random.default_rng(0).integers(
        0, 5, 64)]
    for _ in range(2):
        jnew.fit(jx.DataSet(xs[:64], y5))
        new.fit(pt.DataSet(xs[:64], y5))
        assert abs(new.score() - float(jnew.score())) <= STEP_TOL
    assert torch.equal(new.params[0]["W"], frozen_w)
    tree_close(new.params, np_tree(jnew.params), STEP_TOL)


def test_transfer_nout_replace_matches_jax():
    jsrc, src = _base_pair()
    jnew = jtl.TransferLearning.Builder(jsrc).nout_replace(1, 12).build()
    new = tl.TransferLearning.Builder(src).nout_replace(1, 12).build()
    assert new.conf.to_json() == jnew.conf.to_json()
    assert new.layers[1].n_out == 12 and new.layers[2].n_in == 12
    assert torch.equal(new.params[0]["W"], src.params[0]["W"])


def test_transfer_helper_featurize_matches_jax(classification_data):
    xs, ys = _data(classification_data, 32)
    jsrc, src = _base_pair()
    jnew = jtl.TransferLearning.Builder(jsrc).set_feature_extractor(0) \
        .build()
    new = tl.TransferLearning.Builder(src).set_feature_extractor(0).build()
    _take_jax_params(new, jnew)
    jh, h = jtl.TransferLearningHelper(jnew), tl.TransferLearningHelper(new)
    assert h.frozen_until == jh.frozen_until == 0
    jfeat = jh.featurize(jx.DataSet(xs, ys))
    feat = h.featurize(pt.DataSet(xs, ys))
    assert feat.features.shape == (32, 16)
    np.testing.assert_allclose(feat.features, np.asarray(jfeat.features),
                               rtol=0, atol=STEP_TOL)
    before = new.params[0]["W"].clone()
    jh.fit_featurized(jfeat)
    h.fit_featurized(feat)
    assert torch.equal(new.params[0]["W"], before)
    tree_close(new.params, np_tree(jnew.params), STEP_TOL)


def _graph_src(m, v, seed=11):
    b = (m.NeuralNetConfiguration.builder().seed(seed).updater(m.Sgd(0.1))
         .graph_builder().add_inputs("in")
         .add_layer("h1", m.DenseLayer(n_out=12, activation="tanh"), "in")
         .add_layer("h2", m.DenseLayer(n_out=8, activation="tanh"), "h1")
         .add_layer("out", m.OutputLayer(n_out=5, loss="mcxent"), "h2")
         .set_outputs("out")
         .set_input_types(m.InputType.feed_forward(6)))
    return b.build()


def test_graph_transfer_learning_builder_matches_jax():
    """Freeze an ancestor, nOutReplace a named layer, swap the head: the
    same configuration, h1 transferred bit for bit, and, with JAX's fresh
    layers, three steps within 1e-5 (h1 unmoved)."""
    jsrc = jax_init(JaxGraph(_graph_src(jx, jgraph)))
    src = port_twin(jsrc)

    def edit(m, lib, s):
        return (lib.GraphTransferLearning.GraphBuilder(s)
                .fine_tune_configuration(
                    lib.FineTuneConfiguration.Builder()
                    .updater(m.Sgd(0.05)).build())
                .set_feature_extractor("h1")
                .nout_replace("h2", 10)
                .remove_vertex_and_connections("out")
                .add_layer("new_out", m.OutputLayer(n_out=3, loss="mcxent"),
                           "h2")
                .set_outputs("new_out")
                .build())
    jnew, new = edit(jx, jtl, jsrc), edit(pt, tl, src)
    assert json.loads(new.conf.to_json()) == json.loads(jnew.conf.to_json())
    assert torch.equal(new.params["h1"]["W"], src.params["h1"]["W"])
    assert tuple(new.params["h2"]["W"].shape) == (12, 10)
    assert new.conf.vertices["h1"].frozen
    assert not new.conf.vertices["h2"].frozen
    _take_jax_params(new, jnew)
    h1 = new.params["h1"]["W"].clone()
    r = np.random.default_rng(0)
    x = r.normal(size=(16, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[r.integers(0, 3, 16)]
    for _ in range(3):
        jnew.fit(jx.DataSet(x, y))
        new.fit(pt.DataSet(x, y))
    assert torch.equal(new.params["h1"]["W"], h1)
    tree_close(new.params, np_tree(jnew.params), STEP_TOL)


def _merge_src(m, v):
    b = (m.NeuralNetConfiguration.builder().seed(1).updater(m.Sgd(0.1))
         .graph_builder().add_inputs("in")
         .add_layer("a", m.DenseLayer(n_out=4, activation="relu"), "in")
         .add_layer("bb", m.DenseLayer(n_out=4, activation="tanh"), "in")
         .add_vertex("m", v.MergeVertex(), "a", "bb")
         .add_layer("top", m.DenseLayer(n_out=6, activation="relu"), "m")
         .add_layer("out", m.OutputLayer(n_out=2, loss="mcxent"), "top")
         .set_outputs("out")
         .set_input_types(m.InputType.feed_forward(3)))
    return b.build()


@pytest.mark.parametrize("edit", ["freeze merge", "nout a", "remove a"])
def test_graph_transfer_through_a_merge_matches_jax(edit):
    """Freezing a merge vertex freezes both branches upstream; an
    nOutReplace, or a removed branch, changes the merge's width, which
    reaches `top` (re-inferred and re-initialized): the same
    configurations, shapes and transferred parameters as JAX, and, with
    JAX's fresh layers, a step within 1e-5."""
    jsrc = jax_init(JaxGraph(_merge_src(jx, jgraph)))
    src = port_twin(jsrc)

    def build(lib, s):
        b = lib.GraphTransferLearning.GraphBuilder(s)
        if edit == "freeze merge":
            b.set_feature_extractor("m")
        elif edit == "nout a":
            b.nout_replace("a", 8)
        else:
            b.remove_vertex_and_connections("a")
        return b.build()
    jnew, new = build(jtl, jsrc), build(tl, src)
    assert json.loads(new.conf.to_json()) == json.loads(jnew.conf.to_json())
    want_top = {"freeze merge": (8, 6), "nout a": (12, 6),
                "remove a": (4, 6)}[edit]
    assert tuple(new.params["top"]["W"].shape) == want_top
    if edit == "freeze merge":
        assert new.conf.vertices["a"].frozen
        assert new.conf.vertices["bb"].frozen
        assert not new.conf.vertices["top"].frozen
        assert torch.equal(new.params["top"]["W"], src.params["top"]["W"])
    _take_jax_params(new, jnew)
    r = np.random.default_rng(0)
    x = r.normal(size=(8, 3)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[r.integers(0, 2, 8)]
    jnew.fit(jx.DataSet(x, y))
    new.fit(pt.DataSet(x, y))
    assert abs(new.score() - float(jnew.score())) <= STEP_TOL
    tree_close(new.params, np_tree(jnew.params), STEP_TOL)


# --------------------------- early stopping --------------------------------
def _es_run(lib, net, mk_iter, xs, ys, epochs_conds, iter_conds=(),
            saver=None, save_last=False):
    cfg = (lib.EarlyStoppingConfiguration.Builder()
           .score_calculator(lib.DataSetLossCalculator(
               mk_iter(xs[192:], ys[192:], batch_size=64)))
           .epoch_termination_conditions(*epochs_conds)
           .iteration_termination_conditions(*iter_conds)
           .model_saver(saver or lib.InMemoryModelSaver())
           .save_last_model(save_last)
           .build())
    return lib.EarlyStoppingTrainer(
        cfg, net, mk_iter(xs[:192], ys[:192], batch_size=64)).fit()


def _check_same_run(res, jres):
    assert res.total_epochs == jres.total_epochs
    assert res.termination_reason == jres.termination_reason
    assert res.termination_details == jres.termination_details
    assert res.best_model_epoch == jres.best_model_epoch
    assert sorted(res.score_vs_epoch) == sorted(jres.score_vs_epoch)
    np.testing.assert_allclose(
        [res.score_vs_epoch[e] for e in sorted(res.score_vs_epoch)],
        [jres.score_vs_epoch[e] for e in sorted(jres.score_vs_epoch)],
        rtol=0, atol=TRAJ_TOL)


@pytest.mark.parametrize("cond", [
    "max epochs", "score improvement", "best score", "max score iteration",
    "invalid score iteration", "max time"])
def test_early_stopping_termination_conditions_match_jax(cond,
                                                         classification_data):
    """Each termination condition ends both trainers at the same epoch for
    the same reason, with the same validation scores and best epoch."""
    xs, ys = _data(classification_data)

    def conds(lib):
        ep, it = [lib.MaxEpochsTerminationCondition(
            4 if cond == "max epochs" else 40)], []
        if cond == "score improvement":
            ep.insert(0, lib.ScoreImprovementEpochTerminationCondition(
                1, 5e-2))
        elif cond == "best score":
            ep.insert(0, lib.BestScoreEpochTerminationCondition(0.5))
        elif cond == "max score iteration":
            it.append(lib.MaxScoreIterationTerminationCondition(1e-12))
        elif cond == "invalid score iteration":
            it.append(lib.InvalidScoreIterationTerminationCondition())
        elif cond == "max time":
            it.append(lib.MaxTimeIterationTerminationCondition(0.0))
        return ep, it
    jnet, net = _base_pair(seed=2)
    if cond == "invalid score iteration":
        xs = xs.copy()
        xs[0, 0] = np.nan             # the first batch scores NaN
    jres = _es_run(jes, jnet, jx.ArrayDataSetIterator, xs, ys, *conds(jes))
    res = _es_run(es, net, pt.ArrayDataSetIterator, xs, ys, *conds(es))
    if cond in ("max score iteration", "invalid score iteration",
                "max time"):
        assert res.termination_reason == "IterationTerminationCondition"
        assert res.total_epochs == jres.total_epochs == 0
        assert res.termination_details == jres.termination_details
    else:
        _check_same_run(res, jres)
        assert res.termination_reason == "EpochTerminationCondition"
        tree_close(res.best_model.params, np_tree(jres.best_model.params),
                   TRAJ_TOL)


def test_early_stopping_local_file_saver_matches_jax(tmp_path,
                                                     classification_data):
    """Both savers' zips in one directory each: the port's best and latest
    models restore (onto the device the model was trained on) with the
    JAX run's parameters, and each package restores the other's zip."""
    xs, ys = _data(classification_data)
    jnet, net = _base_pair(seed=3)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jres = _es_run(jes, jnet, jx.ArrayDataSetIterator, xs, ys,
                   [jes.MaxEpochsTerminationCondition(3)],
                   saver=jes.LocalFileModelSaver(jdir), save_last=True)
    saver = es.LocalFileModelSaver(pdir)
    res = _es_run(es, net, pt.ArrayDataSetIterator, xs, ys,
                  [es.MaxEpochsTerminationCondition(3)], saver=saver,
                  save_last=True)
    _check_same_run(res, jres)
    for name in ("bestModel.zip", "latestModel.zip"):
        assert os.path.exists(os.path.join(pdir, name))
    best = res.best_model
    assert isinstance(best, pt.MultiLayerNetwork)
    assert best.device.type == "cpu"
    tree_close(best.params, np_tree(jres.best_model.params), TRAJ_TOL)
    tree_close(saver.get_latest_model().params, np_tree(jnet.params),
               TRAJ_TOL)
    cross = pt.ModelSerializer.restore(os.path.join(jdir, "bestModel.zip"),
                                       device="cpu")
    tree_close(cross.params, np_tree(jres.best_model.params), 0.0)
    jcross = jx.ModelSerializer.restore(os.path.join(pdir, "bestModel.zip"))
    tree_close(best.params, np_tree(jcross.params), 0.0)
    calc = es.DataSetLossCalculator(pt.ArrayDataSetIterator(
        xs[192:], ys[192:], batch_size=64))
    assert abs(calc.calculate_score(best) - res.best_model_score) <= 1e-6


def test_early_stopping_graph_trainer_matches_jax(classification_data):
    """EarlyStoppingGraphTrainer on a single-input graph, in-memory saver:
    the same run as JAX's, and the best model a clone of the graph."""
    xs, ys = _data(classification_data)
    b = (jx.NeuralNetConfiguration.builder().seed(5).updater(jx.Adam(1e-2))
         .graph_builder().add_inputs("in")
         .add_layer("d", jx.DenseLayer(n_out=12, activation="relu"), "in")
         .add_layer("o", jx.OutputLayer(n_out=3), "d")
         .set_outputs("o").set_input_types(jx.InputType.feed_forward(10)))
    jg = jax_init(JaxGraph(b.build()))
    g = port_twin(jg)
    cond = lambda lib: [lib.MaxEpochsTerminationCondition(3)]
    jres = _es_run(jes, jg, jx.ArrayDataSetIterator, xs, ys, cond(jes))
    assert es.EarlyStoppingGraphTrainer is es.EarlyStoppingTrainer
    res = _es_run(es, g, pt.ArrayDataSetIterator, xs, ys, cond(es))
    _check_same_run(res, jres)
    assert isinstance(res.best_model, pt.ComputationGraph)
    assert res.best_model is not g
    tree_close(res.best_model.params, np_tree(jres.best_model.params),
               TRAJ_TOL)


def test_early_stopping_errors():
    class Empty:
        def reset(self):
            pass

        def has_next(self):
            return False
    with pytest.raises(ValueError, match="yielded no examples"):
        es.DataSetLossCalculator(Empty()).calculate_score(None)
    with pytest.raises(ValueError, match="need a model or a ParallelTrainer"):
        es.EarlyStoppingParallelTrainer(
            es.EarlyStoppingConfiguration(), model=None)


# --------------------------- ROC / regression ------------------------------
def _roc_cases():
    rng = np.random.default_rng(0)
    labels = np.array([0, 0, 1, 1, 0, 1] * 10)
    yield "perfect", labels, labels * 0.8 + 0.1, None, 50
    labels = rng.integers(0, 2, 5000)
    yield "random", labels, rng.random(5000), None, 100
    yield "one-hot", np.eye(2)[[0, 1, 1, 0]], np.array(
        [[0.9, 0.1], [0.2, 0.8], [0.3, 0.7], [0.6, 0.4]]), None, 100
    labels = rng.integers(0, 2, (8, 5))
    yield "masked series", labels, rng.random((8, 5)), \
        (rng.random((8, 5)) > 0.3).astype(np.float32), 20


@pytest.mark.parametrize("name,labels,probs,mask,steps", list(_roc_cases()))
def test_roc_matches_jax(name, labels, probs, mask, steps):
    jroc, roc = JaxROC(steps), pt.ROC(steps)
    for lo, hi in ((0, len(labels) // 2), (len(labels) // 2, len(labels))):
        m = None if mask is None else mask[lo:hi]
        jroc.eval(labels[lo:hi], probs[lo:hi], mask=m)
        # the port also takes tensors
        roc.eval(torch.as_tensor(labels[lo:hi]),
                 torch.as_tensor(probs[lo:hi]),
                 mask=None if m is None else torch.as_tensor(m))
    for k in ("tp", "fp", "fn", "tn"):
        np.testing.assert_array_equal(getattr(roc, k), getattr(jroc, k))
    assert roc.get_roc_curve() == jroc.get_roc_curve()
    assert roc.get_precision_recall_curve() == \
        jroc.get_precision_recall_curve()
    assert roc.calculate_auc() == jroc.calculate_auc()
    assert roc.calculate_auprc() == jroc.calculate_auprc()
    if name == "perfect":
        assert roc.calculate_auc() > 0.99


def test_roc_multiclass_matches_jax():
    rng = np.random.default_rng(1)
    labels = np.eye(3)[rng.integers(0, 3, 600)]
    logits = labels * 3.0 + rng.normal(0, 1.0, (600, 3))
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    jr, r = JaxROCMultiClass(), pt.ROCMultiClass()
    jr.eval(labels, probs)
    r.eval(labels, probs)
    assert r.num_classes == jr.num_classes == 3
    for c in range(3):
        assert r.calculate_auc(c) == jr.calculate_auc(c) > 0.85
        assert r.get_roc_curve(c) == jr.get_roc_curve(c)
    assert r.calculate_average_auc() == jr.calculate_average_auc()


def test_regression_evaluation_matches_jax():
    rng = np.random.default_rng(0)
    labels = rng.normal(size=(200, 2))
    preds = labels + rng.normal(0, 0.1, (200, 2))
    jre = JaxRegression(column_names=["a", "b"])
    re = pt.RegressionEvaluation(column_names=["a", "b"])
    for lo, hi in ((0, 100), (100, 200)):
        jre.eval(labels[lo:hi], preds[lo:hi])
        re.eval(torch.as_tensor(labels[lo:hi]), preds[lo:hi])
    for c in range(2):
        for f in ("mean_squared_error", "mean_absolute_error",
                  "root_mean_squared_error", "relative_squared_error",
                  "pearson_correlation"):
            assert getattr(re, f)(c) == pytest.approx(getattr(jre, f)(c),
                                                      rel=1e-12)
    for f in ("average_mean_squared_error", "average_mean_absolute_error",
              "average_root_mean_squared_error",
              "average_pearson_correlation"):
        assert getattr(re, f)() == pytest.approx(getattr(jre, f)(),
                                                 rel=1e-12)
    assert re.stats() == jre.stats()
    assert re.average_pearson_correlation() > 0.99


def test_regression_evaluation_masked_time_series_matches_jax():
    rng = np.random.default_rng(2)
    labels = rng.normal(size=(4, 6, 3))
    preds = labels + rng.normal(0, 0.3, (4, 6, 3))
    mask = (rng.random((4, 6)) > 0.4).astype(np.float64)
    jre, re = JaxRegression(n_columns=3), pt.RegressionEvaluation(n_columns=3)
    jre.eval_time_series(labels, preds, labels_mask=mask)
    re.eval_time_series(labels, torch.as_tensor(preds),
                        labels_mask=torch.as_tensor(mask))
    np.testing.assert_array_equal(re.count, jre.count)
    assert re.count[0] == mask.sum()
    np.testing.assert_allclose(re.sum_sq_err, jre.sum_sq_err, rtol=1e-12)
    assert re.stats() == jre.stats()
    ones = pt.RegressionEvaluation(n_columns=1)
    ones.eval_time_series(np.ones((2, 3, 1)), np.zeros((2, 3, 1)),
                          labels_mask=np.array([[1, 1, 0], [1, 0, 0]]))
    assert ones.count[0] == 3 and ones.mean_squared_error(0) == 1.0
