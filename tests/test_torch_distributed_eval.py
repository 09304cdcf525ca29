"""PyTorch port, the distributed evaluation and scoring plane on the CPU:
the twins of 16 of `tests/test_distributed_eval.py`'s 17 (its
tensor-parallel case is in `test_torch_tp_models.py`), and the documented
behaviour where
the JAX package's parallel plane has a known defect (ADVICE.md).

Network-level per-example scoring is held to JAX's at 1e-6 (float32).
The parallel plane runs on a world of 4 gloo ranks (`torch_world`): each
rank evaluates its contiguous row share of every batch and the counts are
all-reduced, so multi-rank evaluation equals the single model's exactly
(count-exact confusion matrices); per-example scores are gathered in rank
order and equal the single model's at 1e-6.

The four defects of ADVICE.md, done as documented:
  * `allgather_rows` keeps the input dtype (JAX's returns float64);
  * `allreduce_evaluation` keeps this rank's `predictions` records (JAX's
    drops them);
  * `score` over ranks with unequal batch counts runs in lockstep (JAX's
    per-call collective would desynchronize);
  * `reconstruction_log_probability` on a graph model raises the intended
    ValueError (JAX's raises AttributeError).
"""
import jax
import numpy as np
import pytest

import deeplearning4j_tpu as jx
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.parallel import ParallelTrainer as JaxTrainer
from deeplearning4j_tpu.parallel import make_mesh as jax_mesh
import deeplearning4j_tpu_torch as pt
from jax_reference import jax_init
from torch_threads import one_torch_thread, pinned  # noqa: F401
import torch_parallel_tasks as tasks
from torch_world import World


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    with pinned():
        w = World(4, tmp_path_factory.mktemp("world"), widths=(1, 2))
    yield w
    w.close()


def _conf(lib, seed=7, l2=0.0):
    return (lib.NeuralNetConfiguration.builder().seed(seed)
            .updater(lib.Sgd(0.1)).list()
            .layer(lib.DenseLayer(n_out=16, activation="tanh", l2=l2))
            .layer(lib.OutputLayer(n_out=4, loss="mcxent", l2=l2))
            .set_input_type(lib.InputType.feed_forward(8)).build())


def _graph_conf(lib, seed=11, l2=0.0):
    b = (lib.NeuralNetConfiguration.builder().seed(seed)
         .updater(lib.Sgd(0.1)).graph_builder())
    b.add_inputs("in")
    b.add_layer("d", lib.DenseLayer(n_out=16, activation="tanh", l2=l2),
                "in")
    b.add_layer("out", lib.OutputLayer(n_out=4, loss="mcxent", l2=l2), "d")
    b.set_outputs("out")
    b.set_input_types(lib.InputType.feed_forward(8))
    return b.build()


def _data(n=64, seed=0):
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, 8)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[r.integers(0, 4, n)]
    return x, y


def _pair(conf_fn, seed=7, l2=0.0, graph=False):
    """(JAX net, port net) with the same parameters."""
    if graph:
        j = jax_init(JaxGraph(conf_fn(jx, seed, l2)))
        p = tasks.build(j.conf.to_json(), np.asarray(j.params_flat()),
                        graph=True)
    else:
        j = jax_init(JaxNet(conf_fn(jx, seed, l2)))
        p = tasks.build(j.conf.to_json(), np.asarray(j.params_flat()))
    return j, p


# ----------------------------------------------------------------------
# per-example scoring on the networks themselves, against JAX
# ----------------------------------------------------------------------
def test_score_examples_shape_and_mean_matches_score():
    x, y = _data(32)
    j, m = _pair(_conf)
    per = m.score_examples(pt.DataSet(x, y), add_regularization_terms=False)
    assert per.shape == (32,)
    np.testing.assert_allclose(per.mean(), m.score(pt.DataSet(x, y)),
                               rtol=1e-6)
    np.testing.assert_allclose(
        per, j.score_examples(jx.DataSet(x, y), False), rtol=1e-6)


def test_score_examples_single_example_equivalence_with_reg():
    x, y = _data(8)
    j, m = _pair(_conf, l2=1e-2)
    per = m.score_examples(pt.DataSet(x, y), add_regularization_terms=True)
    for i in range(8):
        want = m.score(pt.DataSet(x[i:i + 1], y[i:i + 1]))
        np.testing.assert_allclose(per[i], want, rtol=1e-5)
    np.testing.assert_allclose(
        per, j.score_examples(jx.DataSet(x, y), True), rtol=1e-6)


def test_score_examples_reg_toggle():
    x, y = _data(16)
    _, m = _pair(_conf, l2=1e-2)
    diff = (m.score_examples(pt.DataSet(x, y), True)
            - m.score_examples(pt.DataSet(x, y), False))
    assert diff.min() > 0
    np.testing.assert_allclose(diff, diff[0], rtol=1e-5, atol=1e-6)


def test_score_examples_iterator_concatenates():
    x, y = _data(40)
    _, m = _pair(_conf)
    per_it = m.score_examples(pt.ArrayDataSetIterator(x, y, batch_size=16),
                              add_regularization_terms=False)
    per_ds = m.score_examples(pt.DataSet(x, y),
                              add_regularization_terms=False)
    np.testing.assert_allclose(per_it, per_ds, rtol=1e-6)


def _rnn_conf(lib, seed=1, C=3, F=4):
    return (lib.NeuralNetConfiguration.builder().seed(seed)
            .updater(lib.Sgd(0.05)).list()
            .layer(lib.GravesLSTM(n_out=8, activation="tanh"))
            .layer(lib.RnnOutputLayer(n_out=C, activation="softmax",
                                      loss="mcxent"))
            .set_input_type(lib.InputType.recurrent(F)).build())


def _rnn_data(B, T, F, C, seed):
    r = np.random.default_rng(seed)
    x = r.normal(size=(B, T, F)).astype(np.float32)
    y = np.eye(C, dtype=np.float32)[r.integers(0, C, (B, T))]
    lm = (r.random((B, T)) > 0.35).astype(np.float32)
    lm[:, 0] = 1.0
    return x, y, lm


def test_score_examples_rnn_masked_sums_over_time():
    B, T, F, C = 6, 5, 4, 3
    x, y, lm = _rnn_data(B, T, F, C, 3)
    j = jax_init(JaxNet(_rnn_conf(jx)))
    m = tasks.build(j.conf.to_json(), np.asarray(j.params_flat()))
    per = m.score_examples(pt.DataSet(x, y, labels_mask=lm), False)
    assert per.shape == (B,)
    probs = m.output(x).numpy()
    per_t = -np.sum(y * np.log(np.clip(probs, 1e-30, None)), axis=-1)
    np.testing.assert_allclose(per, (per_t * lm).sum(axis=1), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(
        per, j.score_examples(jx.DataSet(x, y, labels_mask=lm), False),
        rtol=1e-5, atol=1e-6)


def test_graph_score_examples_matches_multilayer():
    x, y = _data(24, seed=5)
    _, mln = _pair(_conf, seed=11, l2=1e-3)
    _, gm = _pair(_graph_conf, seed=11, l2=1e-3, graph=True)
    gm.params = {"d": mln.params[0], "out": mln.params[1]}
    ds = pt.DataSet(x, y)
    for reg in (True, False):
        np.testing.assert_allclose(gm.score_examples(ds, reg),
                                   mln.score_examples(ds, reg), rtol=1e-6)


def _vae_conf(lib, n_in=6):
    vae = (lib.VariationalAutoencoder if lib is jx
           else lib.nn.layers.generative.VariationalAutoencoder)
    return (lib.NeuralNetConfiguration.builder().seed(0)
            .updater(lib.Adam(1e-2)).list()
            .layer(vae(
                n_out=3, encoder_layer_sizes=(8,), decoder_layer_sizes=(8,),
                activation="tanh"))
            .layer(lib.OutputLayer(n_out=2, loss="mcxent"))
            .set_input_type(lib.InputType.feed_forward(n_in)).build())


def test_vae_reconstruction_log_probability_network_level():
    x = np.random.default_rng(2).normal(size=(12, 6)).astype(np.float32)
    m = pt.MultiLayerNetwork(_vae_conf(pt), device="cpu").init()
    lp = m.reconstruction_log_probability(x, num_samples=4, seed=3)
    assert lp.shape == (12,)
    np.testing.assert_array_equal(
        lp, m.reconstruction_log_probability(x, num_samples=4, seed=3))
    np.testing.assert_allclose(
        m.reconstruction_probability(x, num_samples=4, seed=3),
        np.exp(lp), rtol=1e-6)
    _, plain = _pair(_conf)
    with pytest.raises(ValueError):
        plain.reconstruction_log_probability(x)


# ----------------------------------------------------------------------
# the parallel plane: 4 ranks == the single model
# ----------------------------------------------------------------------
def _trained_single(conf_fn, l2=0.0, seed=9, steps=3, graph=False):
    """(configuration JSON, start parameters, the port model trained on
    one rank, the training batches)."""
    x, y = _data(64, seed=1)
    j, single = _pair(conf_fn, seed=seed, l2=l2, graph=graph)
    start = np.asarray(j.params_flat())
    for _ in range(steps):
        single.fit(pt.DataSet(x, y))
    return j.conf.to_json(), start, single, [(x, y)] * steps


def test_parallel_evaluate_matches_single_device_exactly(world):
    conf, start, single, train = _trained_single(_conf)
    x, y = _data(70, seed=2)       # 35-row batches: uneven over 4 ranks
    ev_s = single.evaluate(pt.ArrayDataSetIterator(x, y, batch_size=35))
    outs = world.run(tasks.plane, conf, start, train,
                     [(x[:35], y[:35]), (x[35:], y[35:])])
    for o in outs:
        np.testing.assert_array_equal(o["confusion"],
                                      ev_s.confusion.matrix)
        assert o["n"] == 70
    np.testing.assert_allclose(outs[0]["params"], single.params_flat(),
                               rtol=1e-5, atol=1e-6)


def test_parallel_evaluate_top_n_and_labels(world):
    conf, start, single, train = _trained_single(_conf)
    x, y = _data(48, seed=4)
    names = ["a", "b", "c", "d"]
    ev_s = single.evaluate(pt.ArrayDataSetIterator(x, y, batch_size=16),
                           labels_list=names, top_n=2)
    o = world.run(tasks.plane, conf, start, train,
                  [(x[i:i + 16], y[i:i + 16]) for i in (0, 16, 32)],
                  None, False, names, 2)[0]
    assert o["top_n_correct"] == ev_s.top_n_correct
    assert o["top_n_total"] == ev_s.top_n_total
    assert o["labels"] == names


def test_parallel_score_examples_matches_single_device(world):
    conf, start, single, train = _trained_single(_conf, l2=1e-3)
    x, y = _data(70, seed=6)
    o = world.run(tasks.plane, conf, start, train, [(x, y)],
                  examples=(x, y))[0]
    for reg, key in ((True, "reg"), (False, "noreg")):
        want = single.score_examples(pt.DataSet(x, y), reg)
        assert o[key].dtype == want.dtype == np.float32
        np.testing.assert_allclose(o[key], want, rtol=1e-6, atol=1e-9)


def test_parallel_evaluate_averaging_mode(world):
    """AVERAGING evaluates the averaged-replica view: the same counts as
    the synced-back model; 4 replicas against JAX's 4 devices."""
    x, y = _data(64, seed=1)
    j = jax_init(JaxNet(_conf(jx, 17)))
    start = np.asarray(j.params_flat())
    jt = JaxTrainer(j, mesh=jax_mesh({"data": 4}, devices=jax.devices()[:4]),
                    mode="averaging", averaging_frequency=2)
    jt.fit(jx.DataSet(x, y))
    jt.fit(jx.DataSet(x, y))
    jev = jt.evaluate(jx.ArrayDataSetIterator(x, y, batch_size=32))
    o = world.run(tasks.plane, j.conf.to_json(), start, [(x, y)] * 2,
                  [(x[:32], y[:32]), (x[32:], y[32:])],
                  {"mode": "averaging", "averaging_frequency": 2})[0]
    np.testing.assert_array_equal(o["confusion"], jev.confusion.matrix)


def test_parallel_vae_reconstruction_matches_single(world):
    x = np.random.default_rng(8).normal(size=(40, 6)).astype(np.float32)
    m = pt.MultiLayerNetwork(_vae_conf(pt), device="cpu").init()
    flat = m.params_flat()
    want = m.reconstruction_log_probability(x, num_samples=4, seed=5)
    o = world.run(tasks.plane, m.conf.to_json(), flat, [], [],
                  recon=(x, 4, 5), width=1)[0]
    np.testing.assert_allclose(o["recon"], want, rtol=1e-5, atol=1e-8)
    # across ranks each rank scores its row share with the seed, as JAX's
    # multi-process path does: every rank returns the same rows, and each
    # share equals the model's score of that share alone
    o4 = world.run(tasks.plane, m.conf.to_json(), flat, [], [],
                   recon=(x, 4, 5))
    for r in o4:
        assert r["recon"].shape == (40,) and r["recon"].dtype == np.float32
        np.testing.assert_array_equal(r["recon"], o4[0]["recon"])
    for i in range(4):
        share = m.reconstruction_log_probability(x[10 * i:10 * (i + 1)],
                                                 num_samples=4, seed=5)
        np.testing.assert_allclose(o4[0]["recon"][10 * i:10 * (i + 1)],
                                   share, rtol=1e-5, atol=1e-8)


def test_graph_parallel_evaluate_and_score_examples(world):
    conf, start, single, train = _trained_single(_graph_conf, seed=21,
                                                 steps=1, graph=True)
    x, y = _data(64, seed=1)
    ev_s = single.evaluate(pt.ArrayDataSetIterator(x, y, batch_size=32))
    o = world.run(tasks.plane, conf, start, train,
                  [(x[:32], y[:32]), (x[32:], y[32:])], None, True,
                  examples=(x, y))[0]
    np.testing.assert_array_equal(o["confusion"], ev_s.confusion.matrix)
    np.testing.assert_allclose(o["reg"],
                               single.score_examples(pt.DataSet(x, y), True),
                               rtol=1e-6, atol=1e-9)


def test_parallel_evaluate_masked_rnn_matches_single(world):
    B, T, F, C = 20, 7, 5, 3
    x, y, lm = _rnn_data(B, T, F, C, 11)
    j = jax_init(JaxNet(_rnn_conf(jx, seed=3, C=C, F=F)))
    start = np.asarray(j.params_flat())
    single = tasks.build(j.conf.to_json(), start)
    evb = [(x[:12], y[:12], None, lm[:12]), (x[12:], y[12:], None, lm[12:])]
    ev_s = single.evaluate(pt.ListDataSetIterator(tasks._datasets(evb)))
    o = world.run(tasks.plane, j.conf.to_json(), start, [], evb,
                  examples=(x, y, None, lm))[0]
    np.testing.assert_array_equal(o["confusion"], ev_s.confusion.matrix)
    assert o["n"] == int(lm.sum())
    np.testing.assert_allclose(
        o["noreg"], single.score_examples(pt.DataSet(x, y, labels_mask=lm),
                                          False), rtol=1e-6, atol=1e-9)


def _exotic_confs(lib):
    r = np.random.default_rng(13)
    xe = r.integers(0, 30, (32, 1)).astype(np.float32)
    ye = np.eye(4, dtype=np.float32)[r.integers(0, 4, 32)]
    xc = r.normal(size=(32, 10)).astype(np.float32)
    return [
        ((lib.NeuralNetConfiguration.builder().seed(2).updater(lib.Sgd(0.1))
          .list().layer(lib.EmbeddingLayer(n_in=30, n_out=8))
          .layer(lib.OutputLayer(n_out=4, loss="mcxent"))
          .set_input_type(lib.InputType.feed_forward(1)).build()), xe, ye),
        ((lib.NeuralNetConfiguration.builder().seed(4).updater(lib.Sgd(0.1))
          .list().layer(lib.DenseLayer(n_out=8, activation="tanh"))
          .layer(lib.CenterLossOutputLayer(n_out=4, loss="mcxent"))
          .set_input_type(lib.InputType.feed_forward(10)).build()), xc, ye),
        ((lib.NeuralNetConfiguration.builder().seed(6).updater(lib.Sgd(0.1))
          .list().layer(lib.VariationalAutoencoder(
              n_out=4, encoder_layer_sizes=(8,), decoder_layer_sizes=(8,),
              activation="tanh"))
          .layer(lib.OutputLayer(n_out=4, loss="mcxent"))
          .set_input_type(lib.InputType.feed_forward(10)).build()), xc, ye)]


@pytest.mark.parametrize("case", [0, 1, 2])
def test_parallel_dp_exotic_layers_match_single(world, case):
    """Embedding, CenterLoss head, supervised VAE encoder: 2 ranks against
    JAX's 8-device mesh (dropout-free, the same start), 2e-5 as JAX's own
    dp == single bound."""
    conf, x, y = _exotic_confs(jx)[case]
    j = jax_init(JaxNet(conf))
    start = np.asarray(j.params_flat())
    jt = JaxTrainer(j, mesh=jax_mesh({"data": 8}))
    for _ in range(3):
        jt.fit(jx.DataSet(x, y))
    jt._sync_back()
    o = world.run(tasks.train, conf.to_json(), start, [(x, y)] * 3,
                  width=2)[0]
    np.testing.assert_allclose(o["params"], np.asarray(j.params_flat()),
                               rtol=2e-5, atol=1e-6)


def test_graph_multidataset_parallel_evaluate_and_score(world):
    def gconf(lib):
        b = (lib.NeuralNetConfiguration.builder().seed(23)
             .updater(lib.Sgd(0.1)).graph_builder())
        b.add_inputs("a", "b")
        b.add_layer("ha", lib.DenseLayer(n_out=8, activation="tanh"), "a")
        b.add_layer("hb", lib.DenseLayer(n_out=8, activation="tanh"), "b")
        b.add_vertex("m", lib.nn.conf.graph.MergeVertex(), "ha", "hb")
        b.add_layer("out", lib.OutputLayer(n_out=3, loss="mcxent"), "m")
        b.set_outputs("out")
        b.set_input_types(lib.InputType.feed_forward(5),
                          lib.InputType.feed_forward(7))
        return b.build()
    r = np.random.default_rng(4)
    xa = r.normal(size=(44, 5)).astype(np.float32)
    xb = r.normal(size=(44, 7)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[r.integers(0, 3, 44)]
    j = jax_init(JaxGraph(gconf(jx)))
    start = np.asarray(j.params_flat())
    single = tasks.build(j.conf.to_json(), start, graph=True)
    single.fit(pt.MultiDataSet(features=[xa[:32], xb[:32]], labels=[y[:32]]))
    mds = {"features": [xa, xb], "labels": [y]}
    ev_s = single.evaluate(pt.ListDataSetIterator(tasks._datasets([mds])))
    o = world.run(tasks.plane, j.conf.to_json(), start,
                  [{"features": [xa[:32], xb[:32]], "labels": [y[:32]]}],
                  [mds], None, True, examples=mds)[0]
    np.testing.assert_array_equal(o["confusion"], ev_s.confusion.matrix)
    assert o["n"] == 44
    np.testing.assert_allclose(
        o["reg"], single.score_examples(tasks._datasets([mds])[0], True),
        rtol=1e-6, atol=1e-9)


# ----------------------------------------------------------------------
# the four ADVICE.md defects, done as documented
# ----------------------------------------------------------------------
def test_allgather_rows_keeps_the_input_dtype(world):
    outs = world.run(tasks.allgather_dtypes, width=4)
    for o in outs:
        assert o["dtype"] == "float32"
        np.testing.assert_array_equal(
            o["rows"], np.asarray([0, 1, 2, 20, 21, 22, 30, 31, 32],
                                  np.float32))
        assert o["int_dtype"] == "int64"
        np.testing.assert_array_equal(o["ints"], [0, 1, 1, 2, 2, 3, 3, 4])


def test_allreduce_evaluation_keeps_predictions(world):
    outs = world.run(tasks.evaluation_keeps_predictions, width=2)
    for r, o in enumerate(outs):
        assert o["n"] == 6
        assert o["meta"] == [f"r{r}-{i}" for i in range(3)]
        np.testing.assert_array_equal(o["matrix"], outs[0]["matrix"])


def test_score_runs_in_lockstep_over_unequal_shards(world):
    """Ranks with different numbers of validation batches (rank 0 one
    more): score, score_examples and evaluate all finish, agree on every
    rank, and equal the single model over the union of the batches."""
    conf, start, single, _ = _trained_single(_conf, steps=0)
    x, y = _data(96, seed=8)
    batches = [(x[i:i + 16], y[i:i + 16]) for i in range(0, 96, 16)]
    outs = world.run(tasks.unequal_lockstep, conf, start, batches, width=2)
    union = batches[0::2] + [batches[0]] + batches[1::2]
    it = pt.ListDataSetIterator(tasks._datasets(union))
    want_ex = np.concatenate([single.score_examples(d, True)
                              for d in tasks._datasets(union)])
    for o in outs:
        assert o["score"] == pytest.approx(outs[0]["score"], rel=0)
        assert o["n_examples"] == 16 * 7
        np.testing.assert_allclose(np.sort(o["examples"]), np.sort(want_ex),
                                   rtol=1e-6, atol=1e-9)
    want = sum(single.score(d) * d.num_examples()
               for d in tasks._datasets(union)) / (16 * 7)
    assert outs[0]["score"] == pytest.approx(want, rel=1e-6)


def test_graph_reconstruction_log_probability_raises_value_error(world):
    msg = world.run(tasks.graph_recon_error, _graph_conf(jx).to_json(),
                    width=2)
    assert all(m and "VariationalAutoencoder" in m for m in msg)
