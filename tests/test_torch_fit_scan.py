"""PyTorch port, `fit_scan` / `fit_scan_arrays` on the CPU: the twins of
`tests/test_fit_scan.py`, the device-resident TBPTT epoch's replay
plumbing, and the port against JAX.

`fit_scan` is `fit(superstep="epoch")`, except for TBPTT configurations,
which run `fit_scan_arrays`' chunked epoch: the recurrent carries flow
from chunk to chunk of a series and restart from zeros at the next
series, and a ragged final chunk is padded under a zero label mask. Where
the sequence is a whole number of chunks the epoch is the per-batch
TBPTT `fit`, bit for bit (in the port, on either device); with a ragged
chunk it is the same function padded, held at rtol 5e-4 (JAX's own
test's). On the card the chunk step is replayed from one captured graph
with its recurrent carries among the statics; `replayed_on_cpu` runs it
eagerly here. Against JAX (the same start and batches): 1e-4 over the
trajectory.
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.zoo import char_rnn as jax_char_rnn
from deeplearning4j_tpu.datasets.iterators import DataSet as JaxDataSet
import deeplearning4j_tpu_torch as pt
from deeplearning4j_tpu_torch.models import char_rnn
from deeplearning4j_tpu_torch.nn import superstep as ss
from deeplearning4j_tpu_torch.nn.trees import flatten_tree
from deeplearning4j_tpu_torch.optimize.listeners import \
    CollectScoresIterationListener
from jax_reference import jax_init
from torch_threads import one_torch_thread  # noqa: F401

TRAJ_TOL = 1e-4


class _EagerGraph:
    """A CUDA graph's stand-in: each replay runs the captured compute and
    commit eagerly on the same static buffers."""

    def __init__(self, name, compute, commit, device, generators):
        self.compute, self.commit = compute, commit

    def replay(self):
        self.commit(self.compute())


@pytest.fixture
def replayed_on_cpu(monkeypatch):
    monkeypatch.setattr(ss, "_Graph", _EagerGraph)
    monkeypatch.setattr(ss, "_captures", lambda model: True)


def _mlp(seed=7):
    conf = (pt.NeuralNetConfiguration.builder()
            .seed(seed).updater(pt.Adam(1e-3)).list()
            .layer(pt.DenseLayer(n_out=32, activation="relu"))
            .layer(pt.OutputLayer(n_out=5, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(pt.InputType.feed_forward(12))
            .build())
    return pt.MultiLayerNetwork(conf, device="cpu").init()


def _batches(n=4, b=16, f=12, c=5, seed=0):
    r = np.random.default_rng(seed)
    return [pt.DataSet(r.normal(size=(b, f)).astype(np.float32),
                       np.eye(c, dtype=np.float32)[r.integers(0, c, b)])
            for _ in range(n)]


def _assert_params_close(a, b, rtol=2e-5, atol=1e-6):
    fa, fb = flatten_tree(a.params)[0], flatten_tree(b.params)[0]
    assert len(fa) == len(fb)
    for x, y in zip(fa, fb):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=rtol,
                                   atol=atol)


def _assert_bit_equal(a, b):
    for tree in ("params", "updater_state", "state"):
        fa = flatten_tree(getattr(a, tree))[0]
        fb = flatten_tree(getattr(b, tree))[0]
        assert len(fa) == len(fb)
        assert all(torch.equal(x, y) for x, y in zip(fa, fb)), tree
    assert a.iteration_count == b.iteration_count


def _char_series(V, seq, n, seed=1):
    r = np.random.default_rng(seed)
    idx = r.integers(0, V, (n, seq))
    eye = np.eye(V, dtype=np.float32)
    return eye[idx], eye[np.roll(idx, -1, 1)]


def test_fit_scan_matches_fit_mlp():
    batches = _batches()
    a, b = _mlp(), _mlp()
    for ds in batches:
        a.fit(ds)
    b.fit_scan(batches)
    _assert_params_close(a, b)
    assert b.iteration_count == a.iteration_count


def test_fit_scan_tbptt_ragged_tail_matches_fit():
    """seq 78 with tbptt 50 -> chunks [50, 28]; the epoch pads the tail to
    50 under a zero label mask: the reference's shorter final chunk."""
    V, seq = 11, 78
    x, y = _char_series(V, seq, 6)
    ds = pt.DataSet(x, y)
    a = char_rnn(vocab_size=V, seq_len=seq, lstm_size=12, device="cpu").init()
    b = char_rnn(vocab_size=V, seq_len=seq, lstm_size=12, device="cpu").init()
    a.fit(ds)
    b.fit_scan(ds)
    _assert_params_close(a, b, rtol=5e-4, atol=1e-5)
    assert a.iteration_count == b.iteration_count == 2


def test_fit_scan_tbptt_whole_chunks_bitexact_vs_fit():
    """seq 60 with tbptt 20: three whole chunks a series, two series
    batches; no padding, so the epoch is the per-batch TBPTT fit bit for
    bit (carries flowing within a series, zeroed between)."""
    V, seq = 9, 60
    x, y = _char_series(V, seq, 8)
    mk = lambda: char_rnn(vocab_size=V, seq_len=seq, lstm_size=10, tbptt=20,
                          device="cpu").init()
    a, b = mk(), mk()
    batches = [pt.DataSet(x[:4], y[:4]), pt.DataSet(x[4:], y[4:])]
    a.fit(pt.ListDataSetIterator(batches), epochs=2)
    b.fit_scan(batches, epochs=2)
    _assert_bit_equal(a, b)
    assert b.iteration_count == 12


def test_fit_scan_multi_epoch_and_listeners():
    net = _mlp()
    lis = CollectScoresIterationListener(frequency=1)
    net.add_listeners(lis)
    net.fit_scan(_batches(n=3), epochs=2)
    assert net.iteration_count == 6
    assert len(lis.scores) == 6
    assert all(np.isfinite(s) for _, s in lis.scores)


def test_fit_scan_rejects_ragged_batches():
    batches = _batches(n=2, b=16) + _batches(n=1, b=9)
    net = _mlp()
    with pytest.raises(ValueError, match="uniform batch shapes"):
        net.fit_scan(batches)


def test_fit_scan_arrays_takes_device_tensors():
    """Pre-stacked tensors on the network's device skip the copy and train
    as the numpy arrays do."""
    batches = _batches(n=3)
    xs = np.stack([b.features for b in batches])
    ys = np.stack([b.labels for b in batches])
    a, b = _mlp(), _mlp()
    a.fit_scan_arrays(xs, ys)
    b.fit_scan_arrays(torch.as_tensor(xs), torch.as_tensor(ys))
    _assert_bit_equal(a, b)


def test_fit_scan_arrays_rejects_line_search():
    conf = (pt.NeuralNetConfiguration.builder().seed(1)
            .optimization_algo("lbfgs").list()
            .layer(pt.OutputLayer(n_out=3, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(pt.InputType.feed_forward(4)).build())
    net = pt.MultiLayerNetwork(conf, device="cpu").init()
    with pytest.raises(ValueError, match="SGD-updater training only"):
        net.fit_scan_arrays(np.zeros((1, 2, 4), np.float32),
                            np.zeros((1, 2, 3), np.float32))


@pytest.mark.parametrize("seq,tbptt", [(60, 20), (50, 20)])
def test_replayed_tbptt_epoch_matches_the_eager_epoch(replayed_on_cpu, seq,
                                                     tbptt):
    """The chunk step replayed from one capture (its recurrent carries in
    the statics, zeroed at each series' first chunk) gives the eager
    epoch's bits, with and without a padded final chunk."""
    V = 9
    x, y = _char_series(V, seq, 8, seed=2)
    batches = [pt.DataSet(x[:4], y[:4]), pt.DataSet(x[4:], y[4:])]
    mk = lambda: char_rnn(vocab_size=V, seq_len=seq, lstm_size=10,
                          tbptt=tbptt, device="cpu").init()
    keep = ss._captures
    ss._captures = lambda model: False
    try:
        ref = mk()
        ref.fit_scan(batches, epochs=2)
    finally:
        ss._captures = keep
    m = mk()
    m.fit_scan(batches, epochs=2)
    _assert_bit_equal(ref, m)
    assert len(m._captured_steps) == 1


def test_bilstm_fit_scan_arrays_matches_the_per_batch_fit():
    """`test_bilstm_subsystems.py::test_bilstm_clone_and_fit_scan`'s
    fit_scan half: a GravesBidirectionalLSTM (a nested parameter tree)
    through fit_scan_arrays, finite, and bit-equal to the per-batch fit
    on the same two batches."""
    from deeplearning4j_tpu_torch.nn.layers import GravesBidirectionalLSTM
    conf = (pt.NeuralNetConfiguration.builder().seed(0)
            .updater(pt.Sgd(0.1)).list()
            .layer(GravesBidirectionalLSTM(n_out=6, activation="tanh"))
            .layer(pt.RnnOutputLayer(n_out=3, loss="mcxent"))
            .set_input_type(pt.InputType.recurrent(5, 7)).build())
    r = np.random.default_rng(0)
    x = r.normal(size=(8, 7, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[r.integers(0, 3, (8, 7))]
    a = pt.MultiLayerNetwork(conf, device="cpu").init()
    for _ in range(2):
        a.fit(pt.DataSet(x, y))
    b = pt.MultiLayerNetwork(conf, device="cpu").init()
    b.fit_scan_arrays(np.stack([x, x]), np.stack([y, y]))
    assert np.isfinite(float(b._score))
    _assert_bit_equal(a, b)


def test_graph_fit_scan_arrays_matches_the_per_batch_fit():
    """ComputationGraph.fit_scan_arrays (a single-input graph's [T, batch,
    ...] arrays, two epochs) is the per-batch fit over the same batches,
    bit for bit, and counts one graph/scan_epoch compile."""
    from deeplearning4j_tpu_torch import telemetry

    def graph():
        b = (pt.NeuralNetConfiguration.builder().seed(3)
             .updater(pt.Adam(1e-2)).graph_builder().add_inputs("in")
             .add_layer("d", pt.DenseLayer(n_out=16, activation="relu"),
                        "in")
             .add_layer("out", pt.OutputLayer(n_out=5, activation="softmax",
                                              loss="mcxent"), "d")
             .set_outputs("out")
             .set_input_types(pt.InputType.feed_forward(12)))
        return pt.ComputationGraph(b.build(), device="cpu").init()
    batches = _batches(n=3)
    a = graph()
    a.fit(pt.ListDataSetIterator(batches), epochs=2)
    b = graph()
    with telemetry.enabled() as sess:
        b.fit_scan_arrays(np.stack([d.features for d in batches]),
                          np.stack([d.labels for d in batches]), epochs=2)
    assert sess.compiles.count("graph/scan_epoch") == 1
    assert b.epoch_count == 2
    _assert_bit_equal(a, b)


_JAX_RUNS = {}


@pytest.fixture
def jax_tbptt_run(one_torch_thread):
    """The JAX run below, made once per module inside the port tests'
    one-core pin (a module-scoped fixture would run before the pin, and
    its XLA compiles would take every core)."""
    if "jax_tbptt_run" not in _JAX_RUNS:
        _JAX_RUNS["jax_tbptt_run"] = _jax_tbptt_run()
    return _JAX_RUNS["jax_tbptt_run"]


def _jax_tbptt_run():
    """JAX's fit_scan of a small char-RNN (seq 60, TBPTT 20, two series
    batches), its start and its final parameters."""
    V, seq = 9, 60
    x, y = _char_series(V, seq, 8, seed=3)
    jnet = jax_init(jax_char_rnn(vocab_size=V, seq_len=seq, lstm_size=10,
                                 tbptt=20))
    np_tree = lambda t: ({k: np_tree(v) for k, v in t.items()}
                         if isinstance(t, dict) else
                         type(t)(np_tree(v) for v in t)
                         if isinstance(t, (list, tuple)) else
                         np.array(t, np.float32))
    start = tuple(np_tree(t) for t in (jnet.params, jnet.updater_state,
                                       jnet.state))
    jnet.fit_scan([JaxDataSet(x[:4], y[:4]), JaxDataSet(x[4:], y[4:])])
    return start, (x, y), np_tree(jnet.params), float(
        np.asarray(jnet._score))


def test_fit_scan_tbptt_matches_jax(jax_tbptt_run):
    """The port's TBPTT epoch against JAX's scanned one from the same
    parameters and series: parameters and the last score within 1e-4."""
    start, (x, y), want_p, want_score = jax_tbptt_run
    net = char_rnn(vocab_size=9, seq_len=60, lstm_size=10, tbptt=20,
                   device="cpu").init()
    pt.from_jax_params(net, start[0], start[1], start[2])
    net.fit_scan([pt.DataSet(x[:4], y[:4]), pt.DataSet(x[4:], y[4:])])
    assert abs(float(net._score) - want_score) <= TRAJ_TOL
    for p, q in zip(net.params, want_p):
        for k in q:
            np.testing.assert_allclose(p[k].numpy(), q[k], rtol=0,
                                       atol=TRAJ_TOL)
