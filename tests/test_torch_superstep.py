"""PyTorch port, `fit(superstep=K)` on the CPU: the twins of
`tests/test_superstep.py` (bar its ParallelTrainer cases, ROADMAP A11),
the window's replay plumbing, and the port against JAX.

Within the port every check is bit-exact: K windows regroup the per-batch
steps, so parameters, updater state, layer state, dropout generators and
counters equal K=1's for any grouping (ragged tails, "epoch", "auto",
resume at a non-window-aligned batch, guard rollback onto the pre-window
snapshot). On the card a window is replays of a captured CUDA graph; here
`replayed_on_cpu` stands in for the graph (each replay runs the captured
step's compute and commit eagerly), so the static buffers, the binding of
the model to the carries and the per-step scalar rows (0-dim tensors where
the eager step multiplies by Python floats) are held bit-equal to the
eager loop. A failed capture raises and trains nothing. Against JAX
(dropout-free, from the same parameters and batches): the parity gate's
1e-4 over a trajectory.
"""
import glob
import json
import logging
import zipfile

import numpy as np
import pytest
import torch

import deeplearning4j_tpu as jx
from deeplearning4j_tpu.datasets.iterators import \
    ArrayDataSetIterator as JaxArrayIt
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
import deeplearning4j_tpu_torch as pt
from deeplearning4j_tpu_torch.datasets.iterators import ArrayDataSetIterator
from deeplearning4j_tpu_torch.fault import (FaultyIterator, GuardPolicy,
                                            NonFiniteScoreError,
                                            TrainingGuard)
from deeplearning4j_tpu_torch.nn import superstep as ss
from deeplearning4j_tpu_torch.nn import updaters as upd
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.superstep import (CaptureError,
                                                   auto_superstep_k,
                                                   validate_superstep)
from deeplearning4j_tpu_torch.nn.trees import flatten_tree
from deeplearning4j_tpu_torch.optimize.listeners import (
    IterationListener, PerformanceListener)
from deeplearning4j_tpu_torch.telemetry import runtime as tel_runtime
from deeplearning4j_tpu_torch.telemetry.runtime import TelemetrySession
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


def _conf(lib, seed=7, dropout=0.0):
    return (lib.NeuralNetConfiguration.builder()
            .seed(seed).updater(lib.Adam(1e-3)).list()
            .layer(lib.DenseLayer(n_out=32, activation="relu",
                                  dropout=dropout or None))
            .layer(lib.OutputLayer(n_out=5, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(lib.InputType.feed_forward(12))
            .build())


def _mlp(seed=7, dropout=0.0):
    return pt.MultiLayerNetwork(_conf(pt, seed, dropout), device="cpu").init()


def _graph(seed=7, dropout=0.0):
    b = (pt.NeuralNetConfiguration.builder()
         .seed(seed).updater(pt.Adam(1e-3))
         .graph_builder().add_inputs("in")
         .set_input_types(pt.InputType.feed_forward(12)))
    b.add_layer("d", pt.DenseLayer(n_out=16, activation="relu",
                                   dropout=dropout or None), "in")
    b.add_layer("out", pt.OutputLayer(n_out=5, activation="softmax",
                                      loss="mcxent"), "d")
    b.set_outputs("out")
    return pt.ComputationGraph(b.build(), device="cpu").init()


def _data(n, f=12, c=5, seed=0):
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, f)).astype(np.float32)
    y = np.eye(c, dtype=np.float32)[r.integers(0, c, n)]
    return x, y


def _it(x, y, batch=16):
    return ArrayDataSetIterator(x, y, batch_size=batch)


def _assert_bit_equal(a, b):
    fa, fb = flatten_tree(a)[0], flatten_tree(b)[0]
    assert len(fa) == len(fb)
    for p, q in zip(fa, fb):
        assert p.dtype == q.dtype and torch.equal(p, q)


def _assert_same_run(a, b):
    _assert_bit_equal(a.params, b.params)
    _assert_bit_equal(a.updater_state, b.updater_state)
    _assert_bit_equal(a.state, b.state)
    assert a.iteration_count == b.iteration_count
    assert a.epoch_count == b.epoch_count


def _gen_state(net):
    gens = net._dropout_generators()
    return [g.get_state() for g in gens]


# ---------------------------------------------------------------------------
# bit-exact equivalence, both model kinds
# ---------------------------------------------------------------------------
def test_superstep_bitexact_vs_perbatch_mlp():
    """K=3 windows over 7 batches + a ragged 9-row tail (its own window):
    parameters, updater state, dropout generator and counters all
    bit-equal to K=1."""
    x, y = _data(7 * 16 + 9)
    a = _mlp(dropout=0.5)
    a.fit(_it(x, y), epochs=2)
    b = _mlp(dropout=0.5)
    b.fit(_it(x, y), epochs=2, superstep=3)
    _assert_same_run(a, b)
    assert all(torch.equal(u, v) for u, v in zip(_gen_state(a),
                                                 _gen_state(b)))
    assert a.iteration_count == b.iteration_count == 16
    assert a.epoch_count == b.epoch_count == 2


def test_superstep_bitexact_vs_perbatch_graph():
    x, y = _data(6 * 8)
    a = _graph(dropout=0.3)
    a.fit(_it(x, y, batch=8), epochs=2)
    b = _graph(dropout=0.3)
    b.fit(_it(x, y, batch=8), epochs=2, superstep=4)
    _assert_same_run(a, b)
    assert all(torch.equal(u, v) for u, v in zip(_gen_state(a),
                                                 _gen_state(b)))


def test_superstep_epoch_and_auto_knobs():
    x, y = _data(5 * 16)
    a = _mlp()
    a.fit(_it(x, y), epochs=1)
    for knob in ("epoch", "auto", 1 << 10):
        m = _mlp()
        m.fit(_it(x, y), epochs=1, superstep=knob)
        _assert_bit_equal(a.params, m.params)
    assert auto_superstep_k(1) >= 1
    assert auto_superstep_k(1 << 40) == 1
    assert validate_superstep(4) == 4
    with pytest.raises(ValueError, match="superstep"):
        validate_superstep(0)
    with pytest.raises(ValueError, match="superstep"):
        validate_superstep("sometimes")


def test_fit_scan_is_superstep_alias_bitexact():
    """fit_scan == fit(superstep='epoch') == per-batch fit, bit-equal."""
    x, y = _data(4 * 16)
    a = _mlp()
    a.fit(_it(x, y), epochs=2)
    b = _mlp()
    b.fit_scan(list(_it(x, y)), epochs=2)
    _assert_bit_equal(a.params, b.params)
    assert a.iteration_count == b.iteration_count


def test_superstep_compile_counts():
    """pad_ragged keeps the epoch to one batch signature, so the fit costs
    one nn/superstep compile — in the port one capture per batch
    signature, whatever the window lengths ([2, 2, 1] here) — and no
    per-batch train_step one; superstep='epoch' costs exactly one too."""
    x, y = _data(4 * 16 + 7)
    m = _mlp()
    sess = TelemetrySession()
    with tel_runtime.enabled(sess):
        m.fit(_it(x, y), epochs=2, superstep=2, pad_ragged=True)
    assert sess.compiles.count("nn/superstep") == 1
    assert sess.compiles.count("nn/train_step") == 0

    m2 = _mlp()
    sess2 = TelemetrySession()
    with tel_runtime.enabled(sess2):
        m2.fit(_it(x, y), epochs=2, superstep="epoch", pad_ragged=True)
    assert sess2.compiles.count("nn/superstep") == 1
    assert sess2.compiles.count("nn/train_step") == 0


def test_superstep_compile_counts_follow_signatures(replayed_on_cpu):
    """Without padding the ragged tail is a second signature: a second
    capture, counted once however many epochs replay it."""
    x, y = _data(4 * 16 + 7)
    m = _mlp()
    sess = TelemetrySession()
    with tel_runtime.enabled(sess):
        m.fit(_it(x, y), epochs=3, superstep=2)
    assert sess.compiles.count("nn/superstep") == 2
    assert len(m._captured_steps) == 2


def test_superstep_listeners_consume_host_window_scores():
    """Listener replay at window edges hands every iteration_done a HOST
    scalar from the window's score vector."""
    seen = []

    class Probe(IterationListener):
        def iteration_done(self, model, iteration):
            seen.append((iteration, model._score,
                         isinstance(model._score, (float, np.floating))))

    x, y = _data(6 * 16)
    m = _mlp()
    perf = PerformanceListener(frequency=2, report_score=True,
                               printer=lambda s: None)
    m.set_listeners(Probe(), perf)
    m.fit(_it(x, y), epochs=1, superstep=3)
    assert len(seen) == 6
    assert all(host for _, _, host in seen), "device score leaked into replay"
    assert all(np.isfinite(s) for _, s, _ in seen)
    assert [i for i, _, _ in seen] == list(range(1, 7))
    assert len(perf.history) == 3
    assert all(np.isfinite(r["score"]) for r in perf.history)


# ---------------------------------------------------------------------------
# guard at window granularity
# ---------------------------------------------------------------------------
def test_superstep_guard_rollback_lands_on_presuperstep_snapshot():
    """NaN injected inside window 2 discards the WHOLE window: parameters
    land bit-exactly on the pre-window snapshot (= the model after window
    1 only)."""
    x, y = _data(8 * 16)
    ref = _mlp()
    ref.fit(ArrayDataSetIterator(x[:4 * 16], y[:4 * 16], batch_size=16),
            epochs=1, superstep=4)

    m = _mlp()
    it = FaultyIterator(_it(x, y), nan_at=5)
    guard = TrainingGuard(policy=GuardPolicy.ROLLBACK, refresh_every=100)
    m.fit(it, epochs=1, superstep=4, guard=guard)
    _assert_same_run(ref, m)
    assert m.iteration_count == 4
    assert guard.nonfinite_steps >= 1


def test_superstep_guard_rollback_replayed(replayed_on_cpu):
    """The same rollback through the replay path: the snapshot is a clone
    taken before the replays, which update the model's tensors in place,
    and the restored model is bound to the carries again."""
    x, y = _data(12 * 16)
    keep = np.r_[0:4 * 16, 8 * 16:12 * 16]
    ref = _mlp()
    ref.fit(ArrayDataSetIterator(x[keep], y[keep], batch_size=16),
            superstep=4)
    m = _mlp()
    guard = TrainingGuard(policy=GuardPolicy.ROLLBACK, refresh_every=100)
    m.fit(FaultyIterator(_it(x, y), nan_at=6), superstep=4, guard=guard)
    _assert_same_run(ref, m)


def test_fit_scan_alias_stages_epoch_window_once():
    """The epoch window re-presents the same batch objects every epoch:
    staging is memoized (one stack for three epochs), and the reused
    tensors still train bit-exactly."""
    from deeplearning4j_tpu_torch.nn.multilayer import \
        _NetworkSuperstepAdapter

    x, y = _data(4 * 16)
    calls = []
    orig = _NetworkSuperstepAdapter.stage

    def counting_stage(self, window):
        calls.append(len(window))
        return orig(self, window)

    a = _mlp()
    a.fit(_it(x, y), epochs=3)
    b = _mlp()
    try:
        _NetworkSuperstepAdapter.stage = counting_stage
        b.fit_scan(list(_it(x, y)), epochs=3)
    finally:
        _NetworkSuperstepAdapter.stage = orig
    assert calls == [4]
    _assert_bit_equal(a.params, b.params)


def test_superstep_guard_halt_raises():
    x, y = _data(4 * 16)
    m = _mlp()
    it = FaultyIterator(_it(x, y), nan_at=1)
    with pytest.raises(NonFiniteScoreError):
        m.fit(it, epochs=1, superstep=2,
              guard=TrainingGuard(policy=GuardPolicy.HALT))


# ---------------------------------------------------------------------------
# checkpoint / resume at window granularity
# ---------------------------------------------------------------------------
def test_superstep_kill_mid_fit_resume_nonaligned(tmp_path):
    """Kill mid-fit with the last checkpoint at batch 4 (a K=2 window
    edge), then resume with K=3: the windows regroup and the run still
    matches the uninterrupted one bit-exactly."""
    d = str(tmp_path / "ckpt")
    x, y = _data(8 * 16)
    ref = _mlp(dropout=0.2)
    ref.fit(_it(x, y), epochs=2, superstep=3)

    m1 = _mlp(dropout=0.2)
    it = FaultyIterator(_it(x, y), raise_at=6, exc=RuntimeError)
    with pytest.raises(RuntimeError):
        m1.fit(it, epochs=2, superstep=2, checkpoint_dir=d,
               checkpoint_every=3)

    m2 = _mlp(dropout=0.2)
    m2.fit(_it(x, y), epochs=2, superstep=3, checkpoint_dir=d, resume=True)
    _assert_same_run(ref, m2)
    assert all(torch.equal(u, v) for u, v in zip(_gen_state(ref),
                                                 _gen_state(m2)))


def test_superstep_resume_from_perbatch_checkpoint(tmp_path):
    """A checkpoint written by the K=1 per-batch loop resumes through the
    window loop: one training loop, one store."""
    d = str(tmp_path / "ckpt")
    x, y = _data(6 * 16)
    ref = _mlp()
    ref.fit(_it(x, y), epochs=1)

    m1 = _mlp()
    it = FaultyIterator(_it(x, y), raise_at=5, exc=RuntimeError)
    with pytest.raises(RuntimeError):
        m1.fit(it, epochs=1, checkpoint_dir=d, checkpoint_every=2)
    m2 = _mlp()
    m2.fit(_it(x, y), epochs=1, superstep="epoch", checkpoint_dir=d,
           resume=True)
    _assert_bit_equal(ref.params, m2.params)
    assert ref.iteration_count == m2.iteration_count


def test_checkpointer_on_batches_saves_at_window_edge(tmp_path):
    """The interval save fires at the window edge with a consistent
    cursor."""
    d = str(tmp_path / "ckpt")
    x, y = _data(8 * 16)
    m = _mlp()
    m.fit(_it(x, y), epochs=1, superstep=4, checkpoint_dir=d,
          checkpoint_every=3)
    metas = []
    for z in sorted(glob.glob(d + "/ckpt_*.zip")):
        with zipfile.ZipFile(z) as zf:
            metas.append(json.loads(zf.read("metadata.json").decode()))
    cursors = {mm.get("reason"): mm.get("batches_into_epoch")
               for mm in metas}
    assert cursors.get("interval") == 4
    assert cursors.get("fit_end") == 0


def test_superstep_listener_replay_sees_own_window_params():
    """With listeners attached, window i is finalized before window i+1
    is enqueued, so a parameter-reading listener sees the parameters at
    the end of its own window."""
    x, y = _data(6 * 16)
    snapshots = {}

    class ParamProbe(IterationListener):
        def iteration_done(self, model, iteration):
            snapshots[iteration] = model.params[0]["W"].detach().clone()

    m = _mlp()
    m.set_listeners(ParamProbe())
    m.fit(_it(x, y), epochs=1, superstep=3)
    ref = _mlp()
    expect, i = {}, 0
    it = _it(x, y)
    while it.has_next():
        ref.fit(it.next())
        i += 1
        expect[i] = ref.params[0]["W"].detach().clone()
    assert torch.equal(snapshots[3], expect[3])
    assert torch.equal(snapshots[6], expect[6])


# ---------------------------------------------------------------------------
# the replay path (the card's), on the CPU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["mlp", "graph"])
@pytest.mark.parametrize("k", [1, 3, "epoch"])
def test_replayed_windows_match_the_eager_loop(replayed_on_cpu, kind, k):
    """Windows replayed from one captured step per signature (a ragged
    tail's own) give the eager per-batch loop's bits, dropout included;
    the model is left bound to the capture's carries."""
    x, y = _data(7 * 8 + 5)
    make = _mlp if kind == "mlp" else _graph
    ss_captures = ss._captures
    ss._captures = lambda model: False
    try:
        ref = make(dropout=0.4)
        ref.fit(_it(x, y, batch=8), epochs=2)
    finally:
        ss._captures = ss_captures
    m = make(dropout=0.4)
    m.fit(_it(x, y, batch=8), epochs=2, superstep=k)
    _assert_same_run(ref, m)
    assert all(torch.equal(u, v) for u, v in zip(_gen_state(ref),
                                                 _gen_state(m)))
    caps = list(m.__dict__.get("_captured_steps", {}).values())
    if k == 1:                      # the per-batch loop captures nothing
        assert not caps
        return
    assert len(caps) == 2           # the full batches' and the tail's
    leaves = flatten_tree(m._carry_trees())[0]
    assert any(all(a is b for a, b in zip(leaves, c.carries)) for c in caps)


def test_replayed_window_after_an_eager_step_binds_the_new_state(
        replayed_on_cpu):
    """Work on the model between windows (an eager step, a parameter
    write) rebinds its tensors; the next window copies them into the
    carries before replaying."""
    x, y = _data(6 * 16)
    ref = _mlp()
    m = _mlp()
    for net in (ref, m):
        net.fit(_it(x, y), superstep=3)
        net.fit(pt.DataSet(x[:16], y[:16]))          # one eager step
        net.set_params_flat(net.params_flat() * 0.5)
    ss_captures = ss._captures
    ss._captures = lambda model: False
    try:
        ref.fit(_it(x, y), superstep=3)
    finally:
        ss._captures = ss_captures
    m.fit(_it(x, y), superstep=3)
    _assert_same_run(ref, m)


def test_a_model_with_captures_is_freed_without_the_cycle_collector(
        replayed_on_cpu):
    """A model and its captured steps form no reference cycle (nor does
    its watched per-batch step): dropping the last reference frees the
    model and its graphs at once. A cycle would leave them to the cyclic
    collector, which may run in the middle of another capture, and a
    graph destroyed there invalidates that capture on the card."""
    import gc
    import weakref
    x, y = _data(4 * 16)
    m = _mlp(dropout=0.3)
    with tel_runtime.enabled(TelemetrySession()):
        m.fit(_it(x, y), superstep=2, grad_accumulation=2)
        m.fit(_it(x, y), superstep=2)
        m.fit(pt.DataSet(x[:16], y[:16]))
    assert len(m._captured_steps) == 2
    ref = weakref.ref(m)
    collecting = gc.isenabled()
    gc.disable()
    try:
        del m
        assert ref() is None
    finally:
        if collecting:
            gc.enable()


def test_capture_failure_raises_and_does_not_fall_back(monkeypatch):
    """On the card a window captures or raises: a capture that fails
    raises CaptureError naming what failed, and no step is trained
    eagerly in its place."""
    class FailingGraph:
        def __init__(self, name, compute, commit, device, generators):
            raise CaptureError(f"{name}: capturing the training step as a "
                               "CUDA graph failed at: RuntimeError: "
                               "operation not permitted when stream is "
                               "capturing (aten::nonzero)")

    monkeypatch.setattr(ss, "_Graph", FailingGraph)
    monkeypatch.setattr(ss, "_captures", lambda model: True)
    x, y = _data(4 * 16)
    m = _mlp()
    before = m.params_flat()
    with pytest.raises(CaptureError, match="aten::nonzero"):
        m.fit(_it(x, y), superstep=2)
    assert m.iteration_count == 0
    np.testing.assert_array_equal(m.params_flat(), before)


def test_capture_refuses_a_non_tensor_carry(replayed_on_cpu):
    """A layer state leaf that is not a tensor cannot live in a graph's
    static carries: named error, no eager fallback."""
    x, y = _data(2 * 16)
    m = _mlp()
    m.state = ({"note": 1.0},) + m.state[1:]
    with pytest.raises(CaptureError, match="not a tensor"):
        m.fit(_it(x, y), superstep=2)
    assert m.iteration_count == 0


UPDATERS = [upd.Sgd(0.1), upd.Adam(1e-2), upd.AdaMax(1e-2), upd.AdaGrad(0.1),
            upd.AdaDelta(), upd.RmsProp(1e-2), upd.Nesterovs(0.1, 0.9),
            upd.NoOp()]


@pytest.mark.parametrize("u", UPDATERS, ids=[type(u).__name__
                                            for u in UPDATERS])
def test_scalar_row_gives_the_bits_of_host_floats(u):
    """The claim the replayed step rests on: the step's scalars as 0-dim
    float32 tensors (a graph's table row) give the bits of the same
    float32 values as Python floats, step after step (f32 parameters and
    a bf16 tensor through `smul`)."""
    r = np.random.default_rng(3)
    p = {"W": torch.tensor(r.normal(size=(7, 5)), dtype=torch.float32),
         "b": torch.tensor(r.normal(size=(5,)), dtype=torch.float32)}
    sa, sb = u.init(p), u.init(p)
    for step in range(5):
        g = {k: torch.tensor(r.normal(size=v.shape), dtype=torch.float32)
             for k, v in p.items()}
        host = u.scalars(step, None)
        row = torch.tensor(host, dtype=torch.float32)
        ua, sa = u.apply(g, sa, host)
        ub, sb = u.apply(g, sb, tuple(row[i] for i in range(len(host))))
        _assert_bit_equal(ua, ub)
        _assert_bit_equal(sa, sb)
    h = torch.tensor(r.normal(size=64), dtype=torch.bfloat16)
    s = float(torch.tensor(0.1234567, dtype=torch.float32))
    assert torch.equal(upd.smul(s, h), upd.smul(torch.tensor(s), h))


def test_superstep_falls_back_for_tbptt_and_line_search(caplog):
    """TBPTT and line-search configurations run per batch, with JAX's
    log line; grad_accumulation>1 on them raises."""
    from deeplearning4j_tpu_torch.models import char_rnn
    net = char_rnn(vocab_size=5, lstm_size=4, seq_len=6, tbptt=3,
                   device="cpu").init()
    eye = np.eye(5, dtype=np.float32)
    r = np.random.default_rng(1)
    x, y = eye[r.integers(0, 5, (4, 6))], eye[r.integers(0, 5, (4, 6))]
    with caplog.at_level(logging.INFO, logger="deeplearning4j_tpu_torch"):
        net.fit(ArrayDataSetIterator(x, y, batch_size=2), superstep=2)
    assert "falls back to per-batch dispatch" in caplog.text
    assert net.iteration_count == 4
    with pytest.raises(ValueError, match="not supported for this "
                                         "configuration"):
        net.fit(ArrayDataSetIterator(x, y, batch_size=2),
                grad_accumulation=2)


# ---------------------------------------------------------------------------
# the port against JAX
# ---------------------------------------------------------------------------
_JAX_RUNS = {}


@pytest.fixture
def jax_window_run(one_torch_thread):
    """The JAX run below, made once per module inside the port tests'
    one-core pin (a module-scoped fixture would run before the pin, and
    its XLA compiles would take every core)."""
    if "jax_window_run" not in _JAX_RUNS:
        _JAX_RUNS["jax_window_run"] = _jax_window_run()
    return _JAX_RUNS["jax_window_run"]


def _jax_window_run():
    """JAX's fit(superstep=3) over 7 batches and a ragged tail, two epochs:
    its initial trees, the batches, its scores and its final trees."""
    from deeplearning4j_tpu.optimize.listeners import IterationListener as JL

    jnet = jax_init(JaxNet(_conf(jx)))
    start = tuple(jax_tree_np(t) for t in (jnet.params, jnet.updater_state,
                                           jnet.state))
    x, y = _data(7 * 16 + 9, seed=5)
    scores = []

    class JLog(JL):
        def iteration_done(self, model, iteration):
            scores.append(float(np.asarray(model._score)))

    jnet.set_listeners(JLog())
    jnet.fit(JaxArrayIt(x, y, batch_size=16), epochs=2, superstep=3)
    return (start, (x, y), scores, jax_tree_np(jnet.params),
            jax_tree_np(jnet.updater_state))


def _sorted_leaves(tree):
    """Leaves in sorted-key order (the order both packages' trees share)."""
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [v for t in tree for v in _sorted_leaves(t)]
    return [tree]


def jax_tree_np(t):
    if isinstance(t, dict):
        return {k: jax_tree_np(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(jax_tree_np(v) for v in t)
    return np.array(t, np.float32)


def _port_from(start):
    net = pt.MultiLayerNetwork(
        MultiLayerConfiguration.from_json(_conf(pt).to_json()),
        device="cpu").init()
    return pt.from_jax_params(net, *start[:2], start[2])


@pytest.mark.parametrize("k", [1, 3])
def test_superstep_trajectory_matches_jax(jax_window_run, k):
    """The port's K-window fit against JAX's superstep=3 fit from the same
    parameters and batches: scores, parameters and Adam state within the
    trajectory tolerance 1e-4."""
    start, (x, y), want_scores, want_p, want_u = jax_window_run
    net = _port_from(start)
    got = []

    class Log(IterationListener):
        def iteration_done(self, model, iteration):
            got.append(float(model._score))

    net.set_listeners(Log())
    net.fit(_it(x, y), epochs=2, superstep=k)
    np.testing.assert_allclose(got, want_scores, rtol=0, atol=TRAJ_TOL)
    for got_tree, want_tree in ((net.params, want_p),
                                (net.updater_state, want_u)):
        la, lb = _sorted_leaves(got_tree), _sorted_leaves(want_tree)
        assert len(la) == len(lb) > 0
        for a, b in zip(la, lb):
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=TRAJ_TOL)


def test_tally_scopes_keep_launches_off_the_counters():
    """A capture's launches go to its `kernels.tally()` instead of the
    counters: this thread's alone, or with `all_threads` every thread's (a
    training step's backward launches on autograd's device thread). A
    replay adds the tally back through `add_counts`."""
    import threading

    from deeplearning4j_tpu_torch import kernels
    from deeplearning4j_tpu_torch.kernels import bn_relu, lstm

    def launched(before):
        return sum(sum(t.values()) for t, _ in
                   kernels.count_delta(before, kernels.count_snapshot())
                   .values())

    def elsewhere():
        t = threading.Thread(target=bn_relu._count, args=("fwd", "resident"))
        t.start()
        t.join()

    before = kernels.count_snapshot()
    try:
        with kernels.tally() as mine:
            lstm._count("launches", "cluster")
            elsewhere()
        assert launched(before) == 1        # the other thread's launch
        delta = kernels.tally_delta(mine)
        assert delta["lstm"][0]["launches"] == 1
        assert delta["lstm"][1]["fwd"]["cluster"] == 1
        assert delta["bn_relu"][0]["fwd_launches"] == 0
        with kernels.tally(all_threads=True) as every:
            lstm._count("launches", "cluster")
            elsewhere()
        assert launched(before) == 1
        delta = kernels.tally_delta(every)
        assert delta["lstm"][0]["launches"] == 1
        assert delta["bn_relu"][1]["fwd"]["resident"] == 1
        kernels.add_counts(delta, times=3)
        assert launched(before) == 1 + 6
        assert lstm.variant_counts()["fwd"]["cluster"] \
            == before["lstm"][1]["fwd"]["cluster"] + 3
    finally:
        kernels.add_counts(kernels.count_delta(kernels.count_snapshot(),
                                               before))
    assert kernels.count_snapshot() == before
