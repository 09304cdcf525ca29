"""PyTorch port, `fit(grad_accumulation=M)` on the CPU: the twins of
`tests/test_accumulation.py` (its ParallelTrainer cases are in
`tests/test_torch_parallel_loop.py`),
the accumulated step's replay plumbing, and the port against JAX.

Within the port: M microbatches of b rows and one batch of M·b rows split
by `split_microbatches` are the same bits; any (K, M) regrouping is
bit-exact; the tail group renormalizes; under skip_batch a non-finite
microbatch drops out of its step; kill and resume at a microbatch inside a
step is bit-exact. Against a native M·b batch: float32 allclose at rtol
5e-5 (the order of the batch sums differs), as JAX's own test holds. On
the card an accumulated step is replays of two captured graphs (the
microbatch's gradient into the float32 accumulators, then the update);
`replayed_on_cpu` runs them eagerly here and holds them bit-equal to the
eager loop. Against JAX (dropout-free, same start and batches): 1e-4 over
the trajectory.
"""
import logging

import numpy as np
import pytest
import torch

import deeplearning4j_tpu as jx
from deeplearning4j_tpu.datasets.iterators import \
    ArrayDataSetIterator as JaxArrayIt
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
import deeplearning4j_tpu_torch as pt
from deeplearning4j_tpu_torch.datasets.iterators import (ArrayDataSetIterator,
                                                         ListDataSetIterator)
from deeplearning4j_tpu_torch.datasets.pipeline import split_microbatches
from deeplearning4j_tpu_torch.fault import (FaultyIterator, GuardPolicy,
                                            NonFiniteScoreError,
                                            TrainingGuard)
from deeplearning4j_tpu_torch.nn import superstep as ss
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.superstep import (OverlapAutoK,
                                                   accum_skip_nonfinite,
                                                   split_accum_groups,
                                                   steps_in,
                                                   validate_grad_accumulation)
from deeplearning4j_tpu_torch.nn.trees import flatten_tree
from deeplearning4j_tpu_torch.optimize.listeners import (
    IterationListener, PerformanceListener)
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


def _graph(seed=7):
    b = (pt.NeuralNetConfiguration.builder()
         .seed(seed).updater(pt.Adam(1e-3))
         .graph_builder().add_inputs("in")
         .set_input_types(pt.InputType.feed_forward(12)))
    b.add_layer("d", pt.DenseLayer(n_out=16, activation="relu"), "in")
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


def _batches(x, y, batch=16):
    return [pt.DataSet(x[i:i + batch], y[i:i + batch])
            for i in range(0, len(x), batch)]


def _assert_bit_equal(a, b):
    fa, fb = flatten_tree(a)[0], flatten_tree(b)[0]
    assert len(fa) == len(fb)
    for p, q in zip(fa, fb):
        assert torch.equal(p, q)


def _assert_f32_close(a, b, rtol=5e-5, atol=1e-7):
    for p, q in zip(flatten_tree(a)[0], flatten_tree(b)[0]):
        np.testing.assert_allclose(p.numpy(), q.numpy(), rtol=rtol,
                                   atol=atol)


def _gens(net):
    return [g.get_state() for g in net._dropout_generators()]


# ---------------------------------------------------------------------------
# M x b against M·b, both model kinds
# ---------------------------------------------------------------------------
def test_accum_matches_native_bigbatch_mlp():
    """M=4 microbatches of 16 against one native batch of 64: the same
    function in exact arithmetic, allclose in float32."""
    x, y = _data(8 * 16)
    a = _mlp()
    a.fit(_it(x, y, 16), epochs=2, grad_accumulation=4)
    b = _mlp()
    b.fit(_it(x, y, 64), epochs=2)
    assert a.iteration_count == b.iteration_count == 4
    assert a.epoch_count == b.epoch_count == 2
    _assert_f32_close(a.params, b.params)
    _assert_f32_close(a.updater_state, b.updater_state)


def test_accum_matches_native_bigbatch_graph():
    x, y = _data(8 * 16)
    a = _graph()
    a.fit(_it(x, y, 16), epochs=2, grad_accumulation=4)
    b = _graph()
    b.fit(_it(x, y, 64), epochs=2)
    assert a.iteration_count == b.iteration_count
    _assert_f32_close(a.params, b.params)


@pytest.mark.parametrize("family", ["mlp", "graph"])
def test_accum_split_bigbatch_bitexact(family):
    """One batch of M·b rows through `split_microbatches` IS M
    microbatches of b rows: bit-exact parameters, updater state and
    generator (dropout included for the MLP)."""
    x, y = _data(6 * 16)
    mk = (lambda: _mlp(dropout=0.5)) if family == "mlp" else _graph
    a = mk()
    a.fit(_it(x, y, 16), epochs=2, grad_accumulation=3)
    b = mk()
    b.fit(split_microbatches(_it(x, y, 48), 16), epochs=2,
          grad_accumulation=3)
    _assert_bit_equal(a.params, b.params)
    _assert_bit_equal(a.updater_state, b.updater_state)
    assert all(torch.equal(u, v) for u, v in zip(_gens(a), _gens(b)))
    assert a.iteration_count == b.iteration_count == 4


def test_accum_superstep_composition_bitexact():
    """K=1, K=3, 'epoch' and 'auto' give the same bits for the same M."""
    x, y = _data(6 * 16)
    ref = _mlp(dropout=0.5)
    ref.fit(_it(x, y), epochs=2, grad_accumulation=2)
    for knob in (3, "epoch", "auto"):
        m = _mlp(dropout=0.5)
        m.fit(_it(x, y), epochs=2, grad_accumulation=2, superstep=knob)
        _assert_bit_equal(ref.params, m.params)
        _assert_bit_equal(ref.updater_state, m.updater_state)
        assert all(torch.equal(u, v) for u, v in zip(_gens(ref), _gens(m)))
        assert m.iteration_count == ref.iteration_count == 6


def test_accum_tail_group_renormalizes():
    """9 micros at M=4 -> steps of (4, 4, 1); the 1-micro step is
    bit-identical to a plain step on that batch."""
    x, y = _data(9 * 16)
    a = _mlp()
    a.fit(_it(x, y), epochs=1, grad_accumulation=4)
    assert a.iteration_count == 3
    b = _mlp()
    b.fit(ListDataSetIterator(_batches(x[:8 * 16], y[:8 * 16])), epochs=1,
          grad_accumulation=4)
    b.fit(ListDataSetIterator(_batches(x[8 * 16:], y[8 * 16:])), epochs=1,
          grad_accumulation=4)
    _assert_bit_equal(a.params, b.params)
    _assert_bit_equal(a.updater_state, b.updater_state)


def test_accum_listener_cadence_per_optimizer_step():
    """iteration_done fires once per OPTIMIZER step with a host score."""
    seen = []

    class Probe(IterationListener):
        def iteration_done(self, model, iteration):
            seen.append((iteration, model._score,
                         isinstance(model._score, (float, np.floating))))

    x, y = _data(8 * 16)
    m = _mlp()
    perf = PerformanceListener(frequency=1, report_score=True,
                               printer=lambda s: None)
    m.set_listeners(Probe(), perf)
    m.fit(_it(x, y), epochs=1, grad_accumulation=4)
    assert [i for i, _, _ in seen] == [1, 2]
    assert all(host for _, _, host in seen), "device score leaked"
    assert all(np.isfinite(s) for _, s, _ in seen)
    assert len(perf.history) == 2


# ---------------------------------------------------------------------------
# guard under accumulation
# ---------------------------------------------------------------------------
def test_accum_guard_skips_only_bad_microbatch():
    """skip_batch + M>1: a non-finite microbatch zeroes only its own
    gradient and the mean renormalizes over the finite ones — the bits of
    an accumulation with the bad microbatch absent from its group."""
    x, y = _data(6 * 16)
    bs = _batches(x, y)
    m = _mlp()
    it = FaultyIterator(ListDataSetIterator(list(bs)), nan_at=1)
    guard = TrainingGuard(policy=GuardPolicy.SKIP_BATCH)
    m.fit(it, epochs=1, grad_accumulation=3, guard=guard)
    assert m.iteration_count == 2
    assert guard.nonfinite_steps == 1
    assert guard.skipped_batches == 1
    ref = _mlp()
    ref.fit(ListDataSetIterator([bs[0], bs[2]]), epochs=1,
            grad_accumulation=2)
    ref.fit(ListDataSetIterator(bs[3:]), epochs=1, grad_accumulation=3)
    _assert_bit_equal(ref.params, m.params)
    _assert_bit_equal(ref.updater_state, m.updater_state)


def test_accum_guard_all_bad_step_discards_window():
    """Every microbatch of a step non-finite: the step score is NaN and
    skip_batch restores the pre-window snapshot."""
    x, y = _data(4 * 16)
    bs = _batches(x, y)
    m = _mlp()
    it = FaultyIterator(FaultyIterator(ListDataSetIterator(list(bs)),
                                       nan_at=0), nan_at=1)
    guard = TrainingGuard(policy=GuardPolicy.SKIP_BATCH)
    m.fit(it, epochs=1, grad_accumulation=2, guard=guard)
    assert m.iteration_count == 1
    ref = _mlp()
    ref.fit(ListDataSetIterator(bs[2:]), epochs=1, grad_accumulation=2)
    _assert_bit_equal(ref.params, m.params)


def test_accum_guard_halt_raises():
    x, y = _data(4 * 16)
    m = _mlp()
    it = FaultyIterator(_it(x, y), nan_at=1)
    with pytest.raises(NonFiniteScoreError):
        m.fit(it, epochs=1, grad_accumulation=2,
              guard=TrainingGuard(policy=GuardPolicy.HALT))


def test_accum_skip_nonfinite_predicate():
    g = TrainingGuard(policy=GuardPolicy.SKIP_BATCH)
    assert accum_skip_nonfinite(g, 4)
    assert not accum_skip_nonfinite(g, 1)
    assert not accum_skip_nonfinite(None, 4)
    assert not accum_skip_nonfinite(
        TrainingGuard(policy=GuardPolicy.ROLLBACK), 4)


# ---------------------------------------------------------------------------
# checkpoint / resume
# ---------------------------------------------------------------------------
def test_accum_kill_mid_accumulation_resume_bitexact(tmp_path):
    """Kill at microbatch 7, inside step 3's group (6..8): the last
    checkpoint sits at the step boundary, and the resumed run matches the
    uninterrupted one bit-exactly."""
    d = str(tmp_path / "ckpt")
    x, y = _data(9 * 16)
    ref = _mlp(dropout=0.3)
    ref.fit(_it(x, y), epochs=2, grad_accumulation=3)
    m1 = _mlp(dropout=0.3)
    it = FaultyIterator(_it(x, y), raise_at=7, exc=RuntimeError)
    with pytest.raises(RuntimeError):
        m1.fit(it, epochs=2, grad_accumulation=3, checkpoint_dir=d,
               checkpoint_every=1)
    m2 = _mlp(dropout=0.3)
    m2.fit(_it(x, y), epochs=2, grad_accumulation=3, checkpoint_dir=d,
           resume=True)
    _assert_bit_equal(ref.params, m2.params)
    _assert_bit_equal(ref.updater_state, m2.updater_state)
    assert all(torch.equal(u, v) for u, v in zip(_gens(ref), _gens(m2)))
    assert ref.iteration_count == m2.iteration_count


def test_accum_resume_mismatched_m_warns(tmp_path, caplog):
    """The checkpoint records grad_accumulation; resuming with another M
    warns (M changes the math)."""
    d = str(tmp_path / "ckpt")
    x, y = _data(6 * 16)
    m1 = _mlp()
    it = FaultyIterator(_it(x, y), raise_at=4, exc=RuntimeError)
    with pytest.raises(RuntimeError):
        m1.fit(it, epochs=1, grad_accumulation=2, checkpoint_dir=d,
               checkpoint_every=1)
    m2 = _mlp()
    with caplog.at_level(logging.WARNING, logger="deeplearning4j_tpu_torch"):
        m2.fit(_it(x, y), epochs=1, grad_accumulation=3, checkpoint_dir=d,
               resume=True)
    assert any("grad_accumulation" in r.message for r in caplog.records)


# ---------------------------------------------------------------------------
# knob validation, auto-K, grouping arithmetic
# ---------------------------------------------------------------------------
def test_grad_accumulation_validation():
    assert validate_grad_accumulation(1) == 1
    assert validate_grad_accumulation(8) == 8
    for bad in (0, -1, 1.5, "lots", None):
        with pytest.raises(ValueError, match="grad_accumulation"):
            validate_grad_accumulation(bad)
    x, y = _data(16)
    with pytest.raises(ValueError, match="grad_accumulation"):
        _mlp().fit(pt.DataSet(x, y), grad_accumulation=2)


def test_overlap_autok_grows_on_dispatch_share():
    ak = OverlapAutoK(2, max_k=16, target_share=0.10)
    assert ak.observe(0.5, 1.0) == 4
    assert ak.observe(0.5, 1.0) == 8
    assert ak.observe(0.5, 1.0) == 16
    assert ak.observe(0.5, 1.0) == 16
    ak2 = OverlapAutoK(4, max_k=64, target_share=0.10)
    for _ in range(5):
        assert ak2.observe(0.01, 1.0) == 4
    assert ak2.observe(0.0, 0.0) == 4


def test_split_accum_groups_and_steps_in():
    """9 microbatches at M=4: two full groups and a renormalized tail."""
    staged = list(range(9))
    parts = split_accum_groups(staged, 9, 4)
    assert [(g, q, m) for g, q, m in parts] == [
        ([[0, 1, 2, 3], [4, 5, 6, 7]], 2, 4), ([[8]], 1, 1)]
    assert steps_in(9, 4) == 3 and steps_in(8, 4) == 2 and steps_in(3, 4) == 1


# ---------------------------------------------------------------------------
# the replay path (the card's), on the CPU
# ---------------------------------------------------------------------------
def _eager(fn):
    keep = ss._captures
    ss._captures = lambda model: False
    try:
        return fn()
    finally:
        ss._captures = keep


@pytest.mark.parametrize("family", ["mlp", "graph"])
@pytest.mark.parametrize("k", [1, 2, "epoch"])
def test_replayed_accumulation_matches_the_eager_loop(replayed_on_cpu,
                                                      family, k):
    """The microbatch and update graphs, replayed (9 micros at M=4: a
    ragged tail group of 1 on the same capture), give the eager
    accumulation's bits; one capture per signature."""
    x, y = _data(9 * 16)
    mk = (lambda: _mlp(dropout=0.5)) if family == "mlp" else _graph

    def run():
        m = mk()
        m.fit(_it(x, y), epochs=2, grad_accumulation=4, superstep=k)
        return m
    ref = _eager(run)
    m = run()
    _assert_bit_equal(ref.params, m.params)
    _assert_bit_equal(ref.updater_state, m.updater_state)
    _assert_bit_equal(ref.state, m.state)
    assert all(torch.equal(u, v) for u, v in zip(_gens(ref), _gens(m)))
    assert m.iteration_count == ref.iteration_count == 6
    assert len(m._captured_steps) == 1


def test_replayed_accumulation_skips_a_bad_microbatch(replayed_on_cpu):
    """skip_batch's in-step neutralization through the replayed graphs:
    the bits of the eager loop, and the skip counted."""
    x, y = _data(6 * 16)
    bs = _batches(x, y)

    def run():
        m = _mlp()
        g = TrainingGuard(policy=GuardPolicy.SKIP_BATCH)
        m.fit(FaultyIterator(ListDataSetIterator(list(bs)), nan_at=4),
              grad_accumulation=3, guard=g)
        return m, g
    ref, _ = _eager(run)
    m, g = run()
    assert g.skipped_batches == 1 and m.iteration_count == 2
    _assert_bit_equal(ref.params, m.params)
    _assert_bit_equal(ref.updater_state, m.updater_state)


# ---------------------------------------------------------------------------
# the port against JAX
# ---------------------------------------------------------------------------
def _np_tree(t):
    if isinstance(t, dict):
        return {k: _np_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(_np_tree(v) for v in t)
    return np.array(t, np.float32)


def _sorted_leaves(tree):
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [v for t in tree for v in _sorted_leaves(t)]
    return [tree]


_JAX_RUNS = {}


@pytest.fixture
def jax_accum_run(one_torch_thread):
    """The JAX run below, made once per module inside the port tests'
    one-core pin (a module-scoped fixture would run before the pin, and
    its XLA compiles would take every core)."""
    if "jax_accum_run" not in _JAX_RUNS:
        _JAX_RUNS["jax_accum_run"] = _jax_accum_run()
    return _JAX_RUNS["jax_accum_run"]


def _jax_accum_run():
    """JAX's fit(grad_accumulation=3, superstep=2) over 9 microbatches
    (steps of 3, 3, 3), two epochs."""
    from deeplearning4j_tpu.optimize.listeners import IterationListener as JL

    jnet = jax_init(JaxNet(_conf(jx)))
    start = tuple(_np_tree(t) for t in (jnet.params, jnet.updater_state,
                                        jnet.state))
    x, y = _data(9 * 16, seed=6)
    scores = []

    class JLog(JL):
        def iteration_done(self, model, iteration):
            scores.append(float(np.asarray(model._score)))

    jnet.set_listeners(JLog())
    jnet.fit(JaxArrayIt(x, y, batch_size=16), epochs=2, grad_accumulation=3,
             superstep=2)
    return (start, (x, y), scores, _np_tree(jnet.params),
            _np_tree(jnet.updater_state))


@pytest.mark.parametrize("k", [1, 2])
def test_accumulation_trajectory_matches_jax(jax_accum_run, k):
    """The port's accumulated fit against JAX's from the same parameters
    and microbatches: scores, parameters and Adam state within 1e-4."""
    start, (x, y), want_scores, want_p, want_u = jax_accum_run
    net = pt.MultiLayerNetwork(
        MultiLayerConfiguration.from_json(_conf(pt).to_json()),
        device="cpu").init()
    pt.from_jax_params(net, start[0], start[1], start[2])
    got = []

    class Log(IterationListener):
        def iteration_done(self, model, iteration):
            got.append(float(model._score))

    net.set_listeners(Log())
    net.fit(_it(x, y), epochs=2, grad_accumulation=3, superstep=k)
    np.testing.assert_allclose(got, want_scores, rtol=0, atol=TRAJ_TOL)
    for got_tree, want_tree in ((net.params, want_p),
                                (net.updater_state, want_u)):
        la, lb = _sorted_leaves(got_tree), _sorted_leaves(want_tree)
        assert len(la) == len(lb) > 0
        for a, b in zip(la, lb):
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=TRAJ_TOL)
