"""PyTorch port, the input pipeline on the CPU: the twins of
`tests/test_input_pipeline.py` (its ParallelTrainer case is in
`tests/test_torch_parallel_loop.py`): weight-zero padding as a learning no-op, one batch signature per
padded epoch (one capture on the card), time buckets, the device prefetch
(its thread, its errors, its telemetry) and the asynchronous iterators;
and the staging of a superstep window.

The padded and prefetched runs are held to the unpadded serial run: the
prefetch stages the same values (bit-equal on the CPU, where its thread
only converts the batch), padding changes the reduction's terms (rtol
1e-4, JAX's own test's tolerance).
"""
import threading
import time

import numpy as np
import pytest
import torch

import deeplearning4j_tpu_torch as pt
from deeplearning4j_tpu_torch import telemetry
from deeplearning4j_tpu_torch.datasets.iterators import (
    ArrayDataSetIterator, AsyncDataSetIterator, AsyncMultiDataSetIterator,
    DataSet, DataSetIterator, ExistingDataSetIterator, ListDataSetIterator,
    MultiDataSet)
from deeplearning4j_tpu_torch.datasets.pipeline import (
    DevicePrefetchIterator, MicrobatchSplitIterator, PadToBatchIterator,
    batch_nbytes, build_pipeline, pad_dataset, pad_rows, split_xy,
    stage_batch, stage_window, staged_tree)
from torch_threads import one_torch_thread  # noqa: F401


def _mlp(seed=7, l2=1e-3):
    conf = (pt.NeuralNetConfiguration.builder().seed(seed)
            .updater(pt.Sgd(0.1)).l2(l2).list()
            .layer(pt.DenseLayer(n_out=16, activation="tanh"))
            .layer(pt.OutputLayer(n_out=3, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(pt.InputType.feed_forward(8))
            .build())
    return pt.MultiLayerNetwork(conf, device="cpu").init()


def _data(n=50, n_in=8, n_out=3, seed=1):
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, n_in)).astype(np.float32)
    y = np.eye(n_out, dtype=np.float32)[r.integers(0, n_out, n)]
    return x, y


def _wait_threads(n0, timeout=5.0):
    deadline = time.time() + timeout
    while threading.active_count() > n0 and time.time() < deadline:
        time.sleep(0.01)
    return threading.active_count()


# ---------------------------------------------------------------------------
# PadToBatchIterator
# ---------------------------------------------------------------------------
def test_pad_to_batch_shapes_and_masks():
    x, y = _data(50)
    it = PadToBatchIterator(ArrayDataSetIterator(x, y, batch_size=16))
    batches = list(it)
    assert len(batches) == 4
    for b in batches:
        assert b.features.shape[0] == 16
        assert b.labels.shape[0] == 16
        assert b.labels_mask is not None and b.labels_mask.shape == (16,)
    for b in batches[:-1]:
        assert b.labels_mask.sum() == 16
    last = batches[-1]
    assert last.labels_mask.sum() == 2
    np.testing.assert_array_equal(last.labels_mask[:2], 1.0)
    np.testing.assert_array_equal(last.features[2:], 0.0)
    assert last.features_mask is None
    assert it.pad_fraction == pytest.approx(14 / 64)


def test_pad_to_batch_infers_batch_size_lazily():
    x, y = _data(20)
    dss = [DataSet(x[:8], y[:8]), DataSet(x[8:16], y[8:16]),
           DataSet(x[16:], y[16:])]
    it = PadToBatchIterator(ExistingDataSetIterator(dss))
    batches = list(it)
    assert [b.features.shape[0] for b in batches] == [8, 8, 8]
    assert batches[-1].labels_mask.sum() == 4


def test_pad_to_batch_rejects_oversize_batch():
    x, y = _data(20)
    it = PadToBatchIterator(ArrayDataSetIterator(x, y, batch_size=12),
                            batch_size=8)
    with pytest.raises(ValueError, match="only pads, never splits"):
        next(iter(it))


def test_pad_dataset_multidataset():
    r = np.random.default_rng(0)
    mds = MultiDataSet(
        features=[r.normal(size=(5, 4)).astype(np.float32)],
        labels=[np.eye(3, dtype=np.float32)[r.integers(0, 3, 5)],
                r.normal(size=(5, 2)).astype(np.float32)])
    padded, n_real, n_pad = pad_dataset(mds, 8)
    assert (n_real, n_pad) == (5, 3)
    assert padded.features[0].shape == (8, 4)
    assert [l.shape[0] for l in padded.labels] == [8, 8]
    assert len(padded.labels_masks) == 2
    for m in padded.labels_masks:
        np.testing.assert_array_equal(m, [1, 1, 1, 1, 1, 0, 0, 0])


def test_time_buckets_stabilize_sequence_shapes():
    mk = lambda b, t: DataSet(np.ones((b, t, 3), np.float32),
                              np.ones((b, t, 2), np.float32))
    dss = [mk(4, 5), mk(4, 9), mk(2, 16)]
    with telemetry.enabled() as sess:
        it = PadToBatchIterator(ListDataSetIterator(dss), batch_size=4,
                                time_buckets=(8, 16))
        out = list(it)
        assert [b.features.shape for b in out] == [
            (4, 8, 3), (4, 16, 3), (4, 16, 3)]
        assert out[0].features_mask.shape == (4, 8)
        np.testing.assert_array_equal(out[0].features_mask[:, :5], 1.0)
        np.testing.assert_array_equal(out[0].features_mask[:, 5:], 0.0)
        assert out[0].labels_mask.shape == (4, 8)
        np.testing.assert_array_equal(out[0].labels_mask[:, 5:], 0.0)
        assert out[2].labels_mask[2:].sum() == 0
        assert sess.pipeline_summary()["bucket_hits"] == {"8": 1, "16": 2}
    with pytest.raises(ValueError, match="exceeds the largest time bucket"):
        list(PadToBatchIterator(ListDataSetIterator([mk(4, 32)]),
                                batch_size=4, time_buckets=(8, 16)))


def test_padded_training_is_learning_noop():
    """Weight-zero rows contribute no loss and no gradient, and the l2
    term normalizes by real rows: the padded fit matches the unpadded
    one."""
    x, y = _data(50)
    base, padded = _mlp(), _mlp()
    base.fit(ArrayDataSetIterator(x, y, batch_size=16), epochs=3)
    padded.fit(ArrayDataSetIterator(x, y, batch_size=16), epochs=3,
               pad_ragged=True)
    np.testing.assert_allclose(padded.params_flat(), base.params_flat(),
                               rtol=1e-4, atol=1e-6)
    ds = DataSet(x, y)
    assert padded.score(ds) == pytest.approx(base.score(ds), rel=1e-4)


def test_pad_ragged_single_compile():
    """One nn/train_step signature (one capture on the card) on a ragged
    dataset with pad_ragged=True, two without."""
    x, y = _data(50)
    with telemetry.enabled() as sess:
        _mlp().fit(ArrayDataSetIterator(x, y, batch_size=16), epochs=2)
        assert sess.compiles.count("nn/train_step") == 2
    with telemetry.enabled() as sess:
        m = _mlp()
        m.fit(ArrayDataSetIterator(x, y, batch_size=16), epochs=2,
              pad_ragged=True)
        assert sess.compiles.count("nn/train_step") == 1
        assert m.recompile_count == 1
        pipe = sess.pipeline_summary()
        assert pipe["pad_fraction"] == pytest.approx(14 / 64, abs=1e-3)
        assert pipe["rows"] == 128


def test_graph_pad_ragged_single_compile():
    conf = (pt.NeuralNetConfiguration.builder().seed(3).updater(pt.Sgd(0.1))
            .graph_builder().add_inputs("in")
            .add_layer("dense", pt.DenseLayer(n_out=16, activation="tanh"),
                       "in")
            .add_layer("out", pt.OutputLayer(n_out=3, activation="softmax",
                                             loss="mcxent"), "dense")
            .set_outputs("out")
            .set_input_types(pt.InputType.feed_forward(8))
            .build())
    x, y = _data(50)
    with telemetry.enabled() as sess:
        g = pt.ComputationGraph(conf, device="cpu").init()
        g.fit(ArrayDataSetIterator(x, y, batch_size=16), epochs=2,
              pad_ragged=True)
        assert sess.compiles.count("graph/train_step") == 1


def test_fit_scan_pad_ragged():
    x, y = _data(50)
    with pytest.raises(ValueError, match="uniform batch shapes"):
        _mlp().fit_scan(ArrayDataSetIterator(x, y, batch_size=16))
    m = _mlp()
    m.fit_scan(ArrayDataSetIterator(x, y, batch_size=16), pad_ragged=True)
    assert np.isfinite(m.score(DataSet(x, y)))


# ---------------------------------------------------------------------------
# DevicePrefetchIterator
# ---------------------------------------------------------------------------
def test_prefetch_matches_serial_and_joins_threads():
    x, y = _data(64)
    base = _mlp()
    base.fit(ArrayDataSetIterator(x, y, batch_size=16), epochs=2)
    n0 = threading.active_count()
    pre = _mlp()
    pre.fit(ArrayDataSetIterator(x, y, batch_size=16), epochs=2,
            prefetch=True)
    assert _wait_threads(n0) <= n0
    np.testing.assert_array_equal(pre.params_flat(), base.params_flat())


@pytest.mark.parametrize("k", [2, "epoch"])
def test_prefetch_under_superstep_is_bitexact(k):
    """Windows of prefetched batches (the staged tensors taken as they
    are) train as the serial per-batch loop does."""
    x, y = _data(80)
    base = _mlp()
    base.fit(ArrayDataSetIterator(x, y, batch_size=16), epochs=2)
    pre = _mlp()
    pre.fit(ArrayDataSetIterator(x, y, batch_size=16), epochs=2,
            prefetch=True, superstep=k)
    np.testing.assert_array_equal(pre.params_flat(), base.params_flat())


def test_prefetch_wait_telemetry_recorded():
    x, y = _data(64)
    with telemetry.enabled() as sess:
        _mlp().fit(ArrayDataSetIterator(x, y, batch_size=16), epochs=2,
                   prefetch=True, pad_ragged=True)
        pipe = sess.pipeline_summary()
        assert pipe["prefetch_waits"] > 0
        assert pipe["prefetch_wait_s"] >= 0.0
        assert pipe["pad_fraction"] == 0.0


class _FailingIterator(DataSetIterator):
    """Yields `good` batches, then raises from next()."""

    def __init__(self, good=1, batch_size=4):
        self.good = good
        self.batch_size = batch_size
        self.reset()

    def reset(self):
        self._served = 0

    def has_next(self):
        return True

    def next(self):
        if self._served >= self.good:
            raise ValueError("boom")
        self._served += 1
        x = np.zeros((self.batch_size, 8), np.float32)
        y = np.eye(3, dtype=np.float32)[np.zeros(self.batch_size, int)]
        return DataSet(x, y)

    def batch(self):
        return self.batch_size


def test_prefetch_error_propagates():
    it = DevicePrefetchIterator(_FailingIterator(good=2))
    got = [it.next()]
    with pytest.raises(RuntimeError, match="prefetch thread failed") as ei:
        while it.has_next():
            got.append(it.next())
    assert isinstance(ei.value.__cause__, ValueError)
    assert len(got) == 2
    it.close()


def test_build_pipeline_composes_and_closes():
    x, y = _data(50)
    it, close = build_pipeline(ArrayDataSetIterator(x, y, batch_size=16),
                               pad_ragged=True, prefetch=True)
    assert isinstance(it, DevicePrefetchIterator)
    assert isinstance(it.source, PadToBatchIterator)
    assert sum(b.num_examples() for b in it) == 64
    close()
    assert not it.has_next()


def test_prefetch_stages_tensors_on_the_device():
    """With a device the worker stages each batch as tensors of the
    model's dtype (on the CPU there is no copy event to wait on), and
    only a consumer asking for that device and dtype takes them."""
    x, y = _data(32)
    it = DevicePrefetchIterator(ArrayDataSetIterator(x, y, batch_size=16),
                                device=torch.device("cpu"),
                                dtype=torch.float64)
    ds = it.next()
    tree = staged_tree(ds, torch.device("cpu"), torch.float64)
    assert tree[0].dtype == torch.float64 and tree[2] is None
    np.testing.assert_array_equal(tree[0].numpy(), x[:16])
    assert staged_tree(ds, torch.device("cpu"), torch.float32) is None
    it.close()


# ---------------------------------------------------------------------------
# window staging
# ---------------------------------------------------------------------------
def test_stage_window_stacks_once_and_keeps_absent_masks():
    x, y = _data(48)
    window = [DataSet(x[i:i + 16], y[i:i + 16]) for i in range(0, 48, 16)]
    trees = stage_window(window, torch.device("cpu"), torch.float32)
    assert len(trees) == 3
    for i, (xs, ys, fm, lm) in enumerate(trees):
        assert fm is None and lm is None
        np.testing.assert_array_equal(xs.numpy(), x[16 * i:16 * (i + 1)])
    # the batches are views of ONE stacked tensor (one copy per window)
    assert trees[0][0].untyped_storage().data_ptr() == \
        trees[2][0].untyped_storage().data_ptr()


def test_stage_window_and_fit_take_batches_of_tensors():
    """DataSets holding tensors (a caller's batches already on the
    device) stage without a trip through numpy, and train as arrays do,
    per batch and in windows, on both model kinds."""
    x, y = _data(48)
    tensors = [DataSet(torch.as_tensor(x[i:i + 16]),
                       torch.as_tensor(y[i:i + 16])) for i in (0, 16, 32)]
    trees = stage_window(tensors, torch.device("cpu"), torch.float64)
    assert trees[1][0].dtype == torch.float64
    np.testing.assert_array_equal(trees[1][0].numpy(), x[16:32])
    base = _mlp()
    base.fit(ArrayDataSetIterator(x, y, batch_size=16))
    for k in (1, 3):
        m = _mlp()
        m.fit(ListDataSetIterator(tensors), superstep=k)
        np.testing.assert_array_equal(m.params_flat(), base.params_flat())
    conf = (pt.NeuralNetConfiguration.builder().seed(3).updater(pt.Sgd(0.1))
            .graph_builder().add_inputs("in")
            .add_layer("out", pt.OutputLayer(n_out=3, activation="softmax",
                                             loss="mcxent"), "in")
            .set_outputs("out")
            .set_input_types(pt.InputType.feed_forward(8)).build())
    ga = pt.ComputationGraph(conf, device="cpu").init()
    ga.fit(ArrayDataSetIterator(x, y, batch_size=16))
    gb = pt.ComputationGraph(conf, device="cpu").init()
    gb.fit(ListDataSetIterator(tensors), superstep=2)
    np.testing.assert_array_equal(ga.params_flat(), gb.params_flat())


def test_stage_window_takes_prefetched_batches_as_they_are():
    x, y = _data(32)
    window = [stage_batch(DataSet(x[i:i + 16], y[i:i + 16]),
                          torch.device("cpu"), torch.float32)
              for i in (0, 16)]
    trees = stage_window(window, torch.device("cpu"), torch.float32)
    assert trees[0][0] is window[0]._staged[2][0]


def test_batch_nbytes_reads_shapes_only():
    a = np.zeros((4, 8), np.float32)
    t = torch.zeros((2, 3), dtype=torch.bfloat16)
    assert batch_nbytes((a, None, t)) == 4 * 8 * 4 + 2 * 3 * 2


def test_pad_rows_and_split_xy():
    a = np.ones((2, 3), np.float32)
    assert pad_rows(a, 2).shape == (4, 3)
    assert pad_rows(None, 2) is None
    f, l = split_xy(np.arange(10, dtype=np.float32).reshape(2, 5), 3)
    assert f.shape == (2, 3) and l.shape == (2, 2)
    with pytest.raises(ValueError, match="cannot split"):
        split_xy(np.zeros((2, 3)), 3)


def test_microbatch_split_iterator_slices_rows():
    x, y = _data(40)
    it = MicrobatchSplitIterator(ArrayDataSetIterator(x, y, batch_size=16),
                                 8)
    sizes = [b.num_examples() for b in it]
    assert sizes == [8, 8, 8, 8, 8]
    with pytest.raises(ValueError, match="positive int"):
        MicrobatchSplitIterator(ArrayDataSetIterator(x, y, batch_size=16),
                                0)


# ---------------------------------------------------------------------------
# AsyncDataSetIterator lifecycle
# ---------------------------------------------------------------------------
def test_async_error_propagation():
    it = AsyncDataSetIterator(_FailingIterator(good=1))
    assert it.next() is not None
    with pytest.raises(RuntimeError, match="prefetch thread failed") as ei:
        it.next()
    assert isinstance(ei.value.__cause__, ValueError)
    it.close()


def test_async_reset_mid_epoch():
    x, y = _data(40)
    it = AsyncDataSetIterator(ArrayDataSetIterator(x, y, batch_size=8),
                              queue_size=2)
    it.next()
    it.next()
    it.reset()
    batches = []
    while it.has_next():
        batches.append(it.next())
    assert sum(b.num_examples() for b in batches) == 40
    it.close()


def test_async_close_no_leaked_threads():
    x, y = _data(40)
    it = AsyncDataSetIterator(ArrayDataSetIterator(x, y, batch_size=8))
    list(it)
    it.close()
    n0 = threading.active_count()
    for _ in range(10):
        it = AsyncDataSetIterator(ArrayDataSetIterator(x, y, batch_size=8))
        it.next()
        it.close()
    assert _wait_threads(n0) <= n0


def test_async_empty_source_does_not_hang():
    x, y = _data(3)
    with pytest.warns(UserWarning):
        src = ArrayDataSetIterator(x, y, batch_size=8, drop_last=True)
    it = AsyncDataSetIterator(src)
    assert not it.has_next()
    with pytest.raises(StopIteration):
        it.next()
    it.close()


def test_async_error_then_poll_does_not_hang():
    it = AsyncDataSetIterator(_FailingIterator(good=1))
    it.next()
    with pytest.raises(RuntimeError):
        it.next()
    assert not it.has_next()
    with pytest.raises(StopIteration):
        it.next()
    it.close()


def test_async_multi_dataset_iterator_feeds_a_graph():
    """AsyncMultiDataSetIterator over MultiDataSets trains a two-input
    graph as the plain iterator does."""
    r = np.random.default_rng(4)
    mds = [MultiDataSet(features=[r.normal(size=(8, 4)).astype(np.float32),
                                  r.normal(size=(8, 6)).astype(np.float32)],
                        labels=[np.eye(2, dtype=np.float32)[
                            r.integers(0, 2, 8)]]) for _ in range(3)]

    def graph():
        b = (pt.NeuralNetConfiguration.builder().seed(2)
             .updater(pt.Adam(1e-2)).graph_builder().add_inputs("a", "b")
             .add_layer("da", pt.DenseLayer(n_out=5, activation="tanh"), "a")
             .add_layer("db", pt.DenseLayer(n_out=5, activation="tanh"), "b")
             .add_vertex("m", pt.MergeVertex(), "da", "db")
             .add_layer("out", pt.OutputLayer(n_out=2, loss="mcxent"), "m")
             .set_outputs("out")
             .set_input_types(pt.InputType.feed_forward(4),
                              pt.InputType.feed_forward(6)))
        return pt.ComputationGraph(b.build(), device="cpu").init()
    a, b = graph(), graph()
    a.fit(ListDataSetIterator(mds), epochs=2)
    it = AsyncMultiDataSetIterator(ListDataSetIterator(mds))
    b.fit(it, epochs=2)
    it.close()
    np.testing.assert_array_equal(a.params_flat(), b.params_flat())


def test_pad_to_batch_inferred_target_overflow_is_actionable():
    x, y = _data(20)
    dss = [DataSet(x[:4], y[:4]), DataSet(x[4:12], y[4:12])]
    it = PadToBatchIterator(ExistingDataSetIterator(dss))
    it.next()
    with pytest.raises(ValueError, match="batch_size=.*explicitly"):
        it.next()


def test_async_close_then_reset_restarts():
    x, y = _data(24)
    it = AsyncDataSetIterator(ArrayDataSetIterator(x, y, batch_size=8))
    it.close()
    assert not it.has_next()
    it.reset()
    assert sum(b.num_examples() for b in it) == 24
    it.close()


def test_drop_last_smaller_than_batch_warns():
    x, y = _data(3)
    with pytest.warns(UserWarning, match="zero batches"):
        it = ArrayDataSetIterator(x, y, batch_size=8, drop_last=True)
    assert not it.has_next()


def test_shuffle_first_epoch_uses_seed():
    n = 20
    x = np.arange(n, dtype=np.float32).reshape(n, 1)
    it = ArrayDataSetIterator(x, x, batch_size=n, shuffle=True, seed=5)
    it.reset()
    got = it.next().features[:, 0].astype(int)
    np.testing.assert_array_equal(
        got, np.random.default_rng(5).permutation(n))
    it.reset()
    got2 = it.next().features[:, 0].astype(int)
    np.testing.assert_array_equal(
        got2, np.random.default_rng(6).permutation(n))
