"""PyTorch port, the in-memory iterators and the classification evaluation
against the JAX package on the same numpy arrays: the iterators must yield
the same batches in the same order (a training run on the same iterator
then sees the same data in both packages), and Evaluation must count the
same confusion matrix and report the same metrics. Exact equality: both
sides are numpy with the same seeds.
"""
import numpy as np
import pytest

from deeplearning4j_tpu.datasets.iterators import (
    ArrayDataSetIterator as JaxArrayIterator, DataSet as JaxDataSet,
    ListDataSetIterator as JaxListIterator)
from deeplearning4j_tpu.eval.evaluation import Evaluation as JaxEvaluation
from deeplearning4j_tpu_torch.datasets import (ArrayDataSetIterator, DataSet,
                                               ListDataSetIterator)
from deeplearning4j_tpu_torch.eval import Evaluation


def _arrays(n=10, seed=0):
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[r.integers(0, 3, n)]
    m = (r.uniform(size=(n,)) > 0.2).astype(np.float32)
    return x, y, m


def _drain(it):
    out = []
    while it.has_next():
        ds = it.next()
        out.append((ds.features, ds.labels, ds.features_mask, ds.labels_mask))
    return out


def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shuffle,seed,drop_last,batch", [
    (False, None, False, 3), (True, 4, False, 3), (True, 4, True, 3),
    (True, 0, False, 10), (False, None, True, 4)])
def test_array_iterator_yields_the_jax_batches_over_epochs(shuffle, seed,
                                                            drop_last, batch):
    x, y, m = _arrays()
    kw = dict(batch_size=batch, shuffle=shuffle, seed=seed,
              drop_last=drop_last)
    it = ArrayDataSetIterator(x, y, labels_mask=m, **kw)
    jit = JaxArrayIterator(x, y, labels_mask=m, **kw)
    for epoch in range(3):        # reset() advances the consumed epoch
        it.reset()
        jit.reset()
        _same_batches(_drain(it), _drain(jit))
    assert it.batch() == batch and it.total_examples() == 10


def test_set_epoch_replays_the_jax_permutation():
    x, y, _ = _arrays(seed=1)
    it = ArrayDataSetIterator(x, y, batch_size=4, shuffle=True, seed=7)
    jit = JaxArrayIterator(x, y, batch_size=4, shuffle=True, seed=7)
    it.set_epoch(5)
    jit.set_epoch(5)
    _same_batches(_drain(it), _drain(jit))
    # a reset without a drawn batch keeps the epoch, as in JAX
    it.reset()
    jit.reset()
    _same_batches(_drain(it), _drain(jit))


def test_list_iterator_rebatches_like_jax():
    x, y, m = _arrays(n=7, seed=2)
    parts = [(x[:2], y[:2], None), (x[2:], y[2:], m[2:])]
    it = ListDataSetIterator([DataSet(a, b, labels_mask=c)
                              for a, b, c in parts], batch_size=3)
    jit = JaxListIterator([JaxDataSet(a, b, labels_mask=c)
                           for a, b, c in parts], batch_size=3)
    _same_batches(_drain(it), _drain(jit))
    assert it.batch() == jit.batch() == 3
    assert [d.num_examples() for d in it] == [3, 3, 1]


def test_dataset_split_shuffle_and_merge_match_jax():
    x, y, m = _arrays(n=8, seed=3)
    ds, jds = DataSet(x, y, labels_mask=m), JaxDataSet(x, y, labels_mask=m)
    for a, b in zip(ds.split_test_and_train(5), jds.split_test_and_train(5)):
        _same_batches([(a.features, a.labels, a.features_mask,
                        a.labels_mask)],
                      [(b.features, b.labels, b.features_mask,
                        b.labels_mask)])
    ds.shuffle(seed=9)
    jds.shuffle(seed=9)
    np.testing.assert_array_equal(ds.features, jds.features)
    merged = DataSet.merge([DataSet(x[:3], y[:3]), ds])
    assert merged.num_examples() == 11
    np.testing.assert_array_equal(merged.labels_mask[:3], np.ones(3))


def test_drop_last_warns_when_no_batch_fits():
    x, y, _ = _arrays(n=2)
    with pytest.warns(UserWarning, match="zero batches"):
        it = ArrayDataSetIterator(x, y, batch_size=3, drop_last=True)
    assert not it.has_next()


def _eval_inputs(seed, shape):
    r = np.random.default_rng(seed)
    labels = np.eye(shape[-1])[r.integers(0, shape[-1], shape[:-1])]
    preds = r.uniform(size=shape)
    preds /= preds.sum(-1, keepdims=True)
    mask = (r.uniform(size=shape[:-1]) > 0.25).astype(np.float32)
    return labels, preds, mask


@pytest.mark.parametrize("shape,masked,top_n", [
    ((20, 4), False, 1), ((20, 4), True, 2), ((5, 6, 4), True, 1),
    ((5, 6, 4), False, 3)])
def test_evaluation_matches_jax(shape, masked, top_n):
    ev, jev = Evaluation(top_n=top_n), JaxEvaluation(top_n=top_n)
    for seed in range(3):
        labels, preds, mask = _eval_inputs(seed, shape)
        m = mask if masked else None
        if len(shape) == 3:
            ev.eval_time_series(labels, preds, labels_mask=m)
            jev.eval_time_series(labels, preds, labels_mask=m)
        else:
            ev.eval(labels, preds, mask=m)
            jev.eval(labels, preds, mask=m)
    np.testing.assert_array_equal(ev.confusion.matrix, jev.confusion.matrix)
    for metric in ("accuracy", "precision", "recall", "f1",
                   "top_n_accuracy", "num_examples"):
        assert getattr(ev, metric)() == getattr(jev, metric)(), metric
    for cls in range(shape[-1]):
        assert ev.precision(cls) == jev.precision(cls)
        assert ev.recall(cls) == jev.recall(cls)
    assert ev.stats() == jev.stats()
    assert ev.confusion_to_string() == jev.confusion_to_string()


def test_evaluation_merge_and_binary_single_column_match_jax():
    labels, preds, _ = _eval_inputs(4, (12, 3))
    a, b = Evaluation(), Evaluation()
    a.eval(labels[:6], preds[:6])
    b.eval(labels[6:], preds[6:])
    a.merge(b)
    whole = JaxEvaluation()
    whole.eval(labels, preds)
    np.testing.assert_array_equal(a.confusion.matrix, whole.confusion.matrix)
    r = np.random.default_rng(5)
    yb = r.integers(0, 2, (15, 1)).astype(np.float32)
    pb = r.uniform(size=(15, 1))
    ev, jev = Evaluation(), JaxEvaluation()
    ev.eval(yb, pb)
    jev.eval(yb, pb)
    np.testing.assert_array_equal(ev.confusion.matrix, jev.confusion.matrix)
    assert ev.num_classes == 2
