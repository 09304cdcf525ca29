"""DataSet and the in-memory iterators: the port of
`deeplearning4j_tpu/datasets/iterators.py` (`DataSet`, `MultiDataSet`,
`DataSetIterator`, `ArrayDataSetIterator` with its seed + consumed-epoch
shuffle, `ListDataSetIterator`, `ExistingDataSetIterator`,
`IteratorDataSetIterator`, `MultipleEpochsIterator`,
`SamplingDataSetIterator`, and the background-thread
`AsyncDataSetIterator` / `AsyncMultiDataSetIterator`). Batches are host
numpy arrays, so the same iterator can feed the JAX package and the port;
`datasets/pipeline.py`'s device prefetch stages them on the card ahead of
the step (a DataSet it has staged carries its tensors in `_staged`).
"""
from __future__ import annotations

import queue
import threading
import warnings
from dataclasses import dataclass, field
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["DataSet", "MultiDataSet", "DataSetIterator",
           "ArrayDataSetIterator", "ListDataSetIterator",
           "ExistingDataSetIterator", "IteratorDataSetIterator",
           "MultipleEpochsIterator", "SamplingDataSetIterator",
           "AsyncDataSetIterator", "AsyncMultiDataSetIterator"]


@dataclass
class DataSet:
    """features/labels (+ optional masks) minibatch of numpy arrays (ND4J
    DataSet: features, labels, featuresMaskArray, labelsMaskArray). The
    network moves a batch to its device when it trains on it."""

    features: np.ndarray
    labels: Optional[np.ndarray] = None
    features_mask: Optional[np.ndarray] = None
    labels_mask: Optional[np.ndarray] = None
    # (device, dtype, tensors, event) when datasets/pipeline.py has staged
    # the batch on a device ahead of its step
    _staged: Optional[tuple] = field(default=None, repr=False, compare=False)

    def num_examples(self) -> int:
        return int(self.features.shape[0])

    def split_test_and_train(self, n_train: int) -> Tuple["DataSet", "DataSet"]:
        def cut(a, lo, hi):
            return None if a is None else a[lo:hi]
        n = self.num_examples()
        return (DataSet(*(cut(a, 0, n_train) for a in
                          (self.features, self.labels, self.features_mask, self.labels_mask))),
                DataSet(*(cut(a, n_train, n) for a in
                          (self.features, self.labels, self.features_mask, self.labels_mask))))

    def shuffle(self, seed: Optional[int] = None):
        rng = np.random.default_rng(seed)
        idx = rng.permutation(self.num_examples())
        self.features = self.features[idx]
        if self.labels is not None:
            self.labels = self.labels[idx]
        if self.features_mask is not None:
            self.features_mask = self.features_mask[idx]
        if self.labels_mask is not None:
            self.labels_mask = self.labels_mask[idx]

    @staticmethod
    def merge(datasets: Sequence["DataSet"]) -> "DataSet":
        def cat(xs):
            xs = [x for x in xs if x is not None]
            return np.concatenate(xs, axis=0) if xs else None

        def cat_masks(masks, anchors):
            """Concat masks; datasets lacking one get all-ones so rows stay
            aligned with their examples."""
            if all(m is None for m in masks):
                return None
            proto = next(m for m in masks if m is not None)
            out = []
            for m, anchor in zip(masks, anchors):
                if m is None:
                    m = np.ones((anchor.shape[0],) + proto.shape[1:],
                                dtype=proto.dtype)
                out.append(m)
            return np.concatenate(out, axis=0)

        feats = [d.features for d in datasets]
        labs = [d.labels for d in datasets]
        return DataSet(cat(feats), cat(labs),
                       cat_masks([d.features_mask for d in datasets], feats),
                       cat_masks([d.labels_mask for d in datasets],
                                 [l if l is not None else f
                                  for l, f in zip(labs, feats)]))


@dataclass
class MultiDataSet:
    """Multiple-input / multiple-output minibatch of numpy arrays (ND4J
    MultiDataSet), for the ComputationGraph (ROADMAP A7)."""

    features: List[np.ndarray] = field(default_factory=list)
    labels: List[np.ndarray] = field(default_factory=list)
    features_masks: Optional[List[Optional[np.ndarray]]] = None
    labels_masks: Optional[List[Optional[np.ndarray]]] = None
    _staged: Optional[tuple] = field(default=None, repr=False, compare=False)

    def num_examples(self) -> int:
        return int(self.features[0].shape[0])


class DataSetIterator:
    """Iterator contract: `__iter__` restarts an epoch (calls `reset`)."""

    def __iter__(self) -> Iterator[DataSet]:
        self.reset()
        return self

    def __next__(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        return self.next()

    def has_next(self) -> bool:
        raise NotImplementedError

    def next(self) -> DataSet:
        raise NotImplementedError

    def reset(self):
        raise NotImplementedError

    def batch(self) -> int:
        raise NotImplementedError

    @property
    def async_supported(self) -> bool:
        return True


class ArrayDataSetIterator(DataSetIterator):
    """Batches over in-memory arrays (role of ND4J's ListDataSetIterator over a
    pre-split list, but vectorized)."""

    def __init__(self, features, labels=None, batch_size: int = 32,
                 features_mask=None, labels_mask=None, shuffle: bool = False,
                 seed: Optional[int] = None, drop_last: bool = False):
        self.features = np.asarray(features)
        self.labels = None if labels is None else np.asarray(labels)
        self.features_mask = None if features_mask is None else np.asarray(features_mask)
        self.labels_mask = None if labels_mask is None else np.asarray(labels_mask)
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        if drop_last and self.features.shape[0] < self.batch_size:
            # has_next() would be False forever: every epoch yields ZERO
            # batches and fit() silently trains on nothing
            warnings.warn(
                f"ArrayDataSetIterator(drop_last=True) with only "
                f"{self.features.shape[0]} examples < batch_size="
                f"{self.batch_size}: every epoch yields zero batches, so "
                "fit() will train on NOTHING. Lower batch_size, set "
                "drop_last=False, or pad with "
                "datasets.pipeline.PadToBatchIterator",
                UserWarning, stacklevel=2)
        self._epoch = 0
        self._drawn = False   # batches consumed since the last reset?
        self.reset()

    def reset(self):
        # Epoch E shuffles with `seed + E`, E counting CONSUMED epochs:
        # reset() only advances the epoch after a batch was drawn, so the
        # constructor's reset and fit()'s epoch-start reset both leave the
        # first epoch on `seed + 0` (reproducible from `seed=` alone).
        if self._drawn:
            self._epoch += 1
        n = self.features.shape[0]
        if self.shuffle:
            rng = np.random.default_rng(
                None if self.seed is None else self.seed + self._epoch)
            self._order = rng.permutation(n)
        else:
            self._order = np.arange(n)
        self._pos = 0
        self._drawn = False

    def set_epoch(self, epoch: int):
        """Position the shuffle-epoch counter (resume): the
        iterator reshuffles as if `epoch` epochs had already been
        consumed, so a resumed fit replays the exact permutation the
        interrupted run would have used (seed + epoch)."""
        self._epoch = int(epoch)
        self._drawn = False
        self.reset()

    def has_next(self) -> bool:
        remaining = len(self._order) - self._pos
        if self.drop_last:
            return remaining >= self.batch_size
        return remaining > 0

    def next(self) -> DataSet:
        idx = self._order[self._pos:self._pos + self.batch_size]
        self._pos += len(idx)
        self._drawn = True

        def take(a):
            return None if a is None else a[idx]
        return DataSet(take(self.features), take(self.labels),
                       take(self.features_mask), take(self.labels_mask))

    def batch(self) -> int:
        return self.batch_size

    def total_examples(self) -> int:
        return int(self.features.shape[0])


class ListDataSetIterator(DataSetIterator):
    """Iterates a list of pre-built DataSets, re-batched to `batch` examples
    (parity with `datasets/iterator/ListDataSetIterator`)."""

    def __init__(self, datasets: Sequence[DataSet], batch_size: Optional[int] = None):
        self._datasets = list(datasets)
        self._batch = batch_size
        if batch_size is not None:
            merged = DataSet.merge(self._datasets)
            self._datasets = []
            for i in range(0, merged.num_examples(), batch_size):
                self._datasets.append(DataSet(
                    merged.features[i:i + batch_size],
                    None if merged.labels is None else merged.labels[i:i + batch_size],
                    None if merged.features_mask is None else merged.features_mask[i:i + batch_size],
                    None if merged.labels_mask is None else merged.labels_mask[i:i + batch_size]))
        self._pos = 0

    def reset(self):
        self._pos = 0

    def has_next(self):
        return self._pos < len(self._datasets)

    def next(self):
        d = self._datasets[self._pos]
        self._pos += 1
        return d

    def batch(self):
        return self._batch or (self._datasets[0].num_examples() if self._datasets else 0)


class ExistingDataSetIterator(DataSetIterator):
    """Wraps a plain python iterable of DataSets
    (`datasets/iterator/ExistingDataSetIterator.java`)."""

    def __init__(self, iterable: Iterable[DataSet]):
        self._iterable = iterable
        self.reset()

    def reset(self):
        self._it = iter(self._iterable)
        self._peek = None
        self._advance()

    def _advance(self):
        try:
            self._peek = next(self._it)
        except StopIteration:
            self._peek = None

    def has_next(self):
        return self._peek is not None

    def next(self):
        d = self._peek
        self._advance()
        return d

    def batch(self):
        return -1


class IteratorDataSetIterator(DataSetIterator):
    """Re-batches an iterator of DataSets to a fixed minibatch size
    (`datasets/iterator/IteratorDataSetIterator.java`)."""

    def __init__(self, source: DataSetIterator, batch_size: int):
        self.source = source
        self.batch_size = int(batch_size)
        self._buffer: List[DataSet] = []

    def reset(self):
        self.source.reset()
        self._buffer = []

    def has_next(self):
        return bool(self._buffer) or self.source.has_next()

    def next(self):
        have = sum(d.num_examples() for d in self._buffer)
        while have < self.batch_size and self.source.has_next():
            d = self.source.next()
            self._buffer.append(d)
            have += d.num_examples()
        merged = DataSet.merge(self._buffer)

        def cut(a, lo, hi):
            return None if a is None else a[lo:hi]

        b = self.batch_size
        out = DataSet(cut(merged.features, 0, b), cut(merged.labels, 0, b),
                      cut(merged.features_mask, 0, b),
                      cut(merged.labels_mask, 0, b))
        n = merged.num_examples()
        self._buffer = []
        if n > b:
            self._buffer = [DataSet(cut(merged.features, b, n),
                                    cut(merged.labels, b, n),
                                    cut(merged.features_mask, b, n),
                                    cut(merged.labels_mask, b, n))]
        return out

    def batch(self):
        return self.batch_size


class MultipleEpochsIterator(DataSetIterator):
    """Replays an iterator for N epochs (`datasets/iterator/MultipleEpochsIterator.java`)."""

    def __init__(self, epochs: int, source: DataSetIterator):
        self.epochs = int(epochs)
        self.source = source
        self._epoch = 0

    def reset(self):
        self.source.reset()
        self._epoch = 0

    def has_next(self):
        if self.source.has_next():
            return True
        if self._epoch + 1 < self.epochs:
            self._epoch += 1
            self.source.reset()
            return self.source.has_next()
        return False

    def next(self):
        if not self.has_next():
            raise StopIteration
        return self.source.next()

    def batch(self):
        return self.source.batch()


class SamplingDataSetIterator(DataSetIterator):
    """Samples minibatches with replacement from one DataSet
    (`datasets/iterator/SamplingDataSetIterator.java`)."""

    def __init__(self, dataset: DataSet, batch_size: int, total_batches: int,
                 seed: Optional[int] = None):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.total_batches = int(total_batches)
        self.seed = seed
        self.reset()

    def reset(self):
        self._rng = np.random.default_rng(self.seed)
        self._count = 0

    def has_next(self):
        return self._count < self.total_batches

    def next(self):
        idx = self._rng.integers(0, self.dataset.num_examples(), self.batch_size)
        self._count += 1
        return DataSet(self.dataset.features[idx],
                       None if self.dataset.labels is None else self.dataset.labels[idx])

    def batch(self):
        return self.batch_size


class AsyncDataSetIterator(DataSetIterator):
    """Background-thread prefetch (double buffering), as JAX's
    `AsyncDataSetIterator` (`datasets/iterator/AsyncDataSetIterator.java`
    in DL4J), including worker-exception propagation to the caller.

    Consumer protocol: queue entries are `(batch, more)` pairs, `more`
    evaluated by the WORKER after drawing the batch — so `next()` hands a
    ready batch over immediately and the consumer only ever blocks when
    the next batch genuinely isn't staged yet (waiting for batch k+1
    before releasing batch k would serialize exactly the work the thread
    exists to overlap), and the last batch's tag ends the epoch without a
    final sentinel round-trip. The worker starts lazily on first
    consumption, so wrapping an iterator (or an epoch-start `reset()`)
    never stages batches that are immediately thrown away."""

    _SENTINEL = object()

    def __init__(self, source: DataSetIterator, queue_size: int = 2):
        self.source = source
        self.queue_size = max(1, int(queue_size))
        self._queue: queue.Queue = queue.Queue(self.queue_size)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._peek = None
        self._more = True      # may the worker still yield items?
        self._started = False

    def _prepare(self, ds):
        """Worker-thread hook run on each batch before it is queued —
        subclasses stage extra work here (DevicePrefetchIterator starts
        the host->device copy)."""
        return ds

    def _start(self):
        self._queue = queue.Queue(self.queue_size)
        self._error = None
        self._stop = threading.Event()
        # Bind this generation's queue/stop locally: a stale worker that
        # outlives reset()'s join timeout must keep writing to ITS queue, not
        # the new generation's (else previous-epoch batches leak in).
        q, stop = self._queue, self._stop

        def put(item):
            # stop-aware put: an abandoned consumer must not leave this
            # thread blocked on a full queue forever
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                more = self.source.has_next()
                while more and not stop.is_set():
                    ds = self.source.next()
                    more = self.source.has_next()
                    if not put((self._prepare(ds), more)):
                        return
            except BaseException as e:  # propagate to consumer
                self._error = e
            # ALWAYS end with a sentinel: an empty source yields no tagged
            # item at all, so without it the consumer's first _fetch would
            # block forever. After a fully-tagged epoch the consumer never
            # reads it (the last tag ended the epoch) — the queue has space
            # by then and reset()/close() drain it.
            put(self._SENTINEL)

        self._thread = threading.Thread(target=worker, daemon=True,
                                        name="dl4j-async-prefetch")
        self._thread.start()
        self._started = True
        self._peek = None
        self._more = True

    def _ensure_started(self):
        if not self._started:
            self._start()

    def _fetch(self):
        """Block for the next queue entry; resolves end-of-epoch and
        worker errors."""
        item = self._queue.get()
        if item is self._SENTINEL:
            self._more = False   # before raising: a caller that catches the
            self._peek = None    # error and re-polls must not block forever
            if self._error is not None:
                raise RuntimeError(
                    "Async prefetch thread failed") from self._error
        else:
            self._peek, more = item
            if not more:
                self._more = False

    def _shutdown(self):
        """Stop + join the current worker generation (idempotent)."""
        if self._thread is None:
            return
        self._stop.set()
        # drain so a blocked worker unblocks promptly
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
        self._thread = None

    def close(self):
        """Shut the prefetch thread down. The iterator stays resettable:
        `reset()` (or `__iter__`) restarts a fresh worker."""
        self._shutdown()
        self._peek = None
        self._more = False
        self._started = True   # don't lazily restart; reset() re-arms

    def reset(self):
        self._shutdown()
        self.source.reset()
        self._peek = None
        self._more = True
        self._started = False   # worker restarts on first consumption

    def has_next(self):
        self._ensure_started()
        if self._peek is not None:
            return True
        if not self._more:
            return False
        self._fetch()
        return self._peek is not None

    def next(self):
        if not self.has_next():
            raise StopIteration
        d = self._peek
        self._peek = None
        return d

    def batch(self):
        return self.source.batch()


class AsyncMultiDataSetIterator(AsyncDataSetIterator):
    """Background-thread prefetch over a MULTI-dataset iterator (parity
    with `datasets/iterator/AsyncMultiDataSetIterator.java`) — the prefetch
    machinery is payload-agnostic, so this is the naming/type marker for
    MultiDataSet sources feeding a ComputationGraph."""
