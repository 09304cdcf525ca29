"""Shape-stable, device-prefetched input pipeline: the port of
`deeplearning4j_tpu/datasets/pipeline.py`.

Composable stages between any `DataSetIterator` and the fit loops:

  * `PadToBatchIterator` — shape stabilization. Ragged final batches are
    padded up to the fixed batch size with weight-zero rows (every batch
    carries a labels mask whose padded rows are zero), and optionally the
    time axis of sequence data is padded up to a small set of buckets.
    One batch signature per epoch instead of 2+ means ONE capture of the
    window step on the card instead of one per distinct shape.
  * `DevicePrefetchIterator` — device prefetch. A background thread copies
    each batch into pinned host memory and from there to the card with
    `non_blocking=True` on a side stream, one batch ahead, and records an
    event; the step's stream waits on that event before it reads the
    batch, so the copy overlaps the previous step's compute. On the CPU
    the thread only converts the batch to tensors.
  * `MicrobatchSplitIterator` — slices big batches into microbatches for
    `fit(grad_accumulation=M)`.
  * `stage_window` — a superstep window's batches as tensors on the
    device: one pinned copy for the whole window, or the batches the
    prefetch thread already staged.

Padding is a provable learning no-op (see `pad_dataset`): the loss is a
masked mean normalized by the REAL (mask-live) entry count, and the
models' regularization term is normalized by the live ROW count whenever
a labels mask is present — so padded rows contribute neither loss nor
gradient, and the denominator matches the unpadded run. Caveats that
break exactness: BatchNorm in train mode (batch statistics see the pad
rows) and dropout (mask shapes differ, so the per-element randomness
differs) — both stay correct in expectation but are not bitwise-equal to
the unpadded run.

Telemetry (when a session is active): `dl4j_pipeline_rows_total{kind=
real|pad}` (pad_fraction), `dl4j_pipeline_prefetch_wait_seconds` (how
long the consumer stalled waiting on the prefetch thread — ~0 means the
copy fully overlapped compute), `dl4j_pipeline_bucket_hits_total{bucket=
...}` for time bucketing, and `dl4j_pipeline_h2d_bytes_total` (bytes
staged on the card).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from .iterators import (AsyncDataSetIterator, DataSet, DataSetIterator,
                        MultiDataSet)

__all__ = ["PadToBatchIterator", "DevicePrefetchIterator",
           "MicrobatchSplitIterator", "pad_dataset", "pad_rows",
           "build_pipeline", "split_microbatches", "stage_window",
           "stage_batch", "batch_tree", "batch_nbytes", "split_xy"]


# ---------------------------------------------------------------------------
# Telemetry plumbing (no-op when no session is active)
# ---------------------------------------------------------------------------
def _pipeline_metrics():
    """(rows counter, prefetch-wait timer, bucket counter) of the active
    session's registry, or None."""
    from ..telemetry import runtime
    tel = runtime.active()
    if tel is None:
        return None
    reg = tel.registry
    return (reg.counter("dl4j_pipeline_rows_total",
                        "input-pipeline rows by kind (real vs padding)",
                        labels=("kind",)),
            reg.timer("dl4j_pipeline_prefetch_wait_seconds",
                      "seconds the consumer stalled on the prefetch queue"),
            reg.counter("dl4j_pipeline_bucket_hits_total",
                        "batches landing in each time-axis bucket",
                        labels=("bucket",)))


def _count_rows(real: int, pad: int):
    m = _pipeline_metrics()
    if m is not None:
        m[0].inc(real, kind="real")
        if pad:
            m[0].inc(pad, kind="pad")


def _count_h2d(nbytes: int):
    from ..telemetry import runtime
    tel = runtime.active()
    if tel is not None:
        tel.registry.counter("dl4j_pipeline_h2d_bytes_total",
                             "bytes staged on the card by the pipeline"
                             ).inc(nbytes)


def _count_bucket(bucket: int):
    m = _pipeline_metrics()
    if m is not None:
        m[2].inc(1, bucket=str(bucket))


# ---------------------------------------------------------------------------
# Shape stabilization
# ---------------------------------------------------------------------------
def _per_example_mask_shape(labels: np.ndarray) -> tuple:
    """Shape of the per-example loss the losses module reduces over —
    `[B]` for flat labels, `[B, T]` for sequence labels (losses._apply_mask
    broadcasts the mask over the trailing feature axis)."""
    return labels.shape[:-1] if labels.ndim >= 2 else (labels.shape[0],)


def pad_rows(a, n_pad):
    """Append `n_pad` zero rows along axis 0 (the PadToBatch row
    shaping)."""
    if a is None or n_pad == 0:
        return a
    return np.concatenate(
        [a, np.zeros((n_pad,) + a.shape[1:], dtype=a.dtype)], axis=0)


_pad_rows = pad_rows


def split_xy(record: np.ndarray, feature_width: int
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Split a record `[rows, feature_width + ny]` into `(features,
    labels)` float32 arrays (the record form of the streaming plane's
    training windows, ROADMAP A10). A 1-D record is treated as a single
    row."""
    a = np.asarray(record, np.float32)
    if a.ndim == 1:
        a = a[None]
    if a.ndim != 2 or a.shape[1] <= feature_width:
        raise ValueError(
            f"record shape {tuple(a.shape)} cannot split into "
            f"features[:{feature_width}] + labels — expected "
            f"[rows, > {feature_width}]")
    return a[:, :feature_width], a[:, feature_width:]


def _pad_time(a, t_pad, axis=1):
    if a is None or t_pad == 0 or a.ndim <= axis:
        return a
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, t_pad)
    return np.pad(a, widths)


def pad_dataset(ds, target_rows: int, time_target: Optional[int] = None):
    """Pad `ds` (DataSet or MultiDataSet) up to `target_rows` rows (and,
    for rank>=3 features, up to `time_target` timesteps) with weight-zero
    entries. Returns `(padded, n_real, n_pad)`.

    The padded dataset ALWAYS carries a labels mask (ones over real
    entries, zeros over padding) so every batch of an epoch shares one
    signature and the loss/regularization normalize by the real count.
    A features mask is synthesized only when the time axis is padded
    (row-only padding leaves absent features masks absent, preserving
    the network's unmasked forward path)."""
    if isinstance(ds, MultiDataSet):
        return _pad_multi(ds, target_rows)
    n = ds.num_examples()
    n_pad = target_rows - n
    if n_pad < 0:
        raise ValueError(
            f"batch of {n} rows exceeds the pipeline batch size "
            f"{target_rows}; PadToBatchIterator only pads, never splits")
    feats = np.asarray(ds.features)
    labels = None if ds.labels is None else np.asarray(ds.labels)
    fmask = None if ds.features_mask is None else np.asarray(ds.features_mask)
    lmask = None if ds.labels_mask is None else np.asarray(ds.labels_mask)

    t_pad = 0
    if time_target is not None and feats.ndim >= 3:
        t = feats.shape[1]
        t_pad = time_target - t
        if t_pad < 0:
            raise ValueError(
                f"sequence length {t} exceeds the largest time bucket "
                f"{time_target}")
        if t_pad:
            feats = _pad_time(feats, t_pad)
            if labels is not None and labels.ndim >= 3:
                labels = _pad_time(labels, t_pad)
            lmask = _pad_time(lmask, t_pad)
        # a padded time axis needs a features mask so recurrent layers see
        # the true lengths; synthesize one even for t_pad == 0 batches so
        # bucketed epochs stay signature-stable
        if fmask is None:
            fmask = np.zeros(feats.shape[:2], np.float32)
            fmask[:n, :feats.shape[1] - t_pad] = 1.0
        else:
            fmask = _pad_time(fmask, t_pad)

    if lmask is None and labels is not None:
        shape = _per_example_mask_shape(labels)
        lmask = np.ones(shape, np.float32)
        if t_pad and len(shape) >= 2:
            lmask[:, shape[1] - t_pad:] = 0.0
    feats = _pad_rows(feats, n_pad)
    labels = _pad_rows(labels, n_pad)
    fmask = _pad_rows(fmask, n_pad)
    lmask = _pad_rows(lmask, n_pad)
    return DataSet(feats, labels, fmask, lmask), n, n_pad


def _pad_multi(ds: MultiDataSet, target_rows: int):
    """Row padding for MultiDataSet (time bucketing is single-DataSet
    only): every output gets a labels mask with zero pad rows."""
    n = ds.num_examples()
    n_pad = target_rows - n
    if n_pad < 0:
        raise ValueError(
            f"batch of {n} rows exceeds the pipeline batch size "
            f"{target_rows}; PadToBatchIterator only pads, never splits")
    feats = [_pad_rows(np.asarray(a), n_pad) for a in ds.features]
    labels = [_pad_rows(np.asarray(a), n_pad) for a in ds.labels]
    fmasks = None
    if ds.features_masks is not None:
        fmasks = [None if m is None else _pad_rows(np.asarray(m), n_pad)
                  for m in ds.features_masks]
    lmasks = list(ds.labels_masks) if ds.labels_masks is not None \
        else [None] * len(ds.labels)
    for i, (lab, m) in enumerate(zip(ds.labels, lmasks)):
        if m is None:
            m = np.ones(_per_example_mask_shape(np.asarray(lab)), np.float32)
        else:
            m = np.asarray(m)
        lmasks[i] = _pad_rows(m, n_pad)
    return MultiDataSet(features=feats, labels=labels,
                        features_masks=fmasks, labels_masks=lmasks), n, n_pad


class PadToBatchIterator(DataSetIterator):
    """Pads every batch of `source` up to a fixed row count (and optional
    time buckets) with weight-zero entries — see `pad_dataset` for the
    no-op argument. Batch size comes from `batch_size`, else
    `source.batch()`, else lazily from the first batch of the epoch
    (standard iterators emit full batches first, ragged batch last).

    `time_buckets`: ascending sequence of allowed sequence lengths; each
    rank-3 batch is padded up to the smallest bucket >= its length, so an
    epoch of arbitrary lengths produces at most `len(time_buckets)`
    signatures."""

    def __init__(self, source: DataSetIterator, batch_size: Optional[int] = None,
                 time_buckets: Optional[Sequence[int]] = None):
        self.source = source
        declared = int(batch_size) if batch_size else 0
        if declared <= 0:
            declared = int(getattr(source, "batch", lambda: 0)() or 0)
        self._target = declared if declared > 0 else None
        self._target_inferred = self._target is None
        self.time_buckets = (tuple(sorted(int(b) for b in time_buckets))
                             if time_buckets else None)
        self.pad_rows = 0
        self.real_rows = 0

    def _bucket_for(self, t: int) -> int:
        for b in self.time_buckets:
            if t <= b:
                return b
        raise ValueError(
            f"sequence length {t} exceeds the largest time bucket "
            f"{self.time_buckets[-1]}")

    def reset(self):
        self.source.reset()

    def has_next(self) -> bool:
        return self.source.has_next()

    def next(self) -> DataSet:
        ds = self.source.next()
        n = ds.num_examples()
        if self._target is None:
            self._target = n
        elif self._target_inferred and n > self._target:
            # the lazy inference assumed full-batches-first (the standard
            # iterator layout); a growing batch means it guessed wrong
            raise ValueError(
                f"batch of {n} rows exceeds the batch size {self._target} "
                "inferred from this epoch's first batch; pass "
                "PadToBatchIterator(batch_size=...) explicitly for sources "
                "whose batch() is unknown and whose first batch is not "
                "full-size")
        time_target = None
        if (self.time_buckets is not None and not isinstance(ds, MultiDataSet)
                and np.asarray(ds.features).ndim >= 3):
            time_target = self._bucket_for(np.asarray(ds.features).shape[1])
            _count_bucket(time_target)
        padded, n_real, n_pad = pad_dataset(ds, self._target, time_target)
        self.real_rows += n_real
        self.pad_rows += n_pad
        _count_rows(n_real, n_pad)
        return padded

    def batch(self) -> int:
        return self._target or self.source.batch()

    @property
    def pad_fraction(self) -> float:
        total = self.real_rows + self.pad_rows
        return self.pad_rows / total if total else 0.0


# ---------------------------------------------------------------------------
# Device staging
# ---------------------------------------------------------------------------
def batch_tree(ds):
    """(features, labels, features masks, labels masks) of a DataSet or
    MultiDataSet as they are (numpy arrays or tensors; lists of them for a
    MultiDataSet), None where absent."""
    if isinstance(ds, MultiDataSet):
        seq = lambda xs: None if xs is None else list(xs)
        return (seq(ds.features), seq(ds.labels), seq(ds.features_masks),
                seq(ds.labels_masks))
    return (ds.features, ds.labels, ds.features_mask, ds.labels_mask)


def _to_device(tree, device, dtype):
    """Every array or tensor of a `batch_tree` as a `dtype` tensor on
    `device`: host arrays to a CUDA device through pinned memory with a
    non-blocking copy (on the current stream). Returns (tree, bytes
    copied from the host)."""
    import torch
    from ..nn.trees import flatten_tree

    leaves, rebuild = flatten_tree(tree)
    out, nbytes = [], 0
    for a in leaves:
        if a is None:
            out.append(None)
            continue
        t = torch.as_tensor(a if isinstance(a, torch.Tensor)
                            else np.ascontiguousarray(a)).to(dtype)
        if device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory().to(device, non_blocking=True)
            nbytes += t.numel() * t.element_size()
        out.append(t.to(device))
    return rebuild(out), nbytes


def stage_batch(ds, device, dtype):
    """Start copying `ds` to `device` now (on a side stream, through
    pinned memory) and keep the copy in `ds._staged` with the event the
    step's stream must wait on. Returns `ds`."""
    import torch

    if device.type == "cuda":
        stream = _side_stream(device)
        with torch.cuda.stream(stream):
            tree, nbytes = _to_device(batch_tree(ds), device, dtype)
            event = torch.cuda.Event()
            event.record(stream)
        _count_h2d(nbytes)
    else:
        tree, _ = _to_device(batch_tree(ds), device, dtype)
        event = None
    ds._staged = (device, dtype, tree, event)
    return ds


_SIDE_STREAMS = {}


def _side_stream(device):
    import torch
    s = _SIDE_STREAMS.get(device)
    if s is None:
        s = _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return s


def staged_tree(ds, device, dtype):
    """The tensors `stage_batch` staged for `ds` on `device` in `dtype`, made
    safe to read on the current stream (it waits on the copy's event, and
    the tensors are recorded on it), or None when `ds` was not staged
    there."""
    import torch
    from ..nn.trees import flatten_tree

    st = getattr(ds, "_staged", None)
    if st is None or st[0] != device or st[1] != dtype:
        return None
    tree, event = st[2], st[3]
    if event is not None:
        cur = torch.cuda.current_stream(device)
        cur.wait_event(event)
        for t in flatten_tree(tree)[0]:
            if t is not None:
                t.record_stream(cur)
    return tree


class DevicePrefetchIterator(AsyncDataSetIterator):
    """Background-thread DEVICE prefetch: one batch ahead, the worker
    copies the batch into pinned memory and to `device` on a side stream
    (`stage_batch`), so the copy overlaps the previous step's compute and
    the step finds its batch staged (double buffering, the
    `AsyncDataSetIterator` contract extended from host assembly to the
    transfer). Accepts DataSet and MultiDataSet sources alike. With no
    `device` it only assembles batches on the thread."""

    def __init__(self, source: DataSetIterator, queue_size: int = 2,
                 device=None, dtype=None):
        super().__init__(source, queue_size=queue_size)
        self.device = device
        self.dtype = dtype

    def _prepare(self, ds):
        if self.device is not None:
            stage_batch(ds, self.device, self.dtype)
        return ds

    def _fetch(self):
        m = _pipeline_metrics()
        if m is None:
            return super()._fetch()
        with m[1].time():
            return super()._fetch()


# ---------------------------------------------------------------------------
# Microbatch splitting (gradient accumulation input side)
# ---------------------------------------------------------------------------
class MicrobatchSplitIterator(DataSetIterator):
    """Slice every batch of `source` into consecutive microbatches of
    `microbatch_size` rows (zero-copy numpy views) — the input-side half
    of gradient accumulation. A big-batch pipeline composes with
    `fit(grad_accumulation=M)` as::

        it = split_microbatches(big_batch_iterator, b)   # B = M·b rows
        model.fit(it, grad_accumulation=M)

    and trains the IDENTICAL [M, b, ...] stacked windows a native
    microbatch iterator over the same rows would: staging M contiguous
    row-slices of one array equals reshaping that array to [M, b, ...],
    so "one batch of M·b rows" and "M microbatches of b rows" are the
    same bits by construction (tests/test_torch_accumulation.py holds
    it). A source batch whose row count is not a multiple of
    `microbatch_size` yields a smaller final slice — a signature change
    that closes the accumulation group early, exactly like a ragged tail
    (pad_ragged upstream keeps every slice full)."""

    def __init__(self, source: DataSetIterator, microbatch_size: int):
        if int(microbatch_size) < 1:
            raise ValueError(
                f"microbatch_size must be a positive int, got "
                f"{microbatch_size!r}")
        self.source = source
        self.microbatch_size = int(microbatch_size)
        self._pending = []

    def _slices(self, ds):
        n = ds.num_examples()
        b = self.microbatch_size
        if n <= b:
            return [ds]
        cut = lambda a, lo, hi: None if a is None else np.asarray(a)[lo:hi]
        out = []
        for lo in range(0, n, b):
            hi = min(lo + b, n)
            if isinstance(ds, MultiDataSet):
                cl = lambda xs: (None if xs is None
                                 else [cut(a, lo, hi) for a in xs])
                out.append(MultiDataSet(features=cl(ds.features),
                                        labels=cl(ds.labels),
                                        features_masks=cl(ds.features_masks),
                                        labels_masks=cl(ds.labels_masks)))
            else:
                out.append(DataSet(cut(ds.features, lo, hi),
                                   cut(ds.labels, lo, hi),
                                   cut(ds.features_mask, lo, hi),
                                   cut(ds.labels_mask, lo, hi)))
        return out

    def reset(self):
        self._pending = []
        self.source.reset()

    def has_next(self) -> bool:
        return bool(self._pending) or self.source.has_next()

    def next(self):
        if not self._pending:
            self._pending = self._slices(self.source.next())
        return self._pending.pop(0)

    def batch(self) -> int:
        return self.microbatch_size

    def set_epoch(self, epoch: int):
        if hasattr(self.source, "set_epoch"):
            self.source.set_epoch(epoch)


def split_microbatches(source: DataSetIterator, microbatch_size: int
                       ) -> MicrobatchSplitIterator:
    """Convenience constructor for `MicrobatchSplitIterator`."""
    return MicrobatchSplitIterator(source, microbatch_size)


# ---------------------------------------------------------------------------
# Superstep window staging
# ---------------------------------------------------------------------------
def stage_window(window, device, dtype):
    """A superstep window's batches as tensor trees on `device` (the
    input of `nn/superstep.run_window`): the batches a
    `DevicePrefetchIterator` already staged there as they are; otherwise
    each array of the window stacked on the host and copied in ONE
    pinned, non-blocking transfer, then split into per-batch views. Under
    the pipelined superstep loop this runs while the previous window's
    replays run on the card."""
    import torch
    from ..nn.trees import flatten_tree

    trees = [staged_tree(ds, device, dtype) for ds in window]
    if all(t is not None for t in trees):
        return trees
    flat = [flatten_tree(batch_tree(ds)) for ds in window]
    rebuild = flat[0][1]
    columns = []
    for j in range(len(flat[0][0])):
        leaves = [f[0][j] for f in flat]
        if leaves[0] is None:
            columns.append([None] * len(window))
            continue
        stack = (torch.stack if isinstance(leaves[0], torch.Tensor)
                 else np.stack)
        stacked, nbytes = _to_device(stack(leaves), device, dtype)
        _count_h2d(nbytes)
        columns.append(list(torch.unbind(stacked, 0)))
    return [rebuild([col[i] for col in columns])
            for i in range(len(window))]


def batch_nbytes(arrays) -> int:
    """Byte size of one batch's arrays or tensors (None entries skipped),
    from shapes and dtypes only: `superstep="auto"` window sizing."""
    total = 0
    for a in arrays:
        shape = getattr(a, "shape", None)
        if a is None or shape is None:
            continue
        size = getattr(a, "element_size", None)
        item = size() if callable(size) else np.dtype(
            getattr(a, "dtype", np.float32)).itemsize
        total += int(np.prod(tuple(shape))) * int(item)
    return total


# ---------------------------------------------------------------------------
# Fit-path assembly
# ---------------------------------------------------------------------------
def build_pipeline(data: DataSetIterator, *, pad_ragged: bool = False,
                   prefetch: bool = False,
                   batch_size: Optional[int] = None,
                   time_buckets: Optional[Sequence[int]] = None,
                   queue_size: int = 2, device=None,
                   dtype=None) -> Tuple[DataSetIterator, callable]:
    """Wrap `data` with the requested pipeline stages (the prefetch stages
    batches on `device` in `dtype`, the model's). Returns `(iterator,
    close)`; callers MUST invoke `close()` when done so the prefetch
    thread shuts down instead of leaking across fits."""
    it = data
    if pad_ragged or time_buckets:
        it = PadToBatchIterator(it, batch_size=batch_size,
                                time_buckets=time_buckets)
    if prefetch and getattr(data, "async_supported", True):
        it = DevicePrefetchIterator(it, queue_size=queue_size,
                                    device=device, dtype=dtype)
        return it, it.close
    return it, lambda: None
