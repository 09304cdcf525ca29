"""Export-based dataset plane — minibatches saved to files, training fed
from paths (the port of `deeplearning4j_tpu/datasets/export.py`, which is
framework-free: the files are the same `.npz`, so either package reads the
other's exports).

The reference's DEFAULT cluster training path (`RDDTrainingApproach.Export`,
selected at `ParameterAveragingTrainingMaster.java:101,366`) saves the RDD
as minibatch files (`BatchAndExportDataSetsFunction.java` — re-batches to
the exact minibatch size, writes `dataset_<idx>.bin`) and trains from a
path-based iterator (`PathSparkDataSetIterator.java`,
`util/ExportSupport.java`) so (a) the dataset never has to fit in
driver/worker RAM and (b) failed/interrupted work is recomputable from the
saved files.

Form here: `.npz` minibatch files + `PathDataSetIterator` (composes with
the port's `AsyncDataSetIterator` for prefetch). The multi-process plane
writes PER-RANK SHARD files per global batch (`export_sharded`), so each
rank reads only its own slice (`ShardedPathDataSetIterator` yields
`LocalShardDataSet`s, which `ParallelTrainer` trains as they are) —
in-memory and path-based training give the same bits.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Union

import numpy as np

from .iterators import (AsyncDataSetIterator, DataSet, DataSetIterator,
                        IteratorDataSetIterator)

__all__ = ["export_datasets", "export_sharded", "load_dataset",
           "PathDataSetIterator", "ShardedPathDataSetIterator",
           "LocalShardDataSet"]

_FIELDS = ("features", "labels", "features_mask", "labels_mask")


def _save(path: str, ds: DataSet):
    arrays = {k: getattr(ds, k) for k in _FIELDS
              if getattr(ds, k) is not None}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)   # atomic: a crash never leaves a torn file


def load_dataset(path: Union[str, os.PathLike]) -> DataSet:
    """Load one exported minibatch file."""
    with np.load(path) as z:
        kw = {k: z[k] for k in _FIELDS if k in z.files}
    return DataSet(**kw)


def _as_batches(data, batch_size: Optional[int]):
    """Shared exporter preamble: optionally re-batch to the exact size
    (the reference's `BatchAndExportDataSetsFunction` behavior), reset,
    and return an iterator of DataSets."""
    if batch_size is not None:
        if not isinstance(data, DataSetIterator):
            from .iterators import ListDataSetIterator
            data = ListDataSetIterator(list(data))
        data = IteratorDataSetIterator(data, batch_size=batch_size)
    if isinstance(data, DataSetIterator):
        data.reset()
    return iter(data)


def export_datasets(data, directory: Union[str, os.PathLike],
                    prefix: str = "dataset",
                    batch_size: Optional[int] = None) -> List[str]:
    """Write every minibatch of `data` (a DataSetIterator or iterable of
    DataSet) as `<prefix>_<idx>.npz` under `directory`; returns the paths
    in order. `batch_size` re-batches to the exact size first."""
    directory = str(directory)
    os.makedirs(directory, exist_ok=True)
    paths = []
    for i, ds in enumerate(_as_batches(data, batch_size)):
        p = os.path.join(directory, f"{prefix}_{i:05d}.npz")
        _save(p, ds)
        paths.append(p)
    return paths


def export_sharded(data, directory: Union[str, os.PathLike],
                   n_shards: int, prefix: str = "dataset",
                   batch_size: Optional[int] = None) -> List[List[str]]:
    """Multi-process exporter: each minibatch is split into `n_shards` equal
    row slices saved as `<prefix>_<idx>.shard<k>.npz`; process k later
    reads ONLY its shard files (`ShardedPathDataSetIterator`). Returns
    paths[k] = ordered shard-k paths. Batches must divide by n_shards
    (uniform SPMD shards — ragged tails are an error, as in
    `local_batch_slice`)."""
    directory = str(directory)
    os.makedirs(directory, exist_ok=True)
    paths: List[List[str]] = [[] for _ in range(n_shards)]
    for i, ds in enumerate(_as_batches(data, batch_size)):
        n = ds.num_examples()
        if n % n_shards:
            raise ValueError(
                f"batch {i} has {n} examples, not divisible into "
                f"{n_shards} uniform shards; re-batch upstream")
        per = n // n_shards
        for k in range(n_shards):
            sl = slice(k * per, (k + 1) * per)
            cut = lambda a: None if a is None else a[sl]
            shard = DataSet(cut(ds.features), cut(ds.labels),
                            cut(ds.features_mask), cut(ds.labels_mask))
            p = os.path.join(directory, f"{prefix}_{i:05d}.shard{k}.npz")
            _save(p, shard)
            paths[k].append(p)
    return paths


class PathDataSetIterator(DataSetIterator):
    """Iterate minibatches from saved files (`PathSparkDataSetIterator`
    analog): only one minibatch is resident at a time, so the dataset
    never has to fit in RAM. Wrap in `AsyncDataSetIterator` to overlap
    disk reads with device steps. `start_from` skips already-consumed
    files — resuming an interrupted run from the export directory."""

    def __init__(self, paths: Sequence[Union[str, os.PathLike]],
                 shuffle: bool = False, seed: Optional[int] = None,
                 start_from: int = 0):
        self.paths = [str(p) for p in paths]
        self.shuffle = shuffle
        self.seed = seed
        self.start_from = int(start_from)
        if self.start_from and shuffle and seed is None:
            # resume skips `start_from` positions of a permutation the
            # interrupted run can't have recorded — the resumed run would
            # process a different file subset than the one actually left
            raise ValueError(
                "start_from with shuffle=True needs a seed: an unseeded "
                "permutation cannot reproduce the interrupted run's order")
        self._epoch = 0
        self._started = False   # no batch consumed yet
        self.reset()

    @classmethod
    def from_directory(cls, directory: Union[str, os.PathLike],
                       prefix: str = "dataset", **kw):
        directory = str(directory)
        names = sorted(n for n in os.listdir(directory)
                       if n.startswith(prefix) and n.endswith(".npz"))
        return cls([os.path.join(directory, n) for n in names], **kw)

    def reset(self):
        # the epoch counter advances only once consumption has started:
        # however many resets precede the first batch (__init__ does one,
        # __iter__ may do another), the first traversal's permutation is a
        # function of `seed` ALONE — so a resumed run (start_from > 0)
        # skips exactly the files the interrupted run consumed
        if self._started:
            self._epoch += 1
        order = np.arange(len(self.paths))
        if self.shuffle:
            rng = np.random.default_rng(
                None if self.seed is None else self.seed + self._epoch)
            order = rng.permutation(len(self.paths))
        # only the FIRST traversal resumes mid-way; once a batch has been
        # consumed, reset() means a fresh full epoch
        offset = 0 if self._started else self.start_from
        self._order = order[offset:]
        self._pos = 0

    def has_next(self) -> bool:
        return self._pos < len(self._order)

    def next(self) -> DataSet:
        self._started = True
        ds = self._load(self.paths[self._order[self._pos]])
        self._pos += 1
        return ds

    def _load(self, path: str) -> DataSet:
        return load_dataset(path)

    def batch(self) -> int:
        if not self.paths:
            return 0
        return load_dataset(self.paths[0]).num_examples()

    def async_prefetch(self, queue_size: int = 2) -> AsyncDataSetIterator:
        return AsyncDataSetIterator(self, queue_size=queue_size)


class LocalShardDataSet(DataSet):
    """A DataSet whose rows are THIS RANK's shard of a global batch: the
    parallel trainer trains it as it is instead of slicing a replicated
    global batch."""

    is_local_shard = True


class ShardedPathDataSetIterator(PathDataSetIterator):
    """Multi-process path iterator: given the shard-k paths written by
    `export_sharded` (or any per-rank path list), yields
    `LocalShardDataSet`s. Each rank touches only its own files — the
    dataset plane never materializes the global batch on any single
    rank."""

    def __init__(self, paths, shard_index: Optional[int] = None, **kw):
        if shard_index is not None:
            # select this rank's shard files from a full listing
            paths = [p for p in paths if f".shard{shard_index}." in str(p)]
        super().__init__(paths, **kw)

    def _load(self, path: str) -> DataSet:
        ds = load_dataset(path)
        return LocalShardDataSet(ds.features, ds.labels,
                                 ds.features_mask, ds.labels_mask)
