"""Distributed (multi-device) embedding training: the port of
`deeplearning4j_tpu/nlp/distributed.py`, under the same names.

Reference analog (SURVEY.md §2.4): dl4j-spark-nlp / `SparkSequenceVectors`
+ `SparkWord2Vec`: vocab built on the driver, per-partition training,
parameter averaging between stages.

Here, as in the JAX package, multi-device training is plain data
parallelism with exact synchronous SGD: every rank holds the whole tables
and the same host-side stream (vocab, pairs, shuffles and draws from the
same seed), takes its contiguous share of each step's batch rows, and the
step's loss and gradients, sums over the batch, are summed over the ranks
(`parallel.collectives.all_reduce_`) before every rank applies the same
update. One rank per device over torch.distributed (`parallel.make_mesh`):
JAX's sharding hooks (`_sg_place_positions`, `_pair_place`, `_place`)
become a rank's share of the batch.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from ..parallel import collectives
from .glove import Glove
from .word2vec import ParagraphVectors, Word2Vec

__all__ = ["DistributedWord2Vec", "DistributedGlove",
           "DistributedParagraphVectors", "ModelExporter",
           "InMemoryExporter", "FileModelExporter"]


# ---------------------------------------------------------------------------
# Exporter SPI: the `SparkModelExporter` analog (a pluggable sink the
# trained vocab + vectors are pushed through when training finishes;
# `VocabCacheExporter` collects into an in-memory model, `HdfsModelExporter`
# streams to storage).
# ---------------------------------------------------------------------------
class ModelExporter:
    """`export(model)` receives the trained Distributed* model (vocab +
    lookup table populated). Attach via `exporter=` or `.set_exporter`."""

    def export(self, model):
        raise NotImplementedError


class InMemoryExporter(ModelExporter):
    """VocabCacheExporter analog: captures vocab, lookup table, and a
    query-ready WordVectorsModel on the exporter itself."""

    def __init__(self):
        self.vocab = None
        self.lookup_table = None
        self.word_vectors = None

    def export(self, model):
        from .embeddings import WordVectorsModel

        self.vocab = model.vocab
        self.lookup_table = model.lookup_table
        self.word_vectors = WordVectorsModel(model.vocab, model.lookup_table)


class FileModelExporter(ModelExporter):
    """HdfsModelExporter analog: streams the trained vectors to a path
    through `WordVectorSerializer` (format: 'text' | 'binary' | 'zip')."""

    def __init__(self, path: str, fmt: str = "text"):
        if fmt not in ("text", "binary", "zip"):
            raise ValueError(f"unknown export format {fmt!r}")
        self.path = str(path)
        self.fmt = fmt

    def export(self, model):
        from .embeddings import WordVectorsModel
        from .serializer import WordVectorSerializer as S

        wv = WordVectorsModel(model.vocab, model.lookup_table)
        if self.fmt == "text":
            S.write_word_vectors(wv, self.path)
        elif self.fmt == "binary":
            S.write_binary(wv, self.path)
        else:
            S.write_word2vec_model(model, self.path)


class _MeshMixin:
    """Shared data-parallel plumbing for the Distributed* embedding models:
    a rank's share of each batch, the divisibility rules, the step's sum
    over the ranks, and the exporter hook (`SparkSequenceVectors
    .fitSequences` ends by pushing the trained model through its
    exporter). `mesh` is a `parallel.make_mesh` mesh (None: one rank);
    the model's device is the mesh's unless `device=` says otherwise."""

    def _init_mesh(self, mesh, data_axis: str,
                   exporter: Optional[ModelExporter] = None):
        self.mesh = mesh
        self.data_axis = data_axis
        self.exporter = exporter

    @staticmethod
    def _mesh_device(mesh, kw):
        if mesh is not None and kw.get("device") is None:
            kw["device"] = mesh.device
        return kw

    def set_exporter(self, exporter: ModelExporter):
        self.exporter = exporter
        return self

    def fit(self, *a, **kw):
        out = super().fit(*a, **kw)
        if self.exporter is not None:
            self.exporter.export(self)
        return out

    def _axis_size(self) -> int:
        return (self.mesh.axis_size(self.data_axis)
                if self.mesh is not None else 1)

    def _require_divisible(self, B: int) -> int:
        """User-visible batch sizes must divide the axis: silently
        rounding them would re-partition the shuffled stream into other
        steps than the single-device run's."""
        n = self._axis_size()
        if B % n:
            raise ValueError(
                f"batch_size {B} not divisible by the {n}-way "
                f"'{self.data_axis}' mesh axis; pick a multiple so "
                "multi-device steps stay identical to single-device")
        return B

    def _round_up(self, B: int) -> int:
        """Internal (derived) batch sizes can be rounded up safely."""
        n = self._axis_size()
        return -(-B // n) * n

    def _share(self, arr, dim: int):
        """This rank's contiguous share of `arr` along `dim`."""
        n = self._axis_size()
        if n == 1:
            return arr
        r = self.mesh.axis_index(self.data_axis)
        per = arr.shape[dim] // n
        return arr.narrow(dim, r * per, per).contiguous()

    def _step_reduce(self):
        if self.mesh is None or not self.mesh.distributed:
            return None
        group = self.mesh.axis_group(self.data_axis)
        # one eager collective first: NCCL makes its communicator at the
        # first call, which a CUDA-graph capture cannot hold
        collectives.all_reduce_(torch.zeros(1, device=self.device), group)

        def reduce(tensors: List[torch.Tensor]):
            flat = torch.cat([t.reshape(-1).to(tensors[1].dtype)
                              for t in tensors])
            collectives.all_reduce_(flat, group)
            at = 0
            for t in tensors:
                t.copy_(flat[at:at + t.numel()].view_as(t))
                at += t.numel()

        return reduce


class DistributedWord2Vec(_MeshMixin, Word2Vec):
    """Word2Vec with both training paths data-parallel over a mesh axis:
    the SGNS corpus path (a rank's share of each step's center positions)
    and the pair path (a rank's share of each batch). Same math as the
    single-device Word2Vec: each step's batch sum is summed over the
    ranks."""

    def __init__(self, mesh=None, data_axis: str = "data",
                 exporter: Optional[ModelExporter] = None, **kw):
        super().__init__(**self._mesh_device(mesh, kw))
        self._init_mesh(mesh, data_axis, exporter)

    def _sg_round_batch(self, B: int) -> int:
        return self._round_up(B)   # derived centers-per-step: round safely

    def _sg_place_positions(self, pos):
        return self._share(pos, 1)  # [T, B]: the batch axis

    def _pair_round_batch(self, B: int) -> int:
        return self._require_divisible(B)

    def _pair_place(self, arr):
        return self._share(arr, 1)  # [T, B, ...]


class DistributedParagraphVectors(_MeshMixin, ParagraphVectors):
    """ParagraphVectors (DBOW/DM) with the pair batches data-parallel over
    a mesh axis (the `SparkParagraphVectors` capability): per-step batch
    sums summed over the ranks, so it trains as the single-device model
    (batch_size must divide the axis)."""

    def __init__(self, mesh=None, data_axis: str = "data",
                 exporter: Optional[ModelExporter] = None, **kw):
        super().__init__(**self._mesh_device(mesh, kw))
        self._init_mesh(mesh, data_axis, exporter)

    def _pair_round_batch(self, B: int) -> int:
        return self._require_divisible(B)

    def _pair_place(self, arr):
        return self._share(arr, 1)


class DistributedGlove(_MeshMixin, Glove):
    """GloVe with the co-occurrence AdaGrad regression data-parallel over a
    mesh axis (the dl4j-spark-nlp `Glove` capability): co-occurrences
    built host-side on every rank, each AdaGrad batch split over the data
    axis with replicated parameters and the gradients summed, so every
    step is the exact global batch (batch_size must divide the axis)."""

    def __init__(self, mesh=None, data_axis: str = "data",
                 exporter: Optional[ModelExporter] = None, **kw):
        super().__init__(**self._mesh_device(mesh, kw))
        self._init_mesh(mesh, data_axis, exporter)

    def _batch_round(self, B: int) -> int:
        return self._require_divisible(B)

    def _place(self, arr):
        return self._share(arr, 1)   # [T, B]
