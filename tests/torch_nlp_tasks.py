"""The rank side of the port's distributed word-vector tests: functions a
`torch_world` World runs on each rank (`fn(ctx, *args)`, ctx.mesh a
data-axis mesh of the task's width). They import only torch and the port,
and take and return numpy arrays and plain values.

`Replay` hands a model the device-side draws the parent's single-device
run recorded (`Record`), in the order it made them: every rank then trains
on the same stream as that run (JAX's, where the parent drew JAX's)."""
import torch

from deeplearning4j_tpu_torch import nlp
from deeplearning4j_tpu_torch.nlp.distributed import (
    DistributedGlove, DistributedParagraphVectors, DistributedWord2Vec,
    FileModelExporter, InMemoryExporter)
from deeplearning4j_tpu_torch.nlp.embeddings import InMemoryLookupTable


class Record:
    """Keeps a copy of every device-side draw the model makes."""

    def _recorded(self):
        if getattr(self, "recorded", None) is None:
            self.recorded = {"sg": [], "pair": []}
        return self.recorded

    def _sg_draws(self, gen, n, T, B):
        pos, win = super()._sg_draws(gen, n, T, B)
        self._recorded()["sg"].append((pos.cpu().numpy(), win.cpu().numpy()))
        return pos, win

    def _pair_negatives(self, gen, table, T, B, K):
        negs = super()._pair_negatives(gen, table, T, B, K)
        self._recorded()["pair"].append(negs.cpu().numpy())
        return negs


class Replay:
    """Draws from `self.draws` ({"sg": [(positions, windows)], "pair":
    [negatives]}), in order."""

    def _sg_draws(self, gen, n, T, B):
        pos, win = self.draws["sg"].pop(0)
        assert pos.shape == (T, B), (pos.shape, T, B)
        return torch.as_tensor(pos), torch.as_tensor(win)

    def _pair_negatives(self, gen, table, T, B, K):
        negs = self.draws["pair"].pop(0)
        assert negs.shape == (T, B, K), (negs.shape, T, B, K)
        return torch.as_tensor(negs)


def tables(m):
    t = m.lookup_table
    return {k: getattr(t, k).detach().cpu().numpy().copy()
            for k in ("syn0", "syn1", "syn1neg")
            if getattr(t, k, None) is not None}


def put_tables(m, tabs):
    t = m.lookup_table
    m.lookup_table = InMemoryLookupTable.from_arrays(
        m.vocab, tabs["syn0"], tabs.get("syn1"), tabs.get("syn1neg"),
        use_hs=t.use_hs, negative=t.negative, device="cpu")


def _copy_draws(draws):
    return {"sg": [(p.copy(), w.copy()) for p, w in draws.get("sg", [])],
            "pair": [n.copy() for n in draws.get("pair", [])]}


def word2vec_fit(ctx, sents, kw, init=None, draws=None, labels=None):
    """A Distributed{Word2Vec, ParagraphVectors} fit on the rank's mesh:
    from `init` tables and replayed `draws` when given, else the rank's own
    (seeded) ones. Returns the tables."""
    if labels is None:
        base = DistributedWord2Vec
        src = dict(sentence_iterator=nlp.CollectionSentenceIterator(sents))
    else:
        base = DistributedParagraphVectors
        src = dict(iterator=nlp.CollectionLabeledSentenceIterator(sents,
                                                                  labels))
    cls = type("R", (Replay, base), {}) if draws is not None else base
    m = cls(mesh=ctx.mesh, device="cpu", **src, **kw)
    m.build_vocab()
    if init is not None:
        put_tables(m, init)
    if draws is not None:
        m.draws = _copy_draws(draws)
    m.fit()
    return tables(m)


def word2vec_learns(ctx, sents, kw):
    m = DistributedWord2Vec(mesh=ctx.mesh, device="cpu",
                            sentence_iterator=nlp.CollectionSentenceIterator(
                                sents), **kw)
    m.fit()
    return (m.similarity("cat", "dog"), m.similarity("cat", "wheel"))


class _InitGlove:
    init = None

    def _init_params(self, V, D):
        p = {k: torch.as_tensor(self.init[k]) for k in ("w", "wc")}
        p.update(b=torch.zeros(V), bc=torch.zeros(V))
        return p


def glove_fit(ctx, sents, kw, init=None):
    cls = type("G", (_InitGlove, DistributedGlove), {}) if init else \
        DistributedGlove
    g = cls(mesh=ctx.mesh, device="cpu",
            sentence_iterator=nlp.CollectionSentenceIterator(sents), **kw)
    if init:
        g.init = init
    g.fit()
    return g.lookup_table.vectors_matrix()


def glove_refuses(ctx, sents, kw):
    g = DistributedGlove(mesh=ctx.mesh, device="cpu",
                         sentence_iterator=nlp.CollectionSentenceIterator(
                             sents), **kw)
    try:
        g.fit()
    except ValueError as e:
        return str(e)
    return None


def exporters(ctx, sents, kw, path):
    mem = InMemoryExporter()
    w2v = DistributedWord2Vec(mesh=ctx.mesh, device="cpu",
                              sentence_iterator=nlp.CollectionSentenceIterator(
                                  sents), exporter=mem, **kw)
    w2v.fit()
    out = {"exported": mem.word_vectors is not None,
           "same_vocab": mem.vocab is w2v.vocab,
           "mem_alpha": mem.word_vectors.word_vector("alpha"),
           "alpha": w2v.lookup_table.vector("alpha")}
    if ctx.mesh.rank == 0:
        w2v.set_exporter(FileModelExporter(path, fmt="text"))
    else:
        w2v.set_exporter(None)
    w2v.fit()
    out["alpha_after"] = w2v.lookup_table.vector("alpha")
    return out
