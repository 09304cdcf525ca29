"""PyTorch port, distributed word vectors (`nlp/distributed.py`) on gloo
worlds of 2 and 4 CPU ranks, held against the port's single-device fit and
against the JAX package's `make_mesh({"data": 8})` (the twins of
`tests/test_nlp_distributed.py`'s six tests: JAX's limits, rtol 5e-4 and
atol 1e-5).

Each rank takes its share of every step's batch rows and the step's loss
and gradients are summed over the ranks (`parallel.collectives`), so a
world trains as one device does. The single-device references train on
JAX's tables and draws (`jax_nlp_draws.JaxDraws`) and record the draws
(`torch_nlp_tasks.Record`); the ranks start from the same tables and
replay the recorded draws (`Replay`), so port world, port single device
and JAX's 8-device mesh share one stream. The rank processes are forked
once per module inside `torch_threads.pinned()` (the worker's core, nice
19), and JAX's references are computed once per module.
"""
import numpy as np
import pytest

import deeplearning4j_tpu.nlp as jnlp
from deeplearning4j_tpu.nlp.distributed import (
    DistributedGlove as JaxDistributedGlove,
    DistributedParagraphVectors as JaxDistributedPV,
    DistributedWord2Vec as JaxDistributedWord2Vec)
from deeplearning4j_tpu.parallel import make_mesh as jax_make_mesh
import deeplearning4j_tpu_torch.nlp as pnlp
from jax_nlp_draws import JaxDraws, JaxInitGlove, carry
from torch_nlp_tasks import Record, tables
import torch_nlp_tasks as tasks
from torch_threads import one_torch_thread, pinned  # noqa: F401
from torch_world import World

RTOL, ATOL = 5e-4, 1e-5


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    with pinned():
        w = World(4, tmp_path_factory.mktemp("nlp_world"), widths=(1, 2))
    yield w
    w.close()


def _corpus(n=2000, seed=0):
    r = np.random.default_rng(seed)
    words = r.zipf(1.3, size=(n, 12)) % 300
    return [" ".join(f"w{w}" for w in row) for row in words]


def _kw():
    return dict(layer_size=32, window_size=4, negative=5, epochs=2,
                min_word_frequency=1, seed=9, batch_size=2048)


class RecW2V(Record, JaxDraws, pnlp.Word2Vec):
    pass


class RecPV(Record, JaxDraws, pnlp.ParagraphVectors):
    pass


def _reference(jcls, pcls, kw, sents, labels=None):
    """JAX's 8-device-mesh fit, and the port's single-device fit on JAX's
    tables and draws: (jax tables, port tables, initial tables, the
    port's recorded draws)."""
    if labels is None:
        jsrc = dict(sentence_iterator=jnlp.CollectionSentenceIterator(sents))
        psrc = dict(sentence_iterator=pnlp.CollectionSentenceIterator(sents))
    else:
        jsrc = dict(iterator=jnlp.CollectionLabeledSentenceIterator(
            sents, labels))
        psrc = dict(iterator=pnlp.CollectionLabeledSentenceIterator(
            sents, labels))
    jm = jcls(mesh=jax_make_mesh({"data": 8}), **jsrc, **kw)
    pm = pcls(device="cpu", **psrc, **kw)
    jm.build_vocab()
    pm.build_vocab()
    carry(jm, pm)
    init = tables(pm)
    jm.fit()
    pm.fit()
    jt = {k: np.asarray(getattr(jm.lookup_table, k))
          for k in ("syn0", "syn1neg")}
    return jt, tables(pm), init, pm.recorded


@pytest.fixture(scope="module")
def w2v_ref():
    with pinned():
        return _reference(JaxDistributedWord2Vec, RecW2V, _kw(), _corpus())


@pytest.mark.parametrize("width", [2, 4])
def test_distributed_w2v_matches_single_device(world, w2v_ref, width):
    """The SGNS corpus path over 2 and 4 ranks (each rank a quarter of the
    512 centers a step) == the single-device fit on the same draws, and
    == JAX's DistributedWord2Vec on its 8-device mesh."""
    jt, single, init, draws = w2v_ref
    out = world.run(tasks.word2vec_fit, _corpus(), _kw(), init, draws,
                    width=width)
    for got in out:
        for k in ("syn0", "syn1neg"):
            np.testing.assert_allclose(got[k], single[k], rtol=RTOL,
                                       atol=ATOL)
            np.testing.assert_allclose(got[k], jt[k], rtol=RTOL, atol=ATOL)
    for got in out[1:]:     # every rank holds the same tables
        np.testing.assert_array_equal(got["syn0"], out[0]["syn0"])


def test_one_rank_world_is_bit_equal_to_the_single_device_fit(world,
                                                              w2v_ref):
    """A one-rank group (the collective sums one share) trains bit for
    bit as the single-device fit."""
    _, single, init, draws = w2v_ref
    got, = world.run(tasks.word2vec_fit, _corpus(), _kw(), init, draws,
                     width=1)
    for k in ("syn0", "syn1neg"):
        np.testing.assert_array_equal(got[k], single[k])


def test_distributed_w2v_learns(world):
    """On its own draws over 4 ranks (twin of test_distributed_w2v_learns)."""
    sents = []
    for i in range(800):
        a = ["cat", "dog", "pet", "fur"][i % 4]
        b = ["car", "road", "wheel", "drive"][i % 4]
        sents.append(f"{a} {a} pet animal fur tail")
        sents.append(f"{b} {b} vehicle road wheel engine")
    kw = dict(layer_size=32, window_size=3, negative=5, epochs=2,
              min_word_frequency=1, seed=4)
    for same, cross in world.run(tasks.word2vec_learns, sents, kw):
        assert same > cross + 0.1, (same, cross)


@pytest.fixture(scope="module")
def glove_ref():
    """JAX's DistributedGlove on its 8-device mesh and the port's
    single-device Glove from JAX's initial w / wc."""
    with pinned():
        import jax
        import jax.numpy as jnp
        sents = _corpus(600, seed=3)
        kw = dict(layer_size=16, window=6, epochs=3, batch_size=1024,
                  min_word_frequency=1, seed=5)
        jg = JaxDistributedGlove(
            mesh=jax_make_mesh({"data": 8}),
            sentence_iterator=jnlp.CollectionSentenceIterator(sents), **kw)
        jg.fit()
        pg = JaxInitGlove(
            sentence_iterator=pnlp.CollectionSentenceIterator(sents),
            device="cpu", **kw)
        pg.fit()
        V, D = jg.vocab.num_words(), 16
        k1, k2 = jax.random.split(jax.random.PRNGKey(5))
        init = {"w": np.array(jax.random.uniform(k1, (V, D), jnp.float32,
                                                  -0.5 / D, 0.5 / D)),
                "wc": np.array(jax.random.uniform(k2, (V, D), jnp.float32,
                                                   -0.5 / D, 0.5 / D))}
        return (sents, kw, np.asarray(jg.lookup_table.syn0),
                pg.lookup_table.vectors_matrix(), init)


@pytest.mark.parametrize("width", [2, 4])
def test_distributed_glove_matches_single_device(world, glove_ref, width):
    """Each AdaGrad batch split over the ranks, the gradients summed ==
    the single-device GloVe, and == JAX's DistributedGlove on 8 devices,
    from JAX's initial w / wc."""
    sents, kw, jax_syn0, single, init = glove_ref
    for got in world.run(tasks.glove_fit, sents, kw, init, width=width):
        np.testing.assert_allclose(got, single, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, jax_syn0, rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def pv_ref():
    with pinned():
        sents = _corpus(300, seed=7)
        labels = [f"doc{i % 40}" for i in range(len(sents))]
        kw = dict(layer_size=16, window_size=4, negative=5, epochs=2,
                  min_word_frequency=1, seed=11, batch_size=1024)
        return (sents, labels, kw) + _reference(JaxDistributedPV, RecPV, kw,
                                                sents, labels)


@pytest.mark.parametrize("width", [2, 4])
def test_distributed_paragraph_vectors_matches_single_device(world, pv_ref,
                                                             width):
    """DBOW pair batches split over the ranks == the single-device
    ParagraphVectors on the same negatives, and == JAX's
    DistributedParagraphVectors on 8 devices."""
    sents, labels, kw, jt, single, init, draws = pv_ref
    for got in world.run(tasks.word2vec_fit, sents, kw, init, draws, labels,
                         width=width):
        for k in ("syn0", "syn1neg"):
            np.testing.assert_allclose(got[k], single[k], rtol=RTOL,
                                       atol=ATOL)
            np.testing.assert_allclose(got[k], jt[k], rtol=RTOL, atol=ATOL)


def test_distributed_glove_rejects_indivisible_batch(world):
    """A user batch the ranks do not divide fails loudly, as JAX's does."""
    sents = _corpus(50, seed=1)
    kw = dict(layer_size=8, window=4, epochs=1, batch_size=1001,
              min_word_frequency=1, seed=2)
    for msg in world.run(tasks.glove_refuses, sents, kw):
        assert msg is not None and "not divisible" in msg, msg
    jg = JaxDistributedGlove(mesh=jax_make_mesh({"data": 8}),
                             sentence_iterator=jnlp.CollectionSentenceIterator(
                                 sents), **kw)
    with pytest.raises(ValueError, match="not divisible"):
        jg.fit()


def test_distributed_exporter_spi(world, tmp_path):
    """The trained model goes through the configured exporter when fit()
    completes: the in-memory exporter on every rank, the file exporter
    (rank 0's) through WordVectorSerializer, read back by both
    packages."""
    sents = [f"alpha beta gamma delta w{i % 7}" for i in range(200)]
    kw = dict(layer_size=16, window_size=2, negative=3, epochs=1,
              min_word_frequency=1, seed=1)
    path = str(tmp_path / "vecs.txt")
    for out in world.run(tasks.exporters, sents, kw, path, width=2):
        assert out["exported"] and out["same_vocab"]
        np.testing.assert_allclose(out["mem_alpha"], out["alpha"])
    back = pnlp.WordVectorSerializer.read_word_vectors(path, device="cpu")
    jback = jnlp.WordVectorSerializer.read_word_vectors(path)
    np.testing.assert_allclose(back.word_vector("alpha"),
                               out["alpha_after"], rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(back.lookup_table.vectors_matrix(),
                                  jback.lookup_table.vectors_matrix())
