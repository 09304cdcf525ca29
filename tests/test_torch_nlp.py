"""PyTorch port, word vectors (`deeplearning4j_tpu_torch/nlp/`) on the CPU,
held against the JAX package.

The twins of `tests/test_nlp.py` (22) and of `tests/test_aux_surface.py::
test_plugin_factories_work_with_word2vec_vocab`: the fits train on the
port's own draws and are held by the JAX tests' own statistics (topic
separation, nearest words), except the ParagraphVectors nearest-label
check, which JAX's test passes on its own draws only: the port's twin
trains and infers on JAX's draws (`jax_nlp_draws.JaxDraws`) and must reach
JAX's answer. (Over seeds 0-11 on each package's own draws the pets text
lands on T0 in 9 of 12 JAX fits and 7 of 12 port fits; at the test's seed
3 the port's lands on T2. The words ParagraphVectors trains beside the
labels separate by topic weakly in both packages at this size, 0.77-0.97
within against 0.36-0.95 across, so neither makes a check on own draws.)

Parity, on the same inputs made from a seed with numpy, tables carried
across with `InMemoryLookupTable.from_arrays`:
  * host side, equal: tokenizers, `VocabConstructor` indices and counts,
    `Huffman` codes / points / masks, the Japanese lattice on the bundled
    gold segmentation;
  * the SGNS step against JAX's `_sgns_expected_step` and its scatter
    oracle: float64 at rtol 1e-9 (`test_nlp.py:307`'s bound); float32
    (bf16 logits and cotangent, f32 products) within `SGNS_F32_TOL` of the
    float64 oracle's largest entry (both packages sit ~3e-3 from it; the
    bound is 2.5x the JAX package's own distance, measured at 3.0e-3 /
    3.4e-3 for gvc / gs1n);
  * a corpus-runner epoch with JAX's positions and windows against
    `make_skipgram_corpus_runner`: float64 at 1e-9 of the largest entry;
    float32 at `EPOCH_F32_TOL` of the tables' move from init;
  * BASELINE config 4's first 8 steps in float64, in both packages on the
    same draws: equal at 1e-9, and diverging alike (the JAX package's own
    defect, ROADMAP "Known reference defects");
  * the pair paths (skip-gram with NS, HS and both, CBOW, DBOW, DM) with
    JAX's negatives: one step at 1e-5, one fit at 1e-4 (of the largest
    entry); `infer_vector` from JAX's start vector and negatives at 1e-5;
  * GloVe's whole fit from JAX's initial w / wc at 1e-4;
  * the Word2Vec corpus fit (two epochs, subsampling on and off) on JAX's
    draws, float32, at `EPOCH_F32_TOL` of the move;
  * the serializers' three formats across the packages, bit-equal;
  * ModelGuesser's word-vector kinds, the telemetry twin and the device
    default (the GPU: raises here).

JAX reference fits are computed once per module inside
`torch_threads.pinned()`.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deeplearning4j_tpu.nlp as jnlp
from deeplearning4j_tpu.nlp import embeddings as jemb
import deeplearning4j_tpu_torch.graphlib as pgraph
import deeplearning4j_tpu_torch.nlp as pnlp
from deeplearning4j_tpu_torch.nlp import embeddings as pemb
from deeplearning4j_tpu_torch.nlp.embeddings import InMemoryLookupTable
from jax_nlp_draws import (JaxDraws, JaxInitGlove, as_torch, carry,
                           jax_corpus_windows, stable_hash)
from torch_threads import one_torch_thread, pinned  # noqa: F401

STEP_TOL = 1e-5       # one optimizer step, the parity gate's default
FIT_TOL = 1e-4        # a trajectory
F64_TOL = 1e-9        # float64, test_nlp.py:307
SGNS_F32_TOL = 7.5e-3  # float32 SGNS step against the f64 oracle (see above)
EPOCH_F32_TOL = 5e-2  # float32 epochs through bf16 logits: gap over the move


def topic_corpus(n_sent=300, seed=0):
    """Sentences drawn from 3 disjoint-topic vocabularies (test_nlp.py:19)."""
    topics = [
        ["cat", "dog", "pet", "fur", "paw", "tail", "kitten", "puppy"],
        ["car", "road", "wheel", "engine", "drive", "fuel", "tire", "brake"],
        ["rain", "cloud", "storm", "wind", "snow", "sun", "sky", "weather"],
    ]
    r = np.random.default_rng(seed)
    sentences = []
    for _ in range(n_sent):
        t = topics[r.integers(0, 3)]
        sentences.append(" ".join(r.choice(t, size=8)))
    return sentences, topics


def zipf_corpus(n=400, seed=0, vocab=300, length=12):
    r = np.random.default_rng(seed)
    words = r.zipf(1.3, size=(n, length)) % vocab
    return [" ".join(f"w{w}" for w in row) for row in words]


def _topic_separation(model, topics):
    intra, inter = [], []
    for ti, t in enumerate(topics):
        for i, a in enumerate(t):
            for b in t[i + 1:]:
                intra.append(model.similarity(a, b))
            for tj in range(ti + 1, 3):
                for b in topics[tj]:
                    inter.append(model.similarity(a, b))
    return float(np.mean(intra)), float(np.mean(inter))


def rel(got, want):
    """Largest |got - want| over the largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def move_gap(got, want, init):
    got, want, init = (np.asarray(a, np.float64) for a in (got, want, init))
    return float(np.linalg.norm(got - want) / np.linalg.norm(want - init))


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


class PW2V(JaxDraws, pnlp.Word2Vec):
    pass


class PPV(JaxDraws, pnlp.ParagraphVectors):
    pass


W2V_KW = dict(layer_size=32, window_size=4, min_word_frequency=3, epochs=3,
              seed=1, negative=5, batch_size=256)


def _train_w2v(**kw):
    sentences, topics = topic_corpus()
    it = pnlp.CollectionSentenceIterator(sentences)
    defaults = dict(W2V_KW)
    defaults.update(kw)
    w2v = pnlp.Word2Vec(sentence_iterator=it, device="cpu", **defaults)
    w2v.fit()
    return w2v, topics


@pytest.fixture(scope="module")
def w2v_one_epoch():
    with pinned():
        return _train_w2v(epochs=1)[0]


# --------------------------- tokenization ----------------------------------

def test_default_tokenizer_and_preprocessor():
    tf = pnlp.DefaultTokenizerFactory()
    tf.set_token_pre_processor(pnlp.CommonPreprocessor())
    toks = tf.create("Hello, World! 123 foo").get_tokens()
    assert toks == ["hello", "world", "foo"]


def test_ngram_tokenizer():
    tf = pnlp.NGramTokenizerFactory(1, 2)
    toks = tf.create("a b c").get_tokens()
    assert "a" in toks and "a b" in toks and "b c" in toks


TOKENIZERS = {
    "default": lambda lib: lib.DefaultTokenizerFactory(),
    "common": lambda lib: _with_pre(lib, lib.CommonPreprocessor()),
    "lowcase": lambda lib: _with_pre(lib, lib.LowCasePreProcessor()),
    "ending": lambda lib: _with_pre(lib, lib.EndingPreProcessor()),
    "ngram": lambda lib: lib.NGramTokenizerFactory(1, 3),
}


def _with_pre(lib, pre):
    tf = lib.DefaultTokenizerFactory()
    tf.set_token_pre_processor(pre)
    return tf


@pytest.mark.parametrize("name", sorted(TOKENIZERS))
def test_tokenizers_match_jax(name):
    texts = (topic_corpus(40)[0]
             + ["Hello, World! 123 foo", "Running dogs ran quickly.",
                "The cats' tails -- wagging; 4 x 4", "  spaced   out\tTABS "])
    for text in texts:
        got = TOKENIZERS[name](pnlp).create(text).get_tokens()
        want = TOKENIZERS[name](jnlp).create(text).get_tokens()
        assert got == want, text
    assert pnlp.STOP_WORDS == jnlp.STOP_WORDS


# --------------------------- vocab + huffman --------------------------------

def test_vocab_constructor_min_frequency():
    seqs = [["a", "a", "a", "b", "b", "c"]]
    vocab = pnlp.VocabConstructor(min_word_frequency=2).build_vocab(seqs)
    assert vocab.contains_word("a") and vocab.contains_word("b")
    assert not vocab.contains_word("c")
    assert vocab.index_of("a") == 0  # most frequent first


def test_huffman_codes():
    seqs = [["a"] * 8 + ["b"] * 4 + ["c"] * 2 + ["d"]]
    vocab = pnlp.VocabConstructor().build_vocab(seqs)
    pnlp.Huffman(vocab).build()
    wa = vocab.word_for("a")
    wd = vocab.word_for("d")
    assert len(wa.code) <= len(wd.code)
    codes = ["".join(map(str, vocab.word_for(w).code)) for w in "abcd"]
    for i, c1 in enumerate(codes):
        for j, c2 in enumerate(codes):
            if i != j:
                assert not c2.startswith(c1)


def _corpus_tokens(name):
    if name == "topics":
        sents, _ = topic_corpus()
        labels = [[f"T{i % 3}"] for i in range(len(sents))]
    else:
        sents = zipf_corpus()
        labels = [[f"doc{i % 7}", "all"] for i in range(len(sents))]
    return [s.split() for s in sents], labels


@pytest.mark.parametrize("corpus", ["topics", "zipf"])
@pytest.mark.parametrize("min_freq", [1, 3])
def test_vocab_and_huffman_match_jax(corpus, min_freq):
    """Word indices, counts, label flags and the Huffman codes / points /
    masks are JAX's: every parity test indexes tables by them."""
    seqs, labels = _corpus_tokens(corpus)
    pv = pnlp.VocabConstructor(min_freq).build_vocab(seqs, labels)
    jv = jnlp.VocabConstructor(min_freq).build_vocab(seqs, labels)
    assert pv.words() == jv.words()
    np.testing.assert_array_equal(pv.counts_array(), jv.counts_array())
    assert [w.is_label for w in pv.vocab_words()] == \
        [w.is_label for w in jv.vocab_words()]
    assert pv.total_word_count == jv.total_word_count
    ph, jh = pnlp.Huffman(pv), jnlp.Huffman(jv)
    ph.build()
    jh.build()
    for a, b in zip(pv.vocab_words(), jv.vocab_words()):
        assert (a.code, a.points) == (b.code, b.points)
    for a, b in zip(ph.codes_arrays(), jh.codes_arrays()):
        np.testing.assert_array_equal(a, b)


def test_labels_source():
    ls = pnlp.LabelsSource("DOC_%d")
    assert ls.next_label() == "DOC_0"
    assert ls.next_label() == "DOC_1"
    assert ls.index_of("DOC_1") == 1


def test_plugin_factories_work_with_word2vec_vocab():
    """Plugin tokenizers satisfy the same SPI the NLP stack consumes
    (twin of test_aux_surface.py's)."""
    from deeplearning4j_tpu_torch.nlp.tokenization_plugins import (
        JapaneseTokenizerFactory)
    tf = JapaneseTokenizerFactory()
    toks = [tf.create("猫は可愛い。犬も可愛い。").get_tokens()]
    vocab = pnlp.VocabConstructor(1).build_vocab(iter(toks), iter([[]]))
    assert vocab.contains_word("猫")


def test_japanese_lattice_matches_jax_on_gold_segmentation():
    """The lattice (costs, lexicon: the port's copies of the bundled
    resources) segments every gold sentence as JAX's does; the Korean and
    the script-run tokenizers too."""
    from deeplearning4j_tpu.nlp import tokenization_plugins as jtp
    from deeplearning4j_tpu_torch.nlp import lattice_ja as plat
    from deeplearning4j_tpu_torch.nlp import tokenization_plugins as ptp
    assert plat._FREQ_ENTRIES >= 2500 and plat._LEARNED
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "deeplearning4j_tpu_torch", "resources",
        "ja_gold_segmentation.tsv")
    with open(path, encoding="utf-8") as f:
        texts = [line.split("\t")[0] for line in f]
    assert len(texts) >= 140
    for cls in ("JapaneseTokenizerFactory", "KoreanTokenizerFactory"):
        p, j = getattr(ptp, cls)(), getattr(jtp, cls)()
        for text in texts[:60] if cls == "KoreanTokenizerFactory" else texts:
            assert p.create(text).get_tokens() == \
                j.create(text).get_tokens(), text
    p = ptp.JapaneseTokenizerFactory(use_lattice=False)
    j = jtp.JapaneseTokenizerFactory(use_lattice=False)
    for text in texts[:30]:
        assert p.create(text).get_tokens() == j.create(text).get_tokens()


# --------------------------- word2vec (own draws) ---------------------------

def test_word2vec_skipgram_negative_sampling_learns_topics():
    w2v, topics = _train_w2v()
    intra, inter = _topic_separation(w2v, topics)
    assert intra > inter + 0.2, (intra, inter)
    near = w2v.words_nearest("cat", 5)
    same_topic = sum(1 for w in near if w in topics[0])
    assert same_topic >= 3, near


def test_word2vec_hierarchical_softmax():
    w2v, topics = _train_w2v(negative=0, use_hierarchic_softmax=True)
    intra, inter = _topic_separation(w2v, topics)
    assert intra > inter + 0.15, (intra, inter)


def test_word2vec_cbow():
    w2v, topics = _train_w2v(elements_learning_algorithm="cbow", epochs=5)
    intra, inter = _topic_separation(w2v, topics)
    assert intra > inter + 0.15, (intra, inter)


def test_word2vec_query_api(w2v_one_epoch):
    w2v = w2v_one_epoch
    assert w2v.has_word("cat")
    assert not w2v.has_word("zebra")
    v = w2v.word_vector("cat")
    assert v.shape == (32,)
    assert np.isfinite(w2v.similarity("cat", "dog"))
    assert np.isnan(w2v.similarity("cat", "zebra"))
    res = w2v.words_nearest_sum(["cat", "dog"], ["car"], top_n=3)
    assert len(res) == 3


def test_word2vec_tiny_vocab_stays_finite():
    """Batched-sum SGD on a tiny vocab must not diverge: centers-per-step
    is capped by the vocab size on the corpus path."""
    sents = []
    for i in range(1500):
        a = ["cat", "dog", "pet", "fur"][i % 4]
        b = ["car", "road", "wheel", "drive"][i % 4]
        sents.append(f"{a} {a} pet animal fur tail")
        sents.append(f"{b} {b} vehicle road wheel engine")
    w2v = pnlp.Word2Vec(sentence_iterator=pnlp.CollectionSentenceIterator(
        sents), layer_size=48, window_size=3, negative=5, epochs=2,
        min_word_frequency=1, seed=11, device="cpu")
    w2v.fit()
    m = w2v.lookup_table.vectors_matrix()
    assert np.all(np.isfinite(m)), "embeddings diverged"
    assert w2v.similarity("cat", "dog") > w2v.similarity("cat", "wheel") + 0.1


# --------------------------- serializer -------------------------------------

def test_word_vector_serializer_text_roundtrip(tmp_path, w2v_one_epoch):
    w2v = w2v_one_epoch
    p = str(tmp_path / "vecs.txt")
    pnlp.WordVectorSerializer.write_word_vectors(w2v, p, header=True)
    back = pnlp.WordVectorSerializer.read_word_vectors(p, device="cpu")
    assert back.vocab.num_words() == w2v.vocab.num_words()
    np.testing.assert_allclose(back.word_vector("cat"),
                               w2v.word_vector("cat"), atol=1e-5)


def test_word_vector_serializer_binary_roundtrip(tmp_path, w2v_one_epoch):
    w2v = w2v_one_epoch
    p = str(tmp_path / "vecs.bin")
    pnlp.WordVectorSerializer.write_binary(w2v, p)
    back = pnlp.WordVectorSerializer.read_binary(p, device="cpu")
    np.testing.assert_allclose(back.word_vector("dog"),
                               w2v.word_vector("dog"), atol=1e-6)


def test_word2vec_model_zip_roundtrip(tmp_path, w2v_one_epoch):
    w2v = w2v_one_epoch
    p = str(tmp_path / "model.zip")
    pnlp.WordVectorSerializer.write_word2vec_model(w2v, p)
    back = pnlp.WordVectorSerializer.read_word2vec_model(p, device="cpu")
    np.testing.assert_allclose(back.word_vector("cat"),
                               w2v.word_vector("cat"), atol=1e-5)
    assert back.vocab.word_frequency("cat") == w2v.vocab.word_frequency("cat")


FORMATS = {
    "text": ("write_word_vectors", "read_word_vectors"),
    "text_gz": ("write_word_vectors", "read_word_vectors"),
    "binary": ("write_binary", "read_binary"),
    "zip": ("write_word2vec_model", "read_word2vec_model"),
}


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_serializer_files_cross_the_packages_bit_equal(tmp_path, fmt,
                                                       writer):
    """A file written by either package reads in the other with the same
    words, counts, labels and vectors, bit for bit; both packages write
    the same bytes from the same table."""
    w, r = FORMATS[fmt]
    sents = zipf_corpus(120, seed=4)
    labels = [f"L{i % 3}" for i in range(len(sents))]
    jm = jnlp.ParagraphVectors(iterator=jnlp.CollectionLabeledSentenceIterator(
        sents, labels), layer_size=7, seed=2)
    jm.build_vocab()
    pm = pnlp.ParagraphVectors(
        iterator=pnlp.CollectionLabeledSentenceIterator(sents, labels),
        layer_size=7, seed=2, device="cpu")
    pm.build_vocab()
    carry(jm, pm)
    name = "vecs" + (".txt.gz" if fmt == "text_gz" else "")
    paths = {k: str(tmp_path / f"{k}_{name}") for k in ("jax", "port")}
    getattr(jnlp.WordVectorSerializer, w)(jm, paths["jax"])
    getattr(pnlp.WordVectorSerializer, w)(pm, paths["port"])
    if fmt in ("text", "binary"):
        with open(paths["jax"], "rb") as a, open(paths["port"], "rb") as b:
            assert a.read() == b.read()
    path = paths[writer]
    got = getattr(pnlp.WordVectorSerializer, r)(path, device="cpu")
    want = getattr(jnlp.WordVectorSerializer, r)(path)
    assert got.vocab.words() == want.vocab.words()
    np.testing.assert_array_equal(got.lookup_table.vectors_matrix(),
                                  want.lookup_table.vectors_matrix())
    np.testing.assert_array_equal(got.vocab.counts_array(),
                                  want.vocab.counts_array())
    assert [v.is_label for v in got.vocab.vocab_words()] == \
        [v.is_label for v in want.vocab.vocab_words()]
    if fmt == "binary":
        np.testing.assert_array_equal(got.lookup_table.vectors_matrix(),
                                      np.asarray(jm.lookup_table.syn0))


def test_model_guesser_zip_header_and_gz_variants(tmp_path):
    """Guesser edge cases (twin of test_mlp.py:252): word2vec zips,
    text-with-header (not binary), gzipped text without a .gz extension;
    each loads as the serializer reads it."""
    from deeplearning4j_tpu_torch.nlp.embeddings import WordVectorsModel
    from deeplearning4j_tpu_torch.util import ModelGuesser
    S = pnlp.WordVectorSerializer

    vc = pnlp.VocabCache()
    for w in ("alpha", "beta"):
        vc.add_token(pnlp.VocabWord(w, 1))
    vc.update_indices()
    model = WordVectorsModel(vc, InMemoryLookupTable(vc, 4, negative=0,
                                                     device="cpu"))

    zp = str(tmp_path / "w2v.zip")
    S.write_word2vec_model(model, zp)
    assert ModelGuesser.guess_format(zp) == "word_vectors_zip"
    assert ModelGuesser.load(zp, device="cpu").has_word("alpha")

    hp = str(tmp_path / "hdr.txt")
    S.write_word_vectors(model, hp, header=True)
    assert ModelGuesser.guess_format(hp) == "word_vectors_text"
    loaded = ModelGuesser.load(hp, device="cpu")
    np.testing.assert_allclose(loaded.word_vector("alpha"),
                               model.word_vector("alpha"), atol=1e-5)
    np.testing.assert_array_equal(
        loaded.lookup_table.vectors_matrix(),
        S.read_word_vectors(hp, device="cpu").lookup_table.vectors_matrix())

    gz = str(tmp_path / "vecs.txt.gz")
    S.write_word_vectors(model, gz)
    import shutil
    renamed = str(tmp_path / "renamed.dat")   # gz content, no extension
    shutil.copy(gz, renamed)
    assert ModelGuesser.guess_format(renamed) == "word_vectors_text"
    assert ModelGuesser.load(renamed, device="cpu").has_word("beta")


# --------------------------- paragraph vectors -------------------------------

def _pv_corpus():
    sentences, topics = topic_corpus(n_sent=120)
    word2topic = {w: i for i, t in enumerate(topics) for w in t}
    labels = [f"T{word2topic[s.split()[0]]}" for s in sentences]
    return sentences, topics, labels


PV_KW = dict(layer_size=24, window_size=4, min_word_frequency=2, epochs=5,
             seed=3, negative=5, train_elements=True)


@pytest.fixture
def stable_jax_hash(monkeypatch):
    """JAX's infer_vector seeds from `hash(text)`, which PYTHONHASHSEED
    changes from process to process: its module sees `stable_hash`
    instead, so its draws (and `JaxDraws`'s) are the same in every run."""
    from deeplearning4j_tpu.nlp import word2vec as jw2v
    monkeypatch.setattr(jw2v, "hash", stable_hash, raising=False)


@pytest.fixture(scope="module")
def pv_pair():
    """test_nlp.py's ParagraphVectors, JAX's fit and the port's on JAX's
    tables and draws."""
    with pinned():
        sentences, topics, labels = _pv_corpus()
        jm = jnlp.ParagraphVectors(
            iterator=jnlp.CollectionLabeledSentenceIterator(sentences,
                                                            labels), **PV_KW)
        pm = PPV(iterator=pnlp.CollectionLabeledSentenceIterator(sentences,
                                                                  labels),
                 device="cpu", **PV_KW)
        jm.build_vocab()
        pm.build_vocab()
        carry(jm, pm)
        jm.fit()
        pm.fit()
        return jm, pm, topics


def test_paragraph_vectors_dbow_groups_topics(pv_pair, stable_jax_hash):
    """test_nlp.py's check on JAX's draws (training negatives and
    infer_vector's start vector and negatives): the inferred pets text is
    nearest the pets label, as in JAX (see the module docstring)."""
    jm, pv, _ = pv_pair
    assert set(pv.labels()) == {"T0", "T1", "T2"}
    inferred = pv.infer_vector("cat dog kitten paw fur pet")
    near = pv.nearest_labels(inferred, top_n=1)
    assert near[0] == "T0", near
    assert near == jm.nearest_labels(jm.infer_vector(
        "cat dog kitten paw fur pet"), top_n=1)


def test_infer_vector_deterministic():
    sentences, _ = topic_corpus(n_sent=60)
    pv = pnlp.ParagraphVectors(
        sentence_iterator=pnlp.CollectionSentenceIterator(sentences),
        layer_size=16, epochs=1, seed=5, min_word_frequency=2, device="cpu")
    pv.fit()
    v1 = pv.infer_vector("cat dog pet")
    v2 = pv.infer_vector("cat dog pet")
    np.testing.assert_allclose(v1, v2, atol=1e-6)


def test_paragraph_vectors_fit_matches_jax(pv_pair):
    """test_nlp.py's ParagraphVectors fit (DBOW + skip-gram words, five
    epochs) on JAX's tables and negatives: 1e-4. (infer_vector from the
    two fits' tables is not compared: its 20 steps amplify the tables'
    1e-5 gap up to 2e-2 at some seeds; it is held from equal tables
    below.)"""
    jm, pm, _ = pv_pair
    for k in ("syn0", "syn1neg"):
        assert rel(_np(getattr(pm.lookup_table, k)),
                   getattr(jm.lookup_table, k)) <= FIT_TOL, k


# --------------------------- glove -------------------------------------------

def test_glove_learns_topics():
    sentences, topics = topic_corpus(n_sent=300)
    g = pnlp.Glove(sentence_iterator=pnlp.CollectionSentenceIterator(
        sentences), layer_size=24, window=6, min_word_frequency=3, epochs=30,
        seed=2, device="cpu")
    g.fit()
    intra, inter = _topic_separation(g, topics)
    assert intra > inter + 0.15, (intra, inter)


@pytest.mark.parametrize("batch_size", [1024, 100])
def test_glove_fit_matches_jax(batch_size):
    """GloVe's whole fit (co-occurrences, numpy shuffle, AdaGrad, a ragged
    last batch at 100) from JAX's initial w / wc."""
    sentences, _ = topic_corpus(n_sent=150, seed=5)
    kw = dict(layer_size=16, window=5, min_word_frequency=2, epochs=8,
              seed=4, batch_size=batch_size)
    jg = jnlp.Glove(sentence_iterator=jnlp.CollectionSentenceIterator(
        sentences), **kw)
    pg = JaxInitGlove(sentence_iterator=pnlp.CollectionSentenceIterator(
        sentences), device="cpu", **kw)
    jg.fit()
    pg.fit()
    assert pg.vocab.words() == jg.vocab.words()
    assert rel(pg.lookup_table.vectors_matrix(),
               jg.lookup_table.syn0) <= FIT_TOL


# --------------------------- bow / tfidf / iterators -------------------------

def test_bag_of_words():
    docs = ["the cat sat", "the dog sat", "cat and dog"]
    bow = pnlp.BagOfWordsVectorizer(pnlp.CollectionSentenceIterator(docs))
    m = bow.fit_transform()
    assert m.shape == (3, bow.vocab.num_words())
    i_cat = bow.vocab.index_of("cat")
    assert m[0, i_cat] == 1 and m[1, i_cat] == 0 and m[2, i_cat] == 1
    jb = jnlp.BagOfWordsVectorizer(jnlp.CollectionSentenceIterator(docs))
    np.testing.assert_array_equal(m, jb.fit_transform())


def test_tfidf():
    docs = ["cat cat dog", "dog fish", "fish bird"]
    tv = pnlp.TfidfVectorizer(pnlp.CollectionSentenceIterator(docs))
    tv.fit()
    v = tv.transform("cat cat dog")
    i_cat = tv.vocab.index_of("cat")
    i_dog = tv.vocab.index_of("dog")
    assert v[i_cat] > v[i_dog] > 0
    assert tv.idf("cat") > tv.idf("dog")
    jt = jnlp.TfidfVectorizer(jnlp.CollectionSentenceIterator(docs))
    jt.fit()
    np.testing.assert_array_equal(v, jt.transform("cat cat dog"))


def test_line_sentence_iterator(tmp_path):
    p = tmp_path / "corpus.txt"
    p.write_text("first line\n\nsecond line\nthird\n")
    it = pnlp.LineSentenceIterator(str(p))
    assert list(it) == ["first line", "second line", "third"]
    it.reset()
    assert it.next_sentence() == "first line"


def test_basic_label_aware_iterator():
    it = pnlp.BasicLabelAwareIterator(
        pnlp.CollectionSentenceIterator(["a b", "c d"]))
    docs = list(it)
    assert [d.labels[0] for d in docs] == ["DOC_0", "DOC_1"]
    assert it.get_labels_source().size() == 2


def test_inverted_index_search_and_phrase():
    from deeplearning4j_tpu_torch.nlp.invertedindex import InvertedIndex

    idx = InvertedIndex()
    d0 = idx.add_document("the cat sat on the mat", label="a")
    d1 = idx.add_document("the dog chased the cat", label="b")
    d2 = idx.add_document("stocks fell on monday trading", label="c")
    assert idx.num_documents() == 3
    assert idx.document_frequency("the") == 2
    assert idx.term_frequency("the", d0) == 2
    assert idx.documents_containing("cat") == [d0, d1]
    assert idx.label(d1) == "b"
    hits = idx.search("cat mat")
    assert hits[0][0] == d0
    assert {h[0] for h in hits} == {d0, d1}
    hits2 = idx.search("monday stocks")
    assert hits2[0][0] == d2
    assert idx.phrase_search("the cat") == [d0, d1]
    assert idx.phrase_search("cat sat") == [d0]
    assert idx.phrase_search("sat cat") == []
    assert idx.phrase_search("dog chased the cat") == [d1]
    batches = list(idx.batch_iter(2))
    assert [len(b) for b in batches] == [2, 1]


# --------------------------- the SGNS step -----------------------------------

def _step_inputs(dups, seed=0, B=37, V=211, D=16, W2=6):
    r = np.random.default_rng(seed)
    vc = r.normal(size=(B, D))
    s1n = r.normal(size=(V, D))
    ctx = r.integers(0, V, (B, W2)).astype(np.int32)
    if dups:
        ctx[:, 1] = ctx[:, 0]          # a word twice in a window
        ctx[::3, 4] = ctx[::3, 0]
    vm = (r.random((B, W2)) > 0.3).astype(np.float64)
    nvalid = vm.sum(axis=1)
    pn = r.random(V)
    return vc, s1n, ctx, vm, nvalid, pn / pn.sum()


def _pt_step(fn, args, K, dtype):
    vc, s1n, ctx, vm, nvalid, pn = args
    t = lambda a: torch.as_tensor(np.asarray(a, dtype))
    return fn(t(vc), t(s1n), torch.as_tensor(ctx, dtype=torch.int64),
              t(vm), t(nvalid), t(pn), K)


def test_sgns_dense_step_matches_scatter_oracle():
    """The port's expected-NS step == its scatter formulation, in f64."""
    args = _step_inputs(False)
    l1, g1, h1 = _pt_step(pemb._sgns_expected_step, args, 5.0, np.float64)
    l2, g2, h2 = _pt_step(pemb._sgns_expected_step_scatter, args, 5.0,
                          np.float64)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-10)
    np.testing.assert_allclose(_np(g1), _np(g2), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(_np(h1), _np(h2), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("dups", [False, True])
@pytest.mark.parametrize("oracle", [False, True])
def test_sgns_step_matches_jax_f64(dups, oracle):
    """The port's step against JAX's `_sgns_expected_step` and against
    JAX's scatter oracle, float64, duplicate contexts in a window or
    not."""
    args = _step_inputs(dups, seed=1)
    jfn = (jemb._sgns_expected_step_scatter if oracle
           else jemb._sgns_expected_step)
    jl, jg, jh = jfn(*map(jnp.asarray, args), 5.0)
    pl, pg, ph = _pt_step(pemb._sgns_expected_step, args, 5.0, np.float64)
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-10)
    np.testing.assert_allclose(_np(pg), np.asarray(jg), rtol=F64_TOL,
                               atol=1e-12)
    np.testing.assert_allclose(_np(ph), np.asarray(jh), rtol=F64_TOL,
                               atol=1e-12)


@pytest.mark.parametrize("dups", [False, True])
def test_sgns_step_f32_through_bf16_logits(dups):
    """float32 tables: bf16 logits and cotangent, f32 products. Both
    packages against the float64 oracle, as a share of its largest
    entry: the port within SGNS_F32_TOL, and within 2.5x of JAX's own
    distance plus 1e-4."""
    args = _step_inputs(dups, seed=2, B=64, V=400, D=32, W2=8)
    f32 = [np.asarray(a, np.float32) if a.dtype.kind == "f" else a
           for a in args]
    ol, og, oh = jemb._sgns_expected_step_scatter(*map(jnp.asarray, args),
                                                  5.0)
    jl, jg, jh = jemb._sgns_expected_step(*map(jnp.asarray, f32), 5)
    pl, pg, ph = _pt_step(pemb._sgns_expected_step, f32, 5, np.float32)
    assert pg.dtype == ph.dtype == torch.float32
    for p, j, o in ((pl, jl, ol), (pg, jg, og), (ph, jh, oh)):
        d_port, d_jax = rel(_np(p), o), rel(j, o)
        assert d_port <= SGNS_F32_TOL, (d_port, d_jax)
        assert d_port <= 2.5 * d_jax + 1e-4, (d_port, d_jax)


def test_bf16_products_keep_float32_results():
    """`_mm_acc` (the gradient products) returns the f32 sum of the exact
    bf16 products: no rounding to bf16 on the way out."""
    r = np.random.default_rng(3)
    a = torch.as_tensor(r.normal(size=(9, 33)), dtype=torch.bfloat16)
    b = torch.as_tensor(r.normal(size=(33, 5)), dtype=torch.bfloat16)
    got = pemb._mm_acc(a, b)
    assert got.dtype == torch.float32
    want = a.double() @ b.double()
    assert float((got.double() - want).abs().max()) < 1e-5
    rounded = got.to(torch.bfloat16).float()
    assert not torch.equal(rounded, got)


# --------------------------- the corpus epoch -------------------------------

def _corpus_setup(seed=0, n_sent=60, V=50, L=9, D=16, B=40):
    r = np.random.default_rng(seed)
    lens = r.integers(2, L, n_sent)
    corpus = np.concatenate([r.integers(0, V, n) for n in lens]).astype(
        np.int32)
    sid = np.repeat(np.arange(n_sent), lens).astype(np.int32)
    counts = np.bincount(corpus, minlength=V).astype(np.float64) + 1
    vocab = jnlp.VocabCache()
    for i, c in enumerate(counts):
        vocab.add_token(jnlp.VocabWord(f"w{i}", float(c)))
    vocab.update_indices()
    # indices follow descending counts: renumber the corpus to match
    order = {f"w{i}": vocab.index_of(f"w{i}") for i in range(V)}
    corpus = np.array([order[f"w{c}"] for c in corpus], np.int32)
    jt = jnlp.InMemoryLookupTable(vocab, D, seed=seed + 1, negative=5)
    n = len(corpus)
    T = 7
    pos = np.stack([r.permutation(n)[:B] for _ in range(T)]).astype(np.int32)
    lrs = np.linspace(0.025, 0.01, T).astype(np.float32)
    s1n0 = r.normal(scale=0.1, size=(V, D))
    return vocab, jt, corpus, sid, pos, lrs, s1n0


@pytest.mark.parametrize("window", [2, 3])
def test_corpus_epoch_matches_jax_f64(window):
    """One corpus-runner epoch on JAX's positions and window draws,
    float64 tables: the port equals `make_skipgram_corpus_runner` at 1e-9
    of the largest entry (corpus ends, sentence boundaries, duplicate
    centers in a step)."""
    vocab, jt, corpus, sid, pos, lrs, s1n0 = _corpus_setup()
    pos[0, :5] = pos[0, 0]              # a center five times in a step
    pos[1, 0], pos[1, 1] = 0, len(corpus) - 1   # both corpus ends
    s0 = np.asarray(jt.syn0, np.float64)
    key = jax.random.PRNGKey(5)
    run = jemb.make_skipgram_corpus_runner(jt, window)
    j0, j1, jl = run(jnp.asarray(s0), jnp.asarray(s1n0), jnp.asarray(corpus),
                     jnp.asarray(sid), jnp.asarray(pos), jnp.asarray(lrs),
                     key)
    T, B = pos.shape
    wins = jax_corpus_windows(key, T, B, window)
    pt = InMemoryLookupTable.from_arrays(
        vocab, np.asarray(jt.syn0), negative=5, device="cpu")
    prun = pemb.make_skipgram_corpus_runner(pt, window)
    p0 = torch.as_tensor(s0).clone()
    p1 = torch.as_tensor(s1n0).clone()
    _, _, pl = prun(p0, p1, torch.as_tensor(corpus, dtype=torch.int64),
                    torch.as_tensor(sid, dtype=torch.int64),
                    torch.as_tensor(pos, dtype=torch.int64),
                    torch.as_tensor(wins), torch.as_tensor(lrs))
    assert rel(_np(p0), j0) <= F64_TOL
    assert rel(_np(p1), j1) <= F64_TOL
    # JAX's mean over its T steps (no padding here)
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-9)
    assert prun.epochs.captures == 0 and prun.epochs.replays == 0


def test_corpus_epoch_f32_gap_over_move():
    """The same epoch in float32 (bf16 logits): the port's tables against
    JAX's, as a gap over JAX's move from init; a run that loses its last
    step reads past the limit."""
    vocab, jt, corpus, sid, pos, lrs, s1n0 = _corpus_setup(seed=2)
    s1n0 = s1n0.astype(np.float32)
    key = jax.random.PRNGKey(6)
    run = jemb.make_skipgram_corpus_runner(jt, 3)
    j0, j1, _ = run(jt.syn0, jnp.asarray(s1n0), jnp.asarray(corpus),
                    jnp.asarray(sid), jnp.asarray(pos), jnp.asarray(lrs), key)
    T, B = pos.shape
    wins = torch.as_tensor(jax_corpus_windows(key, T, B, 3))
    init0 = np.asarray(jt.syn0)

    def port(steps):
        pt = InMemoryLookupTable.from_arrays(vocab, init0, None, s1n0,
                                             negative=5, device="cpu")
        prun = pemb.make_skipgram_corpus_runner(pt, 3)
        prun(pt.syn0, pt.syn1neg, torch.as_tensor(corpus, dtype=torch.int64),
             torch.as_tensor(sid, dtype=torch.int64),
             torch.as_tensor(pos[:steps], dtype=torch.int64), wins[:steps],
             torch.as_tensor(lrs[:steps]))
        return _np(pt.syn0), _np(pt.syn1neg)

    p0, p1 = port(T)
    assert move_gap(p0, j0, init0) <= EPOCH_F32_TOL
    assert move_gap(p1, j1, s1n0) <= EPOCH_F32_TOL
    s0, s1 = port(T - 1)
    assert move_gap(s0, j0, init0) > EPOCH_F32_TOL
    assert move_gap(s1, j1, s1n0) > EPOCH_F32_TOL


def test_config4_first_steps_diverge_alike_f64():
    """BASELINE config 4 (`bench.py:29`: 100,000 x 20 words, zipf 1.2 mod
    10,000, D 128, W 5, 1,638 centers a step) diverges in the JAX package
    itself, and the port follows it step for step. Its first 8 SGNS steps
    in float64, in both packages from JAX's init on the same positions and
    window draws: the losses and tables agree at 1e-9, and the loss goes
    from about 3.7e4 at the first step past 4e5 at the 7th and 1e7 at the
    8th (batched-sum SGD over a corpus whose top word is 18 % of its
    tokens; ROADMAP "Known reference defects")."""
    r = np.random.default_rng(0)
    words = r.zipf(1.2, size=(100_000, 20)) % 10_000
    sents = [" ".join(f"w{w}" for w in row) for row in words]
    jw = jnlp.Word2Vec(
        sentence_iterator=jnlp.CollectionSentenceIterator(sents),
        layer_size=128, window_size=5, negative=5, min_word_frequency=1,
        epochs=1, batch_size=8192, seed=7)
    flat, sid = jw._flatten_corpus(jw.build_vocab(), subsample=False)
    V, n = jw.vocab.num_words(), len(flat)
    B = min(max(32, 8192 // 5), max(32, V))
    assert (V, n, B) == (10_000, 2_000_000, 1638)
    S = 8
    pos = np.stack([r.permutation(n)[:B] for _ in range(S)]).astype(np.int32)
    lrs = 0.025 * (1 - np.arange(S) * B / n)
    s0 = np.asarray(jw.lookup_table.syn0, np.float64)
    j0, j1 = jnp.asarray(s0), jnp.zeros_like(jnp.asarray(s0))
    jrun = jemb.make_skipgram_corpus_runner(jw.lookup_table, 5)
    pt = InMemoryLookupTable.from_arrays(jw.vocab, s0, negative=5,
                                         device="cpu")
    prun = pemb.make_skipgram_corpus_runner(pt, 5)
    p0, p1 = torch.as_tensor(s0).clone(), torch.zeros_like(torch.as_tensor(s0))
    jc, js = jnp.asarray(flat), jnp.asarray(sid)
    pc = torch.as_tensor(flat, dtype=torch.int64)
    ps = torch.as_tensor(sid, dtype=torch.int64)
    jl, pl = [], []
    for t in range(S):
        key = jax.random.PRNGKey(100 + t)
        j0, j1, loss = jrun(j0, j1, jc, js, jnp.asarray(pos[t:t + 1]),
                            jnp.asarray(lrs[t:t + 1]), key)
        jl.append(float(loss))
        _, _, loss = prun(p0, p1, pc, ps,
                          torch.as_tensor(pos[t:t + 1], dtype=torch.int64),
                          torch.as_tensor(jax_corpus_windows(key, 1, B, 5)),
                          torch.as_tensor(lrs[t:t + 1]))
        pl.append(float(loss))
    np.testing.assert_allclose(pl, jl, rtol=F64_TOL)
    assert rel(_np(p0), j0) <= F64_TOL
    assert rel(_np(p1), j1) <= F64_TOL
    assert jl[0] < 5e4 and jl[6] > 4e5 and jl[7] > 1e7, jl


@pytest.mark.parametrize("sampling,fits", [(0.0, 2), (1e-2, 1)])
def test_word2vec_corpus_fit_matches_jax(sampling, fits):
    """Word2Vec's corpus path end to end (vocab, flatten cache,
    subsampling, lr decay, two epochs; without subsampling a second fit,
    with its fold-in and the cached corpus) on JAX's tables and draws,
    float32."""
    sents = zipf_corpus(150, seed=3, vocab=60, length=10)
    kw = dict(layer_size=16, window_size=3, negative=5, epochs=2,
              min_word_frequency=1, seed=9, batch_size=256,
              sampling=sampling)
    jm = jnlp.Word2Vec(sentence_iterator=jnlp.CollectionSentenceIterator(
        sents), **kw)
    pm = PW2V(sentence_iterator=pnlp.CollectionSentenceIterator(sents),
              device="cpu", **kw)
    jm.build_vocab()
    pm.build_vocab()
    carry(jm, pm)
    init0 = np.asarray(jm.lookup_table.syn0)
    for _ in range(fits):
        jm.fit()
        pm.fit()
        assert move_gap(pm.lookup_table.vectors_matrix(),
                        jm.lookup_table.syn0, init0) <= EPOCH_F32_TOL
        assert move_gap(_np(pm.lookup_table.syn1neg),
                        jm.lookup_table.syn1neg,
                        np.zeros_like(init0)) <= EPOCH_F32_TOL


# --------------------------- the pair paths ---------------------------------

PAIR_CASES = {
    "sg_ns": dict(negative=5),
    "sg_hs": dict(negative=0, use_hierarchic_softmax=True),
    "sg_hs_ns": dict(negative=3, use_hierarchic_softmax=True),
    "cbow_ns": dict(negative=5, elements_learning_algorithm="cbow"),
    "cbow_hs": dict(negative=0, use_hierarchic_softmax=True,
                    elements_learning_algorithm="cbow"),
}


def _pair_tables(case, seed=0, B=24):
    sents, _ = topic_corpus(60, seed=seed)
    kw = dict(layer_size=12, window_size=3, min_word_frequency=1, seed=seed,
              **PAIR_CASES[case])
    jm = jnlp.Word2Vec(sentence_iterator=jnlp.CollectionSentenceIterator(
        sents), **kw)
    jm.build_vocab()
    jt = jm.lookup_table
    V, D = jm.vocab.num_words(), 12
    r = np.random.default_rng(seed + 10)
    # start the output tables away from zero so every gradient is live
    if jt.syn1 is not None:
        jt.syn1 = jnp.asarray(r.normal(scale=0.1, size=(V, D)), jnp.float32)
    if jt.syn1neg is not None:
        jt.syn1neg = jnp.asarray(r.normal(scale=0.1, size=(V, D)),
                                 jnp.float32)
    pm = pnlp.Word2Vec(sentence_iterator=pnlp.CollectionSentenceIterator(
        sents), device="cpu", **kw)
    pm.build_vocab()
    carry(jm, pm)
    centers = r.integers(0, V, B).astype(np.int32)
    if "cbow" in case:
        contexts = r.integers(-1, V, (B, 6)).astype(np.int32)
        contexts[:, 0] = r.integers(0, V, B)
    else:
        contexts = r.integers(0, V, B).astype(np.int32)
    return jm, pm, centers, contexts


@pytest.mark.parametrize("case", sorted(PAIR_CASES))
def test_pair_step_matches_jax(case):
    """One SGD step of the pair path (make_skipgram_step /
    make_cbow_step) on JAX's tables with JAX's negatives (drawn from the
    step's key as JAX's step draws them): 1e-5."""
    jm, pm, centers, contexts = _pair_tables(case)
    jt, pt = jm.lookup_table, pm.lookup_table
    cbow = "cbow" in case
    jstep = (jemb.make_cbow_step(jt, 3) if cbow
             else jemb.make_skipgram_step(jt))
    pstep = (pemb.make_cbow_step(pt, 3) if cbow
             else pemb.make_skipgram_step(pt))
    key = jax.random.PRNGKey(11)
    dummy = jnp.zeros((1, 1), jnp.float32)
    j = jstep(jt.syn0, dummy if jt.syn1 is None else jt.syn1,
              dummy if jt.syn1neg is None else jt.syn1neg,
              jnp.asarray(centers), jnp.asarray(contexts),
              jnp.float32(0.05), key)
    negs = (as_torch(jt.sampler.sample(key, centers.shape + (jt.negative,)),
                     "cpu") if jt.negative > 0 else None)
    tdummy = torch.zeros((1, 1))
    p = pstep(pt.syn0, tdummy if pt.syn1 is None else pt.syn1,
              tdummy if pt.syn1neg is None else pt.syn1neg,
              torch.as_tensor(centers, dtype=torch.int64),
              torch.as_tensor(contexts, dtype=torch.int64), 0.05, negs)
    names = ["syn0", "syn1", "syn1neg"]
    for name, a, b, before in zip(names, p[:3], j[:3],
                                  (jt.syn0, jt.syn1, jt.syn1neg)):
        if before is None:
            continue
        assert rel(_np(a), b) <= STEP_TOL, name
        assert not np.array_equal(np.asarray(b), np.asarray(before)), name
    np.testing.assert_allclose(float(p[3]), float(j[3]), rtol=STEP_TOL)


FIT_CASES = {
    "sg_hs": (PW2V, jnlp.Word2Vec, dict(negative=0,
                                        use_hierarchic_softmax=True)),
    "sg_hs_ns": (PW2V, jnlp.Word2Vec, dict(negative=3,
                                           use_hierarchic_softmax=True)),
    "cbow": (PW2V, jnlp.Word2Vec, dict(elements_learning_algorithm="cbow")),
    "dbow": (PPV, jnlp.ParagraphVectors, dict(train_elements=False)),
    "dm": (PPV, jnlp.ParagraphVectors, dict(sequence_learning_algorithm="dm",
                                            train_elements=False)),
    "dm_cbow": (PPV, jnlp.ParagraphVectors, dict(
        sequence_learning_algorithm="dm",
        elements_learning_algorithm="cbow", train_elements=True)),
}


@pytest.mark.parametrize("case", sorted(FIT_CASES))
def test_pair_fit_matches_jax(case):
    """A pair-path fit (pair generation, shuffle, padding, lr decay, the
    epoch runner over two epochs) on JAX's tables and negatives: 1e-4."""
    pcls, jcls, extra = FIT_CASES[case]
    sents, _ = topic_corpus(50, seed=6)
    kw = dict(layer_size=12, window_size=3, min_word_frequency=1, seed=6,
              epochs=2, batch_size=64, negative=5)
    kw.update(extra)
    if jcls is jnlp.ParagraphVectors:
        labels = [f"d{i % 5}" for i in range(len(sents))]
        jm = jcls(iterator=jnlp.CollectionLabeledSentenceIterator(
            sents, labels), **kw)
        pm = pcls(iterator=pnlp.CollectionLabeledSentenceIterator(
            sents, labels), device="cpu", **kw)
    else:
        jm = jcls(sentence_iterator=jnlp.CollectionSentenceIterator(sents),
                  **kw)
        pm = pcls(sentence_iterator=pnlp.CollectionSentenceIterator(sents),
                  device="cpu", **kw)
    jm.build_vocab()
    pm.build_vocab()
    carry(jm, pm)
    jm.fit()
    pm.fit()
    for k in ("syn0", "syn1", "syn1neg"):
        want = getattr(jm.lookup_table, k)
        if want is None:
            continue
        assert rel(_np(getattr(pm.lookup_table, k)), want) <= FIT_TOL, k


def test_infer_vector_matches_jax_from_the_same_draws(pv_pair,
                                                     stable_jax_hash):
    """infer_vector on JAX's trained tables from JAX's start vector and
    negatives equals JAX's over its 20 steps (a trajectory: 1e-4), on
    several texts, unknown words dropped."""
    jm, pm, _ = pv_pair
    same = PPV(iterator=pm.iterator, device="cpu", **PV_KW)
    same.vocab = pm.vocab
    carry(jm, same)
    for text in ("cat dog pet", "car road zebra wheel", "rain", "zebra",
                 "cat dog kitten paw fur pet"):
        assert rel(same.infer_vector(text), jm.infer_vector(text)) \
            <= FIT_TOL, text


def test_infer_vector_seed_is_a_stable_digest():
    """The port seeds infer_vector from a digest of the text, not from
    hash(text) (which changes with PYTHONHASHSEED): a process with another
    PYTHONHASHSEED infers the same vector as this one."""
    import subprocess
    import sys
    code = ("import deeplearning4j_tpu_torch.nlp as n\n"
            "pv = n.ParagraphVectors(sentence_iterator="
            "n.CollectionSentenceIterator(['a b c d'] * 20), layer_size=4,"
            " seed=1, min_word_frequency=1, device='cpu')\n"
            "pv.build_vocab()\n"
            "print(pv.infer_vector('a b c', steps=1).tolist())\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    here = {}
    exec(code.replace("print(", "here['v'] = ("), {"here": here})
    seed = os.environ.get("PYTHONHASHSEED", "")
    env = dict(os.environ, PYTHONPATH=root,
               PYTHONHASHSEED="7" if seed != "7" else "8")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, check=True).stdout
    assert out.strip() == str(here["v"])


# --------------------------- capture plumbing -------------------------------

class _EagerGraph:
    """A CUDA graph's stand-in: each replay runs the captured compute and
    commit eagerly on the same static buffers."""

    def __init__(self, name, compute, commit, device, generators=()):
        self.compute, self.commit = compute, commit

    def replay(self):
        self.commit(self.compute())


@pytest.fixture
def replayed_on_cpu(monkeypatch):
    from deeplearning4j_tpu_torch.nn import superstep
    monkeypatch.setattr(superstep, "_Graph", _EagerGraph)
    monkeypatch.setattr(pemb, "_captures", lambda device: True)


@pytest.mark.parametrize("case", ["corpus", "pair", "glove"])
def test_replayed_epochs_equal_the_eager_loop(replayed_on_cpu, monkeypatch,
                                              case):
    """The card's epoch plumbing (whole-epoch static buffers, the device
    step counter, the loss accumulator, one capture per signature,
    re-capture when an epoch outgrows its buffers) replayed eagerly on the
    CPU is bit-equal to the eager loop."""
    sents = zipf_corpus(80, seed=7, vocab=40, length=9)

    def run(replay):
        monkeypatch.setattr(pemb, "_captures", lambda device: replay)
        if case == "glove":
            m = pnlp.Glove(sentence_iterator=pnlp.CollectionSentenceIterator(
                sents), layer_size=8, window=4, epochs=3, batch_size=50,
                seed=1, device="cpu")
            m.fit()
            return [m.lookup_table.syn0], m._epochs
        kw = dict(layer_size=8, window_size=3, epochs=3, seed=1,
                  min_word_frequency=1, batch_size=64, sampling=0.05)
        if case == "pair":
            kw.update(negative=2, use_hierarchic_softmax=True)
        m = pnlp.Word2Vec(sentence_iterator=pnlp.CollectionSentenceIterator(
            sents), device="cpu", **kw)
        m.fit()
        t = m.lookup_table
        eps = (m._sg_runner.epochs if case == "corpus"
               else m._pair_runners["sg"].epochs)
        return [x for x in (t.syn0, t.syn1, t.syn1neg) if x is not None], eps

    eager, e_eps = run(False)
    replayed, r_eps = run(True)
    for a, b in zip(eager, replayed):
        assert torch.equal(a, b)
    assert e_eps.captures == e_eps.replays == 0
    assert r_eps.replays > 0 and 1 <= r_eps.captures <= 3


def test_epoch_capture_failure_raises_capture_error(monkeypatch):
    """On the card an epoch whose step cannot be captured raises
    CaptureError; no eager loop runs in its place."""
    from deeplearning4j_tpu_torch.nn import superstep
    from deeplearning4j_tpu_torch.nn.superstep import CaptureError

    def refuse(name, compute, commit, device, generators=()):
        raise CaptureError(f"{name}: refused")

    monkeypatch.setattr(superstep, "_Graph", refuse)
    monkeypatch.setattr(pemb, "_captures", lambda device: True)
    sents = zipf_corpus(30, seed=1, vocab=20, length=6)
    m = pnlp.Word2Vec(sentence_iterator=pnlp.CollectionSentenceIterator(
        sents), layer_size=4, window_size=2, seed=1, device="cpu")
    m.build_vocab()
    before = m.lookup_table.vectors_matrix()
    with pytest.raises(CaptureError, match="word2vec/sgns_epoch"):
        m.fit()
    np.testing.assert_array_equal(m.lookup_table.vectors_matrix(), before)


# --------------------------- telemetry, devices ------------------------------

def test_word2vec_telemetry_compile_count():
    """Two epochs of one fit build the SGNS epoch runner once (a compile
    on the CPU is the first eager call of a signature, where the card
    captures), and the device/dispatch span is recorded (twin of
    test_telemetry.py:327)."""
    from deeplearning4j_tpu_torch import telemetry
    sents = ["the quick brown fox jumps over the lazy dog",
             "the cat sat on the mat and the dog barked"] * 20
    w2v = pnlp.Word2Vec(sentence_iterator=pnlp.CollectionSentenceIterator(
        sents), layer_size=8, window_size=2, negative=2,
        min_word_frequency=1, epochs=2, batch_size=64, seed=3, device="cpu")
    with telemetry.enabled() as sess:
        w2v.fit()
        rep = sess.compiles.report()
        assert rep.get("word2vec/sgns_epoch", {}).get("count") == 1, rep
        assert sess.span_totals().get("device/dispatch", 0) > 0


ENTRY_POINTS = {
    "table": lambda: InMemoryLookupTable(pnlp.VocabConstructor().build_vocab(
        [["a", "b"]]), 4),
    "word2vec": lambda: pnlp.Word2Vec(),
    "negative_sampler": lambda: pnlp.NegativeSampler(np.array([3, 2, 1])),
    "paragraph_vectors": lambda: pnlp.ParagraphVectors(),
    "glove": lambda: pnlp.Glove(),
    "deepwalk": lambda: pgraph.DeepWalk(),
    "serializer": None,
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_card(name, tmp_path):
    """Left out, `device` means the GPU; without one the call raises
    (nothing moves to the CPU on its own)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default resolves to it")
    make = ENTRY_POINTS[name]
    if make is None:
        path = str(tmp_path / "v.txt")
        with open(path, "w") as f:
            f.write("a 0.5 0.25\n")
        make = lambda: pnlp.WordVectorSerializer.read_word_vectors(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()


def test_port_nlp_modules_mirror_jax():
    """Every module of the JAX package's nlp/ exists in the port with the
    same public names."""
    import importlib
    import pkgutil

    import deeplearning4j_tpu.nlp as jpkg
    for info in pkgutil.iter_modules(jpkg.__path__):
        jmod = importlib.import_module(f"deeplearning4j_tpu.nlp.{info.name}")
        pmod = importlib.import_module(
            f"deeplearning4j_tpu_torch.nlp.{info.name}")
        assert set(getattr(jmod, "__all__", ())) <= set(dir(pmod)), info.name
    assert jnlp.__all__ == pnlp.__all__
