"""PyTorch port, graph embeddings (`deeplearning4j_tpu_torch/graphlib/`) on
the CPU, held against the JAX package.

The twins of `tests/test_node2vec.py` (5: the walker's length and
connectivity, its return bias, Node2Vec's communities on its own draws,
the gzip text and Google binary round trips), plus: the walkers, the
loader and the graph equal to JAX's (numpy draws in both packages), and
DeepWalk (hierarchical softmax, the pair path) and Node2Vec (the SGNS
corpus path) fitted on JAX's tables and draws against JAX's fits: DeepWalk
at 1e-4 of the largest entry (a float32 trajectory), Node2Vec at 5e-2 of
the tables' move (bf16 logits, as `tests/test_torch_nlp.py`'s epochs).
"""
import numpy as np
import pytest

import deeplearning4j_tpu.graphlib as jg
import deeplearning4j_tpu.nlp as jnlp
import deeplearning4j_tpu_torch.graphlib as pg
import deeplearning4j_tpu_torch.nlp as pnlp
from jax_nlp_draws import JaxDraws, carry
from torch_threads import one_torch_thread  # noqa: F401

FIT_TOL = 1e-4
EPOCH_F32_TOL = 5e-2


def _barbell(lib, n=6):
    """Two cliques of n joined by one bridge edge."""
    g = lib.Graph(2 * n)
    for base in (0, n):
        for i in range(n):
            for j in range(i + 1, n):
                g.add_edge(base + i, base + j)
    g.add_edge(n - 1, n)
    return g


def test_walker_respects_walk_length_and_connectivity():
    g = _barbell(pg)
    walker = pg.Node2VecWalker(g, walk_length=10, p=1.0, q=1.0, seed=0)
    for walk in list(walker.walks(1))[:5]:
        assert len(walk) == 10
        for a, b in zip(walk, walk[1:]):
            assert b in g.neighbors(a)


def test_walker_p_bias_controls_returns():
    """Small p -> frequent immediate backtracking; large p -> rare."""
    g = _barbell(pg)

    def return_rate(p):
        walker = pg.Node2VecWalker(g, walk_length=30, p=p, q=1.0, seed=1)
        returns = steps = 0
        for walk in walker.walks(3):
            for i in range(2, len(walk)):
                steps += 1
                if walk[i] == walk[i - 2]:
                    returns += 1
        return returns / steps

    assert return_rate(0.05) > return_rate(20.0) + 0.05


def _communities(model):
    emb = np.stack([model.vertex_vector(i) for i in range(12)])
    emb = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    same = np.mean([emb[i] @ emb[j] for i in range(5) for j in range(5)
                    if i != j])
    cross = np.mean([emb[i] @ emb[j] for i in range(5) for j in range(7, 12)])
    return same, cross


def test_node2vec_embeds_communities():
    g = _barbell(pg)
    n2v = pg.Node2Vec(vector_size=32, walk_length=20, walks_per_vertex=20,
                      window_size=4, p=1.0, q=0.5, seed=3, epochs=3,
                      device="cpu")
    n2v.fit(g)
    same, cross = _communities(n2v)
    assert same > cross + 0.1, (same, cross)


def test_deepwalk_embeds_communities():
    """DeepWalk (hierarchical softmax over walk-visit counts) on its own
    draws separates the two cliques as Node2Vec's test asks."""
    g = _barbell(pg)
    dw = pg.DeepWalk(vector_size=32, walk_length=20, walks_per_vertex=20,
                     window_size=4, seed=3, epochs=3, device="cpu")
    dw.fit(g)
    same, cross = _communities(dw)
    assert same > cross + 0.1, (same, cross)
    assert dw.num_vertices() == 12
    near = dw.vertices_nearest(0, 4)
    assert sum(v < 6 for v in near) >= 3, near


def test_word_vector_serializer_gzip_round_trip(tmp_path):
    g = _barbell(pg)
    n2v = pg.Node2Vec(vector_size=8, walk_length=10, walks_per_vertex=2,
                      seed=0, device="cpu")
    n2v.fit(g)
    path = str(tmp_path / "vecs.txt.gz")
    pnlp.WordVectorSerializer.write_word_vectors(n2v, path, header=True)
    back = pnlp.WordVectorSerializer.read_word_vectors(path, device="cpu")
    w = n2v.vocab.words()[0]
    np.testing.assert_allclose(back.word_vector(w), n2v.word_vector(w),
                               atol=1e-5)
    jback = jnlp.WordVectorSerializer.read_word_vectors(path)
    np.testing.assert_array_equal(back.lookup_table.vectors_matrix(),
                                  jback.lookup_table.vectors_matrix())


def test_google_binary_round_trip(tmp_path):
    g = _barbell(pg)
    n2v = pg.Node2Vec(vector_size=8, walk_length=10, walks_per_vertex=2,
                      seed=0, device="cpu")
    n2v.fit(g)
    path = str(tmp_path / "vecs.bin")
    pnlp.WordVectorSerializer.write_binary(n2v, path)
    back = pnlp.WordVectorSerializer.read_binary(path, device="cpu")
    for w in n2v.vocab.words()[:5]:
        np.testing.assert_allclose(back.word_vector(w), n2v.word_vector(w),
                                   atol=1e-6)
    jback = jnlp.WordVectorSerializer.read_binary(path)
    np.testing.assert_array_equal(back.lookup_table.vectors_matrix(),
                                  n2v.lookup_table.vectors_matrix())
    assert jback.vocab.words() == back.vocab.words()


def _weighted(lib):
    g = lib.Graph(7, directed=False)
    r = np.random.default_rng(2)
    for a in range(7):
        for b in range(a + 1, 7):
            if r.random() < 0.5:
                g.add_edge(a, b, weight=float(r.integers(1, 5)))
    g.add_edge(0, 6, weight=3.0)
    return g


@pytest.mark.parametrize("walker", ["uniform", "weighted", "node2vec"])
def test_walks_equal_jax(walker):
    """The walkers draw from numpy in both packages: the same walks."""
    gp, gj = _weighted(pg), _weighted(jg)
    if walker == "node2vec":
        got = list(pg.Node2VecWalker(gp, 12, p=0.5, q=2.0, seed=4).walks(3))
        want = list(jg.Node2VecWalker(gj, 12, p=0.5, q=2.0, seed=4).walks(3))
    else:
        pcls, jcls = ((pg.RandomWalkIterator, jg.RandomWalkIterator)
                      if walker == "uniform" else
                      (pg.WeightedRandomWalkIterator,
                       jg.WeightedRandomWalkIterator))
        got, want = list(pcls(gp, 9, seed=5)), list(jcls(gj, 9, seed=5))
    assert got == want and len(got) > 0


def test_disconnected_vertex_handling_matches_jax():
    for lib in (pg, jg):
        g = lib.Graph(3)
        g.add_edge(0, 1)
        walks = list(lib.RandomWalkIterator(g, 4, seed=0))
        assert walks[2] == [2] * 5
        it = lib.RandomWalkIterator(
            g, 4, seed=0,
            no_edge_handling=lib.NoEdgeHandling.EXCEPTION_ON_DISCONNECTED)
        with pytest.raises(ValueError, match="no edges"):
            list(it)


@pytest.mark.parametrize("fmt", ["edge_list", "adjacency_list"])
def test_graph_loader_matches_jax(tmp_path, fmt):
    path = tmp_path / "g.txt"
    if fmt == "edge_list":
        path.write_text("# comment\n0 1\n1 2 2.5\n2 3\n3 0 0.5\n")
        load = "load_edge_list"
    else:
        path.write_text("0 1 2\n1 2\n2 3\n3 0\n")
        load = "load_adjacency_list"
    gp = getattr(pg.GraphLoader, load)(str(path))
    gj = getattr(jg.GraphLoader, load)(str(path))
    assert gp.num_vertices() == gj.num_vertices()
    assert gp.num_edges() == gj.num_edges()
    for v in range(gp.num_vertices()):
        assert [(e.to_idx, e.weight) for e in gp.edges_out(v)] == \
            [(e.to_idx, e.weight) for e in gj.edges_out(v)]


class PDeepWalk(JaxDraws, pg.DeepWalk):
    pass


class PNode2Vec(JaxDraws, pg.Node2Vec):
    pass


@pytest.mark.parametrize("weighted", [False, True])
def test_deepwalk_fit_matches_jax(weighted):
    """DeepWalk's whole fit (walks, vocab, Huffman tree, the HS pair path
    over two epochs) from JAX's tables: 1e-4 of the largest entry."""
    kw = dict(vector_size=16, walk_length=12, walks_per_vertex=4,
              window_size=3, seed=5, epochs=2, weighted=weighted,
              batch_size=128)
    gp, gj = _weighted(pg), _weighted(jg)
    jm, pm = jg.DeepWalk(**kw), PDeepWalk(device="cpu", **kw)
    for m, g, cls in ((jm, gj, jg), (pm, gp, pg)):
        walker = (cls.WeightedRandomWalkIterator if weighted
                  else cls.RandomWalkIterator)
        m._walks = [[str(v) for v in w] for rep in range(4)
                    for w in walker(g, 12, seed=5 + rep)]
        m.build_vocab()
    carry(jm, pm)
    jm.fit(gj)
    pm.fit(gp)
    assert pm._walks == jm._walks
    for k in ("syn0", "syn1"):
        want = np.asarray(getattr(jm.lookup_table, k))
        got = getattr(pm.lookup_table, k).detach().numpy()
        assert np.abs(got - want).max() <= FIT_TOL * np.abs(want).max(), k


def test_node2vec_fit_matches_jax():
    """Node2Vec's fit (biased walks, the SGNS corpus path) on JAX's tables
    and draws: within 5e-2 of the tables' move."""
    kw = dict(vector_size=16, walk_length=12, walks_per_vertex=5,
              window_size=3, p=0.5, q=2.0, seed=6, epochs=2)
    gp, gj = _barbell(pg), _barbell(jg)
    jm, pm = jg.Node2Vec(**kw), PNode2Vec(device="cpu", **kw)
    for m, g, cls in ((jm, gj, jg), (pm, gp, pg)):
        walker = cls.Node2VecWalker(g, 12, p=0.5, q=2.0, seed=6)
        m._walks = [[str(v) for v in w] for w in walker.walks(5)]
        m.build_vocab()
    carry(jm, pm)
    init = np.asarray(jm.lookup_table.syn0)
    jm.fit(gj)
    pm.fit(gp)
    assert pm._walks == jm._walks
    got = pm.lookup_table.vectors_matrix()
    want = np.asarray(jm.lookup_table.syn0)
    gap = np.linalg.norm(got - want) / np.linalg.norm(want - init)
    assert gap <= EPOCH_F32_TOL, gap
