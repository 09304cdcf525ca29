"""PyTorch port, clustering and embedding plots (`deeplearning4j_tpu_torch/
clustering/`, `plot/`) on the CPU, held against the JAX package.

The twins of `tests/test_clustering_trees.py` (10) run the port's classes
on the same data. Parity, on the same inputs made from a seed with numpy:
  * the KD and VP trees' neighbour lists equal JAX's, the distances and
    the space-partitioning tree's forces to float64 rounding (1e-12
    relative); BarnesHutTsne (host float64 in both packages) equal to JAX's
    at 1e-9 of the embedding's largest entry;
  * K-means (euclidean, cosine, and a start with an empty cluster): labels
    equal, centres at 1e-5, the same iteration count;
  * exact t-SNE: the JAX package's `_p_matrix` is uniform (a reference
    defect, witnessed below); the port's P equals JAX's own
    `_binary_search_perplexity` run on the off-diagonal [N, N - 1]
    distances and symmetrised, at 1e-4 of its largest entry (the
    conditional rows read 1.2e-5, P 9.3e-6: the two float32 distance
    matrices round apart and the bisection lands on slightly other betas);
    each row's entropy is log(perplexity) within 1e-4 (reads 7.2e-7); the
    steps run on JAX's P from JAX's start `y`: one step at 1e-5 of the
    embedding's largest entry (reads 4.6e-7), 20 steps (exaggeration and
    momentum switching inside them) within 1e-3 of the largest entry of
    JAX's trajectory on that P in float64 (the suite enables x64; the port
    reads 3.4e-5, JAX's own float32 run of the same P 7.9e-5: the early
    steps amplify float32 rounding);
  * on wide, dense data (1,000 points in 128-D) JAX's search in its
    default float32 mode misses log(perplexity) in some rows even on the
    off-diagonal distances (exp underflows, the normaliser's floor turns
    the bisection); the port's search, on distances taken from each row's
    nearest neighbour's, reaches it;
  * `export_tsne_html` writes JAX's bytes;
  * the device-side entry points (`Tsne`, `KMeansClustering`) default to
    the GPU and raise here; BarnesHutTsne and the trees need none.

JAX references are computed once per module inside `torch_threads.pinned()`.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu import clustering as jclu
from deeplearning4j_tpu.plot import tsne as jtsne
import deeplearning4j_tpu_torch.clustering as pclu
from deeplearning4j_tpu_torch.clustering import (KDTree, KMeansClustering,
                                                 QuadTree, SpTree, VPTree)
from deeplearning4j_tpu_torch.plot import tsne as ptsne
from deeplearning4j_tpu_torch.plot.tsne import BarnesHutTsne, Tsne
from torch_threads import one_torch_thread, pinned  # noqa: F401

TREE_RTOL = 1e-12     # float64 host code in both packages
CENTER_TOL = 1e-5     # K-means centres, float32 on both sides
P_TOL = 1e-4          # the P matrix, of its largest entry (reads 1.2e-5)
ENTROPY_TOL = 1e-4    # each row's entropy against log(perplexity)
STEP_TOL = 1e-5       # one t-SNE step, of the embedding's largest entry
TRAJ_TOL = 1e-3       # 20 steps against JAX's float64 trajectory


def _brute_knn(points, q, k):
    d = np.sqrt(np.sum((points - q) ** 2, axis=1))
    idx = np.argsort(d, kind="stable")[:k]
    return [(float(d[i]), int(i)) for i in idx]


# -- the twins of tests/test_clustering_trees.py -------------------------------

def test_kdtree_matches_brute_force():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(200, 5))
    tree = KDTree(pts)
    assert len(tree) == 200
    for qi in range(10):
        q = rng.normal(size=5)
        got = tree.knn(q, 7)
        want = _brute_knn(pts, q, 7)
        assert [i for _, i in got] == [i for _, i in want]
        np.testing.assert_allclose([d for d, _ in got],
                                   [d for d, _ in want], rtol=1e-10)
    idx, dist = tree.nn(pts[13] + 1e-9)
    assert idx == 13


def test_vptree_matches_brute_force():
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(150, 4))
    tree = VPTree(pts)
    for qi in range(10):
        q = rng.normal(size=4)
        got = tree.knn(q, 5)
        want = _brute_knn(pts, q, 5)
        assert [i for _, i in got] == [i for _, i in want]


def test_vptree_cosine_metric():
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(100, 8))
    tree = VPTree(pts, metric="cosine")
    q = rng.normal(size=8)
    got = tree.knn(q, 4)
    unit = pts / np.linalg.norm(pts, axis=1, keepdims=True)
    d = 1.0 - unit @ (q / np.linalg.norm(q))
    want = np.argsort(d, kind="stable")[:4]
    assert [i for _, i in got] == list(want)


def test_sptree_theta_zero_is_exact():
    """theta=0 forces full traversal -> exact repulsive forces."""
    rng = np.random.default_rng(3)
    y = rng.normal(size=(60, 2))
    tree = QuadTree(y)
    for i in (0, 17, 59):
        neg, sum_q = tree.compute_non_edge_forces(i, theta=0.0)
        diff = y[i] - y
        d2 = np.sum(diff * diff, axis=1)
        q = 1.0 / (1.0 + d2)
        q[i] = 0.0
        want_sum = q.sum()
        want_neg = ((q ** 2)[:, None] * diff).sum(axis=0)
        np.testing.assert_allclose(sum_q, want_sum, rtol=1e-9)
        np.testing.assert_allclose(neg, want_neg, rtol=1e-9, atol=1e-12)


def test_sptree_theta_half_approximates():
    rng = np.random.default_rng(4)
    y = rng.normal(size=(200, 2))
    tree = QuadTree(y)
    exact_tree = QuadTree(y)
    for i in (5, 100):
        approx, sq_a = tree.compute_non_edge_forces(i, theta=0.5)
        exact, sq_e = exact_tree.compute_non_edge_forces(i, theta=0.0)
        assert abs(sq_a - sq_e) / sq_e < 0.05
        np.testing.assert_allclose(approx, exact, rtol=0.15, atol=1e-3)


def test_sptree_3d():
    rng = np.random.default_rng(5)
    y = rng.normal(size=(80, 3))
    tree = SpTree(y)
    neg, sum_q = tree.compute_non_edge_forces(0, theta=0.0)
    diff = y[0] - y
    q = 1.0 / (1.0 + np.sum(diff * diff, axis=1))
    q[0] = 0.0
    np.testing.assert_allclose(sum_q, q.sum(), rtol=1e-9)


def test_sptree_handles_duplicate_points():
    y = np.zeros((10, 2))
    y[5:] = 1.0
    tree = QuadTree(y)  # must not recurse forever
    neg, sum_q = tree.compute_non_edge_forces(0, theta=0.5)
    assert np.isfinite(sum_q)


def _three_blobs(n_per=40, seed=6):
    rng = np.random.default_rng(seed)
    centers = np.array([[0, 0, 0, 0], [8, 8, 0, 0], [0, 8, 8, 0]],
                       dtype=np.float64)
    xs, labels = [], []
    for ci, c in enumerate(centers):
        xs.append(c + rng.normal(scale=0.5, size=(n_per, 4)))
        labels += [ci] * n_per
    return np.concatenate(xs), np.array(labels)


def _separated(y, labels, k=3):
    """Mean intra-cluster spread well below every inter-centre distance."""
    intra, inter = [], []
    for a in range(k):
        ya = y[labels == a]
        intra.append(np.mean(np.linalg.norm(ya - ya.mean(0), axis=1)))
        for b in range(a + 1, k):
            inter.append(np.linalg.norm(ya.mean(0) - y[labels == b].mean(0)))
    return min(inter) > 2.0 * max(intra), (intra, inter)


def test_barnes_hut_tsne_separates_clusters():
    x, labels = _three_blobs()
    ts = BarnesHutTsne(max_iter=250, perplexity=15.0, seed=1, theta=0.5)
    y = ts.fit_transform(x)
    assert y.shape == (x.shape[0], 2)
    assert np.isfinite(ts.kl_divergence)
    ok, spread = _separated(y, labels)
    assert ok, spread


def test_barnes_hut_get_data_and_export(tmp_path):
    x, labels = _three_blobs(n_per=15)
    ts = BarnesHutTsne(max_iter=60, perplexity=8.0, seed=2)
    ts.fit(x)
    assert ts.get_data().shape == (45, 2)
    out = tmp_path / "tsne.csv"
    ts.save_as_file([str(l) for l in labels], str(out))
    assert len(out.read_text().splitlines()) == 45


def test_export_tsne_html(tmp_path):
    """TsneModule-analog scatter export, colored by label."""
    r = np.random.default_rng(0)
    coords = r.normal(size=(30, 2))
    labels = r.integers(0, 3, 30)
    path = str(tmp_path / "tsne.html")
    ptsne.export_tsne_html(coords, path, labels=labels, title="emb<1>")
    html = open(path).read()
    assert html.count("<circle") == 30
    assert "emb&lt;1&gt;" in html


# -- parity with the JAX package ------------------------------------------

@pytest.mark.parametrize("case", ["kdtree", "vptree", "vptree_cosine"])
def test_tree_neighbour_lists_equal_jax(case):
    """The same points and queries: the same neighbour lists, distances to
    float64 rounding; the points handed over as a tensor."""
    rng = np.random.default_rng(11)
    pts = rng.normal(size=(300, 6))
    queries = rng.normal(size=(12, 6))
    if case == "kdtree":
        mk = lambda m, p: m.KDTree(p)
    else:
        metric = "cosine" if case.endswith("cosine") else "euclidean"
        mk = lambda m, p: m.VPTree(p, metric=metric, seed=3)
    got_tree = mk(pclu, torch.tensor(pts))
    want_tree = mk(jclu, pts)
    for q in queries:
        got, want = got_tree.knn(torch.tensor(q), 9), want_tree.knn(q, 9)
        assert [i for _, i in got] == [i for _, i in want]
        np.testing.assert_allclose([d for d, _ in got], [d for d, _ in want],
                                   rtol=TREE_RTOL)


def test_sptree_forces_equal_jax():
    rng = np.random.default_rng(12)
    y = rng.normal(size=(150, 2))
    got, want = QuadTree(torch.tensor(y)), jclu.QuadTree(y)
    for i in range(0, 150, 7):
        for theta in (0.0, 0.5):
            gn, gs = got.compute_non_edge_forces(i, theta)
            wn, ws = want.compute_non_edge_forces(i, theta)
            np.testing.assert_allclose(gn, wn, rtol=TREE_RTOL, atol=1e-15)
            np.testing.assert_allclose(gs, ws, rtol=TREE_RTOL)


def _blobs(n, d=16, k=5, seed=0):
    r = np.random.default_rng(seed)
    c = r.normal(scale=4, size=(k, d))
    x = np.concatenate([c[i] + r.normal(size=(n // k, d)) for i in range(k)])
    return x.astype(np.float32), np.repeat(np.arange(k), n // k)


@pytest.mark.parametrize("case", ["euclidean", "cosine", "empty"])
def test_kmeans_matches_jax(case):
    """Centres at 1e-5, labels and predictions equal, the same iteration
    count. "empty": duplicate rows make two first centres coincide, so a
    cluster is empty and keeps its centre in both packages."""
    x, _ = _blobs(250, seed=7)
    distance = "cosine" if case == "cosine" else "euclidean"
    seed = 3
    if case == "empty":
        first = np.random.default_rng(seed).choice(len(x), 5, replace=False)
        x[first[1]] = x[first[0]]
    want = jclu.KMeansClustering(5, distance=distance, seed=seed).fit(x)
    got = KMeansClustering(5, distance=distance, seed=seed,
                           device="cpu").fit(x)
    np.testing.assert_array_equal(got.labels_, want.labels_)
    np.testing.assert_allclose(got.centers, want.centers, rtol=0,
                               atol=CENTER_TOL)
    np.testing.assert_array_equal(got.predict(x[:40]), want.predict(x[:40]))
    assert got.iterations == got.host_reads
    if case == "empty":         # the first iteration's cluster 1 is empty
        xt = torch.tensor(x)
        start = xt[torch.as_tensor(first)]
        centers, assign, _ = got._step(xt, start)
        assert 1 not in assign.tolist()
        assert torch.equal(centers[1], start[1])


def test_barnes_hut_tsne_equals_jax():
    """Host float64 in both packages: the same embedding and KL."""
    x, _ = _three_blobs(n_per=15)
    kw = dict(max_iter=40, perplexity=8.0, seed=4, theta=0.5)
    want = jtsne.BarnesHutTsne(**kw).fit_transform(x)
    ts = BarnesHutTsne(**kw)
    got = ts.fit_transform(torch.tensor(x))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-9 * np.abs(want).max())
    assert got.dtype == want.dtype


def test_export_tsne_html_equals_jax(tmp_path):
    r = np.random.default_rng(1)
    coords = r.normal(size=(25, 2)).astype(np.float32)
    labels = r.integers(0, 4, 25)
    ptsne.export_tsne_html(torch.tensor(coords), str(tmp_path / "p.html"),
                           labels=labels, title="t<sne>")
    jtsne.export_tsne_html(coords, str(tmp_path / "j.html"), labels=labels,
                           title="t<sne>")
    assert (tmp_path / "p.html").read_text() == \
        (tmp_path / "j.html").read_text()


# -- exact t-SNE -----------------------------------------------------------

N, PERP = 300, 30.0
SCHEDULE = dict(stop_lying_iteration=10, switch_momentum_iteration=15)


def _jax_offdiag_p(x, perplexity):
    """JAX's own search on the off-diagonal [N, N - 1] distances (no inf),
    the conditional rows scattered back to [N, N] (0 on the diagonal)."""
    n = x.shape[0]
    xj = jnp.asarray(x, jnp.float32)
    sq = jnp.sum(xj * xj, axis=1)
    d = np.asarray(sq[:, None] + sq[None, :] - 2.0 * (xj @ xj.T))
    off = ~np.eye(n, dtype=bool)
    rows = np.asarray(jtsne._binary_search_perplexity(
        jnp.asarray(d[off].reshape(n, n - 1)), perplexity))
    cond = np.zeros((n, n), np.float32)
    cond[off] = rows.ravel()
    return cond


@pytest.fixture(scope="module")
def tsne_ref():
    """JAX's P (search on the off-diagonal distances, symmetrised), its
    start y, one JAX step and 20 JAX steps on that P in float64."""
    with pinned():
        x, labels = _blobs(N)
        cond = _jax_offdiag_p(x, PERP)
        p = np.maximum((cond + cond.T) / (2.0 * N), 1e-12)
        y0 = np.asarray(1e-4 * jax.random.normal(
            jax.random.PRNGKey(42), (N, 2), jnp.float32))
        runs = {}
        for steps, dtype in ((1, np.float32), (20, np.float64)):
            jt = jtsne.Tsne(max_iter=steps, perplexity=PERP, **SCHEDULE)
            jt._p_matrix = lambda _x, p=p.astype(dtype): jnp.asarray(p)
            runs[steps] = (jt.fit_transform(x), jt.kl_divergence)
        return {"x": x, "labels": labels, "cond": cond, "p": p, "y0": y0,
                "runs": runs}


def _port_tsne(ref, steps):
    """The port's `steps` on JAX's P from JAX's start y."""
    ts = Tsne(max_iter=steps, perplexity=PERP, device="cpu", **SCHEDULE)
    ts._initial_y = lambda n: torch.tensor(ref["y0"])
    ts._p_matrix = lambda x: torch.tensor(ref["p"])
    return ts, ts.fit_transform(torch.tensor(ref["x"]))


def test_jax_exact_tsne_p_is_uniform_reference_defect():
    """The JAX package's exact P ignores its data: the diagonal's inf
    distance meets a zero affinity in `_hbeta` (inf * 0 = NaN), so every
    row's entropy is NaN, each beta halves 50 times and P is
    1 / (N (N - 1)) off the diagonal. The port's rows are calibrated."""
    x, _ = _blobs(150, k=3, seed=2)
    n = len(x)
    xj = jnp.asarray(x)
    sq = jnp.sum(xj * xj, axis=1)
    d = sq[:, None] + sq[None, :] - 2.0 * (xj @ xj.T)
    d = d.at[jnp.arange(n), jnp.arange(n)].set(jnp.inf)
    h, _ = jtsne._hbeta(d[0], 1.0)
    assert math.isnan(float(h))
    p = np.asarray(jtsne.Tsne(perplexity=10.0)._p_matrix(xj))
    off = p[~np.eye(n, dtype=bool)]
    np.testing.assert_allclose(off, 1.0 / (n * (n - 1)), rtol=1e-5)
    cond = Tsne(perplexity=10.0, device="cpu").conditional_p(x)
    np.testing.assert_allclose(ptsne.row_entropy(cond).numpy(),
                               math.log(10.0), atol=ENTROPY_TOL)


def test_tsne_p_matches_jax_search_off_diagonal(tsne_ref):
    ts = Tsne(perplexity=PERP, device="cpu")
    x = torch.tensor(tsne_ref["x"])
    cond = ts.conditional_p(x)
    np.testing.assert_allclose(cond.numpy(), tsne_ref["cond"], rtol=0,
                               atol=P_TOL * tsne_ref["cond"].max())
    p = ts._p_matrix(x).numpy()
    np.testing.assert_allclose(p, tsne_ref["p"], rtol=0,
                               atol=P_TOL * tsne_ref["p"].max())
    # a block of rows is the same search
    block = ts.conditional_p(x, rows=slice(100, 180))
    np.testing.assert_array_equal(block.numpy(), cond[100:180].numpy())


def test_tsne_rows_reach_log_perplexity(tsne_ref):
    cond = Tsne(perplexity=PERP, device="cpu").conditional_p(tsne_ref["x"])
    h = ptsne.row_entropy(cond).numpy()
    assert np.abs(h - math.log(PERP)).max() <= ENTROPY_TOL
    np.testing.assert_allclose(cond.sum(dim=1).numpy(), 1.0, atol=1e-5)
    assert (cond.diagonal() == 0).all()


def test_perplexity_search_survives_float32_underflow():
    """1,000 points of one Gaussian in 128-D: nearest squared distances near
    170 and a peaked neighbourhood, so exp(-beta d) underflows float32 at
    the betas the search needs. JAX's own search on the off-diagonal
    distances, in JAX's default float32 mode, lands 105 rows up to 0.63
    from log 30 (a reference defect beside the diagonal's); the port's
    rows reach it."""
    r = np.random.default_rng(21)
    x = (r.normal(scale=2.0, size=(1, 128))
         + r.normal(size=(1000, 128))).astype(np.float32)
    cond = Tsne(perplexity=PERP, device="cpu").conditional_p(x)
    port = ptsne.row_entropy(cond).numpy()
    assert np.abs(port - math.log(PERP)).max() <= ENTROPY_TOL
    with jax.enable_x64(False):
        jax_rows = _jax_offdiag_p(x, PERP)
    jax_h = ptsne.row_entropy(torch.tensor(jax_rows)).numpy()
    assert np.abs(jax_h - math.log(PERP)).max() > 0.1


def test_tsne_first_step_matches_jax(tsne_ref):
    ts, y = _port_tsne(tsne_ref, 1)
    want, _ = tsne_ref["runs"][1]
    np.testing.assert_allclose(y, want, rtol=0,
                               atol=STEP_TOL * np.abs(want).max())
    assert ts.host_reads == 1


def test_tsne_twenty_steps_match_jax_f64_trajectory(tsne_ref):
    """Exaggeration ends at step 10 and momentum switches at 15."""
    ts, y = _port_tsne(tsne_ref, 20)
    want, want_kl = tsne_ref["runs"][20]
    scale = np.abs(want).max()
    assert np.abs(y - want).max() <= TRAJ_TOL * scale
    assert abs(ts.kl_divergence - want_kl) <= TRAJ_TOL * abs(want_kl)
    assert y.dtype == np.float32 and ts.host_reads == 1


def test_tsne_separates_clusters():
    """The port's own draws: 250 exact steps on five blobs; each point's 10
    nearest neighbours in 2-D share its blob."""
    x, labels = _blobs(150, d=8)
    y = Tsne(max_iter=250, perplexity=15.0, seed=1,
             device="cpu").fit_transform(x)
    d = ((y[:, None] - y[None]) ** 2).sum(-1)
    np.fill_diagonal(d, np.inf)
    nn = np.argsort(d, axis=1)[:, :10]
    assert (labels[nn] == labels[:, None]).mean() > 0.9


def test_device_entry_points_default_to_the_card():
    """`Tsne` and `KMeansClustering` default to the GPU (none here, so
    they raise); the host-side BarnesHutTsne and trees need no device."""
    for make in (Tsne, lambda: KMeansClustering(3)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert BarnesHutTsne().device.type == "cpu"
    assert KMeansClustering(3, device="cpu").device.type == "cpu"
