"""PyTorch port, the export-based dataset plane on the CPU: the twins of
`tests/test_export_plane.py` (datasets/export.py): minibatches saved as
`.npz` files, training fed from paths, per-rank shard files.

Within the port, training from the exported files equals training from
the arrays bit for bit (the async prefetch wrapper too). The files are the
JAX package's: each package reads the other's exports with the same bits,
and the shard layout of `export_sharded` is the same. Training a world of
ranks from its shard files is in `tests/test_torch_parallel.py`.
"""
import numpy as np
import pytest

from deeplearning4j_tpu.datasets import export as jexport
import deeplearning4j_tpu as jx
import deeplearning4j_tpu_torch as pt
from deeplearning4j_tpu_torch.datasets import (ArrayDataSetIterator,
                                               LocalShardDataSet,
                                               PathDataSetIterator,
                                               ShardedPathDataSetIterator,
                                               export_datasets,
                                               export_sharded, load_dataset)
from torch_threads import one_torch_thread  # noqa: F401


def _data(n=32, f=6, c=3, seed=0):
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, f)).astype(np.float32)
    y = np.eye(c, dtype=np.float32)[r.integers(0, c, n)]
    return x, y


def test_roundtrip_with_masks(tmp_path):
    x = np.ones((4, 3, 5), np.float32)
    y = np.zeros((4, 3, 2), np.float32)
    fm = np.ones((4, 3), np.float32)
    paths = export_datasets([pt.DataSet(x, y, features_mask=fm)], tmp_path)
    assert len(paths) == 1
    back = load_dataset(paths[0])
    np.testing.assert_array_equal(back.features, x)
    np.testing.assert_array_equal(back.labels, y)
    np.testing.assert_array_equal(back.features_mask, fm)
    assert back.labels_mask is None


def test_export_rebatches_to_exact_size(tmp_path):
    x, y = _data(n=30)
    dss = [pt.DataSet(x[:7], y[:7]), pt.DataSet(x[7:19], y[7:19]),
           pt.DataSet(x[19:], y[19:])]
    paths = export_datasets(dss, tmp_path, batch_size=8)
    assert [load_dataset(p).num_examples() for p in paths] == [8, 8, 8, 6]
    cat = np.concatenate([load_dataset(p).features for p in paths])
    np.testing.assert_array_equal(cat, x)


def _build():
    conf = (pt.NeuralNetConfiguration.builder().seed(3)
            .updater(pt.Sgd(0.1)).list()
            .layer(pt.DenseLayer(n_out=12, activation="tanh"))
            .layer(pt.OutputLayer(n_out=3, loss="mcxent"))
            .set_input_type(pt.InputType.feed_forward(6)).build())
    return pt.MultiLayerNetwork(conf, device="cpu").init()


def test_path_iterator_training_equals_in_memory(tmp_path):
    x, y = _data(n=32)
    paths = export_datasets(ArrayDataSetIterator(x, y, batch_size=8),
                            tmp_path)
    m1, m2, m3 = _build(), _build(), _build()
    m1.fit(ArrayDataSetIterator(x, y, batch_size=8), epochs=3)
    m2.fit(PathDataSetIterator(paths), epochs=3)
    np.testing.assert_array_equal(m1.params_flat(), m2.params_flat())
    m3.fit(PathDataSetIterator(paths).async_prefetch(), epochs=3)
    np.testing.assert_array_equal(m1.params_flat(), m3.params_flat())


def test_path_iterator_resume(tmp_path):
    x, y = _data(n=32)
    paths = export_datasets(ArrayDataSetIterator(x, y, batch_size=8),
                            tmp_path)
    it = PathDataSetIterator(paths, start_from=2)
    got = [ds.features for ds in it]
    assert len(got) == 2
    np.testing.assert_array_equal(got[0], x[16:24])
    it.reset()
    assert sum(1 for _ in it) == 4


def test_path_iterator_shuffled_resume_reproducible(tmp_path):
    x, y = _data(n=32)
    paths = export_datasets(ArrayDataSetIterator(x, y, batch_size=8),
                            tmp_path)
    run1 = PathDataSetIterator(paths, shuffle=True, seed=11)
    run1.reset()
    consumed = [run1.next().features for _ in range(2)]
    resumed = PathDataSetIterator(paths, shuffle=True, seed=11, start_from=2)
    feats = consumed + [ds.features for ds in resumed]
    assert len(feats) == 4
    got = np.sort(np.stack([f[0, 0] for f in feats]))
    want = np.sort(np.stack([x[i * 8, 0] for i in range(4)]))
    np.testing.assert_allclose(got, want)
    with pytest.raises(ValueError):
        PathDataSetIterator(paths, shuffle=True, start_from=2)
    # the permutation is JAX's for the same seed
    jorder = jexport.PathDataSetIterator(paths, shuffle=True, seed=11)._order
    assert list(PathDataSetIterator(paths, shuffle=True,
                                    seed=11)._order) == list(jorder)


def test_from_directory_sorts(tmp_path):
    x, y = _data(n=16)
    export_datasets(ArrayDataSetIterator(x, y, batch_size=4), tmp_path)
    cat = np.concatenate([ds.features for ds in
                          PathDataSetIterator.from_directory(tmp_path)])
    np.testing.assert_array_equal(cat, x)


def test_export_sharded_and_shard_selection(tmp_path):
    x, y = _data(n=24)
    paths = export_sharded([pt.DataSet(x, y)], tmp_path, n_shards=4)
    assert [len(p) for p in paths] == [1, 1, 1, 1]
    for k in range(4):
        np.testing.assert_array_equal(load_dataset(paths[k][0]).features,
                                      x[k * 6:(k + 1) * 6])
    all_paths = [p for ps in paths for p in ps]
    got = ShardedPathDataSetIterator(all_paths, shard_index=2).next()
    np.testing.assert_array_equal(got.features, x[12:18])
    assert isinstance(got, LocalShardDataSet) and got.is_local_shard


def test_export_sharded_rejects_ragged(tmp_path):
    x, y = _data(n=10)
    with pytest.raises(ValueError, match="divisible"):
        export_sharded([pt.DataSet(x, y)], tmp_path, n_shards=4)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_exports_cross_the_packages(tmp_path, writer):
    """Either package's exported minibatch and shard files load in the
    other with the same bits (masks included), in the same order."""
    x, y = _data(n=24)
    fm = (np.random.default_rng(1).random((24, 6)) > 0.5).astype(np.float32)
    if writer == "jax":
        paths = jexport.export_datasets(
            [jx.DataSet(x, y, features_mask=fm)], tmp_path, batch_size=8)
        shards = jexport.export_sharded([jx.DataSet(x, y)],
                                        tmp_path / "s", n_shards=2)
        read, read_shard = PathDataSetIterator, ShardedPathDataSetIterator
    else:
        paths = export_datasets([pt.DataSet(x, y, features_mask=fm)],
                                tmp_path, batch_size=8)
        shards = export_sharded([pt.DataSet(x, y)], tmp_path / "s",
                                n_shards=2)
        read = jexport.PathDataSetIterator
        read_shard = jexport.ShardedPathDataSetIterator
    got = list(read(paths))
    np.testing.assert_array_equal(
        np.concatenate([np.asarray(d.features) for d in got]), x)
    np.testing.assert_array_equal(
        np.concatenate([np.asarray(d.features_mask) for d in got]), fm)
    for k in range(2):
        sh = read_shard(shards[k]).next()
        np.testing.assert_array_equal(np.asarray(sh.labels),
                                      y[k * 12:(k + 1) * 12])
        assert getattr(sh, "is_local_shard", False)
