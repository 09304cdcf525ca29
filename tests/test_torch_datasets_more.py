"""PyTorch port, the offline data side on the CPU against the JAX package:
MultiDataSet and the iterators (Existing, Iterator, MultipleEpochs,
Sampling), the fetchers (bundled digits and their stratified split and
augmentation, IDX, MNIST / CIFAR-10 / LFW over a local cache, Iris,
Curves), the CSV and binary record readers, the image record reader and
LabeledPoint ingestion: the twins of the JAX package's
`tests/test_datasets.py`, `tests/test_images.py` (its native-decoder
cases are twinned in `tests/test_torch_native.py`) and the labeled-point
cases of `tests/test_timesource_labeledpoint.py`.

Every file a case reads is written by the test itself (IDX, CIFAR binary
batches, CSV, PNG and JPEG images, an LFW tree). Both packages read the
same files and must give equal arrays (exactly where both run the same
numpy or native arithmetic, MNIST's byte scaling included: both packages
scale in their native tiers; image resizing within 1e-6).
Nothing is downloaded: a cache miss raises FileNotFoundError in the port.
"""
import gzip
import os
import struct
import tarfile

import numpy as np
import pytest

from deeplearning4j_tpu.datasets import fetchers as jf
from deeplearning4j_tpu.datasets import images as jimages
from deeplearning4j_tpu.datasets import iterators as jit
from deeplearning4j_tpu.datasets import labeled_point as jlp
from deeplearning4j_tpu.datasets import records as jrec
from deeplearning4j_tpu_torch import (InputType, MultiLayerNetwork,
                                      NeuralNetConfiguration)
from deeplearning4j_tpu_torch import datasets as pd
from deeplearning4j_tpu_torch.datasets import fetchers as pf
from deeplearning4j_tpu_torch.datasets import images as pimages
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.updaters import Sgd
from torch_threads import one_torch_thread  # noqa: F401


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _batches(it):
    it.reset()
    out = []
    while it.has_next():
        out.append(it.next())
    return out


def _same_batches(port_it, jax_it):
    pb, jb = _batches(port_it), _batches(jax_it)
    assert len(pb) == len(jb) > 0
    for p, j in zip(pb, jb):
        _eq(p.features, j.features)
        if j.labels is not None:
            _eq(p.labels, j.labels)


def _write_idx(path, arr, gz=True):
    head = struct.pack(">HBB", 0, 0x08, arr.ndim) + struct.pack(
        ">" + "I" * arr.ndim, *arr.shape)
    with (gzip.open(path, "wb") if gz else open(path, "wb")) as f:
        f.write(head + arr.astype(np.uint8).tobytes())


def _fake_mnist(cache, n=50, gz=True):
    r = np.random.default_rng(0)
    images = r.integers(0, 256, (n, 28, 28), dtype=np.uint8)
    labels = (np.arange(n) % 10).astype(np.uint8)
    ext = ".gz" if gz else ""
    _write_idx(os.path.join(cache, "train-images-idx3-ubyte" + ext), images,
               gz)
    _write_idx(os.path.join(cache, "train-labels-idx1-ubyte" + ext), labels,
               gz)
    return images, labels


# ---------------------------------------------------------------------------
# iterators
# ---------------------------------------------------------------------------
def _ds_list(n=5, rows=3, seed=0):
    r = np.random.default_rng(seed)
    return [(r.normal(size=(rows, 4)).astype(np.float32),
             np.eye(2, dtype=np.float32)[r.integers(0, 2, rows)])
            for _ in range(n)]


def test_existing_and_iterator_data_set_iterators_match_jax():
    pairs = _ds_list()
    pds = [pd.DataSet(x, y) for x, y in pairs]
    jds = [jit.DataSet(x, y) for x, y in pairs]
    _same_batches(pd.ExistingDataSetIterator(pds),
                  jit.ExistingDataSetIterator(jds))
    assert pd.ExistingDataSetIterator(pds).batch() == -1
    for b in (2, 4, 7, 20):
        p = pd.IteratorDataSetIterator(pd.ListDataSetIterator(pds), b)
        j = jit.IteratorDataSetIterator(jit.ListDataSetIterator(jds), b)
        _same_batches(p, j)
        assert [d.num_examples() for d in _batches(p)] == \
            [d.num_examples() for d in _batches(j)]


def test_multiple_epochs_and_sampling_iterators_match_jax():
    x = np.arange(40, dtype=np.float32).reshape(10, 4)
    y = np.eye(2, dtype=np.float32)[np.arange(10) % 2]
    p = pd.MultipleEpochsIterator(3, pd.ArrayDataSetIterator(x, y,
                                                             batch_size=4))
    j = jit.MultipleEpochsIterator(3, jit.ArrayDataSetIterator(
        x, y, batch_size=4, shuffle=False))
    _same_batches(p, j)
    assert len(_batches(p)) == 9 and p.batch() == 4
    p = pd.SamplingDataSetIterator(pd.DataSet(x, y), 5, 6, seed=3)
    j = jit.SamplingDataSetIterator(jit.DataSet(x, y), 5, 6, seed=3)
    _same_batches(p, j)
    assert len(_batches(p)) == 6


def test_multi_data_set_holds_inputs_and_outputs():
    x1, x2 = np.zeros((3, 2)), np.ones((3, 5))
    m = pd.MultiDataSet([x1, x2], [np.zeros((3, 1))])
    assert m.num_examples() == 3 and m.features_masks is None
    assert m.num_examples() == jit.MultiDataSet([x1, x2], []).num_examples()


# ---------------------------------------------------------------------------
# fetchers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("gz", [True, False])
def test_read_idx_matches_jax_and_rejects_garbage(tmp_path, gz):
    arr = np.arange(2 * 5 * 3, dtype=np.uint8).reshape(2, 5, 3)
    p = str(tmp_path / ("x.idx.gz" if gz else "x.idx"))
    _write_idx(p, arr, gz)
    _eq(pf.read_idx(p), arr)
    _eq(pf.read_idx(p), jf.read_idx(p))
    bad = str(tmp_path / "bad.idx")
    open(bad, "wb").write(b"\x12\x34\x56\x78garbage")
    with pytest.raises(ValueError, match="magic"):
        pf.read_idx(bad)


@pytest.mark.parametrize("binarize", [False, True])
def test_mnist_fetcher_and_iterator_read_the_cache_as_jax(tmp_path,
                                                          binarize):
    cache = str(tmp_path)
    _, labels = _fake_mnist(cache, gz=not binarize)
    # bit for bit: both packages scale the bytes in their native tiers
    # (times float32(1/255))
    x, y = pf.MnistDataFetcher(binarize=binarize, cache=cache).fetch()
    jx, jy = jf.MnistDataFetcher(binarize=binarize, cache=cache).fetch()
    _eq(x, jx)
    _eq(y, jy)
    _eq(y.argmax(1), labels)
    xs, _ = pf.MnistDataFetcher(shuffle=True, seed=4, cache=cache).fetch()
    jxs, _ = jf.MnistDataFetcher(shuffle=True, seed=4, cache=cache).fetch()
    _eq(xs, jxs)
    it = pd.MnistDataSetIterator(batch_size=16, num_examples=40,
                                 cache=cache)
    assert [b.num_examples() for b in _batches(it)] == [16, 16, 8]


def test_cache_misses_raise_without_downloading(tmp_path):
    for fetcher, what in ((pf.MnistDataFetcher(cache=str(tmp_path)),
                           "MNIST"),
                          (pf.CifarDataFetcher(cache=str(tmp_path)),
                           "CIFAR-10"),
                          (pf.LFWDataFetcher(cache=str(tmp_path)), "LFW")):
        with pytest.raises(FileNotFoundError, match=what):
            fetcher.fetch()
    assert not hasattr(pf, "_download")
    src = open(pf.__file__).read()
    assert "urllib" not in src and "http" not in src


def test_data_dir_reads_the_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path))
    assert pf.data_dir("mnist") == jf.data_dir("mnist") == str(
        tmp_path / "mnist")
    assert os.path.isdir(tmp_path / "mnist")


def _cifar_batches(cache, n_per=8, names=None):
    r = np.random.default_rng(1)
    names = names or [f"data_batch_{i}.bin" for i in range(1, 6)]
    for name in names:
        rec = np.zeros((n_per, 3073), dtype=np.uint8)
        rec[:, 0] = r.integers(0, 10, n_per)
        rec[:, 1:] = r.integers(0, 256, (n_per, 3072))
        open(os.path.join(cache, name), "wb").write(rec.tobytes())


def test_cifar_fetcher_reads_binary_batches_as_jax(tmp_path):
    cache = str(tmp_path)
    _cifar_batches(cache)
    x, y = pf.CifarDataFetcher(cache=cache).fetch()
    jx, jy = jf.CifarDataFetcher(cache=cache).fetch()
    assert x.shape == (40, 32, 32, 3)
    _eq(x, jx)
    _eq(y, jy)
    it = pd.CifarDataSetIterator(batch_size=16, cache=cache)
    assert it.next().features.shape == (16, 32, 32, 3)


def test_cifar_tarball_in_the_cache_is_extracted(tmp_path):
    src = tmp_path / "src" / "cifar-10-batches-bin"
    src.mkdir(parents=True)
    _cifar_batches(str(src), n_per=3, names=["test_batch.bin"])
    cache = tmp_path / "cache"
    cache.mkdir()
    with tarfile.open(cache / "cifar-10-binary.tar.gz", "w:gz") as tf:
        tf.add(str(src), arcname="cifar-10-batches-bin")
    x, y = pf.CifarDataFetcher(train=False, cache=str(cache)).fetch()
    jx, _ = jf.CifarDataFetcher(train=False, cache=str(cache)).fetch()
    assert x.shape == (3, 32, 32, 3)
    _eq(x, jx)


def test_iris_matches_jax_and_trains():
    for kw in ({}, {"shuffle": True, "seed": 2}, {"normalize": False}):
        _eq(pf.IrisDataFetcher(**kw).fetch()[0],
            jf.IrisDataFetcher(**kw).fetch()[0])
    _eq(pf.IRIS_LABELS, jf.IRIS_LABELS)
    conf = (NeuralNetConfiguration.builder().seed(0).updater(Sgd(0.1))
            .list().layer(DenseLayer(n_out=10, activation="tanh"))
            .layer(OutputLayer(n_out=3, loss="mcxent"))
            .set_input_type(InputType.feed_forward(4)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    it = pd.IrisDataSetIterator(batch_size=30)
    net.fit(it, epochs=40)
    assert net.evaluate(it).accuracy() > 0.9


def test_curves_bundled_splits_and_augmentation_match_jax():
    x, y = pf.CurvesDataFetcher(n_examples=32, seed=5).fetch()
    _eq(x, jf.CurvesDataFetcher(n_examples=32, seed=5).fetch()[0])
    assert x.shape == (32, 784) and (x == y).all() and x.max() > 0.5
    for a, b in zip(pf.bundled_mnist_subset(300, seed=1),
                    jf.bundled_mnist_subset(300, seed=1)):
        _eq(a, b)
    strat = pf.bundled_mnist_stratified(test_per_class=3, seed=2)
    for a, b in zip(strat, jf.bundled_mnist_stratified(test_per_class=3,
                                                       seed=2)):
        _eq(a, b)
    assert (np.bincount(strat[3], minlength=10) == 3).all()
    ax, ay = pf.augment_digits(strat[0][:4], strat[1][:4], n_aug=2, seed=3)
    jx, jy = jf.augment_digits(strat[0][:4], strat[1][:4], n_aug=2, seed=3)
    assert ax.shape == (12, 784)
    np.testing.assert_allclose(ax, jx, rtol=0, atol=1e-6)
    _eq(ay, jy)


def _lfw_tree(tmp_path, people):
    from PIL import Image
    r = np.random.default_rng(0)
    for person, n in people.items():
        d = tmp_path / "lfw" / person
        d.mkdir(parents=True)
        for i in range(n):
            Image.fromarray(r.integers(0, 256, (30, 24, 3)).astype(np.uint8)
                            ).save(str(d / f"{person}_{i:04d}.jpg"))


def test_lfw_fetcher_reads_person_directories_as_jax(tmp_path):
    _lfw_tree(tmp_path, {"Ada_Lovelace": 3, "Alan_Turing": 2,
                         "Grace_Hopper": 1})
    for kw in ({}, {"num_labels": 2}, {"min_images_per_person": 2}):
        f = pf.LFWDataFetcher(image_size=16, cache=str(tmp_path), **kw)
        j = jf.LFWDataFetcher(image_size=16, cache=str(tmp_path), **kw)
        x, y = f.fetch()
        jx, jy = j.fetch()
        np.testing.assert_allclose(x, jx, rtol=0, atol=1e-6)
        _eq(y, jy)
        assert f.labels() == j.labels() and y.shape[1] == len(f.labels())
    assert pf.LFWDataFetcher(image_size=16, num_labels=2,
                             cache=str(tmp_path)).labels() == [
        "Ada_Lovelace", "Alan_Turing"]


# ---------------------------------------------------------------------------
# record readers, images, labeled points
# ---------------------------------------------------------------------------
def test_csv_record_reader_and_iterator_match_jax(tmp_path):
    r = np.random.default_rng(0)
    m = np.concatenate([r.normal(size=(11, 3)),
                        r.integers(0, 3, (11, 1))], axis=1)
    path = str(tmp_path / "d.csv")
    with open(path, "w") as f:
        f.write("a,b,c,label\n")
        for row in m:
            f.write(",".join(f"{v:.6f}" for v in row) + "\n")
    reader = pd.CSVRecordReader(skip_num_lines=1)
    _eq(reader.read_matrix(path),
        jrec.CSVRecordReader(skip_num_lines=1).read_matrix(path))
    for kw in ({"label_index": 3, "num_classes": 3},
               {"label_index": -1, "regression": True},
               {"label_index": 0, "regression": True, "label_count": 2}):
        _same_batches(
            pd.RecordReaderDataSetIterator(path, 4, reader=reader, **kw),
            jrec.RecordReaderDataSetIterator(
                path, 4, reader=jrec.CSVRecordReader(skip_num_lines=1),
                **kw))
    with pytest.raises(ValueError, match="num_classes"):
        pd.RecordReaderDataSetIterator(path, 4, 3, reader=reader)


def test_binary_record_iterator_matches_jax(tmp_path):
    r = np.random.default_rng(2)
    rec = np.zeros((10, 2 + 12), np.uint8)
    rec[:, :2] = r.integers(0, 4, (10, 2))
    rec[:, 2:] = r.integers(0, 256, (10, 12))
    path = str(tmp_path / "b.bin")
    open(path, "wb").write(b"HEAD" + rec.tobytes())
    for idx in (None, 0):
        kw = dict(feature_shape=(2, 2, 3), num_classes=4, batch_size=4,
                  label_bytes=2, header_bytes=4, label_byte_index=idx)
        _same_batches(pd.BinaryRecordDataSetIterator(path, **kw),
                      jrec.BinaryRecordDataSetIterator(path, **kw))
    reader = pd.BinaryRecordReader(path, (14,), header_bytes=4)
    assert reader.total_records == 10
    assert [b.shape[0] for b in reader.batches(4)] == [4, 4, 2]
    with pytest.raises(ValueError, match="label_byte_index"):
        pd.BinaryRecordDataSetIterator(path, (12,), 4, 4, label_bytes=2,
                                       label_byte_index=2)


def test_resize_and_loader_channel_adaptation_match_jax(tmp_path):
    from PIL import Image
    r = np.random.default_rng(3)
    img = r.integers(0, 256, (13, 9, 3)).astype(np.uint8)
    for h, w in ((13, 9), (7, 5), (20, 30)):
        np.testing.assert_allclose(pimages._resize_bilinear(img, h, w),
                                   jimages._resize_bilinear(img, h, w),
                                   rtol=0, atol=1e-6)
    cases = {"rgb.png": img, "gray.png": img[:, :, 0],
             "rgba.png": np.concatenate([img, img[:, :, :1]], axis=2)}
    for name, arr in cases.items():
        path = str(tmp_path / name)
        Image.fromarray(arr).save(path)
        for c in (1, 3):
            got = pd.ImageLoader(8, 6, c).load(path)
            want = jimages.ImageLoader(8, 6, c).load(path)
            assert got.shape == (8, 6, c)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_image_record_reader_and_iterator_match_jax(tmp_path):
    from PIL import Image
    r = np.random.default_rng(4)
    for label in ("cat", "dog", "emu"):
        d = tmp_path / label
        d.mkdir()
        for i in range(3):
            Image.fromarray(r.integers(0, 256, (10, 12, 3)).astype(np.uint8)
                            ).save(str(d / f"{i}.png"))
    (tmp_path / "dog" / "notes.txt").write_text("not an image")
    reader = pd.ImageRecordReader(str(tmp_path), 8, 8, 3)
    jreader = jimages.ImageRecordReader(str(tmp_path), 8, 8, 3)
    assert reader.labels == jreader.labels == ["cat", "dog", "emu"]
    assert len(reader.records) == 9
    for shuffle in (False, True):
        p = pd.ImageRecordDataSetIterator(reader, 4, shuffle=shuffle, seed=1)
        j = jimages.ImageRecordDataSetIterator(jreader, 4, shuffle=shuffle,
                                               seed=1)
        pb, jb = _batches(p), _batches(j)
        for a, b in zip(pb, jb):
            np.testing.assert_allclose(a.features, b.features, rtol=0,
                                       atol=1e-6)
            _eq(a.labels, b.labels)
    assert p.total_outcomes() == 3
    with pytest.raises(ValueError, match="no label subdirectories"):
        pd.ImageRecordReader(str(tmp_path / "cat"), 8, 8)


def test_labeled_points_dense_sparse_and_fit():
    dense = pd.LabeledPoint(1.0, np.array([1.0, 0.0, 2.0], np.float32))
    sparse = pd.LabeledPoint(0.0, ([0, 2], [1.0, 2.0], 3))
    _eq(dense.dense(), sparse.dense())
    for n in (2, None):
        a = pd.labeled_points_to_dataset([dense, sparse], n_classes=n)
        b = jlp.labeled_points_to_dataset(
            [jlp.LabeledPoint(1.0, dense.features),
             jlp.LabeledPoint(0.0, sparse.features)], n_classes=n)
        _eq(a.features, b.features)
        _eq(a.labels, b.labels)
    r = np.random.default_rng(0)
    pts = []
    for _ in range(64):
        c = int(r.integers(0, 2))
        pts.append(pd.LabeledPoint(c, (r.normal(size=3) + 2 * c)
                                   .astype(np.float32)))
    conf = (NeuralNetConfiguration.builder().seed(0).updater(Sgd(0.2))
            .list().layer(DenseLayer(n_out=8, activation="tanh"))
            .layer(OutputLayer(n_out=2, loss="mcxent"))
            .set_input_type(InputType.feed_forward(3)).build())
    m = MultiLayerNetwork(conf, device="cpu").init()
    it = pd.LabeledPointDataSetIterator(pts, batch_size=16, n_classes=2)
    m.fit(it, epochs=20)
    assert m.evaluate(it).accuracy() > 0.9
    with pytest.raises(ValueError, match="outside"):
        pd.labeled_points_to_dataset([pd.LabeledPoint(5.0, np.zeros(2))],
                                     n_classes=2)
    for idx in ([-1], [3]):
        with pytest.raises(ValueError, match="sparse indices"):
            pd.LabeledPoint(1.0, (idx, [5.0], 3)).dense()
