"""PyTorch port, the native C++ data plane (`deeplearning4j_tpu_torch/native/`)
on the CPU, held against the JAX package's native tier.

The twins of `tests/test_native.py` (12) and of the native-decoder cases
of `tests/test_images.py`: each holds the port's function against the
JAX package's native function, and the port's reader against the JAX
package's reader, on the same file (bit for bit). The file also holds
each native function against its plain numpy / PIL version in the port,
and the witnesses of where the port's readers differ from the JAX
package's pure-Python fallback, which the JAX package takes only where
its library does not build:

  * MNIST pixels: the native scaling x * float32(1/255) is one ulp from
    the fallback's x / 255 in 126 of the 256 byte values; the port
    equals the native path;
  * CSV: a non-numeric field reads as 0 (np.loadtxt raises);
  * a truncated binary record file raises IOError (the fallback returns
    early);
  * a failed build, or a library of another ABI, raises NativeBuildError
    with the compiler's output (the JAX package degrades to numpy);

and a prefetch ring closed in the middle of an epoch, whose reader thread
is joined.
"""
import os
import struct
import threading
import time

import numpy as np
import pytest

import deeplearning4j_tpu.native as jnat
from deeplearning4j_tpu.datasets import fetchers as jf
from deeplearning4j_tpu.datasets import images as jimages
from deeplearning4j_tpu.datasets import records as jrec
import deeplearning4j_tpu_torch.native as pnat
from deeplearning4j_tpu_torch.datasets import fetchers as pf
from deeplearning4j_tpu_torch.datasets import images as pimages
from deeplearning4j_tpu_torch.datasets import records as prec
from test_images import _img, write_bmp, write_png, write_ppm
from torch_threads import one_torch_thread  # noqa: F401

# the JAX package's native tier is the reference: it builds on this host
pytestmark = pytest.mark.skipif(not jnat.native_available(),
                                reason="the JAX package's native tier did "
                                       "not build here")


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _write_idx(path, data, code=0x08):
    with open(path, "wb") as f:
        f.write(struct.pack(">BBBB", 0, 0, code, data.ndim))
        for d in data.shape:
            f.write(struct.pack(">i", d))
        f.write(data.tobytes())


def _threads() -> int:
    return len(os.listdir("/proc/self/task"))


# -- the twins of tests/test_native.py ---------------------------------------

def test_native_idx_matches_python(tmp_path):
    r = np.random.default_rng(0)
    data = r.integers(0, 256, (20, 28, 28)).astype(np.uint8)
    p = str(tmp_path / "t.idx")
    _write_idx(p, data)
    a = pnat.idx_read_native(p)
    _eq(a, data)
    _eq(a, jnat.idx_read_native(p))
    _eq(pf.read_idx(p), jf.read_idx(p))
    _eq(pnat.idx_read_plain(p), a)


def test_native_csv_matches_numpy(tmp_path):
    p = str(tmp_path / "t.csv")
    r = np.random.default_rng(1)
    m = np.round(r.normal(size=(40, 7)).astype(np.float32), 4)
    np.savetxt(p, m, delimiter=",", fmt="%.4f")
    got = prec.CSVRecordReader().read_matrix(p)
    _eq(got, jrec.CSVRecordReader().read_matrix(p))
    _eq(got, jnat.csv_read_native(p))
    _eq(got, pnat.csv_read_plain(p))
    np.testing.assert_allclose(got, m, rtol=1e-6)


def test_native_csv_skip_header(tmp_path):
    p = str(tmp_path / "h.csv")
    with open(p, "w") as f:
        f.write("col_a,col_b\n\n1,2\n  \r\n3,4\n")
    got = prec.CSVRecordReader(skip_num_lines=1).read_matrix(p)
    _eq(got, np.array([[1, 2], [3, 4]], np.float32))
    _eq(got, jrec.CSVRecordReader(skip_num_lines=1).read_matrix(p))
    _eq(got, pnat.csv_read_plain(p, 1))


def test_record_reader_dataset_iterator_classification(tmp_path):
    p = str(tmp_path / "iris.csv")
    r = np.random.default_rng(2)
    feats = r.normal(size=(30, 4)).astype(np.float32)
    labels = r.integers(0, 3, 30)
    np.savetxt(p, np.column_stack([feats, labels]), delimiter=",",
               fmt="%.5f")
    kw = dict(batch_size=10, label_index=4, num_classes=3)
    got = list(prec.RecordReaderDataSetIterator(p, **kw))
    want = list(jrec.RecordReaderDataSetIterator(p, **kw))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _eq(g.features, w.features)
        _eq(g.labels, w.labels)
    y = np.concatenate([b.labels for b in got])
    assert (y.argmax(1) == labels).all()


def test_record_reader_regression(tmp_path):
    p = str(tmp_path / "reg.csv")
    m = np.array([[1, 2, 0.5], [3, 4, 1.5]], np.float32)
    np.savetxt(p, m, delimiter=",", fmt="%.2f")
    kw = dict(batch_size=2, label_index=-1, regression=True)
    ds = next(iter(prec.RecordReaderDataSetIterator(p, **kw)))
    jds = next(iter(jrec.RecordReaderDataSetIterator(p, **kw)))
    _eq(ds.features, jds.features)
    _eq(ds.labels, jds.labels)
    np.testing.assert_allclose(ds.labels, m[:, 2:])


def test_prefetch_ring_streams_all_records(tmp_path):
    r = np.random.default_rng(3)
    data = r.integers(0, 256, (101, 64)).astype(np.uint8)
    p = str(tmp_path / "rec.bin")
    with open(p, "wb") as f:
        f.write(b"HDRX")
        f.write(data.tobytes())
    reader = prec.BinaryRecordReader(p, (64,), header_bytes=4)
    assert reader.total_records == 101
    got = list(reader.batches(17))
    want = list(jrec.BinaryRecordReader(p, (64,), header_bytes=4)
                .batches(17))
    assert [len(b) for b in got] == [len(b) for b in want] == [17] * 5 + [16]
    _eq(np.concatenate(got), data)
    _eq(np.concatenate(got), np.concatenate(want))
    plain = list(pnat.binary_batches_plain(p, 64, 101, 17, header_bytes=4))
    _eq(np.concatenate(got), np.concatenate(plain))


def test_binary_record_dataset_iterator_cifar_layout(tmp_path):
    r = np.random.default_rng(4)
    n = 25
    labels = r.integers(0, 10, n).astype(np.uint8)
    feats = r.integers(0, 256, (n, 3072)).astype(np.uint8)
    p = str(tmp_path / "cifar.bin")
    with open(p, "wb") as f:
        for i in range(n):
            f.write(bytes([labels[i]]))
            f.write(feats[i].tobytes())
    kw = dict(feature_shape=(32, 32, 3), num_classes=10, batch_size=8)
    it = prec.BinaryRecordDataSetIterator(p, **kw)
    got = list(it)
    want = list(jrec.BinaryRecordDataSetIterator(p, **kw))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _eq(g.features, w.features)
        _eq(g.labels, w.labels)
    x = np.concatenate([b.features for b in got])
    np.testing.assert_allclose(
        x.reshape(n, -1), feats.astype(np.float32) / 255.0, rtol=1e-6)
    again = np.concatenate([b.features for b in it])     # reset path
    _eq(again, x)


def test_python_fallback_equals_native(tmp_path, monkeypatch):
    """The port's ring equals the JAX package's native ring, its
    pure-Python fallback and the port's plain chunked reads."""
    r = np.random.default_rng(5)
    data = r.integers(0, 256, (33, 16)).astype(np.uint8)
    p = str(tmp_path / "rec.bin")
    with open(p, "wb") as f:
        f.write(data.tobytes())
    port = np.concatenate(list(prec.BinaryRecordReader(p, (16,))
                               .batches(10)))
    native = np.concatenate(list(jrec.BinaryRecordReader(p, (16,))
                                 .batches(10)))
    monkeypatch.setattr(jnat, "native_available", lambda: False)
    fallback = np.concatenate(list(jrec.BinaryRecordReader(p, (16,))
                                   .batches(10)))
    plain = np.concatenate(list(pnat.binary_batches_plain(p, 16, 33, 10)))
    for other in (native, fallback, plain):
        _eq(port, other)


def test_native_idx_rejects_corrupt_headers(tmp_path):
    p = str(tmp_path / "corrupt.idx")
    with open(p, "wb") as f:  # header claims (0xFFFFFF, 0xFFFF, 2), no data
        f.write(struct.pack(">BBBB", 0, 0, 0x08, 3))
        f.write(struct.pack(">iii", 0xFFFFFF, 0xFFFF, 2))
        f.write(b"abc")
    p2 = str(tmp_path / "trailing.idx")
    with open(p2, "wb") as f:  # [3,4] header but 24 payload bytes
        f.write(struct.pack(">BBBB", 0, 0, 0x08, 2))
        f.write(struct.pack(">ii", 3, 4))
        f.write(bytes(range(24)))
    p3 = str(tmp_path / "magic.idx")
    with open(p3, "wb") as f:
        f.write(b"\x12\x34\x56\x78garbage")
    for path in (p, p2, p3):
        for read in (pnat.idx_read_native, jnat.idx_read_native,
                     pnat.idx_read_plain):
            with pytest.raises(ValueError):
                read(path)
    with pytest.raises(ValueError, match="magic"):
        pf.read_idx(p3)


def test_native_idx_int32_dtype_matches_python(tmp_path):
    data = np.arange(24, dtype=">i4").reshape(2, 3, 4)
    p = str(tmp_path / "i32.idx")
    _write_idx(p, data, code=0x0C)
    a = pnat.idx_read_native(p)
    _eq(a, jnat.idx_read_native(p))
    _eq(a, pnat.idx_read_plain(p))
    assert (np.asarray(a, np.int64) == np.asarray(data, np.int64)).all()


def test_native_csv_rejects_ragged_rows(tmp_path):
    p = str(tmp_path / "ragged.csv")
    with open(p, "w") as f:
        f.write("1,2\n3,4,5\n")
    for read in (prec.CSVRecordReader().read_matrix,
                 jrec.CSVRecordReader().read_matrix, pnat.csv_read_plain):
        with pytest.raises(ValueError, match="ragged"):
            read(p)


def test_native_normalize_matches_python_mnist_semantics():
    """u8 binarize threshold 127 == the fetcher's (x / 255 > 0.5); the
    scaling equals the JAX package's native one and the plain x *
    float32(1/255), bit for bit."""
    px = np.arange(256, dtype=np.uint8)
    nb = pnat.u8_to_f32(px, binarize=True, threshold=127)
    _eq(nb, ((px.astype(np.float32) / 255.0) > 0.5).astype(np.float32))
    _eq(nb, jnat.u8_to_f32(px, binarize=True, threshold=127))
    _eq(nb, pnat.u8_to_f32_plain(px, binarize=True, threshold=127))
    nn = pnat.u8_to_f32(px)
    _eq(nn, jnat.u8_to_f32(px))
    _eq(nn, pnat.u8_to_f32_plain(px))
    np.testing.assert_allclose(nn, px.astype(np.float32) / 255.0, rtol=1e-6)
    for scale, shift in ((1 / 127.5, -1.0), (0.5, 0.25), (1.0, 0.0)):
        _eq(pnat.u8_to_f32(px, scale, shift), jnat.u8_to_f32(px, scale,
                                                             shift))
        _eq(pnat.u8_to_f32(px, scale, shift),
            pnat.u8_to_f32_plain(px, scale, shift))


# -- the twins of tests/test_images.py's native-decoder cases -----------------

def _decoders_agree(p, arr=None):
    got = pnat.image_decode_native(p)
    _eq(got, jnat.image_decode_native(p))
    _eq(got, pnat.image_decode_plain(p))
    if arr is not None:
        _eq(got, arr)
    return got


@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("filt", [0, 1, 2])
def test_native_png_decode(tmp_path, c, filt):
    arr = _img(c=c, seed=c * 10 + filt)
    p = str(tmp_path / f"t{c}{filt}.png")
    write_png(p, arr, filter_type=filt)
    _decoders_agree(p, arr)


def test_native_png_matches_pil(tmp_path):
    from PIL import Image

    arr = _img(32, 17, 3, seed=9)
    p = str(tmp_path / "pil.png")
    Image.fromarray(arr).save(p)
    _decoders_agree(p, arr)


def test_native_bmp_decode(tmp_path):
    arr = _img(7, 5, 3, seed=2)
    p = str(tmp_path / "t.bmp")
    write_bmp(p, arr)
    _decoders_agree(p, arr)


@pytest.mark.parametrize("c", [1, 3])
def test_native_pnm_decode(tmp_path, c):
    arr = _img(6, 4, c, seed=3)
    p = str(tmp_path / "t.pnm")
    write_ppm(p, arr)
    _decoders_agree(p, arr)


def test_native_unsupported_falls_back(tmp_path):
    """A format the native tier does not decode returns None in both
    packages; the image reader then opens it with PIL."""
    from PIL import Image

    p = str(tmp_path / "t.jpg")
    open(p, "wb").write(b"\xff\xd8\xff\xe0 not really a jpeg")
    assert pnat.image_decode_native(p) is None
    assert jnat.image_decode_native(p) is None
    q = str(tmp_path / "real.jpg")
    Image.fromarray(_img(8, 8, 3, seed=4)).save(q, quality=90)
    assert pnat.image_decode_native(q) is None
    _eq(pimages._decode(q), jimages._decode(q))
    _eq(pimages.ImageLoader(8, 8, 3).load(q),
        jimages.ImageLoader(8, 8, 3).load(q))


def test_native_corrupt_raises(tmp_path):
    p = str(tmp_path / "t.png")
    write_png(p, _img(4, 4, 3))
    data = open(p, "rb").read()[:40]    # truncated mid-chunk
    open(p, "wb").write(data)
    for decode in (pnat.image_decode_native, jnat.image_decode_native,
                   pimages._decode):
        with pytest.raises(ValueError):
            decode(p)


def test_native_gray_alpha_png_and_loader(tmp_path):
    arr = _img(6, 5, 2, seed=8)
    p = str(tmp_path / "la.png")
    write_png(p, arr)
    _decoders_agree(p, arr)
    out = pimages.ImageLoader(6, 5, 3).load(p)
    _eq(out, jimages.ImageLoader(6, 5, 3).load(p))
    np.testing.assert_allclose(out[:, :, 0] * 255, arr[:, :, 0])


def test_native_hostile_header_rejected(tmp_path):
    import zlib

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    ihdr = struct.pack(">IIBBBBB", 100000, 100000, 8, 2, 0, 0, 0)
    p = str(tmp_path / "huge.png")
    open(p, "wb").write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                        + chunk(b"IDAT", zlib.compress(b"xx"))
                        + chunk(b"IEND", b""))
    for decode in (pnat.image_decode_native, jnat.image_decode_native):
        with pytest.raises(ValueError):
            decode(p)


def test_image_record_reader_takes_the_native_decoders(tmp_path):
    """A directory of PNG / BMP / PGM / JPEG files through the reader and
    iterator equals the JAX package's, batch for batch."""
    from PIL import Image

    for i, label in enumerate(("cat", "dog")):
        d = tmp_path / label
        d.mkdir()
        write_png(str(d / "a.png"), _img(9, 7, 3, seed=i), filter_type=1)
        write_bmp(str(d / "b.bmp"), _img(5, 8, 3, seed=10 + i))
        write_ppm(str(d / "c.pgm"), _img(6, 6, 1, seed=20 + i))
        Image.fromarray(_img(8, 8, 3, seed=30 + i)).save(str(d / "d.jpg"))
    reader = pimages.ImageRecordReader(str(tmp_path), 8, 8, 3)
    jreader = jimages.ImageRecordReader(str(tmp_path), 8, 8, 3)
    assert reader.records == jreader.records
    for b, jb in zip(pimages.ImageRecordDataSetIterator(reader, 3),
                     jimages.ImageRecordDataSetIterator(jreader, 3)):
        _eq(b.features, jb.features)
        _eq(b.labels, jb.labels)


# -- the readers against the JAX package's on the same files ------------------

def test_mnist_fetcher_equals_the_jax_native_path(tmp_path):
    r = np.random.default_rng(6)
    images = r.integers(0, 256, (40, 28, 28), dtype=np.uint8)
    labels = (np.arange(40) % 10).astype(np.uint8)
    _write_idx(str(tmp_path / "train-images-idx3-ubyte"), images)
    _write_idx(str(tmp_path / "train-labels-idx1-ubyte"), labels)
    for kw in ({}, {"binarize": True}, {"shuffle": True, "seed": 3}):
        x, y = pf.MnistDataFetcher(cache=str(tmp_path), **kw).fetch()
        jx, jy = jf.MnistDataFetcher(cache=str(tmp_path), **kw).fetch()
        _eq(x, jx)
        _eq(y, jy)
    x, _ = pf.MnistDataFetcher(cache=str(tmp_path)).fetch()
    _eq(x, pnat.u8_to_f32_plain(images.reshape(40, -1)))


def test_csv_native_against_plain_on_mnist_layout(tmp_path):
    """The MNIST-as-CSV layout (label, 784 pixels) with a header, CRLF
    line ends and blank lines: native, JAX native and plain equal."""
    r = np.random.default_rng(7)
    m = np.concatenate([r.integers(0, 10, (30, 1)),
                        r.integers(0, 256, (30, 784))], axis=1)
    p = str(tmp_path / "mnist.csv")
    with open(p, "w", newline="") as f:
        f.write("label," + ",".join(f"px{i}" for i in range(784)) + "\r\n")
        for i, row in enumerate(m):
            f.write(",".join(str(v) for v in row) + "\r\n")
            if i == 10:
                f.write("\r\n")
    got = pnat.csv_read_native(p, 1)
    _eq(got, m.astype(np.float32))
    _eq(got, jnat.csv_read_native(p, 1))
    _eq(got, pnat.csv_read_plain(p, 1))


# -- the divergences from the JAX package's pure-Python fallback -------------

def test_mnist_scaling_is_the_native_path_not_the_fallback(tmp_path,
                                                          monkeypatch):
    """The JAX package's fallback divides by 255, its native tier (and the
    port) multiplies by float32(1/255): one ulp apart in 126 of the 256
    byte values. The port's fetcher equals JAX's native fetch."""
    px = np.arange(256, dtype=np.uint8)
    native = jnat.u8_to_f32(px)
    fallback = px.astype(np.float32) / 255.0
    differ = native != fallback
    assert int(differ.sum()) == 126
    ulp = np.spacing(fallback[differ])
    assert (np.abs(native[differ] - fallback[differ]) == ulp).all()
    _eq(pnat.u8_to_f32(px), native)

    images = np.tile(px, 784 // 256 + 1)[:784].reshape(1, 28, 28)
    images = np.concatenate([images, images[:, ::-1]])
    _write_idx(str(tmp_path / "train-images-idx3-ubyte"), images)
    _write_idx(str(tmp_path / "train-labels-idx1-ubyte"),
               np.array([3, 4], np.uint8))
    x, _ = pf.MnistDataFetcher(cache=str(tmp_path)).fetch()
    _eq(x, jf.MnistDataFetcher(cache=str(tmp_path)).fetch()[0])
    monkeypatch.setattr(jnat, "native_available", lambda: False)
    jx_fallback, _ = jf.MnistDataFetcher(cache=str(tmp_path)).fetch()
    assert (x != jx_fallback).any()
    np.testing.assert_allclose(x, jx_fallback, rtol=0, atol=6e-8)


def test_csv_non_numeric_field_reads_as_zero(tmp_path, monkeypatch):
    p = str(tmp_path / "words.csv")
    with open(p, "w") as f:
        f.write("1.5,abc,2\n3,,4e1x\n")
    want = np.array([[1.5, 0, 2], [3, 0, 40]], np.float32)
    got = prec.CSVRecordReader().read_matrix(p)
    _eq(got, want)
    _eq(got, jrec.CSVRecordReader().read_matrix(p))
    _eq(got, pnat.csv_read_plain(p))
    monkeypatch.setattr(jnat, "native_available", lambda: False)
    with pytest.raises(ValueError):
        jrec.CSVRecordReader().read_matrix(p)


def test_truncated_binary_file_raises(tmp_path, monkeypatch):
    data = np.random.default_rng(8).integers(0, 256, (10, 12), np.uint8)
    p = str(tmp_path / "short.bin")
    with open(p, "wb") as f:
        f.write(data.tobytes())
    claims = dict(record_shape=(12,), total_records=14)
    with pytest.raises(IOError, match="short read"):
        list(prec.BinaryRecordReader(p, **claims).batches(4))
    with pytest.raises(IOError):
        list(jrec.BinaryRecordReader(p, **claims).batches(4))
    with pytest.raises(IOError, match="short read"):
        list(pnat.binary_batches_plain(p, 12, 14, 4))
    monkeypatch.setattr(jnat, "native_available", lambda: False)
    early = list(jrec.BinaryRecordReader(p, **claims).batches(4))
    assert [len(b) for b in early] == [4, 4]       # the fallback stops


@pytest.fixture
def fresh_port_library(tmp_path, monkeypatch):
    """The port's native module with no library loaded and a build
    directory of its own; everything is put back after the test."""
    monkeypatch.setattr(pnat, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(pnat, "_LIB", None)
    monkeypatch.setattr(pnat, "_ERROR", None)
    monkeypatch.setattr(pnat, "_INFO", {})
    return tmp_path


@pytest.mark.parametrize("fault", ["syntax error", "another ABI"])
def test_failed_build_raises_where_jax_degrades(fresh_port_library,
                                                monkeypatch, fault):
    tmp = fresh_port_library
    src = open(pnat._SRC).read()
    broken = str(tmp / "dl4j_native.cpp")
    if fault == "syntax error":
        src += "\nthis is not C++;\n"
    else:
        src = src.replace("int dl4j_native_abi() { return 2; }",
                          "int dl4j_native_abi() { return 3; }")
    open(broken, "w").write(src)
    monkeypatch.setattr(pnat, "_SRC", broken)
    csv = str(tmp / "a.csv")
    open(csv, "w").write("1,2\n3,4\n")
    match = "this is not C" if fault == "syntax error" else "ABI 3"
    with pytest.raises(pnat.NativeBuildError, match=match):
        pnat.lib()
    assert not pnat.native_available()
    with pytest.raises(pnat.NativeBuildError, match=match):
        prec.CSVRecordReader().read_matrix(csv)     # no numpy fallback
    with pytest.raises(pnat.NativeBuildError):
        pimages._decode(csv)

    # the JAX package, given the same source, degrades to numpy
    monkeypatch.setattr(jnat, "_SRC", broken)
    monkeypatch.setattr(jnat, "_LIB", None)
    monkeypatch.setattr(jnat, "_TRIED", False)
    monkeypatch.setenv("DL4J_TPU_NATIVE_DIR", str(tmp / "jax_build"))
    assert not jnat.native_available()
    _eq(jrec.CSVRecordReader().read_matrix(csv),
        np.array([[1, 2], [3, 4]], np.float32))


def test_build_is_recorded_and_shared_across_processes(fresh_port_library):
    """A build writes its record (which build, zlib or not); a second
    process waits on the lock and loads that library without compiling."""
    import subprocess
    import sys

    info = pnat.build_info()
    assert info["built_here"] and info["build"] in ("zlib", "no zlib")
    assert info["zlib"] == (info["build"] == "zlib")
    assert os.path.basename(info["path"]) == pnat.LIB_NAME
    code = ("import sys, deeplearning4j_tpu_torch.native as n; "
            f"n.BUILD_DIR = {pnat.BUILD_DIR!r}; i = n.build_info(); "
            "print(i.get('built_here', False), i['build'])")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", info["build"]]


# -- the prefetch ring --------------------------------------------------------

def test_ring_closed_mid_epoch_joins_its_thread(tmp_path):
    data = np.random.default_rng(9).integers(0, 256, (4000, 256), np.uint8)
    p = str(tmp_path / "big.bin")
    with open(p, "wb") as f:
        f.write(data.tobytes())
    pnat.lib()
    base = _threads()
    ring = pnat.PrefetchRing(p, 256, 4000, 64, slots=2)
    assert _threads() == base + 1          # the C++ reader thread
    _eq(ring.next_batch(), data[:64])
    t0 = time.perf_counter()
    ring.close()                            # the producer waits on a slot
    assert time.perf_counter() - t0 < 5
    assert _threads() == base
    with pytest.raises(ValueError, match="closed"):
        ring.next_batch()
    ring.close()                            # twice is harmless

    # a consumer that stops early: closing the generator closes the ring
    gen = prec.BinaryRecordReader(p, (256,)).batches(100)
    _eq(next(gen), data[:100])
    assert _threads() == base + 1
    gen.close()
    assert _threads() == base
    # an iterator reset mid-epoch drops its generator, and the ring with it
    it = prec.BinaryRecordDataSetIterator(p, (255,), 256, 50)
    it.next()
    it.reset()
    it.next()
    assert _threads() == base + 1
    del it
    assert _threads() == base


def test_ring_releases_the_gil_while_it_waits(tmp_path):
    """The ring reads a FIFO that this thread fills only while another
    thread is inside the ring's native calls (ring_open waits for the
    writer, ring_next for the C++ reader): a native call that held the
    GIL would stop the writer, and the reader would never finish."""
    import fcntl as _fcntl

    data = np.random.default_rng(10).integers(0, 256, (300, 512), np.uint8)
    fifo = str(tmp_path / "pipe")
    os.mkfifo(fifo)
    out = {}

    def consume():
        try:
            out["data"] = np.concatenate(list(
                prec.BinaryRecordReader(fifo, (512,), total_records=300)
                .batches(64)))
        except BaseException as e:      # reported below
            out["error"] = e

    pnat.lib()
    t = threading.Thread(target=consume, daemon=True)
    t.start()
    deadline = time.monotonic() + 30
    while True:     # the reader's fopen is waiting in a native call
        try:
            fd = os.open(fifo, os.O_WRONLY | os.O_NONBLOCK)
            break
        except OSError:
            assert time.monotonic() < deadline, "the ring never opened"
            time.sleep(0.01)
    _fcntl.fcntl(fd, _fcntl.F_SETFL, 0)
    with os.fdopen(fd, "wb") as w:
        for i in range(0, 300, 30):
            w.write(data[i:i + 30].tobytes())
            w.flush()
            time.sleep(0.005)
    t.join(30)
    assert not t.is_alive() and "error" not in out, out.get("error")
    _eq(out["data"], data)


def test_ring_rejects_an_empty_batch(tmp_path):
    p = str(tmp_path / "x.bin")
    open(p, "wb").write(b"\0" * 32)
    with pytest.raises(ValueError):
        pnat.PrefetchRing(p, 8, 4, 0)
    with pytest.raises(OSError):
        pnat.PrefetchRing(str(tmp_path / "missing.bin"), 8, 4, 2)
