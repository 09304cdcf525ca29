"""PyTorch port, streaming on the CPU: the twins of
`tests/test_aux_surface.py`'s streaming and Keras-backend tests (the serde,
TCP publisher / consumer, the three FileTopic tests, the InferenceRoute,
the Keras backend server's /fit and /output, the HDF5 minibatch iterator),
and the bytes crossing the packages: serde bytes, messages on the wire
(a JAX publisher feeding the port's route and the reverse) and topic logs
written by one package and read, recovered and appended by the other.

Tolerances: bytes and topic records exactly; the port's route outputs
against JAX's route on the same zip at 1e-5; the Keras backend server's fit
(the same Keras file, the same HDF5 minibatches, JAX's default updater)
against JAX's server at 1e-4 in score and outputs.
"""
import json
import os
import struct
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import streaming as jstream
from deeplearning4j_tpu.streaming import topic as jtopic
from deeplearning4j_tpu_torch import (Adam, DenseLayer, InputType,
                                      ModelSerializer, MultiLayerNetwork,
                                      NeuralNetConfiguration, OutputLayer)
from deeplearning4j_tpu_torch.streaming import (InferenceRoute,
                                                NDArrayConsumer,
                                                NDArrayPublisher,
                                                NDArraySerde)
from deeplearning4j_tpu_torch.streaming.topic import (FileTopic,
                                                      TopicConsumer,
                                                      TopicPublisher)
from torch_threads import one_torch_thread, pinned  # noqa: F401

ROUTE_TOL = 1e-5
FIT_TOL = 1e-4


# ------------------------------ serde / TCP --------------------------------
@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "uint8",
                                   "bool"])
def test_ndarray_serde_roundtrip(dtype):
    a = (np.random.default_rng(0).normal(size=(3, 4)) * 10).astype(dtype)
    data = NDArraySerde.to_bytes(a)
    b = NDArraySerde.from_bytes(data)
    np.testing.assert_array_equal(a, b)
    assert b.dtype == a.dtype
    # the same bytes as JAX's serde, both ways
    assert data == jstream.NDArraySerde.to_bytes(a)
    np.testing.assert_array_equal(jstream.NDArraySerde.from_bytes(data), a)


def test_publisher_consumer_roundtrip():
    with NDArrayConsumer() as consumer:
        with NDArrayPublisher(consumer.host, consumer.port) as pub:
            a = np.arange(12, dtype=np.float32).reshape(3, 4)
            pub.publish(a)
            pub.publish(a * 2)
            got1 = consumer.take(timeout=5)
            got2 = consumer.take(timeout=5)
        # a JAX publisher speaks the same wire format to the port's consumer
        with jstream.NDArrayPublisher(consumer.host, consumer.port) as jpub:
            jpub.publish(a * 3)
            got3 = consumer.take(timeout=5)
    np.testing.assert_array_equal(got1, a)
    np.testing.assert_array_equal(got2, a * 2)
    np.testing.assert_array_equal(got3, a * 3)
    with jstream.NDArrayConsumer() as jconsumer:
        with NDArrayPublisher(jconsumer.host, jconsumer.port) as pub:
            pub.publish(a * 4)
            np.testing.assert_array_equal(jconsumer.take(timeout=5), a * 4)


# ------------------------------ FileTopic ----------------------------------
def test_file_topic_produce_crash_reconsume(tmp_path):
    """Durable topic with committed offsets: a restarted consumer resumes
    from its committed offset and gets the uncommitted record again (at
    least once); a restarted producer appends at the right offset."""
    arrays = [np.full((2, 3), i, np.float32) for i in range(5)]
    topic = FileTopic(tmp_path, "t")
    pub = TopicPublisher(topic)
    for a in arrays[:3]:
        pub.publish(a)

    c = TopicConsumer(topic, group="g1")
    np.testing.assert_array_equal(c.take(timeout=1), arrays[0])
    np.testing.assert_array_equal(c.take(timeout=1), arrays[1])
    c.commit()
    np.testing.assert_array_equal(c.take(timeout=1), arrays[2])

    topic2 = FileTopic(tmp_path, "t")
    c2 = TopicConsumer(topic2, group="g1")
    np.testing.assert_array_equal(c2.take(timeout=1), arrays[2])
    assert c2.take(timeout=0.05) is None
    pub2 = TopicPublisher(topic2)
    assert pub2.publish(arrays[3]) == 3
    np.testing.assert_array_equal(c2.take(timeout=1), arrays[3])
    c3 = TopicConsumer(topic2, group="g2", from_beginning=True)
    np.testing.assert_array_equal(c3.take(timeout=1), arrays[0])
    # JAX's consumer in the same group resumes from the port's commit
    jc = jtopic.TopicConsumer(jtopic.FileTopic(tmp_path, "t"), group="g1")
    np.testing.assert_array_equal(jc.take(timeout=1), arrays[2])


def test_file_topic_segment_roll_and_torn_tail(tmp_path):
    """Tiny segments force rolls; a torn final record is dropped on open
    and truncated by the next writer."""
    topic = FileTopic(tmp_path, "t", segment_bytes=64)
    payloads = [bytes([i]) * 40 for i in range(6)]
    for p in payloads:
        topic.append(p)
    assert len(topic._segments()) > 1
    assert [topic.read(i) for i in range(6)] == payloads
    topic.append(b"z" * 40)
    base, last = topic._segments()[-1]
    with open(last, "r+b") as f:
        f.truncate(os.path.getsize(last) - 13)
    reopened = FileTopic(tmp_path, "t", segment_bytes=64)
    assert reopened.end_offset() == 6
    assert reopened.append(b"w" * 8) == 6
    assert reopened.read(6) == b"w" * 8
    # the same segment files and records through JAX's reader
    jt = jtopic.FileTopic(tmp_path, "t", segment_bytes=64)
    assert jt._segments() == reopened._segments()
    assert [jt.read(i) for i in range(7)] == payloads + [b"w" * 8]


@pytest.mark.parametrize("first", ["port", "jax"])
def test_file_topic_sequential_writer_handoff(tmp_path, first):
    """Writers over one directory, one at a time, re-sync their cursor
    before appending: no duplicate offsets, whichever package writes."""
    make = {"port": FileTopic, "jax": jtopic.FileTopic}
    other = "jax" if first == "port" else "port"
    a = make[first](tmp_path, "t")
    b = make[other](tmp_path, "t")   # opened before a appended anything
    c = FileTopic(tmp_path, "t")
    offs = [a.append(b"a0"), a.append(b"a1"),
            b.append(b"b0"),
            a.append(b"a2"),
            c.append(b"c0")]
    assert offs == [0, 1, 2, 3, 4]
    want = [b"a0", b"a1", b"b0", b"a2", b"c0"]
    for t in (a, b, c):
        assert [t.read(i) for i in range(5)] == want


def test_file_topic_torn_tail_recovered_across_packages(tmp_path):
    """A JAX producer's torn tail: the port's reader leaves it, the port's
    writer truncates it; arrays published by either read in both."""
    jt = jtopic.FileTopic(tmp_path, "t")
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    jtopic.TopicPublisher(jt).publish(a)
    seg = jt._segments()[-1][1]
    good = os.path.getsize(seg)
    with open(seg, "ab") as f:
        f.write(struct.pack(">Q", 1 << 20) + b"partial")
    size = os.path.getsize(seg)
    t = FileTopic(tmp_path, "t")
    assert t.end_offset() == 1 and os.path.getsize(seg) == size
    assert TopicPublisher(t).publish(a * 2) == 1
    assert os.path.getsize(seg) == 2 * good     # tail cut, record appended
    jc = jtopic.TopicConsumer(jtopic.FileTopic(tmp_path, "t"),
                              from_beginning=True)
    c = TopicConsumer(FileTopic(tmp_path, "t"), from_beginning=True)
    for want in (a, a * 2):
        np.testing.assert_array_equal(jc.take(timeout=1), want)
        np.testing.assert_array_equal(c.take(timeout=1), want)
    assert jc.take(timeout=0.05) is None and c.take(timeout=0.05) is None


# ------------------------------ InferenceRoute -----------------------------
def _small_net(n_in=6, n_out=3, seed=0):
    conf = (NeuralNetConfiguration.builder().seed(seed).updater(Adam(1e-2))
            .list()
            .layer(DenseLayer(n_out=8, activation="relu"))
            .layer(OutputLayer(n_out=n_out, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.feed_forward(n_in)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def test_inference_route_serves_model_outputs(tmp_path):
    """Zip -> route -> consume input arrays -> publish model outputs; a JAX
    publisher feeds the port's route, the port's route feeds a JAX sink,
    and JAX's route on the same zip gives the same outputs."""
    net = _small_net()
    path = str(tmp_path / "m.zip")
    ModelSerializer.write_model(net, path)
    x = np.random.default_rng(1).normal(size=(5, 6)).astype(np.float32)

    with jstream.NDArrayConsumer() as sink:
        route = InferenceRoute(path, device="cpu",
                               forward=NDArrayPublisher(sink.host,
                                                        sink.port))
        route.start()
        try:
            with jstream.NDArrayPublisher("127.0.0.1", route.port) as pub:
                pub.publish(x)
                pub.publish(np.zeros((2, 4), np.float32))   # a bad batch
                pub.publish(x[:1])
            out = sink.take(timeout=10)
            out1 = sink.take(timeout=10)
        finally:
            route.stop()
    assert out is not None and out.shape == (5, 3) and out.dtype == np.float32
    assert out1 is not None and out1.shape == (1, 3)
    np.testing.assert_allclose(out, net.output(x).numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(out.sum(1), 1.0, rtol=1e-4)
    jroute = jstream.InferenceRoute(path)
    np.testing.assert_allclose(out, jroute.process(x), rtol=ROUTE_TOL,
                               atol=ROUTE_TOL)
    np.testing.assert_allclose(route.process(x[:1]), out1, rtol=0, atol=0)
    jroute.consumer.close()
    assert route.model.device == torch.device("cpu")


# --------------------------- keras backend server --------------------------
@pytest.fixture(scope="module")
def keras_model(tmp_path_factory):
    """A Keras MLP (5 -> 8 relu -> 3 softmax) saved once, and three HDF5
    minibatch files."""
    keras = pytest.importorskip("keras")
    import h5py
    d = tmp_path_factory.mktemp("kbs")
    with pinned():
        keras.backend.set_floatx("float32")
        model = keras.Sequential([
            keras.layers.Input((5,)),
            keras.layers.Dense(8, activation="relu"),
            keras.layers.Dense(3, activation="softmax"),
        ])
        model.compile(loss="categorical_crossentropy", optimizer="adam")
        mpath = str(d / "model.h5")
        model.save(mpath)
    r = np.random.default_rng(0)
    data_dir = d / "batches"
    data_dir.mkdir()
    for i in range(3):
        with h5py.File(str(data_dir / f"batch_{i}.h5"), "w") as f:
            f.create_dataset("features",
                             data=r.normal(size=(16, 5)).astype(np.float32))
            f.create_dataset(
                "labels",
                data=np.eye(3, dtype=np.float32)[r.integers(0, 3, 16)])
    return mpath, str(data_dir)


def _post(base, path, body, timeout=120):
    req = urllib.request.Request(base + path, json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.load(resp)


def test_keras_backend_server_fit_and_output(keras_model):
    """/ping, /fit for 2 epochs over 3 HDF5 minibatches, /output: the
    port's server against JAX's on the same files."""
    from deeplearning4j_tpu.modelimport.server import \
        KerasBackendServer as JaxServer
    from deeplearning4j_tpu_torch.modelimport.server import (
        KerasBackendServer)

    mpath, data_dir = keras_model
    feats = np.random.default_rng(5).normal(size=(2, 5)).tolist()
    results = {}
    for lib, cls in (("port", KerasBackendServer), ("jax", JaxServer)):
        srv = (cls(device="cpu") if lib == "port" else cls()).start()
        try:
            base = f"http://{srv.host}:{srv.port}"
            with urllib.request.urlopen(base + "/ping", timeout=10) as resp:
                assert json.load(resp)["status"] == "ok"
            before = np.asarray(_post(base, "/output", {
                "model": mpath, "features": feats})["output"])
            out = _post(base, "/fit", {"model": mpath, "data_dir": data_dir,
                                       "epochs": 2})
            assert out["status"] == "ok" and out["iterations"] == 6
            preds = np.asarray(_post(base, "/output", {
                "model": mpath, "features": feats})["output"])
            assert preds.shape == (2, 3)
            np.testing.assert_allclose(preds.sum(1), 1.0, rtol=1e-4)
            assert srv.registry.get(mpath).version == 2   # fit swapped it
            results[lib] = (before, out["score"], preds)
        finally:
            srv.stop()
    (b, s, p), (jb, js, jp) = results["port"], results["jax"]
    np.testing.assert_allclose(b, jb, rtol=1e-5, atol=1e-5)
    assert abs(s - js) <= FIT_TOL
    np.testing.assert_allclose(p, jp, rtol=FIT_TOL, atol=FIT_TOL)
    assert not np.allclose(b, p)                 # the fit moved the model


def test_hdf5_minibatch_iterator_requires_files(tmp_path):
    from deeplearning4j_tpu_torch.modelimport.server import (
        HDF5MiniBatchDataSetIterator)
    with pytest.raises(FileNotFoundError):
        HDF5MiniBatchDataSetIterator(str(tmp_path))


def test_hdf5_minibatch_iterator_and_reader(keras_model):
    """Sorted files, features and labels as float32, the batch size from
    the first file; the reader falls back to the first dataset."""
    from deeplearning4j_tpu.modelimport.server import \
        HDF5MiniBatchDataSetIterator as JaxIt
    from deeplearning4j_tpu_torch.modelimport.server import (
        HDF5MiniBatchDataSetIterator, NDArrayHDF5Reader)

    _, data_dir = keras_model
    it, jit = HDF5MiniBatchDataSetIterator(data_dir), JaxIt(data_dir)
    assert it.batch() == jit.batch() == 16
    n = 0
    while it.has_next():
        ds, jds = it.next(), jit.next()
        np.testing.assert_array_equal(ds.features, jds.features)
        np.testing.assert_array_equal(ds.labels, jds.labels)
        assert ds.features.dtype == np.float32
        n += 1
    assert n == 3 and not jit.has_next()
    it.reset()
    assert it.has_next()
    path = os.path.join(data_dir, "batch_0.h5")
    r = NDArrayHDF5Reader()
    assert r.read(path, "labels").shape == (16, 3)
    np.testing.assert_array_equal(r.read(path, "nope"),      # the first
                                  r.read(path, "features"))  # dataset
