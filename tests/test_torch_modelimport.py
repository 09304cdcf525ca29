"""PyTorch port, Keras model import on the CPU: the twins of
`tests/test_modelimport.py` (Sequential MLP / CNN / BN + dropout / LSTM,
functional graphs, VGG-16, training an imported net, the archive reader,
the refusals, the ordered weight assignment) and of
`test_round4_regressions.py::test_h5_attr_missing_name_errors`; the
`ModelGuesser` format table and its word-vector kinds (loaded as the
serializer reads them, refused by the serving registry); a Keras
HDF5 file served through `load_source`; the legacy Keras backend server's
error semantics (the twins of `tests/test_serving.py`'s legacy-server
tests); and a Keras-2-layout file written with h5py alone, held against
keras's own save of the same weights.

Every Keras file is saved by the installed keras once per module (inside
`torch_threads.pinned()`), and each file is imported by both packages: the
port's parameters equal JAX's exactly, its outputs JAX's at 1e-5, and both
keras's at JAX's own limits. Tests that need keras or h5py skip without
them, as JAX's do.
"""
import json
import urllib.error
import urllib.request
import zipfile

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import DataSet as JaxDataSet
from deeplearning4j_tpu.modelimport import (
    import_keras_model_and_weights as jax_import_model,
    import_keras_sequential_model_and_weights as jax_import_seq)
from deeplearning4j_tpu.util.serializer import ModelGuesser as JaxGuesser
from deeplearning4j_tpu_torch import (DataSet, DenseLayer, GravesLSTM,
                                      InputType, ModelSerializer,
                                      MultiLayerNetwork,
                                      NeuralNetConfiguration, OutputLayer,
                                      RnnOutputLayer, Sgd)
from deeplearning4j_tpu_torch.modelimport import (
    Hdf5Archive, KerasImportError, import_keras_model_and_weights,
    import_keras_sequential_model_and_weights)
from deeplearning4j_tpu_torch.serving import ModelRegistry, ServingError
from deeplearning4j_tpu_torch.util import ModelGuesser
from torch_threads import one_torch_thread, pinned  # noqa: F401

OUT_TOL = 1e-5      # the port's outputs against JAX's import of the file
N_IN, N_OUT = 6, 3


# ---------------------------------------------------------------------------
# Keras-saved files, built once
# ---------------------------------------------------------------------------
def _keras_models(keras):
    """{name: (model, inputs)}: the models of JAX's test_modelimport."""
    L = keras.layers
    rng = np.random.default_rng(2)
    out = {
        "mlp": (keras.Sequential([
            L.Input(shape=(12,)), L.Dense(16, activation="relu"),
            L.Dense(8, activation="tanh"), L.Dense(5, activation="softmax")]),
            np.random.default_rng(0).normal(size=(7, 12))),
        "cnn": (keras.Sequential([
            L.Input(shape=(12, 12, 3)),
            L.Conv2D(6, (3, 3), activation="relu", padding="valid"),
            L.MaxPooling2D((2, 2)),
            L.Conv2D(4, (3, 3), activation="relu", padding="same"),
            L.Flatten(), L.Dense(10, activation="softmax")]),
            np.random.default_rng(1).normal(size=(5, 12, 12, 3))),
        "lstm": (keras.Sequential([
            L.Input(shape=(9, 4)), L.LSTM(8, return_sequences=True),
            L.LSTM(6, return_sequences=False),
            L.Dense(3, activation="softmax")]),
            np.random.default_rng(3).normal(size=(5, 9, 4))),
        "only": (keras.Sequential([L.Input(shape=(4,)),
                                   L.Dense(3, name="only")]), None),
        "reshape": (keras.Sequential([L.Input(shape=(4,)), L.Dense(6),
                                      L.Reshape((2, 3))]), None),
    }
    bn = keras.Sequential([
        L.Input(shape=(10, 10, 2)), L.Conv2D(4, (3, 3), padding="same"),
        L.BatchNormalization(), L.Activation("relu"), L.Dropout(0.4),
        L.GlobalAveragePooling2D(), L.Dense(3, activation="softmax")])
    bn.compile(optimizer="sgd", loss="categorical_crossentropy")
    xs = rng.normal(size=(64, 10, 10, 2)).astype(np.float32)
    ys = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 64)]
    bn.fit(xs, ys, epochs=2, verbose=0)
    out["bn"] = (bn, rng.normal(size=(6, 10, 10, 2)))

    inp = keras.Input(shape=(8,))
    a = L.Dense(6, activation="relu", name="branch_a")(inp)
    b = L.Dense(6, activation="tanh", name="branch_b")(inp)
    s = L.Add(name="added")([a, b])
    c = L.Concatenate(name="cat")([s, a])
    o = L.Dense(4, activation="softmax", name="head")(c)
    out["graph"] = (keras.Model(inp, o),
                    np.random.default_rng(4).normal(size=(5, 8)))

    inp = keras.Input(shape=(8, 8, 2))
    c1 = L.Conv2D(4, (3, 3), padding="same", activation="relu",
                  name="c1")(inp)
    c2 = L.Conv2D(4, (1, 1), padding="same", name="c2")(inp)
    s = L.Add(name="residual")([c1, c2])
    g = L.GlobalAveragePooling2D(name="gap")(s)
    o = L.Dense(3, activation="softmax", name="head")(g)
    out["cnn_graph"] = (keras.Model(inp, o),
                        np.random.default_rng(5).normal(size=(4, 8, 8, 2)))

    tr = keras.Sequential([L.Input(shape=(6,)),
                           L.Dense(8, activation="relu"),
                           L.Dense(2, activation="softmax")])
    tr.compile(optimizer="sgd", loss="categorical_crossentropy")
    out["trainable"] = (tr, None)
    out["vgg16"] = (keras.applications.VGG16(
        weights=None, input_shape=(64, 64, 3), classes=10),
        np.random.default_rng(7).normal(size=(2, 64, 64, 3)))
    return out


@pytest.fixture(scope="module")
def kfiles(tmp_path_factory):
    """{name: (h5 path, x, keras's prediction of x)}."""
    keras = pytest.importorskip("keras")
    d = tmp_path_factory.mktemp("keras")
    files = {}
    with pinned():
        keras.backend.set_floatx("float32")
        for name, (m, x) in _keras_models(keras).items():
            path = str(d / f"{name}.h5")
            m.save(path)
            if x is not None:
                x = x.astype(np.float32)
                files[name] = (path, x, m.predict(x, verbose=0))
            else:
                files[name] = (path, None, None)
    return files


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _assert_same_params(port_params, jax_params):
    """Exactly the file's values on both sides, leaf by leaf."""
    if isinstance(port_params, dict):
        assert port_params.keys() == jax_params.keys()
        pairs = [(port_params[k], jax_params[k]) for k in port_params]
    else:
        assert len(port_params) == len(jax_params)
        pairs = list(zip(port_params, jax_params))
    for p, j in pairs:
        assert p.keys() == j.keys()
        for k in p:
            np.testing.assert_array_equal(_np(p[k]), _np(j[k]), err_msg=k)


def _check_seq(kfiles, name, keras_tol):
    path, x, expected = kfiles[name]
    net = import_keras_sequential_model_and_weights(path, device="cpu")
    jnet = jax_import_seq(path)
    _assert_same_params(net.params, jnet.params)
    _assert_same_params(net.state, jnet.state)
    got = _np(net.output(x))
    np.testing.assert_allclose(got, _np(jnet.output(x)), rtol=OUT_TOL,
                               atol=OUT_TOL)
    np.testing.assert_allclose(got, expected, **keras_tol)
    return net


def _check_graph(kfiles, name, keras_tol):
    path, x, expected = kfiles[name]
    graph = import_keras_model_and_weights(path, device="cpu")
    jgraph = jax_import_model(path)
    _assert_same_params(graph.params, jgraph.params)
    got = _np(graph.output(x)[0])
    np.testing.assert_allclose(got, _np(jgraph.output(x)[0]), rtol=OUT_TOL,
                               atol=OUT_TOL)
    np.testing.assert_allclose(got, expected, **keras_tol)
    return graph


# ---------------------------------------------------------------------------
# Twins of tests/test_modelimport.py
# ---------------------------------------------------------------------------
def test_sequential_mlp_end_to_end(kfiles):
    _check_seq(kfiles, "mlp", dict(rtol=1e-4, atol=1e-5))


def test_sequential_cnn_end_to_end(kfiles):
    net = _check_seq(kfiles, "cnn", dict(rtol=1e-4, atol=1e-5))
    assert list(net.conf.preprocessors) == [3]   # Flatten before the Dense


def test_sequential_bn_dropout_end_to_end(kfiles):
    net = _check_seq(kfiles, "bn", dict(rtol=1e-3, atol=1e-4))
    mean = _np(net.state[1]["mean"])
    assert np.abs(mean).max() > 0           # keras's moving statistics


def test_sequential_lstm_end_to_end(kfiles):
    net = _check_seq(kfiles, "lstm", dict(rtol=1e-3, atol=1e-4))
    kinds = [type(l).__name__ for l in net.layers]
    assert kinds == ["GravesLSTM", "GravesLSTM", "LastTimeStep",
                     "OutputLayer"]
    for i in (0, 1):
        assert not _np(net.params[i]["peep"]).any()   # no peepholes
        assert net.layers[i].forget_gate_bias_init == 0.0


def test_functional_graph_end_to_end(kfiles):
    _check_graph(kfiles, "graph", dict(rtol=1e-4, atol=1e-5))


def test_functional_cnn_graph_end_to_end(kfiles):
    _check_graph(kfiles, "cnn_graph", dict(rtol=1e-4, atol=1e-5))


def test_imported_model_is_trainable(kfiles):
    """The imported net trains, step for step with JAX's import of the
    same file (scores and parameters at 1e-4)."""
    path = kfiles["trainable"][0]
    net = import_keras_sequential_model_and_weights(path, device="cpu")
    jnet = jax_import_seq(path)
    rng = np.random.default_rng(6)
    x = np.concatenate([rng.normal(-1, .5, (40, 6)),
                        rng.normal(1, .5, (40, 6))]).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[np.array([0] * 40 + [1] * 40)]
    s0 = None
    for _ in range(30):
        net.fit(DataSet(x, y))
        jnet.fit(JaxDataSet(x, y))
        assert abs(net.score() - float(jnet.score())) <= 1e-4
        if s0 is None:
            s0 = net.score()
    assert net.score() < s0
    for p, j in zip(net.params, jnet.params):
        for k in p:
            np.testing.assert_allclose(_np(p[k]), _np(j[k]), atol=1e-4,
                                       rtol=1e-4)


def test_hdf5_archive_reads_config_and_weights(kfiles):
    path = kfiles["only"][0]
    with Hdf5Archive(path) as ar:
        cfg = ar.model_config()
        assert cfg["class_name"] == "Sequential"
        kw = ar.layer_weights("only")
        assert kw["kernel"].shape == (4, 3)
        assert kw["bias"].shape == (3,)
        assert ar.layer_names() == ar.layer_names()
    net = import_keras_sequential_model_and_weights(path, device="cpu")
    np.testing.assert_array_equal(_np(net.params[0]["W"]), kw["kernel"])


def test_unsupported_layer_raises(kfiles):
    path = kfiles["reshape"][0]
    with pytest.raises(KerasImportError, match="Unsupported Keras layer "
                                               "'Reshape'"):
        import_keras_sequential_model_and_weights(path, device="cpu")


def test_vgg16_functional_import(kfiles):
    _check_graph(kfiles, "vgg16", dict(rtol=1e-3, atol=1e-4))


def _small_cnn(lib, device=None):
    conf = (lib.NeuralNetConfiguration.builder().seed(0)
            .updater(lib.Sgd(0.1)).list()
            .layer(lib.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                        stride=(1, 1), activation="relu",
                                        convolution_mode="same"))
            .layer(lib.DenseLayer(n_out=6, activation="relu"))
            .layer(lib.OutputLayer(n_out=2, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(lib.InputType.convolutional(5, 5, 3)).build())
    if device is None:
        return lib.MultiLayerNetwork(conf).init()
    return lib.MultiLayerNetwork(conf, device=device).init()


def test_assign_keras_weights_in_order(tmp_path):
    h5py = pytest.importorskip("h5py")
    import deeplearning4j_tpu as jx
    import deeplearning4j_tpu_torch as pt
    from deeplearning4j_tpu.modelimport.trainedmodels import (
        assign_keras_weights_in_order as jax_assign)
    from deeplearning4j_tpu_torch.modelimport.trainedmodels import (
        assign_keras_weights_in_order)

    r = np.random.default_rng(0)
    k1 = r.normal(size=(3, 3, 3, 4)).astype(np.float32)
    b1 = r.normal(size=(4,)).astype(np.float32)
    k2 = r.normal(size=(100, 6)).astype(np.float32)   # 5*5*4 flattened
    b2 = r.normal(size=(6,)).astype(np.float32)
    k3 = r.normal(size=(6, 2)).astype(np.float32)
    b3 = r.normal(size=(2,)).astype(np.float32)
    p = str(tmp_path / "w.h5")
    with h5py.File(p, "w") as f:
        for grp, k, b in (("block1_conv1", k1, b1), ("fc1", k2, b2),
                          ("predictions", k3, b3)):
            g = f.create_group(grp)
            g.create_dataset(f"{grp}_W", data=k)
            g.create_dataset(f"{grp}_b", data=b)
    net = assign_keras_weights_in_order(_small_cnn(pt, "cpu"), p)
    jnet = jax_assign(_small_cnn(jx), p)
    _assert_same_params(net.params, jnet.params)
    np.testing.assert_array_equal(_np(net.params[0]["W"]), k1)
    np.testing.assert_array_equal(_np(net.params[1]["W"]), k2)
    np.testing.assert_array_equal(_np(net.params[2]["b"]), b3)
    x = r.normal(size=(3, 5, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(_np(net.output(x)), _np(jnet.output(x)),
                               rtol=OUT_TOL, atol=OUT_TOL)


def test_assign_keras_weights_shape_mismatch_raises(tmp_path):
    h5py = pytest.importorskip("h5py")
    from deeplearning4j_tpu_torch.modelimport.trainedmodels import (
        assign_keras_weights_in_order)

    conf = (NeuralNetConfiguration.builder().seed(0).updater(Sgd(0.1))
            .list()
            .layer(OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(4)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    p = str(tmp_path / "bad.h5")
    with h5py.File(p, "w") as f:
        g = f.create_group("dense")
        g.create_dataset("W", data=np.zeros((7, 2), np.float32))
        g.create_dataset("b", data=np.zeros((2,), np.float32))
    with pytest.raises(ValueError, match="kernel shape"):
        assign_keras_weights_in_order(net, p)


def test_h5_attr_missing_name_errors(tmp_path):
    """Names listed in layer_names / weight_names attrs but absent from the
    group fail loudly instead of shifting the pairs."""
    h5py = pytest.importorskip("h5py")
    from deeplearning4j_tpu_torch.modelimport.trainedmodels import (
        _collect_weight_pairs)
    p = tmp_path / "w.h5"
    with h5py.File(p, "w") as f:
        g1 = f.create_group("dense_1")
        g1.attrs["weight_names"] = [b"dense_1_W", b"dense_1_b"]
        g1.create_dataset("dense_1_W", data=np.ones((3, 2), np.float32))
        f.attrs["layer_names"] = [b"dense_1"]
    with h5py.File(p, "r") as f:
        with pytest.raises(ValueError, match="missing from the group"):
            _collect_weight_pairs(f)


def test_trained_model_helper_looks_up_the_cache_only(tmp_path):
    """Nothing is fetched: a missing file is a FileNotFoundError naming
    it; a cached labels file (under the JAX downloader's name) loads."""
    from deeplearning4j_tpu_torch.modelimport.trainedmodels import (
        _IMAGENET_LABELS_URL, ImageNetLabels, TrainedModelHelper,
        cached_file)
    with pytest.raises(FileNotFoundError,
                       match="vgg16_weights_tf_dim_ordering_tf_kernels.h5"):
        TrainedModelHelper(cache_dir=str(tmp_path),
                           device="cpu").load_model()
    with pytest.raises(FileNotFoundError, match="imagenet_class_index"):
        ImageNetLabels(cache_dir=str(tmp_path))
    import hashlib
    digest = hashlib.sha256(_IMAGENET_LABELS_URL.encode()).hexdigest()[:12]
    labels = {str(i): [f"n{i:08d}", f"class_{i}"] for i in range(1000)}
    (tmp_path / f"{digest}-imagenet_class_index.json").write_text(
        json.dumps(labels))
    assert cached_file(_IMAGENET_LABELS_URL, str(tmp_path)).endswith(
        f"{digest}-imagenet_class_index.json")
    lab = ImageNetLabels(cache_dir=str(tmp_path))
    probs = np.zeros((2, 1000), np.float32)
    probs[0, 7], probs[1, 999] = 0.9, 0.5
    top = lab.decode_predictions(torch.from_numpy(probs), top=1)
    assert top == [[("class_7", pytest.approx(0.9))],
                   [("class_999", 0.5)]]


# ---------------------------------------------------------------------------
# ModelGuesser and load_source
# ---------------------------------------------------------------------------
def _guess_files(tmp_path):
    """{expected kind: path} of one file per format."""
    files = {}
    net = MultiLayerNetwork(
        NeuralNetConfiguration.builder().seed(0).list()
        .layer(OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
        .set_input_type(InputType.feed_forward(3)).build(),
        device="cpu").init()
    files["dl4j_tpu_zip"] = str(tmp_path / "model.zip")
    ModelSerializer.write_model(net, files["dl4j_tpu_zip"])
    files["keras_h5"] = str(tmp_path / "model.h5")
    with open(files["keras_h5"], "wb") as f:
        f.write(b"\x89HDF\r\n\x1a\n" + bytes(64))
    text = "the 0.1 0.2\nof 0.3 0.4\n"
    files["word_vectors_text"] = str(tmp_path / "vectors.txt")
    with open(files["word_vectors_text"], "w") as f:
        f.write("2 2\n" + text)
    files["word_vectors_binary"] = str(tmp_path / "vectors.bin")
    with open(files["word_vectors_binary"], "wb") as f:
        f.write(b"2 2\n" + b"the " + np.array([0.1, 0.2], np.float32)
                .tobytes() + b"of " + np.array([0.3, 0.4], np.float32)
                .tobytes())
    files["word_vectors_gz"] = str(tmp_path / "vectors.txt.gz")
    import gzip
    with gzip.open(files["word_vectors_gz"], "wt") as f:
        f.write(text)
    files["word_vectors_zip"] = str(tmp_path / "w2v.zip")
    with zipfile.ZipFile(files["word_vectors_zip"], "w") as z:
        z.writestr("syn0.txt", text)
        z.writestr("config.json", "{}")
    files["unknown_zip"] = str(tmp_path / "other.zip")
    with zipfile.ZipFile(files["unknown_zip"], "w") as z:
        z.writestr("readme", "x")
    files["unknown"] = str(tmp_path / "blob.bin")
    with open(files["unknown"], "wb") as f:
        f.write(bytes(range(256)) * 4)
    return files


GUESS_KINDS = ["dl4j_tpu_zip", "keras_h5", "word_vectors_text",
               "word_vectors_binary", "word_vectors_gz", "word_vectors_zip",
               "unknown_zip", "unknown"]


@pytest.mark.parametrize("kind", GUESS_KINDS)
def test_model_guesser_format_table(tmp_path, kind):
    path = _guess_files(tmp_path)[kind]
    want = "word_vectors_text" if kind == "word_vectors_gz" else kind
    assert ModelGuesser.guess_format(path) == want
    assert JaxGuesser.guess_format(path) == want


@pytest.mark.parametrize("kind", ["word_vectors_text",
                                  "word_vectors_binary", "word_vectors_zip"])
def test_model_guesser_loads_word_vectors_registry_refuses(tmp_path, kind):
    """Each word-vector kind loads through ModelGuesser.load as
    WordVectorSerializer reads it (and as JAX's guesser loads it); the
    serving registry still refuses it, in JAX's words."""
    from deeplearning4j_tpu_torch.nlp import WordVectorSerializer
    path = _guess_files(tmp_path)[kind]
    got = ModelGuesser.load(path, device="cpu")
    read = {"word_vectors_text": WordVectorSerializer.read_word_vectors,
            "word_vectors_binary": WordVectorSerializer.read_binary,
            "word_vectors_zip": WordVectorSerializer.read_word2vec_model}[
        kind](path, device="cpu")
    want = JaxGuesser.load(path)
    for other in (read, want):
        assert got.vocab.words() == other.vocab.words()
        np.testing.assert_array_equal(got.lookup_table.vectors_matrix(),
                                      np.asarray(other.lookup_table
                                                 .vectors_matrix()))
    assert got.lookup_table.syn0.device.type == "cpu"
    with pytest.raises(ServingError, match="not a servable model file"):
        ModelRegistry(buckets=(1,), device="cpu").register("w", path)


def test_model_guesser_loads_zip_and_refuses_unknown(tmp_path):
    files = _guess_files(tmp_path)
    net = ModelGuesser.load(files["dl4j_tpu_zip"], device="cpu")
    assert isinstance(net, MultiLayerNetwork) and net.device.type == "cpu"
    for kind in ("unknown", "unknown_zip"):
        with pytest.raises(ValueError, match="cannot determine model "
                                             "format"):
            ModelGuesser.load(files[kind], device="cpu")
        with pytest.raises(ServingError, match=f"sniffed: {kind}"):
            ModelRegistry(buckets=(1,), device="cpu").register("u",
                                                               files[kind])


def test_keras_h5_loads_through_guesser_and_registry(kfiles):
    """`load_source` sends an HDF5 path through ModelGuesser: the registry
    serves the imported Sequential LSTM and the functional graph at their
    imports' outputs."""
    for name in ("lstm", "graph"):
        path, x, expected = kfiles[name]
        model = ModelGuesser.load(path, device="cpu")
        jmodel = JaxGuesser.load(path)
        assert type(model).__name__ == type(jmodel).__name__
        reg = ModelRegistry(buckets=(1, 8), device="cpu")
        v = reg.register(name, path)
        assert v.source == path and v.model_kind == type(model).__name__
        out, _ = reg.predict(name, x)
        np.testing.assert_allclose(out, expected, rtol=1e-3, atol=1e-4)
        want = model.output(x)
        want = want[0] if isinstance(want, tuple) else want
        np.testing.assert_allclose(out, _np(want), rtol=OUT_TOL,
                                   atol=OUT_TOL)


# ---------------------------------------------------------------------------
# A Keras-2-layout file written with h5py alone
# ---------------------------------------------------------------------------
def write_keras2_sequential(path, input_shape, layers, weights):
    """A Keras 2 whole-model HDF5 file: the `model_config` JSON attribute
    and `model_weights/<layer>/<layer>/<name>:0` datasets listed in each
    layer group's `weight_names`. `layers` is [(class_name, config)],
    `weights` {layer name: [(short name, array)]}."""
    import h5py
    cfg = [{"class_name": "InputLayer", "config": {
        "batch_input_shape": [None] + list(input_shape),
        "dtype": "float32", "name": "input_1"}}]
    cfg += [{"class_name": cls, "config": c} for cls, c in layers]
    model_config = {"class_name": "Sequential",
                    "config": {"name": "sequential", "layers": cfg}}
    with h5py.File(path, "w") as f:
        f.attrs["model_config"] = json.dumps(model_config).encode()
        f.attrs["keras_version"] = b"2.15.0"
        f.attrs["backend"] = b"tensorflow"
        root = f.create_group("model_weights")
        root.attrs["layer_names"] = [c["name"].encode() for _, c in layers]
        for _, c in layers:
            g = root.create_group(c["name"])
            names = [f"{c['name']}/{w}:0".encode()
                     for w, _ in weights.get(c["name"], [])]
            g.attrs["weight_names"] = names
            for n, (_, arr) in zip(names, weights.get(c["name"], [])):
                g.create_dataset(n.decode(), data=arr)


def test_keras2_writer_matches_keras_save(tmp_path):
    """Input(T, F) -> LSTM(H, return_sequences) -> LSTM(H) -> Dense(V,
    softmax) with seeded weights: the h5py-written Keras-2 file imports to
    the same network as keras's own save of the same weights (the same
    layers, exactly the same parameters, outputs at 1e-6), and JAX's import
    of it agrees (1e-5)."""
    keras = pytest.importorskip("keras")
    pytest.importorskip("h5py")
    T, F, H, V = 7, 5, 6, 5
    r = np.random.default_rng(17)
    w = {"lstm_1": [("kernel", r.normal(0, .3, (F, 4 * H))),
                    ("recurrent_kernel", r.normal(0, .3, (H, 4 * H))),
                    ("bias", r.normal(0, .3, (4 * H,)))],
         "lstm_2": [("kernel", r.normal(0, .3, (H, 4 * H))),
                    ("recurrent_kernel", r.normal(0, .3, (H, 4 * H))),
                    ("bias", r.normal(0, .3, (4 * H,)))],
         "dense_1": [("kernel", r.normal(0, .3, (H, V))),
                     ("bias", r.normal(0, .3, (V,)))]}
    w = {k: [(n, a.astype(np.float32)) for n, a in v] for k, v in w.items()}
    layers = [("LSTM", {"name": "lstm_1", "units": H,
                        "return_sequences": True, "activation": "tanh",
                        "recurrent_activation": "sigmoid"}),
              ("LSTM", {"name": "lstm_2", "units": H,
                        "return_sequences": False, "activation": "tanh",
                        "recurrent_activation": "sigmoid"}),
              ("Dense", {"name": "dense_1", "units": V,
                         "activation": "softmax"})]
    ours = str(tmp_path / "written.h5")
    write_keras2_sequential(ours, (T, F), layers, w)
    with pinned():
        m = keras.Sequential([
            keras.layers.Input(shape=(T, F)),
            keras.layers.LSTM(H, return_sequences=True, name="lstm_1"),
            keras.layers.LSTM(H, name="lstm_2"),
            keras.layers.Dense(V, activation="softmax", name="dense_1")])
        m.set_weights([a for k in ("lstm_1", "lstm_2", "dense_1")
                       for _, a in w[k]])
        theirs = str(tmp_path / "keras.h5")
        m.save(theirs)
        x = r.normal(size=(4, T, F)).astype(np.float32)
        expected = m.predict(x, verbose=0)
    a = import_keras_sequential_model_and_weights(ours, device="cpu")
    b = import_keras_sequential_model_and_weights(theirs, device="cpu")
    assert [type(l).__name__ for l in a.layers] == \
        [type(l).__name__ for l in b.layers]
    assert [getattr(l, "n_out", None) for l in a.layers] == \
        [getattr(l, "n_out", None) for l in b.layers]
    _assert_same_params(a.params, b.params)
    out = _np(a.output(x))
    np.testing.assert_allclose(out, _np(b.output(x)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(out, expected, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(out, _np(jax_import_seq(ours).output(x)),
                               rtol=OUT_TOL, atol=OUT_TOL)


# ---------------------------------------------------------------------------
# The legacy Keras backend server (twins of tests/test_serving.py's)
# ---------------------------------------------------------------------------
def _http_err(method, url, body=None):
    data = body if isinstance(body, bytes) else \
        (None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(url, data,
                                 {"Content-Type": "application/json"},
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


@pytest.fixture(scope="module")
def legacy():
    from deeplearning4j_tpu_torch.modelimport.server import (
        KerasBackendServer)
    srv = KerasBackendServer(device="cpu").start()
    yield srv
    srv.stop()


def test_legacy_server_malformed_json_is_400(legacy):
    base = f"http://{legacy.host}:{legacy.port}"
    code, body = _http_err("POST", base + "/output", b"{oops")
    assert code == 400 and "malformed JSON" in body["error"]
    assert legacy._httpd.request_queue_size == 128


def test_legacy_server_missing_keys_is_400(legacy):
    base = f"http://{legacy.host}:{legacy.port}"
    for path, body in (("/output", {"features": [[1.0]]}),
                       ("/output", {"model": "/nonexistent/x.h5"}),
                       ("/fit", {"model": "/nonexistent/x.h5"})):
        code, out = _http_err("POST", base + path, body)
        assert code == 400, (path, body, code)
        assert "error" in out


def test_legacy_server_unknown_path_404_and_server_fault_500(legacy):
    base = f"http://{legacy.host}:{legacy.port}"
    code, _ = _http_err("POST", base + "/bogus", {})
    assert code == 404
    code, _ = _http_err("GET", base + "/bogus")
    assert code == 404
    code, out = _http_err("GET", base + "/ping")
    assert code == 200 and out == {"status": "ok"}
    entry = legacy.entry_point
    orig = entry.output
    entry.output = lambda *a, **k: (_ for _ in ()).throw(
        MemoryError("server fault"))
    try:
        code, body = _http_err("POST", base + "/output",
                               {"model": "m", "features": [[1.0]]})
        assert code == 500 and "MemoryError" in body["error"]
    finally:
        entry.output = orig


def _tiny_net(seed=13):
    conf = (NeuralNetConfiguration.builder().seed(seed).updater(Sgd(0.1))
            .list()
            .layer(DenseLayer(n_out=16, activation="relu"))
            .layer(OutputLayer(n_out=N_OUT, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.feed_forward(N_IN)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def test_legacy_output_routes_through_registry(tmp_path):
    """/output serves through the ModelRegistry: loaded and warmed once,
    and a second request reuses the registered version."""
    from deeplearning4j_tpu_torch.modelimport.server import (
        DeepLearning4jEntryPoint)

    reg = ModelRegistry(buckets=(1, 4), device="cpu")
    entry = DeepLearning4jEntryPoint(registry=reg)
    net = _tiny_net()
    path = str(tmp_path / "native.zip")
    ModelSerializer.write_model(net, path)
    entry._models[path] = net
    x = np.random.default_rng(0).normal(size=(2, N_IN)).astype(np.float32)
    out = entry.output(path, x.tolist())
    assert path in reg and out.shape == (2, N_OUT)
    np.testing.assert_allclose(out, _np(net.output(x)), rtol=1e-6,
                               atol=1e-6)
    v1 = reg.get(path).version
    entry.output(path, x.tolist())
    assert reg.get(path).version == v1


def test_legacy_output_accepts_shape_varying_sequences():
    """Registered buckets serve the first request's shape; an off-shape
    request takes the direct net.output() path."""
    from deeplearning4j_tpu_torch.modelimport.server import (
        DeepLearning4jEntryPoint)

    conf = (NeuralNetConfiguration.builder().seed(0).updater(Sgd(0.1))
            .list()
            .layer(GravesLSTM(n_out=8))
            .layer(RnnOutputLayer(n_out=2, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(InputType.recurrent(4)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    entry = DeepLearning4jEntryPoint(
        registry=ModelRegistry(buckets=(1, 2), device="cpu"))
    entry._models["rnn"] = net
    r = np.random.default_rng(0)
    x5 = r.normal(size=(2, 5, 4)).astype(np.float32)
    x9 = r.normal(size=(2, 9, 4)).astype(np.float32)
    out5 = entry.output("rnn", x5.tolist())
    out9 = entry.output("rnn", x9.tolist())
    np.testing.assert_allclose(out5, _np(net.output(x5)), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(out9, _np(net.output(x9)), rtol=1e-4,
                               atol=1e-5)
