"""PyTorch port, serving plane on the CPU: registry, dynamic batcher and
HTTP server against the JAX package's `ModelRegistry.predict` on the same
zip (a small char-RNN: vocab 11, 2 x GravesLSTM(8), T=5), plus the HTTP
error codes, hot-swap and shutdown.

Tolerance atol 1e-5: float32 on both sides, as in test_torch_char_rnn.py;
JSON carries the port's float32 outputs as exact decimal floats.
"""
import json
import shutil
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.zoo import char_rnn as jax_char_rnn
from deeplearning4j_tpu.serving import ModelRegistry as JaxModelRegistry
from deeplearning4j_tpu.util.serializer import \
    ModelSerializer as JaxModelSerializer
from deeplearning4j_tpu_torch import (InferenceServer, ModelRegistry,
                                      ModelSerializer)
from deeplearning4j_tpu_torch.serving import (DynamicBatcher, ServingError,
                                              UnknownModelError)
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-5
VOCAB, HIDDEN, SEQ = 11, 8, 5


def _features(rows, seed=0):
    r = np.random.default_rng(seed)
    return np.eye(VOCAB, dtype=np.float32)[r.integers(0, VOCAB, (rows, SEQ))]


def _http(method, url, body=None, raw=None):
    data = raw if raw is not None else (
        None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(url, data,
                                 {"Content-Type": "application/json"},
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def zips(tmp_path_factory):
    d = tmp_path_factory.mktemp("serving")
    paths = []
    for seed in (3, 4):
        path = str(d / f"char_rnn_{seed}.zip")
        JaxModelSerializer.write_model(
            jax_char_rnn(vocab_size=VOCAB, lstm_size=HIDDEN, seq_len=SEQ,
                         seed=seed).init(), path)
        paths.append(path)
    return paths


@pytest.fixture
def server():
    srv = InferenceServer(registry=ModelRegistry(device="cpu"),
                          port=0).start()
    yield srv
    srv.stop()


def _threads():
    return [t.name for t in threading.enumerate()
            if t.name.startswith("dl4j-torch-serving")]


@pytest.mark.parametrize("rows,batched", [(1, True), (5, True), (8, True),
                                          (5, False)])
def test_http_predict_matches_jax_registry(zips, server, rows, batched):
    jreg = JaxModelRegistry(buckets=(1, 8, 32))
    jreg.register("m", zips[0])
    server.registry.register("m", zips[0])
    x = _features(rows, seed=rows)
    want, _ = jreg.predict("m", x)
    code, r = _http("POST", f"http://{server.host}:{server.port}"
                    "/v1/models/m/predict",
                    {"features": x.tolist(), "batched": batched})
    assert code == 200 and r["version"] == 1 and r["batched"] == batched
    got = np.asarray(r["output"], np.float32)
    assert got.shape == (rows, SEQ, VOCAB)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_registry_pads_to_bucket_and_strips(zips):
    reg = ModelRegistry(buckets=(1, 8), device="cpu")
    v = reg.register("m", zips[0])
    assert v.example_shape == (SEQ, VOCAB) and v.buckets == (1, 8)
    assert v.forwards == 2                      # one warm-up per bucket
    ref = ModelSerializer.restore(zips[0], device="cpu")
    x = _features(19, seed=9)                   # chunks 8 + 8 + 3 -> pad 8
    out, version = reg.predict("m", x)
    assert version == 1 and out.shape == (19, SEQ, VOCAB)
    assert v.forwards == 5
    np.testing.assert_allclose(out, ref.output(x).numpy(), rtol=0, atol=ATOL)


def test_http_error_codes(zips, server):
    server.registry.register("m", zips[0])
    base = f"http://{server.host}:{server.port}"
    code, r = _http("POST", f"{base}/v1/models/m/predict",
                    {"features": np.zeros((2, SEQ, VOCAB + 1)).tolist()})
    assert code == 400 and "does not match" in r["error"]
    code, r = _http("POST", f"{base}/v1/models/nope/predict",
                    {"features": _features(1).tolist()})
    assert code == 404 and "nope" in r["error"]
    assert _http("GET", f"{base}/v1/models/nope")[0] == 404
    assert _http("GET", f"{base}/v1/nothing")[0] == 404
    assert _http("POST", f"{base}/v1/models/m/predict", raw=b"{bad")[0] == 400
    code, r = _http("POST", f"{base}/v1/models/m/predict", {"rows": 1})
    assert code == 400 and "features" in r["error"]
    code, r = _http("POST", f"{base}/v1/models/m/swap",
                    {"source": zips[1], "precision": "fp64"})
    assert code == 400 and "fp64" in r["error"]
    code, r = _http("POST", f"{base}/v1/models/m/swap",
                    {"source": zips[1], "precision": "bf16"})
    assert code == 200 and r["precision"] == "bf16"


def test_http_listing_and_health(zips, server):
    server.registry.register("m", zips[0])
    base = f"http://{server.host}:{server.port}"
    code, r = _http("GET", f"{base}/v1/models")
    assert code == 200 and [m["name"] for m in r["models"]] == ["m"]
    code, r = _http("GET", f"{base}/v1/models/m")
    assert code == 200 and r["input_shape"] == [SEQ, VOCAB]
    assert r["precision"] == "fp32" and r["device"] == "cpu"
    code, r = _http("GET", f"{base}/healthz")
    assert code == 200 and r["status"] == "ok" and r["models"] == {"m": 1}


def test_swap_raises_version_and_follows_new_weights(zips, server):
    server.registry.register("m", zips[0])
    base = f"http://{server.host}:{server.port}/v1/models/m"
    x = _features(3, seed=5)
    code, info = _http("POST", f"{base}/swap", {"source": zips[1]})
    assert code == 200 and info["version"] == 2
    code, r = _http("POST", f"{base}/predict", {"features": x.tolist()})
    assert code == 200 and r["version"] == 2
    new = ModelSerializer.restore(zips[1], device="cpu").output(x).numpy()
    old = ModelSerializer.restore(zips[0], device="cpu").output(x).numpy()
    np.testing.assert_allclose(np.asarray(r["output"]), new, atol=ATOL)
    assert np.abs(np.asarray(r["output"]) - old).max() > 1e-3


def test_stop_leaves_no_serving_thread(zips):
    srv = InferenceServer(registry=ModelRegistry(device="cpu"),
                          port=0).start()
    srv.registry.register("m", zips[0])
    code, _ = _http("POST", f"http://{srv.host}:{srv.port}"
                    "/v1/models/m/predict", {"features": _features(2).tolist()})
    assert code == 200 and _threads()          # HTTP + batcher threads
    srv.stop()
    assert _threads() == []


def test_batcher_coalesces_concurrent_requests():
    """Four one-row requests against max_batch 4 flush as one batch."""
    batches = []

    def runner(x, bucket):
        batches.append((x.shape[0], bucket))
        return x * 2.0, 7

    b = DynamicBatcher(runner, bucket_for=lambda rows: 4, max_batch=4,
                       max_wait_us=5_000_000, name="t", buckets=(4,))
    results = {}

    def client(i):
        results[i] = b.submit(np.full((1, 2), float(i), np.float32))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        b.stop()
    assert batches == [(4, 4)] and b.flushes == 1
    for i in range(4):
        out, version = results[i]
        assert version == 7 and np.array_equal(out, [[2.0 * i, 2.0 * i]])


def test_checkpoint_directory_serves_newest_loadable(zips, tmp_path):
    shutil.copy(zips[0], tmp_path / "ckpt_000000001.zip")
    with open(tmp_path / "ckpt_000000002.zip", "wb") as f:
        f.write(b"not a zip")
    reg = ModelRegistry(device="cpu")
    v = reg.register("m", str(tmp_path))
    assert v.source.endswith("ckpt_000000001.zip")
    with pytest.raises(ServingError, match="does not exist"):
        reg.register("m", str(tmp_path / "missing.zip"))


def test_registry_refusals(zips, monkeypatch):
    reg = ModelRegistry(device="cpu")
    with pytest.raises(UnknownModelError):
        reg.get("m")
    # bf16 and int8 serve now: each is accepted and stays near fp32
    # (JAX's limits, atol 2e-2 and 5e-2)
    x = _features(3, seed=2)
    want = ModelSerializer.restore(zips[0], device="cpu").output(x).numpy()
    for precision, atol in (("bf16", 2e-2), ("int8", 5e-2)):
        v = reg.register(precision, zips[0], precision=precision)
        assert v.precision == precision
        out, _ = reg.predict(precision, x)
        np.testing.assert_allclose(out, want, rtol=0, atol=atol)
    with pytest.raises(ServingError, match="unknown precision"):
        ModelRegistry(precision="fp64", device="cpu")
    with pytest.raises(ServingError, match="unknown precision"):
        reg.register("m", zips[0], precision="fp64")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModelRegistry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceServer()


def test_model_object_source_is_snapshotted(zips):
    """A live model registers by object; the version holds its own copy of
    the parameters, so later edits to the model do not reach it."""
    net = ModelSerializer.restore(zips[0], device="cpu")
    reg = ModelRegistry(buckets=(1,), device="cpu")
    reg.register("m", net)
    x = _features(1, seed=6)
    before, _ = reg.predict("m", x)
    net.params[2]["b"].add_(5.0)
    after, _ = reg.predict("m", x)
    np.testing.assert_array_equal(before, after)
