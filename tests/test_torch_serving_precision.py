"""PyTorch port, the rest of the serving registry on the CPU: bf16 and int8
snapshots, runner reuse across swaps, a failed build at swap time, the
compile metrics, and canary routing (registry and HTTP, predict and
generate). Twins of `tests/test_serving.py`'s quantize / swap-failure /
int8-swap / compile-counter / metrics tests and `tests/test_continual.py`'s
canary mechanics, each held against the JAX package on the same parameters
(crossed through `from_jax_params`).

Tolerances: bf16 and int8 outputs against fp32 at JAX's own limits (atol
2e-2 and 5e-2); the port's int8 outputs against JAX's int8 outputs at 1e-5
(the same int8 weights and scales, float32 compute); bf16 against JAX's
bf16 at 2e-2 (XLA rounds fused chains once, eager torch after each op).
"""
import functools
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import (DenseLayer as JaxDense,
                                InputType as JaxInputType,
                                MultiLayerNetwork as JaxNet,
                                NeuralNetConfiguration as JaxNNC,
                                OutputLayer as JaxOutput, Sgd as JaxSgd)
from deeplearning4j_tpu.serving import ModelRegistry as JaxModelRegistry
from deeplearning4j_tpu.serving import quantize_tree as jax_quantize_tree
from deeplearning4j_tpu_torch import (DenseLayer, EmbeddingSequenceLayer,
                                      InputType, ModelSerializer,
                                      MultiLayerNetwork,
                                      NeuralNetConfiguration, OutputLayer,
                                      RnnOutputLayer, Sgd, TransformerBlock,
                                      from_jax_params, telemetry)
from deeplearning4j_tpu_torch.serving import (AotCompileError,
                                              InferenceServer, ModelRegistry,
                                              ServingError, cast_tree,
                                              quantize_tree)
from jax_reference import jax_init
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.sanitize(
    allow_threads=("dl4j-decode-sched-", "dl4j-torch-serving-http",
                   "dl4j-torch-serving-batcher-"))

N_IN, N_OUT = 6, 3
TOL = {"bf16": 2e-2, "int8": 5e-2}


def _conf(nnc, dense, output, input_type, sgd, seed, hidden):
    return (nnc.builder().seed(seed).updater(sgd(0.1)).list()
            .layer(dense(n_out=hidden, activation="relu"))
            .layer(output(n_out=N_OUT, activation="softmax", loss="mcxent"))
            .set_input_type(input_type.feed_forward(N_IN)).build())


@functools.lru_cache(maxsize=None)
def _jax_net(seed, hidden):
    return jax_init(JaxNet(_conf(JaxNNC, JaxDense, JaxOutput, JaxInputType,
                                 JaxSgd, seed, hidden)))


def tiny_net(seed=0, hidden=16):
    """The port's tiny MLP on the parameters of JAX's for the same seed."""
    net = MultiLayerNetwork(_conf(NeuralNetConfiguration, DenseLayer,
                                  OutputLayer, InputType, Sgd, seed, hidden),
                            device="cpu").init()
    params = [{k: np.asarray(v) for k, v in p.items()}
              for p in _jax_net(seed, hidden).params]
    return from_jax_params(net, params)


def rows(n, seed=0):
    return np.random.default_rng(seed).normal(
        size=(n, N_IN)).astype(np.float32)


def _out(net, x):
    return net.output(x).numpy()


def _lm(seed=3):
    b = (NeuralNetConfiguration.builder().seed(seed).list()
         .layer(EmbeddingSequenceLayer(n_in=32, n_out=16)))
    for _ in range(2):
        b = b.layer(TransformerBlock(n_heads=4))
    conf = (b.layer(RnnOutputLayer(n_out=32, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(InputType.recurrent(1, 32)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


# ---------------------------------------------------------------------------
# bf16 / int8 snapshots
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_precision_outputs():
    jreg = JaxModelRegistry(buckets=(4,))
    out = {}
    for precision in ("fp32", "bf16", "int8"):
        jreg.register(precision, _jax_net(0, 32), precision=precision)
        out[precision] = jreg.predict(precision, rows(4, seed=3))[0]
    return out


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_quantized_and_bf16_paths_close_to_fp32(precision):
    net = tiny_net(hidden=32)
    x = rows(4, seed=3)
    ref = _out(net, x)
    reg = ModelRegistry(buckets=(4,), device="cpu")
    reg.register("m", net, precision=precision)
    reg.register("f", net)
    out, _ = reg.predict("m", x)
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=TOL[precision])
    want = _jax_precision_outputs()
    np.testing.assert_allclose(reg.predict("f", x)[0], want["fp32"],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(out, want[precision], rtol=0,
                               atol=1e-5 if precision == "int8"
                               else TOL["bf16"])
    assert reg.get("m").precision == precision


def test_int8_quantizes_weights_and_holds_fewer_bytes_than_bf16():
    net = tiny_net(hidden=32)
    reg = ModelRegistry(buckets=(4,), device="cpu")
    reg.register("q8", net, precision="int8")
    reg.register("b16", net, precision="bf16")
    reg.register("f32", net)
    # int8 quantized the weight matrices, not the biases
    assert reg.get("q8").snapshot.n_quantized >= 2
    assert reg.get("q8").param_bytes < reg.get("b16").param_bytes \
        < reg.get("f32").param_bytes
    assert {d.dtype for d in reg.get("b16").snapshot.data} \
        == {torch.bfloat16}


def test_quantize_tree_matches_jax():
    tree = {"w": np.random.default_rng(0).normal(size=(64, 32)).astype(
        np.float32), "b": np.ones(32, np.float32)}
    qt = quantize_tree(tree, min_elems=64)
    jqt = jax_quantize_tree(tree, min_elems=64)
    assert qt.n_quantized == jqt.n_quantized == 1     # the bias passes
    (q, scale), = [d for d, s in zip(qt.data, qt.scales) if s is not None]
    (jq, jscale), = [d for d, s in zip(jqt.data, jqt.scales)
                     if s is not None]
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(scale) == float(jscale)
    rebuilt = qt.rebuild(qt.data)
    err = np.abs(rebuilt["w"].numpy() - tree["w"]).max()
    assert err <= np.max(np.abs(tree["w"])) / 127 + 1e-6
    np.testing.assert_array_equal(rebuilt["b"].numpy(), tree["b"])
    cast = cast_tree(tree, "bfloat16")
    assert cast["w"].dtype == torch.bfloat16
    assert qt.nbytes() == jqt.nbytes()


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_lm_serves_and_generates_at_reduced_precision(precision):
    """The transformer LM at bucket 2 against its fp32 output (JAX's
    limits), then generation through the decode plane on that snapshot."""
    from deeplearning4j_tpu_torch.serving.decode import GenerationScheduler

    net = _lm()
    x = np.random.default_rng(1).integers(0, 32, (2, 32, 1)).astype(
        np.float32)
    reg = ModelRegistry(buckets=(2,), device="cpu")
    reg.register("lm", net, precision=precision)
    out, _ = reg.predict("lm", x)
    np.testing.assert_allclose(out, _out(net, x), atol=TOL[precision])
    sched = GenerationScheduler(reg, "lm", block_len=4, decode_buckets=(1,))
    try:
        res = sched.submit([3, 7, 1], max_tokens=6, timeout=300)
        assert res["generated_tokens"] == 6
        assert all(0 <= t < 32 for t in res["tokens"])
    finally:
        sched.stop()


# ---------------------------------------------------------------------------
# runner reuse, failed builds, compile metrics
# ---------------------------------------------------------------------------

def test_swap_bumps_version_and_reuses_runners():
    with telemetry.enabled() as sess:
        reg = ModelRegistry(buckets=(1, 4), metrics=sess.registry,
                            device="cpu")
        net_a, net_b = tiny_net(seed=1), tiny_net(seed=2)
        reg.register("m", net_a)
        out_a, v_a = reg.predict("m", rows(2))
        reg.swap("m", net_b)
        out_b, v_b = reg.predict("m", rows(2))
        assert (v_a, v_b) == (1, 2)
        assert not np.allclose(out_a, out_b)   # the new params serve
        np.testing.assert_allclose(out_b, _out(net_b, rows(2)),
                                   rtol=1e-5, atol=1e-6)
        # same architecture: one runner build per bucket across register
        # and swap
        rep = sess.compiles.report()
        for b in (1, 4):
            assert rep[f"serving/m:b{b}"]["count"] == 1, rep
        assert reg.ensure("m", net_a).version == 2


def test_swap_compile_failure_rejected_live_version_untouched():
    """A candidate whose warm-up fails is refused with a structured
    AotCompileError; the live version, its outputs, the runner cache and
    the compile accounting stay as they were."""
    reg = ModelRegistry(buckets=(1, 4), device="cpu")
    v1 = reg.register("m", tiny_net(seed=1))
    x = rows(2, seed=5)
    expected, _ = reg.predict("m", x)
    entry = reg._entries["m"]
    cache_before = dict(entry.compiled)
    compiles = reg.metrics.counter("dl4j_serving_compiles_total",
                                   labels=("model", "bucket"))
    n_compiles = sum(compiles.values().values())

    bad = tiny_net(seed=2, hidden=8)        # another architecture

    def boom(*args, **kw):
        raise ValueError("injected trace failure")

    bad.layers[0].apply = boom
    with pytest.raises(AotCompileError) as ei:
        reg.swap("m", bad)
    err = ei.value
    assert err.model == "m" and isinstance(err.cause, ValueError)
    assert "injected trace failure" in str(err)
    assert reg.get("m") is v1
    out, version = reg.predict("m", x)
    assert version == v1.version
    np.testing.assert_array_equal(out, expected)
    assert entry.compiled == cache_before
    assert sum(compiles.values().values()) == n_compiles
    assert reg.swap("m", tiny_net(seed=3)).version == v1.version + 1


def test_failed_decode_listener_aborts_the_swap():
    """A version listener that fails (the decode plane's capture, on the
    card) turns into AotCompileError and the live version keeps serving."""
    reg = ModelRegistry(buckets=(1,), device="cpu")
    v1 = reg.register("m", tiny_net(seed=1))

    def listener(event, version):
        raise RuntimeError("capture failed")

    reg.add_listener("m", listener)
    with pytest.raises(AotCompileError, match="capture failed"):
        reg.swap("m", tiny_net(seed=2))
    assert reg.get("m") is v1
    reg.remove_listener("m", listener)
    assert reg.swap("m", tiny_net(seed=2)).version == 2


def test_cached_step_is_served_while_a_swap_holds_the_lock():
    """A cache hit in `compile_cached` does not wait for the swap lock
    (a prefill during a swap); a miss does."""
    import threading

    reg = ModelRegistry(buckets=(1,), device="cpu")
    reg.register("m", tiny_net())
    step = reg.compile_cached("m", ("decode", "sig", "tick", 1),
                              lambda: "built", "decode-b1")
    held, release = threading.Event(), threading.Event()

    def swap():
        with reg._entries["m"].swap_lock:
            held.set()
            release.wait(30)

    t = threading.Thread(target=swap)
    t.start()
    try:
        held.wait(30)
        assert reg.compile_cached("m", ("decode", "sig", "tick", 1),
                                  lambda: "rebuilt", "decode-b1") == step
        got = []
        miss = threading.Thread(target=lambda: got.append(reg.compile_cached(
            "m", ("decode", "sig", "tick", 2), lambda: "b2", "decode-b2")))
        miss.start()
        miss.join(0.2)
        assert miss.is_alive() and not got      # the miss waits
    finally:
        release.set()
        t.join()
    miss.join(30)
    assert got == ["b2"]


def test_compile_counter_metric_exported():
    with telemetry.enabled() as sess:
        reg = ModelRegistry(buckets=(2,), metrics=sess.registry,
                            device="cpu")
        reg.register("m", tiny_net())
        text = sess.registry.prometheus_text()
        assert 'dl4j_serving_compiles_total{model="m",bucket="2"} 1' in text
        assert "dl4j_serving_model_version" in text


def test_int8_swap_reuses_runners_and_cache_is_bounded():
    """int8 scales are runtime tensors, so a re-quantized same-architecture
    swap reuses the runners; cycling architectures keeps the newest two
    signatures' runners."""
    with telemetry.enabled() as sess:
        reg = ModelRegistry(buckets=(1, 4), metrics=sess.registry,
                            device="cpu")
        reg.register("m", tiny_net(seed=1), precision="int8")
        reg.swap("m", tiny_net(seed=2), precision="int8")
        rep = sess.compiles.report()
        for b in (1, 4):
            assert rep[f"serving/m:b{b}"]["count"] == 1, rep
        out, v = reg.predict("m", rows(2))
        assert v == 2
        np.testing.assert_allclose(out, _out(tiny_net(seed=2), rows(2)),
                                   atol=5e-2)
        for h in (8, 24, 40):
            reg.swap("m", tiny_net(hidden=h))
        entry = reg._entries["m"]
        assert len(entry.sig_history) == 2
        assert len(entry.compiled) == 2 * 2   # 2 sigs x 2 buckets


# ---------------------------------------------------------------------------
# canary routing
# ---------------------------------------------------------------------------

def test_canary_routing_deterministic_fraction():
    reg = ModelRegistry(buckets=(1, 4), device="cpu")
    reg.register("m", tiny_net(0))
    assert reg.route_arm("m") == "stable"
    reg.start_canary("m", tiny_net(1), fraction=0.2)
    arms = [reg.route_arm("m") for _ in range(200)]
    assert arms.count("canary") == 40           # exactly 20% of each 100
    assert arms[:100] == arms[100:]
    reg.rollback_canary("m")


def test_same_arch_canary_zero_new_compiles_and_register_blocked():
    reg = ModelRegistry(buckets=(1, 4), device="cpu")
    reg.register("m", tiny_net(0))
    compiles = reg.metrics.counter("dl4j_serving_compiles_total",
                                   labels=("model", "bucket"))
    before = sum(compiles.values().values())
    cand = reg.start_canary("m", tiny_net(5), fraction=0.5)
    assert sum(compiles.values().values()) == before
    assert cand.version == reg.get("m").version + 1
    with pytest.raises(ServingError, match="canary"):
        reg.register("m", tiny_net(6))
    reg.rollback_canary("m")


def test_promote_flips_rollback_bit_exact_versions_monotonic():
    reg = ModelRegistry(buckets=(1, 4), device="cpu")
    v1 = reg.register("m", tiny_net(0))
    x = rows(3, seed=42)
    stable_out, ver = reg.predict("m", x)
    assert ver == v1.version
    cand = reg.start_canary("m", tiny_net(1), fraction=0.1)
    cand_out, cver = reg.predict("m", x, arm="canary")
    assert cver == cand.version and not np.array_equal(cand_out, stable_out)
    np.testing.assert_allclose(cand_out, _out(tiny_net(1), x), atol=1e-5)
    reg.rollback_canary("m")
    assert reg.get("m") is v1
    np.testing.assert_array_equal(reg.predict("m", x)[0], stable_out)
    cand2 = reg.start_canary("m", tiny_net(2), fraction=0.1)
    assert cand2.version > cand.version
    promoted = reg.promote_canary("m")
    assert reg.get("m") is promoted and promoted.version == cand2.version
    assert reg.canary_state("m") is None


def _http(method, url, body=None):
    req = urllib.request.Request(
        url, None if body is None else json.dumps(body).encode(),
        {"Content-Type": "application/json"}, method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            ct = resp.headers.get("Content-Type", "")
            data = resp.read()
            return resp.status, (json.loads(data) if "json" in ct
                                 else data.decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def test_http_canary_endpoints(tmp_path):
    reg = ModelRegistry(buckets=(1, 4), device="cpu")
    v1 = reg.register("m", tiny_net(0))
    ckpt = str(tmp_path / "cand.zip")
    ModelSerializer.write_model(tiny_net(3), ckpt)
    srv = InferenceServer(reg, max_wait_us=500).start()
    try:
        base = f"http://{srv.host}:{srv.port}/v1/models/m/canary"
        code, out = _http("GET", base)
        assert code == 200 and out == {"model": "m", "active": False}
        code, out = _http("POST", base, {"action": "start", "source": ckpt,
                                         "fraction": 0.5})
        assert code == 200 and out["canary"] is True
        cand_version = out["version"]
        # routing is by blocks of 100 requests: the first 50 of each go
        # to the candidate, through its own batcher
        x = rows(1, seed=9)
        for _ in range(4):
            code, r = _http("POST", f"http://{srv.host}:{srv.port}"
                            "/v1/models/m/predict", {"features": x.tolist()})
            assert code == 200 and r["version"] == cand_version
            np.testing.assert_allclose(r["output"], _out(tiny_net(3), x),
                                       atol=1e-5)
        assert ("m", "canary") in srv._batchers
        code, out = _http("GET", base)
        assert code == 200 and out["active"] is True
        assert out["version"] == cand_version and out["fraction"] == 0.5
        assert out["arms"]["canary"]["requests"] == 4
        code, _ = _http("POST", base, {"action": "start", "source": ckpt})
        assert code == 400
        code, out = _http("POST", base, {"action": "promote"})
        assert code == 200 and out["promoted"] is True
        assert out["version"] == cand_version
        assert reg.get("m").version == cand_version
        code, out = _http("POST", base, {"action": "start", "source": ckpt})
        assert code == 200
        code, out = _http("POST", base, {"action": "rollback"})
        assert code == 200 and out["rolled_back"] is True
        assert out["version"] == cand_version
        code, out = _http("POST", base, {"action": "resize"})
        assert code == 400 and "unknown canary action" in out["error"]
        code, _ = _http("GET", f"http://{srv.host}:{srv.port}"
                               "/v1/models/nope/canary")
        assert code == 404
    finally:
        srv.stop()
    assert v1.version < cand_version


def test_canary_generation_runs_on_its_own_scheduler():
    """With generation enabled, starting a canary starts the candidate
    arm's scheduler at once; generate requests split by the canary's
    fraction (the first request of each 100 at 0.01) and each arm's tokens
    are its version's; promote retires the candidate arm."""
    from deeplearning4j_tpu_torch.serving.decode import GenerationScheduler

    reg = ModelRegistry(buckets=(1,), device="cpu")
    srv = InferenceServer(reg, batching=False)
    try:
        reg.register("lm", _lm(seed=3))
        srv.enable_generation("lm", block_len=4, decode_buckets=(1, 2))
        cand = reg.start_canary("lm", _lm(seed=4), fraction=0.01)
        srv._canary_started("lm")
        assert ("lm", "canary") in srv._schedulers
        prompt = [5, 1, 9]
        want = {}
        for seed, version in ((3, 1), (4, cand.version)):
            solo = ModelRegistry(buckets=(1,), device="cpu")
            solo.register("lm", _lm(seed=seed))
            s = GenerationScheduler(solo, "lm", block_len=4,
                                    decode_buckets=(1,))
            want[version] = s.submit(prompt, max_tokens=5,
                                     timeout=300)["tokens"]
            s.stop()
        got = [srv.generate("lm", prompt, max_tokens=5, timeout=300)
               for _ in range(4)]
        arms = reg.canary_state("lm").stats()["arms"]
        assert arms["canary"]["requests"] == 1
        assert arms["stable"]["requests"] == 3
        assert [r["tokens"] for r in got] == [want[cand.version]] \
            + [want[1]] * 3
        reg.promote_canary("lm")
        srv._retire_canary("lm")
        assert ("lm", "canary") not in srv._schedulers
        assert srv.generate("lm", prompt, max_tokens=5,
                            timeout=300)["tokens"] == want[cand.version]
    finally:
        srv.stop()


def test_http_metrics_families():
    reg = ModelRegistry(buckets=(1, 4), device="cpu")
    reg.register("tiny", tiny_net())
    srv = InferenceServer(reg, max_wait_us=500).start()
    try:
        base = f"http://{srv.host}:{srv.port}"
        code, out = _http("POST", f"{base}/v1/models/tiny/predict",
                          {"features": rows(2, seed=1).tolist()})
        assert code == 200 and out["batched"] is True
        code, text = _http("GET", f"{base}/metrics")
        assert code == 200
        for family in ("dl4j_serving_requests_total",
                       "dl4j_serving_latency_seconds",
                       "dl4j_serving_batch_size",
                       "dl4j_serving_batch_rows_total",
                       "dl4j_serving_queue_wait_seconds",
                       "dl4j_serving_compiles_total",
                       "dl4j_serving_compile_seconds",
                       "dl4j_serving_swaps_total",
                       "dl4j_serving_model_version",
                       "dl4j_slo_latency_seconds"):
            assert family in text, f"{family} missing from /metrics"
    finally:
        srv.stop()
