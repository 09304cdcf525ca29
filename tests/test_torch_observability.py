"""PyTorch port, request tracing and the SLO surface on the CPU: twin of
`tests/test_observability.py`'s trace-context, SLO, `/generate` trace,
error-body trace id and `/debug/flightrecord` tests, plus the batched
predict path's spans and the overhead bench's plumbing.

The JAX package's `TraceContext` and `SloSurface` run beside the port's on
the same calls: the span trees and the burn accounting must agree. The
`/generate` trace is served by the port's LM on the JAX LM's parameters,
and its tokens are held to the JAX scheduler's.
"""
import functools
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu import (Adam as JaxAdam,
                                EmbeddingSequenceLayer as JaxEmbedding,
                                InputType as JaxInputType,
                                MultiLayerNetwork as JaxNet,
                                NeuralNetConfiguration as JaxNNC,
                                RnnOutputLayer as JaxRnnOutput,
                                TransformerBlock as JaxBlock)
from deeplearning4j_tpu import telemetry as jax_telemetry
from deeplearning4j_tpu.serving.decode import \
    GenerationScheduler as JaxScheduler
from deeplearning4j_tpu.serving.registry import \
    ModelRegistry as JaxModelRegistry
from deeplearning4j_tpu.telemetry.trace_context import (
    SloSurface as JaxSloSurface, TraceContext as JaxTraceContext)
from deeplearning4j_tpu_torch import (Adam, DenseLayer,
                                      EmbeddingSequenceLayer, InputType,
                                      MultiLayerNetwork,
                                      NeuralNetConfiguration, OutputLayer,
                                      RnnOutputLayer, TransformerBlock,
                                      from_jax_params)
from deeplearning4j_tpu_torch.telemetry import enabled
from deeplearning4j_tpu_torch.telemetry.recorder import (FlightRecorder,
                                                         flight_recorder,
                                                         install)
from deeplearning4j_tpu_torch.telemetry.trace_context import (
    DEFAULT_SLO_TARGETS, SloSurface, TraceContext)
from jax_reference import jax_init
from torch_threads import one_torch_thread, pinned  # noqa: F401

pytestmark = pytest.mark.sanitize(
    allow_threads=("dl4j-decode-sched-", "dl4j-torch-serving-http",
                   "dl4j-torch-serving-batcher-"))

PROMPT, MAX_TOKENS = [1, 2, 3], 6


@pytest.fixture
def fresh_recorder():
    """Isolate the process-wide flight recorder per test."""
    prev = install(FlightRecorder(capacity=256))
    yield flight_recorder()
    install(prev)


def _lm_conf(nnc, embedding, block, output, input_type, adam):
    b = (nnc.builder().seed(0).updater(adam(1e-3)).list()
         .layer(embedding(n_in=32, n_out=16)))
    for _ in range(2):
        b = b.layer(block(n_heads=4))
    return (b.layer(output(n_out=32, activation="softmax", loss="mcxent"))
            .set_input_type(input_type.recurrent(1, 32)).build())


@functools.lru_cache(maxsize=None)
def _lms():
    """(JAX LM, the port's LM on its parameters, JAX's greedy tokens for
    PROMPT)."""
    jnet = jax_init(JaxNet(_lm_conf(JaxNNC, JaxEmbedding, JaxBlock,
                                    JaxRnnOutput, JaxInputType, JaxAdam)))
    params = [{k: np.asarray(v) for k, v in p.items()} for p in jnet.params]
    net = from_jax_params(MultiLayerNetwork(
        _lm_conf(NeuralNetConfiguration, EmbeddingSequenceLayer,
                 TransformerBlock, RnnOutputLayer, InputType, Adam),
        device="cpu").init(), params)
    reg = JaxModelRegistry(buckets=(1,))
    reg.register("gen", jnet)
    sched = JaxScheduler(reg, "gen", block_len=4, decode_buckets=(1,))
    try:
        tokens = sched.submit(PROMPT, max_tokens=MAX_TOKENS,
                              timeout=300)["tokens"]
    finally:
        sched.stop()
    return jnet, net, tokens


def _http(method, url, body=None, headers=None, timeout=120):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type":
                                          "application/json",
                                          **(headers or {})})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, dict(r.headers), json.loads(r.read())


def _trace(tracer, trace_id):
    return [e for e in tracer.events()
            if e.get("ph") == "X"
            and e.get("args", {}).get("trace_id") == trace_id]


# ---------------------------------------------------------------------------
# TraceContext / SloSurface units, beside JAX's
# ---------------------------------------------------------------------------

def _links(ctx, tracer):
    """(span name, parent name) of a trace's spans, and the root's tier."""
    evts = {e["args"]["span_id"]: e for e in _trace(tracer, ctx.trace_id)}
    names = {sid: e["name"] for sid, e in evts.items()}
    return (sorted((e["name"], names.get(e["args"]["parent_id"]))
                   for e in evts.values()),
            evts[ctx.span_id]["args"]["tier"])


def _drive_context(cls, tracer):
    ctx = cls.begin(tier="interactive", trace_id="0123456789abcdef")
    assert ctx.span_id == f"{ctx.trace_id}.0"
    with ctx.span("child_a", foo=1):
        pass
    sid_b = ctx.emit("child_b", 0.0, 0.1)
    sid_c = ctx.emit("grandchild", 0.1, 0.2, parent=sid_b)
    ctx.emit_root("http/test", code=200)
    assert sid_b != sid_c and sid_b.startswith(ctx.trace_id + ".")
    return ctx, _links(ctx, tracer)


def test_trace_context_parent_links():
    with enabled() as sess:
        ctx, (links, tier) = _drive_context(TraceContext, sess.tracer)
        assert len(links) == 4 and tier == "interactive"
        assert ("child_b", "http/test") in links
        assert ("grandchild", "child_b") in links
        assert ("http/test", None) in links
    with jax_telemetry.enabled() as jsess:
        jctx, jax_links = _drive_context(JaxTraceContext, jsess.tracer)
    assert (links, tier) == jax_links
    assert [e["args"]["span_id"] for e in _trace(sess.tracer, ctx.trace_id)] \
        == [e["args"]["span_id"] for e in _trace(jsess.tracer, jctx.trace_id)]


def test_trace_context_without_session_is_inert():
    ctx = TraceContext.begin()
    sid = ctx.emit("nothing", 0.0, 0.1)    # no active tracer: id only
    assert sid.startswith(ctx.trace_id)
    ctx.emit_root("nothing")               # no-op, no raise
    assert ctx.elapsed() >= 0.0


def _drive_slo(slo):
    assert slo.targets == DEFAULT_SLO_TARGETS
    slo.observe("interactive", 0.01)       # within the 0.25 s target
    slo.observe("interactive", 1.0)        # breach
    slo.observe("undeclared", 99.0)        # histogram only
    slo.declare("bulk", 10.0)
    slo.observe("bulk", 0.5)
    return slo.summary(), slo.burn_rate("interactive")


def test_slo_surface_burn_accounting():
    with enabled() as sess:
        summary, burn = _drive_slo(SloSurface(sess.registry,
                                              error_budget=0.01))
        assert burn == pytest.approx(50.0)
        assert summary["interactive"]["breaches"] == 1
        assert summary["interactive"]["requests"] == 2
        assert "undeclared" not in summary
        assert summary["bulk"]["breaches"] == 0
        text = sess.registry.prometheus_text()
        assert "dl4j_slo_latency_seconds" in text
        assert "dl4j_slo_burn_rate" in text
    with jax_telemetry.enabled() as jsess:
        assert (summary, burn) == _drive_slo(
            JaxSloSurface(jsess.registry, error_budget=0.01))


# ---------------------------------------------------------------------------
# HTTP end to end: the connected-trace acceptance test
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served():
    from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
    from deeplearning4j_tpu_torch.serving.server import InferenceServer

    with enabled() as sess:
        registry = ModelRegistry(buckets=(1,), metrics=sess.registry,
                                 device="cpu")
        srv = InferenceServer(registry, batching=False, port=0)
        srv.start()
        try:
            with pinned():
                registry.register("gen", _lms()[1])
                srv.enable_generation("gen", block_len=4,
                                      decode_buckets=(1, 2))
            yield srv, sess
        finally:
            srv.stop()


def test_generate_yields_one_connected_trace(served, fresh_recorder):
    srv, sess = served
    url = f"http://127.0.0.1:{srv.port}/v1/models/gen/generate"
    code, headers, out = _http(
        "POST", url, {"prompt": PROMPT, "max_tokens": MAX_TOKENS},
        headers={"X-DL4J-SLO-Tier": "interactive"})
    assert code == 200 and out["tokens"] == _lms()[2]
    trace_id = headers["X-DL4J-Trace"]
    evts = _trace(sess.tracer, trace_id)
    by_name = {}
    for e in evts:
        by_name.setdefault(e["name"], []).append(e)
    root = by_name["http/generate"][0]["args"]
    assert root["parent_id"] is None and root["tier"] == "interactive"
    rid = root["span_id"]
    # the request's whole lifecycle hangs off the one root span
    for stage in ("queue_wait", "bucket_select", "prefill", "scatter"):
        assert len(by_name[stage]) == 1, stage
        assert by_name[stage][0]["args"]["parent_id"] == rid, stage
    ticks = by_name["decode_tick"]
    assert len(ticks) == MAX_TOKENS - 1     # the prefill samples the first
    assert all(t["args"]["parent_id"] == rid for t in ticks)
    sids = [e["args"]["span_id"] for e in evts]
    assert len(set(sids)) == len(sids)
    assert srv.slo.summary()["interactive"]["requests"] >= 1
    kinds = {e["kind"] for e in fresh_recorder.snapshot()}
    assert "decode/admit" in kinds


def test_batched_predict_yields_one_connected_trace(served):
    """A batched predict's spans: queue_wait, batch_forward and scatter
    under the HTTP root."""
    srv, sess = served
    conf = (NeuralNetConfiguration.builder().seed(1).list()
            .layer(DenseLayer(n_out=8, activation="relu"))
            .layer(OutputLayer(n_out=3, loss="mcxent"))
            .set_input_type(InputType.feed_forward(4)).build())
    srv.registry.register("mlp", MultiLayerNetwork(conf, device="cpu"))
    url = f"http://127.0.0.1:{srv.port}/v1/models/mlp/predict"
    code, headers, out = _http("POST", url, {"features": [[0.0] * 4],
                                             "batched": True})
    assert code == 200 and out["batched"] is True
    evts = _trace(sess.tracer, headers["X-DL4J-Trace"])
    names = sorted(e["name"] for e in evts)
    assert names == ["batch_forward", "http/predict", "queue_wait",
                     "scatter"]
    root = [e for e in evts if e["name"] == "http/predict"][0]["args"]
    assert all(e["args"]["parent_id"] == root["span_id"] for e in evts
               if e["name"] != "http/predict")


def test_error_body_carries_trace_id(served):
    srv, _ = served
    url = f"http://127.0.0.1:{srv.port}/v1/models/nope/generate"
    with pytest.raises(urllib.error.HTTPError) as ei:
        _http("POST", url, {"prompt": [1]})
    err = ei.value
    body = json.loads(err.read())
    assert err.code == 404 and "error" in body
    assert body["trace_id"] == err.headers["X-DL4J-Trace"]


def test_debug_flightrecord_endpoint(served, fresh_recorder):
    srv, _ = served
    fresh_recorder.record("test/ping", n=1)
    code, headers, body = _http(
        "GET", f"http://127.0.0.1:{srv.port}/debug/flightrecord")
    assert code == 200 and body["enabled"]
    assert body["capacity"] == 256
    assert any(e["kind"] == "test/ping" for e in body["events"])
    assert headers["X-DL4J-Trace"]


def test_obs_bench_serving_arm_runs():
    """The overhead bench's serving arm, one short pair: all three windows
    served every request, and its cost split counts the batcher's three
    child spans a traced request."""
    from deeplearning4j_tpu_torch.telemetry.obs_bench import _serving_arm

    out = _serving_arm(pairs=1, clients=2, requests=5, device="cpu")
    (pair,) = out["pairs"]
    for arm in ("off", "client", "on"):
        assert pair[arm]["req_s"] > 0 and "errors" not in pair[arm]
    assert out["ratio"] is not None
    split = out["cost_split"]
    assert split["child_spans_per_request"] == 3
    assert set(split["request_wall_gained_us"]) == {"client", "on"}
