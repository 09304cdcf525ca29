"""PyTorch port, telemetry on the CPU: the twins of `tests/test_telemetry.py`
(its ParallelTrainer case is in `tests/test_torch_parallel_loop.py`, its
Word2Vec case waits for ROADMAP A12): the
metrics registry and its exporters, the tracer, the capture watcher, the
resource watermarks, TelemetryListener on a fit, and the listener
satellites.

What a compile is in the port (telemetry/compile_watch.py): a CUDA-graph
capture of an entry point for a batch signature on the card, and the first
call of an eager entry point with a new batch signature; so a fit on
uniform batches counts one `nn/train_step` compile however many epochs it
runs, a window fit one `nn/superstep` capture per signature, and four
distinct batch shapes a storm.
"""
import json
import math
import threading
import warnings

import numpy as np
import pytest

import deeplearning4j_tpu_torch as pt
from deeplearning4j_tpu_torch import telemetry
from deeplearning4j_tpu_torch.datasets.iterators import (ArrayDataSetIterator,
                                                         DataSet)
from deeplearning4j_tpu_torch.optimize.listeners import (
    CollectScoresIterationListener, ComposableIterationListener,
    ParamAndGradientIterationListener, PerformanceListener,
    ScoreIterationListener, warn_scan_replay)
from deeplearning4j_tpu_torch.telemetry import (FlightRecorder,
                                                MetricsRegistry,
                                                ResourceWatermarks,
                                                TelemetryListener,
                                                TelemetrySession, Tracer,
                                                flight_recorder, install)
from deeplearning4j_tpu_torch.telemetry.compile_watch import (
    RecompilationStormWarning, roster_names, watch_compiles)
from torch_threads import one_torch_thread  # noqa: F401


def _mlp(n_in=8, n_out=3, seed=7):
    conf = (pt.NeuralNetConfiguration.builder().seed(seed)
            .updater(pt.Sgd(0.1)).list()
            .layer(pt.DenseLayer(n_out=16, activation="relu"))
            .layer(pt.OutputLayer(n_out=n_out, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(pt.InputType.feed_forward(n_in))
            .build())
    return pt.MultiLayerNetwork(conf, device="cpu").init()


def _data(n=64, n_in=8, n_out=3, seed=0):
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, n_in)).astype(np.float32)
    y = np.eye(n_out, dtype=np.float32)[r.integers(0, n_out, n)]
    return x, y


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------
def test_registry_counter_gauge():
    reg = MetricsRegistry()
    c = reg.counter("t_total", "help text")
    c.inc()
    c.inc(4)
    assert c.value() == 5
    with pytest.raises(ValueError):
        c.inc(-1)
    g = reg.gauge("t_gauge", "g", labels=("k",))
    g.set(2.5, k="a")
    g.set_max(1.0, k="a")
    assert g.value(k="a") == 2.5
    g.set_max(7.0, k="a")
    assert g.value(k="a") == 7.0
    assert reg.counter("t_total") is c
    with pytest.raises(ValueError):
        reg.gauge("t_total")


def test_registry_histogram_and_timer():
    reg = MetricsRegistry()
    h = reg.histogram("t_hist", "h", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 5.0, 50.0):
        h.observe(v)
    assert h.count() == 4
    assert h.sum() == pytest.approx(55.55)
    t = reg.timer("t_timer", "t")
    with t.time():
        pass
    assert t.count() == 1 and t.sum() >= 0.0


def test_prometheus_text_format():
    reg = MetricsRegistry()
    reg.counter("a_total", "the a", labels=("fn",)).inc(3, fn="x")
    reg.gauge("b_gauge", "the b").set(1.5)
    reg.histogram("c_seconds", "the c", buckets=(1.0,)).observe(0.5)
    txt = reg.prometheus_text()
    assert '# TYPE a_total counter' in txt
    assert 'a_total{fn="x"} 3' in txt
    assert 'b_gauge 1.5' in txt
    assert '# TYPE c_seconds histogram' in txt
    assert 'c_seconds_bucket{le="1"} 1' in txt
    assert 'c_seconds_bucket{le="+Inf"} 1' in txt
    assert 'c_seconds_count 1' in txt


def test_prometheus_text_survives_nan_and_inf():
    reg = MetricsRegistry()
    reg.gauge("nan_gauge").set(float("nan"))
    reg.gauge("inf_gauge").set(float("inf"))
    txt = reg.prometheus_text()
    assert "nan_gauge NaN" in txt
    assert "inf_gauge +Inf" in txt


def test_registry_thread_safety():
    reg = MetricsRegistry()
    c = reg.counter("race_total")
    h = reg.histogram("race_hist")

    def work():
        for _ in range(1000):
            c.inc()
            h.observe(0.001)
    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.value() == 8000
    assert h.count() == 8000


def test_jsonl_export_roundtrip(tmp_path):
    reg = MetricsRegistry()
    reg.counter("j_total").inc(2)
    p = tmp_path / "metrics.jsonl"
    reg.export_jsonl(p)
    reg.counter("j_total").inc(1)
    reg.export_jsonl(p, extra={"tag": "w2"})
    lines = p.read_text(encoding="utf-8").splitlines()
    assert len(lines) == 2
    r1, r2 = (json.loads(l) for l in lines)
    assert r1["metrics"]["j_total"]["values"][""] == 2
    assert r2["metrics"]["j_total"]["values"][""] == 3
    assert r2["tag"] == "w2"


# ---------------------------------------------------------------------------
# tracer and flight recorder
# ---------------------------------------------------------------------------
def test_tracer_chrome_trace(tmp_path):
    tr = Tracer()
    with tr.span("outer", step=1):
        with tr.span("inner"):
            pass
    tr.instant("marker")
    p = tmp_path / "trace.json"
    tr.export_chrome_trace(p)
    doc = json.loads(p.read_text(encoding="utf-8"))
    evs = doc["traceEvents"]
    names = [e["name"] for e in evs]
    assert "outer" in names and "inner" in names and "marker" in names
    x = next(e for e in evs if e["name"] == "outer")
    assert x["ph"] == "X" and x["dur"] >= 0 and "ts" in x
    assert x["args"] == {"step": 1}


def test_tracer_bounded_buffer():
    tr = Tracer(max_events=5)
    for i in range(20):
        tr.instant(f"e{i}")
    assert len(tr) == 5
    assert tr.dropped_events == 16
    assert tr.chrome_trace()["otherData"]["dropped_events"] == 16


def test_flight_recorder_ring_and_guard_dump(tmp_path):
    """The ring keeps the newest events; a guard that trips dumps it with
    the failing window's scores."""
    from deeplearning4j_tpu_torch.fault import (FaultyIterator,
                                                TrainingGuard)
    rec = FlightRecorder(capacity=8)
    prev = install(rec)
    try:
        for i in range(12):
            rec.record("e", i=i)
        assert [e["i"] for e in rec.snapshot()] == list(range(4, 12))
        assert rec.dropped() == 4
        x, y = _data()
        guard = TrainingGuard("skip_batch", flight_dump_dir=str(tmp_path))
        _mlp().fit(FaultyIterator(ArrayDataSetIterator(x, y, batch_size=16),
                                  nan_at=1), superstep=2, guard=guard)
        assert guard.last_flight_dump is not None
        assert list(tmp_path.glob("flightrecord-skip_batch-*.json"))
        assert flight_recorder() is rec
    finally:
        install(prev)


# ---------------------------------------------------------------------------
# the capture watcher
# ---------------------------------------------------------------------------
def test_compile_watcher_counts_and_storm():
    """A compile is the first call with a new batch signature: three
    shapes are three compiles, a repeated shape none, a fourth shape a
    storm."""
    sess = TelemetrySession(storm_threshold=3)
    fn = lambda x: x * 2
    with warnings.catch_warnings():
        warnings.simplefilter("error", RecompilationStormWarning)
        for n in (2, 3, 4):
            sess.compiles.call("f", fn, (np.ones(n),), {})
        sess.compiles.call("f", fn, (np.ones(2),), {})
    assert sess.compiles.count("f") == 3
    with pytest.warns(RecompilationStormWarning, match="recompilation storm"):
        sess.compiles.call("f", fn, (np.ones(5),), {})
    assert sess.compiles.count("f") == 4
    rep = sess.compiles.report()
    assert rep["f"]["count"] == 4 and rep["f"]["wall_s"] >= 0
    assert sess.registry.get("dl4j_graph_captures_total").value(
        function="f") == 4


def test_record_capture_counts_a_cuda_graph_capture():
    """The card's CapturedStep reports each capture with its wall time."""
    sess = TelemetrySession()
    sess.compiles.record_capture("nn/superstep", 0.25)
    assert sess.compiles.report()["nn/superstep"] == {"count": 1,
                                                      "wall_s": 0.25}
    assert any(e["name"] == "graph/capture:nn/superstep"
               for e in sess.tracer.events())


def test_watch_compiles_registers_the_roster():
    class Step:
        def run(self, x):
            return x
    s = Step()
    w = watch_compiles(s.run, "test/step_roster")
    assert "test/step_roster" in roster_names()
    assert w(3) == 3


# ---------------------------------------------------------------------------
# a fit under a session
# ---------------------------------------------------------------------------
def test_three_epoch_fit_produces_all_artifacts(tmp_path):
    x, y = _data()
    net = _mlp()
    with telemetry.enabled(sync_per_step=True) as sess:
        net.set_listeners(TelemetryListener(session=sess, report_window=4))
        net.fit(ArrayDataSetIterator(x, y, batch_size=16), epochs=3)
        prom = tmp_path / "metrics.prom"
        sess.export_prometheus(prom)
        txt = prom.read_text(encoding="utf-8")
        families = [l.split()[2] for l in txt.splitlines()
                    if l.startswith("# TYPE")]
        assert len(families) >= 6, families
        assert "dl4j_iterations_total" in families
        assert "dl4j_graph_captures_total" in families
        assert "dl4j_iterations_total 12" in txt
        assert "dl4j_samples_total 192" in txt
        assert "dl4j_epochs_total 3" in txt
        trace = tmp_path / "trace.json"
        sess.export_chrome_trace(trace)
        doc = json.loads(trace.read_text(encoding="utf-8"))
        names = {e["name"] for e in doc["traceEvents"]}
        assert "host/batch_prep" in names
        assert "device/dispatch" in names
        for e in doc["traceEvents"]:
            if e["ph"] == "X":
                assert e["dur"] >= 0 and "ts" in e and "pid" in e
        rep = sess.compiles.report()
        assert rep["nn/train_step"]["count"] == 1, rep
        jl = tmp_path / "metrics.jsonl"
        sess.export_jsonl(jl)
        rec = json.loads(jl.read_text(encoding="utf-8").splitlines()[0])
        assert rec["metrics"]["dl4j_iterations_total"]["values"][""] == 12
    assert telemetry.active() is None


def test_shape_churn_fires_storm_warning():
    x, y = _data(n=48)
    net = _mlp()
    with telemetry.enabled(storm_threshold=3):
        with pytest.warns(RecompilationStormWarning,
                          match="nn/train_step.*captured 4"):
            for b in (8, 9, 10, 11):
                net.fit(DataSet(x[:b], y[:b]))


def test_fit_scan_path_counts_scan_compile():
    x, y = _data()
    net = _mlp()
    xs = np.stack([x[:16], x[16:32], x[32:48]])
    ys = np.stack([y[:16], y[16:32], y[32:48]])
    with telemetry.enabled() as sess:
        net.set_listeners(TelemetryListener(session=sess))
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            net.fit_scan_arrays(xs, ys, epochs=2)
        assert sess.compiles.report()["nn/scan_epoch"]["count"] == 1
        assert sess.registry.get("dl4j_iterations_total").value() == 6
        spans = sess.span_totals()
        assert spans.get("device/dispatch", 0) > 0
        assert "device/sync" in spans


def test_superstep_window_spans_and_one_capture():
    """A window fit: one nn/superstep compile for the one signature, the
    window's spans, and the listeners fed per optimizer step."""
    x, y = _data()
    net = _mlp()
    with telemetry.enabled() as sess:
        net.set_listeners(TelemetryListener(session=sess))
        net.fit(ArrayDataSetIterator(x, y, batch_size=16), epochs=3,
                superstep=2)
        assert sess.compiles.count("nn/superstep") == 1
        assert sess.compiles.count("nn/train_step") == 0
        assert sess.registry.get("dl4j_iterations_total").value() == 12
        spans = sess.span_totals()
        assert spans["device/dispatch"] > 0 and "device/sync" in spans


def test_computation_graph_telemetry():
    b = (pt.NeuralNetConfiguration.builder().seed(3).updater(pt.Sgd(0.1))
         .graph_builder())
    b.add_inputs("in")
    b.add_layer("d", pt.DenseLayer(n_out=16, activation="relu"), "in")
    b.add_layer("out", pt.OutputLayer(n_out=3, activation="softmax",
                                      loss="mcxent"), "d")
    b.set_outputs("out")
    b.set_input_types(pt.InputType.feed_forward(8))
    g = pt.ComputationGraph(b.build(), device="cpu").init()
    x, y = _data()
    with telemetry.enabled(sync_per_step=True) as sess:
        g.set_listeners(TelemetryListener(session=sess))
        g.fit(ArrayDataSetIterator(x, y, batch_size=16), epochs=2)
        assert sess.compiles.report()["graph/train_step"]["count"] == 1
        names = {e["name"] for e in sess.tracer.events()}
        assert "host/batch_prep" in names and "device/dispatch" in names


def test_resource_watermarks_sample_the_host():
    """On the CPU the watermarks read the process RSS and no device
    series; a card adds its allocated and peak bytes (the card tests
    hold that)."""
    reg = MetricsRegistry()
    w = ResourceWatermarks(reg)
    s = w.sample(devices=())
    assert s["host_rss_mb"] > 0 and s["host_rss_peak_mb"] >= s["host_rss_mb"]
    assert not any(k.startswith("device") for k in s)
    assert reg.get("dl4j_host_rss_mb").value() > 0


def test_disabled_telemetry_is_inert():
    assert telemetry.active() is None
    x, y = _data(n=16)
    _mlp().fit(DataSet(x, y))
    assert telemetry.active() is None


# ---------------------------------------------------------------------------
# listener satellites
# ---------------------------------------------------------------------------
def test_performance_listener_counts_warmup_and_never_nan():
    x, y = _data(n=64)
    net = _mlp()
    perf = PerformanceListener(frequency=1)
    net.set_listeners(perf)
    net.fit(ArrayDataSetIterator(x, y, batch_size=16), epochs=1)
    assert len(perf.history) == 4
    assert perf.history[0].get("warmup") is True
    assert all(not rec.get("warmup") for rec in perf.history[1:])
    for rec in perf.history:
        assert math.isfinite(rec["samples_per_sec"])
        assert math.isfinite(rec["batches_per_sec"])
        assert rec["samples_per_sec"] > 0


def test_performance_listener_clamps_zero_dt():
    perf = PerformanceListener(frequency=1)

    class M:
        last_batch_size = 8

        def score(self):
            return 0.0
    perf.iteration_done(M(), 1)
    perf.iteration_done(M(), 2)
    assert all(math.isfinite(r["samples_per_sec"]) for r in perf.history)


def test_collect_scores_export_roundtrip(tmp_path):
    lis = CollectScoresIterationListener()
    lis.scores = [(1, 0.75), (2, 0.5), (3, 0.25)]
    p = tmp_path / "scores.csv"
    lis.export_scores(p)
    raw = p.read_bytes()
    assert b"\r\n" not in raw
    raw.decode("utf-8")
    back = CollectScoresIterationListener.load_scores(p)
    assert back == [(1, 0.75), (2, 0.5), (3, 0.25)]
    with pytest.raises(ValueError):
        bad = tmp_path / "bad.csv"
        bad.write_text("nope\n", encoding="utf-8")
        CollectScoresIterationListener.load_scores(bad)


def test_warn_scan_replay_fires_for_nested_composable_trees():
    nested = ComposableIterationListener(
        ScoreIterationListener(1),
        ComposableIterationListener(ParamAndGradientIterationListener()))
    with pytest.warns(UserWarning,
                      match="ParamAndGradientIterationListener"):
        warn_scan_replay([nested])


def test_warn_scan_replay_silent_for_plain_score_listeners():
    listeners = [ScoreIterationListener(1),
                 CollectScoresIterationListener(),
                 PerformanceListener(),
                 ComposableIterationListener(ScoreIterationListener(5))]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        warn_scan_replay(listeners)


def test_warn_scan_replay_silent_for_telemetry_listener():
    with telemetry.enabled() as sess:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            warn_scan_replay([TelemetryListener(session=sess)])
