"""PyTorch port, the parallel stack's stats and clocks on the CPU: the
twins of `tests/test_training_stats.py` and of the time-source half of
`tests/test_timesource_labeledpoint.py` (`parallel/stats.py`,
`parallel/timesource.py`, which is the port's copy of JAX's framework-free
module), `profiler_trace` on `torch.profiler`, and the trainer's
`elastic_state` / `load_elastic_state` and prefetch in one process.
"""
import json
import os
import time

import numpy as np
import pytest
import torch

import deeplearning4j_tpu_torch as pt
from deeplearning4j_tpu_torch.parallel import (ParallelTrainer,
                                               TrainingMode, TrainingStats,
                                               make_mesh, profiler_trace)
from deeplearning4j_tpu_torch.parallel import timesource as m
from torch_threads import one_torch_thread  # noqa: F401


def _model(seed=1):
    conf = (pt.NeuralNetConfiguration.builder().seed(seed)
            .updater(pt.Adam(1e-2)).list()
            .layer(pt.DenseLayer(n_out=16, activation="relu"))
            .layer(pt.OutputLayer(n_out=2, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(pt.InputType.feed_forward(8)).build())
    return pt.MultiLayerNetwork(conf, device="cpu").init()


def _ds(n=64):
    rng = np.random.default_rng(0)
    return pt.DataSet(rng.normal(size=(n, 8)).astype(np.float32),
                      np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)])


def _mesh():
    return make_mesh(device="cpu")


# ----------------------------- stats ---------------------------------------
def test_training_stats_units():
    st = TrainingStats()
    with st.time("fit"):
        pass
    st.add("broadcast", 12.5)
    st.add("fit", 3.0)
    assert st.get_keys() == ["fit", "broadcast"]
    assert st.get_values_for_key("broadcast") == [12.5]
    assert st.summary()["fit"]["count"] == 2
    json.loads(st.as_json())


def test_sync_trainer_collects_phase_stats():
    tr = ParallelTrainer(_model(), mesh=_mesh(), collect_stats=True)
    for _ in range(3):
        tr.fit(_ds())
    assert set(tr.stats.get_keys()) == {"data", "step"}
    assert len(tr.stats.get_values_for_key("step")) == 3
    assert all(v > 0 for v in tr.stats.get_values_for_key("step"))


def test_averaging_trainer_collects_average_phase(tmp_path):
    tr = ParallelTrainer(_model(), mesh=_mesh(), mode=TrainingMode.AVERAGING,
                         averaging_frequency=2, collect_stats=True)
    for _ in range(4):
        tr.fit(_ds())
    assert "average" in tr.stats.get_keys()
    assert len(tr.stats.get_values_for_key("average")) == 2
    out = str(tmp_path / "timeline.html")
    tr.stats.export_html(out)
    html = open(out).read()
    assert "Training phase timeline" in html and "average" in html


def test_training_stats_epoch_stamps():
    class Shifted(m.TimeSource):
        def current_time_millis(self):
            return int(time.time() * 1000) + 5_000_000

    st = TrainingStats(time_source=Shifted())
    with st.time("step"):
        pass
    ev = st.events()
    assert ev and ev[0]["key"] == "step"
    assert ev[0]["epoch_ms"] - time.time() * 1000 > 4_000_000


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    with profiler_trace(str(tmp_path / "prof")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert os.path.exists(tmp_path / "prof" / "trace.json")
    assert any("mm" in e.key for e in prof.key_averages())


# ----------------------------- time source ---------------------------------
def test_coordinator_time_source_recovers_offset():
    skew = 123.456
    with m.TimeServer() as srv:
        ts = m.CoordinatorTimeSource(srv.host, srv.port, samples=8,
                                     clock=lambda: time.time() + skew)
        assert abs(ts.offset_ms() + skew * 1000) < 50
        assert abs(ts.current_time_millis() - time.time() * 1000) < 100


def test_time_source_refresh_and_caching():
    with m.TimeServer() as srv:
        ts = m.CoordinatorTimeSource(srv.host, srv.port, samples=2,
                                     frequency_sec=1000.0)
        o1 = ts.offset_ms()
        measured_at = ts._measured_at
        ts.offset_ms()
        assert ts._measured_at == measured_at
        ts.frequency_sec = 0.0
        ts.offset_ms()
        deadline = time.time() + 5
        while ts._measured_at == measured_at and time.time() < deadline:
            time.sleep(0.02)
        assert ts._measured_at > measured_at
        assert abs(o1) < 50


def test_time_source_survives_dead_server():
    srv = m.TimeServer()
    ts = m.CoordinatorTimeSource(srv.host, srv.port, samples=2,
                                 frequency_sec=1000.0, timeout=0.5)
    first = ts.offset_ms()
    srv.close()
    ts.frequency_sec = 0.0
    for _ in range(3):
        assert ts.offset_ms() == pytest.approx(first)
        time.sleep(0.1)
    with pytest.raises(OSError):
        m.CoordinatorTimeSource("127.0.0.1", srv.port, samples=1,
                                timeout=0.3)


def test_time_source_provider_env(monkeypatch):
    monkeypatch.delenv(m.SOURCE_ENV, raising=False)
    assert isinstance(m.get_time_source(), m.SystemClockTimeSource)
    monkeypatch.setenv(m.SOURCE_ENV, "coordinator")
    monkeypatch.delenv(m.SERVER_ENV, raising=False)
    with pytest.raises(ValueError, match="requires"):
        m.get_time_source()
    srv = m.TimeServer()
    monkeypatch.setenv(m.SERVER_ENV, f"{srv.host}:{srv.port}")
    assert isinstance(m.get_time_source(), m.CoordinatorTimeSource)
    srv.close()
    monkeypatch.setenv(m.SERVER_ENV, "127.0.0.1:9")
    with pytest.raises(OSError):
        m.get_time_source()
    monkeypatch.setenv(m.SOURCE_ENV, "bogus")
    with pytest.raises(ValueError, match="unknown"):
        m.get_time_source()


# ----------------------------- the trainer ---------------------------------
@pytest.mark.parametrize("src,dst", [("zero2", "replicated"),
                                     ("replicated", "fsdp"),
                                     ("zero1", "zero2")])
def test_elastic_state_relands_under_another_strategy(src, dst):
    """The logical state of one trainer, loaded into another strategy's,
    continues bit-equal to the uninterrupted run."""
    ref = ParallelTrainer(_model(), mesh=_mesh(), strategy=src)
    for _ in range(4):
        ref.fit(_ds())
    a = ParallelTrainer(_model(), mesh=_mesh(), strategy=src)
    for _ in range(2):
        a.fit(_ds())
    tree, meta = a.elastic_state()
    assert meta["iteration_count"] == 2 and meta["strategy"] == src
    assert meta["mesh_axes"] == {"data": 1}
    b = ParallelTrainer(_model(seed=9), mesh=_mesh(), strategy=dst)
    b.load_elastic_state(tree, json.loads(json.dumps(meta)))
    assert b.iteration_count == 2
    for _ in range(2):
        b.fit(_ds())
    np.testing.assert_array_equal(b.model.params_flat(),
                                  ref.model.params_flat())


def test_prefetch_trains_the_same_bits():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(64, 8)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 64)]
    a = ParallelTrainer(_model(), mesh=_mesh(), strategy="zero2")
    a.fit(pt.ArrayDataSetIterator(x, y, batch_size=16), epochs=2)
    b = ParallelTrainer(_model(), mesh=_mesh(), strategy="zero2")
    b.fit(pt.ArrayDataSetIterator(x, y, batch_size=16), epochs=2,
          prefetch=True, superstep=2)
    np.testing.assert_array_equal(a.model.params_flat(),
                                  b.model.params_flat())


def test_elastic_counters_feed_the_session_summary():
    """The elastic loop's counters (`fault/metrics.py`) land in the
    session's elastic summary under JAX's family names."""
    from deeplearning4j_tpu_torch import telemetry
    from deeplearning4j_tpu_torch.fault.metrics import (count_elastic,
                                                        elastic_snapshot_timer)
    with pytest.raises(ValueError, match="unknown elastic event"):
        count_elastic("bogus")
    with telemetry.enabled() as sess:
        count_elastic("worker_losses")
        count_elastic("resizes", 2)
        with elastic_snapshot_timer():
            pass
        summary = sess.elastic_summary()
        assert sess.registry.get("dl4j_elastic_resizes_total").value() == 2
    assert summary["worker_losses"] == 1 and summary["resizes"] == 2
    assert summary["snapshots"] == 1
    count_elastic("drains")          # no session: a no-op
