"""PyTorch port, the dashboard (`deeplearning4j_tpu_torch/ui/`) and the
evaluation charts (`eval/tools.py`) on the CPU, held against the JAX package.

The twins of `tests/test_ui.py` (22) run the port's listener, storages,
server, router, legacy listeners, components and charts on port models.
Parity, on the same models (one zip, or a graph carried across with
`from_jax_params`) and the same batches:
  * StatsListener's reports on a MultiLayerNetwork and a ComputationGraph
    equal JAX's: score at 1e-5; each parameter's and update's mean, stdev,
    min and max at 1e-5 of the tensor's largest magnitude (the update's
    own scale for updates); histogram bin counts within 1 (a value within
    rounding of a bin edge may fall on the other side); the topology equal;
  * stats files (JSON lines and sqlite) written by either package read back
    equal in the other;
  * the components, the dashboard page and `train_data`, and
    `EvaluationTools`' three HTML exports are JAX's bytes for the same
    inputs;
  * the convolutional listener's activations (NHWC in both packages) at
    1e-5, its grids within one grey level;
  * a windowed fit warns that the listener's parameter summaries are
    end-of-window snapshots (`warn_scan_replay`), as JAX's does.
"""
import json
import time
import urllib.request

import numpy as np
import pytest
import torch

import deeplearning4j_tpu as jx
from deeplearning4j_tpu import ui as jui
from deeplearning4j_tpu.eval import evaluation as jeval
from deeplearning4j_tpu.eval import roc as jroc
from deeplearning4j_tpu.eval import tools as jtools
from deeplearning4j_tpu.nn.conf import graph as jgraph
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.ui import components as jcomp
from deeplearning4j_tpu.ui import server as jserver
import deeplearning4j_tpu_torch as pt
from deeplearning4j_tpu_torch import (Adam, DataSet, DenseLayer, InputType,
                                      MultiLayerNetwork,
                                      NeuralNetConfiguration, OutputLayer)
from deeplearning4j_tpu_torch import ui as pui
from deeplearning4j_tpu_torch.ui import components as pcomp
from deeplearning4j_tpu_torch.ui import server as pserver
from deeplearning4j_tpu_torch.ui import (FileStatsStorage,
                                         InMemoryStatsStorage, StatsListener,
                                         StatsStorageEvent, UIServer)
from jax_reference import jax_init
from torch_graph_pair import port_twin
from torch_threads import one_torch_thread, pinned  # noqa: F401

SCORE_TOL = 1e-5      # a report's score
SUMMARY_TOL = 1e-5    # summaries, of the tensor's largest magnitude
HIST_TOL = 1          # a histogram bin's count


def _small_model(seed=5):
    conf = (NeuralNetConfiguration.builder()
            .seed(seed).updater(Adam(1e-2))
            .list()
            .layer(DenseLayer(n_out=8, activation="relu"))
            .layer(OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(4))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


# the UI stack spawns HTTP server and router threads: every test runs under
# the thread-leak watchdog and lock-order shims, as JAX's twins do, so a
# server that outlives its test fails loudly
pytestmark = pytest.mark.sanitize()


def _train(model, listener, steps=5):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, 4)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 32)]
    model.set_listeners(listener)
    for _ in range(steps):
        model.fit(DataSet(x, y))


def test_stats_listener_collects_reports():
    storage = InMemoryStatsStorage()
    listener = StatsListener(storage, session_id="s1")
    model = _small_model()
    _train(model, listener, steps=4)
    assert storage.list_session_ids() == ["s1"]
    updates = storage.get_all_updates("s1", StatsListener.TYPE_ID, "local")
    assert len(updates) == 4
    ts, report = updates[-1]
    assert np.isfinite(report["score"])
    assert "layer0/W" in report["params"]
    h = report["params"]["layer0/W"]["histogram"]
    assert sum(h["counts"]) == 4 * 8  # every weight binned
    assert "updates" in report  # param deltas from iteration 2 on
    assert report["memory"]["rss_mb"] > 0


def test_stats_listener_frequency_and_events():
    storage = InMemoryStatsStorage()
    events = []
    storage.register_listener(events.append)
    listener = StatsListener(storage, frequency=2, session_id="s2")
    _train(_small_model(), listener, steps=6)
    updates = storage.get_all_updates("s2", StatsListener.TYPE_ID, "local")
    assert len(updates) == 3  # every 2nd iteration
    kinds = [e.kind for e in events]
    assert kinds.count(StatsStorageEvent.NEW_SESSION) == 1
    assert kinds.count(StatsStorageEvent.POST_UPDATE) == 3


def test_file_stats_storage_round_trip(tmp_path):
    path = str(tmp_path / "stats.jsonl")
    storage = FileStatsStorage(path)
    listener = StatsListener(storage, session_id="persisted")
    _train(_small_model(), listener, steps=3)

    # fresh storage instance replays the file (the round-trip test the
    # reference runs on FileStatsStorage)
    reloaded = FileStatsStorage(path)
    assert reloaded.list_session_ids() == ["persisted"]
    orig = storage.get_all_updates("persisted", StatsListener.TYPE_ID, "local")
    rep = reloaded.get_all_updates("persisted", StatsListener.TYPE_ID, "local")
    assert len(rep) == 3
    assert json.dumps(rep) == json.dumps(orig)


def test_ui_server_serves_dashboard_and_data():
    storage = InMemoryStatsStorage()
    listener = StatsListener(storage, session_id="ui-sess")
    model = _small_model()
    _train(model, listener, steps=4)

    server = UIServer(port=0).attach(storage).start()  # port 0 = ephemeral
    try:
        base = f"http://127.0.0.1:{server.port}"
        html = urllib.request.urlopen(base + "/train/overview").read().decode()
        assert "deeplearning4j_tpu" in html
        sessions = json.loads(
            urllib.request.urlopen(base + "/train/sessions.json").read())
        assert sessions == ["ui-sess"]
        data = json.loads(
            urllib.request.urlopen(base + "/train/data.json").read())
        assert data["session"] == "ui-sess"
        assert len(data["scores"]) == 4
        assert "layer0/W" in data["params"]
        missing = urllib.request.urlopen(base + "/nope")
    except urllib.error.HTTPError as e:
        assert e.code == 404
    finally:
        server.stop()


def test_stats_listener_works_with_computation_graph():
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration as NNC

    b = (NNC.builder().seed(1).updater(Adam(1e-2)).graph_builder()
         .add_inputs("in"))
    b.add_layer("d", DenseLayer(n_out=6, activation="relu"), "in")
    b.add_layer("out", OutputLayer(n_out=2, activation="softmax",
                                   loss="mcxent"), "d")
    b.set_outputs("out")
    from deeplearning4j_tpu_torch.nn.conf.input_type import InputType as IT
    b.set_input_types(IT.feed_forward(4))
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    g = ComputationGraph(b.build(), device="cpu").init()

    storage = InMemoryStatsStorage()
    g.set_listeners(StatsListener(storage, session_id="graph"))
    rng = np.random.default_rng(2)
    x = rng.normal(size=(16, 4)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 16)]
    for _ in range(3):
        g.fit(DataSet(x, y))
    updates = storage.get_all_updates("graph", StatsListener.TYPE_ID, "local")
    assert len(updates) == 3
    assert "d/W" in updates[-1][1]["params"]


def test_remote_stats_router_roundtrip():
    """RemoteUIStatsStorageRouter -> /remote -> dashboard data (the
    reference's RemoteUIStatsStorageRouter + RemoteReceiverModule pair)."""
    from deeplearning4j_tpu_torch.ui.remote import RemoteUIStatsStorageRouter
    from deeplearning4j_tpu_torch.ui.server import UIServer

    srv = UIServer(port=0).enable_remote_listener().start()
    try:
        router = RemoteUIStatsStorageRouter(f"http://127.0.0.1:{srv.port}")
        for i in range(3):
            router.put_update("sess-r", "stats", "worker-1", float(i),
                              {"iteration": i, "score": 1.0 / (i + 1)})
        assert router.pending == 0
        data = srv.train_data("sess-r")
        assert data["session"] == "sess-r"
        assert data["scores"] == [1.0, 0.5, 1.0 / 3.0]
    finally:
        srv.stop()


def test_remote_router_buffers_when_server_down():
    from deeplearning4j_tpu_torch.ui.remote import RemoteUIStatsStorageRouter
    router = RemoteUIStatsStorageRouter("http://127.0.0.1:9",  # closed port
                                        timeout=0.3)
    router.put_update("s", "t", "w", 0.0, {"score": 1.0})
    assert router.pending == 1


def test_remote_endpoint_requires_enable():
    from deeplearning4j_tpu_torch.ui.server import UIServer
    import json as _json
    import urllib.request

    srv = UIServer(port=0).start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/remote",
            _json.dumps({"session": "s"}).encode(),
            {"Content-Type": "application/json"})
        try:
            urllib.request.urlopen(req, timeout=5)
            assert False, "expected 403"
        except urllib.error.HTTPError as e:
            assert e.code == 403
    finally:
        srv.stop()


def test_chart_components_json_and_svg():
    """ui-components DSL parity: charts serialize to JSON and render SVG."""
    import json as _json

    from deeplearning4j_tpu_torch.ui.components import (ChartHistogram, ChartLine,
                                                  ChartScatter,
                                                  ComponentTable,
                                                  render_page)

    line = (ChartLine("loss").add_series("train", [0, 1, 2], [3.0, 2.0, 1.5])
            .add_series("val", [0, 1, 2], [3.5, 2.4, 2.0]))
    d = _json.loads(line.to_json())
    assert d["type"] == "chart-line" and len(d["series"]) == 2
    svg = line.render_svg()
    assert svg.count("<polyline") == 2 and "loss" in svg

    sc = ChartScatter("emb").add_series("pts", [0.0, 1.0], [1.0, 0.0])
    assert sc.render_svg().count("<circle") == 2

    h = ChartHistogram("w").add_bin(0, 1, 5).add_bin(1, 2, 3)
    assert h.render_svg().count("<rect") == 2

    t = ComponentTable(["a", "b"], [[1, 2], [3, 4]])
    assert "<table" in t.render_svg()

    page = render_page("report", [line, t])
    assert page.startswith("<!DOCTYPE html>") and "report" in page


def test_evaluation_tools_roc_html_export(tmp_path):
    """EvaluationTools.exportRocChartsToHtmlFile parity."""
    import numpy as _np

    from deeplearning4j_tpu_torch.eval.roc import ROC, ROCMultiClass
    from deeplearning4j_tpu_torch.eval.tools import EvaluationTools

    r = _np.random.default_rng(0)
    labels = r.integers(0, 2, 200).astype(_np.float64)
    probs = _np.clip(labels * 0.6 + r.normal(0, 0.25, 200), 0, 1)
    roc = ROC(threshold_steps=50)
    roc.eval(labels, probs)
    path = str(tmp_path / "roc.html")
    EvaluationTools.export_roc_charts_to_html_file(roc, path)
    html = open(path).read()
    assert "AUC=" in html and "<polyline" in html
    assert f"{roc.calculate_auc():.4f}" in html

    mc = ROCMultiClass(threshold_steps=25)
    y = _np.eye(3)[r.integers(0, 3, 120)]
    p = _np.abs(y * 0.5 + r.normal(0, 0.3, y.shape))
    p = p / p.sum(1, keepdims=True)
    mc.eval(y, p)
    html2 = EvaluationTools.roc_multi_class_chart_html(mc)
    assert html2.count("class ") >= 3


def test_evaluation_tools_confusion_html(tmp_path):
    import numpy as _np

    from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
    from deeplearning4j_tpu_torch.eval.tools import EvaluationTools

    ev = Evaluation(labels=["cat", "dog"])
    ev.eval(_np.eye(2)[[0, 1, 0, 1]], _np.eye(2)[[0, 1, 1, 1]])
    path = str(tmp_path / "cm.html")
    EvaluationTools.export_confusion_matrix_html_file(ev, path)
    html = open(path).read()
    assert "cat" in html and "accuracy" in html


def test_components_escape_html():
    from deeplearning4j_tpu_torch.ui.components import (ChartLine, ComponentTable,
                                                  ComponentText, render_page)
    t = ComponentTable(["a<b"], [["<=5&"]])
    svg = t.render_svg()
    assert "&lt;=5&amp;" in svg and "a&lt;b" in svg
    assert "<p>x &lt; y</p>" in ComponentText("x < y").render_svg()
    line = ChartLine("t&t").add_series("a<s", [0, 1], [0, 1])
    assert "a&lt;s" in line.render_svg() and "t&amp;t" in line.render_svg()
    page = render_page("p<q", [t])
    assert "p&lt;q" in page


def test_roc_precision_recall_curve_in_export(tmp_path):
    """The PR chart must actually render (was dead code behind hasattr)."""
    import numpy as _np

    from deeplearning4j_tpu_torch.eval.roc import ROC
    from deeplearning4j_tpu_torch.eval.tools import EvaluationTools
    r = _np.random.default_rng(1)
    labels = r.integers(0, 2, 100).astype(_np.float64)
    probs = _np.clip(labels * 0.7 + r.normal(0, 0.2, 100), 0, 1)
    roc = ROC(threshold_steps=20)
    roc.eval(labels, probs)
    assert len(roc.get_precision_recall_curve()) == len(roc.thresholds)
    html = EvaluationTools.roc_chart_html(roc)
    assert "Precision-Recall" in html and "AUPRC=" in html


def test_confusion_export_empty_evaluation(tmp_path):
    from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
    from deeplearning4j_tpu_torch.eval.tools import EvaluationTools
    path = str(tmp_path / "empty.html")
    EvaluationTools.export_confusion_matrix_html_file(Evaluation(), path)
    assert "accuracy" in open(path).read()


def test_dashboard_page_has_histogram_tab_and_payload():
    """HistogramModule analog: the dashboard serves a Histograms tab with a
    bar renderer, and data.json carries per-param histograms."""
    import json as _json
    import urllib.request

    import numpy as _np

    from deeplearning4j_tpu_torch import (Adam, DataSet, DenseLayer, InputType,
                                    MultiLayerNetwork,
                                    NeuralNetConfiguration, OutputLayer)
    from deeplearning4j_tpu_torch.ui.server import UIServer
    from deeplearning4j_tpu_torch.ui.stats import StatsListener
    from deeplearning4j_tpu_torch.ui.storage import InMemoryStatsStorage

    storage = InMemoryStatsStorage()
    conf = (NeuralNetConfiguration.builder().seed(1).updater(Adam(1e-2))
            .list()
            .layer(DenseLayer(n_out=8, activation="relu"))
            .layer(OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(4)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    net.add_listeners(StatsListener(storage, frequency=1))
    r = _np.random.default_rng(0)
    x = r.normal(size=(16, 4)).astype(_np.float32)
    y = _np.eye(2, dtype=_np.float32)[r.integers(0, 2, 16)]
    for _ in range(3):
        net.fit(DataSet(x, y))
    srv = UIServer(port=0).attach(storage).start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        page = urllib.request.urlopen(base + "/train", timeout=10) \
            .read().decode()
        assert 'data-p="histograms"' in page and "function bars(" in page
        d = _json.load(urllib.request.urlopen(base + "/train/data.json",
                                              timeout=10))
        hist = next(iter(d["params"].values()))["histogram"]
        assert hist["counts"] and hist["min"] <= hist["max"]
    finally:
        srv.stop()


def test_convolutional_listener_stores_activation_grids():
    """ConvolutionalListenerModule analog: first-conv activation grids are
    PNG-encoded onto the stats stream every N iterations."""
    import base64
    import io

    import numpy as _np
    import pytest as _pytest

    PIL = _pytest.importorskip("PIL")
    from PIL import Image

    from deeplearning4j_tpu_torch import (Adam, DataSet, InputType,
                                    MultiLayerNetwork,
                                    NeuralNetConfiguration, OutputLayer)
    from deeplearning4j_tpu_torch.nn.layers import (ConvolutionLayer,
                                              ConvolutionMode)
    from deeplearning4j_tpu_torch.ui.convolutional import (
        ConvolutionalIterationListener, activation_grid)
    from deeplearning4j_tpu_torch.ui.storage import InMemoryStatsStorage

    # tiler: 5 channels of h=4,w=3 -> 2 rows x 3 cols grid with 1px padding
    g = activation_grid(_np.random.default_rng(0)
                        .normal(size=(4, 3, 5)).astype(_np.float32))
    assert g.dtype == _np.uint8 and g.shape == (2 * 5 - 1, 3 * 4 - 1)

    storage = InMemoryStatsStorage()
    conf = (NeuralNetConfiguration.builder().seed(0).updater(Adam(1e-3))
            .list()
            .layer(ConvolutionLayer(n_out=6, kernel_size=(3, 3),
                                    stride=(1, 1), activation="relu",
                                    convolution_mode=ConvolutionMode.SAME))
            .layer(OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.convolutional(8, 8, 1)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    lis = ConvolutionalIterationListener(storage, frequency=2,
                                         session_id="conv-test")
    net.add_listeners(lis)
    r = _np.random.default_rng(1)
    x = r.normal(size=(4, 8, 8, 1)).astype(_np.float32)
    y = _np.eye(2, dtype=_np.float32)[r.integers(0, 2, 4)]
    for _ in range(4):
        net.fit(DataSet(x, y))
    ups = storage.get_all_updates("conv-test", "activations", "worker-0")
    assert len(ups) == 2                      # iterations 2 and 4
    _, report = ups[-1]
    png = base64.b64decode(report["pngs_base64"][0])
    img = Image.open(io.BytesIO(png))
    # 6 conv channels of 8x8 tile to a 2-row x 3-col grid with 1px pad:
    # width 3*9-1=26, height 2*9-1=17 — pins CONV activations, not the
    # (8x8x1) input image, as the rendered payload
    assert img.mode == "L" and img.size == (26, 17)


# ------------------------ Flow module (round 3) ----------------------------

def test_model_topology_graph_and_chain():
    """FlowListenerModule analog: topology extraction for both model
    families."""
    from deeplearning4j_tpu_torch.ui.stats import model_topology

    chain = model_topology(_small_model())
    assert [v["type"] for v in chain] == ["Input", "DenseLayer",
                                          "OutputLayer"]
    assert chain[1]["inputs"] == ["input"]
    assert chain[1]["n_params"] == 4 * 8 + 8   # W + b

    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration as NNC
    from deeplearning4j_tpu_torch.nn.conf.graph import ElementWiseVertex
    from deeplearning4j_tpu_torch.nn.conf.input_type import InputType as IT
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    b = NNC.builder().seed(0).graph_builder()
    b.add_inputs("in")
    b.add_layer("a", DenseLayer(n_out=4, activation="relu"), "in")
    b.add_layer("b", DenseLayer(n_out=4, activation="relu"), "in")
    b.add_vertex("sum", ElementWiseVertex(op="add"), "a", "b")
    b.add_layer("out", OutputLayer(n_out=2, loss="mcxent"), "sum")
    b.set_outputs("out")
    b.set_input_types(IT.feed_forward(3))
    g = ComputationGraph(b.build(), device="cpu").init()
    topo = model_topology(g)
    names = {v["name"]: v for v in topo}
    assert names["sum"]["inputs"] == ["a", "b"]
    assert names["sum"]["type"] == "ElementWiseVertex"
    assert names["out"]["inputs"] == ["sum"]


def test_flow_tab_data_and_storage_round_trip(tmp_path):
    """Topology travels in the first report, survives the FileStatsStorage
    round trip, and is served on /train/data.json; the dashboard carries
    the Flow tab."""
    path = str(tmp_path / "stats.jsonl")
    storage = FileStatsStorage(path)
    listener = StatsListener(storage, session_id="flow-sess")
    _train(_small_model(), listener, steps=2)

    reloaded = FileStatsStorage(path)
    ups = reloaded.get_all_updates("flow-sess", StatsListener.TYPE_ID,
                                   "local")
    assert "model" in ups[0][1] and "model" not in ups[1][1]

    server = UIServer(port=0).attach(reloaded).start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        html = urllib.request.urlopen(base + "/train").read().decode()
        assert 'data-p="flow"' in html and "function flow(" in html
        data = json.loads(
            urllib.request.urlopen(base + "/train/data.json").read())
        assert [v["name"] for v in data["model"]] == ["input", "layer0",
                                                      "layer1"]
    finally:
        server.stop()


def test_legacy_remote_iteration_listeners():
    """WebReporter tier (deeplearning4j-ui-remote-iterationlisteners):
    direct per-iteration POSTs of flow/histogram payloads to an HTTP
    endpoint, with queue-on-failure."""
    import http.server
    import threading as _t

    from deeplearning4j_tpu_torch.ui.legacy_listeners import (
        RemoteFlowIterationListener, RemoteHistogramIterationListener,
        WebReporter)

    received = []

    class H(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            received.append(json.loads(self.rfile.read(n)))
            self.send_response(200)
            self.end_headers()

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
    _t.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}/legacy"
    flow_l = hist_l = None
    try:
        model = _small_model()
        flow_l = RemoteFlowIterationListener(url)
        hist_l = RemoteHistogramIterationListener(url, frequency=2)
        model.set_listeners(flow_l, hist_l)
        rng = np.random.default_rng(0)
        x = rng.normal(size=(16, 4)).astype(np.float32)
        y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 16)]
        for _ in range(4):
            model.fit(DataSet(x, y))
        # posting is async (worker thread): drain before asserting
        assert flow_l.reporter.flush() and hist_l.reporter.flush()
        kinds = [p["type"] for p in received]
        assert kinds.count("flow") == 4
        assert kinds.count("histogram") == 2
        flow = next(p for p in received if p["type"] == "flow")
        assert [v["name"] for v in flow["model"]] == ["input", "layer0",
                                                      "layer1"]
        hist = next(p for p in received if p["type"] == "histogram")
        assert "layer0/W" in hist["histograms"]
    finally:
        # join the reporters' worker threads (the sanitize watchdog
        # flagged exactly this: the listeners' WebReporters outlived
        # the test) and stop the throwaway HTTP server
        for lst in (flow_l, hist_l):
            if lst is not None:
                lst.reporter.close()
        srv.shutdown()
        srv.server_close()

    # queue-on-failure: black-holed host keeps payloads pending, and
    # report() never blocks the caller
    rep = WebReporter("http://127.0.0.1:1/legacy", timeout=0.2)
    t0 = time.time()
    rep.report({"type": "x"})
    assert time.time() - t0 < 0.1      # non-blocking enqueue
    assert not rep.flush(timeout=0.5)  # head keeps retrying, stays queued
    assert rep.pending == 1
    rep.close()


def test_webreporter_backpressure_dead_endpoint():
    """Round-4 (VERDICT #10): with the endpoint dead, the bounded queue
    drops the OLDEST payloads and report() never blocks — a down UI host
    cannot stall or OOM the training loop."""
    from deeplearning4j_tpu_torch.ui.legacy_listeners import WebReporter

    rep = WebReporter("http://127.0.0.1:1/legacy", timeout=0.2,
                      queue_size=8)
    t0 = time.time()
    for i in range(50):
        rep.report({"i": i})
    elapsed = time.time() - t0
    assert elapsed < 1.0, f"report() blocked the caller ({elapsed:.2f}s)"
    assert rep.pending <= 8            # bounded, never grows past maxlen
    with rep._lock:
        kept = [p["i"] for p in rep._queue]
    # newest survive; oldest dropped (deque maxlen semantics). The worker
    # may have popped/retried the head concurrently, so only bound-check
    # the window start
    assert kept == sorted(kept)
    assert kept[0] >= 50 - 8
    assert kept[-1] == 49
    rep.close()


def test_sqlite_stats_storage_round_trip(tmp_path):
    """SQLite-backed storage (J7FileStatsStorage/MapDBStatsStorage role):
    durable across connections, same SPI surface + events."""
    from deeplearning4j_tpu_torch.ui import SqliteStatsStorage

    path = str(tmp_path / "stats.db")
    storage = SqliteStatsStorage(path)
    events = []
    storage.register_listener(events.append)
    listener = StatsListener(storage, session_id="sq")
    _train(_small_model(), listener, steps=3)
    assert storage.list_session_ids() == ["sq"]
    ups = storage.get_all_updates("sq", StatsListener.TYPE_ID, "local")
    assert len(ups) == 3 and np.isfinite(ups[-1][1]["score"])
    kinds = [e.kind for e in events]
    assert kinds.count(StatsStorageEvent.NEW_SESSION) == 1
    storage.close()

    reloaded = SqliteStatsStorage(path)     # fresh connection replays
    rep = reloaded.get_all_updates("sq", StatsListener.TYPE_ID, "local")
    assert json.dumps(rep) == json.dumps(ups)
    # serves the dashboard like any storage
    server = UIServer(port=0).attach(reloaded).start()
    try:
        data = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/train/data.json").read())
        assert len(data["scores"]) == 3
    finally:
        server.stop()
        reloaded.close()


def test_tsne_tab_and_endpoint():
    """TsneModule analog: attached 2-D coordinates served at
    /tsne/data.json and rendered by the t-SNE tab."""
    server = UIServer(port=0)
    rng = np.random.default_rng(0)
    coords = rng.normal(size=(30, 2))
    labels = [f"c{i % 3}" for i in range(30)]
    server.attach_tsne(coords, labels).start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        html = urllib.request.urlopen(base + "/train").read().decode()
        assert 'data-p="tsne"' in html
        data = json.loads(
            urllib.request.urlopen(base + "/tsne/data.json").read())
        assert len(data["points"]) == 30 and data["labels"][0] == "c0"
    finally:
        server.stop()


# ------------------------ parity with the JAX package ----------------------

def _batches(n=4, rows=16, width=4, classes=2, seed=0):
    r = np.random.default_rng(seed)
    return [(r.normal(size=(rows, width)).astype(np.float32),
             np.eye(classes, dtype=np.float32)[r.integers(0, classes, rows)])
            for _ in range(n)]


def _jax_mlp(seed=5):
    conf = (jx.NeuralNetConfiguration.builder()
            .seed(seed).updater(jx.Adam(1e-2)).list()
            .layer(jx.DenseLayer(n_out=8, activation="relu"))
            .layer(jx.DenseLayer(n_out=6, activation="tanh"))
            .layer(jx.OutputLayer(n_out=2, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(jx.InputType.feed_forward(4)).build())
    return jax_init(jx.MultiLayerNetwork(conf))


def _jax_graph():
    b = (jx.NeuralNetConfiguration.builder().seed(1).updater(jx.Adam(1e-2))
         .graph_builder().add_inputs("in"))
    b.add_layer("a", jx.DenseLayer(n_out=6, activation="relu"), "in")
    b.add_layer("b", jx.DenseLayer(n_out=6, activation="tanh"), "in")
    b.add_vertex("sum", jgraph.ElementWiseVertex(op="add"), "a", "b")
    b.add_layer("out", jx.OutputLayer(n_out=2, activation="softmax",
                                      loss="mcxent"), "sum")
    b.set_outputs("out")
    b.set_input_types(jx.InputType.feed_forward(4))
    return jax_init(JaxGraph(b.build()))


def _summary_close(got, want, scale, what):
    for key in ("mean", "stdev", "min", "max"):
        assert abs(got[key] - want[key]) <= SUMMARY_TOL * scale, \
            (what, key, got[key], want[key])
    gh, wh = got["histogram"], want["histogram"]
    assert sum(gh["counts"]) == sum(wh["counts"]), what
    assert max(abs(a - b) for a, b in zip(gh["counts"], wh["counts"])) \
        <= HIST_TOL, (what, gh["counts"], wh["counts"])
    for key in ("min", "max"):
        assert abs(gh[key] - wh[key]) <= SUMMARY_TOL * scale, (what, key)


def _reports_close(got, want):
    """Reports of the two packages' listeners over the same steps."""
    assert len(got) == len(want)
    for (_, g), (_, w) in zip(got, want):
        assert g["iteration"] == w["iteration"]
        assert abs(g["score"] - w["score"]) <= SCORE_TOL
        assert ("model" in g) == ("model" in w)
        if "model" in w:
            assert g["model"] == w["model"]
        assert sorted(g["params"]) == sorted(w["params"])
        for k, s in w["params"].items():
            scale = max(abs(s["min"]), abs(s["max"]), 1e-30)
            _summary_close(g["params"][k], s, scale, f"params {k}")
        assert sorted(g.get("updates", {})) == sorted(w.get("updates", {}))
        for k, s in w.get("updates", {}).items():
            scale = max(abs(s["min"]), abs(s["max"]), 1e-30)
            _summary_close(g["updates"][k], s, scale, f"updates {k}")
        assert sorted(g["memory"]) == sorted(w["memory"]) == ["rss_mb"]


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """JAX's listener over 4 steps of an MLP (from its zip) and 3 of a
    graph, with the models' starting points for the port."""
    tmp = tmp_path_factory.mktemp("jax_stats")
    with pinned():
        mlp = _jax_mlp()
        zip_path = str(tmp / "mlp.zip")
        jx.ModelSerializer.write_model(mlp, zip_path)
        graph = _jax_graph()
        graph_start = port_twin(graph)
        out = {"zip": zip_path, "graph_start": graph_start}
        for name, model, steps in (("mlp", mlp, 4), ("graph", graph, 3)):
            storage = jui.InMemoryStatsStorage()
            model.set_listeners(jui.StatsListener(storage, session_id=name))
            for x, y in _batches(steps):
                model.fit(jx.DataSet(x, y))
            out[name] = storage.get_all_updates(
                name, jui.StatsListener.TYPE_ID, "local")
        return out


def test_stats_reports_match_jax_multilayer(jax_runs):
    net = pt.ModelSerializer.restore(jax_runs["zip"], device="cpu")
    storage = InMemoryStatsStorage()
    listener = StatsListener(storage, session_id="mlp")
    net.set_listeners(listener)
    for x, y in _batches(4):
        net.fit(DataSet(x, y))
    _reports_close(storage.get_all_updates("mlp", StatsListener.TYPE_ID,
                                           "local"), jax_runs["mlp"])
    assert listener.host_copies == 0      # a CPU model copies nothing


def test_stats_reports_match_jax_graph(jax_runs):
    g = jax_runs["graph_start"]
    storage = InMemoryStatsStorage()
    g.set_listeners(StatsListener(storage, session_id="graph"))
    for x, y in _batches(3):
        g.fit(DataSet(x, y))
    _reports_close(storage.get_all_updates("graph", StatsListener.TYPE_ID,
                                           "local"), jax_runs["graph"])


@pytest.mark.parametrize("kind", ["file", "sqlite"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_stats_files_cross_packages(tmp_path, kind, writer):
    """A stats file written by one package reads back equal in the other."""
    ext = "jsonl" if kind == "file" else "db"
    path = str(tmp_path / f"stats.{ext}")
    cls = {"file": "FileStatsStorage", "sqlite": "SqliteStatsStorage"}[kind]
    w_mod, r_mod = (jui, pui) if writer == "jax" else (pui, jui)
    if writer == "jax":
        model, make_ds = _jax_mlp(), jx.DataSet
    else:
        model, make_ds = _small_model(), DataSet
    storage = getattr(w_mod, cls)(path)
    model.set_listeners(w_mod.StatsListener(storage, session_id="cross"))
    for x, y in _batches(3):
        model.fit(make_ds(x, y))
    written = storage.get_all_updates("cross", "StatsListener", "local")
    if kind == "sqlite":
        storage.close()
    reread = getattr(r_mod, cls)(path)
    try:
        assert reread.list_session_ids() == ["cross"]
        got = reread.get_all_updates("cross", "StatsListener", "local")
        assert json.dumps(got) == json.dumps(written)
    finally:
        if kind == "sqlite":
            reread.close()


def test_components_and_dashboard_are_jax_bytes():
    """The same components render the same SVG / HTML; the dashboard
    serves JAX's page and assembles JAX's JSON from one storage."""
    def build(m):
        line = (m.ChartLine("loss").add_series("a<b", [0, 1, 2], [3, 2, 1.5])
                .add_series("val", [0, 1], [2.0, 1.0]))
        sc = m.ChartScatter("emb", m.StyleChart(300, 200)).add_series(
            "p", [0.5, -1.0], [1.0, 0.25])
        h = m.ChartHistogram("w").add_bin(0, 1, 5).add_bin(1, 2, 3)
        t = m.ComponentTable(["k", "v<"], [["a", 1], ["b&", 2.5]])
        comps = [line, sc, h, t, m.ComponentText("x < y")]
        return ([c.to_json() for c in comps],
                m.render_page("page<1>", comps))
    assert build(pcomp) == build(jcomp)
    assert pserver._PAGE == jserver._PAGE

    storage = InMemoryStatsStorage()
    _train(_small_model(), StatsListener(storage, session_id="d"), steps=3)
    got = UIServer(port=0).attach(storage).train_data()
    want = jui.UIServer(port=0).attach(storage).train_data()
    assert json.dumps(got) == json.dumps(want)


def _roc_inputs():
    r = np.random.default_rng(0)
    labels = r.integers(0, 2, 200).astype(np.float64)
    probs = np.clip(labels * 0.6 + r.normal(0, 0.25, 200), 0, 1)
    y = np.eye(3)[r.integers(0, 3, 120)]
    p = np.abs(y * 0.5 + r.normal(0, 0.3, y.shape))
    return labels, probs, y, p / p.sum(1, keepdims=True)


@pytest.mark.parametrize("chart", ["roc", "multiclass", "confusion"])
def test_evaluation_tools_html_equals_jax(tmp_path, chart):
    """The same evaluation in both packages writes the same HTML; the
    port's evaluations take tensors."""
    labels, probs, y, p = _roc_inputs()
    if chart == "roc":
        got, want = pt.eval.ROC(threshold_steps=50), jroc.ROC(
            threshold_steps=50)
        got.eval(torch.tensor(labels), torch.tensor(probs))
        want.eval(labels, probs)
        html = (pt.eval.EvaluationTools.roc_chart_html(got),
                jtools.EvaluationTools.roc_chart_html(want))
    elif chart == "multiclass":
        got, want = (pt.eval.ROCMultiClass(threshold_steps=25),
                     jroc.ROCMultiClass(threshold_steps=25))
        got.eval(torch.tensor(y), torch.tensor(p))
        want.eval(y, p)
        html = (pt.eval.EvaluationTools.roc_multi_class_chart_html(got),
                jtools.EvaluationTools.roc_multi_class_chart_html(want))
    else:
        got = pt.eval.Evaluation(labels=["a", "b", "c"])
        want = jeval.Evaluation(labels=["a", "b", "c"])
        got.eval(y, p)
        want.eval(y, p)
        paths = [str(tmp_path / f"{n}.html") for n in ("p", "j")]
        pt.eval.EvaluationTools.export_confusion_matrix_html_file(
            got, paths[0])
        jtools.EvaluationTools.export_confusion_matrix_html_file(
            want, paths[1])
        html = tuple(open(q).read() for q in paths)
    assert html[0] == html[1]


def test_attach_tsne_takes_tensors():
    """Coordinates as a tensor (bf16 included) serve as JAX's array does."""
    r = np.random.default_rng(3)
    coords = r.normal(size=(20, 3)).astype(np.float32)
    labels = [f"c{i % 4}" for i in range(20)]
    want = jui.UIServer(port=0).attach_tsne(coords, labels).tsne_data()
    got = UIServer(port=0).attach_tsne(torch.tensor(coords),
                                       labels).tsne_data()
    assert got == want
    half = UIServer(port=0).attach_tsne(
        torch.tensor(coords).bfloat16()).tsne_data()
    np.testing.assert_allclose(half["points"], coords[:, :2], rtol=1e-2)


def test_host_copy_is_one_copy_per_dtype():
    from deeplearning4j_tpu_torch.ui.stats import _host_copy
    ts = [torch.arange(6.0).reshape(2, 3), torch.ones(4, dtype=torch.bfloat16),
          torch.arange(3, dtype=torch.float64), torch.zeros(2, 2)]
    got = _host_copy(ts)
    assert [a.shape for a in got] == [(2, 3), (4,), (3,), (2, 2)]
    assert [a.dtype for a in got] == [np.float32, np.float32, np.float64,
                                      np.float32]
    np.testing.assert_array_equal(got[0], ts[0].numpy())


def _conv_nets(tmp_path):
    conf = (jx.NeuralNetConfiguration.builder().seed(0)
            .updater(jx.Adam(1e-3)).list()
            .layer(jx.ConvolutionLayer(n_out=6, kernel_size=(3, 3),
                                       stride=(1, 1), activation="relu",
                                       convolution_mode="same"))
            .layer(jx.OutputLayer(n_out=2, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(jx.InputType.convolutional(8, 8, 1)).build())
    jnet = jax_init(jx.MultiLayerNetwork(conf))
    path = str(tmp_path / "conv.zip")
    jx.ModelSerializer.write_model(jnet, path)
    return jnet, pt.ModelSerializer.restore(path, device="cpu")


def test_convolutional_listener_matches_jax(tmp_path):
    """The first conv activation is NHWC in both packages; the grids of the
    same activations agree within one grey level."""
    pytest.importorskip("PIL")
    from deeplearning4j_tpu.ui.convolutional import \
        ConvolutionalIterationListener as JaxConv
    from deeplearning4j_tpu_torch.ui.convolutional import (
        ConvolutionalIterationListener, activation_grid)

    jnet, net = _conv_nets(tmp_path)
    x = np.random.default_rng(1).normal(size=(3, 8, 8, 1)).astype(
        np.float32)
    want = JaxConv(None)._first_conv_activation(jnet, x)
    got = ConvolutionalIterationListener(None)._first_conv_activation(
        net, torch.tensor(x))
    assert got.shape == want.shape == (3, 8, 8, 6)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    from deeplearning4j_tpu.ui.convolutional import \
        activation_grid as jax_grid
    for i in range(3):
        diff = (activation_grid(torch.tensor(got[i])).astype(int)
                - jax_grid(want[i]).astype(int))
        assert np.abs(diff).max() <= 1


def test_stats_listener_warns_under_windowed_fit():
    """fit(superstep=K) replays the listener at the window's edge: the
    port warns as JAX's does, and the report count is unchanged."""
    storage = InMemoryStatsStorage()
    net = _small_model()
    net.set_listeners(StatsListener(storage, session_id="w"))
    x, y = _batches(1, rows=64)[0]
    it = pt.ArrayDataSetIterator(x, y, batch_size=16)
    with pytest.warns(UserWarning, match="end-of-window snapshots"):
        net.fit(it, superstep=2)
    assert len(storage.get_all_updates("w", StatsListener.TYPE_ID,
                                       "local")) == 4


def test_train_data_serves_a_session_of_any_attached_storage():
    """With two storages attached, `train_data(session)` of a session held
    by the second serves it; JAX's serves the first storage's latest
    session instead (a reference defect, ROADMAP)."""
    a, b = InMemoryStatsStorage(), InMemoryStatsStorage()
    a.put_update("sa", "stats", "w", 0.0, {"iteration": 1, "score": 1.0})
    for i in range(3):
        b.put_update("sb", "stats", "w", float(i),
                     {"iteration": i, "score": 0.5})
    got = UIServer(port=0).attach(a).attach(b).train_data("sb")
    assert got["session"] == "sb" and got["scores"] == [0.5] * 3
    want = jui.UIServer(port=0).attach(a).attach(b).train_data("sb")
    assert want["session"] == "sa"
    # a session nowhere attached: JAX's choice, the first storage's latest
    assert UIServer(port=0).attach(a).attach(b).train_data("nope") == \
        jui.UIServer(port=0).attach(a).attach(b).train_data("nope")


def test_stats_listener_flattens_nested_parameters():
    """A bidirectional layer's parameters are a nested dict: the port's
    report names each leaf by its path; JAX's `_flatten_params` hands the
    inner dict to numpy as one object and its summary raises TypeError."""
    from types import SimpleNamespace

    from deeplearning4j_tpu.ui import stats as jstats
    from deeplearning4j_tpu_torch.nn.layers import GravesBidirectionalLSTM
    nested = {"fwd": {"W": np.ones((2, 3), np.float32)},
              "bwd": {"W": np.zeros((2, 3), np.float32)}}
    jax_model = SimpleNamespace(params=(nested,),
                                layers=[SimpleNamespace(name=None)])
    flat = jstats._flatten_params(jax_model)
    with pytest.raises(TypeError):
        jstats._summary(flat["layer0/bwd"], 4)

    conf = (NeuralNetConfiguration.builder().seed(2).updater(Adam(1e-2))
            .list()
            .layer(GravesBidirectionalLSTM(n_out=3))
            .layer(pt.RnnOutputLayer(n_out=2, activation="softmax"))
            .set_input_type(InputType.recurrent(4, 5)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    storage = InMemoryStatsStorage()
    net.set_listeners(StatsListener(storage, session_id="bi"))
    r = np.random.default_rng(0)
    x = r.normal(size=(3, 5, 4)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[r.integers(0, 2, (3, 5))]
    net.fit(DataSet(x, y))
    report = _reports_only(storage, "bi")[0]
    leaves = {f"layer0/{path}" for path in
              ("bwd/W", "bwd/b", "bwd/peep", "fwd/W", "fwd/b", "fwd/peep")}
    assert leaves <= set(report["params"]), sorted(report["params"])
    assert report["model"][1]["n_params"] == sum(
        v.numel() for d in net.params[0].values() for v in d.values())
    np.testing.assert_allclose(
        report["params"]["layer0/fwd/W"]["mean"],
        float(net.params[0]["fwd"]["W"].double().mean()), rtol=1e-6)


def _reports_only(storage, session):
    return [r for _, r in storage.get_all_updates(
        session, StatsListener.TYPE_ID, "local")]
