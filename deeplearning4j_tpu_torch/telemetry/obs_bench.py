"""Observability overhead bench: the tracing + flight-recorder planes
measured enabled-vs-disabled in ALTERNATING paired windows (the port of
`deeplearning4j_tpu/telemetry/obs_bench.py`, on the GPU unless the caller
passes `device="cpu"`).

The contract is that always-on observability costs (almost) nothing:
per-request ``TraceContext`` spans + SLO observation on the serving
plane, and ``FlightRecorder`` events on the training plane, must keep
paired throughput at >= 0.95 of the instrumented-off baseline.

Two arms, each alternating OFF/ON windows within a pair (a contaminated
capture shows up as spread across pairs, and the median-of-ratios verdict
ignores it):

  * **serving** — closed-loop concurrent clients against the mlp128
    batched data plane (``serving/bench._closed_loop``). The ON window
    runs each request under a ``TraceContext`` (root span + the
    queue_wait/batch_forward/scatter children the batcher emits into the
    bounded Tracer) and feeds the SLO surface; the OFF window passes
    ``ctx=None`` — the exact code path an untraced request takes.
    Ratio = req_s_on / req_s_off.
  * **fit** — the LeNet fit path under a ``TrainingGuard`` (the guard's
    sanctioned host-sync already pays the score read in BOTH windows, so
    the delta is purely the recorder). ON installs an enabled
    ``FlightRecorder`` (train/step + train/window events), OFF an
    ``enabled=False`` one whose ``record()`` is a single attribute check.
    Ratio = t_off / t_on.

The verdict is the median paired ratio per arm; ``pass_0p95`` is the
gate. ``serving.cost_split`` splits the serving arm's cost by the thread
that pays it: the batcher's one flush thread emits the child spans, the
client threads make the context, the root span and the SLO observation.
A third window in each pair does only the clients' part (``client``).
Beside the wall time a request gains in each window stands each piece
timed alone on one thread (``span_costs``).
"""
from __future__ import annotations

import json
import time
from typing import Dict

import numpy as np

__all__ = ["run_obs_overhead_bench", "span_costs"]


def span_costs() -> Dict:
    """Host microseconds a call, on one thread with a session active, of
    each piece tracing adds to a served request: the context
    (`TraceContext.begin`), a child span split into its dicts (ids, args
    and event, built into a Tracer that keeps nothing) and the Tracer's
    lock and append, the root span, and the SLO observation. Each is the
    fastest of three runs of 10,000 calls."""
    from .registry import MetricsRegistry
    from .runtime import TelemetrySession, enabled
    from .trace_context import SloSurface, TraceContext
    from .tracing import Tracer

    class _Dropping(Tracer):
        def _append(self, ev):
            pass

    n = 10_000

    def per_call(fn):
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            best = min(best, time.perf_counter() - t0)
        return 1e6 * best / n

    ctx = TraceContext.begin()
    t = time.perf_counter()

    def child():
        ctx.emit("queue_wait", t, t, model="mlp128", rows=1)

    out = {"context": per_call(TraceContext.begin)}
    with enabled(TelemetrySession(tracer=_Dropping())):
        out["span_dicts"] = per_call(child)
    with enabled(TelemetrySession(tracer=Tracer(max_events=6 * n + 8))):
        out["child_span"] = per_call(child)
        out["root_span"] = per_call(
            lambda: ctx.emit_root("bench/predict", model="mlp128"))
    out["tracer_lock_append"] = out["child_span"] - out["span_dicts"]
    slo = SloSurface(MetricsRegistry())
    out["slo_observe"] = per_call(lambda: slo.observe("standard", 1e-3))
    return {k: round(v, 3) for k, v in out.items()}


def _serving_arm(pairs: int, clients: int, requests: int,
                 device=None) -> Dict:
    from ..serving.bench import _closed_loop, _make_mlp128, _median
    from ..serving.registry import ModelRegistry
    from ..serving.server import InferenceServer
    from . import enabled
    from .trace_context import TraceContext

    out: Dict = {"clients": clients, "requests_per_client": requests}
    with enabled() as sess:
        registry = ModelRegistry(buckets=(1, 8), metrics=sess.registry,
                                 device=device)
        server = InferenceServer(registry, batching=True, max_wait_us=2000)
        try:
            registry.register("mlp128", _make_mlp128(registry.device))
            shape = registry.get("mlp128").example_shape

            def make_row(i):
                return np.random.default_rng(i).normal(
                    size=(1,) + shape).astype(np.float32)

            def plain(x):
                server.predict("mlp128", x, batched=True)

            def traced(x, spans=True):
                ctx = TraceContext.begin()
                server.predict("mlp128", x, batched=True,
                               ctx=ctx if spans else None)
                ctx.emit_root("bench/predict", model="mlp128")
                server.slo.observe(ctx.tier, ctx.elapsed())

            arms = {"off": plain,
                    "client": lambda x: traced(x, spans=False),
                    "on": traced}
            for fn in arms.values():
                fn(make_row(0))
            ratios, reps = [], []
            gained = {"client": [], "on": []}
            for _ in range(pairs):
                rep = {k: _closed_loop(fn, clients, requests, make_row)
                       for k, fn in arms.items()}
                reps.append(rep)
                off = rep["off"]["req_s"]
                if off and rep["on"]["req_s"]:
                    ratios.append(round(rep["on"]["req_s"] / off, 3))
                for k, g in gained.items():
                    if off and rep[k]["req_s"]:
                        g.append(1e6 / rep[k]["req_s"] - 1e6 / off)
            spans: Dict = {}
            for e in sess.tracer.events():
                tid = (e.get("args") or {}).get("trace_id")
                if tid is not None and e.get("ph") == "X":
                    spans[tid] = spans.get(tid, 0) + 1
        finally:
            server.stop()
    out["pairs"] = reps
    out["paired_ratios"] = ratios
    out["ratio"] = _median(ratios) if ratios else None
    cost = span_costs()
    # traces of the "on" windows: the root and its children
    full = [n - 1 for n in spans.values() if n > 1]
    children = float(np.median(full)) if full else 0.0
    flush = children * cost["child_span"]
    client = cost["context"] + cost["root_span"] + cost["slo_observe"]
    out["cost_split"] = {
        "span_costs_us": cost, "child_spans_per_request": children,
        "flush_thread_us": round(flush, 3),
        "client_thread_us": round(client, 3),
        "request_wall_gained_us": {k: (round(_median(g), 3) if g else None)
                                   for k, g in gained.items()},
        "request_wall_off_us": (round(_median(
            [1e6 / r["off"]["req_s"] for r in reps if r["off"]["req_s"]]),
            3) if reps else None)}
    return out


def _fit_arm(pairs: int, batch: int, n_batches: int, device=None) -> Dict:
    from ..datasets.iterators import DataSet, ListDataSetIterator
    from ..fault.guard import GuardPolicy, TrainingGuard
    from ..models.zoo import lenet_mnist
    from ..serving.bench import _median
    from .recorder import FlightRecorder, flight_recorder, install

    r = np.random.default_rng(0)
    n = batch * n_batches
    x = r.normal(size=(n, 784)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[r.integers(0, 10, n)]
    model = lenet_mnist(seed=7, device=device).init()
    guard = TrainingGuard(GuardPolicy.WARN)

    def one_fit():
        it = ListDataSetIterator([DataSet(x, y)], batch_size=batch)
        t0 = time.perf_counter()
        model.fit(it, guard=guard)
        return time.perf_counter() - t0

    prev = flight_recorder()
    out: Dict = {"batch": batch, "n_batches": n_batches}
    try:
        install(FlightRecorder(enabled=False))
        one_fit()                      # compile + dispatch warmth
        ratios, reps = [], []
        for _ in range(pairs):
            install(FlightRecorder(enabled=False))
            t_off = one_fit()
            install(FlightRecorder(enabled=True))
            t_on = one_fit()
            reps.append({"off_s": round(t_off, 4), "on_s": round(t_on, 4)})
            if t_on > 0:
                ratios.append(round(t_off / t_on, 3))
    finally:
        install(prev)
    out["pairs"] = reps
    out["paired_ratios"] = ratios
    out["ratio"] = _median(ratios) if ratios else None
    return out


def run_obs_overhead_bench(pairs: int = 3, clients: int = 8,
                           requests_per_client: int = 60,
                           fit_batch: int = 128,
                           fit_n_batches: int = 6, device=None) -> Dict:
    """Per-arm alternating paired enabled/disabled windows, median paired
    ratio (>= 0.95 gate), on `device` (the GPU by default)."""
    serving = _serving_arm(pairs, clients, requests_per_client, device)
    fit = _fit_arm(pairs, fit_batch, fit_n_batches, device)
    ratios = [r for r in (serving["ratio"], fit["ratio"]) if r is not None]
    return {"serving": serving, "fit": fit,
            "min_ratio": min(ratios) if ratios else None,
            "pass_0p95": bool(ratios) and min(ratios) >= 0.95}


def main(argv=None):
    """`python -m deeplearning4j_tpu_torch.telemetry.obs_bench` — one JSON
    line."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="deeplearning4j_tpu_torch.telemetry.obs_bench")
    ap.add_argument("--device", default=None)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--requests", type=int, default=60)
    ap.add_argument("--fit-batch", type=int, default=128)
    ap.add_argument("--fit-batches", type=int, default=6)
    args = ap.parse_args(argv)
    print(json.dumps(run_obs_overhead_bench(
        pairs=args.pairs, clients=args.clients,
        requests_per_client=args.requests, fit_batch=args.fit_batch,
        fit_n_batches=args.fit_batches, device=args.device)))


if __name__ == "__main__":
    main()
