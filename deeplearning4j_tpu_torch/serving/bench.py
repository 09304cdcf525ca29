"""Serving latency/throughput bench: concurrent closed-loop clients
against the registry+batcher data plane, batched vs unbatched (the port of
`deeplearning4j_tpu/serving/bench.py`, on the registry's device: the GPU
unless the caller passes `device="cpu"`).

Each client thread runs a closed loop (send one request, wait for the
response, repeat) of single-row predicts against the SAME engine the
HTTP server fronts (`InferenceServer.predict`) — so the numbers measure
the serving data plane (validation, queue wait, padded forward,
scatter) without conflating stdlib-HTTP parsing overhead. Reported per
concurrency level: p50/p99 latency (ms) and aggregate requests/s, for
the batched path (DynamicBatcher coalescing) and the unbatched path
(per-request padded forward on the same bucket-1 runner).

Two configs ship: `lenet` (the zoo conv model) and `mlp128` (a
dispatch-bound 784->128->10 head — the regime where coalescing wins big).
At the top concurrency level the two arms run in ALTERNATING paired reps
and the speedup is the median of per-pair ratios (a contaminated capture
shows up as spread in the artifact).

Two invariants are checked and reported alongside the numbers:
  * exactly ONE runner build per (model, shape-bucket) across the whole
    run — hot-swaps included — via the CompileWatcher;
  * a hot-swap under sustained 16-client load completes with zero failed
    requests and per-client monotonically non-decreasing versions.
"""
from __future__ import annotations

import json
import tempfile
import threading
import time
from typing import Dict, Sequence

import numpy as np

__all__ = ["run_serving_bench"]


def _make_lenet(device=None):
    from ..models.zoo import lenet_mnist
    return lenet_mnist(seed=7, device=device).init()


def _make_mlp128(device=None):
    from .. import (DenseLayer, InputType, MultiLayerNetwork,
                    NeuralNetConfiguration, OutputLayer, Sgd)
    conf = (NeuralNetConfiguration.builder().seed(7).updater(Sgd(0.1))
            .list()
            .layer(DenseLayer(n_out=128, activation="relu"))
            .layer(OutputLayer(n_out=10, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.feed_forward(784)).build())
    return MultiLayerNetwork(conf, device=device).init()


_MODELS = {"lenet": _make_lenet, "mlp128": _make_mlp128}


def _closed_loop(predict, n_clients: int, n_requests: int,
                 make_row) -> Dict:
    """Run `n_clients` closed-loop threads of `n_requests` each; returns
    p50/p99 per-request latency (ms) and aggregate requests/s."""
    lat = [[] for _ in range(n_clients)]
    errors = []
    barrier = threading.Barrier(n_clients + 1)

    def client(i):
        x = make_row(i)
        barrier.wait()
        for _ in range(n_requests):
            t0 = time.perf_counter()
            try:
                predict(x)
            except Exception as e:   # pragma: no cover - surfaced in dict
                errors.append(f"{type(e).__name__}: {e}")
                return
            lat[i].append(time.perf_counter() - t0)

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(n_clients)]
    for t in threads:
        t.start()
    barrier.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    all_lat = np.asarray([v for row in lat for v in row])
    if not len(all_lat):
        return {"req_s": 0.0, "p50_ms": 0.0, "p99_ms": 0.0,
                "errors": errors[:3]}
    out = {"req_s": round(len(all_lat) / wall, 1) if wall > 0 else 0.0,
           "p50_ms": round(float(np.percentile(all_lat, 50)) * 1e3, 3),
           "p99_ms": round(float(np.percentile(all_lat, 99)) * 1e3, 3)}
    if errors:
        out["errors"] = errors[:3]
    return out


def _median(vals):
    vals = sorted(vals)
    return vals[len(vals) // 2]


def _swap_under_load(server, registry, name: str, swap_source,
                     n_clients: int = 16, n_requests: int = 60) -> Dict:
    """Hammer the batched path while a hot-swap lands mid-flight; no
    request may fail and each client must observe non-decreasing
    versions."""
    errors = []
    monotonic = [True] * n_clients
    versions_seen = set()
    barrier = threading.Barrier(n_clients + 2)
    shape = registry.get(name).example_shape

    def client(i):
        x = np.random.default_rng(i).normal(
            size=(1,) + shape).astype(np.float32)
        last = 0
        barrier.wait()
        for _ in range(n_requests):
            try:
                _, version, _ = server.predict(name, x, batched=True)
            except Exception as e:
                errors.append(f"{type(e).__name__}: {e}")
                return
            if version < last:
                monotonic[i] = False
            last = version
            versions_seen.add(version)

    def swapper():
        barrier.wait()
        time.sleep(0.05)     # land mid-flight
        registry.swap(name, swap_source)

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(n_clients)]
    sw = threading.Thread(target=swapper, daemon=True)
    for t in threads:
        t.start()
    sw.start()
    barrier.wait()
    for t in threads + [sw]:
        t.join()
    return {"requests": n_clients * n_requests,
            "failed": len(errors), "errors": errors[:3],
            "versions_seen": sorted(versions_seen),
            "versions_monotonic": all(monotonic)}


def _bench_model(server, registry, sess, name: str, builder,
                 clients: Sequence[int], requests_per_client: int,
                 buckets: Sequence[int], pairs_at_top: int,
                 swap_check: bool) -> Dict:
    registry.register(name, builder(registry.device))
    shape = registry.get(name).example_shape

    def make_row(i):
        return np.random.default_rng(i).normal(
            size=(1,) + shape).astype(np.float32)

    def unbatched(x):
        return server.predict(name, x, batched=False)

    def batched(x):
        return server.predict(name, x, batched=True)

    # warm both paths (dispatch warmth; the runner builds all happened at
    # register() and are asserted below)
    unbatched(make_row(0))
    batched(make_row(0))

    out: Dict = {}
    top = max(clients)
    for c in clients:
        if c != top:
            out[str(c)] = {"unbatched": _closed_loop(
                unbatched, c, requests_per_client, make_row),
                "batched": _closed_loop(
                    batched, c, requests_per_client, make_row)}
            continue
        # top level: alternating paired reps, median-of-ratios
        unb_reps, bat_reps, ratios = [], [], []
        for _ in range(pairs_at_top):
            u = _closed_loop(unbatched, c, requests_per_client, make_row)
            b = _closed_loop(batched, c, requests_per_client, make_row)
            unb_reps.append(u)
            bat_reps.append(b)
            if u["req_s"]:
                ratios.append(round(b["req_s"] / u["req_s"], 2))
        by_rate = lambda reps: sorted(  # noqa: E731 - median-rate rep
            reps, key=lambda r: r["req_s"])[len(reps) // 2]
        out[str(c)] = {
            "unbatched": by_rate(unb_reps),
            "batched": by_rate(bat_reps),
            "req_s_spread": {
                "unbatched": [min(r["req_s"] for r in unb_reps),
                              max(r["req_s"] for r in unb_reps)],
                "batched": [min(r["req_s"] for r in bat_reps),
                            max(r["req_s"] for r in bat_reps)]},
            "paired_ratios": ratios,
        }
        out["batched_vs_unbatched_speedup"] = _median(ratios) if ratios \
            else None

    if swap_check:
        with tempfile.TemporaryDirectory() as d:
            ckpt = f"{d}/swap.zip"
            from ..util.serializer import ModelSerializer
            ModelSerializer.write_model(builder(registry.device), ckpt)
            out["swap_under_load"] = _swap_under_load(
                server, registry, name, ckpt)

    # build accounting: exactly one runner build per (model, bucket)
    # across the whole run, swaps included (same-architecture swaps
    # reuse runners)
    prefix = f"serving/{name}:b"
    compiles = {k[len(prefix):]: v["count"]
                for k, v in sess.compiles.report().items()
                if k.startswith(prefix)}
    out["compiles_per_bucket"] = compiles
    out["one_compile_per_bucket"] = (
        set(compiles) == {str(b) for b in buckets}
        and all(v == 1 for v in compiles.values()))
    return out


def run_serving_bench(clients: Sequence[int] = (1, 8, 32),
                      requests_per_client: int = 150,
                      buckets: Sequence[int] = (1, 8, 32),
                      max_wait_us: int = 5000,
                      models: Sequence[str] = ("lenet", "mlp128"),
                      pairs_at_top: int = 3,
                      swap_check: bool = True, device=None) -> Dict:
    """Per-model batched/unbatched p50/p99 + req/s at each concurrency
    level, the median paired speedup at the top level, hot-swap-under-load
    and one-build-per-bucket verdicts, on `device` (the GPU by default)."""
    from ..telemetry import enabled
    from .registry import ModelRegistry
    from .server import InferenceServer

    results: Dict = {"clients": list(clients), "device": str(device),
                     "rows_per_request": 1,
                     "requests_per_client": requests_per_client,
                     "buckets": list(buckets),
                     "max_wait_us": max_wait_us}
    with enabled() as sess:
        registry = ModelRegistry(buckets=buckets, metrics=sess.registry,
                                 device=device)
        server = InferenceServer(registry, batching=True,
                                 max_wait_us=max_wait_us)
        # engine-only: the HTTP thread is never started; server.predict
        # IS the handler's data plane
        try:
            for name in models:
                results[name] = _bench_model(
                    server, registry, sess, name, _MODELS[name], clients,
                    requests_per_client, buckets, pairs_at_top,
                    swap_check=swap_check and name == "lenet")
        finally:
            server.stop()
    results["speedup_at_max_clients"] = {
        name: results[name].get("batched_vs_unbatched_speedup")
        for name in models}
    return results


def main(argv=None):
    """`python -m deeplearning4j_tpu_torch.serving.bench` — one JSON
    line."""
    import argparse

    ap = argparse.ArgumentParser(prog="deeplearning4j_tpu_torch.serving."
                                      "bench")
    ap.add_argument("--device", default=None)
    ap.add_argument("--clients", default="1,8,32")
    ap.add_argument("--requests", type=int, default=150)
    ap.add_argument("--max-wait-us", type=int, default=5000)
    ap.add_argument("--models", default="lenet,mlp128")
    ap.add_argument("--pairs", type=int, default=3)
    args = ap.parse_args(argv)
    out = run_serving_bench(
        clients=tuple(int(c) for c in args.clients.split(",")),
        requests_per_client=args.requests,
        max_wait_us=args.max_wait_us,
        models=tuple(args.models.split(",")),
        pairs_at_top=args.pairs, device=args.device)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
