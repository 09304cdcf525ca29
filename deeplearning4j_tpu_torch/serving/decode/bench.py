"""Closed-loop generation bench: continuous vs static batching through
the server's `/generate` data plane (the port of
`deeplearning4j_tpu/serving/decode/bench.py`, on the GPU unless the caller
passes `device="cpu"`).

Concurrent client threads each run a closed loop of generation requests
(random prompt lengths, random `max_tokens`) against
`InferenceServer.generate` — the exact method the HTTP handler invokes,
minus stdlib-HTTP parsing, matching `serving/bench.py`'s engine-only
protocol. The two arms run the SAME workload in ALTERNATING paired
windows (a guard against load swings on the host):

  * `continuous` — token-granularity admission: a finished sequence's
    batch slot refills between decode ticks;
  * `static` — request-level batching: the batch only refills once
    every running sequence drains (the classic serving baseline).

With length-varied requests the static arm spends its tail ticks at
batch 1 while finished clients wait, so the paired tokens/s ratio
(median over pairs) must exceed 1 — that ratio, plus p50/p99 request
latency and a zero-failed-requests count per arm, is the
`Serving-decode-tokens-per-s` extras block.

Two more verdicts ride along, mirroring the stateless plane's bench:
a same-architecture hot-swap lands mid-window in the first continuous
window (running sequences re-prefill against the new weights; no
request may fail), and the CompileWatcher must report exactly ONE step
build per (model, phase, bucket) across the whole run — both arms, swap
included, share the registry's decode steps. On the card it also counts
the tick graphs captured: one per (scheduler pool, version, bucket), none
of them on a request's path.
"""
from __future__ import annotations

import json
import tempfile
import threading
import time
from typing import Dict, Optional, Sequence

import numpy as np

__all__ = ["run_decode_bench"]

_VOCAB = 48


def _lm(seed=7, vocab=_VOCAB, width=32, heads=4, t=64, blocks=2,
        device=None):
    from ... import (Adam, EmbeddingSequenceLayer, InputType,
                     MultiLayerNetwork, NeuralNetConfiguration,
                     RnnOutputLayer, TransformerBlock)
    b = (NeuralNetConfiguration.builder().seed(seed).updater(Adam(1e-3))
         .list().layer(EmbeddingSequenceLayer(n_in=vocab, n_out=width)))
    for _ in range(blocks):
        b = b.layer(TransformerBlock(n_heads=heads))
    conf = (b.layer(RnnOutputLayer(n_out=vocab, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(InputType.recurrent(1, t)).build())
    return MultiLayerNetwork(conf, device=device).init()


def _window(server, name: str, n_clients: int, requests: int,
            seed: int, swap_source: Optional[str] = None,
            vocab: int = _VOCAB, prompt_len=(4, 12),
            max_tokens=(4, 28)) -> Dict:
    """One measurement window: every client runs `requests` generation
    calls with seed-determined prompt/max_tokens (identical across the
    paired windows; prompt lengths and max_tokens drawn from [lo, hi)).
    Optionally lands a hot-swap mid-window."""
    lat = [[] for _ in range(n_clients)]
    toks = [0] * n_clients
    errors = []
    barrier = threading.Barrier(n_clients + 1 + (1 if swap_source else 0))

    def client(i):
        r = np.random.default_rng(1000 + i)   # NOT seed-dependent: the
        # paired windows must replay the identical request sequence
        barrier.wait()
        for _ in range(requests):
            prompt = r.integers(0, vocab,
                                int(r.integers(*prompt_len))).tolist()
            mt = int(r.integers(*max_tokens))
            t0 = time.perf_counter()
            try:
                res = server.generate(name, prompt, max_tokens=mt,
                                      timeout=600)
            except Exception as e:   # pragma: no cover - surfaced in dict
                errors.append(f"{type(e).__name__}: {e}")
                return
            lat[i].append(time.perf_counter() - t0)
            toks[i] += res["generated_tokens"]

    def swapper():
        barrier.wait()
        time.sleep(0.05)             # land mid-window
        server.registry.swap(name, swap_source)

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(n_clients)]
    if swap_source:
        threads.append(threading.Thread(target=swapper, daemon=True))
    for t in threads:
        t.start()
    barrier.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    all_lat = np.asarray([v for row in lat for v in row])
    out = {"tokens_per_s": round(sum(toks) / wall, 1) if wall > 0 else 0.0,
           "requests": int(len(all_lat)), "failed": len(errors)}
    if len(all_lat):
        out["p50_ms"] = round(float(np.percentile(all_lat, 50)) * 1e3, 2)
        out["p99_ms"] = round(float(np.percentile(all_lat, 99)) * 1e3, 2)
    if errors:
        out["errors"] = errors[:3]
    return out


def run_decode_bench(n_clients: int = 8, requests_per_client: int = 3,
                     pairs: int = 3, block_len: int = 8,
                     decode_buckets: Sequence[int] = (1, 2, 4, 8),
                     kv_dtype: str = "fp32",
                     swap_check: bool = True, device=None,
                     model=None, prompt_len=(4, 12),
                     max_tokens=(4, 28)) -> Dict:
    """The `Serving-decode-tokens-per-s` extras block for bench.py (see
    module docstring): per-arm tokens/s + p50/p99 per paired window, the
    median continuous/static ratio, the swap-under-generation verdict,
    and the one-compile-per-(phase, bucket) verdict. `model(seed)` builds
    the served LM (default: the small two-block LM above) and
    `prompt_len` / `max_tokens` bound the clients' random requests."""
    from ...telemetry import enabled
    from ...util.serializer import ModelSerializer
    from ..registry import ModelRegistry
    from ..server import InferenceServer

    name = "gen"
    opts = dict(block_len=block_len, decode_buckets=tuple(decode_buckets),
                kv_dtype=kv_dtype)
    if model is None:
        model = lambda seed: _lm(seed=seed, device=device)  # noqa: E731
    results: Dict = {"n_clients": n_clients, "device": str(device),
                     "prompt_len": list(prompt_len),
                     "max_tokens": list(max_tokens),
                     "requests_per_client": requests_per_client,
                     "pairs": pairs, "kv_dtype": kv_dtype,
                     "decode_buckets": list(decode_buckets)}
    with enabled() as sess, \
            tempfile.TemporaryDirectory() as tmp:
        registry = ModelRegistry(metrics=sess.registry, device=device)
        server = InferenceServer(registry, batching=False)
        # engine-only: the HTTP thread is never started; server.generate
        # IS the /generate handler's data plane
        try:
            lm = model(7)
            load = dict(vocab=int(lm.layers[0].n_in),
                        prompt_len=tuple(prompt_len),
                        max_tokens=tuple(max_tokens))
            registry.register(name, lm, buckets=(1,))
            swap_src = None
            if swap_check:
                swap_src = f"{tmp}/swap.zip"
                ModelSerializer.write_model(model(8), swap_src)
            # unmeasured warmup pair: pays every decode/prefill compile
            # and hosts the swap-under-generation check, so the measured
            # windows compare pure steady-state scheduling
            warm: Dict = {}
            for mode in ("continuous", "static"):
                server.enable_generation(name, mode=mode, **opts)
                try:
                    warm[mode] = _window(server, name, n_clients,
                                         requests_per_client, seed=-1,
                                         swap_source=(swap_src
                                                      if mode
                                                      == "continuous"
                                                      else None), **load)
                finally:
                    server.disable_generation(name)
            if swap_check:
                results["swap_under_generation"] = {
                    "failed": warm["continuous"]["failed"],
                    "errors": warm["continuous"].get("errors", [])}
            windows, ratios = [], []
            for p in range(pairs):
                pair: Dict = {}
                for mode in ("continuous", "static"):
                    server.enable_generation(name, mode=mode, **opts)
                    try:
                        pair[mode] = _window(
                            server, name, n_clients, requests_per_client,
                            seed=p, **load)
                    finally:
                        server.disable_generation(name)
                windows.append(pair)
                if pair["static"]["tokens_per_s"]:
                    ratios.append(round(pair["continuous"]["tokens_per_s"]
                                        / pair["static"]["tokens_per_s"],
                                        2))
            results["windows"] = windows
            results["paired_ratios"] = ratios
            results["continuous_vs_static"] = (
                sorted(ratios)[len(ratios) // 2] if ratios else None)
            results["failed_requests"] = sum(
                w[m]["failed"] for w in [warm] + windows
                for m in ("continuous", "static"))
            # build accounting: both arms + the swap share the decode
            # steps — exactly one build per (phase, bucket)
            prefix = f"serving/{name}:b"
            compiles = {k[len(prefix):]: v["count"]
                        for k, v in sess.compiles.report().items()
                        if k.startswith(prefix)}
            results["compiles_per_phase_bucket"] = compiles
            results["one_compile_per_phase_bucket"] = (
                bool(compiles)
                and all(v == 1 for v in compiles.values()))
            captures = {k: v["count"]
                        for k, v in sess.compiles.report().items()
                        if k.startswith(f"serving/decode:{name}:")}
            results["tick_captures"] = captures
        finally:
            server.stop()
    return results


def main(argv=None):
    """`python -m deeplearning4j_tpu_torch.serving.decode.bench` — one JSON
    line."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="deeplearning4j_tpu_torch.serving.decode.bench")
    ap.add_argument("--device", default=None)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--kv-dtype", default="fp32")
    ap.add_argument("--no-swap", action="store_true")
    args = ap.parse_args(argv)
    out = run_decode_bench(n_clients=args.clients,
                           requests_per_client=args.requests,
                           pairs=args.pairs, kv_dtype=args.kv_dtype,
                           swap_check=not args.no_swap, device=args.device)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
