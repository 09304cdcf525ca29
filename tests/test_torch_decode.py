"""PyTorch port, the autoregressive decode plane on the CPU, twin of
`tests/test_decode.py` (18 of its 20 tests; its two JAX-IR probes wait for
the torch analogs of the jit-hygiene rules).

The port's LM (vocab 32, width 16, 4 heads, 2 blocks, context 32) takes
its parameters from the JAX LM through `from_jax_params`; the JAX
references (its decode engine's per-step logits, its scheduler's greedy
and seeded-sampling tokens) are computed once per module, inside the
one-core pin of `torch_threads.py`.

Contracts, as in JAX:
  * bit-exact within the port: a row's tick logits with and without a
    batch neighbour (one bucket), a reused KV block against a fresh one,
    and greedy tokens across eviction and re-prefill;
  * against the port's own full-sequence forward: per-step logits within
    rtol 2e-5, atol 1e-6 (JAX's own limits), greedy argmax identical;
  * against JAX: engine logits within 1e-5 of the largest |logit|, the
    scheduler's greedy tokens and its seeded temperature samples equal.
"""
import functools
import json
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import (Adam as JaxAdam,
                                EmbeddingSequenceLayer as JaxEmbedding,
                                InputType as JaxInputType,
                                MultiLayerNetwork as JaxNet,
                                NeuralNetConfiguration as JaxNNC,
                                RnnOutputLayer as JaxRnnOutput,
                                TransformerBlock as JaxBlock)
from deeplearning4j_tpu.kernels.attention import \
    attention_reference as jax_attention_reference
from deeplearning4j_tpu.serving.batcher import FlushEma as JaxFlushEma
from deeplearning4j_tpu.serving.decode import \
    GenerationScheduler as JaxScheduler
from deeplearning4j_tpu.serving.registry import \
    ModelRegistry as JaxModelRegistry
from deeplearning4j_tpu_torch import (Adam, DenseLayer, EmbeddingSequenceLayer,
                                      InputType, MultiLayerNetwork,
                                      NeuralNetConfiguration, OutputLayer,
                                      RnnOutputLayer, Sgd, TransformerBlock,
                                      from_jax_params, telemetry)
from deeplearning4j_tpu_torch.kernels.attention import attention_reference
from deeplearning4j_tpu_torch.serving.batcher import FlushEma
from deeplearning4j_tpu_torch.serving.decode import engine as engine_mod
from deeplearning4j_tpu_torch.serving.decode import (DecodeEngine,
                                                     GenerationError,
                                                     GenerationScheduler,
                                                     OutOfBlocksError)
from deeplearning4j_tpu_torch.serving.registry import (ModelRegistry,
                                                       ServingError)
from deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry
from deeplearning4j_tpu_torch.util.serializer import ModelSerializer
from jax_reference import jax_init
from torch_threads import one_torch_thread, pinned  # noqa: F401

pytestmark = pytest.mark.sanitize(
    allow_threads=("dl4j-decode-sched-", "dl4j-torch-serving-http"))

VOCAB, WIDTH, TMAX = 32, 16, 32
JAX_REL = 1e-5          # engine logits against JAX, of the largest |logit|
PROMPT = [5, 11, 2, 29, 7]
GREEDY = [3, 7, 1, 4, 9, 2]
CONCURRENT = [[1 + i, 8, 2 * i + 1, 5] for i in range(6)]
SAMPLED = dict(prompt=[4, 9, 1], max_tokens=8, temperature=0.9, seed=42)


def _conf(nnc, embedding, block, output, input_type, adam, seed):
    b = (nnc.builder().seed(seed).updater(adam(1e-3))
         .list().layer(embedding(n_in=VOCAB, n_out=WIDTH)))
    for _ in range(2):
        b = b.layer(block(n_heads=4))
    return (b.layer(output(n_out=VOCAB, activation="softmax",
                           loss="mcxent"))
            .set_input_type(input_type.recurrent(1, TMAX)).build())


def lm(seed=0):
    """The port's LM, drawn from `seed`."""
    conf = _conf(NeuralNetConfiguration, EmbeddingSequenceLayer,
                 TransformerBlock, RnnOutputLayer, InputType, Adam, seed)
    return MultiLayerNetwork(conf, device="cpu").init()


@functools.lru_cache(maxsize=None)
def _pair():
    """(JAX LM, the port's LM on its parameters)."""
    jnet = jax_init(JaxNet(_conf(JaxNNC, JaxEmbedding, JaxBlock, JaxRnnOutput,
                                 JaxInputType, JaxAdam, 3)))
    params = [{k: np.asarray(v) for k, v in p.items()} for p in jnet.params]
    return jnet, from_jax_params(lm(seed=3), params)


@functools.lru_cache(maxsize=None)
def _jax():
    """The JAX references: its engine's prefill + 10 greedy ticks on PROMPT
    (logits per step), and its scheduler's tokens for every request the
    tests send, submitted one at a time (greedy tokens do not depend on
    the batch)."""
    jnet, _ = _pair()
    reg = JaxModelRegistry()
    reg.register("gen", jnet, buckets=(1,))
    sched = JaxScheduler(reg, "gen", block_len=4, decode_buckets=(1,))
    try:
        eng, v = sched.engine, reg.get("gen")
        pool = eng.new_pool()
        blocks = pool.alloc(eng.spec.blocks_for(len(PROMPT)))
        logits = [eng.run_prefill(v, pool, PROMPT, blocks)]
        ctx = list(PROMPT)
        for _ in range(10):
            tok = int(np.argmax(logits[-1]))
            ctx.append(tok)
            need = eng.spec.blocks_for(len(ctx)) - len(blocks)
            if need:
                blocks += pool.alloc(need)
            logits.append(eng.run_tick(v, pool, [tok], [len(ctx) - 1],
                                       [blocks], bucket=1)[0])
        out = {"engine": np.stack(logits),
               "greedy": sched.submit(GREEDY, max_tokens=10,
                                      timeout=300)["tokens"],
               "context": sched.submit(GREEDY, max_tokens=10_000,
                                       timeout=300),
               "concurrent": [sched.submit(p, max_tokens=6 + i % 3,
                                           timeout=300)["tokens"]
                              for i, p in enumerate(CONCURRENT)],
               "sampled": sched.submit(
                   SAMPLED["prompt"], max_tokens=SAMPLED["max_tokens"],
                   temperature=SAMPLED["temperature"], seed=SAMPLED["seed"],
                   timeout=300)["tokens"],
               "first": sched.submit([3, 7, 1, 4], max_tokens=1,
                                     timeout=300)["tokens"]}
    finally:
        sched.stop()
    return out


def eager_logits(model, ctx):
    """Full-sequence forward, no cache and no padding: the next-token
    logits after `ctx` (the decode plane's ground truth)."""
    x = torch.tensor(ctx, dtype=torch.float32)[None, :, None]
    with torch.no_grad():
        h = model._forward(model.params, model.state, x,
                           upto=len(model.layers) - 1)[0]
        return model.layers[-1].preout(model.params[-1], {}, h)[0, -1].numpy()


def eager_greedy(model, prompt, n):
    ctx = list(prompt)
    for _ in range(n):
        ctx.append(int(np.argmax(eager_logits(model, ctx))))
    return ctx[len(prompt):]


@pytest.fixture(scope="module")
def served():
    """Module-shared registry and greedy continuous scheduler over the
    port's LM (the JAX LM's parameters)."""
    with pinned():
        reg = ModelRegistry(device="cpu")
        model = _pair()[1]
        reg.register("gen", model, buckets=(1,))
        sched = GenerationScheduler(reg, "gen", block_len=4,
                                    decode_buckets=(1, 2, 4))
    yield reg, model, sched
    sched.stop()


# ---------------------------------------------------------------------------
# the plain attention's decode masks
# ---------------------------------------------------------------------------

def test_attention_kv_length_matches_sliced_full():
    """`kv_length` masking is full attention over only the valid prefix,
    row by row, bit for bit; and JAX's `attention_reference` agrees."""
    r = np.random.default_rng(0)
    B, T, D = 3, 8, 4
    qn, kn, vn = (r.normal(size=s).astype(np.float32)
                  for s in ((B, 1, D), (B, T, D), (B, T, D)))
    q, k, v = map(torch.from_numpy, (qn, kn, vn))
    lengths = [3, 8, 5]
    pos = [[n - 1] for n in lengths]
    out = attention_reference(q, k, v, causal=True,
                              q_positions=torch.tensor(pos),
                              kv_length=torch.tensor(lengths))
    for b, n in enumerate(lengths):
        ref = attention_reference(q[b:b + 1], k[b:b + 1, :n], v[b:b + 1, :n])
        assert torch.equal(out[b], ref[0])
    want = jax_attention_reference(qn, kn, vn, causal=True,
                                   q_positions=np.asarray(pos, np.int32),
                                   kv_length=np.asarray(lengths, np.int32))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_attention_kv_length_garbage_slots_inert():
    """Slots past kv_length may hold any finite garbage without changing
    an output bit (the decode plane's trash block); a row that admits no
    key gives NaN, as in JAX."""
    r = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(r.normal(size=s).astype(np.float32))
               for s in ((2, 1, 4), (2, 6, 4), (2, 6, 4)))
    kw = dict(causal=True, q_positions=torch.tensor([[3], [2]]),
              kv_length=torch.tensor([4, 3]))
    a = attention_reference(q, k, v, **kw)
    k2, v2 = k.clone(), v.clone()
    k2[:, 4:] = 1e9
    v2[:, 4:] = -1e9
    assert torch.equal(a, attention_reference(q, k2, v2, **kw))
    empty = attention_reference(q, k, v, kv_length=torch.tensor([0, 3]))
    assert torch.isnan(empty[0]).all() and not torch.isnan(empty[1]).any()
    want = jax_attention_reference(q.numpy(), k.numpy(), v.numpy(),
                                   kv_length=np.asarray([0, 3], np.int32))
    assert np.isnan(np.asarray(want)[0]).all()


# ---------------------------------------------------------------------------
# prefill + ticks against the full forward, and against JAX
# ---------------------------------------------------------------------------

def test_engine_prefill_and_ticks_match_full_forward(served):
    """Per-step logits within JAX's limits of the full forward, greedy
    argmax identical; and within 1e-5 of the largest |logit| of the JAX
    engine on the same parameters, with the same greedy tokens."""
    reg, model, sched = served
    want = _jax()["engine"]
    eng, v = sched.engine, reg.get("gen")
    pool = eng.new_pool()
    blocks = pool.alloc(eng.spec.blocks_for(len(PROMPT)))
    logits = eng.run_prefill(v, pool, PROMPT, blocks)
    ctx = list(PROMPT)
    for step in range(11):
        ref = eager_logits(model, ctx)
        np.testing.assert_allclose(logits, ref, rtol=2e-5, atol=1e-6)
        assert int(np.argmax(logits)) == int(np.argmax(ref)), \
            f"greedy diverged at step {step}"
        gap = np.abs(logits - want[step]).max() / np.abs(want[step]).max()
        assert gap <= JAX_REL, f"step {step}: {gap} of max |logit| from JAX"
        assert int(np.argmax(logits)) == int(np.argmax(want[step]))
        if step == 10:
            break
        tok = int(np.argmax(logits))
        ctx.append(tok)
        pos = len(ctx) - 1
        need = eng.spec.blocks_for(pos + 1) - len(blocks)
        if need:
            blocks += pool.alloc(need)
        logits = eng.run_tick(v, pool, [tok], [pos], [blocks], bucket=1)[0]
    pool.release(blocks)


def test_scheduler_greedy_identical_to_full_forward(served):
    reg, model, sched = served
    res = sched.submit(GREEDY, max_tokens=10, timeout=300)
    assert res["tokens"] == eager_greedy(model, GREEDY, 10)
    assert res["tokens"] == _jax()["greedy"]
    assert res["finish_reason"] == "length"
    assert res["generated_tokens"] == 10
    # deterministic: resubmitting replays the identical sequence
    assert sched.submit(GREEDY, max_tokens=10,
                        timeout=300)["tokens"] == res["tokens"]


def test_scheduler_concurrent_clients_all_greedy_exact(served):
    """Joins and leaves while neighbours are mid-flight: every client
    still gets its single-sequence greedy answer, JAX's."""
    reg, model, sched = served
    want = _jax()["concurrent"]
    got = [None] * len(CONCURRENT)

    def client(i):
        got[i] = sched.submit(CONCURRENT[i], max_tokens=6 + i % 3,
                              timeout=300)["tokens"]

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(CONCURRENT))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert got == want
    assert got == [eager_greedy(model, p, 6 + i % 3)
                   for i, p in enumerate(CONCURRENT)]


def test_stop_token_and_context_cap(served):
    reg, model, sched = served
    full = _jax()["greedy"]
    stop = full[3]
    res = sched.submit(GREEDY, max_tokens=10, stop=[stop], timeout=300)
    assert res["finish_reason"] == "stop"
    # cut at the stop token's first occurrence (greedy chains repeat)
    assert res["tokens"] == full[:full.index(stop)]
    res = sched.submit(GREEDY, max_tokens=10_000, timeout=300)
    assert res["finish_reason"] == "context"
    assert len(GREEDY) + res["generated_tokens"] == TMAX
    assert res == _jax()["context"]
    with pytest.raises(GenerationError):
        sched.submit(list(range(TMAX)), timeout=300)


def test_temperature_sampling_seeded(served):
    """Seeded sampling replays itself and draws JAX's tokens: the same
    numpy generator and float64 softmax over logits within 1e-5."""
    reg, model, sched = served
    kw = dict(max_tokens=SAMPLED["max_tokens"],
              temperature=SAMPLED["temperature"], seed=SAMPLED["seed"],
              timeout=300)
    a = sched.submit(SAMPLED["prompt"], **kw)
    b = sched.submit(SAMPLED["prompt"], **kw)
    assert a["tokens"] == b["tokens"] == _jax()["sampled"]
    assert all(0 <= t < VOCAB for t in a["tokens"])


# ---------------------------------------------------------------------------
# bit-exactness within the port: isolation and block reuse
# ---------------------------------------------------------------------------

def test_join_leave_neighbour_isolation_bitexact(served):
    """A row's tick logits are bit-identical with and without a batch
    neighbour (same bucket, so the same step)."""
    reg, model, sched = served
    eng, v = sched.engine, reg.get("gen")
    pa, pb = [5, 11, 2, 29, 7], [1, 2, 3]

    def run(with_neighbour):
        pool = eng.new_pool()
        ba = pool.alloc(eng.spec.blocks_for(len(pa) + 1))
        la = eng.run_prefill(v, pool, pa, ba)
        rows = [(int(np.argmax(la)), len(pa), ba)]
        if with_neighbour:
            bb = pool.alloc(eng.spec.blocks_for(len(pb) + 1))
            lb = eng.run_prefill(v, pool, pb, bb)
            rows.append((int(np.argmax(lb)), len(pb), bb))
        out = eng.run_tick(v, pool, [r[0] for r in rows],
                           [r[1] for r in rows], [r[2] for r in rows],
                           bucket=2)
        return la, out[0]

    la2, tick2 = run(True)
    la1, tick1 = run(False)
    np.testing.assert_array_equal(la1, la2)       # prefill: same blocks
    np.testing.assert_array_equal(tick1, tick2)   # tick: neighbour inert


def test_kv_block_reuse_after_release_bitexact(served):
    """Blocks freed by one sequence and recycled by another behave
    bit-identically to a fresh allocation — logits and the arena slots
    the new sequence covers."""
    reg, model, sched = served
    eng, v = sched.engine, reg.get("gen")
    pa, pb = [9, 9, 9, 9, 9, 9, 9], [4, 1, 6, 2, 8]

    def gen3(pool, blocks):
        out = [eng.run_prefill(v, pool, pb, blocks)]
        ctx = list(pb)
        for _ in range(3):
            tok = int(np.argmax(out[-1]))
            ctx.append(tok)
            need = eng.spec.blocks_for(len(ctx)) - len(blocks)
            if need:
                blocks += pool.alloc(need)
            out.append(eng.run_tick(v, pool, [tok], [len(ctx) - 1],
                                    [blocks], bucket=1)[0])
        return blocks, out

    pool1 = eng.new_pool()
    stale = pool1.alloc(eng.spec.blocks_for(len(pa)))
    eng.run_prefill(v, pool1, pa, stale)          # dirty the blocks
    pool1.release(stale)
    reused = pool1.alloc(eng.spec.blocks_for(len(pb)))
    assert set(reused) <= set(stale)              # LIFO recycles them
    reused, out1 = gen3(pool1, reused)

    pool2 = eng.new_pool()
    fresh = pool2.alloc(eng.spec.blocks_for(len(pb)))
    fresh, out2 = gen3(pool2, fresh)
    for a, b in zip(out1, out2):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(pool1.cache["kv"][reused], pool2.cache["kv"][fresh])


def test_eviction_resume_greedy_exact_and_counted():
    """Under KV-block pressure the scheduler preempts sequences (blocks
    freed, context re-prefilled on re-admission): every client still gets
    the port's exact greedy answer and the eviction counter moved."""
    reg = ModelRegistry(device="cpu")
    model = lm(seed=5)
    reg.register("gen", model, buckets=(1,))
    metrics = MetricsRegistry()
    # 7 usable blocks of 4 slots: three 16-token sequences cannot all be
    # resident, so continuous batching must juggle by eviction
    sched = GenerationScheduler(reg, "gen", block_len=4, num_blocks=8,
                                decode_buckets=(1, 2, 4),
                                metrics=metrics)
    try:
        prompts = [[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]]
        want = [eager_greedy(model, p, 12) for p in prompts]
        got = [None] * 3

        def client(i):
            got[i] = sched.submit(prompts[i], max_tokens=12,
                                  timeout=300)["tokens"]

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert got == want
        evicted = metrics.counter(
            "dl4j_decode_evictions_total", "",
            labels=("model",)).value(model="gen")
        assert evicted >= 1, "pressure never forced an eviction"
        assert sched.pool.used_blocks() == 0
    finally:
        sched.stop()


def test_single_sequence_larger_than_pool_fails_cleanly():
    reg = ModelRegistry(device="cpu")
    reg.register("gen", lm(seed=5), buckets=(1,))
    sched = GenerationScheduler(reg, "gen", block_len=4, num_blocks=3,
                                decode_buckets=(1,))
    try:
        with pytest.raises((GenerationError, OutOfBlocksError)):
            sched.submit([1, 2, 3], max_tokens=20, timeout=300)
        assert sched.pool.used_blocks() == 0
    finally:
        sched.stop()


# ---------------------------------------------------------------------------
# int8 KV cache
# ---------------------------------------------------------------------------

def test_int8_kv_cache_generates(served):
    reg = served[0]
    sched = GenerationScheduler(reg, "gen", block_len=4, kv_dtype="int8",
                                decode_buckets=(1, 2))
    try:
        assert sched.pool.cache["kv"].dtype == torch.int8
        assert sched.pool.cache["scale"].dtype == torch.float32
        res = sched.submit([3, 7, 1, 4], max_tokens=6, timeout=300)
        assert res["generated_tokens"] == 6
        # the prefill attends over the local, unquantized projections, so
        # the first sampled token is the fp32 cache's, JAX's
        assert res["tokens"][0] == _jax()["first"][0]
    finally:
        sched.stop()


# ---------------------------------------------------------------------------
# build accounting and cache keys
# ---------------------------------------------------------------------------

def test_swap_and_generate_one_compile_per_signature():
    """Decode and prefill steps are built once per (phase, bucket) for the
    server's lifetime, across a same-architecture hot-swap, and generation
    picks up the new weights (running sequences re-prefill)."""
    m1, m2 = lm(seed=7), lm(seed=8)
    with telemetry.enabled() as sess:
        reg = ModelRegistry(metrics=sess.registry, device="cpu")
        reg.register("gen", m1, buckets=(1,))
        sched = GenerationScheduler(reg, "gen", block_len=4,
                                    decode_buckets=(1, 2))
        try:
            prompt = [3, 7, 1, 4]
            assert sched.submit(prompt, max_tokens=5, timeout=300)[
                "tokens"] == eager_greedy(m1, prompt, 5)
            with tempfile.TemporaryDirectory() as d:
                ModelSerializer.write_model(m2, f"{d}/m2.zip")
                reg.swap("gen", f"{d}/m2.zip")
            assert sched.submit(prompt, max_tokens=5, timeout=300)[
                "tokens"] == eager_greedy(reg.get("gen").model, prompt, 5)
        finally:
            sched.stop()
        decode_compiles = {
            k: v["count"] for k, v in sess.compiles.report().items()
            if k.startswith("serving/gen:b")
            and ("decode" in k or "prefill" in k)}
        assert decode_compiles, "decode builds never recorded"
        assert all(c == 1 for c in decode_compiles.values()), \
            decode_compiles


class _EagerTick:
    """The engine's captured tick as it runs on the CPU: the same decode
    step, run eagerly at each replay. Its construction takes a while, as a
    capture does."""

    def __init__(self, engine, v, pool, bucket):
        time.sleep(0.005)
        self.version = v
        self._run = lambda x: engine.decode_exec(v, bucket)(
            v.snapshot.data, pool.cache, x[:, 0], x[:, 1], x[:, 2:],
            engine.spec)

    def replay(self, rows):
        with torch.no_grad():
            return self._run(torch.from_numpy(rows))


class _SlowIterDict(dict):
    """A pool's graph dict whose iteration takes 20 ms a key (a dict that
    changes size while iterated raises, as the plain dict does)."""

    def __iter__(self):
        for k in super().__iter__():
            time.sleep(0.02)
            yield k


def test_swaps_under_generation_with_tick_graphs(monkeypatch):
    """Two swaps back to back while the scheduler generates, with the
    card's tick graphs emulated on the CPU: the worker drops the old
    version's graphs while the next swap's listener captures the newest
    version's into the same pool. No request fails, nothing is captured
    on a tick's call, and only the live version's graphs stay."""
    monkeypatch.setattr(DecodeEngine, "uses_graphs",
                        property(lambda self: True))
    monkeypatch.setattr(engine_mod, "_TickGraph", _EagerTick)
    reg = ModelRegistry(device="cpu")
    reg.register("gen", lm(seed=11), buckets=(1,))
    sched = GenerationScheduler(reg, "gen", block_len=4,
                                decode_buckets=(1, 2, 4))
    sched.pool.graphs = _SlowIterDict(sched.pool.graphs)
    errors, served = [], []
    try:
        with tempfile.TemporaryDirectory() as d:
            zips = []
            for seed in (12, 13):
                ModelSerializer.write_model(lm(seed=seed), f"{d}/{seed}.zip")
                zips.append(f"{d}/{seed}.zip")

            def client(i):
                for k in range(6):
                    try:
                        served.append(sched.submit(
                            [1 + i, 2 + k, 3], max_tokens=8,
                            timeout=300))
                    except Exception as e:      # noqa: BLE001 - counted
                        errors.append(e)

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(4)]
            for t in threads:
                t.start()
            time.sleep(0.05)
            for z in zips:
                reg.swap("gen", z)
            for t in threads:
                t.join()
        assert not errors, errors[:3]
        assert len(served) == 24
        live = reg.get("gen")
        assert live.version == 3
        prompt = [3, 7, 1, 4]
        assert sched.submit(prompt, max_tokens=5, timeout=300)["tokens"] \
            == eager_greedy(live.model, prompt, 5)
        assert {k[0] for k in sched.pool.graphs} == {id(live)}
        assert sched.engine.captures == 3 * 3
        assert sched.engine.lazy_captures == 0
    finally:
        sched.stop()


def test_registry_decode_and_fwd_cache_keys_disjoint():
    """The decode plane's steps live under ("decode", sig, phase, bucket)
    keys and the stateless plane's runners under ("fwd", sig, bucket):
    enabling generation on a servable must not evict its forward runners,
    nor the reverse."""
    reg = ModelRegistry(device="cpu")
    reg.register("gen", lm(seed=9), buckets=(1,))
    entry = reg._entries["gen"]
    fwd_keys = {k for k in entry.compiled if k[0] == "fwd"}
    assert fwd_keys, "stateless runners missing"
    eng = DecodeEngine(reg, "gen", block_len=4, decode_buckets=(1,))
    v = reg.get("gen")
    eng.prefill_exec(v, 8)
    eng.decode_exec(v, 1)
    keys = set(entry.compiled)
    assert fwd_keys <= keys, "decode builds evicted fwd runners"
    decode_keys = {k for k in keys if k[0] == "decode"}
    assert {k[2:] for k in decode_keys} == {("prefill", 8), ("tick", 1)}
    reg.register("twin", lm(seed=9), buckets=(1,))
    assert all(k[0] == "fwd" for k in reg._entries["twin"].compiled)


def test_flush_ema_bucket_extrapolation():
    """An unsampled bucket is estimated from the nearest larger sampled
    bucket (floored by smaller ones), as JAX's FlushEma does, and the
    flush choice follows rows per second."""
    for cls in (FlushEma, JaxFlushEma):
        ema = cls()
        ema.observe(1, 1e-4)
        ema.observe(32, 1e-2)
        est = ema.estimate(8)
        assert est == pytest.approx(1e-2 * 8 / 32)     # from bucket 32
        assert est > 1e-4                              # monotone floor
        assert ema.estimate(64) == pytest.approx(1e-2 * 64 / 32)
        assert ema.estimate(32) == pytest.approx(1e-2)
        ema2 = cls()
        ema2.observe(4, 1e-3)
        ema2.observe(8, 1e-2)       # padding up is 10x worse
        assert ema2.pick_rows(5, [1, 2, 4, 8], 8) == 4
        ema3 = cls()
        ema3.observe(4, 1e-3)
        ema3.observe(8, 1.1e-3)     # padding up is nearly free
        assert ema3.pick_rows(5, [1, 2, 4, 8], 8) == 5
    port, jax_ema = FlushEma(), JaxFlushEma()
    for b, t in ((2, 3e-4), (16, 2e-3), (2, 5e-4)):
        port.observe(b, t)
        jax_ema.observe(b, t)
    for b in (1, 2, 4, 8, 16, 32, 64):
        assert port.estimate(b) == jax_ema.estimate(b)


# ---------------------------------------------------------------------------
# HTTP endpoint
# ---------------------------------------------------------------------------

def _http(method, url, body=None, timeout=120):
    req = urllib.request.Request(
        url, None if body is None else json.dumps(body).encode(),
        {"Content-Type": "application/json"}, method=method)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def test_generate_http_endpoint():
    from deeplearning4j_tpu_torch.serving.server import InferenceServer

    model = _pair()[1]
    srv = InferenceServer(batching=False, device="cpu").start()
    try:
        srv.registry.register("gen", model, buckets=(1,))
        srv.enable_generation("gen", block_len=4, decode_buckets=(1, 2))
        base = f"http://{srv.host}:{srv.port}"
        out = _http("POST", f"{base}/v1/models/gen/generate",
                    {"prompt": GREEDY, "max_tokens": 10})
        assert out["tokens"] == _jax()["greedy"]
        assert out["finish_reason"] == "length" and out["version"] == 1
        out2 = _http("POST", f"{base}/v1/models/gen/generate",
                     {"prompt": GREEDY, "max_tokens": 10})
        assert out2["tokens"] == out["tokens"]
        req = urllib.request.Request(f"{base}/metrics")
        with urllib.request.urlopen(req, timeout=60) as resp:
            text = resp.read().decode()
        for family in ("dl4j_decode_tokens_total", "dl4j_decode_kv_blocks",
                       "dl4j_decode_admissions_total",
                       "dl4j_decode_phase_seconds"):
            assert family in text, f"{family} missing from /metrics"
        with pytest.raises(urllib.error.HTTPError) as ei:
            _http("POST", f"{base}/v1/models/gen/generate", {})
        assert ei.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as ei:
            _http("POST", f"{base}/v1/models/gen/generate",
                  {"prompt": GREEDY, "max_tokens": "lots of"})
        assert ei.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as ei:
            _http("POST", f"{base}/v1/models/nope/generate",
                  {"prompt": GREEDY})
        assert ei.value.code == 404
        # a model that cannot generate -> 400 (ServingError), not 500
        conf = (NeuralNetConfiguration.builder().seed(0).updater(Sgd(0.1))
                .list().layer(DenseLayer(n_out=8, activation="relu"))
                .layer(OutputLayer(n_out=4, loss="mcxent"))
                .set_input_type(InputType.feed_forward(6)).build())
        srv.registry.register(
            "mlp", MultiLayerNetwork(conf, device="cpu").init(),
            buckets=(1,))
        with pytest.raises(urllib.error.HTTPError) as ei:
            _http("POST", f"{base}/v1/models/mlp/generate",
                  {"prompt": GREEDY})
        assert ei.value.code == 400
    finally:
        srv.stop()


def test_scheduler_stop_rejects_new_submissions():
    reg = ModelRegistry(device="cpu")
    reg.register("gen", lm(seed=12), buckets=(1,))
    sched = GenerationScheduler(reg, "gen", block_len=4,
                                decode_buckets=(1,))
    res = sched.submit([1, 2, 3], max_tokens=2, timeout=300)
    assert res["generated_tokens"] == 2
    sched.stop()
    with pytest.raises(GenerationError):
        sched.submit([1, 2, 3], max_tokens=2)


def test_non_transformer_stack_rejected():
    conf = (NeuralNetConfiguration.builder().seed(0).updater(Sgd(0.1))
            .list().layer(DenseLayer(n_out=8, activation="relu"))
            .layer(OutputLayer(n_out=4, loss="mcxent"))
            .set_input_type(InputType.feed_forward(6)).build())
    reg = ModelRegistry(device="cpu")
    reg.register("mlp", MultiLayerNetwork(conf, device="cpu").init(),
                 buckets=(1,))
    with pytest.raises(ServingError):
        DecodeEngine(reg, "mlp")
