#!/usr/bin/env python3
"""Drive the PyTorch port (deeplearning4j_tpu_torch) on one NVIDIA GPU and
check every phase. Run from the repository root:

    python3 chip_smoke.py

Phases:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions,
     and the kernel build from the repository's CUDA sources;
  2. each kernel against its plain PyTorch version on the same GPU tensors,
     at the shapes the main paths give it (and ragged and other head-size
     cases for attention and its backward; one step, one row and a column
     tail for the LSTM training kernels);
  3. main path 1: the full-width char-RNN (vocab 77, 2 x GravesLSTM(200),
     seq 64, random weights from a seed) written to a zip, registered,
     served over HTTP in buckets 1, 8 and 32 (direct, batched, concurrent
     clients), hot-swapped, and checked against the same zip on the CPU;
  4. stateful sampling of 64 characters through rnn_time_step, each step
     held against the CPU;
  5. main path 2: the transformer LM at nanoGPT's shakespeare-char widths
     (vocab 65, width 384, 6 heads, 6 blocks, context 256, random weights
     from a seed) served the same way and checked against the CPU;
  6. main path 3: train the full-width char-RNN (BASELINE config 3's
     training bench: vocab 77, 2 x GravesLSTM(200), Adam 2e-3, batch 64,
     sequence 128, TBPTT 64) for 20 optimizer steps with `fit` over an
     ArrayDataSetIterator of the repository's README.md, from a zip of
     seeded random weights; the same zip and batches on the CPU; per-step
     scores, first-step gradients and final parameters compared; the zip
     with its updater state restored on both devices for one more step;
  7. main path 4: train the transformer LM of phase 5 (nanoGPT's
     shakespeare-char widths, Adam 1e-3 with beta2 0.99, dropout 0) for 20
     optimizer steps at batch 64 x 256 with `fit` over an
     ArrayDataSetIterator of overlapping windows of README.md, from a zip
     of seeded random weights; first-step gradients at batch 64 and a
     20-step trajectory at batch 16 held against the same zip and batches
     on the CPU; the trained zip with its updater state restored on both
     devices for one more step, then registered and served at bucket 32
     against the CPU;
  8. times: each kernel, its plain version, the PyTorch library call where
     there is one, and its bound; predict and HTTP p50 per bucket and
     tokens/s at bucket 32 for both models; training tokens/s and step
     p50 for both models; where the LM's bucket-32 forward, a char-RNN
     training batch and an LM training step spend their device time
     (torch.profiler).

Each kernel counts its launches. Every count is set to 0 before each main
path and read after it: two primal LSTM launches per char-RNN forward
(phases 3-4), six primal attention launches per LM forward (phase 5), two
residual-forward, two adjoint and two reduction launches per char-RNN
training step (phase 6), and six logsumexp-forward, six dq and six dk/dv
launches per LM training step (phase 7), each path launching none of the
others' kernels. The last two lines are a `{"kernels": [...]}` object and
`{"ok": true, "device": {...}}`. Any failed check, or a machine without a
CUDA device, exits non-zero before either.
"""
import json
import os
import string
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

DEVICE = "cuda"
BUCKETS = (1, 8, 32)
SERVE_TOL = 1e-4    # GPU kernel path vs the CPU plain path, end to end
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet, at 700 W
F32_FLOP_PER_S = 67e12          # H100 SXM float32 outside the tensor cores

# char-RNN (BASELINE config 3)
SEQ, VOCAB, HIDDEN = 64, 77, 200
LSTM_TOL = 5e-5     # f32 sums of up to 400 terms in another order, x 64 steps
ALPHABET = string.ascii_letters + string.digits + " .,;:!?'\"-()&/\n"

# char-RNN training (deeplearning4j_tpu/models/zoo.py:bench_char_rnn)
TRAIN_B, TRAIN_T, TRAIN_TBPTT, TRAIN_BATCHES = 64, 128, 64, 10
# The backward kernels against their plain versions, relative to the
# largest magnitude of the plain result: dx, dh0 and dc0 come out of a
# 64-step recurrence of f32 products summed in another order, dW, db and
# dpeep sum T*B = 4096 terms each.
BWD_TOL = 2e-5
# First-step gradients on the card against the CPU, per tensor relative to
# its largest entry: the kernels' f32 sums in another order, plus cuBLAS
# against the CPU's BLAS for the output layer.
GRAD_TOL = 1e-4
# Scores of the 20 steps, card against CPU (absolute; the score starts at
# ln 77 = 4.34): the ROADMAP's trajectory bound.
SCORE_TOL = 1e-4
# Final parameters, card against CPU, per tensor: |a - b| / |b| in L2.
# Adam's m / sqrt(v) can flip the sign of an update where a gradient entry
# is near zero, so a max-abs bound is the wrong test.
PARAM_TOL = 1e-3
GRADS = ("dx", "dW", "db", "dpeep", "dh0", "dc0")

# transformer LM (nanoGPT config/train_shakespeare_char.py)
LM_VOCAB, LM_WIDTH, LM_HEADS, LM_BLOCKS, LM_SEQ = 65, 384, 6, 6, 256
# f32 sums of up to 256 terms (64 for the logits) in another order than the
# plain version's einsum, and exp of differently rounded logits: about
# 2e-5 abs is the expected scale
ATTN_TOL = 5e-5
# The attention backward (and the logsumexp) against its plain version,
# relative to the largest magnitude of the plain result: sums of up to 256
# products in another order (the kv or q loop, and Dh per score), exp of
# differently rounded logits.
ATTN_GRAD_TOL = 2e-5

# LM training (nanoGPT config/train_shakespeare_char.py: batch 64, block
# 256, learning_rate 1e-3, beta2 0.99, dropout 0 for the comparison; no
# weight decay, warm-up or clipping, which the JAX package does not have in
# that form)
LM_ALPHABET = ("\n !$&',-.3:;?ABCDEFGHIJKLMNOPQRSTUVWXYZ"
               "abcdefghijklmnopqrstuvwxyz")     # its 65 characters
LM_TRAIN_B, LM_STEPS, LM_LR = 64, 20, 1e-3
# The card-against-CPU trajectory runs at batch 16: a batch-64 step of the
# full-width LM takes seconds on the CPU (printed below), 20 of them more
# than a minute.
LM_CMP_B = 16
# Scores of the LM's 20 steps, card against CPU (absolute). Without
# nanoGPT's warm-up, Adam at 1e-3 drives the score through spikes (4.2 ->
# 8.2 -> 3.1 at batch 16) that amplify float32 rounding about 1000-fold:
# 2.4e-7 apart at step 2, 2.0e-4 by step 17 through the kernels and 8.2e-5
# through the plain attention on the card (NVIDIA H100 80GB HBM3, 700 W,
# this script's printout), so the char-RNN's 1e-4 is out of reach for
# either. The plain-attention run is repeated below in every run.
LM_SCORE_TOL = 1e-3


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def http(method, url, body=None, timeout=300):
    req = urllib.request.Request(
        url, None if body is None else json.dumps(body).encode(),
        {"Content-Type": "application/json"}, method=method)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def one_hot_batch(rng, rows):
    idx = rng.integers(0, VOCAB, (rows, SEQ))
    return np.eye(VOCAB, dtype=np.float32)[idx]


def lm_ids(rng, rows):
    return rng.integers(0, LM_VOCAB, (rows, LM_SEQ, 1)).astype(np.float32)


def lstm_inputs(torch, T, B, F, H, seed):
    """One LSTM layer's inputs at the char-RNN's scale: one-hot characters
    into the first layer, tanh-range activations into the second,
    xavier-normal W, 0.1-normal biases and peepholes."""
    r = np.random.default_rng(seed)
    x = (np.eye(F)[r.integers(0, F, (T, B))] if F == VOCAB
         else np.tanh(r.normal(size=(T, B, F))))
    k = np.sqrt(2.0 / (F + H))
    arrays = (x, r.normal(size=(F + H, 4 * H)) * k,
              r.normal(size=(4 * H,)) * 0.1, r.normal(size=(3 * H,)) * 0.1,
              r.normal(size=(B, H)) * 0.5, r.normal(size=(B, H)) * 0.5)
    return [torch.as_tensor(a.astype(np.float32), device=DEVICE)
            for a in arrays]


def cotangents(torch, T, B, H, seed):
    """Standard-normal cotangents for hs, h_T and c_T."""
    r = np.random.default_rng(seed)
    return [torch.as_tensor(r.normal(size=s).astype(np.float32),
                            device=DEVICE)
            for s in ((T, B, H), (B, H), (B, H))]


def rel_err(got, want):
    """max |got - want| over max |want|."""
    return ((got - want).abs().max()
            / want.abs().max().clamp_min(1e-30)).item()


def text_windows(root, alphabet, n, length):
    """The repository's README.md as ids of `alphabet` (anything else
    becomes a space), cut into `n` evenly spaced windows of `length`
    characters (overlapping where the text is shorter than n * length)."""
    with open(os.path.join(root, "README.md"), encoding="utf-8") as fh:
        text = fh.read()
    index = {c: i for i, c in enumerate(alphabet)}
    ids = np.array([index.get(c, index[" "]) for c in text])
    starts = np.linspace(0, len(ids) - length, n).astype(np.int64)
    return ids[starts[:, None] + np.arange(length)]


def readme_batches(root):
    """TRAIN_BATCHES x TRAIN_B windows of TRAIN_T + 1 characters of
    ALPHABET as one-hot characters; the labels are the next character."""
    windows = text_windows(root, ALPHABET, TRAIN_BATCHES * TRAIN_B,
                           TRAIN_T + 1)
    eye = np.eye(VOCAB, dtype=np.float32)
    return eye[windows[:, :-1]], eye[windows[:, 1:]]


def lm_text_batches(root):
    """LM_STEPS x LM_TRAIN_B windows of LM_SEQ + 1 characters of
    LM_ALPHABET: ids [N, LM_SEQ, 1] and next-character one-hot labels."""
    windows = text_windows(root, LM_ALPHABET, LM_STEPS * LM_TRAIN_B,
                           LM_SEQ + 1)
    return (windows[:, :-1, None].astype(np.float32),
            np.eye(LM_VOCAB, dtype=np.float32)[windows[:, 1:]])


class StepLog:
    """Listener: every optimizer step's score tensor (no host sync), and,
    given `torch`, the host time after synchronizing the card."""

    def __init__(self, torch=None):
        self.scores, self.times, self._torch = [], [], torch

    def iteration_done(self, model, iteration):
        self.scores.append(model._score)
        if self._torch is not None:
            self._torch.cuda.synchronize()
            self.times.append(time.perf_counter())


def first_chunk_grads(torch, net, ds, steps=TRAIN_TBPTT):
    """Gradients of the first `steps` time steps' score (the first TBPTT
    chunk; all of them when None) at the network's current parameters
    (what the first optimizer step applies)."""
    x, y, _, _ = net._batch(ds)
    x, y = x[:, :steps], y[:, :steps]
    params = tuple({k: v.detach().requires_grad_() for k, v in p.items()}
                   for p in net.params)
    with torch.enable_grad():
        score, _ = net._loss_fn(params, net.state, x, y)
        grads = torch.autograd.grad(
            score, [v for p in params for v in p.values()])
    names = [f"{i}/{k}" for i, p in enumerate(params) for k in p]
    return dict(zip(names, (g.detach().cpu() for g in grads)))


def param_rel_l2(net, ref, skip=()):
    """Largest per-tensor |a - b|_2 / |b|_2 between two networks, over the
    parameter keys not in `skip`."""
    worst = 0.0
    for p, q in zip(net.params, ref.params):
        for k in q:
            if k in skip:
                continue
            a, b = p[k].detach().cpu(), q[k].detach().cpu()
            worst = max(worst, ((a - b).norm() / b.norm()).item())
    return worst


def key_bias_max(net):
    """Largest |b_k| over the network's transformer blocks. The key bias's
    gradient is exactly 0 in exact arithmetic (one vector added to every
    key shifts a row's logits by a constant, which the softmax ignores), so
    its Adam updates follow rounding noise and two devices cannot agree on
    it: it is held to what Adam can move it, LM_LR per step."""
    return max(p["b_k"].abs().max().item() for p in net.params
               if "b_k" in p)


def attention_inputs(torch, B, T, S, H, Dh, seed):
    """q [B, T, H, Dh], k/v [B, S, H, Dh], standard normal."""
    r = np.random.default_rng(seed)
    return [torch.as_tensor(r.normal(size=(B, n, H, Dh)).astype(np.float32),
                            device=DEVICE) for n in (T, S, S)]


def bound(nbytes, flops):
    """Least time for the work: bytes over HBM, FLOPs over the f32
    (non-tensor-core) peak. Returns (ms, what bounds it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def lstm_bound_ms(T, B, F, H):
    """One sequence forward: each input read once, each output written
    once; the gate matmul's FLOPs."""
    nbytes = 4 * (T * B * F + (F + H) * 4 * H + 7 * H + 2 * B * H
                  + T * B * H + 2 * B * H)
    return bound(nbytes, 2 * T * B * (F + H) * 4 * H)


def residual_forward_bound_ms(T, B, F, H):
    """The residual-saving forward: inputs read once; hs, h_T, c_T and the
    five residuals written once; the gate matmul's FLOPs."""
    nbytes = 4 * (T * B * F + (F + H) * 4 * H + 7 * H + 2 * B * H
                  + 6 * T * B * H + 2 * B * H)
    return bound(nbytes, 2 * T * B * (F + H) * 4 * H)


def adjoint_bound_ms(T, B, F, H, need_dx):
    """The adjoint: the five residuals, the dhs cotangent, the rows of W it
    multiplies, peep and the carries read once; dx (when needed), dh0 and
    dc0 written once; 2 FLOPs per gate gradient and row of W^T."""
    rows = F + H if need_dx else H
    nbytes = 4 * (6 * T * B * H + rows * 4 * H + 3 * H + 3 * B * H
                  + (T * B * F if need_dx else 0) + 2 * B * H)
    return bound(nbytes, 2 * T * B * 4 * H * rows)


def reduction_bound_ms(T, B, F, H):
    """The reduction: x, hs, h0, cs, c0 and the gate gradients read once;
    dW, db and dpeep written once; the [F+H, T*B] x [T*B, 4H] product."""
    nbytes = 4 * (T * B * F + 2 * T * B * H + 2 * B * H + T * B * 4 * H
                  + (F + H) * 4 * H + 7 * H)
    return bound(nbytes, 2 * T * B * 4 * H * (F + H))


def live_pairs(T, S, causal):
    """(query, key) pairs a mask leaves, per (batch, head)."""
    return sum(min(t + 1, S) for t in range(T)) if causal else T * S


def attention_bound_ms(B, T, S, H, Dh, causal):
    """One launch: q, k, v read once and o written once; 4 Dh FLOPs (the
    two products) per attended (query, key) pair this mask leaves."""
    nbytes = 4 * B * H * Dh * (2 * T + 2 * S)
    return bound(nbytes, 4 * Dh * live_pairs(T, S, causal) * B * H)


def lse_bound_ms(B, T, S, H, Dh, causal):
    """The logsumexp forward: as the primal, plus L [B, H, T] written."""
    nbytes = 4 * B * H * (Dh * (2 * T + 2 * S) + T)
    return bound(nbytes, 4 * Dh * live_pairs(T, S, causal) * B * H)


def dq_bound_ms(B, T, S, H, Dh, causal):
    """dq: q, k, v, o, do and L read once, dq and D written once; 6 Dh
    FLOPs per live pair (s, do v^T, ds k)."""
    nbytes = 4 * B * H * (Dh * (5 * T + 2 * S) + 2 * T)
    return bound(nbytes, 6 * Dh * live_pairs(T, S, causal) * B * H)


def dkv_bound_ms(B, T, S, H, Dh, causal):
    """dk/dv: q, k, v, do, L and D read once, dk and dv written once; 8 Dh
    FLOPs per live pair (s, do v^T, p^T do, ds^T q)."""
    nbytes = 4 * B * H * (Dh * (2 * T + 4 * S) + 2 * T)
    return bound(nbytes, 8 * Dh * live_pairs(T, S, causal) * B * H)


def cuda_ms(torch, fn, reps=20):
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def make_lm(pt, torch, seed, updater=None, dist=None):
    """The transformer LM at nanoGPT shakespeare-char widths, built with
    the builder DSL (the repository has no zoo entry for it), with random
    weights from `seed` (the configuration's default Xavier init, or the
    weight distribution `dist`)."""
    b = pt.NeuralNetConfiguration.builder().seed(seed)
    if updater is not None:
        b = b.updater(updater)
    if dist is not None:
        b = b.dist(dist)
    b = (b.list()
         .layer(pt.EmbeddingSequenceLayer(n_in=LM_VOCAB, n_out=LM_WIDTH)))
    for _ in range(LM_BLOCKS):
        b = b.layer(pt.TransformerBlock(n_heads=LM_HEADS))
    conf = (b.layer(pt.RnnOutputLayer(n_out=LM_VOCAB, activation="softmax",
                                      loss="mcxent"))
            .set_input_type(pt.InputType.recurrent(1, LM_SEQ)).build())
    return pt.MultiLayerNetwork(conf, device=DEVICE).init(
        generator=torch.Generator().manual_seed(seed))


def serve_and_check(pt, name, zips, cpu_nets, make_x, out_tail, rng):
    """Register zips[0] with buckets 1/8/32, POST 1, 5 and 32 rows, run 8
    concurrent clients x 4 requests of 1-4 rows through the batcher, swap
    to zips[1] and POST once more directly. Every reply is checked for
    shape, finite values, rows summing to 1 and agreement with the same zip
    on the CPU. Returns the two versions served, the batcher's flush count,
    the number of batched requests and the largest error seen."""
    def check_output(out, x, ref, what):
        out = np.asarray(out, np.float32)
        check(out.shape == (x.shape[0],) + out_tail,
              f"{name} {what}: output shape {out.shape}")
        check(np.isfinite(out).all(), f"{name} {what}: non-finite output")
        check(np.abs(out.sum(-1) - 1.0).max() <= 1e-4,
              f"{name} {what}: rows do not sum to 1")
        err = float(np.abs(out - ref).max())
        check(err <= SERVE_TOL,
              f"{name} {what}: max abs err {err} vs the CPU run")
        return err

    reg = pt.ModelRegistry(buckets=BUCKETS)
    srv = pt.InferenceServer(registry=reg, port=0).start()
    serve_err, n_batched = 0.0, 0
    try:
        reg.register(name, zips[0])
        v1 = reg.get(name)
        base = f"http://{srv.host}:{srv.port}/v1/models/{name}"
        for rows in (1, 5, 32):
            x = make_x(rng, rows)
            r = http("POST", f"{base}/predict", {"features": x.tolist()})
            check(r["version"] == 1 and r["batched"],
                  f"{name} {rows}-row reply {r.keys()}")
            serve_err = max(serve_err, check_output(
                r["output"], x, cpu_nets[0].output(x).numpy(),
                f"{rows}-row request"))
            n_batched += 1
        failures, replies = [], []

        def client(i):
            crng = np.random.default_rng(100 + i)
            try:
                for j in range(4):
                    x = make_x(crng, 1 + (i + j) % 4)
                    r = http("POST", f"{base}/predict",
                             {"features": x.tolist()})
                    replies.append((x, r))
            except Exception as e:       # reported below, fails the run
                failures.append(repr(e))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        check(not failures, f"{name} concurrent clients failed: {failures}")
        check(len(replies) == 32,
              f"{name}: {len(replies)} of 32 concurrent replies")
        # rows are independent, so one CPU forward checks every reply
        ref = cpu_nets[0].output(np.concatenate([x for x, _ in replies]))
        ref, lo = ref.numpy(), 0
        for x, r in replies:
            check(r["batched"] and r["version"] == 1,
                  f"{name} concurrent reply")
            serve_err = max(serve_err, check_output(
                r["output"], x, ref[lo:lo + len(x)], "concurrent request"))
            lo += len(x)
        n_batched += len(replies)
        flushes = srv._batchers[name].flushes

        info = http("POST", f"{base}/swap", {"source": zips[1]})
        check(info["version"] == 2, f"{name} swap gave version "
              f"{info['version']}")
        v2 = reg.get(name)
        x = make_x(rng, 8)
        r = http("POST", f"{base}/predict", {"features": x.tolist(),
                                             "batched": False})
        check(r["version"] == 2 and not r["batched"],
              f"{name} post-swap reply")
        serve_err = max(serve_err, check_output(
            r["output"], x, cpu_nets[1].output(x).numpy(),
            "post-swap request"))
        old = cpu_nets[0].output(x).numpy()
        check(np.abs(np.asarray(r["output"]) - old).max() > 1e-3,
              f"{name} post-swap output still follows the old weights")
    finally:
        srv.stop()
    check(not any(t.name.startswith("dl4j-torch-serving")
                  for t in threading.enumerate()), "serving threads left")
    return v1, v2, flushes, n_batched, serve_err


def time_serving(pt, name, zip_path, make_x, rng, tag, tokens_per_row):
    """predict p50 and HTTP p50 per bucket, tokens/s at bucket 32."""
    out = {}
    reg = pt.ModelRegistry(buckets=BUCKETS)
    reg.register(name, zip_path)
    srv = pt.InferenceServer(registry=reg, port=0).start()
    try:
        base = f"http://{srv.host}:{srv.port}/v1/models/{name}"
        for b in BUCKETS:
            x = make_x(rng, b)
            fwd, web = [], []
            for _ in range(20):
                t0 = time.perf_counter()
                reg.predict(name, x)
                fwd.append(time.perf_counter() - t0)
            for _ in range(10):
                t0 = time.perf_counter()
                http("POST", f"{base}/predict", {"features": x.tolist(),
                                                 "batched": False})
                web.append(time.perf_counter() - t0)
            out[f"predict_p50_ms_b{b}"] = 1e3 * float(np.median(fwd))
            out[f"http_p50_ms_b{b}"] = 1e3 * float(np.median(web))
            print(f"{tag} {name} bucket {b}: registry.predict p50 "
                  f"{out[f'predict_p50_ms_b{b}']:.3f} ms, HTTP predict "
                  f"p50 {out[f'http_p50_ms_b{b}']:.3f} ms")
    finally:
        srv.stop()
    for path in ("predict", "http"):
        out[f"tokens_per_s_b32_{path}"] = 32 * tokens_per_row / (
            out[f"{path}_p50_ms_b32"] / 1e3)
    print(f"{tag} {name} tokens/s at bucket 32: "
          f"{out['tokens_per_s_b32_predict']:.1f} (registry.predict), "
          f"{out['tokens_per_s_b32_http']:.1f} (HTTP)")
    return out


def profile_device(torch, fn, what, tag, reps=5):
    """Device time of `reps` warm calls of `fn` by kernel (torch.profiler,
    device-side events only: an operator's own row repeats the time of the
    kernels it launched), beside their host wall time. Returns ([(kernel,
    ms per call, launches per call)], device busy ms per call, wall ms per
    call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / reps
    events = [(e.key, e.self_device_time_total / 1e3 / reps, e.count // reps)
              for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    check(events, f"torch.profiler recorded no device time for {what}")
    events.sort(key=lambda e: -e[1])
    busy = sum(ms for _, ms, _ in events)
    print(f"{tag} {what}, device time by kernel (torch.profiler, {reps} "
          f"calls): busy {busy:.3f} ms of {wall:.3f} ms wall (idle share "
          f"{1 - busy / wall:.3f})")
    for key, ms, n in events[:12]:
        print(f"{tag}   {ms:8.3f} ms  {100 * ms / busy:5.1f} %  x{n:<4d} "
              f"{key[:90]}")
    return events, busy, wall


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import deeplearning4j_tpu_torch as pt
    from deeplearning4j_tpu_torch import kernels
    from deeplearning4j_tpu_torch.kernels import attention, lstm
    from deeplearning4j_tpu_torch.nn.weights import Distribution

    def reset_counts():
        lstm.reset_launches()
        attention.reset_launches()

    def check_no_training_launches(path):
        counts = lstm.launch_counts()
        check(counts["residual_launches"] == counts["adjoint_launches"]
              == counts["reduction_launches"] == 0,
              f"the {path} path launched LSTM training kernels: {counts}")
        counts = attention.launch_counts()
        check(counts["lse_launches"] == counts["dq_launches"]
              == counts["dkv_launches"] == 0,
              f"the {path} path launched attention training kernels: "
              f"{counts}")

    # ---- 1. card, versions, build -------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    tag = f"[{card}]"
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    kernels.library()
    print(f"kernel build: {kernels.build_seconds:.3f} s (nvcc, sm_90a)")

    # ---- 2. kernels vs plain on the card --------------------------------
    lstm_err = 0.0
    shapes = [(SEQ, b, f, HIDDEN) for b in BUCKETS for f in (VOCAB, HIDDEN)]
    shapes += [(1, 1, f, HIDDEN) for f in (VOCAB, HIDDEN)]
    for T, B, F, H in shapes:
        args = lstm_inputs(torch, T, B, F, H, seed=T * 1000 + B * 10 + F)
        got = lstm.fused_lstm_sequence(*args, 1.0)
        want = lstm.lstm_sequence_reference(*args, 1.0)
        torch.cuda.synchronize()
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        check(err <= LSTM_TOL, f"LSTM kernel T={T} B={B} F={F} H={H}: "
              f"max abs err {err} > {LSTM_TOL}")
        lstm_err = max(lstm_err, err)
    print(f"LSTM kernel vs plain: {len(shapes)} shapes, max abs err "
          f"{lstm_err:.3e} (limit {LSTM_TOL})")

    # the training kernels: residual forward, adjoint, reduction
    res_err = adj_err = red_err = adj_rel = red_rel = 0.0
    train_shapes = [(TRAIN_TBPTT, TRAIN_B, f, HIDDEN) for f in (VOCAB, HIDDEN)]
    train_shapes += [(1, TRAIN_B, VOCAB, HIDDEN),          # one step
                     (TRAIN_TBPTT, 1, HIDDEN, HIDDEN),     # one row
                     (9, 3, 5, 37)]                        # a column tail
    for T, B, F, H in train_shapes:
        args = lstm_inputs(torch, T, B, F, H, seed=T * 7 + B * 3 + F)
        x, W, b, peep, h0, c0 = args
        got = lstm.lstm_residual_forward(*args, 1.0)
        ref = lstm.lstm_sequence_reference(*args, 1.0, save_residuals=True)
        torch.cuda.synchronize()
        err = max((g - w).abs().max().item() for g, w in zip(
            got, (ref[0], ref[0][-1], ref[1][-1]) + ref[1:]))
        check(err <= LSTM_TOL, f"LSTM residual forward T={T} B={B} F={F} "
              f"H={H}: max abs err {err} > {LSTM_TOL}")
        res_err = max(res_err, err)
        dhs, dhT, dcT = cotangents(torch, T, B, H, seed=F + H + T)
        want = lstm.lstm_sequence_backward_reference(
            x, W, peep, h0, c0, *ref, dhs, dhT, dcT)
        for need_dx in ((False, True) if F == VOCAB else (True,)):
            got = lstm.lstm_sequence_backward(x, W, peep, h0, c0, *ref, dhs,
                                              dhT, dcT, need_dx=need_dx)
            torch.cuda.synchronize()
            check((got[0] is None) == (not need_dx), "dx returned unasked")
            for name, g, w in zip(GRADS, got, want):
                if g is None:
                    continue
                rel = rel_err(g, w)
                check(rel <= BWD_TOL, f"LSTM backward {name} T={T} B={B} "
                      f"F={F} H={H}: max err / max |ref| {rel} > {BWD_TOL}")
                err = (g - w).abs().max().item()
                if name in ("dx", "dh0", "dc0"):
                    adj_err, adj_rel = max(adj_err, err), max(adj_rel, rel)
                else:
                    red_err, red_rel = max(red_err, err), max(red_rel, rel)
    print(f"LSTM training kernels vs plain: {len(train_shapes)} shapes; "
          f"residual forward max abs err {res_err:.3e} (limit {LSTM_TOL}); "
          f"adjoint (dx, dh0, dc0) max abs err {adj_err:.3e}, over max "
          f"|ref| {adj_rel:.3e}; reduction (dW, db, dpeep) max abs err "
          f"{red_err:.3e}, over max |ref| {red_rel:.3e} (limit {BWD_TOL})")

    attn_err = 0.0
    attn_shapes = [(b, LM_SEQ, LM_SEQ, LM_HEADS, LM_WIDTH // LM_HEADS, True)
                   for b in BUCKETS]
    attn_shapes += [(2, 100, 100, LM_HEADS, 64, True),   # ragged causal
                    (3, 37, 129, LM_HEADS, 64, False),   # T != S
                    (2, 256, 256, 4, 32, True), (2, 256, 256, 3, 128, True)]
    for B, T, S, H, Dh, causal in attn_shapes:
        q, k, v = attention_inputs(torch, B, T, S, H, Dh, seed=B + T + S + Dh)
        got = attention.flash_attention_heads(q, k, v, causal)
        want = attention.attention_reference_heads(q, k, v, causal)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(err <= ATTN_TOL, f"attention kernel B={B} T={T} S={S} H={H} "
              f"Dh={Dh} causal={causal}: max abs err {err} > {ATTN_TOL}")
        attn_err = max(attn_err, err)
    print(f"attention kernel vs plain: {len(attn_shapes)} shapes, max abs "
          f"err {attn_err:.3e} (limit {ATTN_TOL})")

    # the attention training kernels: logsumexp forward, dq, dk/dv
    Dh = LM_WIDTH // LM_HEADS
    grad_shapes = [(LM_TRAIN_B, LM_SEQ, LM_SEQ, LM_HEADS, Dh, True),  # fit
                   (1, LM_SEQ, LM_SEQ, LM_HEADS, Dh, True),           # b=1
                   (2, 100, 100, LM_HEADS, Dh, True),      # ragged causal
                   (3, 96, 80, LM_HEADS, Dh, False),       # T != S
                   (2, LM_SEQ, LM_SEQ, LM_HEADS, 16, True),
                   (2, LM_SEQ, LM_SEQ, 3, 128, True)]
    attn_train_err = {name: [0.0, 0.0] for name in ("lse", "dq", "dkv")}
    for B, T, S, H, Dh_, causal in grad_shapes:
        q, k, v = attention_inputs(torch, B, T, S, H, Dh_, seed=T + 3 * S)
        do = attention_inputs(torch, B, T, T, H, Dh_, seed=T + Dh_)[0]
        what = f"B={B} T={T} S={S} H={H} Dh={Dh_} causal={causal}"
        o, lse = attention.flash_attention_fwd_lse_heads(q, k, v, causal)
        want_o, want_lse = attention.attention_reference_heads_lse(
            q, k, v, causal)
        dq, dsum = attention.attention_bwd_dq(q, k, v, want_o, want_lse, do,
                                              causal)
        dk, dv = attention.attention_bwd_dkv(q, k, v, do, want_lse, dsum,
                                             causal)
        want_dq, want_dsum = attention.attention_bwd_dq_reference(
            q, k, v, want_o, want_lse, do, causal)
        want_dk, want_dv = attention.attention_bwd_dkv_reference(
            q, k, v, do, want_lse, want_dsum, causal)
        torch.cuda.synchronize()
        err = (o - want_o).abs().max().item()
        check(err <= ATTN_TOL, f"logsumexp forward {what}: output max abs "
              f"err {err} > {ATTN_TOL}")
        for key, pairs in (("lse", ((lse, want_lse),)),
                           ("dq", ((dsum, want_dsum), (dq, want_dq))),
                           ("dkv", ((dk, want_dk), (dv, want_dv)))):
            for got, want in pairs:
                rel = rel_err(got, want)
                check(rel <= ATTN_GRAD_TOL, f"attention {key} {what}: max "
                      f"err / max |ref| {rel} > {ATTN_GRAD_TOL}")
                e = attn_train_err[key]
                e[0] = max(e[0], (got - want).abs().max().item())
                e[1] = max(e[1], rel)
    print(f"attention training kernels vs plain: {len(grad_shapes)} shapes; "
          + "; ".join(f"{k} max abs err {a:.3e}, over max |ref| {r:.3e}"
                      for k, (a, r) in attn_train_err.items())
          + f" (limit {ATTN_GRAD_TOL} of max |ref|; the logsumexp "
          f"forward's output within {ATTN_TOL} abs)")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    rng = np.random.default_rng(0)

    # ---- 3. main path 1: serve the char-RNN -----------------------------
    rnn_zips = []
    for seed in (1, 2):
        net = pt.char_rnn(vocab_size=VOCAB, lstm_size=HIDDEN, seq_len=SEQ)
        net.init(generator=torch.Generator().manual_seed(seed))
        path = os.path.join(tmp, f"char_rnn_{seed}.zip")
        pt.ModelSerializer.write_model(net, path)
        rnn_zips.append(path)
    rnn_cpu = [pt.ModelSerializer.restore(z, device="cpu") for z in rnn_zips]

    reset_counts()
    v1, v2, flushes, n_batched, serve_err = serve_and_check(
        pt, "char_rnn", rnn_zips, rnn_cpu, one_hot_batch, (SEQ, VOCAB), rng)
    forwards = v1.forwards + v2.forwards
    serve_launches = lstm.launches
    check(serve_launches == 2 * forwards,
          f"LSTM kernel launched {serve_launches} times for {forwards} "
          "forwards (want 2 per forward)")
    print(f"char-RNN serving: {n_batched} batched requests in {flushes} "
          f"flushes + swap; {forwards} forwards, {serve_launches} LSTM "
          f"kernel launches; max abs err vs CPU {serve_err:.3e}")

    # ---- 4. stateful sampling ------------------------------------------
    sampler = pt.ModelSerializer.restore(rnn_zips[0])
    steps = []
    step = sampler.rnn_time_step

    def recording_step(x):
        out = step(x)
        steps.append((np.array(x), out.detach().cpu().numpy()))
        return out

    sampler.rnn_time_step = recording_step
    text = pt.sample_characters(sampler, {c: i for i, c in enumerate(ALPHABET)},
                                "The ", 64, rng_seed=0)
    check(len(text) == 64, f"sampled {len(text)} characters")
    cpu = rnn_cpu[0]
    cpu.rnn_clear_previous_state()
    sample_err = 0.0
    for x, out in steps:
        ref = cpu.rnn_time_step(x).numpy()
        sample_err = max(sample_err, float(np.abs(out - ref).max()))
    check(sample_err <= SERVE_TOL, f"rnn_time_step max abs err {sample_err}")
    sample_launches = lstm.launches - serve_launches
    check(sample_launches == 2 * len(steps),
          f"{sample_launches} launches for {len(steps)} rnn_time_step calls")
    lstm_launches = lstm.launches
    check(attention.launches == 0,
          f"the char-RNN path launched attention {attention.launches} times")
    check_no_training_launches("char-RNN serving")
    print(f"sampling: {len(steps)} rnn_time_step calls, {sample_launches} "
          f"LSTM kernel launches, max abs err vs CPU {sample_err:.3e}, "
          f"text {text!r}")

    # ---- 5. main path 2: serve the transformer LM -----------------------
    lm_zips = []
    for seed in (1, 2):
        path = os.path.join(tmp, f"lm_{seed}.zip")
        pt.ModelSerializer.write_model(make_lm(pt, torch, seed), path)
        lm_zips.append(path)
    lm_cpu = [pt.ModelSerializer.restore(z, device="cpu") for z in lm_zips]
    n_params = sum(t.numel() for p in lm_cpu[0].params for t in p.values())

    reset_counts()
    t0 = time.perf_counter()
    v1, v2, flushes, n_batched, lm_err = serve_and_check(
        pt, "lm", lm_zips, lm_cpu, lm_ids, (LM_SEQ, LM_VOCAB), rng)
    lm_forwards = v1.forwards + v2.forwards
    attn_launches = attention.launches
    check(attn_launches == LM_BLOCKS * lm_forwards,
          f"attention kernel launched {attn_launches} times for "
          f"{lm_forwards} LM forwards (want {LM_BLOCKS} per forward)")
    check(lstm.launches == 0,
          f"the LM path launched the LSTM kernel {lstm.launches} times")
    check_no_training_launches("LM serving")
    print(f"LM serving ({n_params} parameters): {n_batched} batched "
          f"requests in {flushes} flushes + swap; {lm_forwards} forwards, "
          f"{attn_launches} attention kernel launches; max abs err vs CPU "
          f"{lm_err:.3e} (limit {SERVE_TOL}); "
          f"{time.perf_counter() - t0:.1f} s")

    # ---- 6. main path 3: train the char-RNN -----------------------------
    root = os.path.dirname(os.path.abspath(__file__))
    x_text, y_text = readme_batches(root)
    net = pt.char_rnn(vocab_size=VOCAB, lstm_size=HIDDEN, seq_len=TRAIN_T,
                      tbptt=TRAIN_TBPTT)
    net.init(generator=torch.Generator().manual_seed(3))
    train_zip = os.path.join(tmp, "char_rnn_train.zip")
    pt.ModelSerializer.write_model(net, train_zip)
    gpu_net = pt.ModelSerializer.restore(train_zip)
    cpu_net = pt.ModelSerializer.restore(train_zip, device="cpu")
    batches = lambda: pt.ArrayDataSetIterator(x_text, y_text,
                                              batch_size=TRAIN_B,
                                              shuffle=True, seed=11)

    # the first step's gradients (before the counted run)
    first = batches().next()
    g_gpu, g_cpu = (first_chunk_grads(torch, n, first)
                    for n in (gpu_net, cpu_net))
    grad_err = max(rel_err(g_gpu[k], g_cpu[k]) for k in g_cpu)
    check(grad_err <= GRAD_TOL, f"first-step gradients: max err / max |ref| "
          f"{grad_err} > {GRAD_TOL}")

    gpu_log, cpu_log = StepLog(), StepLog()
    gpu_net.set_listeners(gpu_log)
    cpu_net.set_listeners(cpu_log)
    reset_counts()
    t0 = time.perf_counter()
    gpu_net.fit(batches())
    torch.cuda.synchronize()
    gpu_fit_s = time.perf_counter() - t0
    train_counts = lstm.launch_counts()
    steps = gpu_net.iteration_count
    check(steps == 2 * TRAIN_BATCHES, f"{steps} optimizer steps, want "
          f"{2 * TRAIN_BATCHES}")
    check(train_counts == {"launches": 0, "residual_launches": 2 * steps,
                           "adjoint_launches": 2 * steps,
                           "reduction_launches": 2 * steps},
          f"training launches {train_counts} for {steps} steps (want 2 "
          "residual forwards, 2 adjoints, 2 reductions and no primal "
          "forward per step)")
    check(set(attention.launch_counts().values()) == {0},
          f"char-RNN training launched attention kernels: "
          f"{attention.launch_counts()}")
    t0 = time.perf_counter()
    cpu_net.fit(batches())
    cpu_fit_s = time.perf_counter() - t0
    gpu_scores = [float(v) for v in gpu_log.scores]
    cpu_scores = [float(v) for v in cpu_log.scores]
    check(len(gpu_scores) == len(cpu_scores) == steps, "missing step scores")
    check(np.isfinite(gpu_scores).all(), f"non-finite scores {gpu_scores}")
    score_err = float(np.abs(np.subtract(gpu_scores, cpu_scores)).max())
    check(score_err <= SCORE_TOL, f"step scores card vs CPU: max abs err "
          f"{score_err} > {SCORE_TOL}")
    check(gpu_scores[-1] < gpu_scores[0], f"the score did not fall: "
          f"{gpu_scores[0]} -> {gpu_scores[-1]}")
    param_err = param_rel_l2(gpu_net, cpu_net)
    check(param_err <= PARAM_TOL, f"parameters after {steps} steps: "
          f"relative L2 {param_err} > {PARAM_TOL}")
    print(f"char-RNN training: {steps} steps ({TRAIN_BATCHES} batches of "
          f"{TRAIN_B} x {TRAIN_T}, TBPTT {TRAIN_TBPTT}) in {gpu_fit_s:.2f} s "
          f"on the card, {cpu_fit_s:.2f} s on the CPU; launches "
          f"{train_counts}; score {gpu_scores[0]:.4f} -> "
          f"{gpu_scores[-1]:.4f}; card vs CPU: scores max abs err "
          f"{score_err:.3e} (limit {SCORE_TOL}), first-step gradients "
          f"{grad_err:.3e} of max (limit {GRAD_TOL}), final parameters "
          f"relative L2 {param_err:.3e} (limit {PARAM_TOL})")
    print(json.dumps({"train_scores_card": gpu_scores,
                      "train_scores_cpu": cpu_scores}))

    # the zip with its updater state, then one more step on both devices
    resume_zip = os.path.join(tmp, "char_rnn_trained.zip")
    pt.ModelSerializer.write_model(gpu_net, resume_zip)
    resumed = [pt.ModelSerializer.restore(resume_zip, load_updater=True),
               pt.ModelSerializer.restore(resume_zip, load_updater=True,
                                          device="cpu")]
    for u, w in zip(resumed[0].updater_state, gpu_net.updater_state):
        for slot in w:
            for k in w[slot]:
                check(torch.equal(u[slot][k], w[slot][k]),
                      f"restored updater state {slot}/{k} differs")
    extra = pt.DataSet(x_text[:TRAIN_B, :TRAIN_TBPTT],
                       y_text[:TRAIN_B, :TRAIN_TBPTT])
    for n in resumed:
        n.fit(extra)
    check(all(n.iteration_count == steps + 1 for n in resumed),
          "the resumed step did not run once on each device")
    resume_err = abs(resumed[0].score() - resumed[1].score())
    resume_param_err = param_rel_l2(*resumed)
    check(resume_err <= SCORE_TOL and resume_param_err <= PARAM_TOL,
          f"resumed step card vs CPU: score err {resume_err}, parameters "
          f"relative L2 {resume_param_err}")
    print(f"zip with updater state -> restore on card and CPU -> one more "
          f"step: score err {resume_err:.3e}, parameters relative L2 "
          f"{resume_param_err:.3e}")

    # ---- 7. main path 4: train the transformer LM ------------------------
    lm_x, lm_y = lm_text_batches(root)
    lm_zip = os.path.join(tmp, "lm_train.zip")
    # nanoGPT's init (normal, std 0.02): from Xavier at this depth, with no
    # final LayerNorm, the logits start large and Adam at 1e-3 diverges
    pt.ModelSerializer.write_model(
        make_lm(pt, torch, 5, pt.Adam(LM_LR, beta2=0.99),
                Distribution(kind="normal", std=0.02)), lm_zip)
    gpu_lm = pt.ModelSerializer.restore(lm_zip)
    cpu_lm = pt.ModelSerializer.restore(lm_zip, device="cpu")
    lm_batches = lambda n, b: pt.ArrayDataSetIterator(
        lm_x[:n], lm_y[:n], batch_size=b, shuffle=True, seed=11)

    def check_key_bias(nets, steps, what):
        for n in nets:
            kb = key_bias_max(n)
            check(kb <= LM_LR * steps, f"{what}: |b_k| {kb} beyond Adam's "
                  f"reach {LM_LR * steps}")

    # the first step's gradients at batch 64 (before the counted run); the
    # key bias's gradient is 0 up to rounding on both devices
    first = lm_batches(len(lm_x), LM_TRAIN_B).next()
    t0 = time.perf_counter()
    lg_cpu = first_chunk_grads(torch, cpu_lm, first, steps=None)
    cpu_grad_s = time.perf_counter() - t0
    lg_gpu = first_chunk_grads(torch, gpu_lm, first, steps=None)
    lm_grad_err = max(rel_err(lg_gpu[k], lg_cpu[k]) for k in lg_cpu
                      if not k.endswith("/b_k"))
    check(lm_grad_err <= GRAD_TOL, f"LM first-step gradients: max err / max "
          f"|ref| {lm_grad_err} > {GRAD_TOL}")
    bk_grad = max(g[f"{i}/b_k"].abs().max().item()
                  / g[f"{i}/W_k"].abs().max().item()
                  for g in (lg_gpu, lg_cpu) for i in range(1, 1 + LM_BLOCKS))
    check(bk_grad <= GRAD_TOL, f"LM key-bias gradient {bk_grad} of its "
          "W_k's largest entry: not 0 up to rounding")

    lm_log = StepLog()
    gpu_lm.set_listeners(lm_log)
    reset_counts()
    t0 = time.perf_counter()
    gpu_lm.fit(lm_batches(len(lm_x), LM_TRAIN_B))
    torch.cuda.synchronize()
    lm_fit_s = time.perf_counter() - t0
    lm_counts = attention.launch_counts()
    lm_steps = gpu_lm.iteration_count
    check(lm_steps == LM_STEPS, f"{lm_steps} LM optimizer steps, want "
          f"{LM_STEPS}")
    check(lm_counts == {"launches": 0, "lse_launches": LM_BLOCKS * lm_steps,
                        "dq_launches": LM_BLOCKS * lm_steps,
                        "dkv_launches": LM_BLOCKS * lm_steps},
          f"LM training launches {lm_counts} for {lm_steps} steps (want "
          f"{LM_BLOCKS} logsumexp forwards, dq and dk/dv per step and no "
          "primal forward)")
    check(set(lstm.launch_counts().values()) == {0},
          f"LM training launched LSTM kernels: {lstm.launch_counts()}")
    lm_scores = [float(v) for v in lm_log.scores]
    print(f"LM training: {lm_steps} steps of {LM_TRAIN_B} x {LM_SEQ} "
          f"tokens in {lm_fit_s:.2f} s on the card; launches {lm_counts}; "
          f"score {lm_scores[0]:.4f} -> {lm_scores[-1]:.4f}; first-step "
          f"gradients card vs CPU {lm_grad_err:.3e} of max (limit "
          f"{GRAD_TOL}; key bias {bk_grad:.3e} of its W_k's max on either "
          f"device); the CPU took {cpu_grad_s:.2f} s for that batch-"
          f"{LM_TRAIN_B} forward and backward")
    check(np.isfinite(lm_scores).all() and lm_scores[-1] < lm_scores[0],
          f"LM training scores {lm_scores}")
    check_key_bias([gpu_lm], lm_steps, "LM training")

    # card against CPU: 20 steps at batch LM_CMP_B from the same zip
    cmp_nets = [pt.ModelSerializer.restore(lm_zip),
                pt.ModelSerializer.restore(lm_zip, device="cpu")]
    cmp_logs = [StepLog(), StepLog()]
    reset_counts()
    t0 = time.perf_counter()
    for n, log in zip(cmp_nets, cmp_logs):
        n.set_listeners(log)
        n.fit(lm_batches(LM_STEPS * LM_CMP_B, LM_CMP_B))
    cmp_s = time.perf_counter() - t0
    check(attention.launch_counts()["lse_launches"] == LM_BLOCKS * LM_STEPS,
          f"comparison run launches {attention.launch_counts()}")
    cmp_scores = [[float(v) for v in log.scores] for log in cmp_logs]
    check(len(cmp_scores[0]) == len(cmp_scores[1]) == LM_STEPS,
          "missing LM step scores")
    lm_score_err = float(np.abs(np.subtract(*cmp_scores)).max())
    lm_param_err = param_rel_l2(*cmp_nets, skip=("b_k",))
    print(f"LM card vs CPU at batch {LM_CMP_B} ({cmp_s:.1f} s for both): "
          f"score {cmp_scores[0][0]:.4f} -> {cmp_scores[0][-1]:.4f}; scores "
          f"max abs err {lm_score_err:.3e} (limit {LM_SCORE_TOL}); final "
          f"parameters relative L2 {lm_param_err:.3e} (limit {PARAM_TOL}; "
          f"with the key biases {param_rel_l2(*cmp_nets):.3e}); |b_k| at "
          f"most {max(key_bias_max(n) for n in cmp_nets):.3e} (Adam's reach "
          f"{LM_LR * LM_STEPS})")
    print(json.dumps({"lm_train_scores_card": cmp_scores[0],
                      "lm_train_scores_cpu": cmp_scores[1],
                      "lm_train_scores_b64": lm_scores}))
    # the same run with the plain attention on the card: the LM's own
    # float32 sensitivity, which LM_SCORE_TOL answers
    block = pt.TransformerBlock
    kernel_attend = block._attend
    block._attend = lambda self, q, k, v, mask: \
        attention.attention_reference_heads(q, k, v, self.causal)
    try:
        plain = pt.ModelSerializer.restore(lm_zip)
        plain_log = StepLog()
        plain.set_listeners(plain_log)
        plain.fit(lm_batches(LM_STEPS * LM_CMP_B, LM_CMP_B))
    finally:
        block._attend = kernel_attend
    plain_scores = [float(v) for v in plain_log.scores]
    plain_score_err = float(np.abs(np.subtract(plain_scores,
                                               cmp_scores[1])).max())
    plain_param_err = param_rel_l2(plain, cmp_nets[1], skip=("b_k",))
    print(f"plain attention on the card vs CPU, same run: scores max abs err "
          f"{plain_score_err:.3e}, parameters relative L2 "
          f"{plain_param_err:.3e}")
    check(lm_score_err <= LM_SCORE_TOL, f"LM step scores card vs CPU: max "
          f"abs err {lm_score_err} > {LM_SCORE_TOL}")
    check(lm_param_err <= PARAM_TOL, f"LM parameters after {LM_STEPS} "
          f"steps: relative L2 {lm_param_err} > {PARAM_TOL}")
    check(cmp_scores[0][-1] < cmp_scores[0][0], "the LM score did not fall "
          f"at batch {LM_CMP_B}: {cmp_scores[0]}")
    check_key_bias(cmp_nets, LM_STEPS, "LM comparison")

    # the trained zip with its updater state: one more step on both
    # devices, then served against the CPU
    lm_trained = os.path.join(tmp, "lm_trained.zip")
    pt.ModelSerializer.write_model(gpu_lm, lm_trained)
    resumed = [pt.ModelSerializer.restore(lm_trained),
               pt.ModelSerializer.restore(lm_trained, device="cpu")]
    for u, w in zip(resumed[0].updater_state, gpu_lm.updater_state):
        for slot in w:
            for k in w[slot]:
                check(torch.equal(u[slot][k], w[slot][k]),
                      f"restored LM updater state {slot}/{k} differs")
    extra = pt.DataSet(lm_x[:LM_CMP_B], lm_y[:LM_CMP_B])
    for n in resumed:
        n.fit(extra)
    check(all(n.iteration_count == lm_steps + 1 for n in resumed),
          "the resumed LM step did not run once on each device")
    lm_resume_err = abs(resumed[0].score() - resumed[1].score())
    lm_resume_param = param_rel_l2(*resumed, skip=("b_k",))
    check(lm_resume_err <= SCORE_TOL and lm_resume_param <= PARAM_TOL,
          f"resumed LM step card vs CPU: score err {lm_resume_err}, "
          f"parameters relative L2 {lm_resume_param}")
    reset_counts()
    reg = pt.ModelRegistry(buckets=(32,))
    v = reg.register("lm_trained", lm_trained)
    x_held = lm_x[-32:]
    out, _ = reg.predict("lm_trained", x_held)
    ref = pt.ModelSerializer.restore(lm_trained, device="cpu").output(x_held)
    trained_err = float(np.abs(out - ref.numpy()).max())
    check(out.shape == (32, LM_SEQ, LM_VOCAB) and np.isfinite(out).all(),
          f"trained LM served output shape {out.shape}")
    check(trained_err <= SERVE_TOL, f"trained LM served vs CPU: max abs err "
          f"{trained_err} > {SERVE_TOL}")
    check(attention.launches == LM_BLOCKS * v.forwards,
          f"serving the trained LM: {attention.launch_counts()} for "
          f"{v.forwards} forwards")
    check_no_training_launches("trained-LM serving")
    print(f"trained LM zip with updater state -> restore on card and CPU -> "
          f"one more step: score err {lm_resume_err:.3e}, parameters "
          f"relative L2 {lm_resume_param:.3e}; registered and served at "
          f"bucket 32: max abs err vs CPU {trained_err:.3e} (limit "
          f"{SERVE_TOL}), {v.forwards} forwards, {attention.launches} primal "
          "attention launches")

    # ---- 8. times (counted launches end above) --------------------------
    kernel_ms = plain_ms = bound_ms = 0.0
    bound_by = set()
    for F in (VOCAB, HIDDEN):
        args = lstm_inputs(torch, SEQ, 32, F, HIDDEN, seed=F)
        k = cuda_ms(torch, lambda: lstm.fused_lstm_sequence(*args, 1.0))
        p = cuda_ms(torch, lambda: lstm.lstm_sequence_reference(*args, 1.0),
                    reps=5)
        b, by = lstm_bound_ms(SEQ, 32, F, HIDDEN)
        print(f"{tag} LSTM layer B=32 T={SEQ} F={F} H={HIDDEN}: kernel "
              f"{k:.4f} ms, plain {p:.4f} ms, bound {b:.6f} ms ({by})")
        kernel_ms, plain_ms, bound_ms = kernel_ms + k, plain_ms + p, bound_ms + b
        bound_by.add(by)
    # the primal and residual forwards side by side at the serving and the
    # training batch (per-step time of one block depends on both)
    for B in (32, TRAIN_B):
        for F in (VOCAB, HIDDEN):
            args = lstm_inputs(torch, SEQ, B, F, HIDDEN, seed=F)
            kp = cuda_ms(torch, lambda: lstm.fused_lstm_sequence(*args, 1.0))
            kr = cuda_ms(torch, lambda: lstm.lstm_residual_forward(*args,
                                                                   1.0))
            print(f"{tag} LSTM forward B={B} T={SEQ} F={F} H={HIDDEN}: "
                  f"primal {kp:.4f} ms, residual {kr:.4f} ms")

    Dh = LM_WIDTH // LM_HEADS
    q, k, v = attention_inputs(torch, 32, LM_SEQ, LM_SEQ, LM_HEADS, Dh, seed=3)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    a_ms = cuda_ms(torch, lambda: attention.flash_attention_heads(q, k, v,
                                                                  True))
    a_plain = cuda_ms(torch, lambda: attention.attention_reference_heads(
        q, k, v, True))
    a_lib = cuda_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True))
    a_bound, a_by = attention_bound_ms(32, LM_SEQ, LM_SEQ, LM_HEADS, Dh, True)
    print(f"{tag} attention B=32 H={LM_HEADS} T=S={LM_SEQ} Dh={Dh} causal, "
          f"per launch: kernel {a_ms:.4f} ms, plain {a_plain:.4f} ms, "
          f"SDPA {a_lib:.4f} ms, bound {a_bound:.6f} ms ({a_by})")

    serving = {"card": card}
    serving.update(time_serving(pt, "char_rnn", rnn_zips[0], one_hot_batch,
                                rng, tag, SEQ))
    print(json.dumps({"serving": serving}))
    lm_serving = {"card": card}
    lm_serving.update(time_serving(pt, "lm", lm_zips[0], lm_ids, rng, tag,
                                   LM_SEQ))
    reg = pt.ModelRegistry(buckets=(32,))
    reg.register("lm", lm_zips[0])
    x_lm = lm_ids(rng, 32)
    events, busy, wall = profile_device(
        torch, lambda: reg.predict("lm", x_lm), "LM bucket-32 forward", tag)
    attn_dev = sum(ms for key, ms, _ in events if "flash_fwd_kernel" in key)
    lm_serving.update({
        "attention_share_of_predict_b32":
            LM_BLOCKS * a_ms / lm_serving["predict_p50_ms_b32"],
        "profiled_attention_ms_per_forward_b32": attn_dev,
        "profiled_device_busy_ms_per_forward_b32": busy,
        "profiled_wall_ms_per_forward_b32": wall})
    print(f"{tag} LM registry.predict at bucket 32: p50 "
          f"{lm_serving['predict_p50_ms_b32']:.3f} ms, of which "
          f"{LM_BLOCKS} attention launches x {a_ms:.4f} ms = "
          f"{100 * lm_serving['attention_share_of_predict_b32']:.1f} % "
          f"(profiled: {attn_dev:.3f} ms of {busy:.3f} ms device time)")
    print(json.dumps({"lm_serving": lm_serving}))

    # training: step p50 and tokens/s, then one batch's device time
    timed = pt.ModelSerializer.restore(train_zip)
    clock = StepLog(torch)
    timed.set_listeners(clock)
    source = batches()
    timed.fit(source.next())                  # warm-up batch
    clock.times.clear()
    n_timed = TRAIN_BATCHES - 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_timed):
        timed.fit(source.next())
    fit_s = time.perf_counter() - t0
    step_ms = 1e3 * np.diff([t0] + clock.times)
    training = {"card": card, "steps_timed": len(step_ms),
                "step_p50_ms": float(np.median(step_ms)),
                "batch_ms": 1e3 * fit_s / n_timed,
                "tokens_per_s": n_timed * TRAIN_B * TRAIN_T / fit_s}
    print(f"{tag} char-RNN training (B={TRAIN_B}, T={TRAIN_T}, TBPTT "
          f"{TRAIN_TBPTT}): step p50 {training['step_p50_ms']:.3f} ms over "
          f"{len(step_ms)} steps, {training['batch_ms']:.3f} ms per batch, "
          f"{training['tokens_per_s']:.1f} tokens/s")
    batch = pt.DataSet(x_text[:TRAIN_B], y_text[:TRAIN_B])
    events, busy, wall = profile_device(
        torch, lambda: timed.fit(batch), "char-RNN training batch (2 steps)",
        tag, reps=3)
    lstm_dev = sum(ms for key, ms, _ in events if "lstm" in key)
    training.update({"profiled_device_busy_ms_per_batch": busy,
                     "profiled_wall_ms_per_batch": wall,
                     "profiled_idle_share": 1 - busy / wall,
                     "profiled_lstm_kernels_ms_per_batch": lstm_dev})

    # the training kernels per launch, at one TBPTT chunk of both layers
    T, B, H = TRAIN_TBPTT, TRAIN_B, HIDDEN
    train_times = {name: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                          "library_ms": 0.0, "by": set()}
                   for name in ("residual", "adjoint", "reduction")}
    for F in (VOCAB, HIDDEN):
        need_dx = F != VOCAB     # the first layer's one-hot input needs none
        args = lstm_inputs(torch, T, B, F, H, seed=F + 1)
        x, W, b, peep, h0, c0 = args
        hs, _, _, *res = lstm.lstm_residual_forward(*args, 1.0)
        cs = res[0]
        dhs, dhT, dcT = cotangents(torch, T, B, H, seed=F + 2)
        dgates = lstm.lstm_adjoint(W, peep, c0, *res, dhs, dhT, dcT, F,
                                   need_dx)[0]
        zcat_t = torch.cat([x, torch.cat([h0[None], hs[:-1]])], -1).reshape(
            T * B, F + H).T.contiguous()
        dg_2d = dgates.reshape(T * B, 4 * H)
        rows = {
            "residual": (
                lambda: lstm.lstm_residual_forward(*args, 1.0),
                lambda: lstm.lstm_sequence_reference(*args, 1.0,
                                                     save_residuals=True),
                None, residual_forward_bound_ms(T, B, F, H)),
            "adjoint": (
                lambda: lstm.lstm_adjoint(W, peep, c0, *res, dhs, dhT, dcT,
                                          F, need_dx),
                lambda: lstm.lstm_adjoint_reference(W, peep, c0, *res, dhs,
                                                    dhT, dcT, F),
                None, adjoint_bound_ms(T, B, F, H, need_dx)),
            "reduction": (
                lambda: lstm.lstm_param_grads(x, hs, h0, cs, c0, dgates),
                lambda: lstm.lstm_param_grads_reference(x, hs, h0, cs, c0,
                                                        dgates),
                lambda: torch.matmul(zcat_t, dg_2d),
                reduction_bound_ms(T, B, F, H))}
        for name, (kern, plain, lib, (bnd, by)) in rows.items():
            k, p = cuda_ms(torch, kern), cuda_ms(torch, plain, reps=5)
            l = None if lib is None else cuda_ms(torch, lib)
            print(f"{tag} LSTM {name} B={B} T={T} F={F} H={H}"
                  f"{'' if name != 'adjoint' else f' dx={need_dx}'}: kernel "
                  f"{k:.4f} ms, plain {p:.4f} ms, "
                  + ("" if l is None else f"torch.matmul {l:.4f} ms, ")
                  + f"bound {bnd:.6f} ms ({by})")
            e = train_times[name]
            e["ms"] += k
            e["plain_ms"] += p
            e["bound_ms"] += bnd
            e["library_ms"] = None if l is None else e["library_ms"] + l
            e["by"].add(by)
    training["kernel_ms_per_step"] = {n: e["ms"]
                                      for n, e in train_times.items()}
    print(json.dumps({"training": training}))

    # the attention training kernels per launch at the LM's training shape,
    # the primal forward beside the logsumexp one (two instantiations of
    # one template), and SDPA as the yardstick (f32, its own backend)
    B, T, H = LM_TRAIN_B, LM_SEQ, LM_HEADS
    q, k, v = attention_inputs(torch, B, T, T, H, Dh, seed=7)
    do = attention_inputs(torch, B, T, T, H, Dh, seed=8)[0]
    o, lse = attention.flash_attention_fwd_lse_heads(q, k, v, True)
    dsum = attention.attention_bwd_dq(q, k, v, o, lse, do, True)[1]
    qt, kt, vt, dot = (t.transpose(1, 2).contiguous().requires_grad_()
                       for t in (q, k, v, do))
    sdpa_fwd = cuda_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True))
    sdpa_both = cuda_ms(torch, lambda: torch.autograd.grad(
        sdpa(qt, kt, vt, is_causal=True), (qt, kt, vt), dot))
    attn_train = {
        "lse": (lambda: attention.flash_attention_fwd_lse_heads(q, k, v,
                                                                True),
                lambda: attention.attention_reference_heads_lse(q, k, v,
                                                                True),
                sdpa_fwd, lse_bound_ms(B, T, T, H, Dh, True)),
        "dq": (lambda: attention.attention_bwd_dq(q, k, v, o, lse, do, True),
               lambda: attention.attention_bwd_dq_reference(q, k, v, o, lse,
                                                            do, True),
               sdpa_both - sdpa_fwd, dq_bound_ms(B, T, T, H, Dh, True)),
        "dkv": (lambda: attention.attention_bwd_dkv(q, k, v, do, lse, dsum,
                                                    True),
                lambda: attention.attention_bwd_dkv_reference(
                    q, k, v, do, lse, dsum, True),
                sdpa_both - sdpa_fwd, dkv_bound_ms(B, T, T, H, Dh, True))}
    attn_train_times = {}
    for name, (kern, plain, lib, (bnd, by)) in attn_train.items():
        kms, pms = cuda_ms(torch, kern), cuda_ms(torch, plain, reps=5)
        attn_train_times[name] = (kms, pms, lib, bnd, by)
        sdpa_what = ("forward" if name == "lse"
                     else "backward (dq, dk, dv together)")
        print(f"{tag} attention {name} B={B} H={H} T=S={T} Dh={Dh} causal, "
              f"per launch: kernel {kms:.4f} ms, plain {pms:.4f} ms, SDPA "
              f"{sdpa_what} {lib:.4f} ms, bound {bnd:.6f} ms ({by})")
    for Bp in (32, LM_TRAIN_B):
        qp, kp, vp = attention_inputs(torch, Bp, T, T, H, Dh, seed=Bp)
        kp_ms = cuda_ms(torch, lambda: attention.flash_attention_heads(
            qp, kp, vp, True))
        kl_ms = cuda_ms(torch, lambda: attention.flash_attention_fwd_lse_heads(
            qp, kp, vp, True))
        print(f"{tag} attention forward B={Bp} H={H} T=S={T} Dh={Dh}: "
              f"primal {kp_ms:.4f} ms, logsumexp {kl_ms:.4f} ms")

    # LM training: step p50 and tokens/s at batch 64, then one step's
    # device time by kind
    timed_lm = pt.ModelSerializer.restore(lm_zip)
    lm_clock = StepLog(torch)
    timed_lm.set_listeners(lm_clock)
    source = lm_batches(len(lm_x), LM_TRAIN_B)
    timed_lm.fit(source.next())                  # warm-up step
    lm_clock.times.clear()
    n_timed = LM_STEPS - 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_timed):
        timed_lm.fit(source.next())
    lm_fit_s = time.perf_counter() - t0
    step_ms = 1e3 * np.diff([t0] + lm_clock.times)
    lm_training = {"card": card, "steps_timed": len(step_ms),
                   "step_p50_ms": float(np.median(step_ms)),
                   "tokens_per_s": n_timed * LM_TRAIN_B * LM_SEQ / lm_fit_s,
                   "parameters": n_params}
    timed_lm.set_listeners()
    batch = pt.DataSet(lm_x[:LM_TRAIN_B], lm_y[:LM_TRAIN_B])
    events, busy, wall = profile_device(
        torch, lambda: timed_lm.fit(batch), "LM training step (batch 64)",
        tag, reps=3)
    kinds = {"gemm": 0.0, "attention": 0.0, "copies": 0.0, "other": 0.0}
    for key, ms, _ in events:
        low = key.lower()
        kind = ("attention" if "flash_" in low else
                "gemm" if "gemm" in low else
                "copies" if "memcpy" in low or "memset" in low else "other")
        kinds[kind] += ms
    lm_training.update({
        "profiled_wall_ms_per_step": wall,
        "profiled_device_busy_ms_per_step": busy,
        "profiled_idle_share": 1 - busy / wall,
        "profiled_ms_per_step_by_kind": kinds,
        "attention_kernel_ms_per_step": LM_BLOCKS * sum(
            attn_train_times[n][0] for n in ("lse", "dq", "dkv"))})
    print(f"{tag} LM training (B={LM_TRAIN_B}, T={LM_SEQ}, {n_params} "
          f"parameters): step p50 {lm_training['step_p50_ms']:.3f} ms over "
          f"{len(step_ms)} steps, {lm_training['tokens_per_s']:.1f} tokens/s; "
          f"one step's device time: "
          + ", ".join(f"{k} {ms:.3f} ms" for k, ms in kinds.items())
          + f" of {wall:.3f} ms wall (idle share {1 - busy / wall:.3f})")
    print(json.dumps({"lm_training": lm_training}))

    print(json.dumps({"kernels": [{
        "name": "fused_lstm_sequence",
        "route": "cuda",
        "source": "deeplearning4j_tpu_torch/kernels/csrc/lstm.cu",
        "replaces": "deeplearning4j_tpu/kernels/lstm.py:57 (_fwd_kernel via "
                    "_fwd_impl :121, fused_lstm_sequence :252)",
        "launches": lstm_launches,
        "max_abs_err": lstm_err,
        "per": "char-RNN forward at bucket 32 (2 launches: F=77 and "
               "F=200, H=200, T=64)",
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if bound_by == {"operations"} else "bytes",
        "library_ms": None,
        "card": card,
    }, {
        "name": "flash_attention_heads",
        "route": "cuda",
        "source": "deeplearning4j_tpu_torch/kernels/csrc/attention.cu",
        "replaces": "deeplearning4j_tpu/kernels/attention.py:81 (_make_kernel "
                    "via _flash_fwd_impl :168, primal mode)",
        "launches": attn_launches,
        "max_abs_err": attn_err,
        "per": f"one launch (one block's attention) at B=32, H={LM_HEADS}, "
               f"T=S={LM_SEQ}, Dh={Dh}, causal",
        "ms": a_ms,
        "plain_ms": a_plain,
        "bound_ms": a_bound,
        "bound_by": a_by,
        "library_ms": a_lib,
        "card": card,
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "deeplearning4j_tpu_torch/kernels/csrc/lstm.cu",
        "replaces": replaces,
        "launches": train_counts[counter],
        "max_abs_err": err,
        "max_err_over_max_ref": rel,
        "per": f"one TBPTT step (2 launches: F={VOCAB} and F={HIDDEN}, "
               f"H={HIDDEN}, B={TRAIN_B}, T={TRAIN_TBPTT})",
        "ms": train_times[key]["ms"],
        "plain_ms": train_times[key]["plain_ms"],
        "bound_ms": train_times[key]["bound_ms"],
        "bound_by": ("operations" if train_times[key]["by"] == {"operations"}
                     else "bytes"),
        "library_ms": train_times[key]["library_ms"],
        "library": library,
        "card": card,
    } for name, key, counter, err, rel, replaces, library in (
        ("lstm_residual_forward", "residual", "residual_launches", res_err,
         None,
         "deeplearning4j_tpu/kernels/lstm.py:57 (_fwd_kernel via _fwd_impl "
         ":121, save_residuals=True, for _vjp_fwd :265)",
         "none: cuDNN's LSTM behind torch.nn.LSTM has no peepholes and no "
         "forget offset"),
        ("lstm_adjoint", "adjoint", "adjoint_launches", adj_err, adj_rel,
         "deeplearning4j_tpu/kernels/lstm.py:137 (_bwd_kernel's per-step "
         "chain via _bwd_impl :219, for _vjp_bwd :273)",
         "none: cuDNN's LSTM behind torch.nn.LSTM has no peepholes and no "
         "forget offset"),
        ("lstm_param_grads", "reduction", "reduction_launches", red_err,
         red_rel,
         "deeplearning4j_tpu/kernels/lstm.py:137 (_bwd_kernel's dW, db and "
         "dpeep accumulation :179-186 via _bwd_impl :219)",
         "torch.matmul of the [F+H, T*B] x [T*B, 4H] product (dW only)"))]
        + [{
            "name": name,
            "route": "cuda",
            "source": "deeplearning4j_tpu_torch/kernels/csrc/attention.cu",
            "replaces": replaces,
            "launches": lm_counts[counter],
            "max_abs_err": attn_train_err[key][0],
            "max_err_over_max_ref": attn_train_err[key][1],
            "per": f"one launch (one block's attention) at B={LM_TRAIN_B}, "
                   f"H={LM_HEADS}, T=S={LM_SEQ}, Dh={Dh}, causal; "
                   f"{LM_BLOCKS} per LM training step",
            "ms": attn_train_times[key][0],
            "plain_ms": attn_train_times[key][1],
            "bound_ms": attn_train_times[key][3],
            "bound_by": attn_train_times[key][4],
            "library_ms": attn_train_times[key][2],
            "library": library,
            "card": card,
        } for name, key, counter, replaces, library in (
            ("flash_attention_fwd_lse_heads", "lse", "lse_launches",
             "deeplearning4j_tpu/kernels/attention.py:81 (_make_kernel via "
             "_flash_fwd_impl :168, emit_lse=True, for _flash_fwd :350)",
             "scaled_dot_product_attention forward (f32, is_causal, inputs "
             "requiring grad)"),
            ("attention_bwd_dq", "dq", "dq_launches",
             "deeplearning4j_tpu/kernels/attention.py:206 (_make_dq_kernel "
             "via _flash_bwd_impl :312)",
             "scaled_dot_product_attention backward (f32, is_causal): dq, dk "
             "and dv together, the same time on both backward entries"),
            ("attention_bwd_dkv", "dkv", "dkv_launches",
             "deeplearning4j_tpu/kernels/attention.py:244 (_make_dkv_kernel "
             "via _flash_bwd_impl :329)",
             "scaled_dot_product_attention backward (f32, is_causal): dq, dk "
             "and dv together, the same time on both backward entries"))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
