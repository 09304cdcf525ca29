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
     tail for the LSTM training kernels; N in {128, 4096, 4097} x C in
     {1024, 200, 48} x bf16 / f16 / f32 and an NHWC input for the BN+ReLU
     forward and backward);
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
  8. main path 5: train the repository's `mlp_mnist` (784 -> 1024 -> 1024
     -> 10, Adam 1e-3) with a BatchNormalization(relu) after each hidden
     Dense(identity) layer, in bf16 compute (`compute_dtype("bfloat16")`,
     float32 masters), built from one JSON, for 20 optimizer steps with
     `fit` over an ArrayDataSetIterator of the 320 bundled MNIST training
     digits (batch 128, shuffled, drop_last: two batches an epoch, ten
     epochs) from a zip of seeded random weights; the same zip and batches
     on the CPU; per-step scores, first-step gradients, final parameters
     and running statistics compared; `evaluate` on the 64 held-out
     digits; the zip with updater and layer state restored on both devices
     for one more step; then the same network in float32 (no
     compute_dtype), which must launch no BN kernel, against the CPU;
  9. times: each kernel, its plain version, the PyTorch library call where
     there is one, and its bound; predict and HTTP p50 per bucket and
     tokens/s at bucket 32 for both models; training tokens/s and step
     p50 for both models and samples/s for the BN-MLP; where the LM's
     bucket-32 forward, a char-RNN training batch, an LM training step and
     a BN-MLP step spend their device time (torch.profiler).

Each kernel counts its launches. Every count is set to 0 before each main
path and read after it: two primal LSTM launches per char-RNN forward
(phases 3-4), six primal attention launches per LM forward (phase 5), two
residual-forward, two adjoint and two reduction launches per char-RNN
training step (phase 6), and six logsumexp-forward, six dq and six dk/dv
launches per LM training step (phase 7), and one BN+ReLU forward and one
backward launch per BN layer and bf16 training step (phase 8: 40 and 40
over 20 steps, none in evaluation or in float32), each path launching none
of the others' kernels. The last two lines are a `{"kernels": [...]}` object and
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

# BN-MLP (deeplearning4j_tpu/models/zoo.py:mlp_mnist with a
# BatchNormalization(relu) after each hidden Dense(identity) layer), trained
# in bf16 on the bundled MNIST digits (deeplearning4j_tpu_torch/resources/
# mnist_subset.npz: 320 train, 64 held out)
MLP_WIDTH, MLP_B, MLP_EPOCHS, MLP_LR = 1024, 128, 10, 1e-3
MLP_STEPS = 2 * MLP_EPOCHS          # 320 digits, batch 128, drop_last
BN_SHAPES = [(n, c) for n in (MLP_B, 4096, 4097) for c in (1024, 200, 48)]
# The BN+ReLU kernels against their plain versions: statistics, dgamma and
# dbeta are float32 sums of up to 4097 terms in another order (1e-5 of the
# largest plain magnitude); y and dx are compared in float32 after both are
# rounded to x's dtype, within that plus one ulp of the dtype (8 or 11
# significant bits) for a value on a rounding boundary.
BN_TOL = 1e-5
BN_ULP = {"float32": 0.0, "bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}
# bf16 compute, card against CPU: both sides round every product and sum of
# the hidden layers to bf16 (8 significant bits), but the card's bf16 GEMMs
# accumulate in another order than the CPU's, so about 1 in 100-500 values
# lands one ulp (up to 2^-8 relative) apart, and the gap compounds over 20
# Adam steps. Gradients per tensor relative to its largest entry; scores
# absolute (the score starts near ln 10 = 2.3); parameters relative L2 per
# tensor, against the larger of the tensor's norm and Adam's reach over the
# run (tensors that start at 0: beta, the output bias); running statistics
# relative L2 per tensor too, since they are functions of those parameters:
# at lr 1e-3 an Adam step moves a weight by up to a third of its Xavier
# scale, so entries whose gradient is within rounding of 0 step either way,
# and the parameters end 1.35e-2 apart, the running statistics 1.56e-2 (the
# port against the JAX package on the CPU, the same run:
# tests/test_torch_mlp_bn_training.py, run as a script, prints them).
BF16_GRAD_TOL = 2e-2
BF16_SCORE_TOL = 2e-2
BF16_PARAM_TOL = 5e-2


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


def bn_args(torch, N, C, dtype, seed):
    """x [N, C] with per-channel means, gamma near 1, beta near 0, dy
    standard normal; x and dy in `dtype`."""
    r = np.random.default_rng(seed)
    x = r.normal(size=(N, C)) * 1.5 + r.normal(size=C)
    arrays = (x, 1 + 0.2 * r.normal(size=C), 0.3 * r.normal(size=C),
              r.normal(size=(N, C)))
    x, g, b, dy = (torch.as_tensor(a.astype(np.float32), device=DEVICE)
                   for a in arrays)
    dt = getattr(torch, dtype)
    return x.to(dt), g, b, dy.to(dt)


def bn_err(got, want, dtype):
    """(within the limit, max abs err, max err / max |want|): the limit is
    BN_TOL of max |want| plus one ulp of `dtype` of each element."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    limit = (BN_ULP[dtype] * got.abs().maximum(want.abs())
             + BN_TOL * want.abs().max())
    return (bool((err <= limit).all()), err.max().item(),
            (err.max() / want.abs().max().clamp_min(1e-30)).item())


def bn_fwd_bound_ms(N, C, itemsize):
    """The forward: x read once, y written once (the [C] vectors are
    noise); a few FLOPs per element, far under the tensor-free f32 rate."""
    return bound(2 * N * C * itemsize + 4 * 4 * C, 10 * N * C)


def bn_bwd_bound_ms(N, C, itemsize):
    """The backward: x and dy read once, dx written once."""
    return bound(3 * N * C * itemsize + 6 * 4 * C, 16 * N * C)


def bn_mlp_json(pt):
    """The BN-MLP's configuration JSON: mlp_mnist's widths, seed and Adam
    with each hidden Dense(relu) split into Dense(identity) +
    BatchNormalization(relu), in bf16 compute."""
    return (pt.NeuralNetConfiguration.builder().seed(42)
            .updater(pt.Adam(MLP_LR)).compute_dtype("bfloat16").list()
            .layer(pt.DenseLayer(n_out=MLP_WIDTH, activation="identity"))
            .layer(pt.BatchNormalization(activation="relu"))
            .layer(pt.DenseLayer(n_out=MLP_WIDTH, activation="identity"))
            .layer(pt.BatchNormalization(activation="relu"))
            .layer(pt.OutputLayer(n_out=10, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(pt.InputType.feed_forward(784)).build().to_json())


class BiasLog(StepLog):
    """StepLog that also keeps, before each step, the biases of the Dense
    layers feeding a BN layer (`pre_bn`): their gradient is 0 in exact
    arithmetic, so Adam moves them by rounding noise, and a running mean
    carries them."""

    def __init__(self, net, pre_bn):
        super().__init__()
        self.net, self.pre_bn = net, pre_bn
        self.biases = [self._biases()]

    def _biases(self):
        return [self.net.params[i]["b"].detach().cpu().clone()
                for i in self.pre_bn]

    def iteration_done(self, model, iteration):
        super().iteration_done(model, iteration)
        self.biases.append(self._biases())

    def running_mean_without_bias(self, state, pos, bn, decay):
        """The BN layer's running mean less the share of it that is the
        pre-BN bias: sum_t (1 - d) d^(T-1-t) b_t over the T steps (the
        running mean starts at 0)."""
        steps = len(self.scores)
        part = sum((1 - decay) * decay ** (steps - 1 - t)
                   * self.biases[t][pos] for t in range(steps))
        return state[bn]["mean"].detach().cpu() - part


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


def device_ms(torch, fn, reps=20):
    """Device time per call of `fn`: every device-side kernel and copy it
    ran, summed (torch.profiler), apart from the host's launch path. Where
    a call does microseconds of device work, `cuda_ms` of back-to-back
    calls measures how fast the host issues them instead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA)
    check(total > 0, "torch.profiler recorded no device time")
    return total / 1e3 / reps


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
    from deeplearning4j_tpu_torch.kernels import attention, bn_relu, lstm
    from deeplearning4j_tpu_torch.nn.weights import Distribution

    def reset_counts():
        lstm.reset_launches()
        attention.reset_launches()
        bn_relu.reset_launches()

    def check_no_bn_launches(path):
        check(set(bn_relu.launch_counts().values()) == {0},
              f"the {path} path launched BN+ReLU kernels: "
              f"{bn_relu.launch_counts()}")

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
        check_no_bn_launches(path)

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

    # the BN+ReLU forward and backward
    bn_max = {"fwd": [0.0, 0.0], "bwd": [0.0, 0.0]}
    bn_cases = [(N, C, dt, False) for N, C in BN_SHAPES
                for dt in ("bfloat16", "float16", "float32")]
    bn_cases.append((2 * 14 * 14, 64, "bfloat16", True))      # NHWC
    for N, C, dt, nhwc in bn_cases:
        x, g, b, dy = bn_args(torch, N, C, dt, seed=N + C)
        what = f"N={N} C={C} {dt}{' NHWC' if nhwc else ''}"
        if nhwc:        # [2, 14, 14, C] through the layer's entry point
            y, mean, var = bn_relu.fused_bn_relu(x.reshape(2, 14, 14, C), g,
                                                 b)
            y = y.reshape(N, C)
        else:
            y, mean, var = bn_relu.bn_relu_forward(x, g, b)
        dx, dg, db = bn_relu.bn_relu_backward(x, g, b, mean, var, dy)
        want_y, want_m, want_v = bn_relu.bn_relu_reference(x, g, b)
        want_dx, want_dg, want_db = bn_relu.bn_relu_backward_reference(
            x, g, b, mean, var, dy)
        torch.cuda.synchronize()
        for key, pairs in (("fwd", ((y, want_y, dt), (mean, want_m, "float32"),
                                    (var, want_v, "float32"))),
                           ("bwd", ((dx, want_dx, dt), (dg, want_dg, "float32"),
                                    (db, want_db, "float32")))):
            for got, want, kind in pairs:
                ok, err, rel = bn_err(got, want, kind)
                check(ok and got.dtype == want.dtype,
                      f"BN+ReLU {key} {what}: max abs err {err}, over max "
                      f"|ref| {rel} ({got.dtype} vs {want.dtype})")
                m = bn_max[key]
                m[0], m[1] = max(m[0], err), max(m[1], rel)
    print(f"BN+ReLU kernels vs plain: {len(bn_cases)} cases; "
          + "; ".join(f"{k} max abs err {a:.3e}, over max |ref| {r:.3e}"
                      for k, (a, r) in bn_max.items())
          + f" (limit {BN_TOL} of max |ref| plus one ulp of x's dtype)")

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
    check_no_bn_launches("char-RNN training")
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
    check_no_bn_launches("LM training")
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

    # ---- 8. main path 5: train the BN-MLP in bf16 -----------------------
    x_tr, y_tr, x_te, y_te = pt.bundled_mnist_subset()
    mlp_json = bn_mlp_json(pt)
    mlp_zip = os.path.join(tmp, "bn_mlp.zip")
    pt.ModelSerializer.write_model(pt.MultiLayerNetwork(
        pt.MultiLayerConfiguration.from_json(mlp_json), device=DEVICE).init(
        generator=torch.Generator().manual_seed(7)), mlp_zip)
    mlp_gpu = pt.ModelSerializer.restore(mlp_zip)
    mlp_cpu = pt.ModelSerializer.restore(mlp_zip, device="cpu")
    check(mlp_gpu._compute_dtype == torch.bfloat16, "the BN-MLP zip lost "
          "compute_dtype")
    pre_bn = [0, 2]                 # the Dense layers feeding BN layers
    mlp_batches = lambda x, y: pt.ArrayDataSetIterator(
        x, y, batch_size=MLP_B, shuffle=True, seed=13, drop_last=True)

    def pre_bn_grad_ratio(grads):
        """The largest pre-BN bias gradient (0 in exact arithmetic) over its
        W's largest gradient entry."""
        return max(grads[f"{i}/b"].abs().max().item()
                   / grads[f"{i}/W"].abs().max().item() for i in pre_bn)

    def mlp_param_err(net, ref, steps):
        """Largest per-tensor |a - b|_2 / max(|b|_2, Adam's reach over
        `steps` in L2), the pre-BN biases apart; and their largest |b|."""
        worst, bias = 0.0, 0.0
        for i, (p, q) in enumerate(zip(net.params, ref.params)):
            for k in q:
                a, b = p[k].detach().cpu(), q[k].detach().cpu()
                if i in pre_bn and k == "b":
                    bias = max(bias, a.abs().max().item(),
                               b.abs().max().item())
                    continue
                scale = max(b.norm().item(),
                            MLP_LR * steps * b.numel() ** 0.5)
                worst = max(worst, (a - b).norm().item() / scale)
        return worst, bias

    def mlp_state_err(logs, nets):
        """Largest relative L2 error of the running means (less their
        pre-BN bias share) and vars, per tensor."""
        worst = 0.0
        for pos, i in enumerate((1, 3)):
            d = nets[0].layers[i].decay
            m = [log.running_mean_without_bias(n.state, pos, i, d)
                 for log, n in zip(logs, nets)]
            v = [n.state[i]["var"].detach().cpu() for n in nets]
            for a, b in (m, v):
                worst = max(worst, ((a - b).norm() / b.norm()).item())
        return worst

    first = mlp_batches(x_tr, y_tr).next()
    mg_gpu, mg_cpu = (first_chunk_grads(torch, n, first, steps=None)
                      for n in (mlp_gpu, mlp_cpu))
    mlp_grad_err = max(rel_err(mg_gpu[k], mg_cpu[k]) for k in mg_cpu
                       if k not in ("0/b", "2/b"))
    mlp_bias_grad = max(pre_bn_grad_ratio(g) for g in (mg_gpu, mg_cpu))
    check(mlp_grad_err <= BF16_GRAD_TOL, f"BN-MLP first-step gradients: max "
          f"err / max |ref| {mlp_grad_err} > {BF16_GRAD_TOL}")
    check(mlp_bias_grad <= BF16_GRAD_TOL, f"BN-MLP pre-BN bias gradient "
          f"{mlp_bias_grad} of its W's largest: not 0 up to rounding")

    mlp_logs = [BiasLog(n, pre_bn) for n in (mlp_gpu, mlp_cpu)]
    for n, log in zip((mlp_gpu, mlp_cpu), mlp_logs):
        n.set_listeners(log)
    reset_counts()
    t0 = time.perf_counter()
    mlp_gpu.fit(mlp_batches(x_tr, y_tr), epochs=MLP_EPOCHS)
    torch.cuda.synchronize()
    mlp_fit_s = time.perf_counter() - t0
    bn_counts = bn_relu.launch_counts()
    mlp_steps = mlp_gpu.iteration_count
    check(mlp_steps == MLP_STEPS, f"{mlp_steps} BN-MLP steps, want "
          f"{MLP_STEPS}")
    check(bn_counts == {"fwd_launches": 2 * mlp_steps,
                        "bwd_launches": 2 * mlp_steps},
          f"BN-MLP training launches {bn_counts} for {mlp_steps} steps "
          "(want 2 forward and 2 backward BN launches per step)")
    check(set(lstm.launch_counts().values()) == {0}
          and set(attention.launch_counts().values()) == {0},
          f"BN-MLP training launched LSTM or attention kernels: "
          f"{lstm.launch_counts()} {attention.launch_counts()}")
    t0 = time.perf_counter()
    mlp_cpu.fit(mlp_batches(x_tr, y_tr), epochs=MLP_EPOCHS)
    mlp_cpu_s = time.perf_counter() - t0
    mlp_scores = [[float(v) for v in log.scores] for log in mlp_logs]
    check(len(mlp_scores[0]) == len(mlp_scores[1]) == mlp_steps,
          "missing BN-MLP step scores")
    check(np.isfinite(mlp_scores[0]).all()
          and mlp_scores[0][-1] < mlp_scores[0][0],
          f"BN-MLP scores {mlp_scores[0]}")
    mlp_score_err = float(np.abs(np.subtract(*mlp_scores)).max())
    mlp_param, mlp_bias = mlp_param_err(mlp_gpu, mlp_cpu, mlp_steps)
    mlp_state = mlp_state_err(mlp_logs, (mlp_gpu, mlp_cpu))
    for n in (mlp_gpu, mlp_cpu):
        check(all(t.dtype == torch.float32 and not t.requires_grad
                  for tree in (n.params, n.state) for d in tree
                  for t in d.values()),
              "BN-MLP masters or layer state not float32 and detached")
    print(f"BN-MLP training (bf16 compute): {mlp_steps} steps of {MLP_B} "
          f"digits in {mlp_fit_s:.2f} s on the card, {mlp_cpu_s:.2f} s on "
          f"the CPU; launches {bn_counts}; score {mlp_scores[0][0]:.4f} -> "
          f"{mlp_scores[0][-1]:.4f}; card vs CPU: scores max abs err "
          f"{mlp_score_err:.3e} (limit {BF16_SCORE_TOL}), first-step "
          f"gradients {mlp_grad_err:.3e} of max (limit {BF16_GRAD_TOL}; "
          f"pre-BN biases {mlp_bias_grad:.3e} of their W's max), final "
          f"parameters {mlp_param:.3e} (limit {BF16_PARAM_TOL}), running "
          f"stats {mlp_state:.3e} (limit {BF16_PARAM_TOL}); pre-BN "
          f"biases at most {mlp_bias:.3e} (Adam's reach "
          f"{MLP_LR * mlp_steps})")
    print(json.dumps({"bn_mlp_scores_card": mlp_scores[0],
                      "bn_mlp_scores_cpu": mlp_scores[1]}))
    check(mlp_score_err <= BF16_SCORE_TOL, f"BN-MLP scores card vs CPU: "
          f"max abs err {mlp_score_err} > {BF16_SCORE_TOL}")
    check(mlp_param <= BF16_PARAM_TOL, f"BN-MLP parameters after "
          f"{mlp_steps} steps: {mlp_param} > {BF16_PARAM_TOL}")
    check(mlp_state <= BF16_PARAM_TOL, f"BN-MLP running stats: {mlp_state} "
          f"> {BF16_PARAM_TOL}")
    check(mlp_bias <= MLP_LR * mlp_steps + 1e-6, f"pre-BN biases "
          f"{mlp_bias} beyond Adam's reach")

    # evaluate on the held-out digits: inference takes the plain folded
    # path, no BN launch
    reset_counts()
    evs = [n.evaluate(pt.ArrayDataSetIterator(x_te, y_te, batch_size=64))
           for n in (mlp_gpu, mlp_cpu)]
    out = mlp_gpu.output(x_te)
    torch.cuda.synchronize()
    check_no_bn_launches("BN-MLP evaluate / output")
    out_err = (out.cpu() - mlp_cpu.output(x_te)).abs().max().item()
    check(out.shape == (len(x_te), 10) and torch.isfinite(out).all().item(),
          f"BN-MLP output {tuple(out.shape)}")
    check(out_err <= BF16_SCORE_TOL, f"BN-MLP held-out output card vs CPU "
          f"{out_err}")
    print(f"BN-MLP evaluate on {len(x_te)} held-out digits: accuracy "
          f"{evs[0].accuracy():.4f} on the card, {evs[1].accuracy():.4f} on "
          f"the CPU; outputs max abs err {out_err:.3e}; no BN launch")

    # the zip with updater and layer state, then one more step on both
    mlp_trained = os.path.join(tmp, "bn_mlp_trained.zip")
    pt.ModelSerializer.write_model(mlp_gpu, mlp_trained)
    resumed = [pt.ModelSerializer.restore(mlp_trained),
               pt.ModelSerializer.restore(mlp_trained, device="cpu")]
    for tree, ref in ((resumed[0].state, mlp_gpu.state),
                      (resumed[0].updater_state, mlp_gpu.updater_state)):
        for u, w in zip(tree, ref):
            for k in w:
                same = (all(torch.equal(u[k][j], w[k][j]) for j in w[k])
                        if isinstance(w[k], dict)
                        else torch.equal(u[k], w[k]))
                check(same, f"restored BN-MLP state {k} differs")
    extra = pt.DataSet(x_tr[:MLP_B], y_tr[:MLP_B])
    for n in resumed:
        n.fit(extra)
    mlp_resume_err = abs(resumed[0].score() - resumed[1].score())
    mlp_resume_param = mlp_param_err(*resumed, 1)[0]
    check(mlp_resume_err <= BF16_SCORE_TOL
          and mlp_resume_param <= BF16_PARAM_TOL,
          f"resumed BN-MLP step card vs CPU: score err {mlp_resume_err}, "
          f"parameters {mlp_resume_param}")
    print(f"BN-MLP zip with updater and layer state -> restore on card and "
          f"CPU -> one more step: score err {mlp_resume_err:.3e}, "
          f"parameters {mlp_resume_param:.3e}")

    # the same network in float32: the exact BN path, no kernel
    f32_conf = json.loads(mlp_json)
    f32_conf["conf"]["compute_dtype"] = None
    f32_zip = os.path.join(tmp, "bn_mlp_f32.zip")
    pt.ModelSerializer.write_model(pt.MultiLayerNetwork(
        pt.MultiLayerConfiguration.from_json(json.dumps(f32_conf)),
        device=DEVICE).init(generator=torch.Generator().manual_seed(7)),
        f32_zip)
    f32_nets = [pt.ModelSerializer.restore(f32_zip),
                pt.ModelSerializer.restore(f32_zip, device="cpu")]
    f32_logs = [BiasLog(n, pre_bn) for n in f32_nets]
    reset_counts()
    for n, log in zip(f32_nets, f32_logs):
        n.set_listeners(log)
        n.fit(mlp_batches(x_tr, y_tr), epochs=MLP_EPOCHS)
    torch.cuda.synchronize()
    check_no_bn_launches("float32 BN-MLP training")
    f32_scores = [[float(v) for v in log.scores] for log in f32_logs]
    f32_score_err = float(np.abs(np.subtract(*f32_scores)).max())
    f32_param, f32_bias = mlp_param_err(*f32_nets, MLP_STEPS)
    f32_state = mlp_state_err(f32_logs, f32_nets)
    print(f"BN-MLP in float32: {MLP_STEPS} steps, no BN launch; score "
          f"{f32_scores[0][0]:.4f} -> {f32_scores[0][-1]:.4f}; card vs CPU: "
          f"scores {f32_score_err:.3e} (limit {SCORE_TOL}), parameters "
          f"{f32_param:.3e} (limit {PARAM_TOL}), running stats "
          f"{f32_state:.3e} (limit {PARAM_TOL}); pre-BN biases at "
          f"most {f32_bias:.3e}")
    check(f32_score_err <= SCORE_TOL and f32_param <= PARAM_TOL
          and f32_state <= PARAM_TOL and f32_bias <= MLP_LR * MLP_STEPS + 1e-6,
          "float32 BN-MLP card vs CPU beyond the float32 limits")

    # ---- 9. times (counted launches end above) --------------------------
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

    # the BN+ReLU kernels per launch at the BN-MLP's shape (N = MLP_B) and
    # at N = 4096, C = 1024, bf16, beside their plain versions and the
    # library call (F.batch_norm in training mode + relu, bf16 input with
    # float32 weight and bias; its backward through autograd, the forward's
    # time subtracted), timed here as the yardstick only; each both per
    # call (CUDA events around back-to-back calls, as every other row) and
    # in device time (torch.profiler), since at N = 128 a call is
    # microseconds of device work behind tens of host microseconds
    fn = torch.nn.functional
    bn_times = {}
    for N in (MLP_B, 4096):
        x, g, b, dy = bn_args(torch, N, MLP_WIDTH, "bfloat16", seed=N)
        _, mean, var = bn_relu.bn_relu_forward(x, g, b)
        xl, gl, bl = (t.clone().requires_grad_() for t in (x, g, b))
        lib_fwd = lambda: fn.relu(fn.batch_norm(xl, None, None, gl, bl,
                                                training=True))
        lib_grad = lambda: torch.autograd.grad(lib_fwd(), (xl, gl, bl), dy)
        lib_f, lib_both = cuda_ms(torch, lib_fwd), cuda_ms(torch, lib_grad)
        lib_dev_f = device_ms(torch, lib_fwd)
        lib_dev = {"fwd": lib_dev_f,
                   "bwd": device_ms(torch, lib_grad) - lib_dev_f}
        rows = {
            "fwd": (lambda: bn_relu.bn_relu_forward(x, g, b),
                    lambda: bn_relu.bn_relu_reference(x, g, b), lib_f,
                    bn_fwd_bound_ms(N, MLP_WIDTH, 2)),
            "bwd": (lambda: bn_relu.bn_relu_backward(x, g, b, mean, var, dy),
                    lambda: bn_relu.bn_relu_backward_reference(
                        x, g, b, mean, var, dy),
                    lib_both - lib_f, bn_bwd_bound_ms(N, MLP_WIDTH, 2))}
        for name, (kern, plain, lib, (bnd, by)) in rows.items():
            kms, pms = cuda_ms(torch, kern), cuda_ms(torch, plain)
            dev = (device_ms(torch, kern), device_ms(torch, plain),
                   lib_dev[name])
            bn_times[(name, N)] = (kms, pms, lib, bnd, by) + dev
            print(f"{tag} BN+ReLU {name} N={N} C={MLP_WIDTH} bf16, per "
                  f"call: kernel {kms:.4f} ms, plain {pms:.4f} ms, "
                  f"F.batch_norm + relu "
                  f"{'forward' if name == 'fwd' else 'backward'} {lib:.4f} "
                  f"ms; device time: kernel {dev[0]:.4f} ms, plain "
                  f"{dev[1]:.4f} ms, library {dev[2]:.4f} ms; bound "
                  f"{bnd:.6f} ms ({by})")

    # BN-MLP training: step p50 and samples/s, then one step's device time
    # by kind
    timed_mlp = pt.ModelSerializer.restore(mlp_zip)
    mlp_clock = StepLog(torch)
    timed_mlp.set_listeners(mlp_clock)
    source = mlp_batches(x_tr, y_tr)
    timed_mlp.fit(source)                       # warm-up epoch, 2 steps
    mlp_clock.times.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed_mlp.fit(source, epochs=MLP_EPOCHS - 1)
    mlp_fit_s = time.perf_counter() - t0
    step_ms = 1e3 * np.diff([t0] + mlp_clock.times)
    bn_mlp = {"card": card, "steps_timed": len(step_ms),
              "step_p50_ms": float(np.median(step_ms)),
              "samples_per_s": len(step_ms) * MLP_B / mlp_fit_s}
    timed_mlp.set_listeners()
    batch = pt.DataSet(x_tr[:MLP_B], y_tr[:MLP_B])
    events, busy, wall = profile_device(
        torch, lambda: timed_mlp.fit(batch),
        f"BN-MLP training step (batch {MLP_B}, bf16)", tag, reps=5)
    kinds = {"gemm": 0.0, "bn_relu": 0.0, "copies": 0.0, "other": 0.0}
    for key, ms, _ in events:
        low = key.lower()
        kind = ("bn_relu" if "bn_relu" in low else
                "gemm" if any(w in low for w in ("gemm", "xmma", "cutlass"))
                else "copies" if "memcpy" in low or "memset" in low
                else "other")
        kinds[kind] += ms
    bn_mlp.update({
        "profiled_wall_ms_per_step": wall,
        "profiled_device_busy_ms_per_step": busy,
        "profiled_idle_share": 1 - busy / wall,
        "profiled_ms_per_step_by_kind": kinds,
        "accuracy_held_out_card": evs[0].accuracy(),
        "accuracy_held_out_cpu": evs[1].accuracy()})
    print(f"{tag} BN-MLP training (batch {MLP_B}, bf16 compute): step p50 "
          f"{bn_mlp['step_p50_ms']:.3f} ms over {len(step_ms)} steps, "
          f"{bn_mlp['samples_per_s']:.1f} samples/s; one step's device "
          f"time: " + ", ".join(f"{k} {ms:.3f} ms" for k, ms in kinds.items())
          + f" of {wall:.3f} ms wall (idle share {1 - busy / wall:.3f})")
    print(json.dumps({"bn_mlp_training": bn_mlp}))

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
             "and dv together, the same time on both backward entries"))]
        + [{
            "name": name,
            "route": "cuda",
            "source": "deeplearning4j_tpu_torch/kernels/csrc/bn_relu.cu",
            "replaces": replaces,
            "launches": bn_counts[counter],
            "max_abs_err": bn_max[key][0],
            "max_err_over_max_ref": bn_max[key][1],
            "per": f"one launch at the BN-MLP's N={MLP_B}, C={MLP_WIDTH}, "
                   f"bf16 (2 per training step)",
            "ms": bn_times[(key, MLP_B)][0],
            "plain_ms": bn_times[(key, MLP_B)][1],
            "bound_ms": bn_times[(key, MLP_B)][3],
            "bound_by": bn_times[(key, MLP_B)][4],
            "library_ms": bn_times[(key, MLP_B)][2],
            "library": library,
            "device_ms": bn_times[(key, MLP_B)][5],
            "plain_device_ms": bn_times[(key, MLP_B)][6],
            "library_device_ms": bn_times[(key, MLP_B)][7],
            "at_n4096": {k: v for k, v in zip(
                ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                 "device_ms", "plain_device_ms", "library_device_ms"),
                bn_times[(key, 4096)])},
            "card": card,
        } for name, key, counter, replaces, library in (
            ("bn_relu_forward", "fwd", "fwd_launches",
             "deeplearning4j_tpu/kernels/bn_relu.py:38 (_fwd_kernel via "
             "_fwd_call's pallas_call :88)",
             "F.batch_norm(training=True) + relu forward (bf16 input, f32 "
             "weight and bias)"),
            ("bn_relu_backward", "bwd", "bwd_launches",
             "deeplearning4j_tpu/kernels/bn_relu.py:50 (_bwd_kernel via "
             "_bwd_call's pallas_call :123)",
             "autograd backward of F.batch_norm(training=True) + relu "
             "(forward time subtracted)"))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
