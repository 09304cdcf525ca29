#!/usr/bin/env python3
"""Drive the PyTorch port (deeplearning4j_tpu_torch) on one NVIDIA GPU and
check every phase. Run from the repository root:

    python3 chip_smoke.py

Phases:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions,
     and the kernel build from the repository's CUDA sources;
  2. each kernel against its plain PyTorch version on the same GPU tensors,
     at the shapes the main paths give it (and ragged and other head-size
     cases for attention and its backward: every backward variant, simt,
     wgmma and wide, at head dimensions 10 to 512, in f32 / bf16 / f16, at
     B * H = 65,536, each variant also rerun bit-equal; the LSTM sequence
     kernels in both variants, "cluster" at the char-RNN's buckets 1, 8 and
     32 and training batch 64, one step, one row and a column tail, dx
     asked and not, "streamed" at H = 512 and at a 58,200-wide one-hot
     input, each variant rerun bit-equal; N in {128, 4096, 4097} x C in
     {1024, 200, 48} x bf16 / f16 / f32 and an NHWC input for the BN+ReLU
     forward and backward, "resident" there, "streamed" at N = 28,673 and
     57,345, unaligned views through both, each variant rerun
     bit-equal);
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
     ArrayDataSetIterator of the training text (chip_smoke_text.txt), from
     a zip of seeded random weights; the same zip and batches on the CPU;
     per-step scores, first-step gradients and final parameters compared;
     the zip with its updater state restored on both devices for one more
     step; then a word-level GravesLSTM(200) on a one-hot vocabulary of
     58,200 (the LSTM kernels' streamed variant) from one zip: one forward
     and one training step on the card and the CPU;
  7. main path 4: train the transformer LM of phase 5 (nanoGPT's
     shakespeare-char widths, Adam 1e-3 with beta2 0.99, dropout 0) for 20
     optimizer steps at batch 64 x 256 with `fit` over an
     ArrayDataSetIterator of overlapping windows of the training text,
     from a zip of seeded random weights; first-step gradients at batch 64
     and a 20-step trajectory at batch 16 held against the same zip and
     batches on the CPU, and the same trajectory with nanoGPT's lr warm-up;
     the trained zip with its updater state restored on both devices for
     one more step, then registered and served at bucket 32 against the
     CPU;
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
     compute_dtype), which must launch no BN kernel, against the CPU; then
     one step of the BN-MLP at batch 4096 and of a narrow BN network
     (784 -> 8 -> BatchNormalization(relu) -> 10) at batch 65,536, the
     largest batches JAX's tier sends to its kernel at those widths, each
     first-step gradient against the CPU;
  9. main path 6: the LM of phase 7 in bf16 compute
     (`compute_dtype("bfloat16")`, float32 masters) with nanoGPT's lr
     warm-up, through the bf16 instantiations of the attention kernels:
     first-step gradients at batch 16 and a 20-step trajectory at batch 16
     held against the same zip on the CPU, 20 steps at batch 64 x 256
     counted, and the trained zip's bucket-32 forward through the primal
     kernel against the CPU; the same trajectory without the warm-up,
     through the kernels and the plain attention, printed beside the CPU's;
     then one-block LMs at head dimensions 256 and 512 (widths 512 and
     1024, 2 heads), one step and one forward each in float32 and in bf16,
     against the CPU;
 10. times: each kernel, its plain version, the PyTorch library call where
     there is one, and its bound (the LSTM sequence kernels also per step,
     in both variants; also in bf16 and at Dh = 256 and 512 for
     the attention kernels, per call and on the device, SDPA's backward
     beside dq and dk/dv, and
     the LSTM reduction's whole function in PyTorch calls beside
     torch.matmul); predict and HTTP p50 per bucket and tokens/s at bucket
     32 for both models; training tokens/s and step p50 for both models
     and samples/s for the BN-MLP; the BN+ReLU kernels at N in {128,
     4096} x C in {1024, 200, 48} through the wrapper and each variant's
     entry point alone, a call at N = 128 split into entry point, wrapper
     and autograd Function; where the LM's bucket-32 forward, a char-RNN
     training batch, an LM training step in f32 and in bf16 and a BN-MLP
     step at batch 128 and 4096 spend their device time (torch.profiler);
 11. main path 7, the convolutional path (no hand kernel; conv, pool and
     LRN through torch.nn.functional, cuDNN on the card): AlexNet's SAME
     11x11/4 conv (padding split 3 / 4), 3x3 SAME and 5x5 convs, LRN and
     the four pooling types (TRUNCATE, uneven SAME, padding past half a
     kernel) on the card against the CPU, outputs and gradients; LeNet-MNIST
     (BASELINE config 1, full width, 431,080 parameters) built from one
     JSON and trained 20 Nesterovs steps with `fit` over an
     ArrayDataSetIterator of the 320 bundled digits (batch 128, shuffled,
     drop_last) from a zip of seeded random weights, on the card and the
     CPU (scores, first-step gradients, final parameters), evaluated on
     the 64 held-out digits, its zip with updater state restored on both
     devices for one more step, and served over HTTP in buckets 1, 8 and
     32 with a swap; VGG-16 at ImageNet widths (224 x 224 x 3, 1000
     classes, 138,357,544 parameters): forward and first-step gradients at
     batch 2 against the CPU, then 5 Nesterovs steps at batch 32 on the
     card; AlexNet (62,378,344 parameters) registered and served in
     process at buckets 1, 8 and 32 against the CPU; then LeNet's step
     p50 and samples/s at batch 512, VGG-16's step p50, images/s and share
     of the f32 peak at batch 32, both steps' device busy time and idle
     share (torch.profiler), AlexNet's predict p50 per bucket, and the
     run's total seconds.

Each kernel counts its launches. Every count is set to 0 before each main
path and read after it: two primal LSTM launches per char-RNN forward
(phases 3-4), six primal attention launches per LM forward (phase 5), two
residual-forward, two adjoint and two reduction launches per char-RNN
training step (phase 6), the LSTM sequence kernels all of the "cluster"
variant (phases 3, 4 and 6), one of each "streamed" for the word-level
layer's forward and training step (phase 6), and six logsumexp-forward, six
dq and six dk/dv launches per LM training step, the backward all of the
"simt" variant (phase 7), and one BN+ReLU forward and one backward launch
per BN layer and bf16 training step (phase 8: 40 and 40 over 20 steps, all
"resident", none in evaluation or in float32; 4 and 4 "resident" for the
batch-4096 gradients and step, 2 and 2 "streamed" for the narrow network's),
six bf16 logsumexp-forward, dq and dk/dv launches per bf16 LM training step,
the backward all of the "wgmma" variant, and six primal ones per bf16 LM
forward, one of each per step or forward of the wide-head LMs, at Dh = 512
of the "wide" variants (phase 9), each path launching none of the others'
kernels, and none at all on the convolutional path (phase 11). The last two lines are a `{"kernels": [...]}` object and `{"ok":
true, "device": {...}}`. Any failed check, or a machine without a CUDA
device, exits non-zero before either.
"""
import contextlib
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
BF16_FLOP_PER_S = 989e12        # H100 SXM bf16 / fp16 tensor cores, dense

# char-RNN (BASELINE config 3)
SEQ, VOCAB, HIDDEN = 64, 77, 200
LSTM_TOL = 5e-5     # f32 sums of up to 400 terms in another order, x 64 steps
# a word-level GravesLSTM(200) on a one-hot vocabulary of 58,200 (the
# wide layer the card tests hold): a cluster CTA's 7,275 input rows of W do
# not fit its shared memory, so its kernels take the "streamed" variant
WORD_VOCAB, WORD_CLASSES, WORD_T, WORD_B = 58200, 16, 8, 4
# shapes that take the LSTM kernels' "streamed" variant: a layer of 512
# units, and the word-level layer
STREAMED_SHAPES = [(SEQ, 4, VOCAB, 512), (WORD_T, WORD_B, WORD_VOCAB, HIDDEN)]
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
# The same 20 steps with nanoGPT's warm-up (LM_WARMUP, as the bf16 LM of
# phase 9 trains) stay clear of the spikes, so they are held to the
# char-RNN's trajectory limit.
LM_WARM_SCORE_TOL = SCORE_TOL

# BN-MLP (deeplearning4j_tpu/models/zoo.py:mlp_mnist with a
# BatchNormalization(relu) after each hidden Dense(identity) layer), trained
# in bf16 on the bundled MNIST digits (deeplearning4j_tpu_torch/resources/
# mnist_subset.npz: 320 train, 64 held out)
MLP_WIDTH, MLP_B, MLP_EPOCHS, MLP_LR = 1024, 128, 10, 1e-3
MLP_STEPS = 2 * MLP_EPOCHS          # 320 digits, batch 128, drop_last
BN_SHAPES = [(n, c) for n in (MLP_B, 4096, 4097) for c in (1024, 200, 48)]
# Shapes past the BN kernels' resident slabs (csrc/bn_relu.cu's header):
# N = 28,673 at C = 10 takes the streamed backward (and the resident
# forward), N = 57,345 at C = 8 the streamed forward and backward
BN_STREAMED = [(28673, 10), (57345, 8)]
# The BN-MLP also takes one step at batch 4096, the largest batch JAX's
# _block_c sends to its kernel at width 1024 (resident, N split over
# clusters of 2); and a narrow BN network (Dense(8) + BatchNormalization
# (relu) + softmax output) one step at batch 65,536, the largest _block_c
# sends at width 8: past both resident slabs, the streamed kernels' path
MLP_BIG_B = 4096
NARROW_C, NARROW_B = 8, 65536
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

# Attention kernels in bf16 / f16, at head dimensions from 10 to 512 and at
# B * H = 65,536 against their plain versions: both compute in f32 from the
# same inputs (the "wgmma" backward takes p and ds as hi + lo pairs of the
# input type, about 2^-16 relative) and round o, dq, dk and dv to the
# inputs' dtype, so a value on a rounding boundary may land one ulp of the
# dtype apart (BN_ULP), on top of the f32 limit ATTN_GRAD_TOL of the
# largest plain magnitude; L and D are f32. The cases reach every backward
# variant ("simt": f32, or a head dimension not a multiple of 16; "wgmma":
# bf16 / f16 at multiples of 16 up to 256; "wide": past 256) and both
# forward variants.
TYPED_ATTN = [("bfloat16", LM_TRAIN_B, LM_SEQ, LM_SEQ, LM_HEADS, 64, True),
              ("bfloat16", 32, LM_SEQ, LM_SEQ, LM_HEADS, 64, True),
              ("float16", 4, LM_SEQ, LM_SEQ, LM_HEADS, 64, True),
              ("bfloat16", 2, 100, 100, LM_HEADS, 64, True),    # ragged
              ("bfloat16", 3, 96, 80, LM_HEADS, 64, False),     # T != S
              ("bfloat16", 3, 37, 129, 3, 10, False),
              ("bfloat16", 2, LM_SEQ, LM_SEQ, 4, 16, True),
              ("float16", 2, LM_SEQ, LM_SEQ, 3, 128, True),
              ("float32", 2, 100, 100, 2, 160, True),
              ("bfloat16", 2, 100, 100, 2, 160, True),
              ("float32", 4, LM_SEQ, LM_SEQ, 2, 256, True),
              ("bfloat16", 4, LM_SEQ, LM_SEQ, 2, 256, True),
              ("float16", 2, 70, 50, 2, 256, False),
              ("float32", 2, 24, 24, 2, 257, True),      # the wide kernels
              ("bfloat16", 2, 24, 24, 2, 257, True),
              ("float32", 2, 70, 50, 2, 320, False),
              ("bfloat16", 2, 20, 13, 2, 320, False),
              ("float32", 2, 100, 100, 2, 512, True),
              ("bfloat16", 2, LM_SEQ, LM_SEQ, 2, 512, True),
              ("float32", 16384, 8, 8, 4, 16, True),     # B * H = 65,536
              ("bfloat16", 16384, 8, 8, 4, 16, True)]
# The bf16 LM trains with nanoGPT's warm-up (config/train_shakespeare_char.py
# `warmup_iters = 100`, get_lr's lr * (it + 1) / (warmup_iters + 1); 20 steps
# see its first fifth). Without it, Adam at 1e-3 drives the score through a
# spike that amplifies bf16 rounding: the card ends up 1.8e-1 from the CPU
# through the kernels and 7.5e-2 through the plain attention (NVIDIA H100
# 80GB HBM3, 700 W, this script's printout); with it, 7.0e-5. The
# no-warm-up run is repeated below in every run, printed beside the held
# one.
LM_WARMUP = 100
# the wide-head LMs: one block at Dh = 256 and 512 (widths 512 and 1024, 2
# heads)
WIDE_WIDTHS, WIDE_HEADS = (512, 1024), 2

# the convolutional path (main path 7): LeNet-MNIST (BASELINE config 1,
# deeplearning4j_tpu/models/zoo.py:25) trained as the BN-MLP is, on the
# bundled digits (batch 128, shuffled, drop_last: 20 steps in 10 epochs),
# held to the char-RNN's float32 limits (GRAD_TOL, SCORE_TOL, PARAM_TOL)
LENET_PARAMS, LENET_B, LENET_EPOCHS = 431_080, 128, 10
LENET_STEPS = 2 * LENET_EPOCHS
LENET_BENCH_B = 512             # bench_lenet's batch (zoo.py:255)
# LeNet's final biases (norms 0.06-0.1 after 20 steps) are held per tensor
# to 1e-2 relative L2, its weights to PARAM_TOL: the 20 Nesterovs steps
# pass rounding on through max-pool choices and ReLU masks, and the CPU
# alone, against itself in float64 or at another thread count, leaves its
# hidden layers' biases 2.2e-3 to 3.0e-3 apart (the output bias 2.7e-4 to
# 4.4e-4) and its weights 2.6e-5 to 4.4e-4 (`python
# tests/test_torch_lenet.py` prints them); the card read 4.6e-3 on one
# bias against 1e-3 (NVIDIA H100 80GB HBM3, 700.00 W)
LENET_BIAS_TOL = 1e-2
# VGG-16 at ImageNet widths (zoo.py:246): forward and first-step gradients
# at batch 2 against the CPU. Each conv output sums up to 3 x 3 x 512 =
# 4608 f32 products and a dense one up to 25,088, in another order on cuDNN
# / cuBLAS than on the CPU's oneDNN: about 4608^0.5 x 2^-24 x 16 layers ~
# 7e-5 for independent roundings, which the output and the score show
# (output relative to its largest entry held at 1e-3, score at 1e-4
# relative). The gradients do not: where two values of a 2 x 2 max-pool
# window lie within rounding of each other (or a pre-activation within
# rounding of 0), the two sides route a gradient to different entries, and
# one such flip moves a gradient tensor below it by up to ~1e-2 in relative
# L2 (two entries of ~25,000 live ones: (2 / 25,000)^0.5). So they are held
# per tensor in relative L2 at 1e-2, and the same gaps of the CPU's own
# float32 against its float64 are printed beside the card's: the first
# runs read 4.3e-3 card vs CPU and 4.8e-3 CPU float32 vs float64 (worst
# tensors; NVIDIA H100 80GB HBM3, 700.00 W), after a largest-entry limit of
# 1e-3 and then a relative-L2 one of 1e-3, each set before that
# measurement, had failed there.
IMAGE, CLASSES = 224, 1000       # ImageNet widths, VGG-16's and AlexNet's
VGG_PARAMS, VGG_CMP_B, VGG_B, VGG_STEPS = 138_357_544, 2, 32, 5
VGG_TOL = 1e-3
VGG_GRAD_TOL = 1e-2
# The zoo's Nesterovs at lr 0.01 (momentum 0.9) diverges to NaN within a
# few steps on seeded normal images with random labels (on the CPU at
# smaller images, the same math in either package), and 1e-3 can still
# jump; the card's steps take lr 1e-4, whose scores fall. A step's time
# does not depend on the rate.
VGG_LR = 1e-4
ALEX_PARAMS = 62_378_344        # zoo.py:510, image 224, 1000 classes
# one conv / pool / LRN layer on the card against the CPU, outputs and
# gradients relative to the largest magnitude: sums of up to 25,088 f32
# terms (a weight gradient) in another order, and cuDNN may pick FFT or
# Winograd algorithms, whose f32 rounding exceeds a direct sum's
CNN_LAYER_TOL = 1e-4


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


def l2_err(got, want):
    """|got - want| over |want|, in L2."""
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


@contextlib.contextmanager
def plain_bn(bn_relu):
    """The BN+ReLU kernels' plain versions in their place on the card, for
    a comparison only: the launch counts do not move."""
    fwd, bwd = bn_relu._forward_kernel, bn_relu._backward_kernel
    bn_relu._forward_kernel = bn_relu.bn_relu_reference
    bn_relu._backward_kernel = bn_relu.bn_relu_backward_reference
    try:
        yield
    finally:
        bn_relu._forward_kernel, bn_relu._backward_kernel = fwd, bwd


def text_windows(root, alphabet, n, length):
    """The training text of phases 6, 7 and 9 as ids of `alphabet`
    (anything else becomes a space), cut into `n` evenly spaced windows of
    `length` characters (overlapping where the text is shorter than n *
    length). The text is the repository's README.md as it stood before the
    port's eighth slice, kept in chip_smoke_text.txt: the LM's no-warm-up
    trajectory amplifies f32 rounding through its loss spikes by an amount
    that depends on the text, so an edit of the README must not move these
    runs."""
    with open(os.path.join(root, "chip_smoke_text.txt"),
              encoding="utf-8") as fh:
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


def adam_param_err(net, ref, lr, steps, skip=("b_k",)):
    """Largest per-tensor |a - b|_2 / max(|b|_2, Adam's reach lr * steps in
    L2) between two networks, over the parameter keys not in `skip` (the
    reach for tensors that start at 0, whose entries with a gradient within
    rounding of 0 Adam moves by lr per step with the noise's sign)."""
    worst = 0.0
    for p, q in zip(net.params, ref.params):
        for k in q:
            if k in skip:
                continue
            a, b = p[k].detach().cpu(), q[k].detach().cpu()
            scale = max(b.norm().item(), lr * steps * b.numel() ** 0.5)
            worst = max(worst, (a - b).norm().item() / scale)
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


def bound(nbytes, flops, flop_per_s=F32_FLOP_PER_S):
    """Least time for the work: bytes over HBM, FLOPs over the peak of the
    inputs' type (f32 outside the tensor cores unless given). Returns (ms,
    what bounds it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_per_s
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


def _peak(itemsize):
    """The FLOP rate of the inputs' type: f32 on the CUDA cores, or the
    bf16 / f16 tensor-core rate for 2-byte inputs."""
    return F32_FLOP_PER_S if itemsize == 4 else BF16_FLOP_PER_S


def attention_bound_ms(B, T, S, H, Dh, causal, itemsize=4):
    """One launch: q, k, v read once and o written once; 4 Dh FLOPs (the
    two products) per attended (query, key) pair this mask leaves."""
    nbytes = itemsize * B * H * Dh * (2 * T + 2 * S)
    return bound(nbytes, 4 * Dh * live_pairs(T, S, causal) * B * H,
                 _peak(itemsize))


def lse_bound_ms(B, T, S, H, Dh, causal, itemsize=4):
    """The logsumexp forward: as the primal, plus L [B, H, T] (f32)
    written."""
    nbytes = itemsize * B * H * Dh * (2 * T + 2 * S) + 4 * B * H * T
    return bound(nbytes, 4 * Dh * live_pairs(T, S, causal) * B * H,
                 _peak(itemsize))


def dq_bound_ms(B, T, S, H, Dh, causal, itemsize=4):
    """dq: q, k, v, o, do and L read once, dq and D written once; 6 Dh
    FLOPs per live pair (s, do v^T, ds k)."""
    nbytes = itemsize * B * H * Dh * (4 * T + 2 * S) + 8 * B * H * T
    return bound(nbytes, 6 * Dh * live_pairs(T, S, causal) * B * H,
                 _peak(itemsize))


def dkv_bound_ms(B, T, S, H, Dh, causal, itemsize=4):
    """dk/dv: q, k, v, do, L and D read once, dk and dv written once; 8 Dh
    FLOPs per live pair (s, do v^T, p^T do, ds^T q)."""
    nbytes = itemsize * B * H * Dh * (2 * T + 4 * S) + 8 * B * H * T
    return bound(nbytes, 8 * Dh * live_pairs(T, S, causal) * B * H,
                 _peak(itemsize))


def ulp_err(got, want, dtype, tol=BN_TOL):
    """(within the limit, max abs err, max err / max |want|): the limit is
    `tol` of max |want| plus one ulp of `dtype` (BN_ULP) of each
    element."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    limit = (BN_ULP[dtype] * got.abs().maximum(want.abs())
             + tol * want.abs().max())
    return (bool((err <= limit).all()), err.max().item(),
            (err.max() / want.abs().max().clamp_min(1e-30)).item())


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


def bn_narrow_json(pt):
    """A narrow BN network: Dense(identity) of NARROW_C units +
    BatchNormalization(relu) + softmax output on 784 inputs, in bf16
    compute, Adam as the BN-MLP."""
    return (pt.NeuralNetConfiguration.builder().seed(42)
            .updater(pt.Adam(MLP_LR)).compute_dtype("bfloat16").list()
            .layer(pt.DenseLayer(n_out=NARROW_C, activation="identity"))
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
    # a profiling session now and then records no device event at all
    # (seen on the H100 machine after a few dozen sessions): up to three
    # sessions, then the check fails
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA)
        if total > 0:
            break
    check(total > 0, "torch.profiler recorded no device time")
    return total / 1e3 / reps


def device_ms_by_kind(events):
    """A profile's device ms (profile_device's events) by kind: GEMMs, the
    BN+ReLU kernels, copies and the rest."""
    kinds = {"gemm": 0.0, "bn_relu": 0.0, "copies": 0.0, "other": 0.0}
    for key, ms, _ in events:
        low = key.lower()
        kind = ("bn_relu" if "bn_relu" in low else
                "gemm" if any(w in low for w in ("gemm", "xmma", "cutlass"))
                else "copies" if "memcpy" in low or "memset" in low
                else "other")
        kinds[kind] += ms
    return kinds


def bn_bare_call(torch, bn_relu, kind, variant, x, g, b, mean, var, dy):
    """A call of the BN+ReLU `kind` ("fwd" / "bwd") kernel's `variant`
    entry point alone, on outputs made here (the ctypes call: no checks, no
    allocation, no launch count), and those outputs (y or dx, then the two
    [C] results). The resident variant runs the plan bn_plan gives the
    shape; the streamed one takes any N. x and dy are aligned and C a
    multiple of the 16-byte pack."""
    N, C = x.shape
    plan = bn_relu.bn_plan(N, C, x.element_size(), kind == "bwd")
    check(variant == "streamed" or plan.variant == "resident",
          f"N={N} C={C} has no resident {kind} plan")
    out = torch.empty_like(x)
    sums = torch.empty((2, C), dtype=torch.float32, device=x.device)
    tensors = ((x, g, b, out, sums[0], sums[1]) if kind == "fwd" else
               (x, g, b, mean, var, dy, out, sums[0], sums[1]))
    dims = (N, C, plan.rows, plan.cluster) if variant == "resident" else (N, C)
    entry = bn_relu._kernel_fn(bn_relu._ENTRY_POINTS[kind, variant])
    args = ([t.data_ptr() for t in tensors] + list(dims)
            + [1e-5, bn_relu.KERNEL_DTYPES[x.dtype], 1,
               torch.cuda.current_stream().cuda_stream])
    return (lambda: entry(*args)), (out, sums[0], sums[1])


def make_lm(pt, torch, seed, updater=None, dist=None, compute_dtype=None,
            width=LM_WIDTH, heads=LM_HEADS, blocks=LM_BLOCKS, warmup=False):
    """The transformer LM at nanoGPT shakespeare-char widths (or the given
    width, heads and depth), built with the builder DSL (the repository
    has no zoo entry for it), with random weights from `seed` (the
    configuration's default Xavier init, or the weight distribution
    `dist`), in float32 or the given compute dtype (float32 masters); with
    `warmup`, the updater's lr ramps up as nanoGPT's first LM_STEPS
    iterations do (LM_WARMUP)."""
    b = pt.NeuralNetConfiguration.builder().seed(seed)
    if updater is not None:
        b = b.updater(updater)
    if dist is not None:
        b = b.dist(dist)
    if compute_dtype is not None:
        b = b.compute_dtype(compute_dtype)
    if warmup:
        b = b.learning_rate_decay_policy("schedule", schedule={
            i: LM_LR * (i + 1) / (LM_WARMUP + 1) for i in range(LM_STEPS)})
    b = (b.list()
         .layer(pt.EmbeddingSequenceLayer(n_in=LM_VOCAB, n_out=width)))
    for _ in range(blocks):
        b = b.layer(pt.TransformerBlock(n_heads=heads))
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



def forward_flops(net):
    """A network's forward FLOPs per example: 2 x the multiply-adds of
    every convolution and dense layer, from the input types `init` carries
    through the preprocessors."""
    from deeplearning4j_tpu_torch.nn.layers import (ConvolutionLayer,
                                                    DenseLayer, OutputLayer)
    it, flops = net.conf.input_type, 0
    for i, layer in enumerate(net.layers):
        if i in net.conf.preprocessors:
            it = net.conf.preprocessors[i].output_type(it)
        out = layer.output_type(it)
        if isinstance(layer, ConvolutionLayer):
            kh, kw = layer.kernel_size
            flops += 2 * out.height * out.width * kh * kw * it.channels \
                * out.channels
        elif isinstance(layer, (DenseLayer, OutputLayer)):
            flops += 2 * it.flat_size() * layer.n_out
        it = out
    return flops


def cnn_ms_by_kind(events):
    """A profile's device ms (profile_device's events) by kind for a conv
    net: cuDNN's direct / implicit-GEMM convolutions, its FFT convolutions
    (transforms, complex GEMMs, pointwise products), its layout transposes
    between NHWC and NCHW, other GEMMs (the dense layers; some may be
    convolutions cuDNN runs as a GEMM), pooling, and elementwise work and
    the rest (bias, ReLU, updater, loss)."""
    kinds = dict.fromkeys(("conv", "conv_fft", "layout", "gemm", "pool",
                           "other"), 0.0)
    for key, ms, _ in events:
        low = key.lower()
        kind = ("layout" if "nhwctonchw" in low or "nchwtonhwc" in low else
                "conv_fft" if any(w in low for w in ("fft", "cf32",
                                                     "complex")) else
                "conv" if any(w in low for w in ("fprop", "dgrad", "wgrad",
                                                 "convolve", "implicit",
                                                 "winograd", "cudnn")) else
                "gemm" if "gemm" in low else
                "pool" if "pool" in low else "other")
        kinds[kind] += ms
    return kinds


def cnn_path(pt, torch, tag, tmp, reset_counts, counts):
    """Main path 7 (phase 11): the convolutional path. LeNet-MNIST trained
    20 steps on the card and the CPU from one zip, evaluated, resumed from
    its zip and served over HTTP; VGG-16 at ImageNet widths held to the CPU
    at batch 2, then trained and timed at batch 32; AlexNet registered and
    served in process at buckets 1, 8 and 32 against the CPU; the conv,
    pool and LRN layers of these paths on the card against the CPU; times
    and device profiles. No hand kernel launches on this path: `counts()`
    stays all 0. Returns the phase's numbers."""
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.nn.conf.base import conf_from_dict
    from deeplearning4j_tpu_torch.nn.updaters import Nesterovs
    from deeplearning4j_tpu_torch.util.platform import strict_fp32
    strict_fp32()     # TF32 off for the bare layers, as a network sets it
    out = {"card": tag.strip("[]")}
    t_phase = time.perf_counter()
    reset_counts()

    # -- the layers at these paths' shapes, card against CPU ------------
    def layer_case(spec, shape, seed):
        layer = conf_from_dict({"__layer__": {"type": spec[0],
                                              "fields": spec[1]}})
        r = np.random.default_rng(seed)
        x = r.normal(size=shape).astype(np.float32)
        params = {}
        if layer.has_params:
            params = layer.init_params(torch.Generator().manual_seed(seed),
                                       pt.InputType.convolutional(
                                           *shape[1:]), "cpu")
        ys = []
        for dev in (DEVICE, "cpu"):
            p = {k: v.to(dev).requires_grad_() for k, v in params.items()}
            xt = torch.tensor(x, device=dev, requires_grad=True)
            y, _ = layer.apply(p, {}, xt)
            ct = torch.tensor(np.random.default_rng(seed + 1).normal(
                size=tuple(y.shape)).astype(np.float32), device=dev)
            grads = torch.autograd.grad(y, [xt] + list(p.values()), ct)
            ys.append([y.detach().cpu()] + [g.cpu() for g in grads])
            if dev == DEVICE:
                contiguous = y.is_contiguous()
        return max(rel_err(a, b) for a, b in zip(*ys)), contiguous

    cases = [
        (("ConvolutionLayer", {"n_in": 3, "n_out": 96,
                               "kernel_size": [11, 11], "stride": [4, 4],
                               "convolution_mode": "same"}),
         (8, 224, 224, 3)),          # AlexNet's conv 1: SAME pads (3, 4)
        (("ConvolutionLayer", {"n_in": 64, "n_out": 64,
                               "kernel_size": [3, 3],
                               "convolution_mode": "same"}),
         (8, 56, 56, 64)),
        (("ConvolutionLayer", {"n_in": 1, "n_out": 20,
                               "kernel_size": [5, 5]}), (64, 28, 28, 1)),
        (("LocalResponseNormalization", {}), (8, 27, 27, 256)),
    ] + [(("SubsamplingLayer", {"pooling_type": pool, **kw}), shape)
         for pool in ("max", "avg", "sum", "pnorm")
         for kw, shape in (
             ({"kernel_size": [3, 3], "stride": [2, 2]}, (8, 55, 55, 96)),
             ({"kernel_size": [2, 2], "stride": [2, 2],
               "convolution_mode": "same"}, (8, 27, 27, 64)),
             ({"kernel_size": [3, 3], "stride": [1, 1],
               "padding": [2, 2]}, (8, 13, 13, 32)))]
    layer_err = 0.0
    for i, (spec, shape) in enumerate(cases):
        err, contiguous = layer_case(spec, shape, seed=40 + i)
        check(err <= CNN_LAYER_TOL, f"{spec[0]} {spec[1]} at {shape}: "
              f"output or gradient err / max |ref| {err} > {CNN_LAYER_TOL}")
        check(spec[0] != "ConvolutionLayer" or contiguous,
              f"{spec[0]} {spec[1]}: output not contiguous NHWC")
        layer_err = max(layer_err, err)
    print(f"conv / pool / LRN layers on the card vs the CPU: {len(cases)} "
          f"cases (AlexNet's SAME 11x11/4 conv, 3x3 SAME and LeNet's 5x5 "
          f"convs, LRN, 4 pooling types x TRUNCATE / uneven SAME / padding "
          f"past half a kernel): output and gradients max err / max |ref| "
          f"{layer_err:.3e} (limit {CNN_LAYER_TOL}); conv outputs contiguous NHWC "
          "(cuDNN returned channels_last)")
    out["layers_max_err_over_max_ref"] = layer_err

    # -- LeNet: 20 steps on the card and the CPU from one zip -----------
    x_tr, y_tr, x_te, y_te = pt.bundled_mnist_subset()
    lenet_json = zoo.lenet_mnist(device="cpu").conf.to_json()
    zips = []
    for seed in (7, 8):
        path = os.path.join(tmp, f"lenet_{seed}.zip")
        pt.ModelSerializer.write_model(pt.MultiLayerNetwork(
            pt.MultiLayerConfiguration.from_json(lenet_json),
            device=DEVICE).init(generator=torch.Generator().manual_seed(
                seed)), path)
        zips.append(path)
    nets = [pt.ModelSerializer.restore(zips[0]),
            pt.ModelSerializer.restore(zips[0], device="cpu")]
    check(nets[0].num_params() == LENET_PARAMS, f"LeNet has "
          f"{nets[0].num_params()} parameters, want {LENET_PARAMS}")
    batches = lambda: pt.ArrayDataSetIterator(
        x_tr, y_tr, batch_size=LENET_B, shuffle=True, seed=13,
        drop_last=True)
    first = batches().next()
    g = [first_chunk_grads(torch, n, first, steps=None) for n in nets]
    grad_err = max(rel_err(g[0][k], g[1][k]) for k in g[1])
    check(grad_err <= GRAD_TOL, f"LeNet first-step gradients: max err / "
          f"max |ref| {grad_err} > {GRAD_TOL}")
    logs = [StepLog(), StepLog()]
    for n, log in zip(nets, logs):
        n.set_listeners(log)
    t0 = time.perf_counter()
    nets[0].fit(batches(), epochs=LENET_EPOCHS)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    nets[1].fit(batches(), epochs=LENET_EPOCHS)
    cpu_s = time.perf_counter() - t0
    scores = [[float(v) for v in log.scores] for log in logs]
    check(len(scores[0]) == len(scores[1]) == LENET_STEPS,
          f"LeNet took {len(scores[0])} / {len(scores[1])} steps, want "
          f"{LENET_STEPS}")
    check(np.isfinite(scores[0]).all() and scores[0][-1] < scores[0][0],
          f"LeNet scores {scores[0]}")
    score_err = float(np.abs(np.subtract(*scores)).max())
    param_gaps = {f"{i}/{k}": l2_err(p[k].detach().cpu(), q[k])
                  for i, (p, q) in enumerate(zip(nets[0].params,
                                                 nets[1].params))
                  for k in q}
    param_err = max(v for k, v in param_gaps.items() if k.endswith("/W"))
    bias_err = max(v for k, v in param_gaps.items() if k.endswith("/b"))
    print(f"LeNet training ({LENET_PARAMS} parameters, Nesterovs 0.01 / "
          f"0.9, l2 5e-4): {LENET_STEPS} steps of {LENET_B} digits in "
          f"{fit_s:.2f} s on the card, {cpu_s:.2f} s on the CPU; score "
          f"{scores[0][0]:.4f} -> {scores[0][-1]:.4f}; card vs CPU: scores "
          f"max abs err {score_err:.3e} (limit {SCORE_TOL}), first-step "
          f"gradients {grad_err:.3e} of max (limit {GRAD_TOL}), final "
          f"weights {param_err:.3e} relative L2 (limit {PARAM_TOL}), "
          f"biases {bias_err:.3e} (limit {LENET_BIAS_TOL}); per tensor "
          + ", ".join(f"{k} {v:.2e}" for k, v in param_gaps.items()))
    print(json.dumps({"lenet_scores_card": scores[0],
                      "lenet_scores_cpu": scores[1]}))
    check(score_err <= SCORE_TOL, f"LeNet scores card vs CPU: {score_err} "
          f"> {SCORE_TOL}")
    check(param_err <= PARAM_TOL and bias_err <= LENET_BIAS_TOL,
          f"LeNet parameters after {LENET_STEPS} steps: {param_gaps}")
    # evaluate on the 64 held-out digits; a digit whose two top
    # probabilities are within rounding may go either way, so the two
    # accuracies may differ by one digit in 64
    evs = [n.evaluate(pt.ArrayDataSetIterator(x_te, y_te, batch_size=64))
           for n in nets]
    accs = [ev.accuracy() for ev in evs]
    check(abs(accs[0] - accs[1]) <= 1 / 64 + 1e-9, f"LeNet held-out "
          f"accuracy {accs[0]} on the card, {accs[1]} on the CPU")
    print(f"LeNet evaluate (64 held-out digits): accuracy {accs[0]:.4f} on "
          f"the card, {accs[1]:.4f} on the CPU")
    # the zip with its updater state, restored on both devices, one more
    # step on each
    trained = os.path.join(tmp, "lenet_trained.zip")
    pt.ModelSerializer.write_model(nets[0], trained)
    resumed = [pt.ModelSerializer.restore(trained),
               pt.ModelSerializer.restore(trained, device="cpu")]
    check(all(n.iteration_count == LENET_STEPS for n in resumed)
          and all(float(v.abs().max()) > 0 for n in resumed
                  for u in n.updater_state for v in u["v"].values()),
          "the LeNet zip lost its iteration count or Nesterovs' velocity")
    for n in resumed:
        n.fit(first)
    resume_score = abs(float(resumed[0].score()) - float(resumed[1].score()))
    resume_param = max(l2_err(p[k].detach().cpu(), q[k])
                       for p, q in zip(*(n.params for n in resumed))
                       for k in q)
    check(resume_score <= SCORE_TOL and resume_param <= PARAM_TOL,
          f"LeNet resumed step: score err {resume_score}, parameters "
          f"{resume_param}")
    print(f"LeNet zip (with updater state) restored on both devices, one "
          f"more step: score err {resume_score:.3e}, parameters "
          f"{resume_param:.3e} relative L2")
    # served over HTTP in buckets 1, 8 and 32: the trained zip, then a
    # swap to the seed-8 zip
    serve_cpu = [pt.ModelSerializer.restore(z, device="cpu")
                 for z in (trained, zips[1])]
    v1, v2, flushes, n_batched, serve_err = serve_and_check(
        pt, "lenet", [trained, zips[1]], serve_cpu,
        lambda r, rows: r.random((rows, 784)).astype(np.float32), (10,),
        np.random.default_rng(30))
    print(f"LeNet serving: {n_batched} batched requests in {flushes} "
          f"flushes + swap, {v1.forwards + v2.forwards} forwards; max abs "
          f"err vs CPU {serve_err:.3e} (limit {SERVE_TOL})")
    out["lenet"] = {"scores_card": scores[0], "score_err": score_err,
                    "grad_err": grad_err, "param_err": param_gaps,
                    "accuracy_card": accs[0], "accuracy_cpu": accs[1],
                    "resume_score_err": resume_score,
                    "serve_err": serve_err}

    # -- VGG-16 at ImageNet widths ---------------------------------------
    t0 = time.perf_counter()
    gen = lambda: torch.Generator().manual_seed(11)
    vggs = [zoo.vgg16(CLASSES, IMAGE, updater=Nesterovs(VGG_LR, 0.9),
                      device=dev).init(generator=gen())
            for dev in (DEVICE, "cpu")]
    check(vggs[0].num_params() == VGG_PARAMS, f"VGG-16 has "
          f"{vggs[0].num_params()} parameters, want {VGG_PARAMS}")
    r = np.random.default_rng(21)
    xv = r.normal(size=(VGG_B * (VGG_STEPS + 1), IMAGE, IMAGE, 3)).astype(
        np.float32)
    yv = np.eye(CLASSES, dtype=np.float32)[r.integers(0, CLASSES, len(xv))]
    small = pt.DataSet(xv[:VGG_CMP_B], yv[:VGG_CMP_B])
    probs = [n.output(small.features).cpu() for n in vggs]
    vgg_out_err = rel_err(probs[0], probs[1])
    g = [first_chunk_grads(torch, n, small, steps=None) for n in vggs]
    s = [n.score(small) for n in vggs]
    vgg_score_err = abs(s[0] - s[1]) / abs(s[1])
    # the CPU's own rounding: the same gradients in float64
    del vggs[1]
    f64 = zoo.vgg16(CLASSES, IMAGE, device="cpu").init(generator=gen())
    f64.conf.conf.dtype = "float64"
    f64.params = tuple({k: v.double() for k, v in p.items()}
                       for p in f64.params)
    g.append(first_chunk_grads(torch, f64, small, steps=None))
    del f64
    gaps = {pair: {k: (l2_err(g[a][k].double(), g[b][k].double()),
                       rel_err(g[a][k].double(), g[b][k].double()))
                   for k in g[b]}
            for pair, (a, b) in (("card_vs_cpu", (0, 1)),
                                 ("cpu_f32_vs_f64", (1, 2)),
                                 ("card_vs_cpu_f64", (0, 2)))}
    del g
    worst = {pair: [max(v[i] for v in d.values()) for i in (0, 1)]
             for pair, d in gaps.items()}
    vgg_grad_err = worst["card_vs_cpu"][0]
    print(f"VGG-16 ({VGG_PARAMS} parameters, {IMAGE} x {IMAGE} x 3, "
          f"{CLASSES} classes) at batch {VGG_CMP_B}: output card vs CPU "
          f"{vgg_out_err:.3e} of max (limit {VGG_TOL}); first-step "
          f"gradients, worst tensor, relative L2 / largest-entry error over "
          f"largest: card vs CPU {worst['card_vs_cpu'][0]:.3e} (limit "
          f"{VGG_GRAD_TOL}) / {worst['card_vs_cpu'][1]:.3e}, the CPU's float32 "
          f"vs its float64 {worst['cpu_f32_vs_f64'][0]:.3e} / "
          f"{worst['cpu_f32_vs_f64'][1]:.3e}, card vs float64 "
          f"{worst['card_vs_cpu_f64'][0]:.3e} / "
          f"{worst['card_vs_cpu_f64'][1]:.3e}; score {s[0]:.5f} vs "
          f"{s[1]:.5f} ({vgg_score_err:.3e} relative, limit 1e-4); "
          f"{time.perf_counter() - t0:.1f} s")
    print(json.dumps({"vgg16_grad_gaps": gaps}))
    check(vgg_out_err <= VGG_TOL and vgg_grad_err <= VGG_GRAD_TOL
          and vgg_score_err <= 1e-4, "VGG-16 card vs CPU past its limits")
    vgg = vggs[0]
    log = StepLog(torch)
    vgg.set_listeners(log)
    xg = torch.as_tensor(xv, device=DEVICE)
    yg = torch.as_tensor(yv, device=DEVICE)
    for i in range(VGG_STEPS):
        vgg.fit(pt.DataSet(xg[i * VGG_B:(i + 1) * VGG_B],
                           yg[i * VGG_B:(i + 1) * VGG_B]))
    vgg_scores = [float(v) for v in log.scores]
    check(len(vgg_scores) == VGG_STEPS and np.isfinite(vgg_scores).all(),
          f"VGG-16 scores at batch {VGG_B}: {vgg_scores}")
    print(f"VGG-16 training at batch {VGG_B} (Nesterovs {VGG_LR} / 0.9, "
          f"seeded normal images on the card): scores {vgg_scores}")
    out["vgg16"] = {"output_err": vgg_out_err, "grad_gaps_worst": worst,
                    "score_err": vgg_score_err, "scores_b32": vgg_scores}

    # -- AlexNet served in process ---------------------------------------
    alex = [zoo.alexnet(CLASSES, IMAGE, device=dev).init(
        generator=torch.Generator().manual_seed(12))
        for dev in (DEVICE, "cpu")]
    check(alex[0].num_params() == ALEX_PARAMS, f"AlexNet has "
          f"{alex[0].num_params()} parameters, want {ALEX_PARAMS}")
    reg = pt.ModelRegistry(buckets=BUCKETS)
    v = reg.register("alexnet", alex[0])
    check(v.example_shape == (IMAGE, IMAGE, 3)
          and v.forwards == len(BUCKETS),
          f"AlexNet registered as {v.example_shape}, {v.forwards} warm-ups")
    r = np.random.default_rng(22)
    alex_err = 0.0
    for rows in (1, 5, 32):
        x = r.normal(size=(rows, IMAGE, IMAGE, 3)).astype(np.float32)
        got, version = reg.predict("alexnet", x)
        want = alex[1].output(x).numpy()
        check(got.shape == (rows, CLASSES) and np.isfinite(got).all()
              and np.abs(got.sum(-1) - 1).max() <= 1e-4,
              f"AlexNet {rows}-row output")
        alex_err = max(alex_err, float(np.abs(got - want).max()))
    check(alex_err <= SERVE_TOL, f"AlexNet served vs CPU: {alex_err} > "
          f"{SERVE_TOL}")
    print(f"AlexNet ({ALEX_PARAMS} parameters) registered and served in "
          f"process at buckets {BUCKETS} (1, 5 and 32 rows): max abs err vs "
          f"the CPU {alex_err:.3e} (limit {SERVE_TOL})")
    out["alexnet"] = {"serve_err": alex_err}
    c = counts()
    check(all(n == 0 for n in c.values()), f"the convolutional path "
          f"launched hand kernels: {c}")
    print(f"convolutional path: hand-kernel launches {c} (all 0); "
          f"{time.perf_counter() - t_phase:.1f} s so far")

    # -- times -------------------------------------------------------------
    def step_p50(net, ds, steps, warm=3):
        clock = StepLog(torch)
        net.set_listeners(clock)
        for _ in range(warm):
            net.fit(ds)
        clock.times.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            net.fit(ds)
        fit_s = time.perf_counter() - t0
        net.set_listeners()
        step_ms = 1e3 * np.diff([t0] + clock.times)
        return float(np.median(step_ms)), steps / fit_s

    r = np.random.default_rng(23)
    lenet = zoo.lenet_mnist(device=DEVICE).init(
        generator=torch.Generator().manual_seed(9))
    lb = pt.DataSet(torch.as_tensor(r.normal(size=(LENET_BENCH_B, 784))
                                    .astype(np.float32), device=DEVICE),
                    torch.as_tensor(np.eye(10, dtype=np.float32)[
                        r.integers(0, 10, LENET_BENCH_B)], device=DEVICE))
    p50, rate = step_p50(lenet, lb, 30)
    lenet_t = {"batch": LENET_BENCH_B, "step_p50_ms": p50,
               "samples_per_s": rate * LENET_BENCH_B}
    events, busy, wall = profile_device(
        torch, lambda: lenet.fit(lb),
        f"LeNet training step (batch {LENET_BENCH_B})", tag, reps=5)
    lenet_t.update(device_busy_ms=busy, profiled_wall_ms=wall,
                   idle_share=1 - busy / wall,
                   device_ms_by_kind=cnn_ms_by_kind(events))
    print(f"{tag} LeNet training (batch {LENET_BENCH_B}, seeded normal "
          f"inputs on the card): step p50 {p50:.3f} ms, "
          f"{lenet_t['samples_per_s']:.1f} samples/s; device busy "
          f"{busy:.3f} of {wall:.3f} ms (idle share {1 - busy / wall:.3f})")

    vb = pt.DataSet(xg[:VGG_B], yg[:VGG_B])
    p50, rate = step_p50(vgg, vb, 10, warm=1)
    fwd = forward_flops(vgg)
    step_flop = 3 * fwd * VGG_B
    bound = 1e3 * step_flop / F32_FLOP_PER_S
    vgg_t = {"batch": VGG_B, "step_p50_ms": p50,
             "images_per_s": rate * VGG_B,
             "forward_gflop_per_image": fwd / 1e9,
             "step_tflop": step_flop / 1e12, "bound_ms": bound,
             "share_of_f32_peak": bound / p50}
    events, busy, wall = profile_device(
        torch, lambda: vgg.fit(vb), f"VGG-16 training step (batch {VGG_B})",
        tag, reps=3)
    kinds = cnn_ms_by_kind(events)
    vgg_t.update(device_busy_ms=busy, profiled_wall_ms=wall,
                 idle_share=1 - busy / wall, device_ms_by_kind=kinds)
    print(f"{tag} VGG-16 training (batch {VGG_B}, f32, no TF32): step p50 "
          f"{p50:.3f} ms, {vgg_t['images_per_s']:.1f} images/s; forward "
          f"{fwd / 1e9:.2f} GFLOP an image, a step 3 x {fwd / 1e9:.2f} x "
          f"{VGG_B} = {step_flop / 1e12:.3f} TFLOP, bound {bound:.1f} ms at "
          f"{F32_FLOP_PER_S / 1e12:.0f} TFLOP/s: {100 * bound / p50:.1f} % "
          f"of the f32 peak; device busy {busy:.3f} of {wall:.3f} ms (idle "
          f"share {1 - busy / wall:.3f}; the kernels' sum can pass the wall "
          "where cuDNN overlaps them): " + ", ".join(
              f"{k} {ms:.3f} ms" for k, ms in kinds.items()))

    alex_t = {}
    for b in BUCKETS:
        x = r.normal(size=(b, IMAGE, IMAGE, 3)).astype(np.float32)
        times = []
        for _ in range(20):
            t0 = time.perf_counter()
            reg.predict("alexnet", x)
            times.append(time.perf_counter() - t0)
        alex_t[f"predict_p50_ms_b{b}"] = 1e3 * float(np.median(times))
    print(f"{tag} AlexNet registry.predict p50: " + ", ".join(
        f"bucket {b} {alex_t[f'predict_p50_ms_b{b}']:.3f} ms"
        for b in BUCKETS))
    c = counts()
    check(all(n == 0 for n in c.values()), f"the convolutional path's "
          f"timed runs launched hand kernels: {c}")
    out.update(lenet_times=lenet_t, vgg16_times=vgg_t, alexnet_times=alex_t,
               seconds=time.perf_counter() - t_phase)
    print(json.dumps({"cnn_path": out}))
    return out


def main():
    t_start = time.perf_counter()
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
    print(f"torch {torch.__version__} cuda {torch.version.cuda} cudnn "
          f"{torch.backends.cudnn.version()} device "
          f"{torch.cuda.get_device_name(0)}")
    kernels.library()
    print(f"kernel build: {kernels.build_seconds:.3f} s (nvcc, sm_90a)")

    # ---- 2. kernels vs plain on the card --------------------------------
    # the LSTM sequence kernels: each shape takes the variant its plan
    # picks (lstm.sequence_plan): "cluster" at the char-RNN's widths,
    # "streamed" past a cluster CTA's shared memory (H = 512, or a
    # 58,200-wide one-hot input)
    def variant_launched(kind, B, F, H, before):
        want = lstm.sequence_variant(B, F, H)
        after = lstm.variant_counts()[kind]
        check(after[want] == before[kind][want] + 1
              and sum(after.values()) == sum(before[kind].values()) + 1,
              f"LSTM {kind} B={B} F={F} H={H}: launched {after} after "
              f"{before[kind]}, want one {want} launch")
        return want

    lstm_err = {"cluster": 0.0, "streamed": 0.0}
    shapes = [(SEQ, b, f, HIDDEN) for b in BUCKETS for f in (VOCAB, HIDDEN)]
    shapes += [(1, 1, f, HIDDEN) for f in (VOCAB, HIDDEN)]
    shapes += STREAMED_SHAPES
    for T, B, F, H in shapes:
        args = lstm_inputs(torch, T, B, F, H, seed=T * 1000 + B * 10 + F)
        before = lstm.variant_counts()
        got = lstm.fused_lstm_sequence(*args, 1.0)
        want = lstm.lstm_sequence_reference(*args, 1.0)
        torch.cuda.synchronize()
        variant = variant_launched("fwd", B, F, H, before)
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        check(err <= LSTM_TOL, f"LSTM kernel ({variant}) T={T} B={B} F={F} "
              f"H={H}: max abs err {err} > {LSTM_TOL}")
        lstm_err[variant] = max(lstm_err[variant], err)
    print(f"LSTM kernel vs plain: {len(shapes)} shapes, max abs err "
          f"{lstm_err} (limit {LSTM_TOL})")

    # the training kernels: residual forward, adjoint, reduction
    res_err = {"cluster": 0.0, "streamed": 0.0}
    adj_err = {"cluster": [0.0, 0.0], "streamed": [0.0, 0.0]}
    red_err = red_rel = 0.0
    train_shapes = [(TRAIN_TBPTT, TRAIN_B, f, HIDDEN) for f in (VOCAB, HIDDEN)]
    train_shapes += [(SEQ, b, f, HIDDEN)                    # the buckets
                     for b, f in ((1, VOCAB), (8, HIDDEN), (32, VOCAB))]
    train_shapes += [(1, TRAIN_B, VOCAB, HIDDEN),          # one step
                     (TRAIN_TBPTT, 1, HIDDEN, HIDDEN),     # one row
                     (9, 3, 5, 37)]                        # a column tail
    train_shapes += STREAMED_SHAPES
    for T, B, F, H in train_shapes:
        args = lstm_inputs(torch, T, B, F, H, seed=T * 7 + B * 3 + F)
        x, W, b, peep, h0, c0 = args
        before = lstm.variant_counts()
        got = lstm.lstm_residual_forward(*args, 1.0)
        ref = lstm.lstm_sequence_reference(*args, 1.0, save_residuals=True)
        torch.cuda.synchronize()
        variant = variant_launched("residual", B, F, H, before)
        err = max((g - w).abs().max().item() for g, w in zip(
            got, (ref[0], ref[0][-1], ref[1][-1]) + ref[1:]))
        check(err <= LSTM_TOL, f"LSTM residual forward ({variant}) T={T} "
              f"B={B} F={F} H={H}: max abs err {err} > {LSTM_TOL}")
        res_err[variant] = max(res_err[variant], err)
        dhs, dhT, dcT = cotangents(torch, T, B, H, seed=F + H + T)
        want = lstm.lstm_sequence_backward_reference(
            x, W, peep, h0, c0, *ref, dhs, dhT, dcT)
        for need_dx in (False, True):
            before = lstm.variant_counts()
            got = lstm.lstm_sequence_backward(x, W, peep, h0, c0, *ref, dhs,
                                              dhT, dcT, need_dx=need_dx)
            torch.cuda.synchronize()
            variant_launched("adjoint", B, F, H, before)
            check((got[0] is None) == (not need_dx), "dx returned unasked")
            for name, g, w in zip(GRADS, got, want):
                if g is None:
                    continue
                rel = rel_err(g, w)
                check(rel <= BWD_TOL, f"LSTM backward ({variant}) {name} "
                      f"T={T} B={B} F={F} H={H} dx={need_dx}: max err / max "
                      f"|ref| {rel} > {BWD_TOL}")
                err = (g - w).abs().max().item()
                if name in ("dx", "dh0", "dc0"):
                    e = adj_err[variant]
                    e[0], e[1] = max(e[0], err), max(e[1], rel)
                else:
                    red_err, red_rel = max(red_err, err), max(red_rel, rel)
    print(f"LSTM training kernels vs plain: {len(train_shapes)} shapes, dx "
          f"asked and not; residual forward max abs err {res_err} (limit "
          f"{LSTM_TOL}); adjoint (dx, dh0, dc0) [max abs err, over max "
          f"|ref|] {adj_err}; reduction (dW, db, dpeep) max abs err "
          f"{red_err:.3e}, over max |ref| {red_rel:.3e} (limit {BWD_TOL})")

    # each variant of the sequence kernels: the same bits run to run (a
    # fixed summation order)
    for T, B, F, H in ((SEQ, 32, HIDDEN, HIDDEN),
                       (TRAIN_TBPTT, TRAIN_B, HIDDEN, HIDDEN),
                       STREAMED_SHAPES[0]):
        args = lstm_inputs(torch, T, B, F, H, seed=5)
        x, W, b, peep, h0, c0 = args
        dhs, dhT, dcT = cotangents(torch, T, B, H, seed=6)
        runs = []
        for _ in range(3):
            res = lstm.lstm_residual_forward(*args, 1.0)
            runs.append((lstm.fused_lstm_sequence(*args, 1.0), res,
                         lstm.lstm_adjoint(W, peep, c0, *res[3:], dhs, dhT,
                                           dcT, F)))
        for what, i in (("forward", 0), ("residual forward", 1),
                        ("adjoint", 2)):
            check(all(torch.equal(p, q) for r in runs[1:]
                      for p, q in zip(r[i], runs[0][i]) if p is not None),
                  f"LSTM {what} ({lstm.sequence_variant(B, F, H)}, B={B} "
                  f"F={F} H={H}) differs run to run")
        print(f"LSTM {lstm.sequence_variant(B, F, H)} forward, residual "
              f"forward and adjoint (T={T} B={B} F={F} H={H}): bit-equal "
              "over 3 runs")
    # the clusters of each char-RNN plan run side by side (one wave): the
    # card holds at least plan.groups of them at once, in both kernels
    max_active = kernels.library().dl4j_lstm_cluster_max_active
    held = {}
    for B in BUCKETS + (TRAIN_B,):
        for F in (VOCAB, HIDDEN):
            plan = lstm.sequence_plan(B, F, HIDDEN)
            held[(B, F)] = (plan.groups, min(
                max_active(F, HIDDEN, plan.units, plan.x_rows, plan.group,
                           adjoint) for adjoint in (0, 1)))
            check(held[(B, F)][1] >= plan.groups, f"LSTM plan B={B} F={F}: "
                  f"{plan.groups} clusters, the card holds "
                  f"{held[(B, F)][1]} at once")
    print("LSTM cluster plans, (B, F): (clusters, the card holds at once): "
          f"{held}")

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

    # the attention kernels in bf16 / f16, at head dimensions up to 512 and
    # at B * H = 65,536; each case's launches by variant are recorded
    typed_err, typed_variants = {}, {}
    for dt, B, T, S, H, Dh_, causal in TYPED_ATTN:
        dtype = getattr(torch, dt)
        q, k, v = (t.to(dtype) for t in attention_inputs(
            torch, B, T, S, H, Dh_, seed=T + S + Dh_))
        do = attention_inputs(torch, B, T, T, H, Dh_, seed=2 * T + Dh_)[0]
        do = do.to(dtype)
        what = f"{dt} B={B} T={T} S={S} H={H} Dh={Dh_} causal={causal}"
        attention.reset_launches()
        out = attention.flash_attention_heads(q, k, v, causal)
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
        errs = {}
        for name, got, want in (("o", out, want_o), ("o (lse)", o, want_o),
                                ("L", lse, want_lse), ("D", dsum, want_dsum),
                                ("dq", dq, want_dq), ("dk", dk, want_dk),
                                ("dv", dv, want_dv)):
            ok, err, rel = ulp_err(got, want, str(got.dtype)[6:],
                                   ATTN_GRAD_TOL)
            check(ok and got.dtype == want.dtype, f"attention {name} {what}: "
                  f"max abs err {err}, over max |ref| {rel} ({got.dtype} vs "
                  f"{want.dtype})")
            errs[name] = (err, rel)
        for key in (dt,) + tuple(
                f"{kind} {variant}" for kind, counts in
                attention.variant_counts().items()
                for variant, n in counts.items() if n):
            kind = key.split()[0]
            names = {"fwd": ("o",), "lse": ("o (lse)", "L"),
                     "dq": ("D", "dq"), "dkv": ("dk", "dv")}.get(kind, errs)
            e = typed_err.setdefault(key, [0.0, 0.0])
            e[0] = max([e[0]] + [errs[n][0] for n in names])
            e[1] = max([e[1]] + [errs[n][1] for n in names])
            if key != dt:
                typed_variants[tuple(key.split())] = \
                    typed_variants.get(tuple(key.split()), 0) + 1
    print(f"attention kernels in other dtypes, head dimensions and B * H vs "
          f"plain: {len(TYPED_ATTN)} cases (primal, logsumexp, dq, dk/dv; Dh "
          f"10 to 512, B * H up to 65,536); " + "; ".join(
              f"{k} max abs err {a:.3e}, over max |ref| {r:.3e}"
              for k, (a, r) in typed_err.items())
          + f" (limit {ATTN_GRAD_TOL} of max |ref| plus one ulp of the "
          "dtype)")
    for kind in ("dq", "dkv"):
        for variant in ("simt", "wgmma", "wide"):
            check(typed_variants.get((kind, variant)), f"no case reached the "
                  f"{variant} {kind} kernel")
    check(typed_variants.get(("lse", "wide")), "no case reached the wide "
          "forward")

    # each backward variant gives the same bits run to run (no atomics)
    for dt, B, T, H, Dh_ in (("float32", LM_TRAIN_B, LM_SEQ, LM_HEADS, 64),
                             ("bfloat16", LM_TRAIN_B, LM_SEQ, LM_HEADS, 64),
                             ("float32", 2, 70, 2, 320)):
        dtype = getattr(torch, dt)
        q, k, v, do = (t.to(dtype) for t in attention_inputs(
            torch, B, T, T, H, Dh_, seed=31) + attention_inputs(
                torch, B, T, T, H, Dh_, seed=32)[:1])
        o, lse = attention.attention_reference_heads_lse(q, k, v, True)
        attention.reset_launches()
        first = attention.flash_attention_bwd_heads(q, k, v, o, lse, do, True)
        variant = [n for n, c in attention.variant_counts()["dq"].items()
                   if c]
        for _ in range(2):
            again = attention.flash_attention_bwd_heads(q, k, v, o, lse, do,
                                                        True)
            check(all(torch.equal(a, b) for a, b in zip(first, again)),
                  f"attention backward ({variant}, {dt}, Dh {Dh_}) differs "
                  "run to run")
        print(f"attention backward {variant[0]} ({dt}, B={B} H={H} T={T} "
              f"Dh={Dh_}): bit-equal over 3 runs")

    # the reduction: the same bits run to run (a fixed summation order)
    args = lstm_inputs(torch, TRAIN_TBPTT, TRAIN_B, VOCAB, HIDDEN, seed=21)
    x, W, b, peep, h0, c0 = args
    hs, cs = lstm.lstm_sequence_reference(*args, 1.0,
                                          save_residuals=True)[:2]
    dgates = cotangents(torch, TRAIN_TBPTT, TRAIN_B, 4 * HIDDEN, seed=22)[0]
    first = lstm.lstm_param_grads(x, hs, h0, cs, c0, dgates)
    for _ in range(3):
        again = lstm.lstm_param_grads(x, hs, h0, cs, c0, dgates)
        check(all(torch.equal(a, c) for a, c in zip(first, again)),
              "the LSTM reduction differs run to run")
    print("LSTM reduction: bit-equal over 4 runs at the char-RNN's "
          "training shape")

    # the BN+ReLU forward and backward, each case through the variants
    # bn_plan picks (BN_STREAMED: past the resident slabs), unaligned views
    # through the one-element copies of both
    bn_max = {(k, v): [0.0, 0.0] for k in ("fwd", "bwd")
              for v in ("resident", "streamed")}
    bn_reached = set()
    bn_cases = [(N, C, dt, "") for N, C in BN_SHAPES
                for dt in ("bfloat16", "float16", "float32")]
    bn_cases.append((2 * 14 * 14, 64, "bfloat16", "NHWC"))
    bn_cases += [(N, C, dt, "") for N, C in BN_STREAMED
                 for dt in ("bfloat16", "float32")]
    bn_cases += [(2 * 21 * 7, 64, "bfloat16", "unaligned"),
                 (BN_STREAMED[1][0], 16, "bfloat16", "unaligned")]
    for N, C, dt, how in bn_cases:
        x, g, b, dy = bn_args(torch, N + (how == "unaligned"), C, dt,
                              seed=N + C)
        if how == "unaligned":   # a storage offset of 3 elements (6 bytes)
            x, dy = (t.reshape(-1)[3:3 + N * C].reshape(N, C)
                     for t in (x, dy))
        what = f"N={N} C={C} {dt} {how}".rstrip()
        before = bn_relu.variant_counts()
        if how == "NHWC":       # [2, 14, 14, C] through the layer's entry
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
        after = bn_relu.variant_counts()
        for key, pairs in (("fwd", ((y, want_y, dt), (mean, want_m, "float32"),
                                    (var, want_v, "float32"))),
                           ("bwd", ((dx, want_dx, dt),
                                    (dg, want_dg, "float32"),
                                    (db, want_db, "float32")))):
            variant = bn_relu.bn_plan(N, C, x.element_size(),
                                      key == "bwd").variant
            check(after[key][variant] == before[key][variant] + 1
                  and sum(after[key].values())
                  == sum(before[key].values()) + 1,
                  f"BN+ReLU {key} {what}: launches {after[key]}, want one "
                  f"{variant}")
            bn_reached.add((key, variant))
            for got, want, kind in pairs:
                ok, err, rel = ulp_err(got, want, kind)
                check(ok and got.dtype == want.dtype,
                      f"BN+ReLU {key} {variant} {what}: max abs err {err}, "
                      f"over max |ref| {rel} ({got.dtype} vs {want.dtype})")
                m = bn_max[(key, variant)]
                m[0], m[1] = max(m[0], err), max(m[1], rel)
    check(bn_reached == set(bn_max), f"phase 2 reached only the BN+ReLU "
          f"kernels {sorted(bn_reached)}")
    print(f"BN+ReLU kernels vs plain: {len(bn_cases)} cases; "
          + "; ".join(f"{k} {v} max abs err {a:.3e}, over max |ref| {r:.3e}"
                      for (k, v), (a, r) in bn_max.items())
          + f" (limit {BN_TOL} of max |ref| plus one ulp of x's dtype)")
    # each variant rerun bit-equal
    for N, C in ((4096, MLP_WIDTH), BN_STREAMED[1]):
        x, g, b, dy = bn_args(torch, N, C, "bfloat16", seed=3)
        runs = []
        for _ in range(4):
            out = bn_relu.bn_relu_forward(x, g, b)
            runs.append(out + bn_relu.bn_relu_backward(x, g, b, out[1],
                                                       out[2], dy))
        check(all(torch.equal(a, c) for run in runs[1:]
                  for a, c in zip(run, runs[0])),
              f"BN+ReLU N={N} C={C} differs run to run")
        print(f"BN+ReLU N={N} C={C} bf16 "
              f"({bn_relu.bn_plan(N, C, 2, False).variant} forward, "
              f"{bn_relu.bn_plan(N, C, 2, True).variant} backward): "
              "bit-equal over 4 runs")

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
    check(lstm.variant_counts()["fwd"] == {"cluster": serve_launches,
                                           "streamed": 0},
          f"char-RNN serving LSTM variants {lstm.variant_counts()['fwd']} "
          "(want cluster only)")
    print(f"char-RNN serving: {n_batched} batched requests in {flushes} "
          f"flushes + swap; {forwards} forwards, {serve_launches} LSTM "
          f"kernel launches {lstm.variant_counts()['fwd']}; max abs err vs "
          f"CPU {serve_err:.3e}")

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
    check(lstm.variant_counts()["fwd"] == {"cluster": lstm_launches,
                                           "streamed": 0},
          f"char-RNN serving and sampling LSTM variants "
          f"{lstm.variant_counts()['fwd']} (want cluster only)")
    check(attention.launches == 0,
          f"the char-RNN path launched attention {attention.launches} times")
    check_no_training_launches("char-RNN serving")
    print(f"sampling: {len(steps)} rnn_time_step calls, {sample_launches} "
          f"LSTM kernel launches (cluster), max abs err vs CPU "
          f"{sample_err:.3e}, text {text!r}")

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
    train_variants = lstm.variant_counts()
    steps = gpu_net.iteration_count
    check(steps == 2 * TRAIN_BATCHES, f"{steps} optimizer steps, want "
          f"{2 * TRAIN_BATCHES}")
    check(train_counts == {"launches": 0, "residual_launches": 2 * steps,
                           "adjoint_launches": 2 * steps,
                           "reduction_launches": 2 * steps},
          f"training launches {train_counts} for {steps} steps (want 2 "
          "residual forwards, 2 adjoints, 2 reductions and no primal "
          "forward per step)")
    check(train_variants == {
        "fwd": {"cluster": 0, "streamed": 0},
        "residual": {"cluster": 2 * steps, "streamed": 0},
        "adjoint": {"cluster": 2 * steps, "streamed": 0}},
          f"char-RNN training LSTM variants {train_variants} (want cluster "
          "only)")
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

    # the streamed variant on a path: the word-level GravesLSTM from one
    # zip, one forward and one training step on the card and the CPU
    check(lstm.sequence_variant(WORD_B, WORD_VOCAB, HIDDEN) == "streamed",
          "the word-level layer does not take the streamed variant")
    word_conf = (pt.NeuralNetConfiguration.builder().seed(5).list()
                 .layer(pt.GravesLSTM(n_out=HIDDEN))
                 .layer(pt.RnnOutputLayer(n_out=WORD_CLASSES,
                                          activation="softmax"))
                 .set_input_type(pt.InputType.recurrent(WORD_VOCAB, WORD_T))
                 .build())
    word_zip = os.path.join(tmp, "word_lstm.zip")
    pt.ModelSerializer.write_model(
        pt.MultiLayerNetwork(word_conf, device="cpu").init(), word_zip)
    word_nets = [pt.ModelSerializer.restore(word_zip),
                 pt.ModelSerializer.restore(word_zip, device="cpu")]
    r = np.random.default_rng(7)
    word_x = np.zeros((WORD_B, WORD_T, WORD_VOCAB), np.float32)
    word_x[np.arange(WORD_B)[:, None], np.arange(WORD_T)[None],
           r.integers(0, WORD_VOCAB, (WORD_B, WORD_T))] = 1.0
    word_y = np.eye(WORD_CLASSES, dtype=np.float32)[
        r.integers(0, WORD_CLASSES, (WORD_B, WORD_T))]
    word_ds = pt.DataSet(word_x, word_y)
    g_gpu, g_cpu = (first_chunk_grads(torch, n, word_ds, steps=None)
                    for n in word_nets)
    word_grad_err = max(rel_err(g_gpu[k], g_cpu[k]) for k in g_cpu)
    reset_counts()
    word_out = word_nets[0].output(word_x)
    word_nets[0].fit(word_ds)
    torch.cuda.synchronize()
    word_counts, word_variants = lstm.launch_counts(), lstm.variant_counts()
    check(word_counts == dict.fromkeys(word_counts, 1),
          f"word-level LSTM launches {word_counts} (want one of each)")
    check(all(v == {"cluster": 0, "streamed": 1}
              for v in word_variants.values()),
          f"word-level LSTM variants {word_variants} (want streamed only)")
    word_out_err = (word_out.cpu() - word_nets[1].output(word_x)).abs().max(
        ).item()
    word_nets[1].fit(word_ds)
    word_score_err = abs(word_nets[0].score() - word_nets[1].score())
    word_param_err = param_rel_l2(*word_nets)
    check(word_out_err <= SERVE_TOL and word_grad_err <= GRAD_TOL
          and word_score_err <= SCORE_TOL and word_param_err <= PARAM_TOL,
          f"word-level LSTM card vs CPU: output {word_out_err}, gradients "
          f"{word_grad_err}, score {word_score_err}, parameters "
          f"{word_param_err}")
    print(f"word-level GravesLSTM (one-hot {WORD_VOCAB}, H {HIDDEN}, B "
          f"{WORD_B}, T {WORD_T}): launches {word_counts}, variants "
          f"{word_variants}; card vs CPU: output max abs err "
          f"{word_out_err:.3e} (limit {SERVE_TOL}), gradients "
          f"{word_grad_err:.3e} of max (limit {GRAD_TOL}), score after one "
          f"step {word_score_err:.3e} (limit {SCORE_TOL}), parameters "
          f"relative L2 {word_param_err:.3e} (limit {PARAM_TOL})")

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
    lm_variants = attention.variant_counts()
    lm_steps = gpu_lm.iteration_count
    check(lm_steps == LM_STEPS, f"{lm_steps} LM optimizer steps, want "
          f"{LM_STEPS}")
    check(lm_counts == {"launches": 0, "lse_launches": LM_BLOCKS * lm_steps,
                        "dq_launches": LM_BLOCKS * lm_steps,
                        "dkv_launches": LM_BLOCKS * lm_steps},
          f"LM training launches {lm_counts} for {lm_steps} steps (want "
          f"{LM_BLOCKS} logsumexp forwards, dq and dk/dv per step and no "
          "primal forward)")
    for kind in ("dq", "dkv"):
        check(lm_variants[kind] == {"simt": LM_BLOCKS * lm_steps, "wgmma": 0,
                                    "wide": 0},
              f"f32 LM training {kind} launches by variant "
              f"{lm_variants[kind]} (want only simt)")
    check(set(lstm.launch_counts().values()) == {0},
          f"LM training launched LSTM kernels: {lstm.launch_counts()}")
    check_no_bn_launches("LM training")
    lm_scores = [float(v) for v in lm_log.scores]
    print(f"LM training: {lm_steps} steps of {LM_TRAIN_B} x {LM_SEQ} "
          f"tokens in {lm_fit_s:.2f} s on the card; launches {lm_counts}; "
          f"by variant dq {lm_variants['dq']}, dk/dv {lm_variants['dkv']}; "
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

    # the same LM and batches with nanoGPT's warm-up: card against CPU
    warm_zip = os.path.join(tmp, "lm_train_warm.zip")
    pt.ModelSerializer.write_model(
        make_lm(pt, torch, 5, pt.Adam(LM_LR, beta2=0.99),
                Distribution(kind="normal", std=0.02), warmup=True), warm_zip)
    warm_nets = [pt.ModelSerializer.restore(warm_zip),
                 pt.ModelSerializer.restore(warm_zip, device="cpu")]
    warm_logs = [StepLog(), StepLog()]
    for n, log in zip(warm_nets, warm_logs):
        n.set_listeners(log)
        n.fit(lm_batches(LM_STEPS * LM_CMP_B, LM_CMP_B))
    warm_scores = [[float(v) for v in log.scores] for log in warm_logs]
    lm_warm_err = float(np.abs(np.subtract(*warm_scores)).max())
    lm_warm_param = param_rel_l2(*warm_nets, skip=("b_k",))
    print(f"LM card vs CPU at batch {LM_CMP_B} with nanoGPT's warm-up "
          f"({LM_WARMUP} iterations): score {warm_scores[0][0]:.4f} -> "
          f"{warm_scores[0][-1]:.4f}; scores max abs err {lm_warm_err:.3e} "
          f"(limit {LM_WARM_SCORE_TOL}); final parameters relative L2 "
          f"{lm_warm_param:.3e} (limit {PARAM_TOL}); without the warm-up "
          f"{lm_score_err:.3e} (limit {LM_SCORE_TOL})")
    print(json.dumps({"lm_warm_scores_card": warm_scores[0],
                      "lm_warm_scores_cpu": warm_scores[1]}))
    check(lm_warm_err <= LM_WARM_SCORE_TOL, f"LM step scores with the "
          f"warm-up, card vs CPU: max abs err {lm_warm_err} > "
          f"{LM_WARM_SCORE_TOL}")
    check(lm_warm_param <= PARAM_TOL, f"LM parameters after {LM_STEPS} "
          f"warm-up steps: relative L2 {lm_warm_param} > {PARAM_TOL}")
    check_key_bias(warm_nets, LM_STEPS, "LM warm-up comparison")

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
    bn_variants = bn_relu.variant_counts()
    check(bn_variants == {k: {"resident": 2 * mlp_steps, "streamed": 0}
                          for k in ("fwd", "bwd")},
          f"BN-MLP training launches by variant {bn_variants} (want "
          "resident only)")
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
          f"the CPU; launches {bn_counts}, by variant {bn_variants}; score "
          f"{mlp_scores[0][0]:.4f} -> "
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

    def large_batch_step(zip_path, rows, pre_bn_biases, want, what):
        """One bf16 training step of the zip's network at `rows` rows of
        seeded random normal inputs with random labels (as
        deeplearning4j_tpu/models/zoo.py's benches make them), on the card
        and the CPU: the first step's gradients held against the CPU per
        tensor in relative L2 (BF16_GRAD_TOL, the pre-BN biases apart),
        then one `fit` step on the card; the BN launches by variant must be
        `want`. The largest entry's error over the largest entry is
        printed, not held, beside the same with the plain BN versions on
        the card: it is set by the few entries where a ReLU mask flips
        between two bf16 roundings of the GEMMs, through the kernels and
        the plain versions alike."""
        r = np.random.default_rng(0)
        batch = pt.DataSet(
            r.normal(size=(rows, 784)).astype(np.float32),
            np.eye(10, dtype=np.float32)[r.integers(0, 10, rows)])
        nets = [pt.ModelSerializer.restore(zip_path),
                pt.ModelSerializer.restore(zip_path, device="cpu")]
        reset_counts()
        grads = [first_chunk_grads(torch, n, batch, steps=None) for n in nets]
        nets[0].fit(batch)
        torch.cuda.synchronize()
        variants = bn_relu.variant_counts()
        check(variants == want, f"{what}: launches by variant {variants}, "
              f"want {want}")
        check(set(lstm.launch_counts().values()) == {0}
              and set(attention.launch_counts().values()) == {0},
              f"{what} launched LSTM or attention kernels")
        with plain_bn(bn_relu):
            plain = first_chunk_grads(torch, pt.ModelSerializer.restore(
                zip_path), batch, steps=None)
        keys = [k for k in grads[1] if k not in pre_bn_biases]
        l2 = {k: l2_err(grads[0][k], grads[1][k]) for k in keys}
        worst = {k: (rel_err(grads[0][k], grads[1][k]),
                     rel_err(plain[k], grads[1][k])) for k in keys}
        check(max(l2.values()) <= BF16_GRAD_TOL, f"{what}: first-step "
              f"gradients card vs CPU, relative L2 {l2} > {BF16_GRAD_TOL}")
        check(np.isfinite(nets[0].score()), f"{what}: step score")
        print(f"{what}: first-step gradients card vs CPU, relative L2 per "
              f"tensor at most {max(l2.values()):.3e} (limit "
              f"{BF16_GRAD_TOL}); largest entry's error over the largest "
              f"(printed: through the kernels / the plain BN on the card) "
              + ", ".join(f"{k} {a:.2e} / {b:.2e}"
                          for k, (a, b) in worst.items())
              + f"; one step, score {nets[0].score():.4f}; launches by "
              f"variant {variants}")
        return nets[0], batch, variants

    # the BN-MLP at batch 4096 (MLP_BIG_B): every BN launch resident
    big_net, big_batch, big_variants = large_batch_step(
        mlp_zip, MLP_BIG_B, ("0/b", "2/b"),
        {k: {"resident": 4, "streamed": 0} for k in ("fwd", "bwd")},
        f"BN-MLP at batch {MLP_BIG_B} (bf16)")

    # the narrow BN network at batch 65,536: both BN kernels streamed
    narrow_zip = os.path.join(tmp, "bn_narrow.zip")
    pt.ModelSerializer.write_model(pt.MultiLayerNetwork(
        pt.MultiLayerConfiguration.from_json(bn_narrow_json(pt)),
        device=DEVICE).init(generator=torch.Generator().manual_seed(7)),
        narrow_zip)
    _, _, narrow_variants = large_batch_step(
        narrow_zip, NARROW_B, ("0/b",),
        {k: {"resident": 0, "streamed": 2} for k in ("fwd", "bwd")},
        f"narrow BN network (784 -> {NARROW_C} -> BN(relu) -> 10, bf16) at "
        f"batch {NARROW_B}")

    # ---- 9. main path 6: the LM in bf16 compute --------------------------
    # the LM of phase 7 under compute_dtype("bfloat16") (float32 masters),
    # with nanoGPT's warm-up: every block's attention runs the bf16
    # instantiations of kernels 1-3
    bf16_zip = os.path.join(tmp, "lm_bf16.zip")
    pt.ModelSerializer.write_model(
        make_lm(pt, torch, 9, pt.Adam(LM_LR, beta2=0.99),
                Distribution(kind="normal", std=0.02),
                compute_dtype="bfloat16", warmup=True), bf16_zip)
    bf16_lm = pt.ModelSerializer.restore(bf16_zip)
    check(bf16_lm._compute_dtype == torch.bfloat16, "the bf16 LM computes "
          f"in {bf16_lm._compute_dtype}")

    # first-step gradients at batch LM_CMP_B, card against CPU
    first = lm_batches(LM_STEPS * LM_CMP_B, LM_CMP_B).next()
    bg = [first_chunk_grads(torch, n, first, steps=None) for n in
          (bf16_lm, pt.ModelSerializer.restore(bf16_zip, device="cpu"))]
    bf16_grad_err = max(rel_err(bg[0][k], bg[1][k]) for k in bg[1]
                        if not k.endswith("/b_k"))
    bf16_bk = max(g[f"{i}/b_k"].abs().max().item()
                  / g[f"{i}/W_k"].abs().max().item()
                  for g in bg for i in range(1, 1 + LM_BLOCKS))
    check(bf16_grad_err <= BF16_GRAD_TOL, f"bf16 LM first-step gradients: "
          f"max err / max |ref| {bf16_grad_err} > {BF16_GRAD_TOL}")
    check(bf16_bk <= BF16_GRAD_TOL, f"bf16 LM key-bias gradient {bf16_bk} "
          "of its W_k's largest entry: not 0 up to rounding")

    # 20 steps at batch 64 x 256, counted
    bf16_log = StepLog()
    bf16_lm.set_listeners(bf16_log)
    reset_counts()
    t0 = time.perf_counter()
    bf16_lm.fit(lm_batches(len(lm_x), LM_TRAIN_B))
    torch.cuda.synchronize()
    bf16_fit_s = time.perf_counter() - t0
    bf16_counts = attention.launch_counts()
    bf16_variants = attention.variant_counts()
    bf16_steps = bf16_lm.iteration_count
    check(bf16_steps == LM_STEPS, f"{bf16_steps} bf16 LM steps, want "
          f"{LM_STEPS}")
    check(bf16_counts == {"launches": 0,
                          "lse_launches": LM_BLOCKS * bf16_steps,
                          "dq_launches": LM_BLOCKS * bf16_steps,
                          "dkv_launches": LM_BLOCKS * bf16_steps},
          f"bf16 LM training launches {bf16_counts} for {bf16_steps} steps "
          f"(want {LM_BLOCKS} logsumexp forwards, dq and dk/dv per step)")
    for kind in ("dq", "dkv"):
        check(bf16_variants[kind] == {"simt": 0,
                                      "wgmma": LM_BLOCKS * bf16_steps,
                                      "wide": 0},
              f"bf16 LM training {kind} launches by variant "
              f"{bf16_variants[kind]} (want only wgmma)")
    check(set(lstm.launch_counts().values()) == {0},
          f"bf16 LM training launched LSTM kernels: {lstm.launch_counts()}")
    check_no_bn_launches("bf16 LM training")
    bf16_scores = [float(v) for v in bf16_log.scores]
    check(np.isfinite(bf16_scores).all()
          and bf16_scores[-1] < bf16_scores[0],
          f"bf16 LM training scores {bf16_scores}")
    check_key_bias([bf16_lm], bf16_steps, "bf16 LM training")
    for p in bf16_lm.params:
        check(all(t.dtype == torch.float32 for t in p.values()),
              "bf16 LM masters not float32")

    # card against CPU: 20 steps at batch LM_CMP_B from the same zip
    bf16_nets = [pt.ModelSerializer.restore(bf16_zip),
                 pt.ModelSerializer.restore(bf16_zip, device="cpu")]
    bf16_logs = [StepLog(), StepLog()]
    reset_counts()
    t0 = time.perf_counter()
    for n, log in zip(bf16_nets, bf16_logs):
        n.set_listeners(log)
        n.fit(lm_batches(LM_STEPS * LM_CMP_B, LM_CMP_B))
    bf16_cmp_s = time.perf_counter() - t0
    check(attention.launch_counts()["lse_launches"] == LM_BLOCKS * LM_STEPS,
          f"bf16 comparison run launches {attention.launch_counts()}")
    bf16_cmp = [[float(v) for v in log.scores] for log in bf16_logs]
    bf16_score_err = float(np.abs(np.subtract(*bf16_cmp)).max())
    bf16_param_err = adam_param_err(*bf16_nets, LM_LR, LM_STEPS)
    check_key_bias(bf16_nets, LM_STEPS, "bf16 LM comparison")

    # served: a bucket-32 forward of the trained network through the
    # primal kernel, against the same zip on the CPU
    bf16_trained = os.path.join(tmp, "lm_bf16_trained.zip")
    pt.ModelSerializer.write_model(bf16_lm, bf16_trained)
    served = pt.ModelSerializer.restore(bf16_trained)
    x_held = lm_x[-32:]
    reset_counts()
    with torch.inference_mode():
        out = served.output(x_held)
    torch.cuda.synchronize()
    bf16_serve_counts = attention.launch_counts()
    check(bf16_serve_counts == {"launches": LM_BLOCKS, "lse_launches": 0,
                                "dq_launches": 0, "dkv_launches": 0},
          f"bf16 LM forward launches {bf16_serve_counts} (want "
          f"{LM_BLOCKS} primal)")
    check_no_training_launches("bf16 LM serving")
    ref = pt.ModelSerializer.restore(bf16_trained, device="cpu").output(
        x_held)
    check(tuple(out.shape) == (32, LM_SEQ, LM_VOCAB)
          and torch.isfinite(out).all().item(), "bf16 LM served output "
          f"{tuple(out.shape)}")
    bf16_serve_err = (out.float().cpu() - ref.float()).abs().max().item()
    print(f"bf16 LM (compute_dtype bfloat16, float32 masters): {bf16_steps} "
          f"steps of {LM_TRAIN_B} x {LM_SEQ} tokens in {bf16_fit_s:.2f} s on "
          f"the card; launches {bf16_counts}; by variant dq "
          f"{bf16_variants['dq']}, dk/dv {bf16_variants['dkv']}; score "
          f"{bf16_scores[0]:.4f} -> "
          f"{bf16_scores[-1]:.4f}; card vs CPU: first-step gradients at "
          f"batch {LM_CMP_B} {bf16_grad_err:.3e} of max (limit "
          f"{BF16_GRAD_TOL}; key bias {bf16_bk:.3e} of its W_k's max), "
          f"{LM_STEPS}-step scores at batch {LM_CMP_B} max abs err "
          f"{bf16_score_err:.3e} (limit {BF16_SCORE_TOL}; {bf16_cmp_s:.1f} s "
          f"for both), final parameters {bf16_param_err:.3e} (limit "
          f"{BF16_PARAM_TOL}); the trained zip served at bucket 32: "
          f"{bf16_serve_counts['launches']} primal launches, max abs err vs "
          f"CPU {bf16_serve_err:.3e} (limit {BF16_SCORE_TOL})")
    print(json.dumps({"bf16_lm_scores_card": bf16_cmp[0],
                      "bf16_lm_scores_cpu": bf16_cmp[1],
                      "bf16_lm_scores_b64": bf16_scores}))
    check(bf16_score_err <= BF16_SCORE_TOL, f"bf16 LM scores card vs CPU: "
          f"max abs err {bf16_score_err} > {BF16_SCORE_TOL}")
    check(bf16_param_err <= BF16_PARAM_TOL, f"bf16 LM parameters after "
          f"{LM_STEPS} steps: {bf16_param_err} > {BF16_PARAM_TOL}")
    check(bf16_cmp[0][-1] < bf16_cmp[0][0], "the bf16 LM score did not fall "
          f"at batch {LM_CMP_B}: {bf16_cmp[0]}")
    check(bf16_serve_err <= BF16_SCORE_TOL, f"bf16 LM served vs CPU: max abs "
          f"err {bf16_serve_err} > {BF16_SCORE_TOL}")

    # the same 20 steps without the warm-up, through the kernels and
    # through the plain attention on the card, against the CPU: the LM's
    # own amplification of bf16 rounding, printed, not held
    nowarm_zip = os.path.join(tmp, "lm_bf16_nowarm.zip")
    pt.ModelSerializer.write_model(
        make_lm(pt, torch, 9, pt.Adam(LM_LR, beta2=0.99),
                Distribution(kind="normal", std=0.02),
                compute_dtype="bfloat16"), nowarm_zip)
    nowarm = {}
    for name, device, attend in (("cpu", "cpu", None), ("kernels", None, None),
                                 ("plain", None, lambda self, q, k, v, mask:
                                  attention.attention_reference_heads(
                                      q, k, v, self.causal))):
        if attend is not None:
            block._attend = attend
        try:
            n = pt.ModelSerializer.restore(
                nowarm_zip, **({} if device is None else {"device": device}))
            log = StepLog()
            n.set_listeners(log)
            n.fit(lm_batches(LM_STEPS * LM_CMP_B, LM_CMP_B))
        finally:
            block._attend = kernel_attend
        nowarm[name] = [float(v) for v in log.scores]
    nowarm_gap = {k: np.abs(np.subtract(nowarm[k], nowarm["cpu"]))
                  for k in ("kernels", "plain")}
    print("bf16 LM without the warm-up, card vs CPU at batch "
          f"{LM_CMP_B}: " + "; ".join(
              f"{k} max abs err {g.max():.3e} at step {int(g.argmax()) + 1} "
              f"(first 8 steps {g[:8].max():.3e})"
              for k, g in nowarm_gap.items())
          + f"; scores on the CPU {nowarm['cpu'][0]:.4f} -> "
          f"{nowarm['cpu'][-1]:.4f}, max {max(nowarm['cpu']):.4f}")
    print(json.dumps({"bf16_lm_nowarm_scores": nowarm}))

    # the wide-head LMs: one block at Dh = 256 (the tiled kernels' widest)
    # and at Dh = 512 (the wide kernels), one training step and one forward
    # on the card against the CPU, in float32 and in bf16 compute
    wide, wide_variants = {}, {}
    for width, cd in ((w, cd) for w in WIDE_WIDTHS
                      for cd in (None, "bfloat16")):
        limits = ((GRAD_TOL, SCORE_TOL, LM_SCORE_TOL) if cd is None
                  else (BF16_GRAD_TOL, BF16_SCORE_TOL, BF16_SCORE_TOL))
        wide_zip = os.path.join(tmp, f"lm_wide_{width}_{cd}.zip")
        pt.ModelSerializer.write_model(
            make_lm(pt, torch, 10, pt.Adam(LM_LR, beta2=0.99),
                    Distribution(kind="normal", std=0.02), compute_dtype=cd,
                    width=width, heads=WIDE_HEADS, blocks=1), wide_zip)
        nets = [pt.ModelSerializer.restore(wide_zip),
                pt.ModelSerializer.restore(wide_zip, device="cpu")]
        batch = pt.DataSet(lm_x[:4], lm_y[:4])
        g = [first_chunk_grads(torch, n, batch, steps=None) for n in nets]
        g_err = max(rel_err(g[0][k], g[1][k]) for k in g[1]
                    if not k.endswith("/b_k"))
        reset_counts()
        for n in nets:
            n.fit(batch)
        outs = [n.output(lm_x[4:8]) for n in nets]
        torch.cuda.synchronize()
        counts = attention.launch_counts()
        variants = attention.variant_counts()
        check(counts == {"launches": 1, "lse_launches": 1, "dq_launches": 1,
                         "dkv_launches": 1},
              f"wide-head LM ({cd or 'float32'}) launches {counts}")
        Dh_ = width // WIDE_HEADS
        want = ("wide" if Dh_ > attention.TILED_HEAD_DIM else
                "simt" if cd is None else "wgmma")
        check(variants["dq"][want] == variants["dkv"][want] == 1
              and (want == "wide") == (variants["lse"]["wide"] == 1),
              f"wide-head LM (Dh {Dh_}, {cd or 'float32'}) launches by "
              f"variant {variants} (want {want})")
        for kind, c in variants.items():
            for variant, n in c.items():
                wide_variants[(kind, variant)] = \
                    wide_variants.get((kind, variant), 0) + n
        s_err = abs(nets[0].score() - nets[1].score())
        o_err = (outs[0].float().cpu() - outs[1].float()).abs().max().item()
        wide[f"dh{Dh_}_{cd or 'float32'}"] = {"grad": g_err, "score": s_err,
                                              "output": o_err}
        print(f"wide-head LM (width {width}, {WIDE_HEADS} heads, Dh "
              f"{Dh_}, one block, {cd or 'float32'}): launches {counts}, "
              f"the backward by {want}; card vs CPU: first-step gradients "
              f"{g_err:.3e} of max (limit {limits[0]}), step score "
              f"{s_err:.3e} (limit {limits[1]}), next forward {o_err:.3e} "
              f"(limit {limits[2]})")
        check(g_err <= limits[0] and s_err <= limits[1]
              and o_err <= limits[2], f"wide-head LM ({cd or 'float32'}) "
              "card vs CPU beyond its limits")

    # ---- 10. times (counted launches end above) --------------------------
    # the LSTM sequence kernels: per launch and per step (ms / T of one
    # layer), the cluster variant at the char-RNN's shapes, the streamed one
    # at the word-level layer's
    kernel_ms = plain_ms = bound_ms = 0.0
    bound_by = set()
    fwd_per_step = {}
    for F in (VOCAB, HIDDEN):
        args = lstm_inputs(torch, SEQ, 32, F, HIDDEN, seed=F)
        k = cuda_ms(torch, lambda: lstm.fused_lstm_sequence(*args, 1.0))
        p = cuda_ms(torch, lambda: lstm.lstm_sequence_reference(*args, 1.0),
                    reps=5)
        b, by = lstm_bound_ms(SEQ, 32, F, HIDDEN)
        print(f"{tag} LSTM layer ({lstm.sequence_variant(32, F, HIDDEN)}) "
              f"B=32 T={SEQ} F={F} H={HIDDEN}: kernel {k:.4f} ms "
              f"({1e3 * k / SEQ:.3f} us a step), plain {p:.4f} ms, bound "
              f"{b:.6f} ms ({1e3 * b / SEQ:.4f} us a step, {by})")
        kernel_ms, plain_ms, bound_ms = kernel_ms + k, plain_ms + p, bound_ms + b
        bound_by.add(by)
        fwd_per_step[f"F={F}"] = k / SEQ
    # the primal and residual forwards side by side at each bucket and the
    # training batch (the plan's rows a cluster grow with B)
    for B in BUCKETS + (TRAIN_B,):
        for F in (VOCAB, HIDDEN):
            args = lstm_inputs(torch, SEQ, B, F, HIDDEN, seed=F)
            kp = cuda_ms(torch, lambda: lstm.fused_lstm_sequence(*args, 1.0))
            kr = cuda_ms(torch, lambda: lstm.lstm_residual_forward(*args,
                                                                   1.0))
            plan = lstm.sequence_plan(B, F, HIDDEN)
            print(f"{tag} LSTM forward ({plan.variant}, {plan.group} rows x "
                  f"{plan.groups} clusters) B={B} T={SEQ} F={F} H={HIDDEN}: "
                  f"primal {kp:.4f} ms ({1e3 * kp / SEQ:.3f} us a step), "
                  f"residual {kr:.4f} ms ({1e3 * kr / SEQ:.3f} us a step)")
    # the streamed variant at the word-level layer (no dx: a one-hot input)
    T, B, F, H = WORD_T, WORD_B, WORD_VOCAB, HIDDEN
    args = lstm_inputs(torch, T, B, F, H, seed=9)
    x, W, b, peep, h0, c0 = args
    res = lstm.lstm_residual_forward(*args, 1.0)
    ref = lstm.lstm_sequence_reference(*args, 1.0, save_residuals=True)
    dhs, dhT, dcT = cotangents(torch, T, B, H, seed=10)
    streamed_times = {}
    for kind, kern, plain, (bnd, by) in (
            ("fwd", lambda: lstm.fused_lstm_sequence(*args, 1.0),
             lambda: lstm.lstm_sequence_reference(*args, 1.0),
             lstm_bound_ms(T, B, F, H)),
            ("residual", lambda: lstm.lstm_residual_forward(*args, 1.0),
             lambda: lstm.lstm_sequence_reference(*args, 1.0,
                                                  save_residuals=True),
             residual_forward_bound_ms(T, B, F, H)),
            ("adjoint", lambda: lstm.lstm_adjoint(W, peep, c0, *res[3:], dhs,
                                                  dhT, dcT, F, False),
             lambda: lstm.lstm_adjoint_reference(W, peep, c0, *ref[1:], dhs,
                                                 dhT, dcT, F),
             adjoint_bound_ms(T, B, F, H, False))):
        k, p = cuda_ms(torch, kern), cuda_ms(torch, plain, reps=5)
        streamed_times[kind] = {"ms": k, "per_step_ms": k / T,
                                "plain_ms": p, "bound_ms": bnd,
                                "bound_by": by, "library_ms": None}
        print(f"{tag} LSTM {kind} (streamed) B={B} T={T} F={F} H={H}: "
              f"kernel {k:.4f} ms ({1e3 * k / T:.3f} us a step), plain "
              f"{p:.4f} ms, bound {bnd:.6f} ms ({by})")

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
    a_dev = device_ms(torch, lambda: attention.flash_attention_heads(
        q, k, v, True))
    a_lib_dev = device_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True))
    print(f"{tag} attention B=32 H={LM_HEADS} T=S={LM_SEQ} Dh={Dh} causal, "
          f"per launch: kernel {a_ms:.4f} ms ({a_dev:.4f} ms device), plain "
          f"{a_plain:.4f} ms, SDPA {a_lib:.4f} ms ({a_lib_dev:.4f} ms "
          f"device), bound {a_bound:.6f} ms ({a_by})")
    # the primal kernel at buckets 1 and 8 (the q-tile height it picks)
    for Bp in (1, 8):
        qb_, kb_, vb_ = attention_inputs(torch, Bp, LM_SEQ, LM_SEQ, LM_HEADS,
                                         Dh, seed=Bp)
        tb = [t.transpose(1, 2).contiguous() for t in (qb_, kb_, vb_)]
        print(f"{tag} attention B={Bp} H={LM_HEADS} T=S={LM_SEQ} Dh={Dh} "
              f"causal, per launch: kernel "
              f"{cuda_ms(torch, lambda: attention.flash_attention_heads(qb_, kb_, vb_, True)):.4f}"
              f" ms, SDPA {cuda_ms(torch, lambda: sdpa(*tb, is_causal=True)):.4f}"
              f" ms, bound "
              f"{attention_bound_ms(Bp, LM_SEQ, LM_SEQ, LM_HEADS, Dh, True)[0]:.6f}"
              " ms")

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
                          "library_ms": 0.0, "by": set(), "per_step_ms": {}}
                   for name in ("residual", "adjoint", "reduction")}
    red_extra = {"device_ms": 0.0, "library_device_ms": 0.0,
                 "same_work_ms": 0.0, "same_work_device_ms": 0.0}
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

        def same_work():
            """The reduction's whole function in PyTorch calls: [x | h]
            assembled, the dW product, db and dpeep."""
            c_prev = torch.cat([c0[None], cs[:-1]])
            zc = torch.cat([x, torch.cat([h0[None], hs[:-1]])], -1)
            dW = zc.reshape(T * B, F + H).T @ dg_2d
            return dW, dg_2d.sum(0), torch.cat([
                (dgates[..., :H] * c_prev).sum((0, 1)),
                (dgates[..., H:2 * H] * c_prev).sum((0, 1)),
                (dgates[..., 2 * H:3 * H] * cs).sum((0, 1))])
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
            if name == "reduction":
                extra = {"device_ms": device_ms(torch, kern),
                         "library_device_ms": device_ms(torch, lib),
                         "same_work_ms": cuda_ms(torch, same_work),
                         "same_work_device_ms": device_ms(torch, same_work)}
                print(f"{tag} LSTM reduction B={B} T={T} F={F} H={H}: device "
                      f"time kernel {extra['device_ms']:.4f} ms, "
                      f"torch.matmul {extra['library_device_ms']:.4f} ms; "
                      f"the same work in PyTorch (cat + matmul + db + "
                      f"dpeep) {extra['same_work_ms']:.4f} ms per call, "
                      f"{extra['same_work_device_ms']:.4f} ms device")
                for key, val in extra.items():
                    red_extra[key] += val
            print(f"{tag} LSTM {name} B={B} T={T} F={F} H={H}"
                  f"{'' if name != 'adjoint' else f' dx={need_dx}'}: kernel "
                  f"{k:.4f} ms ({1e3 * k / T:.3f} us a step), plain "
                  f"{p:.4f} ms, "
                  + ("" if l is None else f"torch.matmul {l:.4f} ms, ")
                  + f"bound {bnd:.6f} ms ({by})")
            e = train_times[name]
            e["per_step_ms"][f"F={F}"] = k / T
            e["ms"] += k
            e["plain_ms"] += p
            e["bound_ms"] += bnd
            e["library_ms"] = None if l is None else e["library_ms"] + l
            e["by"].add(by)
    training["kernel_ms_per_step"] = {n: e["ms"]
                                      for n, e in train_times.items()}
    training["reduction_per_step"] = dict(red_extra)
    print(f"{tag} LSTM reduction per TBPTT step (both layers): kernel "
          f"{train_times['reduction']['ms']:.4f} ms per call, "
          f"{red_extra['device_ms']:.4f} ms device; torch.matmul "
          f"{train_times['reduction']['library_ms']:.4f} / "
          f"{red_extra['library_device_ms']:.4f} ms; same work "
          f"{red_extra['same_work_ms']:.4f} / "
          f"{red_extra['same_work_device_ms']:.4f} ms; bound "
          f"{train_times['reduction']['bound_ms']:.6f} ms")
    print(json.dumps({"training": training}))

    def attn_times(dt, B, H, Dh_):
        """Per launch at [B, 256, H, Dh_] causal in dtype `dt`: {kernel:
        {ms, plain_ms, library_ms, bound_ms, bound_by, device_ms,
        library_device_ms, variant}} for the primal and logsumexp forwards
        (SDPA's forward beside them) and dq and dk/dv (SDPA's backward
        beside each, rerun on one saved graph: neither the forward nor the
        graph's build is in it). Per call: CUDA events around
        back-to-back calls; device: the kernels' own time (torch.profiler).
        The bound is in the working dtype."""
        T = LM_SEQ
        dtype = getattr(torch, dt)
        q, k, v = (t.to(dtype) for t in attention_inputs(
            torch, B, T, T, H, Dh_, seed=Dh_))
        do = attention_inputs(torch, B, T, T, H, Dh_, seed=Dh_ + 1)[0]
        do = do.to(dtype)
        o, lse = attention.flash_attention_fwd_lse_heads(q, k, v, True)
        dsum = attention.attention_bwd_dq(q, k, v, o, lse, do, True)[1]
        qt, kt, vt, dot = (t.transpose(1, 2).contiguous().requires_grad_()
                           for t in (q, k, v, do))
        fwd = lambda: sdpa(qt, kt, vt, is_causal=True)
        # SDPA's backward alone on one saved graph: its fused backward node
        # called directly (the aten backward op, without autograd's engine),
        # or, where SDPA ran its unfused math path, autograd's backward
        graph = fwd()
        node = graph.grad_fn
        if "ScaledDotProduct" in type(node).__name__:
            lib_call = type(node).__name__
            bwd = lambda: node(dot)
        else:
            lib_call = "autograd.grad of the math path"
            bwd = lambda: torch.autograd.grad(graph, (qt, kt, vt), dot,
                                              retain_graph=True)
        f, lib_b = cuda_ms(torch, fwd), cuda_ms(torch, bwd)
        f_dev, lib_b_dev = device_ms(torch, fwd), device_ms(torch, bwd)
        size = dtype.itemsize
        rows = {
            "primal": (lambda: attention.flash_attention_heads(q, k, v, True),
                       lambda: attention.attention_reference_heads(q, k, v,
                                                                   True),
                       f, f_dev,
                       attention_bound_ms(B, T, T, H, Dh_, True, size)),
            "lse": (lambda: attention.flash_attention_fwd_lse_heads(
                        q, k, v, True),
                    lambda: attention.attention_reference_heads_lse(
                        q, k, v, True),
                    f, f_dev, lse_bound_ms(B, T, T, H, Dh_, True, size)),
            "dq": (lambda: attention.attention_bwd_dq(q, k, v, o, lse, do,
                                                      True),
                   lambda: attention.attention_bwd_dq_reference(
                       q, k, v, o, lse, do, True),
                   lib_b, lib_b_dev,
                   dq_bound_ms(B, T, T, H, Dh_, True, size)),
            "dkv": (lambda: attention.attention_bwd_dkv(q, k, v, do, lse,
                                                        dsum, True),
                    lambda: attention.attention_bwd_dkv_reference(
                        q, k, v, do, lse, dsum, True),
                    lib_b, lib_b_dev,
                    dkv_bound_ms(B, T, T, H, Dh_, True, size))}
        out = {}
        for name, (kern, plain, lib, lib_dev, (bnd, by)) in rows.items():
            attention.reset_launches()
            kern()
            kind = "fwd" if name == "primal" else name
            variant = [n for n, c in attention.variant_counts()[kind].items()
                       if c][0]
            out[name] = {"ms": cuda_ms(torch, kern),
                         "plain_ms": cuda_ms(torch, plain, reps=5),
                         "library_ms": lib, "bound_ms": bnd,
                         "bound_by": by, "device_ms": device_ms(torch, kern),
                         "library_device_ms": lib_dev, "variant": variant,
                         "library_call": (lib_call if name in ("dq", "dkv")
                                          else "scaled_dot_product_attention")}
            r = out[name]
            print(f"{tag} attention {name} ({variant}) {dt} B={B} H={H} "
                  f"T=S={T} Dh={Dh_} causal, per launch: kernel "
                  f"{r['ms']:.4f} ms (device {r['device_ms']:.4f}), plain "
                  f"{r['plain_ms']:.4f} ms, SDPA "
                  f"{'forward' if name in ('primal', 'lse') else 'backward'}"
                  f" {lib:.4f} ms (device {lib_dev:.4f}), bound "
                  f"{bnd:.6f} ms ({by})")
        pair, pair_dev = (out["dq"][k] + out["dkv"][k]
                          for k in ("ms", "device_ms"))
        print(f"{tag} attention backward pair dq + dk/dv {dt} B={B} H={H} "
              f"Dh={Dh_}: {pair:.4f} ms per call, {pair_dev:.4f} ms device; "
              f"SDPA backward ({lib_call}) {lib_b:.4f} ms, device "
              f"{lib_b_dev:.4f} "
              f"ms; bound {out['dq']['bound_ms'] + out['dkv']['bound_ms']:.6f}"
              " ms")
        return out

    # the attention kernels per launch at the LM's training shape (B = 64)
    # in f32 and bf16, the primal forward also at the serving bucket 32, and
    # at Dh = 256 and 512 (B = 8, 2 heads), SDPA as the yardstick
    H = LM_HEADS
    attn_f32 = attn_times("float32", LM_TRAIN_B, H, Dh)
    attn_bf16 = {"b32": attn_times("bfloat16", 32, H, Dh),
                 "b64": attn_times("bfloat16", LM_TRAIN_B, H, Dh)}
    attn_wide = {(Dh_, dt): attn_times(dt, 8, WIDE_HEADS, Dh_)
                 for Dh_ in (256, 512) for dt in ("float32", "bfloat16")}
    for Bp in (32, LM_TRAIN_B):
        qp, kp, vp = attention_inputs(torch, Bp, LM_SEQ, LM_SEQ, H, Dh,
                                      seed=Bp)
        kp_ms = cuda_ms(torch, lambda: attention.flash_attention_heads(
            qp, kp, vp, True))
        kl_ms = cuda_ms(torch, lambda: attention.flash_attention_fwd_lse_heads(
            qp, kp, vp, True))
        print(f"{tag} attention forward B={Bp} H={H} T=S={LM_SEQ} Dh={Dh}: "
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
            attn_f32[n]["ms"] for n in ("lse", "dq", "dkv"))})
    print(f"{tag} LM training (B={LM_TRAIN_B}, T={LM_SEQ}, {n_params} "
          f"parameters): step p50 {lm_training['step_p50_ms']:.3f} ms over "
          f"{len(step_ms)} steps, {lm_training['tokens_per_s']:.1f} tokens/s; "
          f"one step's device time: "
          + ", ".join(f"{k} {ms:.3f} ms" for k, ms in kinds.items())
          + f" of {wall:.3f} ms wall (idle share {1 - busy / wall:.3f})")
    print(json.dumps({"lm_training": lm_training}))
    # one bf16 LM step's device time by kind (the trained bf16 network)
    events, busy, wall = profile_device(
        torch, lambda: bf16_lm.fit(batch), "bf16 LM training step (batch "
        "64)", tag, reps=3)
    bf16_kinds = {"gemm": 0.0, "attention": 0.0, "copies": 0.0, "other": 0.0}
    for key, ms, _ in events:
        low = key.lower()
        kind = ("attention" if "flash_" in low else
                "gemm" if "gemm" in low else
                "copies" if "memcpy" in low or "memset" in low else "other")
        bf16_kinds[kind] += ms
    print(f"{tag} bf16 LM training step (B={LM_TRAIN_B}, T={LM_SEQ}) device "
          f"time: " + ", ".join(f"{k} {ms:.3f} ms"
                                for k, ms in bf16_kinds.items())
          + f" of {wall:.3f} ms wall (idle share {1 - busy / wall:.3f}); "
          f"attention kernels per step by call {LM_BLOCKS * sum(attn_bf16['b64'][n]['ms'] for n in ('lse', 'dq', 'dkv')):.3f} ms")
    bf16_training = {"card": card, "steps": bf16_steps,
                     "profiled_ms_per_step_by_kind": bf16_kinds,
                     "profiled_device_busy_ms_per_step": busy,
                     "profiled_wall_ms_per_step": wall,
                     "fit_s": bf16_fit_s,
                     "tokens_per_s_incl_first_step":
                         bf16_steps * LM_TRAIN_B * LM_SEQ / bf16_fit_s,
                     "card_vs_cpu": {"grad": bf16_grad_err,
                                     "score": bf16_score_err,
                                     "param": bf16_param_err,
                                     "served": bf16_serve_err},
                     "wide_head": wide,
                     "card_vs_cpu_without_warmup": {
                         k: float(g.max()) for k, g in nowarm_gap.items()}}
    print(f"{tag} bf16 LM training (B={LM_TRAIN_B}, T={LM_SEQ}): "
          f"{bf16_steps} steps in {bf16_fit_s:.3f} s, first step included, "
          f"{bf16_training['tokens_per_s_incl_first_step']:.1f} tokens/s")
    print(json.dumps({"bf16_lm_training": bf16_training}))

    # BN-MLP training: step p50 and samples/s, before the BN kernels'
    # profiles below
    def time_mlp_steps():
        """Step p50 (ms) and samples/s of the BN-MLP over MLP_EPOCHS - 1
        epochs after a warm-up epoch."""
        net = pt.ModelSerializer.restore(mlp_zip)
        clock = StepLog(torch)
        net.set_listeners(clock)
        source = mlp_batches(x_tr, y_tr)
        net.fit(source)                         # warm-up epoch, 2 steps
        clock.times.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(source, epochs=MLP_EPOCHS - 1)
        fit_s = time.perf_counter() - t0
        step_ms = 1e3 * np.diff([t0] + clock.times)
        timed_nets.append(net)
        return float(np.median(step_ms)), len(step_ms) * MLP_B / fit_s

    timed_nets = []
    p50, rate = time_mlp_steps()
    bn_mlp = {"card": card, "steps_timed": (MLP_EPOCHS - 1) * 2,
              "step_p50_ms": p50, "samples_per_s": rate}
    timed_mlp = timed_nets[0]
    timed_mlp.set_listeners()

    # the BN+ReLU kernels at N in {MLP_B, 4096} x C in {1024, 200, 48},
    # bf16: the wrapper (the variant bn_plan picks), each variant's entry
    # point called bare on pre-made outputs (so the plan's choice hides
    # neither), the plain versions and the library call (F.batch_norm in
    # training mode + relu, bf16 input with float32 weight and bias; its
    # backward through autograd, rerun on one saved graph), timed here as
    # the yardstick only; each per call (CUDA events around back-to-back
    # calls) and in device time (torch.profiler): at N = 128 a call is
    # microseconds of device work behind the host's launch path
    fn = torch.nn.functional
    bn_times = {}
    for N in (MLP_B, 4096):
        for C in (MLP_WIDTH, 200, 48):
            x, g, b, dy = bn_args(torch, N, C, "bfloat16", seed=N + C)
            _, mean, var = bn_relu.bn_relu_forward(x, g, b)
            xl, gl, bl = (t.clone().requires_grad_() for t in (x, g, b))
            lib_fwd = lambda: fn.relu(fn.batch_norm(xl, None, None, gl, bl,
                                                    training=True))
            graph = lib_fwd()   # the backward alone, on one saved graph
            lib_grad = lambda: torch.autograd.grad(graph, (xl, gl, bl), dy,
                                                   retain_graph=True)
            for kind, wrapper, plain, lib, (bnd, by) in (
                    ("fwd", lambda: bn_relu.bn_relu_forward(x, g, b),
                     lambda: bn_relu.bn_relu_reference(x, g, b), lib_fwd,
                     bn_fwd_bound_ms(N, C, 2)),
                    ("bwd",
                     lambda: bn_relu.bn_relu_backward(x, g, b, mean, var, dy),
                     lambda: bn_relu.bn_relu_backward_reference(
                         x, g, b, mean, var, dy), lib_grad,
                     bn_bwd_bound_ms(N, C, 2))):
                row = {"variant": bn_relu.bn_plan(N, C, 2,
                                                  kind == "bwd").variant,
                       "bound_ms": bnd, "bound_by": by,
                       "ms": cuda_ms(torch, wrapper),
                       "device_ms": device_ms(torch, wrapper),
                       "plain_ms": cuda_ms(torch, plain),
                       "plain_device_ms": device_ms(torch, plain),
                       "library_ms": cuda_ms(torch, lib),
                       "library_device_ms": device_ms(torch, lib)}
                want = plain()
                for variant in ("resident", "streamed"):
                    call, outs = bn_bare_call(torch, bn_relu, kind, variant,
                                              x, g, b, mean, var, dy)
                    check(call() == 0, f"BN+ReLU {kind} {variant} entry "
                          f"point failed at N={N} C={C}")
                    torch.cuda.synchronize()
                    for got, ref, dt in zip(outs, want, ("bfloat16",
                                                         "float32",
                                                         "float32")):
                        check(ulp_err(got, ref, dt)[0], f"BN+ReLU {kind} "
                              f"{variant} entry point at N={N} C={C} "
                              "disagrees with plain")
                    row[variant] = {"ms": cuda_ms(torch, call),
                                    "device_ms": device_ms(torch, call)}
                if (N, C) == (MLP_B, MLP_WIDTH):
                    # a call's host path in three parts: the entry point
                    # alone (above), the wrapper, the autograd Function
                    if kind == "fwd":
                        func = lambda: bn_relu.fused_bn_relu(xl, gl, bl)
                    else:
                        saved = bn_relu.fused_bn_relu(xl, gl, bl)[0]
                        func = lambda: torch.autograd.grad(
                            saved, (xl, gl, bl), dy, retain_graph=True)
                    row["function_ms"] = cuda_ms(torch, func)
                bn_times[(kind, N, C)] = row
                print(f"{tag} BN+ReLU {kind} N={N} C={C} bf16 "
                      f"({row['variant']}), per call: wrapper "
                      f"{row['ms']:.4f} ms, entry point "
                      f"resident {row['resident']['ms']:.4f} / streamed "
                      f"{row['streamed']['ms']:.4f}, plain "
                      f"{row['plain_ms']:.4f}, library "
                      f"{row['library_ms']:.4f}; device time: wrapper "
                      f"{row['device_ms']:.4f} ms, resident "
                      f"{row['resident']['device_ms']:.4f}, streamed "
                      f"{row['streamed']['device_ms']:.4f}, plain "
                      f"{row['plain_device_ms']:.4f}, library "
                      f"{row['library_device_ms']:.4f}; bound {bnd:.6f} ms "
                      f"({by})")
    for kind in ("fwd", "bwd"):
        row = bn_times[(kind, MLP_B, MLP_WIDTH)]
        print(f"{tag} BN+ReLU {kind} N={MLP_B} C={MLP_WIDTH}, a call's host "
              f"path: entry point alone {row['resident']['ms']:.4f} ms, the "
              f"wrapper {row['ms']:.4f}, through the autograd Function "
              f"{row['function_ms']:.4f} (device {row['device_ms']:.4f})")
    # the streamed kernels at their main path's shape (the narrow network)
    x, g, b, dy = bn_args(torch, NARROW_B, NARROW_C, "bfloat16", seed=11)
    _, mean, var = bn_relu.bn_relu_forward(x, g, b)
    for kind, wrapper, plain, (bnd, by) in (
            ("fwd", lambda: bn_relu.bn_relu_forward(x, g, b),
             lambda: bn_relu.bn_relu_reference(x, g, b),
             bn_fwd_bound_ms(NARROW_B, NARROW_C, 2)),
            ("bwd", lambda: bn_relu.bn_relu_backward(x, g, b, mean, var, dy),
             lambda: bn_relu.bn_relu_backward_reference(x, g, b, mean, var,
                                                        dy),
             bn_bwd_bound_ms(NARROW_B, NARROW_C, 2))):
        check(bn_relu.bn_plan(NARROW_B, NARROW_C, 2,
                              kind == "bwd").variant == "streamed",
              "the narrow shape does not take the streamed kernels")
        xl, gl, bl = (t.clone().requires_grad_() for t in (x, g, b))
        graph = fn.relu(fn.batch_norm(xl, None, None, gl, bl, training=True))
        lib = ((lambda: fn.relu(fn.batch_norm(xl, None, None, gl, bl,
                                              training=True)))
               if kind == "fwd" else
               (lambda: torch.autograd.grad(graph, (xl, gl, bl), dy,
                                            retain_graph=True)))
        row = {"variant": "streamed", "bound_ms": bnd, "bound_by": by,
               "ms": cuda_ms(torch, wrapper),
               "device_ms": device_ms(torch, wrapper),
               "plain_ms": cuda_ms(torch, plain),
               "plain_device_ms": device_ms(torch, plain),
               "library_ms": cuda_ms(torch, lib),
               "library_device_ms": device_ms(torch, lib)}
        bn_times[(kind, NARROW_B, NARROW_C)] = row
        print(f"{tag} BN+ReLU {kind} N={NARROW_B} C={NARROW_C} bf16 "
              f"(streamed), per call {row['ms']:.4f} ms, device "
              f"{row['device_ms']:.4f}; plain {row['plain_ms']:.4f} "
              f"(device {row['plain_device_ms']:.4f}); library "
              f"{row['library_ms']:.4f} (device "
              f"{row['library_device_ms']:.4f}); bound {bnd:.6f} ms ({by})")

    # BN-MLP training: step p50 again after the BN kernels' profiles (two
    # readings of one run show the spread of the host's clock, which the
    # host-bound step follows), then one step's device time by kind
    bn_mlp["step_p50_ms_after_kernel_profiles"] = time_mlp_steps()[0]
    print(f"{tag} BN-MLP training step p50 after the BN kernels' profiles: "
          f"{bn_mlp['step_p50_ms_after_kernel_profiles']:.3f} ms")
    batch = pt.DataSet(x_tr[:MLP_B], y_tr[:MLP_B])
    events, busy, wall = profile_device(
        torch, lambda: timed_mlp.fit(batch),
        f"BN-MLP training step (batch {MLP_B}, bf16)", tag, reps=5)
    kinds = device_ms_by_kind(events)
    big_events, big_busy, big_wall = profile_device(
        torch, lambda: big_net.fit(big_batch),
        f"BN-MLP training step (batch {MLP_BIG_B}, bf16)", tag, reps=5)
    big_kinds = device_ms_by_kind(big_events)
    print(f"{tag} BN-MLP training step at batch {MLP_BIG_B}: device time "
          + ", ".join(f"{k} {ms:.4f} ms" for k, ms in big_kinds.items())
          + f" of {big_wall:.3f} ms wall (idle share "
          f"{1 - big_busy / big_wall:.3f})")
    bn_mlp.update({
        "batch_4096": {"profiled_wall_ms_per_step": big_wall,
                       "profiled_device_busy_ms_per_step": big_busy,
                       "profiled_idle_share": 1 - big_busy / big_wall,
                       "profiled_ms_per_step_by_kind": big_kinds}})
    bn_mlp.update({
        "profiled_wall_ms_per_step": wall,
        "profiled_device_busy_ms_per_step": busy,
        "profiled_idle_share": 1 - busy / wall,
        "profiled_ms_per_step_by_kind": kinds,
        "accuracy_held_out_card": evs[0].accuracy(),
        "accuracy_held_out_cpu": evs[1].accuracy()})
    print(f"{tag} BN-MLP training (batch {MLP_B}, bf16 compute): step p50 "
          f"{bn_mlp['step_p50_ms']:.3f} ms over {bn_mlp['steps_timed']} "
          f"steps, "
          f"{bn_mlp['samples_per_s']:.1f} samples/s; one step's device "
          f"time: " + ", ".join(f"{k} {ms:.3f} ms" for k, ms in kinds.items())
          + f" of {wall:.3f} ms wall (idle share {1 - busy / wall:.3f})")
    print(json.dumps({"bn_mlp_training": bn_mlp}))

    # ---- 11. main path 7: the convolutional path -----------------------
    cnn_path(pt, torch, tag, tmp, reset_counts, lambda: {
        f"{mod.__name__.rsplit('.', 1)[-1]}/{k}": n
        for mod in (lstm, attention, bn_relu)
        for k, n in mod.launch_counts().items()})
    print(f"{tag} chip_smoke run: {time.perf_counter() - t_start:.1f} s "
          "(kernel build included)")

    launches = {"resident": bn_variants, "streamed": narrow_variants}
    launches = {v: {k: c[k][v] for k in ("fwd", "bwd")}
                for v, c in launches.items()}

    def bn_timing(r):
        """The timing keys of one `bn_times` row (each variant's entry
        point alone beside the wrapper where it was timed)."""
        keys = ("variant", "ms", "device_ms", "plain_ms", "plain_device_ms",
                "library_ms", "library_device_ms", "bound_ms", "bound_by",
                "resident", "streamed", "function_ms")
        return {k: r[k] for k in keys if k in r}

    def timing(r):
        """The timing keys of one `attn_times` row."""
        return {k: r[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                  "bound_by", "device_ms",
                                  "library_device_ms")}

    def typed_entry(key, launches):
        """A tiled forward's bf16 numbers (the LM's shapes: B=32 for the
        primal, B=64 for the logsumexp mode; launches from main path 6) and
        its Dh = 256 numbers (B=8, 2 heads) in float32 and bf16."""
        b = attn_bf16["b32" if key == "primal" else "b64"][key]
        entry = {"launches": launches,
                 "max_abs_err": typed_err["bfloat16"][0], **timing(b)}
        for dt in ("float32", "bfloat16"):
            entry[f"dh256_{dt}"] = timing(attn_wide[(256, dt)][key])
        return entry

    red_json = {"device_ms": red_extra["device_ms"],
                "library_device_ms": red_extra["library_device_ms"],
                "same_work_ms": red_extra["same_work_ms"],
                "same_work_device_ms": red_extra["same_work_device_ms"],
                "same_work": "torch.cat of [x | h_{t-1}] + torch.matmul + "
                             "the db and dpeep sums"}
    lstm_replaces = {
        "fwd": "deeplearning4j_tpu/kernels/lstm.py:57 (_fwd_kernel via "
               "_fwd_impl :121, fused_lstm_sequence :252)",
        "residual": "deeplearning4j_tpu/kernels/lstm.py:57 (_fwd_kernel via "
                    "_fwd_impl :121, save_residuals=True, for _vjp_fwd :265)",
        "adjoint": "deeplearning4j_tpu/kernels/lstm.py:137 (_bwd_kernel's "
                   "per-step chain via _bwd_impl :219, for _vjp_bwd :273)"}
    no_library = ("none: cuDNN's LSTM behind torch.nn.LSTM has no peepholes "
                  "and no forget offset")
    streamed_err = {"fwd": lstm_err["streamed"],
                    "residual": res_err["streamed"],
                    "adjoint": adj_err["streamed"][0]}
    print(json.dumps({"kernels": [{
        "name": "fused_lstm_sequence",
        "route": "cuda",
        "source": "deeplearning4j_tpu_torch/kernels/csrc/lstm_cluster.cu",
        "replaces": lstm_replaces["fwd"],
        "variant": "cluster",
        "launches": lstm_launches,
        "max_abs_err": lstm_err["cluster"],
        "per_step_ms": fwd_per_step,
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
        "device_ms": a_dev,
        "library_device_ms": a_lib_dev,
        "bf16": typed_entry("primal", bf16_serve_counts["launches"]),
        "card": card,
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "deeplearning4j_tpu_torch/kernels/csrc/"
                  + ("lstm.cu" if key == "reduction" else "lstm_cluster.cu"),
        "replaces": replaces,
        **({} if key == "reduction" else {
            "variant": "cluster",
            "per_step_ms": train_times[key]["per_step_ms"]}),
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
        **(red_json if key == "reduction" else {}),
        "card": card,
    } for name, key, counter, err, rel, replaces, library in (
        ("lstm_residual_forward", "residual", "residual_launches",
         res_err["cluster"], None, lstm_replaces["residual"], no_library),
        ("lstm_adjoint", "adjoint", "adjoint_launches",
         adj_err["cluster"][0], adj_err["cluster"][1],
         lstm_replaces["adjoint"], no_library),
        ("lstm_param_grads", "reduction", "reduction_launches", red_err,
         red_rel,
         "deeplearning4j_tpu/kernels/lstm.py:137 (_bwd_kernel's dW, db and "
         "dpeep accumulation :179-186 via _bwd_impl :219)",
         "torch.matmul of the [F+H, T*B] x [T*B, 4H] product (dW only)"))]
        + [{
            "name": f"{name}_streamed",
            "route": "cuda",
            "source": "deeplearning4j_tpu_torch/kernels/csrc/lstm.cu",
            "replaces": lstm_replaces[kind],
            "variant": "streamed",
            "launches": word_variants[kind]["streamed"],
            "max_abs_err": streamed_err[kind],
            "per": f"one launch at the word-level layer (T={WORD_T}, "
                   f"B={WORD_B}, F={WORD_VOCAB}, H={HIDDEN}"
                   + (", no dx)" if kind == "adjoint" else ")"),
            **streamed_times[kind],
            "library": no_library,
            "card": card,
        } for name, kind in (("fused_lstm_sequence", "fwd"),
                             ("lstm_residual_forward", "residual"),
                             ("lstm_adjoint", "adjoint"))]
        + [{
            "name": "flash_attention_fwd_lse_heads",
            "route": "cuda",
            "source": "deeplearning4j_tpu_torch/kernels/csrc/attention.cu",
            "replaces": "deeplearning4j_tpu/kernels/attention.py:81 "
                        "(_make_kernel via _flash_fwd_impl :168, "
                        "emit_lse=True, for _flash_fwd :350)",
            "launches": lm_counts["lse_launches"],
            "max_abs_err": attn_train_err["lse"][0],
            "max_err_over_max_ref": attn_train_err["lse"][1],
            "per": f"one launch (one block's attention) at B={LM_TRAIN_B}, "
                   f"H={LM_HEADS}, T=S={LM_SEQ}, Dh={Dh}, causal; "
                   f"{LM_BLOCKS} per LM training step",
            **timing(attn_f32["lse"]),
            "library": "scaled_dot_product_attention forward (f32, "
                       "is_causal, inputs requiring grad)",
            "bf16": typed_entry("lse", bf16_counts["lse_launches"]),
            "card": card,
        }] + [{
            "name": base if variant == "simt" else f"{base}_{variant}",
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "variant": variant,
            "launches": launches,
            "max_abs_err": typed_err.get(f"{kind} {variant}", [0.0])[0]
                           if variant != "simt" else
                           max(attn_train_err[kind][0],
                               typed_err.get(f"{kind} simt", [0.0])[0]),
            "per": per,
            **timing(rows[kind]),
            "library": "scaled_dot_product_attention backward (is_causal, "
                       f"{dt}): dq, dk and dv together, its backward node "
                       f"({rows[kind]['library_call']}) called on one saved "
                       "graph, the same time on the dq and dk/dv entries",
            **extra(kind),
            "card": card,
        } for kind, base, replaces in (
            ("dq", "attention_bwd_dq",
             "deeplearning4j_tpu/kernels/attention.py:206 (_make_dq_kernel "
             "via _flash_bwd_impl :312)"),
            ("dkv", "attention_bwd_dkv",
             "deeplearning4j_tpu/kernels/attention.py:244 (_make_dkv_kernel "
             "via _flash_bwd_impl :329)"))
          for variant, source, launches, rows, dt, per, extra in (
            ("simt", "deeplearning4j_tpu_torch/kernels/csrc/attention_bwd.cu",
             lm_variants[kind]["simt"], attn_f32, "f32",
             f"one launch at B={LM_TRAIN_B}, H={LM_HEADS}, T=S={LM_SEQ}, "
             f"Dh={Dh}, causal, float32; {LM_BLOCKS} per f32 LM training "
             "step (main path 4)",
             lambda kind: {"dh256": timing(attn_wide[(256, "float32")][kind])}),
            ("wgmma",
             "deeplearning4j_tpu_torch/kernels/csrc/attention_wgmma.cu",
             bf16_variants[kind]["wgmma"], attn_bf16["b64"], "bf16",
             f"one launch at B={LM_TRAIN_B}, H={LM_HEADS}, T=S={LM_SEQ}, "
             f"Dh={Dh}, causal, bfloat16; {LM_BLOCKS} per bf16 LM training "
             "step (main path 6)",
             lambda kind: {"dh256": timing(
                 attn_wide[(256, "bfloat16")][kind])}),
            ("wide", "deeplearning4j_tpu_torch/kernels/csrc/attention.cu",
             wide_variants[(kind, "wide")], attn_wide[(512, "float32")],
             "f32",
             "one launch at B=8, H=2, T=S=256, Dh=512, causal, float32; one "
             "per step of the Dh = 512 LMs (main path 6)",
             lambda kind: {"bf16": timing(
                 attn_wide[(512, "bfloat16")][kind])}))] + [{
            "name": "flash_attention_fwd_wide",
            "route": "cuda",
            "source": "deeplearning4j_tpu_torch/kernels/csrc/attention.cu",
            "replaces": "deeplearning4j_tpu/kernels/attention.py:81 "
                        "(_make_kernel via _flash_fwd_impl :168, both modes, "
                        "head dimensions past 256)",
            "variant": "wide",
            "launches": wide_variants[("fwd", "wide")]
                        + wide_variants[("lse", "wide")],
            "max_abs_err": max(typed_err["lse wide"][0],
                               typed_err["fwd wide"][0]),
            "per": "one logsumexp-mode launch at B=8, H=2, T=S=256, Dh=512, "
                   "causal, float32",
            **timing(attn_wide[(512, "float32")]["lse"]),
            "library": "scaled_dot_product_attention forward (f32, "
                       "is_causal)",
            "primal": timing(attn_wide[(512, "float32")]["primal"]),
            "bf16": timing(attn_wide[(512, "bfloat16")]["lse"]),
            "card": card,
        }]
        + [{
            "name": name if variant == "resident" else f"{name}_streamed",
            "route": "cuda",
            "source": "deeplearning4j_tpu_torch/kernels/csrc/bn_relu.cu",
            "replaces": replaces,
            "variant": variant,
            "launches": launches[variant][key],
            "max_abs_err": bn_max[(key, variant)][0],
            "max_err_over_max_ref": bn_max[(key, variant)][1],
            "per": per,
            **bn_timing(bn_times[(key, *shape)]),
            "library": library,
            "by_shape": {f"N={n} C={c}": bn_timing(bn_times[(key, n, c)])
                         for n in (MLP_B, 4096)
                         for c in (MLP_WIDTH, 200, 48)},
            "card": card,
        } for name, key, replaces, library in (
            ("bn_relu_forward", "fwd",
             "deeplearning4j_tpu/kernels/bn_relu.py:38 (_fwd_kernel via "
             "_fwd_call's pallas_call :88)",
             "F.batch_norm(training=True) + relu forward (bf16 input, f32 "
             "weight and bias)"),
            ("bn_relu_backward", "bwd",
             "deeplearning4j_tpu/kernels/bn_relu.py:50 (_bwd_kernel via "
             "_bwd_call's pallas_call :123)",
             "autograd backward of F.batch_norm(training=True) + relu, "
             "rerun on one saved graph (per call: autograd's host path)"))
          for variant, shape, per in (
            ("resident", (MLP_B, MLP_WIDTH),
             f"one launch at the BN-MLP's N={MLP_B}, C={MLP_WIDTH}, bf16 (2 "
             "per training step; launches: main path 5); by_shape: its "
             "entry point alone beside the streamed one's"),
            ("streamed", (NARROW_B, NARROW_C),
             f"one launch at the narrow BN network's N={NARROW_B}, "
             f"C={NARROW_C}, bf16 (1 per step; launches: its step and "
             "first-step gradients); by_shape: its entry point alone, at "
             "shapes its plan gives the resident variant"))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
