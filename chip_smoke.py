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
     bit-equal); then every variant of the seven kernels (LSTM forward,
     residual forward and adjoint "cluster" and "streamed", the
     reduction; attention "tiled" forward and logsumexp, "simt" and
     "wgmma" dq and dk/dv, the "wide" four; BN+ReLU forward and backward
     "resident" and "streamed") captured once in a CUDA graph at the main
     paths' shapes and replayed on three fresh inputs, each replay
     bit-equal to an eager launch, the counters at 1 captured + 3
     replayed launches;
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
     first-step gradients at batch 16 and a 10-step trajectory at batch 16
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
     share (torch.profiler), AlexNet's predict p50 per bucket;
 12. main path 8: a stacked bidirectional LSTM at the char-RNN's widths
     (one-hot 77 characters, window 64, batch 64, 2 x
     GravesBidirectionalLSTM(200), LastTimeStep, softmax output over the
     next character, Adam 2e-3) trained 20 steps with `fit` over an
     ArrayDataSetIterator of chip_smoke_text.txt windows on the card and
     the CPU from one zip (first-step gradients, scores, final
     parameters); the trained zip registered and served at buckets 1 and
     32 against the CPU; a masked batch (rows ending early) through the
     plain path on the card against the CPU; remat="layer" with policy
     "dots" bit-equal to no remat, with the recompute's launches and the
     peak memory both ways; the step p50, device busy time, idle share and
     each LSTM kernel's device time by variant; layer 2's streamed kernels
     per launch (F = 400) with their bound;
 13. main path 9: layerwise pretraining on the bundled digits through
     `fit` on pretrain=True, backprop=False configurations, card against
     CPU under the same injected noise: the VAE of
     VariationalAutoEncoderExample (784 -> (256, 256) -> 2, Bernoulli
     reconstruction, RmsProp 1e-3, l2 1e-4) and its reconstruction
     log-probability of the held-out digits, the RBM stack of
     DeepAutoEncoderExample (784-1000-500-250-100-30) and a one-layer
     AutoEncoder (784-1000, corruption 0), each with its time per
     pretraining step; then one Adam step of a MixtureOfExpertsLayer (n_in
     512, 8 experts, top-2, hidden 2048) on the card against the CPU with
     all-zero rows whose router logits tie;
 14. main path 10, ComputationGraphs: ResNet-50 (BASELINE config 2: 224 x
     224 x 3, 1000 classes, 25,557,032 parameters, Adam 1e-3) in float32
     at batch 2 on the card against the CPU (output, score, first-step
     gradients in relative L2 per tensor, the CPU's float32 against its
     float64 beside them), then 5 bf16 steps at batch 32 on seeded
     images, its graph zip with Adam state restored on both devices for
     one more step, its step p50, images/s, share of the bf16 dense peak,
     device busy time, idle share and device time by kind; GoogLeNet (224,
     1000 classes) registered and served in process at buckets 1, 8 and 32
     against the CPU with the predict p50 per bucket; an encoder-decoder
     graph in the shape of dl4j-examples' AdditionRNN at the char-RNN's
     widths (two one-hot inputs of 77, T 64, encoder GravesLSTM(200) ->
     LastTimeStepVertex -> DuplicateToTimeSeriesVertex -> MergeVertex with
     the decoder input -> decoder GravesLSTM(200) -> softmax) trained 20
     Adam steps with `fit` over MultiDataSets of chip_smoke_text.txt on the
     card and the CPU from one zip, then stepped with rnn_time_step against
     the CPU; a bf16 two-branch graph (two 784-wide inputs, each Dense(1024)
     -> BatchNormalization(relu), MergeVertex, softmax 10) trained 20 Adam
     steps on the bundled digits card against CPU, early stopping on it with
     a LocalFileModelSaver on the card and its best model restored, a
     GraphTransferLearning head replacement stepped on both devices, and
     conjugate-gradient and L-BFGS line searches card against CPU;
 15. main path 11, the training loop (`fit`'s options; windows replayed
     from CUDA graphs): the BN-MLP of phase 8 on 20 batches of 128
     seeded normal rows, superstep 1, 4, 3 and "epoch" bit-equal on the
     card and held to the CPU at phase 8's bf16 limits, the same with
     dropout, grad_accumulation=2 at batch 64 (K=2 bit-equal to K=1;
     against batch 128 on mlp_mnist without BN), a TrainingGuard over a
     NaN batch (skip_batch and rollback: the run equals one without the
     poisoned window), checkpoint_every=5 under superstep=4 with a
     SimulatedCrash at the second save and resume bit-equal to the
     uninterrupted run, checkpoints resumed across devices, the same run
     in a TelemetrySession (chrome trace parsed back, captures counted,
     the card's memory watermarks), then 20 steps at batch 4096 with
     prefetch at K=1 and K=4 (step p50, samples/s, device busy time, idle
     share and copy time); the char-RNN's fit_scan bit-equal to its
     per-batch fit (20 TBPTT chunk steps); the bf16 LM with warm-up at
     batch 16, superstep=4 bit-equal to 1, and its step p50 and idle
     share at batch 64 for K=1 and K=4; the bf16 two-branch BN graph
     under superstep=4; and the run's total seconds;
 16. main path 12, generation (the decode plane): phase 5's LM at
     nanoGPT's widths registered from a seeded zip with generation enabled
     (block_len 16, decode buckets 1-32, prompt buckets 8-256); one
     sequence's prefill and 64 teacher-forced ticks against the full
     forward on the card and the CPU (1e-4 of the largest |logit|), its
     greedy tokens against the card's full-forward argmax (near ties
     counted), a row's tick bit-equal with neighbours in its bucket and
     printed across buckets; generation over HTTP at 8 and 32 clients
     (prompts 8-200, max_tokens 16-64; tokens/s, TTFT from the request
     traces) and again at 32 with a /swap mid-run (no request fails); a
     pool of 64 blocks forcing eviction and resume; an int8 KV arena whose
     first token is fp32's; bf16 and int8 precision at bucket 32 against
     fp32 and the CPU, then 32 tokens generated in bf16; a canary at 0.25
     promoted, another rolled back; /metrics, /debug/flightrecord and the
     X-DL4J-Trace header on a success and an error; prefill and tick (CUDA
     graph and eager) times, a profiled tick, `run_decode_bench`
     (continuous against static), `run_serving_bench` and `obs_bench`;
 17. main path 13, the continual train-to-serve loop and streaming: the
     BN-MLP of phase 8 (bf16, Adam 1e-3) served from a seeded zip by a
     registry on the card and fine-tuned by a `ContinualTrainer` from a
     `FileTopic` of the bundled digits (records of 64 rows [784 features |
     10 one-hot], windows of 4 records, batch 128, gated on the 64
     held-out digits, canaried at a quarter of live traffic): an
     improvement window at superstep 1 and one at superstep 2 promoted, a
     NaN window under the guard rolled back as empty_window, a NaN window
     without it rejected by the gate, a canary with an injected latency
     regression rolled back; every candidate against the same window
     fine-tuned on the CPU from the same stable zip (phase 8's bf16
     limits) with the same decision, no failed request, the stable outputs
     bit-equal across each rollback, each cycle's fine-tune / save / gate /
     canary seconds and the promotion latency; then the crash drill at the
     ten continual/* points (the narrow BN network, windows of one
     record), each recovered on the card to its last promoted checkpoint;
     then phase 3's char-RNN zip behind an `InferenceRoute` on the card,
     batches of 1, 8 and 32 published over TCP, every output against the
     CPU, p50 latency and arrays/s. (Keras import, `modelimport/`, runs on
     the CPU only: the card's machine has no h5py.)
 18. main path 14, the data-parallel trainer on a one-rank NCCL group
     (rendezvous on localhost; NCCL refuses two ranks on one device, so
     collectives across cards are not run): phase 9's bf16 LM (batch 64 x
     256, 8 steps) by `ParallelTrainer` under REPLICATED, ZERO1, ZERO2,
     ZERO2 with the bf16 wire and FSDP at superstep 1 and 4 against the
     model's own fit on the same zip and batches (REPLICATED bit-equal,
     the others at the bf16 limits, their gaps printed), step p50 a
     strategy, device busy and idle share; phase 8's BN-MLP (bf16, batch
     128, 10 steps on the digits) in AVERAGING and ZERO2 with evaluate,
     score and score_examples against the model's; ZERO2 killed in its
     second sharded save and resumed, bit-equal to the uninterrupted run;
     the CLI training the BN-MLP's zip one step on the card, the zip
     restored on the CPU;
 19. main path 15, the model-parallel trainer: phase 9's bf16 LM (6
     blocks, batch 64 x 256, 8 steps, one zip) by TENSOR_PARALLEL and
     ZERO1_TP at m = 2 (each rank attends over its 3 heads through kernels
     1-3), PP at p = 2 and ZERO1_TP_PP at (1, 2, 2), each over processes
     sharing the one card (gloo; every collective staged through pinned
     host memory by parallel/collectives.py, the copies counted), by
     PIPELINE (the host-driven GPipe: 2 stages of 3 blocks, 4
     microbatches) in process, and by TENSOR_PARALLEL and ZERO1_TP on a
     one-rank NCCL group at superstep 4 (bit-equal to 1), each against
     the model's own fit on the same zip and batches at the bf16 limits;
     phase 8's BN-MLP (bf16, global batch 128, 10 steps) under SYNC
     REPLICATED over 2 ranks through the four split BN+ReLU kernels
     against the one-rank fused run; ring attention over 2 ranks (B 4,
     T 512, H 6, Dh 64, causal, f32) against kernel 1's primal on the
     whole sequence and its gradients against autograd of the plain
     attention; the ElasticTrainer on the LM over 4 ranks, drained by a
     SIGTERM at an edge and resumed, bit-equal to the uninterrupted run.
     Phase 2 also holds the split kernels against their plain versions
     (N 64 and 2048 rows a rank, C 1024, bf16; two ranks' statistics
     merged by Chan's formula against the fused forward's) and phase 10
     times them beside their plain versions, a library call and their
     bound. `--model-parallel-only` runs phase 1, those checks and phase
     19.

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
of the "wide" variants (phase 9), four residual-forward, four adjoint and
four reduction launches per BiLSTM training step, the forward and adjoint
two "cluster" (layer 1) and two "streamed" (layer 2) each, four primal
launches per served BiLSTM forward and none for a masked batch (phase 12),
two residual-forward, two adjoint and two reduction launches per step of
the seq2seq graph, all "cluster", and two primal ones per rnn_time_step
call, one "resident" BN+ReLU forward and one backward launch per BN vertex
and step of the two-branch graph, none in its evaluation (phase 14), each
path launching none of the others' kernels, and none at all on the
convolutional, pretraining and MoE paths (phases 11 and 13) or on the
ResNet-50 and GoogLeNet graphs (phase 14: the 4-D BN takes the plain
tier); on the training loop (phase 15), counted through the CUDA-graph
replays, one resident BN+ReLU forward and backward launch per BN layer
and step at every window length, 2 + 2 + 2 cluster LSTM launches per
chunk step of the char-RNN's fit_scan, 6 + 6 + 6 wgmma attention
launches per bf16 LM step, and one resident forward and backward per BN
vertex and step of the two-branch graph; on the generation path (phase
16) six primal attention launches (float32, "tiled") per prefill and none
per decode tick, six bfloat16 ones per bf16 prefill, every tick replayed
from a CUDA graph captured once per (pool, version, bucket) before its
version went live and none on a request's path; on the continual path
(phase 17) one resident BN+ReLU forward and backward launch per BN layer
and fine-tune step, counted through the replays at superstep 2, none in
gate scoring, canary warm-up or serving, and two cluster LSTM launches per
batch through the InferenceRoute; on the data-parallel path (phase 18),
counted through the replays, 6 + 6 + 6 wgmma attention launches per bf16
LM step in every strategy, and one resident BN+ReLU forward and backward
launch per BN layer and step, none in evaluation (the kernels line's
`parallel_launches`); on the model-parallel path (phase 19), a rank's
6 + 6 + 6 wgmma attention launches per bf16 LM step under TP / ZERO1_TP,
3 + 3 + 3 under PP / ZERO1_TP_PP (a stage's blocks), 24 + 24 + 24 per
GPipe step (4 microbatches), two of each split BN kernel per step at 2
data ranks and no fused BN launch (the kernels line's
`model_parallel_launches`). The last two lines are a
`{"kernels": [...]}` object and `{"ok":
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
import urllib.error
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
# than a minute. The bf16 LM's (phase 9) runs 10 steps: bf16 on the CPU
# made its 20 steps the costliest part of a whole run (185 s of phase 9
# on a slow host); its warmed-up score falls from the first step, where
# the f32 LM's trajectory without the warm-up (phase 7) needs its 20
# steps to come down from its loss spikes.
LM_CMP_B, LM_CMP_STEPS = 16, 10
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

# the bidirectional LSTM (main path 8) at the char-RNN's widths, the only
# recurrent width the repository defines (BASELINE config 3,
# deeplearning4j_tpu/models/zoo.py:59): one-hot input of the 77 characters
# of ALPHABET, window 64, batch 64, two GravesBidirectionalLSTM(200),
# LastTimeStep, softmax output over the next character, Adam 2e-3; held to
# phase 6's limits (GRAD_TOL, SCORE_TOL, PARAM_TOL) against the CPU. Layer
# 1 (F = 77) plans "cluster"; layer 2 reads both directions (F = 400),
# where a cluster CTA's slice of W does not fit: "streamed".
BI_B, BI_T, BI_STEPS, BI_LR = 64, 64, 20, 2e-3
BI_F2 = 2 * HIDDEN

# layerwise pretraining (main path 9) on the bundled digits: the VAE of
# dl4j-examples' VariationalAutoEncoderExample (nIn 784, encoder and
# decoder (256, 256), nOut 2, leakyrelu, Bernoulli reconstruction with
# sigmoid, RmsProp 1e-3, l2 1e-4, batch 128), the RBM stack of its
# DeepAutoEncoderExample (784-1000-500-250-100-30; SGD 0.1 here: the
# example's line-gradient descent is not in the port) and a one-layer
# AutoEncoder (784-1000, corruption 0). Both devices draw the same noise
# (`same_noise`: one seeded CPU stream, copied to the device), so the VAE
# and the AutoEncoder are held to the f32 limits. The RBM's Gibbs samples
# compare that shared noise with probabilities that differ by rounding,
# so a sample may flip where the two straddle a draw (about 1e-7 of the
# 1e8 draws a step): each flip moves one row of dW by lr / 128, so its
# parameters are held to 1e-2 relative L2 and its scores to 1e-3 relative.
PRE_B, PRE_EPOCHS = 128, 3
RBM_SIZES = (784, 1000, 500, 250, 100, 30)
RBM_PARAM_TOL, RBM_SCORE_TOL = 1e-2, 1e-3
# the VAE's reconstruction log-probability of the held-out digits, card
# against CPU, relative to its magnitude (about 550 nats a digit: 784
# Bernoulli terms summed in another order)
RECON_TOL = 1e-5

# a MixtureOfExpertsLayer at a transformer FFN's scale: n_in 512, 8
# experts, top-2, hidden 2048 (4 x 512), relu, load-balance coefficient
# 0.01; one Adam step at batch 64, the last 8 rows all zero (every router
# logit ties: experts 0 and 1 must win, gates 1/2 each)
MOE_IN, MOE_EXPERTS, MOE_TOPK, MOE_HIDDEN, MOE_B, MOE_ZERO = (
    512, 8, 2, 2048, 64, 8)


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


def plain_mlp_conf(pt):
    """`mlp_mnist`'s widths and Adam (784 -> 1024 -> 1024 -> 10, relu) in
    bf16 compute, without BN: where gradient accumulation computes what
    one big batch does."""
    return (pt.NeuralNetConfiguration.builder().seed(42)
            .updater(pt.Adam(MLP_LR)).compute_dtype("bfloat16").list()
            .layer(pt.DenseLayer(n_out=MLP_WIDTH, activation="relu"))
            .layer(pt.DenseLayer(n_out=MLP_WIDTH, activation="relu"))
            .layer(pt.OutputLayer(n_out=10, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(pt.InputType.feed_forward(784)).build())


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


def tree_grads(torch, net, x, y, fmask=None):
    """{"layer/key path": gradient on the CPU} of the network's score on
    one batch at its current parameters (nested trees included: a BiLSTM's
    `0/fwd/W`), through `_loss_fn` in training mode (remat included)."""
    from deeplearning4j_tpu_torch.nn.trees import leaf_paths, tree_map
    params = tuple(tree_map(lambda v: v.detach().requires_grad_(), p)
                   for p in net.params)
    paths = [(f"{i}/{k}", v) for i, p in enumerate(params)
             for k, v in leaf_paths(p)]
    with torch.enable_grad():
        score, _ = net._loss_fn(params, net.state, x, y, fmask=fmask)
        grads = torch.autograd.grad(score, [v for _, v in paths])
    return score.detach(), {name: g.detach().cpu()
                            for (name, _), g in zip(paths, grads)}


def tree_rel_l2(net, ref):
    """Largest per-tensor |a - b|_2 / |b|_2 between two networks' (possibly
    nested) parameter trees."""
    from deeplearning4j_tpu_torch.nn.trees import flat_leaves
    worst = 0.0
    for p, q in zip(net.params, ref.params):
        for a, b in zip(flat_leaves(p), flat_leaves(q)):
            a, b = a.detach().cpu(), b.detach().cpu()
            worst = max(worst, ((a - b).norm() / b.norm().clamp_min(1e-30))
                        .item())
    return worst


def grads_rel_max(got, want):
    """Largest per-tensor max |got - want| / max |want| over two gradient
    dicts."""
    return max(((got[k] - want[k]).abs().max()
                / want[k].abs().max().clamp_min(1e-30)).item()
               for k in want)


def lstm_ms_by_variant(events):
    """A profile's LSTM kernel device ms by kernel and variant."""
    kinds = {}
    for key, ms, _ in events:
        for name, kind in (("lstm_cluster_fwd", "forward cluster"),
                           ("lstm_seq_fwd", "forward streamed"),
                           ("lstm_cluster_bwd", "adjoint cluster"),
                           ("lstm_seq_bwd", "adjoint streamed"),
                           ("lstm_param_grad", "reduction")):
            if name in key:
                kinds[kind] = kinds.get(kind, 0.0) + ms
    return kinds


def bilstm_conf(pt, remat=None, policy=None):
    """Main path 8's network: 2 x GravesBidirectionalLSTM(200),
    LastTimeStep, softmax output over the next of 77 characters, Adam."""
    from deeplearning4j_tpu_torch.nn.layers import (GravesBidirectionalLSTM,
                                                    LastTimeStep)
    b = pt.NeuralNetConfiguration.builder().seed(12345).updater(
        pt.Adam(BI_LR))
    if remat is not None:
        b = b.remat(remat).remat_policy(policy)
    return (b.list()
            .layer(GravesBidirectionalLSTM(n_out=HIDDEN))
            .layer(GravesBidirectionalLSTM(n_out=HIDDEN))
            .layer(LastTimeStep())
            .layer(pt.OutputLayer(n_out=VOCAB, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(pt.InputType.recurrent(VOCAB, BI_T)).build())


def bilstm_path(pt, torch, tag, tmp, root, reset_counts):
    """Main path 8 (phase 12): train the stacked bidirectional LSTM 20 Adam
    steps on the card and the CPU from one zip (first-step gradients,
    scores, final parameters), with 4 residual-forward, 4 adjoint and 4
    reduction launches a step (layer 1 "cluster", layer 2 "streamed");
    serve the trained zip at buckets 1 and 32 through the primal kernel; a
    masked batch through the plain path on the card; remat="layer" with
    policy "dots" bit-equal to no remat; times. Returns the phase's
    numbers."""
    from deeplearning4j_tpu_torch.kernels import lstm
    from deeplearning4j_tpu_torch.nn.trees import tree_map
    out = {"card": tag.strip("[]")}
    t_phase = time.perf_counter()
    layer2 = lstm.sequence_plan(BI_B, BI_F2, HIDDEN)
    check(lstm.sequence_variant(BI_B, VOCAB, HIDDEN) == "cluster"
          and layer2.variant == "streamed",
          f"BiLSTM plans: F={VOCAB} {lstm.sequence_variant(BI_B, VOCAB, HIDDEN)}"
          f", F={BI_F2} {layer2}")
    windows = text_windows(root, ALPHABET, BI_STEPS * BI_B, BI_T + 1)
    eye = np.eye(VOCAB, dtype=np.float32)
    x_all, y_all = eye[windows[:, :-1]], eye[windows[:, -1]]
    net = pt.MultiLayerNetwork(bilstm_conf(pt), device=DEVICE).init(
        generator=torch.Generator().manual_seed(31))
    zip0 = os.path.join(tmp, "bilstm0.zip")
    pt.ModelSerializer.write_model(net, zip0)
    nets = [pt.ModelSerializer.restore(zip0, device=d)
            for d in (DEVICE, "cpu")]

    # first-step gradients, card against CPU
    grads = []
    for n in nets:
        x, y = (n._as_input(a) for a in (x_all[:BI_B], y_all[:BI_B]))
        grads.append(tree_grads(torch, n, x, y)[1])
    grad_err = grads_rel_max(*grads)
    check(grad_err <= GRAD_TOL, f"BiLSTM first-step gradients card vs CPU: "
          f"{grad_err} > {GRAD_TOL}")

    # 20 Adam steps on both devices, the card's launches counted
    logs = [StepLog(torch), StepLog()]
    for n, log in zip(nets, logs):
        n.set_listeners(log)
    reset_counts()
    nets[0].fit(pt.ArrayDataSetIterator(x_all, y_all, batch_size=BI_B))
    counts, variants = lstm.launch_counts(), lstm.variant_counts()
    nets[1].fit(pt.ArrayDataSetIterator(x_all, y_all, batch_size=BI_B))
    per = 4 * BI_STEPS
    check(counts == {"launches": 0, "residual_launches": per,
                     "adjoint_launches": per, "reduction_launches": per},
          f"BiLSTM training launches {counts}, want {per} of each training "
          "kernel and no primal forward")
    for kind in ("residual", "adjoint"):
        check(variants[kind] == {"cluster": per // 2, "streamed": per // 2},
              f"BiLSTM {kind} variants {variants[kind]}")
    cards = [float(s) for s in logs[0].scores]
    cpus = [float(s) for s in logs[1].scores]
    score_err = max(abs(a - b) for a, b in zip(cards, cpus))
    param_err = tree_rel_l2(*nets)
    check(len(cards) == len(cpus) == BI_STEPS and score_err <= SCORE_TOL
          and param_err <= PARAM_TOL,
          f"BiLSTM 20 steps card vs CPU: score err {score_err}, parameters "
          f"relative L2 {param_err}")
    step_ms = 1e3 * np.diff(logs[0].times)
    print(f"BiLSTM (2 x GravesBidirectionalLSTM({HIDDEN}), B={BI_B}, "
          f"T={BI_T}, Adam {BI_LR}) trained {BI_STEPS} steps on the card "
          f"and the CPU from one zip: first-step gradients {grad_err:.3e} "
          f"of max (limit {GRAD_TOL}), scores {cards[0]:.4f} -> "
          f"{cards[-1]:.4f}, max err {score_err:.3e} (limit {SCORE_TOL}), "
          f"final parameters relative L2 {param_err:.3e} (limit "
          f"{PARAM_TOL}); launches {counts}, variants {variants}")
    out.update(first_step_grad_err=grad_err, score_err=score_err,
               param_err=param_err, launches=counts, variants=variants,
               scores_card=cards)

    # serve the trained zip at buckets 1 and 32
    zip1 = os.path.join(tmp, "bilstm1.zip")
    pt.ModelSerializer.write_model(nets[0], zip1)
    ref = pt.ModelSerializer.restore(zip1, device="cpu")
    reg = pt.ModelRegistry(buckets=(1, 32))
    v = reg.register("bilstm", zip1)
    reset_counts()
    before = v.forwards
    serve_err, serve_t = 0.0, {}
    for rows in (1, 32):
        xs = x_all[-rows:]
        got, _ = reg.predict("bilstm", xs)
        want = ref.output(xs).numpy()
        check(got.shape == (rows, VOCAB) and np.isfinite(got).all(),
              f"BiLSTM served output shape {got.shape}")
        serve_err = max(serve_err, float(np.abs(got - want).max()))
        times = []
        for _ in range(20):
            t0 = time.perf_counter()
            reg.predict("bilstm", xs)
            times.append(time.perf_counter() - t0)
        serve_t[f"predict_p50_ms_b{rows}"] = 1e3 * float(np.median(times))
    counts = lstm.launch_counts()
    n_fwd = v.forwards - before
    check(serve_err <= SERVE_TOL, f"BiLSTM served vs CPU: {serve_err} > "
          f"{SERVE_TOL}")
    check(counts == {"launches": 4 * n_fwd, "residual_launches": 0,
                     "adjoint_launches": 0, "reduction_launches": 0},
          f"serving the BiLSTM: {counts} for {n_fwd} forwards")
    print(f"{tag} trained BiLSTM zip registered and served at buckets 1 and "
          f"32: max abs err vs CPU {serve_err:.3e} (limit {SERVE_TOL}), "
          f"{counts['launches']} primal LSTM launches for {n_fwd} forwards "
          "(4 each), no training kernel; registry.predict p50 " + ", ".join(
              f"bucket {b} {serve_t[f'predict_p50_ms_b{b}']:.3f} ms"
              for b in (1, 32)))
    out.update(serve_err=serve_err, serve=serve_t)

    # a masked batch (rows end early): the plain path on the card
    r = np.random.default_rng(41)
    lengths = r.integers(BI_T // 4, BI_T + 1, BI_B)
    mask = (np.arange(BI_T)[None] < lengths[:, None]).astype(np.float32)
    reset_counts()
    masked = []
    for n in nets:
        x, y, m = (n._as_input(a) for a in (x_all[:BI_B], y_all[:BI_B],
                                             mask))
        score, g = tree_grads(torch, n, x, y, fmask=m)
        masked.append((n.output(x_all[:BI_B], features_mask=mask).cpu(),
                       float(score), g))
    c = lstm.launch_counts()
    m_out = (masked[0][0] - masked[1][0]).abs().max().item()
    m_score = abs(masked[0][1] - masked[1][1])
    m_grad = grads_rel_max(masked[0][2], masked[1][2])
    check(all(n == 0 for n in c.values()), f"the masked BiLSTM batch "
          f"launched LSTM kernels: {c}")
    check(m_out <= SERVE_TOL and m_score <= SCORE_TOL
          and m_grad <= GRAD_TOL,
          f"masked BiLSTM card vs CPU: output {m_out}, score {m_score}, "
          f"gradients {m_grad}")
    print(f"masked BiLSTM batch (lengths {lengths.min()}-{lengths.max()}): "
          f"plain path on the card, LSTM launches {c} (all 0); card vs CPU "
          f"output {m_out:.3e}, score {m_score:.3e}, gradients {m_grad:.3e} "
          "of max")
    out.update(masked_output_err=m_out, masked_score_err=m_score,
               masked_grad_err=m_grad)

    # remat="layer" with policy "dots": bit-equal, the recompute counted
    remats = {}
    for name, conf in (("none", bilstm_conf(pt)),
                       ("layer/dots", bilstm_conf(pt, "layer", "dots"))):
        n = pt.MultiLayerNetwork(conf, device=DEVICE).init()
        n.params = tuple(tree_map(torch.Tensor.clone, p)
                         for p in nets[0].params)
        x, y = (n._as_input(a) for a in (x_all[:BI_B], y_all[:BI_B]))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts()
        score, g = tree_grads(torch, n, x, y)
        torch.cuda.synchronize()
        remats[name] = {"score": score.item(), "grads": g,
                        "residual_launches":
                            lstm.launch_counts()["residual_launches"],
                        "peak_bytes": torch.cuda.max_memory_allocated()
                        - base}
    plain, rm = remats["none"], remats["layer/dots"]
    bit_equal = (plain["score"] == rm["score"] and all(
        torch.equal(plain["grads"][k], rm["grads"][k])
        for k in plain["grads"]))
    check(bit_equal, "BiLSTM remat='layer' (dots): scores or gradients "
          "differ from the run without remat")
    check(plain["residual_launches"] == 4
          and rm["residual_launches"] == 8,
          f"BiLSTM residual launches: no remat {plain['residual_launches']}"
          f", remat {rm['residual_launches']} (want 4 and 4 + 4 recomputed)")
    print(f"{tag} BiLSTM remat='layer', policy 'dots': score and gradients "
          f"bit-equal to no remat; residual-forward launches "
          f"{plain['residual_launches']} -> {rm['residual_launches']} (the "
          f"recompute); peak memory above the step's start "
          f"{plain['peak_bytes'] / 2**20:.1f} MiB -> "
          f"{rm['peak_bytes'] / 2**20:.1f} MiB "
          "(torch.cuda.max_memory_allocated)")
    out["remat"] = {k: {kk: vv for kk, vv in v.items() if kk != "grads"}
                    for k, v in remats.items()}

    # times: the step, its device profile, the kernels by variant
    timed = nets[0]
    batch = pt.DataSet(torch.as_tensor(x_all[:BI_B], device=DEVICE),
                       torch.as_tensor(y_all[:BI_B], device=DEVICE))
    clock = StepLog(torch)
    timed.set_listeners(clock)
    for _ in range(3):
        timed.fit(batch)
    clock.times.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        timed.fit(batch)
    step_ms = 1e3 * np.diff([t0] + clock.times)
    timed.set_listeners()
    events, busy, wall = profile_device(
        torch, lambda: timed.fit(batch), "BiLSTM training step", tag, reps=5)
    by_variant = lstm_ms_by_variant(events)
    streamed = sum(ms for k, ms in by_variant.items() if "streamed" in k)
    times = {"step_p50_ms": float(np.median(step_ms)),
             "device_busy_ms": busy, "profiled_wall_ms": wall,
             "idle_share": 1 - busy / wall,
             "lstm_device_ms_by_variant": by_variant,
             "streamed_share_of_busy": streamed / busy,
             "streamed_share_of_wall": streamed / wall}
    print(f"{tag} BiLSTM training step (B={BI_B}, T={BI_T}): p50 "
          f"{times['step_p50_ms']:.3f} ms; device busy {busy:.3f} of "
          f"{wall:.3f} ms (idle share {1 - busy / wall:.3f}); LSTM kernels' "
          "device ms a step: " + ", ".join(
              f"{k} {ms:.4f}" for k, ms in sorted(by_variant.items()))
          + f"; streamed kernels {streamed:.4f} ms = "
          f"{100 * streamed / busy:.1f} % of busy, "
          f"{100 * streamed / wall:.1f} % of the step")

    # layer 2's streamed kernels per launch (T 64, B 64, F 400, H 200)
    T, B, F, H = BI_T, BI_B, BI_F2, HIDDEN
    args = lstm_inputs(torch, T, B, F, H, seed=43)
    x, W, b, peep, h0, c0 = args
    res = lstm.lstm_residual_forward(*args, 1.0)
    ref_res = lstm.lstm_sequence_reference(*args, 1.0, save_residuals=True)
    dhs, dhT, dcT = cotangents(torch, T, B, H, seed=44)
    layer2_t = {}
    for kind, kern, plain_fn, (bnd, by) in (
            ("residual", lambda: lstm.lstm_residual_forward(*args, 1.0),
             lambda: lstm.lstm_sequence_reference(*args, 1.0,
                                                  save_residuals=True),
             residual_forward_bound_ms(T, B, F, H)),
            ("adjoint", lambda: lstm.lstm_adjoint(W, peep, c0, *res[3:], dhs,
                                                  dhT, dcT, F, True),
             lambda: lstm.lstm_adjoint_reference(W, peep, c0, *ref_res[1:],
                                                 dhs, dhT, dcT, F),
             adjoint_bound_ms(T, B, F, H, True))):
        k, p = cuda_ms(torch, kern), cuda_ms(torch, plain_fn, reps=5)
        dev = device_ms(torch, kern)
        layer2_t[kind] = {"ms": k, "device_ms": dev, "per_step_ms": k / T,
                          "plain_ms": p, "bound_ms": bnd, "bound_by": by,
                          "library_ms": None}
        print(f"{tag} LSTM {kind} (streamed, BiLSTM layer 2) B={B} T={T} "
              f"F={F} H={H}: kernel {k:.4f} ms ({1e3 * k / T:.3f} us a step)"
              f", device {dev:.4f} ms, plain {p:.4f} ms, bound {bnd:.6f} ms "
              f"({by})")
    times["layer2_streamed"] = layer2_t
    out.update(times=times, seconds=time.perf_counter() - t_phase)
    print(json.dumps({"bilstm_path": out}))
    return out


@contextlib.contextmanager
def same_noise(torch, seed):
    """The pretraining layers' draws (`nn.noise.draw`) from one seeded CPU
    stream, copied to the layer's device: a card run and a CPU run see the
    same noise."""
    from deeplearning4j_tpu_torch.nn import noise
    gen = torch.Generator().manual_seed(seed)
    real = noise.draw

    def draw(kind, shape, generator, dtype, device):
        return real(kind, shape, gen, dtype, "cpu").to(device)
    noise.draw = draw
    try:
        yield
    finally:
        noise.draw = real


def pretrain_path(pt, torch, tag, tmp, reset_counts, counts):
    """Main path 9 (phase 13): layerwise pretraining on the bundled
    digits, card against CPU under the same noise: the VAE of
    VariationalAutoEncoderExample (then its reconstruction
    log-probability of the held-out digits), the RBM stack of
    DeepAutoEncoderExample and a one-layer AutoEncoder at corruption 0,
    each through `fit` on a pretrain=True, backprop=False configuration;
    then the time per pretraining step. No hand kernel launches. Returns
    the phase's numbers."""
    from deeplearning4j_tpu_torch.nn.layers import (
        RBM, AutoEncoder, BernoulliReconstructionDistribution,
        VariationalAutoencoder)
    from deeplearning4j_tpu_torch.nn.updaters import RmsProp
    out = {"card": tag.strip("[]")}
    t_phase = time.perf_counter()
    x_train, _, x_test, _ = pt.bundled_mnist_subset()

    def build(updater, layers, l2=None):
        b = pt.NeuralNetConfiguration.builder().seed(12345).updater(updater)
        if l2:
            b = b.l2(l2)
        lb = b.list()
        for layer in layers:
            lb = lb.layer(layer)
        return (lb.set_input_type(pt.InputType.feed_forward(784))
                .pretrain(True).backprop(False).build())

    confs = {
        "vae": build(RmsProp(1e-3), [VariationalAutoencoder(
            n_out=2, encoder_layer_sizes=(256, 256),
            decoder_layer_sizes=(256, 256), activation="leakyrelu",
            pzx_activation="identity",
            reconstruction_distribution=BernoulliReconstructionDistribution(
                activation="sigmoid"))], l2=1e-4),
        "rbm_stack": build(pt.Sgd(0.1), [RBM(n_out=n)
                                         for n in RBM_SIZES[1:]]),
        "autoencoder": build(pt.Sgd(0.1), [AutoEncoder(
            n_out=1000, corruption_level=0.0)])}
    reset_counts()
    for name, conf in confs.items():
        net = pt.MultiLayerNetwork(conf, device=DEVICE).init(
            generator=torch.Generator().manual_seed(51))
        z = os.path.join(tmp, f"{name}.zip")
        pt.ModelSerializer.write_model(net, z)
        nets = [pt.ModelSerializer.restore(z, device=d)
                for d in (DEVICE, "cpu")]
        scores = []
        for n in nets:
            it = pt.ArrayDataSetIterator(x_train, x_train, batch_size=PRE_B)
            with same_noise(torch, 53):
                n.fit(it)                   # pretrain=True: one epoch
                n.pretrain(it, epochs=PRE_EPOCHS - 1)
            scores.append(float(n._score))
        param_err = tree_rel_l2(*nets)
        score_err = abs(scores[0] - scores[1])
        if name == "rbm_stack":
            ok = (param_err <= RBM_PARAM_TOL
                  and score_err <= RBM_SCORE_TOL * abs(scores[1]))
            limits = f"{RBM_PARAM_TOL}, {RBM_SCORE_TOL} relative"
        else:
            ok = param_err <= PARAM_TOL and score_err <= SCORE_TOL * max(
                1.0, abs(scores[1]))
            limits = f"{PARAM_TOL}, {SCORE_TOL}"
        check(ok and np.isfinite(scores[0]), f"{name} pretraining card vs "
              f"CPU: parameters relative L2 {param_err}, last score "
              f"{scores} (limits {limits})")
        steps = PRE_EPOCHS * -(-len(x_train) // PRE_B)
        print(f"{name} pretrained {PRE_EPOCHS} epochs ({steps} steps a "
              f"layer) on the {len(x_train)} bundled digits, card and CPU "
              f"under the same noise: last score card {scores[0]:.6f}, CPU "
              f"{scores[1]:.6f}; parameters relative L2 {param_err:.3e} "
              f"(limits {limits})")
        entry = {"score_card": scores[0], "score_cpu": scores[1],
                 "param_err": param_err}
        if name == "vae":
            lps = []
            for n in nets:
                with same_noise(torch, 57):
                    lps.append(n.reconstruction_log_probability(
                        x_test, num_samples=5))
            rec_err = float(np.abs(lps[0] - lps[1]).max()
                            / np.abs(lps[1]).max())
            check(lps[0].shape == (len(x_test),) and np.isfinite(
                lps[0]).all() and rec_err <= RECON_TOL,
                f"VAE reconstruction log-probability card vs CPU: "
                f"{rec_err} (limit {RECON_TOL})")
            print(f"{tag} VAE reconstruction_log_probability of the "
                  f"{len(x_test)} held-out digits (5 samples): mean "
                  f"{lps[0].mean():.3f} nats, card vs CPU {rec_err:.3e} of "
                  f"max (limit {RECON_TOL})")
            entry.update(recon_log_prob_mean=float(lps[0].mean()),
                         recon_err=rec_err)
        # time per pretraining step (the bottom layer alone)
        it = pt.ArrayDataSetIterator(x_train, x_train, batch_size=PRE_B)
        n = nets[0]
        n.pretrain_layer(0, it)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reps = 5
        n.pretrain_layer(0, it, epochs=reps)
        torch.cuda.synchronize()
        entry["layer0_step_ms"] = 1e3 * (time.perf_counter() - t0) / (
            reps * -(-len(x_train) // PRE_B))
        print(f"{tag} {name} layer 0 pretraining step (batch {PRE_B}): "
              f"{entry['layer0_step_ms']:.3f} ms")
        out[name] = entry
    c = counts()
    check(all(n == 0 for n in c.values()), f"the pretraining path launched "
          f"hand kernels: {c}")
    out["seconds"] = time.perf_counter() - t_phase
    print(json.dumps({"pretrain_path": out}))
    return out


def moe_step(pt, torch, tag, counts):
    """One Adam step of a MixtureOfExpertsLayer network on the card and the
    CPU from the same parameters, a batch whose last rows are all zero (the
    router's logits tie there: experts 0 and 1 win on both devices).
    Returns the numbers."""
    from deeplearning4j_tpu_torch.nn.layers import MixtureOfExpertsLayer
    from deeplearning4j_tpu_torch.nn.layers.moe import top_k_gates
    conf = (pt.NeuralNetConfiguration.builder().seed(7)
            .updater(pt.Adam(1e-3)).list()
            .layer(MixtureOfExpertsLayer(
                n_out=MOE_IN, n_experts=MOE_EXPERTS, top_k=MOE_TOPK,
                expert_hidden=MOE_HIDDEN, activation="relu",
                load_balance_coef=0.01))
            .layer(pt.OutputLayer(n_out=10, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(pt.InputType.feed_forward(MOE_IN)).build())
    r = np.random.default_rng(61)
    x = r.normal(size=(MOE_B, MOE_IN)).astype(np.float32)
    x[-MOE_ZERO:] = 0.0
    y = np.eye(10, dtype=np.float32)[r.integers(0, 10, MOE_B)]
    card = pt.MultiLayerNetwork(conf, device=DEVICE).init(
        generator=torch.Generator().manual_seed(63))
    cpu = card.clone().to("cpu")
    nets = (card, cpu)
    gates = []
    for n in nets:
        xt = n._as_input(x)
        logits = xt @ n.params[0]["router_W"]
        gates.append(top_k_gates(logits, MOE_TOPK).cpu())
    want = torch.zeros(MOE_ZERO, MOE_EXPERTS)
    want[:, :2] = 0.5
    for g, where in zip(gates, ("card", "CPU")):
        check(torch.equal(g[-MOE_ZERO:], want), f"MoE tied rows on the "
              f"{where}: gates {g[-MOE_ZERO:]}")
        check(int((g > 0).sum(1).max()) == MOE_TOPK, f"MoE routes more than "
              f"{MOE_TOPK} experts a row on the {where}")
    same_route = torch.equal(gates[0] > 0, gates[1] > 0)
    grads = [tree_grads(torch, n, n._as_input(x), n._as_input(y))[1]
             for n in nets]
    grad_err = grads_rel_max(*grads)
    for n in nets:
        n.fit(x, y)
    param_err = tree_rel_l2(*nets)
    score_err = abs(card.score() - cpu.score())
    check(same_route and grad_err <= GRAD_TOL and param_err <= PARAM_TOL
          and score_err <= SCORE_TOL,
          f"MoE step card vs CPU: same routes {same_route}, gradients "
          f"{grad_err}, parameters {param_err}, score {score_err}")
    c = counts()
    check(all(n == 0 for n in c.values()), f"the MoE step launched hand "
          f"kernels: {c}")
    print(f"{tag} MixtureOfExpertsLayer (n_in {MOE_IN}, {MOE_EXPERTS} "
          f"experts, top-{MOE_TOPK}, hidden {MOE_HIDDEN}) one Adam step at "
          f"batch {MOE_B} ({MOE_ZERO} all-zero rows routed to experts 0 and "
          f"1 on both devices): same routes on card and CPU, gradients "
          f"{grad_err:.3e} of max, score err {score_err:.3e}, parameters "
          f"relative L2 {param_err:.3e}")
    return {"grad_err": grad_err, "score_err": score_err,
            "param_err": param_err}


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
    # (seen on the H100 machine after a few dozen sessions; three sessions
    # in a row once, at a BN entry point's microsecond launches): up to six
    # sessions, each after a pause, then the check fails
    for attempt in range(6):
        if attempt:
            time.sleep(0.25)
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


def graph_ms(torch, fn, reps=20):
    """Device ms per call of `fn`: `reps` calls captured in one CUDA
    graph and replayed, timed with CUDA events (the host's launch path
    left out, without a torch.profiler session: the profiler stops
    recording device events after a few dozen sessions on the H100
    machine, `device_ms`)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
        flushes = srv._batchers[(name, "stable")].flushes

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


# ---- main path 10: ComputationGraphs ------------------------------------
# ResNet-50 (BASELINE config 2, deeplearning4j_tpu/models/zoo.py:114) at
# ImageNet widths: 224 x 224 x 3, 1000 classes, Adam 1e-3, bf16 compute over
# float32 masters by default; 25,557,032 parameters. Parity runs in float32
# at batch 2: the output as VGG-16's (VGG_TOL; at random init the softmax is
# all but one-hot, so the score, relative 1e-4, is the sharper check), the
# first-step gradients against float64 (ROADMAP C3's measure): per tensor,
# the card's relative L2 gap to the CPU's float64 gradients within
# R50_F64_FACTOR times the CPU's own float32 gap to them, plus
# R50_GRAD_FLOOR. A gap of the card to the CPU's float32 alone cannot be
# held: max pooling and ReLU masks flip on rounding, and BN divides by the
# deviation of 98 values a channel at the last stage, so the CPU's float32
# lies 2.3e-2 from its float64 in one tensor (the card 1.8e-2 from the
# CPU's float32 and 2.1e-2 from its float64; NVIDIA H100 80GB HBM3,
# 700.00 W, this script's first run). The same gradients with bf16 compute
# on the card are read against the limit as a control. Training at batch
# 32 in bf16.
R50_PARAMS, R50_CMP_B, R50_B, R50_STEPS = 25_557_032, 2, 32, 5
R50_F64_FACTOR, R50_GRAD_FLOOR = 2.0, 1e-3
# the bf16 zip-resume step, card against CPU, relative to the score: at
# batch 2 the batch statistics of bf16 activations amplify rounding (the
# tiny ResNet on the CPU: tests/test_torch_graph.py holds both packages'
# bf16 scores to 2e-2 of the float32 one)
R50_RESUME_TOL = 2e-2
# GoogLeNet (zoo.py:563) at 224 and 1000 classes, served in process
GOOG_PARAMS = 6_998_552
# the encoder-decoder graph in the shape of dl4j-examples' AdditionRNN at
# the char-RNN's widths: two sequence inputs of one-hot characters (77, T =
# 64), encoder GravesLSTM(200) -> LastTimeStepVertex ->
# DuplicateToTimeSeriesVertex (time from the decoder input) -> MergeVertex
# with the decoder input (F = 277) -> decoder GravesLSTM(200) -> softmax
# RnnOutputLayer; Adam 2e-3, batch 64, 20 steps on chip_smoke_text.txt,
# held to phase 6's limits
S2S_B, S2S_T, S2S_STEPS, S2S_LR = 64, 64, 20, 2e-3
S2S_STEP_B, S2S_STEP_T = 32, 16     # rnn_time_step batch and steps
# the bf16 two-branch graph at the BN-MLP's widths: two 784-wide inputs
# (a digit and its mirror image), each Dense(1024, no bias: a bias before
# BN gets only rounding noise as gradient) -> BatchNormalization(relu),
# MergeVertex, softmax OutputLayer(10); Adam 1e-3, batch 128, 20 steps on
# the bundled digits, held to the BN-MLP's bf16 limits
TB_WIDTH, TB_B, TB_STEPS, TB_LR = 1024, 128, 20, 1e-3
# line search on the card: CG and L-BFGS, 5 iterations each, on
# test_solvers.py's least-squares problem widened to 256 features and 4096
# rows, scores held relative to their size (a line search compares float32
# scores to pick its step: steps may differ where two trials tie)
LS_ITERS, LS_N, LS_D = 5, 4096, 256
LS_TOL = 1e-4


def graph_grads(torch, g, ds):
    """{"vertex/key path": gradient on the CPU} of a graph's score on one
    DataSet or MultiDataSet at its current parameters, and the score."""
    from deeplearning4j_tpu_torch.nn.trees import leaf_paths, tree_map
    inputs, labels, fm, lm = g._to_inputs(ds)
    params = {n: tree_map(lambda v: v.detach().requires_grad_(), p)
              for n, p in g.params.items()}
    paths = [(f"{n}/{k}", v) for n, p in params.items()
             for k, v in leaf_paths(p)]
    with torch.enable_grad():
        score, _ = g._loss_fn(params, g.state, inputs, labels, None, fm, lm)
        grads = torch.autograd.grad(score, [v for _, v in paths])
    return float(score.detach()), {name: d.detach().cpu()
                                   for (name, _), d in zip(paths, grads)}


def graph_rel_l2(g, ref, lr=0.0, steps=0, state=False):
    """Largest per-tensor |a - b|_2 / max(|b|_2, Adam's reach lr * steps in
    L2) between two graphs' parameters (or layer states)."""
    from deeplearning4j_tpu_torch.nn.trees import flat_leaves
    worst = 0.0
    a_t, b_t = (g.state, ref.state) if state else (g.params, ref.params)
    for n in b_t:
        for a, b in zip(flat_leaves(a_t[n]), flat_leaves(b_t[n])):
            a, b = a.detach().double().cpu(), b.detach().double().cpu()
            scale = max(b.norm().item(), lr * steps * b.numel() ** 0.5,
                        1e-30)
            worst = max(worst, (a - b).norm().item() / scale)
    return worst


def graph_forward_flops(g):
    """A graph's forward FLOPs per example: 2 x the multiply-adds of every
    convolution and dense vertex, from the input types `build()` inferred."""
    from deeplearning4j_tpu_torch.nn.layers import (ConvolutionLayer,
                                                    DenseLayer, OutputLayer)
    flops = 0
    for name, layer in g.layer_vertices.items():
        it = g._input_type_for(name)
        out = layer.output_type(it)
        if isinstance(layer, ConvolutionLayer):
            kh, kw = layer.kernel_size
            flops += 2 * out.height * out.width * kh * kw * it.channels \
                * out.channels
        elif isinstance(layer, (DenseLayer, OutputLayer)):
            flops += 2 * it.flat_size() * layer.n_out
    return flops


def resnet_ms_by_kind(events):
    """A profile's device ms by kind for the ResNet step: cuDNN's
    convolutions, its NHWC / NCHW layout transposes, other GEMMs, the BN
    plain tier's reductions (batch statistics, dgamma / dbeta), pooling,
    and elementwise work and the rest (BN's normalise, ReLU, the residual
    adds, casts, Adam)."""
    kinds = dict.fromkeys(("conv", "layout", "gemm", "bn_reduce", "pool",
                           "elementwise"), 0.0)
    for key, ms, _ in events:
        low = key.lower()
        kind = ("layout" if "nhwctonchw" in low or "nchwtonhwc" in low else
                "conv" if any(w in low for w in (
                    "fprop", "dgrad", "wgrad", "convolve", "implicit",
                    "winograd", "cudnn", "fft", "conv")) else
                "gemm" if "gemm" in low or "xmma" in low else
                "bn_reduce" if "reduce" in low else
                "pool" if "pool" in low else "elementwise")
        kinds[kind] += ms
    return kinds


def s2s_conf(pt):
    """The encoder-decoder graph (AdditionRNN's shape, char-RNN widths)."""
    return (pt.NeuralNetConfiguration.builder().seed(12345)
            .updater(pt.Adam(S2S_LR)).graph_builder()
            .add_inputs("encoderInput", "decoderInput")
            .add_layer("encoder", pt.GravesLSTM(n_out=HIDDEN),
                       "encoderInput")
            .add_vertex("lastTimeStep", pt.LastTimeStepVertex(), "encoder")
            .add_vertex("duplicateTimeStep", pt.DuplicateToTimeSeriesVertex(),
                        "lastTimeStep", "decoderInput")
            .add_vertex("merge", pt.MergeVertex(), "decoderInput",
                        "duplicateTimeStep")
            .add_layer("decoder", pt.GravesLSTM(n_out=HIDDEN), "merge")
            .add_layer("output", pt.RnnOutputLayer(
                n_out=VOCAB, activation="softmax", loss="mcxent"), "decoder")
            .set_outputs("output")
            .set_input_types(pt.InputType.recurrent(VOCAB, S2S_T),
                             pt.InputType.recurrent(VOCAB, S2S_T))
            .build())


def two_branch_conf(pt, compute_dtype="bfloat16"):
    """The bf16 two-branch BN graph at the BN-MLP's widths."""
    b = pt.NeuralNetConfiguration.builder().seed(42).updater(pt.Adam(TB_LR))
    if compute_dtype:
        b = b.compute_dtype(compute_dtype)
    b = b.graph_builder().add_inputs("digit", "mirror")
    for side in ("digit", "mirror"):
        b.add_layer(f"{side}_dense", pt.DenseLayer(
            n_out=TB_WIDTH, activation="identity", has_bias=False), side)
        b.add_layer(f"{side}_bn", pt.BatchNormalization(activation="relu"),
                    f"{side}_dense")
    return (b.add_vertex("merge", pt.MergeVertex(), "digit_bn", "mirror_bn")
            .add_layer("out", pt.OutputLayer(n_out=10, activation="softmax",
                                             loss="mcxent"), "merge")
            .set_outputs("out")
            .set_input_types(pt.InputType.feed_forward(784),
                             pt.InputType.feed_forward(784))
            .build())


def graph_path(pt, torch, tag, tmp, root, reset_counts, hand_counts):
    """Main path 10 (phase 14): ComputationGraphs on the card. (a)
    ResNet-50: float32 parity at batch 2 against the CPU (and the CPU's
    float32 against float64), 5 bf16 steps at batch 32, the graph zip with
    Adam state restored on both devices for one more step, times and a
    profile; no hand kernel. (b) GoogLeNet served in process at buckets 1,
    8 and 32 against the CPU. (c) The encoder-decoder graph: 20 Adam steps
    card against CPU from one zip through the LSTM training kernels (2 + 2
    + 2 "cluster" launches a step), and rnn_time_step step by step against
    the CPU through the primal kernel. (d) The bf16 two-branch BN graph: 20
    Adam steps card against CPU through the BN+ReLU kernels (one resident
    forward and backward launch per BN vertex and step, none in
    evaluation), early stopping with a LocalFileModelSaver on the card, a
    GraphTransferLearning head replacement stepped on both devices, and CG
    and L-BFGS line searches card against CPU. Returns the phase's
    numbers."""
    from deeplearning4j_tpu_torch import earlystopping as es
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ExistingDataSetIterator
    from deeplearning4j_tpu_torch.kernels import bn_relu, lstm
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.nn.conf import OptimizationAlgorithm
    from deeplearning4j_tpu_torch.nn.transferlearning import (
        FineTuneConfiguration, GraphTransferLearning)
    from deeplearning4j_tpu_torch.nn.trees import flat_leaves, tree_map
    out = {"card": tag.strip("[]")}
    t_phase = time.perf_counter()

    def no_hand_launches(what):
        c = hand_counts()
        check(all(n == 0 for n in c.values()),
              f"{what} launched hand kernels: {c}")

    # -- (a) ResNet-50 -------------------------------------------------------
    gen = lambda: torch.Generator().manual_seed(51)
    r = np.random.default_rng(52)
    xr = r.normal(size=(R50_B * (R50_STEPS + 1), IMAGE, IMAGE, 3)).astype(
        np.float32)
    yr = np.eye(CLASSES, dtype=np.float32)[r.integers(0, CLASSES, len(xr))]
    small = pt.DataSet(xr[:R50_CMP_B], yr[:R50_CMP_B])
    reset_counts()
    f32 = [zoo.resnet50(CLASSES, IMAGE, compute_dtype=None,
                        device=d).init(generator=gen())
           for d in (DEVICE, "cpu")]
    check(f32[0].num_params() == R50_PARAMS, f"ResNet-50 has "
          f"{f32[0].num_params()} parameters, want {R50_PARAMS}")
    probs = [g.output(small.features)[0].cpu() for g in f32]
    r50_out_err = rel_err(probs[0], probs[1])
    grads = [graph_grads(torch, g, small) for g in f32]
    r50_score_err = abs(grads[0][0] - grads[1][0]) / abs(grads[1][0])
    del f32[1]
    f64 = zoo.resnet50(CLASSES, IMAGE, compute_dtype=None,
                       device="cpu").init(generator=gen())
    f64.conf.conf.dtype = "float64"
    f64.params = tree_map(torch.Tensor.double, f64.params)
    f64.state = tree_map(torch.Tensor.double, f64.state)
    grads.append(graph_grads(torch, f64, small))
    del f64
    gaps = {pair: {k: l2_err(grads[a][1][k].double(),
                             grads[b][1][k].double())
                   for k in grads[b][1]}
            for pair, (a, b) in (("card_vs_cpu", (0, 1)),
                                 ("cpu_f32_vs_f64", (1, 2)),
                                 ("card_vs_cpu_f64", (0, 2)))}
    worst = {pair: max(d.values()) for pair, d in gaps.items()}
    # control: the same gradients through bf16 compute on the card, read
    # against the same limit (what the limit lets through, not a check)
    bf = zoo.resnet50(CLASSES, IMAGE, device=DEVICE).init(generator=gen())
    ctl = {k: l2_err(v.double(), grads[2][1][k].double())
           for k, v in graph_grads(torch, bf, small)[1].items()}
    del bf, grads
    past = {k: (gaps["card_vs_cpu_f64"][k], gaps["cpu_f32_vs_f64"][k])
            for k in gaps["card_vs_cpu_f64"]
            if gaps["card_vs_cpu_f64"][k] > R50_F64_FACTOR
            * gaps["cpu_f32_vs_f64"][k] + R50_GRAD_FLOOR}
    over = lambda d: max([d[k] / gaps["cpu_f32_vs_f64"][k] for k in d
                          if gaps["cpu_f32_vs_f64"][k] >= R50_GRAD_FLOOR]
                         or [0.0])
    ratio, ctl_ratio = over(gaps["card_vs_cpu_f64"]), over(ctl)
    ctl_past = sum(ctl[k] > R50_F64_FACTOR * gaps["cpu_f32_vs_f64"][k]
                   + R50_GRAD_FLOOR for k in ctl)
    check(r50_out_err <= VGG_TOL and not past and r50_score_err <= 1e-4,
          f"ResNet-50 float32 card vs CPU: output {r50_out_err}, score "
          f"{r50_score_err}, tensors past the float64 limit (card, CPU): "
          f"{past}")
    print(f"ResNet-50 ({R50_PARAMS} parameters, {IMAGE} x {IMAGE} x 3, "
          f"{CLASSES} classes) in float32 at batch {R50_CMP_B}: output card "
          f"vs CPU {r50_out_err:.3e} of max (limit {VGG_TOL}); score "
          f"relative {r50_score_err:.3e} (limit 1e-4); first-step gradients "
          f"relative L2, worst tensor: card vs CPU float32 "
          f"{worst['card_vs_cpu']:.3e}, card vs CPU float64 "
          f"{worst['card_vs_cpu_f64']:.3e}, the CPU's float32 vs its "
          f"float64 {worst['cpu_f32_vs_f64']:.3e}; every tensor's card gap to "
          f"float64 within {R50_F64_FACTOR} x the CPU's + {R50_GRAD_FLOOR} "
          f"(largest card / CPU ratio {ratio:.3f} where the CPU's gap is "
          f"past {R50_GRAD_FLOOR}); control, the card in bf16 compute: "
          f"worst tensor {max(ctl.values()):.3e} from float64, largest "
          f"ratio {ctl_ratio:.3f}, {ctl_past} of {len(ctl)} tensors past "
          f"the limit")
    out["resnet50_f32"] = {"output_err": r50_out_err, "grad_worst": worst,
                           "card_over_cpu_f64_gap_max": ratio,
                           "bf16_control_over_cpu_f64_gap_max": ctl_ratio,
                           "bf16_control_past": ctl_past,
                           "score_err": r50_score_err}
    del f32

    r50 = zoo.resnet50(CLASSES, IMAGE, device=DEVICE).init(generator=gen())
    log = StepLog(torch)
    r50.set_listeners(log)
    for i in range(R50_STEPS):
        r50.fit(pt.DataSet(xr[i * R50_B:(i + 1) * R50_B],
                           yr[i * R50_B:(i + 1) * R50_B]))
    r50_scores = [float(s) for s in log.scores]
    check(len(r50_scores) == R50_STEPS and np.isfinite(r50_scores).all(),
          f"ResNet-50 bf16 scores at batch {R50_B}: {r50_scores}")
    print(f"ResNet-50 bf16 training at batch {R50_B} (Adam 1e-3, seeded "
          f"normal images, fixed labels): scores {r50_scores}")
    zr = os.path.join(tmp, "resnet50.zip")
    pt.ModelSerializer.write_model(r50, zr)
    back = [pt.ModelSerializer.restore(zr, device=d) for d in (DEVICE,
                                                               "cpu")]
    for g in back:
        check(g.iteration_count == R50_STEPS and graph_rel_l2(g, r50) == 0
              and all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(
                  flat_leaves(g.updater_state), flat_leaves(
                      r50.updater_state))),
              f"ResNet-50 zip restore on {g.device}")
    nxt = pt.DataSet(xr[-R50_CMP_B:], yr[-R50_CMP_B:])
    resumed = []
    for g in back:
        g.fit(nxt)
        resumed.append(g.score())
    resume_err = abs(resumed[0] - resumed[1]) / abs(resumed[1])
    check(resume_err <= R50_RESUME_TOL, f"ResNet-50 resumed step card "
          f"{resumed[0]} vs CPU {resumed[1]}")
    print(f"ResNet-50 zip (Adam state, iteration {R50_STEPS}) restored on "
          f"both devices bit-equal, one more bf16 step at batch "
          f"{R50_CMP_B}: score card {resumed[0]:.5f} vs CPU {resumed[1]:.5f}"
          f" ({resume_err:.3e} relative, limit {R50_RESUME_TOL})")
    del back
    no_hand_launches("the ResNet-50 path")
    out["resnet50"] = {"scores_b32": r50_scores,
                       "resume_scores": resumed, "resume_err": resume_err}

    # times: step p50, images/s, share of the bf16 dense peak, profile
    rb = pt.DataSet(torch.as_tensor(xr[:R50_B], device=DEVICE),
                    torch.as_tensor(yr[:R50_B], device=DEVICE))
    clock = StepLog(torch)
    r50.set_listeners(clock)
    for _ in range(2):
        r50.fit(rb)
    clock.times.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        r50.fit(rb)
    fit_s = time.perf_counter() - t0
    r50.set_listeners()
    p50 = float(np.median(1e3 * np.diff([t0] + clock.times)))
    fwd = graph_forward_flops(r50)
    step_flop = 3 * fwd * R50_B
    bound = 1e3 * step_flop / BF16_FLOP_PER_S
    events, busy, wall = profile_device(
        torch, lambda: r50.fit(rb),
        f"ResNet-50 bf16 training step (batch {R50_B})", tag, reps=3)
    kinds = resnet_ms_by_kind(events)
    r50_t = {"batch": R50_B, "step_p50_ms": p50,
             "images_per_s": 10 * R50_B / fit_s,
             "forward_gflop_per_image": fwd / 1e9,
             "step_tflop": step_flop / 1e12, "bound_ms": bound,
             "share_of_bf16_peak": bound / p50, "device_busy_ms": busy,
             "profiled_wall_ms": wall, "idle_share": 1 - busy / wall,
             "device_ms_by_kind": kinds}
    print(f"{tag} ResNet-50 training (batch {R50_B}, bf16 compute, float32 "
          f"masters): step p50 {p50:.3f} ms, {r50_t['images_per_s']:.1f} "
          f"images/s; forward {fwd / 1e9:.2f} GFLOP an image, a step 3 x "
          f"{fwd / 1e9:.2f} x {R50_B} = {step_flop / 1e12:.3f} TFLOP, bound "
          f"{bound:.2f} ms at {BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s: "
          f"{100 * bound / p50:.1f} % of the bf16 dense peak; device busy "
          f"{busy:.3f} of {wall:.3f} ms (idle share {1 - busy / wall:.3f}): "
          + ", ".join(f"{k} {ms:.3f} ms" for k, ms in kinds.items()))
    no_hand_launches("the ResNet-50 timed steps")
    out["resnet50_times"] = r50_t
    del r50, rb

    # -- (b) GoogLeNet served ---------------------------------------------
    goog = [zoo.googlenet(CLASSES, IMAGE, device=d).init(
        generator=torch.Generator().manual_seed(53)) for d in (DEVICE,
                                                               "cpu")]
    check(goog[0].num_params() == GOOG_PARAMS, f"GoogLeNet has "
          f"{goog[0].num_params()} parameters, want {GOOG_PARAMS}")
    zg = os.path.join(tmp, "googlenet.zip")
    pt.ModelSerializer.write_model(goog[0], zg)
    reg = pt.ModelRegistry(buckets=BUCKETS, device=DEVICE)
    v = reg.register("googlenet", zg)
    check(v.model_kind == "ComputationGraph"
          and v.example_shape == (IMAGE, IMAGE, 3),
          f"GoogLeNet registered as {v.model_kind} {v.example_shape}")
    r = np.random.default_rng(54)
    goog_err, goog_t = 0.0, {}
    for b in BUCKETS:
        x = r.normal(size=(b, IMAGE, IMAGE, 3)).astype(np.float32)
        got, _ = reg.predict("googlenet", x)
        want = goog[1].output(x)[0].numpy()
        check(got.shape == (b, CLASSES) and np.isfinite(got).all()
              and np.abs(got.sum(-1) - 1).max() <= 1e-4,
              f"GoogLeNet bucket {b} output")
        goog_err = max(goog_err, float(np.abs(got - want).max()))
        times = []
        for _ in range(20):
            t0 = time.perf_counter()
            reg.predict("googlenet", x)
            times.append(time.perf_counter() - t0)
        goog_t[f"predict_p50_ms_b{b}"] = 1e3 * float(np.median(times))
    check(goog_err <= SERVE_TOL, f"GoogLeNet served vs CPU: {goog_err}")
    print(f"{tag} GoogLeNet ({GOOG_PARAMS} parameters, {IMAGE}, {CLASSES} "
          f"classes) zip registered and served in process: max abs err vs "
          f"the CPU {goog_err:.3e} (limit {SERVE_TOL}); registry.predict "
          "p50 " + ", ".join(f"bucket {b} "
                             f"{goog_t[f'predict_p50_ms_b{b}']:.3f} ms"
                             for b in BUCKETS))
    no_hand_launches("the GoogLeNet path")
    out["googlenet"] = {"serve_err": goog_err, **goog_t}
    del goog, reg, v

    # -- (c) the encoder-decoder graph through the LSTM kernels -----------
    for f in (VOCAB, VOCAB + HIDDEN):
        check(lstm.sequence_variant(S2S_B, f, HIDDEN) == "cluster",
              f"seq2seq LSTM plan at F={f}")
    windows = text_windows(root, ALPHABET, S2S_STEPS * S2S_B,
                           2 * S2S_T + 1)
    eye = np.eye(VOCAB, dtype=np.float32)
    enc, dec, lab = (eye[windows[:, :S2S_T]],
                     eye[windows[:, S2S_T:2 * S2S_T]],
                     eye[windows[:, S2S_T + 1:]])
    batches = [pt.MultiDataSet(features=[enc[i:i + S2S_B],
                                         dec[i:i + S2S_B]],
                               labels=[lab[i:i + S2S_B]])
               for i in range(0, len(enc), S2S_B)]
    s2s = pt.ComputationGraph(s2s_conf(pt), device=DEVICE).init(
        generator=torch.Generator().manual_seed(55))
    z0 = os.path.join(tmp, "s2s0.zip")
    pt.ModelSerializer.write_model(s2s, z0)
    nets = [pt.ModelSerializer.restore(z0, device=d) for d in (DEVICE,
                                                               "cpu")]
    g = [graph_grads(torch, n, batches[0]) for n in nets]
    s2s_grad_err = grads_rel_max(g[0][1], g[1][1])
    check(s2s_grad_err <= GRAD_TOL, f"seq2seq first-step gradients card vs "
          f"CPU: {s2s_grad_err} > {GRAD_TOL}")
    logs = [StepLog(torch), StepLog()]
    for n, lg in zip(nets, logs):
        n.set_listeners(lg)
    reset_counts()
    nets[0].fit(ExistingDataSetIterator(batches))
    counts, variants = lstm.launch_counts(), lstm.variant_counts()
    nets[1].fit(ExistingDataSetIterator(batches))
    per = 2 * S2S_STEPS
    check(counts == {"launches": 0, "residual_launches": per,
                     "adjoint_launches": per, "reduction_launches": per},
          f"seq2seq training launches {counts}, want {per} of each "
          "training kernel and no primal forward")
    for kind in ("residual", "adjoint"):
        check(variants[kind] == {"cluster": per, "streamed": 0},
              f"seq2seq {kind} variants {variants[kind]}")
    check(set(bn_relu.launch_counts().values()) == {0},
          "the seq2seq path launched BN+ReLU kernels")
    cards = [float(s) for s in logs[0].scores]
    cpus = [float(s) for s in logs[1].scores]
    s2s_score_err = max(abs(a - b) for a, b in zip(cards, cpus))
    s2s_param_err = graph_rel_l2(nets[0], nets[1])
    check(len(cards) == S2S_STEPS and s2s_score_err <= SCORE_TOL
          and s2s_param_err <= PARAM_TOL,
          f"seq2seq 20 steps card vs CPU: scores {s2s_score_err}, "
          f"parameters {s2s_param_err}")
    step_ms = float(np.median(1e3 * np.diff(logs[0].times)))
    print(f"seq2seq graph (AdditionRNN shape: one-hot {VOCAB}, T={S2S_T}, "
          f"encoder and decoder GravesLSTM({HIDDEN}), B={S2S_B}, Adam "
          f"{S2S_LR}) trained {S2S_STEPS} steps with fit over MultiDataSets "
          f"on the card and the CPU from one zip: first-step gradients "
          f"{s2s_grad_err:.3e} of max (limit {GRAD_TOL}), scores "
          f"{cards[0]:.4f} -> {cards[-1]:.4f}, max err {s2s_score_err:.3e} "
          f"(limit {SCORE_TOL}), final parameters relative L2 "
          f"{s2s_param_err:.3e} (limit {PARAM_TOL}); launches {counts}, "
          f"variants {variants}; {tag} step p50 {step_ms:.3f} ms")
    out["seq2seq"] = {"grad_err": s2s_grad_err, "score_err": s2s_score_err,
                      "param_err": s2s_param_err, "launches": counts,
                      "variants": variants, "step_p50_ms": step_ms,
                      "scores_card": cards}
    # rnn_time_step on the trained graph, both inputs one step at a time
    for n in nets:
        n.rnn_clear_previous_state()
    reset_counts()
    step_err = 0.0
    for t in range(S2S_STEP_T):
        a, b = enc[:S2S_STEP_B, t], dec[:S2S_STEP_B, t]
        got = nets[0].rnn_time_step(a, b).cpu()
        want = nets[1].rnn_time_step(a, b)
        step_err = max(step_err, (got - want).abs().max().item())
    step_counts = lstm.launch_counts()
    check(step_err <= SERVE_TOL and step_counts == {
        "launches": 2 * S2S_STEP_T, "residual_launches": 0,
        "adjoint_launches": 0, "reduction_launches": 0},
          f"seq2seq rnn_time_step: err {step_err}, launches {step_counts}")
    print(f"seq2seq rnn_time_step, {S2S_STEP_T} steps of both inputs at batch "
          f"{S2S_STEP_B}: max abs err vs CPU {step_err:.3e} (limit "
          f"{SERVE_TOL}), {step_counts['launches']} primal LSTM launches "
          "(2 a step)")
    out["seq2seq"].update(rnn_time_step_err=step_err,
                          rnn_time_step_launches=step_counts["launches"])
    del nets, s2s

    # -- (d) the bf16 two-branch BN graph through the BN+ReLU kernels -----
    x_tr, y_tr, x_te, y_te = pt.bundled_mnist_subset()
    mirror = lambda x: x.reshape(-1, 28, 28)[:, :, ::-1].reshape(-1, 784)
    r = np.random.default_rng(56)
    tb_batches = []
    for _ in range(TB_STEPS // 2):
        order = r.permutation(len(x_tr))
        for i in range(2):
            idx = order[i * TB_B:(i + 1) * TB_B]
            tb_batches.append(pt.MultiDataSet(
                features=[x_tr[idx], mirror(x_tr[idx])], labels=[y_tr[idx]]))
    held = [pt.MultiDataSet(features=[x_te, mirror(x_te)], labels=[y_te])]
    tb = pt.ComputationGraph(two_branch_conf(pt), device=DEVICE).init(
        generator=torch.Generator().manual_seed(57))
    zt = os.path.join(tmp, "two_branch0.zip")
    pt.ModelSerializer.write_model(tb, zt)
    nets = [pt.ModelSerializer.restore(zt, device=d) for d in (DEVICE,
                                                               "cpu")]
    check(nets[0].conf.vertices["digit_bn"]._helper(torch.zeros(
        TB_B, TB_WIDTH, dtype=torch.bfloat16), True) == "pallas",
          "the two-branch BN vertices do not take the BN+ReLU tier")
    reset_counts()
    g = [graph_grads(torch, n, tb_batches[0]) for n in nets]
    tb_grad_err = grads_rel_max(g[0][1], g[1][1])
    first = bn_relu.launch_counts()
    check(tb_grad_err <= BF16_GRAD_TOL and first == {
        "fwd_launches": 2, "bwd_launches": 2},
          f"two-branch first-step gradients {tb_grad_err}, BN launches "
          f"{first}")
    logs = [StepLog(torch), StepLog()]
    for n, lg in zip(nets, logs):
        n.set_listeners(lg)
    reset_counts()
    nets[0].fit(ExistingDataSetIterator(tb_batches))
    tb_counts, tb_variants = bn_relu.launch_counts(), bn_relu.variant_counts()
    nets[1].fit(ExistingDataSetIterator(tb_batches))
    per = 2 * TB_STEPS
    check(tb_counts == {"fwd_launches": per, "bwd_launches": per}
          and tb_variants == {"fwd": {"resident": per, "streamed": 0},
                              "bwd": {"resident": per, "streamed": 0}},
          f"two-branch BN launches {tb_counts} {tb_variants}, want {per} "
          "resident forward and backward")
    check(set(lstm.launch_counts().values()) == {0},
          "the two-branch path launched LSTM kernels")
    cards = [float(s) for s in logs[0].scores]
    cpus = [float(s) for s in logs[1].scores]
    tb_score_err = max(abs(a - b) for a, b in zip(cards, cpus))
    tb_param_err = graph_rel_l2(nets[0], nets[1], TB_LR, TB_STEPS)
    tb_state_err = graph_rel_l2(nets[0], nets[1], state=True)
    check(tb_score_err <= BF16_SCORE_TOL and tb_param_err <= BF16_PARAM_TOL
          and tb_state_err <= BF16_PARAM_TOL,
          f"two-branch 20 steps card vs CPU: scores {tb_score_err}, "
          f"parameters {tb_param_err}, running statistics {tb_state_err}")
    reset_counts()
    evs = [n.evaluate(ExistingDataSetIterator(held)) for n in nets]
    check(set(bn_relu.launch_counts().values()) == {0},
          f"evaluation launched BN kernels: {bn_relu.launch_counts()}")
    tb_step_ms = float(np.median(1e3 * np.diff(logs[0].times)))
    print(f"bf16 two-branch graph (2 x 784 -> Dense({TB_WIDTH}) -> "
          f"BatchNormalization(relu), Merge, softmax 10; B={TB_B}, Adam "
          f"{TB_LR}) trained {TB_STEPS} steps on the card and the CPU from "
          f"one zip: first-step gradients {tb_grad_err:.3e} of max (limit "
          f"{BF16_GRAD_TOL}), scores {cards[0]:.4f} -> {cards[-1]:.4f}, max "
          f"err {tb_score_err:.3e} (limit {BF16_SCORE_TOL}), parameters "
          f"{tb_param_err:.3e} and running statistics {tb_state_err:.3e} "
          f"relative L2 (limit {BF16_PARAM_TOL}); BN launches {tb_counts} "
          f"{tb_variants}, none in evaluation; held-out accuracy card "
          f"{evs[0].accuracy():.4f}, CPU {evs[1].accuracy():.4f}; {tag} "
          f"step p50 {tb_step_ms:.3f} ms")
    out["two_branch"] = {"grad_err": tb_grad_err, "score_err": tb_score_err,
                         "param_err": tb_param_err,
                         "state_err": tb_state_err, "launches": tb_counts,
                         "variants": tb_variants, "step_p50_ms": tb_step_ms,
                         "accuracy_card": evs[0].accuracy(),
                         "accuracy_cpu": evs[1].accuracy()}

    # early stopping on the card, the best model restored from its zip
    es_dir = os.path.join(tmp, "early_stopping")
    saver = es.LocalFileModelSaver(es_dir)
    cfg = (es.EarlyStoppingConfiguration.Builder()
           .score_calculator(es.DataSetLossCalculator(
               ExistingDataSetIterator(held)))
           .epoch_termination_conditions(
               es.ScoreImprovementEpochTerminationCondition(1, 1e-3),
               es.MaxEpochsTerminationCondition(4))
           .model_saver(saver).build())
    es_net = pt.ModelSerializer.restore(zt, device=DEVICE)
    res = es.EarlyStoppingTrainer(
        cfg, es_net, ExistingDataSetIterator(tb_batches[:2])).fit()
    best = res.best_model
    again = es.DataSetLossCalculator(ExistingDataSetIterator(
        held)).calculate_score(best)
    check(best.device.type == "cuda"
          and os.path.exists(os.path.join(es_dir, "bestModel.zip"))
          and abs(again - res.best_model_score) <= 1e-6,
          f"early stopping: best model on {best.device}, score {again} vs "
          f"{res.best_model_score}")
    print(f"early stopping on the card ({res.termination_reason}: "
          f"{res.termination_details} after {res.total_epochs} epochs): "
          f"validation scores {res.score_vs_epoch}, best epoch "
          f"{res.best_model_epoch}, its zip restored on the card scores "
          f"{again:.6f} (recorded {res.best_model_score:.6f})")
    out["early_stopping"] = {"epochs": res.total_epochs,
                             "reason": res.termination_details,
                             "scores": res.score_vs_epoch}

    # transfer learning: a new head on the frozen branches, card vs CPU
    tl_nets = []
    for n in nets:
        tl_nets.append(
            GraphTransferLearning.GraphBuilder(n)
            .fine_tune_configuration(FineTuneConfiguration.Builder()
                                     .updater(pt.Sgd(0.05)).build())
            .set_feature_extractor("merge")
            .remove_vertex_and_connections("out")
            .add_layer("parity", pt.OutputLayer(n_out=2, activation="softmax",
                                                loss="mcxent"), "merge")
            .set_outputs("parity").build())
    y2 = np.eye(2, dtype=np.float32)[y_tr[:TB_B].argmax(1) % 2]
    parity = pt.MultiDataSet(features=[x_tr[:TB_B], mirror(x_tr[:TB_B])],
                             labels=[y2])
    reset_counts()
    frozen = tl_nets[0].params["digit_dense"]["W"].clone()
    for n in tl_nets:
        n.fit(parity)
    tl_counts = bn_relu.launch_counts()
    tl_score_err = abs(tl_nets[0].score() - tl_nets[1].score())
    tl_param_err = graph_rel_l2(tl_nets[0], tl_nets[1])
    check(torch.equal(tl_nets[0].params["digit_dense"]["W"], frozen)
          and tl_score_err <= BF16_SCORE_TOL
          and tl_param_err <= BF16_PARAM_TOL,
          f"transfer learning step card vs CPU: score {tl_score_err}, "
          f"parameters {tl_param_err}")
    print(f"GraphTransferLearning (branches frozen up to the merge, a new "
          f"2-class head, SGD 0.05): one step on the card and the CPU, "
          f"score err {tl_score_err:.3e}, parameters {tl_param_err:.3e} "
          f"relative L2, frozen weights unmoved; BN launches {tl_counts}")
    out["transfer"] = {"score_err": tl_score_err, "param_err": tl_param_err,
                       "bn_launches": tl_counts}
    del nets, tl_nets, es_net, best

    # line search: CG and L-BFGS, card against CPU
    r = np.random.default_rng(58)
    xl = r.normal(size=(LS_N, LS_D)).astype(np.float32)
    yl = (xl @ r.normal(size=(LS_D, 1)) + 0.01 * r.normal(
        size=(LS_N, 1))).astype(np.float32)
    ls = {}
    for algo in (OptimizationAlgorithm.CONJUGATE_GRADIENT,
                 OptimizationAlgorithm.LBFGS):
        conf = (pt.NeuralNetConfiguration.builder().seed(59)
                .optimization_algo(algo).max_num_line_search_iterations(8)
                .list()
                .layer(pt.DenseLayer(n_out=64, activation="tanh"))
                .layer(pt.OutputLayer(n_out=1, activation="identity",
                                      loss="mse"))
                .set_input_type(pt.InputType.feed_forward(LS_D)).build())
        pair = [pt.MultiLayerNetwork(conf, device=d).init(
            generator=torch.Generator().manual_seed(60))
            for d in (DEVICE, "cpu")]
        scores = [[], []]
        for _ in range(LS_ITERS):
            for n, s in zip(pair, scores):
                n.fit(pt.DataSet(xl, yl))
                s.append(n.score())
        err = max(abs(a - b) / abs(b) for a, b in zip(*scores))
        check(err <= LS_TOL and scores[0][-1] < scores[0][0],
              f"{algo} card vs CPU: scores {scores}")
        ls[algo] = {"scores_card": scores[0], "rel_err": err}
    print(f"line search on the card ({LS_ITERS} iterations, {LS_N} x {LS_D}"
          " least squares through Dense(64, tanh)): " + ", ".join(
              f"{a} scores {v['scores_card'][0]:.4f} -> "
              f"{v['scores_card'][-1]:.4f}, max relative err vs CPU "
              f"{v['rel_err']:.3e}" for a, v in ls.items())
          + f" (limit {LS_TOL})")
    out["line_search"] = ls
    out["seconds"] = time.perf_counter() - t_phase
    print(f"{tag} main path 10 (ComputationGraphs): {out['seconds']:.1f} s")
    print(json.dumps({"graph_path": out}))
    return out


# ---- phase 2's CUDA-graph checks, and main path 11: the training loop -----
def trees_equal(torch, a, b):
    """Two trees of tensors hold the same bits, leaf for leaf."""
    from deeplearning4j_tpu_torch.nn.trees import flatten_tree
    la, lb = flatten_tree(a)[0], flatten_tree(b)[0]
    return len(la) == len(lb) and all(
        (x is None and y is None) or (
            x is not None and y is not None and x.shape == y.shape
            and torch.equal(x.cpu(), y.cpu()))
        for x, y in zip(la, lb))


def nets_equal(torch, a, b):
    """Parameters, updater state, layer state and counters bit-equal."""
    return (trees_equal(torch, a.params, b.params)
            and trees_equal(torch, a.updater_state, b.updater_state)
            and trees_equal(torch, a.state, b.state)
            and a.iteration_count == b.iteration_count
            and a.epoch_count == b.epoch_count)


def launches_in(delta):
    """Total launches in a `kernels.count_delta` (or `tally_delta`)."""
    return sum(sum(totals.values()) for totals, _ in delta.values())


def replay_check(torch, kernels, what, make, call):
    """Capture one call of a kernel wrapper in a CUDA graph (the wrapper
    launches on the current stream, as a capture needs), replay it on
    three fresh inputs copied into the captured ones, and hold each replay
    bit-equal to an eager call on the same inputs. The capture's launches
    go to a tally instead of the counters and every replay adds them:
    1 launch captured, 3 counted after the replays. Returns the captured
    launches."""
    def quiet(fn):
        with kernels.tally():
            return fn()

    static = quiet(lambda: make(0))
    quiet(lambda: call(*static))            # first launch: attributes
    torch.cuda.synchronize()
    before = kernels.count_snapshot()
    graph = torch.cuda.CUDAGraph()
    with kernels.tally() as launched, torch.cuda.graph(graph):
        out = call(*static)
    captured = kernels.tally_delta(launched)
    check(launches_in(captured) == 1, f"{what}: the capture recorded "
          f"{launches_in(captured)} launches, want 1")
    outs = [o for o in (out if isinstance(out, (tuple, list)) else (out,))]
    for r in (1, 2, 3):
        fresh = quiet(lambda: make(r))
        for s, f in zip(static, fresh):
            if isinstance(s, torch.Tensor):
                s.copy_(f)
        graph.replay()
        kernels.add_counts(captured)
        want = quiet(lambda: call(*fresh))
        want = want if isinstance(want, (tuple, list)) else (want,)
        torch.cuda.synchronize()
        check(all((o is None and w is None) or torch.equal(o, w)
                  for o, w in zip(outs, want)),
              f"{what}: replay {r} differs from the eager launch")
    got = kernels.count_delta(before, kernels.count_snapshot())
    check(launches_in(got) == 3 and all(
        got[m][0] == {k: 3 * n for k, n in captured[m][0].items()}
        for m in got), f"{what}: counters read {got} after 3 replays of "
        f"{captured}")
    return captured


def capture_checks(torch, kernels, lstm, attention, bn_relu, tag):
    """Phase 2's CUDA-graph check of every kernel variant at the main
    paths' shapes: capture one call, replay it three times, each replay
    bit-equal to an eager launch, the counters at 1 captured + 3
    replayed."""
    t0 = time.perf_counter()
    cases = []

    def lstm_make(T, B, F, H, kind):
        def make(r):
            args = lstm_inputs(torch, T, B, F, H, seed=100 + r)
            if kind in ("fwd", "residual"):
                return args + [1.0]
            x, W, b, peep, h0, c0 = args
            res = lstm.lstm_sequence_reference(*args, 1.0,
                                               save_residuals=True)
            dhs, dhT, dcT = cotangents(torch, T, B, H, seed=200 + r)
            if kind == "adjoint":
                return [W, peep, c0, *res[1:], dhs, dhT, dcT, F]
            dgates = cotangents(torch, T, B, 4 * H, seed=300 + r)[0]
            return [x, res[0], h0, res[1], c0, dgates]
        return make

    calls = {"fwd": lstm.fused_lstm_sequence,
             "residual": lstm.lstm_residual_forward,
             "adjoint": lstm.lstm_adjoint,
             "reduction": lstm.lstm_param_grads}
    for kind, shape in (("fwd", (SEQ, 32, VOCAB, HIDDEN)),
                        ("fwd", STREAMED_SHAPES[0]),
                        ("residual", (TRAIN_TBPTT, TRAIN_B, VOCAB, HIDDEN)),
                        ("residual", STREAMED_SHAPES[0]),
                        ("adjoint", (TRAIN_TBPTT, TRAIN_B, VOCAB, HIDDEN)),
                        ("adjoint", STREAMED_SHAPES[0]),
                        ("reduction", (TRAIN_TBPTT, TRAIN_B, VOCAB,
                                       HIDDEN))):
        T, B, F, H = shape
        variant = ("" if kind == "reduction"
                   else lstm.sequence_variant(B, F, H))
        cases.append((f"LSTM {kind} {variant} T={T} B={B} F={F} H={H}",
                      lstm_make(T, B, F, H, kind), calls[kind]))

    def attn_make(B, T, H, Dh, dtype, kind):
        dt = getattr(torch, dtype)

        def make(r):
            q, k, v = (t.to(dt) for t in attention_inputs(
                torch, B, T, T, H, Dh, seed=400 + r))
            if kind in ("fwd", "lse"):
                return [q, k, v, True]
            o, lse = attention.attention_reference_heads_lse(q, k, v, True)
            do = attention_inputs(torch, B, T, T, H, Dh,
                                  seed=500 + r)[0].to(dt)
            if kind == "dq":
                return [q, k, v, o, lse, do, True]
            dsum = (do.float() * o.float()).sum(-1).permute(0, 2, 1) \
                .contiguous()
            return [q, k, v, do, lse, dsum, True]
        return make

    acalls = {"fwd": attention.flash_attention_heads,
              "lse": attention.flash_attention_fwd_lse_heads,
              "dq": attention.attention_bwd_dq,
              "dkv": attention.attention_bwd_dkv}
    Dh = LM_WIDTH // LM_HEADS
    for kinds, (B, T, H, Dh_, dt), variant in (
            (("fwd", "lse", "dq", "dkv"),
             (LM_CMP_B, LM_SEQ, LM_HEADS, Dh, "float32"), "tiled / simt"),
            (("dq", "dkv"), (LM_CMP_B, LM_SEQ, LM_HEADS, Dh, "bfloat16"),
             "wgmma"),
            (("fwd", "lse", "dq", "dkv"), (2, LM_SEQ, 2, 512, "float32"),
             "wide")):
        for kind in kinds:
            cases.append((f"attention {kind} {variant} B={B} T={T} H={H} "
                          f"Dh={Dh_} {dt}", attn_make(B, T, H, Dh_, dt, kind),
                          acalls[kind]))

    def bn_make(N, C, kind):
        def make(r):
            x, g, b, dy = bn_args(torch, N, C, "bfloat16", seed=600 + r)
            if kind == "fwd":
                return [x, g, b]
            y, mean, var = bn_relu.bn_relu_reference(x, g, b)
            return [x, g, b, mean, var, dy]
        return make

    for N, C in ((MLP_B, MLP_WIDTH), BN_STREAMED[1]):
        for kind, fn in (("fwd", bn_relu.bn_relu_forward),
                         ("bwd", bn_relu.bn_relu_backward)):
            variant = bn_relu.bn_plan(N, C, 2, kind == "bwd").variant
            cases.append((f"BN+ReLU {kind} {variant} N={N} C={C} bfloat16",
                          bn_make(N, C, kind), fn))
    for what, make, call in cases:
        replay_check(torch, kernels, what, make, call)
    print(f"{tag} CUDA graphs: {len(cases)} kernel variants captured and "
          "replayed 3 times each on fresh inputs, every replay bit-equal "
          "to an eager launch, counters 1 captured + 3 replayed each "
          f"({time.perf_counter() - t0:.1f} s)")
    return len(cases)


def window_profile(torch, fn, reps=1):
    """Device busy ms, host wall ms and host-to-device copy ms of `fn`
    (torch.profiler, device-side events only)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    busy = h2d = 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        ms = e.self_device_time_total / 1e3
        busy += ms
        if "htod" in e.key.lower() or "host to device" in e.key.lower():
            h2d += ms
    check(busy > 0, "torch.profiler recorded no device time")
    return busy, wall, h2d


def bn_mlp_err(a, b, steps, pre_bn=(0, 2)):
    """Largest per-tensor relative L2 error of the parameters (against
    Adam's reach where a tensor is small) and of the running
    variances, with the name of that tensor; the pre-BN biases, whose
    gradient is 0 up to rounding (Adam moves them by noise, up to its
    reach lr x steps an entry, either way), are held as phase 8 holds
    them: both sides within that reach."""
    worst, name = 0.0, ""
    reach_entry = MLP_LR * steps
    for i, (p, q) in enumerate(zip(a.params, b.params)):
        for k in q:
            x, y = p[k].detach().cpu(), q[k].detach().cpu()
            if i in pre_bn and k == "b":
                check(max(x.abs().max().item(), y.abs().max().item())
                      <= reach_entry * 1.001, f"pre-BN bias {i} moved "
                      f"past Adam's reach {reach_entry}")
                continue
            scale = max(y.norm().item(),
                        reach_entry * y.numel() ** 0.5)
            err = (x - y).norm().item() / scale
            if err > worst:
                worst, name = err, f"{i}/{k}"
    for i in (1, 3):
        x, y = (n.state[i]["var"].detach().cpu() for n in (a, b))
        err = ((x - y).norm() / y.norm()).item()
        if err > worst:
            worst, name = err, f"{i}/var"
    return worst, name


class EdgeLog:
    """Listener: the score and the host time (after a device sync) of every
    iteration_done; under a window they come at the window's edge."""

    def __init__(self, torch, sync=True):
        self.torch, self.sync = torch, sync
        self.scores, self.times = [], []

    def iteration_done(self, model, iteration):
        self.scores.append(float(model._score))
        if self.sync:
            self.torch.cuda.synchronize()
        self.times.append(time.perf_counter())


# the training loop (main path 11): the BN-MLP of phase 8 on 20 batches of
# seeded normal rows (the bundled digits give two batches an epoch), the
# char-RNN of phase 6 on its 10 text batches, 8 steps of the bf16 LM of
# phase 9 at batch 16, 8 steps of the two-branch graph of phase 14
LOOP_BATCHES, LOOP_BIG_B = 20, 4096
LOOP_LM_STEPS, LOOP_TB_STEPS = 8, 8


def loop_path(pt, torch, tag, tmp, root, reset_counts):
    """Main path 11 (phase 15): the training-loop machinery on the card,
    held against the same zips and batches on the CPU. Returns its
    launches and numbers."""
    from deeplearning4j_tpu_torch.fault import (FaultyIterator, GuardPolicy,
                                                SimulatedCrash,
                                                TrainingGuard,
                                                crash_at_write)
    from deeplearning4j_tpu_torch.kernels import attention, bn_relu, lstm
    from deeplearning4j_tpu_torch.telemetry import TelemetrySession
    from deeplearning4j_tpu_torch.telemetry import runtime as tel_runtime
    t_phase = time.perf_counter()
    out = {"card": tag.strip("[]")}
    L = pt.ListDataSetIterator

    # -- (a) the bf16 BN-MLP through kernels 4-5 --------------------------
    r = np.random.default_rng(71)
    xs = r.normal(size=(LOOP_BATCHES * MLP_B, 784)).astype(np.float32)
    ys = np.eye(10, dtype=np.float32)[r.integers(0, 10, len(xs))]
    batches = [pt.DataSet(xs[i:i + MLP_B], ys[i:i + MLP_B])
               for i in range(0, len(xs), MLP_B)]
    halves = [pt.DataSet(xs[i:i + MLP_B // 2], ys[i:i + MLP_B // 2])
              for i in range(0, len(xs), MLP_B // 2)]
    mlp_json = bn_mlp_json(pt)
    zpath = os.path.join(tmp, "loop_mlp.zip")
    pt.ModelSerializer.write_model(pt.MultiLayerNetwork(
        pt.MultiLayerConfiguration.from_json(mlp_json), device=DEVICE).init(
        generator=torch.Generator().manual_seed(72)), zpath)
    net = lambda dev=DEVICE: pt.ModelSerializer.restore(zpath, device=dev)

    mlp_err = bn_mlp_err

    def run(k, dev=DEVICE, data=None, m=1, **kw):
        n = net(dev)
        log = EdgeLog(torch, sync=False)
        n.set_listeners(log)
        n.fit(L(batches if data is None else data), superstep=k,
              grad_accumulation=m, **kw)
        if dev == DEVICE:
            torch.cuda.synchronize()
        return n, log.scores

    reset_counts()
    t0 = time.perf_counter()
    ref, ref_scores = run(1)
    eager_s = time.perf_counter() - t0
    eager_counts = bn_relu.variant_counts()
    runs, counts = {}, {}
    for k in (4, 3, "epoch"):
        reset_counts()
        t0 = time.perf_counter()
        runs[k] = run(k)
        counts[k] = (bn_relu.variant_counts(), time.perf_counter() - t0)
        check(nets_equal(torch, runs[k][0], ref) and runs[k][1] == ref_scores,
              f"BN-MLP superstep={k} on the card differs from superstep=1")
    want = {kind: {"resident": 2 * LOOP_BATCHES, "streamed": 0}
            for kind in ("fwd", "bwd")}
    for k, (c, _) in list(counts.items()) + [("1 (eager)", (eager_counts,
                                                            0))]:
        check(c == want, f"BN-MLP superstep={k}: BN launches {c}, want "
              f"{want} (one resident forward and backward per BN layer "
              "and step, through the replays)")
    n_graphs = len(runs[4][0].__dict__.get("_captured_steps", {}))
    check(n_graphs == 1, f"superstep=4 captured {n_graphs} graphs, want 1")
    cpu_ref, cpu_scores = run(1, "cpu")
    cpu4, cpu4_scores = run(4, "cpu")
    check(nets_equal(torch, cpu4, cpu_ref), "BN-MLP superstep=4 on the CPU "
          "differs from superstep=1")
    score_err = float(np.abs(np.subtract(runs[4][1], cpu4_scores)).max())
    param_err, param_at = mlp_err(runs[4][0], cpu4, LOOP_BATCHES)
    check(score_err <= BF16_SCORE_TOL, f"BN-MLP superstep=4 card vs CPU "
          f"scores {score_err} > {BF16_SCORE_TOL}")
    check(param_err <= BF16_PARAM_TOL, f"BN-MLP superstep=4 card vs CPU "
          f"parameters / running variances {param_err} (tensor {param_at}) "
          f"> {BF16_PARAM_TOL}")
    print(f"{tag} loop (a) BN-MLP bf16, {LOOP_BATCHES} steps: superstep 4, "
          "3 (ragged last window) and epoch bit-equal to 1 on the card "
          "(parameters, updater state, running statistics, counters, "
          f"scores); one capture; BN launches {counts[4][0]} through the "
          f"replays; fit wall s: eager {eager_s:.2f}, "
          + ", ".join(f"K={k} {c[1]:.2f}" for k, c in counts.items())
          + f" (first windows capture); card vs CPU at K=4: scores "
          f"{score_err:.3e} (limit {BF16_SCORE_TOL}), parameters and "
          f"running variances {param_err:.3e} at {param_at} (limit "
          f"{BF16_PARAM_TOL})")
    out["bn_mlp"] = {"score_err": score_err, "param_err": param_err,
                     "launches": counts[4][0]}

    # dropout: the generator registered with the graph advances as an
    # eager step does
    drop_conf = pt.MultiLayerConfiguration.from_json(mlp_json)
    drop_conf.layers[0].dropout = 0.5
    dz = os.path.join(tmp, "loop_drop.zip")
    pt.ModelSerializer.write_model(pt.MultiLayerNetwork(
        drop_conf, device=DEVICE).init(
        generator=torch.Generator().manual_seed(73)), dz)
    drops = []
    for k in (1, 4):
        n = pt.ModelSerializer.restore(dz, device=DEVICE)
        n.fit(L(batches[:8]), superstep=k)
        drops.append(n)
    check(nets_equal(torch, *drops) and torch.equal(
        drops[0]._generator.get_state(), drops[1]._generator.get_state()),
        "BN-MLP with dropout: superstep=4 differs from 1 on the card")
    print(f"{tag} loop (a) dropout 0.5: superstep=4 bit-equal to 1 on the "
          "card, generator states equal")

    # gradient accumulation: 2 x 64 rows a step. Against native batch 128
    # it is the same math only without BN (a BN layer normalises over each
    # microbatch): the BN-MLP's gap is printed, and mlp_mnist in bf16 (the
    # same widths, Dense(relu), no BN) is held to the bf16 limits
    acc1, acc1_s = run(1, data=halves, m=2)
    acc2, acc2_s = run(2, data=halves, m=2)
    check(nets_equal(torch, acc1, acc2) and acc1_s == acc2_s,
          "grad_accumulation=2: superstep 2 differs from 1 on the card")
    bn_acc = (float(np.abs(np.subtract(acc1_s, ref_scores)).max()),
              mlp_err(acc1, ref, LOOP_BATCHES)[0])
    plain_zip = os.path.join(tmp, "loop_plain_mlp.zip")
    pt.ModelSerializer.write_model(pt.MultiLayerNetwork(
        plain_mlp_conf(pt), device=DEVICE).init(
        generator=torch.Generator().manual_seed(79)), plain_zip)
    plain = []
    for data, m in ((batches, 1), (halves, 2)):
        n = pt.ModelSerializer.restore(plain_zip, device=DEVICE)
        log = EdgeLog(torch, sync=False)
        n.set_listeners(log)
        n.fit(L(data), superstep=2, grad_accumulation=m)
        plain.append((n, log.scores))
    acc_score = float(np.abs(np.subtract(plain[0][1], plain[1][1])).max())
    acc_param = max(
        (a - b).norm().item() / max(b.norm().item(), MLP_LR * LOOP_BATCHES
                                    * b.numel() ** 0.5)
        for p, q in zip(plain[1][0].params, plain[0][0].params)
        for a, b in ((p[k].detach().cpu(), q[k].detach().cpu()) for k in q))
    check(acc_score <= BF16_SCORE_TOL and acc_param <= BF16_PARAM_TOL,
          f"mlp_mnist grad_accumulation=2 x 64 against batch 128: scores "
          f"{acc_score}, parameters {acc_param} (limits {BF16_SCORE_TOL}, "
          f"{BF16_PARAM_TOL})")
    print(f"{tag} loop (a) grad_accumulation=2 at batch 64: superstep 2 "
          f"bit-equal to 1 on the card; mlp_mnist (bf16, no BN) against "
          f"native batch 128: scores {acc_score:.3e}, parameters "
          f"{acc_param:.3e} (limits {BF16_SCORE_TOL}, {BF16_PARAM_TOL}); "
          f"the BN-MLP against batch 128 (BN statistics over 64 rows, not "
          f"128: another function, printed only): scores {bn_acc[0]:.3e}, "
          f"parameters {bn_acc[1]:.3e}")
    out["accumulation"] = {"plain_score_err": acc_score,
                           "plain_param_err": acc_param,
                           "bn_score_gap": bn_acc[0],
                           "bn_param_gap": bn_acc[1]}

    # the guard: NaN in batch 7, superstep 4 (window 2 discarded whole)
    kept = batches[:4] + batches[8:]
    guard_ref, _ = run(4, data=kept)
    for policy in (GuardPolicy.SKIP_BATCH, GuardPolicy.ROLLBACK):
        got = {}
        for dev in (DEVICE, "cpu"):
            n = net(dev)
            g = TrainingGuard(policy=policy, refresh_every=100)
            n.fit(FaultyIterator(L(batches), nan_at=7), superstep=4,
                  guard=g)
            check(g.nonfinite_steps >= 1 and n.iteration_count
                  == len(kept), f"guard {policy} on {dev}: "
                  f"{g.nonfinite_steps} non-finite, {n.iteration_count} "
                  "steps")
            got[dev] = n
        check(nets_equal(torch, got[DEVICE], guard_ref), f"guard {policy}: "
              "the card's run is not the run without the poisoned window")
        err = mlp_err(got[DEVICE], got["cpu"], len(kept))[0]
        check(err <= BF16_PARAM_TOL, f"guard {policy}: card vs CPU {err}")
        print(f"{tag} loop (a) guard {policy}: the poisoned window "
              "restored to its pre-window snapshot bit-exactly (the run "
              f"equals one without batches 4-7); card vs CPU {err:.3e}")

    # checkpoints, a crash at the second save, resume
    ck = {}
    for dev in (DEVICE, "cpu"):
        d = os.path.join(tmp, f"loop_ckpt_{dev}")
        n = net(dev)
        try:
            with crash_at_write(nth=2) as hit:
                n.fit(L(batches), superstep=4, checkpoint_dir=d,
                      checkpoint_every=5)
            check(False, "the crash at the second save did not fire")
        except SimulatedCrash:
            pass
        check(hit["fired"] == 2, f"crash hook fired {hit['fired']} times")
        ck[dev] = d
    resumed = net()
    resumed.fit(L(batches), superstep=4, checkpoint_dir=ck[DEVICE],
                resume=True)
    check(nets_equal(torch, resumed, runs[4][0]), "resume after the crash "
          "differs from the uninterrupted run on the card")
    cross = {}
    for src, dev in ((DEVICE, "cpu"), ("cpu", DEVICE)):
        n = net(dev)
        n.fit(L(batches), superstep=4, checkpoint_dir=ck[src], resume=True)
        want_net = cpu4 if dev == "cpu" else runs[4][0]
        cross[f"{src}->{dev}"] = mlp_err(n, want_net, LOOP_BATCHES)[0]
        check(n.iteration_count == LOOP_BATCHES and cross[f"{src}->{dev}"]
              <= BF16_PARAM_TOL, f"checkpoint written on {src} resumed on "
              f"{dev}: {cross[f'{src}->{dev}']}")
    print(f"{tag} loop (a) checkpoint_every=5 under superstep=4, crash at "
          "the 2nd save: resume bit-equal to the uninterrupted run on the "
          f"card; across devices {cross} (limit {BF16_PARAM_TOL})")

    # telemetry: run (a)'s K=4 inside a session
    sess = TelemetrySession()
    with tel_runtime.enabled(sess):
        tel_net, _ = run(4)
        sample = sess.watermarks.sample()
    check(nets_equal(torch, tel_net, runs[4][0]), "the telemetry run differs")
    trace = os.path.join(tmp, "loop_trace.json")
    sess.export_chrome_trace(trace)
    with open(trace) as fh:
        events = json.load(fh)
    events = events.get("traceEvents", events) if isinstance(events,
                                                             dict) else events
    spans = {k: round(v, 4) for k, v in sess.span_totals().items()}
    caps = sess.compiles.report()
    check(caps.get("nn/superstep", {}).get("count") == 1, f"captures "
          f"{caps}: want one of nn/superstep (one batch signature)")
    check(sample.get("device0_bytes", 0) > 0, f"watermarks {sample}")
    check(len(events) > 0 and "device/dispatch" in spans, f"trace "
          f"{len(events)} events, spans {spans}")
    print(f"{tag} loop (e) telemetry: {len(events)} trace events parsed "
          f"back; span totals s {spans}; captures {caps}; watermarks "
          f"{sample}")
    out["telemetry"] = {"captures": caps, "spans": spans, "sample": sample}

    # prefetch at batch 4096: step time, idle share, copy time (recorded)
    rb = np.random.default_rng(74)
    bx = rb.normal(size=(LOOP_BATCHES * LOOP_BIG_B, 784)).astype(np.float32)
    by = np.eye(10, dtype=np.float32)[rb.integers(0, 10, len(bx))]
    big = [pt.DataSet(bx[i:i + LOOP_BIG_B], by[i:i + LOOP_BIG_B])
           for i in range(0, len(bx), LOOP_BIG_B)]
    out["prefetch"] = {}
    for k in (1, 4):
        n = net()
        n.fit(L(big[:k]), superstep=k, prefetch=True)      # captures
        log = EdgeLog(torch)
        n.set_listeners(log)
        t0 = time.perf_counter()
        n.fit(L(big), superstep=k, prefetch=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        edges = np.diff([t0] + log.times[k - 1::k]) / k * 1e3
        n.set_listeners()
        busy, pwall, h2d = window_profile(
            torch, lambda: n.fit(L(big), superstep=k, prefetch=True))
        row = {"step_p50_ms": float(np.median(edges)),
               "samples_per_s": LOOP_BATCHES * LOOP_BIG_B / wall,
               "busy_ms_per_step": busy / LOOP_BATCHES,
               "idle_share": 1 - busy / pwall,
               "h2d_ms_per_step": h2d / LOOP_BATCHES}
        out["prefetch"][f"K={k}"] = row
        print(f"{tag} loop (a) prefetch, batch {LOOP_BIG_B}, superstep={k}: "
              f"step p50 {row['step_p50_ms']:.3f} ms, "
              f"{row['samples_per_s']:.0f} samples/s, device busy "
              f"{row['busy_ms_per_step']:.3f} ms a step, idle share "
              f"{row['idle_share']:.3f}, host-to-device copies "
              f"{row['h2d_ms_per_step']:.3f} ms a step (torch.profiler)")
    del big, bx, by

    # -- (b) the char-RNN's device-resident TBPTT epoch, kernels 6-7 -------
    x_text, y_text = readme_batches(root)
    cr = pt.char_rnn(vocab_size=VOCAB, lstm_size=HIDDEN, seq_len=TRAIN_T,
                     tbptt=TRAIN_TBPTT, device=DEVICE)
    cr.init(generator=torch.Generator().manual_seed(75))
    czip = os.path.join(tmp, "loop_char_rnn.zip")
    pt.ModelSerializer.write_model(cr, czip)
    text = list(pt.ArrayDataSetIterator(x_text, y_text, batch_size=TRAIN_B,
                                        shuffle=True, seed=11))
    per_batch = pt.ModelSerializer.restore(czip, device=DEVICE)
    per_batch.fit(L(text))
    reset_counts()
    scan = pt.ModelSerializer.restore(czip, device=DEVICE)
    t0 = time.perf_counter()
    scan.fit_scan(text)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    c_counts, c_var = lstm.launch_counts(), lstm.variant_counts()
    steps = scan.iteration_count
    check(steps == 2 * TRAIN_BATCHES, f"fit_scan took {steps} chunk steps")
    check(nets_equal(torch, scan, per_batch), "char-RNN fit_scan differs "
          "from the per-batch fit on the card")
    check(c_counts == {"launches": 0, "residual_launches": 2 * steps,
                       "adjoint_launches": 2 * steps,
                       "reduction_launches": 2 * steps}
          and c_var["residual"]["cluster"] == c_var["adjoint"]["cluster"]
          == 2 * steps, f"char-RNN fit_scan launches {c_counts} {c_var}")
    cpu_scan = pt.ModelSerializer.restore(czip, device="cpu")
    cpu_scan.fit_scan(text)
    c_err = max(param_rel_l2(scan, cpu_scan), 0.0)
    check(c_err <= PARAM_TOL, f"char-RNN fit_scan card vs CPU parameters "
          f"{c_err} > {PARAM_TOL}")
    c_score = abs(float(scan._score) - float(cpu_scan._score))
    check(c_score <= SCORE_TOL, f"char-RNN fit_scan last score card vs CPU "
          f"{c_score} > {SCORE_TOL}")
    print(f"{tag} loop (b) char-RNN fit_scan ({steps} TBPTT chunk steps, "
          f"{scan_s:.2f} s with the capture): bit-equal to the per-batch "
          f"fit on the card; launches {c_counts} all cluster through the "
          f"replays; card vs CPU parameters {c_err:.3e} (limit "
          f"{PARAM_TOL}), last score {c_score:.3e} (limit {SCORE_TOL})")
    out["char_rnn"] = {"launches": c_counts, "param_err": c_err}

    # -- (c) the bf16 LM with warm-up, kernels 1-3 --------------------------
    ids, lab = lm_text_batches(root)
    lm_batches = [pt.DataSet(ids[i:i + LM_CMP_B], lab[i:i + LM_CMP_B])
                  for i in range(0, LOOP_LM_STEPS * LM_CMP_B, LM_CMP_B)]
    lm = make_lm(pt, torch, 76, updater=pt.Adam(LM_LR, beta2=0.99),
                 compute_dtype="bfloat16", warmup=True)
    lzip = os.path.join(tmp, "loop_lm.zip")
    pt.ModelSerializer.write_model(lm, lzip)
    lms = []
    for k in (1, 4):
        reset_counts()
        n = pt.ModelSerializer.restore(lzip, device=DEVICE)
        n.fit(L(lm_batches), superstep=k)
        torch.cuda.synchronize()
        lms.append((n, attention.launch_counts(),
                    attention.variant_counts()))
    check(nets_equal(torch, lms[0][0], lms[1][0]), "bf16 LM superstep=4 "
          "differs from 1 on the card")
    a_counts, a_var = lms[1][1], lms[1][2]
    per = LM_BLOCKS * LOOP_LM_STEPS
    check(a_counts == {"launches": 0, "lse_launches": per,
                       "dq_launches": per, "dkv_launches": per}
          and a_var["dq"]["wgmma"] == a_var["dkv"]["wgmma"] == per,
          f"bf16 LM superstep=4 launches {a_counts} {a_var}")
    print(f"{tag} loop (c) bf16 LM, {LOOP_LM_STEPS} steps at batch "
          f"{LM_CMP_B}: superstep=4 bit-equal to 1 on the card; launches "
          f"{a_counts} (dq / dk/dv all wgmma) through the replays")
    out["lm"] = {"launches": a_counts}
    big_lm = [pt.DataSet(ids[i:i + LM_TRAIN_B], lab[i:i + LM_TRAIN_B])
              for i in range(0, LOOP_LM_STEPS * LM_TRAIN_B, LM_TRAIN_B)]
    out["lm_times"] = {}
    for k in (1, 4):
        n = pt.ModelSerializer.restore(lzip, device=DEVICE)
        n.fit(L(big_lm[:k]), superstep=k)                   # captures
        log = EdgeLog(torch)
        n.set_listeners(log)
        t0 = time.perf_counter()
        n.fit(L(big_lm), superstep=k)
        edges = np.diff([t0] + log.times[k - 1::k]) / k * 1e3
        n.set_listeners()
        busy, pwall, _ = window_profile(
            torch, lambda: n.fit(L(big_lm), superstep=k))
        row = {"step_p50_ms": float(np.median(edges)),
               "idle_share": 1 - busy / pwall,
               "busy_ms_per_step": busy / LOOP_LM_STEPS}
        out["lm_times"][f"K={k}"] = row
        print(f"{tag} loop (c) bf16 LM batch {LM_TRAIN_B} x {LM_SEQ}, "
              f"superstep={k}: step p50 {row['step_p50_ms']:.3f} ms, device "
              f"busy {row['busy_ms_per_step']:.3f} ms a step, idle share "
              f"{row['idle_share']:.3f}")

    # -- (d) the bf16 two-branch BN graph, kernels 4-5 on vertices -------
    x_tr, y_tr, _, _ = pt.bundled_mnist_subset()
    mirror = lambda x: x.reshape(-1, 28, 28)[:, :, ::-1].reshape(-1, 784)
    rg = np.random.default_rng(77)
    tbb = []
    for _ in range(LOOP_TB_STEPS):
        idx = rg.permutation(len(x_tr))[:TB_B]
        tbb.append(pt.MultiDataSet(features=[x_tr[idx], mirror(x_tr[idx])],
                                   labels=[y_tr[idx]]))
    tz = os.path.join(tmp, "loop_two_branch.zip")
    pt.ModelSerializer.write_model(pt.ComputationGraph(
        two_branch_conf(pt), device=DEVICE).init(
        generator=torch.Generator().manual_seed(78)), tz)
    gs = []
    for k in (1, 4):
        reset_counts()
        g = pt.ModelSerializer.restore(tz, device=DEVICE)
        g.fit(L(tbb), superstep=k)
        torch.cuda.synchronize()
        gs.append((g, bn_relu.variant_counts()))
    check(nets_equal(torch, gs[0][0], gs[1][0]), "two-branch graph "
          "superstep=4 differs from 1 on the card")
    gwant = {kind: {"resident": 2 * LOOP_TB_STEPS, "streamed": 0}
             for kind in ("fwd", "bwd")}
    check(gs[1][1] == gwant, f"two-branch graph superstep=4 BN launches "
          f"{gs[1][1]}, want {gwant}")
    print(f"{tag} loop (d) bf16 two-branch graph, {LOOP_TB_STEPS} steps: "
          f"superstep=4 bit-equal to 1 on the card; BN launches "
          f"{gs[1][1]} through the replays")
    out["graph"] = {"launches": gs[1][1]}
    out["seconds"] = time.perf_counter() - t_phase
    print(f"{tag} main path 11 (training loop): "
          f"{out['seconds']:.1f} s")
    return out


# ---- main path 12: generation, the decode plane ----------------------------
# The LM of phase 5 (nanoGPT's shakespeare-char widths) generates through
# the serving plane's decode engine: prefill through kernel 1's primal (one
# launch per block), ticks replayed from CUDA graphs captured per (pool,
# version, decode bucket) before each version goes live.
GEN_BLOCK_LEN = 16
GEN_DECODE_BUCKETS = (1, 2, 4, 8, 16, 32)
GEN_PROMPT, GEN_TICKS = 24, 64      # teacher-forced prefill + ticks
# engine logits against the full forward, of the largest |logit|: the LM's
# serving limit (SERVE_TOL)
GEN_LOGIT_TOL = SERVE_TOL
GEN_CLIENTS = (8, 32)
GEN_REQUESTS = {8: 40, 32: 10}      # requests per client, a window
GEN_PROMPT_LEN, GEN_MAX_TOKENS = (8, 201), (16, 65)   # [lo, hi) a request
GEN_POOL_BLOCKS = 64
GEN_POOL_PROMPT, GEN_POOL_MAX_TOKENS = (8, 41), (16, 33)
GEN_BENCH_PROMPT = (8, 129)
GEN_TIME_POS = 128                  # cached positions a row, tick times
GEN_BF16_TOKENS = 32
# the bf16 engine's logits (prefill at every prompt bucket, teacher-forced
# ticks) against the CPU's bf16 full forward, of the largest |logit|: set
# from the sound runs' largest reading, below the wrong paths' (PERF.md)
BF16_ENGINE_TOL = 5e-2


def http_traced(method, url, body=None, timeout=300):
    """(status, JSON body, headers) of one request, error statuses
    included."""
    req = urllib.request.Request(
        url, None if body is None else json.dumps(body).encode(),
        {"Content-Type": "application/json"}, method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            ct = resp.headers.get("Content-Type", "")
            data = resp.read()
            return (resp.status, json.loads(data) if "json" in ct
                    else data.decode(), dict(resp.headers))
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), dict(e.headers)


def gen_full_logits(torch, net, ids, params=None, dtype=None):
    """The next-token logits after every prefix of `ids`: one causal full
    forward, [len(ids), V] float32 on the host; on `params` (the net's by
    default) with the ids cast to `dtype` (a bf16 snapshot's). A reference
    for the checks: its kernel launches go to a tally, not the counters."""
    from deeplearning4j_tpu_torch import kernels
    params = net.params if params is None else params
    x = torch.tensor(np.asarray(ids), dtype=torch.float32,
                     device=net.device)[None, :, None]
    if dtype is not None:
        x = x.to(dtype)
    with torch.no_grad(), kernels.tally():
        h = net._forward(params, net.state, x, upto=len(net.layers) - 1)[0]
        return net.layers[-1].preout(params[-1], {}, h)[0] \
            .float().cpu().numpy()


def logit_err(got, want):
    """max |got - want| over the largest |want| (host arrays)."""
    return float(np.max(np.abs(got - want)) / np.abs(want).max())


def greedy_ties(torch, net, prompt, tokens, what):
    """Each of `tokens` (greedy generation after `prompt`) is the argmax of
    the full forward over its context, or lies within GEN_LOGIT_TOL of the
    largest |logit| of it (a near-tie, which float order may flip).
    Returns the number of near-tie steps it took."""
    if not tokens:
        return 0
    full = gen_full_logits(torch, net, list(prompt) + list(tokens[:-1]))
    ties = 0
    for i, tok in enumerate(tokens):
        row = full[len(prompt) - 1 + i]
        best = int(np.argmax(row))
        if best != tok:
            gap = (row[best] - row[tok]) / np.abs(row).max()
            check(gap <= GEN_LOGIT_TOL, f"{what}: generated token {i} is "
                  f"{tok}, the full forward's argmax {best}, {gap:.3e} of "
                  f"the largest |logit| apart (limit {GEN_LOGIT_TOL})")
            ties += 1
    return ties


def percentile_ms(values, q):
    return float(np.percentile(np.asarray(values), q)) if values else None


def decode_path(pt, torch, tag, tmp, root, reset_counts):
    """Main path 12 (phase 16): the decode plane at nanoGPT's LM widths.
    Returns the phase's numbers."""
    from deeplearning4j_tpu_torch.kernels import attention
    from deeplearning4j_tpu_torch.serving.bench import run_serving_bench
    from deeplearning4j_tpu_torch.serving.decode import (DecodeEngine,
                                                         GenerationScheduler)
    from deeplearning4j_tpu_torch.serving.decode.bench import \
        run_decode_bench
    from deeplearning4j_tpu_torch.telemetry.obs_bench import \
        run_obs_overhead_bench

    t_phase = time.perf_counter()
    out = {"launches": {}, "captures": {}, "times": {}}
    text = text_windows(root, LM_ALPHABET, 64, LM_SEQ)
    zips = []
    for seed in (1, 2):
        path = os.path.join(tmp, f"gen_lm_{seed}.zip")
        pt.ModelSerializer.write_model(make_lm(pt, torch, seed), path)
        zips.append(path)
    cpu_net = pt.ModelSerializer.restore(zips[0], device="cpu")
    opts = dict(block_len=GEN_BLOCK_LEN, decode_buckets=GEN_DECODE_BUCKETS)
    engines = {}                # what captured graphs: {what: engine}
    # kernel-1 launches of the decode plane's prefills, by instantiation:
    # read from the counters at every bank(), less the stateless plane's
    # forwards (LM_BLOCKS launches each, warm-ups included)
    kernel1 = {"float32": 0, "bfloat16": 0}
    direct = {"float32": 0, "bfloat16": 0}    # run_prefill calls made here
    seen, marks = {}, {}        # versions phase 16 made; their forwards

    def dtype_of(v):
        return "bfloat16" if v.precision == "bf16" else "float32"

    def see():
        for name in reg.names():
            vs = [reg.get(name)]
            cs = reg.canary_state(name)
            if cs is not None:
                vs.append(cs.version)
            for v in vs:
                seen[id(v)] = v

    def bank():
        """Add the kernel-1 launches counted since the last bank, less the
        stateless forwards, to `kernel1`, and reset the counters. Returns
        this interval's share."""
        see()
        dts = attention.dtype_counts()
        got = {k: dts[k] for k in kernel1}
        for key, v in seen.items():
            n = v.forwards - marks.get(key, 0)
            marks[key] = v.forwards
            got[dtype_of(v)] -= LM_BLOCKS * n
        for k in kernel1:
            kernel1[k] += got[k]
        reset_counts()
        return got

    def prefill(eng, v, pool, prompt, blocks):
        direct[dtype_of(v)] += 1
        return eng.run_prefill(v, pool, prompt, blocks)

    def prefills(name):
        c = sess.registry.counter("dl4j_decode_admissions_total",
                                  labels=("model",))
        return int(c.value(model=name))

    sess = pt.TelemetrySession()
    with pt.telemetry.enabled(sess):
        reg = pt.ModelRegistry(buckets=BUCKETS, metrics=sess.registry,
                               device=DEVICE)
        srv = pt.InferenceServer(reg, port=0).start()
        base = f"http://{srv.host}:{srv.port}/v1/models"
        try:
            bank()
            # -- generation set-up: register, enable, capture -----------
            t0 = time.perf_counter()
            v1 = reg.register("lm", zips[0])
            sched = srv.enable_generation("lm", **opts)
            eng = sched.engine
            engines["lm (stable arm)"] = eng
            check(eng.captures == len(GEN_DECODE_BUCKETS),
                  f"enable_generation captured {eng.captures} tick graphs "
                  f"for {len(GEN_DECODE_BUCKETS)} decode buckets")
            out["setup_s"] = time.perf_counter() - t0
            print(f"{tag} generation enabled on the LM (block_len "
                  f"{GEN_BLOCK_LEN}, decode buckets {GEN_DECODE_BUCKETS}, "
                  f"prompt buckets {eng.prompt_buckets}, {eng.spec.num_blocks}"
                  f" KV blocks, {eng.spec.arena_nbytes() / 2**20:.1f} MiB "
                  f"arena): register + {eng.captures} tick captures + "
                  f"{len(eng.prompt_buckets)} prefill warm-ups "
                  f"{out['setup_s']:.2f} s")

            # -- engine against the full forward, teacher-forced ---------
            eng2 = DecodeEngine(reg, "lm", **opts)
            pool = eng2.new_pool()
            eng2.prepare(v1, pool)
            engines["scratch engine"] = eng2
            ids = [int(t) for t in text[0][:GEN_PROMPT + GEN_TICKS]]
            prompt = ids[:GEN_PROMPT]
            blocks = pool.alloc(eng2.spec.blocks_for(len(ids)))
            bank()
            logits = [prefill(eng2, v1, pool, prompt, blocks)]
            counts = attention.launch_counts()
            check(counts["launches"] == LM_BLOCKS
                  and attention.dtype_counts()["float32"] == LM_BLOCKS
                  and attention.variant_counts()["fwd"]["tiled"]
                  == LM_BLOCKS, f"a prefill launched {counts}, "
                  f"{attention.dtype_counts()}; want {LM_BLOCKS} float32 "
                  "tiled primal launches")
            for i in range(GEN_TICKS):
                p = GEN_PROMPT + i
                logits.append(eng2.run_tick(v1, pool, [ids[p]], [p],
                                            [blocks], 1)[0])
            check(attention.launch_counts() == counts,
                  f"ticks launched hand kernels: {attention.launch_counts()}")
            got = np.stack(logits)
            card = gen_full_logits(torch, v1.model, ids)[GEN_PROMPT - 1:]
            host = gen_full_logits(torch, cpu_net, ids)[GEN_PROMPT - 1:]
            err = {k: logit_err(got, w) for k, w in (("card", card),
                                                    ("cpu", host))}
            err["card_full_vs_cpu"] = logit_err(card, host)
            for k in ("card", "cpu"):
                check(err[k] <= GEN_LOGIT_TOL, f"engine logits against the "
                      f"{k}'s full forward: {err[k]:.3e} of the largest "
                      f"|logit| > {GEN_LOGIT_TOL}")
            pool.release(blocks)
            # greedy: the engine's own tokens against the card's full
            # forward over them
            blocks = pool.alloc(eng2.spec.blocks_for(len(ids)))
            row = prefill(eng2, v1, pool, prompt, blocks)
            toks = []
            for i in range(GEN_TICKS):
                toks.append(int(np.argmax(row)))
                row = eng2.run_tick(v1, pool, [toks[-1]], [GEN_PROMPT + i],
                                    [blocks], 1)[0]
            ties = greedy_ties(torch, v1.model, prompt, toks, "greedy")
            # a row beside neighbours: bit-equal within its bucket, and
            # printed across buckets
            p = GEN_PROMPT + GEN_TICKS - 1
            alone = {b: eng2.run_tick(v1, pool, [toks[-1]], [p], [blocks],
                                      b)[0] for b in (1, 8, 32)}
            nb = []
            for w in text[1:8]:
                nbl = pool.alloc(eng2.spec.blocks_for(GEN_PROMPT + 1))
                tok = int(np.argmax(prefill(
                    eng2, v1, pool, [int(t) for t in w[:GEN_PROMPT]], nbl)))
                nb.append((tok, GEN_PROMPT, nbl))
            both = eng2.run_tick(v1, pool, [toks[-1]] + [n[0] for n in nb],
                                 [p] + [n[1] for n in nb],
                                 [blocks] + [n[2] for n in nb], 8)[0]
            check(np.array_equal(both, alone[8]), "a row's bucket-8 tick "
                  "logits changed with 7 neighbours in the batch")
            across = {f"b1_vs_b{b}": float(np.max(np.abs(alone[b]
                                                          - alone[1])))
                      for b in (8, 32)}
            for n in nb:
                pool.release(n[2])
            pool.release(blocks)
            out["engine"] = {"rel_err": err, "near_ties": ties,
                             "across_buckets_max_abs": across}
            print(f"{tag} engine: prefill ({GEN_PROMPT} tokens, "
                  f"{LM_BLOCKS} kernel-1 launches) + {GEN_TICKS} "
                  f"teacher-forced ticks (0 launches) against the full "
                  f"forward, max err / max |logit|: card {err['card']:.3e}, "
                  f"CPU {err['cpu']:.3e} (limit {GEN_LOGIT_TOL}; card full "
                  f"forward vs CPU {err['card_full_vs_cpu']:.3e}); greedy "
                  f"{GEN_TICKS} tokens = the card's full-forward argmax "
                  f"but at {ties} near-tie steps; a row's tick bit-equal "
                  f"with 7 neighbours at bucket 8; the same row across "
                  f"buckets, max abs diff {across}")

            # -- concurrent generation over HTTP, a swap mid-run ---------
            def window(n_clients, requests, swap_to=None):
                """`requests` generations a client; with `swap_to`, a
                /swap lands mid-run and every client goes on (up to 4x
                `requests`) until the swap has returned."""
                results, errors, swap_s = [], [], []
                swapped = threading.Event()
                barrier = threading.Barrier(n_clients + 1
                                            + (swap_to is not None))

                def client(i):
                    r = np.random.default_rng(100 + i)
                    last = 0
                    barrier.wait()
                    for k in range(4 * requests):
                        if k >= requests and (swap_to is None
                                              or swapped.is_set()):
                            break
                        n = int(r.integers(*GEN_PROMPT_LEN))
                        w = text[(i * requests + k) % len(text)]
                        s = int(r.integers(0, LM_SEQ - n + 1))
                        prompt = [int(t) for t in w[s:s + n]]
                        mt = int(r.integers(*GEN_MAX_TOKENS))
                        t0 = time.perf_counter()
                        try:
                            code, body, hdr = http_traced(
                                "POST", f"{base}/lm/generate",
                                {"prompt": prompt, "max_tokens": mt})
                        except Exception as e:   # counted as a failure
                            errors.append(f"{type(e).__name__}: {e}")
                            return
                        if code != 200:
                            errors.append(f"{code}: {body}")
                            return
                        if body["version"] < last:
                            errors.append("version went back")
                        last = body["version"]
                        results.append(dict(
                            prompt=prompt, tokens=body["tokens"],
                            version=body["version"],
                            ms=1e3 * (time.perf_counter() - t0),
                            trace=hdr["X-DL4J-Trace"]))

                def swapper():
                    barrier.wait()
                    time.sleep(0.3)
                    t0 = time.perf_counter()
                    try:
                        code, body, _ = http_traced(
                            "POST", f"{base}/lm/swap", {"source": swap_to})
                        swap_s.append(time.perf_counter() - t0)
                        if code != 200:
                            errors.append(f"swap {code}: {body}")
                    finally:
                        swapped.set()

                threads = [threading.Thread(target=client, args=(i,))
                           for i in range(n_clients)]
                if swap_to is not None:
                    threads.append(threading.Thread(target=swapper))
                for t in threads:
                    t.start()
                barrier.wait()
                t0 = time.perf_counter()
                for t in threads:
                    t.join()
                wall = time.perf_counter() - t0
                return results, errors, wall, swap_s

            def phase_stats(name):
                h = sess.registry.histogram("dl4j_decode_phase_seconds",
                                            labels=("model", "phase"))
                return {ph: (h.count(model=name, phase=ph),
                             h.sum(model=name, phase=ph))
                        for ph in ("prefill", "decode")}

            def ttft_ms(results):
                """Request start (the HTTP root span) to its first prefill's
                end, per request, from the session's trace."""
                spans = {}
                for e in sess.tracer.events():
                    a = e.get("args") or {}
                    if e.get("ph") == "X" and "trace_id" in a:
                        spans.setdefault(a["trace_id"], []).append(e)
                out_ = []
                for res in results:
                    evs = spans.get(res["trace"], [])
                    root_ = [e for e in evs if e["name"] == "http/generate"]
                    pre = sorted(e["ts"] + e["dur"] for e in evs
                                 if e["name"] == "prefill")
                    if root_ and pre:
                        out_.append((pre[0] - root_[0]["ts"]) / 1e3)
                return out_

            gen = {}
            windows = [(n, None) for n in GEN_CLIENTS] \
                + [(GEN_CLIENTS[-1], zips[1])]
            for n_clients, swap_to in windows:
                key = f"{n_clients}" + ("_swap" if swap_to else "")
                bank()
                admitted = prefills("lm")
                before = phase_stats("lm")
                results, errors, wall, swap_s = window(
                    n_clients, GEN_REQUESTS[n_clients], swap_to)
                check(not errors and len(results) >= n_clients
                      * GEN_REQUESTS[n_clients], f"generation at "
                      f"{n_clients} clients: {len(results)} served, "
                      f"{len(errors)} failed: {errors[:3]}")
                admitted = prefills("lm") - admitted
                after = phase_stats("lm")
                steps = {ph: (after[ph][0] - before[ph][0],
                              after[ph][1] - before[ph][1])
                         for ph in after}
                n_launch = attention.launch_counts()["launches"]
                # a swap's stateless warm-up forwards (one per batch
                # bucket) launch kernel 1 too; its decode warm-ups do not
                # count (kernels.tally)
                warm = (reg.get("lm").forwards if swap_to is not None
                        else 0)
                check(n_launch == LM_BLOCKS * (admitted + warm),
                      f"{n_clients} clients: {n_launch} kernel-1 launches "
                      f"for {admitted} prefills and {warm} warm-up "
                      f"forwards (want {LM_BLOCKS} each)")
                tokens = sum(len(r["tokens"]) for r in results)
                ttft = ttft_ms(results)
                check(len(ttft) == len(results), "a request's trace lacks "
                      "its root or prefill span")
                lat = [r["ms"] for r in results]
                g = {"requests": len(results), "generated_tokens": tokens,
                     "wall_s": wall, "tokens_per_s": tokens / wall,
                     "ttft_p50_ms": percentile_ms(ttft, 50),
                     "ttft_p99_ms": percentile_ms(ttft, 99),
                     "latency_p50_ms": percentile_ms(lat, 50),
                     "latency_max_ms": max(lat),
                     "prefills": admitted, "launches": n_launch,
                     "prefill_steps": steps["prefill"],
                     "ticks": steps["decode"], "swap_s": swap_s,
                     "versions": sorted({r["version"] for r in results})}
                if swap_to is None:
                    cur = reg.get("lm")
                    g["near_ties"] = sum(
                        greedy_ties(torch, cur.model, r["prompt"],
                                    r["tokens"], f"request at {n_clients}"
                                    " clients") for r in results)
                else:
                    check(reg.get("lm").version == 2 and 2 in g["versions"],
                          f"the swap under generation: versions "
                          f"{g['versions']}, current "
                          f"{reg.get('lm').version}")
                gen[key] = g
                print(f"{tag} generation over HTTP, {n_clients} clients, "
                      f"{len(results)} requests (prompts "
                      f"{GEN_PROMPT_LEN[0]}-{GEN_PROMPT_LEN[1] - 1}, "
                      f"max_tokens {GEN_MAX_TOKENS[0]}-"
                      f"{GEN_MAX_TOKENS[1] - 1})"
                      f"{' with a /swap mid-run' if swap_to else ''}"
                      f": 0 failed, {tokens} tokens in {wall:.2f} s = "
                      f"{g['tokens_per_s']:.1f} tokens/s, TTFT p50 "
                      f"{g['ttft_p50_ms']:.2f} ms p99 {g['ttft_p99_ms']:.2f} "
                      f"ms, request p50 {g['latency_p50_ms']:.1f} ms max "
                      f"{g['latency_max_ms']:.1f} ms; {admitted} prefills "
                      f"({steps['prefill'][1]:.3f} s), {steps['decode'][0]} "
                      f"ticks ({steps['decode'][1]:.3f} s), {n_launch} "
                      f"kernel-1 launches; versions {g['versions']}"
                      + (f"; swap {swap_s[0]:.3f} s" if swap_s else "")
                      + (f"; greedy, {g['near_ties']} near-tie steps"
                         if swap_to is None else ""))
            out["generation"] = gen
            check(eng.captures == 2 * len(GEN_DECODE_BUCKETS)
                  and eng.lazy_captures == 0,
                  f"the stable arm captured {eng.captures} tick graphs for "
                  "2 versions")

            # -- KV-pool pressure: eviction and resume --------------------
            reg.register("lm_pool", zips[0])
            psched = srv.enable_generation("lm_pool",
                                           num_blocks=GEN_POOL_BLOCKS, **opts)
            engines["lm_pool"] = psched.engine
            pv = reg.get("lm_pool")
            reqs = []
            r = np.random.default_rng(7)
            for i in range(32):
                n = int(r.integers(*GEN_POOL_PROMPT))
                reqs.append(([int(t) for t in text[i][:n]],
                             int(r.integers(*GEN_POOL_MAX_TOKENS))))
            res = [None] * len(reqs)
            errors = []

            def pclient(i):
                try:
                    res[i] = srv.generate("lm_pool", reqs[i][0],
                                          max_tokens=reqs[i][1], timeout=600)
                except Exception as e:   # surfaced by the check below
                    errors.append(f"{type(e).__name__}: {e}")

            t0 = time.perf_counter()
            threads = [threading.Thread(target=pclient, args=(i,))
                       for i in range(len(reqs))]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            wall = time.perf_counter() - t0
            check(not errors, f"pool pressure: {errors[:3]}")
            evictions = int(sess.registry.counter(
                "dl4j_decode_evictions_total",
                labels=("model",)).value(model="lm_pool"))
            check(evictions >= 1, "a pool of 64 blocks forced no eviction")
            check(psched.pool.used_blocks() == 0,
                  f"{psched.pool.used_blocks()} blocks held after the run")
            ties = sum(greedy_ties(torch, pv.model, p, x["tokens"],
                                   "pool pressure")
                       for (p, _), x in zip(reqs, res))
            out["pool_pressure"] = {"evictions": evictions,
                                    "prefills": prefills("lm_pool"),
                                    "near_ties": ties, "wall_s": wall}
            print(f"{tag} pool of {GEN_POOL_BLOCKS} blocks, 32 concurrent "
                  f"requests: {evictions} evictions, "
                  f"{prefills('lm_pool')} prefills for 32 requests, all "
                  f"greedy against the full forward ({ties} near-tie "
                  f"steps), {wall:.2f} s")

            # -- int8 KV ---------------------------------------------------
            v2 = reg.get("lm")
            q = [int(t) for t in text[9][:GEN_PROMPT]]
            first = sched.submit(q, max_tokens=1, timeout=300)["tokens"][0]
            ksched = GenerationScheduler(reg, "lm", kv_dtype="int8",
                                         metrics=None, **opts)
            engines["lm int8 KV"] = ksched.engine
            try:
                kv = ksched.pool.cache["kv"]
                check(kv.dtype == torch.int8 and kv.is_cuda,
                      f"int8 arena is {kv.dtype} on {kv.device}")
                kres = ksched.submit(q, max_tokens=32, timeout=300)
            finally:
                ksched.stop()
            check(kres["tokens"][0] == first and kres[
                "generated_tokens"] == 32, f"int8 KV: first token "
                f"{kres['tokens'][0]}, fp32's {first}")
            out["int8_kv"] = {"arena_mib": ksched.engine.spec.arena_nbytes()
                              / 2**20, "first_token_equal": True}
            print(f"{tag} int8 KV arena ({kv.dtype}, "
                  f"{out['int8_kv']['arena_mib']:.1f} MiB against "
                  f"{eng.spec.arena_nbytes() / 2**20:.1f} MiB fp32): 32 "
                  f"tokens, the first equal to fp32's ({first})")

            # -- bf16 and int8 precision -----------------------------------
            # each one's gap to fp32 on the card within twice the CPU's
            # own gap plus 1e-3 (at these widths the gaps exceed JAX's
            # small-model limits on both devices, ROADMAP C); int8 (the
            # same int8 weights, float32 compute) against the CPU's at the
            # LM's serving limit; bf16 against the CPU's printed
            x = text[10:42, :, None].astype(np.float32)
            ref, _ = reg.predict("lm_pool", x)
            cpu_reg = pt.ModelRegistry(buckets=(32,), device="cpu")
            cpu_reg.register("fp32", zips[0])
            cpu_ref, _ = cpu_reg.predict("fp32", x)
            prec = {}
            for precision in ("bf16", "int8"):
                reg.register(f"lm_{precision}", zips[0], precision=precision)
                cpu_reg.register(precision, zips[0], precision=precision)
                got, _ = reg.predict(f"lm_{precision}", x)
                host, _ = cpu_reg.predict(precision, x)
                e = {"card_vs_fp32": float(np.max(np.abs(got - ref))),
                     "cpu_vs_fp32": float(np.max(np.abs(host - cpu_ref))),
                     "card_vs_cpu": float(np.max(np.abs(got - host)))}
                prec[precision] = dict(e, param_mb=reg.get(
                    f"lm_{precision}").param_bytes / 1e6)
            for precision, e in prec.items():
                check(e["card_vs_fp32"] <= 2 * e["cpu_vs_fp32"] + 1e-3,
                      f"{precision} against fp32: card {e['card_vs_fp32']},"
                      f" CPU {e['cpu_vs_fp32']}")
            check(prec["int8"]["card_vs_cpu"] <= SERVE_TOL,
                  f"int8 bucket-32 predict, card against CPU: "
                  f"{prec['int8']['card_vs_cpu']} > {SERVE_TOL}")
            check(prec["int8"]["param_mb"] < prec["bf16"]["param_mb"],
                  f"int8 snapshot {prec['int8']['param_mb']} MB, bf16 "
                  f"{prec['bf16']['param_mb']} MB")

            # the bf16 engine, teacher-forced, against the CPU's bf16 full
            # forward (plain attention): the prefill at every prompt
            # bucket, then a prefill and GEN_TICKS ticks; the same readings
            # on two wrong paths (the row before the right one; ticks one
            # position off) must exceed the limit
            bv, cpu_bv = reg.get("lm_bf16"), cpu_reg.get("bf16")
            cpu_bp = cpu_bv.snapshot.rebuild(cpu_bv.snapshot.data)
            beng = DecodeEngine(reg, "lm_bf16", **opts)
            bpool = beng.new_pool()
            beng.prepare(bv, bpool)
            engines["bf16 scratch engine"] = beng
            bank()
            sound, wrong = {}, {"previous_row": 0.0}
            for tb in beng.prompt_buckets:
                p_ids = [int(t) for t in text[13][:tb]]
                bl = bpool.alloc(beng.spec.blocks_for(tb))
                row = prefill(beng, bv, bpool, p_ids, bl)
                bpool.release(bl)
                want = gen_full_logits(torch, cpu_bv.model, p_ids, cpu_bp,
                                       torch.bfloat16)
                sound[f"prefill_t{tb}"] = logit_err(row, want[-1])
                wrong["previous_row"] = max(wrong["previous_row"],
                                            logit_err(row, want[-2]))
            want = gen_full_logits(torch, cpu_bv.model, ids, cpu_bp,
                                   torch.bfloat16)[GEN_PROMPT - 1:]
            runs = {}
            for shift in (0, 1):
                bl = bpool.alloc(beng.spec.blocks_for(len(ids) + shift))
                rows = [prefill(beng, bv, bpool, prompt, bl)]
                for i in range(GEN_TICKS):
                    p = GEN_PROMPT + i
                    rows.append(beng.run_tick(bv, bpool, [ids[p]],
                                              [p + shift], [bl], 1)[0])
                bpool.release(bl)
                runs[shift] = np.stack(rows)
            sound["ticks"] = logit_err(runs[0][1:], want[1:])
            wrong["previous_row"] = max(wrong["previous_row"],
                                        logit_err(runs[0][1:], want[:-1]))
            wrong["position_off_by_one"] = logit_err(runs[1][1:], want[1:])
            n_bf = len(beng.prompt_buckets) + 2
            got = bank()
            check(got == {"float32": 0, "bfloat16": LM_BLOCKS * n_bf},
                  f"the bf16 engine's {n_bf} prefills launched {got}")
            top_sound, low_wrong = max(sound.values()), min(wrong.values())
            print(f"{tag} bf16 engine against the CPU's bf16 full forward, "
                  f"max err / max |logit|: " + ", ".join(
                      f"{k} {v:.3e}" for k, v in sound.items())
                  + f" (limit {BF16_ENGINE_TOL}); wrong paths: " + ", ".join(
                      f"{k} {v:.3e}" for k, v in wrong.items())
                  + f"; {LM_BLOCKS * n_bf} bfloat16 kernel-1 launches for "
                  f"{n_bf} prefills")
            check(top_sound <= BF16_ENGINE_TOL < low_wrong,
                  f"bf16 engine against the CPU: sound paths up to "
                  f"{top_sound:.3e}, wrong paths from {low_wrong:.3e}, "
                  f"limit {BF16_ENGINE_TOL}")
            prec["bf16"]["engine_vs_cpu"] = sound
            prec["bf16"]["engine_wrong_paths"] = wrong

            bsched = srv.enable_generation("lm_bf16", **opts)
            engines["lm_bf16"] = bsched.engine
            bank()
            bres = srv.generate("lm_bf16", q, max_tokens=GEN_BF16_TOKENS,
                                timeout=300)
            check(bres["generated_tokens"] == GEN_BF16_TOKENS,
                  f"bf16 generation: {bres}")
            dts = attention.dtype_counts()
            check(dts == {"float32": 0, "bfloat16": LM_BLOCKS,
                          "float16": 0}, f"a bf16 prefill launched {dts}")
            prec["bf16"]["generated"] = bres["tokens"]
            prec["bf16"]["prefill_launches"] = dts
            out["precisions"] = prec
            print(f"{tag} precisions at bucket 32 (max abs, softmax): "
                  + "; ".join(f"{k}: card vs fp32 {v['card_vs_fp32']:.3e}, "
                              f"CPU vs fp32 {v['cpu_vs_fp32']:.3e}, card vs "
                              f"CPU {v['card_vs_cpu']:.3e}, "
                              f"{v['param_mb']:.2f} MB"
                              for k, v in prec.items())
                  + f"; bf16 generated {GEN_BF16_TOKENS} tokens, its "
                  f"prefill {dts}")

            # -- canary: start 0.25, promote; start, rollback --------------
            def canary(action, **body):
                code, b, _ = http_traced("POST", f"{base}/lm/canary",
                                         dict(action=action, **body))
                check(code == 200, f"canary {action}: {code} {b}")
                return b

            def burst(n_clients=8, per=5):
                errs = []

                def c(i):
                    for k in range(per):
                        w = text[(i * per + k) % len(text)]
                        try:
                            code, b, _ = http_traced(
                                "POST", f"{base}/lm/generate",
                                {"prompt": [int(t) for t in w[:12]],
                                 "max_tokens": 6})
                        except Exception as e:   # counted as a failure
                            code, b = None, f"{type(e).__name__}: {e}"
                        if code != 200:
                            errs.append(f"{code} {b}")
                ts = [threading.Thread(target=c, args=(i,))
                      for i in range(n_clients)]
                for t in ts:
                    t.start()
                for t in ts:
                    t.join()
                check(not errs, f"canary traffic failed: {errs[:3]}")
                return n_clients * per

            cand = canary("start", source=zips[0], fraction=0.25)
            see()
            cached = srv._schedulers.get(("lm", "canary"))
            check(cached is not None and cached.engine.captures
                  == len(GEN_DECODE_BUCKETS), "the canary arm's scheduler "
                  "did not capture its graphs at the start")
            engines["lm canary 1"] = cached.engine
            n = burst()
            stats = reg.canary_state("lm").stats()["arms"]
            check(stats["canary"]["requests"] == 25
                  and stats["stable"]["requests"] == n - 25
                  and stats["canary"]["errors"] == 0,
                  f"canary arms after {n} requests: {stats}")
            promoted = canary("promote")
            check(promoted["version"] == cand["version"]
                  and reg.get("lm").version == cand["version"]
                  and ("lm", "canary") not in srv._schedulers,
                  f"promote: {promoted}")
            check(eng.captures == 3 * len(GEN_DECODE_BUCKETS),
                  f"the stable arm captured {eng.captures} tick graphs for "
                  "3 versions")
            n2 = burst(4, 2)
            cand2 = canary("start", source=zips[1], fraction=0.25)
            see()
            engines["lm canary 2"] = srv._schedulers[("lm", "canary")].engine
            n3 = burst(4, 2)
            back = canary("rollback")
            check(back["version"] == cand["version"]
                  and reg.get("lm").version == cand["version"],
                  f"rollback: {back}")
            out["canary"] = {"arms": stats, "versions": [
                cand["version"], cand2["version"]], "requests": n + n2 + n3}
            print(f"{tag} canary at 0.25: {stats['canary']['requests']} of "
                  f"{n} requests on v{cand['version']}, promoted; then "
                  f"v{cand2['version']} started and rolled back; "
                  f"{n + n2 + n3} generate requests, 0 failed")

            # -- captures: one per (pool, version, bucket), none lazy ------
            for what, e in engines.items():
                check(e.lazy_captures == 0, f"{what}: {e.lazy_captures} "
                      "tick graphs captured on a request's path")
                check(e.captures % len(GEN_DECODE_BUCKETS) == 0,
                      f"{what}: {e.captures} captures")
            out["captures"] = {what: e.captures
                               for what, e in engines.items()}
            rep = {k: v["count"] for k, v in sess.compiles.report().items()
                   if k.startswith("serving/")}
            out["compile_report"] = rep
            print(f"{tag} tick-graph captures by scheduler (6 decode buckets "
                  f"a version, none on a request's path): {out['captures']};"
                  f" watcher: {rep}")

            # -- observability --------------------------------------------
            code, _, hdr = http_traced("POST", f"{base}/lm_pool/predict",
                                       {"features": x[:2].tolist()})
            check(code == 200 and hdr.get("X-DL4J-Trace"),
                  "predict: no X-DL4J-Trace")
            code, body, hdr = http_traced("POST", f"{base}/nope/generate",
                                          {"prompt": [1]})
            check(code == 404 and body.get("trace_id")
                  == hdr.get("X-DL4J-Trace"), f"error reply {code} {body} "
                  f"{hdr.get('X-DL4J-Trace')}")
            code, text_m, _ = http_traced(
                "GET", f"http://{srv.host}:{srv.port}/metrics")
            families = ("dl4j_serving_requests_total",
                        "dl4j_serving_latency_seconds",
                        "dl4j_serving_swaps_total",
                        "dl4j_serving_compiles_total",
                        "dl4j_serving_compile_seconds",
                        "dl4j_serving_model_version",
                        "dl4j_serving_batch_size",
                        "dl4j_serving_batch_rows_total",
                        "dl4j_serving_queue_wait_seconds",
                        "dl4j_decode_tokens_total",
                        "dl4j_decode_admissions_total",
                        "dl4j_decode_evictions_total",
                        "dl4j_decode_phase_seconds",
                        "dl4j_decode_kv_blocks", "dl4j_slo_latency_seconds",
                        "dl4j_continual_canary_requests_total")
            missing = [f for f in families if f not in text_m]
            check(code == 200 and not missing, f"/metrics lacks {missing}")
            code, body, hdr = http_traced(
                "GET", f"http://{srv.host}:{srv.port}/debug/flightrecord")
            kinds = {e["kind"] for e in body.get("events", [])}
            check(code == 200 and "decode/admit" in kinds
                  and "decode/evict" in kinds, f"/debug/flightrecord: "
                  f"{code}, kinds {sorted(kinds)}")
            print(f"{tag} /metrics: {len(families)} families present; "
                  f"/debug/flightrecord: {body.get('total_events')} events "
                  f"({sorted(kinds)[:6]}...); X-DL4J-Trace on a success and "
                  "on a 404, whose body carries the same trace id")
            # -- times -----------------------------------------------------
            # (each prompt bucket's f32 prefill is held to the CPU's full
            # forward too)
            times = out["times"]
            pre, pre_err = {}, {}
            for tb in eng2.prompt_buckets:
                p_ids = [int(t) for t in text[11][:tb]]
                bl = pool.alloc(eng2.spec.blocks_for(tb))
                ms = []
                for _ in range(10):
                    t0 = time.perf_counter()
                    row = prefill(eng2, v1, pool, p_ids, bl)
                    ms.append(1e3 * (time.perf_counter() - t0))
                pool.release(bl)
                pre[tb] = float(np.median(ms))
                pre_err[tb] = logit_err(row, gen_full_logits(
                    torch, cpu_net, p_ids)[-1])
            times["prefill_p50_ms"] = pre
            out["engine"]["prefill_vs_cpu"] = pre_err
            print(f"{tag} f32 prefill against the CPU's full forward at "
                  f"every prompt bucket, max err / max |logit|: " + ", ".join(
                      f"{k}: {v:.3e}" for k, v in pre_err.items())
                  + f" (limit {GEN_LOGIT_TOL})")
            check(max(pre_err.values()) <= GEN_LOGIT_TOL, f"f32 prefill "
                  f"against the CPU: {pre_err} > {GEN_LOGIT_TOL}")
            rows = []
            for i in range(max(GEN_DECODE_BUCKETS)):
                w = [int(t) for t in text[12 + i % 40][:GEN_TIME_POS]]
                bl = pool.alloc(eng2.spec.blocks_for(GEN_TIME_POS + 1))
                tok = int(np.argmax(prefill(eng2, v1, pool, w, bl)))
                rows.append((tok, GEN_TIME_POS, bl))
            tick = {}
            for b in GEN_DECODE_BUCKETS:
                sub = rows[:b]
                args = ([r_[0] for r_ in sub], [r_[1] for r_ in sub],
                        [r_[2] for r_ in sub])
                cap = []
                for _ in range(20):
                    t0 = time.perf_counter()
                    eng2.run_tick(v1, pool, *args, b)
                    cap.append(1e3 * (time.perf_counter() - t0))
                inp = np.zeros((b, 2 + eng2.spec.table_width), np.int64)
                for i, (t_, p_, bl) in enumerate(sub):
                    inp[i, 0], inp[i, 1] = t_, p_
                    inp[i, 2:] = eng2._pad_table(bl)
                step = eng2.decode_exec(v1, b)
                eager = []
                for _ in range(20):
                    t0 = time.perf_counter()
                    xt = torch.from_numpy(inp).to(DEVICE)
                    with torch.no_grad():
                        step(v1.snapshot.data, pool.cache, xt[:, 0],
                             xt[:, 1], xt[:, 2:], eng2.spec).cpu()
                    eager.append(1e3 * (time.perf_counter() - t0))
                tick[b] = {"captured_p50_ms": float(np.median(cap)),
                           "eager_p50_ms": float(np.median(eager))}
            times["tick_p50_ms"] = tick
            print(f"{tag} prefill p50 by prompt bucket (host wall, ms): "
                  + ", ".join(f"{k}: {v:.3f}" for k, v in pre.items()))
            print(f"{tag} tick p50 by decode bucket (host wall, ms, rows at "
                  f"position {GEN_TIME_POS}), captured / eager: " + ", ".join(
                      f"{b}: {t['captured_p50_ms']:.3f} / "
                      f"{t['eager_p50_ms']:.3f}" for b, t in tick.items()))
            top = max(GEN_DECODE_BUCKETS)
            graph = eng2._tick_graph(v1, pool, top)
            sub = rows[:top]
            inp = np.zeros((top, 2 + eng2.spec.table_width), np.int64)
            for i, (t_, p_, bl) in enumerate(sub):
                inp[i, 0], inp[i, 1] = t_, p_
                inp[i, 2:] = eng2._pad_table(bl)

            def replay():
                graph.replay(inp)

            events, busy, wall = profile_device(
                torch, replay, f"decode tick at bucket {top} (captured, "
                f"{GEN_TIME_POS} cached positions a row)", tag, reps=20)
            times["tick_profile"] = {"busy_ms": busy, "wall_ms": wall,
                                     "idle_share": 1 - busy / wall,
                                     "top": events[:8]}
            for r_ in rows:
                pool.release(r_[2])

            # -- kernel-1 launches of every prefill above, from the counters
            bank()
            admitted = {k: sum(prefills(n) for n in names) for k, names in
                        (("float32", ("lm", "lm_pool")),
                         ("bfloat16", ("lm_bf16",)))}
            # + the int8-KV scheduler's one prefill (it keeps no metrics)
            want = {"float32": LM_BLOCKS * (direct["float32"]
                                            + admitted["float32"] + 1),
                    "bfloat16": LM_BLOCKS * (direct["bfloat16"]
                                             + admitted["bfloat16"])}
            check(kernel1 == want, f"kernel-1 launches of main path 12's "
                  f"prefills, read from the counters less the stateless "
                  f"forwards: {kernel1}; {LM_BLOCKS} per prefill gives "
                  f"{want} ({direct} direct, {admitted} admitted)")
            out["launches"] = {"per_prefill": LM_BLOCKS, "per_tick": 0,
                               "counted": kernel1, "prefills": {
                                   "direct": direct, "admitted": admitted,
                                   "int8_kv": 1}}
            print(f"{tag} kernel-1 launches of main path 12's prefills, read "
                  f"from the counters (stateless forwards taken off): "
                  f"{kernel1} = {LM_BLOCKS} x ({direct} run here + "
                  f"{admitted} admitted + 1 int8-KV)")
            out["generation_times"] = {
                k: {m: gen[k][m] for m in ("tokens_per_s", "ttft_p50_ms",
                                           "ttft_p99_ms")}
                for k in gen if "swap" not in k}
        finally:
            srv.stop()

    # -- the benches -------------------------------------------------------
    t0 = time.perf_counter()
    dec = run_decode_bench(
        n_clients=32, requests_per_client=2, pairs=2, device=DEVICE,
        block_len=GEN_BLOCK_LEN, decode_buckets=GEN_DECODE_BUCKETS,
        model=lambda seed: make_lm(pt, torch, seed),
        prompt_len=GEN_BENCH_PROMPT, max_tokens=GEN_MAX_TOKENS)
    check(dec["failed_requests"] == 0 and dec["one_compile_per_phase_bucket"]
          and dec["swap_under_generation"]["failed"] == 0,
          f"run_decode_bench: {json.dumps(dec)[:400]}")
    out["decode_bench"] = {k: dec[k] for k in (
        "continuous_vs_static", "paired_ratios", "failed_requests",
        "tick_captures", "compiles_per_phase_bucket")}
    out["decode_bench"]["windows"] = [
        {m: {k: w[m].get(k) for k in ("tokens_per_s", "p50_ms", "p99_ms")}
         for m in w} for w in dec["windows"]]
    print(f"{tag} run_decode_bench at the LM's widths (32 clients x 2, "
          f"prompts 8-128, max_tokens 16-64, 2 pairs): continuous / static "
          f"tokens/s {dec['paired_ratios']} (median "
          f"{dec['continuous_vs_static']}), 0 failed, a swap mid-window; "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sb = run_serving_bench(clients=(1, 8, 32), requests_per_client=30,
                           pairs_at_top=2, device=DEVICE)
    for m in ("lenet", "mlp128"):
        check(sb[m]["one_compile_per_bucket"], f"serving bench {m}: "
              f"{sb[m]['compiles_per_bucket']}")
    check(sb["lenet"]["swap_under_load"]["failed"] == 0,
          f"swap under load: {sb['lenet']['swap_under_load']}")
    top = str(max(sb["clients"]))
    out["serving_bench"] = {m: {"speedup": sb[m][
        "batched_vs_unbatched_speedup"], top: sb[m][top]}
        for m in ("lenet", "mlp128")}
    print(f"{tag} run_serving_bench (1 / 8 / 32 clients x 30): batched / "
          f"direct req/s at 32 clients, median of 2 pairs: lenet "
          f"{sb['lenet']['batched_vs_unbatched_speedup']}, mlp128 "
          f"{sb['mlp128']['batched_vs_unbatched_speedup']}; {top} clients "
          f"batched: lenet {sb['lenet'][top]['batched']}, "
          f"mlp128 {sb['mlp128'][top]['batched']}; swap under load "
          f"{sb['lenet']['swap_under_load']['failed']} failed; "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ob = run_obs_overhead_bench(pairs=2, clients=8, requests_per_client=40,
                                device=DEVICE)
    split = ob["serving"]["cost_split"]
    out["obs_bench"] = {"serving_ratio": ob["serving"]["ratio"],
                        "fit_ratio": ob["fit"]["ratio"],
                        "pass_0p95": ob["pass_0p95"], "cost_split": split}
    print(f"{tag} obs_bench (tracing on / off, paired): serving "
          f"{ob['serving']['paired_ratios']}, fit {ob['fit']['paired_ratios']}"
          f" (pass_0p95 {ob['pass_0p95']}); {time.perf_counter() - t0:.1f} s")
    print(f"{tag} obs_bench serving cost split (host us; one thread, each "
          f"piece alone): {split['span_costs_us']}; a request: "
          f"{split['child_spans_per_request']} child spans on the flush "
          f"thread = {split['flush_thread_us']} us, context + root + SLO on "
          f"the client = {split['client_thread_us']} us; wall a request "
          f"gained against the untraced window's "
          f"{split['request_wall_off_us']} us: "
          f"{split['request_wall_gained_us']['client']} us with the "
          f"client's part alone, {split['request_wall_gained_us']['on']} "
          f"us traced")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"{tag} main path 12 (phase 16): {out['seconds']:.1f} s")
    return out


# the continual train-to-serve loop (main path 13): the BN-MLP of phase 8
# fine-tuned from a topic of bundled digits (records of 64 rows, windows of
# 4 records: two steps at batch 128), gated on the 64 held-out digits,
# canaried at a quarter of the traffic; the crash drill at windows of one
# record; the char-RNN of phase 3 behind an InferenceRoute
CONT_ROWS, CONT_WINDOW, CONT_FRACTION = 64, 4, 0.25
# a canary decides after 50 candidate requests; the candidate rolls back
# when its mean latency passes 5x the stable arm's (the regression cycle
# adds CONT_SLOW_S to each candidate request's observed latency)
CONT_MIN_REQUESTS, CONT_LATENCY_RATIO, CONT_SLOW_S = 50, 5.0, 0.02
CONT_POINTS = ("stable_registered", "window_consumed", "window_trained",
               "candidate_saved", "window_record", "offset_committed",
               "gate_record", "canary_started", "decision_record",
               "decision_applied")
ROUTE_REPS = 16                     # batches of each size through the route


def continual_path(pt, torch, tag, tmp, reset_counts):
    """Main path 13 (phase 17): the continual train-to-serve loop on the
    card (fine-tunes through kernels 4-5, each candidate held against the
    same window fine-tuned on the CPU from the same stable zip), the crash
    drill at the ten continual/* points, and the streaming route serving
    the char-RNN through kernel 6. Returns the phase's numbers."""
    import shutil

    from deeplearning4j_tpu_torch.continual import (CanaryPolicy,
                                                    ContinualJournal,
                                                    ContinualTrainer)
    from deeplearning4j_tpu_torch.fault import SimulatedCrash, crash_at_write
    from deeplearning4j_tpu_torch.fault import injection
    from deeplearning4j_tpu_torch.kernels import attention, bn_relu, lstm
    from deeplearning4j_tpu_torch.streaming import (InferenceRoute,
                                                    NDArrayConsumer,
                                                    NDArrayPublisher,
                                                    NDArraySerde)
    from deeplearning4j_tpu_torch.streaming.topic import (FileTopic,
                                                          TopicPublisher)
    from deeplearning4j_tpu_torch.telemetry import runtime as tel_runtime
    t_phase = time.perf_counter()
    out = {"card": tag.strip("[]")}
    root = os.path.join(tmp, "continual")

    def counts():
        return {f"{mod.__name__.rsplit('.', 1)[-1]}/{k}": n
                for mod in (lstm, attention, bn_relu)
                for k, n in mod.launch_counts().items()}

    def since(before):
        now = counts()
        return {k: now[k] - before[k] for k in now if now[k] != before[k]}

    # -- (a) the loop at full width ----------------------------------------
    x_tr, y_tr, x_te, y_te = pt.bundled_mnist_subset()
    gate = pt.DataSet(x_te, y_te)
    boot = os.path.join(tmp, "continual_boot.zip")
    pt.ModelSerializer.write_model(pt.MultiLayerNetwork(
        pt.MultiLayerConfiguration.from_json(bn_mlp_json(pt)),
        device=DEVICE).init(generator=torch.Generator().manual_seed(81)),
        boot)

    def window(seed, poison=False):
        """CONT_WINDOW records of CONT_ROWS training digits, [x | one-hot]."""
        order = np.random.default_rng(seed).permutation(len(x_tr))
        rows = order[:CONT_WINDOW * CONT_ROWS]
        x = x_tr[rows].copy()
        if poison:
            x[:] = np.nan
        rec = np.concatenate([x, y_tr[rows]], axis=1)
        return [rec[i:i + CONT_ROWS] for i in range(0, len(rec), CONT_ROWS)]

    name = "bn_mlp"
    topic = FileTopic(root, "digits")
    pub = TopicPublisher(topic)
    lat = {"stable": [], "canary": []}
    failures = {"stable": 0, "canary": 0}
    slow = [False]
    probe = x_te[:8]
    marks = []          # (point, host time, launch counts) per crash point

    kept = os.path.join(tmp, "continual_candidate.zip")

    def mark(point, info):
        """Crash-point observer: the time and launch counts at each
        boundary of a cycle; the candidate's zip copied when it is saved
        (a rollback deletes it)."""
        torch.cuda.synchronize()
        point = point.split("/", 1)[1]
        if point == "candidate_saved":
            shutil.copyfile(info["ckpt"], kept)
        marks.append((point, time.perf_counter(), counts(), dict(info)))

    with tel_runtime.enabled() as tel:
        reg = pt.ModelRegistry(buckets=BUCKETS, device=DEVICE,
                               metrics=tel.registry)

        def traffic():
            """100 requests, one digit each, on the arm the registry
            routes them to; each request's latency observed on its arm."""
            for i in range(100):
                arm = reg.route_arm(name)
                t0 = time.perf_counter()
                err = False
                try:
                    reg.predict(name, x_te[i % len(x_te)][None], arm=arm)
                except Exception:
                    failures[arm] += 1
                    err = True
                dt = time.perf_counter() - t0
                lat[arm].append(dt)
                if arm == "canary" and slow[0]:
                    dt += CONT_SLOW_S
                reg.observe_canary(name, arm, latency_s=dt, error=err)

        trainer = ContinualTrainer(
            reg, name, topic, workdir=os.path.join(root, "loop"),
            gate_set=gate, initial_source=boot, feature_width=784,
            window_records=CONT_WINDOW, batch_size=MLP_B, gate_margin=0.0,
            canary_fraction=CONT_FRACTION,
            canary_policy=CanaryPolicy(min_requests=CONT_MIN_REQUESTS,
                                       max_latency_ratio=CONT_LATENCY_RATIO),
            canary_timeout_s=120.0, canary_poll_s=0.0, buckets=BUCKETS,
            traffic_hook=traffic)
        # each cycle's candidate, kept to read its captured steps
        candidates = []
        fine_tune = trainer._fine_tune

        def keep_candidate(arrays):
            res = fine_tune(arrays)
            candidates.append(res[0])
            return res

        trainer._fine_tune = keep_candidate
        cpu_reg = pt.ModelRegistry(buckets=(1,), device="cpu")
        cpu_twin = ContinualTrainer(
            cpu_reg, name, topic, workdir=os.path.join(root, "cpu"),
            gate_set=gate, feature_width=784, window_records=CONT_WINDOW,
            batch_size=MLP_B)
        reset_counts()
        c_boot = counts()
        t0 = time.perf_counter()
        v1 = trainer.recover()
        torch.cuda.synchronize()
        boot_s = time.perf_counter() - t0
        check(not since(c_boot), f"bootstrap (restore, register, warm-up) "
              f"launched kernels: {since(c_boot)}")
        traffic()

        # (window seed, poison, superstep, guard, slow canary, expected)
        plan = [(1, False, 1, "skip_batch", False, ("promoted", None)),
                (2, False, 2, "skip_batch", False, ("promoted", None)),
                (3, True, 2, "skip_batch", False,
                 ("rolled_back", "empty_window")),
                (4, True, 2, None, False, ("rolled_back", "gate_fail")),
                (5, False, 2, "skip_batch", True,
                 ("rolled_back", "latency"))]
        cycles, steps_total = [], 0
        for seed, poison, k, guard, is_slow, want in plan:
            for rec in window(seed, poison):
                pub.publish(rec)
            trainer.superstep, trainer.guard_policy = k, guard
            slow[0] = is_slow
            stable_ckpt, stable_v = trainer.stable_ckpt, reg.get(name)
            before_out = reg.predict(name, probe)[0]
            marks.clear()
            hooks = {}
            for p in CONT_POINTS:
                hooks[p] = f"continual/{p}"
                injection._crash_hooks[hooks[p]] = mark
            try:
                c0 = counts()
                t0 = time.perf_counter()
                res = trainer.run_cycle()
                wall = time.perf_counter() - t0
            finally:
                for h in hooks.values():
                    injection._crash_hooks.pop(h, None)
            at = {p: (t, c, info) for p, t, c, info in marks}
            outcome = (res["outcome"], res.get("reason"))
            check(outcome == want, f"continual cycle {res['cycle']}: "
                  f"{outcome}, want {want}")
            ft = {kk: at["window_trained"][1][kk] - at["window_consumed"][1][kk]
                  for kk in c0}
            rest = since(at["window_trained"][1])
            win = [r for r in trainer.journal.replay()
                   if r["kind"] == "window"][-1]
            steps = win["batches"]
            want_bn = {"bn_relu/fwd_launches": 2 * steps,
                       "bn_relu/bwd_launches": 2 * steps}
            got_bn = {kk: v for kk, v in ft.items() if v}
            check(got_bn == want_bn, f"continual cycle {res['cycle']} "
                  f"(superstep {k}): fine-tune launches {got_bn}, want "
                  f"{want_bn} (2 + 2 a step)")
            check(not rest, f"continual cycle {res['cycle']}: gate scoring, "
                  f"canary warm-up or serving launched kernels: {rest}")
            graphs = len(candidates[-1].__dict__.get("_captured_steps", {}))
            check(graphs == (1 if k > 1 else 0), f"continual cycle "
                  f"{res['cycle']} (superstep {k}): the candidate holds "
                  f"{graphs} captured steps (want {1 if k > 1 else 0}: a "
                  "window's steps replay one CUDA graph)")
            if outcome[0] == "rolled_back":
                check(reg.get(name) is stable_v, "a rollback moved the "
                      "stable version")
                after_out = reg.predict(name, probe)[0]
                check(np.array_equal(after_out, before_out), f"stable "
                      f"outputs differ across the {outcome[1]} rollback")
            t = {p: v[0] for p, v in at.items()}
            split = {
                "fine_tune_s": t["window_trained"] - t["window_consumed"],
                "save_s": t["candidate_saved"] - t["window_trained"],
                "gate_s": t.get("gate_record", t["offset_committed"])
                - t["offset_committed"]}
            if "canary_started" in t:
                split["canary_build_s"] = t["canary_started"] \
                    - t["gate_record"]
                split["canary_watch_s"] = t["decision_record"] \
                    - t["canary_started"]
            # the same window on the CPU from the same stable zip
            card_cand = pt.ModelSerializer.restore(kept, device="cpu")
            arrays = [NDArraySerde.from_bytes(topic.read(o))
                      for o in range(win["start"], win["end"])]
            cpu_twin.stable_ckpt = stable_ckpt
            cpu_twin.superstep, cpu_twin.guard_policy = k, guard
            cpu_cand, c_batches, c_skipped, _ = cpu_twin._fine_tune(arrays)
            cpu_stable = pt.ModelSerializer.restore(stable_ckpt, device="cpu")
            cpu_stable_score = cpu_stable.score(gate)
            cpu_score = cpu_cand.score(gate)
            if c_skipped >= c_batches:
                cpu_decision = "empty_window"
            elif np.isfinite(cpu_score) and cpu_score <= cpu_stable_score:
                cpu_decision = "gate_pass"
            else:
                cpu_decision = "gate_fail"
            gate_rec = [r for r in trainer.journal.replay()
                        if r["kind"] == "gate" and r["cycle"] == res["cycle"]]
            card_decision = ("empty_window" if not gate_rec else
                             "gate_pass" if gate_rec[0]["passed"] else
                             "gate_fail")
            check(card_decision == cpu_decision, f"continual cycle "
                  f"{res['cycle']}: the card decided {card_decision}, the "
                  f"CPU {cpu_decision}")
            entry = {"cycle": res["cycle"], "superstep": k, "guard": guard,
                     "outcome": outcome, "steps": steps, "wall_s": wall,
                     "launches": got_bn, "captures": graphs, **split,
                     "decision": card_decision}
            if card_decision in ("gate_pass", "empty_window"):
                err, at_t = bn_mlp_err(card_cand, cpu_cand,
                                       steps_total + steps)
                score_err = abs(gate_rec[0]["cand_score"] - cpu_score) \
                    if gate_rec else abs(card_cand.score(gate) - cpu_score)
                check(err <= BF16_PARAM_TOL, f"continual cycle "
                      f"{res['cycle']}: card vs CPU candidate parameters / "
                      f"running variances {err} at {at_t} > "
                      f"{BF16_PARAM_TOL}")
                check(score_err <= BF16_SCORE_TOL, f"continual cycle "
                      f"{res['cycle']}: card vs CPU gate score {score_err} "
                      f"> {BF16_SCORE_TOL}")
                entry.update(param_err=err, param_at=at_t,
                             score_err=score_err)
            if gate_rec:
                entry.update(cand_score=gate_rec[0]["cand_score"],
                             stable_score=gate_rec[0]["stable_score"],
                             cpu_cand_score=cpu_score)
            if outcome[0] == "promoted":
                steps_total += steps
            cycles.append(entry)
            traffic()
        summary = tel.summary().get("continual", {})
    check(failures == {"stable": 0, "canary": 0},
          f"failed requests during the continual loop: {failures}")
    n_steps = sum(c["steps"] for c in cycles)
    loop_bn = {kind: sum(c["launches"].get(f"bn_relu/{kind}_launches", 0)
                         for c in cycles) for kind in ("fwd", "bwd")}
    check(loop_bn == {"fwd": 2 * n_steps, "bwd": 2 * n_steps},
          f"continual loop BN launches {loop_bn} for {n_steps} steps")
    arm_p50 = {arm: percentile_ms([v * 1e3 for v in lat[arm]], 50)
               for arm in lat}
    out["loop"] = {"cycles": cycles, "boot_s": boot_s, "steps": n_steps,
                   "launches": loop_bn, "telemetry": summary,
                   "p50_ms": arm_p50,
                   "requests": {a: len(v) for a, v in lat.items()}}
    for c in cycles:
        print(f"{tag} continual cycle {c['cycle']} (superstep "
              f"{c['superstep']}, guard {c['guard']}): {c['outcome']}, "
              f"{c['steps']} steps, BN launches {c['launches']}, step "
              f"captures {c['captures']}; "
              + ", ".join(f"{kk} {c[kk]:.3f}" for kk in
                          ("wall_s", "fine_tune_s", "save_s", "gate_s",
                           "canary_build_s", "canary_watch_s") if kk in c)
              + (f"; card vs CPU parameters {c['param_err']:.3e} at "
                 f"{c['param_at']}, gate score {c['score_err']:.3e}"
                 if "param_err" in c else "")
              + f"; decision {c['decision']} on both devices")
    print(f"{tag} continual loop: bootstrap {boot_s:.3f} s; "
          f"{n_steps} fine-tune steps, BN launches {loop_bn} (2 + 2 a "
          f"step, none in gate scoring or serving); promotion latency "
          f"{summary.get('promotion_latency_s')} s (mean); canary "
          f"requests {summary.get('canary_requests')}; request p50 ms by "
          f"arm {arm_p50}; failed requests {failures}; rollbacks "
          f"{summary.get('rollbacks')}")

    # -- (b) the crash drill: windows of one record ------------------------
    # on the narrow BN network of phase 8 (bf16), whose zips write in
    # milliseconds: each point restarts the loop and writes up to six zips
    t_drill = time.perf_counter()
    drill = {}
    x_probe = x_te[:3]
    drill_boot = os.path.join(tmp, "continual_drill_boot.zip")
    pt.ModelSerializer.write_model(pt.MultiLayerNetwork(
        pt.MultiLayerConfiguration.from_json(bn_narrow_json(pt)),
        device=DEVICE).init(generator=torch.Generator().manual_seed(82)),
        drill_boot)
    for point in CONT_POINTS:
        d = os.path.join(root, f"drill_{point}")
        dtopic = FileTopic(d, "t")
        dpub = TopicPublisher(dtopic)
        for seed in (1, 2):
            dpub.publish(window(10 + seed)[0])

        def mk(r):
            return ContinualTrainer(
                r, name, dtopic, workdir=os.path.join(d, "loop"),
                gate_set=gate, initial_source=drill_boot, feature_width=784,
                window_records=1, batch_size=MLP_B, gate_margin=100.0,
                canary_fraction=CONT_FRACTION,
                canary_policy=CanaryPolicy(min_requests=4),
                canary_timeout_s=30.0, canary_poll_s=0.0, buckets=(1, 8),
                fsync_journal=False,
                traffic_hook=lambda: [r.observe_canary(
                    name, "canary", latency_s=1e-3) for _ in range(4)])

        r1 = pt.ModelRegistry(buckets=(1, 8), device=DEVICE)
        crashed = False
        try:
            with crash_at_write(f"continual/{point}"):
                t1 = mk(r1)
                t1.recover()
                t1.run(max_cycles=4, poll_timeout_s=0)
        except SimulatedCrash:
            crashed = True
        check(crashed, f"drill {point}: the crash point never fired")
        jpath = os.path.join(d, "loop", "journal.jsonl")
        pre = ContinualJournal(jpath).replay()
        promoted = [rec for rec in pre if rec["kind"] == "promoted"][-1]
        expect = pt.ModelRegistry(buckets=(1, 8), device=DEVICE)
        expect.register(name, pt.ModelSerializer.restore(promoted["ckpt"],
                                                         device=DEVICE))
        want = expect.predict(name, x_probe)[0]
        r2 = pt.ModelRegistry(buckets=(1, 8), device=DEVICE)
        t2 = mk(r2)
        t2.recover()
        got = r2.predict(name, x_probe)[0]
        check(np.array_equal(got, want), f"drill {point}: the recovered "
              "stable version is not the last promoted checkpoint")
        check(r2.canary_state(name) is None, f"drill {point}: a candidate "
              "is live after recovery")
        post = ContinualJournal(jpath).replay()
        if pre and pre[-1]["kind"] in ("window", "gate", "canary"):
            check(post[len(pre)]["kind"] == "rolled_back"
                  and post[len(pre)]["reason"] == "crash_recovery",
                  f"drill {point}: the open cycle was not closed as "
                  "crash_recovery")
        t2.run(max_cycles=8, poll_timeout_s=0)
        spans = sorted((rec["start"], rec["end"]) for rec in
                       ContinualJournal(jpath).replay()
                       if rec["kind"] == "window")
        check(spans[0][0] == 0 and spans[-1][1] == 2 and all(
            s2 == e1 for (_, e1), (s2, _) in zip(spans, spans[1:])),
            f"drill {point}: windows replayed or skipped: {spans}")
        check(dtopic.committed("continual") == 2, f"drill {point}: "
              f"committed offset {dtopic.committed('continual')}")
        drill[point] = [rec["kind"] for rec in
                        ContinualJournal(jpath).replay()]
    drill_s = time.perf_counter() - t_drill
    out["drill"] = {"points": len(drill), "seconds": drill_s,
                    "journals": drill}
    print(f"{tag} continual crash drill (narrow BN network, windows of one "
          f"record): {len(drill)} points, each "
          "recovered on the card to its last promoted checkpoint "
          "(bit-equal outputs), no candidate live, windows tiled once; "
          f"{drill_s:.2f} s")

    # -- (c) the streaming route: the char-RNN through kernel 6 ------------
    net = pt.char_rnn(vocab_size=VOCAB, lstm_size=HIDDEN, seq_len=SEQ,
                      device=DEVICE)
    net.init(generator=torch.Generator().manual_seed(1))
    rnn_zip = os.path.join(tmp, "continual_char_rnn.zip")
    pt.ModelSerializer.write_model(net, rnn_zip)
    cpu_rnn = pt.ModelSerializer.restore(rnn_zip, device="cpu")
    rng = np.random.default_rng(17)
    route_stats, route_err, n_batches = {}, 0.0, 0
    reset_counts()
    with NDArrayConsumer() as sink:
        route = InferenceRoute(rnn_zip, device=DEVICE,
                               forward=NDArrayPublisher(sink.host,
                                                        sink.port)).start()
        try:
            with NDArrayPublisher("127.0.0.1", route.port) as src:
                for b in BUCKETS:
                    xs = [one_hot_batch(rng, b) for _ in range(ROUTE_REPS)]
                    outs, times = [], []
                    for x in xs:            # one at a time: latency
                        t0 = time.perf_counter()
                        src.publish(x)
                        outs.append(sink.take(timeout=60))
                        times.append(time.perf_counter() - t0)
                    t0 = time.perf_counter()
                    for x in xs:            # all at once: throughput
                        src.publish(x)
                    outs += [sink.take(timeout=60) for _ in xs]
                    wall = time.perf_counter() - t0
                    check(all(o is not None for o in outs), f"route B={b}: "
                          f"{sum(o is None for o in outs)} of {len(outs)} "
                          "outputs never arrived")
                    for x, o in zip(xs + xs, outs):
                        want = cpu_rnn.output(x).numpy()
                        err = float(np.abs(o - want).max())
                        route_err = max(route_err, err)
                    n_batches += len(outs)
                    route_stats[b] = {
                        "p50_ms": percentile_ms([v * 1e3 for v in times],
                                                50),
                        "arrays_per_s": len(xs) / wall,
                        "rows_per_s": len(xs) * b / wall}
        finally:
            route.stop()
            route.forward.close()
    check(route_err <= SERVE_TOL, f"route outputs vs the CPU: max abs err "
          f"{route_err} > {SERVE_TOL}")
    route_launches = lstm.launches
    check(route_launches == 2 * n_batches, f"the route launched the LSTM "
          f"kernel {route_launches} times for {n_batches} batches (want 2 "
          "a batch)")
    check(lstm.variant_counts()["fwd"] == {"cluster": route_launches,
                                           "streamed": 0},
          f"route LSTM variants {lstm.variant_counts()['fwd']}")
    lc = lstm.launch_counts()
    check(lc["residual_launches"] == lc["adjoint_launches"]
          == lc["reduction_launches"] == 0
          and set(attention.launch_counts().values()) == {0}
          and set(bn_relu.launch_counts().values()) == {0},
          f"the route launched other kernels: {lc} "
          f"{attention.launch_counts()} {bn_relu.launch_counts()}")
    out["route"] = {"batches": n_batches, "launches": route_launches,
                    "max_abs_err": route_err, "by_batch": route_stats}
    print(f"{tag} continual route (char-RNN zip, InferenceRoute on the "
          f"card): {n_batches} batches, every output arrived, max abs err "
          f"vs CPU {route_err:.3e} (limit {SERVE_TOL}); {route_launches} "
          "LSTM launches (2 a batch, cluster), no training launch; "
          + "; ".join(f"B={b}: p50 {s['p50_ms']:.3f} ms, "
                      f"{s['arrays_per_s']:.1f} arrays/s "
                      f"({s['rows_per_s']:.1f} rows/s)"
                      for b, s in route_stats.items()))
    out["seconds"] = time.perf_counter() - t_phase
    print(f"{tag} phase 17 (continual, drill, route): "
          f"{out['seconds']:.1f} s")
    shutil.rmtree(root, ignore_errors=True)
    return out


# ---- main path 14: the data-parallel trainer ------------------------------
# ParallelTrainer on a one-rank NCCL group (torch.distributed, rendezvous on
# localhost): the bf16 LM of phase 9 at nanoGPT's widths and batch 64 x 256
# (kernels 1-3) under every SYNC strategy at superstep 1 and 4 against the
# model's own fit on the card; the BN-MLP of phase 8 at batch 128 (kernels
# 4-5) in AVERAGING and SYNC ZERO2 with the evaluation plane; a sharded
# checkpoint and resume; the CLI. NCCL refuses two ranks on one device,
# so collectives across cards stay unverified here.
PAR_LM_STEPS = 8
PAR_STRATEGIES = (("replicated", {}), ("zero1", {"strategy": "zero1"}),
                  ("zero2", {"strategy": "zero2"}),
                  ("zero2_bf16", {"strategy": "zero2",
                                  "zero_reduce_dtype": "bfloat16"}),
                  ("fsdp", {"strategy": "fsdp"}))
PAR_MLP_EPOCHS = 5             # 2 batches of 128 digits an epoch: 10 steps
PAR_CKPT_AT = 4
# the bf16 wire's parameter gap to fit over the norm of fit's move from
# the zip: it read 9.09e-3 on the H100, its controls 1 (no update) and
# 0.194 (the last step lost); the limit sits 5.5x above the one and under
# a third of the other
PAR_WIRE_TOL = 5e-2


def _free_port():
    import socket
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _flat(torch, tree):
    from deeplearning4j_tpu_torch.nn.trees import flat_leaves
    return torch.cat([t.detach().float().reshape(-1).cpu()
                      for t in flat_leaves(tree)])


def flat_rel_l2(torch, a, b, origin=None):
    """L2 of a - b over two trees' leaves, all together, relative to b's
    norm, or with `origin` to the norm of b's move from it."""
    x, y = _flat(torch, a), _flat(torch, b)
    ref = y if origin is None else y - _flat(torch, origin)
    return float((x - y).norm() / ref.norm().clamp_min(1e-30))


def _f32_compute(net):
    """`net` computing in float32 (its masters' dtype)."""
    net._compute_dtype = None
    return net


def add_parallel_launches(line, par):
    """Each attention and BN+ReLU row (kernels 1-5) of the kernels line
    gains `parallel_launches`: its launches on main path 14 (the bf16 LM's
    8 REPLICATED steps at superstep 4, the BN-MLP's 10 ZERO2 steps)."""
    att, var, bn = par["attention"], par["attention_variants"], par["bn"]
    for e in line["kernels"]:
        name, v = e["name"], e.get("variant")
        if name.startswith("bn_relu"):
            kind = "fwd" if "forward" in name else "bwd"
            n = bn[kind].get(v or "resident", 0)
        elif name.startswith("attention_bwd"):
            kind = "dkv" if "_dkv" in name else "dq"
            n = var[kind].get(v or "simt", 0)
        elif name.startswith("flash_attention"):
            if "wide" in name:
                n = 0
            elif "lse" in name:
                n = att["lse_launches"]
            else:
                n = att["launches"]
        else:
            continue
        e["parallel_launches"] = n
        e["parallel_per"] = ("main path 14: 8 steps of the bf16 LM (B=64, "
                             "T=256) by ParallelTrainer REPLICATED at "
                             "superstep 4 on a one-rank NCCL group, 6 a "
                             "step" if "attention" in name else
                             "main path 14: 10 steps of the BN-MLP (N=128, "
                             "C=1024, bf16) by ParallelTrainer ZERO2, one "
                             "launch per BN layer a step")


def parallel_path(pt, torch, tag, tmp, root, reset_counts):
    """Main path 14 (phase 18): the data-parallel trainer on a one-rank
    NCCL group through kernels 1-5. Returns its launches and numbers."""
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.fault import SimulatedCrash, crash_at_write
    from deeplearning4j_tpu_torch.kernels import attention, bn_relu, lstm
    from deeplearning4j_tpu_torch.parallel import (ParallelTrainer,
                                                   ShardedCheckpoint,
                                                   initialize, make_mesh)
    t_phase = time.perf_counter()
    out = {"card": tag.strip("[]"), "lm": {}, "times": {}}
    L = pt.ListDataSetIterator
    own_group = not dist.is_initialized()
    if own_group:
        check(initialize(f"localhost:{_free_port()}", 1, 0) is True,
              "initialize did not make a process group")
    check(dist.get_backend() == "nccl", f"backend {dist.get_backend()}, "
          "want nccl on the card")
    mesh = make_mesh()
    check(mesh.distributed and mesh.size == 1 and mesh.device.type == "cuda",
          f"the one-rank mesh is {mesh}")

    def same(a, b):
        return (trees_equal(torch, a.params, b.params)
                and trees_equal(torch, a.updater_state, b.updater_state)
                and trees_equal(torch, a.state, b.state)
                and a.iteration_count == b.iteration_count)

    # -- (a) the bf16 LM, kernels 1-3 --------------------------------------
    ids, lab = lm_text_batches(root)
    lm_batches = [pt.DataSet(ids[i:i + LM_TRAIN_B], lab[i:i + LM_TRAIN_B])
                  for i in range(0, PAR_LM_STEPS * LM_TRAIN_B, LM_TRAIN_B)]
    lzip = os.path.join(tmp, "par_lm.zip")
    pt.ModelSerializer.write_model(make_lm(
        pt, torch, 81, updater=pt.Adam(LM_LR, beta2=0.99),
        compute_dtype="bfloat16", warmup=True), lzip)
    per = LM_BLOCKS * PAR_LM_STEPS
    want_a = {"launches": 0, "lse_launches": per, "dq_launches": per,
              "dkv_launches": per}
    # one restore of the zip; every run starts from a clone of it
    base = pt.ModelSerializer.restore(lzip, device=DEVICE)
    fresh = base.clone
    refs = {}
    for k in (1, 4):
        n = fresh()
        n.fit(L(lm_batches), superstep=k)
        torch.cuda.synchronize()
        refs[k] = n
    check(same(refs[1], refs[4]), "bf16 LM fit superstep=4 differs from 1")
    # the bf16 wire is held to fit by its gap over fit's move from the
    # zip; two wrong updates read against the same yardstick: none at
    # all (1 by construction) and the last step lost (a stale update)
    stale = fresh()
    stale.fit(L(lm_batches[:-1]))
    torch.cuda.synchronize()
    wire_controls = {
        "no_update": flat_rel_l2(torch, base.params, refs[1].params,
                                 base.params),
        "last_step_lost": flat_rel_l2(torch, stale.params, refs[1].params,
                                      base.params)}
    check(min(wire_controls.values()) > PAR_WIRE_TOL,
          f"the wire check's controls {wire_controls} do not exceed its "
          f"limit {PAR_WIRE_TOL}")
    out["wire_controls"] = wire_controls
    print(f"{tag} parallel (a) the bf16 wire's controls against fit's move: "
          + ", ".join(f"{k} {v:.3e}" for k, v in wire_controls.items()))
    par_launches = None
    for name, kw in PAR_STRATEGIES:
        for k in (1, 4):
            n = fresh()
            tr = ParallelTrainer(n, mesh=mesh, **kw)
            reset_counts()
            t0 = time.perf_counter()
            if k == 1:
                step_ms = []
                for ds in lm_batches:
                    t1 = time.perf_counter()
                    tr._fit_batch(ds)
                    torch.cuda.synchronize()
                    step_ms.append(1e3 * (time.perf_counter() - t1))
                tr._sync_back()
            else:
                tr.fit(L(lm_batches), superstep=k)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = attention.launch_counts()
            var = attention.variant_counts()
            check(counts == want_a and var["dq"]["wgmma"] == per
                  and var["dkv"]["wgmma"] == per
                  and var["dq"].get("simt", 0) == var["dkv"].get("simt", 0)
                  == 0, f"parallel {name} superstep={k}: attention launches "
                  f"{counts} {var}, want {want_a}, all wgmma")
            check(set(lstm.launch_counts().values()) == {0}
                  and set(bn_relu.launch_counts().values()) == {0},
                  f"parallel {name}: LSTM or BN launches")
            if name == "replicated" and k == 4:
                par_launches = {"attention": dict(counts),
                                "attention_variants": {
                                    kk: dict(v) for kk, v in var.items()}}
            ref = refs[k]
            bit = same(n, ref)
            p_err = flat_rel_l2(torch, n.params, ref.params)
            o_err = flat_rel_l2(torch, n.updater_state, ref.updater_state)
            s_err = abs(float(tr.score()) - float(ref._score)) / max(
                abs(float(ref._score)), 1e-30)
            m_err = flat_rel_l2(torch, n.params, ref.params, base.params)
            if name != "zero2_bf16":
                # one rank: the mean is an identity, and the ZeRO chunks
                # are the whole tensors, updated by the same arithmetic
                check(bit, f"parallel {name} superstep={k} is not "
                      "bit-equal to fit on the card")
            else:
                check(s_err <= BF16_SCORE_TOL and p_err <= BF16_PARAM_TOL
                      and m_err <= PAR_WIRE_TOL,
                      f"parallel {name} superstep={k}: score {s_err:.3e} "
                      f"(limit {BF16_SCORE_TOL}), params {p_err:.3e} "
                      f"(limit {BF16_PARAM_TOL}), {m_err:.3e} of fit's "
                      f"move (limit {PAR_WIRE_TOL}; controls "
                      f"{wire_controls}) against fit")
            caps = len(tr.__dict__.get("_captured_steps", {}))
            check(caps == (1 if k == 4 else 0), f"parallel {name} "
                  f"superstep={k}: {caps} captures")
            row = {"bit_equal": bit, "param_rel_l2": p_err,
                   "param_rel_move": m_err, "opt_rel_l2": o_err,
                   "score_rel": s_err, "wall_s": wall}
            if k == 1:
                row["step_p50_ms"] = float(np.median(step_ms))
            else:
                # steady state: a second fit replays the captured step
                t1 = time.perf_counter()
                tr.fit(L(lm_batches), superstep=k)
                torch.cuda.synchronize()
                row["step_ms"] = 1e3 * (time.perf_counter() - t1) / \
                    PAR_LM_STEPS
            out["lm"][f"{name} K={k}"] = row
            print(f"{tag} parallel (a) bf16 LM {name} superstep={k}: "
                  + ("bit-equal to fit" if bit else
                     f"params {p_err:.3e} ({m_err:.3e} of fit's move), "
                     f"updater {o_err:.3e}, score {s_err:.3e} from fit "
                     f"(limits {BF16_PARAM_TOL}, {PAR_WIRE_TOL}, "
                     f"{BF16_SCORE_TOL})")
                  + f"; attention {counts} (dq / dk/dv all wgmma); "
                  + (f"step p50 {row['step_p50_ms']:.3f} ms"
                     if k == 1 else f"step {row['step_ms']:.3f} ms "
                     "(replays)") + f"; wall {wall:.2f} s")
    # device time and idle share of a replayed window, two strategies
    for name, kw in (("replicated", {}), ("zero2", {"strategy": "zero2"})):
        tr = ParallelTrainer(fresh(), mesh=mesh, **kw)
        tr.fit(L(lm_batches), superstep=4)                  # captures
        busy, pwall, _ = window_profile(
            torch, lambda: tr.fit(L(lm_batches), superstep=4))
        out["times"][name] = {"busy_ms_per_step": busy / PAR_LM_STEPS,
                              "idle_share": 1 - busy / pwall,
                              "wall_ms_per_step": pwall / PAR_LM_STEPS}
        print(f"{tag} parallel (a) bf16 LM {name} superstep=4 under the "
              f"profiler: device busy {busy / PAR_LM_STEPS:.3f} ms a step, "
              f"idle share {1 - busy / pwall:.3f}")

    out["seconds_a"] = time.perf_counter() - t_phase
    # -- (b) the BN-MLP, kernels 4-5 ---------------------------------------
    x_tr, y_tr, x_te, y_te = pt.bundled_mnist_subset()
    mb = [pt.DataSet(x_tr[i:i + MLP_B], y_tr[i:i + MLP_B])
          for i in (0, MLP_B)]
    mzip = os.path.join(tmp, "par_mlp.zip")
    pt.ModelSerializer.write_model(pt.MultiLayerNetwork(
        pt.MultiLayerConfiguration.from_json(bn_mlp_json(pt)),
        device=DEVICE).init(generator=torch.Generator().manual_seed(82)),
        mzip)
    mref = pt.ModelSerializer.restore(mzip, device=DEVICE)
    mref.fit(L(mb), epochs=PAR_MLP_EPOCHS)
    test = pt.DataSet(x_te, y_te)
    steps = PAR_MLP_EPOCHS * len(mb)
    out["mlp"] = {}
    for name, kw in (("averaging", {"mode": "averaging",
                                    "averaging_frequency": 5,
                                    "average_updaters": True}),
                     ("zero2", {"strategy": "zero2"})):
        n = pt.ModelSerializer.restore(mzip, device=DEVICE)
        tr = ParallelTrainer(n, mesh=mesh, **kw)
        reset_counts()
        tr.fit(L(mb), epochs=PAR_MLP_EPOCHS)
        torch.cuda.synchronize()
        got = bn_relu.variant_counts()
        want_b = {kind: {"resident": 2 * steps, "streamed": 0}
                  for kind in ("fwd", "bwd")}
        check(got == want_b, f"parallel BN-MLP {name}: BN launches {got}, "
              f"want {want_b}")
        if name == "zero2":
            par_launches["bn"] = {kk: dict(v) for kk, v in got.items()}
        reset_counts()
        ev = tr.evaluate(L([test]))
        score = tr.score(test)
        per_ex = tr.score_examples(test)
        check(set(bn_relu.launch_counts().values()) == {0},
              f"parallel BN-MLP {name} evaluation launched BN kernels")
        bit = same(n, mref)
        ref_ev = mref.evaluate(L([test]))
        ref_score = mref.score(test)
        ref_ex = mref.score_examples(test)
        ex_err = float(np.abs(per_ex - ref_ex).max())
        s_err = abs(score - ref_score)
        p_err = flat_rel_l2(torch, n.params, mref.params)
        check((ev.confusion.matrix == ref_ev.confusion.matrix).all(),
              f"parallel BN-MLP {name}: evaluation differs from fit's")
        # one rank: AVERAGING's mean and ZERO2's chunks are identities
        check(bit and s_err == 0 and ex_err == 0,
              f"parallel BN-MLP {name} is not bit-equal to fit: score "
              f"{s_err:.3e}, per-example {ex_err:.3e}, params {p_err:.3e}")
        out["mlp"][name] = {"launches": got, "bit_equal": bit,
                            "score_err": s_err,
                            "examples_err": ex_err, "param_rel_l2": p_err,
                            "accuracy": ev.accuracy()}
        print(f"{tag} parallel (b) BN-MLP {name}, {steps} steps: BN "
              f"launches {got}, none in evaluation; bit-equal to fit "
              f"(score, score_examples, confusion; accuracy "
              f"{ev.accuracy():.4f})")

    out["seconds_b"] = time.perf_counter() - t_phase
    # -- (c) a sharded checkpoint of the ZERO2 run at step 4, resumed ------
    ck = os.path.join(tmp, "par_ckpt")
    ref = fresh()
    ParallelTrainer(ref, mesh=mesh, strategy="zero2").fit(L(lm_batches))
    n = fresh()
    crashed = False
    with crash_at_write("sharded/tree_written", nth=2):
        try:
            ParallelTrainer(n, mesh=mesh, strategy="zero2").fit(
                L(lm_batches), checkpoint_dir=ck,
                checkpoint_every=PAR_CKPT_AT)
        except SimulatedCrash:
            crashed = True
    mgr = ShardedCheckpoint(ck)
    check(crashed and mgr.latest_step() == PAR_CKPT_AT,
          f"sharded checkpoint: crashed={crashed}, latest committed step "
          f"{mgr.latest_step()}, want {PAR_CKPT_AT}")
    n2 = fresh()
    t0 = time.perf_counter()
    tr2 = ParallelTrainer(n2, mesh=mesh, strategy="zero2")
    tr2.fit(L(lm_batches), checkpoint_dir=ck, checkpoint_every=PAR_CKPT_AT,
            resume=True)
    torch.cuda.synchronize()
    check(same(n2, ref), "ZERO2 resumed from the step-4 sharded checkpoint "
          "is not bit-equal to the uninterrupted run (parameters, updater "
          "state, counters)")
    print(f"{tag} parallel (c) ZERO2 killed in its second sharded save, "
          f"resumed from step {PAR_CKPT_AT}: parameters and updater state "
          f"bit-equal to the uninterrupted run ({time.perf_counter() - t0:.2f}"
          " s with the restore)")
    out["resume_bit_equal"] = True

    out["seconds_c"] = time.perf_counter() - t_phase
    # -- (d) the CLI --------------------------------------------------------
    csv = os.path.join(tmp, "par_digits.csv")
    rows = np.concatenate([x_tr[:MLP_B], y_tr[:MLP_B].argmax(1)[:, None]],
                          axis=1)
    np.savetxt(csv, rows, delimiter=",", fmt="%.6g")
    czip = os.path.join(tmp, "par_cli.zip")
    proc = subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.parallel",
         "--model", mzip, "--data", csv, "--label-index", "-1",
         "--num-classes", "10", "--batch-size", str(MLP_B),
         "--coordinator", f"localhost:{_free_port()}", "--num-processes",
         "1", "--process-id", "0", "--save-to", czip],
        capture_output=True, text=True, cwd=root, timeout=300)
    check(proc.returncode == 0, f"the parallel CLI failed: {proc.stderr}")
    card_net = pt.ModelSerializer.restore(czip, device=DEVICE)
    cpu_net = pt.ModelSerializer.restore(czip, device="cpu")
    check(trees_equal(torch, card_net.params, cpu_net.params),
          "the CLI's zip restores different parameters on the CPU")
    # the zip on both devices in float32 compute: the transfer, at the
    # serving limit
    f32 = lambda dev: _f32_compute(pt.ModelSerializer.restore(czip,
                                                              device=dev))
    zip_err = float(np.abs(f32("cpu").output(x_te).numpy()
                           - f32(DEVICE).output(x_te).float().cpu().numpy()
                           ).max())
    check(zip_err <= SERVE_TOL, f"the CLI's zip in float32: CPU outputs "
          f"{zip_err:.3e} from the card's > {SERVE_TOL}")
    # the same step trained on the CPU (one rank: the model's own fit)
    cpu_ref = pt.ModelSerializer.restore(mzip, device="cpu")
    cpu_ref.fit(pt.DataSet(x_tr[:MLP_B], y_tr[:MLP_B]))
    got = cpu_net.output(x_te).float().numpy()
    want = cpu_ref.output(x_te).float().numpy()
    cli_err = float(np.abs(got - want).max())
    out["cli"] = {"zip_output_err": zip_err, "train_output_err": cli_err}
    print(f"{tag} parallel (d) CLI: one step of the BN-MLP zip on the card "
          "(a one-rank NCCL group); the zip restores on the CPU bit-equal "
          f"in parameters, its float32 outputs {zip_err:.3e} from the "
          f"card's (limit {SERVE_TOL}); its bf16 outputs {cli_err:.3e} from "
          f"the same step trained on the CPU (limit {BF16_SCORE_TOL}: one "
          "bf16 Adam step on each device)")
    check(cli_err <= BF16_SCORE_TOL, f"parallel CLI outputs {cli_err:.3e} "
          f"from the CPU-trained step's > {BF16_SCORE_TOL}")
    out["launches"] = par_launches
    if own_group:
        dist.destroy_process_group()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"{tag} main path 14 (data-parallel trainer): "
          f"{out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# main path 15 (phase 19): the model-parallel half of the parallel stack
# ---------------------------------------------------------------------------
# Ranks that share the one card run gloo (NCCL refuses two ranks on a
# device), their compute on the card and every collective staged through
# pinned host memory by the port's collective layer
# (parallel/collectives.py; the H100 machine's gloo has no CUDA transport).
MP_WORLD = 4                   # worker processes on the one card
MP_LM_STEPS = PAR_LM_STEPS     # the bf16 LM's steps, batch 64 x 256
MP_GPIPE_STAGES, MP_GPIPE_MICRO = 2, 4
MP_BN_RANKS = 2
MP_RING = (4, 512, 6, 64)      # B, T, H, Dh of the ring's check (f32)
# the ring's output against kernel 1's primal on the whole sequence:
# float32 sums in another order, relative to the largest |output|
RING_TOL = 1e-5
MP_ELASTIC_STEPS, MP_ELASTIC_EVERY, MP_ELASTIC_SIGTERM = 4, 2, 1
# Each run is held to its reference by its parameter gap over the norm of
# the reference's move from the zip (`flat_rel_l2(..., origin)`): the LM
# runs to the model's own fit at PAR_WIRE_TOL, beside three wrong updates
# that must read past it (no update, the last step lost, each step on
# half its batch). The BN-MLP of (d) against the one-rank fused run: its
# bf16 noise alone reads about 5e-2 of that move (a 2-rank split on the
# CPU, 4.9e-2; 10 steps of Adam flip the near-zero gradients' steps), the
# level of one lost step of ten, so its parameters are held at
# MP_BN_MOVE_TOL, which its fault (each rank's own statistics, 0.42 on
# the CPU) reads past, and its running statistics, which that noise
# hardly moves (4.2e-3 on the CPU), at MP_BN_STATE_MOVE_TOL, which the
# last step lost reads past (5.8e-2 on the CPU).
MP_BN_MOVE_TOL = 0.15
MP_BN_STATE_MOVE_TOL = 2e-2
SPLIT_ROWS = (64, 2048)        # rows a rank of the split BN kernels
SPLIT_C = MLP_WIDTH
# the strategies of (a) and (c): (name, mesh axes, trainer kwargs)
MP_LM_RUNS = (
    ("tensor_parallel", {"data": 1, "model": 2},
     {"strategy": "tensor_parallel"}),
    ("zero1_tp", {"data": 1, "model": 2}, {"strategy": "zero1_tp"}),
    ("pp", {"data": 1, "model": 1, "pipe": 2}, {"strategy": "pp"}),
    ("zero1_tp_pp", {"data": 1, "model": 2, "pipe": 2},
     {"strategy": "zero1_tp_pp"}))


def split_bound(kind, N, C, itemsize):
    """The least time of one split kernel over an [N, C] rank: the bytes
    it must move (x, dy read once; y, dx written once; the [C] vectors and
    the [3, C] / [2, C] results) over HBM, a few FLOPs an element."""
    nc = N * C * itemsize
    nbytes, flops = {"stats": (nc + 12 * C, 4 * N * C),
                     "apply": (2 * nc + 16 * C, 5 * N * C),
                     "bwd_sums": (2 * nc + 24 * C, 8 * N * C),
                     "bwd_dx": (3 * nc + 32 * C, 10 * N * C)}[kind]
    return bound(nbytes, flops)


def split_bn_checks(torch, tag):
    """Phase 2 and 10 for the four split BN+ReLU kernels: each against its
    plain version at SPLIT_ROWS rows a rank, C = 1024, bf16 (y and dx
    within one bf16 ulp plus BN_TOL of the largest magnitude; the [3, C]
    and [2, C] sums at BN_TOL), the ranks' stats merged by Chan's formula
    against the fused forward's over the union; then each timed at 2048
    rows beside its plain version and a library call, with its bound.
    Launches here are comparisons: the counts are reset after."""
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.kernels import bn_relu, bn_split as s
    out = {"errors": {}, "times": {}}
    for N in SPLIT_ROWS:
        x, g, b, dy = bn_args(torch, N, SPLIT_C, "bfloat16", 190 + N)
        st = s.split_stats(x)
        want_st = s.split_stats_reference(x)
        n, mean, var = s.chan_merge([s.split_stats(x[:N // 2]),
                                     s.split_stats(x[N // 2:])])
        _, f_mean, f_var = bn_relu.bn_relu_forward(x, g, b)
        y = s.split_apply(x, g, b, mean, var)
        want_y = s.split_apply_reference(x, g, b, mean, var)
        sums = s.split_bwd_sums(x, g, b, mean, var, dy)
        want_sums = s.split_bwd_sums_reference(x, g, b, mean, var, dy)
        dx = s.split_bwd_dx(x, g, b, mean, var, dy, want_sums, float(N))
        want_dx = s.split_bwd_dx_reference(x, g, b, mean, var, dy, want_sums,
                                           float(N))
        torch.cuda.synchronize()
        err = lambda a, w: float((a.float() - w.float()).abs().max())
        rel = lambda a, w: err(a, w) / max(float(w.float().abs().max()),
                                           1e-30)
        sums_rel = {"stats": rel(st, want_st),
                    "bwd_sums": rel(sums, want_sums),
                    "merge_mean": rel(mean, f_mean),
                    "merge_var": rel(var, f_var)}
        for k, r in sums_rel.items():
            check(r <= BN_TOL, f"split BN {k} at N={N}: {r:.3e} of the "
                  f"largest magnitude > {BN_TOL}")
        errs = {"stats": err(st, want_st), "bwd_sums": err(sums, want_sums)}
        for k, got, want in (("apply", y, want_y), ("bwd_dx", dx, want_dx)):
            ok, errs[k], _ = ulp_err(got, want, "bfloat16")
            check(ok, f"split BN {k} at N={N}: {errs[k]:.3e} beyond one "
                  f"bf16 ulp + {BN_TOL}")
        out["errors"][N] = dict(errs, relative=sums_rel)
        print(f"{tag} split BN+ReLU kernels vs plain at N={N} (a rank's "
              f"rows), C={SPLIT_C}, bf16, max abs err: stats "
              f"{errs['stats']:.3e} ({sums_rel['stats']:.3e} of the largest"
              f" value), apply {errs['apply']:.3e}, bwd_sums "
              f"{errs['bwd_sums']:.3e} ({sums_rel['bwd_sums']:.3e}), bwd_dx"
              f" {errs['bwd_dx']:.3e}; two halves merged by Chan's formula "
              f"vs the fused forward's stats: mean "
              f"{sums_rel['merge_mean']:.3e}, var "
              f"{sums_rel['merge_var']:.3e} of the largest")
    # times at 2048 rows a rank
    N = SPLIT_ROWS[-1]
    x, g, b, dy = bn_args(torch, N, SPLIT_C, "bfloat16", 199)
    n, mean, var = s.chan_merge([s.split_stats(x)])
    sums = s.split_bwd_sums(x, g, b, mean, var, dy)
    yl = torch.relu(F.batch_norm(x, mean, var, g, b, training=False,
                                 eps=1e-5))
    zero = torch.zeros((), dtype=dy.dtype, device=dy.device)
    invstd = torch.rsqrt(var + 1e-5)

    def lib_bwd():
        # the library's backward of the apply: the ReLU mask, then ATen's
        # given-statistics BatchNorm backward (dx, dgamma, dbeta; its CUDA
        # path wants the saved statistics defined even in eval mode)
        return torch.ops.aten.native_batch_norm_backward(
            torch.where(yl > 0, dy, zero), x, g, mean, var, mean, invstd,
            False, 1e-5, [True, True, True])
    calls = {
        "stats": (lambda: s.split_stats(x),
                  lambda: s.split_stats_reference(x),
                  lambda: torch.var_mean(x, dim=0, correction=0),
                  "torch.var_mean over the rank's rows (bf16 in)"),
        "apply": (lambda: s.split_apply(x, g, b, mean, var),
                  lambda: s.split_apply_reference(x, g, b, mean, var),
                  lambda: torch.relu(F.batch_norm(x, mean, var, g, b,
                                                  training=False,
                                                  eps=1e-5)),
                  "F.batch_norm(training=False) with the given statistics,"
                  " then relu"),
        "bwd_sums": (lambda: s.split_bwd_sums(x, g, b, mean, var, dy),
                     lambda: s.split_bwd_sums_reference(x, g, b, mean, var,
                                                        dy),
                     lib_bwd,
                     "the apply's library backward: the ReLU mask and "
                     "aten.native_batch_norm_backward with the given "
                     "statistics (dx, dgamma, dbeta; beside both backward "
                     "kernels)"),
        "bwd_dx": (lambda: s.split_bwd_dx(x, g, b, mean, var, dy, sums,
                                          float(N)),
                   lambda: s.split_bwd_dx_reference(x, g, b, mean, var, dy,
                                                    sums, float(N)),
                   lib_bwd, "the apply's library backward, as bwd_sums'"),
    }
    for kind, (kern, plain, lib, what) in calls.items():
        bms, by = split_bound(kind, N, SPLIT_C, 2)
        out["times"][kind] = {"ms": graph_ms(torch, kern),
                              "wall_ms": cuda_ms(torch, kern),
                              "plain_ms": graph_ms(torch, plain),
                              "library_ms": graph_ms(torch, lib),
                              "library": what, "bound_ms": bms,
                              "bound_by": by}
        t = out["times"][kind]
        print(f"{tag} split BN {kind} at N={N} a rank, C={SPLIT_C}, bf16 "
              f"(device ms a call, replayed from a CUDA graph): "
              f"{t['ms']:.4f} ({t['wall_ms']:.4f} a call launched back to "
              f"back), plain {t['plain_ms']:.4f}, library "
              f"{t['library_ms']:.4f}, bound {bms:.4f} ({by})")
    s.reset_launches()
    bn_relu.reset_launches()
    return out


def _mp_flat(torch, tree):
    from deeplearning4j_tpu_torch.nn.trees import flat_leaves
    return torch.cat([t.detach().float().reshape(-1).cpu()
                      for t in flat_leaves(tree)]).numpy()


def _mp_lm_job(pt, torch, rank, tmp, name, axes, kw):
    """One LM run of (a) / (c) on the ranks of its mesh: 8 steps of the
    bf16 LM from the zip; rank 0's parameters, every rank's launches,
    host copies and step times."""
    from deeplearning4j_tpu_torch.kernels import attention
    from deeplearning4j_tpu_torch.parallel import (ParallelTrainer,
                                                   collectives, make_mesh)
    n = int(np.prod(list(axes.values())))
    mesh = make_mesh(dict(axes), devices=list(range(n)), device=DEVICE)
    if rank >= n:
        return None
    net = pt.ModelSerializer.restore(os.path.join(tmp, "mp_lm.zip"),
                                     device=DEVICE)
    d = np.load(os.path.join(tmp, "mp_lm.npz"))
    batches = [pt.DataSet(d["x"][i:i + LM_TRAIN_B], d["y"][i:i + LM_TRAIN_B])
               for i in range(0, MP_LM_STEPS * LM_TRAIN_B, LM_TRAIN_B)]
    tr = ParallelTrainer(net, mesh=mesh, **kw)
    attention.reset_launches()
    collectives.reset_host_copies()
    step_ms = []
    for ds in batches:
        t0 = time.perf_counter()
        tr._fit_batch(ds)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
    counts = attention.launch_counts()
    var = attention.variant_counts()
    copies = collectives.host_copies()
    score = float(tr.score())
    tr._sync_back()
    return {"flat": _mp_flat(torch, net.params) if rank == 0 else None,
            "counts": counts, "variants": {k: dict(v) for k, v in
                                           var.items()},
            "copies": copies, "step_ms": step_ms, "score": score,
            "flash": tr.flash_mode}


def _mp_bn_job(pt, torch, rank, tmp):
    """(d): the BN-MLP under SYNC REPLICATED over MP_BN_RANKS ranks (the
    global batch of 128 split), 10 steps; the split kernels' launches."""
    from deeplearning4j_tpu_torch.kernels import bn_relu, bn_split
    from deeplearning4j_tpu_torch.parallel import (ParallelTrainer,
                                                   collectives, make_mesh)
    mesh = make_mesh({"data": MP_BN_RANKS},
                     devices=list(range(MP_BN_RANKS)), device=DEVICE)
    if rank >= MP_BN_RANKS:
        return None
    net = pt.ModelSerializer.restore(os.path.join(tmp, "mp_mlp.zip"),
                                     device=DEVICE)
    d = np.load(os.path.join(tmp, "mp_mlp.npz"))
    mb = [pt.DataSet(d["x"][i:i + MLP_B], d["y"][i:i + MLP_B])
          for i in (0, MLP_B)]
    tr = ParallelTrainer(net, mesh=mesh)
    bn_split.reset_launches()
    bn_relu.reset_launches()
    collectives.reset_host_copies()
    t0 = time.perf_counter()
    tr.fit(pt.ListDataSetIterator(mb), epochs=PAR_MLP_EPOCHS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = {"flat": _mp_flat(torch, net.params) if rank == 0 else None,
           "state": _mp_flat(torch, net.state) if rank == 0 else None,
           "split": bn_split.launch_counts(),
           "fused": bn_relu.launch_counts(),
           "copies": collectives.host_copies(), "wall_s": wall,
           "score": float(tr.score())}
    # the control: the fault the split kernels fix, each rank normalising
    # by its own rows' statistics (the gradients still all-reduced)
    ctl = pt.ModelSerializer.restore(os.path.join(tmp, "mp_mlp.zip"),
                                     device=DEVICE)
    tr = ParallelTrainer(ctl, mesh=mesh)
    tr._bn_global = False
    tr.fit(pt.ListDataSetIterator(mb), epochs=PAR_MLP_EPOCHS)
    torch.cuda.synchronize()
    out["per_rank_flat"] = _mp_flat(torch, ctl.params) if rank == 0 \
        else None
    out["per_rank_state"] = _mp_flat(torch, ctl.state) if rank == 0 \
        else None
    return out


def _mp_ring_job(pt, torch, rank, tmp):
    """(e): ring attention over a sequence group of 2 ranks, f32: this
    rank's block of the output and of the gradients (sum of the output)."""
    from deeplearning4j_tpu_torch.parallel import make_mesh
    from deeplearning4j_tpu_torch.parallel.ring_attention import \
        ring_self_attention
    mesh = make_mesh({"seq": 2}, devices=[0, 1], device=DEVICE)
    if rank >= 2:
        return None
    B, T, H, Dh = MP_RING
    r = np.random.default_rng(195)
    q, k, v = (torch.tensor(r.normal(size=(B, T, H, Dh)).astype(np.float32),
                            device=DEVICE) for _ in range(3))
    sl = slice(rank * T // 2, (rank + 1) * T // 2)
    qb, kb, vb = (a[:, sl].clone().requires_grad_(True) for a in (q, k, v))
    t0 = time.perf_counter()
    out = ring_self_attention(qb, kb, vb, mesh, axis="seq", causal=True)
    out.sum().backward()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"out": out.detach().cpu().numpy(),
            "dq": qb.grad.cpu().numpy(), "dk": kb.grad.cpu().numpy(),
            "dv": vb.grad.cpu().numpy(), "wall_s": wall}


def _mp_elastic_job(pt, torch, rank, tmp):
    """(f): ElasticTrainer over the whole world on the bf16 LM (data
    parallel): a SIGTERM to rank 1 at step MP_ELASTIC_SIGTERM drains every
    rank at the next edge; a new trainer resumes from the directory; an
    uninterrupted run in another directory is the control."""
    from deeplearning4j_tpu_torch.fault import injection
    from deeplearning4j_tpu_torch.parallel import ElasticTrainer
    d = np.load(os.path.join(tmp, "mp_lm.npz"))
    batches = [pt.DataSet(d["x"][i:i + LM_TRAIN_B], d["y"][i:i + LM_TRAIN_B])
               for i in range(0, MP_ELASTIC_STEPS * LM_TRAIN_B, LM_TRAIN_B)]
    factory = lambda: pt.ModelSerializer.restore(
        os.path.join(tmp, "mp_lm.zip"), device=DEVICE)
    kw = dict(mesh_shape=(MP_WORLD, 1), snapshot_every=MP_ELASTIC_EVERY,
              lease_ttl_s=120.0, commit_timeout_s=120.0, timeout_s=120.0,
              device=DEVICE)
    if rank == 1:
        injection.sigterm_at_step(MP_ELASTIC_SIGTERM)
    et = ElasticTrainer(factory, os.path.join(tmp, "elastic"), **kw)
    first = (et.fit(batches, MP_ELASTIC_STEPS), et.trainer.iteration_count)
    injection._crash_hooks.pop(injection.STEP_POINT, None)
    et = ElasticTrainer(factory, os.path.join(tmp, "elastic"), **kw)
    second = (et.fit(batches, MP_ELASTIC_STEPS), et.trainer.iteration_count)
    resumed = _mp_flat(torch, et.trainer.publish_view().params)
    ctl = ElasticTrainer(factory, os.path.join(tmp, "elastic_ctl"), **kw)
    third = (ctl.fit(batches, MP_ELASTIC_STEPS), ctl.trainer.iteration_count)
    control = _mp_flat(torch, ctl.trainer.publish_view().params)
    return {"first": first, "second": second, "control": third,
            "bit_equal": bool(np.array_equal(resumed, control))}


def _mp_worker(rank, port, tmp, results):
    """A rank of phase 19's world: gloo over localhost, tensors on the one
    card; runs every job in order (each job makes its mesh with every
    rank, as making a group takes) and puts (rank, ok, results)."""
    import datetime
    import traceback
    import torch
    import torch.distributed as dist
    try:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        import deeplearning4j_tpu_torch as pt
        from deeplearning4j_tpu_torch import kernels
        kernels.library()
        dist.init_process_group(
            "gloo", init_method=f"tcp://localhost:{port}",
            world_size=MP_WORLD, rank=rank,
            timeout=datetime.timedelta(seconds=180))
        out = {"probe": _gloo_probe(torch, dist, rank)}
        for name, axes, kw in MP_LM_RUNS:
            out[name] = _mp_lm_job(pt, torch, rank, tmp, name, axes, kw)
        out["bn"] = _mp_bn_job(pt, torch, rank, tmp)
        out["ring"] = _mp_ring_job(pt, torch, rank, tmp)
        out["elastic"] = _mp_elastic_job(pt, torch, rank, tmp)
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _gloo_probe(torch, dist, rank):
    """Which collectives gloo takes on CPU tensors between these
    processes (the transport the collective layer stages CUDA tensors
    through); a CUDA tensor handed to gloo itself aborts the process on
    this machine's build, so it is not tried."""
    res = {}
    t = torch.full((4,), float(rank + 1))
    dist.all_reduce(t)
    res["all_reduce"] = t.tolist() == [float(sum(range(1, MP_WORLD + 1)))] * 4
    out = torch.empty(4 * MP_WORLD)
    dist.all_gather_into_tensor(out, torch.full((4,), float(rank)))
    res["all_gather_into_tensor"] = out.reshape(MP_WORLD, 4)[:, 0].tolist() \
        == [float(r) for r in range(MP_WORLD)]
    o2 = torch.empty(1)
    dist.reduce_scatter_tensor(o2, torch.ones(MP_WORLD))
    res["reduce_scatter_tensor"] = float(o2) == float(MP_WORLD)
    buf = torch.empty(2)
    peer = rank ^ 1
    for w in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, torch.full((2,), float(rank)), peer),
            dist.P2POp(dist.irecv, buf, peer)]):
        w.wait()
    res["batch_isend_irecv"] = buf.tolist() == [float(peer)] * 2
    return res


def model_parallel_path(pt, torch, tag, tmp, root, reset_counts):
    """Main path 15 (phase 19): the model-parallel strategies through
    kernels 1-5 on the one card. Returns its launches and numbers."""
    import torch.multiprocessing as tmp_mp
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.kernels import attention, bn_relu, bn_split
    from deeplearning4j_tpu_torch.parallel import (ParallelTrainer,
                                                   PipelinedNetworkTrainer,
                                                   initialize, make_mesh)
    t_phase = time.perf_counter()
    L = pt.ListDataSetIterator
    out = {"card": tag.strip("[]"), "lm": {}}
    # -- the zips, batches and the single-process references --------------
    ids, lab = lm_text_batches(root)
    n_rows = MP_LM_STEPS * LM_TRAIN_B
    np.savez(os.path.join(tmp, "mp_lm.npz"), x=ids[:n_rows], y=lab[:n_rows])
    lm_batches = [pt.DataSet(ids[i:i + LM_TRAIN_B], lab[i:i + LM_TRAIN_B])
                  for i in range(0, n_rows, LM_TRAIN_B)]
    lzip = os.path.join(tmp, "mp_lm.zip")
    pt.ModelSerializer.write_model(make_lm(
        pt, torch, 91, updater=pt.Adam(LM_LR, beta2=0.99),
        compute_dtype="bfloat16", warmup=True), lzip)
    base = pt.ModelSerializer.restore(lzip, device=DEVICE)
    ref = base.clone()
    ref.fit(L(lm_batches))
    torch.cuda.synchronize()
    ref_flat = _mp_flat(torch, ref.params)
    base_flat = _mp_flat(torch, base.params)

    def move_gap(flat, ref_, base_):
        """|flat - ref_| over the norm of ref_'s move from base_."""
        return float(np.linalg.norm(flat - ref_)
                     / max(np.linalg.norm(ref_ - base_), 1e-30))

    # three wrong updates against the LM runs' yardstick: none at all (1
    # by construction), the last step lost, each step on half its rows
    stale, half = base.clone(), base.clone()
    stale.fit(L(lm_batches[:-1]))
    half.fit(L([pt.DataSet(ids[i:i + LM_TRAIN_B // 2],
                           lab[i:i + LM_TRAIN_B // 2])
                for i in range(0, n_rows, LM_TRAIN_B)]))
    torch.cuda.synchronize()
    lm_controls = {name: move_gap(_mp_flat(torch, n.params), ref_flat,
                                  base_flat)
                   for name, n in (("no_update", base),
                                   ("last_step_lost", stale),
                                   ("half_batch", half))}
    check(min(lm_controls.values()) > PAR_WIRE_TOL,
          f"the LM runs' controls {lm_controls} do not exceed their limit "
          f"{PAR_WIRE_TOL}")
    out["lm_controls"] = lm_controls
    print(f"{tag} model parallel: the bf16 LM runs are held to fit at "
          f"{PAR_WIRE_TOL} of fit's move; its controls read "
          + ", ".join(f"{k} {v:.3e}" for k, v in lm_controls.items()))
    del stale, half
    x_tr, y_tr, _, _ = pt.bundled_mnist_subset()
    np.savez(os.path.join(tmp, "mp_mlp.npz"), x=x_tr[:2 * MLP_B],
             y=y_tr[:2 * MLP_B])
    mzip = os.path.join(tmp, "mp_mlp.zip")
    pt.ModelSerializer.write_model(pt.MultiLayerNetwork(
        pt.MultiLayerConfiguration.from_json(bn_mlp_json(pt)),
        device=DEVICE).init(generator=torch.Generator().manual_seed(92)),
        mzip)
    mref = pt.ModelSerializer.restore(mzip, device=DEVICE)
    m_base = (_mp_flat(torch, mref.params), _mp_flat(torch, mref.state))
    mb = [pt.DataSet(x_tr[i:i + MLP_B], y_tr[i:i + MLP_B])
          for i in (0, MLP_B)]
    mref.fit(L(mb), epochs=PAR_MLP_EPOCHS)
    m_stale = pt.ModelSerializer.restore(mzip, device=DEVICE)
    m_stale.fit(L((mb * PAR_MLP_EPOCHS)[:-1]))
    torch.cuda.synchronize()

    def lm_gap(flat, what):
        p_err = float(np.linalg.norm(flat - ref_flat)
                      / max(np.linalg.norm(ref_flat), 1e-30))
        m_err = move_gap(flat, ref_flat, base_flat)
        check(p_err <= BF16_PARAM_TOL and m_err <= PAR_WIRE_TOL,
              f"{what}: parameters {p_err:.3e} from the model's own fit "
              f"(limit {BF16_PARAM_TOL}), {m_err:.3e} of its move (limit "
              f"{PAR_WIRE_TOL}; controls {lm_controls})")
        return p_err, m_err

    # -- (b) PIPELINE: the host-driven GPipe in this process ---------------
    n = base.clone()
    gp = PipelinedNetworkTrainer(
        n, n_stages=MP_GPIPE_STAGES, n_microbatches=MP_GPIPE_MICRO,
        boundaries=[1 + LM_BLOCKS // 2],            # 3 blocks a stage
        devices=[DEVICE] * MP_GPIPE_STAGES)
    reset_counts()
    bn_split.reset_launches()
    t0 = time.perf_counter()
    gp.fit(L(lm_batches))
    gp.sync_back()
    torch.cuda.synchronize()
    g_wall = time.perf_counter() - t0
    counts, var = attention.launch_counts(), attention.variant_counts()
    per = LM_BLOCKS * MP_GPIPE_MICRO * MP_LM_STEPS
    check(counts == {"launches": 0, "lse_launches": per, "dq_launches": per,
                     "dkv_launches": per}
          and var["dq"]["wgmma"] == var["dkv"]["wgmma"] == per,
          f"pipeline (GPipe): attention launches {counts} {var}, want "
          f"{per} each, wgmma")
    p_err, m_err = lm_gap(_mp_flat(torch, n.params), "pipeline (GPipe)")
    out["lm"]["pipeline"] = {"param_rel_l2": p_err, "param_rel_move": m_err,
                             "launches": counts, "wall_s": g_wall,
                             "step_ms": 1e3 * g_wall / MP_LM_STEPS}
    gpipe_launches = {k: counts[k] // MP_LM_STEPS
                      for k in ("lse_launches", "dq_launches",
                                "dkv_launches")}
    print(f"{tag} model parallel (b) bf16 LM by PIPELINE (GPipe, "
          f"{MP_GPIPE_STAGES} stages of {LM_BLOCKS // 2} blocks on the one "
          f"card, {MP_GPIPE_MICRO} microbatches), {MP_LM_STEPS} steps: "
          f"params {p_err:.3e} from the model's own fit, {m_err:.3e} of "
          f"its move (limits {BF16_PARAM_TOL}, {PAR_WIRE_TOL}); attention "
          f"{counts}, dq / "
          f"dk/dv all wgmma; {1e3 * g_wall / MP_LM_STEPS:.1f} ms a step")

    # -- TENSOR_PARALLEL and ZERO1_TP at one NCCL rank, superstep 4 --------
    own_group = not dist.is_initialized()
    if own_group:
        check(initialize(f"localhost:{_free_port()}", 1, 0) is True,
              "initialize did not make a process group")
    mesh = make_mesh({"data": 1, "model": 1}, device=DEVICE)
    out["nccl_superstep"] = {}
    for strategy in ("tensor_parallel", "zero1_tp"):
        runs = []
        for k in (1, 4):
            n = base.clone()
            ParallelTrainer(n, mesh=mesh, strategy=strategy).fit(
                L(lm_batches), superstep=k)
            torch.cuda.synchronize()
            runs.append(n)
        bit = (trees_equal(torch, runs[0].params, runs[1].params)
               and trees_equal(torch, runs[0].updater_state,
                               runs[1].updater_state))
        check(bit, f"{strategy} at one NCCL rank: superstep=4 is not "
              "bit-equal to superstep=1")
        out["nccl_superstep"][strategy] = bit
    print(f"{tag} model parallel: TENSOR_PARALLEL and ZERO1_TP on a "
          "one-rank NCCL group (data 1, model 1) at superstep 4 (CUDA-graph"
          " replays) bit-equal to superstep 1")
    if own_group:
        dist.destroy_process_group()

    # -- (a), (c), (d), (e), (f): the world of MP_WORLD processes ----------
    ctx = tmp_mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_mp_worker, args=(r, port, tmp, results))
             for r in range(MP_WORLD)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    got, errors = {}, []
    try:
        for _ in procs:
            rank, ok, val = results.get(timeout=900)
            if ok:
                got[rank] = val
            else:
                errors.append(f"rank {rank}:\n{val}")
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    check(not errors, "phase 19's world failed:\n" + "\n".join(errors))
    out["world_s"] = time.perf_counter() - t0
    out["gloo_cpu_probe"] = got[0]["probe"]
    print(f"{tag} model parallel: {MP_WORLD} processes on the one card, "
          "gloo between them; every collective of a CUDA tensor staged "
          "through pinned host memory (this machine's gloo has no CUDA "
          "transport); gloo's CPU collectives between the processes: "
          + ", ".join(f"{k} {'ok' if v else 'WRONG'}"
                      for k, v in got[0]["probe"].items()))
    check(all(got[0]["probe"].values()), "gloo's CPU collectives gave "
          f"wrong results: {got[0]['probe']}")
    launches = {"pipeline": {"per_rank_per_step": gpipe_launches,
                             "blocks_per_rank": LM_BLOCKS, "ranks": 1}}
    for name, axes, kw in MP_LM_RUNS:
        n_ranks = int(np.prod(list(axes.values())))
        rows = [got[r][name] for r in range(n_ranks)]
        blocks = LM_BLOCKS // axes.get("pipe", 1)
        per = blocks * MP_LM_STEPS
        for r, row in enumerate(rows):
            c, v = row["counts"], row["variants"]
            check(c == {"launches": 0, "lse_launches": per,
                        "dq_launches": per, "dkv_launches": per}
                  and v["dq"]["wgmma"] == v["dkv"]["wgmma"] == per,
                  f"{name} rank {r}: attention launches {c} {v}, want "
                  f"{per} each (wgmma)")
        p_err, m_err = lm_gap(rows[0]["flat"], name)
        s_err = abs(rows[0]["score"] - float(ref._score))
        check(s_err <= BF16_SCORE_TOL, f"{name}: last score {s_err:.3e} "
              f"from the model's own fit > {BF16_SCORE_TOL}")
        step = float(np.median(rows[0]["step_ms"]))
        copies = rows[0]["copies"]
        out["lm"][name] = {"param_rel_l2": p_err, "param_rel_move": m_err,
                           "score_err": s_err, "step_p50_ms": step,
                           "launches_rank0": rows[0]["counts"],
                           "host_copies_rank0": copies,
                           "flash": rows[0]["flash"], "ranks": n_ranks}
        launches[name] = {"per_rank_per_step": {
            k: rows[0]["counts"][k] // MP_LM_STEPS
            for k in ("lse_launches", "dq_launches", "dkv_launches")},
            "blocks_per_rank": blocks, "ranks": n_ranks}
        print(f"{tag} model parallel {'(a)' if 'pp' not in name else '(c)'}"
              f" bf16 LM by {name} on {axes} ({n_ranks} processes): params "
              f"{p_err:.3e} from the model's own fit, {m_err:.3e} of its "
              f"move (limits {BF16_PARAM_TOL}, {PAR_WIRE_TOL}), last score "
              f"{s_err:.3e} "
              f"(limit {BF16_SCORE_TOL}); attention a rank "
              f"{rows[0]['counts']} ({blocks} blocks x {MP_LM_STEPS} steps, "
              f"wgmma; flash mode {rows[0]['flash']}); step p50 "
              f"{step:.1f} ms; host staging on rank 0: "
              f"{copies['to_host']} + {copies['to_device']} copies, "
              f"{copies['bytes'] / 1e6:.1f} MB")
    # (d) global-batch BN over two ranks against the one-rank fused run
    rows = [got[r]["bn"] for r in range(MP_BN_RANKS)]
    steps = PAR_MLP_EPOCHS * 2
    want = {k: 2 * steps for k in ("stats_launches", "apply_launches",
                                   "bwd_sums_launches", "bwd_dx_launches")}
    for r, row in enumerate(rows):
        check(row["split"] == want and set(row["fused"].values()) == {0},
              f"BN-MLP over {MP_BN_RANKS} ranks, rank {r}: split launches "
              f"{row['split']} (want {want}), fused {row['fused']} (want "
              "none)")
    m_flat = _mp_flat(torch, mref.params)
    bn_err = float(np.linalg.norm(rows[0]["flat"] - m_flat)
                   / np.linalg.norm(m_flat))
    st_flat = _mp_flat(torch, mref.state)
    st_err = float(np.linalg.norm(rows[0]["state"] - st_flat)
                   / np.linalg.norm(st_flat))
    bs_err = abs(rows[0]["score"] - float(mref._score))

    def bn_move(params, state):
        """(parameter, running-statistics) gaps over their moves."""
        return (move_gap(params, m_flat, m_base[0]),
                move_gap(state, st_flat, m_base[1]))

    def bn_held(gaps):
        return (gaps[0] <= MP_BN_MOVE_TOL
                and gaps[1] <= MP_BN_STATE_MOVE_TOL)

    bn_gaps = bn_move(rows[0]["flat"], rows[0]["state"])
    bn_controls = {
        "no_update": bn_move(*m_base),
        "last_step_lost": bn_move(_mp_flat(torch, m_stale.params),
                                  _mp_flat(torch, m_stale.state)),
        "per_rank_statistics": bn_move(rows[0]["per_rank_flat"],
                                       rows[0]["per_rank_state"])}
    ctl_text = ", ".join(f"{k} {a:.3e} / {b:.3e}"
                         for k, (a, b) in bn_controls.items())
    check(not any(bn_held(g) for g in bn_controls.values()),
          f"(d)'s controls (parameters / running statistics over their "
          f"moves) {ctl_text} do not exceed the limits {MP_BN_MOVE_TOL} / "
          f"{MP_BN_STATE_MOVE_TOL}")
    check(bn_held(bn_gaps) and bn_err <= BF16_PARAM_TOL
          and st_err <= BF16_PARAM_TOL and bs_err <= BF16_SCORE_TOL,
          f"BN-MLP over {MP_BN_RANKS} ranks vs the one-rank fused run: "
          f"params {bn_err:.3e}, running stats {st_err:.3e} (limit "
          f"{BF16_PARAM_TOL}); over their moves {bn_gaps[0]:.3e} / "
          f"{bn_gaps[1]:.3e} (limits {MP_BN_MOVE_TOL} / "
          f"{MP_BN_STATE_MOVE_TOL}; controls {ctl_text}); score "
          f"{bs_err:.3e} (limit {BF16_SCORE_TOL})")
    out["bn"] = {"param_rel_l2": bn_err, "state_rel_l2": st_err,
                 "param_rel_move": bn_gaps[0], "state_rel_move": bn_gaps[1],
                 "controls": bn_controls,
                 "score_err": bs_err, "split_launches_rank0": rows[0]["split"],
                 "host_copies_rank0": rows[0]["copies"],
                 "wall_s": rows[0]["wall_s"]}
    launches["bn"] = {"per_rank_per_step": {k: v // steps for k, v in
                                            rows[0]["split"].items()},
                      "ranks": MP_BN_RANKS}
    print(f"{tag} model parallel (d) BN-MLP (bf16, global batch {MLP_B}, "
          f"{steps} steps) under SYNC REPLICATED over {MP_BN_RANKS} "
          f"processes through the split kernels: params {bn_err:.3e}, "
          f"running stats {st_err:.3e}, score {bs_err:.3e} from the "
          f"one-rank fused run (limits {BF16_PARAM_TOL}, {BF16_SCORE_TOL}); "
          f"over their moves {bn_gaps[0]:.3e} / {bn_gaps[1]:.3e} (limits "
          f"{MP_BN_MOVE_TOL} / {MP_BN_STATE_MOVE_TOL}); controls "
          f"{ctl_text}; split launches a rank {rows[0]['split']}, fused "
          "none")
    # (e) ring attention against kernel 1's primal on the whole sequence
    from deeplearning4j_tpu_torch.kernels.attention import \
        flash_attention_heads
    from deeplearning4j_tpu_torch.parallel.ring_attention import \
        local_attention_reference
    B, T, H, Dh = MP_RING
    r = np.random.default_rng(195)
    q, k, v = (torch.tensor(r.normal(size=(B, T, H, Dh)).astype(np.float32),
                            device=DEVICE) for _ in range(3))
    ring_out = np.concatenate([got[i]["ring"]["out"] for i in (0, 1)], 1)
    with torch.no_grad():
        want_o = flash_attention_heads(q, k, v, True).cpu().numpy()
    ring_err = float(np.abs(ring_out - want_o).max() / np.abs(want_o).max())
    qq, kk, vv = (a.clone().requires_grad_(True) for a in (q, k, v))
    local_attention_reference(qq, kk, vv, True).sum().backward()
    grad_err = max(
        float(np.abs(np.concatenate([got[i]["ring"][nm] for i in (0, 1)], 1)
                     - t.grad.cpu().numpy()).max()
              / np.abs(t.grad.cpu().numpy()).max())
        for nm, t in (("dq", qq), ("dk", kk), ("dv", vv)))
    check(ring_err <= RING_TOL and grad_err <= RING_TOL,
          f"ring attention over 2 ranks: output {ring_err:.3e} from kernel "
          f"1's primal, gradients {grad_err:.3e} from plain autograd "
          f"(limit {RING_TOL})")
    out["ring"] = {"out_rel_err": ring_err, "grad_rel_err": grad_err,
                   "wall_s": got[0]["ring"]["wall_s"]}
    print(f"{tag} model parallel (e) ring attention over 2 processes "
          f"(B={B}, T={T}, H={H}, Dh={Dh}, causal, f32): output "
          f"{ring_err:.3e} of the largest |o| from kernel 1's primal on the "
          f"whole sequence, dq/dk/dv {grad_err:.3e} from autograd of the "
          f"plain attention (limit {RING_TOL})")
    # (f) the elastic drain and resume
    el = got[0]["elastic"]
    check(all(tuple(got[r]["elastic"]["first"]) ==
              ("drained", MP_ELASTIC_EVERY) for r in range(MP_WORLD))
          and tuple(el["second"]) == ("completed", MP_ELASTIC_STEPS)
          and el["bit_equal"],
          "elastic drain / resume: "
          f"{[got[r]['elastic'] for r in range(MP_WORLD)]}")
    out["elastic"] = el
    print(f"{tag} model parallel (f) ElasticTrainer on the bf16 LM over "
          f"{MP_WORLD} processes: SIGTERM to rank 1 at step "
          f"{MP_ELASTIC_SIGTERM}, every rank drained at edge "
          f"{MP_ELASTIC_EVERY}; a new trainer resumed to step "
          f"{MP_ELASTIC_STEPS}, final parameters bit-equal to the "
          "uninterrupted run")
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    print(f"{tag} main path 15 (model-parallel trainer): "
          f"{out['seconds']:.1f} s ({out['world_s']:.1f} s in the world of "
          f"{MP_WORLD})")
    return out


def add_model_parallel_launches(line, mp, split):
    """The attention rows (kernels 1-3) gain `model_parallel_launches`:
    per rank and step on main path 15; the BN rows (kernels 4-5) the
    split path's; and the four split kernels their rows."""
    for e in line["kernels"]:
        name = e["name"]
        if name.startswith("attention_bwd") and e.get("variant") == "wgmma" \
                or name == "flash_attention_fwd_lse_heads":
            key = ("dq_launches" if "_dq" in name else "dkv_launches"
                   if "_dkv" in name else "lse_launches")
            e["model_parallel_launches"] = {
                run: v["per_rank_per_step"][key]
                for run, v in mp["launches"].items() if run != "bn"}
            e["model_parallel_per"] = ("main path 15: launches a rank a "
                                       "step of the bf16 LM (B=64, T=256)")
        elif name.startswith("bn_relu") and e.get("variant") == "resident":
            e["model_parallel_launches"] = 0
            e["model_parallel_per"] = ("main path 15: at 2 data ranks the "
                                       "split kernels take the BN layer")
    rows = []
    for kind, replaces in (
            ("stats", "deeplearning4j_tpu/kernels/bn_relu.py:38 "
                      "(_fwd_kernel's two-pass statistics via _fwd_call's "
                      "pallas_call :88, over a rank's rows)"),
            ("apply", "deeplearning4j_tpu/kernels/bn_relu.py:38 "
                      "(_fwd_kernel's normalise + ReLU via :88, global "
                      "statistics)"),
            ("bwd_sums", "deeplearning4j_tpu/kernels/bn_relu.py:50 "
                         "(_bwd_kernel's dgamma / dbeta sums via _bwd_call's"
                         " pallas_call :123, over a rank's rows)"),
            ("bwd_dx", "deeplearning4j_tpu/kernels/bn_relu.py:50 "
                       "(_bwd_kernel's dx via :123, global sums)")):
        t = split["times"][kind]
        rows.append({
            "name": f"bn_split_{kind}", "route": "cuda",
            "source": "deeplearning4j_tpu_torch/kernels/csrc/bn_relu.cu",
            "replaces": replaces, "variant": "split",
            "launches": mp["bn"]["split_launches_rank0"][f"{kind}_launches"],
            "model_parallel_launches": mp["launches"]["bn"][
                "per_rank_per_step"][f"{kind}_launches"],
            "max_abs_err": max(split["errors"][n][kind]
                               for n in SPLIT_ROWS),
            "per": f"one launch at N={SPLIT_ROWS[-1]} rows a rank, "
                   f"C={SPLIT_C}, bf16; launches: rank 0 of main path 15's "
                   "BN-MLP over 2 ranks (N=64 a rank, 2 BN layers, 10 "
                   "steps)",
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "library": t["library"],
            "card": mp["card"]})
    line["kernels"].extend(rows)


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
    from deeplearning4j_tpu_torch.kernels import (attention, bn_relu, bn_split,
                                                  lstm)
    from deeplearning4j_tpu_torch.nn.weights import Distribution

    def reset_counts():
        lstm.reset_launches()
        attention.reset_launches()
        bn_relu.reset_launches()
        bn_split.reset_launches()

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
    if "--loop-only" in sys.argv:
        # phase 2's CUDA-graph checks and main path 11 alone, for work on
        # the training loop; prints no result lines
        capture_checks(torch, kernels, lstm, attention, bn_relu, tag)
        with tempfile.TemporaryDirectory() as tmp:
            loop_path(pt, torch, tag, tmp,
                      os.path.dirname(os.path.abspath(__file__)),
                      reset_counts)
        print(f"{tag} --loop-only run: {time.perf_counter() - t_start:.1f} "
              "s (kernel build included)")
        return 0
    if "--continual-only" in sys.argv:
        # main path 13 alone, for work on the continual plane, streaming
        # and model import; prints no result lines
        with tempfile.TemporaryDirectory() as tmp:
            cont = continual_path(pt, torch, tag, tmp, reset_counts)
        print(json.dumps({"continual": cont}, default=str))
        print(f"{tag} --continual-only run: "
              f"{time.perf_counter() - t_start:.1f} s (kernel build "
              "included)")
        return 0
    if "--parallel-only" in sys.argv:
        # main path 14 alone, for work on the data-parallel trainer;
        # prints no result lines
        with tempfile.TemporaryDirectory() as tmp:
            par = parallel_path(pt, torch, tag, tmp,
                                os.path.dirname(os.path.abspath(__file__)),
                                reset_counts)
        print(json.dumps({"parallel": par}, default=str))
        print(f"{tag} --parallel-only run: "
              f"{time.perf_counter() - t_start:.1f} s (kernel build "
              "included)")
        return 0
    if "--model-parallel-only" in sys.argv:
        # the split BN kernels' checks and main path 15 alone, for work on
        # the model-parallel trainer; prints no result lines
        split = split_bn_checks(torch, tag)
        with tempfile.TemporaryDirectory() as tmp:
            mp = model_parallel_path(
                pt, torch, tag, tmp,
                os.path.dirname(os.path.abspath(__file__)), reset_counts)
        print(json.dumps({"model_parallel": mp, "split": split},
                         default=str))
        print(f"{tag} --model-parallel-only run: "
              f"{time.perf_counter() - t_start:.1f} s (kernel build "
              "included)")
        return 0
    if "--decode-only" in sys.argv:
        # main path 12 alone, for work on the decode plane; prints no
        # result lines
        with tempfile.TemporaryDirectory() as tmp:
            decode = decode_path(pt, torch, tag, tmp,
                                 os.path.dirname(os.path.abspath(__file__)),
                                 reset_counts)
        print(json.dumps({"generation": decode}, default=str))
        print(f"{tag} --decode-only run: {time.perf_counter() - t_start:.1f}"
              " s (kernel build included)")
        return 0

    # ---- 2. kernels vs plain on the card --------------------------------
    print(f"{tag} phase 2 starts at {time.perf_counter() - t_start:.1f} s")
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

    # each kernel variant captured in a CUDA graph and replayed
    n_captured = capture_checks(torch, kernels, lstm, attention, bn_relu,
                                tag)
    # the split BN+ReLU kernels of the data-parallel BN layer: against
    # their plain versions, and their times (phase 10's)
    split = split_bn_checks(torch, tag)

    # ---- 3. main path 1: serve the char-RNN -----------------------------
    print(f"{tag} phase 3 starts at {time.perf_counter() - t_start:.1f} s")
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
    print(f"{tag} phase 4 starts at {time.perf_counter() - t_start:.1f} s")
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
    print(f"{tag} phase 5 starts at {time.perf_counter() - t_start:.1f} s")
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
    print(f"{tag} phase 6 starts at {time.perf_counter() - t_start:.1f} s")
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
    print(f"{tag} phase 7 starts at {time.perf_counter() - t_start:.1f} s")
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
    print(f"{tag} phase 8 starts at {time.perf_counter() - t_start:.1f} s")
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
    print(f"{tag} phase 9 starts at {time.perf_counter() - t_start:.1f} s")
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

    # card against CPU: LM_CMP_STEPS steps at batch LM_CMP_B from the
    # same zip
    bf16_nets = [pt.ModelSerializer.restore(bf16_zip),
                 pt.ModelSerializer.restore(bf16_zip, device="cpu")]
    bf16_logs = [StepLog(), StepLog()]
    reset_counts()
    t0 = time.perf_counter()
    for n, log in zip(bf16_nets, bf16_logs):
        n.set_listeners(log)
        n.fit(lm_batches(LM_CMP_STEPS * LM_CMP_B, LM_CMP_B))
    bf16_cmp_s = time.perf_counter() - t0
    check(attention.launch_counts()["lse_launches"]
          == LM_BLOCKS * LM_CMP_STEPS,
          f"bf16 comparison run launches {attention.launch_counts()}")
    bf16_cmp = [[float(v) for v in log.scores] for log in bf16_logs]
    bf16_score_err = float(np.abs(np.subtract(*bf16_cmp)).max())
    bf16_param_err = adam_param_err(*bf16_nets, LM_LR, LM_CMP_STEPS)
    check_key_bias(bf16_nets, LM_CMP_STEPS, "bf16 LM comparison")

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
          f"{LM_CMP_STEPS}-step scores at batch {LM_CMP_B} max abs err "
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
          f"{LM_CMP_STEPS} steps: {bf16_param_err} > {BF16_PARAM_TOL}")
    check(bf16_cmp[0][-1] < bf16_cmp[0][0], "the bf16 LM score did not fall "
          f"at batch {LM_CMP_B}: {bf16_cmp[0]}")
    check(bf16_serve_err <= BF16_SCORE_TOL, f"bf16 LM served vs CPU: max abs "
          f"err {bf16_serve_err} > {BF16_SCORE_TOL}")

    # the same steps without the warm-up, through the kernels and
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
            n.fit(lm_batches(LM_CMP_STEPS * LM_CMP_B, LM_CMP_B))
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
    print(f"{tag} phase 10 starts at {time.perf_counter() - t_start:.1f} s")
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
    print(f"{tag} phase 11 starts at {time.perf_counter() - t_start:.1f} s")
    cnn_path(pt, torch, tag, tmp, reset_counts, lambda: {
        f"{mod.__name__.rsplit('.', 1)[-1]}/{k}": n
        for mod in (lstm, attention, bn_relu)
        for k, n in mod.launch_counts().items()})
    # ---- 12. main path 8: the bidirectional LSTM ------------------------
    print(f"{tag} phase 12 starts at {time.perf_counter() - t_start:.1f} s")
    hand_counts = lambda: {
        f"{mod.__name__.rsplit('.', 1)[-1]}/{k}": n
        for mod in (lstm, attention, bn_relu)
        for k, n in mod.launch_counts().items()}
    bilstm = bilstm_path(pt, torch, tag, tmp, root, reset_counts)
    check(set(attention.launch_counts().values()) == {0}, "the BiLSTM path "
          f"launched attention kernels: {attention.launch_counts()}")
    check_no_bn_launches("BiLSTM")

    # ---- 13. main path 9: layerwise pretraining; the MoE step -----------
    print(f"{tag} phase 13 starts at {time.perf_counter() - t_start:.1f} s")
    pretrain_path(pt, torch, tag, tmp, reset_counts, hand_counts)
    moe_step(pt, torch, tag, hand_counts)

    # ---- 14. main path 10: ComputationGraphs ----------------------------
    print(f"{tag} phase 14 starts at {time.perf_counter() - t_start:.1f} s")
    graph = graph_path(pt, torch, tag, tmp, root, reset_counts, hand_counts)
    check(set(attention.launch_counts().values()) == {0}, "the graph path "
          f"launched attention kernels: {attention.launch_counts()}")

    # ---- 15. main path 11: the training loop ------------------------------
    print(f"{tag} phase 15 starts at {time.perf_counter() - t_start:.1f} s")
    loop = loop_path(pt, torch, tag, tmp, root, reset_counts)
    # ---- 16. main path 12: generation, the decode plane -----------------
    print(f"{tag} phase 16 starts at {time.perf_counter() - t_start:.1f} s")
    decode = decode_path(pt, torch, tag, tmp, root, reset_counts)
    check(set(lstm.launch_counts().values()) == {0}
          and set(bn_relu.launch_counts().values()) == {0},
          "the decode path launched LSTM or BN+ReLU kernels: "
          f"{lstm.launch_counts()} {bn_relu.launch_counts()}")
    # ---- 17. main path 13: the continual loop, its crash drill, the route
    print(f"{tag} phase 17 starts at {time.perf_counter() - t_start:.1f} s")
    cont = continual_path(pt, torch, tag, tmp, reset_counts)
    # ---- 18. main path 14: the data-parallel trainer --------------------
    print(f"{tag} phase 18 starts at {time.perf_counter() - t_start:.1f} s")
    par = parallel_path(pt, torch, tag, tmp, root, reset_counts)
    # ---- 19. main path 15: the model-parallel trainer -------------------
    print(f"{tag} phase 19 starts at {time.perf_counter() - t_start:.1f} s")
    mp = model_parallel_path(pt, torch, tag, tmp, root, reset_counts)
    print(f"{tag} chip_smoke run: {time.perf_counter() - t_start:.1f} s "
          "(kernel build included)")

    print(json.dumps({"training_loop": loop, "captured_variants":
                      n_captured}, default=str))
    print(json.dumps({"generation": decode}, default=str))
    print(json.dumps({"continual": cont}, default=str))
    print(json.dumps({"parallel": par}, default=str))
    print(json.dumps({"model_parallel": mp}, default=str))
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
    kernels_line = {"kernels": [{
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
        "graph_launches": graph["seq2seq"]["rnn_time_step_launches"],
        "graph_per": f"main path 10: {S2S_STEP_T} rnn_time_step calls of "
                     f"the seq2seq graph (encoder F={VOCAB} and decoder F="
                     f"{VOCAB + HIDDEN}, H={HIDDEN}, B={S2S_STEP_B}), 2 "
                     "launches a call, all cluster",
        "route_launches": cont["route"]["launches"],
        "route_per": f"main path 13: {cont['route']['batches']} batches "
                     "of the char-RNN through the InferenceRoute (B 1, 8 "
                     "and 32), 2 launches a batch, all cluster",
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
        "bf16": dict(typed_entry("primal", bf16_serve_counts["launches"]),
                     decode_launches=decode["launches"]["counted"][
                         "bfloat16"],
                     decode_per="main path 12: the bf16 LM's prefills (its "
                                "teacher-forced engine checks and /generate),"
                                " one launch per block, bfloat16 "
                                "instantiation; read from the counters"),
        "decode_launches": decode["launches"]["counted"]["float32"],
        "decode_per": "main path 12: every prefill of its engine checks, "
                      "HTTP windows, pool pressure, int8 KV, canary and "
                      f"times ({LM_BLOCKS} a prefill, float32 "
                      "instantiation, prompt buckets 8-256; none per decode "
                      "tick), read from the counters less the stateless "
                      "plane's forwards; the benches after it not counted",
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
        "bilstm_launches": (
            bilstm["launches"][counter] if key == "reduction" else
            bilstm["variants"][key]["cluster"]),
        "bilstm_per": ("main path 8's 20 steps: one launch a layer and "
                       "direction a step" if key == "reduction" else
                       f"main path 8's 20 steps: layer 1 (F={VOCAB}) of "
                       "the BiLSTM, both directions"),
        "graph_launches": graph["seq2seq"]["launches"][counter],
        "graph_per": f"main path 10's {S2S_STEPS} steps of the seq2seq "
                     f"graph: encoder (F={VOCAB}) and decoder (F="
                     f"{VOCAB + HIDDEN}), one launch each a step"
                     + ("" if key == "reduction" else ", all cluster"),
        "loop_launches": loop["char_rnn"]["launches"][counter],
        "loop_per": "main path 11: the char-RNN's fit_scan, 20 TBPTT chunk "
                    "steps replayed from one CUDA graph, 2 launches a step",
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
            **({} if kind == "fwd" else {"bilstm_layer2": {
                "launches": bilstm["variants"][kind]["streamed"],
                "per": f"main path 8's 20 steps: layer 2 of the BiLSTM "
                       f"(T={BI_T}, B={BI_B}, F={BI_F2}, H={HIDDEN}), both "
                       "directions; times per launch at that shape",
                **bilstm["times"]["layer2_streamed"][kind]}}),
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
            "loop_launches": loop["lm"]["launches"]["lse_launches"],
            "loop_per": f"main path 11: {LOOP_LM_STEPS} steps of the bf16 "
                        f"LM at batch {LM_CMP_B} under superstep=4 (CUDA-"
                        f"graph replays), {LM_BLOCKS} a step",
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
            **({"loop_launches": loop["lm"]["launches"][f"{kind}_launches"],
                "loop_per": f"main path 11: {LOOP_LM_STEPS} steps of the "
                            f"bf16 LM at batch {LM_CMP_B} under superstep=4 "
                            f"(CUDA-graph replays), {LM_BLOCKS} a step"}
               if variant == "wgmma" else {}),
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
            **({"graph_launches": graph["two_branch"]["variants"][key][
                "resident"],
                "graph_per": f"main path 10's {TB_STEPS} steps of the bf16 "
                             f"two-branch graph (N={TB_B}, C={TB_WIDTH}): one "
                             "launch per BN vertex a step",
                "loop_launches": loop["bn_mlp"]["launches"][key]["resident"],
                "loop_per": f"main path 11: {LOOP_BATCHES} steps of the "
                            "BN-MLP under superstep=4 (CUDA-graph replays), "
                            "one launch per BN layer a step",
                "continual_launches": cont["loop"]["launches"][key],
                "continual_per": f"main path 13: the continual loop's "
                                 f"{cont['loop']['steps']} fine-tune steps "
                                 f"of the BN-MLP (N={MLP_B}, C={MLP_WIDTH}, "
                                 "bf16; superstep 1 and 2, the windows at 2 "
                                 "replayed from CUDA graphs), one launch "
                                 "per BN layer a step"}
               if variant == "resident" else {}),
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
             "shapes its plan gives the resident variant"))]}
    add_parallel_launches(kernels_line, par["launches"])
    add_model_parallel_launches(kernels_line, mp, split)
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
