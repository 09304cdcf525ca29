#!/usr/bin/env python3
"""Drive the PyTorch port (deeplearning4j_tpu_torch) on one NVIDIA GPU and
check every phase. Run from the repository root:

    python3 chip_smoke.py

Phases:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions,
     and the kernel build from the repository's CUDA sources;
  2. each kernel against its plain PyTorch version on the same GPU tensors,
     at the shapes the main path gives it;
  3. the main path: the full-width char-RNN (vocab 77, 2 x GravesLSTM(200),
     seq 64, random weights from a seed) written to a zip, registered,
     served over HTTP in buckets 1, 8 and 32 (direct, batched, concurrent
     clients), hot-swapped, and checked against the same zip on the CPU;
  4. stateful sampling of 64 characters through rnn_time_step, each step
     held against the CPU;
  5. times: kernel, plain version and bound per forward at bucket 32,
     predict p50 per bucket, tokens/s at bucket 32.

Each kernel counts its launches; the counts are set to 0 before phases 3-4
and must equal two per char-RNN forward afterwards. The last two lines are a
`{"kernels": [...]}` object and `{"ok": true, "device": {...}}`. Any failed
check, or a machine without a CUDA device, exits non-zero before either.
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
SEQ, VOCAB, HIDDEN = 64, 77, 200
BUCKETS = (1, 8, 32)
KERNEL_TOL = 5e-5   # f32 sums of up to 400 terms in another order, x 64 steps
SERVE_TOL = 1e-4    # GPU kernel path vs the CPU plain path, end to end
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet, at 700 W
F32_FLOP_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
ALPHABET = string.ascii_letters + string.digits + " .,;:!?'\"-()&/\n"


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def http(method, url, body=None, timeout=120):
    req = urllib.request.Request(
        url, None if body is None else json.dumps(body).encode(),
        {"Content-Type": "application/json"}, method=method)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def one_hot_batch(rng, rows):
    idx = rng.integers(0, VOCAB, (rows, SEQ))
    return np.eye(VOCAB, dtype=np.float32)[idx]


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


def lstm_bound_ms(T, B, F, H):
    """Least time for one sequence forward: each input read once, each
    output written once, over HBM; the gate matmul's FLOPs over the f32
    (non-tensor-core) peak. Returns (ms, what bounds it)."""
    nbytes = 4 * (T * B * F + (F + H) * 4 * H + 7 * H + 2 * B * H
                  + T * B * H + 2 * B * H)
    flops = 2 * T * B * (F + H) * 4 * H
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


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


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import deeplearning4j_tpu_torch as pt
    from deeplearning4j_tpu_torch import kernels
    from deeplearning4j_tpu_torch.kernels import lstm

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

    # ---- 2. kernel vs plain on the card ---------------------------------
    max_err = 0.0
    shapes = [(SEQ, b, f, HIDDEN) for b in BUCKETS for f in (VOCAB, HIDDEN)]
    shapes += [(1, 1, f, HIDDEN) for f in (VOCAB, HIDDEN)]
    for T, B, F, H in shapes:
        args = lstm_inputs(torch, T, B, F, H, seed=T * 1000 + B * 10 + F)
        got = lstm.fused_lstm_sequence(*args, 1.0)
        want = lstm.lstm_sequence_reference(*args, 1.0)
        torch.cuda.synchronize()
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        check(err <= KERNEL_TOL, f"LSTM kernel T={T} B={B} F={F} H={H}: "
              f"max abs err {err} > {KERNEL_TOL}")
        max_err = max(max_err, err)
    print(f"kernel vs plain: {len(shapes)} shapes, max abs err {max_err:.3e}")

    # ---- 3. main path: serve the char-RNN -------------------------------
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    zips = []
    for seed in (1, 2):
        net = pt.char_rnn(vocab_size=VOCAB, lstm_size=HIDDEN, seq_len=SEQ)
        net.init(generator=torch.Generator().manual_seed(seed))
        path = os.path.join(tmp, f"char_rnn_{seed}.zip")
        pt.ModelSerializer.write_model(net, path)
        zips.append(path)
    cpu_nets = [pt.ModelSerializer.restore(z, device="cpu") for z in zips]

    def check_output(out, x, ref_net, what):
        out = np.asarray(out, np.float32)
        check(out.shape == (x.shape[0], SEQ, VOCAB),
              f"{what}: output shape {out.shape}")
        check(np.isfinite(out).all(), f"{what}: non-finite output")
        check(np.abs(out.sum(-1) - 1.0).max() <= 1e-4,
              f"{what}: rows do not sum to 1")
        ref = ref_net.output(x).numpy()
        err = float(np.abs(out - ref).max())
        check(err <= SERVE_TOL, f"{what}: max abs err {err} vs the CPU run")
        return err

    lstm.reset_launches()
    rng = np.random.default_rng(0)
    reg = pt.ModelRegistry(buckets=BUCKETS)
    srv = pt.InferenceServer(registry=reg, port=0).start()
    serve_err, n_batched = 0.0, 0
    try:
        reg.register("char_rnn", zips[0])
        v1 = reg.get("char_rnn")
        base = f"http://{srv.host}:{srv.port}/v1/models/char_rnn"
        for rows in (1, 5, 32):
            x = one_hot_batch(rng, rows)
            r = http("POST", f"{base}/predict", {"features": x.tolist()})
            check(r["version"] == 1 and r["batched"], f"{rows}-row reply {r.keys()}")
            serve_err = max(serve_err, check_output(
                r["output"], x, cpu_nets[0], f"{rows}-row request"))
            n_batched += 1
        failures, replies = [], []

        def client(i):
            crng = np.random.default_rng(100 + i)
            try:
                for j in range(4):
                    x = one_hot_batch(crng, 1 + (i + j) % 4)
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
        check(not failures, f"concurrent clients failed: {failures}")
        check(len(replies) == 32, f"{len(replies)} of 32 concurrent replies")
        for x, r in replies:
            check(r["batched"] and r["version"] == 1, "concurrent reply")
            serve_err = max(serve_err, check_output(
                r["output"], x, cpu_nets[0], "concurrent request"))
        n_batched += len(replies)
        flushes = srv._batchers["char_rnn"].flushes

        info = http("POST", f"{base}/swap", {"source": zips[1]})
        check(info["version"] == 2, f"swap gave version {info['version']}")
        v2 = reg.get("char_rnn")
        x = one_hot_batch(rng, 8)
        r = http("POST", f"{base}/predict", {"features": x.tolist(),
                                             "batched": False})
        check(r["version"] == 2 and not r["batched"], "post-swap reply")
        serve_err = max(serve_err, check_output(
            r["output"], x, cpu_nets[1], "post-swap request"))
        old = cpu_nets[0].output(x).numpy()
        check(np.abs(np.asarray(r["output"]) - old).max() > 1e-3,
              "post-swap output still follows the old weights")
    finally:
        srv.stop()
    check(not any(t.name.startswith("dl4j-torch-serving")
                  for t in threading.enumerate()), "serving threads left")
    forwards = v1.forwards + v2.forwards
    serve_launches = lstm.launches
    check(serve_launches == 2 * forwards,
          f"LSTM kernel launched {serve_launches} times for {forwards} "
          "forwards (want 2 per forward)")
    print(f"serving: {n_batched} batched requests in {flushes} flushes + "
          f"swap; {forwards} forwards, {serve_launches} kernel launches; "
          f"max abs err vs CPU {serve_err:.3e}")

    # ---- 4. stateful sampling ------------------------------------------
    sampler = pt.ModelSerializer.restore(zips[0])
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
    cpu = cpu_nets[0]
    cpu.rnn_clear_previous_state()
    sample_err = 0.0
    for x, out in steps:
        ref = cpu.rnn_time_step(x).numpy()
        sample_err = max(sample_err, float(np.abs(out - ref).max()))
    check(sample_err <= SERVE_TOL, f"rnn_time_step max abs err {sample_err}")
    sample_launches = lstm.launches - serve_launches
    check(sample_launches == 2 * len(steps),
          f"{sample_launches} launches for {len(steps)} rnn_time_step calls")
    main_launches = lstm.launches
    print(f"sampling: {len(steps)} rnn_time_step calls, {sample_launches} "
          f"kernel launches, max abs err vs CPU {sample_err:.3e}, "
          f"text {text!r}")

    # ---- 5. times (counted launches end above) --------------------------
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
    serving = {"card": card}
    reg = pt.ModelRegistry(buckets=BUCKETS)
    reg.register("char_rnn", zips[0])
    srv = pt.InferenceServer(registry=reg, port=0).start()
    try:
        base = f"http://{srv.host}:{srv.port}/v1/models/char_rnn"
        for b in BUCKETS:
            x = one_hot_batch(rng, b)
            fwd, web = [], []
            for _ in range(20):
                t0 = time.perf_counter()
                reg.predict("char_rnn", x)
                fwd.append(time.perf_counter() - t0)
            for _ in range(10):
                t0 = time.perf_counter()
                http("POST", f"{base}/predict", {"features": x.tolist(),
                                                 "batched": False})
                web.append(time.perf_counter() - t0)
            serving[f"predict_p50_ms_b{b}"] = 1e3 * float(np.median(fwd))
            serving[f"http_p50_ms_b{b}"] = 1e3 * float(np.median(web))
            print(f"{tag} bucket {b}: registry.predict p50 "
                  f"{serving[f'predict_p50_ms_b{b}']:.3f} ms, HTTP predict "
                  f"p50 {serving[f'http_p50_ms_b{b}']:.3f} ms")
    finally:
        srv.stop()
    serving["tokens_per_s_b32_predict"] = 32 * SEQ / (
        serving["predict_p50_ms_b32"] / 1e3)
    serving["tokens_per_s_b32_http"] = 32 * SEQ / (
        serving["http_p50_ms_b32"] / 1e3)
    print(f"{tag} tokens/s at bucket 32: "
          f"{serving['tokens_per_s_b32_predict']:.1f} (registry.predict), "
          f"{serving['tokens_per_s_b32_http']:.1f} (HTTP)")
    print(json.dumps({"serving": serving}))

    print(json.dumps({"kernels": [{
        "name": "fused_lstm_sequence",
        "route": "cuda",
        "source": "deeplearning4j_tpu_torch/kernels/csrc/lstm.cu",
        "replaces": "deeplearning4j_tpu/kernels/lstm.py:57 (_fwd_kernel via "
                    "_fwd_impl :121, fused_lstm_sequence :252)",
        "launches": main_launches,
        "max_abs_err": max_err,
        "per": "char-RNN forward at bucket 32 (2 launches: F=77 and "
               "F=200, H=200, T=64)",
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if bound_by == {"operations"} else "bytes",
        "library_ms": None,
        "card": card,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
