"""Whole-sequence Graves-LSTM forward: one CUDA kernel launch per layer.

Counterpart of `deeplearning4j_tpu/kernels/lstm.py:fused_lstm_sequence` in
primal (inference) mode. The kernel is `csrc/lstm.cu`; its header says what
bounds it and how its design answers that. The backward kernel and the
residual-saving forward wait for the training slice.

  * `fused_lstm_sequence` — the wrapper. CPU tensors go to the plain
    version; CUDA tensors launch the kernel or raise.
  * `lstm_sequence_reference` — the plain PyTorch version: a step loop of
    the same math, for the CPU and for holding the kernel to account.
  * `launches` — how many times the wrapper launched the kernel.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import torch

__all__ = ["fused_lstm_sequence", "lstm_sequence_reference", "launches",
           "reset_launches", "MAX_SHARED_BYTES"]

# dynamic shared memory a block may use on Hopper (232,448 bytes)
MAX_SHARED_BYTES = 227 * 1024

launches = 0
_launch_lock = threading.Lock()
_fn = None


def reset_launches() -> int:
    """Set the launch count to 0; returns the count it had."""
    global launches
    with _launch_lock:
        n, launches = launches, 0
    return n


def _canon(x, W, b, peep, h0, c0):
    """Every input in float32, biases and peepholes flat (as the TPU
    kernel's `_canon` does)."""
    f32 = torch.float32
    return (x.to(f32), W.to(f32), b.reshape(-1).to(f32),
            peep.reshape(-1).to(f32), h0.to(f32), c0.to(f32))


def lstm_sequence_reference(x, W, b, peep, h0, c0, offs: float
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Plain version: x [T, B, F] time-major, W [F+H, 4H] (i|f|o|g),
    b [4H], peep [3H] (i|f|o), carries [B, H]. Returns (hs, h_T, c_T) in
    float32."""
    x, W, b, peep, h, c = _canon(x, W, b, peep, h0, c0)
    H = h.shape[-1]
    p_i, p_f, p_o = peep[:H], peep[H:2 * H], peep[2 * H:]
    hs = []
    for t in range(x.shape[0]):
        z = torch.cat([x[t], h], dim=-1) @ W + b
        i = torch.sigmoid(z[:, :H] + c * p_i)
        f = torch.sigmoid(z[:, H:2 * H] + c * p_f + offs)
        g = torch.tanh(z[:, 3 * H:])
        c = f * c + i * g
        o = torch.sigmoid(z[:, 2 * H:3 * H] + c * p_o)
        h = o * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs), h, c


def _kernel_fn():
    global _fn
    if _fn is None:
        from . import library
        fn = library().dl4j_lstm_seq_fwd
        ptr = ctypes.c_void_p
        fn.argtypes = [ptr] * 9 + [ctypes.c_int] * 4 + [ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(x, W, b, peep, h0, c0):
    tensors = {"x": x, "W": W, "b": b, "peep": peep, "h0": h0, "c0": c0}
    if x.dim() != 3:
        raise ValueError(f"x must be [T, B, F], got shape {tuple(x.shape)}")
    T, B, F = x.shape
    H = h0.shape[-1] if h0.dim() == 2 else -1
    if (F + 6 * H) * 4 > MAX_SHARED_BYTES:
        raise ValueError(f"F={F}, H={H} needs {(F + 6 * H) * 4} bytes of "
                         f"shared memory; a block has {MAX_SHARED_BYTES}")
    want = {"W": (F + H, 4 * H), "b": (4 * H,), "peep": (3 * H,),
            "h0": (B, H), "c0": (B, H)}
    for name, shape in want.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"{name} must have shape {shape} for x "
                             f"{tuple(x.shape)} and H={H}, got "
                             f"{tuple(tensors[name].shape)}")
    if T < 1 or B < 1 or H < 1:
        raise ValueError(f"empty LSTM problem: T={T}, B={B}, H={H}")
    for name, t in tensors.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fused_lstm_sequence(x, W, b, peep, h0, c0, offs: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Whole-sequence LSTM forward, semantics of the layer's `_lstm_cell`
    without a mask. Shapes as `lstm_sequence_reference`; outputs come back
    in x's dtype. One kernel launch on a CUDA device."""
    global launches
    if not x.is_floating_point():
        raise TypeError(f"LSTM input must be floating point, got {x.dtype}")
    args = _canon(x, W, b, peep, h0, c0)
    _check(*args)
    if x.device.type == "cpu":
        hs, hT, cT = lstm_sequence_reference(*args, offs)
    elif x.device.type == "cuda":
        xf, Wf, bf, pf, h0f, c0f = args
        T, B, F = xf.shape
        H = h0f.shape[-1]
        hs = torch.empty((T, B, H), dtype=torch.float32, device=xf.device)
        hT = torch.empty((B, H), dtype=torch.float32, device=xf.device)
        cT = torch.empty((B, H), dtype=torch.float32, device=xf.device)
        fn = _kernel_fn()
        with torch.cuda.device(xf.device):
            stream = torch.cuda.current_stream(xf.device).cuda_stream
            err = fn(*(t.data_ptr() for t in (xf, Wf, bf, pf, h0f, c0f,
                                               hs, hT, cT)),
                     T, B, F, H, float(offs), stream)
        if err != 0:
            raise RuntimeError(f"LSTM kernel launch failed: CUDA error {err}")
        with _launch_lock:
            launches += 1
    else:
        raise ValueError(f"no LSTM kernel for device {x.device}")
    return hs.to(x.dtype), hT.to(x.dtype), cT.to(x.dtype)
