"""Training-mode BatchNorm + ReLU: forward and backward as CUDA kernel
launches.

Counterpart of `deeplearning4j_tpu/kernels/bn_relu.py:fused_bn_relu`, its
custom VJP included. The kernels are in `csrc/bn_relu.cu`; its header says
what bounds each and how its design answers that.

  * `fused_bn_relu(x, gamma, beta, eps)` — x [N, C] or channels-last
    [..., C]; returns (y, batch mean, batch biased var), y in x's dtype, the
    stats float32 and non-differentiable (the caller updates its running
    averages from them). Differentiable in x, gamma and beta through the
    autograd Function `_BnRelu`: the forward kernel, then in backward the
    backward kernel (the ReLU mask fused with the three BN reductions).
  * `bn_relu_forward`, `bn_relu_backward` — the two halves as wrappers (one
    launch each on a CUDA device).
  * `bn_relu_reference`, `bn_relu_backward_reference` — the plain PyTorch
    versions (`bn_relu_reference` and `_bwd_kernel`'s math), for the CPU and
    for holding the kernels to account; `bn_relu_inference` — the running-
    stats expression (no kernel, as in JAX).
  * Launch counts: `fwd_launches`, `bwd_launches`.

A wrapper given CPU tensors runs the plain version, in any float dtype;
given CUDA tensors it launches the kernel (x in float32, bfloat16 or
float16) or raises. Statistics and products are float32, as the TPU kernel
computes them.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

__all__ = ["fused_bn_relu", "bn_relu_forward", "bn_relu_backward",
           "bn_relu_reference", "bn_relu_backward_reference",
           "bn_relu_inference", "fwd_launches", "bwd_launches",
           "reset_launches", "launch_counts", "KERNEL_DTYPES"]

# dtype -> the kernels' dtype code
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

fwd_launches = 0     # forward: stats, normalise, ReLU
bwd_launches = 0     # backward: mask, dgamma / dbeta, dx
_COUNTS = ("fwd_launches", "bwd_launches")
_launch_lock = threading.Lock()
_fns = {}


def reset_launches() -> int:
    """Set both launch counts to 0; returns the forward's count."""
    with _launch_lock:
        n = fwd_launches
        for name in _COUNTS:
            globals()[name] = 0
    return n


def launch_counts() -> dict:
    """{count name: launches} for the two kernels."""
    with _launch_lock:
        return {name: globals()[name] for name in _COUNTS}


def _count(name: str):
    with _launch_lock:
        globals()[name] += 1


def _block_c(C: int, N: int) -> Optional[int]:
    """The TPU kernel's channel tile, or None when one tile's whole batch
    would exceed its ~2 MB VMEM budget. It has no meaning on the card (the
    CUDA kernel loops over N); it is kept so that `BatchNormalization._helper`
    selects this kernel for exactly the batches JAX sends to its kernel."""
    bc = 128 if C >= 128 else C
    if N * bc * 4 > 2 * 1024 * 1024:
        return None
    return bc


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def bn_relu_reference(x, gamma, beta, eps: float = 1e-5):
    """Plain version: batch-stat BN + ReLU over [N, C] in float32. Returns
    (y in x's dtype, mean, biased var)."""
    f32 = torch.float32
    xf = x.to(f32)
    mean = xf.mean(dim=0)
    var = torch.square(xf - mean).mean(dim=0)
    inv = torch.rsqrt(var + eps)
    y = torch.relu((xf - mean) * inv * gamma.to(f32) + beta.to(f32))
    return y.to(x.dtype), mean, var


def bn_relu_backward_reference(x, gamma, beta, mean, var, dy,
                               eps: float = 1e-5):
    """Plain version of `_bwd_kernel`: the ReLU mask recomputed from the
    saved stats, dg = sum(dyr * xhat), db = sum(dyr), dx = gamma * inv / n *
    (n * dyr - db - xhat * dg). Returns (dx in x's dtype, dg, db float32)."""
    f32 = torch.float32
    g, b = gamma.to(f32), beta.to(f32)
    n = float(x.shape[0])
    inv = torch.rsqrt(var.to(f32) + eps)
    xhat = (x.to(f32) - mean.to(f32)) * inv
    dyr = torch.where(xhat * g + b > 0.0, dy.to(f32), 0.0)
    dg = (dyr * xhat).sum(dim=0)
    db = dyr.sum(dim=0)
    dx = (g * inv / n) * (n * dyr - db - xhat * dg)
    return dx.to(x.dtype), dg, db


def bn_relu_inference(x, gamma, beta, mean, var, eps: float = 1e-5):
    """Inference-mode BN + ReLU from running stats: one elementwise
    expression in float32, left to PyTorch (the kernels are for the
    batch-stat reductions), y in x's dtype."""
    f32 = torch.float32
    inv = torch.rsqrt(var.to(f32) + eps)
    y = (x.to(f32) - mean.to(f32)) * inv * gamma.to(f32) + beta.to(f32)
    return torch.relu(y).to(x.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {   # entry point -> pointers before (N, C, eps, dtype, wide)
    "dl4j_bn_relu_fwd": 6,
    "dl4j_bn_relu_bwd": 9,
}


def _kernel_fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        from . import library
        fn = getattr(library(), name)
        fn.argtypes = ([_PTR] * _SIGNATURES[name]
                       + [_INT, _INT, ctypes.c_float, _INT, _INT, _PTR])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _launch(name: str, counter: str, x, *args, eps: float):
    """Launch `name` on the current stream of x's device. The 16-byte pack
    (4 f32 or 8 bf16 / f16 channels a load) is used where C and every [N, C]
    tensor allow it."""
    N, C = x.shape
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    wide = (C % (16 // x.element_size()) == 0
            and all(t.data_ptr() % 16 == 0 for t in tensors + [x]
                    if t.dim() == 2))
    fn = _kernel_fn(name)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), *(a.data_ptr() for a in args), N, C,
                 float(eps), KERNEL_DTYPES[x.dtype], int(wide), stream)
    if err != 0:
        raise RuntimeError(f"BN+ReLU kernel {name} launch failed: CUDA error "
                           f"{err}")
    _count(counter)


def _check(x, **vectors):
    """x must be a non-empty [N, C] float tensor, each vector [C] on x's
    device; on a CUDA device x must be float32, bfloat16 or float16."""
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"x must be a non-empty [N, C], got "
                         f"{tuple(x.shape)}")
    if not x.is_floating_point():
        raise TypeError(f"BN+ReLU input must be floating point, got "
                        f"{x.dtype}")
    C = x.shape[1]
    for name, t in vectors.items():
        if tuple(t.shape) != (C,):
            raise ValueError(f"{name} must have shape ({C},), got "
                             f"{tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.device.type == "cuda" and x.dtype not in KERNEL_DTYPES:
        raise ValueError(
            f"the BN+ReLU kernels take float32, bfloat16 or float16 on a "
            f"CUDA device, got {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no BN+ReLU kernel for device {x.device}")


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def bn_relu_forward(x, gamma, beta, eps: float = 1e-5
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward over [N, C]: (y in x's dtype, mean, var). One kernel
    launch on a CUDA device; the plain version on the CPU."""
    _check(x, gamma=gamma, beta=beta)
    if x.device.type == "cpu":
        return bn_relu_reference(x, gamma, beta, eps)
    x, gamma, beta = x.contiguous(), _f32(gamma), _f32(beta)
    N, C = x.shape
    y = torch.empty_like(x)
    mean, var = (torch.empty(C, dtype=torch.float32, device=x.device)
                 for _ in range(2))
    _launch("dl4j_bn_relu_fwd", "fwd_launches", x, gamma, beta, y, mean, var,
            eps=eps)
    return y, mean, var


def bn_relu_backward(x, gamma, beta, mean, var, dy, eps: float = 1e-5
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward from the saved stats: (dx in x's dtype, dg, db float32).
    One kernel launch on a CUDA device; the plain version on the CPU."""
    _check(x, gamma=gamma, beta=beta, mean=mean, var=var)
    if tuple(dy.shape) != tuple(x.shape) or dy.device != x.device:
        raise ValueError(f"dy must match x {tuple(x.shape)} on {x.device}, "
                         f"got {tuple(dy.shape)} on {dy.device}")
    if x.device.type == "cpu":
        return bn_relu_backward_reference(x, gamma, beta, mean, var, dy, eps)
    x, dy = x.contiguous(), dy.to(x.dtype).contiguous()
    C = x.shape[1]
    dx = torch.empty_like(x)
    dg, db = (torch.empty(C, dtype=torch.float32, device=x.device)
              for _ in range(2))
    _launch("dl4j_bn_relu_bwd", "bwd_launches", x, _f32(gamma), _f32(beta),
            _f32(mean), _f32(var), dy, dx, dg, db, eps=eps)
    return dx, dg, db


class _BnRelu(torch.autograd.Function):
    """`bn_relu_forward` with its custom VJP (`_bn_relu_fwd` /
    `_bn_relu_bwd`): the forward saves (x, gamma, beta, mean, var); the stats
    are outputs without a gradient (running-average semantics); backward is
    `bn_relu_backward`, dgamma and dbeta cast to their parameters' dtypes."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        y, mean, var = bn_relu_forward(x, gamma, beta, eps)
        ctx.save_for_backward(x, gamma, beta, mean, var)
        ctx.eps = eps
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, gamma, beta, mean, var = ctx.saved_tensors
        dx, dg, db = bn_relu_backward(x, gamma, beta, mean, var, dy, ctx.eps)
        return dx, dg.to(gamma.dtype), db.to(beta.dtype), None


def fused_bn_relu(x, gamma, beta, eps: float = 1e-5):
    """Fused training-mode BatchNorm + ReLU. x: [N, C] or channels-last
    [N, H, W, C] (statistics over every axis but the last). Returns (y,
    batch_mean, batch_var), y shaped like x; the caller updates its running
    statistics from the batch stats, as the JAX layer does."""
    shape = x.shape
    if x.dim() < 2:
        raise ValueError(f"x must be [N, C] or [..., C], got {tuple(shape)}")
    y, mean, var = _BnRelu.apply(x.reshape(-1, shape[-1]), gamma, beta,
                                 float(eps))
    return y.reshape(shape), mean, var
