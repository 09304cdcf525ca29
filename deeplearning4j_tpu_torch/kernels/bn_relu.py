"""Training-mode BatchNorm + ReLU: forward and backward as CUDA kernel
launches.

Counterpart of `deeplearning4j_tpu/kernels/bn_relu.py:fused_bn_relu`, its
custom VJP included. The kernels are in `csrc/bn_relu.cu`; its header says
what bounds each and how its design answers that. Each half runs one of
two variants, picked from the shape alone by `bn_plan`: "resident" (the
[rows, 32-byte] slab of a CTA in shared memory, N split across a
thread-block cluster) wherever a slab fits a cluster of 8, "streamed" (one
block per 32 channels looping over N) past that.

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
  * `bn_plan`, `resident_bytes` — the launch plan of a shape and the
    shared memory it takes.
  * Launch counts: `fwd_launches`, `bwd_launches` (`launch_counts()`), and
    by variant (`variant_counts()`).

A wrapper given CPU tensors runs the plain version, in any float dtype;
given CUDA tensors it launches the kernel (x in float32, bfloat16 or
float16) or raises. Statistics and products are float32, as the TPU kernel
computes them.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
from typing import NamedTuple, Optional, Tuple

import torch

from .lstm import MAX_SHARED_BYTES

__all__ = ["fused_bn_relu", "bn_relu_forward", "bn_relu_backward",
           "bn_relu_reference", "bn_relu_backward_reference",
           "bn_relu_inference", "fwd_launches", "bwd_launches",
           "reset_launches", "launch_counts", "variant_counts", "bn_plan",
           "BnPlan", "resident_bytes", "KERNEL_DTYPES"]

# dtype -> the kernels' dtype code
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# The resident variant (csrc/bn_relu.cu's constants): a CTA owns one
# 32-byte row segment of channels and reserves slab rows in multiples of
# 128; a cluster has at most 8 CTAs (the portable maximum). Its scratch is
# red [2][8][16], part [2][16] and tot [2][16] floats.
SEGMENT_BYTES = 32
ROW_QUANTUM = 128
MAX_CLUSTER = 8
_SCRATCH_BYTES = (2 * 8 * 16 + 4 * 16) * 4
# SMs of an H100 SXM: the plan sizes its grid to about one wave of these
CARD_SMS = 132
# N is split across a cluster only while each CTA keeps at least this many
# rows (4 packs a thread): below it a cluster barrier costs more than the
# rows it spreads
MIN_SPLIT_ROWS = 512
# The streamed variant: 32 channels a block, static shared memory only
# (red [8][32] + tot [32] floats forward, twice that backward)
STREAMED_CHANNELS = 32
STREAMED_BYTES = {False: (8 * 32 + 32) * 4, True: 2 * (8 * 32 + 32) * 4}
_VARIANTS = ("resident", "streamed")
_ENTRY_POINTS = {("fwd", "resident"): "dl4j_bn_relu_fwd_resident",
                 ("fwd", "streamed"): "dl4j_bn_relu_fwd",
                 ("bwd", "resident"): "dl4j_bn_relu_bwd_resident",
                 ("bwd", "streamed"): "dl4j_bn_relu_bwd"}

fwd_launches = 0     # forward: stats, normalise, ReLU
bwd_launches = 0     # backward: mask, dgamma / dbeta, dx
_COUNTS = ("fwd_launches", "bwd_launches")
_by_variant = {kind: dict.fromkeys(_VARIANTS, 0) for kind in ("fwd", "bwd")}
_launch_lock = threading.Lock()
_fns = {}


def reset_launches() -> int:
    """Set every launch count to 0; returns the forward's count."""
    with _launch_lock:
        n = fwd_launches
        for name in _COUNTS:
            globals()[name] = 0
        for counts in _by_variant.values():
            counts.update(dict.fromkeys(counts, 0))
    return n


def launch_counts() -> dict:
    """{count name: launches} for the two kernels."""
    with _launch_lock:
        return {name: globals()[name] for name in _COUNTS}


def variant_counts() -> dict:
    """{"fwd" | "bwd": {variant: launches}}; each kind's variants add up to
    its total in `launch_counts()`."""
    with _launch_lock:
        return {kind: dict(counts) for kind, counts in _by_variant.items()}


def _count(kind: str, variant: str):
    from . import tallied
    if tallied("bn_relu", kind + "_launches", kind, variant):
        return
    with _launch_lock:
        globals()[kind + "_launches"] += 1
        _by_variant[kind][variant] += 1


class BnPlan(NamedTuple):
    """How the forward (or the backward) kernel runs an [N, C] problem."""
    variant: str      # "resident" or "streamed"
    channels: int     # channels a CTA owns (the last CTA's may be fewer)
    cluster: int      # CTAs of a cluster, splitting N (1: no cluster)
    rows: int         # rows a CTA holds (the last rank's may be fewer)
    ctas: int         # CTAs in the grid
    smem_bytes: int   # shared memory of a CTA


def resident_bytes(rows: int, backward: bool) -> int:
    """Dynamic shared memory of one resident CTA holding `rows` rows, in
    bytes; `resident_bytes` in csrc/bn_relu.cu computes the same: the
    scratch, then one slab (x) or two (x, dy) of the rows rounded up to
    ROW_QUANTUM, SEGMENT_BYTES a row."""
    slab = -(-rows // ROW_QUANTUM) * ROW_QUANTUM * SEGMENT_BYTES
    return _SCRATCH_BYTES + (2 if backward else 1) * slab


@functools.lru_cache(maxsize=1024)
def bn_plan(N: int, C: int, itemsize: int, backward: bool) -> BnPlan:
    """The variant and launch plan of the forward (backward = False) or
    the backward kernel for an [N, C] batch of `itemsize`-byte values; a
    function of the shape alone.

    "resident": a CTA owns SEGMENT_BYTES of channels (16 bf16 / f16 or 8
    f32: one sector a row), so ceil(C / channels) channel groups; a
    cluster of `cluster` CTAs (a power of two up to MAX_CLUSTER) splits N
    into `rows`-row slabs. The cluster doubles while the grid stays within
    about one wave of CARD_SMS and each CTA keeps MIN_SPLIT_ROWS rows (so
    N = 128 runs without a cluster), then further until a slab fits
    MAX_SHARED_BYTES. "streamed": where no slab fits a cluster of 8 (N
    above 57,344 forward, 28,672 backward)."""
    if itemsize not in (2, 4):
        raise ValueError(f"no BN+ReLU kernel for {itemsize}-byte values")
    channels = SEGMENT_BYTES // itemsize
    groups = -(-C // channels)
    n = 1
    while (n < MAX_CLUSTER and groups * 2 * n <= CARD_SMS
           and -(-N // (2 * n)) >= MIN_SPLIT_ROWS):
        n *= 2
    while n <= MAX_CLUSTER:
        rows = -(-N // n)
        nbytes = resident_bytes(rows, backward)
        if nbytes <= MAX_SHARED_BYTES:
            return BnPlan("resident", channels, n, rows, groups * n, nbytes)
        n *= 2
    return BnPlan("streamed", STREAMED_CHANNELS, 1, N,
                  -(-C // STREAMED_CHANNELS), STREAMED_BYTES[backward])


def _block_c(C: int, N: int) -> Optional[int]:
    """The TPU kernel's channel tile, or None when one tile's whole batch
    would exceed its ~2 MB VMEM budget. It has no meaning on the card (the
    CUDA kernels take any N: `bn_plan` picks how); it is kept so that
    `BatchNormalization._helper` selects these kernels for exactly the
    batches JAX sends to its kernel."""
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
_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {   # entry point -> (pointers, ints before eps)
    "dl4j_bn_relu_fwd": (6, 2),             # N, C
    "dl4j_bn_relu_bwd": (9, 2),
    "dl4j_bn_relu_fwd_resident": (6, 4),    # N, C, rows, cluster
    "dl4j_bn_relu_bwd_resident": (9, 4),
}


def _kernel_fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        from . import library
        fn = getattr(library(), name)
        pointers, ints = _SIGNATURES[name]
        fn.argtypes = ([_PTR] * pointers + [_INT] * ints
                       + [_FLOAT, _INT, _INT, _PTR])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _raw_stream(index: int) -> int:
    """The current CUDA stream of device `index`, as an address."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(index)
    return torch.cuda.current_stream(index).cuda_stream


def _launch(kind: str, x, pointers, aligned: bool, eps: float):
    """Launch the `kind` ("fwd" or "bwd") kernel of the variant `bn_plan`
    picks for x [N, C], on the current stream of x's device. `pointers`
    are the entry point's addresses; `aligned` says every [N, C] one is
    16-byte aligned, so the 16-byte pack (4 f32 or 8 bf16 / f16 channels)
    is taken where C is a multiple of it."""
    N, C = x.shape
    size = x.element_size()
    plan = bn_plan(N, C, size, kind == "bwd")
    wide = int(aligned and C % (16 // size) == 0)
    fn = _kernel_fn(_ENTRY_POINTS[kind, plan.variant])
    dims = ((N, C, plan.rows, plan.cluster) if plan.variant == "resident"
            else (N, C))
    index = x.device.index
    with (contextlib.nullcontext() if index == torch.cuda.current_device()
          else torch.cuda.device(index)):
        err = fn(*pointers, *dims, eps, KERNEL_DTYPES[x.dtype], wide,
                 _raw_stream(index))
    if err != 0:
        raise RuntimeError(f"BN+ReLU kernel "
                           f"{_ENTRY_POINTS[kind, plan.variant]} launch "
                           f"failed: CUDA error {err}")
    _count(kind, plan.variant)


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
    if t.dtype == torch.float32 and t.is_contiguous():
        return t
    return t.to(torch.float32).contiguous()


def _forward_kernel(x, gamma, beta, eps: float):
    """The forward launch on checked CUDA tensors. The temporaries stay
    referenced until the launch is queued."""
    if not x.is_contiguous():
        x = x.contiguous()
    g, b = _f32(gamma), _f32(beta)
    # two [C] tensors like g: on the host, cheaper than one [2, C] tensor
    # and its two row views
    y, mean, var = (torch.empty_like(x), torch.empty_like(g),
                    torch.empty_like(g))
    xp, yp = x.data_ptr(), y.data_ptr()
    _launch("fwd", x, (xp, g.data_ptr(), b.data_ptr(), yp, mean.data_ptr(),
                       var.data_ptr()), (xp | yp) % 16 == 0, eps)
    return y, mean, var


def _backward_kernel(x, gamma, beta, mean, var, dy, eps: float):
    """The backward launch on checked CUDA tensors."""
    if not x.is_contiguous():
        x = x.contiguous()
    if dy.dtype != x.dtype or not dy.is_contiguous():
        dy = dy.to(x.dtype).contiguous()
    g, b, m, v = _f32(gamma), _f32(beta), _f32(mean), _f32(var)
    dx, dg, db = torch.empty_like(x), torch.empty_like(g), torch.empty_like(g)
    xp, dyp, dxp = x.data_ptr(), dy.data_ptr(), dx.data_ptr()
    _launch("bwd", x, (xp, g.data_ptr(), b.data_ptr(), m.data_ptr(),
                       v.data_ptr(), dyp, dxp, dg.data_ptr(), db.data_ptr()),
            (xp | dyp | dxp) % 16 == 0, eps)
    return dx, dg, db


def bn_relu_forward(x, gamma, beta, eps: float = 1e-5
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward over [N, C]: (y in x's dtype, mean, var). One kernel
    launch on a CUDA device; the plain version on the CPU."""
    _check(x, gamma=gamma, beta=beta)
    if x.device.type == "cpu":
        return bn_relu_reference(x, gamma, beta, eps)
    return _forward_kernel(x, gamma, beta, float(eps))


def bn_relu_backward(x, gamma, beta, mean, var, dy, eps: float = 1e-5
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward from the saved stats: (dx in x's dtype, dg, db float32).
    One kernel launch on a CUDA device; the plain version on the CPU."""
    _check(x, gamma=gamma, beta=beta, mean=mean, var=var)
    if dy.shape != x.shape or dy.device != x.device:
        raise ValueError(f"dy must match x {tuple(x.shape)} on {x.device}, "
                         f"got {tuple(dy.shape)} on {dy.device}")
    if x.device.type == "cpu":
        return bn_relu_backward_reference(x, gamma, beta, mean, var, dy, eps)
    return _backward_kernel(x, gamma, beta, mean, var, dy, float(eps))


class _BnRelu(torch.autograd.Function):
    """The forward with its custom VJP (`_bn_relu_fwd` / `_bn_relu_bwd`):
    the forward saves (x, gamma, beta, mean, var); the stats are outputs
    without a gradient (running-average semantics); backward is the
    backward kernel (the plain version on the CPU), dgamma and dbeta cast
    to their parameters' dtypes. `fused_bn_relu` checks the inputs once,
    so neither half checks them again."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        if x.is_cuda:
            y, mean, var = _forward_kernel(x, gamma, beta, eps)
        else:
            y, mean, var = bn_relu_reference(x, gamma, beta, eps)
        ctx.save_for_backward(x, gamma, beta, mean, var)
        ctx.eps = eps
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, gamma, beta, mean, var = ctx.saved_tensors
        if x.is_cuda:
            dx, dg, db = _backward_kernel(x, gamma, beta, mean, var, dy,
                                          ctx.eps)
        else:
            dx, dg, db = bn_relu_backward_reference(x, gamma, beta, mean,
                                                    var, dy, ctx.eps)
        return dx, dg.to(gamma.dtype), db.to(beta.dtype), None


def fused_bn_relu(x, gamma, beta, eps: float = 1e-5):
    """Fused training-mode BatchNorm + ReLU. x: [N, C] or channels-last
    [N, H, W, C] (statistics over every axis but the last). Returns (y,
    batch_mean, batch_var), y shaped like x; the caller updates its running
    statistics from the batch stats, as the JAX layer does. A batch spread
    over data ranks takes `kernels/bn_split.py`'s `split_bn_relu`."""
    shape = x.shape
    if x.dim() < 2:
        raise ValueError(f"x must be [N, C] or [..., C], got {tuple(shape)}")
    flat = x if x.dim() == 2 else x.reshape(-1, shape[-1])
    _check(flat, gamma=gamma, beta=beta)
    y, mean, var = _BnRelu.apply(flat, gamma, beta, float(eps))
    return (y if x.dim() == 2 else y.reshape(shape)), mean, var
