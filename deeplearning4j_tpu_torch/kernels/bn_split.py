"""Training-mode BatchNorm + ReLU over a batch spread across data-parallel
ranks: the split kernels of `csrc/bn_relu.cu`.

JAX's GSPMD step takes a training BatchNorm's statistics over the global
batch; its Pallas kernels (`deeplearning4j_tpu/kernels/bn_relu.py`
`_fwd_kernel` / `_bwd_kernel`) compute them in two passes, the mean, then
the mean of (x - mean)^2. A rank here holds only its rows, so the fused
resident kernel cannot give the global statistics. `split_bn_relu` splits
the layer's pass in four launches around two small collectives over the
data group:

  forward   `split_stats`: per channel (count, mean, M2) of this rank's
            rows -> all-gather of the [3, C] triples -> every rank merges
            them with Chan's formula in rank order (`chan_merge`), so the
            global mean and biased variance are the same on all ranks
            (no one-pass sum of squares: its variance cancels where JAX's
            does not) -> `split_apply`: normalise + ReLU with them;
  backward  `split_bwd_sums`: per channel sum(dyr) and sum(dyr * xhat)
            of this rank's rows -> all-gather, summed in rank order ->
            `split_bwd_dx`: dx from the global sums and the global row
            count. dgamma and dbeta come back as this rank's sums: the
            trainer's gradient all-reduce adds the ranks'.

A rank whose loss is its own rows' mean (`BatchGroup.weight` = D_r / D)
scales its sums by its weight before the gather and divides the global
sums by it after, so the ranks' gradients meet at the global loss's
scale.

Each of the four has a wrapper (the kernel on a CUDA tensor, its plain
PyTorch version `*_reference` on a CPU tensor; x in float32, bfloat16 or
float16) and a launch count (`launch_counts()`).
"""
from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Optional, Tuple

import torch

__all__ = ["split_bn_relu", "split_stats", "split_apply", "split_bwd_sums",
           "split_bwd_dx", "split_stats_reference", "split_apply_reference",
           "split_bwd_sums_reference", "split_bwd_dx_reference",
           "chan_merge", "launch_counts", "variant_counts",
           "reset_launches", "ENTRY_POINTS"]

_KINDS = ("stats", "apply", "bwd_sums", "bwd_dx")
ENTRY_POINTS = {"stats": "dl4j_bn_split_stats",
                "apply": "dl4j_bn_split_apply",
                "bwd_sums": "dl4j_bn_split_bwd_sums",
                "bwd_dx": "dl4j_bn_split_bwd_dx"}
stats_launches = 0
apply_launches = 0
bwd_sums_launches = 0
bwd_dx_launches = 0
_COUNTS = tuple(k + "_launches" for k in _KINDS)
_by_variant = {k: {"split": 0} for k in _KINDS}
_launch_lock = threading.Lock()
_fns = {}


def reset_launches() -> int:
    """Set every launch count to 0; returns the statistics kernel's."""
    with _launch_lock:
        n = stats_launches
        for name in _COUNTS:
            globals()[name] = 0
        for counts in _by_variant.values():
            counts["split"] = 0
    return n


def launch_counts() -> dict:
    with _launch_lock:
        return {name: globals()[name] for name in _COUNTS}


def variant_counts() -> dict:
    with _launch_lock:
        return {kind: dict(c) for kind, c in _by_variant.items()}


def _count(kind: str):
    from . import tallied
    if tallied("bn_split", kind + "_launches", kind, "split"):
        return
    with _launch_lock:
        globals()[kind + "_launches"] += 1
        _by_variant[kind]["split"] += 1


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def split_stats_reference(x):
    """[3, C] float32: this rank's row count, mean and M2 (the centred sum
    of squares), two passes."""
    xf = x.to(torch.float32)
    n = x.shape[0]
    mean = xf.mean(dim=0) if n else torch.zeros_like(xf[0])
    m2 = torch.square(xf - mean).sum(dim=0)
    return torch.stack([torch.full_like(mean, float(n)), mean, m2])


def chan_merge(triples):
    """(count, mean, biased var) of the union of the ranks' rows from
    their [3, C] triples (a sequence, or an [R, 3, C] tensor), merged in
    rank order with Chan's formula."""
    n, mean, m2 = triples[0][0], triples[0][1], triples[0][2]
    for t in list(triples)[1:]:
        nb, mb, m2b = t[0], t[1], t[2]
        tot = n + nb
        delta = mb - mean
        frac = torch.where(tot > 0, nb / torch.clamp(tot, min=1.0),
                           torch.zeros_like(nb))
        mean = mean + delta * frac
        m2 = m2 + m2b + delta * delta * n * frac
        n = tot
    return n, mean, m2 / torch.clamp(n, min=1.0)


def _xhat_dyr(x, gamma, beta, mean, var, dy, eps, relu):
    f32 = torch.float32
    inv = torch.rsqrt(var.to(f32) + eps)
    xhat = (x.to(f32) - mean.to(f32)) * inv
    d = dy.to(f32)
    if relu:
        d = torch.where(xhat * gamma.to(f32) + beta.to(f32) > 0.0, d, 0.0)
    return xhat, d, inv


def split_apply_reference(x, gamma, beta, mean, var, eps: float = 1e-5,
                          relu: bool = True):
    """y = relu((x - mean) * inv * gamma + beta) in x's dtype, from the
    given (global) statistics."""
    f32 = torch.float32
    inv = torch.rsqrt(var.to(f32) + eps)
    y = (x.to(f32) - mean.to(f32)) * inv * gamma.to(f32) + beta.to(f32)
    return (torch.relu(y) if relu else y).to(x.dtype)


def split_bwd_sums_reference(x, gamma, beta, mean, var, dy,
                             eps: float = 1e-5, relu: bool = True):
    """[2, C] float32: (sum(dyr), sum(dyr * xhat)) over this rank's
    rows."""
    xhat, d, _ = _xhat_dyr(x, gamma, beta, mean, var, dy, eps, relu)
    return torch.stack([d.sum(dim=0), (d * xhat).sum(dim=0)])


def split_bwd_dx_reference(x, gamma, beta, mean, var, dy, sums, n: float,
                           eps: float = 1e-5, relu: bool = True):
    """dx in x's dtype from the global sums [2, C] and row count n."""
    xhat, d, inv = _xhat_dyr(x, gamma, beta, mean, var, dy, eps, relu)
    k = gamma.to(torch.float32) * inv / n
    return (k * (n * d - sums[0] - xhat * sums[1])).to(x.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {   # entry point -> argtypes before (dtype, wide, stream)
    "stats": [_PTR] * 2 + [_INT] * 2,
    "apply": [_PTR] * 6 + [_INT] * 2 + [_FLOAT],
    "bwd_sums": [_PTR] * 7 + [_INT] * 2 + [_FLOAT],
    "bwd_dx": [_PTR] * 8 + [_INT] * 2 + [_FLOAT] * 2,
}


def _kernel_fn(kind: str):
    fn = _fns.get(kind)
    if fn is None:
        from . import library
        fn = getattr(library(), ENTRY_POINTS[kind])
        fn.argtypes = _SIGNATURES[kind] + [_INT, _INT, _PTR]
        fn.restype = ctypes.c_int
        _fns[kind] = fn
    return fn


def _launch(kind: str, x, args, tensors):
    from .bn_relu import KERNEL_DTYPES, _raw_stream
    size = x.element_size()
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
    wide = int(aligned and x.shape[1] % (16 // size) == 0)
    index = x.device.index
    with (contextlib.nullcontext() if index == torch.cuda.current_device()
          else torch.cuda.device(index)):
        err = _kernel_fn(kind)(*args, KERNEL_DTYPES[x.dtype], wide,
                               _raw_stream(index))
    if err != 0:
        raise RuntimeError(f"BN split kernel {ENTRY_POINTS[kind]} launch "
                           f"failed: CUDA error {err}")
    _count(kind)


def _check(x, *vectors):
    from .bn_relu import KERNEL_DTYPES
    if x.dim() != 2 or x.shape[1] < 1:
        raise ValueError(f"x must be [N, C], got {tuple(x.shape)}")
    C = x.shape[1]
    for t in vectors:
        if t.device != x.device or t.shape[-1] != C:
            raise ValueError(f"a [.., {C}] tensor on {x.device} was "
                             f"expected, got {tuple(t.shape)} on {t.device}")
    if x.is_cuda and x.dtype not in KERNEL_DTYPES:
        raise ValueError(f"the BN split kernels take float32, bfloat16 or "
                         f"float16 on a CUDA device, got {x.dtype}")


def _f32(t):
    if t.dtype == torch.float32 and t.is_contiguous():
        return t
    return t.to(torch.float32).contiguous()


def split_stats(x) -> torch.Tensor:
    """[3, C] (count, mean, M2) of x's rows: one launch on a CUDA device,
    the plain version on the CPU."""
    _check(x)
    if not x.is_cuda:
        return split_stats_reference(x)
    x = x.contiguous()
    N, C = x.shape
    out = torch.empty((3, C), dtype=torch.float32, device=x.device)
    _launch("stats", x, (x.data_ptr(), out.data_ptr(), N, C), (x,))
    return out


def split_apply(x, gamma, beta, mean, var, eps: float = 1e-5):
    """relu((x - mean) * inv * gamma + beta) from given statistics."""
    _check(x, gamma, beta, mean, var)
    if not x.is_cuda:
        return split_apply_reference(x, gamma, beta, mean, var, eps)
    x = x.contiguous()
    g, b, m, v = _f32(gamma), _f32(beta), _f32(mean), _f32(var)
    y = torch.empty_like(x)
    N, C = x.shape
    _launch("apply", x, (x.data_ptr(), g.data_ptr(), b.data_ptr(),
                         m.data_ptr(), v.data_ptr(), y.data_ptr(), N, C,
                         float(eps)), (x, y))
    return y


def split_bwd_sums(x, gamma, beta, mean, var, dy, eps: float = 1e-5):
    """[2, C] (sum(dyr), sum(dyr * xhat)) over x's rows."""
    _check(x, gamma, beta, mean, var, dy)
    if not x.is_cuda:
        return split_bwd_sums_reference(x, gamma, beta, mean, var, dy, eps)
    x = x.contiguous()
    dy = dy.to(x.dtype).contiguous()
    g, b, m, v = _f32(gamma), _f32(beta), _f32(mean), _f32(var)
    N, C = x.shape
    out = torch.empty((2, C), dtype=torch.float32, device=x.device)
    _launch("bwd_sums", x, (x.data_ptr(), g.data_ptr(), b.data_ptr(),
                            m.data_ptr(), v.data_ptr(), dy.data_ptr(),
                            out.data_ptr(), N, C, float(eps)), (x, dy))
    return out


def split_bwd_dx(x, gamma, beta, mean, var, dy, sums, n: float,
                 eps: float = 1e-5):
    """dx from the global sums [2, C] and the global row count n."""
    _check(x, gamma, beta, mean, var, dy, sums)
    if not x.is_cuda:
        return split_bwd_dx_reference(x, gamma, beta, mean, var, dy, sums,
                                      n, eps)
    x = x.contiguous()
    dy = dy.to(x.dtype).contiguous()
    g, b, m, v, s = (_f32(gamma), _f32(beta), _f32(mean), _f32(var),
                     _f32(sums))
    dx = torch.empty_like(x)
    N, C = x.shape
    _launch("bwd_dx", x, (x.data_ptr(), g.data_ptr(), b.data_ptr(),
                          m.data_ptr(), v.data_ptr(), dy.data_ptr(),
                          s.data_ptr(), dx.data_ptr(), N, C, float(n),
                          float(eps)), (x, dy, dx))
    return dx


# ---------------------------------------------------------------------------
# the layer's function
# ---------------------------------------------------------------------------
def _gather_sum(t, bg, scale=None):
    """The ranks' `t` summed in rank order (every rank the same bits);
    with `scale` each rank's t is multiplied by its own before the gather
    and the sum divided by this rank's after."""
    from ..parallel.collectives import all_gather_list
    if scale is not None:
        t = t * scale
    parts = all_gather_list(t, bg.group)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total if scale is None else total / scale


class _SplitBn(torch.autograd.Function):
    """Global-batch BN (+ ReLU) of this rank's rows x [N, C]: the split
    kernels on a CUDA tensor when `kernel`, their plain versions
    otherwise. Returns (y, global mean, global var), the statistics
    without a gradient."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, relu, kernel, bg):
        from ..parallel.collectives import all_gather_list
        k = kernel and x.is_cuda
        part = (split_stats(x) if k else split_stats_reference(x))
        n, mean, var = chan_merge(all_gather_list(part, bg.group))
        if k:
            y = split_apply(x, gamma, beta, mean, var, eps)
        else:
            y = split_apply_reference(x, gamma, beta, mean, var, eps, relu)
        ctx.save_for_backward(x, gamma, beta, mean, var, n)
        ctx.eps, ctx.relu, ctx.kernel, ctx.bg = eps, relu, k, bg
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, gamma, beta, mean, var, n = ctx.saved_tensors
        bg, eps = ctx.bg, ctx.eps
        if ctx.kernel:
            sums = split_bwd_sums(x, gamma, beta, mean, var, dy, eps)
        else:
            sums = split_bwd_sums_reference(x, gamma, beta, mean, var, dy,
                                            eps, ctx.relu)
        glob = _gather_sum(sums, bg, bg.weight)
        n_glob = float(n[0]) if n.numel() else 0.0
        if ctx.kernel:
            dx = split_bwd_dx(x, gamma, beta, mean, var, dy, glob, n_glob,
                              eps)
        else:
            dx = split_bwd_dx_reference(x, gamma, beta, mean, var, dy, glob,
                                        n_glob, eps, ctx.relu)
        return (dx, sums[1].to(gamma.dtype), sums[0].to(beta.dtype), None,
                None, None, None)


def split_bn_relu(x, gamma, beta, eps: float, bg, relu: bool = True,
                  kernel: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training BN (+ ReLU) of this rank's rows with the statistics of the
    global batch of `bg` (a `parallel.collectives.BatchGroup`). x is
    [N, C] or channels-last [..., C]; returns (y shaped like x, global
    mean, global biased var). `kernel`: the split kernels on a CUDA
    tensor (they apply the ReLU), else their plain versions."""
    if kernel and not relu:
        raise ValueError("the split BN kernels apply a ReLU; pass "
                         "kernel=False for BN without one")
    shape = x.shape
    flat = x if x.dim() == 2 else x.reshape(-1, shape[-1])
    y, mean, var = _SplitBn.apply(flat, gamma, beta, float(eps), bool(relu),
                                  bool(kernel), bg)
    return (y if x.dim() == 2 else y.reshape(shape)), mean, var
