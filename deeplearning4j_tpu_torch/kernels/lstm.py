"""Whole-sequence Graves-LSTM: forward and backward as CUDA kernel launches.

Counterpart of `deeplearning4j_tpu/kernels/lstm.py:fused_lstm_sequence`,
its custom VJP included. The kernels are in `csrc/lstm.cu` and
`csrc/lstm_cluster.cu`; their headers say what bounds each and how its
design answers that.

  * `fused_lstm_sequence` — the primal (inference) forward: hs, h_T, c_T.
  * `lstm_sequence` — the same forward as a `torch.autograd.Function`: it
    runs the residual-saving forward and, in backward, the adjoint and the
    parameter-gradient reduction. The layer calls it whenever autograd
    records (`GravesLSTM.apply`).
  * `lstm_residual_forward`, `lstm_sequence_backward` — the two halves of
    that Function as wrappers (what the custom VJP's `_vjp_fwd` and
    `_vjp_bwd` compute); the backward is `lstm_adjoint` then
    `lstm_param_grads`, one kernel each.
  * `lstm_sequence_reference`, `lstm_adjoint_reference`,
    `lstm_param_grads_reference`, `lstm_sequence_backward_reference` — the
    plain PyTorch versions: step loops of the same equations, for the CPU
    and for holding the kernels to account.
  * Launch counts, one per kernel: `launches` (primal forward),
    `residual_launches`, `adjoint_launches`, `reduction_launches`
    (`launch_counts()`), and the sequence kernels' launches by variant
    (`variant_counts()`).
  * `sequence_plan`, `sequence_variant` — which variant of the forward and
    adjoint kernels a shape takes, and how it is launched: "cluster"
    (`csrc/lstm_cluster.cu`: clusters of CLUSTER_SIZE CTAs, each holding a
    slice of W in shared memory for the whole sequence) wherever a CTA's
    slice and step buffers fit MAX_SHARED_BYTES, "streamed" (`csrc/lstm.cu`:
    one block per batch row, W read from L2 every step) otherwise.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises. Everything is computed in float32 (the TPU
kernel's `_canon`); outputs come back in the input's dtype.
"""
from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional, Tuple

import torch

__all__ = ["fused_lstm_sequence", "lstm_sequence", "lstm_residual_forward",
           "lstm_sequence_backward", "lstm_adjoint", "lstm_param_grads",
           "lstm_sequence_reference",
           "lstm_adjoint_reference", "lstm_param_grads_reference",
           "lstm_sequence_backward_reference", "launches",
           "residual_launches", "adjoint_launches", "reduction_launches",
           "reset_launches", "launch_counts", "variant_counts",
           "lstm_x_chunk", "SequencePlan", "sequence_plan",
           "sequence_variant", "cluster_bytes", "MAX_SHARED_BYTES",
           "CLUSTER_SIZE", "CLUSTER_THREADS", "CLUSTER_GROUPS", "GROUP_ROWS"]

# dynamic shared memory a block may use on Hopper (232,448 bytes)
MAX_SHARED_BYTES = 227 * 1024
CLUSTER_SIZE = 8         # CTAs of a cluster: the portable maximum
CLUSTER_THREADS = 256    # threads of a cluster CTA
# clusters of 8 CTAs (one an SM) an H100 runs side by side: 15 of them on
# its 132 SMs (cudaOccupancyMaxActiveClusters on an H100 80GB HBM3 at the
# char-RNN's plans, printed by chip_smoke.py), not 132 / 8
CLUSTER_GROUPS = 15
GROUP_ROWS = tuple(range(1, 9))   # batch rows a cluster may take
_VARIANTS = ("cluster", "streamed")
_KINDS = {"launches": "fwd", "residual_launches": "residual",
          "adjoint_launches": "adjoint"}

launches = 0              # primal forward
residual_launches = 0     # residual-saving forward
adjoint_launches = 0      # reverse-time adjoint
reduction_launches = 0    # dW / db / dpeep reduction
_COUNTS = ("launches", "residual_launches", "adjoint_launches",
           "reduction_launches")
_by_variant = {kind: dict.fromkeys(_VARIANTS, 0) for kind in _KINDS.values()}
_launch_lock = threading.Lock()
_fns = {}


def reset_launches() -> int:
    """Set every launch count to 0; returns the primal forward's count."""
    with _launch_lock:
        n = launches
        for name in _COUNTS:
            globals()[name] = 0
        for counts in _by_variant.values():
            counts.update(dict.fromkeys(counts, 0))
    return n


def launch_counts() -> dict:
    """{count name: launches} for the four kernels."""
    with _launch_lock:
        return {name: globals()[name] for name in _COUNTS}


def variant_counts() -> dict:
    """{"fwd" | "residual" | "adjoint": {variant: launches}}; each kind's
    variants add up to its total in `launch_counts()`."""
    with _launch_lock:
        return {kind: dict(counts) for kind, counts in _by_variant.items()}


def _count(name: str, variant: Optional[str] = None):
    from . import tallied
    if tallied("lstm", name, _KINDS.get(name), variant):
        return
    with _launch_lock:
        globals()[name] += 1
        if variant is not None:
            _by_variant[_KINDS[name]][variant] += 1


class SequencePlan(NamedTuple):
    """How the forward and adjoint kernels run a (B, F, H) problem."""
    variant: str     # "cluster" or "streamed"
    units: int       # hidden units a cluster CTA owns (the last may own fewer)
    x_rows: int      # input rows of W a cluster CTA holds in the adjoint
    group: int       # batch rows a cluster (or a streamed block) takes
    groups: int      # clusters (cluster) or blocks (streamed)
    fwd_bytes: int   # shared memory of a forward cluster CTA (0: streamed)
    bwd_bytes: int   # shared memory of an adjoint cluster CTA (0: streamed)


def _up4(n: int) -> int:
    return (n + 3) // 4 * 4


def cluster_bytes(F: int, H: int, units: int, x_rows: int, group: int,
                  adjoint: bool) -> int:
    """Dynamic shared memory of one cluster CTA, in bytes; the same carve-up
    as `fwd_layout` / `bwd_layout` in csrc/lstm_cluster.cu. Forward: the
    [F+H, 4 units] W slice, two [F+H, group] input buffers, the k-slices'
    partial sums, c, b and peep. Adjoint: the [4H, units + x_rows] W^T
    slice, two [4H, group] gate-gradient buffers, the partial sums, dc,
    peep and two residual stages of 7 [group, units] arrays."""
    U, Bg = units, group
    part = 4 * CLUSTER_THREADS * Bg
    if adjoint:
        K = 4 * H
        floats = (K * _up4(U + x_rows) + _up4(2 * K * Bg) + part
                  + _up4(Bg * U) + _up4(3 * U) + _up4(14 * Bg * U))
    else:
        K = F + H
        floats = (_up4(K * 4 * U) + _up4(2 * K * Bg) + part + _up4(Bg * U)
                  + _up4(4 * U) + _up4(3 * U))
    return 4 * floats


def sequence_plan(B: int, F: int, H: int) -> SequencePlan:
    """The variant and launch plan of the forward (both modes) and the
    adjoint kernels for batch B, input width F and H hidden units; a
    function of the shape alone.

    "cluster": CLUSTER_SIZE CTAs per group of `group` batch rows, CTA r
    owning hidden units [r U, r U + U) with U = ceil(H / 8) (and input rows
    [r Fr, r Fr + Fr) of W in the adjoint, Fr = ceil(F / 8)). `group` is
    the fewest rows (at most 8) for which the ceil(B / group) clusters run
    side by side (CLUSTER_GROUPS), so a batch spreads over many SMs in one
    wave; where that group's buffers do not fit a CTA's MAX_SHARED_BYTES,
    the largest smaller one that does. "streamed": where no group fits
    (wide H, or a slice of W too large: a one-hot input tens of thousands
    wide), one block per row."""
    U = -(-H // CLUSTER_SIZE)
    Fr = -(-F // CLUSTER_SIZE)
    want = min(GROUP_ROWS[-1], -(-B // CLUSTER_GROUPS))
    if U <= CLUSTER_THREADS and _up4(U + Fr) // 4 <= CLUSTER_THREADS:
        for g in range(want, 0, -1):
            fwd = cluster_bytes(F, H, U, Fr, g, adjoint=False)
            bwd = cluster_bytes(F, H, U, Fr, g, adjoint=True)
            if max(fwd, bwd) <= MAX_SHARED_BYTES:
                return SequencePlan("cluster", U, Fr, g, -(-B // g), fwd, bwd)
    return SequencePlan("streamed", 0, 0, 1, B, 0, 0)


def sequence_variant(B: int, F: int, H: int) -> str:
    """"cluster" or "streamed": see `sequence_plan`."""
    return sequence_plan(B, F, H).variant


def _canon(x, W, b, peep, h0, c0):
    """Every input in float32, biases and peepholes flat (as the TPU
    kernel's `_canon` does)."""
    f32 = torch.float32
    return (x.to(f32), W.to(f32), b.reshape(-1).to(f32),
            peep.reshape(-1).to(f32), h0.to(f32), c0.to(f32))


def _f32(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.to(torch.float32).contiguous()


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def lstm_sequence_reference(x, W, b, peep, h0, c0, offs: float,
                            save_residuals: bool = False):
    """Plain version: x [T, B, F] time-major, W [F+H, 4H] (i|f|o|g),
    b [4H], peep [3H] (i|f|o), carries [B, H]. Returns (hs, h_T, c_T), or
    with `save_residuals` the six [T, B, H] tensors (hs, cs, i, f, o, g)
    the adjoint reads; float32."""
    x, W, b, peep, h, c = _canon(x, W, b, peep, h0, c0)
    H = h.shape[-1]
    p_i, p_f, p_o = peep[:H], peep[H:2 * H], peep[2 * H:]
    outs = {k: [] for k in ("hs", "cs", "i", "f", "o", "g")}
    for t in range(x.shape[0]):
        z = torch.cat([x[t], h], dim=-1) @ W + b
        i = torch.sigmoid(z[:, :H] + c * p_i)
        f = torch.sigmoid(z[:, H:2 * H] + c * p_f + offs)
        g = torch.tanh(z[:, 3 * H:])
        c = f * c + i * g
        o = torch.sigmoid(z[:, 2 * H:3 * H] + c * p_o)
        h = o * torch.tanh(c)
        for k, v in zip(outs, (h, c, i, f, o, g)):
            outs[k].append(v)
    if save_residuals:
        return tuple(torch.stack(v) for v in outs.values())
    return torch.stack(outs["hs"]), h, c


def lstm_adjoint_reference(W, peep, c0, cs, ii, ff, oo, gg, dhs, dhT, dcT,
                           F: int):
    """Plain version of the adjoint recurrence (`_bwd_kernel`'s per-step
    chain): returns (dgates [T, B, 4H] as i|f|o|g, dx [T, B, F], dh0, dc0).
    `dhs`, `dhT`, `dcT` may be None (zero cotangents)."""
    W, peep, c0 = _f32(W), _f32(peep).reshape(-1), _f32(c0)
    T, B, H = cs.shape
    p_i, p_f, p_o = peep[:H], peep[H:2 * H], peep[2 * H:]
    zeros = torch.zeros((B, H), dtype=torch.float32, device=cs.device)
    dh = zeros if dhT is None else _f32(dhT)
    dc = zeros if dcT is None else _f32(dcT)
    dgates, dxs = [None] * T, [None] * T
    for t in range(T - 1, -1, -1):
        c, i, f, o, g = cs[t], ii[t], ff[t], oo[t], gg[t]
        c_prev = c0 if t == 0 else cs[t - 1]
        if dhs is not None:
            dh = dhs[t].to(torch.float32) + dh
        tc = torch.tanh(c)
        do_pre = dh * tc * o * (1.0 - o)
        dct = dh * o * (1.0 - tc * tc) + dc + do_pre * p_o
        di_pre = dct * g * i * (1.0 - i)
        df_pre = dct * c_prev * f * (1.0 - f)
        dg_pre = dct * i * (1.0 - g * g)
        dc = dct * f + di_pre * p_i + df_pre * p_f
        dgates[t] = torch.cat([di_pre, df_pre, do_pre, dg_pre], dim=-1)
        dz = dgates[t] @ W.T
        dxs[t], dh = dz[:, :F], dz[:, F:]
    return torch.stack(dgates), torch.stack(dxs), dh, dc


def lstm_param_grads_reference(x, hs, h0, cs, c0, dgates):
    """Plain version of the parameter-gradient reduction, accumulated step
    by step as `_bwd_kernel` does: dW = sum [x_t, h_{t-1}]^T dgates_t,
    db = sum dgates_t, dpeep = (sum di c_{t-1}, sum df c_{t-1}, sum do c_t),
    with h_{-1} = h0 and c_{-1} = c0."""
    x, h0, c0 = _f32(x), _f32(h0), _f32(c0)
    T, B, H = hs.shape
    dW = torch.zeros((x.shape[-1] + H, 4 * H), dtype=torch.float32,
                     device=x.device)
    db = torch.zeros(4 * H, dtype=torch.float32, device=x.device)
    dpeep = torch.zeros(3 * H, dtype=torch.float32, device=x.device)
    for t in range(T - 1, -1, -1):
        h_prev = h0 if t == 0 else hs[t - 1]
        c_prev = c0 if t == 0 else cs[t - 1]
        dg = dgates[t]
        dW += torch.cat([x[t], h_prev], dim=-1).T @ dg
        db += dg.sum(0)
        dpeep += torch.cat([(dg[:, :H] * c_prev).sum(0),
                            (dg[:, H:2 * H] * c_prev).sum(0),
                            (dg[:, 2 * H:3 * H] * cs[t]).sum(0)])
    return dW, db, dpeep


def lstm_sequence_backward_reference(x, W, peep, h0, c0, hs, cs, ii, ff, oo,
                                     gg, dhs, dhT=None, dcT=None):
    """Plain version of the whole backward (`_bwd_impl`): returns dx, dW,
    db, dpeep, dh0, dc0 in float32."""
    dgates, dx, dh0, dc0 = lstm_adjoint_reference(
        W, peep, c0, cs, ii, ff, oo, gg, dhs, dhT, dcT, x.shape[-1])
    dW, db, dpeep = lstm_param_grads_reference(x, hs, h0, cs, c0, dgates)
    return dx, dW, db, dpeep, dh0, dc0


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {   # entry point -> (pointers, ints, trailing float offs)
    "dl4j_lstm_seq_fwd": (9, 4, True),
    "dl4j_lstm_seq_fwd_res": (14, 4, True),
    "dl4j_lstm_seq_bwd": (15, 4, False),
    "dl4j_lstm_cluster_fwd": (9, 7, True),
    "dl4j_lstm_cluster_fwd_res": (14, 7, True),
    "dl4j_lstm_cluster_bwd": (15, 7, False),
    "dl4j_lstm_param_grad": (9, 4, False),
}


def _kernel_fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        from . import library
        fn = getattr(library(), name)
        n_ptr, n_int, has_offs = _SIGNATURES[name]
        fn.argtypes = ([_PTR] * n_ptr + [_INT] * n_int
                       + ([ctypes.c_float] if has_offs else []) + [_PTR])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _launch(name: str, counter: str, device, *args,
            variant: Optional[str] = None):
    """Launch `name` on the current stream of `device`; tensors are passed
    by pointer (None is a null pointer)."""
    fn = _kernel_fn(name)
    ptr = lambda a: (a.data_ptr() if isinstance(a, torch.Tensor)
                     else a)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*(ptr(a) for a in args), stream)
    if err != 0:
        raise RuntimeError(f"LSTM kernel {name} launch failed: CUDA error "
                           f"{err}")
    _count(counter, variant)


def _launch_sequence(kind: str, counter: str, device, pointers, T, B, F, H,
                     *offs):
    """Launch the sequence kernel `kind` ("fwd", "fwd_res" or "bwd") in
    the variant `sequence_plan(B, F, H)` picks."""
    plan = sequence_plan(B, F, H)
    if plan.variant == "cluster":
        _launch(f"dl4j_lstm_cluster_{kind}", counter, device, *pointers, T,
                B, F, H, plan.units, plan.x_rows, plan.group, *offs,
                variant="cluster")
    else:
        _launch(f"dl4j_lstm_seq_{kind}", counter, device, *pointers, T, B,
                F, H, *offs, variant="streamed")


def lstm_x_chunk(n_in: int, n_out: int) -> int:
    """Input features the streamed forward kernel stages in shared memory
    at once: all of x_t where (F + 6 H) * 4 bytes fit a block's
    MAX_SHARED_BYTES, else chunks of what is left beside the 6 H floats of
    h, c and the gates. Below 1 (n_out above 9,685) no chunk fits: a CUDA
    tensor raises."""
    return min(n_in, MAX_SHARED_BYTES // 4 - 6 * n_out)


def _check(x, W, b, peep, h0, c0):
    tensors = {"x": x, "W": W, "b": b, "peep": peep, "h0": h0, "c0": c0}
    if x.dim() != 3:
        raise ValueError(f"x must be [T, B, F], got shape {tuple(x.shape)}")
    T, B, F = x.shape
    H = h0.shape[-1] if h0.dim() == 2 else -1
    if x.device.type == "cuda" and F > 0 and lstm_x_chunk(F, H) < 1:
        raise ValueError(f"H={H} needs {6 * H * 4} bytes of shared memory "
                         f"and a chunk of x; a block has {MAX_SHARED_BYTES} "
                         "(the plain version on the CPU has no such limit)")
    want = {"W": (F + H, 4 * H), "b": (4 * H,), "peep": (3 * H,),
            "h0": (B, H), "c0": (B, H)}
    for name, shape in want.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"{name} must have shape {shape} for x "
                             f"{tuple(x.shape)} and H={H}, got "
                             f"{tuple(tensors[name].shape)}")
    if T < 1 or B < 1 or H < 1:
        raise ValueError(f"empty LSTM problem: T={T}, B={B}, H={H}")
    _check_placed(tensors, x.device)


def _check_placed(tensors, device):
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, x on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _prepare(x, W, b, peep, h0, c0):
    if not x.is_floating_point():
        raise TypeError(f"LSTM input must be floating point, got {x.dtype}")
    args = _canon(x, W, b, peep, h0, c0)
    _check(*args)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no LSTM kernel for device {x.device}")
    return args


def fused_lstm_sequence(x, W, b, peep, h0, c0, offs: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Whole-sequence LSTM forward, semantics of the layer's `_lstm_cell`
    without a mask. Shapes as `lstm_sequence_reference`; outputs come back
    in x's dtype. One kernel launch on a CUDA device. Not differentiable:
    the layer takes `lstm_sequence` when autograd records."""
    args = _prepare(x, W, b, peep, h0, c0)
    if x.device.type == "cpu":
        hs, hT, cT = lstm_sequence_reference(*args, offs)
    else:
        xf, _, _, _, h0f, _ = args
        T, B, _ = xf.shape
        H = h0f.shape[-1]
        hs, hT, cT = (torch.empty(s, dtype=torch.float32, device=xf.device)
                      for s in ((T, B, H), (B, H), (B, H)))
        _launch_sequence("fwd", "launches", xf.device, (*args, hs, hT, cT),
                         *xf.shape, H, float(offs))
    return hs.to(x.dtype), hT.to(x.dtype), cT.to(x.dtype)


def lstm_residual_forward(x, W, b, peep, h0, c0, offs: float):
    """The residual-saving forward (`_vjp_fwd`'s `_fwd_impl(...,
    save_residuals=True)`): returns (hs, h_T, c_T, cs, i, f, o, g) in
    float32. One kernel launch on a CUDA device."""
    args = _prepare(x, W, b, peep, h0, c0)
    if x.device.type == "cpu":
        hs, cs, ii, ff, oo, gg = lstm_sequence_reference(
            *args, offs, save_residuals=True)
        return hs, hs[-1].clone(), cs[-1].clone(), cs, ii, ff, oo, gg
    xf, _, _, _, h0f, _ = args
    T, B, _ = xf.shape
    H = h0f.shape[-1]
    new = lambda *s: torch.empty(s, dtype=torch.float32, device=xf.device)
    hs, hT, cT = new(T, B, H), new(B, H), new(B, H)
    res = [new(T, B, H) for _ in range(5)]
    _launch_sequence("fwd_res", "residual_launches", xf.device,
                     (*args, hs, hT, cT, *res), T, B, xf.shape[-1], H,
                     float(offs))
    return (hs, hT, cT, *res)


def _check_residuals(T, B, H, device, **tensors):
    _check_placed(tensors, device)
    for name, t in tensors.items():
        if t is not None and (tuple(t.shape) != (T, B, H)
                              or t.dtype != torch.float32):
            raise ValueError(f"{name} must be float32 [T, B, H] = "
                             f"[{T}, {B}, {H}], got {t.dtype} "
                             f"{tuple(t.shape)}")


def lstm_adjoint(W, peep, c0, cs, ii, ff, oo, gg, dhs, dhT=None, dcT=None,
                 F: int = 0, need_dx: bool = True):
    """The adjoint recurrence (`_bwd_kernel`'s per-step chain) from the
    residuals and the cotangents (`dhs`, `dhT`, `dcT` may be None: zeros).
    Returns (dgates [T, B, 4H], dx [T, B, F] or None when not `need_dx`,
    dh0, dc0) in float32. One kernel launch on a CUDA device."""
    W, peep, c0 = _f32(W), _f32(peep).reshape(-1), _f32(c0)
    dhs, dhT, dcT = _f32(dhs), _f32(dhT), _f32(dcT)
    T, B, H = cs.shape
    if tuple(W.shape) != (F + H, 4 * H) or tuple(peep.shape) != (3 * H,):
        raise ValueError(f"W must be [{F + H}, {4 * H}] and peep [{3 * H}] "
                         f"for F={F}, H={H}; got {tuple(W.shape)}, "
                         f"{tuple(peep.shape)}")
    _check_placed({"W": W, "peep": peep, "c0": c0, "dhT": dhT, "dcT": dcT},
                  cs.device)
    _check_residuals(T, B, H, cs.device, cs=cs, i=ii, f=ff, o=oo, g=gg,
                     dhs=dhs)
    if cs.device.type == "cpu":
        dgates, dx, dh0, dc0 = lstm_adjoint_reference(
            W, peep, c0, cs, ii, ff, oo, gg, dhs, dhT, dcT, F)
        return dgates, (dx if need_dx else None), dh0, dc0
    if cs.device.type != "cuda":
        raise ValueError(f"no LSTM kernel for device {cs.device}")
    new = lambda *s: torch.empty(s, dtype=torch.float32, device=cs.device)
    dgates, dh0, dc0 = new(T, B, 4 * H), new(B, H), new(B, H)
    dx = new(T, B, F) if need_dx else None
    _launch_sequence("bwd", "adjoint_launches", cs.device,
                     (W, peep, c0, cs, ii, ff, oo, gg, dhs, dhT, dcT, dgates,
                      dx, dh0, dc0), T, B, F, H)
    return dgates, dx, dh0, dc0


def lstm_param_grads(x, hs, h0, cs, c0, dgates):
    """The parameter-gradient reduction: dW = sum [x_t, h_{t-1}]^T dgates_t,
    db, dpeep (see `lstm_param_grads_reference`), in float32. One kernel
    launch on a CUDA device."""
    x, h0, c0, dgates = _f32(x), _f32(h0), _f32(c0), _f32(dgates)
    T, B, F = x.shape
    H = h0.shape[-1]
    if tuple(dgates.shape) != (T, B, 4 * H):
        raise ValueError(f"dgates must be [{T}, {B}, {4 * H}], got "
                         f"{tuple(dgates.shape)}")
    _check_placed({"h0": h0, "c0": c0, "dgates": dgates}, x.device)
    _check_residuals(T, B, H, x.device, hs=hs, cs=cs)
    if x.device.type == "cpu":
        return lstm_param_grads_reference(x, hs, h0, cs, c0, dgates)
    if x.device.type != "cuda":
        raise ValueError(f"no LSTM kernel for device {x.device}")
    new = lambda *s: torch.empty(s, dtype=torch.float32, device=x.device)
    dW, db, dpeep = new(F + H, 4 * H), new(4 * H), new(3 * H)
    _launch("dl4j_lstm_param_grad", "reduction_launches", x.device, x, hs,
            h0, cs, c0, dgates, dW, db, dpeep, T, B, F, H)
    return dW, db, dpeep


def lstm_sequence_backward(x, W, peep, h0, c0, hs, cs, ii, ff, oo, gg, dhs,
                           dhT=None, dcT=None, need_dx: bool = True):
    """The backward (`_vjp_bwd`'s `_bwd_impl`) from the residuals and the
    cotangents (`dhs`, `dhT`, `dcT` may be None: zeros). Returns dx (None
    when not `need_dx`), dW, db, dpeep, dh0, dc0 in float32. On a CUDA
    device: two launches, the adjoint and the reduction."""
    x = _f32(x)
    dgates, dx, dh0, dc0 = lstm_adjoint(W, peep, c0, cs, ii, ff, oo, gg, dhs,
                                        dhT, dcT, x.shape[-1], need_dx)
    dW, db, dpeep = lstm_param_grads(x, hs, h0, cs, c0, dgates)
    return dx, dW, db, dpeep, dh0, dc0


class _LstmSequence(torch.autograd.Function):
    """`fused_lstm_sequence` with its custom VJP: forward saves what
    `_vjp_fwd` saves, backward is `_vjp_bwd`. The h_T / c_T cotangents may
    be None (TBPTT carries leave a chunk detached)."""

    @staticmethod
    def forward(ctx, x, W, b, peep, h0, c0, offs):
        hs, hT, cT, cs, ii, ff, oo, gg = lstm_residual_forward(
            x, W, b, peep, h0, c0, offs)
        ctx.save_for_backward(x, W, peep, h0, c0, hs, cs, ii, ff, oo, gg)
        ctx.dtypes = (x.dtype, W.dtype, b.dtype, peep.dtype, h0.dtype,
                      c0.dtype)
        ctx.shapes = (b.shape, peep.shape)
        ctx.set_materialize_grads(False)
        return hs.to(x.dtype), hT.to(x.dtype), cT.to(x.dtype)

    @staticmethod
    def backward(ctx, dhs, dhT, dcT):
        x, W, peep, h0, c0, hs, cs, ii, ff, oo, gg = ctx.saved_tensors
        dx, dW, db, dpeep, dh0, dc0 = lstm_sequence_backward(
            x, W, peep, h0, c0, hs, cs, ii, ff, oo, gg, dhs, dhT, dcT,
            need_dx=ctx.needs_input_grad[0])
        dt = ctx.dtypes
        b_shape, p_shape = ctx.shapes
        return (None if dx is None else dx.to(dt[0]), dW.to(dt[1]),
                db.reshape(b_shape).to(dt[2]),
                dpeep.reshape(p_shape).to(dt[3]), dh0.to(dt[4]),
                dc0.to(dt[5]), None)


def lstm_sequence(x, W, b, peep, h0, c0, offs: float):
    """Differentiable whole-sequence LSTM forward (same contract as
    `fused_lstm_sequence`): the residual-saving kernel forward, and the
    adjoint and reduction kernels in backward."""
    return _LstmSequence.apply(x, W, b, peep, h0, c0, float(offs))
