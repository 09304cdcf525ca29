"""Flash attention, forward and backward: CUDA kernel launches for all heads.

Counterpart of `deeplearning4j_tpu/kernels/attention.py:flash_attention`,
its custom VJP included. The kernels are in `csrc/attention.cu`; its header
says what bounds each and how its design answers that. The decode plane's
`q_positions` / `kv_length` masks are in the plain versions only, as JAX
has them only in its `attention_reference`: the decode tick attends through
them, the prefill through the causal primal kernel.

  * `flash_attention` — the JAX contract: q [B, T, D], k/v [B, S, D].
  * `flash_attention_heads` — the entry the transformer layer calls:
    q [B, T, H, Dh], k/v [B, S, H, Dh] (what `vmap` over axis 2 gives in
    JAX, written as a batch dimension). The kernels read rows with stride
    H * Dh, so the layer's projections go in as they are. When autograd
    records, it runs `_FlashAttention` (the custom VJP: the forward that
    also writes the logsumexp, then dq and dk/dv in backward); otherwise
    the primal forward, one launch.
  * `flash_attention_fwd_lse_heads` — the forward that also returns the
    per-row logsumexp L [B, H, T] (`_flash_fwd_impl(..., emit_lse=True)`).
  * `flash_attention_bwd_heads` — the backward (`_flash_bwd_impl`): dq, dk,
    dv from q, k, v, o, L and the output cotangent. Two launches,
    `attention_bwd_dq` (which also forms D = rowsum(do * o) [B, H, T]) and
    `attention_bwd_dkv`.
  * `attention_reference`, `attention_reference_heads`,
    `attention_reference_heads_lse`, `attention_bwd_dq_reference`,
    `attention_bwd_dkv_reference`, `attention_bwd_reference_heads` — the
    plain PyTorch versions, for the CPU and for holding the kernels to
    account. The backward ones are written out as the TPU kernels' math
    (p from the saved logsumexp), not as autograd of the forward.
  * Launch counts, one per kernel: `launches` (primal forward),
    `lse_launches`, `dq_launches`, `dkv_launches` (`launch_counts()`), the
    same launches by kernel variant (`variant_counts()`), and the primal
    forward's eager launches by dtype, that is by template instantiation
    (`dtype_counts()`; graph replays add to the first two only).
  * `backward_variant`, `forward_variant` — which kernel variant a launch
    takes (`csrc/attention.cu`'s header describes them): the backward
    runs "wgmma" (tensor cores) for bfloat16 / float16 at head dimensions
    that are multiples of 16 up to 256 with 16-byte aligned rows and
    pointers, "simt" (CUDA cores) for any other dtype or layout up to 256,
    and "wide" above 256; the forward runs "tiled" up to 256 and "wide"
    above.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises. Both compute in float32 and write o, dq, dk
and dv in q's dtype, as the TPU kernels do (`preferred_element_type=
jnp.float32`, outputs in the inputs' dtype); the row statistics L and D are
float32 [B, H, T]. q, k, v (and o, do) must share one dtype. The plain
versions take any floating dtype; the kernels take float32, bfloat16 or
float16 and contiguous tensors. Neither caps the head dimension or B * H.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

__all__ = ["flash_attention", "flash_attention_heads",
           "flash_attention_fwd_lse_heads", "flash_attention_bwd_heads",
           "attention_bwd_dq", "attention_bwd_dkv", "attention_reference",
           "attention_reference_heads", "attention_reference_heads_lse",
           "attention_bwd_dq_reference", "attention_bwd_dkv_reference",
           "attention_bwd_reference_heads", "launches", "lse_launches",
           "dq_launches", "dkv_launches", "reset_launches", "launch_counts",
           "variant_counts", "dtype_counts", "backward_variant",
           "forward_variant", "TILED_HEAD_DIM"]

TILED_HEAD_DIM = 256     # the widest head the tiled kernels take (Gemma's);
                         # above it the "wide" kernels run
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_DTYPE_NAMES = {0: "float32", 1: "bfloat16", 2: "float16"}
_VARIANTS = {"fwd": ("tiled", "wide"), "lse": ("tiled", "wide"),
             "dq": ("simt", "wgmma", "wide"),
             "dkv": ("simt", "wgmma", "wide")}

launches = 0             # primal forward
lse_launches = 0         # forward that writes the logsumexp
dq_launches = 0          # backward: dq (and D)
dkv_launches = 0         # backward: dk and dv
_COUNTS = ("launches", "lse_launches", "dq_launches", "dkv_launches")
_by_variant = {kind: dict.fromkeys(names, 0)
               for kind, names in _VARIANTS.items()}
_by_dtype = dict.fromkeys(_DTYPE_NAMES.values(), 0)
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
        _by_dtype.update(dict.fromkeys(_by_dtype, 0))
    return n


def launch_counts() -> dict:
    """{count name: launches} for the four kernels."""
    with _launch_lock:
        return {name: globals()[name] for name in _COUNTS}


def variant_counts() -> dict:
    """{"fwd" | "lse" | "dq" | "dkv": {variant: launches}}; each kind's
    variants add up to its total in `launch_counts()`."""
    with _launch_lock:
        return {kind: dict(counts) for kind, counts in _by_variant.items()}


def dtype_counts() -> dict:
    """{dtype name: eager primal-forward launches}: which instantiation of
    the forward kernel ran (float32, bfloat16 or float16)."""
    with _launch_lock:
        return dict(_by_dtype)


def forward_variant(head_dim: int) -> str:
    """The forward kernel a head dimension takes: "tiled" up to
    TILED_HEAD_DIM, "wide" above."""
    return "wide" if head_dim > TILED_HEAD_DIM else "tiled"


def backward_variant(dtype, head_dim: int, row_stride: int,
                     aligned: bool) -> str:
    """The dq and dk/dv kernel variant: "wide" above TILED_HEAD_DIM;
    "wgmma" (tensor cores) for bfloat16 or float16 at a head dimension that
    is a multiple of 16, a row stride that is a multiple of 8 elements and
    16-byte aligned pointers (`aligned`), as its TMA tiles need; "simt"
    (CUDA cores) otherwise."""
    if head_dim > TILED_HEAD_DIM:
        return "wide"
    if (dtype in (torch.bfloat16, torch.float16) and head_dim % 16 == 0
            and row_stride % 8 == 0 and aligned):
        return "wgmma"
    return "simt"


def _scale(q, sm_scale):
    return 1.0 / (q.shape[-1] ** 0.5) if sm_scale is None else float(sm_scale)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def _masked_logits(q, k, causal, scale, q_positions=None, kv_length=None):
    """float32 logits [B, H, T, S], -inf above the top-left causal diagonal
    (kv <= q attends), and the live mask (None when nothing is masked).
    `q_positions` [B, T] moves each query's diagonal to its absolute key
    index (kv <= q_positions[b, t] attends); `kv_length` [B] (or a scalar)
    masks the keys at kv >= kv_length[b]."""
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    T, S = logits.shape[-2:]
    ki = torch.arange(S, device=q.device)
    live = None
    if causal:
        if q_positions is None:
            qi = torch.arange(T, device=q.device)[None, :]
        else:
            qi = torch.as_tensor(q_positions, device=q.device)
        live = (ki[None, None, :] <= qi[:, :, None])[:, None]  # [B|1,1,T,S]
    if kv_length is not None:
        lengths = torch.as_tensor(kv_length, device=q.device).reshape(-1)
        valid = (ki[None, :] < lengths[:, None])[:, None, None, :]
        live = valid if live is None else live & valid
    if live is None:
        return logits, None
    return logits.masked_fill(~live, float("-inf")), live


def attention_reference_heads(q, k, v, causal: bool = False,
                              sm_scale: Optional[float] = None,
                              q_positions=None, kv_length=None):
    """Plain version on q [B, T, H, Dh], k/v [B, S, H, Dh]: float32
    logits, -inf above the top-left causal diagonal (kv <= q attends),
    softmax, output in q's dtype. The decode masks are JAX's
    `attention_reference`'s: `q_positions` [B, T], each query's absolute
    key index (causal then means kv <= q_positions[b, t]), and `kv_length`
    [B], the valid cache slots of each row (keys at kv >= kv_length[b] get
    no weight). A row that admits no key gives NaN, as in JAX. k and v may
    have another float dtype than q (a float32 cache under bfloat16
    queries)."""
    logits, _ = _masked_logits(q, k, causal, _scale(q, sm_scale),
                               q_positions, kv_length)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhts,bshd->bthd", w, v.float()).to(q.dtype)


def attention_reference_heads_lse(q, k, v, causal: bool = False,
                                  sm_scale: Optional[float] = None):
    """Plain version of the forward that also emits the logsumexp: returns
    (out in q's dtype, as `attention_reference_heads`; L [B, H, T] float32
    = m_safe + log(max(l, 1e-30)) with m the row max of the scaled, masked
    logits, 0 where it is -inf, and l the row sum of exp(logits - m_safe),
    as the TPU kernel writes it)."""
    logits, _ = _masked_logits(q, k, causal, _scale(q, sm_scale))
    m = logits.amax(dim=-1)
    m_safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    l = torch.exp(logits - m_safe[..., None]).sum(dim=-1)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", w, v.float()).to(q.dtype)
    return out.contiguous(), m_safe + torch.log(l.clamp_min(1e-30))


def _probs(q, k, lse, causal, scale):
    """p = exp(s - L) masked to 0 (`_make_dq_kernel`'s p), [B, H, T, S]."""
    logits, live = _masked_logits(q, k, causal, scale)
    p = torch.exp(logits - lse.float()[..., None])
    return p if live is None else p.masked_fill(~live, 0.0)


def attention_bwd_dq_reference(q, k, v, o, lse, do, causal: bool = False,
                               sm_scale: Optional[float] = None):
    """Plain version of the dq kernel: returns (dq [B, T, H, Dh] in q's
    dtype, D = rowsum(do * o) [B, H, T] float32), computed in float32."""
    scale = _scale(q, sm_scale)
    p = _probs(q, k, lse, causal, scale)
    dsum = (do.float() * o.float()).sum(dim=-1).permute(0, 2, 1)
    dp = torch.einsum("bthd,bshd->bhts", do.float(), v.float())
    ds = p * (dp - dsum[..., None]) * scale
    dq = torch.einsum("bhts,bshd->bthd", ds, k.float())
    return dq.to(q.dtype), dsum.contiguous()


def attention_bwd_dkv_reference(q, k, v, do, lse, dsum, causal: bool = False,
                                sm_scale: Optional[float] = None):
    """Plain version of the dk/dv kernel: returns (dk, dv), [B, S, H, Dh]
    in q's dtype (computed in float32), from D = rowsum(do * o) [B, H, T]."""
    scale = _scale(q, sm_scale)
    p = _probs(q, k, lse, causal, scale)
    dp = torch.einsum("bthd,bshd->bhts", do.float(), v.float())
    ds = p * (dp - dsum.float()[..., None]) * scale
    return (torch.einsum("bhts,bthd->bshd", ds, q.float()).to(q.dtype),
            torch.einsum("bhts,bthd->bshd", p, do.float()).to(q.dtype))


def attention_bwd_reference_heads(q, k, v, o, lse, do, causal: bool = False,
                                  sm_scale: Optional[float] = None):
    """Plain version of the whole backward (`_flash_bwd_impl`): returns
    dq, dk, dv in q's dtype."""
    dq, dsum = attention_bwd_dq_reference(q, k, v, o, lse, do, causal,
                                          sm_scale)
    dk, dv = attention_bwd_dkv_reference(q, k, v, do, lse, dsum, causal,
                                         sm_scale)
    return dq, dk, dv


def attention_reference(q, k, v, causal: bool = False,
                        sm_scale: Optional[float] = None,
                        q_positions=None, kv_length=None):
    """Plain version on q [B, T, D], k/v [B, S, D] (JAX's
    `attention_reference`, its decode masks included)."""
    return attention_reference_heads(
        q[:, :, None], k[:, :, None], v[:, :, None], causal,
        _scale(q, sm_scale), q_positions, kv_length)[:, :, 0]


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
_PTR, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_TAIL = [_INT] * 5 + [_I64] + [_INT, ctypes.c_float, _INT]
_SIGNATURES = {   # entry point -> argument types before the stream
    "dl4j_flash_attn_fwd": [_PTR] * 4 + [_INT] * 5 + [_I64] * 4
                           + [_INT, ctypes.c_float, _INT],
    "dl4j_flash_attn_fwd_lse": [_PTR] * 5 + _TAIL,
    "dl4j_flash_attn_fwd_wide": [_PTR] * 5 + _TAIL,
    **{f"dl4j_flash_attn_bwd_{kind}_{variant}": [_PTR] * 8 + _TAIL
       for kind in ("dq", "dkv") for variant in _VARIANTS[kind]},
}


def _kernel_fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        from . import library
        fn = getattr(library(), name)
        fn.argtypes = _SIGNATURES[name] + [_PTR]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _launch(name: str, counter: str, variant, device, *args):
    """Launch `name` on the current stream of `device`, counted under
    `counter` and `variant` = (kind, variant name) (or in this thread's
    `kernels.tally()`); tensors are passed by pointer (None is a null
    pointer)."""
    fn = _kernel_fn(name)
    ptr = lambda a: a.data_ptr() if isinstance(a, torch.Tensor) else a
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*(ptr(a) for a in args), stream)
    if err != 0:
        raise RuntimeError(f"attention kernel {name} launch failed: CUDA "
                           f"error {err}")
    from . import tallied
    if tallied("attention", counter, *variant):
        return
    with _launch_lock:
        globals()[counter] += 1
        _by_variant[variant[0]][variant[1]] += 1
        if counter == "launches":
            _by_dtype[_DTYPE_NAMES[args[-1]]] += 1


def _check_placed(tensors, device, dtype):
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, q on {device}")
        if not t.is_floating_point():
            raise ValueError(f"{name} is {t.dtype}; attention takes "
                             "floating-point tensors")
        if t.dtype != dtype:
            raise ValueError(f"mixed dtypes: {name} is {t.dtype}, q is "
                             f"{dtype}; attention takes one dtype")
        if device.type != "cpu" and t.dtype not in _DTYPE_CODES:
            raise ValueError(f"{name} is {t.dtype}; the attention kernels "
                             "take float32, bfloat16 or float16 (a CPU "
                             "tensor of another float dtype takes the plain "
                             "version)")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be [B, T, H, Dh], got shape "
                             f"{tuple(t.shape)}")
    _check_placed({"q": q, "k": k, "v": v}, q.device, q.dtype)
    B, T, H, Dh = q.shape
    S = k.shape[1]
    if k.shape != (B, S, H, Dh) or v.shape != k.shape:
        raise ValueError(f"k and v must be [B, S, H, Dh] = [{B}, S, {H}, "
                         f"{Dh}] for q {tuple(q.shape)}; got k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if min(B, T, S, H, Dh) < 1:
        raise ValueError(f"empty attention problem: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no attention kernel for device {q.device}")


def _check_rows(T, B, H, device, **rows):
    """Row statistics (L, D) must be float32 [B, H, T] on q's device."""
    for name, t in rows.items():
        if (tuple(t.shape) != (B, H, T) or t.dtype != torch.float32
                or t.device != device or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 [B, H, T] "
                             f"= [{B}, {H}, {T}] on {device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def _new(shape, device, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=device)


def _ld(q):
    # row stride of a contiguous [B, T, H, Dh] (size-1 dims may report any
    # stride, so it is not read from them)
    return q.shape[2] * q.shape[3]


def _primal(q, k, v, causal, scale):
    B, T, H, Dh = q.shape
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    ld = _ld(q)
    variant = forward_variant(Dh)
    if variant == "wide":
        _launch("dl4j_flash_attn_fwd_wide", "launches", ("fwd", variant),
                q.device, q, k, v, o, None, B, T, k.shape[1], H, Dh, ld,
                int(bool(causal)), scale, _DTYPE_CODES[q.dtype])
    else:
        _launch("dl4j_flash_attn_fwd", "launches", ("fwd", variant),
                q.device, q, k, v, o, B, T, k.shape[1], H, Dh, ld, ld, ld,
                ld, int(bool(causal)), scale, _DTYPE_CODES[q.dtype])
    return o


def flash_attention_fwd_lse_heads(q, k, v, causal: bool = False,
                                  sm_scale: Optional[float] = None):
    """The forward that also emits the logsumexp (`_flash_fwd_impl(...,
    emit_lse=True)`): returns (out [B, T, H, Dh] in q's dtype, L [B, H, T]
    float32). One kernel launch on a CUDA device."""
    _check(q, k, v)
    scale = _scale(q, sm_scale)
    if q.device.type == "cpu":
        return attention_reference_heads_lse(q, k, v, causal, scale)
    B, T, H, Dh = q.shape
    o, lse = _new(q.shape, q.device, q.dtype), _new((B, H, T), q.device)
    variant = forward_variant(Dh)
    name = ("dl4j_flash_attn_fwd_wide" if variant == "wide"
            else "dl4j_flash_attn_fwd_lse")
    _launch(name, "lse_launches", ("lse", variant), q.device, q, k, v, o,
            lse, B, T, k.shape[1], H, Dh, _ld(q), int(bool(causal)), scale,
            _DTYPE_CODES[q.dtype])
    return o, lse


def _check_bwd(q, k, v, rows, **like_q):
    """q/k/v as `_check`; the tensors `like_q` (o, do) placed and shaped as
    q; the row statistics `rows` (L, D) as `_check_rows`."""
    _check(q, k, v)
    _check_placed(like_q, q.device, q.dtype)
    for name, t in like_q.items():
        if t.shape != q.shape:
            raise ValueError(f"{name} must have q's shape {tuple(q.shape)}, "
                             f"got {tuple(t.shape)}")
    B, T, H, _ = q.shape
    _check_rows(T, B, H, q.device, **rows)


def _backward_variant(q, *tensors):
    """`backward_variant` for these inputs and outputs."""
    aligned = all(t.data_ptr() % 16 == 0 for t in (q,) + tensors)
    return backward_variant(q.dtype, q.shape[-1], _ld(q), aligned)


def attention_bwd_dq(q, k, v, o, lse, do, causal: bool = False,
                     sm_scale: Optional[float] = None):
    """dq and D = rowsum(do * o) (`_make_dq_kernel`, with D folded into its
    preamble): returns (dq [B, T, H, Dh] in q's dtype, D [B, H, T] in
    float32). One kernel launch on a CUDA device."""
    _check_bwd(q, k, v, {"lse": lse}, o=o, do=do)
    scale = _scale(q, sm_scale)
    if q.device.type == "cpu":
        return attention_bwd_dq_reference(q, k, v, o, lse, do, causal, scale)
    B, T, H, Dh = q.shape
    dq, dsum = _new(q.shape, q.device, q.dtype), _new((B, H, T), q.device)
    variant = _backward_variant(q, k, v, o, do, dq)
    _launch(f"dl4j_flash_attn_bwd_dq_{variant}", "dq_launches",
            ("dq", variant), q.device, q, k, v, o, do, lse, dq, dsum, B, T,
            k.shape[1], H, Dh, _ld(q), int(bool(causal)), scale,
            _DTYPE_CODES[q.dtype])
    return dq, dsum


def attention_bwd_dkv(q, k, v, do, lse, dsum, causal: bool = False,
                      sm_scale: Optional[float] = None):
    """dk and dv (`_make_dkv_kernel`) from D = rowsum(do * o) [B, H, T]:
    returns (dk, dv) [B, S, H, Dh] in q's dtype. One kernel launch on a
    CUDA device."""
    _check_bwd(q, k, v, {"lse": lse, "dsum": dsum}, do=do)
    B, T, H, Dh = q.shape
    scale = _scale(q, sm_scale)
    if q.device.type == "cpu":
        return attention_bwd_dkv_reference(q, k, v, do, lse, dsum, causal,
                                           scale)
    dk, dv = (_new(k.shape, q.device, q.dtype) for _ in range(2))
    variant = _backward_variant(q, k, v, do, dk, dv)
    _launch(f"dl4j_flash_attn_bwd_dkv_{variant}", "dkv_launches",
            ("dkv", variant), q.device, q, k, v, do, lse, dsum, dk, dv, B, T,
            k.shape[1], H, Dh, _ld(q), int(bool(causal)), scale,
            _DTYPE_CODES[q.dtype])
    return dk, dv


def flash_attention_bwd_heads(q, k, v, o, lse, do, causal: bool = False,
                              sm_scale: Optional[float] = None):
    """The backward (`_flash_bwd_impl`) from the forward's output o, its
    logsumexp L [B, H, T] and the output cotangent do (made contiguous
    here): returns dq, dk, dv in q's dtype. On a CUDA device: two launches,
    dq (which forms D) and then dk/dv."""
    do = do.contiguous()
    dq, dsum = attention_bwd_dq(q, k, v, o, lse, do, causal, sm_scale)
    dk, dv = attention_bwd_dkv(q, k, v, do, lse, dsum, causal, sm_scale)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """`flash_attention_heads` with its custom VJP: forward saves what
    `_flash_fwd` saves (q, k, v, o, L), backward is `_flash_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_attention_fwd_lse_heads(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_heads(q, k, v, o, lse, do,
                                               ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_heads(q, k, v, causal: bool = False,
                          sm_scale: Optional[float] = None):
    """Multi-head attention, q [B, T, H, Dh], k/v [B, S, H, Dh] ->
    [B, T, H, Dh]; semantics of `attention_reference_heads`. When autograd
    records (grad enabled and an input requires grad) it is differentiable
    through `_FlashAttention`: on a CUDA device the logsumexp forward now
    and the dq and dk/dv kernels in backward. Otherwise the primal forward:
    one kernel launch on a CUDA device."""
    _check(q, k, v)
    scale = _scale(q, sm_scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, bool(causal), scale)
    if q.device.type == "cpu":
        return attention_reference_heads(q, k, v, causal, scale)
    return _primal(q, k, v, causal, scale)


def flash_attention(q, k, v, causal: bool = False,
                    sm_scale: Optional[float] = None):
    """Flash attention with the JAX contract: q [B, T, D], k/v [B, S, D].
    The TPU kernel's tiling knobs `block_q` / `block_k` have no
    counterpart: the CUDA kernels pick their tiles at launch."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 3:
            raise ValueError(f"{name} must be [B, T, D], got shape "
                             f"{tuple(t.shape)}")
    return flash_attention_heads(q[:, :, None], k[:, :, None],
                                 v[:, :, None], causal, sm_scale)[:, :, 0]
