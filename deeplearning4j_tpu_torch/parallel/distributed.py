"""Multi-process runtime over `torch.distributed` (the port of
`deeplearning4j_tpu/parallel/distributed.py`).

Where JAX's pod needs `jax.distributed.initialize` for rendezvous, the
port's ranks meet through `torch.distributed.init_process_group`: one rank
per device, NCCL between GPUs, gloo between CPU processes. The dataset
plane is the same as JAX's: every rank either slices its rows out of a
replicated global batch (`local_batch_slice`) or reads only its own shard
files (`datasets/export.py`).

`initialize()` is a no-op when no coordinator is configured (the
single-process case). It reads the coordinator from its arguments, from
`JAX_COORDINATOR_ADDRESS` (the JAX package's variable, so one launcher
script serves both) or from torchrun's `MASTER_ADDR` / `MASTER_PORT`, the
world size from `WORLD_SIZE` and the rank from `RANK`. Rendezvous retries
transient failures with JAX's capped exponential backoff and, once the
budget is spent, raises an error naming the coordinator.
"""
from __future__ import annotations

import logging
import os
import time
from typing import Optional

import numpy as np
import torch

from .mesh import MeshAxes, make_mesh
from ..util.platform import DeviceLike, resolve_device

log = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["initialize", "is_multi_host", "global_mesh", "process_index",
           "process_count", "local_batch_slice", "global_batch_array",
           "allreduce_evaluation", "allgather_rows"]

# patchable in tests (backoff without wall-clock sleeps; a fake rendezvous)
_sleep = time.sleep
_init_process_group = None

#: transient rendezvous failures worth retrying: the coordinator not up
#: yet / mid-teardown surfaces as a RuntimeError (torch's DistStoreError,
#: DistNetworkError) or a raw socket error
_RETRYABLE = (RuntimeError, ConnectionError, OSError, TimeoutError)


def _dist():
    import torch.distributed as dist
    return dist if dist.is_available() and dist.is_initialized() else None


def _coordinator(address: Optional[str]) -> Optional[str]:
    if address:
        return address
    env = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if env:
        return env
    host, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    if host and port:
        return f"{host}:{port}"
    return None


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               max_retries: int = 4,
               backoff_base_s: float = 0.5,
               backoff_cap_s: float = 8.0, *,
               device: DeviceLike = None,
               timeout_s: Optional[float] = None):
    """Join the process group. No-op (returns False) when single-process:
    no coordinator in the arguments or the environment. The backend is
    NCCL for a GPU `device` (the default) and gloo for `device="cpu"`; with
    no GPU and no `device="cpu"` the call raises.

    Rendezvous retries up to `max_retries` times on transient failures
    with bounded exponential backoff (base * 2^attempt, capped), counting
    each retry into ``dl4j_fault_retries_total{kind=rendezvous}``. After
    the budget is spent it raises a RuntimeError naming the coordinator
    address and the usual causes, chained to the last underlying error."""
    addr = _coordinator(coordinator_address)
    if addr is None:
        log.debug("distributed.initialize: single-process mode")
        return False
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None else
                              int(os.environ.get("LOCAL_RANK", "0"))
                              % max(1, torch.cuda.device_count()))
    init = _init_process_group
    if init is None:
        import torch.distributed as dist
        init = dist.init_process_group
    from ..fault.metrics import count_retry

    kw = {}
    if timeout_s is not None:
        import datetime
        kw["timeout"] = datetime.timedelta(seconds=float(timeout_s))
    last = None
    for attempt in range(int(max_retries) + 1):
        if attempt:
            delay = min(backoff_base_s * (2 ** (attempt - 1)), backoff_cap_s)
            log.warning(
                "distributed.initialize: rendezvous with %s failed (%s); "
                "retry %d/%d in %.1fs", addr, last, attempt, max_retries,
                delay)
            count_retry("rendezvous")
            _sleep(delay)
        try:
            init(backend=backend, init_method=f"tcp://{addr}",
                 world_size=int(num_processes), rank=int(process_id), **kw)
            return True
        except _RETRYABLE as e:
            last = e
    raise RuntimeError(
        f"could not rendezvous with the torch.distributed coordinator at "
        f"{addr} after {int(max_retries) + 1} attempt(s). Check that the "
        f"rank-0 process is running and reachable at that address/port, "
        f"that num_processes ({num_processes}) matches the launched world "
        f"size, and that no stale generation still holds the port."
    ) from last


def is_multi_host() -> bool:
    return process_count() > 1


def process_index() -> int:
    dist = _dist()
    return 0 if dist is None else dist.get_rank()


def process_count() -> int:
    dist = _dist()
    return 1 if dist is None else dist.get_world_size()


def global_mesh(model_parallel: int = 1, seq_parallel: int = 1,
                pipe_parallel: int = 1, data_parallel: Optional[int] = None,
                *, device: DeviceLike = None):
    """Standard mesh factory: data axis outermost, then pipe / seq / model
    (JAX's order); axes of size 1 other than data are left out."""
    n = process_count()
    inner = model_parallel * seq_parallel * pipe_parallel
    if n % inner:
        raise ValueError(f"{n} devices not divisible by inner {inner}")
    dp = data_parallel if data_parallel is not None else n // inner
    axes = {MeshAxes.DATA: dp, MeshAxes.PIPE: pipe_parallel,
            MeshAxes.SEQ: seq_parallel, MeshAxes.MODEL: model_parallel}
    axes = {k: v for k, v in axes.items() if v > 1 or k == MeshAxes.DATA}
    return make_mesh(axes, device=device)


def global_batch_array(mesh, local, axis: str = MeshAxes.DATA):
    """THIS rank's share of the global batch, on the rank's device: the
    port's counterpart of assembling a data-sharded global array from
    process-local data. Each rank holds only its rows; the trainer's
    collectives combine the ranks' results."""
    return torch.as_tensor(np.asarray(local), device=mesh.device)


def local_batch_slice(global_batch: int) -> slice:
    """This rank's slice of a globally-sharded batch. Shards must be
    uniform, so a non-divisible global batch is an error (pad or drop
    upstream) rather than a silent loss of the remainder on every rank."""
    count = process_count()
    if global_batch % count:
        raise ValueError(
            f"global batch {global_batch} not divisible by process count "
            f"{count}; pad the batch or drop the ragged tail upstream")
    per = global_batch // count
    i = process_index()
    return slice(i * per, (i + 1) * per)


def _wire_device(group=None) -> torch.device:
    """The device a collective's tensors must live on for the group's
    backend: the current GPU for NCCL, the CPU for gloo."""
    import torch.distributed as dist
    if str(dist.get_backend(group)) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _group_size(group) -> int:
    import torch.distributed as dist
    return dist.get_world_size(group)


def allreduce_evaluation(ev, group=None):
    """The reduce half of the distributed evaluation plane: merge the
    ranks' `Evaluation` counts (confusion matrix, top-N tallies) into one
    identical Evaluation on every rank (reference
    `IEvaluationReduceFunction.java`). This rank's per-example `predictions`
    records stay on the merged object, process-local, as documented."""
    from ..eval.evaluation import ConfusionMatrix, Evaluation

    dist = _dist()
    if dist is None or _group_size(group) == 1:
        return ev
    dev = _wire_device(group)
    c_local = int(ev.num_classes or 0)
    c_t = torch.tensor([c_local], dtype=torch.int64, device=dev)
    dist.all_reduce(c_t, op=dist.ReduceOp.MAX, group=group)
    c = int(c_t.item())
    mat = np.zeros((c, c), np.int64)
    if ev.confusion is not None:
        mat[:c_local, :c_local] = ev.confusion.matrix
    payload = torch.as_tensor(np.concatenate([
        mat.ravel(), np.asarray([ev.top_n_correct, ev.top_n_total],
                                np.int64)]), device=dev)
    dist.all_reduce(payload, group=group)
    total = payload.cpu().numpy()
    merged = Evaluation(num_classes=c or None, top_n=ev.top_n,
                        labels=ev.label_names)
    if c:
        merged.confusion = ConfusionMatrix(c)
        merged.confusion.matrix = total[:-2].reshape(c, c)
    merged.top_n_correct = int(total[-2])
    merged.top_n_total = int(total[-1])
    merged.predictions = list(ev.predictions)
    return merged


_DTYPES = (np.float32, np.float64, np.float16, np.int32, np.int64)


def allgather_rows(local, group=None):
    """Gather the ranks' variable-length 1-D arrays into their
    concatenation in rank order, identical on every rank (the collect half
    of per-example distributed scoring). The result keeps the input dtype:
    the wire carries float64, which holds every float32 value and every
    integer below 2**53 exactly, and the ranks agree on the dtype of the
    first rank with rows, so an empty share does not change it."""
    dist = _dist()
    local = np.asarray(local)
    if dist is None or _group_size(group) == 1:
        return local
    dev = _wire_device(group)
    n = _group_size(group)
    code = next((i for i, d in enumerate(_DTYPES) if local.dtype == d), 0)
    head = torch.tensor([local.shape[0], code if local.shape[0] else -1],
                        dtype=torch.int64, device=dev)
    heads = [torch.empty_like(head) for _ in range(n)]
    dist.all_gather(heads, head, group=group)
    heads = np.stack([h.cpu().numpy() for h in heads])
    lens = heads[:, 0]
    codes = [int(c) for c in heads[:, 1] if c >= 0]
    dtype = np.dtype(_DTYPES[codes[0]]) if codes else local.dtype
    m = int(lens.max())
    if m == 0:
        return np.zeros(0, dtype)
    padded = torch.zeros(m, dtype=torch.float64, device=dev)
    padded[:local.shape[0]] = torch.as_tensor(local.astype(np.float64),
                                              device=dev)
    rows = [torch.empty_like(padded) for _ in range(n)]
    dist.all_gather(rows, padded, group=group)
    return np.concatenate([rows[p][:int(lens[p])].cpu().numpy()
                           for p in range(n)]).astype(dtype)
