"""PyTorch port, the multi-process runtime glue on the CPU: the twins of
`tests/test_distributed.py` (parallel/distributed.py) — single-process
behaviours for real, the rendezvous through a fake
`init_process_group`, the multi-process topology through patched
`process_count` / `process_index` (JAX's tests patch jax.distributed and
the process topology the same way).

The port's rendezvous is torch.distributed's: NCCL for a GPU device, gloo
for `device="cpu"`; with no GPU and no `device="cpu"` it raises. It reads
the coordinator from its arguments, `JAX_COORDINATOR_ADDRESS` or
torchrun's MASTER_ADDR / MASTER_PORT, and keeps JAX's retry schedule and
exhaustion error.
"""
import numpy as np
import pytest

import deeplearning4j_tpu_torch.parallel.distributed as dist
from deeplearning4j_tpu_torch import telemetry
from deeplearning4j_tpu_torch.parallel import MeshAxes
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _no_env(monkeypatch):
    for k in ("JAX_COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT",
              "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)


def _fake(calls, fail=0, exc=RuntimeError("DEADLINE_EXCEEDED: not up")):
    def init(backend=None, init_method=None, world_size=None, rank=None,
             **kw):
        calls.append({"backend": backend, "init": init_method,
                      "n": world_size, "rank": rank})
        if len(calls) <= fail:
            raise exc
    return init


def test_initialize_single_process_noop():
    assert dist.initialize() is False
    assert dist.is_multi_host() is False
    assert dist.process_index() == 0
    assert dist.process_count() == 1


def test_initialize_passes_coordinator(monkeypatch):
    calls = []
    monkeypatch.setattr(dist, "_init_process_group", _fake(calls))
    assert dist.initialize("10.0.0.1:1234", num_processes=4, process_id=2,
                           device="cpu") is True
    assert calls == [{"backend": "gloo", "init": "tcp://10.0.0.1:1234",
                      "n": 4, "rank": 2}]


@pytest.mark.parametrize("env", [
    {"JAX_COORDINATOR_ADDRESS": "envhost:99"},
    {"MASTER_ADDR": "envhost", "MASTER_PORT": "99", "WORLD_SIZE": "3",
     "RANK": "1"}])
def test_initialize_env_coordinator(monkeypatch, env):
    calls = []
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(dist, "_init_process_group", _fake(calls))
    assert dist.initialize(device="cpu") is True
    assert calls[0]["init"] == "tcp://envhost:99"
    if "WORLD_SIZE" in env:
        assert (calls[0]["n"], calls[0]["rank"]) == (3, 1)


def test_initialize_defaults_to_the_gpu(monkeypatch):
    """No GPU here: a rendezvous for the default device raises, it does
    not fall back to gloo on the CPU."""
    calls = []
    monkeypatch.setattr(dist, "_init_process_group", _fake(calls))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist.initialize("h:1", 2, 0)
    assert calls == []


def test_global_mesh_axes():
    mesh = dist.global_mesh(device="cpu")
    assert mesh.shape == {MeshAxes.DATA: 1}
    assert mesh.size == 1 and mesh.rank == 0


def test_global_mesh_rejects_bad_split(monkeypatch):
    monkeypatch.setattr(dist, "process_count", lambda: 8)
    with pytest.raises(ValueError, match="not divisible"):
        dist.global_mesh(model_parallel=3, device="cpu")


def test_local_batch_slice_single_process():
    s = dist.local_batch_slice(32)
    assert (s.start, s.stop) == (0, 32)


def test_local_batch_slice_multi_process(monkeypatch):
    monkeypatch.setattr(dist, "process_count", lambda: 4)
    shards = []
    for i in range(4):
        monkeypatch.setattr(dist, "process_index", lambda i=i: i)
        shards.append(dist.local_batch_slice(32))
    covered = np.concatenate([np.arange(s.start, s.stop) for s in shards])
    assert (covered == np.arange(32)).all()


def test_local_batch_slice_rejects_ragged(monkeypatch):
    monkeypatch.setattr(dist, "process_count", lambda: 4)
    with pytest.raises(ValueError, match="not divisible"):
        dist.local_batch_slice(30)


def test_initialize_retries_transient_then_succeeds(monkeypatch):
    calls, delays = [], []
    monkeypatch.setattr(dist, "_init_process_group", _fake(calls, fail=2))
    monkeypatch.setattr(dist, "_sleep", delays.append)
    with telemetry.enabled() as sess:
        assert dist.initialize("10.0.0.1:1234", num_processes=2,
                               process_id=1, device="cpu") is True
        fault = sess.summary()["fault"]
    assert [c["init"] for c in calls] == ["tcp://10.0.0.1:1234"] * 3
    assert delays == [0.5, 1.0]
    assert fault["retries"] == 2


def test_initialize_backoff_is_capped(monkeypatch):
    delays = []
    monkeypatch.setattr(dist, "_init_process_group",
                        _fake([], fail=99, exc=ConnectionError("refused")))
    monkeypatch.setattr(dist, "_sleep", delays.append)
    with pytest.raises(RuntimeError):
        dist.initialize("h:1", max_retries=6, backoff_base_s=1.0,
                        backoff_cap_s=4.0, device="cpu")
    assert delays == [1.0, 2.0, 4.0, 4.0, 4.0, 4.0]


def test_initialize_exhausted_error_names_coordinator(monkeypatch):
    monkeypatch.setattr(dist, "_init_process_group",
                        _fake([], fail=99, exc=RuntimeError("UNAVAILABLE")))
    monkeypatch.setattr(dist, "_sleep", lambda s: None)
    with pytest.raises(RuntimeError) as ei:
        dist.initialize("badhost:4321", num_processes=4, max_retries=2,
                        device="cpu")
    msg = str(ei.value)
    assert "badhost:4321" in msg
    assert "3 attempt(s)" in msg
    assert "num_processes (4)" in msg
    assert "rank-0 process" in msg
    assert isinstance(ei.value.__cause__, RuntimeError)


def test_initialize_nonretryable_raises_immediately(monkeypatch):
    calls = []
    monkeypatch.setattr(dist, "_init_process_group",
                        _fake(calls, fail=99,
                              exc=ValueError("rank out of range")))
    monkeypatch.setattr(dist, "_sleep",
                        lambda s: pytest.fail("must not sleep"))
    with pytest.raises(ValueError, match="out of range"):
        dist.initialize("h:1", device="cpu")
    assert len(calls) == 1


def test_single_process_merges_are_identities():
    """With no process group the evaluation merge and the row gather are
    the local values, dtype kept."""
    from deeplearning4j_tpu_torch.eval import Evaluation
    ev = Evaluation(num_classes=2)
    ev.eval(np.eye(2)[[0, 1]], np.eye(2)[[0, 0]], meta_data=["a", "b"])
    assert dist.allreduce_evaluation(ev) is ev
    rows = np.arange(3, dtype=np.float32)
    out = dist.allgather_rows(rows)
    assert out.dtype == np.float32 and (out == rows).all()
