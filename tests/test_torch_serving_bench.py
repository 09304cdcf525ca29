"""PyTorch port, the serving benches' plumbing on the CPU at a small size
(the numbers come from the card, `chip_smoke.py`): the closed-loop helper,
`run_serving_bench` (batched against direct, one build per bucket), the
swap under load, and `run_decode_bench` (continuous against static
batching of generation, a swap mid-window, one step build per phase and
bucket). Each is checked for its verdicts, not its speed; the JAX
package's `_closed_loop` drives the same callable beside the port's.
"""
import numpy as np
import pytest

from deeplearning4j_tpu.serving.bench import _closed_loop as jax_closed_loop
from deeplearning4j_tpu_torch.serving import InferenceServer, ModelRegistry
from deeplearning4j_tpu_torch.serving.bench import (_closed_loop,
                                                    _make_mlp128,
                                                    _swap_under_load,
                                                    run_serving_bench)
from deeplearning4j_tpu_torch.serving.decode.bench import run_decode_bench
from deeplearning4j_tpu_torch.util.serializer import ModelSerializer
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.sanitize(
    allow_threads=("dl4j-decode-sched-", "dl4j-torch-serving-http"))


def _row(i):
    return np.random.default_rng(i).normal(size=(1, 784)).astype(np.float32)


@pytest.mark.parametrize("closed_loop", [_closed_loop, jax_closed_loop],
                         ids=["port", "jax"])
def test_closed_loop_helper(closed_loop):
    reg = ModelRegistry(buckets=(1, 4), device="cpu")
    reg.register("m", _make_mlp128("cpu"))
    srv = InferenceServer(reg, max_wait_us=500)
    try:
        res = closed_loop(lambda x: srv.predict("m", x), 4, 10, _row)
    finally:
        srv.stop()
    assert res["req_s"] > 0 and res["p99_ms"] >= res["p50_ms"]
    assert "errors" not in res


def test_run_serving_bench_verdicts():
    out = run_serving_bench(clients=(1, 4), requests_per_client=8,
                            buckets=(1, 4), models=("mlp128",),
                            pairs_at_top=1, swap_check=False, device="cpu")
    m = out["mlp128"]
    assert m["one_compile_per_bucket"], m["compiles_per_bucket"]
    assert m["batched_vs_unbatched_speedup"] is not None
    for arm in ("batched", "unbatched"):
        assert m["4"][arm]["req_s"] > 0 and "errors" not in m["4"][arm]
    assert out["speedup_at_max_clients"]["mlp128"] \
        == m["batched_vs_unbatched_speedup"]


def test_swap_under_load_no_failures(tmp_path):
    reg = ModelRegistry(buckets=(1, 4), device="cpu")
    reg.register("m", _make_mlp128("cpu"))
    ckpt = str(tmp_path / "swap.zip")
    ModelSerializer.write_model(_make_mlp128("cpu"), ckpt)
    srv = InferenceServer(reg, max_wait_us=500)
    try:
        res = _swap_under_load(srv, reg, "m", ckpt, n_clients=4,
                               n_requests=30)
        # the swap landed (clients may all have finished before it did)
        assert srv.predict("m", _row(0), batched=True)[1] == 2
    finally:
        srv.stop()
    assert res["failed"] == 0, res["errors"]
    assert res["versions_monotonic"]
    assert set(res["versions_seen"]) <= {1, 2}


def test_run_decode_bench_verdicts():
    out = run_decode_bench(n_clients=3, requests_per_client=1, pairs=1,
                           block_len=4, decode_buckets=(1, 2, 4),
                           device="cpu")
    assert out["failed_requests"] == 0
    assert out["swap_under_generation"]["failed"] == 0
    assert out["one_compile_per_phase_bucket"], \
        out["compiles_per_phase_bucket"]
    assert out["continuous_vs_static"] is not None
    (pair,) = out["windows"]
    for mode in ("continuous", "static"):
        assert pair[mode]["requests"] == 3 and pair[mode]["failed"] == 0
    assert out["tick_captures"] == {}      # the CPU runs its ticks eagerly
