"""PyTorch port, the elastic trainer (`parallel/elastic.py`) on the CPU:
the twins of `tests/test_elastic.py`'s trainer and protocol cases (its
coordinated-store cases are twinned in `test_torch_parallel_loop.py`), and
real multi-process drills on worlds of 2 gloo ranks: a worker killed at an
exact step (the survivor re-forms the world and resumes from the last
edge), and a SIGTERM drain at an edge, then a new generation's resume.

JAX's single-process emulation (one process plays every worker) is the
port's `emulated=True`: the protocol (leases, two-phase commits of every
live worker's shards, drains, resizes) runs in full, on the process's one
rank. Resume and resize are held bit-exact against the port's own
uninterrupted or live-switched trainer; the uninterrupted run against
JAX's emulated ElasticTrainer at 1e-4 (a trajectory on another device
count). Each drill runs in its own processes with a 60 s limit and a
short gloo timeout, so a hang fails fast.
"""
import json
import multiprocessing as mp
import os

import numpy as np
import pytest

import deeplearning4j_tpu as jx
from deeplearning4j_tpu_torch import telemetry
from deeplearning4j_tpu_torch.parallel import (CoordinatedCheckpoint,
                                               DrainSignal, ElasticTrainer,
                                               HeartbeatLease,
                                               ParallelTrainer,
                                               ShardingStrategy, make_mesh,
                                               surviving_mesh_shape)
from deeplearning4j_tpu_torch.parallel.elastic import _strategy_for_shape
from torch_threads import one_torch_thread, pinned  # noqa: F401
import torch_mp_tasks as mp_tasks
import torch_parallel_tasks as tasks

CONF = None


def _conf(lib=jx, seed=7):
    return (lib.NeuralNetConfiguration.builder().seed(seed)
            .updater(lib.Adam(1e-2)).list()
            .layer(lib.DenseLayer(n_out=16, activation="tanh"))
            .layer(lib.OutputLayer(n_out=4, loss="mcxent"))
            .set_input_type(lib.InputType.feed_forward(8)).build())


def _start():
    """The JAX model's configuration JSON and start parameters (one draw
    for every test)."""
    global CONF
    if CONF is None:
        from jax_reference import jax_init
        from deeplearning4j_tpu.nn.multilayer import \
            MultiLayerNetwork as JaxNet
        jnet = jax_init(JaxNet(_conf()))
        CONF = (jnet.conf.to_json(), np.asarray(jnet.params_flat()))
    return CONF


def _model():
    conf, start = _start()
    return tasks.build(conf, start)


def _batches(n=8, b=16):
    return mp_tasks.elastic_batches(n, b)


def _trainer(strategy=ShardingStrategy.ZERO1):
    return ParallelTrainer(_model(), mesh=make_mesh(device="cpu"),
                           strategy=strategy)


def _flat(trainer):
    return np.asarray(trainer.publish_view().params_flat())


def _elastic(path, **kw):
    base = dict(mesh_shape=(8, 1), strategy=ShardingStrategy.ZERO1,
                n_workers=2, emulated=True, snapshot_every=2, device="cpu")
    base.update(kw)
    return ElasticTrainer(_model, path, **base)


def test_surviving_mesh_shape_and_downgrade():
    assert surviving_mesh_shape(16, (2, 2, 2)) == (4, 2, 2)
    assert surviving_mesh_shape(6, (1, 4, 1)) == (3, 2, 1)
    with pytest.raises(ValueError, match="at least one"):
        surviving_mesh_shape(0, (2, 2))
    with pytest.raises(ValueError, match="must be"):
        surviving_mesh_shape(4, (2, 2, 2, 2))
    assert (_strategy_for_shape(ShardingStrategy.ZERO1_TP_PP, (4, 2, 1))
            == (ShardingStrategy.ZERO1_TP, (4, 2)))
    assert (_strategy_for_shape(ShardingStrategy.PP, (8, 1, 1))
            == (ShardingStrategy.REPLICATED, (8, 1)))
    assert (_strategy_for_shape(ShardingStrategy.ZERO1_TP_PP, (1, 2, 4))
            == (ShardingStrategy.ZERO1_TP_PP, (1, 2, 4)))


def test_heartbeat_lease_expiry_and_resign(tmp_path):
    now = [100.0]
    clock = lambda: now[0]
    a = HeartbeatLease(tmp_path, 0, ttl_s=5.0, clock=clock)
    b = HeartbeatLease(tmp_path, 1, ttl_s=5.0, clock=clock)
    a.renew()
    b.renew()
    assert a.active_workers() == [0, 1]
    assert a.lost_workers([0, 1, 2]) == [2]
    now[0] += 4.0
    b.renew()
    now[0] += 2.0
    assert a.active_workers() == [1]
    assert b.lost_workers([0, 1]) == [0]
    a.renew()
    assert b.lost_workers([0, 1]) == []
    b.resign()
    assert a.active_workers() == [0]
    (tmp_path / "lease_p3.json").write_text("{half a js")
    assert a.ages()[3] == float("inf")
    assert a.lost_workers([3]) == [3]


def test_drain_signal_first_writer_wins(tmp_path):
    d = DrainSignal(tmp_path)
    assert d.target_edge() is None
    assert d.request(6, worker_id=1) == 6
    assert d.request(9, worker_id=0) == 6
    assert d.target_edge() == 6
    d.clear()
    assert d.target_edge() is None


def test_coordinated_checkpoint_gc_and_fallback(tmp_path, one_torch_thread):
    tr = _trainer()
    batches = _batches()
    ck = CoordinatedCheckpoint(tmp_path, n_workers=2, keep=2)
    saved = []
    for i in range(4):
        tr.fit(batches[i])
        saved.append(ck.save(tr, emulate_workers=[0, 1]))
    assert saved == [1, 2, 3, 4]
    assert ck.steps() == [3, 4]
    want = _flat(tr)
    blob = tmp_path / "step_000000004" / "shards_p0.bin"
    blob.write_bytes(b"\x00" * blob.stat().st_size)
    tr2 = _trainer()
    assert ck.restore(tr2) == 3
    assert tr2.iteration_count == 3
    tr2.fit(batches[3])
    np.testing.assert_array_equal(_flat(tr2), want)
    assert ck.meta(3)["n_workers"] == 2


def test_elastic_trainer_completes_and_matches_uninterrupted(
        tmp_path, one_torch_thread):
    """Bit-equal to a plain trainer on the same batches; a restart from
    the directory trains nothing and restores the same state; and 1e-4 of
    JAX's emulated ElasticTrainer on its (8, 1) mesh."""
    batches = _batches()
    et = _elastic(tmp_path / "run")
    assert et.fit(batches, 6) == "completed"
    assert et.trainer.iteration_count == 6
    assert et.checkpoint.latest_step() == 6
    ref = _trainer()
    for i in range(6):
        ref.fit(batches[i])
    np.testing.assert_array_equal(_flat(et.trainer), _flat(ref))
    et2 = _elastic(tmp_path / "run")
    assert et2.fit(batches, 6) == "completed"
    np.testing.assert_array_equal(_flat(et2.trainer), _flat(ref))
    from deeplearning4j_tpu.parallel import ElasticTrainer as JaxElastic
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
    from deeplearning4j_tpu.nn.conf import MultiLayerConfiguration as JMC
    conf, start = _start()

    def jmodel():
        net = JaxNet(JMC.from_json(conf)).init()
        net.set_params_flat(start)
        return net
    jb = [jx.DataSet(np.asarray(b.features), np.asarray(b.labels))
          for b in batches]
    je = JaxElastic(jmodel, str(tmp_path / "jax"), mesh_shape=(8, 1),
                    strategy="zero1", n_workers=2, emulated=True,
                    snapshot_every=2)
    assert je.fit(jb, 6) == "completed"
    np.testing.assert_allclose(
        _flat(et.trainer), np.asarray(je.trainer.publish_view()
                                      .params_flat()), rtol=1e-4,
        atol=1e-5)


def test_elastic_trainer_loss_resize_then_rejoin(tmp_path, one_torch_thread):
    """Worker loss: the stale lease is noticed, the world resizes 4 -> 2
    workers ((8, 1) -> (4, 1)), the last edge is restored and training
    resumes bit-equal to a live-switch control; the rejoin resizes back.
    Telemetry counts each transition."""
    batches = _batches(n=10)
    with telemetry.enabled() as sess:
        et = _elastic(tmp_path / "run", n_workers=4)
        assert et.fit(batches, 4) == "completed"
        assert et.mesh_shape == (8, 1)
        tree, meta = et.trainer.elastic_state()
        et.mark_worker_lost(2)
        et.mark_worker_lost(3)
        assert et.fit(batches, 6) == "completed"
        assert et.mesh_shape == (4, 1)
        assert len(et._live) == 2
        ctrl = _trainer()
        ctrl.load_elastic_state(tree, meta)
        for i in range(4, 6):
            ctrl.fit(batches[i])
        np.testing.assert_array_equal(_flat(et.trainer), _flat(ctrl))
        et.mark_worker_joined(2)
        et.mark_worker_joined(3)
        assert et.fit(batches, 8) == "completed"
        assert et.mesh_shape == (8, 1)
        for i in range(6, 8):
            ctrl.fit(batches[i])
        np.testing.assert_array_equal(_flat(et.trainer), _flat(ctrl))
        summary = sess.summary()["elastic"]
    assert summary["worker_losses"] == 2
    assert summary["rejoins"] == 2
    assert summary["resizes"] == 2
    assert summary["snapshots"] > 0


def test_elastic_trainer_drain_lands_common_edge(tmp_path, one_torch_thread):
    batches = _batches()
    with telemetry.enabled() as sess:
        et = _elastic(tmp_path / "run", snapshot_every=3)
        assert et.fit(batches, 2) == "completed"
        et._preempted = True
        assert et.fit(batches, 8) == "drained"
        assert et.trainer.iteration_count == 3
        assert et.drain.target_edge() == 3
        assert (et.checkpoint.meta(3) or {}).get("drained") is True
        drains = sess.summary()["elastic"]["drains"]
    assert drains == 1
    et2 = _elastic(tmp_path / "run", snapshot_every=3)
    assert et2.fit(batches, 8) == "completed"
    assert et2.drain.target_edge() is None
    ref = _trainer()
    for i in range(8):
        ref.fit(batches[i])
    np.testing.assert_array_equal(_flat(et2.trainer), _flat(ref))


def test_elastic_trainer_worker_lost_exit_on_commit_timeout(
        tmp_path, one_torch_thread):
    """A snapshot whose peer never lands times out into
    ElasticWorkerLost: a clean "worker_lost" exit, nothing torn."""
    import deeplearning4j_tpu_torch.parallel.elastic as el
    batches = _batches()
    et = ElasticTrainer(_model, tmp_path / "run", mesh_shape=(4, 1),
                        strategy=ShardingStrategy.ZERO1, n_workers=2,
                        worker_id=0, emulated=False, snapshot_every=1,
                        commit_timeout_s=0.3, lease_ttl_s=60.0,
                        device="cpu")
    et.lease.renew(1)
    et._announce(0)
    el.atomic_replace(os.path.join(et.lease.directory, "ann_p1.json"),
                      json.dumps({"worker": 1, "step": 99}).encode())
    with telemetry.enabled() as sess:
        assert et.fit(batches, 1) == "worker_lost"
        assert sess.summary()["elastic"]["worker_losses"] == 1
    assert et.checkpoint.latest_step() is None
    assert et.lease.lost_workers([0]) == [0]


def test_count_elastic_rejects_unknown_event():
    from deeplearning4j_tpu_torch.fault.metrics import count_elastic
    with pytest.raises(ValueError, match="unknown elastic event"):
        count_elastic("bogus")


# ----------------------------------------------------------------------
# real multi-process drills
# ----------------------------------------------------------------------
def _run_drill(directory, n_steps, fault=None, world=2):
    conf, start = _start()
    os.makedirs(directory, exist_ok=True)
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=mp_tasks.elastic_drill,
                         args=(r, world, str(directory),
                               conf, start, n_steps, fault, out),
                         daemon=True)
             for r in range(world)]
    with pinned():
        for p in procs:
            p.start()
    got = {}
    try:
        alive = world - (fault is not None and fault[1] == "kill_at_step")
        for _ in range(alive):
            rank, status, it, flat, shape = out.get(timeout=60)
            got[rank] = (status, it, np.asarray(flat, np.float32), shape)
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
    return got, [p.exitcode for p in procs]


def test_drill_worker_killed_survivor_resizes_and_resumes(tmp_path):
    """Worker 1 dies (os._exit) at step 3 of 6: worker 0 finds it missing
    at the step barrier, re-forms a world of one, restores the step-3
    snapshot and completes on (1, 1), bit-equal to a one-rank trainer
    that loads the same snapshot and trains steps 3..5."""
    got, codes = _run_drill(tmp_path / "run", 6, fault=(1, "kill_at_step",
                                                        3))
    assert codes[1] == 137
    status, it, flat, shape = got[0]
    assert (status, it, tuple(shape)) == ("completed", 6, (1, 1))
    store = CoordinatedCheckpoint(tmp_path / "run" / "steps",
                                  n_workers=2)._store(3)
    ref = _trainer(ShardingStrategy.REPLICATED)
    ref.load_elastic_state(store.read_tree({
        "params": ref.model.params, "state": ref.model.state,
        "updater_state": ref.model.updater_state}), store.read_meta())
    assert ref.iteration_count == 3
    b = _batches(n=8)
    for i in range(3, 6):
        ref.fit(b[i])
    np.testing.assert_array_equal(flat, _flat(ref))


def test_drill_sigterm_drain_then_resume_bit_equal(tmp_path):
    """SIGTERM to worker 1 at step 2: both workers drain at the edge (step
    2 trained, one coordinated snapshot), exit "drained"; a new
    generation of 2 workers resumes there and completes 5 steps, bit-equal
    to an uninterrupted 2-worker run."""
    got, _ = _run_drill(tmp_path / "run", 5, fault=(1, "sigterm_at_step",
                                                    2))
    assert {r: g[0] for r, g in got.items()} == {0: "drained",
                                                 1: "drained"}
    assert all(g[1] == 2 for g in got.values())
    resumed, _ = _run_drill(tmp_path / "run", 5)
    ref, _ = _run_drill(tmp_path / "ref", 5)
    for r in (0, 1):
        assert resumed[r][:2] == ("completed", 5)
        np.testing.assert_array_equal(resumed[r][2], ref[r][2])
