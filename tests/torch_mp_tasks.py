"""The rank side of the port's model-parallel tests: functions a
`torch_world` World runs on each rank (`fn(ctx, *args)`). They build their
own mesh (data, model, pipe axes) over the task's ranks, import only
torch and the port, and take and return numpy arrays, configuration JSON
and plain values, so the parent test compares them with JAX's results."""
import numpy as np
import torch

import deeplearning4j_tpu_torch as pt
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.parallel import ParallelTrainer, make_mesh
from torch_parallel_tasks import _datasets, _opt_flat, build


def mesh_of(ctx, axes):
    """A mesh of `axes` over the first ranks of the world. Every rank of
    the world calls it (the tests run these tasks with `every=True`):
    making the mesh's axis groups is a call of the whole world. None on a
    rank outside the mesh."""
    n = int(np.prod(list(axes.values())))
    mesh = make_mesh(dict(axes), devices=list(range(n)), device="cpu")
    return mesh if ctx.rank < n else None


def train_mesh(ctx, conf_json, flat, batches, axes, kw=None, fit=None,
               evaluate=None):
    """Train a fresh model on a mesh of `axes` with ParallelTrainer(**kw),
    one fit(DataSet) per batch (or one iterator fit with `fit`); returns
    the published params, updater state, score and, with `evaluate` (x,
    y), the trainer's score and accuracy of that batch."""
    kw = dict(kw or {})
    graph = kw.pop("graph", False)
    mesh = mesh_of(ctx, axes)
    if mesh is None:
        return None
    net = build(conf_json, flat, graph)
    tr = ParallelTrainer(net, mesh=mesh, **kw)
    dss = _datasets(batches)
    scores = []
    if fit is None:
        for ds in dss:
            tr.fit(ds)
            scores.append(tr.score())
    else:
        fit = dict(fit)
        epochs = fit.pop("epochs", 1)
        tr.fit(ListDataSetIterator(dss), epochs=epochs, **fit)
    out = {"params": net.params_flat(), "opt": _opt_flat(net),
           "score": tr.score(), "scores": scores,
           "iters": tr.iteration_count,
           "state": _state_flat(net), "flash": tr.flash_mode}
    if evaluate is not None:
        ds = pt.DataSet(*evaluate)
        out["eval_score"] = tr.score(ds)
        out["accuracy"] = tr.evaluate(ds).accuracy()
    if tr._tp is not None:
        out["local_numel"] = int(sum(a.numel() for a in _leaves(tr._params)))
    return out


def _leaves(tree):
    from deeplearning4j_tpu_torch.nn.trees import flat_leaves
    return [a for a in flat_leaves(tree) if isinstance(a, torch.Tensor)]


def _state_flat(net):
    leaves = _leaves(net.state)
    if not leaves:
        return np.zeros(0, np.float32)
    return np.concatenate([a.detach().float().reshape(-1).numpy()
                           for a in leaves])


def mesh_facts(ctx, axes):
    """Coordinates, axis ranks and axis-group sizes of this rank."""
    import torch.distributed as dist
    m = mesh_of(ctx, axes)
    if m is None:
        return None
    return {"coords": m.coords(),
            "ranks": {a: list(m.axis_ranks(a)) for a in m.axis_names},
            "sizes": {a: dist.get_world_size(m.axis_group(a))
                      for a in m.axis_names}}


def tp_collectives(ctx, m_size):
    """copy_to_tp / reduce_from_tp forward and backward over a model
    group of m_size ranks."""
    from deeplearning4j_tpu_torch.parallel.tp import (copy_to_tp,
                                                      reduce_from_tp)
    mesh = mesh_of(ctx, {"model": m_size})
    if mesh is None:
        return None
    from deeplearning4j_tpu_torch.parallel.tp import TPContext
    tp = TPContext(mesh.axis_group("model"), m_size,
                   mesh.axis_index("model"))
    r = mesh.axis_index("model")
    x = torch.full((3,), float(r + 1), requires_grad=True)
    y = reduce_from_tp(x * 2.0, tp)
    y.sum().backward()
    z = torch.ones(2, requires_grad=True)
    w = copy_to_tp(z, tp) * float(r + 1)
    w.sum().backward()
    return {"y": y.detach().numpy(), "dx": x.grad.numpy(),
            "dz": z.grad.numpy()}


def split_bn(ctx, x, gamma, beta, dy, width):
    """Global-batch BN + ReLU of this rank's rows through the split path
    (plain versions on the CPU): y, stats, dx of its rows and its dgamma,
    dbeta partials."""
    from deeplearning4j_tpu_torch.kernels.bn_split import split_bn_relu
    from deeplearning4j_tpu_torch.parallel.collectives import BatchGroup
    mesh = mesh_of(ctx, {"data": width})
    if mesh is None:
        return None
    r = mesh.axis_index("data")
    rows = np.array_split(np.arange(x.shape[0]), width)[r]
    xt = torch.tensor(x[rows], requires_grad=True)
    g = torch.tensor(gamma, requires_grad=True)
    b = torch.tensor(beta, requires_grad=True)
    y, mean, var = split_bn_relu(xt, g, b, 1e-5,
                                 BatchGroup(mesh.axis_group("data"), width))
    y.backward(torch.tensor(dy[rows]))
    return {"y": y.detach().numpy(), "mean": mean.numpy(),
            "var": var.numpy(), "dx": xt.grad.numpy(),
            "dg": g.grad.numpy(), "db": b.grad.numpy()}


def ring(ctx, q, k, v, causal, width):
    """Ring attention over a sequence group of `width` ranks: this rank's
    output rows and the gradients of its q, k, v blocks (of sum(out * g),
    g = ones)."""
    from deeplearning4j_tpu_torch.parallel.ring_attention import \
        ring_self_attention
    mesh = mesh_of(ctx, {"seq": width})
    if mesh is None:
        return None
    r = mesh.axis_index("seq")
    T = q.shape[1] // width
    sl = slice(r * T, (r + 1) * T)
    qt, kt, vt = (torch.tensor(a[:, sl], requires_grad=True)
                  for a in (q, k, v))
    out = ring_self_attention(qt, kt, vt, mesh, axis="seq", causal=causal)
    out.sum().backward()
    return {"out": out.detach().numpy(), "dq": qt.grad.numpy(),
            "dk": kt.grad.numpy(), "dv": vt.grad.numpy()}


def jax_params_to_shards(ctx, conf_json, params, opt, axes, strategy,
                         batch, zip_path):
    """JAX's global parameters and updater state (numpy trees) through
    `from_jax_params` into each rank's layout under `strategy`: this
    rank's shards as numpy, then one step, the published view written to
    `zip_path` by rank 0."""
    from deeplearning4j_tpu_torch import from_jax_params
    from deeplearning4j_tpu_torch.nn.trees import tree_map
    mesh = mesh_of(ctx, axes)
    if mesh is None:
        return None
    net = build(conf_json)
    from_jax_params(net, params, opt)
    tr = ParallelTrainer(net, mesh=mesh, strategy=strategy)
    shards = tree_map(lambda a: a.detach().numpy().copy()
                      if isinstance(a, torch.Tensor) else a, tr._params)
    tr.fit(pt.DataSet(*batch))
    view = tr.publish_view()
    if ctx.rank == 0:
        pt.ModelSerializer.write_model(view, zip_path)
    return {"shards": shards, "coords": mesh.coords(),
            "flat": view.params_flat()}


def elastic_batches(n=8, b=16):
    """The elastic tests' batches: n seeded [b, 8] rows, 4 classes."""
    r = np.random.default_rng(0)
    return [pt.DataSet(r.normal(size=(b, 8)).astype(np.float32),
                       np.eye(4, dtype=np.float32)[r.integers(0, 4, b)])
            for _ in range(n)]


def elastic_drill(rank, world, directory, conf, start, n_steps, fault, out):
    """One worker of a drill: a gloo world over a file store, an
    ElasticTrainer over it, the fault armed at its step; the worker's
    status, step and parameters into `out`."""
    import datetime
    import os
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.fault import injection
    from deeplearning4j_tpu_torch.parallel import ElasticTrainer
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(directory, "world_g0"),
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=20))
    if fault is not None and fault[0] == rank:
        getattr(injection, fault[1])(fault[2])
    et = ElasticTrainer(lambda: build(conf, start), directory,
                        mesh_shape=(world, 1), snapshot_every=1, keep=10,
                        lease_ttl_s=3.0, commit_timeout_s=20.0,
                        device="cpu", timeout_s=20.0)
    status = et.fit(elastic_batches(8), n_steps)
    out.put((rank, status, et.trainer.iteration_count,
             np.asarray(et.trainer.publish_view().params_flat()).tolist(),
             et.mesh_shape))
    if dist.is_initialized():
        dist.destroy_process_group()


def pp_accumulation(ctx, conf_json, flat, batches):
    """PP on 2 pipe ranks: the trainer's grad_accumulation=2 over the
    batches, and the same groups through `make_pp_accum_superstep` (one
    M = 2 schedule a group); both parameter vectors."""
    from deeplearning4j_tpu_torch.parallel import (PipelinePlan,
                                                   make_pp_accum_superstep)
    mesh = mesh_of(ctx, {"data": 1, "model": 1, "pipe": 2})
    if mesh is None:
        return None
    net = build(conf_json, flat)
    tr = ParallelTrainer(net, mesh=mesh, strategy="pp")
    tr.fit(ListDataSetIterator(_datasets(batches)), grad_accumulation=2)
    out = {"trainer": net.params_flat()}
    net2 = build(conf_json, flat)
    plan = PipelinePlan(net2, mesh)
    fn, _ = make_pp_accum_superstep(net2, plan)
    loc = lambda t: plan.to_local(t)
    tensors = [tuple(torch.tensor(a) for a in b) + (None, None)
               for b in batches]
    groups = [tensors[i:i + 2] for i in range(0, len(tensors), 2)]
    params, state, opt, _ = fn(loc(net2.params), loc(net2.state),
                               loc(net2.updater_state), 0, groups)
    net2.params = plan.from_local(params)
    out["schedule"] = net2.params_flat()
    return out


def flash_spmd(ctx, q, k, v, causal, axes):
    """`flash_attention_spmd` over a (data, model) mesh: the global
    output and the gradients of sum(sin(out)) w.r.t. q, k, v (the same
    on every rank)."""
    from deeplearning4j_tpu_torch.kernels.attention import \
        flash_attention_spmd
    mesh = mesh_of(ctx, axes)
    if mesh is None:
        return None
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = flash_attention_spmd(qt, kt, vt, causal, mesh=mesh)
    torch.sin(out).sum().backward()
    return {"out": out.detach().numpy(), "dq": qt.grad.numpy(),
            "dk": kt.grad.numpy(), "dv": vt.grad.numpy()}
