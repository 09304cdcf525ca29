"""The rank side of the port's parallel tests: functions a `torch_world`
World runs on each rank (`fn(ctx, *args)`, ctx.mesh a data-axis mesh of
the task's width). They import only torch and the port, and take and
return numpy arrays, configuration JSON and plain values, so the parent
test compares them with JAX's results."""
import numpy as np

import deeplearning4j_tpu_torch as pt
from deeplearning4j_tpu_torch.datasets.iterators import (ListDataSetIterator,
                                                         MultiDataSet)
from deeplearning4j_tpu_torch.parallel import ParallelTrainer


def build(conf_json, flat=None, graph=False):
    """A port model from its configuration JSON and flat parameters."""
    if graph:
        from deeplearning4j_tpu_torch.nn.conf.graph import \
            ComputationGraphConfiguration
        net = pt.ComputationGraph(
            ComputationGraphConfiguration.from_json(conf_json),
            device="cpu").init()
    else:
        from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
        net = pt.MultiLayerNetwork(MultiLayerConfiguration.from_json(
            conf_json), device="cpu").init()
    if flat is not None:
        net.set_params_flat(np.asarray(flat))
    return net


def _datasets(batches):
    out = []
    for b in batches:
        if isinstance(b, dict) and "features" in b and isinstance(
                b["features"], list):
            out.append(MultiDataSet(**b))
        else:
            out.append(pt.DataSet(*b))
    return out


def _opt_flat(net):
    from deeplearning4j_tpu_torch.nn.trees import flat_leaves
    leaves = flat_leaves(net.updater_state)
    if not leaves:
        return np.zeros(0, np.float32)
    return np.concatenate([a.detach().float().reshape(-1).numpy()
                           for a in leaves])


def train(ctx, conf_json, flat, batches, kw=None, fit=None):
    """Train a fresh model on `batches` (a list of (x, y[, fm, lm]) global
    batches) with ParallelTrainer(**kw): one fit(DataSet) per batch, or
    with `fit` (a dict of fit kwargs plus "epochs", "batch") one iterator
    fit. Returns params, updater state, last score, iteration count."""
    kw = dict(kw or {})
    graph = kw.pop("graph", False)
    net = build(conf_json, flat, graph)
    tr = ParallelTrainer(net, mesh=ctx.mesh, **kw)
    dss = _datasets(batches)
    if fit is None:
        for ds in dss:
            tr.fit(ds)
    else:
        fit = dict(fit)
        epochs = fit.pop("epochs", 1)
        tr.fit(ListDataSetIterator(dss), epochs=epochs, **fit)
    return {"params": net.params_flat(), "opt": _opt_flat(net),
            "score": tr.score(), "iters": tr.iteration_count,
            "info": tr.collective_accounting()}


def unequal_lockstep(ctx, conf_json, flat, batches):
    """Every rank holds a different number of validation batches (its own
    shard files): score, score_examples and evaluate still agree."""
    from deeplearning4j_tpu_torch.datasets.export import LocalShardDataSet
    net = build(conf_json, flat)
    tr = ParallelTrainer(net, mesh=ctx.mesh)
    mine = [LocalShardDataSet(*b) for i, b in enumerate(batches)
            if i % ctx.mesh.size == ctx.mesh.rank]
    if ctx.mesh.rank == 0:
        mine = mine + mine[:1]       # rank 0 has one batch more
    it = ListDataSetIterator(mine)
    return {"score": tr.score(it), "examples": tr.score_examples(it),
            "n_examples": tr.evaluate(it).num_examples()}


def allgather_dtypes(ctx):
    """allgather_rows keeps the input dtype, an empty share included."""
    from deeplearning4j_tpu_torch.parallel import allgather_rows
    r = ctx.mesh.rank
    local = (np.zeros(0, np.float32) if r == 1
             else np.arange(3, dtype=np.float32) + 10 * r)
    out = allgather_rows(local, ctx.mesh.group)
    ints = allgather_rows(np.arange(2, dtype=np.int64) + r, ctx.mesh.group)
    return {"rows": out, "dtype": str(out.dtype), "ints": ints,
            "int_dtype": str(ints.dtype)}


def evaluation_keeps_predictions(ctx):
    """allreduce_evaluation merges counts and keeps this rank's
    per-example records."""
    from deeplearning4j_tpu_torch.eval import Evaluation
    from deeplearning4j_tpu_torch.parallel import allreduce_evaluation
    r = ctx.mesh.rank
    ev = Evaluation(num_classes=3)
    labels = np.eye(3)[[r, r, 2]]
    preds = np.eye(3)[[r, 2, 2]]
    ev.eval(labels, preds, meta_data=[f"r{r}-{i}" for i in range(3)])
    merged = allreduce_evaluation(ev, ctx.mesh.group)
    return {"n": merged.num_examples(),
            "meta": [p.meta for p in merged.predictions],
            "matrix": merged.confusion.matrix.copy()}


def checkpoint_resume(ctx, conf_json, flat, batches, kw, ckpt_dir,
                      crash_at, superstep=1):
    """Kill mid-sharded-save at the `crash_at`-th save, resume, and
    return the resumed run's params and updater state; a second fresh
    model trains uninterrupted for the reference."""
    from deeplearning4j_tpu_torch.fault import SimulatedCrash
    from deeplearning4j_tpu_torch.fault.injection import crash_at_write

    dss = _datasets(batches)
    ref = build(conf_json, flat)
    ParallelTrainer(ref, mesh=ctx.mesh, **kw).fit(
        ListDataSetIterator(dss), superstep=superstep)
    net = build(conf_json, flat)
    tr = ParallelTrainer(net, mesh=ctx.mesh, **kw)
    crashed = False
    with crash_at_write("sharded/tree_written", nth=crash_at):
        try:
            tr.fit(ListDataSetIterator(dss), superstep=superstep,
                   checkpoint_dir=ckpt_dir, checkpoint_every=2)
        except SimulatedCrash:
            crashed = True
    net2 = build(conf_json, flat)
    tr2 = ParallelTrainer(net2, mesh=ctx.mesh, **kw)
    tr2.fit(ListDataSetIterator(dss), superstep=superstep,
            checkpoint_dir=ckpt_dir, checkpoint_every=2, resume=True)
    return {"crashed": crashed, "params": net2.params_flat(),
            "opt": _opt_flat(net2), "ref_params": ref.params_flat(),
            "ref_opt": _opt_flat(ref), "iters": tr2.iteration_count}


def export_plane(ctx, conf_json, flat, paths):
    """Train from this rank's shard files (LocalShardDataSet)."""
    from deeplearning4j_tpu_torch.datasets.export import \
        ShardedPathDataSetIterator
    net = build(conf_json, flat)
    tr = ParallelTrainer(net, mesh=ctx.mesh)
    it = ShardedPathDataSetIterator(paths, shard_index=ctx.mesh.rank)
    tr.fit(it)
    return net.params_flat()


def early_stopping(ctx, conf_json, flat, train_batches, val_batches, kw,
                   epochs):
    from deeplearning4j_tpu_torch.earlystopping import (
        DataSetLossCalculator, EarlyStoppingConfiguration,
        EarlyStoppingParallelTrainer, InMemoryModelSaver,
        MaxEpochsTerminationCondition)
    net = build(conf_json, flat)
    conf = EarlyStoppingConfiguration(
        epoch_termination_conditions=[MaxEpochsTerminationCondition(epochs)],
        score_calculator=DataSetLossCalculator(
            ListDataSetIterator(_datasets(val_batches))),
        model_saver=InMemoryModelSaver())
    es = EarlyStoppingParallelTrainer(
        conf, net, ListDataSetIterator(_datasets(train_batches)),
        mesh=ctx.mesh, **kw)
    res = es.fit()
    return {"scores": dict(res.score_vs_epoch),
            "best_epoch": res.best_model_epoch,
            "params": net.params_flat()}


def plane(ctx, conf_json, flat, train_batches, eval_batches, kw=None,
          graph=False, labels=None, top_n=1, examples=None, recon=None):
    """Train on `train_batches` (one fit a batch), then the evaluation
    plane: evaluate over `eval_batches` (an iterator of them),
    score_examples of `examples` (a batch) with and without the l1/l2
    term, and with `recon` (features, num_samples, seed) the VAE
    reconstruction log-probability. Returns what rank 0 and every other
    rank saw, which must agree."""
    net = build(conf_json, flat, graph)
    tr = ParallelTrainer(net, mesh=ctx.mesh, **(kw or {}))
    for ds in _datasets(train_batches):
        tr.fit(ds)
    ev = tr.evaluate(ListDataSetIterator(_datasets(eval_batches)),
                     labels_list=labels, top_n=top_n)
    out = {"confusion": (None if ev.confusion is None
                         else ev.confusion.matrix.copy()),
           "n": ev.num_examples(), "top_n_correct": ev.top_n_correct,
           "top_n_total": ev.top_n_total, "labels": ev.label_names,
           "params": net.params_flat()}
    if examples is not None:
        ds = _datasets([examples])[0]
        out["reg"] = tr.score_examples(ds, True)
        out["noreg"] = tr.score_examples(ds, False)
    if recon is not None:
        x, n, seed = recon
        out["recon"] = tr.reconstruction_log_probability(
            pt.DataSet(x, np.zeros((len(x), 2), np.float32)),
            num_samples=n, seed=seed)
    return out


def graph_recon_error(ctx, conf_json):
    """reconstruction_log_probability on a graph model: the documented
    ValueError."""
    net = build(conf_json, None, graph=True)
    tr = ParallelTrainer(net, mesh=ctx.mesh)
    try:
        tr.reconstruction_log_probability(
            pt.DataSet(np.zeros((4, 8), np.float32),
                       np.zeros((4, 4), np.float32)))
    except ValueError as e:
        return str(e)
    return None


def untrainable_resume(ctx, conf_json, flat, batches, ckpt_dir):
    """A batch with fewer rows than ranks trims to nothing and is
    consumed untrained; a fit killed by a data fault after it resumes
    (superstep 2, a checkpoint every step) to the uninterrupted run."""
    from deeplearning4j_tpu_torch.fault import FaultyIterator
    dss = _datasets(batches)
    ref = build(conf_json, flat)
    rt = ParallelTrainer(ref, mesh=ctx.mesh)
    rt.fit(ListDataSetIterator(list(dss)), superstep=2)
    t1 = ParallelTrainer(build(conf_json, flat), mesh=ctx.mesh)
    raised = False
    try:
        t1.fit(FaultyIterator(ListDataSetIterator(list(dss)), raise_at=5,
                              exc=RuntimeError), superstep=2,
               checkpoint_dir=ckpt_dir, checkpoint_every=1)
    except RuntimeError:
        raised = True
    net2 = build(conf_json, flat)
    t2 = ParallelTrainer(net2, mesh=ctx.mesh)
    t2.fit(ListDataSetIterator(list(dss)), superstep=2,
           checkpoint_dir=ckpt_dir, resume=True)
    return {"raised": raised, "ref_iters": rt.iteration_count,
            "iters": t2.iteration_count, "ref": ref.params_flat(),
            "params": net2.params_flat()}


def replica_params(ctx, conf_json, flat, batches, kw, epochs):
    """Early stopping over an AVERAGING trainer: every rank's live replica
    after the run (not averaged within the run's cadence)."""
    from deeplearning4j_tpu_torch.earlystopping import (
        DataSetLossCalculator, EarlyStoppingConfiguration,
        EarlyStoppingParallelTrainer, InMemoryModelSaver,
        MaxEpochsTerminationCondition)
    from deeplearning4j_tpu_torch.nn.trees import flat_leaves
    net = build(conf_json, flat)
    tr = ParallelTrainer(net, mesh=ctx.mesh, **kw)
    conf = EarlyStoppingConfiguration(
        epoch_termination_conditions=[MaxEpochsTerminationCondition(epochs)],
        score_calculator=DataSetLossCalculator(
            ListDataSetIterator(_datasets(batches))),
        model_saver=InMemoryModelSaver())
    res = EarlyStoppingParallelTrainer(
        conf, train_iter=ListDataSetIterator(_datasets(batches)),
        trainer=tr).fit()
    leaf = flat_leaves(tr._params)[0].detach().numpy().copy()
    return {"epochs": res.total_epochs, "best": res.best_model is not None,
            "leaf": leaf}


def elastic_state_of(ctx, conf_json, flat, batches, kw):
    """Train, then the trainer's logical state (trees as CPU tensors)."""
    tr = ParallelTrainer(build(conf_json, flat), mesh=ctx.mesh, **kw)
    for ds in _datasets(batches):
        tr.fit(ds)
    tree, meta = tr.elastic_state()
    from deeplearning4j_tpu_torch.nn.trees import tree_map
    return tree_map(lambda a: a.detach().cpu().clone(), tree), meta


def continue_from(ctx, conf_json, tree, meta, batches, kw):
    """Load a logical state into a fresh trainer and keep training."""
    net = build(conf_json)
    tr = ParallelTrainer(net, mesh=ctx.mesh, **kw)
    tr.load_elastic_state(tree, meta)
    for ds in _datasets(batches):
        tr.fit(ds)
    return {"params": net.params_flat(), "iters": tr.iteration_count}


def placement(ctx):
    """This rank process's CPU affinity and scheduling priority."""
    import os
    return sorted(os.sched_getaffinity(0)), os.getpriority(os.PRIO_PROCESS,
                                                           0)


def batchnorm_sync(ctx, conf_json, flat, batch):
    """SYNC training of a BatchNormalization model over this world's ranks
    in each strategy, one step each (the global batch's statistics), and
    one step of each ZeRO step builder; the inference-mode score and
    accuracy of the untrained model."""
    import torch
    from deeplearning4j_tpu_torch.parallel import (make_zero_accum_superstep,
                                                   make_zero_step)
    ds = pt.DataSet(*batch)
    params, scores = {}, {}
    for strategy in ("replicated", "zero1", "zero2", "fsdp"):
        net = build(conf_json, flat)
        tr = ParallelTrainer(net, mesh=ctx.mesh, strategy=strategy)
        tr.fit(ds)
        params[strategy] = net.params_flat()
        scores[strategy] = tr.score()
    builders = {}
    for fn in (make_zero_step, make_zero_accum_superstep):
        net = build(conf_json, flat)
        step, info = fn(net, ctx.mesh)
        rows = len(batch[0]) // ctx.mesh.size
        sl = slice(ctx.mesh.rank * rows, (ctx.mesh.rank + 1) * rows)
        b = (torch.tensor(batch[0][sl]), torch.tensor(batch[1][sl]), None,
             None)
        opt = step.plan.to_plan_opt(net.updater_state)
        if fn is make_zero_step:
            out = step(net.params, net.state, opt, 0, b)
            builders[fn.__name__] = float(out[3])
        else:
            out = step(net.params, net.state, opt, 0, [[b]])
            builders[fn.__name__] = float(out[3][0])
    tr = ParallelTrainer(build(conf_json, flat), mesh=ctx.mesh)
    return {"params": params, "scores": scores, "builders": builders,
            "score": tr.score(ds), "accuracy": tr.evaluate(ds).accuracy()}
