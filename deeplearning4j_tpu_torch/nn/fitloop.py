"""The iterator loop of `fit` and the epoch loop of `fit_scan_arrays`,
shared by MultiLayerNetwork and ComputationGraph (JAX writes them out in
each model; `deeplearning4j_tpu/nn/multilayer.py:596-657, 853-915`,
`nn/graph.py:605-655`).

`fit_iterator` wires the fault-tolerance and pipeline options around the
epochs: the checkpointer (`fault/resume.py`: resume, interval saves, the
SIGTERM snapshot), the input pipeline (`datasets/pipeline.py`: padding,
time buckets, device prefetch), and either the windowed loop
(`nn/superstep.SuperstepRunner`) or the per-batch loop with the guard
around each step.
"""
from __future__ import annotations

import numpy as np
import torch

from ..telemetry.runtime import active as _tel_active, null_span as _null_span

__all__ = ["fit_iterator", "scan_epochs"]


def _epoch_listeners(model, hook):
    for listener in model.listeners:
        if hasattr(listener, hook):
            getattr(listener, hook)(model)


def fit_iterator(model, data, epochs, *, superstep, accum_m, prefetch,
                 pad_ragged, time_buckets, checkpoint_dir, checkpoint_every,
                 resume, guard, context, epoch_listeners):
    """`epochs` passes over the iterator `data` (what remains of them after
    a resume). `epoch_listeners`: call the listeners' on_epoch_start /
    on_epoch_end (the network's fit does, the graph's does not, as in
    JAX)."""
    from ..datasets.pipeline import build_pipeline
    from ..fault.resume import maybe_fit_checkpointer

    ckpt = maybe_fit_checkpointer(model, checkpoint_dir, checkpoint_every,
                                  resume, context=context)
    skip, done_epochs = (0, 0) if ckpt is None else ckpt.resume_into(data)
    data, close = build_pipeline(data, pad_ragged=pad_ragged,
                                 prefetch=prefetch,
                                 time_buckets=time_buckets,
                                 device=model.device, dtype=model._dtype)
    runner = model._make_superstep_runner(superstep, guard, ckpt, accum_m)
    if runner is not None:
        runner.skip(skip)
        skip = 0
        if model.listeners:
            from ..optimize.listeners import warn_scan_replay
            warn_scan_replay(model.listeners)
    sigterm = ckpt.sigterm_snapshot() if ckpt is not None else _null_span()
    try:
        with sigterm:
            for _ in range(max(0, epochs - done_epochs)):
                if epoch_listeners:
                    _epoch_listeners(model, "on_epoch_start")
                data.reset()
                if runner is not None:
                    runner.run_epoch(data)
                else:
                    while data.has_next():
                        ds = (guard.next_batch(data) if guard is not None
                              else data.next())
                        if skip:
                            # resume: this prefix of the epoch trained
                            # before the interruption; drawing it keeps the
                            # iterator where the uninterrupted run had it
                            skip -= 1
                            continue
                        if guard is not None:
                            guard.run_step(model,
                                           lambda b=ds: model._fit_batch(b))
                        else:
                            model._fit_batch(ds)
                        if ckpt is not None:
                            ckpt.on_batch()
                if epoch_listeners:
                    _epoch_listeners(model, "on_epoch_end")
                model.epoch_count += 1
                if ckpt is not None:
                    ckpt.on_epoch()
            if ckpt is not None:
                ckpt.on_fit_end()
    finally:
        close()
    return model


def scan_epochs(model, batches, firsts, epochs, *, checkpoint_dir=None,
                checkpoint_every=0, resume=False, guard=None, context=None,
                epoch_listeners=True):
    """The epochs of `fit_scan_arrays`: each epoch is one window over the
    `batches` (tensor trees on the model's device). With `firsts` (a TBPTT
    epoch of chunks) the recurrent carries flow from chunk to chunk and
    are zeroed where a flag marks a series' first chunk. The guard works
    at epoch granularity: a non-finite epoch is discarded whole.
    `epoch_listeners` as for `fit_iterator`."""
    from ..fault.resume import maybe_fit_checkpointer
    from .superstep import run_window, run_tbptt_window

    tel = _tel_active()
    span = tel.span if tel is not None else _null_span
    if model.listeners:
        from ..optimize.listeners import warn_scan_replay
        warn_scan_replay(model.listeners)
    ckpt = maybe_fit_checkpointer(model, checkpoint_dir, checkpoint_every,
                                  resume, context=context)
    done_epochs = ckpt.resume_into()[1] if ckpt is not None else 0
    with (ckpt.sigterm_snapshot() if ckpt is not None else _null_span()):
        for _ in range(max(0, epochs - done_epochs)):
            if epoch_listeners:
                _epoch_listeners(model, "on_epoch_start")
            snap = (guard._snapshot(model)
                    if guard is not None and guard._needs_snapshot else None)
            with span("device/dispatch", kind="scan_epoch"):
                if firsts is None:
                    scores = run_window(model, batches,
                                        model.iteration_count, kind="scan")
                else:
                    scores = run_tbptt_window(model, batches, firsts,
                                              model.iteration_count)
            with span("device/sync", kind="scan_scores"):
                host_scores = scores.cpu().numpy()
            if guard is not None and not guard.check_scores(
                    model, host_scores, snap):
                # epoch discarded, pre-epoch state back; still balance
                # on_epoch_start with on_epoch_end
                if epoch_listeners:
                    _epoch_listeners(model, "on_epoch_end")
                continue
            x_last = batches[-1][0]
            if isinstance(x_last, dict):
                x_last = next(iter(x_last.values()))
            model.last_batch_size = int(x_last.shape[0])
            model.last_input = x_last
            if model.listeners:
                for s in host_scores:
                    model._score = s
                    model.iteration_count += 1
                    for listener in model.listeners:
                        listener.iteration_done(model,
                                                model.iteration_count)
            else:
                model._score = host_scores[-1]
                model.iteration_count += len(host_scores)
            if epoch_listeners:
                _epoch_listeners(model, "on_epoch_end")
            model.epoch_count += 1
            if ckpt is not None:
                ckpt.on_epoch()
                ckpt.maybe_save()
        if ckpt is not None:
            ckpt.on_fit_end()
    return model
