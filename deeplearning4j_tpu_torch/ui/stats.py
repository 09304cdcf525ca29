"""StatsListener: per-iteration training statistics; the port of
`deeplearning4j_tpu/ui/stats.py`.

Parity with `ui/stats/BaseStatsListener.java:43` — collects score,
per-parameter summary stats + histograms, update(-magnitude) stats, memory
and throughput each `frequency` iterations, and routes a `StatsReport` into a
`StatsStorage`. A report reads the score and copies every parameter to the
host in one copy (one per parameter dtype; bf16 leaves as float32, numpy
has no bf16): two device-to-host copies, counted in `host_copies`. The
summaries are JAX's numpy code on those arrays, so a report equals JAX's
for the same parameters. Set frequency>1 to amortize.

The device memory is `torch.cuda.memory_allocated` of the model's device,
under JAX's key `device_bytes_in_use` (absent for a model on the CPU, as
JAX's CPU client reports no memory stats).
"""
from __future__ import annotations

import resource
import time
import uuid
from typing import Dict, List, Optional

import numpy as np
import torch

from .storage import StatsStorage
from ..optimize.listeners import TrainingListener

__all__ = ["StatsListener", "StatsReport", "model_topology"]


def _named_leaves(prefix: str, tree):
    """[(path, leaf)] of a parameter dict, nested dicts (a bidirectional
    layer's directions) joined by "/"."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in _named_leaves(f"{prefix}/{k}", tree[k])]
    return [(prefix, tree)]


def _host_copy(tensors: List[torch.Tensor]) -> List[np.ndarray]:
    """Host arrays of `tensors` (one device): one copy per dtype, bf16 as
    float32."""
    out: List[Optional[np.ndarray]] = [None] * len(tensors)
    groups: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        dt = torch.float32 if t.dtype == torch.bfloat16 else t.dtype
        groups.setdefault(dt, []).append(i)
    for dt, idx in groups.items():
        flat = torch.cat([tensors[i].detach().reshape(-1).to(dt)
                          for i in idx]).cpu().numpy()
        at = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[at:at + n].reshape(tuple(tensors[i].shape))
            at += n
    return out


def _flatten_params(model) -> Dict[str, np.ndarray]:
    """{"layername/param": host array} for MultiLayerNetwork (tuple of dicts)
    or ComputationGraph (dict of dicts), copied to the host at once."""
    params = model.params
    if params is None:
        return {}
    if isinstance(params, dict):
        items = params.items()
    else:
        names = [getattr(l, "name", None) or f"layer{i}"
                 for i, l in enumerate(model.layers)]
        items = zip(names, params)
    named = [pl for name, p in items if p
             for pl in _named_leaves(name, p)]
    arrays = _host_copy([v for _, v in named])
    return {k: a for (k, _), a in zip(named, arrays)}


def _summary(arr: np.ndarray, bins: int) -> Dict:
    flat = arr.ravel().astype(np.float64)
    counts, edges = np.histogram(flat, bins=bins)
    return {
        "mean": float(flat.mean()),
        "stdev": float(flat.std()),
        "min": float(flat.min()),
        "max": float(flat.max()),
        "histogram": {"counts": counts.tolist(),
                      "min": float(edges[0]), "max": float(edges[-1])},
    }


def _param_count(p) -> int:
    if not p:
        return 0
    return int(sum(v.numel() for _, v in _named_leaves("", p)))


def model_topology(model) -> List[Dict]:
    """Vertex list for the Flow view (reference FlowListenerModule /
    ModelInfo): [{name, type, inputs, n_params}] in topological order.
    Works for ComputationGraph (DAG) and MultiLayerNetwork (chain)."""
    conf = getattr(model, "conf", None)
    out: List[Dict] = []
    if hasattr(conf, "vertices"):  # ComputationGraph
        for name in conf.network_inputs:
            out.append({"name": name, "type": "Input", "inputs": [],
                        "n_params": 0})
        params = model.params or {}
        for name in conf.topological_order:
            if name not in conf.vertices:
                continue
            v = conf.vertices[name]
            out.append({"name": name, "type": type(v).__name__,
                        "inputs": list(conf.vertex_inputs[name]),
                        "n_params": _param_count(params.get(name))})
        return out
    # MultiLayerNetwork: sequential chain
    out.append({"name": "input", "type": "Input", "inputs": [],
                "n_params": 0})
    prev = "input"
    params = model.params or ()
    for i, layer in enumerate(getattr(model, "layers", ())):
        name = getattr(layer, "name", None) or f"layer{i}"
        out.append({"name": name, "type": type(layer).__name__,
                    "inputs": [prev],
                    "n_params": _param_count(
                        params[i] if i < len(params) else {})})
        prev = name
    return out


class StatsReport(dict):
    """A plain-dict report (JSON-able). Keys: iteration, timestamp, score,
    params {name: summary}, updates {name: summary}, memory, perf, and (on
    the first report of a session) model — the topology for the Flow
    view."""


class StatsListener(TrainingListener):
    TYPE_ID = "StatsListener"
    # reads model.params per iteration_done — under fit_scan_arrays replay
    # every call sees end-of-window params (see fit_scan_arrays docstring)
    collects_param_stats = True

    def __init__(self, storage: StatsStorage, frequency: int = 1,
                 session_id: Optional[str] = None, worker_id: str = "local",
                 collect_histograms: bool = True, histogram_bins: int = 20,
                 collect_updates: bool = True):
        self.storage = storage
        self.frequency = max(1, int(frequency))
        self.session_id = session_id or uuid.uuid4().hex[:12]
        self.worker_id = worker_id
        self.collect_histograms = collect_histograms
        self.histogram_bins = int(histogram_bins)
        self.collect_updates = collect_updates
        self._prev_params: Optional[Dict[str, np.ndarray]] = None
        self._last_time: Optional[float] = None
        self._last_iter: Optional[int] = None
        self._sent_model = False
        self.host_copies = 0      # device-to-host copies of the reports

    def iteration_done(self, model, iteration: int):
        if iteration % self.frequency != 0:
            return
        now = time.time()
        report = StatsReport(iteration=int(iteration), timestamp=now,
                             score=float(model.score()))
        device = getattr(model, "device", None)
        on_card = isinstance(device, torch.device) and device.type == "cuda"
        if not self._sent_model:
            # topology travels with the FIRST report (the reference's
            # StatsInitializationReport carries the model info the Flow
            # module renders)
            try:
                report["model"] = model_topology(model)
            except Exception:
                pass
            self._sent_model = True

        params = _flatten_params(model)
        if on_card:     # the score's read and the parameters' copies
            self.host_copies += 1 + len({v.dtype for v in params.values()})
        if self.collect_histograms:
            report["params"] = {k: _summary(v, self.histogram_bins)
                                for k, v in params.items()}
        if self.collect_updates and self._prev_params is not None:
            upd = {}
            for k, v in params.items():
                prev = self._prev_params.get(k)
                if prev is not None and prev.shape == v.shape:
                    upd[k] = _summary(v - prev, self.histogram_bins)
            report["updates"] = upd
        self._prev_params = params if self.collect_updates else None

        # memory (reference samples JVM/GC; here RSS + device stats if any)
        mem = {"rss_mb": resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 1024.0}
        if on_card:
            mem["device_bytes_in_use"] = int(
                torch.cuda.memory_allocated(device))
        report["memory"] = mem

        # throughput (PerformanceListener's samples/sec, folded in)
        if self._last_time is not None and iteration > (self._last_iter or 0):
            dt = now - self._last_time
            iters = iteration - self._last_iter
            if dt > 0:
                report["perf"] = {
                    "iterations_per_sec": iters / dt,
                    "samples_per_sec":
                        iters * getattr(model, "last_batch_size", 0) / dt,
                }
        self._last_time = now
        self._last_iter = iteration

        self.storage.put_update(self.session_id, self.TYPE_ID,
                                self.worker_id, now, report)
