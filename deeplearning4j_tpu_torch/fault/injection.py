"""Deterministic fault injection for testing every recovery path.

Two injection surfaces:

  * **Crash points**: named hook points in the durable-write paths
    (`util/serializer.py`). A registered hook fires at the point;
    `crash_at_write` installs one that raises `SimulatedCrash` on the nth
    firing, so "the process died exactly between writing the payload and
    committing it" is a reproducible test case. The point in use:
      - ``zip/temp_written``    after the temp file's bytes are written,
                                before fsync+atomic rename (ModelSerializer)
  * **FaultyIterator**: a DataSetIterator wrapper injecting data-plane
    faults at exact global batch ordinals: transient/permanent raise,
    all-NaN feature batches (numerically poisoned data), stalls.

`SimulatedCrash` subclasses BaseException so it sails through the
`except Exception` retry/cleanup layers the way SIGKILL would: only test
harnesses catch it.

**Process-level injectors**: where `crash_at_write` models a death inside
this interpreter, `kill_at_step` / `hang_at_step` / `sigterm_at_step`
model the death, stall or preemption notice of a whole worker (`os._exit`
with no teardown, an indefinite sleep, a SIGTERM to itself) at an exact
optimizer step. They ride the ``elastic/step`` crash point that the
elastic trainer's supervision loop fires once per step (in the port that
loop comes with the parallel stack, ROADMAP A11; `fire_crash_point`
drives the point directly meanwhile), and `install_faults_from_env` arms
them, and the write-boundary injectors, from ``DL4J_*`` environment
variables so a child process can be killed at an exact step or write.
"""
from __future__ import annotations

import contextlib
import os
import signal
import time
from typing import Callable, Dict, Optional

import numpy as np

from ..datasets.iterators import DataSet, DataSetIterator, MultiDataSet

__all__ = ["SimulatedCrash", "fire_crash_point", "crash_at_write",
           "install_crash_at_write", "kill_at_step", "hang_at_step",
           "sigterm_at_step", "install_faults_from_env", "clear_crash_hooks",
           "FaultyIterator"]

#: the per-optimizer-step crash point the elastic trainer's loop fires
#: (info carries step= and worker=): the hook surface for kill/hang/
#: SIGTERM-at-step process-level injection
STEP_POINT = "elastic/step"


class SimulatedCrash(BaseException):
    """Injected mid-write process death (BaseException on purpose: generic
    `except Exception` recovery code must not be able to swallow it)."""


_crash_hooks: Dict[str, Callable] = {}


def fire_crash_point(point: str, **info):
    """Called by durable-write paths at their commit boundaries. No-op
    (one dict lookup) unless a test installed a hook for `point`."""
    cb = _crash_hooks.get(point)
    if cb is not None:
        cb(point, info)


@contextlib.contextmanager
def crash_at_write(point: str = "zip/temp_written", nth: int = 1):
    """Install a crash hook: the `nth` firing of `point` raises
    SimulatedCrash. Yields a dict whose "fired" entry counts firings, so
    tests can assert the crash actually hit the intended write."""
    state = {"fired": 0}

    def cb(p, info):
        state["fired"] += 1
        if state["fired"] == nth:
            raise SimulatedCrash(
                f"injected crash at {p} (firing #{nth}; {info})")

    prev = _crash_hooks.get(point)
    _crash_hooks[point] = cb
    try:
        yield state
    finally:
        if prev is None:
            _crash_hooks.pop(point, None)
        else:
            _crash_hooks[point] = prev


def install_crash_at_write(point: str, nth: int = 1):
    """Non-contextmanager `crash_at_write`: installs a persistent hook
    raising SimulatedCrash on the nth firing of `point`. For subprocess
    children (armed from env, die with the process) — in-process tests
    should prefer the scoped `crash_at_write`. Returns the firing-count
    state dict."""
    state = {"fired": 0}

    def cb(p, info):
        state["fired"] += 1
        if state["fired"] == nth:
            raise SimulatedCrash(
                f"injected crash at {p} (firing #{nth}; {info})")

    _crash_hooks[point] = cb
    return state


def _install_step_hook(n: int, action: Callable[[dict], None]):
    n = int(n)

    def cb(p, info):
        if int(info.get("step", -1)) == n:
            action(info)

    _crash_hooks[STEP_POINT] = cb


def kill_at_step(n: int, exit_code: int = 137):
    """Hard-kill this process when the elastic supervision loop reaches
    optimizer step `n`: `os._exit` skips every finally/atexit/flush — the
    closest userspace stand-in for SIGKILL or a preemption. Default exit
    code 137 (= 128+SIGKILL) so harnesses can tell an injected kill from
    an ordinary crash."""
    _install_step_hook(n, lambda info: os._exit(exit_code))


def hang_at_step(n: int, hang_s: float = 3600.0):
    """Stall this process at optimizer step `n` without exiting — the
    worker stops renewing its heartbeat lease while its peer keeps
    running, which is exactly the failure the lease TTL exists to detect
    (a wedged host looks identical to a dead one from the outside)."""
    _install_step_hook(n, lambda info: time.sleep(float(hang_s)))


def sigterm_at_step(n: int):
    """Deliver SIGTERM to OURSELVES at optimizer step `n` — deterministic
    preemption notice for drills: the elastic loop's handler defers it to
    the next superstep edge and requests a cross-process drain there."""
    _install_step_hook(
        n, lambda info: os.kill(os.getpid(), signal.SIGTERM))


def _exit_at_write(point: str, nth: int = 1, exit_code: int = 137):
    """Hard `os._exit` on the nth firing of a write-boundary crash point
    — the two-phase-commit kill drills use this to die exactly between
    a durable write and its marker with NO Python teardown."""
    state = {"fired": 0}

    def cb(p, info):
        state["fired"] += 1
        if state["fired"] == nth:
            os._exit(exit_code)

    _crash_hooks[point] = cb


def clear_crash_hooks():
    """Drop every installed crash hook (test teardown for the persistent
    `install_*` variants; the scoped `crash_at_write` cleans up itself)."""
    _crash_hooks.clear()


def install_faults_from_env(env=None):
    """Arm process-level injectors from environment variables: the
    subprocess injection surface (the parent can't reach into a child's
    interpreter, but it can set its env):

      DL4J_KILL_AT_STEP=n            kill_at_step(n)
      DL4J_HANG_AT_STEP=n[:secs]     hang_at_step(n, secs)
      DL4J_SIGTERM_AT_STEP=n         sigterm_at_step(n)
      DL4J_CRASH_AT_WRITE=point[:nth]  raise SimulatedCrash at the point
      DL4J_EXIT_AT_WRITE=point[:nth]   os._exit(137) at the point (the
                                       mid-commit kill drills)

    Returns the list of armed injector names (empty when none set)."""
    env = os.environ if env is None else env
    armed = []
    v = env.get("DL4J_KILL_AT_STEP")
    if v:
        kill_at_step(int(v))
        armed.append(f"kill_at_step({v})")
    v = env.get("DL4J_HANG_AT_STEP")
    if v:
        n, _, secs = v.partition(":")
        hang_at_step(int(n), float(secs) if secs else 3600.0)
        armed.append(f"hang_at_step({n})")
    v = env.get("DL4J_SIGTERM_AT_STEP")
    if v:
        sigterm_at_step(int(v))
        armed.append(f"sigterm_at_step({v})")
    v = env.get("DL4J_CRASH_AT_WRITE")
    if v:
        point, _, nth = v.partition(":")
        install_crash_at_write(point, int(nth) if nth else 1)
        armed.append(f"crash_at_write({point})")
    v = env.get("DL4J_EXIT_AT_WRITE")
    if v:
        point, _, nth = v.partition(":")
        _exit_at_write(point, int(nth) if nth else 1)
        armed.append(f"exit_at_write({point})")
    return armed


class FaultyIterator(DataSetIterator):
    """Wrap a DataSetIterator with faults at exact **global** batch
    ordinals (0-based, counted across epochs — reset() does not reset the
    ordinal, so "the 7th batch ever served" is deterministic even
    mid-epoch-2).

      raise_at    next() raises `exc` when about to serve this ordinal.
      fail_times  how many consecutive next() calls fail there before the
                  batch is served (transient fault; default 1).
                  -1 = permanent (every call fails).
      exc         exception factory/class (default: ``OSError`` with an
                  "injected transient fault" message). Pass SimulatedCrash
                  to model a hard process death (not retryable).
      nan_at      serve this ordinal with all-NaN features (numerically
                  poisoned batch — exercises TrainingGuard policies; every
                  input of a MultiDataSet).
      delay_at / delay_s   sleep before serving this ordinal (flaky/slow
                  source; exercises timeout/backoff behavior).
    """

    def __init__(self, base: DataSetIterator, *, raise_at: Optional[int] = None,
                 fail_times: int = 1, exc=None, nan_at: Optional[int] = None,
                 delay_at: Optional[int] = None, delay_s: float = 0.0):
        self.base = base
        self.raise_at = raise_at
        self.fail_times = fail_times
        self.exc = exc if exc is not None else OSError
        self.nan_at = nan_at
        self.delay_at = delay_at
        self.delay_s = float(delay_s)
        self._served = 0      # global ordinal of the NEXT batch
        self._failed = 0

    # -- iterator contract ------------------------------------------------
    def has_next(self) -> bool:
        return self.base.has_next()

    def next(self) -> DataSet:
        i = self._served
        if self.raise_at is not None and i == self.raise_at and (
                self.fail_times < 0 or self._failed < self.fail_times):
            self._failed += 1
            exc = self.exc
            raise (exc(f"injected transient fault at batch {i} "
                       f"(attempt {self._failed})")
                   if isinstance(exc, type) else exc)
        if self.delay_at is not None and i == self.delay_at and self.delay_s:
            time.sleep(self.delay_s)
        ds = self.base.next()
        self._served += 1
        if self.nan_at is not None and i == self.nan_at:
            nan = lambda a: np.full_like(np.asarray(a, np.float64),
                                         np.nan).astype(np.asarray(a).dtype)
            if isinstance(ds, MultiDataSet):
                ds = MultiDataSet([nan(a) for a in ds.features], ds.labels,
                                  ds.features_masks, ds.labels_masks)
            else:
                ds = DataSet(nan(ds.features), ds.labels, ds.features_mask,
                             ds.labels_mask)
        return ds

    def reset(self):
        self.base.reset()

    def batch(self) -> int:
        return self.base.batch()

    def set_epoch(self, epoch: int):
        """Forward checkpoint-resume epoch positioning to the base."""
        if hasattr(self.base, "set_epoch"):
            self.base.set_epoch(epoch)

    @property
    def async_supported(self) -> bool:
        # faults must fire on the consumer thread at deterministic points
        return False
