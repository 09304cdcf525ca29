"""The one-thread autouse fixture of the PyTorch port's test modules.

Each `tests/test_torch_*.py` module imports `one_torch_thread`, which pytest
then applies to every test of that module. The suite runs in parallel
worker processes, and torch's default of one intra-op thread per core in
each of them oversubscribes the CPU and slows the whole run, the JAX
package's timed tests included.

Under pytest-xdist with two or more workers, each port test also runs with
every thread of its worker process on one core (worker gwN on the N-th
schedulable core, modulo their count), and the process's own affinity is
given back after the test. The port's tests compare with JAX references,
and XLA:CPU compiles each of them on a pool of threads as wide as the
machine; unpinned, one port worker's compiles take as many cores as they
can while the JAX package's timed tests run on the other workers. XLA
sizes its thread pools from the schedulable cores when it creates them,
so the first pin in a process comes after one warm-up compile: the JAX
package's tests that the worker runs later keep their full pools.

A pinned port test also runs at a lower scheduling priority (nice
`PORT_NICE`, every thread of the worker; Linux nice values are per
thread, and the worker's module fixtures and the rank processes they fork
inherit it): the JAX package's timed tests on the other workers spread
their XLA threads over every core, and where one of them shares a core
with a port test, the port test yields. The priority is given back with
the affinity, and only where the process may raise it again (a probe at
import)."""
import contextlib
import os

import pytest
import torch

_ALL_CORES = os.sched_getaffinity(0)
_warm = []
PORT_NICE = 19


def _can_restore_priority() -> bool:
    """Whether this process may lower a thread's nice value back (root
    with CAP_SYS_NICE): probed on a throwaway thread."""
    import threading
    ok = []

    def probe():
        tid = threading.get_native_id()
        base = os.getpriority(os.PRIO_PROCESS, tid)
        try:
            os.setpriority(os.PRIO_PROCESS, tid, base + 1)
            os.setpriority(os.PRIO_PROCESS, tid, base)
            ok.append(True)
        except OSError:
            pass
    t = threading.Thread(target=probe)
    t.start()
    t.join()
    return bool(ok)


_BASE_NICE = os.getpriority(os.PRIO_PROCESS, 0)
_RENICE = _can_restore_priority()


def _worker_core():
    """The one core of this xdist worker, or None outside a parallel run."""
    wid = os.environ.get("PYTEST_XDIST_WORKER", "")
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    cores = sorted(_ALL_CORES)
    if workers < 2 or not wid.startswith("gw") or len(cores) < 2:
        return None
    return {cores[int(wid[2:]) % len(cores)]}


def _pin(cores, nice=None):
    """Every thread of this process on `cores` (and at `nice`)."""
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), cores)
            if nice is not None:
                os.setpriority(os.PRIO_PROCESS, int(tid), nice)
        except OSError:                         # the thread has ended
            pass


def _warm_up_jax():
    """XLA's client and compile pools, created at full width."""
    if not _warm:
        import jax
        import jax.numpy as jnp
        jax.jit(lambda a: a + 1)(jnp.ones(2)).block_until_ready()
        _warm.append(True)


@contextlib.contextmanager
def pinned():
    """One intra-op torch thread and, in a parallel run, every thread of
    the worker on its one core, for the block. The per-test fixture below
    uses it; a module-scoped fixture that computes JAX references uses it
    too, since pytest sets such a fixture up before the per-test pin."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    core = _worker_core()
    if core is not None:
        _warm_up_jax()
        _pin(core, _BASE_NICE + PORT_NICE if _RENICE else None)
    try:
        yield
    finally:
        if core is not None:
            _pin(_ALL_CORES, _BASE_NICE if _RENICE else None)
        torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's side of each comparison, and in
    a parallel run the worker's threads on one core."""
    with pinned():
        yield
