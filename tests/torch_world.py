"""A world of gloo ranks for the PyTorch port's parallel tests.

`World(n, tmpdir)` starts n rank processes once (a module fixture) and
hands them the tests' work: `world.run(fn, *args, width=w)` runs
`fn(ctx, *args, **kwargs)` on ranks 0..w-1 (the others skip the task) and returns
their results in rank order. `ctx.mesh` is a data-axis mesh over the first
w ranks (subgroups of 1, 2 and n made at start), on the CPU.

The ranks are forked from a forkserver that has imported torch and the
port once per test process, so a world starts in well under a second after
the first; they rendezvous through a FileStore under the fixture's
temporary directory (no fixed port to collide between test processes).
Start the world inside `torch_threads.pinned()`: the forkserver and its
ranks then inherit the test worker's one core and one torch thread, and
stay off the cores the JAX package's timed tests need.
"""
import importlib
import multiprocessing as mp
import os
import queue
import traceback

_CTX = None


def _context():
    global _CTX
    if _CTX is None:
        _CTX = mp.get_context("forkserver")
        _CTX.set_forkserver_preload(["torch", "torch.distributed",
                                     "deeplearning4j_tpu_torch.parallel"])
    return _CTX


class RankContext:
    def __init__(self, rank, world, groups):
        self.rank = rank
        self.world = world
        self.groups = groups
        self.mesh = None

    def mesh_of(self, width):
        from deeplearning4j_tpu_torch.parallel import make_mesh
        return make_mesh({"data": width}, group=self.groups[width],
                         device="cpu")


def _rank_main(rank, n, init, widths, tasks, results):
    import datetime

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=n,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    groups = {n: None}
    for w in widths:
        if w < n:
            groups[w] = dist.new_group(list(range(w)))
    ctx = RankContext(rank, n, groups)
    results.put((rank, True, "ready"))
    while True:
        task = tasks.get()
        if task is None:
            break
        mod, name, args, kwargs, width, every = task
        if rank >= width and not every:
            results.put((rank, True, None))
            continue
        try:
            fn = getattr(importlib.import_module(mod), name)
            ctx.width = width
            ctx.mesh = ctx.mesh_of(width) if rank < width else None
            out = fn(ctx, *args, **kwargs)
            results.put((rank, True, out))
        except BaseException:
            results.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class World:
    def __init__(self, n, tmpdir, widths=(1, 2)):
        ctx = _context()
        self.n = n
        widths = sorted(set(widths) | {n})
        init = "file://" + os.path.join(str(tmpdir), "world_store")
        self.tasks = [ctx.Queue() for _ in range(n)]
        self.results = ctx.Queue()
        self.procs = [ctx.Process(target=_rank_main,
                                  args=(r, n, init, widths, self.tasks[r],
                                        self.results), daemon=True)
                      for r in range(n)]
        for p in self.procs:
            p.start()
        self._collect(n, 180)

    def _collect(self, n, timeout):
        out, errors = {}, []
        for _ in range(n):
            try:
                rank, ok, val = self.results.get(timeout=timeout)
            except queue.Empty:
                self.close(kill=True)
                raise AssertionError("a rank did not answer within "
                                     f"{timeout} s")
            if ok:
                out[rank] = val
            else:
                errors.append(f"rank {rank}:\n{val}")
        if errors:
            raise AssertionError("\n".join(errors))
        return out

    def run(self, fn, *args, width=None, timeout=600, every=False,
            **kwargs):
        """fn(ctx, *args, **kwargs) on ranks 0..width-1 (with `every`, on
        every rank, `ctx.width` saying how many the task uses: making a
        subgroup is a call of the whole world); their results in order."""
        width = self.n if width is None else int(width)
        for q in self.tasks:
            q.put((fn.__module__, fn.__name__, args, kwargs, width, every))
        out = self._collect(self.n, timeout)
        return [out[r] for r in range(width)]

    def close(self, kill=False):
        for q in self.tasks:
            try:
                q.put(None)
            except Exception:
                pass
        for p in self.procs:
            p.join(timeout=0 if kill else 10)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
