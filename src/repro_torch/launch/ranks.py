"""A pool of machine processes for ``impl="mesh"``: one spawned process per
machine, joined into a ``gloo`` process group, running the same top-level
function on every rank.

    from repro_torch.launch.ranks import RankPool, run_ranks

    with RankPool(8) as pool:                  # 8 processes, started once
        outs = pool.run(fit_and_predict, parts, X_q)          # all 8 ranks
        outs = pool.run(fit_and_predict, parts[:4], X_q, world=4)  # ranks 0-3
    outs = run_ranks(4, fit_and_predict, parts, X_q)   # a pool for one call

``fn`` must be importable by name (a module-level function): the spawned
processes import it.  Each call's ``world`` ranks form the default process
group (rendezvous through a ``FileStore`` in the pool's own temporary
directory, never a fixed port, so pools never collide); the group is kept
while ``world`` stays the same.  A call returns every rank's result, its
tensors as numpy arrays, in rank order; an exception on any rank is
raised in the caller with that rank's traceback.  Each process runs one
torch thread, and ranks other than 0 run with their standard output
silenced.  ``startup_s`` holds
each process's seconds from spawn to ready (``torch`` imported, its card
context made when ``device`` is a CUDA device).
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import shutil
import sys
import tempfile
import time
import traceback

__all__ = ["RankPool", "run_ranks"]


def _to_numpy(obj):
    """A job's result with its tensors (in dicts, lists and tuples) as numpy."""
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_numpy(v) for v in obj)
    return obj


def _worker(rank: int, conn, device: str, t_spawn: float):
    if rank != 0:
        sys.stdout = open(os.devnull, "w")
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    if device.startswith("cuda"):
        torch.zeros(1, device=device)  # the card context, made once here
    conn.send(("ready", time.time() - t_spawn))
    store = None
    while True:
        msg = conn.recv()
        if msg[0] == "stop":
            break
        _, fn, args, kwargs, world, store_path, timeout = msg
        try:
            if store != store_path:
                if dist.is_initialized():
                    dist.destroy_process_group()
                dist.init_process_group(
                    "gloo", store=dist.FileStore(store_path, world), rank=rank,
                    world_size=world, timeout=datetime.timedelta(seconds=timeout))
                store = store_path
            conn.send(("ok", _to_numpy(fn(*args, **kwargs))))
        except (Exception, SystemExit) as e:  # reported to the caller, who raises it
            tb = traceback.format_exc()
            try:
                conn.send(("err", e, tb))
            except Exception:  # noqa: BLE001 - an exception that does not pickle
                conn.send(("err", RuntimeError(f"{type(e).__name__}: {e}"), tb))
    if dist.is_initialized():
        dist.destroy_process_group()


class RankPool:
    """``n`` spawned processes that run top-level functions as the ranks of
    a ``gloo`` process group (see the module docstring).  ``device``: where
    the processes run (``"cuda"`` makes the card's context at start-up);
    ``timeout``: seconds a collective may wait for its peers before the
    ranks give up."""

    def __init__(self, n: int, *, device: str = "cpu", timeout: float = 300.0):
        self.n, self.timeout = int(n), float(timeout)
        self._dir = tempfile.mkdtemp(prefix="repro_torch_ranks_")
        self._gen, self._world = 0, None
        ctx = mp.get_context("spawn")
        t0 = time.time()
        self._conns, self._procs = [], []
        for r in range(self.n):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_worker, args=(r, child, str(device), t0), daemon=True)
            p.start()
            child.close()
            self._conns.append(parent)
            self._procs.append(p)
        self.startup_s = [self._recv(r)[1] for r in range(self.n)]

    def _recv(self, r: int):
        conn = self._conns[r]
        while not conn.poll(1.0):
            if not self._procs[r].is_alive():
                raise RuntimeError(f"rank {r} exited (code {self._procs[r].exitcode})")
        return conn.recv()

    def run(self, fn, *args, world: int | None = None, **kwargs) -> list:
        """``fn(*args, **kwargs)`` on ranks 0..world-1 (all ``n`` when None),
        which form the default process group; every rank's result."""
        world = self.n if world is None else int(world)
        if not 1 <= world <= self.n:
            raise ValueError(f"world={world} outside 1..{self.n}")
        if world != self._world:
            self._gen += 1
            self._world = world
        store = os.path.join(self._dir, f"store_{self._gen}")
        for r in range(world):
            self._conns[r].send(("run", fn, args, kwargs, world, store, self.timeout))
        replies = [self._recv(r) for r in range(world)]
        for r, reply in enumerate(replies):
            if reply[0] == "err":
                _, exc, tb = reply
                exc.add_note(f"raised on rank {r} of {world}:\n{tb}")
                self._world = None  # the group may be wedged: the next call makes a new one
                raise exc
        return [reply[1] for reply in replies]

    def close(self):
        for conn in self._conns:
            try:
                conn.send(("stop",))
            except (BrokenPipeError, OSError):
                pass
        for p in self._procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def run_ranks(m: int, fn, *args, ranks_on: str = "cpu", **kwargs) -> list:
    """``fn(*args, **kwargs)`` on ``m`` fresh ranks (a pool for one call,
    its processes' device ``ranks_on``); every rank's result."""
    with RankPool(m, device=ranks_on) as pool:
        return pool.run(fn, *args, **kwargs)
