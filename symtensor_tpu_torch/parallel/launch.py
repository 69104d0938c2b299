"""Process worlds for the parallel layer: one process per rank, each in a
``torch.distributed`` process group, on the card or on the CPU.

``World`` starts `world` processes with the ``spawn`` start method and a
``file://`` rendezvous in a temporary directory, and keeps them for as many
collective tasks as the caller runs (``World.run``); ``spawn_world`` runs
one task in a world of its own. A task is a picklable function, imported by
name in each process, called on every rank with the same arguments; its
return values come back in rank order.

Every world has a deadline. The process groups are made with
``timeout=``, so that a collective whose peers never arrive raises in the
worker, and the parent waits at most `timeout_s` seconds for a task: past
it, or as soon as any rank reports an exception, the parent ends every
worker and raises (``TimeoutError``, or ``RuntimeError`` with the worker's
traceback). A hung collective fails; it never hangs the caller.

On the card (`device="cuda"`) worker r calls ``torch.cuda.set_device(r %
cards)`` before its process group is made (``cuda:0`` on a one-card
machine): NCCL takes one rank per card, so a world of more ranks than
cards runs gloo, whose ranks may share ``cuda:0``.
Each worker runs ``torch.set_num_threads(1)``.
"""

from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _worker(rank: int, world: int, backend: str, device: str, init: str,
            timeout_s: float, tasks, results) -> None:
    import faulthandler

    faulthandler.enable()  # a crash in a collective prints its stack
    torch.set_num_threads(1)
    try:
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=init, world_size=world,
                                rank=rank,
                                timeout=datetime.timedelta(seconds=timeout_s))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        return
    try:
        while True:
            task = tasks.get()
            if task is None:
                break
            fn, args, kwargs = task
            try:
                results.put((rank, True, fn(*args, **kwargs)))
            except BaseException:
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class World:
    """A world of `world` ranks kept for several tasks (a context manager).

    backend: "gloo" or "nccl"; device: "cpu" or "cuda"; timeout_s: the
    deadline of each task, and the process groups' timeout."""

    def __init__(self, world: int, *, backend: str = "gloo", device: str = "cpu",
                 timeout_s: float = 120.0):
        if world < 1:
            raise ValueError(f"a world needs at least one rank; got {world}")
        if device == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("a world on the card needs CUDA, and CUDA is "
                               "not available: pass device='cpu'")
        self.world, self.backend, self.device = world, backend, device
        self.timeout_s = float(timeout_s)
        ctx = mp.get_context("spawn")
        self._dir = tempfile.mkdtemp(prefix="symtensor_world_")
        init = "file://" + os.path.join(self._dir, "store")
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in range(world)]
        self._procs = [
            ctx.Process(target=_worker, daemon=True,
                        args=(r, world, backend, device, init, self.timeout_s,
                              self._tasks[r], self._results))
            for r in range(world)
        ]
        for p in self._procs:
            p.start()
        self.closed = False

    def run(self, fn: Callable, *args, **kwargs) -> List[Any]:
        """fn(*args, **kwargs) on every rank; the results in rank order."""
        if self.closed:
            raise RuntimeError("this world was closed (a task failed or ran "
                               "past its deadline)")
        for q in self._tasks:
            q.put((fn, args, kwargs))
        out: List[Optional[Any]] = [None] * self.world
        pending = set(range(self.world))
        deadline = time.monotonic() + self.timeout_s
        while pending:
            left = deadline - time.monotonic()
            try:
                rank, ok, value = self._results.get(timeout=max(0.1, min(left, 1.0)))
            except queue.Empty:
                dead = [r for r in pending if not self._procs[r].is_alive()]
                if dead or left <= 0:
                    codes = [self._procs[r].exitcode for r in dead]
                    self.kill()
                    if dead:
                        raise RuntimeError(
                            f"ranks {dead} of a world of {self.world} exited "
                            f"(exit codes {codes}) during "
                            f"{getattr(fn, '__name__', fn)}")
                    raise TimeoutError(
                        f"{getattr(fn, '__name__', fn)} did not finish on ranks "
                        f"{sorted(pending)} of a world of {self.world} within "
                        f"{self.timeout_s:g} s")
                continue
            if not ok:
                self.kill()
                raise RuntimeError(f"rank {rank} of a world of {self.world} "
                                   f"raised:\n{value}")
            out[rank] = value
            pending.discard(rank)
        return out

    def kill(self) -> None:
        """End every worker now."""
        self.closed = True
        for p in self._procs:
            if p.is_alive():
                p.kill()
        for p in self._procs:
            p.join(10)
        shutil.rmtree(self._dir, ignore_errors=True)

    def close(self) -> None:
        """Let every worker leave its process group and exit."""
        if self.closed:
            return
        self.closed = True
        for q in self._tasks:
            q.put(None)
        for p in self._procs:
            p.join(30)
        self.kill()

    def __enter__(self) -> "World":
        return self

    def __exit__(self, *exc) -> None:
        if exc[0] is None:
            self.close()
        else:
            self.kill()


def spawn_world(fn: Callable, world: int, *, backend: str = "gloo",
                device: str = "cpu", timeout_s: float = 120.0,
                args: Sequence = ()) -> List[Any]:
    """fn(*args) on every rank of a new world of `world` ranks; the results
    in rank order. The world ends with the call (see ``World``)."""
    with World(world, backend=backend, device=device, timeout_s=timeout_s) as w:
        return w.run(fn, *args)
