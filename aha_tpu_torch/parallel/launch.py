"""Start a world of ranks from one Python process, one child process a rank,
as ``torchrun`` would, and collect what each rank's function returns.

``spawn(fn, world, *args, device=...)`` runs ``fn(rank, world, device, *args)``
in each child after ``init_distributed`` (gloo on the CPU and where the ranks
share one card, NCCL where each has its own), with every collective bounded
by ``timeout`` seconds: a rank whose control flow parted from the others
fails instead of hanging. ``fn`` must be importable by name (a module-level
function), and what it returns picklable.
"""

from __future__ import annotations

import os
import socket
import traceback


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(rank, world, port, device, backend, timeout, threads, fn, args, q):
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE=str(world),
                      RANK=str(rank), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    import torch
    import torch.distributed as dist

    from ..utils.dist import init_distributed

    torch.set_num_threads(threads)
    try:
        init_distributed(f"localhost:{port}", world, rank, device=device, backend=backend,
                         timeout_s=timeout)
        out = fn(rank, world, device, *args)
        q.put((rank, "ok", out))
    except BaseException:
        q.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class World:
    """A started world (``start``): ``result()`` waits for its ranks."""

    def __init__(self, procs, q, world, timeout):
        self.procs, self.q, self.world, self.timeout = procs, q, world, timeout
        self._out = None

    def result(self) -> list:
        if self._out is None:
            self._out = self._collect()
        return self._out

    def _collect(self) -> list:
        import queue as _queue

        results, errors = {}, []
        try:
            while len(results) + len(errors) < self.world:
                try:
                    rank, status, out = self.q.get(timeout=self.timeout + 60)
                except _queue.Empty:
                    raise TimeoutError(f"{self.world - len(results)} of {self.world} ranks "
                                       f"returned nothing in {self.timeout + 60:.0f} s")
                if status == "ok":
                    results[rank] = out
                else:
                    errors.append((rank, out))
                    break
        finally:
            for p in self.procs:
                p.join(timeout=5 if not errors else 1)
                if p.is_alive():
                    p.kill()
                    p.join()
        if errors:
            rank, tb = errors[0]
            raise RuntimeError(f"rank {rank} of {self.world} failed:\n{tb}")
        return [results[r] for r in range(self.world)]


def start(fn, world: int, *args, device="cpu", backend: str | None = None,
          timeout: float = 300.0, threads: int = 1) -> World:
    """Start ``fn(rank, world, device, *args)`` on ``world`` ranks and return
    at once; ``World.result()`` collects what they return."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_entry, daemon=True,
                         args=(r, world, port, device, backend, timeout, threads, fn, args, q))
             for r in range(world)]
    for p in procs:
        p.start()
    return World(procs, q, world, timeout)


def spawn(fn, world: int, *args, device="cpu", backend: str | None = None,
          timeout: float = 300.0, threads: int = 1) -> list:
    """Run ``fn(rank, world, device, *args)`` on ``world`` ranks; returns the
    ranks' results in rank order. Raises with the first failing rank's
    traceback, or when a rank neither returns nor fails within ``timeout``
    (every child is then killed)."""
    return start(fn, world, *args, device=device, backend=backend, timeout=timeout,
                 threads=threads).result()
