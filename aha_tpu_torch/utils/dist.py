"""Multi-process runtime helpers: the port's copy of ``aha_tpu/utils/dist.py``.

One process per rank, the way ``torchrun`` starts them. ``init_distributed``
is ``torch.distributed.init_process_group``: NCCL where each rank has a card of
its own, gloo on the CPU and where several ranks share one card
(``backend_for``). Seeding, the rank helpers, rank-0 print gating and the
stride split of host work (``shard_iterable``) are JAX's.
"""

from __future__ import annotations

import builtins
import datetime
import functools
import os
import random

# a collective that waits longer than this fails instead of hanging a run
DEFAULT_TIMEOUT_S = 600


def set_seed(seed: int):
    """Seed python, numpy and torch."""
    import numpy as np
    import torch

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def _initialized() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    if _initialized():
        import torch.distributed as dist

        return dist.get_rank()
    return int(os.environ.get("RANK", 0))


def process_count() -> int:
    if _initialized():
        import torch.distributed as dist

        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))


def is_main_process() -> bool:
    return process_index() == 0


def setup_for_distributed(is_master: bool):
    """Gate print() to the main process (``print(..., force=True)`` still prints)."""
    builtin_print = getattr(builtins.print, "__wrapped__", builtins.print)

    @functools.wraps(builtin_print)
    def print_(*args, force=False, **kwargs):
        if is_master or force:
            builtin_print(*args, **kwargs)

    builtins.print = print_


def backend_for(device) -> str:
    """NCCL when every rank of this host has a card of its own, else gloo
    (the CPU, or ranks that share one card: NCCL refuses two ranks on one
    device)."""
    import torch

    if str(device).startswith("cuda") and torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", 1)))
        if torch.cuda.device_count() >= local:
            return "nccl"
    return "gloo"


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, *, device="cuda",
                     backend: str | None = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> dict:
    """``init_process_group`` from explicit arguments (``coordinator_address``
    "host:port", the world size, this rank) or, without them, from the
    environment torchrun / SLURM / Open MPI set. Returns the rank, the world
    size and the devices as JAX's does, and gates print() to rank 0."""
    import torch
    import torch.distributed as dist

    env = os.environ
    if coordinator_address is None:
        coordinator_address = (env.get("AHA_COORDINATOR_ADDRESS")
                               or env.get("COORDINATOR_ADDRESS"))
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE") or env.get("SLURM_NTASKS")
                            or env.get("OMPI_COMM_WORLD_SIZE") or 1)
    if process_id is None:
        process_id = int(env.get("RANK") or env.get("SLURM_PROCID")
                         or env.get("OMPI_COMM_WORLD_RANK") or 0)
    if coordinator_address is None:
        coordinator_address = f"{env.get('MASTER_ADDR', 'localhost')}:" \
                              f"{env.get('MASTER_PORT', '29500')}"
    backend = backend or backend_for(device)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id,
                                timeout=datetime.timedelta(seconds=timeout_s))
    local_rank = int(env.get("LOCAL_RANK", process_id))
    if backend == "nccl":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    info = {
        "process_index": dist.get_rank(),
        "process_count": dist.get_world_size(),
        "backend": backend,
        "local_devices": 1,
        "global_devices": dist.get_world_size(),
    }
    setup_for_distributed(info["process_index"] == 0)
    return info


def agreed_flag(flag: int, op: str = "max") -> bool:
    """``flag`` reduced over the world (max: set on any rank; min: on every
    rank), for a host decision every rank must take alike. NCCL reduces only
    CUDA tensors, so the flag crosses on the rank's card there."""
    import torch
    import torch.distributed as dist

    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
    t = torch.tensor([int(flag)], dtype=torch.int32, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.MIN)
    return bool(t.item())


def multihost_env_detected() -> bool:
    """True when the environment says this process is one of several:

      * an explicit coordinator (AHA_COORDINATOR_ADDRESS / COORDINATOR_ADDRESS);
      * torchrun: WORLD_SIZE > 1 with MASTER_ADDR;
      * SLURM with more than one task (SLURM_NTASKS);
      * Open MPI / mpirun with more than one rank (OMPI_COMM_WORLD_SIZE).

    Reads only the environment."""
    env = os.environ
    if env.get("AHA_COORDINATOR_ADDRESS") or env.get("COORDINATOR_ADDRESS"):
        return True
    try:
        if int(env.get("WORLD_SIZE", "1")) > 1 and env.get("MASTER_ADDR"):
            return True
        if int(env.get("SLURM_NTASKS", "1")) > 1:
            return True
        if int(env.get("OMPI_COMM_WORLD_SIZE", "1")) > 1:
            return True
    except ValueError:
        pass
    return False


def maybe_init_distributed(device="cuda") -> dict | None:
    """Command-line entry hook: bring the process group up iff the
    environment is a multi-process job, else do nothing."""
    if not multihost_env_detected():
        return None
    return init_distributed(device=device)


def shard_iterable(items, num_shards: int | None = None, shard_id: int | None = None):
    """Stride split of host work: item i goes to shard i % num_shards."""
    n = num_shards if num_shards is not None else process_count()
    r = shard_id if shard_id is not None else process_index()
    for i, item in enumerate(items):
        if i % n == r:
            yield item
