"""Multi-process initialization (counterpart of
``visualbert_tpu/parallel/distributed.py``).

One process a GPU: ``torchrun --nproc_per_node N -m visualbert_torch.train_cli
...`` starts N processes and hands each its ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK`` and ``MASTER_ADDR``/``MASTER_PORT`` (the counterparts of
JAX's ``JAX_PROCESS_ID`` / ``JAX_NUM_PROCESSES`` / ``JAX_COORDINATOR_ADDRESS``);
:func:`initialize_distributed` brings ``torch.distributed`` up from them,
NCCL on CUDA and gloo on the CPU, and each rank takes ``cuda:LOCAL_RANK``.
``parallel/mesh.py`` lays the ranks out as a (data, model) mesh; every
rank walks the same global batch schedule and feeds its data index's slice
(``Batcher(process_shard=mesh.batch_shard())``, which is
:func:`process_shard` when every rank is on the data axis).

A launch that was configured (``WORLD_SIZE`` or an explicit
``init_method``) and fails to come up raises: carrying on as one process
would train a private copy on each rank.
"""

from __future__ import annotations

import datetime
import os
import subprocess
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from visualbert_torch.utils.logging import get_logger

log = get_logger(__name__)

DEFAULT_TIMEOUT_S = 1800.0


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def initialize_distributed(device_type: str = "cuda", backend: Optional[str] = None,
                           init_method: Optional[str] = None, rank: Optional[int] = None,
                           world_size: Optional[int] = None, timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Bring up the default process group when the launch asks for one;
    a no-op for a single process. Returns True when more than one rank is up.

    ``rank`` / ``world_size`` default to ``RANK`` / ``WORLD_SIZE``;
    ``init_method`` to ``env://`` (``MASTER_ADDR``/``MASTER_PORT``), or a
    ``file://`` store that needs no port. ``backend`` defaults to NCCL for
    ``device_type`` "cuda" and gloo for "cpu"; gloo on CUDA lets several
    ranks share one card (NCCL refuses that). On CUDA the rank's device is
    set to ``cuda:LOCAL_RANK`` first."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    rank = _env_int("RANK") if rank is None else rank
    world_size = _env_int("WORLD_SIZE") if world_size is None else world_size
    if world_size is None and init_method is None:
        return False  # one process
    if world_size is None or rank is None:
        raise RuntimeError(f"a distributed launch needs both RANK and WORLD_SIZE (got rank={rank}, "
                           f"world_size={world_size})")
    if device_type == "cuda":
        torch.cuda.set_device(local_rank())
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    dist.init_process_group(backend=backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size, timeout=datetime.timedelta(seconds=timeout_s))
    dist.barrier()  # every rank reached the backend: a launch that cannot talk fails here
    log.info("torch.distributed up: rank %d/%d, backend %s", dist.get_rank(), dist.get_world_size(), backend)
    return dist.get_world_size() > 1


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def local_rank() -> int:
    """This process's card on its host (``LOCAL_RANK``, 0 by default)."""
    return _env_int("LOCAL_RANK") or 0


def rank_device(device) -> torch.device:
    """``cuda`` becomes this rank's ``cuda:LOCAL_RANK``; anything else is
    returned as given."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", local_rank())
    return device


def process_shard() -> Optional[Tuple[int, int]]:
    """(rank, world size) for ``Batcher(process_shard=...)``, or None for
    one process."""
    n = world_size()
    return (rank(), n) if n > 1 else None


def local_batch_slice(global_batch_size: int) -> Tuple[int, int]:
    """(start, size) of this rank's contiguous slice of a global batch: the
    slice ``Batcher(process_shard=...)`` keeps, in the rank order of
    ``parallel.mesh.create_mesh``."""
    n, i = world_size(), rank()
    assert global_batch_size % n == 0, (global_batch_size, n)
    per = global_batch_size // n
    return i * per, per


def barrier() -> None:
    """Wait for every rank; a no-op for one process."""
    if is_distributed():
        dist.barrier()


def run_ranks(commands: Sequence[Sequence[str]], envs: Sequence[Dict[str, str]], timeout: float,
              cwd: Optional[str] = None) -> List[str]:
    """Start one process a rank (``commands[r]`` in ``envs[r]``), wait for
    all of them and return their output (stdout and stderr). A rank that
    fails or outlives ``timeout`` seconds raises with the failing ranks'
    output; every rank still running is killed."""
    procs = [subprocess.Popen(list(c), env=e, cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c, e in zip(commands, envs)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode, log[-4000:]) for r, (p, log) in enumerate(zip(procs, logs)) if p.returncode]
    if bad:
        raise RuntimeError("rank failures:\n" + "\n".join(f"rank {r} exit {c}:\n{log}" for r, c, log in bad))
    return logs
