"""Run a function on n ranks of a fresh process group, one spawned
process per rank.

A spawned child imports the module that holds its function, which must
therefore import no JAX (the tasks of ``dryrun.py``, of
``utils/smoke_parallel.py`` and of the tests' ``torch_spawn_tasks.py``).
Each child uses one CPU thread, joins the group through a ``file://``
rendezvous in a temporary directory, runs its task and saves the result
there; a child that fails makes :func:`run` raise
(``torch.multiprocessing.spawn``'s exception is not caught).
"""

from __future__ import annotations

import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..utils.precision import resolve_device
from .multihost import initialize_distributed


def run(task, world: int, *args, backend: str | None = None, device: str = "cuda") -> list:
    """``task(*args)`` on ``world`` ranks of a new process group, each with
    ``device`` as its device: CUDA unless the caller asks for the CPU,
    rank r on card r % the card count.  ``backend`` defaults to NCCL on
    CUDA and gloo on the CPU (gloo on CUDA stages every transfer through
    the host, see ``comm``).  Returns the ranks' results in rank order."""
    device = resolve_device(device).type
    if backend is None:
        backend = "nccl" if device == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_entry, args=(world, tmp, backend, device, task, args), nprocs=world,
                 join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]


def _entry(rank, world, tmp, backend, device, task, args):
    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    initialize_distributed(f"file://{os.path.join(tmp, 'rendezvous')}", world, rank, backend)
    try:
        torch.save(task(*args), os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
