"""Device selection and the multi-process bring-up for the port's entry
points — port of ``jckx/utils/device.py:24-121``.

The reference picks cuda-else-cpu (``utils.py:4-8``); the port never falls
back quietly: an entry point runs on the card unless its caller asks for
the CPU by name, and with no card and no explicit device it raises. Under
``torchrun`` (``LOCAL_RANK`` set) a bare ``cuda`` is this process's card,
``cuda:{LOCAL_RANK}``; a device named with its index is taken as given.

One process per GPU, as PyTorch runs a data-parallel job: ``init_multihost``
brings up the default process group from torch's ``env://`` variables
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, as ``torchrun``
sets them), NCCL for a CUDA device and gloo for the CPU.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch
import torch.distributed as dist


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` → ``cuda`` (``cuda:{LOCAL_RANK}`` under ``torchrun``); an
    explicit device is taken as given. Raises ``RuntimeError`` when CUDA is
    wanted and ``torch.cuda.is_available()`` is false."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return dev


def _count(var: str) -> int:
    try:
        return int(os.environ.get(var, ""))
    except ValueError:
        return 0


def cluster_env_present() -> bool:
    """True when the environment says this process is one of a
    MULTI-process job: torch's ``WORLD_SIZE`` > 1 (``MASTER_ADDR`` is part
    of such a job only beside that count), or a scheduler's task count > 1
    (``SLURM_NTASKS``, ``SLURM_NPROCS``, ``OMPI_COMM_WORLD_SIZE``). A count
    of 1 is a lone process, not a cluster."""
    return any(_count(v) > 1 for v in ("WORLD_SIZE", "SLURM_NTASKS", "SLURM_NPROCS",
                                       "OMPI_COMM_WORLD_SIZE"))


def init_multihost(device=None):
    """Bring up the default process group from the ``env://`` variables
    (``--multihost``, or a mesh of more than one rank): NCCL on a CUDA
    ``device`` (made this thread's current device first), gloo otherwise.

    Returns ``(ok, err)``: ``(True, None)`` once the group is up. On failure
    with NO cluster env present (the flag given on a lone machine) it
    degrades to ``(False, err)`` for the caller to warn about. With cluster
    env present the failure re-raises: this process is one of a real job,
    and going on alone would train N divergent copies of the run."""
    dev = torch.device("cpu" if device is None else device)
    try:
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method="env://")
        return True, None
    except Exception as e:  # noqa: BLE001 — classified below
        if cluster_env_present():
            raise
        return False, e


def multihost_barrier(name: str, logger=None) -> None:
    """All ranks meet here. A no-op without a process group or on one rank;
    a failure (a peer died) is logged naming the barrier and re-raised,
    never swallowed."""
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() <= 1:
        return
    try:
        dist.barrier()
    except Exception as e:
        msg = (f"multihost barrier {name!r} failed ({type(e).__name__}: {e}): a peer rank "
               f"died or stopped; check its log")
        if logger is not None:
            logger.error(msg)
        raise RuntimeError(msg) from e
