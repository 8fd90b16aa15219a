"""Process-group start-up (port of
``research_image_retrieval_tpu/parallel/dist_init.py``).

JAX runs one controller per host over all of its local devices; the port
runs one process per GPU, the torch idiom, launched by ``torchrun`` or
SLURM.  ``init_distributed_mode`` resolves the world as the JAX function
does (explicit arguments, then ``RANK`` / ``WORLD_SIZE``, then
``SLURM_PROCID`` / ``SLURM_NTASKS``), starts ``torch.distributed`` with
the backend the device asks for (NCCL for CUDA, gloo for the CPU; a
failed NCCL start raises and is never retried on gloo), sets
``LOCAL_RANK`` and makes ``cuda:LOCAL_RANK`` this process's device.
"""

from __future__ import annotations

import builtins
import os

import torch
import torch.distributed as dist

__all__ = [
    "get_rank",
    "get_world_size",
    "init_distributed_mode",
    "is_main_process",
    "local_device",
    "setup_for_distributed",
]


def _local_rank(rank: int) -> int:
    for key in ("LOCAL_RANK", "SLURM_LOCALID"):
        if key in os.environ:
            return int(os.environ[key])
    return rank


def init_distributed_mode(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    quiet_non_main: bool = True,
    backend: str | None = None,
    device="cuda",
    force: bool = False,
) -> bool:
    """Start ``torch.distributed`` if the arguments or the environment ask
    for more than one process; returns whether a group was started.

    ``backend`` None takes NCCL for a CUDA ``device`` and gloo for the
    CPU; pass "gloo" explicitly to run gloo collectives on CUDA tensors
    (several ranks sharing one card).  A ``device`` with an index
    (``"cuda:0"``) pins every rank to that card; a bare ``"cuda"`` takes
    ``cuda:LOCAL_RANK``.  ``force=True`` starts a group of one process
    too (``num_processes`` 1, rank 0 unless given), so that the
    distributed path runs at world size 1.  The rendezvous is TCP at
    ``coordinator_address`` (``host:port``), else ``COORDINATOR_ADDRESS``,
    else ``MASTER_ADDR:MASTER_PORT`` (torchrun sets both).
    """
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialized")
    if num_processes is None:
        if "WORLD_SIZE" in os.environ:
            num_processes = int(os.environ["WORLD_SIZE"])
            process_id = int(os.environ.get("RANK", 0))
        elif "SLURM_NTASKS" in os.environ and "SLURM_PROCID" in os.environ:
            num_processes = int(os.environ["SLURM_NTASKS"])
            process_id = int(os.environ["SLURM_PROCID"])
        elif force:
            num_processes, process_id = 1, 0
        else:
            print("Not using distributed mode")
            return False
    process_id = int(process_id or 0)
    if num_processes <= 1 and not force:
        return False
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend needs a CUDA device")
    local = _local_rank(process_id)
    os.environ["LOCAL_RANK"] = str(local)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but "
                               "torch.cuda.is_available() is False")
        torch.cuda.set_device(dev.index if dev.index is not None else local)
    coordinator_address = coordinator_address or os.environ.get(
        "COORDINATOR_ADDRESS", os.environ.get("MASTER_ADDR", "localhost")
        + ":" + os.environ.get("MASTER_PORT", "1234"))
    kw = {}
    if backend == "nccl":
        kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id, **kw)
    if quiet_non_main:
        setup_for_distributed(is_main_process())
    print(f"| distributed init: process {get_rank()}/{get_world_size()}, "
          f"backend {backend}, device {local_device(device)}")
    return True


def local_device(device="cuda") -> torch.device:
    """This process's device: a CUDA device without an index becomes
    ``cuda:LOCAL_RANK`` in a distributed run, the current device
    otherwise; anything else is returned as given."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if dist.is_initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    return get_rank() == 0


def setup_for_distributed(is_master: bool):
    """Silence ``print`` on every rank but the main one (``force=True``
    prints anyway)."""
    builtin_print = builtins.print

    def print_(*args, **kwargs):
        force = kwargs.pop("force", False)
        if is_master or force:
            builtin_print(*args, **kwargs)

    builtins.print = print_
