"""Multi-process launch plumbing (reference ``romis_tpu/parallel/launch.py``).

The reference runs one process a host, all running the same SPMD program
over a global device mesh. The port runs one process a GPU (a rank), all
running the same frame on their own row bands (``parallel.mesh.Bands``),
joined by ``torch.distributed``: NCCL between CUDA devices, gloo when the
caller asks for the CPU (the CPU tests). ``maybe_init_distributed()`` joins
the ranks when a cluster is configured and does nothing otherwise, so one
code path serves one GPU, several, and the CPU:

    torchrun --nproc_per_node=4 -m romis_tpu_torch.cli --config scene.toml

or with the reference's variables, one process a GPU:

    COORDINATOR_ADDRESS=host0:1234 NUM_PROCESSES=4 PROCESS_ID=0 \\
        LOCAL_RANK=0 python -m romis_tpu_torch.cli --config scene.toml

The reference's ``ROMIS_AUTO_DISTRIBUTED`` (TPU pods that describe
themselves) has no counterpart: a GPU cluster names its rendezvous.
"""

from __future__ import annotations

import datetime
import os

import torch

# How long a collective waits for its peers before it fails.
DEFAULT_TIMEOUT_S = 600


def _cluster():
    """(init_method, world size, rank) from the environment, or None: the
    reference's COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID first,
    then torchrun's MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK."""
    env = os.environ
    addr, nproc, pid = (env.get("COORDINATOR_ADDRESS"),
                        env.get("NUM_PROCESSES"), env.get("PROCESS_ID"))
    if addr and nproc and pid is not None:
        return f"tcp://{addr}", int(nproc), int(pid)
    if (env.get("MASTER_ADDR") and env.get("MASTER_PORT")
            and env.get("WORLD_SIZE") and env.get("RANK") is not None):
        return "env://", int(env["WORLD_SIZE"]), int(env["RANK"])
    return None


def maybe_init_distributed(device=None,
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Initialise the default ``torch.distributed`` process group when a
    cluster is configured (see the module docstring) → True when this
    process is a rank of one. Safe to call unconditionally: without the
    variables it does nothing and returns False.

    ``device`` is the device the caller renders on: "cpu" joins with gloo;
    otherwise (the CUDA card, the default) the process first takes GPU
    ``LOCAL_RANK`` (else its rank modulo the GPUs) as its current device,
    before anything touches the card, and joins with NCCL."""
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    cluster = _cluster()
    if cluster is None:
        return False
    init_method, world, rank = cluster
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if not on_cpu:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "maybe_init_distributed: the ranks render on CUDA devices and "
                "none is available; pass device=\"cpu\" to join with gloo")
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else rank % torch.cuda.device_count())
    dist.init_process_group("gloo" if on_cpu else "nccl",
                            init_method=init_method, world_size=world,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def global_bands(height: int):
    """The calling rank's row band of an image of ``height`` rows over every
    rank of the cluster (the whole image in a single process): the
    counterpart of the reference's ``global_mesh``."""
    from .mesh import make_bands

    return make_bands(height)
