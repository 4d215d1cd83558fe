"""Process-group bootstrap and each rank's share of the global batch (a port
of the JAX package's ``parallel/distributed.py``).

The reference trained with Lightning DDP, one process per GPU over NCCL.
The JAX package runs one controller per host and assembles each host's rows
into one global array (its ``global_batch_from_host_local``). The port runs
one process per device, as the reference did: a rank's batch already is its
share of the global batch, on its own device, so that assembly has no
counterpart here. ``torchrun`` (``python -m torch.distributed.run``)
launches the ranks and sets their environment.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

from predict_pv_yield_tpu_torch.parallel.mesh import build_mesh
from predict_pv_yield_tpu_torch.utils import resolve_device

log = logging.getLogger(__name__)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
) -> None:
    """Join the process group.

    Pass the three arguments, or launch with ``torchrun``, whose environment
    (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``) fills what is not passed; ``coordinator_address`` is
    ``host:port`` or a ``tcp://`` URL. A no-op when nothing is configured (a
    plain single-process run) or the group exists already. The backend is
    NCCL on ``cuda:{LOCAL_RANK}``, and gloo only for ``device="cpu"``; a
    NCCL that fails raises, with no fallback to gloo.
    """
    env = os.environ
    if dist.is_initialized():
        return
    if coordinator_address is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and env.get("WORLD_SIZE") is not None:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK") is not None:
        process_id = int(env["RANK"])
    if coordinator_address is None and process_id is None and num_processes in (None, 1):
        log.debug("single-process run; no process group")
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            f"initialize_distributed: coordinator {coordinator_address!r}, {num_processes} processes, "
            f"process {process_id}: all three are needed"
        )
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", device.index or 0)))
        backend = "nccl"
    else:
        backend = "gloo"
    init_method = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes, rank=process_id)
    log.info("distributed initialised: rank %d of %d over %s", process_id, num_processes, backend)


def host_local_batch_slice(global_batch_size: int, mesh=None) -> slice:
    """The rows of a global batch this rank loads: the block of its data
    coordinate over the data size (default mesh: every rank on the data
    axis). The ranks of one model group load the same rows. In the JAX
    package one process holds all of its devices, so process and data shard
    coincide there; here a process is one rank of a replica."""
    mesh = build_mesh() if mesh is None else mesh
    per_rank, remainder = divmod(global_batch_size, mesh.data)
    if remainder:
        raise ValueError(f"global batch {global_batch_size} must be divisible by the data size {mesh.data}")
    start = mesh.data_index * per_rank
    return slice(start, start + per_rank)
