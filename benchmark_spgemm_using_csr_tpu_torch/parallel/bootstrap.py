"""Multi-host process bootstrap: join a torch.distributed job that someone
else launched (one process per device, on one host or many).

Launch recipe (every process; rank 0's host also serves the rendezvous):

    # process i of N, each driving its host's cuda:LOCAL_RANK
    COORDINATOR_ADDRESS=host0:9876 NUM_PROCESSES=N PROCESS_ID=$i \\
        python -m benchmark_spgemm_using_csr_tpu_torch suite:er_medium \\
            --multihost --mesh N --schedule halo

torchrun's variables serve as well (``MASTER_ADDR``/``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), so ``torchrun --nproc-per-node
G --nnodes H ... -m benchmark_spgemm_using_csr_tpu_torch ... --multihost``
works unchanged. After ``init_multihost()``, ``global_mesh()`` is the 1D
row mesh over every process, and every schedule of ``parallel.dist`` and
``parallel.halo`` runs on it.
"""
from __future__ import annotations

import dataclasses
import datetime
import logging
import os

import torch

log = logging.getLogger(__name__)

# the bound on any one collective of the job's process group
PG_TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True)
class HostTopology:
    process_id: int
    process_count: int
    global_devices: int  # devices of the whole job, one per process
    coordinator: str | None
    backend: str
    device: torch.device


def _env_int(*names):
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def init_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device: str | None = None,
) -> HostTopology:
    """Initialize torch.distributed and return the topology.

    The arguments default to COORDINATOR_ADDRESS / NUM_PROCESSES /
    PROCESS_ID, then to torchrun's MASTER_ADDR:MASTER_PORT / WORLD_SIZE /
    RANK. The device is cuda:LOCAL_RANK over NCCL, unless ``device="cpu"``
    asks for the CPU over gloo.
    Idempotent: a second call in the process returns the existing
    topology."""
    already = torch.distributed.is_initialized()
    if not already:
        if coordinator_address is None:
            coordinator_address = os.environ.get("COORDINATOR_ADDRESS")
        if coordinator_address is None and os.environ.get("MASTER_ADDR"):
            coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                                   f"{os.environ.get('MASTER_PORT', '29500')}")
        if num_processes is None:
            num_processes = _env_int("NUM_PROCESSES", "WORLD_SIZE")
        if process_id is None:
            process_id = _env_int("PROCESS_ID", "RANK")
        if None in (coordinator_address, num_processes, process_id):
            raise ValueError(
                "init_multihost needs the coordinator address, the number "
                "of processes and this process's id (arguments, "
                "COORDINATOR_ADDRESS/NUM_PROCESSES/PROCESS_ID, or torchrun's "
                "MASTER_ADDR/WORLD_SIZE/RANK)")
        if device is None:
            device = "cuda"
        if device == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("init_multihost: no CUDA device is "
                                   "available (device='cpu' runs gloo)")
            torch.cuda.set_device(_env_int("LOCAL_RANK") or 0)
        elif device != "cpu":
            raise ValueError(f"device {device!r}: 'cuda' or 'cpu'")
        torch.distributed.init_process_group(
            "nccl" if device == "cuda" else "gloo",
            init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id,
            timeout=datetime.timedelta(seconds=PG_TIMEOUT_S),
        )
    from .mesh import default_device

    backend = torch.distributed.get_backend()
    topo = HostTopology(
        process_id=torch.distributed.get_rank(),
        process_count=torch.distributed.get_world_size(),
        global_devices=torch.distributed.get_world_size(),
        coordinator=coordinator_address,
        backend=backend,
        device=default_device(),
    )
    log.info("multihost%s: process %d/%d over %s on %s",
             " (already initialized)" if already else "",
             topo.process_id, topo.process_count, backend, topo.device)
    return topo


def global_mesh(n_devices: int | None = None):
    """The 1D row mesh over the first ``n_devices`` processes of the job
    (all by default; call after ``init_multihost``, on every process)."""
    from .mesh import make_mesh

    return make_mesh(n_devices)


def shutdown() -> None:
    """Tear the process group down (safe if it is not up)."""
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
