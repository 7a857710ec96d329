"""``torch.distributed`` bootstrap from the runtime env contract.

Counterpart of ``skypilot_tpu/parallel/distributed.py``. The gang driver
(``skypilot_tpu/runtime/driver.py``) injects ``JAX_COORDINATOR_ADDRESS``
/ ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID`` on every host, plus
``MEGASCALE_*`` on multislice clusters (``runtime/constants.py``). The
port reads the same variables, so one job's env starts either package:
:func:`initialize_from_env` joins the cluster-wide rendezvous with no
arguments, ``tcp://<coordinator>`` as torch's store, the process id as
the rank and the process count as the world size.

One deliberate difference: one process drives one card, torch's idiom
(NCCL puts one rank on a card), where a JAX process drives every chip of
its host. A host with several cards therefore runs one process per card;
starting those from one host's env is left for later.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch.distributed as dist

from skypilot_tpu_torch import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class ProcessTopology:
    num_processes: int
    process_id: int
    num_slices: int
    slice_id: int
    coordinator: Optional[str]


def topology_from_env() -> ProcessTopology:
    coord = os.environ.get("JAX_COORDINATOR_ADDRESS")
    num = int(os.environ.get("JAX_NUM_PROCESSES")
              or os.environ.get("SKYTPU_NUM_HOSTS") or "1")
    pid = int(os.environ.get("JAX_PROCESS_ID")
              or os.environ.get("SKYTPU_HOST_ID") or "0")
    n_slices = int(os.environ.get("MEGASCALE_NUM_SLICES") or "1")
    slice_id = int(os.environ.get("MEGASCALE_SLICE_ID") or "0")
    return ProcessTopology(num, pid, n_slices, slice_id, coord)


def backend_for(device: DeviceLike = None) -> str:
    """NCCL for a card, gloo for the CPU."""
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def initialize_from_env(device: DeviceLike = None) -> ProcessTopology:
    """Join the cluster-wide ``torch.distributed`` rendezvous using only
    the injected env. No-op for single-process jobs. Idempotent: a
    process already in a group stays in it."""
    topo = topology_from_env()
    if (topo.num_processes > 1 and topo.coordinator
            and not dist.is_initialized()):
        dist.init_process_group(
            backend_for(device),
            init_method=f"tcp://{topo.coordinator}",
            rank=topo.process_id, world_size=topo.num_processes)
    return topo


def world_size() -> int:
    """Ranks in the default group; 1 outside one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank in the default group; 0 outside one."""
    return dist.get_rank() if dist.is_initialized() else 0
