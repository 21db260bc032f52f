"""The series mesh, multi-process bring-up and the port's collectives (port
of the reference's ``parallel/mesh.py``).

Fits are independent, so the only collective traffic in this problem is
small reductions of per-series metrics, the gather of reconciled bottoms,
and the carries of the time-sharded scans.  The reference lays one mesh
axis, ``"series"``, over the devices of one controller; the port runs the
same layout SPMD, one process (rank) per device, over ``torch.distributed``:

  * :func:`initialize_distributed` brings a rank into the process group
    from the reference's three conf keys (``tasks/common.py``'s
    ``distributed:`` block calls it), or from a store the caller holds
    (a replica's own ranks, ``serving/replica.py``);
  * :func:`make_mesh` returns a 1-D ``DeviceMesh`` named ``"series"`` over
    the group's ranks (bringing up a one-rank group itself when the
    process has none);
  * :func:`all_reduce_sum` and :func:`all_gather_rows` are the only two
    collectives the sharded functions use.

The backend comes from a rule, :func:`choose_backend`, never from a failed
attempt: NCCL where each rank on the host has a card of its own, gloo
otherwise (CPU ranks, or several ranks sharing one card: NCCL refuses two
ranks on one device).  Gloo takes CUDA tensors for both collectives
(torch 2.11 on an H100, ``chip_smoke.py`` phase 22), so the helpers pass a
rank's tensors as they are, whatever the backend.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from distributed_forecasting_tpu_torch.utils.device import resolve_device
from distributed_forecasting_tpu_torch.utils.logging import get_logger

SERIES_AXIS = "series"

_logger = get_logger("parallel.mesh")

# set once this process has joined a group through initialize_distributed
_DISTRIBUTED_UP = False
# where this rank's tensors live, as initialize_distributed resolved it
_RANK_DEVICE: Optional[torch.device] = None


def choose_backend(device_type: str, local_ranks: int,
                   device_count: int) -> str:
    """``"nccl"`` when the ranks are on cards and each rank on the host has
    a card of its own (``local_ranks <= device_count``), else ``"gloo"``."""
    if device_type == "cuda" and 0 < local_ranks <= device_count:
        return "nccl"
    return "gloo"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
    store=None,
    timeout=None,
) -> Optional[torch.device]:
    """Multi-process bring-up from the ``distributed:`` conf block, or from
    a store the caller holds.

    Wraps ``torch.distributed.init_process_group`` with the init method
    ``tcp://<coordinator_address>`` (``env://`` when no address is given),
    or with ``store``, a ``torch.distributed.TCPStore`` the caller started
    (a serving replica starts one on a free port for its own ranks, so two
    replicas of one fleet never meet in a group), ``world_size=
    num_processes`` and ``rank=process_id``; ``timeout`` bounds each
    collective.  A no-op for ``num_processes`` of None, 0 or 1 (the common
    single-process case), and idempotent: a workflow builds one task per
    node, each of which may carry the same block.

    Each rank runs on ``cuda:<local rank % device_count>`` unless
    ``device="cpu"``; the local rank is ``LOCAL_RANK`` when a launcher sets
    it, else ``process_id``, and the ranks on this host are
    ``LOCAL_WORLD_SIZE``, else ``num_processes`` (set it on a multi-host
    run; with a ``store`` every rank is on this host and the environment
    is not read).  So on one host rank ``r`` has ``cuda:r`` under NCCL, and with one
    card every rank has ``cuda:0`` under gloo.  The backend follows
    :func:`choose_backend`, and is logged.  Returns the rank's device (None
    for the no-op).
    """
    global _DISTRIBUTED_UP, _RANK_DEVICE
    if num_processes in (None, 0, 1):
        return None
    if _DISTRIBUTED_UP:
        return _RANK_DEVICE
    import torch.distributed as dist

    dev = resolve_device(device)
    if dist.is_initialized():  # brought up outside this wrapper
        _DISTRIBUTED_UP, _RANK_DEVICE = True, dev
        return dev
    world = int(num_processes)
    rank = -1 if process_id is None else int(process_id)
    if store is not None:  # the caller's own ranks, all on this host
        local_rank, local_ranks = max(rank, 0), world
    else:
        local_rank = int(os.environ.get("LOCAL_RANK", max(rank, 0)))
        local_ranks = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    count = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend = choose_backend(dev.type, local_ranks, count)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % count)
        torch.cuda.set_device(dev)
    if store is not None:
        how = {"store": store}
    else:
        how = {"init_method": (f"tcp://{coordinator_address}"
                               if coordinator_address else "env://")}
    _logger.info("torch.distributed: rank %s of %d on %s, backend %s "
                 "(%d rank(s) on this host, %d card(s)), %s", process_id,
                 world, dev, backend, local_ranks, count,
                 how.get("init_method", "a store the caller holds"))
    if timeout is not None:
        how["timeout"] = timeout
    dist.init_process_group(backend=backend, world_size=world, rank=rank,
                            **how)
    _DISTRIBUTED_UP, _RANK_DEVICE = True, dev
    return dev


def _single_rank_group(dev: torch.device) -> None:
    """A one-rank group over an in-process store: NCCL on the card, gloo
    on the CPU (the single-host case of :func:`make_mesh`)."""
    import torch.distributed as dist

    global _RANK_DEVICE
    backend = choose_backend(dev.type, 1, torch.cuda.device_count()
                             if dev.type == "cuda" else 0)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device()
                           if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
    _logger.info("torch.distributed: one rank on %s, backend %s", dev,
                 backend)
    dist.init_process_group(backend=backend, store=dist.HashStore(),
                            world_size=1, rank=0)
    _RANK_DEVICE = dev


def make_mesh(n_devices: Optional[int] = None, device=None,
              axis_name: str = SERIES_AXIS):
    """1-D ``DeviceMesh`` over the series axis, one rank per device.

    It spans the default group's ranks.  With no group and ``n_devices`` in
    (None, 1) it brings up a one-rank group itself.  ``device``: where the
    ranks' tensors live — the device :func:`initialize_distributed` chose,
    else the card (raising without one) unless ``device="cpu"``.  Asking
    for more devices than the group has ranks raises ``ValueError``; a
    mesh over part of the group is not supported (each rank is one
    device of the mesh).
    """
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    dev = resolve_device(device if device is not None else _RANK_DEVICE)
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(
                f"requested {n_devices} devices but this process has no "
                f"torch.distributed group (one rank, one device); bring the "
                f"ranks up with initialize_distributed first")
        _single_rank_group(dev)
    world = dist.get_world_size()
    if n_devices is not None and n_devices > world:
        raise ValueError(
            f"requested {n_devices} devices but the group has {world} "
            f"rank(s), one device each; start {n_devices} ranks")
    if n_devices is not None and n_devices != world:
        raise ValueError(
            f"requested {n_devices} devices of a {world}-rank group; the "
            f"mesh spans every rank of the group")
    return DeviceMesh.from_group(dist.group.WORLD, dev.type,
                                 mesh_dim_names=(axis_name,))


# -- the mesh as the sharded functions read it --------------------------------

def mesh_group(mesh, axis_name: str = SERIES_AXIS):
    """The process group of the mesh's ``axis_name`` dimension."""
    return mesh.get_group(axis_name)


def mesh_size(mesh, axis_name: str = SERIES_AXIS) -> int:
    """Ranks (devices) along ``axis_name``."""
    return mesh.size(mesh.mesh_dim_names.index(axis_name))


def mesh_rank(mesh, axis_name: str = SERIES_AXIS) -> int:
    """This rank's coordinate along ``axis_name``: its block of the axis."""
    return mesh.get_local_rank(axis_name)


def mesh_device(mesh) -> torch.device:
    """The device this rank's tensors go to."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


# -- collectives ----------------------------------------------------------------

def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise sum of ``x`` over the group's ranks, on ``x``'s device
    (``x`` itself is not changed)."""
    import torch.distributed as dist

    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along axis 0 in rank order, on
    ``x``'s device; ``x`` has the same shape on every rank."""
    import torch.distributed as dist

    src = x.detach().contiguous()
    world = dist.get_world_size(group)
    out = src.new_empty((world * src.shape[0],) + tuple(src.shape[1:]))
    # all_gather_into_tensor is deprecated in favour of all_gather_single
    # where torch has it
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    gather(out, src, group=group)
    return out
