"""Joining the processes of a job and cutting them into a (dp, sp) grid.

The port of ``ring_flash_attn_tpu/utils/multihost.py``. JAX joins its
hosts with ``jax.distributed.initialize`` and lays its devices out on a
``Mesh``; here every card is a process of ``torch.distributed`` (the
reference's ``dist.init_process_group``), and a mesh axis is a process
group. ``initialize_multihost`` joins the default group from torchrun's
environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``) or from its arguments; ``make_cp_mesh`` returns this
process's data-parallel and sequence-parallel groups in JAX's layout.

Unlike the JAX function, a failure to join raises: only an existing group
and a single process with no environment make it a no-op.
"""

import os

import torch
import torch.distributed as dist

__all__ = ["initialize_multihost", "make_cp_mesh"]


def _env_int(name):
    value = os.environ.get(name)
    return None if value is None else int(value)


def initialize_multihost(init_method=None, world_size=None, rank=None,
                         device="cuda"):
    """Join the default process group.

    ``init_method`` (e.g. ``"tcp://host:port"``), ``world_size`` and
    ``rank`` default to torchrun's environment (``env://`` from
    ``MASTER_ADDR`` and ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``). The
    backend follows ``device``: ``nccl`` on the card (each process on the
    card ``LOCAL_RANK``, else ``rank`` modulo the cards), ``gloo`` for
    ``device="cpu"``. A no-op when a default group exists, or when there
    is one process and no environment names a group. Returns True when
    this call joined a group."""
    if dist.is_initialized():
        return False
    world_size = world_size if world_size is not None else _env_int(
        "WORLD_SIZE")
    rank = rank if rank is not None else _env_int("RANK")
    if init_method is None and "MASTER_ADDR" in os.environ:
        init_method = "env://"
    if init_method is None and (world_size or 1) == 1:
        return False  # one process and nothing to join
    if init_method is None or world_size is None or rank is None:
        raise ValueError(f"joining a group of {world_size} needs an "
                         f"init_method (or MASTER_ADDR/MASTER_PORT), a "
                         f"world_size and a rank: got {init_method!r}, "
                         f"{world_size}, {rank}")
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cpu or cuda, got {device!r}")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        local = _env_int("LOCAL_RANK")
        torch.cuda.set_device(local if local is not None
                              else rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return True


def make_cp_mesh(dp=1, sp=None):
    """(dp_group, sp_group) of this process on a (dp, sp) grid of all the
    default group's processes, laid out as JAX's ``make_cp_mesh``
    (``devices.reshape(dp, sp)``, sp varying fastest): rank r is data
    index ``r // sp`` and sequence index ``r % sp``; its sequence group is
    the ranks ``[r // sp * sp, ...)`` in a run, its data group every
    sp-th rank. Every process creates every group, in one order, as
    ``dist.new_group`` requires. Without a default group the world is one
    process and both groups are ``None`` (the port's one-process group)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if sp is None:
        if world % dp:
            raise ValueError(f"dp={dp} does not divide {world} processes")
        sp = world // dp
    if dp * sp != world:
        raise ValueError(f"dp={dp} x sp={sp} != {world} processes")
    if not dist.is_initialized():
        return None, None
    rank = dist.get_rank()
    sp_groups = [dist.new_group([d * sp + s for s in range(sp)])
                 for d in range(dp)]
    dp_groups = [dist.new_group([d * sp + s for d in range(dp)])
                 for s in range(sp)]
    return dp_groups[rank % sp], sp_groups[rank // sp]
