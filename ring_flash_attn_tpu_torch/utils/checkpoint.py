"""Checkpoint and resume of training state.

The port of ``ring_flash_attn_tpu/utils/checkpoint.py``, without orbax
(the JAX package's checkpointer): the state is written with ``torch.save``
from CPU copies of its tensors to ``path/state.pt``, with JAX's JSON
sidecar ``path/meta.json`` holding the step and the caller's metadata (the
dropout seed schedule, the data position: what must resume exactly).

``state`` is a dict (nested dicts and lists allowed) of tensors, an
``nn.Module``'s ``state_dict()`` among them. A restore places it on the
card by default, as every entry point does, or where ``device`` says, and
with ``like`` (``abstract_like`` of the state to resume: shapes and dtypes
as tensors on the meta device, which hold no data) checks that the
checkpoint has that structure, shapes and dtypes. JAX restores a sharded
tree onto a mesh through its shardings; here a tensor-parallel rank
restores the whole parameters and cuts its shards with
``models.shard_params`` (which takes a state dict), as it cuts them from a
whole model.
"""

import json
import os

import torch

from ..config import resolve_device

__all__ = ["save_checkpoint", "restore_checkpoint", "abstract_like"]


def _map(fn, tree, where="state"):
    """``tree`` with ``fn(leaf, where)`` for every tensor leaf; dicts and
    lists (tuples) keep their structure, other leaves raise."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, where)
    if isinstance(tree, dict):
        return {k: _map(fn, v, f"{where}[{k!r}]") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, f"{where}[{i}]")
                          for i, v in enumerate(tree))
    raise TypeError(f"{where}: a checkpoint holds tensors in dicts and "
                    f"lists, got {type(tree).__name__}")


def save_checkpoint(path, state, step, metadata=None):
    """Save ``state`` (a nested dict / list of tensors), the step and
    JSON-able metadata under the directory ``path``: ``state.pt`` (CPU
    copies of the tensors) and ``meta.json``. Overwrites what is there;
    each file is written under a temporary name and then renamed."""
    path = str(path)
    os.makedirs(path, exist_ok=True)
    cpu = _map(lambda t, _: t.detach().to("cpu", copy=True), state)
    tmp = os.path.join(path, "state.pt.tmp")
    torch.save(cpu, tmp)
    os.replace(tmp, os.path.join(path, "state.pt"))
    tmp = os.path.join(path, "meta.json.tmp")
    with open(tmp, "w") as f:
        json.dump({"step": int(step), "metadata": metadata or {}}, f)
    os.replace(tmp, os.path.join(path, "meta.json"))


def _check_like(state, like, where="state"):
    """Raise ValueError where ``state`` differs from ``like`` in
    structure, a shape or a dtype."""
    if isinstance(like, torch.Tensor):
        if not isinstance(state, torch.Tensor):
            raise ValueError(f"{where}: expected a tensor, the checkpoint "
                             f"holds {type(state).__name__}")
        if state.shape != like.shape or state.dtype != like.dtype:
            raise ValueError(f"{where}: the checkpoint holds {state.dtype} "
                             f"{tuple(state.shape)}, expected {like.dtype} "
                             f"{tuple(like.shape)}")
        return
    if isinstance(like, dict):
        if not isinstance(state, dict) or set(state) != set(like):
            got = sorted(state) if isinstance(state, dict) else type(state)
            raise ValueError(f"{where}: the checkpoint holds keys {got}, "
                             f"expected {sorted(like)}")
        for k in like:
            _check_like(state[k], like[k], f"{where}[{k!r}]")
        return
    if isinstance(like, (list, tuple)):
        if not isinstance(state, (list, tuple)) or len(state) != len(like):
            raise ValueError(f"{where}: the checkpoint's structure differs "
                             f"from the expected list of {len(like)}")
        for i, (s, l) in enumerate(zip(state, like)):
            _check_like(s, l, f"{where}[{i}]")
        return
    raise TypeError(f"{where}: like= holds {type(like).__name__}")


def restore_checkpoint(path, like=None, device="cuda"):
    """Restore (state, step, metadata) from the directory ``path``.

    ``like``: the expected structure, shapes and dtypes (``abstract_like``
    of the state to resume, or the state itself); a checkpoint that
    differs raises ValueError. The tensors are placed on ``device`` (the
    card by default)."""
    path = str(path)
    dev = resolve_device(device)
    state = torch.load(os.path.join(path, "state.pt"), map_location="cpu",
                       weights_only=True)
    if like is not None:
        _check_like(state, like)
    state = _map(lambda t, _: t.to(dev), state)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return state, int(meta["step"]), meta.get("metadata", {})


def abstract_like(tree):
    """``tree`` with every tensor replaced by an empty tensor of its shape
    and dtype on the meta device (JAX's ShapeDtypeStruct), for
    ``restore_checkpoint(like=...)``. A module is taken by its
    ``state_dict()``."""
    if isinstance(tree, torch.nn.Module):
        tree = tree.state_dict()
    return _map(lambda t, _: torch.empty(t.shape, dtype=t.dtype,
                                         device="meta"), tree)
