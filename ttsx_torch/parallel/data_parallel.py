"""Data parallelism over a mesh of ranks (``ttsx/parallel/data_parallel.py``).

The reference's mapping of DDP: parameters replicated, the batch sharded
on the mesh's dp axis, the gradient all-reduce inserted by XLA. Here
each rank is a process (``ttsx_torch.core.mesh``): ``replicate``
broadcasts rank 0's tensors, ``shard_batch_dp`` keeps this rank's rows,
``dp_train_step`` runs a step on them inside ``with mesh:`` (where
``TrainState.apply_gradients`` averages the gradients over the ranks
before the optimizer), and ``dp_synthesis`` runs synthesis on this
rank's rows and all-gathers the outputs in rank order, so every rank
returns the whole batch.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch
import torch.distributed as dist
from torch import nn

from ttsx_torch.core.config import MeshConfig
from ttsx_torch.core.mesh import Mesh, dp_rows, make_mesh, shard_batch


def make_dp_mesh(n: int | None = None, device="cuda") -> Mesh:
    """A dp-only mesh over the default group's ``n`` ranks (its world
    size when None; any other ``n`` raises, as a process cannot join a
    mesh that leaves it out)."""
    world = dist.get_world_size() if dist.is_initialized() else None
    if n is not None and world is not None and n != world:
        raise ValueError(f"a dp mesh of {n} ranks in a world of {world}")
    return make_mesh(MeshConfig(dp=n or -1, tp=1), device=device)


def shard_batch_dp(batch: Dict, mesh: Mesh) -> Dict:
    """This rank's rows of every array of ``batch`` (see ``shard_batch``)."""
    return shard_batch(batch, mesh)


def _tensors(obj: Any, out: List[torch.Tensor]) -> None:
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, nn.Module):
        out.extend(obj.parameters())
        out.extend(obj.buffers())
    elif isinstance(obj, dict):
        for v in obj.values():
            _tensors(v, out)
    elif hasattr(obj, "state_dict"):
        _tensors(obj.state_dict(), out)


@torch.no_grad()
def replicate(obj: Any, mesh: Mesh) -> Any:
    """Rank 0's values, in place on every rank, of every floating-point
    tensor on the mesh's device in ``obj``: a module's parameters and
    buffers, a ``TrainState`` or a train block (their ``state_dict``:
    parameters, buffers, Adam moments, the EMA), or a dict of these.
    Returns ``obj``."""
    if mesh.size == 1:
        return obj
    found: List[torch.Tensor] = []
    _tensors(obj, found)
    seen = set()
    for t in found:
        if (not t.is_floating_point() or t.device != mesh.device
                or t.data_ptr() in seen):
            continue
        seen.add(t.data_ptr())
        buf = t if t.is_contiguous() else t.contiguous()
        dist.broadcast(buf, src=0)
        if buf is not t:
            t.copy_(buf)
    return obj


def dp_train_step(step_fn: Callable, mesh: Mesh) -> Callable:
    """``step_fn(batch, *args)`` run on this rank's rows of ``batch``
    inside ``with mesh:``; the blocks' updates average their gradients
    over the ranks before the optimizer, the reference's all-reduce."""

    def wrapped(batch, *args, **kwargs):
        with mesh:
            return step_fn(shard_batch(batch, mesh), *args, **kwargs)

    return wrapped


def _gather(out, mesh: Mesh):
    """A tensor, or a tuple or NamedTuple of tensors (``SynthesisOutput``),
    gathered over dp."""
    if isinstance(out, torch.Tensor):
        return mesh.all_gather(out, "dp")
    gathered = [_gather(v, mesh) for v in out]
    return type(out)(*gathered) if hasattr(out, "_fields") else tuple(gathered)


def dp_synthesis(synth_fn: Callable, mesh: Mesh) -> Callable:
    """``synth_fn(*batched_inputs)`` on this rank's rows of each tensor
    input (other inputs as given) inside ``with mesh:``, its output (a
    tensor or a tuple of them) all-gathered over dp in rank order: every
    rank returns the whole batch's outputs."""

    def wrapped(*batched_inputs):
        with mesh:
            local = [dp_rows(x, mesh) if isinstance(x, torch.Tensor)
                     and x.ndim >= 1 else x for x in batched_inputs]
            return _gather(synth_fn(*local), mesh)

    return wrapped
