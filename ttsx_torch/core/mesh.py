"""The (dp, tp) mesh of ranks on ``torch.distributed`` (``ttsx/core/mesh.py``).

The reference is single-controller: one process sees every device of a
``jax.sharding.Mesh`` and XLA inserts the collectives. The port is SPMD:
one process per rank, each on its own device. A ``Mesh`` is a (dp, tp)
grid over the ranks of the default process group, rank ``d * tp + t``
at (d, t) as the reference's ``reshape(dp, tp)`` of its device list,
with a sub-group for each axis. Every rank reads the same global batch
from the same stream and keeps its own rows of the dp axis
(``shard_batch``), so the data stream, a resumed run's replay and the
seeds are those of one process.

``with mesh:`` makes it the active mesh, the counterpart of
``jax.set_mesh``, and the modules read it through ``active_mesh()``:

* ``TrainState.apply_gradients`` averages the gradients over every rank
  before the optimizer (and so before its clip);
* the VQ's EMA counts and sums add over dp and its restart rows index
  the global batch (``nn/vq.py``);
* masked means divide by the dp-global mask sum (``masked_denominator``);
* random draws are drawn at the global batch's shape and cut to this
  rank's rows (``global_rows``; ``nn.draws.mesh_draws``), dropout,
  diffusion noise, the emotion drop and the SDE sampler's noise alike;
* the generator's ``band_tp`` splits its bands over tp.

Nothing here starts a process group: the caller gives
``torch.distributed.init_process_group`` its address, world size and
rank. A mesh without an initialized group raises, and so does a backend
that does not match the device (NCCL for ``cuda``, gloo for ``cpu``).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ttsx_torch.core.config import MeshConfig

BACKEND = {"cuda": "nccl", "cpu": "gloo"}
_ACTIVE: List["Mesh"] = []


class Mesh:
    """A (dp, tp) grid over the default group's ranks on ``device``."""

    def __init__(self, dp: int, tp: int, device="cuda"):
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "no process group: call torch.distributed."
                "init_process_group(backend, init_method, world_size, rank) "
                "before building a mesh")
        world = dist.get_world_size()
        if dp * tp != world:
            raise ValueError(f"mesh dp*tp={dp * tp} != world size {world}")
        dev = torch.device(device)
        if dev.type not in BACKEND:
            raise ValueError(f"unsupported mesh device {device!r}")
        backend = dist.get_backend()
        want = BACKEND[dev.type]
        if not (backend == want
                or f"{dev.type}:{want}" in str(backend).split(",")):
            raise RuntimeError(
                f"process group backend {backend!r} does not serve "
                f"{dev.type} tensors: a {dev.type} mesh needs {want!r}")
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.dp, self.tp, self.device = dp, tp, dev
        self.rank, self.size = dist.get_rank(), world
        self.dp_rank, self.tp_rank = divmod(self.rank, tp)
        # every rank creates every group, in the same order
        self.dp_group = self.tp_group = None
        for t in range(tp):
            g = dist.new_group([d * tp + t for d in range(dp)])
            if t == self.tp_rank:
                self.dp_group = g
        for d in range(dp):
            g = dist.new_group([d * tp + t for t in range(tp)])
            if d == self.dp_rank:
                self.tp_group = g

    @property
    def shape(self):
        return (self.dp, self.tp)

    def __enter__(self) -> "Mesh":
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> bool:
        _ACTIVE.remove(self)
        return False

    # -- collectives ---------------------------------------------------
    def _axis(self, axis: Optional[str]):
        """(group, size) of ``axis``: "dp", "tp" or None for every rank."""
        if axis is None:
            return None, self.size
        if axis == "dp":
            return self.dp_group, self.dp
        if axis == "tp":
            return self.tp_group, self.tp
        raise ValueError(f"no mesh axis {axis!r}: 'dp', 'tp' or None")

    def all_reduce(self, x: torch.Tensor, axis: Optional[str] = None
                   ) -> torch.Tensor:
        """``x`` summed over ``axis`` (in place; no collective on an axis
        of one rank)."""
        group, n = self._axis(axis)
        if n > 1:
            dist.all_reduce(x, group=group)
        return x

    def all_gather(self, x: torch.Tensor, axis: Optional[str] = None
                   ) -> torch.Tensor:
        """Every rank's ``x`` of ``axis``, concatenated along dim 0 in rank
        order (equal shapes on every rank)."""
        group, n = self._axis(axis)
        if n == 1:
            return x
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=0)

    def barrier(self) -> None:
        """Returns on every rank once every rank has called it (the host
        waits for the collective)."""
        if self.size > 1:
            self.all_reduce(torch.zeros(1, device=self.device)).item()

    def time_all_reduce(self, numel: int, iters: int = 20) -> float:
        """Mean ms of an NCCL all-reduce of ``numel`` float32 over every
        rank, one rank included (CUDA events around ``iters`` calls after
        two warm-up calls)."""
        buf = torch.ones(numel, device=self.device)
        for _ in range(2):
            dist.all_reduce(buf)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            dist.all_reduce(buf)
        end.record()
        torch.cuda.synchronize(self.device)
        return start.elapsed_time(end) / iters

    def mean(self, values: Dict[str, float]) -> Dict[str, float]:
        """The mean of each float over every rank: the same floats on
        every rank, so that control flow reading them agrees."""
        if not values or self.size == 1:
            return dict(values)
        keys = sorted(values)
        v = self.all_reduce(torch.tensor([float(values[k]) for k in keys],
                                         dtype=torch.float64,
                                         device=self.device))
        return {k: float(x) / self.size for k, x in zip(keys, v.tolist())}


def make_mesh(cfg: MeshConfig | None = None, world: int | None = None,
              device="cuda") -> Mesh:
    """The (dp, tp) mesh over the default group's ``world`` ranks (its
    world size when None); dp -1 takes every rank that tp does not.
    Raises when dp * tp is not the world size. The axes are "dp" and "tp"
    whatever ``cfg.axis_names`` says (the reference's models name them
    so too)."""
    cfg = cfg or MeshConfig()
    if world is None:
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "no process group: call torch.distributed."
                "init_process_group before make_mesh")
        world = dist.get_world_size()
    tp = max(1, cfg.tp)
    dp = cfg.dp if cfg.dp > 0 else world // tp
    if dp * tp != world:
        raise ValueError(f"mesh dp*tp={dp * tp} != device count {world}")
    return Mesh(dp, tp, device)


def active_mesh() -> Optional[Mesh]:
    """The mesh of the innermost ``with mesh:``, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def dp_rows(x, mesh: Mesh):
    """This rank's rows of ``x`` (a tensor or an array) on the dp axis."""
    B = x.shape[0]
    if B % mesh.dp:
        raise ValueError(f"batch of {B} rows does not split over dp="
                         f"{mesh.dp}")
    b = B // mesh.dp
    return x[mesh.dp_rank * b:(mesh.dp_rank + 1) * b]


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of every array entry of a batch dict (or of one
    array) on the dp axis; other entries pass unchanged. Raises when a
    batch does not split evenly over dp."""
    if not isinstance(batch, dict):
        return dp_rows(batch, mesh)
    return {k: dp_rows(v, mesh)
            if isinstance(v, (torch.Tensor, np.ndarray)) and v.ndim >= 1
            else v for k, v in batch.items()}


def global_rows(draw: Callable, shape: Sequence[int],
                mesh: Optional[Mesh] = None) -> torch.Tensor:
    """``draw(shape)`` for a batch-major ``shape`` of this rank's rows:
    under a mesh of dp > 1, ``draw`` at the global batch's shape (dp x
    the rows) and this rank's rows of it, so that every rank advances
    its generator as one process would and holds the rows one process
    would give it."""
    mesh = mesh or active_mesh()
    shape = tuple(shape)
    if mesh is None or mesh.dp == 1:
        return draw(shape)
    b = shape[0]
    full = draw((b * mesh.dp,) + shape[1:])
    return full[mesh.dp_rank * b:(mesh.dp_rank + 1) * b]


def masked_denominator(mask_sum: torch.Tensor, floor: float = 1.0
                       ) -> torch.Tensor:
    """``max(mask_sum, floor)``, the denominator of a masked mean whose
    numerator sums this rank's rows; under a mesh of dp > 1 the global
    batch's ``max(sum over dp, floor)`` divided by dp (a constant, no
    gradient), so that the mean over dp of the ranks' masked means, and
    of their gradients, is the global batch's masked mean and gradient."""
    mesh = active_mesh()
    if mesh is None or mesh.dp == 1:
        return torch.clamp_min(mask_sum, floor)
    total = mesh.all_reduce(mask_sum.detach().clone(), "dp")
    return torch.clamp_min(total, floor) / mesh.dp
