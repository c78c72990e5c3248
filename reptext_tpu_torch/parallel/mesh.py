"""The (dp, tp) mesh: data and tensor parallelism's ranks and groups.

Counterpart of ``reptext_tpu/parallel/mesh.py::make_mesh``. The JAX package
lays devices out as a named ``Mesh`` of shape (dp, tp) and lets XLA insert
every collective from sharding annotations. Here each rank runs its own part
and a :class:`Mesh` gives it its place in the (dp, tp) grid and three
groups (``parallel/group.py``): ``tp_group`` (the ranks that split one
model's heads and features: the partial sums of ``parallel/partition.py``),
``dp_group`` (the ranks that split the batch rows) and ``world`` (every rank:
decisions taken on rank 0, serving's broadcasts). Ranks are laid out as
``np.arange(n).reshape(dp, tp)``, so a tp group is contiguous ranks, which
share a node's NVLink under ``torchrun``.

:func:`make_mesh` builds a rank's mesh from the job's processes (NCCL with one
process per card on ``cuda:LOCAL_RANK``, gloo on the CPU), or, given
``threads``, a :class:`LocalMesh` of dp x tp ranks as threads of one process
on one device (``parallel/testing.py::run_spmd`` runs them), the form the
tests and ``chip_smoke.py`` use.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import weakref
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from reptext_tpu_torch.parallel.group import DistSPGroup, SPGroup


def mesh_shape(n: int, dp: Optional[int] = None, tp: Optional[int] = None) -> Tuple[int, int]:
    """(dp, tp) over ``n`` ranks as the JAX ``make_mesh`` factors them: all
    on tp by default, a missing factor filled in, and dp x tp must be n."""
    if dp is None and tp is None:
        dp, tp = 1, n
    elif dp is None:
        dp = n // tp
    elif tp is None:
        tp = n // dp
    if dp * tp != n:
        raise ValueError(f"dp*tp={dp * tp} != device count {n}")
    return dp, tp


class SliceCache:
    """The tensor-parallel slices of a module shared by the dp replicas of one
    tp rank in a thread mesh (their weights are equal and inference keeps no
    state in them), and by thread meshes given one cache: ``get(whole, key,
    make)`` makes the slice ``key`` of the tensor ``whole`` once while
    ``whole`` lives (the entry holds it weakly, so it pins no weights)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[Any, Any] = {}

    def get(self, whole: torch.Tensor, key, make: Callable[[], Any]) -> Any:
        with self._lock:
            ref, value = self._entries.get((id(whole), *key), (None, None))
            if ref is None or ref() is not whole:
                value = make()
                self._entries[(id(whole), *key)] = (weakref.ref(whole), value)
            return value


@dataclasses.dataclass
class Mesh:
    """One rank's view of a (dp, tp) mesh: its rank in the world, and the
    world, dp and tp groups it belongs to."""

    dp: int
    tp: int
    rank: int
    world: SPGroup
    dp_group: SPGroup
    tp_group: SPGroup
    slices: Optional[SliceCache] = None   # the thread form's shared slices

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp

    @property
    def size(self) -> int:
        return self.dp * self.tp

    @property
    def device(self) -> torch.device:
        return self.world.device


class LocalMesh:
    """dp x tp ranks as threads of one process on ``device``, run by
    ``parallel/testing.py::run_spmd``: ``member(rank)`` is a rank's
    :class:`Mesh` over thread groups (``LocalSPGroup``)."""

    def __init__(self, dp: int, tp: int, device="cpu", slices: Optional[SliceCache] = None):
        """``slices``: another thread mesh's cache, whose tp slices this one
        takes (one copy of each rank's slices for both)."""
        from reptext_tpu_torch.parallel.testing import LocalSPGroup

        if dp < 1 or tp < 1:
            raise ValueError(f"a mesh needs dp, tp >= 1, got ({dp}, {tp})")
        self.dp, self.tp, self.size = dp, tp, dp * tp
        self.device = torch.device(device)
        self._world = LocalSPGroup(self.size, device)
        self._tp_groups = [LocalSPGroup(tp, device) for _ in range(dp)]
        self._dp_groups = [LocalSPGroup(dp, device) for _ in range(tp)]
        self.slices = slices if slices is not None else SliceCache()

    def _groups(self):
        return [self._world, *self._tp_groups, *self._dp_groups]

    def _reset(self) -> None:
        for g in self._groups():
            g._reset()

    def _abort(self) -> None:
        for g in self._groups():
            g._abort()

    def member(self, rank: int) -> Mesh:
        d, t = divmod(rank, self.tp)
        return Mesh(self.dp, self.tp, rank, self._world.member(rank),
                    self._dp_groups[t].member(d), self._tp_groups[d].member(t), self.slices)


def make_mesh(dp: Optional[int] = None, tp: Optional[int] = None, device="cuda",
              threads: Optional[int] = None):
    """A (dp, tp) mesh over this job's ranks: this rank's :class:`Mesh`.

    The defaults and errors are the JAX function's (:func:`mesh_shape`). The
    job is the ``torchrun`` processes (one per card on ``cuda:LOCAL_RANK``,
    or the current card without torchrun; NCCL; gloo with ``device="cpu"``);
    the process group is started from torchrun's environment if it is not
    started yet, and every rank makes every dp and tp group, as
    ``dist.new_group`` asks; a job of one process needs none. With
    ``threads`` = n, a :class:`LocalMesh` of n thread ranks on ``device``
    instead.
    """
    if threads is not None:
        return LocalMesh(*mesh_shape(threads, dp, tp), device)
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    dp, tp = mesh_shape(world, dp, tp)
    if world == 1 and not dist.is_initialized():     # one process: no process group
        return LocalMesh(1, 1, device).member(0)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} asked for, but torch.cuda.is_available() is False")
        local = os.environ.get("LOCAL_RANK")
        dev = torch.device("cuda", torch.cuda.current_device() if local is None else int(local))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    rank = dist.get_rank()
    ranks = np.arange(world).reshape(dp, tp)
    tp_group = dp_group = None
    for row in ranks:                    # every rank makes every group, in one order
        g = dist.new_group([int(r) for r in row])
        if rank in row:
            tp_group = DistSPGroup(g, dev)
    for col in ranks.T:
        g = dist.new_group([int(r) for r in col])
        if rank in col:
            dp_group = DistSPGroup(g, dev)
    return Mesh(dp, tp, rank, DistSPGroup(device=dev), dp_group, tp_group)
