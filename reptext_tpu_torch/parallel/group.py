"""Sequence-parallel groups: the port's counterpart of the ``sp`` mesh axis.

The JAX package shards the image tokens over a one-axis mesh
(``reptext_tpu/parallel/sequence.py::make_sp_mesh``) and writes each rank's
part as the body of a ``shard_map``, whose collectives are ``lax.ppermute``,
``all_gather``, ``all_to_all`` and ``pmean`` over that axis. Here each rank
runs the same Python code on its own shard, and an :class:`SPGroup` gives it
its ``rank``, ``size`` and ``device`` and those four collectives, plus the
true sum that tensor parallelism's partial products need
(:meth:`SPGroup.all_reduce_sum`) and serving's :meth:`SPGroup.broadcast_object`
from rank 0. The group is the port's one process group type: the ``dp`` and
``tp`` groups of a mesh (``parallel/mesh.py``) are SP groups too.
:class:`DistSPGroup` is the group over ``torch.distributed``: NCCL with one
process per card (``cuda:LOCAL_RANK``), gloo on the CPU.
``parallel/testing.py`` runs n ranks as threads of one process.
:func:`decide_on_rank0` gives every rank rank 0's answer to a host question
(a pipeline callback's), so that the ranks take the same branch.
"""

from __future__ import annotations

import os
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist


class SPGroup:
    """``rank``, ``size``, ``device`` and the collectives of one rank."""

    rank: int
    size: int
    device: torch.device

    def ppermute_right(self, x: torch.Tensor, out: Optional[torch.Tensor] = None):
        """Send ``x`` to rank + 1 and receive rank - 1's into ``out`` (a new
        tensor when None), around the ring; returns a handle whose ``wait()``
        returns the received tensor."""
        raise NotImplementedError

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in rank order."""
        raise NotImplementedError

    def all_to_all(self, x: torch.Tensor, split_dim: int, concat_dim: int) -> torch.Tensor:
        """Split ``x`` into ``size`` chunks along ``split_dim``, send chunk j to
        rank j, and concatenate what arrives along ``concat_dim`` in rank order
        (``lax.all_to_all(..., tiled=True)``)."""
        raise NotImplementedError

    def all_reduce_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of every rank's ``x`` (``lax.pmean``), equal on every rank."""
        raise NotImplementedError

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``x`` (``lax.psum``), bit-equal on every rank:
        a new tensor, ``x`` is left as it is."""
        raise NotImplementedError

    def broadcast_object(self, obj: Any = None) -> Any:
        """Rank 0's ``obj`` (any picklable object) on every rank; the other
        ranks' arguments are ignored."""
        raise NotImplementedError

    def shard(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's contiguous part of ``x`` along ``dim`` (a view)."""
        check_divides(x.shape[dim], self.size, f"dim {dim}")
        part = x.shape[dim] // self.size
        return x.narrow(dim, self.rank * part, part)


def check_divides(length: int, size: int, what: str) -> None:
    if length % size:
        raise ValueError(f"{what} ({length}) must divide the sp group ({size})")


def decide_on_rank0(group: SPGroup, decide: Callable[[], bool]) -> bool:
    """``decide()`` called on rank 0 alone; its answer on every rank (one
    flag all-gathered from the group), so that no rank leaves a loop that
    the others go on with and no collective is left waiting."""
    flag = float(bool(decide())) if group.rank == 0 else 0.0
    answers = group.all_gather(torch.tensor([flag], device=group.device), 0)
    return bool(answers[0].item())


class _Pending:
    def __init__(self, works, recv: torch.Tensor, keep: torch.Tensor):
        self.works, self.recv, self.keep = works, recv, keep

    def wait(self) -> torch.Tensor:
        for work in self.works:
            work.wait()
        self.keep = None
        return self.recv


class DistSPGroup(SPGroup):
    """An :class:`SPGroup` over a ``torch.distributed`` process group (the
    default group when None). The transfers are issued on the caller's
    current stream, which NCCL's stream waits on, and ``wait()`` makes the
    current stream wait for them."""

    def __init__(self, group=None, device=None):
        self.group = group if group is not None else dist.group.WORLD
        self.rank = dist.get_rank(self.group)
        self.size = dist.get_world_size(self.group)
        if device is None:
            device = (torch.device("cuda", torch.cuda.current_device())
                      if dist.get_backend(self.group) == "nccl" else torch.device("cpu"))
        self.device = torch.device(device)
        self._right = dist.get_global_rank(self.group, (self.rank + 1) % self.size)
        self._left = dist.get_global_rank(self.group, (self.rank - 1) % self.size)
        self._root = dist.get_global_rank(self.group, 0)

    def ppermute_right(self, x, out=None):
        send = x.contiguous()
        recv = torch.empty_like(send) if out is None else out
        works = dist.batch_isend_irecv([dist.P2POp(dist.isend, send, self._right, self.group),
                                        dist.P2POp(dist.irecv, recv, self._left, self.group)])
        return _Pending(works, recv, send)

    def all_gather(self, x, dim):
        x = x.contiguous()
        parts: List[torch.Tensor] = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts, dim=dim)

    def all_to_all(self, x, split_dim, concat_dim):
        check_divides(x.shape[split_dim], self.size, f"dim {split_dim}")
        send = torch.stack(x.chunk(self.size, dim=split_dim))
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.group)
        return torch.cat(recv.unbind(0), dim=concat_dim)

    def all_reduce_mean(self, x):
        return self.all_reduce_sum(x) / self.size

    def all_reduce_sum(self, x):
        y = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=self.group)
        return y

    def broadcast_object(self, obj=None):
        box = [obj if self.rank == 0 else None]
        dist.broadcast_object_list(box, src=self._root, group=self.group,
                                   device=self.device if self.device.type == "cuda" else None)
        return box[0]


def make_sp_group(n: int, device: str = "cuda") -> DistSPGroup:
    """The group of all ranks of this job, which must be ``n``: one process
    per card under ``torchrun --nproc-per-node n`` on ``cuda:LOCAL_RANK``
    (NCCL), or processes on the CPU (gloo) with ``device="cpu"``. Starts the
    process group from torchrun's environment if it is not started yet.
    Raises when the job has fewer or more ranks than ``n``, as
    ``make_sp_mesh`` raises without enough devices."""
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    if world < n:
        raise ValueError(f"need {n} ranks, have {world} (run one process per card: "
                         f"torchrun --nproc-per-node {n} -m reptext_tpu_torch.cli ...)")
    if world > n:
        raise ValueError(f"the job has {world} ranks; an sp group of {n} takes all of them")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} asked for, but torch.cuda.is_available() is False")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    return DistSPGroup(device=dev)
