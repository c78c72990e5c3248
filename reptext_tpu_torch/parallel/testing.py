"""n sequence-parallel ranks as threads of one process, on one device.

The counterpart of the JAX package's virtual CPU mesh
(``reptext_tpu/parallel/testing.py``, ``--xla_force_host_platform_device_count``):
where the JAX tests run an 8-device mesh on one host, :class:`LocalSPGroup`
runs n ranks on one device, so the SP code runs on the CPU and on one card.
Only the tests and ``chip_smoke.py`` use it; a job with a card per rank uses
``parallel/group.py::DistSPGroup``.

:func:`run_spmd` starts one thread per rank, each calling ``fn(member, *args)``
with its rank's group. The ranks exchange tensors through a barrier: each
posts its tensor, and after the barrier each copies what it receives into a
new tensor (or the given ``out``), never an alias, before a second barrier
lets anyone post again. On a card every rank queues on one CUDA stream, the
caller's, so stream order is the only synchronisation: no kernel waits on
another rank. Autograd and inference mode are thread-local in PyTorch; the
threads take the caller's.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, List

import torch

from reptext_tpu_torch.parallel.group import SPGroup, check_divides


class _Done:
    def __init__(self, value: torch.Tensor):
        self.value = value

    def wait(self) -> torch.Tensor:
        return self.value


class _Member(SPGroup):
    """One rank of a :class:`LocalSPGroup`."""

    def __init__(self, world: "LocalSPGroup", rank: int):
        self.world, self.rank, self.size, self.device = world, rank, world.size, world.device

    def _exchange(self, x: torch.Tensor, take: Callable[[List[torch.Tensor]], Any]):
        w = self.world
        w._box[self.rank] = x
        w._barrier.wait()
        try:
            return take(list(w._box))
        finally:
            w._barrier.wait()

    def ppermute_right(self, x, out=None):
        left = (self.rank - 1) % self.size
        return _Done(self._exchange(
            x, lambda box: box[left].clone() if out is None else out.copy_(box[left])))

    def all_gather(self, x, dim):
        return self._exchange(x, lambda box: torch.cat(box, dim=dim))

    def all_to_all(self, x, split_dim, concat_dim):
        check_divides(x.shape[split_dim], self.size, f"dim {split_dim}")
        return self._exchange(x, lambda box: torch.cat(
            [b.chunk(self.size, dim=split_dim)[self.rank] for b in box], dim=concat_dim))

    def all_reduce_mean(self, x):
        def mean(box):
            total = box[0].clone()
            for b in box[1:]:
                total += b
            return total / self.size
        return self._exchange(x, mean)


# A rank that waits longer than this at an exchange raises BrokenBarrierError
# (a rank that skipped a collective would otherwise hang the others for good).
BARRIER_TIMEOUT_S = 300.0


class LocalSPGroup:
    """n ranks on ``device``, run by :func:`run_spmd`: the counterpart of the
    JAX package's virtual n-device CPU mesh."""

    def __init__(self, n: int, device="cpu"):
        if n < 1:
            raise ValueError(f"an sp group needs at least one rank, got {n}")
        self.size = n
        self.device = torch.device(device)
        self._reset()

    def _reset(self) -> None:
        self._barrier = threading.Barrier(self.size, timeout=BARRIER_TIMEOUT_S)
        self._box: List[Any] = [None] * self.size

    def member(self, rank: int) -> SPGroup:
        return _Member(self, rank)


def run_spmd(group: LocalSPGroup, fn: Callable, *args) -> List[Any]:
    """``[fn(group.member(r), *args) for r in ranks]``, the ranks running as
    threads; the first error of any rank is raised after all have stopped."""
    n = group.size
    results: List[Any] = [None] * n
    errors: List[BaseException] = [None] * n
    grad, inference = torch.is_grad_enabled(), torch.is_inference_mode_enabled()
    stream = torch.cuda.current_stream(group.device) if group.device.type == "cuda" else None

    def body(rank: int) -> None:
        try:
            with contextlib.ExitStack() as stack:
                stack.enter_context(torch.inference_mode(inference))
                stack.enter_context(torch.set_grad_enabled(grad))
                if stream is not None:
                    stack.enter_context(torch.cuda.stream(stream))
                results[rank] = fn(group.member(rank), *args)
        except BaseException as e:  # noqa: BLE001 (handed to the caller below)
            errors[rank] = e
            group._barrier.abort()   # release the ranks waiting on this one

    threads = [threading.Thread(target=body, args=(r,), name=f"sp-rank-{r}") for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    failed = [e for e in errors if e is not None]
    if failed:
        group._reset()
        raise next((e for e in failed if not isinstance(e, threading.BrokenBarrierError)),
                   failed[0])
    return results
