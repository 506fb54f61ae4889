"""The collective layer of the parallel paths.

Counterpart of what the JAX package takes from ``lax.psum`` / ``pmin`` /
``pmax``, ``multihost_utils.broadcast_one_to_all`` and
``process_allgather``: a communicator with ``size``, ``rank``,
``all_reduce_sum``, ``all_reduce_min``, ``all_reduce_max``, ``broadcast``
and ``all_gather``.  Two implementations:

- ``LocalComm``: one process; every collective is the identity and no
  process group is needed;
- ``ProcessGroupComm``: the ranks of a ``torch.distributed`` process group
  (NCCL moves CUDA tensors, gloo CPU tensors: ``distributed.initialize``
  creates the group with both backends where a card is present).

Collectives take and return tensors; none works in place on its argument.
"""

from __future__ import annotations

from typing import List, Sequence

import torch


class LocalComm:
    """The communicator of a single process."""

    size = 1
    rank = 0

    def all_reduce_sum(self, tensors: Sequence[torch.Tensor]
                       ) -> List[torch.Tensor]:
        return list(tensors)

    all_reduce_min = all_reduce_sum
    all_reduce_max = all_reduce_sum

    def broadcast(self, tensors: Sequence[torch.Tensor], src: int = 0
                  ) -> List[torch.Tensor]:
        if src != 0:
            raise ValueError(f"broadcast from rank {src} of 1")
        return list(tensors)

    def all_gather(self, tensor: torch.Tensor) -> torch.Tensor:
        return tensor[None]


class ProcessGroupComm:
    """The ranks of a ``torch.distributed`` process group (the default
    group when ``group`` is None)."""

    def __init__(self, group=None):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialized: call "
                               "parallel.distributed.initialize first")
        self._dist = dist
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def _reduce(self, tensors, op):
        out = []
        for t in tensors:
            t = t.clone()
            self._dist.all_reduce(t, op=op, group=self.group)
            out.append(t)
        return out

    def all_reduce_sum(self, tensors):
        return self._reduce(tensors, self._dist.ReduceOp.SUM)

    def all_reduce_min(self, tensors):
        return self._reduce(tensors, self._dist.ReduceOp.MIN)

    def all_reduce_max(self, tensors):
        return self._reduce(tensors, self._dist.ReduceOp.MAX)

    def broadcast(self, tensors, src: int = 0):
        """Every rank passes tensors of the source's shapes and dtypes and
        receives the source's values."""
        out = []
        for t in tensors:
            t = t.clone()
            self._dist.broadcast(t, src=src, group=self.group)
            out.append(t)
        return out

    def all_gather(self, tensor):
        """(size, *tensor.shape): every rank's tensor, in rank order."""
        parts = [torch.empty_like(tensor) for _ in range(self.size)]
        self._dist.all_gather(parts, tensor.contiguous(), group=self.group)
        return torch.stack(parts)


def world():
    """The communicator of this process: the default process group's when
    ``torch.distributed`` is initialized, else the single-process one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return ProcessGroupComm()
    return LocalComm()
