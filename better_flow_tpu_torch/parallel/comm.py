"""The collective layer of the parallel paths.

Counterpart of what the JAX package takes from ``lax.psum`` / ``pmin`` /
``pmax``, ``multihost_utils.broadcast_one_to_all`` and
``process_allgather``: a communicator with ``size``, ``rank``,
``all_reduce_sum``, ``all_reduce_min``, ``all_reduce_max``, ``broadcast``,
``all_gather`` and ``permute`` (``lax.ppermute``).  Two implementations:

- ``LocalComm``: one process; every collective is the identity and no
  process group is needed;
- ``ProcessGroupComm``: the ranks of a ``torch.distributed`` process group
  (NCCL moves CUDA tensors, gloo CPU tensors: ``distributed.initialize``
  creates the group with both backends where a card is present).

Collectives take and return tensors; none works in place on its argument,
except ``ProcessGroupComm.all_reduce_sum_``, the in-place sum that the
event-parallel image seam (``ops.fused_model.sum_images``) calls when there
is more than one rank.
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

    def permute(self, tensors: Sequence[torch.Tensor], pairs
                ) -> List[torch.Tensor]:
        """See ``ProcessGroupComm.permute``: the one rank sends to itself
        or to nobody."""
        check_pairs(pairs, 1)
        if pairs:
            return list(tensors)
        return [torch.zeros_like(t) for t in tensors]


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

    def all_reduce_sum_(self, tensors):
        """``all_reduce_sum`` in place: every rank's contiguous tensors
        become the sums over the ranks.  Returns them."""
        for t in tensors:
            self._dist.all_reduce(t, op=self._dist.ReduceOp.SUM,
                                  group=self.group)
        return list(tensors)

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


    def permute(self, tensors, pairs):
        """``lax.ppermute``: ``pairs`` is a list of (source rank, destination
        rank), each rank at most once as a source and once as a
        destination, the same list on every rank.  Every rank passes
        tensors of the same shapes and dtypes; a rank receives its source's
        tensors, or zeros when no pair names it as a destination."""
        check_pairs(pairs, self.size)
        dst = {a: b for a, b in pairs}.get(self.rank)
        src = {b: a for a, b in pairs}.get(self.rank)
        if src is None:
            out = [torch.zeros_like(t) for t in tensors]
        elif src == self.rank:
            out = list(tensors)
        else:
            out = [torch.empty_like(t) for t in tensors]
        ops = []
        # Ranks of a group are global ranks only in the default group.
        peer = (lambda r: r) if self.group is None else \
            (lambda r: self._dist.get_global_rank(self.group, r))
        if dst is not None and dst != self.rank:
            ops += [self._dist.P2POp(self._dist.isend, t.contiguous(),
                                     peer(dst), self.group) for t in tensors]
        if src is not None and src != self.rank:
            ops += [self._dist.P2POp(self._dist.irecv, t, peer(src),
                                     self.group) for t in out]
        if ops:
            for req in self._dist.batch_isend_irecv(ops):
                req.wait()
        return out


def check_pairs(pairs, size: int) -> None:
    srcs = [a for a, _ in pairs]
    dsts = [b for _, b in pairs]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts) or any(
            not 0 <= r < size for r in srcs + dsts):
        raise ValueError(f"permute pairs {list(pairs)} over {size} ranks: "
                         "each rank at most once as a source and once as a "
                         "destination")


def world():
    """The communicator of this process: the default process group's when
    ``torch.distributed`` is initialized, else the single-process one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return ProcessGroupComm()
    return LocalComm()
