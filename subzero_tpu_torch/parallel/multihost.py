"""Multi-process execution of the domain decomposition on ``torch.distributed``.

Counterpart of ``subzero_tpu/parallel/multihost.py``.  The JAX package runs
one program over a device mesh; here every rank is a process of its own (one
host or many, as ``torchrun`` starts them), and ``parallel/decomp.py`` runs
the same loop on every rank.  Host life-cycle passes run on every rank alike,
on a pool that every rank gathers in full, with the same numpy generator, so
the ranks stay consistent without a broadcast; only rank 0 writes output.

``Comm`` holds what the decomposition's step needs of the process group:

  * ``exchange``: the neighbour exchange (``ppermute``'s counterpart), one
    packed buffer a direction, both directions in one ``batch_isend_irecv``;
    a side with no neighbour receives zeros, as ``ppermute`` gives;
  * ``ordered_sum``: an ``all_gather`` added in ascending rank order, so that
    every rank holds the same bits and two runs give the same bits (no float
    ``all_reduce``);
  * ``flag_max``: one integer ``all_reduce(MAX)`` of a step's flags (overflow
    and fuse together), read on the host once;
  * ``gather_rows``: every rank's block in rank order.

The backend is the caller's choice.  ``nccl`` (the default) takes CUDA
tensors, one rank a card.  ``gloo`` takes CPU tensors: it serves CPU runs,
and several ranks that share one card (NCCL refuses two ranks on one GPU),
in which case ``Comm`` copies each buffer through host memory and counts
those copies (``stats["staging_copies"]``): that is the transport, and
nothing switches backends on a failure.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = [
    "initialize", "is_io_process", "replicate_to_host", "rank_device", "Comm",
    "pack_rows", "unpack_rows",
]


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))


def initialize(backend=None, init_method=None, world_size=None, rank=None):
    """Start the process group; call once in every rank before ``make_decomp``.

    With no arguments: ``env://`` as ``torchrun`` sets it up, backend
    ``nccl``.  Explicit ``init_method`` (``"tcp://localhost:<port>"``),
    ``world_size`` and ``rank`` serve manual launches.  ``backend="gloo"``
    runs on the CPU, or lets several ranks share one card through host
    memory.  Under ``nccl`` this raises when this rank's ``LOCAL_RANK``
    names no card of its own (NCCL refuses two ranks on one GPU), and makes
    that card the current device."""
    backend = backend or "nccl"
    if backend == "nccl":
        n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        local = _local_rank()
        if local >= n_cards:
            raise RuntimeError(
                f"nccl needs a card a rank: LOCAL_RANK {local} but this host has "
                f"{n_cards} CUDA device(s), and NCCL refuses two ranks of one "
                "communicator on the same GPU; start at most one rank a card, or "
                "pass backend='gloo' to let ranks share a card through host memory"
            )
        torch.cuda.set_device(local)
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank)


def is_io_process() -> bool:
    """True on the one rank that writes output and logs (rank 0)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def rank_device(device=None) -> torch.device:
    """This rank's device: ``device`` as given, else the card.  Under
    ``nccl`` that is ``cuda:LOCAL_RANK``; under ``gloo`` the ranks of one host
    take the cards in turn (``LOCAL_RANK`` modulo the count), so several
    share one where there are fewer cards than ranks.  Raises where there is
    no card: nothing lands on the CPU unless the caller names it."""
    if device is not None:
        return torch.device(device)
    resolve_device(None)
    local = _local_rank()
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", local)
    return torch.device("cuda", local % torch.cuda.device_count())


def pack_rows(tensors) -> torch.Tensor:
    """Tensors with one leading length n -> one uint8 [n, bytes] buffer that
    holds each row's bytes of every tensor in turn (one copy)."""
    n = tensors[0].shape[0]
    return torch.cat(
        [t.contiguous().reshape(n, -1).view(torch.uint8) for t in tensors], dim=1)


def unpack_rows(buf, like) -> list:
    """Inverse of ``pack_rows``: ``like`` gives each tensor's trailing shape
    and dtype (tensors of any length, or (shape, dtype) pairs)."""
    n = buf.shape[0]
    out, at = [], 0
    for t in like:
        tail, dtype = (tuple(t.shape[1:]), t.dtype) if isinstance(t, torch.Tensor) else t
        nb = int(np.prod(tail, dtype=np.int64)) * dtype.itemsize
        out.append(buf[:, at:at + nb].contiguous().view(dtype).reshape((n,) + tail))
        at += nb
    return out


class Comm:
    """A process group seen from one rank: its size, this rank's index and
    device, the decomposition's collectives, and counters of what they did.

    ``group`` None is the default group; without an initialised process group
    the Comm is a single rank whose collectives return their input.
    ``device`` None is the card (``resolve_device``).  ``stats["bytes_sent"]``
    counts every byte this rank sent, ``stats["exchange_bytes"]`` those of
    the neighbour exchanges (halos and migrants) alone."""

    STATS = ("messages", "bytes_sent", "exchange_bytes", "staging_copies",
             "reductions", "flag_reductions", "pool_gathers")

    def __init__(self, group=None, device=None):
        self.group = group
        self.device = resolve_device(device)
        self.distributed = dist.is_initialized()
        if self.distributed:
            self.size = dist.get_world_size(group)
            self.rank = dist.get_rank(group)
            self.backend = dist.get_backend(group)
        else:
            self.size, self.rank, self.backend = 1, 0, None
        # gloo moves CPU tensors only: CUDA buffers go through host memory
        self.stage = self.backend == "gloo" and self.device.type == "cuda"
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError("the nccl backend takes CUDA tensors; this rank's "
                             f"pool is on {self.device}")
        self.stats = dict.fromkeys(self.STATS, 0)

    def _global(self, r: int) -> int:
        return r if self.group is None else dist.get_global_rank(self.group, r)

    def _to_wire(self, x):
        if self.stage:
            self.stats["staging_copies"] += 1
            return x.cpu()
        return x

    def _from_wire(self, x):
        if self.stage:
            self.stats["staging_copies"] += 1
            return x.to(self.device)
        return x

    def exchange(self, to_lo, to_hi, lo, hi):
        """Send ``to_lo`` to rank ``lo`` and ``to_hi`` to rank ``hi`` (ranks of
        this group, None = no neighbour on that side) and return ``(from_lo,
        from_hi)``: what ``lo`` sent to its upper neighbour and what ``hi``
        sent to its lower one, zeros from a missing neighbour.  The four
        buffers have one shape.  Both directions go in one
        ``batch_isend_irecv``; the downward messages are issued first on every
        rank, so a pair of ranks that are each other's lower and upper
        neighbour (two ranks on a periodic axis) match in order under NCCL, as
        under gloo's tags."""
        wire = self._to_wire(torch.stack([to_lo, to_hi]))
        got = torch.zeros_like(wire)
        ops = []
        if lo is not None:
            ops.append(dist.P2POp(dist.isend, wire[0], self._global(lo), self.group, tag=0))
        if hi is not None:
            ops.append(dist.P2POp(dist.irecv, got[1], self._global(hi), self.group, tag=0))
            ops.append(dist.P2POp(dist.isend, wire[1], self._global(hi), self.group, tag=1))
        if lo is not None:
            ops.append(dist.P2POp(dist.irecv, got[0], self._global(lo), self.group, tag=1))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        sent = (lo is not None) + (hi is not None)
        nbytes = sent * to_lo.numel() * to_lo.element_size()
        self.stats["messages"] += sent
        self.stats["bytes_sent"] += nbytes
        self.stats["exchange_bytes"] += nbytes
        got = self._from_wire(got)
        return got[0], got[1]

    def gather_rows(self, x):
        """Every rank's ``x`` (one shape on all ranks), concatenated along the
        first axis in rank order: [size * n, ...]."""
        if not self.distributed:
            return x
        wire = self._to_wire(x.contiguous())
        parts = [torch.empty_like(wire) for _ in range(self.size)]
        dist.all_gather(parts, wire, group=self.group)
        self.stats["pool_gathers"] += 1
        self.stats["bytes_sent"] += wire.numel() * wire.element_size()
        return self._from_wire(torch.cat(parts))

    def gather_tree(self, tree):
        """``gather_rows`` of a pool (a NamedTuple of tensors with one leading
        length, packed into one message) or of one tensor."""
        if isinstance(tree, torch.Tensor):
            return self.gather_rows(tree)
        parts = list(tree)
        return type(tree)(*unpack_rows(self.gather_rows(pack_rows(parts)), parts))

    def ordered_sum(self, x):
        """The sum of ``x`` over the ranks, added in ascending rank order, so
        every rank gets the same bits in every run."""
        if not self.distributed:
            return x
        wire = self._to_wire(x.contiguous())
        parts = [torch.empty_like(wire) for _ in range(self.size)]
        dist.all_gather(parts, wire, group=self.group)
        self.stats["reductions"] += 1
        self.stats["bytes_sent"] += wire.numel() * wire.element_size()
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return self._from_wire(out)

    def flag_max(self, flags) -> list:
        """The largest of each flag (bools or ints, one tensor) over the ranks,
        read on the host: one ``all_reduce(MAX)``."""
        x = flags.to(torch.int32)
        if self.distributed:
            if self.backend == "gloo":
                x = x.cpu()  # the host read; gloo reduces it there
                if self.stage:
                    self.stats["staging_copies"] += 1
            dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.group)
            self.stats["flag_reductions"] += 1
            self.stats["bytes_sent"] += x.numel() * x.element_size()
        return x.tolist()


def replicate_to_host(tree, comm: Comm | None = None):
    """Every rank's block of a pool (a NamedTuple of tensors with one leading
    length, or one tensor), concatenated in rank order, as numpy on every
    rank.  A single process copies its own."""
    if comm is None:
        comm = Comm(device=(tree if isinstance(tree, torch.Tensor) else tree[0]).device)
    full = comm.gather_tree(tree)
    if isinstance(full, torch.Tensor):
        return full.cpu().numpy()
    return type(full)(*(t.cpu().numpy() for t in full))
