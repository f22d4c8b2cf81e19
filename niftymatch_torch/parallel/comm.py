"""The collectives of the multi-device layer, over ``torch.distributed``.

The JAX package's ``ppermute``, ``psum`` and sharded outputs become:

* :func:`ring_shift`: the block of rank i goes to rank (i + 1) % n, one
  ``batch_isend_irecv`` (:func:`start_shift` leaves it in flight);
* :func:`all_reduce_sum`: ``psum``;
* :func:`all_gather_rows`: the row blocks of every rank, concatenated in
  rank order (JAX leaves results sharded; here every rank gets them all).

NCCL moves CUDA tensors between devices.  gloo sends CPU tensors only, so
on a gloo group a CUDA tensor is staged through host memory: the group's
backend decides this (:func:`staged`), not a caught error.  That mode runs
several ranks on one card, where NCCL refuses two ranks on one device; its
transfers cross the host and say nothing of NVLink.

``COUNTS`` counts the calls of each collective in this process, so a
caller can read how many a solve made (reset with :func:`reset_counts`).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

COUNTS = {"ring_shift": 0, "all_reduce": 0, "all_gather": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def staged(group) -> bool:
    """True where the group's backend sends only host tensors (gloo)."""
    return dist.get_backend(group) == "gloo"


def comm_device(group, device) -> torch.device:
    """Where a block must lie to be sent on ``group``: the host for a
    staged group, else the block's own device."""
    return torch.device("cpu") if staged(group) else torch.device(device)


class PendingShift:
    """A ring transfer in flight; :meth:`wait` returns the received block
    (on the device the sent block lay on)."""

    def __init__(self, reqs, buf, sent=None):
        self._reqs, self._buf, self._sent = reqs, buf, sent   # keep the sent block alive

    def wait(self) -> torch.Tensor:
        for r in self._reqs:
            r.wait()
        return self._buf


def start_shift(t: torch.Tensor, group) -> PendingShift:
    """Send ``t`` to the next rank of ``group`` and receive the previous
    rank's block of the same shape, without waiting.  ``t`` must lie on
    ``comm_device(group, ...)``: the caller keeps the host copy of a
    staged block so that the next step sends it without a device read."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    COUNTS["ring_shift"] += 1
    if n == 1:
        return PendingShift([], t)
    buf = torch.empty(t.shape, dtype=t.dtype, device=t.device,
                      pin_memory=t.device.type == "cpu" and torch.cuda.is_available())
    src = t.contiguous()
    ops = [dist.P2POp(dist.isend, src, dist.get_global_rank(group, (me + 1) % n), group),
           dist.P2POp(dist.irecv, buf, dist.get_global_rank(group, (me - 1) % n), group)]
    return PendingShift(dist.batch_isend_irecv(ops), buf, src)


def ring_shift(t: torch.Tensor, group) -> torch.Tensor:
    """The counterpart of ``ppermute`` to (i + 1) % n: returns the block of
    the previous rank, on ``t``'s device.  At one rank it returns ``t``,
    as a one-device ``ppermute`` does."""
    if dist.get_world_size(group) == 1:
        COUNTS["ring_shift"] += 1
        return t
    got = start_shift(t.to(comm_device(group, t.device)), group).wait()
    return got.to(t.device)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over the group's ranks, on ``t``'s device (``t``
    itself is reduced in place unless the group is staged).  Every rank
    gets the same bits."""
    COUNTS["all_reduce"] += 1
    t = t.contiguous()
    if staged(group) and t.device.type != "cpu":
        host = t.cpu()
        dist.all_reduce(host, group=group)
        return host.to(t.device)
    dist.all_reduce(t, group=group)
    return t


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes), concatenated along dim 0 in rank
    order, on ``t``'s device."""
    COUNTS["all_gather"] += 1
    n = dist.get_world_size(group)
    if n == 1:
        return t
    src = t.contiguous().to(comm_device(group, t.device))
    if src.dtype == torch.bool:       # sent as bytes
        src = src.view(torch.uint8)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(t.device).view(t.dtype)
