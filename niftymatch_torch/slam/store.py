"""Device-resident keyframe feature store (``slam/store.py`` of the JAX
package).

One growing set of ``(capacity, N, ...)`` tensors, one per ``Features``
field, holds every keyframe's features:

- **Staged appends, no retention.**  Accepted rows of a chunk batch are
  *staged* on the host and written at :meth:`FeatureStore.flush` with one
  ``index_copy_`` per field, in place (the JAX package's donated
  ``dynamic_update_slice``).  After the flush nothing references the chunk
  batch, so rejected frames' features are freed.
- **Doubling capacity.**  The tensors double when full, as in the JAX
  package (where that bounds its recompiles).
- **Ghost rows.**  A staged chunk write is padded to a multiple of
  ``chunk_pad`` rows by repeating its last accepted row; the ghost rows sit
  beyond ``count`` and are overwritten by the next append, and every
  consumer of :meth:`FeatureStore.view` masks by ``count``.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..features import Features
from ..utils.precision import device_constant


class FeatureStore:
    """Append-only device store of keyframe feature sets; its tensors live
    on the device of the first staged features."""

    def __init__(self, init_capacity: int = 64, chunk_pad: int = 16):
        self._buf: Features | None = None
        self.capacity = init_capacity
        self.count = 0
        self.chunk_pad = chunk_pad
        # Staged writes, executed in order at flush: ("rows", feats_b,
        # [batch row, ...], k0) or ("one", feats, k0).
        self._pending: List[tuple] = []
        self._staged = 0  # rows reserved beyond count (pending ones)

    # -- staging -------------------------------------------------------
    def stage_chunk(self, feats_b: Features, accepted: List[int]) -> List[int]:
        """Reserve slots for the ``accepted`` rows of a chunk batch; returns
        the slot indices.  The write happens at :meth:`flush`."""
        if not accepted:
            return []
        k0 = self.count + self._staged
        self._pending.append(("rows", feats_b, list(accepted), k0))
        self._staged += len(accepted)
        return list(range(k0, k0 + len(accepted)))

    def stage_single(self, feats: Features) -> int:
        k0 = self.count + self._staged
        self._pending.append(("one", feats, k0))
        self._staged += 1
        return k0

    # -- flush ---------------------------------------------------------
    def _ensure_capacity(self, need: int) -> None:
        if self._buf is None:
            # The per-frame shapes and the device come from the first item.
            kind, feats, *_ = self._pending[0]
            while self.capacity < need:
                self.capacity *= 2
            self._buf = Features(*[
                torch.zeros((self.capacity,) + (a.shape[1:] if kind == "rows" else a.shape),
                            dtype=a.dtype, device=a.device)
                for a in feats])
            return
        while self.capacity < need:
            self._buf = Features(*[torch.cat([b, torch.zeros_like(b)]) for b in self._buf])
            self.capacity *= 2

    def _pad_len(self, n: int) -> int:
        return -(-n // self.chunk_pad) * self.chunk_pad

    def flush(self) -> None:
        """Execute the staged writes: one ``index_copy_`` per field for each
        staged item, rows padded to ``chunk_pad`` with ghosts."""
        if not self._pending:
            return
        need = k = self.count
        for item in self._pending:
            n = len(item[2]) if item[0] == "rows" else 1
            need = max(need, k + (self._pad_len(n) if item[0] == "rows" else 1))
            k += n
        self._ensure_capacity(need)
        dev = self._buf.x.device
        for item in self._pending:
            if item[0] == "rows":
                _, feats_b, accepted, k0 = item
                pad = self._pad_len(len(accepted))
                rows = device_constant(
                    np.asarray(accepted + [accepted[-1]] * (pad - len(accepted)), np.int64), dev)
                src = [a.index_select(0, rows) for a in feats_b]
                self.count = k0 + len(accepted)
            else:
                _, feats, k0 = item
                pad = 1
                src = [a[None] for a in feats]
                self.count = k0 + 1
            slots = torch.arange(k0, k0 + pad, device=dev)
            for b, a in zip(self._buf, src):
                b.index_copy_(0, slots, a.to(dev))
        self._pending = []
        self._staged = 0

    # -- reads (all flush first) ----------------------------------------
    def get(self, slot: int) -> Features:
        """Row ``slot`` (a view: a committed row is never written again)."""
        if slot < 0:
            raise ValueError("feature row not committed yet (slot < 0)")
        self.flush()
        return Features(*[b[slot] for b in self._buf])

    def gather(self, slots) -> Features:
        """Rows ``slots`` (leading dim len(slots)), one gather per field."""
        self.flush()
        idx = device_constant(np.asarray(slots, np.int64), self._buf.x.device)
        return Features(*[b.index_select(0, idx) for b in self._buf])

    def tail(self, n: int) -> Features:
        """The last ``n`` rows (leading dim n; the start is clamped so the
        rows fit, as ``dynamic_slice`` clamps)."""
        self.flush()
        lo = min(max(0, self.count - n), self.capacity - n)
        return Features(*[b[lo:lo + n] for b in self._buf])

    def view(self) -> Features:
        """The full (capacity, ...) tensors.  Rows >= count are zeros or
        ghosts: callers must mask by ``count``."""
        self.flush()
        return self._buf
