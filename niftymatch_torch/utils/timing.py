"""Timing harness, the counterpart of ``utils/timing.py`` of the JAX package
(the reference's ``CudaTimer``, ``src/gpu/utils/cudatimer.cu:3-22``).

Work on the card is timed with CUDA events on the card's clock; work on
the CPU with ``time.perf_counter``.  Which clock a measurement used
depends on the values it waited on: CUDA tensors, or none."""

from __future__ import annotations

import time
from typing import Callable, Sequence

import torch
from torch.utils._pytree import tree_leaves


def _on_cuda(value) -> bool:
    return any(isinstance(t, torch.Tensor) and t.is_cuda for t in tree_leaves(value))


class Timer:
    """Context-manager timer that waits for a result before it stops.

    >>> with Timer() as t:
    ...     out = fn(x)
    ...     t.block_on(out)
    >>> t.elapsed_ms

    With CUDA tensors in the result, ``elapsed_ms`` is the card's time
    between CUDA events recorded on the current stream at entry and exit;
    otherwise the host's."""

    def __enter__(self):
        self.elapsed_ms = None
        self._value = None
        self._start_event = None
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            self._start_event = torch.cuda.Event(enable_timing=True)
            self._start_event.record()
        self._start = time.perf_counter()
        return self

    def block_on(self, value):
        self._value = value
        return value

    def __exit__(self, *exc):
        if self._start_event is not None and _on_cuda(self._value):
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            self.elapsed_ms = self._start_event.elapsed_time(end)
        else:
            self.elapsed_ms = (time.perf_counter() - self._start) * 1e3
        return False


def benchmark(fn: Callable, args_sets: Sequence[tuple], warmup: int = 2,
              iters: int = 20) -> float:
    """Mean ms per call of ``fn``, cycling over distinct argument sets
    after ``warmup`` calls: CUDA events around the timed calls where the
    results are CUDA tensors, the host's clock otherwise."""
    n = len(args_sets)
    outs = [fn(*args_sets[i % n]) for i in range(max(warmup, 1))]
    if _on_cuda(outs):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        outs = [fn(*args_sets[i % n]) for i in range(iters)]
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    start = time.perf_counter()
    outs = [fn(*args_sets[i % n]) for i in range(iters)]
    return (time.perf_counter() - start) / iters * 1e3
