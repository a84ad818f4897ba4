"""Per-stage wall time and device traces: the port of
`radarslampy_tpu/utils/profiling.py`.

`StageTimer` accumulates host wall time per named stage; a stage given
tensors to `sync` waits for their devices first (`torch.cuda.synchronize`
on the card, nothing on the CPU, where the work is already done), so its time
holds the device work it launched.  `device_trace(logdir)` records a
`torch.profiler` trace (CPU and, on a card, CUDA activity) into `logdir`, as
`jax.profiler.start_trace` does in the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict

import torch


def _devices(tree) -> set:
    """The CUDA devices of every tensor leaf of a tensor, tuple, list,
    NamedTuple or dict."""
    if isinstance(tree, torch.Tensor):
        return {tree.device} if tree.is_cuda else set()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return set().union(*(_devices(t) for t in tree))
    return set()


def synchronize(tree) -> None:
    """Wait for the device work behind every tensor leaf of `tree`."""
    for dev in _devices(tree):
        torch.cuda.synchronize(dev)


class StageTimer:
    """Accumulates wall time per named stage; device-synchronised."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        t0 = time.perf_counter()
        yield
        if sync is not None:
            synchronize(sync)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def report(self) -> dict:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "calls": self.counts[name],
                "mean_ms": round(1e3 * self.totals[name] / max(self.counts[name], 1), 3),
            }
            for name in sorted(self.totals)
        }

    def dump(self) -> str:
        return json.dumps(self.report(), indent=2)


@contextlib.contextmanager
def device_trace(logdir: str):
    """Record a torch.profiler trace of the block into
    `logdir/trace_<pid>_<ns>.json` (Chrome trace format: chrome://tracing,
    Perfetto).  Yields the profiler; the file is written on exit, also when
    the block raises."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    try:
        with prof:
            yield prof
    finally:
        prof.export_chrome_trace(
            os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
