"""Per-stage wall time and device traces: the port of
`radarslampy_tpu/utils/profiling.py`.

`StageTimer` accumulates host wall time per named stage; a stage given
tensors to `sync` waits for their devices first (`torch.cuda.synchronize`
on the card, nothing on the CPU, where the work is already done), so its time
holds the device work it launched.  `device_trace(logdir)` records a
`torch.profiler` trace (CPU and, on a card, CUDA activity) into `logdir`, as
`jax.profiler.start_trace` does in the JAX package.

Reading a trace of the step (`models/frontend.slam_step` runs each stage in
a `record_function` range "slam_step.<stage>"): `step_profile` gives each
range's host and device time per step and the device's busy time over the
steps' window, `device_busy_us` the union of the device activity among a
trace's events, `lost_launches` the host's launches whose device events a
trace lacks, `collective_trace` the all-reduces and graph replays of a
trace and the NCCL kernels each launched.  `card_line` is the card's name
and power limit as `nvidia-smi` gives them, to be written beside every time
taken on it.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import time
from collections import Counter, defaultdict
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


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`'s first
    line, e.g. "NVIDIA H100 80GB HBM3, 700.00 W"."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_us(ev) -> float:
    """A profiler event's device time in us (`cuda_time_total` before torch 2.4)."""
    us = getattr(ev, "device_time_total", None)
    return ev.cuda_time_total if us is None else us


def step_profile(prof, steps: int = 1):
    """From a trace holding `steps` calls of slam_step: ({range: (host ms,
    device ms)}, the steps' window in ms, the device's busy ms inside it).

    The ranges are the step ("slam_step") and each of its "slam_step.<stage>"
    ranges.  A range's device time is the sum of the kernels (and copies)
    launched inside it; each range is summed over the steps and divided by
    `steps`, so a stage that some steps skip (the keyframe branch) is a mean
    over all of them.  The window runs from the first step's start to the
    last step's end, the host's gaps between steps included; busy time is
    the union of all device activity inside it, in total (not per step)."""
    from torch.autograd import DeviceType

    events = prof.events()
    ranges = [e for e in events if e.device_type == DeviceType.CPU
              and (e.name == "slam_step" or e.name.startswith("slam_step."))]
    step = [e for e in ranges if e.name == "slam_step"]
    counts = Counter(e.name for e in ranges)
    if len(step) != steps or max(counts.values()) > steps:
        raise ValueError(f"expected {steps} slam_step ranges with at most one range per "
                         f"stage each, got {dict(counts)}")
    stages = {}
    for e in ranges:
        host, dev = stages.get(e.name, (0.0, 0.0))
        stages[e.name] = (host + e.cpu_time_total / 1e3 / steps,
                          dev + launched_us(e) / 1e3 / steps)
    t0 = min(e.time_range.start for e in step)
    t1 = max(e.time_range.end for e in step)
    busy = device_busy_us(events, t0, t1, skip=lambda e: e.name.startswith("slam_step"))
    return stages, (t1 - t0) / 1e3, busy / 1e3


def launched_us(ev) -> float:
    """Device us of the kernels and copies that a host event (a torch op or a
    range) launched, its children's included.  CUPTI's overhead records
    ("Activity Buffer Request", "Buffer Flush") land among the ops and can
    carry a second copy of an op's kernels: they do not count, where
    `device_time_total` counts them."""
    own = getattr(ev, "activity_type", "cpu_op") in ("cpu_op", "user_annotation")
    return ((sum(k.duration for k in ev.kernels) if own else 0.0)
            + sum(launched_us(c) for c in ev.cpu_children))


# The host calls that put work on the device: CUPTI records each on the host,
# and its kernel, copy or set on the device, under one correlation id
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync")


def lost_launches(events, t0=float("-inf")) -> int:
    """The launches (LAUNCH_CALLS on the host) among profiler `events` from
    `t0` on whose device event the trace lacks: events the trace lost."""
    from torch.autograd import DeviceType

    on_device = {e.id for e in events if e.device_type != DeviceType.CPU}
    return sum(1 for e in events if e.device_type == DeviceType.CPU
               and e.name in LAUNCH_CALLS and e.time_range.start >= t0
               and e.id not in on_device)


def collective_trace(events) -> dict:
    """What a trace of all-reduces and CUDA graph replays holds: the
    all-reduce calls made on the host ("c10d::allreduce_" ops, captured ones
    included), the replays ("cudaGraphLaunch" calls), the device's kernels and
    copies split into those the replays launched (a replay's kernels carry
    its cudaGraphLaunch's correlation id) and the rest, the NCCL all-reduce
    kernels (names from "nccl" holding "allreduce", user annotations left
    out) of each, their names, and the replays whose device events the trace
    lacks."""
    from torch.autograd import DeviceType

    host = [e for e in events if e.device_type == DeviceType.CPU]
    replays = {e.id for e in host if e.name == "cudaGraphLaunch"}
    device = [e for e in events if e.device_type != DeviceType.CPU
              and not getattr(e, "is_user_annotation", False)]
    replayed = [e for e in device if e.id in replays]
    nccl = [e for e in device if e.name.lower().startswith("nccl")
            and "allreduce" in e.name.lower()]
    return dict(allreduce_calls=sum(1 for e in host if e.name == "c10d::allreduce_"),
                replays=len(replays), replayed_events=len(replayed),
                eager_events=len(device) - len(replayed),
                replayed_nccl=sum(1 for e in nccl if e.id in replays),
                eager_nccl=sum(1 for e in nccl if e.id not in replays),
                nccl_names=sorted(Counter(e.name for e in nccl).items()),
                replays_without_events=len(replays - {e.id for e in replayed}))


def device_busy_us(events, t0=float("-inf"), t1=float("inf"), skip=lambda e: False) -> float:
    """The union of the device activity among profiler `events` inside
    [t0, t1], in us.  Events on the CPU, user annotations and those `skip`
    selects do not count."""
    from torch.autograd import DeviceType

    spans = sorted((max(e.time_range.start, t0), min(e.time_range.end, t1)) for e in events
                   if e.device_type != DeviceType.CPU and not skip(e)
                   and not getattr(e, "is_user_annotation", False))
    busy, cur = 0.0, None
    for a, b in spans:
        if b <= a:
            continue
        if cur is None or a > cur[1]:
            busy += 0 if cur is None else cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    return busy + (0 if cur is None else cur[1] - cur[0])
