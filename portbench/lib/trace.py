"""The profiled stretches of a traced run, reduced to what the per-layer
metrics and the breakdown read.

A traced run profiles a fixed number of units (steps or frames) in the
middle of its window twice, each time synchronised before and after; the
traces stay in memory and only these summaries are kept.

  device stretch  torch.profiler recording device activity alone (no host
                  operators; the tracing of each launch still costs the host
                  some microseconds, which stay in the stretch); it lies
                  between two marker kernels launched on an idle device, and
                  its busy time, its length and its kernels all come from
                  the trace.
                  The per-layer metrics, device.busy_s / window_s and the
                  breakdown's device_ops read it.
  host stretch    CPU and CUDA activity: the host's operators label the
                  breakdown's idle gaps (the profiler's own host cost widens
                  them, so nothing else reads this stretch).
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Tuple

Interval = Tuple[str, float, float]  # (name, start, end), seconds


@dataclasses.dataclass
class Stretch:
    units: int                    # steps or frames profiled
    kernels: List[Interval]       # every device activity (kernel, copy, set)
    host_ops: List[Interval]      # host-side operators, for labelling gaps
    start: float                  # the stretch's first and last moments on
    end: float                    # the trace's clock

    @property
    def launches(self) -> int:
        return sum(1 for n, _, _ in self.kernels if not is_transfer(n))

    def busy_s(self) -> float:
        return union_length([(s, e) for _, s, e in self.kernels], self.start, self.end)

    def kernel_seconds(self, match) -> float:
        """Device seconds of the activities whose name `match` accepts."""
        return sum(e - s for n, s, e in self.kernels if match(n))


def is_transfer(name: str) -> bool:
    return name.startswith("Memcpy") or name.startswith("Memset") or name.startswith("[memory]")


def union_length(spans, lo: float, hi: float) -> float:
    """Length of the union of [s, e] spans clipped to [lo, hi]: overlapping
    activities (several streams) count once."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in spans):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(spans, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The intervals of [lo, hi] in which no activity ran."""
    gaps, t = [], lo
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in spans):
        if e <= s:
            continue
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def label_gaps(gaps, host_ops: List[Interval]) -> Dict[str, float]:
    """Idle seconds by the innermost host operator open when each gap began
    ("host" where none was: Python between the program's calls)."""
    ops = sorted(host_ops, key=lambda o: o[1])
    starts = [o[1] for o in ops]
    out: Dict[str, float] = {}
    for a, b in gaps:
        i = bisect.bisect_right(starts, a) - 1
        label = "host"
        for j in range(i, max(i - 64, -1), -1):
            if ops[j][2] >= a:
                label = ops[j][0]
                break
        out[label] = out.get(label, 0.0) + (b - a)
    return out


NAME_CHARS = 160


def top(by_name: Dict[str, float], n: int = 10):
    """The n largest entries, names cut to NAME_CHARS characters."""
    return [[k[:NAME_CHARS], v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]


def breakdown(device: Stretch, host: Stretch) -> dict:
    ops: Dict[str, float] = {}
    for n, s, e in device.kernels:
        ops[n] = ops.get(n, 0.0) + (e - s)
    gaps = idle_gaps([(s, e) for _, s, e in host.kernels], host.start, host.end)
    return {"device_ops": top(ops), "idle_gaps": top(label_gaps(gaps, host.host_ops))}


def _events(prof):
    """(device activities, host operators) of a finished profile, as
    intervals in seconds on the trace's clock."""
    from torch.autograd import DeviceType

    kernels, host = [], []
    for e in prof.events():
        tr = e.time_range
        iv = (e.name, tr.start * 1e-6, tr.end * 1e-6)
        if e.device_type == DeviceType.CUDA:
            kernels.append(iv)
        elif not e.name.startswith("cuda") and not e.name.startswith("ProfilerStep"):
            host.append(iv)
    return kernels, host


def profile_device(fn, units: int, sync, device) -> Stretch:
    """Run fn() `units` times with the device's activity traced, between two
    marker kernels each launched once the device is idle: the stretch runs
    from the first marker's end to the last one's start."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    marker = torch.zeros(1, device=device)
    sync()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        marker.add_(1.0)
        sync()
        for _ in range(units):
            fn()
        sync()
        marker.add_(1.0)
        sync()
    return between_markers(_events(prof)[0], units)


def between_markers(kernels: List[Interval], units: int) -> Stretch:
    """The stretch between the first activity (a marker) and the last (the
    other marker), from the end of the one to the start of the other."""
    kernels = sorted(kernels, key=lambda k: k[1])
    if len(kernels) < 2:
        return Stretch(units=units, kernels=[], host_ops=[], start=0.0, end=0.0)
    start, end = kernels[0][2], kernels[-1][1]
    return Stretch(units=units, kernels=kernels[1:-1], host_ops=[], start=start, end=end)


def profile_host(fn, units: int, sync) -> Stretch:
    """Run fn() `units` times under torch.profiler with the host's operators
    and the device's activity; the stretch runs from the first host
    operator's start to the last event's end."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    sync()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(units):
            fn()
        sync()
    kernels, host = _events(prof)
    if host:
        start = min(s for _, s, _ in host)
        end = max(e for _, _, e in host + kernels)
    else:
        start = end = 0.0
    return Stretch(units=units, kernels=kernels, host_ops=host, start=start, end=end)
