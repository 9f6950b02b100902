"""A traced window: ``torch.profiler`` over one unit of a cell's work,
reduced to what the per-layer readers take.

The device's busy time is the union of the kernels' intervals on the
timeline (kernels of a CUDA graph replay included), never their sum; the
window is the host's span of the traced unit, which ends synchronised.
The first window of a process is a throwaway: the tracer can lose
launches while it starts.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

BREAKDOWN_ENTRIES = 10
NAME_CHARS = 160


@dataclass
class Kernel:
    name: str
    start_ns: int
    dur_ns: int


@dataclass
class TraceWindow:
    kernels: List[Kernel]
    window_s: float
    # (start, end, name) of the host's operations and the benchmark's
    # annotations (``record_function``), for naming the device's gaps
    host: List[Tuple[int, int, str]] = field(default_factory=list)
    # the idle gaps, named, of a window that traced the host as well
    gaps: Optional[List[List]] = None

    def busy_intervals(self) -> List[Tuple[int, int]]:
        spans = sorted((k.start_ns, k.start_ns + k.dur_ns)
                       for k in self.kernels)
        merged: List[List[int]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def kernel_seconds(self, match: Callable[[str], bool]) -> float:
        return sum(k.dur_ns for k in self.kernels if match(k.name)) / 1e9

    def kernel_count(self, match: Callable[[str], bool]) -> int:
        return sum(1 for k in self.kernels if match(k.name))

    def top_kernels(self) -> List[List]:
        by: Dict[str, int] = {}
        for k in self.kernels:
            name = k.name[:NAME_CHARS]
            by[name] = by.get(name, 0) + k.dur_ns
        top = sorted(by.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]
        return [[n, ns / 1e9] for n, ns in top]

    def idle_gaps(self) -> List[List]:
        """The longest gaps between busy intervals, each named by the
        innermost host operation under the benchmark's innermost
        annotation at the gap's middle."""
        iv = self.busy_intervals()
        gaps = sorted(((iv[i + 1][0] - iv[i][1], iv[i][1], iv[i + 1][0])
                       for i in range(len(iv) - 1)), reverse=True)
        out = []
        for ns, s, e in gaps[:BREAKDOWN_ENTRIES]:
            out.append([self._host_at((s + e) // 2), ns / 1e9])
        return out

    def _host_at(self, t: int) -> str:
        over = [(e - s, name) for s, e, name in self.host if s <= t <= e]
        if not over:
            return "host: nothing traced"
        notes = sorted((d, n) for d, n in over if n.startswith("bench."))
        ops = sorted((d, n) for d, n in over if not n.startswith("bench."))
        parts = ([notes[0][1]] if notes else []) + ([ops[0][1]] if ops
                                                     else [])
        return " > ".join(parts)[:NAME_CHARS]

    def breakdown(self) -> Dict[str, List[List]]:
        return {"device_ops": self.top_kernels(),
                "idle_gaps": self.gaps if self.gaps is not None
                else self.idle_gaps()}


_WARM = False


def _window(run, activities) -> Tuple[TraceWindow, object]:
    from torch.profiler import profile
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        run()
        window = time.perf_counter() - t0
    kernels, host = [], []
    for ev in prof.profiler.kineto_results.events():
        kind = str(ev.device_type())
        if ev.is_user_annotation() or ev.name().startswith("bench."):
            # the benchmark's annotations (``record_function``) mark the
            # host's side only; their device-side copies are no work
            if not kind.endswith("CUDA"):
                s = int(ev.start_ns())
                host.append((s, s + int(ev.duration_ns()), ev.name()))
            continue
        if kind.endswith("CUDA"):
            kernels.append(Kernel(ev.name(), int(ev.start_ns()),
                                  int(ev.duration_ns())))
        else:
            s = int(ev.start_ns())
            host.append((s, s + int(ev.duration_ns()), ev.name()))
    return TraceWindow(kernels, window, host)


def trace(run: Callable[[], None], warm: Optional[Callable[[], None]] = None
          ) -> TraceWindow:
    """``run()`` (which must leave the device idle: synchronise) traced
    twice: once for the device alone -- the window every metric and the
    device's busy time are read from, since recording the host's
    operations slows a host-bound step by a third -- and once with the
    host's operations, which only name the idle gaps (their lengths as
    that window has them).  ``warm`` (default ``run``) is the process's
    throwaway first window."""
    global _WARM
    import torch
    from torch.profiler import ProfilerActivity
    # (a CPU test has no device to trace: its window traces the host)
    device = [ProfilerActivity.CUDA if torch.cuda.is_available()
              else ProfilerActivity.CPU]
    if not _WARM:
        _window(warm or run, device)
        _WARM = True
    tw = _window(run, device)
    named = _window(run, [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    tw.gaps = named.idle_gaps()
    return tw
