"""The program's own spans (the port's ``utils/profiling.py``) in the traced
window, for the readers of the metrics that read them.

The recorder is on while the profiler traces, so it holds the spans of
every traced run of the unit; the spans kept here are those that overlap
the kernels' interval of ``ctx.trace``, the window that traced the device
alone (the harness's windows follow one another and never overlap).  The
spans' host times are on the profiler's clock, the kernels' clock too, so
an idle gap of the device lies under the spans open at its midpoint: it
is attributed to the innermost one.  A program that records no spans (one
built before them) gives none, and its readers return None.
"""

from __future__ import annotations

from bisect import bisect_right
from collections import defaultdict
from typing import Dict, List, Optional, Tuple


def _interval(tw) -> Optional[Tuple[int, int]]:
    """The kernels' interval of the traced window; on the CPU, which has no
    kernels, that of the host's events the window traced."""
    if tw is None:
        return None
    if tw.kernels:
        return (min(k.start_ns for k in tw.kernels),
                max(k.start_ns + k.dur_ns for k in tw.kernels))
    if tw.host:
        return min(s for s, _, _ in tw.host), max(e for _, e, _ in tw.host)
    return None


def traced(ctx) -> List:
    """The program's recorded spans that overlap the traced window, in
    order of their start (read once a run)."""
    kept = getattr(ctx, "program_spans", None)
    if kept is not None:
        return kept
    from melspec_gpt_vqvae_tpu_torch.utils import profiling
    recorded = getattr(profiling, "recorded", None)
    window = _interval(ctx.trace)
    kept = []
    if recorded is not None and window is not None:
        lo, hi = window
        kept = [s for s in recorded() if s.end_ns >= lo and s.start_ns <= hi]
    ctx.program_spans = kept
    return kept


def named(ctx, name: str) -> List:
    return [s for s in traced(ctx) if s.name == name]


def mean_ms(ctx, name: str) -> Optional[float]:
    """The host milliseconds of the spans ``name``, averaged over them."""
    xs = named(ctx, name)
    return sum(s.ms for s in xs) / len(xs) if xs else None


def device_ms(ctx, name: str) -> Optional[float]:
    """The device milliseconds of the spans ``name`` summed; None where any
    has none (no CUDA events: the CPU)."""
    xs = named(ctx, name)
    if not xs or any(s.device_ms is None for s in xs):
        return None
    return sum(s.device_ms for s in xs)


def host_syncs(ctx) -> List[Tuple[int, int]]:
    """The intervals the host spent in ``cudaDeviceSynchronize`` in the
    traced window (the runtime's calls the device's trace records)."""
    return [(s, e) for s, e, n in (ctx.trace.host if ctx.trace else ())
            if n == "cudaDeviceSynchronize"]


def idle_by_span(ctx) -> Dict[str, float]:
    """The device's idle milliseconds of the traced window by the name of
    the innermost program span open at each gap's midpoint (gaps under
    no span are left out)."""
    kept = getattr(ctx, "program_idle", None)
    if kept is not None:
        return kept
    tw = ctx.trace
    spans = traced(ctx)
    if tw is None or not tw.kernels or not spans:
        ctx.program_idle = {}
        return ctx.program_idle
    cuts = sorted({s.start_ns for s in spans} | {s.end_ns for s in spans})
    inner: List[Optional[str]] = []
    for a, b in zip(cuts, cuts[1:]):
        t = (a + b) / 2
        over = [s for s in spans if s.start_ns <= t < s.end_ns]
        inner.append(max(over, key=lambda s: (s.start_ns, -s.end_ns)).name
                     if over else None)
    out: Dict[str, float] = defaultdict(float)
    iv = tw.busy_intervals()
    for (_, s), (e, _) in zip(iv, iv[1:]):
        i = bisect_right(cuts, (s + e) / 2) - 1
        if 0 <= i < len(inner) and inner[i] is not None:
            out[inner[i]] += (e - s) / 1e6
    ctx.program_idle = dict(out)
    return ctx.program_idle


def idle_ms_per(ctx, name: str, per: str) -> Optional[float]:
    """The device's idle milliseconds under the spans ``name``, a span
    ``per`` (a request, a step)."""
    units = len(named(ctx, per))
    if not units or not (ctx.trace and ctx.trace.kernels):
        return None
    return idle_by_span(ctx).get(name, 0.0) / units
