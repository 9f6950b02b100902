"""Profiling helpers: FLOP counts, a step timer, a torch.profiler trace,
spans and the collector's counter.

Counterpart of melspec_gpt_vqvae_tpu/utils/profiling.py.  The step timer's
MFU divides by the peak of the card in use, looked up by its name and the
parameter dtype; for a card or dtype without a known peak it reports no
MFU.

Spans mark the port's layer boundaries (``span``): the service's request
and its wait for the lock, the pipeline's stages, the GPT's decode loop,
the train step's phases.  A span records only while a ``torch.profiler``
session is active or inside ``recording()``; otherwise opening one is one
check that returns a shared no-op context.  A recorded span keeps its
host times on the profiler's clock (Unix-epoch nanoseconds, the clock of
``KinetoEvent.start_ns`` for host and device events alike), so it lies
over the kernels of the same trace; it also opens a ``record_function``
range of its name, which any profiler trace shows.  Spans nest by a
``contextvars`` stack, each thread its own; those under a request span
share its id.  The last ``SPAN_CAPACITY`` spans are kept in memory and
``recorded()`` returns them.  A callback in ``gc.callbacks`` counts the
collector's passes and seconds by generation (``gc_stats``), always, and
records each pass as a span ``host.gc`` while spans record.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import gc
import itertools
import os
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

# Dense peaks of the NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W
# limit): float32 outside the tensor cores, what float32 products run at
# with TF32 off; bfloat16 on the tensor cores, what mixed precision's
# products run at.
PEAK_FLOPS = {("NVIDIA H100 80GB HBM3", torch.float32): 67e12,
              ("NVIDIA H100 80GB HBM3", torch.bfloat16): 989e12}

SPAN_CAPACITY = 65536


def gpt_fwd_flops(n_params: int, b: int, t: int, n_layer: int,
                  d: int) -> float:
    """Forward FLOPs of one GPT pass: 2 * P * tokens for the matmuls plus
    the two attention products (4 * B * T^2 * D per layer).  Useful
    train-step FLOPs = 3x this."""
    return 2.0 * n_params * b * t + 4.0 * n_layer * b * t * t * d


def peak_flops(device: torch.device, dtype: torch.dtype) -> Optional[float]:
    """The peak FLOP/s of ``device`` for ``dtype`` products, or None."""
    if device.type != "cuda":
        return None
    return PEAK_FLOPS.get((torch.cuda.get_device_name(device), dtype))


@contextlib.contextmanager
def trace(logdir: Optional[str]) -> Iterator[None]:
    """Record a torch.profiler trace of the block (CPU and, where present,
    CUDA activity) into ``logdir/trace.json``; a no-op when None."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@dataclasses.dataclass(slots=True)
class Span:
    """A recorded span.  ``start_ns`` / ``end_ns``: host times on the
    profiler's clock; ``parent``: the id of the span open around it on its
    thread; ``request``: the id of the request span it lies under (None
    outside one); ``device_ms``: for a span opened with a CUDA ``device``,
    the device's milliseconds between the events recorded on the current
    stream at its start and its end, filled in by ``recorded``."""
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    request: Optional[int]
    thread: int
    attrs: Dict[str, object]
    device_ms: Optional[float] = None
    events: Optional[Tuple] = dataclasses.field(default=None, repr=False)

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


class _Recorder:
    """The process's recorded spans, the depth of open ``recording()``
    blocks and the collector's counts."""

    def __init__(self):
        self.spans = collections.deque(maxlen=SPAN_CAPACITY)
        self.depth = 0
        self.lock = threading.Lock()
        self.ids = itertools.count(1)
        self.gc_collections = [0, 0, 0]
        self.gc_seconds = [0.0, 0.0, 0.0]
        self.gc_start = 0


_REC = _Recorder()
# (id of the innermost open span, id of its request) on this context
_OPEN = contextvars.ContextVar("melspec_span", default=(None, None))
_NOOP = contextlib.nullcontext()


class _OpenSpan:
    __slots__ = ("name", "device", "request", "attrs", "span", "token",
                 "rf", "start_event")

    def __init__(self, name: str, device, request: bool, attrs: Dict):
        self.name, self.device = name, device
        self.request, self.attrs = request, attrs

    def __enter__(self) -> Span:
        parent, req = _OPEN.get()
        sid = next(_REC.ids)
        s = self.span = Span(self.name, 0, 0, sid, parent,
                             sid if self.request else req,
                             threading.get_ident(), self.attrs)
        self.token = _OPEN.set((sid, s.request))
        s.start_ns = time.time_ns()
        self.rf = torch.profiler.record_function(s.name)
        self.rf.__enter__()
        self.start_event = None
        dev = self.device
        if dev is not None and torch.device(dev).type == "cuda" \
                and not torch.cuda.is_current_stream_capturing():
            self.start_event = torch.cuda.Event(enable_timing=True)
            self.start_event.record(torch.cuda.current_stream(dev))
        return s

    def __exit__(self, *exc) -> bool:
        s = self.span
        if self.start_event is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self.device))
            s.events = (self.start_event, end)
        self.rf.__exit__(*exc)
        s.end_ns = time.time_ns()
        _OPEN.reset(self.token)
        _REC.spans.append(s)
        return False


def span(name: str, *, device=None, request: bool = False, **attrs):
    """A context manager that records the block as the span ``name`` with
    ``attrs`` while spans record, and does nothing otherwise.  With a CUDA
    ``device`` it also records a timing event on that device's current
    stream at the block's start and end -- no synchronisation, and none
    while the current stream is being captured into a CUDA graph.
    ``request=True`` makes the span the root of a request: the spans
    under it carry its id."""
    if not (_REC.depth or _autograd_profiler._is_profiler_enabled):
        return _NOOP
    return _OpenSpan(name, device, request, attrs)


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record spans inside the block, profiler or not."""
    with _REC.lock:
        _REC.depth += 1
    try:
        yield
    finally:
        with _REC.lock:
            _REC.depth -= 1


def recorded(clear: bool = False) -> List[Span]:
    """The kept spans in order of their start, each span's device
    milliseconds resolved (waiting for its end event); ``clear`` empties
    the buffer."""
    spans = list(_REC.spans)
    if clear:
        _REC.spans.clear()
    for s in spans:
        if s.events is not None:
            start, end = s.events
            end.synchronize()
            s.device_ms = start.elapsed_time(end)
            s.events = None
    return sorted(spans, key=lambda s: s.start_ns)


def _on_gc(phase: str, info: Dict) -> None:
    if phase == "start":
        _REC.gc_start = time.time_ns()
        return
    end = time.time_ns()
    gen = info["generation"]
    _REC.gc_collections[gen] += 1
    _REC.gc_seconds[gen] += (end - _REC.gc_start) / 1e9
    if _REC.depth or _autograd_profiler._is_profiler_enabled:
        parent, req = _OPEN.get()
        _REC.spans.append(Span("host.gc", _REC.gc_start, end, next(_REC.ids),
                               parent, req, threading.get_ident(),
                               {"generation": gen,
                                "collected": info["collected"]}))


gc.callbacks.append(_on_gc)


def gc_stats() -> Dict[str, Tuple]:
    """The collector's passes and seconds by generation (0, 1, 2) since
    this module was imported."""
    return {"collections": tuple(_REC.gc_collections),
            "seconds": tuple(_REC.gc_seconds)}


class StepTimer:
    """Rolling steps/s and examples/s over ``window`` steps, plus tokens/s
    when the tokens per example are known and MFU when the useful FLOPs
    per step and the device's peak are, and the collector's milliseconds
    a step (``perf/gc_ms``, ``gc_stats``).  Host clock: the window's last
    step has been queued, not necessarily finished, so over a short window
    the rates run ahead of the device.  Work between steps that is not a
    step (a media callback) runs inside ``paused``, whose seconds the
    window leaves out.  ``tick`` gets this process's rows; ``batch_scale``
    (the mesh's data size) makes examples and tokens a second the global
    batch's, while MFU stays this device's: ``flops_per_step`` is the
    work of one rank's step, ``peak`` one device's."""

    def __init__(self, window: int = 50, tokens_per_example: int = 0,
                 flops_per_step: float = 0.0,
                 peak: Optional[float] = None, batch_scale: int = 1):
        self.window = window
        self.tokens_per_example = tokens_per_example
        self.flops_per_step = flops_per_step
        self.peak = peak
        self.batch_scale = batch_scale
        self._reset()

    def _reset(self) -> None:
        self.t0 = time.time()
        self.gc0 = sum(_REC.gc_seconds)
        self.steps = 0
        self.examples = 0

    @contextlib.contextmanager
    def paused(self, device: Optional[torch.device] = None) -> Iterator[None]:
        """Leave the block's seconds out of the window.  On a card the
        steps queued before it are waited for first, so that their device
        time stays in the window."""
        if device is not None and device.type == "cuda":
            torch.cuda.synchronize(device)
        t = time.time()
        try:
            yield
        finally:
            self.t0 += time.time() - t

    def tick(self, batch_size: int) -> Optional[dict]:
        self.steps += 1
        self.examples += batch_size * self.batch_scale
        if self.steps % self.window:
            return None
        dt = time.time() - self.t0
        out = {"perf/steps_per_sec": self.steps / dt,
               "perf/examples_per_sec": self.examples / dt}
        if self.tokens_per_example:
            out["perf/tokens_per_sec"] = \
                self.examples * self.tokens_per_example / dt
        if self.flops_per_step and self.peak:
            out["perf/mfu_pct"] = (100.0 * self.steps * self.flops_per_step
                                   / dt / self.peak)
        out["perf/gc_ms"] = 1e3 * (sum(_REC.gc_seconds) - self.gc0) \
            / self.steps
        self._reset()
        return out
