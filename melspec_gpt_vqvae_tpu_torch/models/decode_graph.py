"""A decode loop's body as one captured program.

The JAX package's decode loop is a ``lax.scan`` inside one jitted program
(melspec_gpt_vqvae_tpu/models/gpt.py:593-596, 638-660), so its host sends
one program a request; there is no JAX file to set beside this one.  Eager
PyTorch makes some thousand small launches a token and the card waits for
the host between them.  Here the body of the loop -- the sampling of a
token and the decode step that follows it -- is recorded once in a
``torch.cuda.CUDAGraph`` and replayed once a token:

  * everything the body reads and writes lives in static buffers (the KV
    cache at its full length, the position and the step counter as
    one-element int64 tensors that the body advances on the device, the
    logits, the uniforms, the tokens), so the recorded addresses hold for
    every replay; the host keeps its own count for loop control only;
  * ``Program`` captures a callable by the documented recipe: a few eager
    runs on a side stream first (cuBLASLt's workspaces, cuDNN's plans and
    the kernels' ``cudaFuncSetAttribute`` calls happen there), then
    ``torch.cuda.graph``.  Every capture on a device uses the same side
    stream (``capture_stream``): cuBLAS keeps a workspace for each stream
    it has run on until the process ends, 32 MiB on this card, so a
    stream a capture would leave that much allocated behind every
    program, long after the program is gone.  A failed capture raises:
    nothing falls back to the eager loop;
  * under replay no wrapper runs, so ``Program`` notes how many launches of
    each counted kernel one run of the body holds and adds them to the
    wrappers' counts on every replay.  The warm-up runs launch for
    real and count as such (``DecodeGraphs.warmup_launches`` says how many);
    a body built inside ``_build.kernels(False)`` is captured all the same,
    and its capture raises if it launched a counted kernel;
  * a body that runs collectives (serving over a mesh: the model group's
    all-reduces of tensor parallelism) is captured on the stream its
    warm-up runs used, after one more small collective of every group
    there (``collectives``): NCCL records a collective into a graph only
    over a communicator that exists, and every rank of the mesh captures
    the same program and replays it in step;
  * ``DecodeGraphs`` keeps the captured sessions (buffers + programs) of a
    few request shapes across requests, the oldest evicted first.  A
    session's buffers are shared by its replays, so it is not re-entrant:
    whoever owns a holder serialises the calls that use it
    (pipeline.py::GenerationPipeline does).

On CPU tensors a ``Program`` only keeps the callable and ``replay`` calls
it: the same device-position arithmetic run eagerly, which is how the CPU
tests hold it against the JAX package.  models/gpt.py and
models/speculative.py build the sessions; this module knows nothing of the
model.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Callable, Dict, Hashable, Optional, Tuple

import torch

from .. import _build
from ..ops import decode_attention as _da
from ..ops import int8_linear as _il

WARMUP_RUNS = 3
MAX_SESSIONS = 4
_CAPTURE_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """The side stream every capture on ``device`` warms up on (and
    records collectives on), made on first use."""
    device = torch.device(device)
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    if index not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[index] = torch.cuda.Stream(index)
    return _CAPTURE_STREAMS[index]


def counted_wrappers() -> Dict[str, Tuple[Callable, str]]:
    """The kernel wrappers a decode body can launch, by counter name,
    looked up now: (wrapper, the attribute that keeps the count), each's
    ``launches``, and kernel E's ``streamed`` beside it (its launches that
    took the streamed body, counted in its ``launches`` too)."""
    e = _da.decode_attend_int8
    return {"decode_attention": (e, "launches"),
            "decode_attention_streamed": (e, "streamed"),
            "quantize_rows": (_il.quantize_rows, "launches"),
            "row_scales": (_il.row_scales, "launches"),
            "rescale_bias": (_il.rescale_bias, "launches"),
            "int8_linear_splitk": (_il.int8_linear_splitk, "launches")}


def launch_counts() -> Dict[str, int]:
    return {name: getattr(w, attr)
            for name, (w, attr) in counted_wrappers().items()}


def add_launches(delta: Dict[str, int]) -> None:
    """Add ``delta`` (counter name -> launches) to the wrappers' counts."""
    wrappers = counted_wrappers()
    for name, n in delta.items():
        w, attr = wrappers[name]
        setattr(w, attr, getattr(w, attr) + n)


class Program:
    """``fn`` (no arguments, no result; reads and writes static buffers)
    captured in a CUDA graph on ``device``, or kept as it is on the CPU.

    ``reset`` runs before each warm-up run and before the capture, on the
    stream of that run: it puts the buffers into a state the body can run
    from (a position inside the cache).  ``launches`` is what one replay
    adds to the wrappers' counts; ``warmup_launches`` what the warm-up
    runs launched.  The body is built and captured inside the caller's
    ``_build.kernels`` scope, whose switch the capture bakes in (it is
    ``kernels``): with False, a counted kernel launched in the warm-up or
    the capture raises.  ``collectives`` (the mesh's ``warm_collectives``
    where the body runs collectives) runs on the capture stream just
    before the capture."""

    def __init__(self, fn: Callable[[], None], device: torch.device,
                 reset: Optional[Callable[[], None]] = None, pool=None,
                 collectives: Optional[Callable[[], None]] = None):
        self.fn = fn
        self.kernels = _build.kernel_setting()
        self.graph = None
        self.launches: Dict[str, int] = {}
        self.warmup_launches: Dict[str, int] = {}
        if device.type == "cuda":
            self._capture(device, reset or (lambda: None), pool,
                          collectives)
        if self.kernels is False and (self.launches
                                      or any(self.warmup_launches.values())):
            raise RuntimeError(
                f"a decode body built with the kernels off launched "
                f"kernels: {self.warmup_launches} in warm-up, "
                f"{self.launches} captured")

    def _capture(self, device, reset, pool, collectives) -> None:
        before = launch_counts()
        with torch.cuda.device(device):
            side = capture_stream(device)
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(WARMUP_RUNS):
                    reset()
                    self.fn()
                reset()
                if collectives is not None:
                    collectives()
            torch.cuda.current_stream().wait_stream(side)
            warm = launch_counts()
            graph = torch.cuda.CUDAGraph()
            kw = {} if collectives is None else {"stream": side}
            with torch.cuda.graph(graph, pool=pool, **kw):
                self.fn()
        held = launch_counts()
        self.warmup_launches = {n: warm[n] - before[n] for n in warm}
        self.launches = {n: held[n] - warm[n] for n in held
                         if held[n] != warm[n]}
        # the capture recorded those launches, it did not make them
        add_launches({n: -c for n, c in self.launches.items()})
        self.graph = graph

    def replay(self) -> None:
        if self.graph is None:
            self.fn()
            return
        self.graph.replay()
        add_launches(self.launches)


class DecodeGraphs:
    """The captured sessions of at most ``max_sessions`` request shapes,
    kept across requests; the one used longest ago goes first.  A session
    is whatever ``build`` returns (models/gpt.py and models/speculative.py
    define theirs): static buffers and the ``Program``s over them, keyed
    by everything that fixes the recorded programs.  Not re-entrant."""

    def __init__(self, max_sessions: int = MAX_SESSIONS):
        self.max_sessions = max(1, int(max_sessions))
        self._sessions: "OrderedDict[Hashable, object]" = OrderedDict()
        self.captures = 0            # sessions built
        self.capture_seconds = 0.0   # host seconds spent building them
        self.warmup_launches: Dict[str, int] = {}

    def __len__(self) -> int:
        return len(self._sessions)

    def session(self, key: Hashable, build: Callable[[], object]):
        """The session under ``key``, built (warmed up and captured) on
        first use.  ``build`` returns an object whose ``programs`` are the
        ``Program``s it captured."""
        sess = self._sessions.get(key)
        if sess is not None:
            self._sessions.move_to_end(key)
            return sess
        t0 = time.perf_counter()
        sess = build()
        if sess.device.type == "cuda":
            torch.cuda.synchronize(sess.device)
        self.capture_seconds += time.perf_counter() - t0
        self.captures += 1
        for prog in sess.programs:
            for name, n in prog.warmup_launches.items():
                self.warmup_launches[name] = \
                    self.warmup_launches.get(name, 0) + n
        self._sessions[key] = sess
        while len(self._sessions) > self.max_sessions:
            self._sessions.popitem(last=False)
        return sess

    def clear(self) -> None:
        """Drop every session (its buffers and captured programs)."""
        self._sessions.clear()

    @property
    def last(self):
        """The session used most recently (None before the first)."""
        return next(reversed(self._sessions.values()), None)


def tensors_token(*trees) -> tuple:
    """What a captured program bakes in of nested dicts of tensors: every
    leaf's address, shape and dtype (None for a missing tree)."""
    out = []

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, torch.Tensor):
            out.append((t.data_ptr(), tuple(t.shape), t.dtype))
        else:
            out.append(t)
    for tree in trees:
        walk(tree)
    return tuple(out)
