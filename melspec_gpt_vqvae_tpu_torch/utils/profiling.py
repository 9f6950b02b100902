"""Profiling helpers: FLOP counts, a step timer and a torch.profiler trace.

Counterpart of melspec_gpt_vqvae_tpu/utils/profiling.py.  The step timer's
MFU divides by the peak of the card in use, looked up by its name and the
parameter dtype; for a card or dtype without a known peak it reports no
MFU.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch

# Dense peak of the NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W
# limit) for float32 outside the tensor cores: what float32 products run
# at with TF32 off.
PEAK_FLOPS = {("NVIDIA H100 80GB HBM3", torch.float32): 67e12}


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


class StepTimer:
    """Rolling steps/s and examples/s over ``window`` steps, plus tokens/s
    when the tokens per example are known and MFU when the useful FLOPs
    per step and the device's peak are.  Host clock: the window's last
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
        self.t0 = time.time()
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
        self.t0 = time.time()
        self.steps = 0
        self.examples = 0
        return out
