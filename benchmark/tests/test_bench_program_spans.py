"""The readers of the program's own spans (harness/spans.py): each new
metric on a narrowed cell on the CPU (a finite number, or None where it
needs CUDA events or the device's kernels), their arithmetic on a traced
window made by hand, and a program without spans, which gives None and
raises nothing."""

import math
import types

import pytest
import torch

from harness import cell as cells
from harness import spans as program_spans
from harness.trace import Kernel, TraceWindow

import tiny

torch.set_num_threads(4)

# the new metrics by cell, and those the CPU cannot read (device events,
# the device's idle gaps)
NEW = {
    "vas_gpt.serve_b8": ["queue_wait_ms.serve", "service_self_ms.serve",
                         "decode_device_ms.serve", "decode_idle_ms.serve"],
    "vas_gpt.offline_b512": ["decode_device_ms.offline",
                             "detok_device_ms_per_clip.offline"],
    "vas_gpt_vae.train_b24": ["forward_host_ms.train",
                              "backward_host_ms.train",
                              "optimizer_host_ms.train",
                              "forward_idle_ms.train",
                              "backward_idle_ms.train"],
}
CARD_ONLY = {"decode_device_ms.serve", "decode_idle_ms.serve",
             "decode_device_ms.offline", "detok_device_ms_per_clip.offline",
             "forward_idle_ms.train", "backward_idle_ms.train"}


@pytest.mark.parametrize("workload", list(NEW))
def test_new_readers_on_a_narrow_cell(workload):
    reported = {m["name"] for m in cells.load_cell(workload).per_layer}
    assert set(NEW[workload]) <= reported
    r = tiny.run(workload, seed=2 ** 33 + 3, trace=1)
    assert r["correct"]
    for name in NEW[workload]:
        if name in CARD_ONLY:
            assert name not in r["metrics"], name
        else:
            v = r["metrics"][name]["value"]
            assert math.isfinite(v) and v >= 0, (name, v)


def _span(sid, name, start, end, parent=None, request=None, device_ms=None,
          **attrs):
    return types.SimpleNamespace(id=sid, name=name, start_ns=start,
                                 end_ns=end, parent=parent, request=request,
                                 device_ms=device_ms, attrs=attrs,
                                 ms=(end - start) / 1e6)


def _ctx(spans, kernels, host=(), steps=4):
    tw = TraceWindow([Kernel("k", s, d) for s, d in kernels], 1.0,
                     list(host))
    ctx = types.SimpleNamespace(trace=tw, counters={"steps": steps,
                                                    "traced_clips": 8})
    ctx.program_spans = spans
    return ctx


MS = 1_000_000


def test_idle_goes_to_the_innermost_span():
    """Kernels at 0-1, 3-4, 10-11 and 20-21 ms: the gap 1-3 lies in the
    decode loop, 4-10 in its stage alone, 11-20 under no span."""
    spans = [_span(1, "service.request", 0, 12 * MS, request=1),
             _span(2, "pipeline.generate_tokens", 0, 9 * MS, parent=1),
             _span(3, "gpt.decode", 1 * MS, 5 * MS, parent=2)]
    ctx = _ctx(spans, [(0, MS), (3 * MS, MS), (10 * MS, MS), (20 * MS, MS)])
    by = program_spans.idle_by_span(ctx)
    assert by == {"gpt.decode": 2.0, "pipeline.generate_tokens": 6.0}
    read = cells.reader("decode_idle_ms.serve")
    assert read(ctx) == 2.0


def test_service_self_leaves_out_stages_and_outside_syncs():
    """A 20 ms request: stages of 5 + 6 ms, a copy of 1 ms, and 4 ms of the
    benchmark's synchronisation between two stages (one more inside a
    stage counts with the stage): 20 - 12 - 4 = 4 ms of its own."""
    spans = [_span(1, "service.request", 0, 20 * MS, request=1),
             _span(2, "service.wait", 0, MS // 10, parent=1),
             _span(3, "pipeline.generate_tokens", 1 * MS, 6 * MS, parent=1,
                   device_ms=8.0),
             _span(4, "pipeline.decode_specs", 10 * MS, 16 * MS, parent=1,
                   device_ms=2.0),
             _span(5, "pipeline.to_host", 17 * MS, 18 * MS, parent=1)]
    host = [(6 * MS, 10 * MS, "cudaDeviceSynchronize"),
            (11 * MS, 12 * MS, "cudaDeviceSynchronize"),
            (2 * MS, 3 * MS, "cudaLaunchKernel")]
    ctx = _ctx(spans, [(MS, MS), (18 * MS, MS)], host, steps=4)
    assert cells.reader("service_self_ms.serve")(ctx) == pytest.approx(4.0)
    assert cells.reader("queue_wait_ms.serve")(ctx) == pytest.approx(0.1)
    assert cells.reader("decode_device_ms.serve")(ctx) == 2.0
    # the detok wants both of its stages
    assert cells.reader("detok_device_ms_per_clip.offline")(ctx) is None
    spans.append(_span(6, "pipeline.vocode", 16 * MS, 17 * MS, parent=1,
                       device_ms=2.0))
    assert cells.reader("detok_device_ms_per_clip.offline")(ctx) == 0.5


def test_train_phases_a_step():
    spans = []
    for step in range(2):
        t = step * 10 * MS
        spans += [_span(3 * step + 1, "train.forward", t, t + 2 * MS),
                  _span(3 * step + 2, "train.backward", t + 2 * MS,
                        t + 7 * MS),
                  _span(3 * step + 3, "train.optimizer", t + 7 * MS,
                        t + 8 * MS)]
    # gaps: 1 ms in each step's forward, 6.5 and 1.5 ms in the backwards
    kernels = [(0, MS // 2), (3 * MS // 2, 2 * MS), (10 * MS, MS // 2),
               (3 * MS // 2 + 10 * MS, MS), (14 * MS, 4 * MS)]
    ctx = _ctx(spans, kernels)
    assert cells.reader("forward_host_ms.train")(ctx) == 2.0
    assert cells.reader("backward_host_ms.train")(ctx) == 5.0
    assert cells.reader("optimizer_host_ms.train")(ctx) == 1.0
    assert cells.reader("forward_idle_ms.train")(ctx) == 1.0
    assert cells.reader("backward_idle_ms.train")(ctx) == 4.0


def test_spans_outside_the_window_are_dropped(monkeypatch):
    """The recorder holds every traced run's spans: only those over the
    kernels of the device's window are read."""
    from melspec_gpt_vqvae_tpu_torch.utils import profiling
    held = [_span(1, "train.forward", 0, MS),
            _span(2, "train.forward", 5 * MS, 6 * MS),
            _span(3, "train.forward", 9 * MS, 10 * MS)]
    monkeypatch.setattr(profiling, "recorded", lambda: held)
    ctx = _ctx([], [(4 * MS, 3 * MS)])
    del ctx.program_spans
    assert [s.id for s in program_spans.traced(ctx)] == [2]


def test_a_program_without_spans_gives_none(monkeypatch):
    from melspec_gpt_vqvae_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "recorded")
    ctx = _ctx([], [(0, MS), (2 * MS, MS)])
    del ctx.program_spans
    for names in NEW.values():
        for name in names:
            assert cells.reader(name)(ctx) is None, name
