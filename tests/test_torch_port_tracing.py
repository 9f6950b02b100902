"""PyTorch port: spans and the collector's counter (utils/profiling.py) and
the step timer's repairs, on the CPU.

A span records nothing and is the shared no-op context with the recorder
off; under a CPU ``torch.profiler`` session or inside ``recording()`` it
records its parent and request, one stack a thread, and its host times
hold the profiler's ``record_function`` range of the same name (one
clock).  A tiny served request gives the span tree of the port's layers,
a tiny GPT-VAE train step its three phases in order.
"""

import dataclasses
import gc
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from melspec_gpt_vqvae_tpu_torch.configs import (DataConfig,
                                                 ExperimentConfig, GPTConfig,
                                                 TrainConfig, VAEConfig,
                                                 VocoderConfig, VQVAEConfig)
from melspec_gpt_vqvae_tpu_torch.pipeline import GenerationPipeline
from melspec_gpt_vqvae_tpu_torch.serving import (GenerationService,
                                                 random_weights)
from melspec_gpt_vqvae_tpu_torch.training.vae_task import VAETask
from melspec_gpt_vqvae_tpu_torch.utils import profiling

torch.set_num_threads(1)

H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(autouse=True)
def empty_buffer():
    profiling.recorded(clear=True)
    yield
    profiling.recorded(clear=True)


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_off_records_nothing_and_shares_the_noop():
    assert not torch.autograd._profiler_enabled()
    a = profiling.span("x", clips=2)
    b = profiling.span("y", device=torch.device("cpu"), request=True)
    assert a is b is profiling._NOOP
    with a:
        with b:
            pass
    assert profiling.recorded() == []


def _nest():
    with profiling.span("outer", request=True, k=1):
        with profiling.span("inner"):
            with profiling.span("leaf"):
                pass


def _check_nest(spans):
    s = _by_name(spans)
    (o,), (i,), (leaf,) = s["outer"], s["inner"], s["leaf"]
    assert o.parent is None and o.request == o.id and o.attrs == {"k": 1}
    assert i.parent == o.id and leaf.parent == i.id
    assert i.request == leaf.request == o.id
    assert o.start_ns <= i.start_ns <= leaf.start_ns <= leaf.end_ns \
        <= i.end_ns <= o.end_ns
    assert o.device_ms is None
    assert o.thread == i.thread == leaf.thread == threading.get_ident()


@pytest.mark.parametrize("mode", ["profiler", "recording"])
def test_spans_nest_with_parents_and_requests(mode):
    ctx = (profile(activities=[ProfilerActivity.CPU]) if mode == "profiler"
           else profiling.recording())
    with ctx:
        _nest()
    _check_nest(profiling.recorded())
    # outside the block the recorder is off again
    assert profiling.span("after") is profiling._NOOP


def test_threads_keep_separate_stacks():
    """Two threads open requests at once: each span's parent and request
    are its own thread's."""
    go = threading.Barrier(2, timeout=10)
    idents = {}

    def work(tag):
        idents[tag] = threading.get_ident()
        with profiling.span(f"req.{tag}", request=True):
            go.wait()
            with profiling.span(f"step.{tag}"):
                go.wait()
    with profiling.recording():
        with profiling.span("main"):
            ts = [threading.Thread(target=work, args=(t,)) for t in "ab"]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=10)
    assert not any(t.is_alive() for t in ts)
    s = _by_name(profiling.recorded())
    for tag in "ab":
        (req,), (step,) = s[f"req.{tag}"], s[f"step.{tag}"]
        assert req.parent is None and req.request == req.id
        assert step.parent == req.id and step.request == req.id
        assert req.thread == step.thread == idents[tag]
    assert s["req.a"][0].id != s["req.b"][0].id


def test_spans_hold_their_profiler_ranges():
    """Each span's [start_ns, end_ns] holds the profiler's record_function
    range of its name, within 50 us: the two share one clock."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(3):
            with profiling.span(f"clock.{i}"):
                torch.ones(64).sum()
    ranges = {ev.name(): (ev.start_ns(), ev.start_ns() + ev.duration_ns())
              for ev in prof.profiler.kineto_results.events()
              if ev.name().startswith("clock.")}
    spans = {s.name: s for s in profiling.recorded()}
    assert set(ranges) == set(spans) == {f"clock.{i}" for i in range(3)}
    slack = 50_000
    for name, (lo, hi) in ranges.items():
        s = spans[name]
        assert s.start_ns - slack <= lo <= hi <= s.end_ns + slack, \
            (name, s.start_ns, lo, hi, s.end_ns)


def test_no_device_event_inside_a_capture(monkeypatch):
    """A span opened on a CUDA device while the current stream is being
    captured into a graph records no event (a capture must not see one)."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)

    def refuse(*a, **kw):
        raise AssertionError("an event was made during a capture")
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    with profiling.recording():
        with profiling.span("pipeline.x", device=torch.device("cuda")):
            pass
    (s,) = profiling.recorded()
    assert s.device_ms is None and s.events is None


def _tiny_service():
    vq = VQVAEConfig(num_embeddings=16, embedding_dim=8, ch=8,
                     ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(),
                     z_channels=8, resolution=8, code_h=2, code_w=4)
    gpt = GPTConfig(vocab_size=16, block_size=9, n_layer=2, n_head=2,
                    n_embd=16, class_size=4)
    voc = VocoderConfig(n_mel_channels=4, ngf=4, n_residual_layers=1,
                        ratios=(2, 2))
    exp = dataclasses.replace(ExperimentConfig(model=gpt), vqvae=vq,
                              vocoder=voc)
    g, v, m = random_weights(exp, 3)
    pipe = GenerationPipeline(exp, g, v, m, segments=2, chunk=3, bf16=False)
    return GenerationService(exp, pipe, batch=2, seed=1)


def test_served_request_gives_the_span_tree():
    """A request of three clips (two batches of two): the request at the
    root, the wait for the lock and each batch's stages and copies under
    it, the decode loop under ``generate_tokens``; no device times on the
    CPU."""
    svc = _tiny_service()
    with profiling.recording():
        svc.generate([1, 2, 3], seed=4)
    s = _by_name(profiling.recorded())
    (root,) = s["service.request"]
    assert root.parent is None and root.request == root.id
    assert root.attrs == {"clips": 3, "sample": True}
    (wait,) = s["service.wait"]
    assert wait.parent == root.id
    for stage in ("generate_tokens", "decode_specs", "vocode", "to_host"):
        got = s[f"pipeline.{stage}"]
        assert len(got) == 2 and all(x.parent == root.id for x in got)
    ids = [x.id for x in s["pipeline.generate_tokens"]]
    assert [x.parent for x in s["gpt.decode"]] == ids
    assert all(x.request == root.id and x.device_ms is None
               for xs in s.values() for x in xs if x.name != "host.gc")
    order = [x.name for x in profiling.recorded()
             if x.name.startswith("pipeline.")][:4]
    assert order == ["pipeline.generate_tokens", "pipeline.decode_specs",
                     "pipeline.vocode", "pipeline.to_host"]
    assert all(root.start_ns <= x.start_ns and x.end_ns <= root.end_ns
               for xs in s.values() for x in xs)


def test_train_step_gives_its_phases_in_order():
    base = GPTConfig(vocab_size=11, block_size=12, n_layer=1, n_head=2,
                     n_embd=16)
    exp = ExperimentConfig(model=base, vae=VAEConfig(nz=16),
                           train=TrainConfig(batch_size=2),
                           data=DataConfig(batch_size=2))
    task = VAETask(exp, 3, torch.device("cpu"))
    state = task.init_state(0)
    x = torch.randint(0, 11, (2, 12), generator=torch.Generator()
                      .manual_seed(0))
    with profiling.recording():
        task.train_step(state, x, torch.Generator().manual_seed(1))
    names = [s.name for s in profiling.recorded() if s.name != "host.gc"]
    assert names == ["train.forward", "train.backward", "train.optimizer"]
    spans = [s for s in profiling.recorded() if s.name != "host.gc"]
    assert all(a.end_ns <= b.start_ns for a, b in zip(spans, spans[1:]))


def test_collections_move_the_gc_counter():
    before = profiling.gc_stats()
    gc.collect()
    after = profiling.gc_stats()
    assert after["collections"][2] == before["collections"][2] + 1
    assert after["seconds"][2] > before["seconds"][2]
    with profiling.recording():
        gc.collect()
    (s,) = [x for x in profiling.recorded() if x.name == "host.gc"
            and x.attrs["generation"] == 2]
    assert s.end_ns >= s.start_ns and s.device_ms is None


def test_bfloat16_peak_of_the_h100(monkeypatch):
    """Mixed precision's products run at the H100's bf16 peak, so a
    GPT-VAE run under it reports MFU."""
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: H100)
    card = torch.device("cuda")
    assert profiling.peak_flops(card, torch.bfloat16) == 989e12
    assert profiling.peak_flops(card, torch.float32) == 67e12
    t = profiling.StepTimer(window=1, flops_per_step=1e9,
                            peak=profiling.peak_flops(card, torch.bfloat16))
    assert t.tick(1)["perf/mfu_pct"] > 0


def test_step_timer_reports_the_collectors_ms():
    t = profiling.StepTimer(window=2)
    assert t.tick(1) is None
    gc.collect()
    out = t.tick(1)
    assert out["perf/gc_ms"] > 0
    # the window after it starts from zero
    t.tick(1)
    assert np.isfinite(t.tick(1)["perf/gc_ms"])
