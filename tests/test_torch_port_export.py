"""PyTorch port: the ``torch.export`` serving artifact (export.py), the
counterpart of JAX tests/test_serving.py:271-389.

At the tiny geometry of tests/test_torch_port_pipeline.py on the CPU: an
artifact exported, saved and loaded from disk gives the live pipeline's
tokens (greedy, and sampled for one seed: the artifact takes the
uniforms the live pipeline draws from the same generator) and its specs
and wavs to 1e-5; its decode loop is a ``scan`` a segment, each body one
decode step; every graph holds only ATen / prims ops, getitem and torch's
higher-order ops, and a custom op routed into the trace is refused; the
sidecar's dtypes let a float32 artifact take a bfloat16 pipeline's
weights; drafts and the int8 decode stage are refused; requests with other
knobs or another batch are refused, over HTTP with 400.  The entry points
(scripts/torch_export_serving.py, ``serve --artifact``) run at the VAS
widths with a one-layer GPT, where the artifact is a small fraction of the
weights it is called with.
"""

import copy
import importlib.util
import io
import json
import threading
import urllib.error
import urllib.request
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

from melspec_gpt_vqvae_tpu_torch import export as X
from melspec_gpt_vqvae_tpu_torch import pipeline as TP
from melspec_gpt_vqvae_tpu_torch import serve as serve_cli
from melspec_gpt_vqvae_tpu_torch import serving as TSV
from melspec_gpt_vqvae_tpu_torch.models import gpt as G

from test_torch_port_pipeline import tiny_pipelines

torch.set_num_threads(1)

KNOBS = dict(temperature=0.9, top_k=8, top_p=None)
BATCH = 3
SMALL = "n_layer=1,n_head=2,n_embd=32"


def _export_cli():
    spec = importlib.util.spec_from_file_location(
        "torch_export_serving", Path(__file__).resolve().parents[1]
        / "scripts" / "torch_export_serving.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pcm(blob):
    with wave.open(io.BytesIO(blob), "rb") as w:
        return np.frombuffer(w.readframes(w.getnframes()), "<i2").astype(
            np.int32)


def _export(pipe, path, sample, batch=BATCH):
    ep = X.export_serving(pipe, batch, sample=sample, **KNOBS)
    meta = X.artifact_meta(pipe, batch, sample=sample, dataset="vas",
                           **KNOBS)
    X.save_exported(ep, path, meta)
    return path


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """(live pipeline, {sample: artifact path}) of the tiny geometry."""
    pipe = tiny_pipelines()[2]
    d = tmp_path_factory.mktemp("artifacts")
    return pipe, {s: _export(pipe, str(d / f"tiny_{s}.pt2"), s)
                  for s in (False, True)}


def _graphs(ep):
    return [(n, g) for n, g in ep.graph_module.named_modules()
            if isinstance(g, torch.fx.GraphModule)]


# ------------------------------ round trip -----------------------------------

@pytest.mark.parametrize("sample", [False, True])
def test_round_trip_equals_the_live_pipeline(tiny, sample):
    pipe, paths = tiny
    apipe = X.ArtifactPipeline.from_file(paths[sample], pipe)
    assert apipe.batch == BATCH and apipe.sample_modes == (sample,)
    cls = [1, 3, 0]
    out = apipe.generate(cls, torch.Generator().manual_seed(5),
                         sample=sample, **KNOBS)
    live = pipe.generate(cls, torch.Generator().manual_seed(5),
                         sample=sample, **KNOBS)
    assert out["tokens"].dtype == np.int32 and out["tokens"].shape == (3, 8)
    np.testing.assert_array_equal(out["tokens"], live["tokens"])
    np.testing.assert_allclose(out["specs"], live["specs"], atol=1e-5)
    np.testing.assert_allclose(out["wavs"], live["wavs"], atol=1e-5)
    if sample:   # another seed, other tokens: the uniforms are an input
        other = apipe.generate(cls, torch.Generator().manual_seed(6),
                               sample=True, **KNOBS)
        assert not np.array_equal(other["tokens"], out["tokens"])


def test_decode_loop_is_a_scan_a_segment(tiny):
    """The loaded program's top graph holds one ``scan`` a segment of the
    decode (2 here), each body one decode step of both layers (two cache
    writes a layer), not an unrolled loop."""
    pipe, paths = tiny
    ep = X.load_exported(paths[False])
    top = ep.graph_module
    scans = [n for n in top.graph.nodes if n.op == "call_function"
             and isinstance(n.target, torch._ops.HigherOrderOperator)]
    plan = [seg for _, seg in G._segment_plan(1, 8, pipe.segments) if seg]
    assert [n.target.name() for n in scans] == ["scan"] * len(plan)
    bodies = [g for n, g in _graphs(ep) if n]
    assert len(bodies) == len(plan)
    for body in bodies:
        writes = [n for n in body.graph.nodes
                  if n.op == "call_function"
                  and n.target == torch.ops.aten.index_copy.default]
        assert len(writes) == 2 * pipe.gcfg.n_layer


@pytest.mark.parametrize("sample", [False, True])
def test_graphs_hold_only_aten_prims_getitem_and_hops(tiny, sample):
    ep = X.load_exported(tiny[1][sample])
    assert X.check_kernel_free(ep) == 3
    for _, g in _graphs(ep):
        for n in g.graph.nodes:
            if n.op == "call_function":
                assert X._allowed(n.target), n.target
    assert not ep.state_dict      # the weights are inputs


def test_export_refuses_a_custom_op(tiny, monkeypatch):
    """A wrapper routed through an op of its own (as a kernel would be)
    reaches the trace; the export refuses it by name."""
    pipe, _ = tiny

    @torch.library.custom_op("msgv_export_test::attend", mutates_args=())
    def attend_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  n_unmasked: int) -> torch.Tensor:
        from melspec_gpt_vqvae_tpu_torch.ops.attention import attend_xla
        return attend_xla(q, k, v, n_unmasked)

    @attend_op.register_fake
    def _(q, k, v, n_unmasked):
        return torch.empty_like(q)

    monkeypatch.setattr(G, "attend", lambda q, k, v, n: attend_op(q, k, v, n))
    with pytest.raises(RuntimeError, match="msgv_export_test"):
        X.export_serving(pipe, BATCH, sample=False, **KNOBS)


# ------------------------------ weights and dtypes ----------------------------

def test_float32_artifact_takes_a_bfloat16_pipelines_weights(tiny):
    """The sidecar records the weights' dtypes: a pipeline whose conv nets
    are bfloat16 serves a float32 artifact, its weights cast back; the
    GPT is float32 in both, so the tokens are the float32 pipeline's."""
    pipe, paths = tiny
    bpipe = TP.GenerationPipeline(pipe.exp, pipe.gpt_params,
                                  copy.deepcopy(pipe.vq),
                                  copy.deepcopy(pipe.melgan), segments=2,
                                  chunk=3, bf16=True)
    assert bpipe.vq.quant_conv.weight.dtype == torch.bfloat16
    apipe = X.ArtifactPipeline.from_file(paths[True], bpipe)
    assert all(t.dtype == torch.float32 for t in apipe.vq_state.values())
    assert all(t.dtype == torch.float32 for t in apipe.voc_state.values())
    out = apipe.generate([0, 1, 2], torch.Generator().manual_seed(3),
                         sample=True, **KNOBS)
    live = pipe.generate([0, 1, 2], torch.Generator().manual_seed(3),
                         sample=True, **KNOBS)
    np.testing.assert_array_equal(out["tokens"], live["tokens"])


def test_cast_tree_both_ways_and_refuses_another_geometry():
    leaves = [torch.ones(2), torch.ones(3, dtype=torch.bfloat16)]
    out = X._cast_tree(leaves, ["bfloat16", "float32"], "gpt")
    assert [t.dtype for t in out] == [torch.bfloat16, torch.float32]
    sd = X._cast_tree({"a": torch.ones(1)}, ["bfloat16"], "vq")
    assert list(sd) == ["a"] and sd["a"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="leaves"):
        X._cast_tree({"a": torch.ones(1), "b": torch.ones(1)}, ["float32"],
                     "gpt")


def test_from_file_needs_the_sidecar_and_the_device_type(tiny, tmp_path):
    pipe, paths = tiny
    ep = X.load_exported(paths[False])
    bare = str(tmp_path / "bare.pt2")
    X.save_exported(ep, bare)
    with pytest.raises(ValueError, match="sidecar missing"):
        X.ArtifactPipeline.from_file(bare, pipe)
    meta = json.load(open(paths[False] + ".json"))
    X.save_exported(ep, bare, {**meta, "device": "cuda"})
    with pytest.raises(ValueError, match="torch_export_serving.py"):
        X.ArtifactPipeline.from_file(bare, pipe)


# ------------------------------ refusals --------------------------------------

@pytest.mark.parametrize("kind", ["draft", "int8_decode"])
def test_unexportable_pipelines_are_refused(tiny, kind):
    pipe, _ = tiny
    kw = ({"draft_params": pipe.gpt_params, "draft_cfg": pipe.gcfg}
          if kind == "draft" else {"int8_decode": True})
    other = TP.GenerationPipeline(pipe.exp, pipe.gpt_params, pipe.vq,
                                  pipe.melgan, segments=2, chunk=3,
                                  bf16=False, **kw)
    with pytest.raises(ValueError, match="speculative" if kind == "draft"
                       else "int8-decode"):
        X.export_serving(other, BATCH, **KNOBS)


@pytest.mark.parametrize("change", [
    {"temperature": 1.0}, {"top_k": 5}, {"top_p": 0.9}, {"sample": False},
    {"classes": [0, 1]}])
def test_artifact_rejects_other_knobs_and_batch(tiny, change):
    pipe, paths = tiny
    apipe = X.ArtifactPipeline.from_file(paths[True], pipe)
    kw = {**KNOBS, "sample": True, **change}
    classes = kw.pop("classes", [0, 1, 2])
    with pytest.raises(ValueError, match="re-export|batch"):
        apipe.generate(classes, torch.Generator().manual_seed(1), **kw)


def test_http_serving_from_an_artifact(tiny):
    """The service over an ArtifactPipeline: the warm-up runs the baked
    mode only, an explicit seed gives the live service's clip, another
    top_k gets 400."""
    pipe, paths = tiny
    apipe = X.ArtifactPipeline.from_file(paths[True], pipe)
    svc = TSV.GenerationService(pipe.exp, apipe, batch=BATCH, seed=7,
                                **KNOBS)
    calls = []
    real = apipe.generate
    apipe.generate = lambda *a, **kw: calls.append(kw["sample"]) or real(
        *a, **kw)
    svc.warmup()
    assert calls == [True]
    live = TSV.GenerationService(pipe.exp, pipe, batch=BATCH, seed=7,
                                 **KNOBS)
    httpd = TSV.serve(svc, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/generate?class=2&seed=11") as r:
            assert r.status == 200
            assert r.headers["Content-Type"] == "audio/wav"
            blob = r.read()
        ref = live.generate([2], seed=11)
        want = TP.wav_bytes(ref["wavs"][0], pipe.exp.data.sample_rate)
        assert np.abs(_pcm(blob) - _pcm(want)).max() <= 1
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(url + "/generate?class=2&top_k=5")
        assert e.value.code == 400
        assert "re-export" in json.loads(e.value.read())["error"]
    finally:
        httpd.shutdown()
        httpd.server_close()


# ------------------------------ the scan form ---------------------------------

@pytest.mark.parametrize("cache, weights", [("auto", "auto"),
                                            ("int8", "int8"),
                                            ("int4", "auto")])
@pytest.mark.parametrize("sample", [False, True])
def test_scan_generate_equals_gpt_generate(cache, weights, sample):
    """``gpt_generate_scan`` (run eagerly here) gives ``gpt_generate``'s
    tokens for the same uniforms, on every cache."""
    cfg = G.GPTConfig(vocab_size=16, block_size=12, n_layer=2, n_head=2,
                      n_embd=32, class_size=4, cache_dtype=cache,
                      decode_weight_dtype=weights)
    params = G.init_gpt_params(cfg, torch.Generator().manual_seed(2))
    cond = G.class_embed(params, torch.tensor([0, 3, 1]))
    kw = dict(steps=11, top_k=5, sample=sample, segments=3)
    ref = G.gpt_generate(params, cfg, torch.Generator().manual_seed(4), cond,
                         **kw)
    u = (torch.rand((11, 3, 16), generator=torch.Generator().manual_seed(4))
         if sample else None)
    out = G.gpt_generate_scan(params, cfg, cond, u, **kw)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


# ------------------------------ the entry points ------------------------------

def test_export_script_and_serve_artifact_at_vas_width(tmp_path, capsys):
    """scripts/torch_export_serving.py on the CPU (VAS VQ-VAE and MelGAN,
    a one-layer GPT, int8 cache and weights), then ``serve --artifact``
    over the weights the same flags build: the artifact is a small
    fraction of those weights, the batch and knobs come from the sidecar,
    a greedy request is answered and a sampled one gets 400."""
    path = str(tmp_path / "vas.pt2")
    flags = ["--init_random", "--override", SMALL, "--device", "cpu",
             "--kv_cache", "int8", "--int8_weights", "1"]
    summary = _export_cli().main(flags + ["--batch", "2", "--deterministic",
                                       "--out", path])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == summary
    assert summary["sample"] is False and summary["device"] == "cpu"
    assert summary["graphs"] == 2         # one scan over the int8 cache
    httpd = serve_cli.start(flags + ["--artifact", path, "--port", "0",
                                     "--no_warmup"])
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        svc = httpd.service
        weights = sum(t.numel() * t.element_size() for t in
                      svc.pipe.gpt + list(svc.pipe.vq_state.values())
                      + list(svc.pipe.voc_state.values()))
        assert summary["bytes"] < weights / 20
        assert svc.batch == 2 and svc.pipe.sample_modes == (False,)
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        with urllib.request.urlopen(
                url + "/generate?class=3&deterministic=1") as r:
            assert r.status == 200 and len(r.read()) == 44 + 2 * 848 * 256
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(url + "/generate?class=3")
        assert e.value.code == 400
    finally:
        httpd.shutdown()
        httpd.server_close()
