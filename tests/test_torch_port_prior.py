"""PyTorch port: a GPT-VAE sampled from its prior through the normal path
(pipeline.py's latent prompt, serving.py, the sample CLI), on the CPU.

The decoder is a tiny GPT-VAE's with an odd head count (3 heads, as the
XL preset's 23 is odd) and seeded random weights, every leaf moved off
its initial value.  Its tokens are held to the benchmark's plain float32
reference (benchmark/reference/prior.py, imported by path), teacher-forced
on the latents the pipeline drew and the tokens it decoded: the logits the
pipeline sampled from (the prefill's, then each cached step's) against
the reference's full forward over ``[z, tokens[:-1]]``.
"""

import dataclasses
import json
import sys
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from melspec_gpt_vqvae_tpu_torch import sample as sample_cli
from melspec_gpt_vqvae_tpu_torch import serving
from melspec_gpt_vqvae_tpu_torch.configs import (ExperimentConfig, GPTConfig,
                                                 VAEConfig, VocoderConfig,
                                                 VQVAEConfig)
from melspec_gpt_vqvae_tpu_torch.models import gpt as G
from melspec_gpt_vqvae_tpu_torch.models.gpt_vae import (make_vae_configs,
                                                        sample_from_prior)
from melspec_gpt_vqvae_tpu_torch.pipeline import GenerationPipeline
from melspec_gpt_vqvae_tpu_torch.training.checkpoint import CheckpointManager
from melspec_gpt_vqvae_tpu_torch.utils import profiling

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmark"))
from reference import prior as ref_prior  # noqa: E402

torch.set_num_threads(1)

VQ = VQVAEConfig(num_embeddings=16, embedding_dim=8, ch=8, ch_mult=(1, 2),
                 num_res_blocks=1, attn_resolutions=(), z_channels=8,
                 resolution=8, code_h=2, code_w=4)
VOC = VocoderConfig(n_mel_channels=4, ngf=4, n_residual_layers=1,
                    ratios=(2, 2))
# 8 codes a clip (2 x 4), the decoder one position longer for the latent
BASE = GPTConfig(vocab_size=16, block_size=8, n_layer=2, n_head=3,
                 n_embd=24)
MODEL = {"vocab_size": 16, "block_size": 8, "n_layer": 2, "n_head": 3,
         "n_embd": 24}
SMALL = "n_layer=1,n_head=3,n_embd=24"


def prior_exp(**dtypes):
    base = BASE.replace(**dtypes)
    vae = VAEConfig(nz=base.n_embd)
    return ExperimentConfig(model=make_vae_configs(base, vae).decoder,
                            vqvae=VQ, vocoder=VOC, vae=vae)


def moved(tree, seed):
    """``tree`` with N(0, 0.05) added to every leaf: biases, norms and the
    position embedding off their initial values, so every term counts."""
    g = torch.Generator().manual_seed(seed)

    def go(t):
        if isinstance(t, dict):
            return {k: go(v) for k, v in t.items()}
        return t + 0.05 * torch.randn(t.shape, generator=g).to(t.dtype)
    return go(tree)


def flat(tree, prefix=""):
    """``{"a": {"b": t}}`` -> ``{"/a/b": t}``."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}"
        out.update(flat(v, name) if isinstance(v, dict) else {name: v})
    return out


def prior_pipeline(seed=3, **dtypes):
    exp = prior_exp(**dtypes)
    gpt, vq, mg = serving.random_weights(exp, seed)
    return GenerationPipeline(exp, moved(gpt, seed), vq, mg, segments=2,
                              chunk=3, bf16=False)


@pytest.fixture
def logits_seen(monkeypatch):
    """The logits each token is sampled from, in order."""
    seen = []
    real = G.sample_logits

    def spy(key, logits, **kw):
        seen.append(logits.clone())
        return real(key, logits, **kw)
    monkeypatch.setattr(G, "sample_logits", spy)
    return seen


@pytest.mark.parametrize("sample", [False, True])
def test_float32_decode_logits_equal_the_reference(logits_seen, sample):
    """Float32 weights and cache: the prefill's logits and each cached
    step's equal the reference's teacher-forced forward over the latent
    and the decoded tokens within 1e-4 (float32 rounding of two orders of
    the same sums, the cache's per-step products against the full
    forward's; the logits are ~0.5 in size)."""
    pipe = prior_pipeline()
    gen = torch.Generator().manual_seed(11)
    toks, drawn = pipe.generate_tokens(5, gen, top_k=6, sample=sample)
    got = torch.stack(logits_seen, dim=1)           # (N, steps, V)
    want = ref_prior.prior_logits(pipe.gpt_params, MODEL, drawn["latents"],
                                  toks)
    assert toks.shape == (5, 8) and got.shape == want.shape == (5, 8, 16)
    assert float(want.abs().max()) > 0.2
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_int8_greedy_tokens_lie_within_the_quantisation_gap():
    """int8 cache and int8 block weights: each greedy token's reference
    logit lies within 0.05 of the reference's best at its position.  The
    int8 rows, weights and K/V each round to 1/254 of their row's or
    column's largest value; over two layers that moves the ~0.5-wide
    logits by under 0.02, so only a near tie can part the two argmaxes,
    and by less than 0.05 -- a token chosen at random lies ~1 below."""
    pipe = prior_pipeline(cache_dtype="int8", decode_weight_dtype="int8")
    toks, drawn = pipe.generate_tokens(8, torch.Generator().manual_seed(5),
                                       sample=False)
    ref = ref_prior.prior_logits(pipe.gpt_params, MODEL, drawn["latents"],
                                 toks)
    gap = ref.max(-1).values - ref.gather(-1, toks[..., None])[..., 0]
    assert float(gap.max()) <= 0.05
    wrong = (toks + 8) % 16
    gap_wrong = ref.max(-1).values - ref.gather(-1, wrong[..., None])[..., 0]
    assert float(gap_wrong.max()) > 0.5


def test_latents_come_back_from_the_seed():
    """The latents are the prior's draw from the request's generator,
    made before its sampling uniforms: the same seed gives the same
    latents and tokens, another seed others."""
    pipe = prior_pipeline()
    runs = [pipe.generate_tokens(4, torch.Generator().manual_seed(s))
            for s in (7, 7, 8)]
    (t1, d1), (t2, d2), (t3, d3) = runs
    assert torch.equal(d1["latents"], d2["latents"]) and torch.equal(t1, t2)
    assert not torch.equal(d1["latents"], d3["latents"])
    cfgs = make_vae_configs(BASE, VAEConfig(nz=BASE.n_embd))
    want = sample_from_prior(cfgs, 4, torch.Generator().manual_seed(7))
    assert d1["latents"].dtype == torch.float32
    assert torch.equal(d1["latents"], want)
    assert pipe.latent_rows == 12 and pipe.class_rows == 0


def test_a_class_pipeline_decodes_as_before():
    """A class pipeline's tokens are ``gpt_generate``'s from the class
    embedding, as before the latent prompt; it returns no latents."""
    base = BASE.replace(block_size=9, class_size=4)
    exp = dataclasses.replace(prior_exp(), model=base)
    gpt, vq, mg = serving.random_weights(exp, 2)
    gpt = moved(gpt, 2)
    pipe = GenerationPipeline(exp, gpt, vq, mg, segments=2, bf16=False)
    assert pipe.prompt == "class"
    cls = [0, 3, 1]
    toks, extra = pipe.generate_tokens(cls, torch.Generator().manual_seed(4))
    want = G.gpt_generate(gpt, base, torch.Generator().manual_seed(4),
                          G.class_embed(gpt, torch.tensor(cls)), steps=8,
                          top_k=100, segments=2)
    assert extra == {} and torch.equal(toks, want)
    assert pipe.class_rows == 3 and pipe.latent_rows == 0
    out = pipe.generate(cls, torch.Generator().manual_seed(4))
    assert set(out) == {"tokens", "specs", "wavs"}


def test_a_latent_prompt_takes_no_draft_and_a_latent_as_wide():
    exp = prior_exp()
    gpt, vq, mg = serving.random_weights(exp, 1)
    with pytest.raises(ValueError, match="draft"):
        GenerationPipeline(exp, gpt, vq, mg, draft_params=gpt,
                           draft_cfg=exp.model)
    wrong = dataclasses.replace(exp, vae=VAEConfig(nz=16))
    with pytest.raises(ValueError, match="nz"):
        GenerationPipeline(wrong, gpt, vq, mg)


def test_pipeline_generate_returns_the_latents():
    pipe = prior_pipeline()
    out = pipe.generate(3, torch.Generator().manual_seed(2), sample=False)
    assert out["latents"].shape == (3, 24) and out["tokens"].shape == (3, 8)
    assert out["wavs"].shape[0] == out["specs"].shape[0] == 3


def test_a_prior_request_goes_through_the_service():
    """``clips=3`` at batch 2: two padded batches, three clips and their
    latents back, the same for the same seed; classes are refused."""
    pipe = prior_pipeline()
    svc = serving.GenerationService(pipe.exp, pipe, batch=2, seed=1)
    a = svc.generate(clips=3, seed=9)
    b = svc.generate(clips=3, seed=9)
    assert a["tokens"].shape == (3, 8) and a["latents"].shape == (3, 24)
    assert a["wavs"].shape[0] == 3
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError, match="clips"):
        svc.generate([0, 1])
    with pytest.raises(ValueError, match="clips"):
        svc.generate(clips=0)
    assert pipe.latent_rows == 8      # two requests of two batches of 2


def test_a_prior_request_over_http():
    pipe = prior_pipeline()
    svc = serving.GenerationService(pipe.exp, pipe, batch=2, seed=1)
    httpd = serving.serve(svc, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}/generate"
        req = urllib.request.Request(url, data=json.dumps(
            {"num": 3, "seed": 4}).encode())
        with urllib.request.urlopen(req) as r:
            body = json.loads(r.read())
        assert len(body["clips"]) == 3
        assert all(set(c) == {"wav_base64"} for c in body["clips"])
        with urllib.request.urlopen(url) as r:   # one clip as a WAV
            assert r.headers["Content-Type"] == "audio/wav"
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_build_pipeline_restores_a_gpt_vae_runs_decoder(tmp_path,
                                                        monkeypatch):
    """``model="GPT_VAE"`` with ``experiment=``: the decoder's leaves of
    a ``train_gpt_vae`` checkpoint (``state.params.decoder``), the encoder
    left unread; the pipeline's config the decoder's."""
    from melspec_gpt_vqvae_tpu_torch.configs import (load_preset,
                                                     parse_overrides)
    monkeypatch.chdir(tmp_path)
    exp = load_preset("GPT_VAE", "vggsound", **parse_overrides(SMALL))
    cfgs = make_vae_configs(exp.model, exp.vae)
    g = torch.Generator().manual_seed(0)
    params = {"encoder": G.init_gpt_params(cfgs.encoder, g),
              "decoder": moved(G.init_gpt_params(cfgs.decoder, g), 1)}
    ckpt = CheckpointManager(str(tmp_path / "lightning_logs" /
                                 "xl-vggsound" / "checkpoints" / "version_0"))
    ckpt.save({"state": {"params": params, "step": 3}, "epoch": 2}, step=3)
    ckpt.wait()
    got_exp, pipe = serving.build_pipeline(
        "vggsound", model="GPT_VAE", experiment="xl", resume="last",
        override=SMALL, device="cpu")
    assert got_exp.model == cfgs.decoder and pipe.prompt == "latent"
    want, have = flat(params["decoder"]), flat(pipe.gpt_params)
    assert want.keys() == have.keys()
    assert all(torch.equal(want[n], have[n]) for n in want)


def test_build_pipeline_refuses_a_draft_for_the_prior():
    with pytest.raises(ValueError, match="draft"):
        serving.build_pipeline("vggsound", model="GPT_VAE", init_random=True,
                               override=SMALL, draft_random="n_layer=1",
                               device="cpu")


def test_sample_cli_writes_prior_clips(tmp_path, capsys):
    out_dir = tmp_path / "prior"
    summary = sample_cli.main([
        "--model", "GPT_VAE", "--dataset", "vggsound", "--init_random",
        "--device", "cpu", "--override", SMALL, "--num", "3", "--batch", "2",
        "--save_codes", "--out_dir", str(out_dir)])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == summary and summary["written"] == 3
    assert sorted(p.name for p in out_dir.iterdir()) == [
        f"prior_{i:03d}{s}" for i in range(3)
        for s in (".wav", "_codes.npy")]
    assert np.load(out_dir / "prior_002_codes.npy").shape == (265,)


def test_sample_cli_refuses_a_class_gpt_without_a_preset():
    with pytest.raises(SystemExit, match="vggsound"):
        sample_cli.main(["--dataset", "vggsound", "--init_random",
                         "--device", "cpu"])


def test_prior_spans_and_counters_are_recorded_under_a_profiler():
    """While a profiler runs: ``pipeline.prior_latents`` (rows, nz) inside
    ``pipeline.generate_tokens`` (prompt "latent"), a class pipeline's
    ``generate_tokens`` with prompt "class"; the row counters."""
    profiling.recorded(clear=True)
    pipe = prior_pipeline()
    with profile(activities=[ProfilerActivity.CPU]):
        pipe.generate_tokens(4, torch.Generator().manual_seed(1))
    spans = profiling.recorded(clear=True)
    (outer,) = [s for s in spans if s.name == "pipeline.generate_tokens"]
    (draw,) = [s for s in spans if s.name == "pipeline.prior_latents"]
    assert outer.attrs == {"prompt": "latent"}
    assert draw.attrs == {"rows": 4, "nz": 24} and draw.parent == outer.id
    assert [s.parent for s in spans if s.name == "gpt.decode"] == [outer.id]
    assert draw.end_ns <= min(s.start_ns for s in spans
                              if s.name == "gpt.decode")
    assert (pipe.latent_rows, pipe.class_rows) == (4, 0)
    exp = dataclasses.replace(prior_exp(), model=BASE.replace(
        block_size=9, class_size=4))
    cpipe = GenerationPipeline(exp, *serving.random_weights(exp, 1),
                               bf16=False)
    with profiling.recording():
        cpipe.generate_tokens([1, 2], None, sample=False)
    (cls_span,) = [s for s in profiling.recorded(clear=True)
                   if s.name == "pipeline.generate_tokens"]
    assert cls_span.attrs == {"prompt": "class"}
    assert (cpipe.class_rows, cpipe.latent_rows) == (2, 0)
