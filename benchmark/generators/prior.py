"""Bulk sampling from a GPT-VAE's prior: back-to-back batches of latents
z ~ N(0, I) through the pipeline's three stages, ``generate_tokens`` ->
``decode_specs`` -> ``vocode``, one batch in flight: the host queues a
batch before it waits for the one before to end.

The pipeline is the program's own ``GenerationPipeline`` over the
decoder's tree and config (a latent-prompt pipeline): a batch is a count
of clips, and the pipeline draws their latents from the batch's generator
before the sampling uniforms.  The mix's file gives the batch, the
sampling knobs, the conv stages' chunk and every how many batches one
decodes greedily; each batch's seed comes from the run's seed.  Every
batch keeps ``keep_rows`` of its rows (drawn from the seed) with their
latents and its batch's seed for the check that decides ``correct``: a
greedy batch its latents, tokens, spectrograms and waveforms, a sampled
one its latents and tokens.  The check draws each kept row's latent again
from the batch's seed and holds the program's to it.

Set-up warms the card with ``WARM_BATCHES`` batches of the mix before the
window, so that its first batches run as its last do.  A program without
the prior path (a pipeline that knows no latent prompt) is refused at the
start of set-up, before anything is built.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict

import numpy as np
import torch

from generators import offline
from generators.offline import _sync
from harness import prior_check, program, weights


def require_prior_path():
    """Exit at once unless the program's pipeline takes a latent prompt."""
    from melspec_gpt_vqvae_tpu_torch.pipeline import GenerationPipeline
    if not hasattr(GenerationPipeline, "_prompt"):
        raise SystemExit("the program's GenerationPipeline has no latent "
                         "prompt: it cannot sample a GPT-VAE's prior")


def _mark(dev):
    """An event at the end of the work queued so far (None on the CPU,
    whose work is done when queued)."""
    if dev.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record()
    return ev


# set-up's batches: the first two capture the sampled and the greedy
# decode; the rest run the mix's pattern until the card's clocks and power
# draw have settled under this load (after two alone, the window's first
# one to three batches ran 2-3% slower on an H100, one of them under its
# power cap)
WARM_BATCHES = 6


class Generator(offline.Generator):
    """The offline mix's window, release and row picking over a
    latent-prompt pipeline; hooks: "tokens" on a batch's tokens, "latents"
    on the latents kept for the check."""

    # -- traffic ------------------------------------------------------------
    def batch(self, i: int):
        greedy = i % self.tr["greedy_every"] == 0
        gen = torch.Generator(device=self.dev).manual_seed(
            int(self.rng.integers(0, 2 ** 62)))
        return greedy, gen

    def run_batch(self, greedy, gen, spans=False, sync=True):
        tr, pipe = self.tr, self.pipe
        if spans:
            _sync(self.dev)
            t0 = time.perf_counter()
        with torch.profiler.record_function("bench.generate_tokens"):
            toks, drawn = pipe.generate_tokens(
                tr["batch"], gen, temperature=tr["temperature"],
                top_k=self.top_k, sample=not greedy)
        for stage, fn in self.hooks:
            if stage == "tokens":
                toks = fn(toks)
        if spans:
            _sync(self.dev)
            t1 = time.perf_counter()
        with torch.profiler.record_function("bench.decode_specs"):
            specs = pipe.decode_specs(toks)
        with torch.profiler.record_function("bench.vocode"):
            wavs = pipe.vocode(specs)
        if sync or spans:
            _sync(self.dev)
        if spans:
            t2 = time.perf_counter()
            self.spans["generate_tokens"].append(t1 - t0)
            self.spans["detok"].append(t2 - t1)
        return drawn["latents"], toks, specs, wavs

    # -- phases -------------------------------------------------------------
    def setup(self):
        require_prior_path()
        from melspec_gpt_vqvae_tpu_torch.models.gpt_vae import \
            make_vae_configs
        from melspec_gpt_vqvae_tpu_torch.pipeline import GenerationPipeline
        exp = program.experiment(self.cfg, self.overrides)
        exp = dataclasses.replace(
            exp, model=make_vae_configs(exp.model, exp.vae).decoder)
        self.exp = exp
        serving = self.cfg["serving"]
        dec = prior_check.decoder_weights(
            self.cfg, self.seed, self.dev,
            program.DTYPES[self.cfg["dtypes"]["dtype"]])
        vq_w, mg_w = program.detok_weights(
            self.cfg, self.seed, self.dev,
            program.DTYPES[serving["conv_dtype"]])
        vq, mg = program.program_detok(exp, vq_w, mg_w, self.dev)
        self.pipe = GenerationPipeline(
            exp, dec, vq, mg, segments=serving["segments"],
            chunk=self.tr["chunk"],
            bf16=serving["conv_dtype"] == "bfloat16", device=self.dev,
            int8_decode=self.int8_decode)
        for i in range(WARM_BATCHES):
            gen = torch.Generator(device=self.dev).manual_seed(i)
            self.run_batch(i % self.tr["greedy_every"] == 1, gen)

    def unit(self, n: int, spans: bool = False, sync: bool = True) -> None:
        """Batch ``n`` of the mix, its kept rows drawn from the seed, each
        with its batch's seed and its row for the check's own draw.  The
        rows stay on the device until the check, so that without ``sync``
        nothing here waits for the batch."""
        greedy, gen = self.batch(n)
        batch_seed = gen.initial_seed()
        z, toks, specs, wavs = self.run_batch(greedy, gen, spans, sync)
        rows = np.sort(self.rng.choice(self.tr["batch"],
                                       self.tr["keep_rows"], replace=False))
        r = torch.as_tensor(rows, device=toks.device)
        z = z[r]
        for stage, fn in self.hooks:
            if stage == "latents":
                z = fn(z)
        where = (torch.full((len(rows),), batch_seed, dtype=torch.int64),
                 torch.as_tensor(rows))
        if greedy:
            self.kept.append((*where, z, toks[r], specs[r], wavs[r]))
        else:
            self.kept_sampled.append((*where, z, toks[r]))

    def window(self, seconds: float, spans: bool) -> Dict:
        """The offline window, with one batch in flight: the host queues
        batch n, then waits for batch n - 1 to end, so that a batch's
        host-bound start (the latent draw, the eager prefill: 20-50 ms on
        an H100's host, varying from process to process) runs while the
        card finishes the batch before.  The window ends once a batch
        ended past ``seconds`` and the one in flight has ended too.  A
        traced window (``spans``) synchronises every batch, as the offline
        one does, for its host-clock spans."""
        if spans:
            return super().window(seconds, spans)
        self.spans = {"generate_tokens": [], "detok": []}
        t0 = time.perf_counter()
        n, before = 0, None
        while True:
            self.unit(n, sync=False)
            n += 1
            end = _mark(self.dev)
            if before is not None:
                before.synchronize()
            before = end
            # two batches at least: a greedy one and a sampled one to check
            if time.perf_counter() - t0 >= seconds and n >= 2:
                break
        _sync(self.dev)
        elapsed = time.perf_counter() - t0
        clips = n * self.tr["batch"]
        self.counters.update(batches=n, units=n, clips=clips,
                             window_s=elapsed,
                             steps=self.exp.vqvae.code_h
                             * self.exp.vqvae.code_w)
        return {"metrics": {"clips_per_s": clips / elapsed},
                "attempted": clips, "failed": 0}

    def traced_unit(self):
        _, gen = self.batch(10 ** 6)
        self.run_batch(False, gen)
        self.counters.update(traced_clips=self.tr["batch"], traced_units=1)

    def check(self) -> Dict[str, float]:
        """The reference over ``check_rows`` of the kept greedy rows and as
        many of the sampled ones, drawn from the seed."""
        rng = np.random.default_rng(weights.derive(self.seed, "check"))
        kept, kept_sampled = ([tuple(t.cpu() for t in k) for k in ks]
                              for ks in (self.kept, self.kept_sampled))
        greedy = self._pick(kept, self.tr["check_rows"], rng)
        sampled = self._pick(kept_sampled, self.tr["check_rows"], rng)
        return prior_check.prior_readings(self.cfg, self.seed, self.dev,
                                          greedy, sampled, self.tr["top_k"],
                                          self.tr["batch"],
                                          int4_ref=self.int4_ref)
