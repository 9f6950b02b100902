"""Offline generation: back-to-back batches of class ids through the
pipeline's three stages, ``generate_tokens`` -> ``decode_specs`` ->
``vocode``, each batch synchronised at its end.

The mix's file gives the batch, the sampling knobs, the conv stages'
chunk and every how many batches one decodes greedily; class ids are
uniform over the configuration's classes and each batch's sampling seed
comes from the run's seed.  Every batch keeps ``keep_rows`` of its rows
(drawn from the seed) for the check that decides ``correct``: a greedy
batch its tokens, spectrograms and waveforms, a sampled one its tokens.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from harness import compare, program, weights


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Generator:
    def __init__(self, cell, seed: int, device, overrides=None):
        self.cell, self.seed = cell, int(seed)
        self.dev = torch.device(device)
        self.cfg, self.tr = cell.config, cell.traffic
        self.overrides = overrides
        self.rng = np.random.default_rng(weights.derive(seed, "traffic"))
        self.kept: List = []          # greedy rows
        self.kept_sampled: List = []  # sampled rows
        self.spans: Dict[str, List[float]] = {}
        self.counters: Dict[str, float] = {}
        self.hooks = []   # (stage, fn) a test plants faults through
        # a control run's settings: the program's int8 decode stage, the
        # top-k its sampling applies, the int4 reference's readings
        self.int8_decode = False
        self.top_k = self.tr["top_k"]
        self.int4_ref = False

    # -- traffic ------------------------------------------------------------
    def batch(self, i: int):
        tr = self.tr
        classes = self.rng.integers(0, self.cfg["model"]["class_size"],
                                    tr["batch"])
        greedy = i % tr["greedy_every"] == 0
        gen = torch.Generator(device=self.dev).manual_seed(
            int(self.rng.integers(0, 2 ** 62)))
        return classes, greedy, gen

    def run_batch(self, classes, greedy, gen, spans=False):
        tr, pipe = self.tr, self.pipe
        if spans:
            _sync(self.dev)
            t0 = time.perf_counter()
        with torch.profiler.record_function("bench.generate_tokens"):
            toks, _ = pipe.generate_tokens(
                classes, gen, temperature=tr["temperature"],
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
        _sync(self.dev)
        if spans:
            t2 = time.perf_counter()
            self.spans["generate_tokens"].append(t1 - t0)
            self.spans["detok"].append(t2 - t1)
        return toks, specs, wavs

    # -- phases -------------------------------------------------------------
    def setup(self):
        self.exp, self.pipe = program.class_pipeline(
            self.cfg, self.seed, self.dev, self.tr["chunk"], self.overrides,
            int8_decode=self.int8_decode)
        warm = np.arange(self.tr["batch"]) % self.cfg["model"]["class_size"]
        for greedy in (False, True):
            gen = torch.Generator(device=self.dev).manual_seed(0)
            self.run_batch(warm, greedy, gen)

    def unit(self, n: int, spans: bool = False) -> None:
        """Batch ``n`` of the mix, its kept rows drawn from the seed."""
        classes, greedy, gen = self.batch(n)
        toks, specs, wavs = self.run_batch(classes, greedy, gen, spans)
        rows = np.sort(self.rng.choice(len(classes), self.tr["keep_rows"],
                                       replace=False))
        r = torch.as_tensor(rows, device=toks.device)
        if greedy:
            self.kept.append((torch.as_tensor(classes[rows]), toks[r].cpu(),
                              specs[r].cpu(), wavs[r].cpu()))
        else:
            self.kept_sampled.append((torch.as_tensor(classes[rows]),
                                      toks[r].cpu()))

    def window(self, seconds: float, spans: bool) -> Dict:
        self.spans = {"generate_tokens": [], "detok": []}
        t0 = time.perf_counter()
        n = 0
        while True:
            self.unit(n, spans)
            n += 1
            elapsed = time.perf_counter() - t0
            # two batches at least: a greedy one and a sampled one to check
            if elapsed >= seconds and n >= 2:
                break
        clips = n * self.tr["batch"]
        self.counters.update(batches=n, units=n, clips=clips,
                             window_s=elapsed,
                             steps=self.exp.vqvae.code_h
                             * self.exp.vqvae.code_w)
        return {"metrics": {"clips_per_s": clips / elapsed},
                "attempted": clips, "failed": 0}

    def traced_unit(self):
        classes, greedy, gen = self.batch(10 ** 6)
        self.run_batch(classes, False, gen)
        self.counters.update(traced_clips=len(classes), traced_units=1)

    def release(self):
        del self.pipe
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    @staticmethod
    def _pick(kept, n: int, rng) -> List:
        """``n`` of the kept rows drawn from ``rng``, the last batch's
        always among them."""
        rows = [(b, i) for b, k in enumerate(kept) for i in range(len(k[0]))]
        last = [r for r in rows if r[0] == len(kept) - 1]
        rest = [r for r in rows if r[0] != len(kept) - 1]
        n = min(len(rest), max(0, n - len(last)))
        pick = last + [rest[j] for j in rng.choice(len(rest), n,
                                                   replace=False)]
        return [torch.stack([kept[b][f][i] for b, i in pick])
                for f in range(len(kept[0]))]

    def check(self) -> Dict[str, float]:
        """The reference over ``check_rows`` of the kept greedy rows and as
        many of the sampled ones, drawn from the seed."""
        rng = np.random.default_rng(weights.derive(self.seed, "check"))
        greedy = self._pick(self.kept, self.tr["check_rows"], rng)
        sampled = self._pick(self.kept_sampled, self.tr["check_rows"], rng)
        return compare.served_readings(self.cfg, self.seed, self.dev, greedy,
                                       sampled, self.tr["top_k"],
                                       int4_ref=self.int4_ref)
