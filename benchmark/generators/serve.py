"""Served requests: ``GenerationService.generate`` at the service's fixed
batch, driven by closed-loop clients (each sends its next request when the
last one has come back).

The mix's file gives the service's batch and queue bound, the clients,
the class ids a request carries, the sampling knobs and every how many
requests one is greedy (``deterministic``).  Class ids are uniform over
the configuration's classes and each request carries a seed of its own,
all from the run's seed.  A request's latency is its wall time at the
client; a request the service refuses or fails counts as failed.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from harness import compare, program, stats, weights


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
        self.kept: List = []          # greedy requests
        self.kept_sampled: List = []  # sampled requests
        self.spans: Dict[str, List[float]] = {}
        self._log: Dict[str, List[float]] = {}
        self.counters: Dict[str, float] = {}
        self.hooks = []
        # a control run's settings: the program's int8 decode stage, the
        # top-k its sampling applies, the int4 reference's readings
        self.int8_decode = False
        self.top_k = self.tr["top_k"]
        self.int4_ref = False
        self.n = 0

    def request(self, i: int):
        tr = self.tr
        classes = self.rng.integers(0, self.cfg["model"]["class_size"],
                                    tr["clips_per_request"]).tolist()
        return {"classes": classes,
                "seed": int(self.rng.integers(0, 2 ** 31)),
                "greedy": i % tr["greedy_every"] == 0}

    def _timed_stages(self):
        """Wrap the pipeline's three stages with synchronised spans (a
        traced run only)."""
        pipe = self.pipe
        for name in ("generate_tokens", "decode_specs", "vocode"):
            fn = getattr(pipe, name)
            self._log[name] = []

            def timed(*a, _fn=fn, _name=name, **kw):
                _sync(self.dev)
                t0 = time.perf_counter()
                with torch.profiler.record_function(f"bench.{_name}"):
                    out = _fn(*a, **kw)
                _sync(self.dev)
                self._log[_name].append(time.perf_counter() - t0)
                return out
            setattr(pipe, name, timed)

    def _plant(self):
        pipe = self.pipe
        for stage, fn in self.hooks:
            if stage == "tokens":
                inner = pipe.generate_tokens

                def faulty(*a, _inner=inner, _fn=fn, **kw):
                    toks, st = _inner(*a, **kw)
                    return _fn(toks), st
                pipe.generate_tokens = faulty

    def send(self, req) -> float:
        tr = self.tr
        t0 = time.perf_counter()
        out = self.svc.generate(req["classes"], top_k=self.top_k,
                                temperature=tr["temperature"],
                                sample=not req["greedy"], seed=req["seed"])
        dt = time.perf_counter() - t0
        return out, dt

    # -- phases -------------------------------------------------------------
    def setup(self):
        from melspec_gpt_vqvae_tpu_torch.serving import GenerationService
        tr = self.tr
        if tr["clients"] != 1:
            raise SystemExit("the serve generator drives one closed-loop "
                             f"client, not {tr['clients']}")
        self.exp, self.pipe = program.class_pipeline(
            self.cfg, self.seed, self.dev, tr["chunk"], self.overrides,
            int8_decode=self.int8_decode)
        self._plant()
        self.svc = GenerationService(
            self.exp, self.pipe, batch=tr["batch"],
            seed=weights.derive(self.seed, "service") & 0xFFFFFFFF,
            temperature=tr["temperature"], top_k=self.top_k,
            max_queue=tr["max_queue"])
        for greedy in (False, True):
            self.send({"classes": [0] * tr["clips_per_request"], "seed": 0,
                       "greedy": greedy})

    def unit(self, lat: List[float]) -> None:
        """The mix's next request, its latency appended to ``lat`` (inf
        where the service refused or failed it)."""
        from melspec_gpt_vqvae_tpu_torch.serving import ServiceOverloaded
        req = self.request(self.n)
        self.n += 1
        try:
            out, dt = self.send(req)
        except (ServiceOverloaded, RuntimeError, ValueError):
            # a refused or failed request misses any latency limit
            lat.append(float("inf"))
            return
        lat.append(dt)
        got = (torch.as_tensor(req["classes"]), torch.as_tensor(out["tokens"]))
        if req["greedy"]:
            self.kept.append(got + (torch.as_tensor(out["specs"]),
                                    torch.as_tensor(out["wavs"])))
        else:
            self.kept_sampled.append(got)

    def window(self, seconds: float, spans: bool) -> Dict:
        from melspec_gpt_vqvae_tpu_torch.models.decode_graph import \
            launch_counts
        if spans:
            self._timed_stages()
        lat: List[float] = []
        before = launch_counts()
        t0 = time.perf_counter()
        # two requests at least: a greedy one and a sampled one to check
        while len(lat) < 2 or time.perf_counter() - t0 < seconds:
            self.unit(lat)
        elapsed = time.perf_counter() - t0
        after = launch_counts()
        n, failed = len(lat), sum(x == float("inf") for x in lat)
        # the window's spans, apart from what a traced unit adds later
        self.spans = {k: list(v) for k, v in self._log.items()}
        steps = self.exp.vqvae.code_h * self.exp.vqvae.code_w
        self.latencies = lat
        self.counters.update(
            requests=n, units=n, window_s=elapsed, steps=steps,
            counted_launches=sum(after.values()) - sum(before.values()))
        p90 = stats.percentile(lat, 90)
        greedy = [x for i, x in enumerate(lat)
                  if i % self.tr["greedy_every"] == 0]
        print(f"requests {n}, failed {failed}, over {elapsed:.3f} s; "
              f"{stats.beyond(lat, 90)} beyond the 90th percentile; "
              f"latency s min {min(lat):.4f} median "
              f"{stats.percentile(lat, 50):.4f} p90 {p90:.4f} max "
              f"{max(lat):.4f}; greedy median "
              f"{stats.percentile(greedy, 50):.4f}; the port's counted "
              f"launches a step "
              f"{self.counters['counted_launches'] / (n * steps):.2f}",
              flush=True)
        return {"metrics": {"request_p90_s": p90}, "attempted": n,
                "failed": failed}

    def traced_unit(self):
        self.counters["traced_units"] = self.tr["traced_requests"]
        for i in range(self.tr["traced_requests"]):
            req = self.request(10 ** 6 + i)
            req["greedy"] = False
            self.send(req)

    def release(self):
        del self.svc, self.pipe
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> Dict[str, float]:
        """The reference over ``check_requests`` kept greedy requests and as
        many sampled ones, drawn from the seed, the last of each always
        among them."""
        rng = np.random.default_rng(weights.derive(self.seed, "check"))

        def pick(kept):
            k = len(kept)
            n = min(k - 1, self.tr["check_requests"] - 1)
            rows = [k - 1] + sorted(rng.choice(k - 1, n,
                                               replace=False).tolist())
            return [torch.cat([kept[i][f] for i in rows])
                    for f in range(len(kept[0]))]
        return compare.served_readings(self.cfg, self.seed, self.dev,
                                       pick(self.kept),
                                       pick(self.kept_sampled),
                                       self.tr["top_k"],
                                       int4_ref=self.int4_ref)
