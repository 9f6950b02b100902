"""A cell narrowed to a size the CPU runs in seconds, for the tests: the
same layer kinds and paths at a few layers and channels.  Used only by
the tests; the benchmark's runs take the files as they are."""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
for p in (str(BENCH_DIR.parent), str(BENCH_DIR)):
    if p not in sys.path:
        sys.path.insert(0, p)

MODEL = {"n_layer": 2, "n_head": 4, "n_embd": 64}
VQVAE = {"ch": 8, "z_channels": 8, "embedding_dim": 8}
VOCODER = {"ngf": 4}
TRAFFIC = {
    "offline": {"batch": 4, "chunk": 2, "greedy_every": 2, "keep_rows": 2,
                "check_rows": 3},
    "serve": {"batch": 2, "clips_per_request": 2, "greedy_every": 2,
              "check_requests": 2, "traced_requests": 1, "chunk": 2},
    "train": {"batch": 3, "distinct_batches": 4, "warm_steps": 1,
              "traced_steps": 1},
}


def shrink(cell) -> None:
    """Narrow ``cell``'s configuration and traffic in place."""
    cell.config["model"].update(MODEL)
    for group, ov in (("vqvae", VQVAE), ("vocoder", VOCODER)):
        if group in cell.config:
            cell.config[group].update(ov)
    if "vae" in cell.config:
        cell.config["vae"]["nz"] = MODEL["n_embd"]
    cell.traffic.update(TRAFFIC[cell.traffic["kind"]])


def args(workload: str, seed: int = 5, seconds: float = 0.5,
         trace: int = 0):
    return argparse.Namespace(workload=workload, seed=seed, seconds=seconds,
                              trace=trace)


def run(workload: str, hooks=(), **kw):
    """One run of ``workload`` on the CPU at the narrow size."""
    import run as bench_run
    return bench_run.execute(args(workload, **kw), device="cpu",
                             overrides=dict(MODEL), shrink=shrink,
                             hooks=hooks)
