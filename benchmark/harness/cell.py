"""A cell as BENCHMARK.json names it, with the files it is made of.

Everything that belongs to one configuration, traffic mix or per-layer
metric sits in a file of its own, found by the name BENCHMARK.json gives:

  benchmark/configs/<config>.json    the configuration as it is run
  benchmark/traffic/<traffic>.json   the mix: its ``kind`` names the
                                     generator in benchmark/generators/
  benchmark/checks/<workload>.json   the numbers compared for
                                     ``correct`` and their limits
  benchmark/metrics/<metric>.py      a per-layer metric's reader:
                                     ``read(ctx) -> float | None``
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

# whole top-level module names that must never be loaded: JAX and the JAX
# package (the program's own name begins with the latter's)
FORBIDDEN = ("jax", "jaxlib", "flax", "melspec_gpt_vqvae_tpu")


def forbidden_loaded(modules=None) -> List[str]:
    """The FORBIDDEN top-level names present in ``sys.modules``, compared
    as whole names (the part before the first dot)."""
    names = {m.split(".", 1)[0] for m in (modules if modules is not None
                                          else list(sys.modules))}
    return sorted(n for n in names if n in FORBIDDEN)


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    checks: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def _covers(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, spec: Optional[Dict] = None) -> Cell:
    """The workload ``name`` of BENCHMARK.json (or of ``spec``), with its
    configuration, traffic and checks read from their files and the
    metrics it reports."""
    spec = spec if spec is not None else load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; known: "
                         f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(ROOT / configs[w["config"]]["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    checks = load_json(BENCH_DIR / "checks" / f"{name}.json")
    e2e = [m for m in spec["end_to_end"] if _covers(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    return Cell(name, int(w["chips"]), config, traffic, checks, e2e,
                per_layer)


def reader(metric: str) -> Callable:
    """The ``read`` function of benchmark/metrics/<metric>.py."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    mod_name = "bench_metric_" + "".join(
        ch if ch.isalnum() else "_" for ch in metric)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def generator(kind: str):
    """The generator of a traffic ``kind``: benchmark/generators/<kind>.py's
    ``Generator``."""
    path = BENCH_DIR / "generators" / f"{kind}.py"
    spec = importlib.util.spec_from_file_location(f"bench_generator_{kind}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.Generator
