#!/usr/bin/env python3
"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

from the root of a checkout.  The cell, its configuration, its traffic
and its metrics are read from BENCHMARK.json and the files it names
(harness/cell.py).  A run makes its weights and inputs on the card from
``--seed``, warms up the shapes its traffic uses (set-up, ``setup_s``),
measures for ``--seconds``, then with ``--trace 1`` traces one more unit
of work for the per-layer metrics, frees the program's state and checks
what the timed path produced against the plain float32 reference.  The
numbers compared go to standard error as its last lines and into the
result, the last line of standard output:

    {"correct", "attempted", "failed", "metrics", "device"[, "breakdown"],
     "checks"}

Without a CUDA card, or with fewer than the cell asks for, it exits 3 and
prints no result; likewise if JAX or the JAX package is loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

T_IMPORT = time.time()
BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
for p in (str(ROOT), str(BENCH_DIR)):
    if p not in sys.path:
        sys.path.insert(0, p)

# compile and kernel caches at fixed paths inside the checkout (the
# program's nvcc library goes to build/torch_kernels/ by itself)
for var, sub in (("TRITON_CACHE_DIR", "triton_cache"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor_cache")):
    os.environ[var] = str(ROOT / "build" / sub)
os.environ["USE_FLAX"] = "0"

EXIT_NO_CARD, EXIT_FORBIDDEN = 3, 4


def process_start() -> float:
    """The wall time this process started (Linux: its start tick against
    the boot time), else the time this file was imported."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        boot = time.time() - uptime
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return T_IMPORT


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def require_cards(n: int) -> None:
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"this cell needs {n} CUDA card(s); {have} visible. The "
              "benchmark measures the card and never falls back to the CPU.",
              file=sys.stderr)
        sys.exit(EXIT_NO_CARD)


class Context:
    """What a per-layer metric's reader reads: the cell, the window's
    spans and counters, the traced window, the device and the window's
    peak of allocated memory."""

    def __init__(self, cell, runner, trace, device_name, peak_bytes):
        self.cell = cell
        self.peak_bytes = peak_bytes
        self.config = cell.config
        self.traffic = cell.traffic
        self.spans = runner.spans
        self.counters = runner.counters
        self.trace = trace
        self.device_name = device_name
        self.runner = runner


def execute(args, device=None, overrides=None, shrink=None, hooks=(),
            t_start=None):
    """One run of ``args.workload``; returns the result dict.  ``device``,
    ``overrides``, ``shrink`` and ``hooks`` serve the CPU tests (a
    narrowed configuration, a planted fault); the command line always runs
    on the card."""
    import torch
    from harness import cell as cells
    from harness import compare
    from harness import trace as tracing
    t_start = t_start if t_start is not None else process_start()
    cell = cells.load_cell(args.workload)
    if shrink is not None:
        shrink(cell)
    dev = torch.device(device or "cuda")
    on_card = dev.type == "cuda"
    runner = cells.generator(cell.kind)(cell, args.seed, dev, overrides)
    runner.hooks = list(hooks)
    runner.setup()
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.time() - t_start
    win = runner.window(args.seconds, spans=bool(args.trace))
    peak = int(torch.cuda.max_memory_allocated(dev)) if on_card else 0
    name = torch.cuda.get_device_name(dev) if on_card else "cpu"
    device_info = {"platform": "gpu" if on_card else "cpu", "kind": name,
                   "count": cell.chips, "memory_peak_bytes": peak}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics = {}
    breakdown = None
    if args.trace:
        tw = tracing.trace(runner.traced_unit)
        ctx = Context(cell, runner, tw, name, peak)
        for m in cell.per_layer:
            v = cells.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_info.update(busy_s=tw.busy_s, window_s=tw.window_s)
        breakdown = tw.breakdown()
    else:
        metrics["setup_s"] = {"value": setup_s, "unit": units["setup_s"]}
        for k, v in win["metrics"].items():
            metrics[k] = {"value": v, "unit": units[k]}
    runner.release()
    readings = runner.check()
    checks = compare.checks_of(readings, cell.checks["limits"])
    result = {"correct": compare.passed(checks) and win["failed"] == 0,
              "attempted": win["attempted"], "failed": win["failed"],
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in checks}
    return result


def main(argv=None) -> int:
    t_start = process_start()
    args = parse(argv)
    from harness import cell as cells
    require_cards(cells.load_cell(args.workload).chips)
    result = execute(args, t_start=t_start)
    found = cells.forbidden_loaded()
    if found:
        print(f"loaded in this process, which the benchmark forbids: "
              f"{found}", file=sys.stderr)
        return EXIT_FORBIDDEN
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
