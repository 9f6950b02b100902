#!/usr/bin/env python3
"""The readings the limits of a prior cell's ``correct`` are set from, at
the cell's own size on the card, several seeds in one process.

    python3 benchmark/tools/prior_controls.py --workload <cell>
        --seeds 1,2,3 --variant <variant> [--out FILE]

Every variant goes through the cell's own timed path and check
(generators/prior.py, harness/prior_check.py): set-up, one greedy and one
sampled batch, each keeping the check's sample.  ``program``: the program
as the configuration states it (a lower reading; it also reads the
control of the decode, a reference with int4 products and K/V
teacher-forced on the served tokens, ``logit_gap_int4``).
``int8_detok``: the program's own int8 decode stage in place of the
stated bfloat16 convs and kernel B (the detok's control).  ``topk_off``:
sampling over the whole vocabulary (the fault ``topk_gap`` is there to
catch, which no precision can show).  One JSON line a seed: the variant,
the seed and the readings.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
for p in (str(BENCH_DIR.parent), str(BENCH_DIR)):
    if p not in sys.path:
        sys.path.insert(0, p)

VARIANTS = ("program", "int8_detok", "topk_off")


def readings(cell, seed, variant, device, overrides=None, hooks=()):
    """A prior cell's readings under ``variant``."""
    from harness import cell as cells
    tr = cell.traffic
    tr["greedy_every"] = 2                    # greedy, sampled
    tr["keep_rows"] = tr["check_rows"]        # one batch of each holds it
    drv = cells.generator(cell.kind)(cell, seed, device, overrides)
    drv.hooks = list(hooks)
    drv.int8_decode = variant == "int8_detok"
    drv.int4_ref = variant == "program"
    if variant == "topk_off":
        drv.top_k = None
    drv.setup()
    drv.unit(0)
    drv.unit(1)
    drv.release()
    return drv.check()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variant", required=True, choices=VARIANTS)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    from harness import cell as cells
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = cells.load_cell(args.workload)
        t0 = time.perf_counter()
        r = readings(cell, seed, args.variant, "cuda")
        line = json.dumps({"workload": args.workload, "variant":
                           args.variant, "seed": seed, "readings": r,
                           "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
