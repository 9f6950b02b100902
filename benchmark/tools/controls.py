#!/usr/bin/env python3
"""The readings the limits of ``correct`` are set from, at a cell's own
size on the card, several seeds in one process.

    python3 benchmark/tools/controls.py --workload <cell> --seeds 1,2,3
        --variant <variant> [--out FILE]

Every variant goes through the cell's own timed path and check, with a
window just long enough for the check's sample.  ``program``: the program
as the configuration states it (a lower reading; it also reads the former
control, a reference with int4 products and K/V teacher-forced on the
served tokens).  A served cell's controls, each a run of its own:
``int4_cache``, the program's own int4 KV cache in place of the stated
int8 (the decode's), and ``int8_detok``, the program's own int8 decode
stage in place of the stated bfloat16 convs and kernel B (the detok's);
and its fault ``topk_off``, sampling over the whole vocabulary, which no
precision can show.  A training cell's control ``control``: the
reference computed with float8 (e4m3, per-tensor scale) operands in the
program's place; its faults ``half_batch`` (half of each batch left out,
the loss the mean over the rest) and ``unchanged`` (a step whose
optimizer leaves the state as it was).  One JSON line a seed: the
variant, the seed and the readings.  The benchmark's own runs never run
this.
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

SERVED = ("program", "int4_cache", "int8_detok", "topk_off")
TRAINED = ("program", "control", "half_batch", "unchanged")


def served(cell, seed, variant, device, overrides=None):
    """A served cell's readings: set-up, the fewest units of work that
    fill the check's greedy and sampled samples, the check."""
    from harness import cell as cells
    tr = cell.traffic
    tr["greedy_every"] = 2                       # greedy, sampled, ...
    if tr["kind"] == "offline":
        tr["keep_rows"] = tr["check_rows"]       # one batch of each holds it
    if variant == "int4_cache":
        cell.config["dtypes"]["cache_dtype"] = "int4"
    drv = cells.generator(cell.kind)(cell, seed, device, overrides)
    drv.int8_decode = variant == "int8_detok"
    drv.int4_ref = variant == "program"
    if variant == "topk_off":
        # the service reads 0 as "no top-k", the pipeline None
        drv.top_k = None if tr["kind"] == "offline" else 0
    drv.setup()
    if tr["kind"] == "offline":
        drv.unit(0)
        drv.unit(1)
    else:
        lat = []
        while min(len(drv.kept), len(drv.kept_sampled)) < \
                tr["check_requests"]:
            drv.unit(lat)
    drv.release()
    return drv.check()


def trained(cell, seed, variant, device, overrides=None, hooks=()):
    from harness import cell as cells
    from harness import compare
    from reference import gpt_vae as ref_vae
    drv = cells.generator(cell.kind)(cell, seed, device, overrides)
    drv.hooks = list(hooks)
    if variant == "control":
        # the reference at the lower precision stands in for the program
        from harness import program
        drv.exp = program.experiment(cell.config, overrides)
        steps = drv.reference_steps()
        low = compare.reference_train(cell.config, seed, device, steps,
                                      matmul=ref_vae.fp8_matmul)
        ref = compare.reference_train(cell.config, seed, device,
                                      drv.reference_steps())
        return compare.train_readings(low, ref)
    if variant == "unchanged":
        import torch
        step = torch.optim.AdamW.step
        torch.optim.AdamW.step = lambda self, closure=None: None
        try:
            drv.setup()
        finally:
            torch.optim.AdamW.step = step
    else:
        if variant == "half_batch":
            drv.hooks.append(("batch", lambda x, eps: (
                x[: x.shape[0] // 2], eps[: eps.shape[0] // 2])))
        drv.setup()
    drv.release()
    return drv.check()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variant", required=True,
                    choices=sorted(set(SERVED + TRAINED)))
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    from harness import cell as cells
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = cells.load_cell(args.workload)
        t0 = time.perf_counter()
        if cell.kind == "train":
            r = trained(cell, seed, args.variant, "cuda")
        else:
            r = served(cell, seed, args.variant, "cuda")
        line = json.dumps({"workload": args.workload, "variant":
                           args.variant, "seed": seed, "readings": r,
                           "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
