"""Whole runs of each cell at a narrow geometry on the CPU (the command
line itself refuses the CPU): traffic determinism, ``correct`` true for
the program and false for each fault a cell can have and for its control,
a run without a card, and where a run writes."""

import builtins
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from harness import cell as cells
from harness.cell import BENCH_DIR, ROOT

import tiny

torch.set_num_threads(4)
SERVED = ["vas_gpt.offline_b512", "vas_gpt.serve_b8"]
TRAIN = "vas_gpt_vae.train_b24"


def _driver(workload, seed, cell=None):
    cell = cell or cells.load_cell(workload)
    tiny.shrink(cell)
    return cells.generator(cell.kind)(cell, seed, "cpu", dict(tiny.MODEL))


@pytest.mark.parametrize("workload", SERVED)
def test_served_traffic_is_the_seeds(workload):
    def draws(seed):
        d = _driver(workload, seed)
        out = []
        for i in range(6):
            if d.tr["kind"] == "offline":
                classes, greedy, gen = d.batch(i)
                out.append((classes.tolist(), greedy, gen.initial_seed()))
            else:
                r = d.request(i)
                out.append((r["classes"], r["greedy"], r["seed"]))
        return out
    big = 2 ** 33 + 7          # wider than 32 bits, as a check's seeds may be
    assert draws(big) == draws(big)
    assert draws(big) != draws(big + 1)
    # the same sizes whatever the seed: only ids and seeds move
    assert [(len(c), g) for c, g, _ in draws(1)] == \
        [(len(c), g) for c, g, _ in draws(2)]


def test_train_traffic_is_the_seeds():
    def draws(seed):
        d = _driver(TRAIN, seed)
        d.stage_batches()
        x, eps, gen = d.step_inputs(2)
        return x.clone(), eps.clone(), gen.initial_seed()
    a, b, c = draws(2 ** 33), draws(2 ** 33), draws(2 ** 33 + 1)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) \
        and a[2] == b[2]
    assert not torch.equal(a[0], c[0]) and a[2] != c[2]
    d = _driver(TRAIN, 3)
    d.stage_batches()
    # the first steps' rows all differ
    rows = torch.cat([d.step_inputs(i)[0] for i in range(3)])
    assert len({tuple(r.tolist()) for r in rows}) == len(rows)


@pytest.mark.parametrize("workload", SERVED + [TRAIN])
def test_a_sound_run_is_correct(workload):
    r = tiny.run(workload, seed=2 ** 33 + 11)
    assert r["correct"], r["checks"]
    e2e = {m["name"] for m in cells.load_cell(workload).end_to_end}
    assert set(r["metrics"]) == e2e
    assert list(r)[-1] == "checks"


def test_a_traced_run_reports_per_layer_metrics():
    """``--trace 1``: the per-layer metrics the CPU can read (spans; those
    of the device's trace are left out), the window and a breakdown."""
    r = tiny.run("vas_gpt.serve_b8", seed=3, trace=1)
    assert r["correct"]
    per_layer = {m["name"] for m in cells.load_cell("vas_gpt.serve_b8")
                 .per_layer}
    assert {"decode_step_ms.serve", "service_overhead_ms.serve"} \
        <= set(r["metrics"]) <= per_layer
    assert r["device"]["window_s"] > 0 and "breakdown" in r


def _alter_token(toks):
    """Every tenth token of every row moved half the vocabulary away."""
    toks = toks.clone()
    toks[:, ::10] = (toks[:, ::10] + 64) % 128
    return toks


@pytest.mark.parametrize("workload", SERVED)
def test_an_altered_token_is_not_correct(workload):
    r = tiny.run(workload, seed=17, hooks=[("tokens", _alter_token)])
    assert not r["correct"]
    assert r["checks"]["logit_gap"]["value"] > \
        r["checks"]["logit_gap"]["limit"]


def test_half_the_batch_is_not_correct():
    r = tiny.run(TRAIN, seed=18, hooks=[("batch", lambda x, eps: (
        x[: x.shape[0] // 2], eps[: eps.shape[0] // 2]))])
    assert not r["correct"]


def test_a_step_that_leaves_the_state_is_not_correct(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step",
                        lambda self, closure=None: None)
    r = tiny.run(TRAIN, seed=19)
    assert not r["correct"]
    assert r["checks"]["change_norm_gap"]["value"] == 1.0


@pytest.mark.parametrize("variant,number", [
    ("int4_ref", "logit_gap"), ("topk_off", "topk_gap"),
    ("int8_detok", "wav_max_err"), ("int8_detok", "vocoder_max_err")])
def test_served_control_is_not_correct(variant, number):
    """Each control of the served cells and the top-k fault, against the
    program on one seed: the number it is there to move reads above its
    limit, the program's under it, and the run is not correct.  The GPT
    is 256 wide here, so that its logits spread enough for an int4
    product or a token from outside the top-k to show (at 64 they spread
    a quarter as far as at the cell's 1024); the int4 reference is read in
    the program's run (``logit_gap_int4``)."""
    sys.path.insert(0, str(BENCH_DIR / "tools"))
    import controls
    from harness import compare

    def readings(v):
        cell = cells.load_cell("vas_gpt.serve_b8")
        tiny.shrink(cell)
        cell.config["model"]["n_embd"] = 256
        return controls.served(cell, 21, v, "cpu",
                               dict(tiny.MODEL, n_embd=256))
    p = readings("program")
    c = dict(p, logit_gap=p["logit_gap_int4"]) if variant == "int4_ref" \
        else readings(variant)
    limits = cells.load_cell("vas_gpt.serve_b8").checks["limits"]
    assert p[number] <= limits[number] < c[number]
    assert not compare.passed(compare.checks_of(c, limits))


def test_train_control_is_not_correct():
    sys.path.insert(0, str(BENCH_DIR / "tools"))
    import controls
    from harness import compare
    cell = cells.load_cell(TRAIN)
    tiny.shrink(cell)
    r = controls.trained(cell, 22, "control", "cpu", dict(tiny.MODEL))
    assert not compare.passed(compare.checks_of(r, cell.checks["limits"]))


def test_no_card_no_result():
    """The command line on a machine without a card exits non-zero and
    prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, str(BENCH_DIR / "run.py"),
                        "--workload", "vas_gpt.serve_b8", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA card" in p.stderr


def test_writes_stay_in_the_checkout_or_temp(monkeypatch, tmp_path):
    """A run opens files for writing only inside the checkout or the
    temporary directory, and nothing in /dev/shm."""
    import tempfile
    allowed = (str(ROOT), tempfile.gettempdir(), str(tmp_path))
    written = []
    real_open = builtins.open

    def spy(file, mode="r", *a, **kw):
        if any(m in mode for m in "wax+"):
            written.append(os.path.abspath(str(file)))
        return real_open(file, mode, *a, **kw)
    monkeypatch.setattr(builtins, "open", spy)
    tiny.run("vas_gpt.offline_b512", seed=23)
    assert all(w.startswith(allowed) and not w.startswith("/dev/shm")
               for w in written), written
    for var in ("TRITON_CACHE_DIR", "TORCHINDUCTOR_CACHE_DIR"):
        assert os.environ[var].startswith(str(ROOT / "build"))


@pytest.mark.card
@pytest.mark.parametrize("workload", SERVED + [TRAIN])
def test_on_the_card(card, workload):
    """The command as the check runs it, short, on the card: one JSON
    result line, ``correct``, the device's name and count."""
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        workload, "--seed", str(2 ** 31 + 5), "--seconds",
                        "5", "--trace", "1"], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert r["device"]["kind"] == torch.cuda.get_device_name(0)
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    for m, v in r["metrics"].items():
        if "roofline" in m or "mfu" in m:
            assert 0 < v["value"] <= 105, (m, v)
    assert np.isfinite([v["value"] for v in r["metrics"].values()]).all()
