"""The prior cell (``vggsound_gpt_vae_xl.prior_b256``) at a narrow
geometry on the CPU: its traffic is the seed's, a sound run is
``correct``, each planted fault and control is not (a perturbed token,
latents other than the mix's returned or decoded, a prior of the wrong
variance, the top-k filter off, the int4 reference, the int8 detok), a
program without the prior path is refused at the start of set-up, a run
loads nothing of JAX or the JAX package, and without a card there is no
result.

The decoder is 320 wide here (5 heads of 64, an odd count as the cell's
23): at that width its random logits spread about as far as the cell's
limits reach (a 0.02 normal head over a unit-variance row: 0.36 at 320,
0.77 at the cell's 1472), so that a fault shows."""

import os
import subprocess
import sys

import pytest
import torch

import tiny
from harness import cell as cells
from harness import compare
from harness.cell import BENCH_DIR, ROOT

torch.set_num_threads(4)
CELL = "vggsound_gpt_vae_xl.prior_b256"
MODEL = {"n_layer": 2, "n_head": 5, "n_embd": 320}
TRAFFIC = {"batch": 4, "chunk": 2, "greedy_every": 2, "keep_rows": 2,
           "check_rows": 3}


def shrink(cell) -> None:
    """Narrow the prior cell's configuration and traffic in place (the
    detok as tiny.py narrows the class cells')."""
    cell.config["model"].update(MODEL)
    cell.config["vqvae"].update(tiny.VQVAE)
    cell.config["vocoder"].update(tiny.VOCODER)
    cell.config["vae"]["nz"] = MODEL["n_embd"]
    cell.traffic.update(TRAFFIC)


def run(seed, hooks=(), trace=0):
    import run as bench_run
    return bench_run.execute(tiny.args(CELL, seed=seed, trace=trace),
                             device="cpu", overrides=dict(MODEL),
                             shrink=shrink, hooks=hooks)


def _generator_of(seed):
    cell = cells.load_cell(CELL)
    shrink(cell)
    return cells.generator(cell.kind)(cell, seed, "cpu", dict(MODEL))


def test_prior_traffic_is_the_seeds():
    def draws(seed):
        d = _generator_of(seed)
        return [(g, gen.initial_seed()) for g, gen in
                (d.batch(i) for i in range(6))]
    big = 2 ** 33 + 7
    assert draws(big) == draws(big) != draws(big + 1)
    assert [g for g, _ in draws(1)] == [True, False] * 3


def test_a_sound_prior_run_is_correct_and_loads_no_jax():
    r = run(2 ** 33 + 11)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"clips_per_s", "setup_s"}
    assert set(r["checks"]) == {"logit_gap", "topk_gap", "wav_max_err",
                                "vocoder_max_err", "latent_max_err"}
    assert r["checks"]["latent_max_err"]["value"] == 0.0
    assert cells.forbidden_loaded() == []


def test_a_traced_prior_run_reports_what_the_cpu_can_read():
    r = run(3, trace=1)
    per_layer = {m["name"] for m in cells.load_cell(CELL).per_layer}
    assert len(per_layer) == 10 and all(n.endswith(".prior")
                                        for n in per_layer)
    assert {"decode_step_ms.prior", "gen_mfu.prior",
            "detok_ms_per_clip.prior"} <= set(r["metrics"]) <= per_layer
    assert r["correct"] and r["device"]["window_s"] > 0


def _perturb_tokens(toks):
    """Every tenth token of every row moved half the vocabulary away."""
    toks = toks.clone()
    toks[:, ::10] = (toks[:, ::10] + 512) % 1024
    return toks


def _other_latents(z):
    """Latents the program did not decode from: an independent draw."""
    return torch.randn(z.shape, generator=torch.Generator().manual_seed(1))


def _prompt_fault(monkeypatch, fault):
    """The pipeline's latent prompt replaced by ``fault(cond, z)`` ->
    (the conditioning it decodes from, the latents it returns)."""
    from melspec_gpt_vqvae_tpu_torch.pipeline import GenerationPipeline
    real = GenerationPipeline._prompt

    def prompt(self, classes, generator):
        return fault(*real(self, classes, generator))
    monkeypatch.setattr(GenerationPipeline, "_prompt", prompt)


@pytest.mark.parametrize("stage,fault,number", [
    # tokens the program did not sample
    ("tokens", _perturb_tokens, "logit_gap"),
    # latents handed back that are not the mix's
    ("latents", _other_latents, "latent_max_err"),
    # a prior of the wrong variance, decoded and returned alike
    ("prompt", lambda cond, z: (0.5 * cond, 0.5 * z), "latent_max_err"),
    # the mix's latents returned, others decoded
    ("prompt", lambda cond, z: (_other_latents(z)[:, None, :], z),
     "logit_gap")])
def test_a_planted_fault_is_not_correct(stage, fault, number, monkeypatch):
    if stage == "prompt":
        _prompt_fault(monkeypatch, fault)
        hooks = []
    else:
        hooks = [(stage, fault)]
    r = run(17, hooks=hooks)
    assert not r["correct"]
    c = r["checks"][number]
    assert c["value"] > c["limit"]


_PROGRAM = {}


def _control_readings(variant):
    """A control's readings at the narrow geometry, seed 21 (the
    program's read once)."""
    sys.path.insert(0, str(BENCH_DIR / "tools"))
    import prior_controls
    if variant not in _PROGRAM:
        cell = cells.load_cell(CELL)
        shrink(cell)
        _PROGRAM[variant] = prior_controls.readings(cell, 21, variant,
                                                    "cpu", dict(MODEL))
    return _PROGRAM[variant]


@pytest.mark.parametrize("variant,number", [
    ("int4_ref", "logit_gap"), ("topk_off", "topk_gap"),
    ("int8_detok", "wav_max_err"), ("int8_detok", "vocoder_max_err")])
def test_topk_off_is_not_correct(variant, number):
    """Each control of the prior cell and the top-k fault, against the
    program on one seed, through the cell's own comparison: the number it
    is there to move reads above its limit, the program's under it, and
    the run is not correct.  The int4 reference (teacher-forced int4
    products and K/V) is read in the program's run
    (``logit_gap_int4``); sampling over all 1024 codes is the fault
    ``topk_gap`` catches; the int8 decode stage is the detok's control."""
    p = _control_readings("program")
    c = dict(p, logit_gap=p["logit_gap_int4"]) if variant == "int4_ref" \
        else _control_readings(variant)
    limits = cells.load_cell(CELL).checks["limits"]
    assert p[number] <= limits[number] < c[number]
    assert not compare.passed(compare.checks_of(c, limits))


def test_a_program_without_the_prior_path_is_refused(monkeypatch):
    """A program whose pipeline knows no latent prompt fails at once,
    before it builds anything."""
    from melspec_gpt_vqvae_tpu_torch.pipeline import GenerationPipeline
    monkeypatch.delattr(GenerationPipeline, "_prompt")
    d = _generator_of(5)
    with pytest.raises(SystemExit, match="latent"):
        d.setup()
    assert not hasattr(d, "pipe")


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, str(BENCH_DIR / "run.py"),
                        "--workload", CELL, "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA card" in p.stderr
