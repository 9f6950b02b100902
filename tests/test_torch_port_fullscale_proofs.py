"""PyTorch port, the reference-scale learning proofs
(scripts/torch_quality_fullscale.py, scripts/torch_quality_vqgan_fullscale.py)
on the CPU at a toy geometry.

The proofs train the presets on the card; here each ``main`` runs on the
CPU with its module globals cut to a few steps (16 clips of the battery,
a narrow codec) and its task class wrapped to narrow the model after the
preset's geometry assertion has read the preset itself.  The JSON each
writes is held to the keys of the TPU's record (QUALITY_FULLSCALE.json,
QUALITY_VQGAN.json).  A toy run's gates may go either way: their logic
is checked on the TPU records' own numbers.
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / f"scripts/{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def qf():
    return _load("torch_quality_fullscale")


@pytest.fixture(scope="module")
def qvf():
    return _load("torch_quality_vqgan_fullscale")


def _battery16(mod, monkeypatch):
    """Every fourth clip of the battery: 4 a class."""
    full = mod.make_tone_battery

    def battery16(mcfg):
        w, l, f = full(mcfg)
        return w[::4], l[::4], f[::4]
    monkeypatch.setattr(mod, "make_tone_battery", battery16)


def _narrow_codec(mod, monkeypatch):
    full = mod.small_codec_cfg
    monkeypatch.setattr(mod, "small_codec_cfg", lambda **kw: dataclasses
                        .replace(full(**kw), ch=8, ch_mult=(1, 1, 1, 1, 1),
                                 z_channels=8, embedding_dim=8,
                                 num_embeddings=16, disc_ndf=8))


def _run(mod):
    try:
        mod.main("cpu")
    except SystemExit as e:   # a toy run's gates may fail: the record is
        assert "gates failed" in str(e)   # written first
    return json.loads(Path(mod.OUT).read_text())


def test_fullscale_toy_run_writes_the_jax_records_keys(qf, monkeypatch,
                                                       tmp_path):
    _battery16(qf, monkeypatch)
    _narrow_codec(qf, monkeypatch)
    task = qf.GPTTask

    def narrow_task(exp, device):
        assert exp.model.n_layer == 24 and exp.train.learning_rate == 1e-4
        return task(dataclasses.replace(exp, model=exp.model.replace(
            n_layer=1, n_head=2, n_embd=16)), device)
    for name, value in (("GPTTask", narrow_task), ("VQ_STEPS", 2),
                        ("STEPS", 4), ("EVAL_EVERY", 2),
                        ("OUT", str(tmp_path / "QF.json"))):
        monkeypatch.setattr(qf, name, value)
    deterministic = torch.backends.cudnn.deterministic
    out = _run(qf)
    want = json.loads((ROOT / "QUALITY_FULLSCALE.json").read_text())
    assert set(want) <= set(out), set(want) - set(out)
    assert set(out["gates"]) == set(want["gates"])
    assert out["passed"] == all(out["gates"].values())
    assert [s for s, _ in out["val_loss_milestones"]] == [0, 2, 4]
    assert out["batch_size"] == 8 and out["lr"] == 1e-4
    assert out["steps"] == 4 and out["params_m"] < 1.0
    assert out["use_flash_train"] is False and out["dtype"] == "float32"
    assert set(out["tf32"]) == {"cuda_matmul_allow_tf32",
                                "cudnn_allow_tf32"}
    assert set(out["kernel_launches"]) == {"attention", "flash_attention_fwd",
                                           "flash_attention_bwd"}
    assert out["device"] == {"platform": "cpu"}
    assert np.isfinite(out["train_loss"]["last20_mean"])
    # the codec's grids, fingerprinted; cuDNN deterministic for the run,
    # the caller's switch restored
    assert len(out["codes_sha1"]) == 40 and out["cudnn_deterministic"]
    assert out["runs"][-1]["codes_sha1"] == out["codes_sha1"]
    assert torch.backends.cudnn.deterministic == deterministic


def test_fullscale_gates_on_the_tpu_records_numbers(qf):
    """The six gates on QUALITY_FULLSCALE.json's milestones and train-loss
    means are the record's own (all passed), and each fails alone when
    its figure is moved past the JAX script's bound."""
    rec = json.loads((ROOT / "QUALITY_FULLSCALE.json").read_text())
    vals = [v for _, v in rec["val_loss_milestones"]]
    tl = [rec["train_loss"]["first20_mean"]] * 20 \
        + [rec["train_loss"]["last20_mean"]] * 20
    assert qf.fullscale_gates(vals, tl) == rec["gates"]
    assert all(rec["gates"].values())

    def failed(v, t):
        return {k for k, ok in qf.fullscale_gates(v, t).items() if not ok}
    assert failed(vals[:-1] + [vals[-2] + 1e-3], tl) == {
        "val_final_is_best"}
    assert failed(vals[:2] + [1.2 * vals[1]] + vals[3:], tl) == {
        "val_no_regression"}
    assert "val_all_below_init" in failed([vals[0], vals[0]] + vals[2:], tl)
    assert "val_material" in failed(vals[:-1] + [0.95 * vals[0]], tl)
    assert failed(vals, tl[20:] + tl[:20]) == {"train_decreased"}
    assert failed(vals, tl[:-1] + [float("nan")]) >= {"all_finite"}


def test_vqgan_fullscale_toy_run_writes_the_jax_records_keys(qvf,
                                                             monkeypatch,
                                                             tmp_path):
    _battery16(qvf, monkeypatch)
    task = qvf.VQVAETask

    def narrow_task(cfg, device):
        assert cfg.ch == 128 and cfg.disc_start == 2
        return task(dataclasses.replace(
            cfg, ch=8, ch_mult=(1, 1, 1, 1, 1), num_res_blocks=1,
            z_channels=8, embedding_dim=8, disc_ndf=8), device)
    for name, value in (("VQVAETask", narrow_task), ("RECON_STEPS", 2),
                        ("GAN_STEPS", 5), ("BS", 2),
                        ("OUT", str(tmp_path / "QV.json"))):
        monkeypatch.setattr(qvf, name, value)
    before = torch.backends.cudnn.deterministic
    out = _run(qvf)
    assert torch.backends.cudnn.deterministic == before
    want = json.loads((ROOT / "QUALITY_VQGAN.json").read_text())
    assert set(want) <= set(out), set(want) - set(out)
    assert set(out["gates"]) == set(want["gates"])
    assert out["passed"] == all(out["gates"].values())
    assert (out["recon_steps"], out["gan_steps"], out["batch_size"]) == (
        2, 5, 2)
    assert out["cudnn_deterministic"] is True
    assert out["gates"]["disc_factor_live"]
    # kernel C's count: its plain version on the CPU counts no launch
    assert set(out["kernel_launches"]) == {"vq_nearest"}
    assert out["device"] == {"platform": "cpu"}


def test_proof_runs_join_the_record_under_runs(qvf, monkeypatch, tmp_path):
    """A run at another seed or with ``tf32`` off is appended to the
    record's ``runs`` and leaves the top-level keys the default run's; a
    second run of the same seed and switches is appended beside the first
    (no run is dropped), each stamped with its time; cuDNN's TF32 switch
    is the caller's again after the run."""
    _battery16(qvf, monkeypatch)
    task = qvf.VQVAETask
    seeds = []

    def narrow_task(cfg, device):
        t = task(dataclasses.replace(
            cfg, ch=8, ch_mult=(1, 1, 1, 1, 1), num_res_blocks=1,
            z_channels=8, embedding_dim=8, disc_ndf=8), device)
        init = t.init_state
        t.init_state = lambda seed: (seeds.append(seed), init(seed))[1]
        return t
    for name, value in (("VQVAETask", narrow_task), ("RECON_STEPS", 1),
                        ("GAN_STEPS", 5), ("BS", 2),
                        ("OUT", str(tmp_path / "QV.json"))):
        monkeypatch.setattr(qvf, name, value)
    before = torch.backends.cudnn.allow_tf32
    first = _run(qvf)
    for kw in (dict(seed=1), dict(seed=1, tf32=False), dict(seed=1)):
        try:
            qvf.main("cpu", **kw)
        except SystemExit as e:
            assert "gates failed" in str(e)
        assert torch.backends.cudnn.allow_tf32 == before
    rec = json.loads(Path(qvf.OUT).read_text())
    assert seeds == [0, 1, 1, 1]
    assert {k: v for k, v in rec.items() if k != "runs"} == {
        k: v for k, v in first.items() if k != "runs"}
    assert [(r["seed"], r["tf32"]["cudnn_allow_tf32"]) for r in
            rec["runs"]] == [(0, before), (1, before), (1, False),
                             (1, before)]
    for r in rec["runs"]:
        assert set(r["gates"]) == set(first["gates"])
        assert {"at", "eval_rec_loss", "d_weight", "minutes", "passed",
                "cudnn_deterministic"} <= set(r)


def test_vqgan_gates_on_the_tpu_records_numbers(qvf):
    """The six gates on QUALITY_VQGAN.json's figures are the record's own,
    and each fails alone when its figure is moved past the bound."""
    rec = json.loads((ROOT / "QUALITY_VQGAN.json").read_text())
    cfg = qvf.VQVAEConfig(disc_start=200)
    dw = [rec["d_weight"][k] for k in ("min", "max", "final")]
    args = dict(rec_first=rec["rec_loss"]["first"],
                rec_pre_gan=rec["rec_loss"]["pre_gan"], disc_factor_last=1.0,
                d_first=rec["disc_loss"]["first"],
                d_last5=rec["disc_loss"]["last5_mean"],
                margin_last5=rec["logit_margin_last5"], dw=dw,
                eval_pre=rec["eval_rec_loss"]["pre_gan"],
                eval_post=rec["eval_rec_loss"]["post_gan"],
                scalars=[rec["rec_loss"]["final_last5"], *dw])
    assert qvf.vqgan_gates(cfg, **args) == rec["gates"]

    def failed(**kw):
        return {k for k, ok in qvf.vqgan_gates(cfg, **{**args, **kw})
                .items() if not ok}
    assert failed(rec_pre_gan=0.6 * args["rec_first"]) == {"recon_learns"}
    assert failed(disc_factor_last=0.0) == {"disc_factor_live"}
    assert failed(margin_last5=-1.0) == {"disc_learns"}
    assert failed(d_last5=args["d_first"] + 0.1) == {"disc_learns"}
    assert failed(dw=dw + [cfg.max_adapt_weight * cfg.disc_weight]) == {
        "d_weight_in_range"}
    assert failed(eval_post=2.1 * args["eval_pre"] + 0.06) == {
        "recon_not_collapsed"}
    assert failed(scalars=[float("inf")]) == {"all_finite"}


@pytest.mark.parametrize("name", ["qf", "qvf"])
def test_fullscale_proofs_refuse_to_run_without_a_card(name, request,
                                                       monkeypatch):
    mod = request.getfixturevalue(name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        mod.main()


def test_committed_port_records_carry_the_gates_of_their_numbers(qf, qvf):
    """QUALITY_FULLSCALE_TORCH.json and QUALITY_VQGAN_TORCH.json, written
    on the card, carry the JAX record's keys and the gates of their own
    figures (the train-loss means standing for the losses), whichever
    way each came out; ``passed`` is all of them."""
    rec = json.loads((ROOT / "QUALITY_FULLSCALE_TORCH.json").read_text())
    assert set(json.loads((ROOT / "QUALITY_FULLSCALE.json").read_text())) \
        <= set(rec)
    vals = [v for _, v in rec["val_loss_milestones"]]
    tl = [rec["train_loss"]["first20_mean"]] * 20 \
        + [rec["train_loss"]["last20_mean"]] * 20
    assert qf.fullscale_gates(vals, tl) == rec["gates"]
    assert rec["passed"] == all(rec["gates"].values())
    assert (rec["steps"], rec["batch_size"], rec["lr"]) == (300, 8, 1e-4)

    rec = json.loads((ROOT / "QUALITY_VQGAN_TORCH.json").read_text())
    assert set(json.loads((ROOT / "QUALITY_VQGAN.json").read_text())) \
        <= set(rec)
    dw = [rec["d_weight"][k] for k in ("min", "max", "final")]
    gates = qvf.vqgan_gates(
        qvf.VQVAEConfig(disc_start=rec["recon_steps"]),
        rec_first=rec["rec_loss"]["first"],
        rec_pre_gan=rec["rec_loss"]["pre_gan"], disc_factor_last=1.0,
        d_first=rec["disc_loss"]["first"],
        d_last5=rec["disc_loss"]["last5_mean"],
        margin_last5=rec["logit_margin_last5"], dw=dw,
        eval_pre=rec["eval_rec_loss"]["pre_gan"],
        eval_post=rec["eval_rec_loss"]["post_gan"],
        scalars=[rec["rec_loss"]["final_last5"], *dw])
    assert gates == rec["gates"]
    assert rec["passed"] == all(rec["gates"].values())
    assert (rec["recon_steps"], rec["gan_steps"], rec["batch_size"]) == (
        200, 200, 4)
