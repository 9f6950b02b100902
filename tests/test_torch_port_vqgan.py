"""PyTorch port, the VQ-GAN first stage (the quantiser's training forward,
the discriminator, the GAN losses, ``VQVAETask``, the logger's media
methods and the ``train_vqvae`` CLI), against the JAX package on the CPU.

One module-scoped fixture runs the JAX ``VQVAETask`` at the training
tests' ``TINY`` geometry (tests/test_vqvae_training.py) once: a step from
its initial state, then three more, ``disc_start`` 1, so both phases of
those three run adversarially.  The port takes the state after the first
step through ``bridge`` and runs the same three iterations.  Bounds: 1e-6
for the quantiser's and the losses' values and gradients, indices and
counts exactly; the discriminator's logits and statistics 1e-5; every log
key rtol 1e-5 (``d_weight`` 1e-4; atol 1e-6 for values that pass near 0,
such as a mean logit of -0.002); parameters, Adam moments and
statistics atol 1e-5 -- except parameter elements whose gradient is
zero in exact arithmetic (a conv bias before a GroupNorm of one channel a
group, an attention key bias under the softmax): there Adam divides
float32 rounding noise by its own RMS, so each package moves them by up to
lr a step in its own direction.  They are told apart by JAX's Adam second
moment, whose RMS is below 1e-6 there and at least 1.5e-5 everywhere else
at this geometry, and they must all be biases.
"""

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from melspec_gpt_vqvae_tpu.configs import VQVAEConfig
from melspec_gpt_vqvae_tpu.models import vqvae as JM
from melspec_gpt_vqvae_tpu.training.vqvae_task import VQVAETask as JTask
from melspec_gpt_vqvae_tpu_torch import bridge, train_vqvae
from melspec_gpt_vqvae_tpu_torch.models import vqvae as TM
from melspec_gpt_vqvae_tpu_torch.training.logging import TBLogger
from melspec_gpt_vqvae_tpu_torch.training.vqvae_task import (TRAIN_KEYS,
                                                             VQVAETask)

torch.set_num_threads(1)

TINY = VQVAEConfig(num_embeddings=8, embedding_dim=4, ch=8,
                   ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(),
                   resolution=16, z_channels=4, disc_ndf=8,
                   disc_num_layers=2, disc_start=1, learning_rate=1e-3)


@pytest.fixture(autouse=True)
def _jsonl_events(monkeypatch):
    """The logger's JSON lines (as without tensorboardX, the card's
    machine), which the tests read back."""
    monkeypatch.setitem(sys.modules, "tensorboardX", None)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX task's state after one step and after four, the logs of
    steps 2-4, the batches, and its eval step on the final state."""
    task = JTask(TINY)
    state = task.init_state(jax.random.PRNGKey(0), (1, 16, 16, 1))
    rng = np.random.default_rng(0)
    xs = [rng.uniform(-1, 1, (2, 16, 16, 1)).astype(np.float32)
          for _ in range(5)]
    state, _ = task.train_step(state, jnp.asarray(xs[0]))
    s1 = _np_tree(state)
    logs = []
    for x in xs[1:4]:
        state, log = task.train_step(state, jnp.asarray(x))
        logs.append(log)
    s4 = _np_tree(state)
    ev_logs, recon, idx = task.eval_step(state, jnp.asarray(xs[4]))
    return {"s1": s1, "s4": s4, "logs": logs, "xs": xs,
            "eval": (ev_logs, np.asarray(recon), np.asarray(idx))}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, np.asarray(tree)


def _flat(tree):
    return dict(_leaves(tree))


# ------------------------------ the model -----------------------------------

@pytest.mark.parametrize("n_layers,update", [(2, True), (3, True), (3, False)])
def test_discriminator_matches_flax(n_layers, update):
    """Logits and the BatchNorm statistics of two chained train-mode passes
    (the discriminator phase: real, then fake) against flax with
    ``mutable``; with ``update`` off, train mode leaves the statistics as
    they were; in eval mode the running statistics normalise."""
    disc = JM.NLayerDiscriminator(ndf=8, n_layers=n_layers)
    rng = np.random.default_rng(n_layers)
    xa, xb = (rng.standard_normal((2, 24, 24, 1)).astype(np.float32)
              for _ in range(2))
    variables = disc.init(jax.random.PRNGKey(1), jnp.asarray(xa), train=True)
    params, stats = variables["params"], variables["batch_stats"]
    tdisc = TM.NLayerDiscriminator(8, n_layers)
    tdisc.load_state_dict({
        **bridge.conv_state_dict(_np_tree(params), bridge._DISC_RENAME),
        **bridge.conv_state_dict(_np_tree(stats), bridge._DISC_RENAME)},
        strict=True)
    la, s1 = disc.apply({"params": params, "batch_stats": stats},
                        jnp.asarray(xa), train=True, mutable=["batch_stats"])
    lb, s2 = disc.apply({"params": params, "batch_stats": s1["batch_stats"]},
                        jnp.asarray(xb), train=True, mutable=["batch_stats"])
    ta = tdisc(torch.from_numpy(xa), update_stats=update)
    tb = tdisc(torch.from_numpy(xb), update_stats=update)
    np.testing.assert_allclose(ta.detach().numpy(), np.asarray(la), atol=1e-5)
    if update:
        np.testing.assert_allclose(tb.detach().numpy(), np.asarray(lb),
                                   atol=1e-5)
        want = _flat(_np_tree(s2["batch_stats"]))
    else:
        want = _flat(_np_tree(stats))
    got = {k.replace(".", "/"): v.numpy()
           for k, v in tdisc.named_buffers()}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)
    if not update:
        # eval mode: flax's use_running_average on the first statistics
        lr_ = disc.apply({"params": params, "batch_stats": stats},
                         jnp.asarray(xb), train=False)
        tdisc.eval()
        np.testing.assert_allclose(
            tdisc(torch.from_numpy(xb)).detach().numpy(), np.asarray(lr_),
            atol=1e-5)


def test_gan_losses_match_jax():
    rng = np.random.default_rng(3)
    lr_, lf_ = (rng.standard_normal((2, 5, 7, 1)).astype(np.float32) * 2
                for _ in range(2))
    np.testing.assert_allclose(
        TM.hinge_d_loss(torch.from_numpy(lr_), torch.from_numpy(lf_)).item(),
        float(JM.hinge_d_loss(jnp.asarray(lr_), jnp.asarray(lf_))),
        rtol=1e-6)
    for nll, g, w, lo, hi in [(0.3, 0.02, 1.0, 0.0, 1e4),
                              (5.0, 1e-6, 0.5, 0.0, 1e3),
                              (1e-5, 3.0, 2.0, 0.1, 1e4)]:
        want = float(JM.adaptive_gan_weight(jnp.float32(nll), jnp.float32(g),
                                            w, lo, hi))
        got = TM.adaptive_gan_weight(torch.tensor(nll), torch.tensor(g), w,
                                     lo, hi).item()
        np.testing.assert_allclose(got, want, rtol=1e-6)
    idx = rng.integers(0, 11, (3, 5, 7)).astype(np.int32)
    np.testing.assert_array_equal(
        TM.codebook_usage_counts(torch.from_numpy(idx), 16).numpy(),
        np.asarray(JM.codebook_usage_counts(jnp.asarray(idx), 16)))


def test_quantizer_forward_and_gradients_match_jax():
    """Loss, straight-through output, perplexity and indices, and the
    gradients of a function of the loss and the output with respect to the
    latents and the codebook."""
    k, d = 16, 8
    vq = JM.VectorQuantizer(k, d, 0.25)
    rng = np.random.default_rng(5)
    z = rng.standard_normal((2, 3, 5, d)).astype(np.float32) * 0.1
    w = rng.standard_normal(z.shape).astype(np.float32)
    params = vq.init(jax.random.PRNGKey(2), jnp.asarray(z))["params"]
    cb = np.array(params["embedding"])

    def jf(zz, emb):
        loss, q, (perp, idx) = vq.apply({"params": {"embedding": emb}}, zz)
        return loss + jnp.sum(q * w), (loss, q, perp, idx)
    (_, (jl, jq, jp, ji)), (gz, gcb) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(jnp.asarray(z), jnp.asarray(cb))

    tvq = TM.VectorQuantizer(k, d, 0.25)
    tvq.embedding.data.copy_(torch.from_numpy(cb))
    tz = torch.from_numpy(z).requires_grad_(True)
    loss, q, (perp, idx) = tvq(tz)
    (loss + torch.sum(q * torch.from_numpy(w))).backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    np.testing.assert_allclose(q.detach().numpy(), np.asarray(jq), atol=1e-6)
    np.testing.assert_allclose(perp.item(), float(jp), rtol=1e-6)
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tz.grad.numpy(), np.asarray(gz), atol=1e-6)
    np.testing.assert_allclose(tvq.embedding.grad.numpy(), np.asarray(gcb),
                               atol=1e-6)


def test_vqmodel_forward_matches_jax(jax_run):
    """``VQModel.forward`` (NHWC in and out) on the JAX state's weights."""
    jmodel = JM.VQModel(TINY)
    params = jax_run["s1"]["ae_params"]
    x = jax_run["xs"][0]
    jl, jr, (jp, ji) = jmodel.apply({"params": params}, jnp.asarray(x))
    tmodel = bridge.load_vqvae(params, bridge.config_from_jax(TINY))
    with torch.no_grad():
        tl, tr, (tp, ti) = tmodel(torch.from_numpy(x))
        z = tmodel.encode(torch.from_numpy(x))
    assert tr.shape == x.shape and z.shape == (2, 8, 8, TINY.embedding_dim)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


# ------------------------------ the bridge and init -------------------------

def test_vqgan_state_crosses_and_returns_exactly(jax_run):
    s1 = jax_run["s1"]
    tree = bridge.vqgan_train_state_from_jax(s1)
    assert set(tree) == {"ae_params", "disc_params", "disc_stats", "opt_ae",
                         "opt_disc", "step"} and tree["step"] == 1
    assert tree["disc_params"]["Conv_1.weight"].shape == (16, 8, 4, 4)
    assert "Conv_1.bias" not in tree["disc_params"]
    assert set(tree["disc_stats"]) == {f"BatchNorm_{i}.{s}" for i in (0, 1)
                                       for s in ("mean", "var")}
    back = bridge.vqgan_train_state_to_numpy(tree)
    for part in ("ae_params", "disc_params", "disc_stats"):
        want, got = _flat(s1[part]), _flat(back[part])
        assert want.keys() == got.keys(), part
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for part in ("opt_ae", "opt_disc"):
        adam = bridge._adam_state(s1[part])
        assert int(back[part]["count"]) == int(adam.count) == 1
        for m in ("mu", "nu"):
            want, got = _flat(getattr(adam, m)), _flat(back[part][m])
            assert want.keys() == got.keys()
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the port's own task loads it and gives it back unchanged
    task = VQVAETask(bridge.config_from_jax(TINY), "cpu")
    again = task.state_tree(task.load_state(tree))
    assert _trees_equal(again, tree)


def _trees_equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_trees_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


def test_init_conv_net_bias_less_conv_and_batchnorm():
    """A conv without bias and the discriminator's BatchNorm: kernel
    N(0, 1/fan_in), no bias touched, BatchNorm scale 1, bias 0, mean 0,
    var 1."""
    disc = TM.NLayerDiscriminator(8, 3)
    with torch.no_grad():
        for p in disc.parameters():
            p.fill_(7.0)
        for b in disc.buffers():
            b.fill_(7.0)
    bridge.init_conv_net_(disc, torch.Generator().manual_seed(0))
    assert disc.Conv_1.bias is None and disc.Conv_0.bias is not None
    assert torch.all(disc.Conv_0.bias == 0)
    for i in range(3):
        bn = getattr(disc, f"BatchNorm_{i}")
        assert torch.all(bn.scale == 1) and torch.all(bn.bias == 0)
        assert torch.all(bn.mean == 0) and torch.all(bn.var == 1)
    w = disc.Conv_2.weight
    fan_in = w[0].numel()
    assert abs(w.std().item() * fan_in ** 0.5 - 1.0) < 0.05


# ------------------------------ the task ------------------------------------

def test_task_continues_a_jax_state_for_three_iterations(jax_run):
    task = VQVAETask(bridge.config_from_jax(TINY), "cpu")
    state = task.load_state(bridge.vqgan_train_state_from_jax(jax_run["s1"]))
    for x, want in zip(jax_run["xs"][1:4], jax_run["logs"]):
        state, got = task.train_step(state, x)
        assert set(got) == set(want) == set(TRAIN_KEYS)
        for k in want:
            np.testing.assert_allclose(
                got[k], want[k], rtol=1e-4 if k == "train/d_weight" else 1e-5,
                atol=1e-6, err_msg=k)
        assert got["train/disc_factor"] == 1.0 and got["train/disc_loss"] > 0
    back = bridge.vqgan_train_state_to_numpy(task.state_tree(state))
    s4 = jax_run["s4"]
    assert int(back["step"]) == int(s4["step"]) == 4
    nu = {part: _flat(bridge._adam_state(s4[opt]).nu)
          for part, opt in (("ae_params", "opt_ae"),
                            ("disc_params", "opt_disc"))}
    noisy = []
    for part in ("ae_params", "disc_params"):
        want, got = _flat(s4[part]), _flat(back[part])
        assert want.keys() == got.keys()
        for k in want:
            exact_zero_grad = np.sqrt(nu[part][k]) < 1e-6
            if exact_zero_grad.any():
                noisy.append(k)
            np.testing.assert_allclose(got[k][~exact_zero_grad],
                                       want[k][~exact_zero_grad], atol=1e-5,
                                       err_msg=k)
    assert noisy and all(k.endswith("bias") for k in noisy), noisy
    for part in ("disc_stats",):
        want, got = _flat(s4[part]), _flat(back[part])
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)
    for opt in ("opt_ae", "opt_disc"):
        adam = bridge._adam_state(s4[opt])
        assert int(back[opt]["count"]) == int(adam.count) == 4
        for m in ("mu", "nu"):
            want, got = _flat(getattr(adam, m)), _flat(back[opt][m])
            for k in want:
                np.testing.assert_allclose(got[k], want[k], atol=1e-5,
                                           err_msg=f"{opt} {m} {k}")


def test_eval_step_matches_jax(jax_run):
    task = VQVAETask(bridge.config_from_jax(TINY), "cpu")
    state = task.load_state(bridge.vqgan_train_state_from_jax(jax_run["s4"]))
    logs, recon, idx = task.eval_step(state, jax_run["xs"][4])
    jlogs, jrecon, jidx = jax_run["eval"]
    assert set(logs) == set(jlogs) == {"val/aeloss", "val/rec_loss",
                                       "val/quant_loss", "val/perplexity"}
    for k in jlogs:
        np.testing.assert_allclose(logs[k], jlogs[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(logs["val/aeloss"],
                               logs["val/rec_loss"] + logs["val/quant_loss"],
                               rtol=1e-6)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_allclose(recon.numpy(), jrecon, atol=1e-5)


def test_disc_factor_waits_for_disc_start_and_step_counts_iterations():
    """Before ``disc_start`` both adversarial terms are zeroed (d_weight is
    still computed); the step advances once an iteration; the
    discriminator's statistics move in the discriminator phase only."""
    task = VQVAETask(bridge.config_from_jax(
        dataclasses.replace(TINY, disc_start=2)), "cpu")
    state = task.init_state(0)
    x = np.random.default_rng(1).uniform(-1, 1, (2, 16, 16, 1)).astype(
        np.float32)
    means = []
    for i in range(3):
        before = state["disc"].BatchNorm_0.mean.clone()
        state, logs = task.train_step(state, x)
        means.append(not torch.equal(before, state["disc"].BatchNorm_0.mean))
        assert state["step"] == i + 1
        live = i >= 2
        assert logs["train/disc_factor"] == (1.0 if live else 0.0)
        assert (logs["train/disc_loss"] != 0.0) == live
        assert np.isfinite(logs["train/d_weight"]) and \
            logs["train/d_weight"] > 0
    assert all(means)


# ------------------------------ the logger ----------------------------------

def test_tblogger_histogram_image_spectrogram_json_lines(tmp_path):
    log = TBLogger(str(tmp_path))
    codes = np.repeat(np.arange(5), [3, 0, 2, 1, 4])
    log.histogram("val/code_hits", codes, 7)
    log.histogram("w", np.linspace(0.0, 1.0, 100), 7)
    img = np.random.default_rng(0).uniform(0, 1, (4, 6, 1)).astype(np.float32)
    log.image("images/x", img, 7)
    spec = np.linspace(-1.0, 1.0, 12, dtype=np.float32).reshape(3, 4)
    log.spectrogram("images_inputs", spec, 8)
    log.spectrogram("unit", (spec + 1) / 2, 8, input_range="unit")
    with pytest.raises(ValueError):
        log.spectrogram("bad", spec, 8, input_range="db")
    log.close()
    lines = [json.loads(line) for line in
             (tmp_path / "TensorBoardLoggs" / "version_0" / "events.jsonl")
             .read_text().splitlines()]
    hist = lines[0]["histogram"]
    assert lines[0]["tag"] == "val/code_hits" and lines[0]["step"] == 7
    assert hist["counts"] == [3, 0, 2, 1, 4]
    assert hist["edges"] == [-0.5, 0.5, 1.5, 2.5, 3.5, 4.5]
    assert sum(lines[1]["histogram"]["counts"]) == 100
    assert len(lines[1]["histogram"]["counts"]) == 64
    d = tmp_path / "TensorBoardLoggs" / "version_0"
    assert lines[2]["dataformats"] == "HWC"
    np.testing.assert_array_equal(np.load(d / lines[2]["image"]), img)
    want = ((spec + 1) / 2)[::-1, :, None]
    for rec in lines[3:5]:
        np.testing.assert_allclose(np.load(d / rec["image"]), want,
                                   atol=1e-7)


# ------------------------------ the CLI -------------------------------------

CLI_OVERRIDE = ("ch=8,ch_mult=(1,1,1,1,1),num_res_blocks=1,"
                "attn_resolutions=(),z_channels=4,embedding_dim=4,"
                "disc_ndf=8,disc_num_layers=2")


def _vas_tree(root):
    """Six clips of two classes as VQVAE_train.py reads them (the GPT_VAE
    preset's spec_dir_path under the working directory): 4 train and 2
    valid lines of (80, 860) mels."""
    rng = np.random.default_rng(0)
    lines = []
    for cls in ("baby", "dog"):
        d = root / "data" / "vas" / "features" / cls / "melspec_10s_22050hz"
        d.mkdir(parents=True)
        for i in range(3):
            np.save(d / f"video_{i:05d}_mel.npy",
                    rng.uniform(0, 1, (80, 860)).astype(np.float32))
            lines.append(f"{cls}/video_{i:05d}")
    (root / "data" / "vas_train.txt").write_text(
        "\n".join(lines[:2] + lines[3:5]) + "\n")
    (root / "data" / "vas_valid.txt").write_text(
        "\n".join([lines[2], lines[5]]) + "\n")


def _cli(*extra):
    return train_vqvae.init_config(
        ["--dataset", "vas", "--experiment", "tiny", "--device", "cpu",
         "--num_embeddings", "8", "--override", CLI_OVERRIDE,
         "--disc_start", "1", *extra])


def test_train_vqvae_cli_trains_checkpoints_and_resumes(tmp_path, monkeypatch,
                                                        capsys):
    monkeypatch.chdir(tmp_path)
    _vas_tree(tmp_path)
    task, state, ckpt, agg = train_vqvae.main(_cli("--train", "1",
                                                   "--epochs", "1"))
    assert state["step"] == 2 and task.cfg.num_embeddings == 8
    assert task.cfg.ch == 8 and task.cfg.disc_start == 1
    out = capsys.readouterr().out
    assert "epoch 0: val/aeloss" in out and "zero_hit_codes" in out
    assert set(agg) == {"val/aeloss", "val/rec_loss", "val/quant_loss",
                        "val/perplexity"}
    run = tmp_path / "lightning_logs" / "tiny-vas"
    tree = ckpt.restore("last")
    assert set(tree) == {"state", "epoch"} and tree["epoch"] == 0
    assert set(tree["state"]) == {"ae_params", "disc_params", "disc_stats",
                                  "opt_ae", "opt_disc", "step"}
    assert _trees_equal(tree["state"], task.state_tree(state))
    assert json.loads((run / "checkpoints" / "version_0" / "meta.json")
                      .read_text())["last_step"] == 2
    events = [json.loads(line) for line in
              (run / "TensorBoardLoggs" / "version_0" / "events.jsonl")
              .read_text().splitlines()]
    tags = {e["tag"] for e in events}
    assert {"train/aeloss", "train/d_weight", "learning_rate",
            "val/aeloss", "val/zero_hit_codes", "val/code_hits",
            "images_inputs", "images_reconstructions"} <= tags
    hist = next(e for e in events if e["tag"] == "val/code_hits")
    assert sum(hist["histogram"]["counts"]) == 2 * 5 * 53

    # resume: epoch 1 continues from the checkpoint's state and step
    task, state, ckpt, _ = train_vqvae.main(_cli(
        "--train", "1", "--epochs", "2", "--resume", "last"))
    assert state["step"] == 4
    assert "epoch 1: val/aeloss" in capsys.readouterr().out
    assert ckpt.restore("last")["epoch"] == 1

    # evaluation only, from that checkpoint
    _, state, _, agg = train_vqvae.main(_cli("--eval", "1", "--resume",
                                             "last"))
    assert state["step"] == 4 and np.isfinite(agg["val/aeloss"])
    assert "val/aeloss" in capsys.readouterr().out


def test_train_vqvae_cli_refuses_cuda_without_a_card(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_vqvae.main(train_vqvae.init_config(
            ["--dataset", "vas", "--experiment", "x"]))
