"""The port's train steps against the JAX package at the presets' widths.

tests/test_torch_port_vqgan.py holds the VQ-GAN task at the training
tests' ``TINY`` geometry (ch 8: a GroupNorm of one channel a group, no
attention, 2 levels, a 2-layer ndf-8 discriminator), and the class GPT's
step is held elsewhere at ``n_embd`` 32.  Here the structure the reference
trains goes through one step of each package on the same state:

* the ``VQVAEConfig`` preset as it stands -- ch 128, ch_mult (1, 1, 2, 2,
  4), 2 res blocks, attention at 53 of resolution 848 (it fires by config,
  whatever the input), z 256, GroupNorm(32) of 4 and more channels a
  group, the NLayerDiscriminator at ndf 64 with 3 layers -- with
  ``disc_start`` 0 so the adversarial phase is live.  Only the input's
  time axis is cut: one mel of 80 x 64.  JAX's initial state crosses by
  ``bridge``; the generator phase (the adaptive weight from the two
  gradient norms at the decoder's last conv) runs in each package from
  it, the discriminator phase from JAX's state after its generator phase
  (so that each phase sees the same input), then the eval forward on
  JAX's state after both.  Bounds as tests/test_torch_port_vqgan.py's:
  every log key rtol 1e-5 (``d_weight`` 1e-4), the two gradient norms
  rtol 1e-5, parameters and BatchNorm statistics atol 1e-5, the eval
  recon atol 1e-5.  These are first Adam steps, which move every element
  by lr x the sign of its gradient: an element whose gradient is zero up
  to float32 rounding moves by +-lr in the directions of each package's
  rounding.  So the gradients themselves (2 x Adam's first moment) are
  held, every element within 1e-6 + 1e-4 x its leaf's largest (measured:
  under 3e-5 of it; the attention's key biases, zero in exact
  arithmetic, under 2e-7), and the elements inside that bound are left
  out of the parameter bound; they must be under 1% of a net's.
* the class GPT at the VAS preset's widths (1024 wide, 16 heads, block
  266, vocab 128, the class embedding), cut to 2 layers, dropout off, at
  the learning rate scripts/quality_fullscale.py trains with (1e-4) and
  the preset's AdamW: three ``train_step`` calls from JAX's state after
  one step of its own, so that no element takes a first, sign-only Adam
  step in the comparison (the loss of each within 1e-5 of JAX's; the
  state after the third through ``_assert_after_step``), then
  ``eval_step`` (1e-5).  The batch
  is 2 clips (a count, not a width).

Wall time on an 8-core CPU host, one worker: ~100 s (the VQ-GAN fixture,
JAX's compile of its grad-of-grad generator step most of it, ~55 s).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from melspec_gpt_vqvae_tpu.configs import VQVAEConfig, load_preset
from melspec_gpt_vqvae_tpu.models.vqvae import NLayerDiscriminator, VQModel
from melspec_gpt_vqvae_tpu.parallel.mesh import make_mesh as jax_mesh
from melspec_gpt_vqvae_tpu.training.gpt_task import GPTTask as JGPTTask
from melspec_gpt_vqvae_tpu.training.vqvae_task import VQVAETask as JVQTask
from melspec_gpt_vqvae_tpu_torch import bridge
from melspec_gpt_vqvae_tpu_torch.training.gpt_task import GPTTask
from melspec_gpt_vqvae_tpu_torch.training.vqvae_task import VQVAETask

from test_torch_port_parallel import _assert_after_step

torch.set_num_threads(1)

VQ = VQVAEConfig(disc_start=0)
X_SHAPE = (1, 80, 64, 1)
GPT_LR = 1e-4            # scripts/quality_fullscale.py's LR
GPT_BATCH, GPT_STEPS = 2, 3


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, name))
        else:
            out[name] = np.asarray(v)
    return out


# ------------------------------ the VQ-GAN preset ----------------------------

def _jax_last_conv_norms(state, x):
    """The two gradient norms ``d_weight`` divides, at the decoder's last
    conv kernel, on ``state`` (the JAX task's generator phase)."""
    model = VQModel(VQ)
    disc = NLayerDiscriminator(ndf=VQ.disc_ndf, n_layers=VQ.disc_num_layers)
    params = state["ae_params"]

    def recon(kernel):
        p = jax.tree_util.tree_map(lambda v: v, params)
        p["decoder"]["conv_out"]["kernel"] = kernel
        return model.apply({"params": p}, x)[1]

    def rec(kernel):
        return jnp.mean(jnp.abs(x - recon(kernel)))

    def g(kernel):
        logits, _ = disc.apply({"params": state["disc_params"],
                                "batch_stats": state["disc_stats"]},
                               recon(kernel), train=True,
                               mutable=["batch_stats"])
        return -jnp.mean(logits)

    kernel = params["decoder"]["conv_out"]["kernel"]
    norms = jax.jit(lambda k: (jnp.linalg.norm(jax.grad(rec)(k)),
                               jnp.linalg.norm(jax.grad(g)(k))))(kernel)
    return tuple(float(n) for n in norms)


@pytest.fixture(scope="module")
def vq_run():
    """JAX's initial state and its two gradient norms, then its state after
    the generator phase (``_generator_step``) and after the discriminator
    phase, each phase's logs, and the eval forward on the final state."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, X_SHAPE).astype(np.float32)
    x_eval = rng.uniform(-1, 1, X_SHAPE).astype(np.float32)
    task = JVQTask(VQ)
    state = task.init_state(jax.random.PRNGKey(0), X_SHAPE)
    s0 = _np_tree(state)
    norms = _jax_last_conv_norms(state, jnp.asarray(x))
    state, _, gen_logs = task._generator_step(state, jnp.asarray(x))
    s_gen = _np_tree(state)
    state, _, disc_logs = task._discriminator_step(state, jnp.asarray(x))
    ev_logs, recon, _ = task.eval_step(state, jnp.asarray(x_eval))
    return {"x": x, "x_eval": x_eval, "s0": s0, "norms": norms,
            "s_gen": s_gen, "s_disc": _np_tree(state),
            "gen_logs": {k: float(v) for k, v in gen_logs.items()},
            "disc_logs": {k: float(v) for k, v in disc_logs.items()},
            "eval": (ev_logs, np.asarray(recon))}


def test_vqgan_preset_is_the_reference_structure():
    assert (VQ.ch, VQ.ch_mult, VQ.num_res_blocks, VQ.attn_resolutions,
            VQ.resolution, VQ.z_channels, VQ.disc_ndf,
            VQ.disc_num_layers) == (128, (1, 1, 2, 2, 4), 2, (53,), 848,
                                    256, 64, 3)


def _port_vq(jax_state):
    task = VQVAETask(bridge.config_from_jax(VQ), "cpu")
    return task, task.load_state(bridge.vqgan_train_state_from_jax(
        jax_state))


def _assert_logs(got, want):
    for k in want:
        np.testing.assert_allclose(
            float(got[k]), want[k],
            rtol=1e-4 if k == "train/d_weight" else 1e-5, atol=1e-6,
            err_msg=k)


def _assert_first_adam_step(task, state, want, part, opt):
    """One net after its first Adam step against JAX's: both moments of
    every element within 1e-6 + 1e-4 x its leaf's largest, and the
    parameters within 1e-5 except the elements whose gradient lies inside
    that rounding bound (the module's docstring), under 1% of the net's."""
    back = bridge.vqgan_train_state_to_numpy(task.state_tree(state))
    adam, got_opt = bridge._adam_state(want[opt]), back[opt]
    assert int(got_opt["count"]) == int(adam.count) == 1
    want_p, got_p = _flat(want[part]), _flat(back[part])
    assert want_p.keys() == got_p.keys()
    inside = total = 0
    for m in ("mu", "nu"):
        w, g = _flat(getattr(adam, m)), _flat(got_opt[m])
        for k in w:
            np.testing.assert_allclose(
                g[k], w[k], rtol=0, atol=1e-6 + 1e-4 * np.abs(w[k]).max(),
                err_msg=f"{opt} {m} {k}")
    mu_w = _flat(adam.mu)
    for k in want_p:
        noise = np.abs(mu_w[k]) <= 1e-6 + 1e-4 * np.abs(mu_w[k]).max()
        inside += int(noise.sum())
        total += noise.size
        np.testing.assert_allclose(got_p[k][~noise], want_p[k][~noise],
                                   atol=1e-5, err_msg=k)
    assert inside < 1e-2 * total, (inside, total)


def test_vqgan_last_conv_gradient_norms_match_jax(vq_run):
    """The reconstruction's and the generator loss's gradient norms at the
    decoder's last conv, the two numbers ``d_weight`` is the ratio of."""
    task, state = _port_vq(vq_run["s0"])
    model, disc = state["model"], state["disc"]
    x = task.batch_images(vq_run["x"])
    disc.requires_grad_(False)
    _, recon, _ = model(x)
    rec = torch.mean(torch.abs(x - recon))
    g = -torch.mean(disc(recon))
    last = model.decoder.conv_out.weight
    got = [float(torch.linalg.vector_norm(torch.autograd.grad(
        loss, last, retain_graph=True)[0])) for loss in (rec, g)]
    np.testing.assert_allclose(got, vq_run["norms"], rtol=1e-5)


def test_vqgan_preset_generator_phase_matches_jax(vq_run):
    """The generator phase from JAX's initial state, the adversarial term
    live: its log keys (rec_loss, g_loss, d_weight among them) and the
    autoencoder after its Adam step; the discriminator untouched."""
    task, state = _port_vq(vq_run["s0"])
    logs = task.generator_phase(state, task.batch_images(vq_run["x"]))
    assert float(logs["train/disc_factor"]) == 1.0
    _assert_logs(logs, vq_run["gen_logs"])
    _assert_first_adam_step(task, state, vq_run["s_gen"], "ae_params",
                            "opt_ae")
    assert state["step"] == 0


def test_vqgan_preset_discriminator_phase_matches_jax(vq_run):
    """The discriminator phase from JAX's state after its generator phase:
    the hinge loss and mean logits, the discriminator after its Adam step,
    its BatchNorm statistics moved by the real then the fake pass, and the
    step advanced."""
    task, state = _port_vq(vq_run["s_gen"])
    logs = task.discriminator_phase(state, task.batch_images(vq_run["x"]))
    _assert_logs(logs, vq_run["disc_logs"])
    _assert_first_adam_step(task, state, vq_run["s_disc"], "disc_params",
                            "opt_disc")
    back = bridge.vqgan_train_state_to_numpy(task.state_tree(state))
    want_s, got_s = _flat(vq_run["s_disc"]["disc_stats"]), _flat(
        back["disc_stats"])
    for k in want_s:
        np.testing.assert_allclose(got_s[k], want_s[k], atol=1e-5,
                                   err_msg=k)
    assert state["step"] == int(vq_run["s_disc"]["step"]) == 1


def test_vqgan_preset_eval_forward_matches_jax(vq_run):
    """The eval forward on the state after the iteration: the losses and
    the reconstruction."""
    task, state = _port_vq(vq_run["s_disc"])
    logs, recon, _ = task.eval_step(state, vq_run["x_eval"])
    jlogs, jrecon = vq_run["eval"]
    for k in jlogs:
        np.testing.assert_allclose(logs[k], jlogs[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(recon.numpy(), jrecon, atol=1e-5)


# ------------------------------ the class GPT at the VAS widths --------------

def _gpt_exp():
    exp = load_preset("GPT", "vas")
    model = exp.model.replace(n_layer=2, embd_pdrop=0.0, resid_pdrop=0.0,
                              attn_pdrop=0.0)
    return dataclasses.replace(
        exp, model=model,
        train=dataclasses.replace(exp.train, learning_rate=GPT_LR))


@pytest.fixture(scope="module")
def gpt_run():
    """JAX's GPTTask after one step from its initial state: the state
    crossing to the port, then each of three steps' loss, the state after
    the last, and the eval loss."""
    exp = _gpt_exp()
    m = exp.model
    assert (m.n_embd, m.n_head, m.block_size, m.vocab_size) == (
        1024, 16, 266, 128) and m.class_size
    rng = np.random.default_rng(7)
    batches = [{"codes": rng.integers(0, 128, (GPT_BATCH, 5, 53)).astype(
                    np.int32),
                "target": rng.integers(0, m.class_size, (GPT_BATCH, 1))
                .astype(np.int32)} for _ in range(GPT_STEPS + 2)]
    task = JGPTTask(exp, jax_mesh({"data": 1}))
    state = task.init_state(0)
    state, _ = task.train_step(state, batches[GPT_STEPS + 1],
                               jax.random.PRNGKey(9))
    tree = bridge.train_state_from_jax(
        jax.tree_util.tree_map(np.asarray, state["params"]),
        state["opt_state"], state["step"])
    losses = []
    for s, b in enumerate(batches[:GPT_STEPS]):
        state, loss = task.train_step(state, b, jax.random.PRNGKey(s))
        losses.append(float(loss))
    return {"exp": exp, "tree": tree, "batches": batches, "losses": losses,
            "state": state,
            "eval": float(task.eval_step(state, batches[GPT_STEPS]))}


def test_class_gpt_at_vas_widths_matches_jax(gpt_run):
    """Three AdamW steps from JAX's state (the bias correction moving the
    step size), each loss within 1e-5; the parameters after them within
    1e-6 of JAX's (``_assert_after_step``); the eval loss within 1e-5."""
    task = GPTTask(bridge.config_from_jax(gpt_run["exp"]), "cpu")
    state = task.load_state(gpt_run["tree"])
    for b, want in zip(gpt_run["batches"], gpt_run["losses"]):
        state, loss = task.train_step(state, b, torch.Generator())[:2]
        assert abs(float(loss) - want) < 1e-5, (float(loss), want)
    _assert_after_step(task.state_tree(state), gpt_run["state"])
    got = float(task.eval_step(state, gpt_run["batches"][GPT_STEPS]))
    assert abs(got - gpt_run["eval"]) < 1e-5, (got, gpt_run["eval"])
