"""PyTorch port, the GPT-VAE (model, optimisers, task, runner, CLI),
against the JAX package on the CPU.

The same params (through ``bridge``) and inputs (numpy, fixed seeds) go
through both packages; where JAX draws Gaussian noise from a key, the test
draws JAX's ``eps`` from the same key and hands it to the port, whose
generators never agree with JAX's PRNG.  Bounds: the JAX tests' own
(tests/test_vae.py): 1e-6 for per-element encoder outputs, log q and the
KL; 1e-6 relative for summed log p (sums of ~20 cross entropies of
magnitude ~30 carry float32 rounding of ~2e-6); rtol 1e-5 for the ELBO and
every loss; greedy tokens and active-unit counts exactly.
"""

import json
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from melspec_gpt_vqvae_tpu.configs import (DataConfig, ExperimentConfig,
                                           GPTConfig, TrainConfig, VAEConfig)
from melspec_gpt_vqvae_tpu.models import gpt_vae as JV
from melspec_gpt_vqvae_tpu.parallel import make_mesh
from melspec_gpt_vqvae_tpu.training import optim as JO
from melspec_gpt_vqvae_tpu.training import vae_task as JVT
from melspec_gpt_vqvae_tpu_torch import bridge, train_gpt_vae
from melspec_gpt_vqvae_tpu_torch.data import DataModule
from melspec_gpt_vqvae_tpu_torch.models import gpt_vae as TV
from melspec_gpt_vqvae_tpu_torch.training import callbacks, checkpoint
from melspec_gpt_vqvae_tpu_torch.training import optim as TO
from melspec_gpt_vqvae_tpu_torch.training import runner
from melspec_gpt_vqvae_tpu_torch.training import vae_task as TVT
from melspec_gpt_vqvae_tpu_torch.training.checkpoint import CheckpointManager
from melspec_gpt_vqvae_tpu_torch.training.logging import TBLogger

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _jsonl_events(monkeypatch):
    """The logger's JSON lines (as without tensorboardX, the card's
    machine), which the tests read back."""
    monkeypatch.setitem(sys.modules, "tensorboardX", None)


BASE = GPTConfig(vocab_size=11, block_size=12, n_layer=2, n_head=2,
                 n_embd=16)


def _setup(vae_kw=None, base=BASE, seed=0):
    vae = VAEConfig(nz=base.n_embd, **(vae_kw or {}))
    jc = JV.make_vae_configs(base, vae)
    tc = TV.make_vae_configs(bridge.config_from_jax(base),
                             bridge.config_from_jax(vae))
    jp = JV.init_vae_params(jax.random.PRNGKey(seed), jc)
    tp = bridge.gpt_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return jc, tc, jp, tp


def _tokens(b=3, t=12, vocab=11, seed=0):
    x = np.random.default_rng(seed).integers(0, vocab, (b, t))
    return jnp.asarray(x), torch.from_numpy(x)


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def _eps(key, shape):
    return torch.from_numpy(np.array(jax.random.normal(key, shape)))


# ------------------------------- the model ----------------------------------

def test_configs_and_init():
    jc, tc, jp, tp = _setup()
    assert tc.encoder.n_unmasked == 12 and tc.encoder.last_linear == 32
    assert tc.decoder.block_size == 13 and tc.decoder.last_linear is None
    assert tc.nz == 16 and tc.encoder.attn_pdrop == 0.0
    assert bridge.config_from_jax(jc.decoder) == tc.decoder
    mine = TV.init_vae_params(tc, torch.Generator().manual_seed(0))
    tmpl = TV.vae_param_template(tc)
    for part in ("encoder", "decoder"):
        ref, got = dict(TO.named_leaves(tp[part])), dict(
            TO.named_leaves(mine[part]))
        meta = dict(TO.named_leaves(tmpl[part]))
        assert ref.keys() == got.keys() == meta.keys()
        for n, a in ref.items():
            assert a.shape == got[n].shape == meta[n].shape, n
            assert meta[n].device.type == "meta"


@pytest.mark.parametrize("fix_var", [-1.0, 0.25])
def test_encoder_reparameterize_kl_logq(fix_var):
    jc, tc, jp, tp = _setup({"fix_var": fix_var})
    jx, tx = _tokens()
    jm, jl = JV.encoder_forward(jp, jc, jx)
    tm, tl = TV.encoder_forward(tp, tc, tx)
    np.testing.assert_allclose(_np(tm), _np(jm), atol=1e-6)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-6)
    key = jax.random.PRNGKey(5)
    jz = JV.reparameterize(key, jm, jl, 4)
    tz = TV.reparameterize(tm, tl, 4, eps=_eps(key, (3, 4, 16)))
    np.testing.assert_allclose(_np(tz), _np(jz), atol=1e-6)
    for jf, tf in ((JV.gaussian_kl, TV.gaussian_kl),
                   (JV.gaussian_kl_per_dim, TV.gaussian_kl_per_dim)):
        np.testing.assert_allclose(_np(tf(tm, tl)), _np(jf(jm, jl)),
                                   atol=1e-6)
    np.testing.assert_allclose(
        _np(TV.eval_inference_dist(tp, tc, tx, tz)),
        _np(JV.eval_inference_dist(jp, jc, jx, jz)), rtol=1e-6, atol=1e-6)
    z, kl = TV.encode(tp, tc, tx, 4, eps=_eps(key, (3, 4, 16)))
    np.testing.assert_allclose(_np(z), _np(jz), atol=1e-6)
    # drawn from a generator: N(0, 1) noise, the generator advanced
    g = torch.Generator().manual_seed(0)
    z2 = TV.reparameterize(tm, tl, 2000, g)
    e = ((z2 - tm[:, None]) / torch.exp(0.5 * tl)[:, None]).detach()
    assert abs(e.mean().item()) < 0.05 and abs(e.std().item() - 1) < 0.05


def test_decoder_log_probability_and_greedy_decode():
    jc, tc, jp, tp = _setup()
    jx, tx = _tokens()
    key = jax.random.PRNGKey(7)
    jm, jl = JV.encoder_forward(jp, jc, jx)
    eps = _eps(key, (3, 3, 16))
    jz = JV.reparameterize(key, jm, jl, 3)
    tz = TV.reparameterize(*TV.encoder_forward(tp, tc, tx), 3, eps=eps)
    np.testing.assert_allclose(
        _np(TV.decoder_logits(tp, tc, tx, tz[:, 0])),
        _np(JV.decoder_logits(jp, jc, jx, jz[:, 0])), atol=1e-5)
    rec = TV.reconstruct_error(tp, tc, tx, tz)
    assert rec.shape == (3, 3)
    np.testing.assert_allclose(_np(rec),
                               _np(JV.reconstruct_error(jp, jc, jx, jz)),
                               rtol=1e-6)
    np.testing.assert_allclose(_np(TV.log_probability(tp, tc, tx, tz)),
                               _np(JV.log_probability(jp, jc, jx, jz)),
                               rtol=1e-6)
    # greedy (and "sample", also argmax) tokens equal JAX's exactly
    for strategy in ("greedy", "sample"):
        want = np.asarray(JV.vae_decode(jp, jc, key, jz, strategy))
        got = TV.vae_decode(tp, tc, tz, strategy).numpy()
        assert got.shape == (3, 12)
        np.testing.assert_array_equal(got, want)
    beam = TV.vae_decode(tp, tc, tz, "beam", top_k=5,
                         generator=torch.Generator().manual_seed(1))
    assert beam.shape == (3, 12)
    assert 0 <= int(beam.min()) and int(beam.max()) < 11
    # reconstruct: encode, one z from eps, greedy decode
    k1, k2 = jax.random.split(key)
    want = np.asarray(JV.reconstruct(jp, jc, key, jx, "greedy"))
    got = TV.reconstruct(tp, tc, tx, "greedy", eps=_eps(k1, (3, 1, 16)))
    np.testing.assert_array_equal(got.numpy(), want)
    prior = TV.sample_from_prior(tc, 5, torch.Generator().manual_seed(0))
    assert prior.shape == (5, 16)


def _elbo_eps(key, b=3, ns=1, nz=16):
    """The eps JAX's elbo_loss draws from ``key`` (k_enc of its split)."""
    return _eps(jax.random.split(key)[0], (b, ns, nz))


@pytest.mark.parametrize("ns", [1, 2])
def test_elbo_matches_jax(ns):
    jc, tc, jp, tp = _setup()
    jx, tx = _tokens()
    key = jax.random.PRNGKey(3)
    want = JV.elbo_loss(jp, jc, key, jx, 0.5, ns)
    got = TV.elbo_loss(tp, tc, tx, 0.5, ns, eps=_elbo_eps(key, ns=ns))
    for w, g in zip(want, got):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-5)


@pytest.mark.parametrize("vae_kw", [
    {"fb": 0}, {"fb": 1, "target_kl": 2.0}, {"fb": 2, "target_kl": 8.0},
    {"fb": 3, "target_kl": 3.0}, {"beta": 0.0},
    {"beta": 0.0, "iw_train_nsamples": 4, "iw_train_ns": 2}],
    ids=["fb0", "fb1", "fb2", "fb3", "beta0", "beta0_iw"])
def test_training_loss_branches_match_jax(vae_kw):
    """Every free-bits branch and beta = 0 (plain, and the IW objective),
    loss and report, with JAX's noise handed in."""
    jc, tc, jp, tp = _setup(vae_kw)
    jx, tx = _tokens()
    key = jax.random.PRNGKey(11)
    kw = jnp.asarray(0.7)
    want, waux = JV.training_loss(jp, jc, key, jx, kw, train=True)
    if vae_kw.get("iw_train_nsamples"):
        k2 = jax.random.split(key)[1]
        keys = jax.random.split(k2, 2)
        eps = torch.stack([_eps(k, (3, 2, 16)) for k in keys])
    else:
        eps = _elbo_eps(key)
    got, aux = TV.training_loss(tp, tc, tx, torch.tensor(0.7), train=True,
                                eps=eps)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5)
    assert set(aux) == set(waux)
    for k in waux:
        np.testing.assert_allclose(_np(aux[k]), _np(waux[k]), rtol=1e-5,
                                   atol=1e-6)


def test_nll_iw_and_log_prior_match_jax():
    jc, tc, jp, tp = _setup()
    jx, tx = _tokens()
    key = jax.random.PRNGKey(2)
    want = JV.nll_iw(jp, jc, key, jx, nsamples=6, ns=2)
    eps = torch.stack([_eps(k, (3, 2, 16))
                       for k in jax.random.split(key, 3)])
    got = TV.nll_iw(tp, tc, tx, 6, 2, eps=eps)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5)
    z = np.random.default_rng(0).standard_normal((3, 4, 16)).astype(
        np.float32)
    np.testing.assert_allclose(_np(TV.log_prior(torch.from_numpy(z))),
                               _np(JV.log_prior(jnp.asarray(z))), rtol=1e-6)
    # loss_iw: the posterior once, nll_iw on the second key's chunks
    wl = JV.loss_iw(jp, jc, key, jx, 0.3, nsamples=4, ns=2)
    k2 = jax.random.split(key)[1]
    eps = torch.stack([_eps(k, (3, 2, 16)) for k in jax.random.split(k2, 2)])
    gl = TV.loss_iw(tp, tc, tx, 0.3, 4, 2, eps=eps)
    for w, g in zip(wl, gl):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-5)


def test_mi_and_active_units_match_jax():
    """MI over 700 posteriors (two chunks of 512) with JAX's eps, to 1e-4
    of its value; AU counts and variances; the corpus form over token
    batches, through the encoder."""
    rng = np.random.default_rng(0)
    mu = (rng.standard_normal((700, 16)) * 2).astype(np.float32)
    logvar = rng.uniform(-2, 0.5, (700, 16)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = float(JV.mi_from_posteriors(key, jnp.asarray(mu),
                                       jnp.asarray(logvar)))
    got = float(TV.mi_from_posteriors(torch.from_numpy(mu),
                                      torch.from_numpy(logvar),
                                      eps=_eps(key, (700, 16))))
    assert abs(got - want) < 1e-4 * max(1.0, abs(want))
    means = rng.standard_normal((50, 16)).astype(np.float32) \
        * np.linspace(0.0, 0.3, 16, dtype=np.float32)
    wau, wvar = JV.active_units_from_means(jnp.asarray(means))
    tau, tvar = TV.active_units_from_means(torch.from_numpy(means))
    assert int(tau) == int(wau)
    np.testing.assert_allclose(_np(tvar), _np(wvar), rtol=1e-5, atol=1e-7)

    jc, tc, jp, tp = _setup()
    batches = [_tokens(4, seed=s) for s in range(3)]
    wmi, wau, _ = JV.corpus_mi_and_au(jp, jc, key, [b[0] for b in batches])
    tmi, tau, _ = TV.corpus_mi_and_au(tp, tc, [b[1] for b in batches],
                                      eps=_eps(key, (12, 16)))
    assert tau == wau and abs(tmi - wmi) < 1e-4 * max(1.0, abs(wmi))
    nan, zero, _ = TV.corpus_mi_and_au(tp, tc, [batches[0][1][:1]])
    assert math.isnan(nan) and zero == 0


# ------------------------------- optimisers ---------------------------------

@pytest.mark.parametrize("name,kw", [
    ("adam", {}), ("sgd", {"momentum": 0.9}), ("sgd", {}),
    ("adafactor", {}), ("adamw", {}), ("adafactor", {"grad_clip": 2.0})],
    ids=["adam", "sgd_momentum", "sgd", "adafactor", "adamw",
         "adafactor_clip"])
def test_optimizers_match_optax(name, kw):
    """Three steps against optax on a tree whose leaves factor (two dims
    >= 128, a stacked 3-D leaf) and do not; the live lr."""
    rng = np.random.default_rng(0)
    shapes = {"blocks": {"w": (2, 130, 140), "b": (2, 140)},
              "head": {"w": (150, 129)}, "ln_f_s": (7,)}
    def tree(f):
        return jax.tree_util.tree_map(f, shapes,
                                      is_leaf=lambda s: isinstance(s, tuple))
    p0 = tree(lambda s: rng.standard_normal(s).astype(np.float32))
    grads = [tree(lambda s: rng.standard_normal(s).astype(np.float32))
             for _ in range(3)]
    tx = JO.make_optimizer(name, 1e-2, **kw)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    st = tx.init(jp)
    tp = jax.tree_util.tree_map(lambda a: torch.tensor(a).requires_grad_(
        True), p0)
    opt = TO.make_optimizer(name, tp, 1e-2, **kw)
    for g in grads:
        u, st = tx.update(jax.tree_util.tree_map(jnp.asarray, g), st, jp)
        jp = optax.apply_updates(jp, u)
        flat = dict(_flat(g))
        for n, t in TO.named_leaves(tp):
            t.grad = torch.tensor(flat[n])
        opt.step()
    want = dict(_flat(jp))
    for n, t in TO.named_leaves(tp):
        np.testing.assert_allclose(_np(t), np.asarray(want[n]), atol=1e-6,
                                   err_msg=n)
    assert TO.get_lr(opt) == pytest.approx(float(JO.get_lr(st)))
    with pytest.raises(ValueError):
        TO.make_optimizer("lamb", tp, 1e-2)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, name)
        else:
            yield name, v


# --------------------------------- the task ---------------------------------

def _exp(base=BASE, lr=1e-3, batch_size=4, epochs=1, **vae):
    return ExperimentConfig(
        model=base, vae=VAEConfig(nz=base.n_embd, **vae),
        train=TrainConfig(learning_rate=lr, epochs=epochs,
                          batch_size=batch_size),
        data=DataConfig(batch_size=batch_size))


def _codes(b=4, seed=0):
    # (B, 4, 3) grids -> 12 tokens, vocab 11
    return {"codes": np.random.default_rng(seed).integers(
        0, 11, (b, 4, 3)).astype(np.int32)}


def test_vae_task_continues_a_jax_state():
    """A JAX VAETask state after two steps (anneal warm_up 2 from kl_start
    0.1), carried across with its AdamW moments and kl_weight, then three
    steps in both with JAX's noise -- the last two past freeze_epoch 1:
    every loss and report, kl_weight bit for bit, the final params and
    moments; the frozen steps left the encoder where it was."""
    exp = _exp(warm_up=2, kl_start=0.1, freeze_epoch=1)
    jtask = JVT.VAETask(exp, 3, make_mesh({"data": 1}))
    state = jtask.init_state(0)
    batches = [_codes(seed=s) for s in range(5)]
    for s, bt in enumerate(batches[:2]):
        state, _, _ = jtask.train_step(state, bt, jax.random.PRNGKey(s))
    tree = bridge.train_state_from_jax(
        jax.tree_util.tree_map(np.asarray, state["params"]),
        state["opt_state"], state["step"], kl_weight=state["kl_weight"])
    task = TVT.VAETask(bridge.config_from_jax(exp), 3, torch.device("cpu"))
    assert task.anneal_rate == pytest.approx(jtask.anneal_rate)
    tstate = task.load_state(tree)
    assert tstate["step"] == 2 and tree["count"] == 2
    enc0 = None
    for s, (bt, epoch) in enumerate(zip(batches[2:], (0, 1, 1))):
        key = jax.random.PRNGKey(10 + s)
        state, jl, jrep = jtask.train_step(state, bt, key, epoch=epoch)
        if epoch == 1 and enc0 is None:
            enc0 = {n: t.detach().clone()
                    for n, t in TO.named_leaves(tstate["params"]["encoder"])}
        tstate, tl, trep = task.train_step(tstate, bt, torch.Generator(),
                                           epoch=epoch,
                                           eps=_elbo_eps(key, b=4))
        assert abs(tl.item() - float(jl)) < 1e-5 * max(1.0, abs(float(jl)))
        for k in jrep:
            np.testing.assert_allclose(_np(trep[k]), _np(jrep[k]), rtol=1e-5)
        assert tstate["kl_weight"].item() == float(state["kl_weight"])
    for n, t in TO.named_leaves(tstate["params"]["encoder"]):
        assert torch.equal(t.detach(), enc0[n]), n
    out = task.state_tree(tstate)
    adam = state["opt_state"].inner_state[0]
    # Adam turns a gradient that is zero up to rounding (the key half of
    # the qkv bias: softmax ignores it) into a step of +-lr whose sign is
    # the rounding's: such elements (second moment below 1e-14) may part
    noise = {n: np.asarray(v) < 1e-14 for n, v in _flat(adam.nu)}
    for part, jtree in (("params", state["params"]), ("mu", adam.mu),
                        ("nu", adam.nu)):
        want = dict(_flat(jtree))
        for n, t in TO.named_leaves(out[part]):
            ref = np.asarray(want[n])
            # the VAE's loss sums over the tokens, so its gradients and
            # moments are ~20x the class GPT's: moments held to 1e-5 of
            # each leaf's largest
            ok = np.abs(_np(t) - ref) <= (
                1e-6 if part == "params" else 1e-5 * np.abs(ref).max())
            assert (ok | noise[n]).all(), f"{part} {n}"
    assert sum(int(v.sum()) for v in noise.values()) < 100
    assert out["count"] == 5 and out["step"] == 5


def test_eval_step_and_metrics_from_sums_match_jax():
    exp = _exp(kl_start=0.3)
    jtask = JVT.VAETask(exp, 3, make_mesh({"data": 1}))
    jstate = jtask.init_state(0)
    task = TVT.VAETask(bridge.config_from_jax(exp), 3, torch.device("cpu"))
    tstate = task.load_state(bridge.train_state_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate["params"]),
        jstate["opt_state"], jstate["step"], kl_weight=jstate["kl_weight"]))
    outs_j, outs_t = [], []
    for s in range(2):
        key = jax.random.PRNGKey(s)
        outs_j.append(jtask.eval_step(jstate, _codes(seed=s), key))
        outs_t.append(task.eval_step(tstate, _codes(seed=s),
                                     eps=_elbo_eps(key, b=4)))
    for a, b in zip(outs_t, outs_j):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k] == pytest.approx(b[k], rel=1e-5)
    sums = {"loss": 30.0, "loss_rc": 28.0, "loss_kl": 2.5, "num_words": 88,
            "num_sents": 8}
    assert TVT.VAETask.metrics_from_sums(sums) == pytest.approx(
        JVT.VAETask.metrics_from_sums(sums))
    assert TVT.VAETask.aggregate_epoch(outs_t) == pytest.approx(
        JVT.VAETask.aggregate_epoch(outs_j), rel=1e-5)


def test_state_tree_roundtrip_other_optimizers():
    """adafactor / sgd states cross ``state_tree`` / ``load_state`` exactly
    (their per-leaf state dicts), as AdamW's moments do."""
    for opt in ("adafactor", "sgd", "adamw"):
        exp = _exp()
        exp.train = TrainConfig(learning_rate=1e-3, batch_size=4,
                                optimizer=opt, momentum=0.9)
        task = TVT.VAETask(bridge.config_from_jax(exp), 3,
                           torch.device("cpu"))
        state = task.init_state(0)
        task.train_step(state, _codes(), torch.Generator().manual_seed(0))
        tree = task.state_tree(state)
        again = task.state_tree(task.load_state(tree))
        assert _trees_equal(again, tree), opt
        assert ("mu" in tree) == (opt == "adamw")


def _trees_equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_trees_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


def test_merge_subtree_and_load_tree(tmp_path):
    task = TVT.VAETask(bridge.config_from_jax(_exp()), 3, torch.device("cpu"))
    a, b = task.state_tree(task.init_state(0)), task.state_tree(
        task.init_state(1))
    merged = checkpoint.merge_subtree(a["params"], b["params"], "encoder")
    assert merged["encoder"] is b["params"]["encoder"]
    assert merged["decoder"] is a["params"]["decoder"]
    with pytest.raises(KeyError):
        checkpoint.merge_subtree(a["params"], {"decoder": 1}, "encoder")
    ckpt = CheckpointManager(str(tmp_path / "version_0"))
    ckpt.save({"state": b, "epoch": 0}, 1)
    ckpt.wait()
    for path in (tmp_path / "version_0", tmp_path / "version_0" / "last.pt"):
        assert _trees_equal(checkpoint.load_tree(str(path))["state"], b)


# ------------------------------ the loop and CLI ----------------------------

@pytest.fixture(scope="module")
def vas_tree(tmp_path_factory):
    """8 clips a class of two classes: 12 train and 4 valid lines; codes
    (4, 5) grids of vocab 16 (20 tokens)."""
    root = tmp_path_factory.mktemp("port_vae_vas")
    rng = np.random.default_rng(0)
    lines = []
    for cls in ["baby", "dog"]:
        mel_dir = root / "features" / cls / "melspec_10s_22050hz"
        codes_dir = root / "features" / cls / "codes_10s"
        mel_dir.mkdir(parents=True)
        codes_dir.mkdir(parents=True)
        for i in range(8):
            vid = f"video_{i:05d}"
            np.save(mel_dir / f"{vid}_mel.npy",
                    rng.uniform(0, 1, (80, 860)).astype(np.float32))
            np.save(codes_dir / f"{vid}_mel_code.npy",
                    rng.integers(0, 16, (4, 5)).astype(np.int64))
            lines.append(f"{cls}/{vid}")
    data = root / "data"
    data.mkdir()
    (data / "vas_train.txt").write_text("\n".join(lines[:12]) + "\n")
    (data / "vas_valid.txt").write_text("\n".join(lines[12:]) + "\n")
    return root


TREE_BASE = GPTConfig(vocab_size=16, block_size=20, n_layer=1, n_head=2,
                      n_embd=16, embd_pdrop=0.1, resid_pdrop=0.1,
                      attn_pdrop=0.1, use_flash_train=True, remat=True,
                      remat_policy="attn", mixed_precision=True)


def _dm(vas_tree):
    dm = DataModule(batch_size=4, spec_dir_path=str(
        vas_tree / "features" / "*" / "melspec_10s_22050hz"),
        data_root=str(vas_tree / "data"), num_workers=1)
    dm.setup()
    return dm


def _fit(vas_tree, d, exp, **kw):
    task = TVT.VAETask(bridge.config_from_jax(exp), 3, torch.device("cpu"))
    log = TBLogger(str(d / "logs"))
    dm = _dm(vas_tree)
    state = runner.fit_vae(task, dm, epochs=exp.train.epochs, log=log,
                           ckpt=CheckpointManager(str(d / "ckpt")), seed=3,
                           epoch_end_cb=callbacks.metrics_epoch_end(task, dm,
                                                                    log),
                           **kw)
    log.close()
    return task, state


def test_fit_vae_midepoch_resume_is_exact(vas_tree, tmp_path):
    """Dropout on, kernel F's plain path, mixed precision and remat: a run
    stopped by max_steps mid-epoch and resumed from `last` ends with the
    uninterrupted run's state bit for bit, kl_weight and extras included;
    the epoch-end callback logs MI and AU."""
    exp = _exp(TREE_BASE, epochs=2, warm_up=1, kl_start=0.2)
    full_task, full = _fit(vas_tree, tmp_path / "full", exp, ckpt_every=-1)
    _, cut = _fit(vas_tree, tmp_path / "cut", exp, ckpt_every=0,
                  max_steps=4)
    assert cut["step"] == 4
    meta = json.loads((tmp_path / "cut" / "ckpt" / "meta.json").read_text())
    assert meta["last_batch_idx"] == 0
    task, resumed = _fit(vas_tree, tmp_path / "cut", exp, ckpt_every=0,
                         resume="last")
    assert resumed["step"] == full["step"] == 6
    assert _trees_equal(task.state_tree(resumed), full_task.state_tree(full))
    assert full["kl_weight"].item() == 1.0
    saved = CheckpointManager(str(tmp_path / "cut" / "ckpt")).restore("last")
    assert set(saved["extras"]) == {"best_loss", "pre_mi", "not_improved"}
    assert np.isfinite(saved["extras"]["pre_mi"])
    events = [json.loads(x) for x in (tmp_path / "full" / "logs" /
              "TensorBoardLoggs" / "version_0" / "events.jsonl")
              .read_text().splitlines()]
    tags = {e["tag"] for e in events}
    assert {"metrics/mutual_info", "metrics/active_units", "val/nll",
            "val/ppl", "train/kl_weight"} <= tags


def test_fit_vae_plateau_decay(vas_tree, tmp_path):
    """lr_decay 0.5 after one stale epoch from epoch 0: with a min_delta no
    epoch can beat, the live lr halves each epoch and not_improved resets;
    a checkpoint carries the decayed lr."""
    exp = _exp(TREE_BASE.replace(remat=False), epochs=2)
    exp.train = TrainConfig(learning_rate=1e-3, epochs=2, batch_size=4,
                            lr_decay=0.5, lr_decay_patience=1,
                            lr_decay_start=0, lr_decay_min_delta=1e6)
    task, state = _fit(vas_tree, tmp_path, exp, limit_train_batches=1,
                       ckpt_every=1)
    assert TO.get_lr(state["optimizer"]) == pytest.approx(2.5e-4)
    saved = CheckpointManager(str(tmp_path / "ckpt")).restore("last")
    assert saved["state"]["lr"] == pytest.approx(2.5e-4)
    assert saved["extras"]["not_improved"] == 0
    assert saved["extras"]["best_loss"] == 1e4


def test_evaluate_vae_mi_au_and_iw(vas_tree, tmp_path):
    """evaluate_vae over the valid split with MI / AU and IW-NLL: finite,
    PPL = exp(NLL x sentences / words), IW-PPL likewise; the same numbers
    from the same restored checkpoint twice."""
    exp = _exp(TREE_BASE, epochs=1)
    task, state = _fit(vas_tree, tmp_path, exp, ckpt_every=0)
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    agg = runner.evaluate_vae(task, _dm(vas_tree), ckpt=ckpt, resume="last",
                              compute_mi_au=True, iw_nsamples=4)
    assert {"loss", "nll", "kl", "rec", "ppl", "mutual_info",
            "active_units", "iw_nll", "iw_ppl"} == set(agg)
    assert all(np.isfinite(v) for v in agg.values())
    words = 4 * 19
    assert agg["ppl"] == pytest.approx(math.exp(agg["nll"] * 4 / words))
    assert agg["iw_ppl"] == pytest.approx(math.exp(agg["iw_nll"] * 4 / words))
    again = runner.evaluate_vae(task, _dm(vas_tree), ckpt=ckpt,
                                resume="last", compute_mi_au=True,
                                iw_nsamples=4)
    assert again == agg


def _cli_argv(vas_tree, *extra):
    spec = vas_tree / "features" / "*" / "melspec_10s_22050hz"
    override = ("n_layer=1,n_embd=16,n_head=2,block_size=20,vocab_size=16,"
                "batch_size=4,learning_rate=1e-3,use_flash_train=True,"
                f"spec_dir_path={spec}")
    return ["--dataset", "vas", "--experiment", "tiny", "--device", "cpu",
            "--data_root", str(vas_tree / "data"), "--override", override,
            "--limit_val_batches", "1", "--warm_up", "1", "--kl_start",
            "0.5", *extra]


def test_train_gpt_vae_cli_on_cpu(vas_tree, tmp_path, monkeypatch):
    """train_gpt_vae.main: trains (the preset's mixed precision and remat
    attn, F's plain path), writes the checkpoints and scalars and the
    token text of the media callback; evaluates and tests from `last`
    (MI, AU, IW); reconstructs greedily to a file, dumps the latents, logs
    an interpolation; a stage-2 run takes its encoder from that run."""
    monkeypatch.chdir(tmp_path)
    argv = _cli_argv(vas_tree, "--train", "1", "--epochs_override", "2",
                     "--limit_train_batches", "2", "--logging_frequency", "1")
    task, state, ckpt, _ = train_gpt_vae.main(train_gpt_vae.init_config(argv))
    cfg = task.cfgs.encoder
    assert state["step"] == 4 and cfg.mixed_precision and cfg.remat
    assert state["kl_weight"].item() == 1.0
    run = tmp_path / "lightning_logs" / "tiny-vas"
    meta = json.loads((run / "checkpoints" / "version_0" / "meta.json")
                      .read_text())
    assert meta["last_step"] == 4
    events = (run / "TensorBoardLoggs" / "version_0" / "events.jsonl") \
        .read_text()
    for tag in ("train/greedy_reconstruction", "train/beam_reconstruction",
                "train/interpolation_4", "metrics/mutual_info"):
        assert tag in events
    assert _trees_equal(ckpt.restore("last")["state"],
                        task.state_tree(state))

    _, none, _, metrics = train_gpt_vae.main(train_gpt_vae.init_config(
        _cli_argv(vas_tree, "--eval", "1", "--test", "1", "--iw_nsamples",
                  "4", "--resume", "last", "--reconstruct_from", "last",
                  "--reconstruct_to", "rec.txt", "--save_latent", "1",
                  "--test_interpolation", "1")))
    assert none is None
    assert "mutual_info" in metrics["eval"] and "iw_nll" in metrics["test"]
    rows = (tmp_path / "rec.txt").read_text().splitlines()
    assert len(rows) == 4 and all(len(r.split()) == 20 for r in rows)
    latents = (run / "latent.txt").read_text().splitlines()
    assert len(latents) == 4 and len(latents[0].split("\t")[1].split()) == 16

    # stage 2 at lr 0: the run's state is the warm start, its encoder the
    # first run's bit for bit, its decoder a fresh one
    first = run / "checkpoints" / "version_0" / "last.pt"
    _, s2, _, _ = train_gpt_vae.main(train_gpt_vae.init_config(_cli_argv(
        vas_tree, "--train", "1", "--epochs_override", "1", "--lr", "0",
        "--limit_train_batches", "1", "--logging_frequency", "0",
        "--load_path", str(first))))
    src = checkpoint.load_tree(str(first))["state"]["params"]
    assert s2["step"] == 1
    for part, same in (("encoder", True), ("decoder", False)):
        for n, t in TO.named_leaves(s2["params"][part]):
            if n.endswith("/w") or n == "tok_emb":
                ref = dict(TO.named_leaves(src[part]))[n]
                assert torch.equal(t.detach(), ref) is same, (part, n)


@pytest.mark.parametrize("flags,error,match", [
    (["--model", "lstm"], ValueError, "n_layer"),
    (["--mesh", "data=2"], ValueError, "world size is 1"),
    (["--mesh", "pipe=2", "--pp_micro", "2"], ValueError, "world size is 1"),
    (["--reconstruct_spec", "vq.ckpt"], FileNotFoundError, "vq.ckpt"),
    (["--vocoder", "melgan"], ValueError, "best_netG.pt")],
    ids=["lstm", "mesh", "pp_micro", "reconstruct_spec", "vocoder"])
def test_train_gpt_vae_cli_refuses(vas_tree, tmp_path, monkeypatch, flags,
                                   error, match):
    """What the CLI cannot run raises before the run directory is made: a
    --mesh (with or without --pp_micro) that does not span the world's
    ranks (a single process here: the flags parse, the mesh is refused),
    a decoder that does not load, and --model lstm with the GPT's
    overrides (the LSTM preset has no n_layer)."""
    monkeypatch.chdir(tmp_path)
    args = train_gpt_vae.init_config(
        _cli_argv(vas_tree, "--train", "1", *flags))
    if "--pp_micro" in flags:
        assert args.mesh == "pipe=2" and args.pp_micro == 2
    with pytest.raises(error, match=match):
        train_gpt_vae.main(args)
    assert not (tmp_path / "lightning_logs").exists()
