"""PyTorch port, GPT-class training, against the JAX package on the CPU.

The same numpy inputs (fixed seeds) go through both packages.  Kernel F's
JAX form runs in Pallas interpret mode, as the JAX package's own tests run
it here; on CPU tensors the port's ``flash_attention`` takes the plain
forward and its custom backward formula (not autograd), which these tests
hold to the JAX package's bounds (tests/test_flash_attention.py: 3e-5
outputs, 5e-5 gradients; 1e-4 logits and 1e-3 gradients of a whole
model).  The kernel itself is held against the plain versions on the card
by chip_smoke.py.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from melspec_gpt_vqvae_tpu.configs import (DataConfig, ExperimentConfig,
                                           GPTConfig, TrainConfig, VAEConfig)
from melspec_gpt_vqvae_tpu.data import DataModule
from melspec_gpt_vqvae_tpu.models import gpt as JG
from melspec_gpt_vqvae_tpu.ops import flash_attention as JF
from melspec_gpt_vqvae_tpu.parallel import make_mesh
from melspec_gpt_vqvae_tpu.training import gpt_task as JT
from melspec_gpt_vqvae_tpu.training import optim as JO
from melspec_gpt_vqvae_tpu_torch import bridge
from melspec_gpt_vqvae_tpu_torch import train_gpt
from melspec_gpt_vqvae_tpu_torch.models import gpt as TG
from melspec_gpt_vqvae_tpu_torch.ops import attention as TA
from melspec_gpt_vqvae_tpu_torch.ops import flash_attention as TF
from melspec_gpt_vqvae_tpu_torch.training import gpt_task as TT
from melspec_gpt_vqvae_tpu_torch.training import optim as TO
from melspec_gpt_vqvae_tpu_torch.training import runner
from melspec_gpt_vqvae_tpu_torch.training.checkpoint import CheckpointManager
from melspec_gpt_vqvae_tpu_torch.training.logging import TBLogger

torch.set_num_threads(1)

TINY = GPTConfig(vocab_size=16, block_size=21, n_layer=2, n_head=2,
                 n_embd=16, class_size=4)


def _exp(model=TINY, lr=3e-4, batch_size=8, epochs=1):
    return ExperimentConfig(
        model=model, vae=VAEConfig(nz=model.n_embd),
        train=TrainConfig(learning_rate=lr, epochs=epochs,
                          batch_size=batch_size),
        data=DataConfig(batch_size=batch_size))


def _batch(b=8, seed=0, classes=4):
    rng = np.random.default_rng(seed)
    return {"codes": rng.integers(0, 16, (b, 4, 5)).astype(np.int32),
            "target": rng.integers(0, classes, (b,)).astype(np.int32)}


def _torch_params(jparams, requires_grad=True):
    tree = bridge.gpt_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                             jparams))
    return TT._map(tree, lambda t: t.requires_grad_(requires_grad))


def _assert_tree_close(jtree, ttree, atol, what):
    for name, t in TO.named_leaves(ttree):
        node = jtree
        for k in name.split("/"):
            node = node[k]
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(node),
                                   atol=atol, rtol=0, err_msg=f"{what} {name}")


# ------------------------------- kernel F ----------------------------------

@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("n_unmasked", [0, 11])
def test_flash_attention_matches_jax(n_unmasked, with_mask):
    """Forward (O and lse) and the custom backward against JAX's
    flash_attention and jax.grad, at an odd T."""
    rng = np.random.default_rng(20 + n_unmasked + with_mask)
    b, h, t, hd = 2, 3, 37, 16
    q, k, v, g = (rng.standard_normal((b, h, t, hd)).astype(np.float32)
                  for _ in range(4))
    keep_prob = 0.6 if with_mask else 1.0
    keep = ((rng.uniform(size=(b, h, t, t)) < keep_prob).astype(np.uint8)
            if with_mask else None)
    jmask = None if keep is None else jnp.asarray(keep, jnp.bfloat16)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    o_ref, lse_ref = JF._flash_fwd_impl(jq, jk, jv, jmask, n_unmasked,
                                        keep_prob)
    grads_ref = jax.grad(lambda q, k, v: jnp.sum(JF.flash_attention(
        q, k, v, jmask, n_unmasked, keep_prob) * g), argnums=(0, 1, 2))(
        jq, jk, jv)

    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    tkeep = None if keep is None else torch.from_numpy(keep)
    o = TF.flash_attention(tq, tk, tv, tkeep, n_unmasked, keep_prob)
    _, lse = TF.flash_attention_fwd(tq.detach(), tk.detach(), tv.detach(),
                                    tkeep, n_unmasked, keep_prob)
    (o * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_ref),
                               atol=3e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), atol=3e-5)
    for ours, ref in zip((tq.grad, tk.grad, tv.grad), grads_ref):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=5e-5)


def test_flash_attention_backward_is_the_plain_formula():
    """On CPU tensors the autograd Function's backward is
    flash_attention_ref_bwd on the saved (q, k, v, keep, lse), bool masks
    included, and no kernel launch is counted."""
    rng = np.random.default_rng(3)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((1, 2, 9, 8))
                                   .astype(np.float32)) for _ in range(4))
    keep = torch.from_numpy(rng.uniform(size=(1, 2, 9, 9)) < 0.5)
    launches = TF.flash_attention_fwd.launches, TF.flash_attention_bwd.launches
    leaves = [a.clone().requires_grad_(True) for a in (q, k, v)]
    (TF.flash_attention(*leaves, keep, 3, 0.5) * g).sum().backward()
    _, lse = TF.flash_attention_ref_fwd(q, k, v, keep, 3, 0.5)
    ref = TF.flash_attention_ref_bwd(q, k, v, keep, lse, g, 3, 0.5)
    for leaf, r in zip(leaves, ref):
        assert torch.equal(leaf.grad, r)
    assert launches == (TF.flash_attention_fwd.launches,
                        TF.flash_attention_bwd.launches)


@pytest.mark.parametrize("rate", [0.5, 0.3])
def test_dropout_mask_keep_share(rate):
    """uint8 path (keep 0.5, exact) and uint16 path (keep 0.7): the keep
    share of 2^20 draws lies within 5 sigma of 1 - rate."""
    g = torch.Generator().manual_seed(0)
    mask = TF.make_dropout_mask(g, (16, 256, 256), rate)
    assert mask.dtype == torch.uint8 and int(mask.max()) == 1
    share = mask.double().mean().item()
    sigma = (rate * (1 - rate) / mask.numel()) ** 0.5
    assert abs(share - (1 - rate)) < 5 * sigma
    assert TF.make_dropout_mask(g, (2, 2), 0.0) is None
    assert TF.make_dropout_mask(None, (2, 2), 0.5) is None


def test_attend_xla_dropout_and_attend_refuses_training():
    """attend_xla drops the probabilities with bernoulli_u8's mask and
    rescales by 1 / (1 - rate); kernel A's wrapper refuses a call that
    autograd would have to differentiate."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 2, 7, 8))
                                .astype(np.float32)) for _ in range(3))
    out = TA.attend_xla(q, k, v, 0, dropout_rate=0.25,
                        generator=torch.Generator().manual_seed(5))
    keep = TA.bernoulli_u8(torch.Generator().manual_seed(5), 0.75,
                           (2, 2, 7, 7))
    scores = (q @ k.transpose(-1, -2)) / 8 ** 0.5
    attn = torch.softmax(scores.masked_fill(
        ~torch.from_numpy(TA.window_mask(7)), TA.NEG_INF), -1)
    ref = torch.where(keep, attn / 0.75, 0.0) @ v
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-6)
    with pytest.raises(RuntimeError, match="inference-only"):
        TA.attend(q.requires_grad_(True), k, v)


# ------------------------------ model + optim -------------------------------

@pytest.mark.parametrize("use_flash", [True, False])
def test_train_forward_matches_jax(use_flash):
    """Train-mode loss and logits with dropout 0, and the gradients of
    every parameter, against JAX (kernel F in interpret mode when
    use_flash_train)."""
    cfg = TINY.replace(use_flash_train=use_flash)
    jp = JG.init_gpt_params(jax.random.PRNGKey(1), cfg)
    batch = _batch(seed=1)
    x = JT.tokens_from_batch(jnp.asarray(batch["codes"]))
    c = jnp.asarray(batch["target"])
    jl, jg = jax.value_and_grad(lambda p: JT.gpt_loss_fn(
        p, cfg, x, c, jax.random.PRNGKey(2), train=True))(jp)
    jlogits, _ = JG.gpt_apply(jp, cfg, x[:, :-1], JG.class_embed(jp, c),
                              train=True, rng=jax.random.PRNGKey(2))

    tp = _torch_params(jp)
    tx, tc = TT.tokens_from_batch(batch["codes"]), torch.from_numpy(
        batch["target"])
    g = torch.Generator().manual_seed(0)
    loss = TT.gpt_loss_fn(tp, cfg, tx, tc, generator=g, train=True)
    loss.backward()
    tlogits = TG.gpt_apply(tp, cfg, tx[:, :-1], TG.class_embed(tp, tc),
                           train=True, generator=g)
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits),
                               atol=1e-4)
    assert abs(loss.item() - float(jl)) < 1e-4
    _assert_tree_close(jg, TT._map(tp, lambda t: t.grad), 1e-3, "grad")


def test_decay_mask_and_groups_match_jax():
    jp = JG.init_gpt_params(jax.random.PRNGKey(0), TINY)
    tp = _torch_params(jp)
    jmask = JO.decay_mask(jp)
    tmask = TO.decay_mask(tp)
    flat = dict(TO.named_leaves(tmask))
    for name, value in flat.items():
        node = jmask
        for k in name.split("/"):
            node = node[k]
        assert value is bool(node), name
    assert sum(flat.values()) == 5    # four block matrices and the head
    opt = TO.gpt_adamw(tp, 1e-3)
    decayed = {id(t) for t in opt.param_groups[0]["params"]}
    assert opt.param_groups[0]["weight_decay"] == 0.01
    assert opt.param_groups[1]["weight_decay"] == 0.0
    assert {n for n, t in TO.named_leaves(tp) if id(t) in decayed} == \
        {n for n, v in flat.items() if v}


def test_train_state_from_jax_continues_like_jax():
    """A JAX GPTTask state after two AdamW steps, carried across, then three
    more steps at lr 3e-4 with dropout 0 in both: every step's loss, and
    the final params and moments, agree."""
    exp = _exp()
    jtask = JT.GPTTask(exp, make_mesh({"data": 1}), use_pallas=False)
    state = jtask.init_state(0)
    state["opt_state"] = JO.with_lr(state["opt_state"], 3e-4)
    batches = [_batch(seed=s) for s in range(5)]
    for bt in batches[:2]:
        state, _ = jtask.train_step(state, bt, jax.random.PRNGKey(0))
    tree = bridge.train_state_from_jax(
        jax.tree_util.tree_map(np.asarray, state["params"]),
        state["opt_state"], state["step"])
    assert tree["count"] == 2 and tree["step"] == 2
    assert tree["lr"] == pytest.approx(3e-4)

    task = TT.GPTTask(bridge.config_from_jax(exp), torch.device("cpu"))
    tstate = task.load_state(tree)
    for bt in batches[2:]:
        state, jl = jtask.train_step(state, bt, jax.random.PRNGKey(0))
        tstate, tl = task.train_step(tstate, bt, torch.Generator())
        assert abs(tl.item() - float(jl)) < 1e-5
    out = bridge.train_state_to_numpy(task.state_tree(tstate))
    adam = state["opt_state"].inner_state[0]
    assert out["count"] == int(adam.count) == 5 and out["step"] == 5
    _assert_tree_close(state["params"], task.state_tree(tstate)["params"],
                       1e-6, "params")
    _assert_tree_close(adam.mu, task.state_tree(tstate)["mu"], 1e-6, "mu")
    _assert_tree_close(adam.nu, task.state_tree(tstate)["nu"], 1e-8, "nu")
    assert isinstance(out["params"]["tok_emb"], np.ndarray)


# ------------------------------ checkpoints ---------------------------------

def _tiny_task():
    return TT.GPTTask(bridge.config_from_jax(_exp(TINY.replace(n_layer=1))),
                      torch.device("cpu"))


def _trained_state(task):
    state = task.init_state(0)
    task.train_step(state, _batch(), torch.Generator().manual_seed(1))
    return state


def _trees_equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_trees_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


def test_checkpoint_roundtrip_best_last_and_nan(tmp_path):
    task = _tiny_task()
    state = _trained_state(task)
    ckpt = CheckpointManager(str(tmp_path / "version_0"))
    ckpt.save({"state": task.state_tree(state), "epoch": 0}, 10, metric=1.5)
    ckpt.save({"state": task.state_tree(state), "epoch": 1}, 20,
              metric=float("nan"))
    ckpt.save({"state": task.state_tree(state), "epoch": 2}, 30, metric=2.0)
    ckpt.wait()
    meta = json.loads((tmp_path / "version_0" / "meta.json").read_text())
    assert meta == {"best_metric": 1.5, "best_step": 10, "last_step": 30,
                    "last_batch_idx": -1}
    last = ckpt.restore("last")
    assert last["epoch"] == 2 and ckpt.restored_batch_idx == -1
    assert _trees_equal(last["state"], task.state_tree(state))
    assert ckpt.restore("best")["epoch"] == 0
    assert ckpt.restore(str(tmp_path / "version_0" / "best.pt"))["epoch"] == 0
    restored = task.load_state(last["state"])
    assert _trees_equal(task.state_tree(restored), task.state_tree(state))
    # a mid-epoch save records its batch; a NaN never becomes best
    ckpt2 = CheckpointManager(str(tmp_path / "nan" / "version_0"))
    ckpt2.save({"epoch": 0}, 1, metric=float("nan"), batch_idx=4)
    ckpt2.restore("last")
    assert ckpt2.restored_batch_idx == 4
    assert ckpt2.meta["best_metric"] is None
    with pytest.raises(FileNotFoundError):
        ckpt2.restore("best")


def test_checkpoint_version_fallback_and_geometry(tmp_path):
    task = _tiny_task()
    state = _trained_state(task)
    old = CheckpointManager(str(tmp_path / "checkpoints" / "version_0"))
    old.save({"state": task.state_tree(state), "epoch": 3}, 7, metric=1.0)
    old.wait()
    fresh = CheckpointManager(str(tmp_path / "checkpoints" / "version_1"))
    assert fresh.restore("last")["epoch"] == 3
    assert fresh.restore("best")["epoch"] == 3
    other = TT.GPTTask(_exp(TINY.replace(n_layer=1, n_embd=32)),
                       torch.device("cpu"))
    template = {"state": other.state_tree(other.init_state(0)), "epoch": 0}
    with pytest.raises(ValueError, match="geometry"):
        fresh.restore("last", template=template)


def test_resume_restores_into_shapes_not_a_fresh_state(tmp_path,
                                                       monkeypatch):
    """A resume holds the checkpoint to the task's geometry through meta
    tensors: it never builds a fresh train state (``init_state``) beside
    the restored one, the restored state equals the saved one bit for
    bit, and a checkpoint of another geometry is still refused."""
    task = _tiny_task()
    state = _trained_state(task)
    saved = {k: v for k, v in task.state_tree(state).items()}
    ckpt = CheckpointManager(str(tmp_path / "checkpoints" / "version_0"))
    ckpt.save({"state": saved, "epoch": 2}, 5, metric=1.0)
    ckpt.wait()
    tmpl = task.state_template()
    leaves = [t for _, t in TO.named_leaves(tmpl["params"])]
    assert all(t.device.type == "meta" for t in leaves)
    assert [tuple(t.shape) for t in leaves] == [
        tuple(t.shape) for _, t in TO.named_leaves(state["params"])]

    def no_fresh_state(self, seed=0):
        raise AssertionError("resume built a fresh train state")
    monkeypatch.setattr(TT.GPTTask, "init_state", no_fresh_state)
    got, epoch = runner._restore(task, ckpt, "last")
    assert epoch == 2 and got["step"] == state["step"]
    for (n, a), (_, b) in zip(TO.named_leaves(got["params"]),
                              TO.named_leaves(state["params"])):
        assert torch.equal(a, b), n
    other = TT.GPTTask(_exp(TINY.replace(n_layer=1, n_embd=32)),
                       torch.device("cpu"))
    with pytest.raises(ValueError, match="geometry"):
        runner._restore(other, ckpt, "last")


def test_tblogger_writes_json_lines_without_tensorboardx(tmp_path,
                                                        monkeypatch):
    """Without tensorboardX (the card's machine) the logger writes the same
    scalars and texts as JSON lines into its version directory."""
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    TBLogger(str(tmp_path))
    log = TBLogger(str(tmp_path))
    assert log.version == 1
    log.scalar("train/loss_step", torch.tensor(2.5), 3)
    log.scalars({"val/loss": 1.25}, 4)
    log.text("note", "hello", 4)
    log.close()
    lines = (tmp_path / "TensorBoardLoggs" / "version_1" / "events.jsonl") \
        .read_text().splitlines()
    assert [json.loads(x) for x in lines] == [
        {"tag": "train/loss_step", "value": 2.5, "step": 3},
        {"tag": "val/loss", "value": 1.25, "step": 4},
        {"tag": "note", "text": "hello", "step": 4}]


# ------------------------------ the loop and CLI ----------------------------

@pytest.fixture(scope="module")
def vas_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_vas")
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


def _dm(vas_tree):
    dm = DataModule(batch_size=4, spec_dir_path=str(
        vas_tree / "features" / "*" / "melspec_10s_22050hz"),
        data_root=str(vas_tree / "data"), num_workers=1)
    dm.setup()
    return dm


def test_midepoch_resume_is_exact(vas_tree, tmp_path):
    """A run stopped by max_steps mid-epoch and resumed from `last` ends
    with the uninterrupted run's state, bit for bit (dropout on, kernel F's
    plain path)."""
    cfg = TINY.replace(n_layer=1, class_size=2, embd_pdrop=0.1,
                       resid_pdrop=0.1, attn_pdrop=0.1, use_flash_train=True)
    exp = _exp(cfg, lr=1e-3, batch_size=4, epochs=2)

    def fit(name, **kw):
        task = TT.GPTTask(bridge.config_from_jax(exp), torch.device("cpu"))
        d = tmp_path / name
        state = runner.fit_gpt(task, _dm(vas_tree), epochs=2,
                               log=TBLogger(str(d / "logs")),
                               ckpt=CheckpointManager(str(d / "ckpt")),
                               seed=3, ckpt_every=-1, **kw)
        return task.state_tree(state)

    full = fit("full")
    stopped = fit("cut", max_steps=4)           # 3 batches an epoch
    assert stopped["step"] == 4
    assert json.loads((tmp_path / "cut" / "ckpt" / "meta.json")
                      .read_text())["last_batch_idx"] == 0
    resumed = fit("cut", resume="last")
    assert resumed["step"] == full["step"] == 6
    assert _trees_equal(resumed, full)
    assert not _trees_equal(stopped["params"], full["params"])


def test_train_gpt_cli_on_cpu(vas_tree, tmp_path, monkeypatch):
    """train_gpt.main at a tiny --override: trains two epochs, writes
    last/best checkpoints and the scalars, then evaluates from `last`."""
    monkeypatch.chdir(tmp_path)
    spec = vas_tree / "features" / "*" / "melspec_10s_22050hz"
    override = ("n_layer=1,n_embd=16,n_head=2,block_size=21,vocab_size=16,"
                "batch_size=4,learning_rate=1e-3,use_flash_train=True,"
                f"spec_dir_path={spec}")
    argv = ["--dataset", "vas", "--experiment", "tiny", "--train", "1",
            "--device", "cpu", "--epochs_override", "2",
            "--limit_train_batches", "2", "--limit_val_batches", "1",
            "--data_root", str(vas_tree / "data"), "--override", override]
    task, state, ckpt = train_gpt.main(train_gpt.init_config(argv))
    assert state["step"] == 4 and task.cfg.use_flash_train
    run = tmp_path / "lightning_logs" / "tiny-vas"
    meta = json.loads((run / "checkpoints" / "version_0" / "meta.json")
                      .read_text())
    assert meta["last_step"] == 4 and meta["last_batch_idx"] == -1
    assert os.listdir(run / "TensorBoardLoggs" / "version_0")
    restored = ckpt.restore("last")
    assert _trees_equal(restored["state"], task.state_tree(state))
    out = train_gpt.main(train_gpt.init_config(
        argv[:4] + ["--eval", "1", "--resume", "last"] + argv[6:]))
    assert out[1] is None
    with pytest.raises(ValueError, match="best_netG.pt"):
        train_gpt.main(train_gpt.init_config(argv + ["--vocoder", "x"]))


@pytest.mark.parametrize("flags,passes", [
    (["--eval", "1"], 1), (["--test", "1"], 1),
    (["--eval", "1", "--test", "1"], 2), ([], 0)],
    ids=["eval", "test", "eval+test", "neither"])
def test_train_gpt_cli_validates_once_per_flag(vas_tree, tmp_path,
                                               monkeypatch, capsys, flags,
                                               passes):
    """``--eval 1`` and ``--test 1`` each run one validation pass, so both
    together run two, as GPT_train.py:157-162 does; every pass prints its
    ``val/loss`` and goes through the eval forward (kernel A's wrapper when
    ``use_flash_train`` is off)."""
    monkeypatch.chdir(tmp_path)
    calls = []
    orig = runner.validate_gpt

    def counting(*a, **kw):
        calls.append(orig(*a, **kw))
        return calls[-1]
    monkeypatch.setattr(runner, "validate_gpt", counting)
    spec = vas_tree / "features" / "*" / "melspec_10s_22050hz"
    override = ("n_layer=1,n_embd=16,n_head=2,block_size=21,vocab_size=16,"
                f"batch_size=4,use_flash_train=False,spec_dir_path={spec}")
    out = train_gpt.main(train_gpt.init_config(
        ["--dataset", "vas", "--experiment", "evals", "--train", "0",
         "--device", "cpu", "--limit_val_batches", "1",
         "--data_root", str(vas_tree / "data"), "--override", override]
        + flags))
    assert out[1] is None and len(calls) == passes
    printed = [ln for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("val/loss ")]
    assert len(printed) == passes
    assert all(np.isfinite(v) for v in calls)
    assert len(set(calls)) <= 1     # the same fresh state both times
