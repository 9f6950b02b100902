"""The plain reference against the program at a narrow geometry on the
CPU, in float32: the class GPT's logits, the VQ-VAE decoder and MelGAN,
and a GPT-VAE training step with dropout (the reference redraws the
program's masks from a generator seeded alike) and AdamW."""

import copy
import json

import pytest
import torch

from harness import program, weights
from harness.cell import BENCH_DIR
from reference import detok as ref_detok
from reference import gpt as ref_gpt
from reference import gpt_vae as ref_vae

import tiny

torch.set_num_threads(4)


def _config(name, **model):
    cfg = json.load(open(BENCH_DIR / "configs" / f"{name}.json"))
    cfg["model"].update(tiny.MODEL, **model)
    for group, ov in (("vqvae", tiny.VQVAE), ("vocoder", tiny.VOCODER)):
        if group in cfg:
            cfg[group].update(ov)
    if "vae" in cfg:
        cfg["vae"]["nz"] = cfg["model"]["n_embd"]
    return cfg


def test_class_gpt_logits_match_the_program():
    from melspec_gpt_vqvae_tpu_torch.models import gpt as G
    cfg = _config("vas_gpt")
    exp = program.experiment(dict(cfg, dtypes={"dtype": "float32"}),
                             dict(tiny.MODEL))
    params = program.gpt_weights(cfg["model"], 11, "cpu", torch.float32)
    cls = torch.tensor([0, 3, 7])
    toks = torch.randint(0, 128, (3, 20), generator=torch.Generator()
                         .manual_seed(1))
    mine = ref_gpt.class_logits(params, cfg["model"], cls, toks)
    with torch.no_grad():
        theirs = G.gpt_apply(params, exp.model, toks[:, :-1],
                             G.class_embed(params, cls))
    torch.testing.assert_close(mine, theirs, rtol=1e-5, atol=1e-5)


def test_detok_matches_the_program():
    cfg = _config("vas_gpt")
    exp = program.experiment(cfg, dict(tiny.MODEL))
    vq_w, mg_w = program.detok_weights(cfg, 12, "cpu", torch.float32)
    vq, mg = program.program_detok(exp, vq_w, mg_w, "cpu")
    rvq, rmg = program.reference_detok(cfg, vq_w, mg_w, "cpu")
    toks = torch.randint(0, 128, (2, 265), generator=torch.Generator()
                         .manual_seed(2))
    spec, wav = ref_detok.detok(rvq, rmg, toks, 5, 53)
    grid = toks.reshape(-1, 53, 5).transpose(1, 2)
    with torch.no_grad():
        pspec = vq.decode_code(grid)[..., 0]
        mel = torch.clamp((pspec + 1.0) / 2.0, 0.0, 1.0).transpose(1, 2)
        pwav = mg(mel)
    assert spec.shape == (2, 80, 848) and wav.shape == (2, 848 * 256)
    torch.testing.assert_close(spec, pspec, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(wav, pwav, rtol=1e-4, atol=1e-4)


def test_gpt_vae_step_matches_the_program():
    """One step in float32: the loss and every gradient equal the
    program's (dropout 0.3 drawn alike), and three AdamW steps move the
    parameters as torch's AdamW over the program's groups does."""
    from melspec_gpt_vqvae_tpu_torch.models import gpt_vae as V
    from melspec_gpt_vqvae_tpu_torch.training.vae_task import VAETask
    cfg = _config("vas_gpt_vae", mixed_precision=False)
    ov = dict(tiny.MODEL, mixed_precision=False)
    exp = program.experiment(cfg, ov)
    task = VAETask(exp, 100, "cpu")
    flat = program.vae_weights(cfg["model"], 13, "cpu")
    params = ref_gpt.nest({n: t.clone().requires_grad_(True)
                           for n, t in flat.items()})
    g = torch.Generator().manual_seed(5)
    x = torch.randint(0, 128, (3, 265), generator=g)
    eps = torch.randn((3, 1, 64), generator=g)
    loss, _ = V.training_loss(params, task.cfgs, x, 1.0, train=True,
                              generator=weights.generator(1, "d", "cpu"),
                              eps=eps)
    loss.backward()
    mine_leaves = {n: t.clone().requires_grad_(True) for n, t in flat.items()}
    mine = ref_vae.elbo(ref_gpt.nest(mine_leaves), cfg["model"], x, eps, 1.0,
                        weights.generator(1, "d", "cpu"))
    mine.backward()
    torch.testing.assert_close(mine, loss.detach(), rtol=1e-6, atol=1e-5)
    theirs = dict(ref_gpt.flatten(params))
    for n, t in mine_leaves.items():
        torch.testing.assert_close(t.grad, theirs[n].grad, rtol=1e-4,
                                   atol=1e-6, msg=n)
    # three steps: the reference's AdamW against the program's optimizer
    steps = [(x, eps, weights.generator(1, f"s{i}", "cpu"), 1.0)
             for i in range(3)]
    ref = ref_vae.train_steps(flat, cfg["model"], cfg["train"], steps)
    tree = ref_gpt.nest({n: t.clone().requires_grad_(True)
                         for n, t in flat.items()})
    opt = task._optimizer(tree)
    state = {"params": tree, "optimizer": opt, "step": 0,
             "kl_weight": torch.tensor(1.0)}
    before = copy.deepcopy(ref_gpt.flatten(tree))
    losses = []
    for xi, ei, gi, _ in [(x, eps, weights.generator(1, f"s{i}", "cpu"), 1)
                          for i in range(3)]:
        state, l, _ = task.train_step(state, xi, gi, eps=ei)
        losses.append(float(l))
    assert ref["losses"] == pytest.approx(losses, rel=1e-6)
    after = ref_gpt.flatten(state["params"])
    for n in after:
        change = float((after[n].detach() - before[n].detach()).norm())
        # a third of attn_qkv/b is the key's bias, whose gradient is nought
        # but round-off under softmax: Adam moves it by lr whatever that
        # round-off is, in either implementation
        rel = 2e-2 if n.endswith("attn_qkv/b") else 1e-3
        assert ref["change"][n] == pytest.approx(change, rel=rel), n


def test_fp8_and_int4_products_are_coarser():
    g = torch.Generator().manual_seed(3)
    a, b = torch.randn(64, 64, generator=g), torch.randn(64, 64, generator=g)
    exact = a @ b
    e8 = (ref_vae.fp8_matmul(a, b) - exact).norm() / exact.norm()
    e4 = (ref_gpt.int4_matmul(a, b) - exact).norm() / exact.norm()
    assert 1e-3 < e8 < 0.1 and e4 > e8
