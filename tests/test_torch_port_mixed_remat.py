"""PyTorch port, mixed precision and remat in the GPT's train forward,
against the JAX package on the CPU.

Mixed precision (``cfg.mixed_precision``): the block's four products take
bfloat16 operands and return float32 (on the CPU the float32 product of
the rounded operands, the same function), the residual stream, layer
norms, softmax and loss stay float32.  Held to JAX's ``gpt_apply`` with
``mixed_precision=True`` at 1e-3 for logits (a summation-order difference
can flip one bfloat16 rounding of an operand downstream; the JAX test's
own mixed-vs-float32 bound is 0.05, tests/test_gpt.py:323-335) and at the
port's training bound 1e-3 for gradients (tests/test_torch_port_training.
py:190-193).  Remat (``cfg.remat``, policies full / attn / dots) holds the
port against itself with dropout 0.3 (loss, logits and every gradient to
1e-6, the generator's state after the step equal) and against JAX's remat
with dropout off (1e-5 loss and logits, 1e-4 gradients, tests/test_gpt.py:
198-214).  Kernel F runs its plain version (CPU tensors); its JAX form in
Pallas interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from melspec_gpt_vqvae_tpu.configs import GPTConfig
from melspec_gpt_vqvae_tpu.models import gpt as JG
from melspec_gpt_vqvae_tpu.training import gpt_task as JT
from melspec_gpt_vqvae_tpu_torch import bridge
from melspec_gpt_vqvae_tpu_torch.models import gpt as TG
from melspec_gpt_vqvae_tpu_torch.training import gpt_task as TT
from melspec_gpt_vqvae_tpu_torch.training import optim as TO

torch.set_num_threads(1)

TINY = GPTConfig(vocab_size=16, block_size=21, n_layer=2, n_head=2,
                 n_embd=16, class_size=4)
POLICIES = ["full", "attn", "dots"]


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 16, (8, 4, 5)).astype(np.int32),
            rng.integers(0, 4, (8,)).astype(np.int32))


def _jax_case(cfg, seed=1):
    """JAX loss, gradients and eval logits of the class GPT on one batch,
    with the port's copy of the same params."""
    jp = JG.init_gpt_params(jax.random.PRNGKey(seed), cfg)
    codes, tgt = _batch()
    x, c = JT.tokens_from_batch(jnp.asarray(codes)), jnp.asarray(tgt)
    jl, jg = jax.value_and_grad(lambda p: JT.gpt_loss_fn(
        p, cfg, x, c, jax.random.PRNGKey(2), train=True))(jp)
    jlogits, _ = JG.gpt_apply(jp, cfg, x[:, :-1], JG.class_embed(jp, c))
    tp = TT._map(bridge.gpt_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp)),
        lambda t: t.to(TG.DTYPES[cfg.dtype]).requires_grad_(True))
    return (float(jl), jg, np.asarray(jlogits, np.float32)), tp


def _port_case(tp, cfg, generator=None):
    codes, tgt = _batch()
    tx, tc = TT.tokens_from_batch(codes), torch.from_numpy(tgt)
    loss = TT.gpt_loss_fn(tp, cfg, tx, tc, generator=generator, train=True)
    loss.backward()
    with torch.no_grad():
        logits = TG.gpt_apply(tp, cfg, tx[:, :-1], TG.class_embed(tp, tc))
    return loss.item(), logits.float().numpy()


def _grad_err(jg, tp):
    worst = 0.0
    for name, t in TO.named_leaves(tp):
        node = jg
        for k in name.split("/"):
            node = node[k]
        worst = max(worst, float(np.abs(
            t.grad.float().numpy() - np.asarray(node, np.float32)).max()))
    return worst


@pytest.mark.parametrize("use_flash", [False, True])
def test_mixed_precision_matches_jax(use_flash):
    """Loss, eval logits (1e-3) and every gradient (1e-3) of the mixed-
    precision forward against JAX's; logits are float32."""
    cfg = TINY.replace(mixed_precision=True, use_flash_train=use_flash)
    (jl, jg, jlogits), tp = _jax_case(cfg)
    loss, logits = _port_case(tp, bridge.config_from_jax(cfg))
    assert logits.dtype == np.float32
    np.testing.assert_allclose(logits, jlogits, atol=1e-3, rtol=0)
    assert abs(loss - jl) < 1e-3
    assert _grad_err(jg, tp) < 1e-3


def test_mixed_precision_bf16_params_match_jax():
    """``--param_dtype bfloat16``: bf16 parameters, the lookup in bf16, the
    residual stream in float32; against JAX at the same bounds."""
    cfg = TINY.replace(mixed_precision=True, dtype="bfloat16")
    (jl, jg, jlogits), tp = _jax_case(cfg)
    assert tp["tok_emb"].dtype == torch.bfloat16
    loss, logits = _port_case(tp, bridge.config_from_jax(cfg))
    np.testing.assert_allclose(logits, jlogits, atol=1e-3, rtol=0)
    assert abs(loss - jl) < 1e-3
    assert _grad_err(jg, tp) < 1e-3


def test_mixed_precision_products_are_bf16_operands():
    """The block's products are float32 products of bfloat16-rounded
    operands, not float32 products and not bfloat16 products widened."""
    g = torch.Generator().manual_seed(0)
    a, w = torch.randn(3, 5, 64, generator=g), torch.randn(64, 48,
                                                           generator=g)
    out = TG._dot(a, w, True)
    ref = a.bfloat16().double() @ w.bfloat16().double()
    assert out.dtype == torch.float32
    assert (out.double() - ref).abs().max().item() < 1e-5
    assert (out - (a.bfloat16() @ w.bfloat16()).float()).abs().max() > 1e-3
    assert torch.equal(TG._dot(a, w, False), a @ w)


def _remat_run(cfg, with_generator=True):
    tp = TT._map(TG.init_gpt_params(cfg, torch.Generator().manual_seed(3)),
                 lambda t: t.requires_grad_(True))
    codes, tgt = _batch()
    tx, tc = TT.tokens_from_batch(codes), torch.from_numpy(tgt)
    g = torch.Generator().manual_seed(9) if with_generator else None
    loss = TT.gpt_loss_fn(tp, cfg, tx, tc, generator=g, train=True)
    loss.backward()
    g2 = torch.Generator().manual_seed(9)
    logits = TG.gpt_apply({k: v for k, v in tp.items()}, cfg, tx[:, :-1],
                          TG.class_embed(tp, tc), train=True, generator=g2)
    return (loss.item(), logits.detach(),
            {n: t.grad.clone() for n, t in TO.named_leaves(tp)},
            None if g is None else g.get_state())


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_equals_no_remat_with_dropout(policy, use_flash, mixed):
    """With dropout 0.3 at all three sites, remat gives the loss, the
    train-mode logits and every gradient of the forward without it (to
    1e-6) and leaves the generator where the plain forward leaves it:
    each recomputed region draws its masks again from the state it began
    at."""
    cfg = TINY.replace(embd_pdrop=0.3, resid_pdrop=0.3, attn_pdrop=0.3,
                       use_flash_train=use_flash, mixed_precision=mixed)
    base = _remat_run(cfg)
    got = _remat_run(cfg.replace(remat=True, remat_policy=policy))
    assert abs(got[0] - base[0]) < 1e-6
    assert (got[1] - base[1]).abs().max().item() < 1e-6
    for name, g in base[2].items():
        assert (got[2][name] - g).abs().max().item() < 1e-6, name
    assert torch.equal(got[3], base[3])


@pytest.mark.parametrize("policy,calls", [("full", 4), ("attn", 4),
                                          ("dots", 4), (None, 2)])
def test_remat_recomputes_the_attention(monkeypatch, policy, calls):
    """Under every policy the backward replays each layer's attention once
    (two layers: 2 forward + 2 recomputed), as JAX's remat must to rebuild
    the attention's residuals; without remat it runs once a layer.  An
    unknown policy is refused."""
    seen = []
    attn_half = TG._attn_half

    def counting(*a, **kw):
        seen.append(1)
        return attn_half(*a, **kw)
    monkeypatch.setattr(TG, "_attn_half", counting)
    cfg = TINY.replace(attn_pdrop=0.3)
    if policy is not None:
        cfg = cfg.replace(remat=True, remat_policy=policy)
    tp = TT._map(TG.init_gpt_params(cfg, torch.Generator().manual_seed(3)),
                 lambda t: t.requires_grad_(True))
    codes, tgt = _batch()
    loss = TT.gpt_loss_fn(tp, cfg, TT.tokens_from_batch(codes),
                          torch.from_numpy(tgt),
                          generator=torch.Generator().manual_seed(1),
                          train=True)
    loss.backward()
    assert len(seen) == calls
    with pytest.raises(ValueError, match="remat_policy"):
        TT.gpt_loss_fn(tp, cfg.replace(remat=True, remat_policy="nope"),
                       TT.tokens_from_batch(codes), torch.from_numpy(tgt),
                       train=True)


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_matches_jax_remat(policy, mixed):
    """The port's remat against JAX's remat with dropout off: loss and
    logits to 1e-5, gradients to 1e-4 (1e-3 under mixed precision, the
    bound of the mixed-precision test above)."""
    cfg = TINY.replace(remat=True, remat_policy=policy, mixed_precision=mixed)
    (jl, jg, jlogits), tp = _jax_case(cfg)
    loss, logits = _port_case(tp, bridge.config_from_jax(cfg))
    tol = 1e-3 if mixed else 1e-5
    np.testing.assert_allclose(logits, jlogits, atol=tol, rtol=0)
    assert abs(loss - jl) < tol
    assert _grad_err(jg, tp) < (1e-3 if mixed else 1e-4)
