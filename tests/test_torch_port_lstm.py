"""PyTorch port, the LSTM-VAE (model, task, logger, CLI), against the JAX
package on the CPU.

The same params (through ``bridge``) and inputs (numpy, fixed seeds) go
through both packages at tests/test_lstm_vae.py's and test_lstm_task.py's
tiny geometries.  Where JAX draws noise from a key, the test draws JAX's
draws from the same key and hands them to the port, whose generators never
agree with JAX's PRNG; decoder dropout is 0 wherever a training forward
is compared (its masks cannot be matched either).  Bounds: the JAX tests'
own -- 1e-6 on per-element encoder outputs and on the reconstruction error
(tests/test_lstm_vae.py), rtol 1e-5 on the losses -- and 1e-5 on logits;
greedy tokens, the beam's best hypothesis (on inputs without ties) and the
sentences of ``lstm_tokens_from_batch`` exactly; a train step's params to
1e-6 and its momentum to 1e-5 of each leaf's largest, as
tests/test_torch_port_vae.py holds the GPT-VAE's step.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from melspec_gpt_vqvae_tpu.configs import (ExperimentConfig, GPTConfig,
                                           TrainConfig, VAEConfig)
from melspec_gpt_vqvae_tpu.models import gpt_vae as JGV
from melspec_gpt_vqvae_tpu.models import lstm_vae as JL
from melspec_gpt_vqvae_tpu.parallel import make_mesh
from melspec_gpt_vqvae_tpu.training import callbacks as JCB
from melspec_gpt_vqvae_tpu.training import logging as JLog
from melspec_gpt_vqvae_tpu.training import lstm_task as JLT
from melspec_gpt_vqvae_tpu_torch import bridge, train_gpt_vae
from melspec_gpt_vqvae_tpu_torch.configs import LSTMConfig
from melspec_gpt_vqvae_tpu_torch.models import lstm_vae as TL
from melspec_gpt_vqvae_tpu_torch.training import callbacks as TCB
from melspec_gpt_vqvae_tpu_torch.training import lstm_task as TLT
from melspec_gpt_vqvae_tpu_torch.training import optim as TO
from melspec_gpt_vqvae_tpu_torch.training.logging import TBLogger

torch.set_num_threads(1)

CFG = JL.LSTMConfig(vocab_size=20, nz=8, ni=12, enc_nh=16, dec_nh=16,
                    bos_id=18, eos_id=19, max_len=15,
                    dec_dropout_in=0.5, dec_dropout_out=0.5)
CFG0 = CFG._replace(dec_dropout_in=0.0, dec_dropout_out=0.0)
TASK_CFG = JL.LSTMConfig(vocab_size=18, nz=8, ni=16, enc_nh=16, dec_nh=16,
                         dec_dropout_in=0.0, dec_dropout_out=0.0,
                         bos_id=16, eos_id=17, max_len=22)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _jsonl_events(monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorboardX", None)


def _tcfg(cfg):
    return LSTMConfig(**cfg._asdict())


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def _x(b=3, t=10, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 18, (b, t)).astype(np.int32)
    x[:, 0] = CFG.bos_id
    x[:, -1] = CFG.eos_id
    return jnp.asarray(x), torch.from_numpy(x.astype(np.int64))


def _params(seed=0, cfg=CFG):
    jp = JL.init_lstm_vae(jax.random.PRNGKey(seed), cfg)
    return jp, bridge.lstm_vae_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp))


def _normal(key, shape):
    return torch.from_numpy(np.array(jax.random.normal(key, shape)))


def _iw_eps(key, chunks, b, ns, nz):
    """lstm_nll_iw's noise: chunk c draws from the c-th split of ``key``."""
    return torch.stack([_normal(k, (b, ns, nz))
                        for k in jax.random.split(key, chunks)])


# -------------------------------- the model ----------------------------------

def test_params_cross_leaf_for_leaf():
    jp, tp = _params()
    mine = TL.init_lstm_vae(_tcfg(CFG), torch.Generator().manual_seed(0))
    tmpl = TL.lstm_vae_param_template(_tcfg(CFG))
    ref, got, meta = (dict(TO.named_leaves(t)) for t in (tp, mine, tmpl))
    assert ref.keys() == got.keys() == meta.keys()
    assert "decoder/lstm/wx" in ref and ref["decoder/lstm/wx"].shape == \
        (12 + 8, 64)
    for n, a in ref.items():
        assert a.shape == got[n].shape == meta[n].shape, n
        assert meta[n].device.type == "meta"
    emb = got["encoder/embed"]
    assert emb.abs().max() <= 0.1 and got["decoder/lstm/b"].abs().max() == 0


@pytest.mark.parametrize("fix_var", [-1.0, 0.25])
def test_encoder_matches_jax(fix_var):
    cfg = CFG._replace(fix_var=fix_var)
    jp, tp = _params()
    jx, tx = _x()
    jm, jl = JL.lstm_encoder_forward(jp["encoder"], cfg, jx)
    tm, tl = TL.lstm_encoder_forward(tp["encoder"], _tcfg(cfg), tx)
    np.testing.assert_allclose(_np(tm), np.asarray(jm), atol=1e-6)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=1e-6)
    key = jax.random.PRNGKey(1)
    jz, jkl = JL.lstm_encode(jp["encoder"], cfg, key, jx, 4)
    tz, tkl = TL.lstm_encode(tp["encoder"], _tcfg(cfg), tx, 4,
                             eps=_normal(key, (3, 4, 8)))
    np.testing.assert_allclose(_np(tz), np.asarray(jz), atol=1e-6)
    np.testing.assert_allclose(_np(tkl), np.asarray(jkl), atol=1e-6)


def test_decoder_logits_and_reconstruct_error_match_jax():
    jp, tp = _params()
    jx, tx = _x()
    z = np.random.default_rng(1).standard_normal((3, 2, 8)).astype(
        np.float32)
    want = JL.lstm_decode_logits(jp["decoder"], CFG, jx[:, :-1],
                                 jnp.asarray(z[:, 0]))
    got = TL.lstm_decode_logits(tp["decoder"], _tcfg(CFG), tx[:, :-1],
                                torch.from_numpy(z[:, 0]))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)
    jerr = JL.lstm_reconstruct_error(jp["decoder"], CFG, jx, jnp.asarray(z))
    terr = TL.lstm_reconstruct_error(tp["decoder"], _tcfg(CFG), tx,
                                     torch.from_numpy(z))
    assert terr.shape == (3, 2)
    np.testing.assert_allclose(_np(terr), np.asarray(jerr), atol=1e-6)
    np.testing.assert_allclose(
        _np(TL.lstm_log_probability(tp["decoder"], _tcfg(CFG), tx,
                                    torch.from_numpy(z))),
        -np.asarray(jerr), atol=1e-6)


def test_decoder_dropout_is_inverted_and_from_the_generator():
    """Training draws the input and output masks from the generator: the
    same seed the same logits, another seed others, eval none."""
    _, tp = _params()
    _, tx = _x()
    z = torch.randn(3, 8, generator=torch.Generator().manual_seed(0))
    run = lambda s, train=True: TL.lstm_decode_logits(  # noqa: E731
        tp["decoder"], _tcfg(CFG), tx[:, :-1], z, train=train,
        generator=torch.Generator().manual_seed(s))
    assert torch.equal(run(1), run(1)) and not torch.equal(run(1), run(2))
    assert torch.equal(run(1, train=False), run(2, train=False))
    zero = TL.lstm_decode_logits(tp["decoder"], _tcfg(CFG0), tx[:, :-1], z,
                                 train=True,
                                 generator=torch.Generator().manual_seed(1))
    assert torch.equal(zero, run(1, train=False))


def test_vae_loss_and_iw_nll_match_jax():
    jp, tp = _params()
    jx, tx = _x()
    key = jax.random.PRNGKey(1)
    jloss, jrec, jkl = JL.lstm_vae_loss(jp, CFG, key, jx, 0.5, 2)
    k1, _ = jax.random.split(key)
    tloss, trec, tkl = TL.lstm_vae_loss(tp, _tcfg(CFG), tx, 0.5, 2,
                                        eps=_normal(k1, (3, 2, 8)))
    for t, j in ((tloss, jloss), (trec, jrec), (tkl, jkl)):
        np.testing.assert_allclose(_np(t), np.asarray(j), rtol=1e-5)
    np.testing.assert_allclose(_np(tloss), _np(trec + 0.5 * tkl), rtol=1e-5)

    key = jax.random.PRNGKey(2)
    want = JL.lstm_nll_iw(jp, CFG, key, jx, nsamples=12, ns=4)
    got = TL.lstm_nll_iw(tp, _tcfg(CFG), tx, 12, 4,
                         eps=_iw_eps(key, 3, 3, 4, 8))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5)
    key = jax.random.PRNGKey(3)
    want = JL.lstm_loss_iw(jp, CFG, key, jx, 0.3, nsamples=8, ns=4)
    got = TL.lstm_loss_iw(tp, _tcfg(CFG), tx, 0.3, 8, 4,
                          eps=_iw_eps(jax.random.split(key)[1], 2, 3, 4, 8))
    for t, j in zip(got, want):
        np.testing.assert_allclose(_np(t), np.asarray(j), rtol=1e-5)


TRAIN_MODES = {"fb0": {}, "fb1": {"fb": 1, "target_kl": 2.0},
               "fb2": {"fb": 2, "target_kl": 2.0},
               "fb3": {"fb": 3, "target_kl": 2.0}, "ae": {"beta": 0.0},
               "iw": {"beta": 0.0, "iw_train_nsamples": 8, "iw_train_ns": 4}}


@pytest.mark.parametrize("mode", sorted(TRAIN_MODES))
def test_training_loss_and_grads_match_jax(mode):
    """Each branch of lstm_training_loss (dropout 0, JAX's noise): the loss
    and its report rtol 1e-5, the gradients to 1e-5 of each leaf's max."""
    vae = VAEConfig(nz=8, nsamples=2, **TRAIN_MODES[mode])
    jp, tp = _params(cfg=CFG0)
    jx, tx = _x()
    key = jax.random.PRNGKey(4)
    (jl, jaux), jg = jax.value_and_grad(
        lambda p: JL.lstm_training_loss(p, CFG0, vae, key, jx, 0.7,
                                        nsamples=2), has_aux=True)(jp)
    if mode == "iw":
        eps = _iw_eps(jax.random.split(key)[1], 2, 3, 4, 8)
    else:
        eps = _normal(jax.random.split(key)[0], (3, 2, 8))
    tp = TO.unflatten(tp, {n: t.requires_grad_(True)
                           for n, t in TO.named_leaves(tp)})
    tl, taux = TL.lstm_training_loss(tp, _tcfg(CFG0),
                                     bridge.config_from_jax(vae), tx, 0.7,
                                     nsamples=2, eps=eps)
    tl.backward()
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=1e-5)
    assert set(taux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(_np(taux[k]), np.asarray(jaux[k]),
                                   rtol=1e-5, atol=1e-6)
    want = dict(TO.named_leaves(bridge.lstm_vae_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jg))))
    for n, t in TO.named_leaves(tp):
        ref = want[n].numpy()
        assert np.abs(t.grad.numpy() - ref).max() <= \
            1e-5 * max(np.abs(ref).max(), 1e-3), n


def test_greedy_decode_and_beam_match_jax():
    """Greedy tokens and lengths exactly JAX's; the beam's best hypothesis
    exactly, its score within 1e-5 (scores have no ties here: the check
    below asserts it)."""
    jp, tp = _params(seed=2)
    z = np.random.default_rng(3).standard_normal((3, 8)).astype(np.float32)
    jt, jlen = JL.lstm_sample_decode(jp["decoder"], CFG,
                                     jax.random.PRNGKey(0), jnp.asarray(z),
                                     greedy=True)
    tt, tlen = TL.lstm_sample_decode(tp["decoder"], _tcfg(CFG),
                                     torch.from_numpy(z), greedy=True)
    np.testing.assert_array_equal(_np(tt), np.asarray(jt))
    np.testing.assert_array_equal(_np(tlen), np.asarray(jlen))
    for beam in (1, 4):
        jtop, jsc = JL.lstm_beam_search(jp["decoder"], CFG, jnp.asarray(z),
                                        beam=beam)
        ttop, tsc = TL.lstm_beam_search(tp["decoder"], _tcfg(CFG),
                                        torch.from_numpy(z), beam=beam)
        np.testing.assert_array_equal(_np(ttop), np.asarray(jtop))
        np.testing.assert_allclose(_np(tsc), np.asarray(jsc), rtol=1e-5)
    assert np.asarray(jsc).tolist() == sorted(set(np.asarray(jsc).tolist()),
                                              key=np.asarray(jsc).tolist()
                                              .index)


def test_sample_decode_terminates_and_masks():
    """Ancestral decoding from a generator: </s> after the first </s>,
    lengths counting up to it, the same seed the same rows."""
    _, tp = _params()
    z = torch.zeros(4, 8)
    cfg = _tcfg(CFG)
    toks, lengths = TL.lstm_sample_decode(
        tp["decoder"], cfg, z, generator=torch.Generator().manual_seed(0))
    again, _ = TL.lstm_sample_decode(
        tp["decoder"], cfg, z, generator=torch.Generator().manual_seed(0))
    assert torch.equal(toks, again) and toks.shape == (4, 15)
    for row, n in zip(toks.tolist(), lengths.tolist()):
        if cfg.eos_id in row:
            first = row.index(cfg.eos_id)
            assert n == first + 1 and set(row[first:]) == {cfg.eos_id}
        else:
            assert n == 15


def test_mh_sample_posterior_matches_jax_with_its_noise():
    """The chain with JAX's draws handed in: every kept state within
    1e-5."""
    jp, tp = _params()
    jx, tx = _x()
    key = jax.random.PRNGKey(2)
    want = JL.mh_sample_posterior(jp, CFG, key, jx, nsamples=4, burn_in=2)
    rest, k0 = jax.random.split(key)
    props, unifs = [], []
    for k in jax.random.split(rest, 6):
        k1, k2 = jax.random.split(k)
        props.append(np.array(jax.random.normal(k1, (3, 8))))
        unifs.append(np.array(jax.random.uniform(k2, (3,))))
    noise = (_normal(k0, (3, 8)), torch.from_numpy(np.stack(props)),
             torch.from_numpy(np.stack(unifs)))
    got = TL.mh_sample_posterior(tp, _tcfg(CFG), tx, 4, 2, noise=noise)
    assert got.shape == (3, 4, 8)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)
    drawn = TL.mh_sample_posterior(tp, _tcfg(CFG), tx, 4, 2,
                                   generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (3, 4, 8) and torch.isfinite(drawn).all()


def test_lm_and_discriminators_match_jax():
    jlm = JL.init_lstm_lm(jax.random.PRNGKey(0), CFG)
    tlm = bridge.lstm_vae_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jlm))
    jx, tx = _x()
    np.testing.assert_allclose(_np(TL.lstm_lm_nll(tlm, _tcfg(CFG), tx)),
                               np.asarray(JL.lstm_lm_nll(jlm, CFG, jx)),
                               rtol=1e-6)
    mean = np.random.default_rng(0).standard_normal((5, 8)).astype(
        np.float32)
    for jinit, jfn, tfn in (
            (JL.init_linear_discriminator, JL.linear_discriminator_logits,
             TL.linear_discriminator_logits),
            (JL.init_mlp_discriminator, JL.mlp_discriminator_logits,
             TL.mlp_discriminator_logits)):
        jd = jinit(jax.random.PRNGKey(1), 8, 4)
        td = bridge.lstm_vae_params_from_jax(
            jax.tree_util.tree_map(np.asarray, jd))
        np.testing.assert_allclose(_np(tfn(td, torch.from_numpy(mean))),
                                   np.asarray(jfn(jd, jnp.asarray(mean))),
                                   atol=1e-6)
    g = torch.Generator().manual_seed(0)
    assert TL.linear_discriminator_logits(
        TL.init_linear_discriminator(g, 8, 4), torch.zeros(2, 8)).shape \
        == (2, 4)
    assert TL.mlp_discriminator_logits(
        TL.init_mlp_discriminator(g, 8, 4), torch.zeros(2, 8)).shape == (2, 4)
    assert TL.lstm_lm_nll(TL.init_lstm_lm(_tcfg(CFG), g), _tcfg(CFG),
                          tx).shape == (3,)


# -------------------------------- the task -----------------------------------

@pytest.mark.parametrize("shape", [(2, 5, 53), (3, 4, 5)],
                         ids=["vas", "small_grid"])
def test_lstm_tokens_from_batch_equals_jax(shape):
    codes = np.random.default_rng(0).integers(0, 128, shape)
    want = np.asarray(JLT.lstm_tokens_from_batch(codes, 128, 129))
    got = TLT.lstm_tokens_from_batch(codes, 128, 129)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    if shape[2] == 53:
        assert got.shape == (10, 52)


def _exp(momentum=0.5, **vae_kw):
    return ExperimentConfig(
        model=GPTConfig(vocab_size=18, block_size=22, n_layer=1, n_head=1,
                        n_embd=16),
        vae=VAEConfig(nz=8, **vae_kw),
        train=TrainConfig(learning_rate=0.5, optimizer="sgd",
                          momentum=momentum, epochs=2, batch_size=4,
                          grad_clip=5.0))


def _codes(b=4, seed=0):
    return {"codes": np.random.default_rng(seed).integers(
        0, 16, (b, 4, 5)).astype(np.int32)}


def _flat(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, name)
        else:
            yield name, v


def test_task_continues_a_jax_state():
    """A JAX LSTMVAETask state after two SGD-momentum steps (clip 5, anneal
    warm_up 2 from kl_start 0.1), carried across with its momentum trace
    and kl_weight, then two steps in both with JAX's noise: the losses and
    reports, kl_weight bit for bit, the params to 1e-6 and the trace to
    1e-5 of each leaf's largest."""
    exp = _exp(warm_up=2, kl_start=0.1)
    jtask = JLT.LSTMVAETask(exp, TASK_CFG, 3, mesh=make_mesh({"data": 1}))
    state = jtask.init_state(0)
    batches = [_codes(seed=s) for s in range(4)]
    for s, bt in enumerate(batches[:2]):
        state, _, _ = jtask.train_step(state, bt, jax.random.PRNGKey(s))
    tree = bridge.lstm_vae_train_state_from_jax(
        jax.tree_util.tree_map(np.asarray, state))
    task = TLT.LSTMVAETask(bridge.config_from_jax(exp), _tcfg(TASK_CFG), 3,
                           CPU)
    assert task.anneal_rate == pytest.approx(jtask.anneal_rate)
    tstate = task.load_state(tree)
    assert tstate["step"] == 2 and len(tree["opt"]) == 11
    for s, bt in enumerate(batches[2:]):
        key = jax.random.PRNGKey(10 + s)
        state, jl, jrep = jtask.train_step(state, bt, key)
        eps = _normal(jax.random.split(key)[0], (4, 1, 8))
        tstate, tl, trep = task.train_step(tstate, bt, torch.Generator(),
                                           eps=eps)
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
        for k in jrep:
            np.testing.assert_allclose(_np(trep[k]), np.asarray(jrep[k]),
                                       rtol=1e-5)
        assert tstate["kl_weight"].item() == float(state["kl_weight"])
    out = task.state_tree(tstate)
    want = dict(_flat(state["params"]))
    for n, t in TO.named_leaves(out["params"]):
        np.testing.assert_allclose(_np(t), np.asarray(want[n]), atol=1e-6,
                                   rtol=0, err_msg=n)
    trace = bridge._optax_state(state["opt_state"], "trace").trace
    for n, ref in _flat(trace):
        ref = np.asarray(ref)
        got = _np(out["opt"][n]["momentum_buffer"])
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max(), n
    assert out["step"] == 4


def test_task_state_round_trip_and_eval(tmp_path):
    """state_tree / load_state carry the state exactly (SGD momentum, Adam
    too); eval_step's sums and NLL / PPL as the JAX task's."""
    for opt in ("sgd", "adam"):
        exp = _exp()
        exp.train = exp.train.__class__(**{**exp.train.__dict__,
                                           "optimizer": opt})
        task = TLT.LSTMVAETask(bridge.config_from_jax(exp), _tcfg(TASK_CFG),
                               3, CPU)
        state = task.init_state(0)
        state, _, _ = task.train_step(state, _codes(),
                                      torch.Generator().manual_seed(0))
        again = task.load_state(task.state_tree(state))
        for (na, a), (nb, b) in zip(
                TO.named_leaves(task.state_tree(state)["params"]),
                TO.named_leaves(task.state_tree(again)["params"])):
            assert torch.equal(a, b), na
        tmpl = task.state_template()
        assert ("mu" in tmpl) == (opt == "adam")
    exp = _exp(momentum=0.0)     # plain SGD: no optimiser state
    jtask = JLT.LSTMVAETask(exp, TASK_CFG, 3, mesh=make_mesh({"data": 1}))
    jstate = jtask.init_state(0)
    tree = bridge.lstm_vae_train_state_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate))
    assert tree["opt"] == {}
    task = TLT.LSTMVAETask(bridge.config_from_jax(exp), _tcfg(TASK_CFG), 3,
                           CPU)
    tstate = task.load_state(tree)
    key = jax.random.PRNGKey(7)
    want = jtask.eval_step(jstate, _codes(), key)
    got = task.eval_step(tstate, _codes(),
                         eps=_normal(jax.random.split(key)[0], (4, 1, 8)))
    # the KL of a fresh encoder is 0 up to rounding: 1e-6 absolute there,
    # as tests/test_torch_port_vae.py bounds the reports
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        list(task.aggregate_epoch([got, got]).values()),
        list(jtask.aggregate_epoch([want, want]).values()), rtol=1e-5,
        atol=1e-6)


def test_calc_mi_au_and_iwnll_match_jax():
    """Corpus MI (JAX's noise handed in) within 1e-5 and AU exactly on the
    same two batches; the IW-NLL's PPL bookkeeping."""
    exp = _exp()
    jtask = JLT.LSTMVAETask(exp, TASK_CFG, 3, mesh=make_mesh({"data": 1}))
    jstate = jtask.init_state(0)
    task = TLT.LSTMVAETask(bridge.config_from_jax(exp), _tcfg(TASK_CFG), 3,
                           CPU)
    tstate = task.load_state(bridge.lstm_vae_train_state_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate)))
    batches = [_codes(seed=1), _codes(seed=2)]
    jmi, jau, jvar = jtask.calc_mi_au(jstate, batches)
    eps = _normal(jax.random.PRNGKey(0), (8, 8))
    tmi, tau, tvar = task.calc_mi_au(tstate, batches, eps=eps)
    assert tau == jau
    np.testing.assert_allclose(tmi, jmi, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(tvar), np.asarray(jvar), rtol=1e-5,
                               atol=1e-7)
    nll, ppl = task.calc_iwnll(tstate, batches, nsamples=4, ns=2)
    assert np.isfinite(nll) and ppl == pytest.approx(
        np.exp(nll * 8 / (8 * 21)))
    assert np.isnan(task.calc_mi_au(tstate, [])[0])


def test_reconstruct_decode_and_prior():
    exp = _exp()
    task = TLT.LSTMVAETask(bridge.config_from_jax(exp), _tcfg(TASK_CFG), 3,
                           CPU)
    state = task.init_state(0)
    for strategy in ("greedy", "beam", "sample"):
        toks = task.reconstruct(state, _codes(), strategy,
                                torch.Generator().manual_seed(0))
        assert toks.shape == (4, 22) and int(toks.min()) >= 0 \
            and int(toks.max()) < 18
    assert task.sample_from_prior(state, 3).shape == (3, 22)


def test_lstm_text_logger_writes_the_jax_tags(tmp_path, monkeypatch):
    exp = _exp()
    jtask = JLT.LSTMVAETask(exp, TASK_CFG, 3, mesh=make_mesh({"data": 1}))
    seen = []
    monkeypatch.setattr(JLog.TBLogger, "text",
                        lambda self, tag, text, step: seen.append(tag))
    monkeypatch.setattr(JLog.TBLogger, "flush", lambda self: None)
    JCB.LSTMTextLogger(jtask, JLog.TBLogger(str(tmp_path / "j"),
                                            enabled=False))(
        jtask.init_state(0), _codes(), 1, "val")
    task = TLT.LSTMVAETask(bridge.config_from_jax(exp), _tcfg(TASK_CFG), 3,
                           CPU)
    log = TBLogger(str(tmp_path / "t"))
    TCB.LSTMTextLogger(task, log)(task.init_state(0), _codes(), 1, "val")
    with open(os.path.join(log.log_dir, "events.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["tag"] for r in recs] == seen
    first = recs[0]["text"].split()
    assert first[0] == "16" and len(first) == 22    # <s> id of this vocab
    jx = np.asarray(JLT.lstm_tokens_from_batch(_codes()["codes"][:1], 16,
                                               17))[0]
    assert first == [str(w) for w in jx]


# --------------------------------- the CLI -----------------------------------

@pytest.fixture(scope="module")
def vas_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("lstm_vas")
    rng = np.random.default_rng(0)
    lines = []
    for cls in ["baby", "dog"]:
        for sub in ("melspec_10s_22050hz", "codes_10s"):
            (root / "features" / cls / sub).mkdir(parents=True)
        for i in range(8):
            vid = f"video_{i:05d}"
            feat = root / "features" / cls
            np.save(feat / "melspec_10s_22050hz" / f"{vid}_mel.npy",
                    rng.uniform(0, 1, (80, 860)).astype(np.float32))
            np.save(feat / "codes_10s" / f"{vid}_mel_code.npy",
                    rng.integers(0, 128, (5, 53)).astype(np.int64))
            lines.append(f"{cls}/{vid}")
    data = root / "data"
    data.mkdir()
    (data / "vas_train.txt").write_text("\n".join(lines[:12]) + "\n")
    (data / "vas_valid.txt").write_text("\n".join(lines[12:]) + "\n")
    return root


def test_train_gpt_vae_cli_model_lstm(vas_tree, tmp_path, monkeypatch):
    """--model lstm on the VAE_vas preset's shapes at narrow widths: trains
    two epochs (LSTMTextLogger, MI / AU at each epoch's end), evaluates
    and tests from last (MI, AU, IW), resumes into a third epoch."""
    monkeypatch.chdir(tmp_path)
    spec = vas_tree / "features" / "*" / "melspec_10s_22050hz"
    base = ["--dataset", "vas", "--experiment", "l", "--model", "lstm",
            "--device", "cpu", "--data_root", str(vas_tree / "data"),
            "--override", f"ni=16,enc_nh=16,dec_nh=16,nz=8,batch_size=4,"
                          f"spec_dir_path={spec}",
            "--limit_val_batches", "1", "--warm_up", "1", "--kl_start",
            "0.5", "--iw_nsamples", "4"]
    task, state, ckpt, _ = train_gpt_vae.main(train_gpt_vae.init_config(
        base + ["--train", "1", "--epochs_override", "2",
                "--logging_frequency", "2", "--opt", "sgd", "--momentum",
                "0.5"]))
    assert isinstance(task, TLT.LSTMVAETask)
    assert task.cfg.max_len == 52 and task.exp.train.grad_clip == 5.0
    assert state["step"] == 6 and state["kl_weight"].item() == 1.0
    assert isinstance(state["optimizer"], torch.optim.SGD)
    run = tmp_path / "lightning_logs" / "l-vas"
    with open(run / "TensorBoardLoggs" / "version_0" / "events.jsonl") as f:
        tags = {json.loads(line)["tag"] for line in f}
    for tag in ("train/original", "train/greedy_reconstruction",
                "train/beam_reconstruction", "train/sampled_from_prior",
                "metrics/mutual_info", "val/ppl"):
        assert tag in tags, tag
    tree = ckpt.restore("last")["state"]
    live = task.state_tree(state)
    for (n, a), (_, b) in zip(TO.named_leaves(tree["params"]),
                              TO.named_leaves(live["params"])):
        assert torch.equal(a, b), n
    _, none, _, metrics = train_gpt_vae.main(train_gpt_vae.init_config(
        base + ["--eval", "1", "--test", "1", "--resume", "last"]))
    assert none is None
    for part in ("eval", "test"):
        assert {"mutual_info", "active_units", "nll", "ppl"} <= \
            set(metrics[part])
    assert "iw_nll" in metrics["test"] and np.isfinite(
        metrics["test"]["iw_nll"])
    _, resumed, _, _ = train_gpt_vae.main(train_gpt_vae.init_config(
        base + ["--train", "1", "--epochs_override", "3", "--resume",
                "last", "--opt", "sgd", "--momentum", "0.5"]))
    assert resumed["step"] == 9


def test_train_gpt_vae_cli_model_lstm_refuses_gpt_overrides(vas_tree,
                                                            tmp_path,
                                                            monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="n_layer"):
        train_gpt_vae.main(train_gpt_vae.init_config(
            ["--dataset", "vas", "--experiment", "l", "--model", "lstm",
             "--device", "cpu", "--train", "1", "--override", "n_layer=2"]))
    assert not (tmp_path / "lightning_logs").exists()
