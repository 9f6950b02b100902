"""The port's cross-process reduction (melspec_gpt_vqvae_tpu_torch/
parallel/reduce.py): every case of tests/test_reduce.py through the
port's transport seam -- the metric sums, the posterior concatenation with
unequal and empty shards, corpus MI / AU over the whole corpus, an empty
rank joining the gather -- with the posteriors of the "other host" from
the JAX package's encoder where the JAX test takes them from its own; and
one real two-rank gloo world (tests/torch_dist_worlds.py) of
``cross_process_concat`` with unequal rows and an empty shard."""

import jax
import numpy as np
import pytest
import torch

from melspec_gpt_vqvae_tpu.configs import (DataConfig, ExperimentConfig,
                                           GPTConfig, TrainConfig,
                                           VAEConfig)
from melspec_gpt_vqvae_tpu.parallel import make_mesh as jax_mesh
from melspec_gpt_vqvae_tpu.training.vae_task import VAETask as JVAETask
from melspec_gpt_vqvae_tpu_torch import bridge
from melspec_gpt_vqvae_tpu_torch.parallel import reduce as R
from melspec_gpt_vqvae_tpu_torch.training.vae_task import VAETask

import torch_dist_worlds as W


@pytest.fixture(autouse=True)
def _reset_transport():
    yield
    R.set_transport(None)


def test_single_process_identity():
    m = {"a": 1.5, "b": -2.0}
    assert R.cross_process_sum(m) == {"a": 1.5, "b": -2.0}


def _fake_two_host_transport(other_metrics):
    """Transport that appends the 'other host's' vector (sorted-key order,
    matching cross_process_sum's packing)."""
    keys = sorted(other_metrics)

    def transport(vec):
        other = np.asarray([float(other_metrics[k]) for k in keys],
                           np.float64)
        return np.stack([vec, other])

    return transport


def test_two_process_sums():
    R.set_transport(_fake_two_host_transport({"loss": 3.5, "n": 4.0}))
    assert R.cross_process_sum({"loss": 1.0, "n": 2.0}) == {"loss": 4.5,
                                                           "n": 6.0}


def _fake_outputs(rng, n):
    return [{"loss": float(rng.uniform(10, 20)),
             "loss_rc": float(rng.uniform(8, 15)),
             "loss_kl": float(rng.uniform(0, 5)),
             "num_words": 19 * 4, "num_sents": 4} for _ in range(n)]


def test_multihost_val_equals_single_host_full_data():
    """Epoch metrics computed per host and reduced across processes equal
    the metrics over the full data on one host (the reference's
    sync_dist: Lit_GPT_VAE.py:310-313)."""
    outputs = _fake_outputs(np.random.default_rng(0), 6)
    single = VAETask.metrics_from_sums(VAETask.sum_outputs(outputs))
    R.set_transport(_fake_two_host_transport(
        VAETask.sum_outputs(outputs[3:])))
    multi = VAETask.metrics_from_sums(
        R.cross_process_sum(VAETask.sum_outputs(outputs[:3])))
    for k in single:
        assert multi[k] == pytest.approx(single[k], rel=1e-12), k


def _fake_concat_transport(other_arrays):
    """(K,) -> (P, K) transport simulating a second host: a size-1 vector
    is the counts phase, anything else the data phase (the other host's
    rows, zero-padded to the caller's max_n); consecutive gathers consume
    ``other_arrays`` in order (mu then logvar)."""
    state = {"i": 0}

    def transport(vec):
        other = np.asarray(other_arrays[state["i"]], np.float32)
        if vec.size == 1:
            return np.stack([vec, np.asarray([float(len(other))],
                                             np.float64)])
        state["i"] += 1
        n, d = other.shape
        max_n = vec.size // d
        pad = np.zeros((max_n, d), np.float32)
        pad[:n] = other
        return np.stack([vec, pad.reshape(-1)])

    return transport


def test_cross_process_concat_single_process_identity():
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    np.testing.assert_array_equal(R.cross_process_concat(a), a)
    assert R.concat_gather_fn() is None


def test_cross_process_concat_unequal_rows():
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    b = (100.0 + np.arange(8, dtype=np.float32)).reshape(2, 4)
    R.set_transport(_fake_concat_transport([b]))
    assert R.concat_gather_fn() is not None
    np.testing.assert_array_equal(R.cross_process_concat(a), np.vstack([a,
                                                                        b]))


def _vae():
    """A tiny GPT-VAE: the JAX task and the port's on its state."""
    model = GPTConfig(vocab_size=16, block_size=20, n_layer=1, n_head=2,
                      n_embd=16, class_size=None)
    exp = ExperimentConfig(
        model=model, vae=VAEConfig(nz=8),
        train=TrainConfig(learning_rate=1e-3, epochs=1, batch_size=4),
        data=DataConfig(batch_size=4))
    jtask = JVAETask(exp, steps_per_epoch=2, mesh=jax_mesh())
    jstate = jtask.init_state(0)
    task = VAETask(bridge.config_from_jax(exp), 2, "cpu")
    state = task.load_state(bridge.train_state_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate["params"]),
        jstate["opt_state"], jstate["step"], kl_weight=jstate["kl_weight"]))
    return jtask, jstate, task, state


def _posteriors(jtask, jstate, toks):
    """The other host's posteriors, from the JAX package's encoder."""
    from melspec_gpt_vqvae_tpu.models import gpt_vae as JV
    mu, lv = JV.encoder_forward(jstate["params"], jtask.cfgs,
                                jax.numpy.asarray(toks))
    return [np.asarray(mu), np.asarray(lv)]


def test_multihost_mi_au_covers_full_corpus():
    """Corpus MI / AU under two processes equal the single-process
    full-corpus values: calc_mi_au pools the posterior shards (the
    reference computes them over the whole val set on every rank,
    callbacks/GPT_VAE_callbacks.py:429-436).  The port's noise is one z a
    row from the task's generator, the same in both runs."""
    jtask, jstate, task, state = _vae()
    rng = np.random.default_rng(3)
    toks = [rng.integers(0, 16, (4, 20)).astype(np.int64) for _ in range(3)]
    mi_full, au_full, _ = task.calc_mi_au(state, toks)
    R.set_transport(_fake_concat_transport(_posteriors(jtask, jstate,
                                                       toks[2])))
    mi_a, au_a, _ = task.calc_mi_au(state, toks[:2])
    assert mi_a == pytest.approx(mi_full, abs=1e-5)
    assert au_a == au_full


def test_cross_process_concat_empty_local_shard():
    b = (100.0 + np.arange(8, dtype=np.float32)).reshape(2, 4)
    R.set_transport(_fake_concat_transport([b]))
    np.testing.assert_array_equal(
        R.cross_process_concat(np.zeros((0, 4), np.float32)), b)


def test_cross_process_concat_all_empty():
    R.set_transport(_fake_concat_transport([np.zeros((0, 4), np.float32)]))
    out = R.cross_process_concat(np.zeros((0, 4), np.float32))
    assert out.shape == (0, 4)


def test_cross_process_concat_dtype_stable_across_process_count():
    a = np.arange(6, dtype=np.float64).reshape(2, 3)
    assert R.cross_process_concat(a).dtype == np.float32
    R.set_transport(_fake_concat_transport([a.astype(np.float32)]))
    assert R.cross_process_concat(a).dtype == np.float32


def test_calc_mi_au_empty_rank_joins_collective():
    """An empty local token list still enters the gather and returns the
    other rank's full-corpus statistics; every rank empty gives nan / 0."""
    jtask, jstate, task, state = _vae()
    toks = [np.random.default_rng(7).integers(0, 16, (4, 20))]
    mi_full, au_full, _ = task.calc_mi_au(state, toks)
    R.set_transport(_fake_concat_transport(_posteriors(jtask, jstate,
                                                       toks[0])))
    mi, au, _ = task.calc_mi_au(state, [])
    assert mi == pytest.approx(mi_full, abs=1e-5)
    assert au == au_full
    R.set_transport(_fake_concat_transport(
        [np.zeros((0, 8), np.float32), np.zeros((0, 8), np.float32)]))
    mi, au, _ = task.calc_mi_au(state, [])
    assert np.isnan(mi) and au == 0


def test_pool_posteriors_stays_on_the_device_in_one_process():
    mu = [torch.ones(2, 3), torch.zeros(1, 3)]
    out = R.pool_posteriors(mu, mu, 3)
    assert out[0].shape == (3, 3) and out[0].dtype == torch.float32
    assert R.pool_posteriors([torch.ones(1, 3)], [torch.ones(1, 3)],
                             3) is None
    assert R.cross_process_sharded(None) is False


def test_two_rank_gloo_concat_and_sum(tmp_path):
    """A real two-rank world: unequal rows (3 and 2), an empty shard
    (0 and 2), every rank empty; the sums over the data group and over
    the world; the float32 rows of a float64 input."""
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    b = (100.0 + np.arange(8, dtype=np.float32)).reshape(2, 4)
    e = np.zeros((0, 4), np.float32)
    inp = {"concat": {"unequal": [a, b], "empty": [e, b], "none": [e, e]},
           "sums": [{"loss": 1.0, "n": 2.0}, {"loss": 3.5, "n": 4.0}]}
    W.write_inputs(tmp_path, inp)
    outs = W.join(W.spawn("reduce", 2, tmp_path), tmp_path, timeout=240)
    for o in outs:
        np.testing.assert_array_equal(o["concat/unequal"], np.vstack([a, b]))
        np.testing.assert_array_equal(o["concat/empty"], b)
        assert o["concat/none"].shape == (0, 4)
        assert o["sum"] == o["sum_world"] == {"loss": 4.5, "n": 6.0}
        assert o["gather_fn"] and o["dtype"] == "float32"
