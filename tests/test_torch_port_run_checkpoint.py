"""PyTorch port: serving a GPT run checkpoint (serving.py's
``_restore_gpt_params`` and ``build_pipeline(experiment=...)``) and
scripts/torch_convert_orbax.py.

A tiny JAX GPTTask state (one AdamW step) is saved with the JAX
CheckpointManager as a run of GPT_train.py would save it, converted by the
script into the port's layout, and read back by both packages' loaders:
the params must be equal, the port's CheckpointManager must take the
whole train state, and a pipeline built from the run must decode as one
built from the same weights in memory.
"""

import contextlib
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from melspec_gpt_vqvae_tpu import serving as JSV
from melspec_gpt_vqvae_tpu.configs import load_preset as j_load_preset
from melspec_gpt_vqvae_tpu.configs import parse_overrides as j_overrides
from melspec_gpt_vqvae_tpu.training.checkpoint import \
    CheckpointManager as JCheckpointManager
from melspec_gpt_vqvae_tpu.training.gpt_task import GPTTask as JGPTTask
from melspec_gpt_vqvae_tpu_torch import bridge
from melspec_gpt_vqvae_tpu_torch import serving as TSV
from melspec_gpt_vqvae_tpu_torch.training.checkpoint import CheckpointManager
from melspec_gpt_vqvae_tpu_torch.training.gpt_task import GPTTask
from melspec_gpt_vqvae_tpu_torch.training.optim import named_leaves

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SMALL = "n_layer=1,n_head=2,n_embd=32"


def _script():
    spec = importlib.util.spec_from_file_location(
        "torch_convert_orbax", ROOT / "scripts" / "torch_convert_orbax.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tiny_melgan(d: Path, seed=0):
    """A reference-format MelGAN log dir at 80 mel channels, ngf 2 and one
    resblock a stage (a cheap vocoder beside the VAS VQ-VAE)."""
    rng = np.random.default_rng(seed)
    sd, ch, idx = {}, 32, 2

    def wn(name, *shape, out=None):
        sd[f"{name}.weight_v"] = rng.standard_normal(shape) \
            .astype(np.float32)
        sd[f"{name}.weight_g"] = rng.uniform(
            0.5, 1.5, (shape[0], 1, 1)).astype(np.float32)
        sd[f"{name}.bias"] = (0.1 * rng.standard_normal(out or shape[0])) \
            .astype(np.float32)
    wn("model.1", ch, 80, 7)
    for r in (8, 8, 2, 2):
        idx += 1
        wn(f"model.{idx}", ch, ch // 2, 2 * r, out=ch // 2)
        idx += 1
        ch //= 2
        wn(f"model.{idx}.block.2", ch, ch, 3)
        wn(f"model.{idx}.block.4", ch, ch, 1)
        wn(f"model.{idx}.shortcut", ch, ch, 1)
        idx += 1
    wn(f"model.{idx + 2}", 1, ch, 7)
    d.mkdir(parents=True, exist_ok=True)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
               str(d / "best_netG.pt"))
    (d / "args.yml").write_text("!!python/object:argparse.Namespace\n"
                                "n_mel_channels: 80\nn_residual_layers: 1\n"
                                "ngf: 2\nseq_len: 8192\n")
    return str(d)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A JAX run ``jrun`` (orbax, one AdamW step, saved at epoch 2 with a
    metric, so both ``last`` and ``best`` exist) and its conversion
    ``trun``; returns (the run root, the JAX state)."""
    root = tmp_path_factory.mktemp("runs")
    exp = j_load_preset("GPT", "vas", **j_overrides(SMALL))
    task = JGPTTask(exp, use_pallas=False)
    state = task.init_state(5)
    rng = np.random.default_rng(0)
    batch = {"codes": rng.integers(0, 128, (8, 5, 53)).astype(np.int32),
             "target": rng.integers(0, exp.model.class_size, (8,))
             .astype(np.int32)}
    state, _ = task.train_step(state, batch, jax.random.PRNGKey(1))
    ckpt = JCheckpointManager(str(root / "lightning_logs" / "jrun-vas" /
                                  "checkpoints" / "version_0"))
    ckpt.save({"state": state, "epoch": 2}, step=1, metric=4.5)
    ckpt.wait()
    with contextlib.chdir(root):
        written = _script().main(["gpt", "--experiment", "jrun",
                                  "--out_experiment", "trun",
                                  "--override", SMALL])
    assert sorted(Path(p).name for p in written) == ["best.pt", "last.pt"]
    return root, state


def test_converted_run_restores_the_jax_params(run):
    """The port's _restore_gpt_params on the converted run equals the JAX
    package's on the orbax run, leaf for leaf and exactly, for both
    checkpoints."""
    root, _ = run
    jexp = j_load_preset("GPT", "vas", **j_overrides(SMALL))
    texp = bridge.config_from_jax(jexp)
    with contextlib.chdir(root):
        for which in ("last", "best"):
            ref, ref_epoch = JSV._restore_gpt_params(jexp, "vas", "jrun",
                                                     which, 783435)
            got, epoch = TSV._restore_gpt_params(texp, "vas", "trun", which)
            assert epoch == ref_epoch == 2
            ref = bridge.gpt_params_from_jax(
                jax.tree_util.tree_map(np.asarray, ref))
            names = dict(named_leaves(ref))
            assert names.keys() == dict(named_leaves(got)).keys()
            for name, t in named_leaves(got):
                assert torch.equal(t, names[name]), name


def test_converted_run_is_a_port_train_state(run):
    """The port's CheckpointManager takes the whole converted train state
    against GPTTask.state_template (what train_gpt --resume does), with the
    AdamW moments, count, learning rate and step of the JAX state."""
    root, state = run
    texp = bridge.config_from_jax(
        j_load_preset("GPT", "vas", **j_overrides(SMALL)))
    ckpt = CheckpointManager(str(root / "lightning_logs" / "trun-vas" /
                                 "checkpoints" / "version_0"))
    out = ckpt.restore("last", template={
        "state": GPTTask(texp, "cpu").state_template(), "epoch": 0})
    assert out["epoch"] == 2 and ckpt.meta["best_metric"] == 4.5
    ref = bridge.train_state_from_jax(
        jax.tree_util.tree_map(np.asarray, state["params"]),
        state["opt_state"], state["step"])
    assert (out["state"]["count"], out["state"]["step"]) == (1, 1)
    assert out["state"]["lr"] == ref["lr"]
    for part in ("params", "mu", "nu"):
        got = dict(named_leaves(out["state"][part]))
        for name, t in named_leaves(ref[part]):
            assert torch.equal(got[name], t), (part, name)
    assert float(got["blocks/mlp_up/w"].abs().max()) > 0   # nu after a step
    GPTTask(texp, "cpu").load_state(out["state"])


_FLAX_NAMES = {"norm1": "GroupNorm_0", "norm2": "GroupNorm_1",
               "conv1": "Conv_0", "conv2": "Conv_1"}


def flax_tree(module):
    """A port conv net's weights as the JAX package's flax tree (the
    inverse of bridge.conv_state_dict), numpy leaves."""
    mods = dict(module.named_modules())
    tree = {}
    for name, t in module.state_dict().items():
        *path, leaf = name.split(".")
        x = t.detach().numpy()
        if leaf == "weight":
            if isinstance(mods[".".join(path)], torch.nn.GroupNorm):
                leaf = "scale"
            else:
                leaf = "kernel"
                x = x.transpose(2, 3, 1, 0) if x.ndim == 4 \
                    else x.transpose(2, 1, 0)
        node = tree
        for p in path:
            node = node.setdefault(_FLAX_NAMES.get(p, p), {})
        node[leaf] = x
    return tree


def test_build_pipeline_serves_the_run(run):
    """build_pipeline(experiment=) against build_pipeline(params=) on the
    same weights (the JAX package's restored params, the same VQ-VAE and
    the same reference-format MelGAN): greedy tokens equal, spectrogram
    and waveform of a clip bit for bit."""
    root, _ = run
    voc = tiny_melgan(root / "melgan")
    jexp = j_load_preset("GPT", "vas", **j_overrides(SMALL))
    with contextlib.chdir(root):
        exp, pipe = TSV.build_pipeline("vas", experiment="trun",
                                       resume="last", override=SMALL,
                                       vocoder_ckpt=voc, device="cpu")
        jparams, _ = JSV._restore_gpt_params(jexp, "vas", "jrun", "last",
                                             783435)
    vq_tree = flax_tree(pipe.vq)
    assert bridge.conv_state_dict(vq_tree).keys() == \
        pipe.vq.state_dict().keys()
    _, ref = TSV.build_pipeline(
        "vas", params={"gpt": jax.tree_util.tree_map(np.asarray, jparams),
                       "vqvae": vq_tree},
        override=SMALL, vocoder_ckpt=voc, device="cpu")
    assert exp.vocoder.ngf == 2 and exp.model.n_layer == 1
    toks, _ = pipe.generate_tokens([0, 5, 3], None, sample=False)
    ref_toks, _ = ref.generate_tokens([0, 5, 3], None, sample=False)
    torch.testing.assert_close(toks, ref_toks, rtol=0, atol=0)
    specs, ref_specs = pipe.decode_specs(toks[:1]), ref.decode_specs(toks[:1])
    assert torch.equal(specs, ref_specs)
    assert torch.equal(pipe.vocode(specs), ref.vocode(ref_specs))


def test_build_pipeline_refuses_another_geometry(run):
    root, _ = run
    with contextlib.chdir(root), pytest.raises(ValueError,
                                               match="--override"):
        TSV.build_pipeline("vas", experiment="trun", device="cpu",
                           override="n_layer=2,n_head=2,n_embd=32")
    with contextlib.chdir(root), pytest.raises(FileNotFoundError):
        TSV.build_pipeline("vas", experiment="nope", device="cpu",
                           override=SMALL)


def test_draft_from_a_run_checkpoint(run):
    """draft_experiment reads the draft from a run (here the target's own,
    at draft_resume): as its own draft, greedy decoding accepts every
    proposal and gives the plain pipeline's tokens."""
    root, _ = run
    with contextlib.chdir(root):
        exp, spec = TSV.build_pipeline(
            "vas", experiment="trun", resume="last", override=SMALL,
            draft_experiment="trun", draft_resume="best", gamma=4,
            kv_cache="int8", device="cpu")
        _, plain = TSV.build_pipeline("vas", experiment="trun",
                                      resume="last", override=SMALL,
                                      kv_cache="int8", device="cpu")
    assert spec.draft_cfg.n_layer == 1 and spec.draft_cfg.cache_dtype == "int8"
    toks, stats = spec.generate_tokens([3], None, sample=False)
    ref, _ = plain.generate_tokens([3], None, sample=False)
    torch.testing.assert_close(toks, ref, rtol=0, atol=0)
    assert stats["rounds"] > 0 and stats["accepted"] == stats["drafted"]
