"""PyTorch port, utils/convert.py: reference-format checkpoints loaded by
both packages.

Hand-built state dicts in the reference's layouts (numpy, fixed seeds) --
a tiny VQ-VAE with one attention resolution, a tiny MelGAN with
weight-norm pairs and its ``args.yml`` (an ``argparse.Namespace`` dump),
a 2-layer minGPT with ``embedder.weight`` -- are written to files and
loaded through melspec_gpt_vqvae_tpu.utils.convert and the port's
converters; the models built from them must agree: codes and greedy
tokens exactly, 1e-5 elsewhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from melspec_gpt_vqvae_tpu.configs import GPTConfig as JGPTConfig
from melspec_gpt_vqvae_tpu.configs import VQVAEConfig as JVQVAEConfig
from melspec_gpt_vqvae_tpu.models import gpt as JG
from melspec_gpt_vqvae_tpu.models.vocoder import MelGANGenerator as JMelGAN
from melspec_gpt_vqvae_tpu.models.vqvae import VQModel as JVQModel
from melspec_gpt_vqvae_tpu.utils import convert as JC
from melspec_gpt_vqvae_tpu_torch import bridge
from melspec_gpt_vqvae_tpu_torch.models import gpt as TG
from melspec_gpt_vqvae_tpu_torch.utils import convert as TC

torch.set_num_threads(1)


def _f32(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


# --------------------------- VQ-VAE ------------------------------------------

VQ_CFG = dict(num_embeddings=8, embedding_dim=4, ch=32, ch_mult=(1, 2),
              num_res_blocks=1, attn_resolutions=(8,), resolution=16,
              z_channels=4)


def vqvae_state_dict(seed=4):
    """The reference LitVQVAE names (big_model_attn_gan.py) of the tiny
    config: level 0 at resolution 16, level 1 at 8 with attention."""
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(name, o, i, k):
        sd[f"{name}.weight"] = _f32(rng, o, i, k, k, scale=(i * k * k) ** -0.5)
        sd[f"{name}.bias"] = _f32(rng, o, scale=0.1)

    def gn(name, c):
        sd[f"{name}.weight"] = 1.0 + _f32(rng, c, scale=0.1)
        sd[f"{name}.bias"] = _f32(rng, c, scale=0.1)

    def res(prefix, cin, cout):
        gn(f"{prefix}.norm1", cin)
        conv(f"{prefix}.conv1", cout, cin, 3)
        gn(f"{prefix}.norm2", cout)
        conv(f"{prefix}.conv2", cout, cout, 3)
        if cin != cout:
            conv(f"{prefix}.nin_shortcut", cout, cin, 1)

    def attn(prefix, c):
        gn(f"{prefix}.norm", c)
        for nm in ("q", "k", "v", "proj_out"):
            conv(f"{prefix}.{nm}", c, c, 1)

    conv("_encoder.conv_in", 32, 1, 3)
    res("_encoder.down.0.block.0", 32, 32)
    conv("_encoder.down.0.downsample.conv", 32, 32, 3)
    res("_encoder.down.1.block.0", 32, 64)
    attn("_encoder.down.1.attn.0", 64)
    res("_encoder.mid.block_1", 64, 64)
    attn("_encoder.mid.attn_1", 64)
    res("_encoder.mid.block_2", 64, 64)
    gn("_encoder.norm_out", 64)
    conv("_encoder.conv_out", 4, 64, 3)
    conv("_decoder.conv_in", 64, 4, 3)
    res("_decoder.mid.block_1", 64, 64)
    attn("_decoder.mid.attn_1", 64)
    res("_decoder.mid.block_2", 64, 64)
    res("_decoder.up.1.block.0", 64, 64)
    attn("_decoder.up.1.attn.0", 64)
    res("_decoder.up.1.block.1", 64, 64)
    attn("_decoder.up.1.attn.1", 64)
    conv("_decoder.up.1.upsample.conv", 64, 64, 3)
    res("_decoder.up.0.block.0", 64, 32)
    res("_decoder.up.0.block.1", 32, 32)
    gn("_decoder.norm_out", 32)
    conv("_decoder.conv_out", 1, 32, 3)
    sd["_vq_vae._embedding.weight"] = _f32(rng, 8, 4)
    conv("quant_conv", 4, 4, 1)
    conv("post_quant_conv", 4, 4, 1)
    # what an inference load leaves out: the discriminator, the loss
    sd["_discriminator.main.0.weight"] = _f32(rng, 8, 1, 4, 4)
    return sd


def _save(tmp_path, name, sd):
    path = str(tmp_path / name)
    torch.save({"state_dict": {k: torch.from_numpy(v)
                               for k, v in sd.items()}}, path)
    return path


def test_vqvae_checkpoint_matches_jax(tmp_path):
    """decode_code on the same codes within 1e-5, encode_to_indices codes
    exactly."""
    path = _save(tmp_path, "vqvae.ckpt", vqvae_state_dict())
    jcfg = JVQVAEConfig(**VQ_CFG)
    jparams = JC.load_vqvae_params(path, jcfg)
    model = TC.load_vqvae_params(path, bridge.config_from_jax(jcfg))
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 8, (2, 8, 8)).astype(np.int32)
    x = rng.uniform(-1, 1, (2, 16, 16, 1)).astype(np.float32)
    jvq = JVQModel(jcfg)
    jp = jax.tree_util.tree_map(jnp.asarray, jparams)
    ref_dec = np.asarray(jvq.apply({"params": jp}, jnp.asarray(codes),
                                   method="decode_code"))
    ref_idx = np.asarray(jvq.apply({"params": jp}, jnp.asarray(x),
                                   method="encode_to_indices"))
    with torch.no_grad():
        dec = model.decode_code(torch.from_numpy(codes)).numpy()
        idx = model.encode_to_indices(torch.from_numpy(x)).numpy()
    assert dec.shape == ref_dec.shape == (2, 16, 16, 1)
    np.testing.assert_allclose(dec, ref_dec, atol=1e-5)
    np.testing.assert_array_equal(idx, ref_idx)


def test_vqvae_checkpoint_lacking_tensors_is_refused(tmp_path):
    sd = vqvae_state_dict()
    del sd["_decoder.up.1.attn.1.norm.weight"]
    path = _save(tmp_path, "vqvae.ckpt", sd)
    cfg = bridge.config_from_jax(JVQVAEConfig(**VQ_CFG))
    with pytest.raises(ValueError, match="attn.1.norm.weight"):
        TC.load_vqvae_params(path, cfg)


# --------------------------- MelGAN -------------------------------------------

VOC = dict(n_mel_channels=4, ngf=4, n_residual_layers=2)


def melgan_dir(tmp_path, seed=6):
    """best_netG.pt in the reference Generator's Sequential layout, every
    conv weight-normed (weight_g, weight_v), and its args.yml."""
    rng = np.random.default_rng(seed)
    sd = {}

    def wn(idx, *shape):
        sd[f"{idx}.weight_v"] = _f32(rng, *shape)
        sd[f"{idx}.weight_g"] = rng.uniform(0.5, 1.5, (shape[0], 1, 1)) \
            .astype(np.float32)
        sd[f"{idx}.bias"] = _f32(rng, shape[1] if "up" in idx else shape[0],
                                 scale=0.1)

    ch = 16 * VOC["ngf"]
    wn("model.1", ch, VOC["n_mel_channels"], 7)
    idx = 2
    for r in (8, 8, 2, 2):
        idx += 1
        # ConvTranspose1d weights are (in, out, k); the bias is out's
        sd[f"model.{idx}.weight_v"] = _f32(rng, ch, ch // 2, 2 * r)
        sd[f"model.{idx}.weight_g"] = rng.uniform(0.5, 1.5, (ch, 1, 1)) \
            .astype(np.float32)
        sd[f"model.{idx}.bias"] = _f32(rng, ch // 2, scale=0.1)
        idx += 1
        ch //= 2
        for _ in range(VOC["n_residual_layers"]):
            wn(f"model.{idx}.block.2", ch, ch, 3)
            wn(f"model.{idx}.block.4", ch, ch, 1)
            wn(f"model.{idx}.shortcut", ch, ch, 1)
            idx += 1
    wn(f"model.{idx + 2}", 1, ch, 7)
    d = tmp_path / "melgan"
    d.mkdir()
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
               str(d / "best_netG.pt"))
    (d / "args.yml").write_text(
        "!!python/object:argparse.Namespace\n"
        "augment: true\nbatch_size: 16\ncond_disc: false\n"
        "data_path: ./data/features/\nepochs: 3000\nlog_interval: 100\n"
        "n_layers_D: 4\n"
        f"n_mel_channels: {VOC['n_mel_channels']}\n"
        f"n_residual_layers: {VOC['n_residual_layers']}\n"
        f"ngf: {VOC['ngf']}\nndf: 16\nnum_D: 3\nsave_path: logs/vas\n"
        "seq_len: 8192\n")
    return str(d)


def test_melgan_checkpoint_matches_jax(tmp_path):
    """The generator's forward on the same mel within 1e-5, and the
    geometry read from args.yml without a YAML parser."""
    path = melgan_dir(tmp_path)
    jparams, jcfg = JC.load_vocoder_params(path)
    model, cfg = TC.load_vocoder_params(path)
    assert (cfg.n_mel_channels, cfg.ngf, cfg.n_residual_layers) == (
        jcfg.n_mel_channels, jcfg.ngf, jcfg.n_residual_layers) == (4, 4, 2)
    mel = np.random.default_rng(7).uniform(0, 1, (2, 6, 4)) \
        .astype(np.float32)
    ref = np.asarray(JMelGAN(jcfg).apply(
        {"params": jax.tree_util.tree_map(jnp.asarray, jparams)},
        jnp.asarray(mel)))
    with torch.no_grad():
        out = model(torch.from_numpy(mel)).numpy()
    assert out.shape == (2, 6 * 256)
    np.testing.assert_allclose(out, ref.reshape(out.shape), atol=1e-5)


def test_fold_weight_norm_matches_torch():
    rng = np.random.default_rng(2)
    for conv in (torch.nn.Conv1d(4, 6, 3),
                 torch.nn.ConvTranspose1d(6, 3, 8)):
        conv = torch.nn.utils.weight_norm(conv)
        with torch.no_grad():
            conv.weight_v.copy_(torch.from_numpy(
                _f32(rng, *conv.weight_v.shape)))
            conv.weight_g.copy_(torch.from_numpy(rng.uniform(
                0.5, 2.0, conv.weight_g.shape).astype(np.float32)))
        sd = {f"m.{k}": v.detach() for k, v in conv.state_dict().items()}
        folded = TC._fold_weight_norm(sd, "m")
        conv(torch.zeros(1, conv.in_channels, 8))   # recompute the weight
        torch.testing.assert_close(folded, conv.weight.detach(), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("loader", ["vqvae", "vocoder"])
def test_orbax_directory_is_refused(tmp_path, loader):
    """The port reads no orbax: a directory (what the JAX package's own
    checkpoints are) raises and names the conversion script."""
    d = tmp_path / "orbax_params"
    d.mkdir()
    (d / "_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="torch_convert_orbax.py"):
        if loader == "vqvae":
            TC.load_vqvae_params(str(d), bridge.config_from_jax(
                JVQVAEConfig(**VQ_CFG)))
        else:
            TC.load_vocoder_params(str(d))


def test_files_in_the_ports_own_names_load(tmp_path):
    """What scripts/torch_convert_orbax.py writes -- the port's own state
    dict -- loads as it is: the VQ-VAE file and the MelGAN directory."""
    cfg = bridge.config_from_jax(JVQVAEConfig(**VQ_CFG))
    vq = TC.load_vqvae_params(
        _save(tmp_path, "vqvae.ckpt", vqvae_state_dict()), cfg)
    torch.save(vq.state_dict(), str(tmp_path / "vq_port.pt"))
    again = TC.load_vqvae_params(str(tmp_path / "vq_port.pt"), cfg)
    for k, v in vq.state_dict().items():
        assert torch.equal(v, again.state_dict()[k]), k
    voc, vcfg = TC.load_vocoder_params(melgan_dir(tmp_path))
    d = tmp_path / "voc_port"
    d.mkdir()
    torch.save(voc.state_dict(), str(d / "best_netG.pt"))
    (d / "args.yml").write_text("n_mel_channels: 4\nngf: 4\n"
                                "n_residual_layers: 2\n")
    voc2, _ = TC.load_vocoder_params(str(d))
    for k, v in voc.state_dict().items():
        assert torch.equal(v, voc2.state_dict()[k]), k


# --------------------------- minGPT -------------------------------------------

D, L, V, T, C = 16, 2, 11, 10, 3


def mingpt_state_dict(seed=3):
    rng = np.random.default_rng(seed)
    sd = {"transformer.tok_emb.weight": _f32(rng, V, D),
          "transformer.pos_emb": _f32(rng, 1, T, D, scale=0.1)}
    for i in range(L):
        pre = f"transformer.blocks.{i}"
        for nm in ("ln1", "ln2"):
            sd[f"{pre}.{nm}.weight"] = 1.0 + _f32(rng, D, scale=0.1)
            sd[f"{pre}.{nm}.bias"] = _f32(rng, D, scale=0.1)
        for nm in ("query", "key", "value", "proj"):
            sd[f"{pre}.attn.{nm}.weight"] = _f32(rng, D, D, scale=0.3)
            sd[f"{pre}.attn.{nm}.bias"] = _f32(rng, D, scale=0.1)
        sd[f"{pre}.mlp.0.weight"] = _f32(rng, 4 * D, D, scale=0.3)
        sd[f"{pre}.mlp.0.bias"] = _f32(rng, 4 * D, scale=0.1)
        sd[f"{pre}.mlp.2.weight"] = _f32(rng, D, 4 * D, scale=0.3)
        sd[f"{pre}.mlp.2.bias"] = _f32(rng, D, scale=0.1)
    sd["transformer.ln_f.weight"] = 1.0 + _f32(rng, D, scale=0.1)
    sd["transformer.ln_f.bias"] = _f32(rng, D, scale=0.1)
    sd["transformer.head.weight"] = _f32(rng, V, D, scale=0.5)
    sd["transformer.embedder.weight"] = _f32(rng, C, D)
    return sd


def test_gpt_checkpoint_matches_jax(tmp_path):
    """A Lightning minGPT checkpoint: logits within 1e-5, greedy tokens
    exactly."""
    path = _save(tmp_path, "gpt.ckpt", mingpt_state_dict())
    jp = jax.tree_util.tree_map(jnp.asarray, JC.convert_gpt_state_dict(
        JC._load_torch_state_dict(path), n_layer=L))
    tp = TC.convert_gpt_state_dict(TC._load_torch_state_dict(path), L)
    jcfg = JGPTConfig(vocab_size=V, block_size=T, n_layer=L, n_head=2,
                      n_embd=D, class_size=C)
    cfg = bridge.config_from_jax(jcfg)
    assert tp["blocks"]["attn_qkv"]["w"].shape == (L, D, 3 * D)
    assert tp["head"]["w"].shape == (D, V) and "class_emb" in tp
    x = np.random.default_rng(8).integers(0, V, (2, 6))
    cls = np.asarray([0, 2])
    ref, _ = JG.gpt_apply(jp, jcfg, jnp.asarray(x),
                          JG.class_embed(jp, jnp.asarray(cls)),
                          use_pallas=False)
    with torch.no_grad():
        logits = TG.gpt_apply(tp, cfg, torch.from_numpy(x),
                              TG.class_embed(tp, torch.from_numpy(cls)))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), atol=1e-5)
    ref_tok = JG.gpt_generate(jp, jcfg, jax.random.PRNGKey(0),
                              JG.class_embed(jp, jnp.asarray(cls)),
                              steps=T - 1, sample=False, use_pallas=False)
    with torch.no_grad():
        tok = TG.gpt_generate(tp, cfg, None,
                              TG.class_embed(tp, torch.from_numpy(cls)),
                              steps=T - 1, sample=False)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))
