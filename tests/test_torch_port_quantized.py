"""PyTorch port: the int8 decode stage (ops/quant.py, models/quantized.py)
against the JAX package on the CPU.

The same numpy inputs and flax-initialised weights (carried across by
bridge.py) go through both packages.  The integer sums of the int8
convolution, the quantised weights and activations are held exactly; the
polyphase rewrite to 1e-5; the float mirrors to 1e-6 against the port's
own modules (tests/test_quantized.py pins the JAX mirrors to flax so) and
to 1e-5 against the JAX mirrors; calibration covers the same convs with
the same scales; the int8 stage stays above 20 dB SNR, as the JAX tests
ask.  Conv names map as bridge.py maps weights (``Conv_0`` -> ``conv1``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from melspec_gpt_vqvae_tpu.configs import VocoderConfig, VQVAEConfig
from melspec_gpt_vqvae_tpu.models import quantized as JQ
from melspec_gpt_vqvae_tpu.models.vocoder import MelGANGenerator as JMelGAN
from melspec_gpt_vqvae_tpu.models.vqvae import VQModel as JVQModel
from melspec_gpt_vqvae_tpu.ops import quant as JQO
from melspec_gpt_vqvae_tpu_torch import bridge
from melspec_gpt_vqvae_tpu_torch import pipeline as TP
from melspec_gpt_vqvae_tpu_torch.models import quantized as TQ
from melspec_gpt_vqvae_tpu_torch.ops import quant as TQO

torch.set_num_threads(1)


def snr_db(ref, x):
    ref, x = np.asarray(ref, np.float32), np.asarray(x, np.float32)
    return float(10 * np.log10(np.mean(ref ** 2)
                               / max(float(np.mean((x - ref) ** 2)), 1e-20)))


def port_path(path: str) -> str:
    """A JAX conv path in the port's module names (bridge._RENAME)."""
    return "/".join(bridge._RENAME.get(p, p) for p in path.split("/"))


@pytest.fixture(scope="module")
def tiny():
    """tests/test_quantized.py's geometry (attention at the mid
    resolution, two resblocks a vocoder stage), flax weights in both
    packages, and a batch of code grids."""
    vq = VQVAEConfig(num_embeddings=16, embedding_dim=8, ch=8,
                     ch_mult=(1, 2), num_res_blocks=1,
                     attn_resolutions=(4,), z_channels=8, resolution=8,
                     code_h=2, code_w=4)
    voc = VocoderConfig(n_mel_channels=4, ngf=4, n_residual_layers=2,
                        ratios=(2, 2))
    vq_params = JVQModel(vq).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 4, 8, 1)))["params"]
    voc_params = JMelGAN(voc).init(
        jax.random.PRNGKey(2), jnp.zeros((1, 8, 4)))["params"]
    vq_params = jax.tree_util.tree_map(np.asarray, vq_params)
    voc_params = jax.tree_util.tree_map(np.asarray, voc_params)
    tvq, tvoc = bridge.config_from_jax(vq), bridge.config_from_jax(voc)
    tvq_m = bridge.load_vqvae(vq_params, tvq)
    tvoc_m = bridge.load_melgan(voc_params, tvoc)
    grid = np.random.default_rng(0).integers(0, 16, (3, 2, 4))
    return dict(vq=vq, voc=voc, vq_params=vq_params, voc_params=voc_params,
                tvq=tvq, tvoc=tvoc, tvq_m=tvq_m, tvoc_m=tvoc_m, grid=grid)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


# ------------------------------ ops/quant.py ---------------------------------

def test_quantize_weight_matches_jax():
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((3, 3, 8, 16))
         * rng.uniform(0.01, 2.0, (1, 1, 1, 16))).astype(np.float32)  # HWIO
    jw8, js = JQO.quantize_weight(jnp.asarray(w))
    tw8, ts = TQO.quantize_weight(_t(w).permute(3, 2, 0, 1))          # OIHW
    assert tw8.dtype == torch.int8 and ts.shape == (16,)
    np.testing.assert_array_equal(tw8.permute(2, 3, 1, 0).numpy(),
                                  np.asarray(jw8))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    err = np.abs(tw8.float().numpy() * ts.numpy()[:, None, None, None]
                 - w.transpose(3, 2, 0, 1))
    assert (err <= 0.5 * ts.numpy()[:, None, None, None] + 1e-7).all()


def test_quantize_act_matches_jax():
    x = np.asarray([-10.0, -0.5, 0.0, 0.5, 10.0, 0.125, -0.135], np.float32)
    ref = JQO.quantize_act(jnp.asarray(x), jnp.float32(0.01))
    out = TQO.quantize_act(_t(x), torch.tensor(0.01))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(out.numpy()[:5], [-127, -50, 0, 50, 127])


# (kernel shape OIHW / OIW, stride, padding, dilation, input spatial):
# the decoder's 3x3 and 1x1, the encoder's stride-2 downsample, the
# vocoder's kernel-7 stem and dilated kernel-3, and a one-channel output
CONVS = [
    ((5, 4, 3, 3), None, 1, None, (6, 9)),
    ((6, 4, 1, 1), None, 0, None, (6, 9)),
    ((4, 4, 3, 3), (2, 2), 0, None, (7, 10)),
    ((8, 4, 7), None, 0, None, (19,)),
    ((4, 4, 3), None, 0, (9,), (30,)),
    ((1, 4, 7), None, 0, None, (16,)),
]


@pytest.mark.parametrize("shape, stride, padding, dilation, spatial", CONVS)
def test_conv_int8_integer_sums_equal_jax(shape, stride, padding, dilation,
                                          spatial):
    """torch._int_mm over the unfolded windows gives the JAX package's
    int32 convolution exactly, and the dequantised output its float32
    arithmetic."""
    rng = np.random.default_rng(sum(shape))
    n_sp = len(spatial)
    x = rng.standard_normal((2, shape[1]) + spatial).astype(np.float32)
    w = (rng.standard_normal(shape) / 3).astype(np.float32)
    b = rng.standard_normal(shape[0]).astype(np.float32)
    s_x = np.float32(np.abs(x).max() / 127)
    to_last = (0, *range(2, 2 + n_sp), 1)            # NC.. -> N..C
    w_jax = w.transpose(*range(2, 2 + n_sp), 1, 0)   # OI.. -> ..IO
    jw8, jsw = JQO.quantize_weight(jnp.asarray(w_jax))
    tw8, tsw = TQO.quantize_weight(_t(w))
    x8 = JQO.quantize_act(jnp.asarray(x.transpose(to_last)), s_x)
    pad = [(padding, padding)] * n_sp
    dn = lax.conv_dimension_numbers(x8.shape, jw8.shape,
                                    JQO._dimension_numbers(n_sp))
    ref = lax.conv_general_dilated(
        x8, jw8, stride or (1,) * n_sp, pad, rhs_dilation=dilation,
        dimension_numbers=dn, preferred_element_type=jnp.int32)
    acc = TQO._conv_int32(TQO.quantize_act(_t(x), torch.tensor(s_x)), tw8,
                          stride, padding, dilation)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.permute(*to_last).numpy(),
                                  np.asarray(ref))
    y_ref = JQO.conv_int8(jnp.asarray(x.transpose(to_last)), jw8, jsw,
                          jnp.asarray(b), s_x, strides=stride, padding=pad,
                          dilation=dilation)
    y = TQO.conv_int8(_t(x), tw8, tsw, _t(b), torch.tensor(s_x),
                      stride=stride, padding=padding, dilation=dilation)
    np.testing.assert_allclose(y.permute(*to_last).numpy(),
                               np.asarray(y_ref), rtol=1e-6, atol=1e-6)


def test_int8_conv_matches_float_for_exact_grids():
    """Values exactly on the int8 grid: the int8 conv equals the float
    conv on the dequantised weights to rounding (tests/test_quantized.py's
    check, on the port)."""
    rng = np.random.default_rng(4)
    s_x = torch.tensor(0.25)
    x = torch.from_numpy(rng.integers(-100, 100, (2, 4, 6, 9))).float() * s_x
    w = torch.from_numpy(rng.integers(-100, 100, (5, 4, 3, 3))).float() / 127
    b = torch.from_numpy(rng.standard_normal(5).astype(np.float32))
    w8, s_w = TQO.quantize_weight(w)
    y_f = TQO.conv_float(x, w8.float() * s_w[:, None, None, None], b,
                         padding=1)
    y_q = TQO.conv_int8(x, w8, s_w, b, s_x, padding=1)
    torch.testing.assert_close(y_q, y_f, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("r", [2, 3, 8])
def test_polyphase_matches_jax_and_conv_transpose(r):
    """The polyphase kernel is the JAX package's (permuted), and the
    rewrite equals torch's ConvTranspose1d with the module's crop."""
    rng = np.random.default_rng(r)
    ci, co, t = 6, 5, 7
    wf = rng.standard_normal((2 * r, co, ci)).astype(np.float32)   # flax
    w = _t(wf).permute(2, 1, 0).contiguous()                       # (I,O,k)
    np.testing.assert_array_equal(
        TQO.polyphase_from_transpose(w, r).permute(2, 1, 0).numpy(),
        np.asarray(JQO.polyphase_from_transpose(jnp.asarray(wf), r)))
    x = rng.standard_normal((2, ci, t)).astype(np.float32)
    bias = rng.standard_normal(co).astype(np.float32)
    mod = torch.nn.ConvTranspose1d(ci, co, 2 * r, stride=r,
                                   padding=r // 2 + r % 2,
                                   output_padding=r % 2)
    with torch.no_grad():
        mod.weight.copy_(w)
        mod.bias.copy_(_t(bias))
        ref = mod(_t(x))
        out = TQO.conv_transpose_polyphase(_t(x), w, _t(bias), r)
    assert out.shape == ref.shape == (2, co, t * r)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    jref = JQO.conv_transpose_polyphase(jnp.asarray(x.transpose(0, 2, 1)),
                                        jnp.asarray(wf), jnp.asarray(bias), r)
    np.testing.assert_allclose(out.permute(0, 2, 1).numpy(), np.asarray(jref),
                               rtol=1e-5, atol=1e-5)


# ------------------------------ models/quantized.py ---------------------------

@torch.no_grad()
def test_float_mirror_matches_the_decoder(tiny):
    g = torch.from_numpy(tiny["grid"])
    out = TQ.decode_code_apply(tiny["tvq_m"], tiny["tvq"], g, TQ.FloatConvs())
    torch.testing.assert_close(out, tiny["tvq_m"].decode_code(g),
                               rtol=1e-6, atol=1e-6)
    ref = JQ.decode_code_apply(tiny["vq_params"], tiny["vq"],
                               jnp.asarray(tiny["grid"]), JQ.FloatConvs())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("polyphase", [False, True])
@torch.no_grad()
def test_float_mirror_matches_the_vocoder(tiny, polyphase):
    mel = np.random.default_rng(5).uniform(0, 1, (3, 8, 4)).astype(
        np.float32)
    ex = TQ.FloatConvs()
    ex.polyphase_transpose = polyphase
    out = TQ.melgan_apply(tiny["tvoc_m"], tiny["tvoc"], _t(mel), ex)
    torch.testing.assert_close(out, tiny["tvoc_m"](_t(mel)), rtol=1e-6,
                               atol=1e-6)
    jex = JQ.FloatConvs()
    jex.polyphase_transpose = polyphase
    ref = JQ.melgan_apply(tiny["voc_params"], tiny["voc"], jnp.asarray(mel),
                          jex)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@torch.no_grad()
def test_float_mirror_matches_the_encoder(tiny):
    x = np.random.default_rng(8).uniform(-1, 1, (3, 4, 8, 1)).astype(
        np.float32)
    out = TQ.encode_to_indices_apply(tiny["tvq_m"], tiny["tvq"], _t(x),
                                     TQ.FloatConvs())
    np.testing.assert_array_equal(
        out.numpy(), tiny["tvq_m"].encode_to_indices(_t(x)).numpy())
    ref = JQ.encode_to_indices_apply(tiny["vq_params"], tiny["vq"],
                                     jnp.asarray(x), JQ.FloatConvs())
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("percentile", [1.0, 0.9999, 0.75])
def test_calibration_covers_the_same_convs_with_equal_scales(tiny,
                                                             percentile):
    ref = JQ.calibrate(tiny["vq_params"], tiny["voc_params"], tiny["vq"],
                       tiny["voc"], jnp.asarray(tiny["grid"]), batch=2,
                       percentile=percentile)
    acts = TQ.calibrate(tiny["tvq_m"], tiny["tvoc_m"], tiny["tvq"],
                        tiny["tvoc"], torch.from_numpy(tiny["grid"]),
                        batch=2, percentile=percentile)
    ref = {port_path(k): v for k, v in ref.items()}
    assert sorted(acts) == sorted(ref)
    assert "vq/decoder/mid_block_1/conv1" in acts
    assert "vq/decoder/up_1_upsample/conv1" in acts
    assert "voc/res_1_1/block_conv1" in acts and "voc/up_0" in acts
    assert not any("attn" in k or k.endswith("conv_out") for k in acts)
    for k in acts:
        np.testing.assert_allclose(acts[k], ref[k], rtol=1e-5, err_msg=k)


def test_quantile_matches_jnp_quantile():
    rng = np.random.default_rng(11)
    for n in (1, 2, 7, 1000, 12345):
        x = np.abs(rng.standard_normal(n)).astype(np.float32)
        for q in (1.0, 0.9999, 0.5, 0.0):
            np.testing.assert_allclose(
                float(TQ.quantile_linear(_t(x), q)),
                float(jnp.quantile(jnp.asarray(x), q)), rtol=1e-6)


def test_qstate_matches_jax(tiny):
    """The same calibration (the JAX package's seed gives the same grids)
    quantises every conv to the same int8 kernel and scales."""
    ref = JQ.build_qstate(tiny["vq_params"], tiny["voc_params"], tiny["vq"],
                          tiny["voc"], n_calib=8, batch=4)
    qs = TQ.build_qstate(tiny["tvq_m"], tiny["tvoc_m"], tiny["tvq"],
                         tiny["tvoc"], n_calib=8, batch=4)
    assert sorted(qs["w8"]) == sorted(port_path(k) for k in ref["w8"])
    for jk in ref["w8"]:
        k = port_path(jk)
        w8 = qs["w8"][k]
        perm = (*range(2, w8.ndim), 1, 0)     # OI.. -> ..IO
        np.testing.assert_array_equal(w8.permute(*perm).numpy(),
                                      np.asarray(ref["w8"][jk]), err_msg=k)
        np.testing.assert_array_equal(qs["ws"][k].numpy(),
                                      np.asarray(ref["ws"][jk]), err_msg=k)
        np.testing.assert_allclose(float(qs["acts"][k]),
                                   float(ref["acts"][jk]), rtol=1e-5,
                                   err_msg=k)
    assert qs["w8"]["voc/up_0"].shape[2] == 2      # polyphase width 2


@torch.no_grad()
def test_int8_decode_close_to_float_and_to_jax(tiny):
    qs = TQ.build_qstate(tiny["tvq_m"], tiny["tvoc_m"], tiny["tvq"],
                         tiny["tvoc"], n_calib=8, batch=4)
    jqs = JQ.build_qstate(tiny["vq_params"], tiny["voc_params"], tiny["vq"],
                          tiny["voc"], n_calib=8, batch=4)
    g = torch.from_numpy(tiny["grid"])
    spec_f = TQ.decode_code_apply(tiny["tvq_m"], tiny["tvq"], g,
                                  TQ.FloatConvs())
    spec_q = TQ.decode_code_apply(tiny["tvq_m"], tiny["tvq"], g,
                                  TQ.Int8Convs(qs))
    assert snr_db(spec_f, spec_q) > 20.0
    jspec_q = JQ.decode_code_apply(tiny["vq_params"], tiny["vq"],
                                   jnp.asarray(tiny["grid"]),
                                   JQ.Int8Convs(jqs))
    assert snr_db(jspec_q, spec_q) > 40.0
    mel = torch.clamp((spec_f[..., 0] + 1) / 2, 0, 1).transpose(1, 2)
    wav_f = TQ.melgan_apply(tiny["tvoc_m"], tiny["tvoc"], mel,
                            TQ.FloatConvs())
    wav_q = TQ.melgan_apply(tiny["tvoc_m"], tiny["tvoc"], mel,
                            TQ.Int8Convs(qs))
    assert snr_db(wav_f, wav_q) > 20.0
    jwav_q = JQ.melgan_apply(tiny["voc_params"], tiny["voc"],
                             jnp.asarray(mel.numpy()), JQ.Int8Convs(jqs))
    assert snr_db(jwav_q, wav_q) > 40.0


@torch.no_grad()
def test_int8_transpose_path(tiny):
    mel = _t(np.random.default_rng(6).uniform(0, 1, (3, 8, 4)).astype(
        np.float32))
    wav_f = TQ.melgan_apply(tiny["tvoc_m"], tiny["tvoc"], mel,
                            TQ.FloatConvs())
    qs = TQ.build_qstate(tiny["tvq_m"], tiny["tvoc_m"], tiny["tvq"],
                         tiny["tvoc"], n_calib=8, batch=4,
                         int8_transpose=True)
    assert "voc/up_0" in qs["w8"]
    wav_q = TQ.melgan_apply(tiny["tvoc_m"], tiny["tvoc"], mel,
                            TQ.Int8Convs(qs))
    assert snr_db(wav_f, wav_q) > 20.0
    qs0 = TQ.build_qstate(tiny["tvq_m"], tiny["tvoc_m"], tiny["tvq"],
                          tiny["tvoc"], n_calib=8, batch=4,
                          int8_transpose=False)
    assert "voc/up_0" not in qs0["w8"]
    wav0 = TQ.melgan_apply(tiny["tvoc_m"], tiny["tvoc"], mel,
                           TQ.Int8Convs(qs0))
    assert torch.isfinite(wav0).all()


@torch.no_grad()
def test_int8_encode_code_agreement(tiny):
    x = _t(np.random.default_rng(9).uniform(-1, 1, (8, 4, 8, 1)).astype(
        np.float32))
    qs = TQ.build_encode_qstate(tiny["tvq_m"], tiny["tvq"], x, batch=4)
    assert "vq/encoder/conv_in" in qs["w8"]
    assert "vq/encoder/down_0_downsample/conv1" in qs["w8"]
    idx_f = TQ.encode_to_indices_apply(tiny["tvq_m"], tiny["tvq"], x,
                                       TQ.FloatConvs())
    idx_q = TQ.encode_to_indices_apply(tiny["tvq_m"], tiny["tvq"], x,
                                       TQ.Int8Convs(qs))
    assert float((idx_f == idx_q).float().mean()) > 0.8


def test_pipeline_int8_decode_gives_the_float_pipelines_tokens(tiny):
    """GenerationPipeline(int8_decode=True): the same tokens as the float
    pipeline for one seed (the stage runs after them), its spectrograms
    within 20 dB of the float ones, as JAX tests/test_quantized.py:236-257
    holds its pipeline."""
    from melspec_gpt_vqvae_tpu_torch.configs import ExperimentConfig, \
        GPTConfig
    from melspec_gpt_vqvae_tpu_torch.models.gpt import init_gpt_params
    gpt = GPTConfig(vocab_size=16, block_size=9, n_layer=2, n_head=2,
                    n_embd=16, class_size=4)
    exp = dataclasses.replace(ExperimentConfig(model=gpt),
                              vqvae=tiny["tvq"], vocoder=tiny["tvoc"])
    params = init_gpt_params(gpt, torch.Generator().manual_seed(0))
    kw = dict(segments=2, chunk=3, bf16=False)
    pipe_f = TP.GenerationPipeline(exp, params, tiny["tvq_m"],
                                   tiny["tvoc_m"], **kw)
    pipe_q = TP.GenerationPipeline(exp, params, tiny["tvq_m"],
                                   tiny["tvoc_m"], int8_decode=True, **kw)
    assert pipe_q.qstate is not None and pipe_q.calibrate_seconds > 0
    cls = [0, 1, 2, 3]
    out_f = pipe_f.generate(cls, torch.Generator().manual_seed(7), top_k=5)
    out_q = pipe_q.generate(cls, torch.Generator().manual_seed(7), top_k=5)
    np.testing.assert_array_equal(out_f["tokens"], out_q["tokens"])
    assert out_q["specs"].shape == out_f["specs"].shape
    assert out_q["wavs"].shape == out_f["wavs"].shape
    assert np.isfinite(out_q["wavs"]).all()
    assert snr_db(out_f["specs"], out_q["specs"]) > 20.0
