"""Typed config system with per-(model, dataset) presets.

The port's own copy of ``melspec_gpt_vqvae_tpu/configs.py``: the same
dataclasses, fields, defaults and presets, so a config built for one
package converts field by field into the other's (``bridge.config_from_jax``)
and ``dataclasses.asdict`` of a preset is equal in both.  The port imports
nothing of the JAX package, so the classes here are distinct classes.

Capability parity with the reference's ``config/config_{model}_{dataset}.py``
``params`` dicts (see reference/config/config_GPT_vas.py:1-18,
config_GPT_VAE_vas.py:1-17, config_GPT_VAE_vggsound.py:56-70,
config_vas.py:1-13 for the preserved keys), but validated dataclasses instead
of namespace merging.  ``load_preset(model, dataset)`` mirrors the reference's
``importlib.import_module("config.config_%s_%s")`` lookup
(reference/GPT_train.py:63-66, GPT_VAE_train.py:102-105).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, NamedTuple, Optional


class LSTMConfig(NamedTuple):
    """Legacy LSTM-VAE geometry (reference: config/config_vas.py); the
    counterpart of melspec_gpt_vqvae_tpu/models/lstm_vae.py::LSTMConfig,
    which the port's models/lstm_vae.py reads from here."""
    vocab_size: int = 130          # 128 codes + <s> + </s>
    nz: int = 32
    ni: int = 512
    enc_nh: int = 1024
    dec_nh: int = 1024
    dec_dropout_in: float = 0.5
    dec_dropout_out: float = 0.5
    bos_id: int = 128
    eos_id: int = 129
    max_len: int = 265
    fix_var: float = -1.0


@dataclass(frozen=True)
class GPTConfig:
    """Transformer hyperparameters (reference: transformer/minGPT.py:30-41).

    ``n_unmasked`` widens the causal mask into a bidirectional window over the
    first ``n_unmasked`` positions (reference: minGPT.py:67-68); the GPT-VAE
    encoder sets it to the full block to run fully unmasked.
    ``last_linear`` overrides the output head width (used by the VAE encoder
    to emit ``2*n_embd`` for mean/logvar; reference: minGPT.py:143-149).
    """

    vocab_size: int
    block_size: int
    n_layer: int
    n_head: int
    n_embd: int
    embd_pdrop: float = 0.0
    resid_pdrop: float = 0.0
    attn_pdrop: float = 0.0
    n_unmasked: int = 0
    last_linear: Optional[int] = None
    class_size: Optional[int] = None  # class-conditional variant (GPTClass)
    # accelerator knobs (no reference equivalent):
    dtype: str = "float32"        # parameter dtype
    compute_dtype: str = "bfloat16"  # activation/matmul dtype
    remat: bool = False            # recompute each block in the backward
    remat_policy: str = "full"     # what remat SAVES per block: "full"
                                   # (nothing — replay everything), "attn"
                                   # (save attention outputs so the MLP
                                   # backward skips the attention replay),
                                   # "dots" (save all non-batch matmul
                                   # outputs — cheapest replay, most HBM)
    cache_dtype: str = "auto"     # KV cache: "auto" (= dtype), "int8", or
                                  # "int4" (nibble-packed, absmax/7)
                                  # (absmax per (layer,pos,head); halves the
                                  # cache traffic that dominates AR decode)
    decode_weight_dtype: str = "auto"  # "int8" streams absmax-quantised
                                  # block weights in AR decode (weights are
                                  # the other half of the decode read floor
                                  # at large batch); activations quantise
                                  # per-row so the int8 product applies
    mixed_precision: bool = False  # bf16 matmuls with f32 accumulation and
                                   # f32 residual stream (training speedup;
                                   # params stay in `dtype`)
    use_flash_train: bool = False  # fused attention kernel with its own
                                   # backward in training (dropout via an
                                   # explicit keep-mask)

    def __post_init__(self):
        if self.n_embd % self.n_head != 0:
            raise ValueError(
                f"n_embd={self.n_embd} must be divisible by n_head={self.n_head}")

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @property
    def output_size(self) -> int:
        return self.last_linear if self.last_linear is not None else self.vocab_size

    def replace(self, **kw) -> "GPTConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class MelConfig:
    """Mel-spectrogram frontend constants.

    Mirrors the invertible transform chain at
    reference/feature_extraction/extract_mel_spectrogram.py:141-151
    (librosa 0.8.1 semantics).
    """

    sample_rate: int = 22050
    n_fft: int = 1024
    hop_length: int = 256
    fmin: float = 125.0
    fmax: float = 7600.0
    n_mels: int = 80
    spec_power: float = 1.0
    lower_thresh: float = 1e-5
    multiply: float = 20.0
    subtract: float = 20.0
    add: float = 100.0
    divide: float = 100.0
    clip_min: float = 0.0
    clip_max: float = 1.0
    trim_len: int = 860
    clip_samples: int = 220500  # 10 s @ 22050 Hz


@dataclass(frozen=True)
class VQVAEConfig:
    """SpecVQGAN-style VQ-VAE constants
    (reference: vqvae/big_model_attn_gan.py:521-531, 538-602)."""

    num_embeddings: int = 128          # 128 VAS / 1024 VGGSound
    embedding_dim: int = 256
    commitment_cost: float = 0.25
    ch: int = 128
    ch_mult: tuple = (1, 1, 2, 2, 4)   # 4 downsamples => 16x
    num_res_blocks: int = 2
    attn_resolutions: tuple = (53,)
    dropout: float = 0.0
    in_channels: int = 1
    out_ch: int = 1
    z_channels: int = 256
    resolution: int = 848
    double_z: bool = False
    # GAN training (reference: big_model_attn_gan.py:538-602)
    disc_start: int = 2001
    codebook_weight: float = 1.0
    disc_num_layers: int = 3
    disc_in_channels: int = 1
    disc_factor: float = 1.0
    disc_weight: float = 1.0
    disc_ndf: int = 64
    min_adapt_weight: float = 0.0
    max_adapt_weight: float = 1e4
    learning_rate: float = 1e-3
    # code-grid geometry implied by resolution/ch_mult (5 x 53 for 80x848)
    code_h: int = 5
    code_w: int = 53


@dataclass(frozen=True)
class VocoderConfig:
    """MelGAN generator (reference: vocoder/modules.py:38-77 +
    vocoder/logs/vggsound/args.yml: n_mel_channels 80, ngf 32,
    n_residual_layers 3)."""

    n_mel_channels: int = 80
    ngf: int = 32
    n_residual_layers: int = 3
    ratios: tuple = (8, 8, 2, 2)  # hop length 256


@dataclass(frozen=True)
class DataConfig:
    """Data layer constants (reference: datasets/datamodule.py:10-88,
    transformer/minGPT.py:461-475)."""

    spec_dir_path: str = "./data/vas/features/*/melspec_10s_22050hz"
    batch_size: int = 8
    num_workers: int = 1
    mel_num: int = 80
    spec_len: int = 860
    spec_crop_len: int = 848
    random_crop: bool = False
    sample_rate: int = 22050
    data_root: str = "./data"


@dataclass(frozen=True)
class VAEConfig:
    """GPT-VAE training knobs (reference: GPT_VAE_train.py:39-89 argparse +
    transformer/Lit_GPT_VAE.py:64-89)."""

    nz: int = 1024                # latent size == n_embd
    nsamples: int = 1
    iw_train_nsamples: int = -1
    iw_train_ns: int = 1
    iw_nsamples: int = 500
    warm_up: int = 10             # annealing epochs
    kl_start: float = 1.0         # starting KL weight
    beta: float = 1.0             # 0 => plain AE
    fb: int = 0                   # free-bits mode: 0/1/2/3
    target_kl: float = -1.0
    fix_var: float = -1.0
    freeze_epoch: int = -1
    save_latent: int = 0


@dataclass(frozen=True)
class TrainConfig:
    """Trainer-level knobs (reference: GPT_train.py:25-68,
    GPT_VAE_train.py:29-113)."""

    learning_rate: float = 1e-6
    epochs: int = 300
    batch_size: int = 8
    weight_decay: float = 0.01
    betas: tuple = (0.9, 0.95)
    optimizer: str = "adamw"      # "adamw" (minGPT two-group) | "adafactor"
                                  # (factored 2nd moment: fits GPT-XL-scale
                                  # VAEs on a single 16GB chip) | "sgd" |
                                  # "adam" (LSTM-VAE choice, Lit_vae.py:85-92)
    momentum: float = 0.0         # SGD momentum (reference --momentum)
    grad_clip: Optional[float] = None  # global-norm clip (reference
                                       # clip_grad=5.0, commented out at
                                       # GPT_VAE_train.py:25,176; required
                                       # for LSTM SGD at lr 1.0)
    seed: int = 783435
    logging_frequency: int = 200
    log_dir: str = "lightning_logs"
    # Val-plateau LR decay (opt-in): the reference's commented-out
    # machinery in callbeck_of_my_dreams (GPT_VAE_callbacks.py:456-515:
    # decay_epoch=5, lr_decay=0.5, epoch >= 15 gate).  0.0 = off (the
    # reference ships with it disabled).
    lr_decay: float = 0.0          # multiply LR by this on plateau
    lr_decay_patience: int = 5     # stale val epochs before decaying
    lr_decay_start: int = 15       # no decay before this epoch
    # ReduceLROnPlateau-style threshold: an epoch only counts as improved
    # when it beats best_loss by more than this; 0.0 = any improvement
    # resets the stale counter (a flat-but-epsilon-improving val loss
    # then never triggers decay).
    lr_decay_min_delta: float = 0.0
    # device mesh (replaces Lightning DDP devices/num_nodes):
    mesh_shape: Optional[Dict[str, int]] = None  # e.g. {"data": 8} / {"data": 4, "model": 2}


# ---------------------------------------------------------------------------
# Presets — values preserved verbatim from the reference config/ dicts.
# ---------------------------------------------------------------------------

_PRESETS: Dict[str, Dict[str, Any]] = {
    # reference: config/config_GPT_vas.py
    "GPT_vas": dict(
        vocab_size=128,
        block_size=266,   # 1 class token + 53*5 codes
        n_layer=24,
        n_head=16,
        n_embd=1024,
        class_size=8,
        learning_rate=1e-6,
        epochs=300,
        batch_size=8,
        spec_dir_path="./data/vas/features/*/melspec_10s_22050hz",
        sample_rate=22050,
        embd_pdrop=0.5,
        resid_pdrop=0.5,
        attn_pdrop=0.5,
        n_unmasked=0,
        last_linear=None,
    ),
    # reference: config/config_GPT_VAE_vas.py
    "GPT_VAE_vas": dict(
        vocab_size=128,
        block_size=265,   # 53*5
        n_layer=24,
        n_head=16,
        n_embd=1024,
        learning_rate=1e-6,
        epochs=10000,
        batch_size=24,
        spec_dir_path="./data/vas/features/*/melspec_10s_22050hz",
        sample_rate=22050,
        embd_pdrop=0.3,
        resid_pdrop=0.3,
        attn_pdrop=0.3,
        n_unmasked=0,
        last_linear=None,
        remat=True,
        # no reference equivalent (the reference runs
        # torch.set_float32_matmul_precision('medium') - bf16-class
        # matmuls - at GPT_VAE_train.py:164): save attention outputs
        # under remat + bf16 matmul passes with f32 accumulation.
        remat_policy="attn",
        mixed_precision=True,
    ),
    # reference: config/config_GPT_VAE_vggsound.py (GPT-XL variant, active)
    "GPT_VAE_vggsound": dict(
        vocab_size=1024,
        block_size=265,
        n_layer=40,
        n_head=23,
        n_embd=1472,
        learning_rate=1e-6,
        epochs=10000,
        batch_size=1,
        spec_dir_path="./data/vggsound/melspec_10s_22050hz/",
        sample_rate=22050,
        embd_pdrop=0.0,
        resid_pdrop=0.0,
        attn_pdrop=0.0,
        n_unmasked=0,
        last_linear=None,
        remat=True,
        # same attn-remat + mixed-precision policy as the VAS VAE preset
        remat_policy="attn",
        mixed_precision=True,
    ),
    # reference: config/config_vas.py (legacy LSTM VAE)
    "VAE_vas": dict(
        enc_type="lstm",
        dec_type="lstm",
        nz=32,
        ni=512,
        enc_nh=1024,
        dec_nh=1024,
        dec_dropout_in=0.5,
        dec_dropout_out=0.5,
        batch_size=8,
        epochs=150,
        test_nepoch=5,
        spec_dir_path="./data/vas/features/*/melspec_10s_22050hz",
    ),
}


def parse_overrides(spec: str) -> Dict[str, Any]:
    """Parse a ``k=v,k2=v2`` CLI string into a preset-override dict.

    The reference's config system lets users edit ``config/*.py`` params
    freely (GPT_train.py:63-66 merges the module dict into argparse); the
    typed presets here are code, so ``--override`` is the equivalent
    escape hatch.  Values are coerced like Python literals (``2`` -> int,
    ``0.5`` -> float, ``True``/``None`` literal, ``(1,2)`` -> tuple),
    anything else stays a string.  Commas inside brackets/parens do not
    split entries, so tuple fields like ``ch_mult=(1,2,4)`` work.
    """
    import ast
    out: Dict[str, Any] = {}
    if not spec:
        return out
    items, depth, cur = [], 0, []
    for ch in spec:
        if ch == "," and depth == 0:
            items.append("".join(cur))
            cur = []
            continue
        depth += ch in "([{"
        depth -= ch in ")]}"
        cur.append(ch)
    items.append("".join(cur))
    for item in items:
        k, eq, v = item.partition("=")
        if not eq:
            raise ValueError(f"--override entry {item!r} is not key=value")
        try:
            out[k.strip()] = ast.literal_eval(v.strip())
        except (ValueError, SyntaxError):
            out[k.strip()] = v.strip()
    return out


def _check_override_keys(overrides: Dict[str, Any], allowed, context: str):
    """A typo'd --override key must fail loudly, not train the full-size
    preset silently."""
    unknown = sorted(set(overrides) - set(allowed))
    if unknown:
        raise ValueError(
            f"unknown override key(s) {unknown} for {context}; known keys: "
            f"{sorted(allowed)}")


def preset_params(model: str, dataset: str) -> Dict[str, Any]:
    """Raw params dict, equivalent to the reference's
    ``config.config_{model}_{dataset}.params`` import."""
    key = f"{model}_{dataset}" if model else f"VAE_{dataset}"
    if key not in _PRESETS:
        raise KeyError(f"no preset {key!r}; available: {sorted(_PRESETS)}")
    return dict(_PRESETS[key])


@dataclass
class ExperimentConfig:
    """Fully-resolved experiment configuration (the reference merges argparse
    + config params into one namespace; we make it a typed object)."""

    model: GPTConfig
    mel: MelConfig = field(default_factory=MelConfig)
    vqvae: VQVAEConfig = field(default_factory=VQVAEConfig)
    vocoder: VocoderConfig = field(default_factory=VocoderConfig)
    data: DataConfig = field(default_factory=DataConfig)
    vae: VAEConfig = field(default_factory=VAEConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    extras: Dict[str, Any] = field(default_factory=dict)


def load_lstm_preset(dataset: str = "vas", **overrides):
    """Legacy LSTM-VAE preset (reference config/config_vas.py + the flag
    defaults of the lagging-inference-style system at
    modules/Lit_vae.py:85-92: SGD, lr 1.0, momentum 0).

    Returns (ExperimentConfig, LSTMConfig)."""
    p = preset_params("VAE", dataset)
    _check_override_keys(
        overrides,
        set(p) | set(LSTMConfig._fields)  # NamedTuple
        | {f.name for f in dataclasses.fields(TrainConfig)}
        | {f.name for f in dataclasses.fields(DataConfig)},
        f"VAE_{dataset}")
    p.update(overrides)
    cfg = LSTMConfig(
        vocab_size=130,                  # 128 codes + <s> + </s>
        nz=p.get("nz", 32),
        ni=p.get("ni", 512),
        enc_nh=p.get("enc_nh", 1024),
        dec_nh=p.get("dec_nh", 1024),
        dec_dropout_in=p.get("dec_dropout_in", 0.5),
        dec_dropout_out=p.get("dec_dropout_out", 0.5),
        max_len=52,                      # 50-token parts + <s>/</s>
    )
    train = TrainConfig(
        learning_rate=p.get("learning_rate", 1.0),
        epochs=p.get("epochs", 150),
        batch_size=p.get("batch_size", 8),
        optimizer=p.get("optimizer", "sgd"),
        momentum=p.get("momentum", 0.0),
        grad_clip=p.get("grad_clip", 5.0),
    )
    data = DataConfig(
        spec_dir_path=p.get("spec_dir_path", DataConfig.spec_dir_path),
        batch_size=train.batch_size,
        sample_rate=p.get("sample_rate", 22050),
    )
    vae = VAEConfig(nz=cfg.nz)
    # model slot is unused by the LSTM system; a minimal placeholder keeps
    # ExperimentConfig uniform for the runner/callbacks
    placeholder = GPTConfig(vocab_size=cfg.vocab_size,
                            block_size=cfg.max_len, n_layer=1, n_head=1,
                            n_embd=cfg.ni)
    exp = ExperimentConfig(model=placeholder, data=data, vae=vae,
                           train=train, extras=dict(p))
    return exp, cfg


def load_preset(model: str, dataset: str, **overrides) -> ExperimentConfig:
    """Build an ExperimentConfig from a named preset (+ overrides).

    ``model`` in {"GPT", "GPT_VAE"}, ``dataset`` in {"vas", "vggsound"}.
    """
    p = preset_params(model, dataset)
    _check_override_keys(
        overrides,
        set(p) | {f.name for f in dataclasses.fields(GPTConfig)}
        | {f.name for f in dataclasses.fields(TrainConfig)}
        | {f.name for f in dataclasses.fields(DataConfig)},
        f"{model}_{dataset}")
    p.update(overrides)

    gpt_keys = {f.name for f in dataclasses.fields(GPTConfig)}
    gpt = GPTConfig(**{k: v for k, v in p.items() if k in gpt_keys})

    train = TrainConfig(
        learning_rate=p.get("learning_rate", 1e-6),
        epochs=p.get("epochs", 300),
        batch_size=p.get("batch_size", 8),
    )
    vq = VQVAEConfig(num_embeddings=p["vocab_size"])
    data = DataConfig(
        spec_dir_path=p.get("spec_dir_path", DataConfig.spec_dir_path),
        batch_size=p.get("batch_size", 8),
        sample_rate=p.get("sample_rate", 22050),
    )
    vae = VAEConfig(nz=p.get("n_embd", 1024))
    extras = {k: v for k, v in p.items() if k not in gpt_keys}
    return ExperimentConfig(model=gpt, vqvae=vq, data=data, vae=vae,
                            train=train, extras=extras)
