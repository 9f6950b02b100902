"""Media-logging and epoch-end callbacks of the training loops.

Counterpart of melspec_gpt_vqvae_tpu/training/callbacks.py:

  * ``FrozenDecoders``: a frozen VQ-VAE and MelGAN vocoder, either one
    optional, that turn GPT-order code rows into spectrograms and
    spectrograms into audio (the reference callbacks each load their own
    copies: GPT_VAE_callbacks.py:33-54);
  * ``find_raw_audio``: a clip's source audio beside its features;
  * ``GPTImageLogger`` (GPT_callbacks.py:30-272): the ``media_cb`` of
    ``runner.fit_gpt``, the class GPT's gallery as text, an attention
    heatmap, spectrograms and audio;
  * ``VAETextLogger`` (GPT_VAE_callbacks.py:29-409): the ``media_cb`` of
    ``runner.fit_vae`` for the GPT-VAE, an original with its greedy and
    "beam" reconstructions and a latent interpolation, as token text,
    spectrograms and audio;
  * ``LSTMTextLogger`` (VAE_callbacks.py:30-370): the LSTM-VAE's
    original, greedy and beam reconstructions and a sample from the prior
    as ``VocabEntry`` sentences;
  * ``metrics_epoch_end`` (``callbeck_of_my_dreams``,
    GPT_VAE_callbacks.py:421-522): corpus MI and AU at each validation's
    end.

The decoders run under ``torch.no_grad`` on the trainer's device, inside
whatever ``_build.kernels`` scope the caller entered (none: the kernels on
the card, so the vocoder's stacks run kernel B).  Each logger draws its
noise from a ``torch.Generator`` of its own, seeded 0.  Without decoders
the loggers write the text alone; nothing here catches an error.

Under a mesh every rank calls the callbacks, as the loops call them
everywhere: a logger first takes the task's ``media_state`` (the full
parameters, gathered to global rank 0 when the mesh splits them; None
on the other ranks), then logs on rank 0 alone, on one device (the
reference's ``@rank_zero_only``); ``metrics_epoch_end``'s MI and AU are
a collective over the data group, logged and printed by rank 0.
"""

from __future__ import annotations

import os
import tempfile
import wave
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..data.vocab import VocabEntry
from ..models.vocoder import MelGANGenerator
from ..models.vqvae import VQModel
from ..parallel.mesh import is_primary
from ..utils.codes import sequence_to_grid
from ..utils.demo import extract_audio_from_video, which_ffmpeg
from .logging import TBLogger, attention_image


class FrozenDecoders:
    """A frozen VQ-VAE (``vq``) and MelGAN (``vocoder``), each optional,
    moved to ``device``.  ``codes_to_spec`` needs the VQ-VAE and
    ``spec_to_audio`` the vocoder; each returns None without its model."""

    def __init__(self, vq: Optional[VQModel] = None,
                 vocoder: Optional[MelGANGenerator] = None,
                 code_h: int = 5, code_w: int = 53, device=None):
        self.code_h, self.code_w = code_h, code_w
        self.vq = None if vq is None else vq.to(device).eval()
        self.vocoder = (None if vocoder is None
                        else vocoder.to(device).eval())

    @torch.no_grad()
    def codes_to_spec(self, seq) -> Optional[np.ndarray]:
        """(B, code_h * code_w) GPT-order tokens -> (B, 80, 848) spectrogram
        in [-1, 1] (reference codes_to_spec: GPT_VAE_callbacks.py:388-398)."""
        if self.vq is None:
            return None
        seq = torch.as_tensor(seq).cpu().numpy()
        grid = torch.from_numpy(np.ascontiguousarray(sequence_to_grid(
            seq, self.code_h, self.code_w))).long()
        out = self.vq.decode_code(grid.to(self.vq.quant_conv.weight.device))
        return out[..., 0].float().cpu().numpy()

    @torch.no_grad()
    def spec_to_audio(self, spec) -> Optional[np.ndarray]:
        """A spectrogram (80, T) in [-1, 1] -> its waveform; the vocoder
        reads (spec + 1) / 2 (the callback convention,
        GPT_callbacks.py:96-102)."""
        if self.vocoder is None:
            return None
        w = self.vocoder.conv_in.weight
        s01 = (torch.as_tensor(np.asarray(spec, np.float32)) + 1.0) / 2.0
        mel = s01.t()[None].to(w.device, w.dtype)          # (1, T, 80)
        return self.vocoder(mel)[0].float().cpu().numpy()


def _read_wav(path: str, sample_rate: int) -> Optional[np.ndarray]:
    """A 16-bit WAV as float32 in [-1, 1] (channels averaged), or None at
    another sample rate (the reference resamples with librosa)."""
    with wave.open(path, "rb") as w:
        if w.getframerate() != sample_rate:
            return None
        raw = np.frombuffer(w.readframes(w.getnframes()), dtype="<i2")
        if w.getnchannels() > 1:
            raw = raw.reshape(-1, w.getnchannels()).mean(axis=1)
        return raw.astype(np.float32) / 32768.0


def find_raw_audio(spec_path: str, sample_rate: int = 22050
                   ) -> Optional[np.ndarray]:
    """The source audio of a spectrogram file, or None: the reference
    TextLogger tries the raw clip before it vocodes the spectrogram
    (GPT_VAE_callbacks.py:140-157).  Looked for, in order, beside the
    class's features: ``audio_10s_22050hz/<vid>.wav`` (the tree the mel
    front end reads; a file at another rate is skipped), then
    ``videos/<vid>.mp4`` through ffmpeg where it is installed.  A file that
    cannot be read gives None, as in the reference."""
    base = os.path.basename(spec_path)
    vid = (base[:-len("_mel.npy")] if base.endswith("_mel.npy")
           else os.path.splitext(base)[0])
    cls_dir = os.path.dirname(os.path.dirname(os.path.abspath(spec_path)))
    wav_path = os.path.join(cls_dir, "audio_10s_22050hz", f"{vid}.wav")
    if os.path.isfile(wav_path):
        try:
            return _read_wav(wav_path, sample_rate)
        except (OSError, ValueError, EOFError, wave.Error):
            pass
    mp4_path = os.path.join(cls_dir, "videos", f"{vid}.mp4")
    if os.path.isfile(mp4_path) and which_ffmpeg():
        try:
            with tempfile.TemporaryDirectory() as td:
                out = os.path.join(td, "a.wav")
                extract_audio_from_video(mp4_path, out, sample_rate)
                return _read_wav(out, sample_rate)
        except (OSError, ValueError, EOFError, RuntimeError, wave.Error):
            pass
    return None


def _log_media(log: TBLogger, dec: FrozenDecoders, spec_tag: str,
               audio_tag: str, seq, step: int, sample_rate: int):
    """The first row of the code rows ``seq`` decoded, as a spectrogram
    and as audio, each where the decoders allow."""
    spec = dec.codes_to_spec(seq)
    if spec is None:
        return
    log.spectrogram(spec_tag, spec[0], step)
    audio = dec.spec_to_audio(spec[0])
    if audio is not None:
        log.audio(audio_tag, audio, step, sample_rate)


class GPTImageLogger:
    """``media_cb`` of ``runner.fit_gpt``: ``task.log_samples`` on the
    batch's first ``max_images`` items, logged as ``{split}/conditioning``
    (the labels), the four code rows as text, ``{split}/att_nopix`` (the
    heatmap), ``{split}/inputs`` (+ ``_audio``) and the four rows as
    spectrograms and audio (GPT_callbacks.py:93-152)."""

    def __init__(self, task, log: TBLogger, decoders: FrozenDecoders,
                 sample_rate: int = 22050, max_images: int = 1,
                 top_k: int = 100):
        self.task = task
        self.log = log
        self.dec = decoders
        self.sample_rate = sample_rate
        self.max_images = max_images
        self.top_k = top_k
        self.generator = torch.Generator(device=task.device).manual_seed(0)

    def __call__(self, state, batch, step: int, split: str):
        if "codes" not in batch:
            return
        state = self.task.media_state(state)
        if not is_primary():
            return
        gallery = self.task.log_samples(state["params"], self.generator,
                                        batch, top_k=self.top_k,
                                        n=self.max_images)
        labels = batch.get("label", [])
        if len(labels):
            self.log.text(f"{split}/conditioning",
                          "; ".join(labels[:self.max_images]), step)
        for name in ("codes", "codes_half", "codes_nopix", "codes_det"):
            self.log.text(f"{split}/{name}", str(gallery[name].tolist()),
                          step)
        att = attention_image(gallery["att_nopix"])
        self.log.image(f"{split}/att_nopix", att[0][..., None], step)
        if "image" in batch:
            inp = np.asarray(batch["image"][0])
            self.log.spectrogram(f"{split}/inputs", inp, step)
            audio = self.dec.spec_to_audio(inp)
            if audio is not None:
                self.log.audio(f"{split}/inputs_audio", audio, step,
                               self.sample_rate)
        for name, key in (("reconstructions", "codes"),
                          ("samples_half", "codes_half"),
                          ("samples_nopix", "codes_nopix"),
                          ("samples_det", "codes_det")):
            _log_media(self.log, self.dec, f"{split}/{name}",
                       f"{split}/{name}_audio", gallery[key], step,
                       self.sample_rate)
        self.log.flush()


class VAETextLogger:
    """``media_cb`` of ``runner.fit_vae`` for the GPT-VAE: logs
    ``{split}/original_spec`` and ``{split}/original_audio`` (the clip's
    source audio where ``find_raw_audio`` finds it, else the vocoded
    input), then ``{split}/original_codes``,
    ``{split}/greedy_reconstruction``, ``{split}/beam_reconstruction`` and
    ``{split}/interpolation_{i}`` of the batch's first item (and second,
    for the interpolation), each as text and, through the decoders, as
    ``{tag}_spec`` and ``{tag}_audio``."""

    def __init__(self, task, log: TBLogger,
                 decoders: Optional[FrozenDecoders] = None,
                 sample_rate: int = 22050, interpolation_steps: int = 5):
        self.task = task
        self.log = log
        self.dec = decoders if decoders is not None else FrozenDecoders()
        self.sample_rate = sample_rate
        self.interpolation_steps = interpolation_steps
        self.generator = torch.Generator(device=task.device).manual_seed(0)

    def _log_codes(self, tag: str, seq, step: int):
        seq = torch.as_tensor(seq).cpu().numpy()
        self.log.text(tag, str(seq.tolist()), step)
        _log_media(self.log, self.dec, f"{tag}_spec", f"{tag}_audio", seq,
                   step, self.sample_rate)

    def __call__(self, state, batch, step: int, split: str):
        if "codes" not in batch:
            return
        state = self.task.media_state(state)
        if not is_primary():
            return
        if "image" in batch:
            inp = np.asarray(batch["image"][0])
            self.log.spectrogram(f"{split}/original_spec", inp, step)
            audio = None
            paths = batch.get("file_path_")
            if paths is not None and len(paths):
                audio = find_raw_audio(str(paths[0]), self.sample_rate)
            if audio is None:
                audio = self.dec.spec_to_audio(inp)
            if audio is not None:
                self.log.audio(f"{split}/original_audio", audio, step,
                               self.sample_rate)
        one = {"codes": np.asarray(batch["codes"])[:1]}
        self._log_codes(f"{split}/original_codes",
                        self.task.batch_tokens(one), step)
        for strategy in ("greedy", "beam"):
            self._log_codes(f"{split}/{strategy}_reconstruction",
                            self.task.reconstruct(state, one, strategy,
                                                  self.generator), step)
        self._interpolation(state, batch, step, split)
        self.log.flush()

    def log_interpolation(self, state, batch, step: int, split: str = "val"):
        """Greedy decodes between the first two items' latents (the
        ``--test_interpolation`` path, GPT_VAE_callbacks.py:324-386)."""
        state = self.task.media_state(state)
        if is_primary():
            self._interpolation(state, batch, step, split)

    def _interpolation(self, state, batch, step: int, split: str):
        codes = np.asarray(batch["codes"])
        if codes.shape[0] < 2:
            return
        outs = self.task.interpolate(state, {"codes": codes[:1]},
                                     {"codes": codes[1:2]},
                                     steps=self.interpolation_steps,
                                     generator=self.generator)
        for i, seq in enumerate(outs):
            self._log_codes(f"{split}/interpolation_{i}", seq, step)
        self.log.flush()


class LSTMTextLogger:
    """``media_cb`` of ``runner.fit_vae`` for the LSTM-VAE: the first
    sentence of the batch's first item as ``{split}/original``, its
    ``{split}/greedy_reconstruction`` and ``{split}/beam_reconstruction``
    (the true beam search) and ``{split}/sampled_from_prior``, each as
    ``VocabEntry`` words (VAE_callbacks.py:30-370)."""

    def __init__(self, task, log: TBLogger, vocab: Optional[VocabEntry] = None):
        self.task = task
        self.log = log
        self.vocab = vocab or VocabEntry()
        self.generator = torch.Generator(device=task.device).manual_seed(0)

    def _log_text(self, tag: str, toks, step: int):
        row = torch.as_tensor(toks)[0].cpu().numpy()
        self.log.text(tag, " ".join(str(w) for w in
                                    self.vocab.decode_sentence(row)), step)

    def __call__(self, state, batch, step: int, split: str):
        if "codes" not in batch or not is_primary():
            return
        one = {"codes": np.asarray(batch["codes"])[:1]}
        self._log_text(f"{split}/original", self.task.batch_tokens(one),
                       step)
        for strategy in ("greedy", "beam"):
            self._log_text(f"{split}/{strategy}_reconstruction",
                           self.task.reconstruct(state, one, strategy,
                                                 self.generator), step)
        self._log_text(f"{split}/sampled_from_prior",
                       self.task.sample_from_prior(state, 1,
                                                   generator=self.generator),
                       step)
        self.log.flush()


def metrics_epoch_end(task, dm, log: TBLogger,
                      limit_batches: Optional[int] = None) -> Callable:
    """``epoch_end_cb`` of ``runner.fit_vae``: the corpus MI and AU of the
    validation tokens the epoch's pass kept (read from the loader again
    only when none are handed in), ``extras["pre_mi"]`` set to the MI, and
    the metrics logged."""

    def cb(state, epoch: int, agg: Dict[str, float], extras: Dict[str, Any],
           tokens=None):
        if tokens is None:
            tokens = []
            for i, b in enumerate(dm.val_dataloader()):
                if limit_batches and i >= limit_batches:
                    break
                tokens.append(task.batch_tokens(b))
        mi, au, _ = task.calc_mi_au(state, tokens)
        if not tokens and not np.isfinite(mi):
            return
        extras["pre_mi"] = mi
        step = int(state["step"])
        log.scalar("metrics/mutual_info", mi, step)
        log.scalar("metrics/active_units", au, step)
        if agg:
            log.scalar("metrics/ppl", agg["ppl"], step)
            log.scalar("metrics/nll", agg["nll"], step)
        log.scalar("metrics/starting_best_loss", extras["best_loss"], step)
        if is_primary():
            print(f"epoch {epoch}: mutual_info {mi:.4f} active_units {au}")

    return cb
