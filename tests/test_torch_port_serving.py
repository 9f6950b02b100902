"""PyTorch port: HTTP serving, the serve and sample entry points, and the
explicit kernel switch (the pipeline's ``use_kernels``, a
``_build.kernels`` scope that every wrapper reads).

The HTTP server runs on port 0 beside the JAX package's server over the
same tiny weights (as tests/test_serving.py drives the JAX one): the same
routes, bodies and status codes, and deterministic PCM within one step.
The entry points run on the CPU from a checkpoint the port's own
CheckpointManager wrote.  On the CPU every wrapper takes its plain
version; the switch on (True) there must raise, not fall back.
"""

import base64
import io
import json
import threading
import urllib.error
import urllib.request
import wave

import numpy as np
import pytest
import torch

from melspec_gpt_vqvae_tpu import serving as JSV
from melspec_gpt_vqvae_tpu_torch import _build
from melspec_gpt_vqvae_tpu_torch import pipeline as TP
from melspec_gpt_vqvae_tpu_torch import sample as sample_cli
from melspec_gpt_vqvae_tpu_torch import serve as serve_cli
from melspec_gpt_vqvae_tpu_torch import serving as TSV
from melspec_gpt_vqvae_tpu_torch.configs import (MelConfig, load_preset,
                                                 parse_overrides)
from melspec_gpt_vqvae_tpu_torch.models.vocoder import MelGANResnetBlock
from melspec_gpt_vqvae_tpu_torch.ops import attention as TA
from melspec_gpt_vqvae_tpu_torch.ops import decode_attention as TDA
from melspec_gpt_vqvae_tpu_torch.ops import int8_linear as TL
from melspec_gpt_vqvae_tpu_torch.ops import mel_kernel as TMK
from melspec_gpt_vqvae_tpu_torch.ops import vocoder_stack as TVS
from melspec_gpt_vqvae_tpu_torch.ops import vq as TV
from melspec_gpt_vqvae_tpu_torch.training.checkpoint import CheckpointManager
from melspec_gpt_vqvae_tpu_torch.training.gpt_task import GPTTask

from test_torch_port_pipeline import tiny_pipelines
from test_torch_port_run_checkpoint import tiny_melgan

torch.set_num_threads(1)

SMALL = "n_layer=1,n_head=2,n_embd=32"


# ------------------------------ HTTP ------------------------------------------

def _start(module, svc):
    httpd = module.serve(svc, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


@pytest.fixture(scope="module")
def servers():
    """{"jax": (url, service), "torch": (url, service)} over the same tiny
    weights, batch 2."""
    exp, jpipe, tpipe = tiny_pipelines()
    svcs = {"jax": JSV.GenerationService(exp, jpipe, batch=2, seed=7),
            "torch": TSV.GenerationService(tpipe.exp, tpipe, batch=2,
                                           seed=7)}
    httpds = {"jax": _start(JSV, svcs["jax"]),
              "torch": _start(TSV, svcs["torch"])}
    yield {k: (f"http://127.0.0.1:{h.server_address[1]}", svcs[k])
           for k, h in httpds.items()}
    for h in httpds.values():
        h.shutdown()
        h.server_close()


def _request(url, body=None, raw=None):
    """(status, headers, body bytes) of a GET (no body) or a POST."""
    data = raw if raw is not None else (
        None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def _pcm(blob):
    with wave.open(io.BytesIO(blob), "rb") as w:
        assert w.getframerate() == 22050 and w.getsampwidth() == 2
        return np.frombuffer(w.readframes(w.getnframes()), "<i2")


def test_http_healthz_matches_jax(servers):
    bodies = {}
    for name, (url, _) in servers.items():
        status, headers, blob = _request(url + "/healthz")
        assert status == 200
        assert headers["Content-Type"] == "application/json"
        bodies[name] = json.loads(blob)
    j, t = bodies["jax"], bodies["torch"]
    assert t.keys() == j.keys() and t["queue"].keys() == j["queue"].keys()
    assert t["model"] == j["model"] == {"n_layer": 2, "n_embd": 16,
                                        "class_size": 4}
    assert t["status"] == "ok" and t["batch"] == j["batch"] == 2
    assert t["platform"] == j["platform"] == "cpu"


def test_http_get_generate_wav(servers):
    url, _ = servers["torch"]
    status, headers, blob = _request(
        url + "/generate?class=3&seed=5&top_p=0.9")
    assert status == 200 and headers["Content-Type"] == "audio/wav"
    assert _pcm(blob).shape == (32,)   # tiny vocoder: 8 frames x 4
    assert _request(url + "/generate?class=3&seed=5&top_p=0.9")[2] == blob


def test_http_post_deterministic_pcm_matches_jax(servers):
    """Greedy clips through both servers: the same classes in the same
    order, PCM16 within one step (the waveforms agree to 1e-5)."""
    body = {"classes": [0, 1, 2], "num": 2, "deterministic": True,
            "seed": 5, "format": "json"}
    out = {}
    for name, (url, _) in servers.items():
        status, _, blob = _request(url + "/generate", body)
        assert status == 200
        out[name] = json.loads(blob)
    j, t = out["jax"], out["torch"]
    assert t.keys() == j.keys() == {"clips", "sample_rate", "seconds"}
    assert [c["class"] for c in t["clips"]] == [c["class"] for c in
                                                j["clips"]] == [0, 0, 1, 1,
                                                                2, 2]
    for a, b in zip(t["clips"], j["clips"]):
        pa = _pcm(base64.b64decode(a["wav_base64"])).astype(np.int32)
        pb = _pcm(base64.b64decode(b["wav_base64"])).astype(np.int32)
        assert pa.shape == pb.shape == (32,)
        assert np.abs(pa - pb).max() <= 1


@pytest.mark.parametrize("path, body, raw, code", [
    ("/nope", None, None, 404),
    ("/nope", {"classes": [0]}, None, 404),
    ("/generate?class=99", None, None, 400),
    ("/generate?class=1&num=0", None, None, 400),
    ("/generate", {"classes": [0, 1], "format": "wav"}, None, 400),
    ("/generate", {"classes": [0], "num": 200}, None, 400),
    ("/generate", {"classes": [1], "temperature": 0}, None, 400),
    ("/generate", None, b"{not json", 400),
])
def test_http_errors_match_jax(servers, path, body, raw, code):
    got = {}
    for name, (url, _) in servers.items():
        status, headers, blob = _request(url + path, body, raw)
        got[name] = (status, sorted(json.loads(blob)))
    assert got["torch"] == got["jax"] == (code, ["error"])


def test_http_sheds_load_with_503_and_retry_after(servers):
    url, svc = servers["torch"]
    shed = svc.shed
    with svc._pending_lock:
        svc._pending = svc.max_queue      # a full queue
    try:
        status, headers, blob = _request(url + "/generate?class=0")
    finally:
        with svc._pending_lock:
            svc._pending = 0
    assert status == 503 and headers["Retry-After"] == "2"
    assert "queue full" in json.loads(blob)["error"]
    q = json.loads(_request(url + "/healthz")[2])["queue"]
    assert q["shed"] == shed + 1 and q["pending"] == 0


# ------------------------------ entry points ----------------------------------

@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """A run ``prun`` written by the port's own CheckpointManager (what
    train_gpt saves: the state tree and the epoch) at the SMALL geometry,
    and a reference-format MelGAN dir; returns the root."""
    root = tmp_path_factory.mktemp("port_run")
    task = GPTTask(load_preset("GPT", "vas", **parse_overrides(SMALL)),
                   "cpu")
    ckpt = CheckpointManager(str(root / "lightning_logs" / "prun-vas" /
                                 "checkpoints" / "version_0"))
    ckpt.save({"state": task.state_tree(task.init_state(9)), "epoch": 1},
              step=5)
    ckpt.wait()
    tiny_melgan(root / "melgan")
    return root


def test_sample_cli_writes_clips_from_a_port_checkpoint(port_run, capsys,
                                                        monkeypatch):
    """sample.main on the CPU: the WAV, codes and mel files of the clip,
    the JSON summary last, and the greedy codes of the run's GPT."""
    monkeypatch.chdir(port_run)
    out_dir = port_run / "samples"
    summary = sample_cli.main([
        "--experiment", "prun", "--resume", "last", "--override", SMALL,
        "--vocoder_ckpt", str(port_run / "melgan"), "--classes", "3",
        "--num", "1", "--batch", "2", "--deterministic", "--save_codes",
        "--save_spec", "--out_dir", str(out_dir), "--device", "cpu"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == summary
    assert summary["written"] == 1 and summary["out_dir"] == str(out_dir)
    assert {"seconds", "clips_per_sec"} <= summary.keys()
    assert sorted(p.name for p in out_dir.iterdir()) == [
        "class03_000.wav", "class03_000_codes.npy", "class03_000_mel.npy"]
    assert _pcm((out_dir / "class03_000.wav").read_bytes()).shape == (
        848 * 256,)
    assert np.load(out_dir / "class03_000_mel.npy").shape == (80, 848)
    _, pipe = TSV.build_pipeline("vas", experiment="prun", resume="last",
                                 override=SMALL, device="cpu")
    toks, _ = pipe.generate_tokens([3], None, sample=False)
    np.testing.assert_array_equal(np.load(out_dir / "class03_000_codes.npy"),
                                  toks[0].numpy())


def test_serve_cli_answers_from_a_port_checkpoint(port_run, monkeypatch):
    monkeypatch.chdir(port_run)
    httpd = serve_cli.start([
        "--experiment", "prun", "--resume", "last", "--override", SMALL,
        "--device", "cpu", "--port", "0", "--no_warmup", "--batch", "4"])
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        body = json.loads(_request(url + "/healthz")[2])
        assert body["platform"] == "cpu" and body["batch"] == 4
        assert body["model"]["n_layer"] == 1
        assert _request(url + "/generate?class=99")[0] == 400
    finally:
        httpd.shutdown()
        httpd.server_close()


@pytest.mark.parametrize("cli", [sample_cli.main, serve_cli.start])
def test_entry_points_default_to_the_card(cli, monkeypatch):
    """Without --device the entry points ask for the card and raise when
    there is none; the CPU is taken only with --device cpu."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli(["--init_random", "--override", SMALL])


def test_int8_decode_is_refused_by_the_entry_points():
    """The int8 decode stage is ported; an artifact does not cover it, so
    serve --artifact refuses --int8_decode before it builds anything (the
    JAX serve.py's check)."""
    with pytest.raises(SystemExit, match="int8_decode"):
        serve_cli.start(["--init_random", "--override", SMALL,
                         "--int8_decode", "--artifact", "none.pt2",
                         "--device", "cpu"])


# ------------------------------ warm-up ---------------------------------------

class _Pipe:
    """A stand-in pipeline that records the sample mode of each call."""

    device = torch.device("cpu")

    def __init__(self, modes=None):
        self.calls = []
        if modes is not None:
            self.sample_modes = modes

    def generate(self, part, generator, *, temperature, top_k, top_p,
                 sample):
        self.calls.append(sample)
        n = len(part)
        return {"wavs": np.zeros((n, 4), np.float32),
                "tokens": np.zeros((n, 2), np.int32),
                "specs": np.zeros((n, 1, 2), np.float32)}


@pytest.mark.parametrize("modes, calls", [(None, [True, False]),
                                          ((True,), [True]),
                                          ((False,), [False])])
def test_warmup_serves_the_pipelines_sample_modes(modes, calls, capsys):
    exp = tiny_pipelines()[2].exp
    pipe = _Pipe(modes)
    TSV.GenerationService(exp, pipe, batch=2).warmup()
    assert pipe.calls == calls
    assert "warmup:" in capsys.readouterr().out


# ------------------------------ the kernel switch -----------------------------

def _scoped(fn):
    """``fn`` as a call(switch) that runs it inside ``_build.kernels``."""
    def call(u):
        with _build.kernels(u):
            return fn()
    return call


def _wrapper_calls():
    """{name: call(switch)} of every kernel wrapper on fixed small CPU
    tensors, each call inside a ``_build.kernels(switch)`` scope."""
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g)
    q, k, v = r(2, 2, 5, 8), r(2, 2, 5, 8), r(2, 2, 5, 8)
    blocks = [MelGANResnetBlock(32, 1).eval(),
              MelGANResnetBlock(32, 3).eval()]
    x_voc, x_vq, codebook, wav = r(1, 32, 20), r(7, 8), r(5, 8), r(2, 4096)
    q1, k1, v1 = r(2, 2, 8), r(2, 2, 8), r(2, 2, 8)
    mel_cfg = MelConfig(clip_samples=4096, trim_len=16)
    x_rows, ws, bias = r(3, 16), r(8), r(8)
    xq, xs = TL.quantize_rows_xla(x_rows)
    acc = torch._int_mm(torch.nn.functional.pad(xq, (0, 0, 0, 29)),
                        torch.randint(-5, 5, (16, 8), generator=g,
                                      dtype=torch.int8))
    x64, wq64 = r(3, 64), torch.randint(-5, 5, (8, 64), generator=g,
                                        dtype=torch.int8).t()

    def decode():
        # a fresh cache a call: the write goes into it in place
        cache = [torch.zeros((1, 2, 2, 6, 8), dtype=torch.int8)
                 for _ in range(2)]
        scales = [torch.ones((1, 2, 2, 6), dtype=torch.bfloat16)
                  for _ in range(2)]
        o = TDA.decode_attend_int8(q1, *cache, *scales, 0,
                                   torch.tensor([2]), k_new=k1, v_new=v1)
        return (o, *cache, *scales)
    return {name: _scoped(fn) for name, fn in {
        "attend": lambda: TA.attend(q, k, v, 2),
        "fused_resblock_stack": lambda: TVS.fused_resblock_stack(
            x_voc, blocks),
        "vq_nearest_index": lambda: TV.vq_nearest_index(x_vq, codebook),
        "waveform_to_mel_fused": lambda: TMK.waveform_to_mel_fused(
            wav, mel_cfg),
        "decode_attend_int8": decode,
        "quantize_rows": lambda: TL.quantize_rows(x_rows),
        "rescale_bias": lambda: TL.rescale_bias(acc, xs, ws, bias),
        "int8_linear_splitk": lambda: TL.int8_linear_splitk(x64, wq64, ws,
                                                            bias),
    }.items()}


@pytest.mark.parametrize("name", list(_wrapper_calls()))
@torch.no_grad()
def test_wrapper_switch_on_cpu_tensors(name):
    """The switch on (True) with CPU tensors raises (there is no kernel
    there); False takes the plain version, as None does on the CPU."""
    call = _wrapper_calls()[name]
    with pytest.raises(ValueError, match="use_kernels=True"):
        call(True)
    plain, default = call(False), call(None)
    plain, default = ((x if isinstance(x, tuple) else (x,))
                      for x in (plain, default))
    assert len(plain) == len(default)
    for a, b in zip(plain, default):
        assert torch.equal(a, b)


def test_pipeline_switch_on_cpu():
    """A pipeline or tokenize with the switch on (True) on the CPU raises;
    with False it decodes as the default (the plain versions either
    way)."""
    exp, _, tpipe = tiny_pipelines()
    kw = dict(segments=2, chunk=3, bf16=False)
    on = TP.GenerationPipeline(tpipe.exp, tpipe.gpt_params, tpipe.vq,
                               tpipe.melgan, use_kernels=True, **kw)
    with pytest.raises(ValueError, match="use_kernels=True"):
        on.generate([0, 1], None, sample=False)
    mel_cfg = MelConfig(clip_samples=4096, trim_len=16)
    with pytest.raises(ValueError, match="use_kernels=True"):
        on.tokenize(torch.zeros(1, 4096), mel_cfg)
    with pytest.raises(ValueError, match="use_kernels=True"), \
            _build.kernels(True):
        TP.tokenize(tpipe.vq, torch.zeros(1, 4096), mel_cfg)
    off = TP.GenerationPipeline(tpipe.exp, tpipe.gpt_params, tpipe.vq,
                                tpipe.melgan, use_kernels=False, **kw)
    ref = tpipe.generate([0, 1, 3], None, sample=False)
    out = off.generate([0, 1, 3], None, sample=False)
    for key in ("tokens", "specs", "wavs"):
        np.testing.assert_array_equal(out[key], ref[key])
    assert off.use_kernels is False
