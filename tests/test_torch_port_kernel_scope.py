"""PyTorch port: the kernel switch as one scope (``_build.kernels``).

The pipeline's ``use_kernels`` is the only place the switch is set; every
kernel wrapper reads it from a context variable, so no model or op
signature carries it, a scope entered in one thread is not seen by
another (the HTTP server's handler threads each call a pipeline), and a
captured decode program, which bakes in the switch it was captured under,
is keyed by it.  On the CPU every setting but True takes the plain
versions.
"""

import importlib
import inspect
import threading

import numpy as np
import pytest
import torch

from melspec_gpt_vqvae_tpu_torch import _build
from melspec_gpt_vqvae_tpu_torch import pipeline as TP
from melspec_gpt_vqvae_tpu_torch.models import decode_graph
from melspec_gpt_vqvae_tpu_torch.models import gpt as G
from melspec_gpt_vqvae_tpu_torch.models.speculative import \
    gpt_speculative_generate

from test_torch_port_ops import PORT_MODULES
from test_torch_port_pipeline import tiny_pipelines

torch.set_num_threads(1)

# where the switch may still be named: the pipeline that sets the scope,
# the serving layer and CLIs that hand the pipeline its argument, and
# _build, which holds the scope
SWITCH_HOLDERS = {"melspec_gpt_vqvae_tpu_torch._build",
                  "melspec_gpt_vqvae_tpu_torch.pipeline",
                  "melspec_gpt_vqvae_tpu_torch.serving",
                  "melspec_gpt_vqvae_tpu_torch.sample",
                  "melspec_gpt_vqvae_tpu_torch.serve"}


@pytest.fixture(scope="module")
def tpipe():
    return tiny_pipelines()[2]


def _pipe(tpipe, **kw):
    return TP.GenerationPipeline(tpipe.exp, tpipe.gpt_params, tpipe.vq,
                                 tpipe.melgan, segments=2, chunk=3,
                                 bf16=False, **kw)


@pytest.mark.parametrize("sample", [False, True])
def test_none_and_false_give_equal_outputs_on_cpu(tpipe, sample):
    """use_kernels=None and False run the same plain versions on the CPU:
    equal tokens (greedy, and sampled for one seed), specs and wavs."""
    out = {}
    for switch in (None, False):
        pipe = _pipe(tpipe, use_kernels=switch)
        out[switch] = pipe.generate([0, 3, 1], torch.Generator().manual_seed(
            9), top_k=5, sample=sample)
    for key in ("tokens", "specs", "wavs"):
        np.testing.assert_array_equal(out[None][key], out[False][key])


def test_scope_is_not_seen_by_another_thread():
    seen = {}

    def read(name):
        seen[name] = _build.kernel_setting()

    with _build.kernels(False):
        t = threading.Thread(target=read, args=("other",))
        t.start()
        t.join()
        read("inside")
    read("after")

    def enter_true():
        with _build.kernels(True):
            barrier.wait()      # the main thread reads while it is set
            barrier.wait()

    barrier = threading.Barrier(2)
    t = threading.Thread(target=enter_true)
    t.start()
    barrier.wait()
    read("main_while_other_in_true")
    barrier.wait()
    t.join()
    assert seen == {"other": None, "inside": False, "after": None,
                    "main_while_other_in_true": None}


def test_scopes_nest_and_restore():
    with _build.kernels(False):
        with _build.kernels(None):
            assert _build.kernel_setting() is None
        assert _build.kernel_setting() is False
        with pytest.raises(RuntimeError), _build.kernels(True):
            raise RuntimeError("leaves the scope")
        assert _build.kernel_setting() is False
    with pytest.raises(ValueError, match="expected None, False or True"):
        with _build.kernels("off"):
            pass


def test_switch_on_raises_for_cpu_tensors(tpipe):
    cond = G.class_embed(tpipe.gpt_params, torch.tensor([0, 1]))
    with pytest.raises(ValueError, match="use_kernels=True"), \
            _build.kernels(True):
        G.gpt_generate(tpipe.gpt_params, tpipe.gcfg, None, cond, steps=3,
                       sample=False)
    with _build.kernels(False):
        G.gpt_generate(tpipe.gpt_params, tpipe.gcfg, None, cond, steps=3,
                       sample=False)


def test_session_and_graph_keys_record_the_setting(tpipe):
    """A session (its programs captured on the card) is keyed by the scope
    it was built in: the same request under another setting builds a
    session of its own, and each program records its setting."""
    params, cfg = tpipe.gpt_params, tpipe.gcfg
    cond = G.class_embed(params, torch.tensor([0, 1]))
    holder = decode_graph.DecodeGraphs()
    toks = {}
    for switch in (None, False, None):
        with _build.kernels(switch):
            toks[switch] = G.gpt_generate(params, cfg, None, cond, steps=5,
                                          sample=False, graph=holder)
    assert holder.captures == 2 and len(holder) == 2
    keys = list(holder._sessions)
    assert [k[-1] for k in keys] == [False, None]
    assert keys[0][:-1] == keys[1][:-1]
    assert [p.kernels for s in holder._sessions.values()
            for p in s.programs] == [False, None]
    torch.testing.assert_close(toks[None], toks[False], rtol=0, atol=0)
    # the speculative sessions alike
    spec = decode_graph.DecodeGraphs()
    for switch in (False, None):
        with _build.kernels(switch):
            gpt_speculative_generate(params, cfg, params, cfg, None, cond,
                                     cond, steps=5, gamma=2, sample=False,
                                     graph=spec)
    assert [k[-1] for k in spec._sessions] == [False, None]


def test_no_model_or_op_signature_takes_the_switch():
    """Only the pipeline, the serving layer, the CLIs and _build name
    ``use_kernels``: every other function and method of the port takes
    the switch from the scope."""
    offenders = []
    for name in PORT_MODULES:
        if name in SWITCH_HOLDERS:
            continue
        mod = importlib.import_module(name)
        for obj_name, obj in vars(mod).items():
            if getattr(obj, "__module__", None) != name:
                continue
            funcs = [(obj_name, obj)] if inspect.isfunction(obj) else []
            if inspect.isclass(obj):
                funcs = [(f"{obj_name}.{k}", v) for k, v in vars(obj).items()
                         if inspect.isfunction(v)]
            for fname, fn in funcs:
                if "use_kernels" in inspect.signature(fn).parameters:
                    offenders.append(f"{name}.{fname}")
    assert offenders == []


def test_pipeline_scope_covers_each_stage(tpipe, monkeypatch):
    """generate_tokens, decode_specs, vocode and tokenize each run inside
    the pipeline's scope: a wrapper called from any of them sees it."""
    seen = []
    real = _build.use_kernel

    def spy(*tensors):
        seen.append(_build.kernel_setting())
        return real(*tensors)
    monkeypatch.setattr(_build, "use_kernel", spy)
    pipe = _pipe(tpipe, use_kernels=False, int8_decode=False)
    toks, _ = pipe.generate_tokens([0, 1], None, sample=False)
    n = len(seen)
    pipe.vocode(pipe.decode_specs(toks))
    from melspec_gpt_vqvae_tpu_torch.configs import MelConfig
    pipe.tokenize(torch.zeros(1, 4096),
                  MelConfig(clip_samples=4096, trim_len=16))
    assert n > 0 and len(seen) > n and set(seen) == {False}
