"""The port's serving over a mesh (parallel/mesh.py's serving helpers,
models/gpt.py's decode over a ``model`` axis, ``GenerationPipeline(mesh=)``,
``GenerationService`` and the ``serve`` / ``sample --mesh`` CLIs) against
the JAX package: the pins of tests/test_parallel.py:36-107 and
tests/test_pipeline.py:79-99, at their geometry (2 layers, 4 heads, 32
wide; the pipeline's tiny round trip).

Two gloo worlds run once for the module (tests/torch_dist_worlds.py): four
ranks (``data=2,model=2`` and ``model=4``, then the pipeline at ``data=4``
and ``data=2,model=2``) and two (``data=2``, ``model=2``: sampled tokens).
Greedy tokens must equal the JAX package's one-device tokens exactly, for
float32 and for the int8 cache + int8 weights (whose row-cut products
all-reduce the activation scale with MAX and the int32 sums with SUM, so
they are the single device's bit for bit); sampled tokens equal the port's
one-process tokens for the same seed."""

import json
import os
import signal
import subprocess
import sys
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from melspec_gpt_vqvae_tpu.configs import GPTConfig
from melspec_gpt_vqvae_tpu.models import gpt as JG
from melspec_gpt_vqvae_tpu_torch import bridge
from melspec_gpt_vqvae_tpu_torch import configs as TC
from melspec_gpt_vqvae_tpu_torch import serve as serve_cli
from melspec_gpt_vqvae_tpu_torch import serving as TSV
from melspec_gpt_vqvae_tpu_torch.models import gpt as TG
from melspec_gpt_vqvae_tpu_torch.parallel import mesh as TM

import torch_dist_worlds as W
from test_torch_port_pipeline import tiny_pipelines
from test_torch_port_run_checkpoint import tiny_melgan

torch.set_num_threads(1)

CFG = GPTConfig(vocab_size=16, block_size=24, n_layer=2, n_head=4,
                n_embd=32, class_size=4)
STEPS, SEED, TOP_K = 6, 11, 5
MESHES4 = ({"data": 2, "model": 2}, {"model": 4})
MESHES2 = ({"data": 2}, {"model": 2})
# a model axis that does not divide the heads (parallel/mesh.py::
# head_range): 5 heads over model=4 (2, 1, 1, 1), 3 over model=2 (2, 1),
# each head 8 wide; the case's "heads" names the GPT, not a mesh axis
ODD = ({"model": 4, "heads": 5}, {"model": 2, "heads": 3})
REPO = Path(__file__).resolve().parents[1]


def _np(t):
    return np.asarray(t.detach() if isinstance(t, torch.Tensor) else t)


def _key(shape):
    return ",".join(f"{k}={v}" for k, v in shape.items())


def _gathered(outs, name, shape):
    """The global batch from each rank's rows: the data ranks' outputs in
    order (model coordinate 0 of each data coordinate)."""
    m = shape.get("model", 1)
    return np.concatenate([_np(outs[r][name])
                           for r in range(0, len(outs), m)])


def _references(cfg, cls, x, forced, prefix=""):
    """The port's tree of JAX's ``cfg`` GPT, the float32 and int8 configs,
    the class conditioning, and the JAX and one-process references under
    ``prefix``."""
    jparams = JG.init_gpt_params(jax.random.PRNGKey(0), cfg)
    params = bridge.gpt_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                               jparams))
    int8 = cfg.replace(cache_dtype="int8", decode_weight_dtype="int8")
    cfgs = {"f32": bridge.config_from_jax(cfg),
            "int8": bridge.config_from_jax(int8)}
    cond = TG.class_embed(params, torch.from_numpy(cls))
    ref = {}
    jcond = JG.class_embed(jparams, jnp.asarray(cls))
    for name, c in (("f32", cfg), ("int8", int8)):
        ref[f"{prefix}jax/{name}"] = np.asarray(JG.gpt_generate(
            jparams, c, jax.random.PRNGKey(3), jcond, None, steps=STEPS,
            sample=False, use_pallas=False))
        tc = cfgs[name]
        ref[f"{prefix}port/{name}"] = _np(TG.gpt_generate(
            params, tc, torch.Generator().manual_seed(SEED), cond,
            steps=STEPS, top_k=TOP_K, graph=True))
        ref[f"{prefix}port_greedy/{name}"] = _np(TG.gpt_generate(
            params, tc, None, cond, steps=STEPS, sample=False, graph=True))
        wq = (TG.quantize_block_weights(params["blocks"]) if name == "int8"
              else None)
        ref[f"{prefix}logits/{name}"] = W._forced_logits(params, tc, wq,
                                                         cond, forced)
    ref[f"{prefix}forward"] = np.asarray(JG.gpt_apply(
        jparams, cfg, jnp.asarray(x), use_pallas=False)[0])[:, -1]
    return params, cfgs, cond, ref


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Start the worlds, compute the JAX and one-process references
    meanwhile, join them."""
    tmp = tmp_path_factory.mktemp("torch_serve_mesh")
    rng = np.random.default_rng(0)
    cls = rng.integers(0, 4, (8,)).astype(np.int32)
    x = np.random.default_rng(1).integers(0, 16, (4, 10)).astype(np.int64)
    exp, jpipe, tpipe = tiny_pipelines()
    forced = torch.from_numpy(np.random.default_rng(2).integers(
        0, 16, (3, 8)))
    base = {"x": torch.from_numpy(x), "steps": STEPS, "seed": SEED,
            "top_k": TOP_K, "forced": forced}
    params, cfgs, cond, ref = _references(CFG, cls, x, forced)
    common = {**base, "params": params, "cond": cond, "cfgs": cfgs}
    W.write_inputs(tmp / "four", {
        **common, "meshes": MESHES4,
        "pipe_meshes": ({"data": 4}, {"data": 2, "model": 2}),
        "pipe_exp": tpipe.exp, "pipe_gpt": tpipe.gpt_params,
        "pipe_vq": tpipe.vq, "pipe_melgan": tpipe.melgan,
        "pipe_cls": np.asarray([0, 1, 2, 3], np.int32)})
    W.write_inputs(tmp / "two", {**common, "meshes": MESHES2})
    procs = {"four": W.spawn("serve", 4, tmp / "four"),
             "two": W.spawn("serve", 2, tmp / "two")}
    # heads the model axis does not divide, each in a world of its own
    for shape in ODD:
        world = _world(shape)
        oparams, ocfgs, ocond, oref = _references(
            CFG.replace(n_head=shape["heads"], n_embd=8 * shape["heads"]),
            cls, x, forced, f"{world}/")
        ref.update(oref)
        W.write_inputs(tmp / world, {**base, "params": oparams,
                                     "cond": ocond, "cfgs": ocfgs,
                                     "meshes": (_mesh_shape(shape),)})
        procs[world] = W.spawn("serve", shape["model"], tmp / world)

    cache = TG.init_kv_cache(cfgs["f32"], 8, max_len=1 + STEPS)
    ref["bytes"] = W._tree_bytes(params) + W._tree_bytes(
        {k: v for k, v in cache.items() if k != "len"})
    ref["pipe"] = jpipe.generate(np.asarray([0, 1, 2, 3], np.int32),
                                 jax.random.PRNGKey(5), sample=False)
    out = {w: W.join(p, tmp / w) for w, p in procs.items()}
    return out, ref


def _world(shape):
    """The world a case ran in: ``odd{heads}`` for an odd head count,
    else the four-rank world for 2-axis and ``model=4`` meshes, the
    two-rank one for the rest."""
    if "heads" in shape:
        return f"odd{shape['heads']}"
    return "four" if len(shape) == 2 or shape.get("model") == 4 else "two"


def _mesh_shape(shape):
    return {k: v for k, v in shape.items() if k != "heads"}


def _ref_key(shape, name):
    return f"{_world(shape)}/{name}" if "heads" in shape else name


# ------------------------------ decode ---------------------------------------

@pytest.mark.parametrize("name", ["f32", "int8"])
@pytest.mark.parametrize("shape", MESHES4 + MESHES2 + ODD, ids=_key)
def test_tp_and_dp_greedy_generation_equals_one_device(worlds, shape, name):
    """Greedy tokens over the mesh equal the JAX package's one-device
    tokens exactly (tests/test_parallel.py:36-48, 63-85), in the eager loop
    and the device-position loop, on every model rank of a data
    coordinate; also where the model axis cuts the heads unevenly."""
    out, ref = worlds
    outs = out[_world(shape)]
    m = shape.get("model", 1)
    for graph in (False, True):
        name_g = f"greedy/{_key(_mesh_shape(shape))}/{name}/{graph}"
        np.testing.assert_array_equal(_gathered(outs, name_g, shape),
                                      ref[_ref_key(shape, f"jax/{name}")])
        for r, o in enumerate(outs):   # model replicas agree
            assert torch.equal(o[name_g], outs[r - r % m][name_g])
    np.testing.assert_array_equal(ref[_ref_key(shape, f"port_greedy/{name}")],
                                  ref[_ref_key(shape, f"jax/{name}")])


@pytest.mark.parametrize("shape", MESHES4 + MESHES2 + ODD, ids=_key)
def test_int8_decode_logits_are_one_process_bit_for_bit(worlds, shape):
    """With the int8 cache and weights, a prefill and three teacher-forced
    decode steps (host and device positions) give the one-process
    logits bit for bit on every rank: the row-cut products reduce the
    activation scale (MAX) and the int32 sums (SUM) before the rescale,
    and the prefill runs the single device's products on gathered
    layers.  (A float sum after the rescale keeps greedy tokens at this
    size but not these bits.)  The float32 logits are within 2e-5.  The
    same where the heads are cut unevenly (``ODD``)."""
    out, ref = worlds
    outs = out[_world(shape)]
    m = shape.get("model", 1)
    for name in ("int8", "f32"):
        key = f"logits/{_key(_mesh_shape(shape))}/{name}"
        want = ref[_ref_key(shape, f"logits/{name}")]
        got = torch.cat([outs[r][key] for r in range(0, len(outs), m)], 1)
        if name == "int8":
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
        for r, o in enumerate(outs):   # model replicas agree bit for bit
            assert torch.equal(o[key], outs[r - r % m][key])


@pytest.mark.parametrize("name", ["f32", "int8"])
@pytest.mark.parametrize("shape", MESHES4 + MESHES2 + ODD, ids=_key)
def test_sampled_tokens_equal_one_process(worlds, shape, name):
    """Every rank draws the global batch's uniforms from the same seed and
    takes its rows: the sampled tokens are the port's one-process tokens
    for the seed (under ``data=2`` and under ``model=2``, and the 4-rank
    meshes)."""
    out, ref = worlds
    outs = out[_world(shape)]
    got = _gathered(outs, f"sampled/{_key(_mesh_shape(shape))}/{name}",
                    shape)
    np.testing.assert_array_equal(got, ref[_ref_key(shape, f"port/{name}")])


@pytest.mark.parametrize("shape", MESHES4 + ODD, ids=_key)
def test_tp_prefill_forward_matches_jax(worlds, shape):
    """The serving forward (``gpt_prefill`` over this rank's heads, the
    row-cut products summed over the model group) within 2e-5 of JAX's
    one-device ``gpt_apply`` (tests/test_parallel.py:50-60)."""
    out, ref = worlds
    got = _gathered(out[_world(shape)],
                    f"prefill/{_key(_mesh_shape(shape))}", shape)
    np.testing.assert_allclose(got, ref[_ref_key(shape, "forward")],
                               atol=2e-5)


def test_tp_generation_shards_memory(worlds):
    """Per-rank bytes of the parameters plus the KV cache at ``model=4``
    below 0.55 of one device's (tests/test_parallel.py:88-107): the cache
    is cut over heads, the weights over the Megatron dims."""
    out, ref = worlds
    for o in out["four"]:
        assert o["bytes/model=4"] < 0.55 * ref["bytes"], (
            o["bytes/model=4"], ref["bytes"])


def test_served_shards_cut_the_full_weights():
    """``shard_block_weights`` cuts the FULL weights' int8 copy: a
    column-cut product's scales go with its columns, a row-cut product's
    stay whole; ``shard_gpt_for_serving`` holds contiguous leaves."""
    mesh = TM.Mesh({"model": 2}, "cpu")   # the rules alone, no group
    params = bridge.gpt_params_from_jax(jax.tree_util.tree_map(
        np.asarray, JG.init_gpt_params(jax.random.PRNGKey(0), CFG)))
    full = TG.quantize_block_weights(params["blocks"])
    local = TM.shard_block_weights(mesh, full, CFG.n_head)
    assert torch.equal(local["attn_proj"]["s"], full["attn_proj"]["s"])
    assert torch.equal(local["mlp_down"]["q"], full["mlp_down"]["q"][:, :64])
    assert torch.equal(local["mlp_up"]["s"], full["mlp_up"]["s"][:, :64])
    assert torch.equal(local["attn_qkv"]["s"], torch.cat(
        [full["attn_qkv"]["s"][:, i * 32:i * 32 + 16] for i in range(3)], -1))
    for leaf in local.values():   # the layout the int8 product takes
        assert leaf["q"].transpose(1, 2).is_contiguous()
    shard = TM.shard_gpt_for_serving(mesh, params, CFG.n_head)
    assert shard["blocks"]["mlp_up"]["w"].is_contiguous()
    assert shard["blocks"]["mlp_up"]["w"].shape == (2, 32, 64)
    assert shard["head"]["w"] is params["head"]["w"]


@pytest.mark.parametrize("n_head,m", [(5, 4), (3, 2), (23, 4)])
def test_uneven_served_shards_rejoin_the_full_weights(n_head, m):
    """Heads the model axis does not divide: each rank's qkv columns and
    ``attn_proj`` rows are its heads (``head_range``), its int8 copy cut
    with them from the full weights' quantisation, the MLP cut evenly;
    the ranks' parts, joined in order (``tp_gather``), are the full leaves
    and the full int8 copy."""
    cfg = TC.GPTConfig(vocab_size=16, block_size=8, n_layer=2,
                       n_head=n_head, n_embd=8 * n_head)
    params = TG.init_gpt_params(cfg, torch.Generator().manual_seed(0))
    full_q = TG.quantize_block_weights(params["blocks"])
    shards, quant = [], []
    for r in range(m):
        mesh = TM.Mesh({"model": m}, "cpu")   # the rules alone, no group
        mesh.coords = {"model": r}
        shards.append(TM.shard_gpt_for_serving(mesh, params, n_head))
        quant.append(TM.shard_block_weights(mesh, full_q, n_head))
        lo, n = TM.head_range(n_head, m, r)
        assert TG.local_heads(shards[-1], cfg, mesh) == n
        assert torch.equal(shards[-1]["blocks"]["attn_proj"]["w"],
                           params["blocks"]["attn_proj"]["w"][
                               :, lo * 8:(lo + n) * 8])
    for leaf in TG.BLOCK_MATRICES:
        name = f"blocks/{leaf}/w"
        assert torch.equal(TM.tp_gather(name, [
            sh["blocks"][leaf]["w"] for sh in shards]),
            params["blocks"][leaf]["w"]), leaf
        assert torch.equal(TM.tp_gather(name, [q[leaf]["q"] for q in quant]),
                           full_q[leaf]["q"]), leaf
        if not TM.row_cut(TM.tp_rule(name)):
            assert torch.equal(TM.tp_gather(name, [q[leaf]["s"]
                                                   for q in quant]),
                               full_q[leaf]["s"]), leaf


# ------------------------------ the pipeline ---------------------------------

@pytest.mark.parametrize("shape", [{"data": 4}, {"data": 2, "model": 2}],
                         ids=_key)
def test_mesh_pipeline_matches_jax_single_device(worlds, shape):
    """GenerationPipeline(mesh=): rank 0 gets the whole batch, tokens
    exactly the JAX pipeline's one-device tokens and wavs within 1e-5
    (tests/test_pipeline.py:79-99); every other rank gets None."""
    out, ref = worlds
    got = out["four"][0][f"pipe/{_key(shape)}"]
    np.testing.assert_array_equal(got["tokens"], ref["pipe"]["tokens"])
    np.testing.assert_allclose(got["specs"], ref["pipe"]["specs"], atol=1e-5)
    np.testing.assert_allclose(got["wavs"], ref["pipe"]["wavs"], atol=1e-5)
    assert all(o[f"pipe/{_key(shape)}"] is None for o in out["four"][1:])


def test_service_refuses_a_batch_the_data_axis_does_not_divide():
    """The JAX service's refusal (serving.py:203-206 there)."""
    exp, _, tpipe = tiny_pipelines()
    tpipe.mesh = TM.Mesh({"data": 4}, "cpu")   # the rule alone, no group
    with pytest.raises(SystemExit, match=r"data axis \(4\) must divide "
                                         r"--batch \(6\)"):
        TSV.GenerationService(exp, tpipe, batch=6)
    assert TSV.GenerationService(exp, tpipe, batch=8).batch == 8


# ------------------------------ the CLIs -------------------------------------

SMALL = "n_layer=1,n_head=2,n_embd=32"


def _launch(module, argv, cwd, nproc=2):
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env["PYTHONPATH"] = str(REPO) + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(nproc), "-m", module, *argv],
        cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def _finish(proc, timeout=240):
    try:
        text, _ = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    return proc.returncode, text


def test_sample_and_serve_mesh_clis_under_a_gloo_launch(tmp_path):
    """``sample --mesh data=2`` and ``serve --mesh model=2`` under a
    two-process torchrun on the CPU: sample pads its tail batch (3 clips
    on a data axis of 2), writes only the real clips, from rank 0, and
    their greedy codes are one process's; serve answers on rank 0 and an
    interrupt of rank 0 stops both ranks with exit code 0."""
    tiny_melgan(tmp_path / "melgan")
    common = ["--init_random", "--override", SMALL, "--device", "cpu",
              "--vocoder_ckpt", str(tmp_path / "melgan")]
    proc = _launch("melspec_gpt_vqvae_tpu_torch.sample", [
        *common, "--mesh", "data=2", "--classes", "0,3,1", "--num", "1",
        "--deterministic", "--save_codes", "--out_dir", "mesh"], tmp_path)
    rc, text = _finish(proc)
    assert rc == 0, text[-3000:]
    summary = json.loads([ln for ln in text.splitlines()
                          if ln.startswith('{"written"')][-1])
    assert summary["written"] == 3
    names = sorted(p.name for p in (tmp_path / "mesh").iterdir())
    assert names == ["class00_000.wav", "class00_000_codes.npy",
                     "class01_000.wav", "class01_000_codes.npy",
                     "class03_000.wav", "class03_000_codes.npy"]
    _, pipe = TSV.build_pipeline("vas", init_random=True, override=SMALL,
                                 device="cpu", vocoder_ckpt=str(
                                     tmp_path / "melgan"))
    toks, _ = pipe.generate_tokens([0, 3, 1], None, sample=False)
    for i, c in enumerate((0, 3, 1)):
        np.testing.assert_array_equal(
            np.load(tmp_path / "mesh" / f"class{c:02d}_000_codes.npy"),
            toks[i].numpy())

    proc = _launch("melspec_gpt_vqvae_tpu_torch.serve", [
        *common, "--mesh", "model=2", "--port", "0", "--no_warmup",
        "--batch", "2"], tmp_path)
    try:
        line = ""
        while "serving on" not in line:
            line = proc.stdout.readline()
            assert line or proc.poll() is None, "serve exited early"
            assert proc.poll() is None, line
        url = line.split()[2]
        pid = int(line.rsplit("pid ", 1)[1].rstrip(")\n"))
        health = json.loads(urllib.request.urlopen(url + "/healthz",
                                                   timeout=60).read())
        assert health["batch"] == 2 and health["platform"] == "cpu"
        req = urllib.request.Request(
            url + "/generate", json.dumps(
                {"classes": [0, 3], "deterministic": True}).encode(),
            {"Content-Type": "application/json"})
        body = json.loads(urllib.request.urlopen(req, timeout=120).read())
        assert len(body["clips"]) == 2
        os.kill(pid, signal.SIGINT)
    except BaseException:
        proc.kill()
        raise
    rc, text = _finish(proc, 120)
    assert rc == 0, text[-3000:]


def test_serve_refuses_artifact_with_mesh():
    """The JAX serve.py's refusal of ``--artifact`` with ``--mesh``, before
    anything is built."""
    with pytest.raises(SystemExit, match="single-device"):
        serve_cli.start(["--init_random", "--override", SMALL, "--mesh",
                         "data=2", "--artifact", "none.pt2", "--device",
                         "cpu"])
