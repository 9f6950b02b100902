"""A served mesh places only shards on the device: ``build_pipeline(
mesh_spec=)`` keeps the GPT tree on the host, and each rank cuts it there
leaf by leaf -- the int8 block copy quantised over each matrix's whole
``in`` axis, then cut with its scales -- and moves its own parts alone.

A gloo world of two ranks (tests/torch_dist_worlds.py) builds the pipeline
under ``model=2`` from seeded random weights at a narrow VAS geometry (2
layers, 4 heads, 32 wide), float32 and int8 (cache and weights), with the
device placement recorded by a ``TorchFunctionMode`` (every ``.to`` or
``.cuda`` with a device, by whichever module): no full (L, in, out) block leaf,
float or int8, may reach the device.  The greedy tokens must
equal the meshless pipeline's and the JAX package's one-device tokens on
the same weights."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from melspec_gpt_vqvae_tpu import configs as JC
from melspec_gpt_vqvae_tpu.models import gpt as JG
from melspec_gpt_vqvae_tpu_torch import pipeline as TP
from melspec_gpt_vqvae_tpu_torch import serving as TSV
from melspec_gpt_vqvae_tpu_torch.configs import load_preset, parse_overrides
from melspec_gpt_vqvae_tpu_torch.models import gpt as TG
from melspec_gpt_vqvae_tpu_torch.parallel import mesh as TM

import torch_dist_worlds as W

torch.set_num_threads(1)

OVERRIDE = "n_layer=2,n_head=4,n_embd=32"
SEED = 3
CLS = [0, 5, 2, 7, 1, 3]
VARIANTS = {"f32": {}, "int8": {"kv_cache": "int8", "int8_weights": 1}}


def _full_block_shapes(cfg):
    d, L = cfg.n_embd, cfg.n_layer
    return {(L, d, 3 * d), (L, d, d), (L, d, 4 * d), (L, 4 * d, d)}


@pytest.fixture(scope="module")
def placement(tmp_path_factory):
    """The two-rank world, and meanwhile the meshless pipeline's and the
    JAX package's greedy tokens on the same seeded weights."""
    tmp = tmp_path_factory.mktemp("torch_served_placement")
    W.write_inputs(tmp, {"variants": VARIANTS, "override": OVERRIDE,
                         "seed": SEED, "mesh_spec": "model=2", "cls": CLS})
    procs = W.spawn("served_placement", 2, tmp)

    ref = {}
    exp = load_preset("GPT", "vas", **parse_overrides(OVERRIDE))
    params = TG.init_gpt_params(exp.model.replace(dtype="float32"),
                                torch.Generator().manual_seed(SEED))
    jparams = jax.tree_util.tree_map(lambda t: t.numpy(), params)
    jcfg = JC.load_preset("GPT", "vas", **JC.parse_overrides(OVERRIDE)).model
    jcond = JG.class_embed(jparams, jnp.asarray(CLS, jnp.int32))
    for name, kw in VARIANTS.items():
        mode, placed = W.placement_recorder()
        with mode:
            _, pipe = TSV.build_pipeline("vas", init_random=True,
                                         override=OVERRIDE, seed=SEED,
                                         device="cpu", **kw)
        assert pipe.mesh is None
        ref[f"placed/{name}"] = placed
        ref[f"meshless/{name}"] = pipe.generate_tokens(
            CLS, None, sample=False)[0].numpy()
        q = "int8" if kw else "auto"
        c = dataclasses.replace(jcfg, dtype="float32", cache_dtype=q,
                                decode_weight_dtype=q)
        ref[f"jax/{name}"] = np.asarray(JG.gpt_generate(
            jparams, c, jax.random.PRNGKey(0), jcond, None, steps=265,
            sample=False, use_pallas=False, segments=8))
    return W.join(procs, tmp), ref, exp.model


@pytest.mark.parametrize("name", list(VARIANTS))
def test_mesh_build_places_no_full_block_leaf(placement, name):
    """Each rank placed its own parts alone: the cut block leaves (float
    and, for int8, the quantised copy) are there and no full (L, in, out)
    block shape is -- which the recorder does see when the meshless
    pipeline places the whole tree."""
    outs, ref, cfg = placement
    full = _full_block_shapes(cfg)
    assert full <= {s for s, _ in ref[f"placed/{name}"]}
    L, d = cfg.n_layer, cfg.n_embd
    cut = {(L, d, 3 * d // 2), (L, d // 2, d), (L, d, 2 * d), (L, 2 * d, d)}
    for o in outs:
        placed = o[f"placed/{name}"]
        shapes = {s for s, _ in placed if len(s) == 3}
        assert not shapes & full, shapes & full
        assert cut <= shapes, (cut, shapes)
        int8 = {s for s, dt in placed if dt == "torch.int8"}
        assert int8 == (cut if name == "int8" else set())
        assert o[f"device/{name}"] == "cpu"


@pytest.mark.parametrize("name", list(VARIANTS))
def test_mesh_built_from_the_host_equals_meshless_and_jax(placement, name):
    """Greedy tokens of ``build_pipeline(mesh_spec="model=2")`` built from
    the host tree: on both ranks the meshless pipeline's, which are the
    JAX package's one-device tokens, float32 and int8."""
    outs, ref, _ = placement
    np.testing.assert_array_equal(ref[f"meshless/{name}"], ref[f"jax/{name}"])
    for o in outs:
        np.testing.assert_array_equal(o[f"tokens/{name}"].numpy(),
                                      ref[f"meshless/{name}"])


@pytest.mark.parametrize("rank", [0, 1])
def test_host_quantised_then_cut_equals_the_cut_of_the_full_copy(rank):
    """``_served_weights`` (each matrix quantised whole where it lies, cut,
    placed one at a time) gives ``shard_block_weights(quantize_block_
    weights(full))`` bit for bit, in the int8 product's column-major
    layout, and the float leaves of ``shard_gpt_for_serving``."""
    exp = load_preset("GPT", "vas", **parse_overrides(OVERRIDE))
    cfg = exp.model.replace(dtype="float32", decode_weight_dtype="int8")
    params = TG.init_gpt_params(cfg, torch.Generator().manual_seed(SEED))
    mesh = TM.Mesh({"model": 2}, "cpu")   # the rules alone, no group
    mesh.coords = {"model": rank}
    local, wq = TP._served_weights(mesh, params, cfg, torch.device("cpu"))
    ref = TM.shard_block_weights(mesh, TG.quantize_block_weights(
        params["blocks"]), cfg.n_head)
    assert set(wq) == set(ref) == set(TG.BLOCK_MATRICES)
    for name in TG.BLOCK_MATRICES:
        for f in ("q", "s"):
            assert wq[name][f].dtype == ref[name][f].dtype
            assert torch.equal(wq[name][f], ref[name][f]), (name, f)
        assert wq[name]["q"].transpose(1, 2).is_contiguous()
    got = dict(_leaves(local))
    for name, t in _leaves(TM.shard_gpt_for_serving(mesh, params,
                                                    cfg.n_head)):
        assert torch.equal(got.pop(name), t), name
    assert not got


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}/{k}"
        if isinstance(v, dict):
            yield from _leaves(v, name)
        else:
            yield name, v


def test_served_device_is_the_mesh_s_never_the_host_tree_s():
    """Over a mesh the pipeline's device is the one passed, else the
    mesh's own: a host tree under a mesh on the card is never served on
    the CPU, and a device of another kind than the mesh's is refused,
    before any weight is placed."""
    card = TM.Mesh({"model": 1}, "cuda")   # no group: the rule alone
    assert TP._served_device(card, None) == torch.device("cuda")
    assert TP._served_device(TM.Mesh({"model": 1}, "cpu"),
                             None) == torch.device("cpu")
    with pytest.raises(ValueError, match="mesh's kind"):
        TP._served_device(card, "cpu")
    exp = load_preset("GPT", "vas", **parse_overrides(OVERRIDE))
    params = TG.init_gpt_params(exp.model.replace(dtype="float32"),
                                torch.Generator().manual_seed(SEED))
    mode, placed = W.placement_recorder()
    with mode, pytest.raises(ValueError, match="mesh's kind"):
        TP.GenerationPipeline(exp, params, None, None, mesh=card,
                              device="cpu")
    assert placed == []
