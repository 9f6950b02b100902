"""Speculative decoding: a small draft GPT proposes ``gamma`` tokens per
round, the target verifies them in one chunked cached forward, and a
corrected accept/reject step keeps the output distributed exactly as the
target's (speculative sampling, Leviathan et al. 2023 / Chen et al. 2023).

Counterpart of melspec_gpt_vqvae_tpu/models/speculative.py, with the same
three equivalences (tests/test_torch_port_speculative.py):

  * the chunk forward equals the same tokens fed one by one through
    ``gpt_decode_step`` (logits and cache);
  * draft == target gives exactly ``gpt_generate``'s tokens for the same
    generator: both draw the per-position sampling uniforms up front as one
    (steps, B, V) tensor, and position i samples from row i (the JAX
    package's per-position keys);
  * greedy mode (``sample=False``) gives exactly greedy ``gpt_generate``'s
    tokens for any draft.

The batch advances by the minimum acceptance count over its lanes each
round; lanes that accepted more keep their accepted token at the cut.
The round loop runs on the host, which reads that count once a round.

Over a mesh (``mesh=``: the target and the draft cut over ``model``, the
batch over ``data``) every rank runs the same rounds: the minimum is
all-reduced over the data group each round, and every uniform is drawn
for the global batch and cut to this rank's rows, so the tokens, rounds
and acceptance are the single device's.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import _build
from ..configs import GPTConfig

from ..ops import decode_attention as _da
from ..ops.sampling import categorical, filtered_log_probs, sample_logits
from . import decode_graph
from .gpt import (Params, _check_full, _layer, _layer_norm, _local_heads,
                  _mm, _tp, _write_kv, draw_uniforms, gpt_decode_step,
                  gpt_prefill, init_kv_cache, local_heads,
                  quantize_block_weights, split_pairs)


def gpt_decode_chunk(params: Params, cfg: GPTConfig, cache: Dict,
                     tokens: torch.Tensor, wq: Optional[Dict] = None, *,
                     mesh=None) -> Tuple[torch.Tensor, Dict]:
    """Cached forward over a chunk of c tokens at positions ``cache['len']
    .. len + c - 1``, causal within the chunk and over the cached prefix
    (speculative.py:48-174).  tokens (B, c) -> (logits (B, c, out), cache
    with len += c).  Over a model-dtype cache the attention is plain torch,
    as it is XLA einsums in the JAX package; over a quantised cache it is
    the single step's own attention (kernel E on the card) at each of the
    c positions, which keeps greedy speculative decoding exact there too.
    The attention math is the JAX chunk's either way.  ``cache["len"]`` is
    a Python int or, for a captured program, a one-element int64 tensor
    that is advanced in place, as in ``gpt_decode_step``, whose ``mesh``
    this takes too (this rank's heads, the row-cut products summed)."""
    pos = cache["len"]
    on_device = isinstance(pos, torch.Tensor)
    b, c = tokens.shape
    tp = _tp(mesh)
    hd = cfg.head_dim
    # positions past the block clamp, as the JAX chunk's do
    pidx = torch.clamp(pos + torch.arange(c, device=tokens.device), 0,
                       params["pos_emb"].shape[0] - 1)
    x = params["tok_emb"][tokens.long()] + params["pos_emb"][pidx][None]
    quantised = cfg.cache_dtype in ("int8", "int4")
    if not quantised:
        valid = (torch.arange(cache["k"].shape[3], device=x.device)[None, :]
                 <= (pos + torch.arange(c, device=x.device))[:, None])
        scale = 1.0 / hd ** 0.5
    qc = [cache[n] for n in ("k", "v", "k_scale", "v_scale")] \
        if quantised else None
    pairs = split_pairs(cfg, b, mesh)
    for l in range(cfg.n_layer):
        p = _layer(params["blocks"], l)
        pw = None if wq is None else _layer(wq, l)
        nh = _local_heads(p, cfg, tp)
        h = _layer_norm(x, p["ln1_s"], p["ln1_b"])
        q, k, v = (a.reshape(b, c, nh, hd).transpose(1, 2)        # (B,H,c,hd)
                   for a in _mm(h, p, pw, "attn_qkv", on_device).chunk(3, -1))
        # kernel E once per chunk position: position j attends t <= pos + j
        # of the same cache the single step reads, so a verified token's
        # attention is bit for bit the step's.  On a device position the
        # launch of position j also quantises and writes row pos + j (the
        # rows before it are there by then); on a host position the whole
        # chunk is written first.
        if quantised and on_device:
            o = torch.stack([_da.decode_attend_int8(
                q[:, :, j], *qc, l, pos, k_new=k[:, :, j], v_new=v[:, :, j],
                pos_offset=j, split_pairs=pairs) for j in range(c)], dim=2)
        elif quantised:
            _write_kv(cache, cfg, l, pos, k, v)
            o = torch.stack([_da.decode_attend_int8(
                q[:, :, j], *qc, l, pos + j, split_pairs=pairs)
                for j in range(c)], dim=2)
        else:
            _write_kv(cache, cfg, l, pos, k, v)
            k_l, v_l = cache["k"][l], cache["v"][l]
            scores = (q.float() @ k_l.float().transpose(-1, -2)) * scale
            probs = torch.softmax(torch.where(valid, scores, -1e30), dim=-1)
            o = probs.to(v_l.dtype).float() @ v_l.float()
        o = o.to(x.dtype).transpose(1, 2).reshape(b, c, nh * hd)
        x = x + _mm(o, p, pw, "attn_proj", on_device, tp)
        h2 = _layer_norm(x, p["ln2_s"], p["ln2_b"])
        x = x + _mm(F.gelu(_mm(h2, p, pw, "mlp_up", on_device)),
                    p, pw, "mlp_down", on_device, tp)
    if on_device:
        pos.add_(c)
    else:
        cache["len"] = pos + c
    x = _layer_norm(x, params["ln_f_s"], params["ln_f_b"])
    return x @ params["head"]["w"], cache


class _EagerRounds:
    """A round's two model passes as the eager loop runs them: gamma + 1
    ``gpt_decode_step``s of the draft and one ``gpt_decode_chunk`` of the
    target, at host positions."""

    def __init__(self, params, cfg, wq, draft_params, draft_cfg, dwq, batch,
                 max_len, device, mesh=None):
        self.target = (params, cfg, wq)
        self.draft = (draft_params, draft_cfg, dwq)
        self.mesh = mesh
        self.t_cache = init_kv_cache(cfg, batch, max_len=max_len,
                                     device=device,
                                     heads=local_heads(params, cfg, mesh))
        self.d_cache = init_kv_cache(
            draft_cfg, batch, max_len=max_len, device=device,
            heads=local_heads(draft_params, draft_cfg, mesh))

    def prefill(self, given, cond_emb, draft_cond_emb):
        params, cfg, _ = self.target
        t_logits, self.t_cache = gpt_prefill(params, cfg, self.t_cache,
                                             given, cond_emb, mesh=self.mesh)
        _, self.d_cache = gpt_prefill(self.draft[0], self.draft[1],
                                      self.d_cache, given, draft_cond_emb,
                                      mesh=self.mesh)
        return t_logits

    def begin(self, u_pos, start):
        """Nothing to load: the passes take their positions and uniforms
        from the host."""

    def propose(self, y_prev, produced, gamma, draw, skw):
        """(xs (B, gamma), q_lps (B, gamma, V)): the draft's proposals
        after ``y_prev`` and the log-probabilities they were drawn from;
        ``draw(logits, i)`` samples output position i."""
        params, cfg, wq = self.draft
        tok, xs, q_lps = y_prev, [], []
        for i in range(gamma):
            logits, self.d_cache = gpt_decode_step(params, cfg, self.d_cache,
                                                   tok, wq, mesh=self.mesh)
            tok = draw(logits, produced + i)
            xs.append(tok)
            q_lps.append(filtered_log_probs(logits.float(), **skw))
        # catch-up: when every proposal is accepted the rewound draft cache
        # must also hold x_gamma's keys and values
        _, self.d_cache = gpt_decode_step(params, cfg, self.d_cache, tok, wq,
                                          mesh=self.mesh)
        return torch.stack(xs, dim=1), torch.stack(q_lps, dim=1)

    def verify(self, chunk):
        params, cfg, wq = self.target
        logits_c, self.t_cache = gpt_decode_chunk(params, cfg, self.t_cache,
                                                  chunk, wq, mesh=self.mesh)
        return logits_c

    def rewind(self, length):
        self.t_cache["len"] = self.d_cache["len"] = length


class _SpeculativeSession:
    """The same two passes as programs over static buffers
    (models/decode_graph.py): one draft step with the draw and the
    log-probabilities behind it, replayed gamma + 1 times a round (the
    last is the catch-up step, its draw unused), and the target's chunk of
    gamma + 1 tokens.  Both caches keep their position on the device; the
    accept / reject arithmetic stays eager and rewinds them."""

    def __init__(self, params, cfg, wq, draft_params, draft_cfg, dwq, batch,
                 max_len, steps, gamma, sample, skw, device, mesh=None):
        self.device = device
        self.target = (params, cfg, wq)
        self.draft = (draft_params, draft_cfg, dwq)
        self.held = (params, wq, draft_params, dwq)
        self.mesh = mesh

        def cache_of(p, c):
            cache = init_kv_cache(c, batch, max_len=max_len, device=device,
                                  heads=local_heads(p, c, mesh))
            cache["len"] = torch.zeros(1, dtype=torch.int64, device=device)
            return cache
        self.t_cache = cache_of(params, cfg)
        self.d_cache = cache_of(draft_params, draft_cfg)
        head = params["head"]["w"]
        vocab = head.shape[1]

        def ints(*shape):
            return torch.zeros(shape, dtype=torch.int64, device=device)
        self.tok, self.idx, self.slot = ints(batch), ints(1), ints(1)
        self.xs = ints(batch, gamma + 1)
        self.q_lps = torch.zeros((batch, gamma + 1, vocab), device=device)
        self.u_pos = (torch.full((steps, batch, vocab), 0.5, device=device)
                      if sample else None)
        self.chunk = ints(batch, gamma + 1)
        self.logits_c = torch.zeros((batch, gamma + 1, vocab),
                                    dtype=head.dtype, device=device)

        def draft_step():
            logits, _ = gpt_decode_step(draft_params, draft_cfg,
                                        self.d_cache, self.tok, dwq,
                                        mesh=mesh)
            u = (None if self.u_pos is None else self.u_pos.index_select(
                0, self.idx.clamp(max=steps - 1))[0])
            tok = sample_logits(None, logits, sample=sample, u=u, **skw)
            self.xs.index_copy_(1, self.slot, tok[:, None])
            self.q_lps.index_copy_(1, self.slot, filtered_log_probs(
                logits.float(), **skw)[:, None])
            self.tok.copy_(tok)
            self.idx.add_(1)
            self.slot.add_(1)

        def reset_draft():
            self.d_cache["len"].zero_()
            self.idx.zero_()
            self.slot.zero_()

        def chunk_pass():
            logits_c, _ = gpt_decode_chunk(params, cfg, self.t_cache,
                                           self.chunk, wq, mesh=mesh)
            self.logits_c.copy_(logits_c)

        pool = (torch.cuda.graph_pool_handle() if device.type == "cuda"
                else None)
        warm = None if mesh is None else mesh.warm_collectives
        self.draft_program = decode_graph.Program(
            draft_step, device, reset_draft, pool, warm)
        self.chunk_program = decode_graph.Program(
            chunk_pass, device, self.t_cache["len"].zero_, pool, warm)
        self.programs = [self.draft_program, self.chunk_program]

    def prefill(self, given, cond_emb, draft_cond_emb):
        for cache in (self.t_cache, self.d_cache):
            for name, t in cache.items():
                if name != "len":
                    t.zero_()
        # the prefill writes at host positions and sets a host length:
        # hand it the session's tensors under a dict of its own
        t_logits, _ = gpt_prefill(self.target[0], self.target[1],
                                  dict(self.t_cache), given, cond_emb,
                                  mesh=self.mesh)
        gpt_prefill(self.draft[0], self.draft[1], dict(self.d_cache), given,
                    draft_cond_emb, mesh=self.mesh)
        return t_logits

    def begin(self, u_pos, start):
        """Load a request: the per-position uniforms and the prompt length
        (the prefill has written the caches)."""
        if self.u_pos is not None:
            self.u_pos.copy_(u_pos)
        self.rewind(start)

    def propose(self, y_prev, produced, gamma, draw, skw):
        """As ``_EagerRounds.propose``; the draw is part of the program."""
        self.tok.copy_(y_prev)
        self.idx.fill_(produced)
        self.slot.zero_()
        for _ in range(gamma + 1):
            self.draft_program.replay()
        return self.xs[:, :gamma], self.q_lps[:, :gamma]

    def verify(self, chunk):
        self.chunk.copy_(chunk)
        self.chunk_program.replay()
        return self.logits_c

    def rewind(self, length):
        self.t_cache["len"].fill_(length)
        self.d_cache["len"].fill_(length)


def gpt_speculative_generate(
        params: Params, cfg: GPTConfig, draft_params: Params,
        draft_cfg: GPTConfig, generator: Optional[torch.Generator],
        cond_emb: torch.Tensor, draft_cond_emb: torch.Tensor,
        given: Optional[torch.Tensor] = None, *, steps: int, gamma: int = 4,
        temperature: float = 1.0, top_k: Optional[int] = None,
        top_p: Optional[float] = None, sample: bool = True,
        wq: Optional[Dict] = None, draft_wq: Optional[Dict] = None,
        graph=None, mesh=None) -> Tuple[torch.Tensor, Dict[str, int]]:
    """KV-cached speculative generation (speculative.py:177-344).  Returns
    ``(tokens (B, T0 + steps) int64, stats)``, the tokens distributed
    exactly as ``gpt_generate(params, cfg, ...)``'s, stats = {"rounds",
    "drafted", "accepted"} (acceptance rate = accepted / drafted).

    Randomness: the per-position uniforms (steps, B, V) are drawn first,
    as ``gpt_generate`` draws them; then, from the same generator, one row
    of acceptance uniforms and one row of residual-draw uniforms per round
    (a round emits at least one token, so ``steps`` rows suffice).

    ``wq`` / ``draft_wq`` are the two models' int8 block weights where the
    caller keeps them (else quantised per call).  ``graph`` chooses how a
    round's model passes run, as in ``gpt_generate``: None is the captured
    programs on CUDA tensors and the eager passes on CPU tensors, False
    the eager passes, True the device-position passes (captured on the
    card, run eagerly on the CPU), a ``decode_graph.DecodeGraphs`` keeps
    the captures.  The accept / reject arithmetic is eager either way and
    reads one number a round on the host.  The kernel switch is the
    enclosing ``_build.kernels`` scope's, for both models' passes; the
    captured session is keyed by it.

    ``mesh``: as ``gpt_generate``'s -- this rank's rows of the batch, both
    models' heads over ``model`` (pass ``wq`` / ``draft_wq`` cut from the
    full weights') -- with the round advance all-reduced (MIN) over
    ``data`` each round.
    """
    b, p_len = cond_emb.shape[0], cond_emb.shape[1]
    t0 = 0 if given is None else given.shape[1]
    gamma = max(1, min(gamma, steps)) if steps > 1 else 1
    dev = cond_emb.device
    max_len = p_len + t0 + steps + gamma + 1
    if wq is None and cfg.decode_weight_dtype == "int8":
        _check_full(params, cfg, mesh)
        wq = quantize_block_weights(params["blocks"])
    if draft_wq is None and draft_cfg.decode_weight_dtype == "int8":
        _check_full(draft_params, draft_cfg, mesh)
        draft_wq = quantize_block_weights(draft_params["blocks"])
    skw = dict(temperature=temperature, top_k=top_k, top_p=top_p)
    models = (params, cfg, wq, draft_params, draft_cfg, draft_wq)
    if graph is None:
        graph = cond_emb.is_cuda
    if graph is not False:
        holder = graph if isinstance(graph, decode_graph.DecodeGraphs) \
            else decode_graph.DecodeGraphs()
        key = ("speculative", decode_graph.tensors_token(
            params, wq, draft_params, draft_wq), cfg, draft_cfg, b, max_len,
            steps, gamma, sample, tuple(sorted(skw.items())), str(dev),
            None if mesh is None else mesh.token, _build.kernel_setting())
        rounds_of = holder.session(key, lambda: _SpeculativeSession(
            *models, b, max_len, steps, gamma, sample, skw, dev, mesh))
    else:
        rounds_of = _EagerRounds(*models, b, max_len, dev, mesh)
    with torch.no_grad():
        toks, stats = _speculative_rounds(
            rounds_of, generator, cond_emb, draft_cond_emb, given, steps,
            gamma, sample, skw, mesh)
    if t0 > 0:
        toks = torch.cat([given.long(), toks], dim=1)
    return toks, stats


def _speculative_rounds(model, generator, cond_emb, draft_cond_emb, given,
                        steps, gamma, sample, skw, mesh=None):
    """The round loop over ``model``'s passes (``_EagerRounds`` or
    ``_SpeculativeSession``): (tokens (B, steps), stats)."""
    b, dev = cond_emb.shape[0], cond_emb.device
    t_len = cond_emb.shape[1] + (0 if given is None else given.shape[1])
    t_logits = model.prefill(given, cond_emb, draft_cond_emb)
    u_pos = u_acc = u_res = None
    if sample:
        vocab = t_logits.shape[-1]
        u_pos = draw_uniforms(generator, steps, b, vocab, dev, mesh)
        u_acc = draw_uniforms(generator, steps, b, gamma, dev, mesh)
        u_res = draw_uniforms(generator, steps, b, vocab, dev, mesh)
    model.begin(u_pos, t_len)

    def draw(logits, i):
        """Sample output position i from logits with its own uniforms
        (positions past the end clamp: their tokens are dropped)."""
        u = None if u_pos is None else u_pos[min(i, steps - 1)]
        return sample_logits(None, logits, sample=sample, u=u, **skw)

    y_prev = draw(t_logits, 0)
    out = torch.zeros((b, steps + gamma + 1), dtype=torch.long, device=dev)
    out[:, 0] = y_prev
    produced, rounds, accepted = 1, 0, 0
    while produced < steps:
        # the draft proposes gamma tokens (y_prev first, then its own)
        xs, q_lps = model.propose(y_prev, produced, gamma, draw, skw)

        # the target verifies [y_prev, x_1 .. x_gamma] in one chunk
        logits_c = model.verify(torch.cat([y_prev[:, None], xs], dim=1))
        p_lps = filtered_log_probs(logits_c.float(), **skw)  # (B, g+1, V)

        # accept / reject
        p_at_x = p_lps[:, :gamma].gather(-1, xs[..., None])[..., 0]
        q_at_x = q_lps.gather(-1, xs[..., None])[..., 0]
        if sample:
            accepts = torch.log(u_acc[rounds]) \
                < torch.clamp_max(p_at_x - q_at_x, 0.0)
        else:
            accepts = xs == torch.argmax(p_lps[:, :gamma], dim=-1)
        a_lane = torch.cumprod(accepts.long(), dim=1).sum(dim=1)   # (B,)
        a_min = a_lane.min().reshape(1)                  # round advance
        if mesh is not None:   # the global batch's minimum
            mesh.all_reduce_(a_min, "data", op="min")
        n = int(a_min)

        # next token at the cut: lanes that accepted x_{n+1} keep it,
        # lanes that rejected there draw from the residual max(p - q, 0),
        # and when every proposal was accepted the bonus token samples the
        # target at its own output position (speculative.py:277-313)
        x_next = xs[:, min(n, gamma - 1)]
        if not sample:
            y = torch.argmax(p_lps[:, n], dim=-1)
        elif n == gamma:
            y = draw(logits_c[:, gamma], produced + gamma)
        else:
            p_cut, q_cut = p_lps[:, n], q_lps[:, n]
            resid = torch.clamp_min(torch.exp(p_cut) - torch.exp(q_cut), 0.0)
            rsum = resid.sum(dim=-1, keepdim=True)
            resid_lp = torch.where(
                rsum > 0, torch.log(resid / rsum.clamp_min(1e-38) + 1e-38),
                p_cut)
            y = categorical(torch.where((a_lane == n)[:, None], resid_lp,
                                        p_cut), u_res[rounds])
        y = torch.where(a_lane > n, x_next, y)

        out[:, produced:produced + n] = xs[:, :n]
        out[:, produced + n] = y
        # rewind both caches to the accepted prefix (stale keys and values
        # past len are never attended and are overwritten later)
        t_len += 1 + n
        model.rewind(t_len)
        produced += n + 1
        y_prev = y
        rounds += 1
        accepted += n

    return out[:, :steps], {"rounds": rounds, "drafted": rounds * gamma,
                            "accepted": accepted}
