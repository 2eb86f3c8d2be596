"""The model stack of the dense, MoE and cross-memory families: init,
logits, decode state, the cross-attention memory (vision projection or
encoder, install_memory), single-shot and chunked prefill, decode,
sampling, speculative verify rounds, the token loops and the training
forward.

Ported from ``repro/models/transformer.py`` (the dense, moe, vlm and
encdec families). The model is a ``Transformer`` module holding its blocks in
order (and, for encdec, its encoder); the JAX package's scans over
layers become Python loops, and its scans over tokens and chunks become
loops over step functions (``serve.graphs`` captures the steps as CUDA
graphs). The decode state is {"t": [B] int32 per-lane clock, "layers":
[one flat state dict per layer]} (blocks.init_block_state: a slot
cache, plus a cross layer's memory slab); ``bridge.state_to_numpy``
gives it the JAX package's layout. Decode updates the caches in place.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import prng
from repro_torch.core.cache import reset_lanes as cache_reset_lanes
from repro_torch.core.cache import scrub_lanes as cache_scrub_lanes
from repro_torch.models import blocks
from repro_torch.models.common import (RMSNorm, checkpointed, dense,
                                       resolve_device, rmsnorm_apply,
                                       to_dtype)


class Transformer(nn.Module):
    """Embedding, the blocks (each with its retention gate once
    init_gate_params ran), final norm and unembedding."""

    def __init__(self, cfg, *, device, generator):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported to repro_torch yet; "
                f"ported: {FAMILIES}")
        dtype = to_dtype(cfg.dtype)
        Vp = cfg.padded_vocab
        embed = torch.empty((Vp, cfg.d_model), dtype=torch.float32,
                            device=device)
        embed.normal_(0.0, 1.0, generator=generator)
        self.embed = nn.Parameter((embed * 0.02).to(dtype))
        self.final_norm = RMSNorm(cfg.d_model, device=device)
        self.unembed = dense(cfg.d_model, Vp, dtype=dtype, device=device,
                             generator=generator)
        self.layers = nn.ModuleList(
            blocks.init_block(cfg, kind, device=device, generator=generator)
            for kind in cfg.layer_kinds())
        # the memory's front end: the vision projection [vision_dim, d]
        # (vlm) or the bidirectional encoder (encdec; no gates)
        self.vis_proj = (dense(cfg.vision_dim, cfg.d_model, dtype=dtype,
                               device=device, generator=generator)
                         if cfg.family == "vlm" else None)
        self.encoder = self.encoder_norm = None
        if cfg.family == "encdec":
            self.encoder = nn.ModuleList(
                blocks.init_block(cfg, "global", device=device,
                                  generator=generator)
                for _ in range(cfg.encoder_layers))
            self.encoder_norm = RMSNorm(cfg.d_model, device=device)

    @property
    def device(self) -> torch.device:
        return self.embed.device


FAMILIES = ("dense", "moe", "vlm", "encdec")
# the extra_inputs key that carries a cross family's memory
MEM_KEYS = {"vlm": "vision_embeds", "encdec": "source_embeds"}


def memory_shape(cfg):
    """(S, feat) of one request's full-length front-end inputs (vision
    embeds or source frames), or None for a family without memory."""
    if cfg.family not in MEM_KEYS:
        return None
    return (blocks.memory_len(cfg),
            cfg.vision_dim if cfg.family == "vlm" else cfg.d_model)


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def init_params(cfg, *, seed: int = 0, device="cuda") -> Transformer:
    """Random weights from ``seed`` (a torch.Generator on ``device``),
    scaled as the JAX package's init_params. Inference only: no
    parameter requires grad."""
    device = resolve_device(device)
    model = Transformer(cfg, device=device,
                        generator=_generator(seed, device))
    return model.requires_grad_(False)


def init_gate_params(model: Transformer, cfg, *, seed: int = 1):
    """Attach a retention gate to every block that owns a KV cache
    (bias gate_bias_init, so beta ~= 1). Returns the model."""
    g = _generator(seed, model.device)
    for block in model.layers:
        gate = blocks.init_block_gate(cfg, block.kind, device=model.device,
                                      generator=g)
        if gate is not None:
            block.gate = gate.requires_grad_(False)
    return model


def num_gate_layers(cfg) -> int:
    return sum(1 for k in cfg.layer_kinds()
               if cfg.trimkv and k in ("global", "local", "cross"))


def gate_parameters(model: Transformer):
    """The retention gates' parameters, in layer order: what training
    updates (the base stays frozen)."""
    return [p for block in model.layers if block.gate is not None
            for p in block.gate.parameters()]


def compute_logits(model: Transformer, cfg, hidden):
    """[..., d] -> [..., Vp] float32, padded-vocab columns at -1e30."""
    logits = F.linear(hidden, model.unembed.weight).float()
    mask = torch.arange(cfg.padded_vocab, device=logits.device) \
        < cfg.vocab_size
    return torch.where(mask, logits, torch.full_like(logits, -1e30))


def init_decode_state(cfg, batch: int, budget: int, device,
                      slab_len: int | None = None):
    """A fresh decode state of ``batch`` lanes; a cross layer's memory
    slab has slab_len slots (default blocks.memory_len(cfg))."""
    dtype = to_dtype(cfg.dtype)
    return {
        "t": torch.zeros((batch,), dtype=torch.int32, device=device),
        "layers": [blocks.init_block_state(cfg, kind, batch, budget, dtype,
                                           device, slab_len=slab_len)
                   for kind in cfg.layer_kinds()],
    }


# ------------------------------------------------- cross-attention memory


def _encoder_forward(model: Transformer, cfg, source_embeds, mem_len=None):
    """The bidirectional encoder over frame embeddings [B, S, d] (in the
    model dtype). mem_len: optional [B] valid frame counts of a ragged
    batch padded to a shared S: padded frames are masked out of every
    attention read, so each row's valid prefix is what encoding that
    row alone gives; padded rows of the output are garbage, masked
    downstream by the same mem_len."""
    kv_positions = None
    if mem_len is not None:
        S = source_embeds.shape[1]
        iota = torch.arange(S, dtype=torch.int32,
                            device=source_embeds.device)[None]
        kv_positions = torch.where(iota < mem_len[:, None], iota, -1)
    h = source_embeds
    for block in model.encoder:
        h, _, _ = blocks.apply_block_train(block, cfg, h, causal=False,
                                           kv_positions=kv_positions)
    return rmsnorm_apply(model.encoder_norm.scale, h, cfg.norm_eps)


def memory_from_inputs(model: Transformer, cfg, extra_inputs):
    """The memory tokens of a cross family from its front-end inputs:
    (memory [B, S, d] in the model dtype, mem_len [B] int32), or
    (None, None) for a family without memory. extra_inputs holds the
    family's key (MEM_KEYS: vision embeds [B, S, vision_dim] or source
    frame embeds [B, S, d]) and optionally "mem_len" [B], each row's
    valid length in a padded batch (default: every row whole). As in
    the JAX package, the vision projection runs in float32 and is cast
    after; source frames are cast before the encoder."""
    key = MEM_KEYS.get(cfg.family)
    if key is None:
        return None, None
    dev, dtype = model.device, to_dtype(cfg.dtype)
    x = torch.as_tensor(extra_inputs[key], device=dev)
    mem_len = extra_inputs.get("mem_len")
    if mem_len is not None:
        mem_len = torch.as_tensor(mem_len, dtype=torch.int32, device=dev)
    if cfg.family == "vlm":
        memory = (x.float() @ model.vis_proj.weight.float().T).to(dtype)
    else:
        memory = _encoder_forward(model, cfg, x.to(dtype), mem_len)
    if mem_len is None:
        mem_len = torch.full((memory.shape[0],), memory.shape[1],
                             dtype=torch.int32, device=dev)
    return memory, mem_len


def install_memory(model: Transformer, cfg, state, memory, mem_len,
                   lanes_mask=None):
    """Write the memory's cross-attention K/V (blocks.make_memory_kv)
    and mem_len into every cross layer of ``state``, IN PLACE. memory:
    [B, S, d]; mem_len: [B] int32. lanes_mask: optional [B] bool: only
    those lanes take the new memory, every other lane's is left
    bit-identical (the scheduler admits into reset lanes while their
    neighbours decode). Without a mask the whole batch is replaced and
    S may differ from the state's slab (the state then adopts the
    request's own S, as the JAX package's one-shot path does: those
    leaves are rebound, so a static state is installed with its own
    S). Returns the same state."""
    m = None if lanes_mask is None else torch.as_tensor(
        lanes_mask, device=memory.device)
    ml = torch.as_tensor(mem_len, dtype=torch.int32,
                         device=memory.device).expand(memory.shape[0])
    for block, st in zip(model.layers, state["layers"]):
        if block.kind != "cross":
            continue
        xk, xv = blocks.make_memory_kv(block.xattn, cfg, memory)
        if m is None and st["xk"].shape != xk.shape:
            st["xk"], st["xv"] = xk.contiguous(), xv.contiguous()
            st["mem_len"] = ml.clone()
            continue
        if m is not None:
            xk = torch.where(m[:, None, None, None], xk, st["xk"])
            xv = torch.where(m[:, None, None, None], xv, st["xv"])
            ml = torch.where(m, ml, st["mem_len"])
        st["xk"].copy_(xk)
        st["xv"].copy_(xv)
        st["mem_len"].copy_(ml)
    return state


def _install_inputs(model, cfg, state, extra_inputs):
    """install_memory of extra_inputs' memory into every lane (a no-op
    for a family without memory). Returns the state."""
    memory, mem_len = memory_from_inputs(model, cfg, extra_inputs or {})
    if memory is not None:
        install_memory(model, cfg, state, memory, mem_len)
    return state


def _embed(model, tokens):
    return F.embedding(torch.as_tensor(tokens, device=model.device).long(),
                       model.embed)


def prefill(model: Transformer, cfg, tokens, state, policy, serve_cfg, *,
            extra_inputs=None):
    """Single-shot prefill of tokens [B, T] into a fresh ``state``; a
    cross family's memory comes from extra_inputs (memory_from_inputs)
    and is installed first. Returns (state, last_hidden [B, d])."""
    state = _install_inputs(model, cfg, state, extra_inputs)
    h = _embed(model, tokens)
    B, T = h.shape[:2]
    layers = []
    for block, st in zip(model.layers, state["layers"]):
        h, ns, _ = blocks.apply_block_prefill(
            block, cfg, h, st, policy=policy, budget=serve_cfg.budget,
            obs_window=serve_cfg.obs_window)
        layers.append(ns)
    h = rmsnorm_apply(model.final_norm.scale, h, cfg.norm_eps)
    t = torch.full((B,), T, dtype=torch.int32, device=h.device)
    return {"t": t, "layers": layers}, h[:, -1]


def _prefill_chunk_step(model: Transformer, cfg, tokens, state, policy,
                        serve_cfg, n_valid=None):
    """One chunk of chunked prefill: embed -> per-layer chunk attention
    + top-M merge -> final norm. tokens: [B, C]; n_valid: real tokens —
    None (all C), an int, or a [B] tensor for a ragged batch, where a
    row with n_valid 0 keeps its state bit-identically (see
    blocks.apply_block_prefill_chunk). Returns (state, h_last [B, d] of
    each row's last real token; a row with an empty chunk returns its
    position 0 there, which callers replace with the previous value)."""
    h = _embed(model, tokens)
    B, C = h.shape[:2]
    t0 = state["t"]
    nvb = blocks.valid_counts(n_valid, B, C, h.device)
    layers = []
    for block, st in zip(model.layers, state["layers"]):
        h, ns, _ = blocks.apply_block_prefill_chunk(
            block, cfg, h, st, t0, policy=policy,
            obs_window=serve_cfg.obs_window, n_valid=n_valid)
        layers.append(ns)
    h = rmsnorm_apply(model.final_norm.scale, h, cfg.norm_eps)
    ix = (nvb - 1).clamp(0, C - 1).long()
    h_last = torch.gather(h, 1, ix[:, None, None].expand(B, 1, h.shape[-1]))
    return {"t": t0 + nvb, "layers": layers}, h_last[:, 0]


def prefill_chunk_loop(model: Transformer, cfg, chunks, n_valid, state,
                       policy, serve_cfg, *, extra_inputs=None):
    """Chunked prefill as a loop over chunks [n_chunks, B, C] with
    real-token counts n_valid [n_chunks] (C except the padded tail), or
    [n_chunks, B] for a ragged batch: mixed-length prompts on one chunk
    grid, each row with its own counts (full chunks, its tail, then
    zeros, which freeze the row). Returns (state, h_last [B, d] of each
    row's last real token, carried across its empty chunks). A cross
    family's memory (extra_inputs) is installed once before the first
    chunk: it is loop-invariant.

    The prefix cache's boundary snapshots (the JAX package's
    capture_chunk) are taken by the serving layer, between the chunk
    program's replays (serve.graphs.LanePrograms.prefill_chunks)."""
    state = _install_inputs(model, cfg, state, extra_inputs)
    chunks = torch.as_tensor(chunks, device=model.device)
    n_valid = torch.as_tensor(n_valid, dtype=torch.int32,
                              device=model.device)
    ragged = n_valid.ndim == 2
    h_last = None
    for tokens, nv in zip(chunks, n_valid):
        state, h = _prefill_chunk_step(model, cfg, tokens, state, policy,
                                       serve_cfg, n_valid=nv)
        h_last = (h if h_last is None or not ragged else
                  torch.where((nv > 0)[:, None], h, h_last))
    return state, h_last


def decode_step(model: Transformer, cfg, state, token, policy,
                active=None):
    """token: [B]. Returns (state, logits [B, Vp] float32); the caches
    in ``state`` are updated in place and the clock advances by one.
    active: optional [B] bool; lanes marked False keep their caches and
    clocks bit-identical (the scheduler freezes retired and prefilling
    lanes so)."""
    x = _embed(model, token)
    t = state["t"]
    layers = []
    for block, st in zip(model.layers, state["layers"]):
        x, ns, _ = blocks.apply_block_decode(block, cfg, x, st, t,
                                             policy=policy, active=active)
        layers.append(ns)
    x = rmsnorm_apply(model.final_norm.scale, x, cfg.norm_eps)
    t_new = t + 1 if active is None else t + active.to(t.dtype)
    return {"t": t_new, "layers": layers}, compute_logits(model, cfg, x)


def sample_token(logits, key, *, greedy: bool, temperature: float):
    """logits [B, Vp] -> (token [B] int64, new key, the scores the token
    is the first argmax of). Greedy: the logits (the key is returned as
    it came). Sampled at ``temperature`` from the threefry chain ``key``
    [2]: the key is split once and one categorical draw covers the whole
    [B, Vp] array, as the JAX package's sample_token; the scores are
    logits / temperature plus the gumbel noise."""
    if greedy or temperature == 0.0:
        return torch.argmax(logits, dim=-1), key, logits
    key, sub = prng.split(key)
    scores = prng.perturb(sub, logits / temperature)
    return torch.argmax(scores, dim=-1), key, scores


def top2_margin(logits):
    """logits [B, Vp] -> [B] float32: the largest logit minus the second
    largest, how near an argmax came to a tie."""
    top = torch.topk(logits, 2, dim=-1).values
    return top[:, 0] - top[:, 1]


def decode_loop(model: Transformer, cfg, state, first_token, n_steps: int,
                policy, *, greedy=True, temperature=0.0, key=None):
    """n_steps of emit -> decode -> sample. first_token [B] (from the
    prefill logits) is emitted first. ``key`` [2] (default the key of
    seed 0) is the sampling chain, split once per sampled step. Returns
    (state, ids [B, n_steps], the last step's logits [B, Vp], margins
    [B, n_steps]: each step's top-two margin of the scores it took the
    argmax of, the final key)."""
    tok = first_token
    if key is None:
        key = prng.prng_key(0, device=tok.device)
    out, margins = [], []
    logits = None
    for _ in range(n_steps):
        out.append(tok)
        state, logits = decode_step(model, cfg, state, tok, policy)
        tok, key, scores = sample_token(logits, key, greedy=greedy,
                                        temperature=temperature)
        margins.append(top2_margin(scores))
    return (state, torch.stack(out, dim=1), logits,
            torch.stack(margins, dim=1), key)


# --------------------------------------------- continuous-batching lanes
#
# The scheduler (serve.scheduler) treats the batch dim as B fixed LANES,
# each holding one request at its own clock and its own threefry key
# chain. Retired lanes are reset (pos := -1) and refilled. The helpers
# below are the model-level surface of that: the masked segment and
# mixed steps, per-lane sampling and lane-granular state surgery. The
# JAX package runs each loop as one lax.scan; here the steps are the
# bodies of the step programs of serve.graphs.LanePrograms, which the
# scheduler replays as CUDA graphs and the loops below run eagerly.


def sample_token_lanes(logits, keys, *, greedy: bool = True,
                       temperature: float = 0.0):
    """Per-lane tokens [B] (int64) from logits [B, Vp] and the lanes' own
    key chains keys [B, 2]: greedy argmax (keys returned as they came),
    or each lane splits its key once and draws from its own row, the
    stream a B = 1 generate seeded with that key draws. Returns
    (tokens, new keys)."""
    if greedy or temperature == 0.0:
        return torch.argmax(logits, dim=-1), keys
    new_keys, sub = prng.split(keys)
    return prng.categorical_rows(sub, logits / temperature), new_keys


def _emit(tok, live, nxt, n_emitted, max_new, eos_id):
    """The per-step bookkeeping of a segment: lanes in ``live`` emit
    their carried token and take ``nxt``; a lane that emitted its eos or
    its max_new-th token stops. Returns (new_tok, n_emitted, done)."""
    n_emitted = n_emitted + live.to(n_emitted.dtype)
    done = live & (((eos_id >= 0) & (tok == eos_id)) | (n_emitted >= max_new))
    return torch.where(live, nxt, tok), n_emitted, done


def segment_step(model: Transformer, cfg, state, tok, keys, live, n_emitted,
                 max_new, eos_id, ok, policy, *, greedy=True,
                 temperature=0.0):
    """One step of a masked decode segment over B lanes: lanes in
    ``live`` ([B] bool) emit their carried token ``tok``, feed it
    through the masked decode_step (the others are frozen) and take the
    next token; a live lane advances its key (keys [B, 2]), the others
    keep theirs. Returns (state, new_tok, keys, n_emitted, done, ok,
    logits); ok [B] turns False for a live lane whose logits were not
    finite."""
    state, logits = decode_step(model, cfg, state, tok, policy, active=live)
    ok = ok & (~live | torch.isfinite(logits).all(dim=-1))
    nxt, new_keys = sample_token_lanes(logits, keys, greedy=greedy,
                                       temperature=temperature)
    keys = torch.where(live[:, None], new_keys, keys)
    tok, n_emitted, done = _emit(tok, live, nxt, n_emitted, max_new, eos_id)
    return state, tok, keys, n_emitted, done, ok, logits


def mixed_step(model: Transformer, cfg, state, tok, keys, active, n_emitted,
               max_new, eos_id, ok, ctoks, nv, fin, new_keys, policy,
               serve_cfg, *, finishing: bool, greedy=True, temperature=0.0):
    """One step of an interleaved segment: the decode sub-step of
    segment_step over ``active`` lanes, then one prompt chunk ctoks
    [B, C] with per-lane real counts nv [B] (0 = no chunk: the row is
    frozen). Lanes in ``fin`` [B] consumed their last chunk: they take
    the greedy token of that chunk's last hidden state as their carried
    token (one-shot generate's first token is the prefill argmax under
    sampling too), their request's key from new_keys [B, 2] (after this
    step's split, so their first draw splits the seed's key), n_emitted
    0, and turn active. ``finishing`` (the host's fin.any()) picks the
    variant that computes those logits; without it the transition is
    the identity, as when fin has no lane. Returns (state, tok, keys,
    active, n_emitted, ok, emit, the decode sub-step's logits)."""
    emit = active
    state, tok, keys, n_emitted, done, ok, logits = segment_step(
        model, cfg, state, tok, keys, active, n_emitted, max_new, eos_id,
        ok, policy, greedy=greedy, temperature=temperature)
    active = active & ~done
    state, h_last = _prefill_chunk_step(model, cfg, ctoks, state, policy,
                                        serve_cfg, n_valid=nv)
    if finishing:
        lg = compute_logits(model, cfg, h_last)
        first = torch.argmax(lg, dim=-1)
        ok = ok & (~fin | torch.isfinite(lg).all(dim=-1))
        tok = torch.where(fin, first, tok)
        keys = torch.where(fin[:, None], new_keys, keys)
        n_emitted = torch.where(fin, torch.zeros_like(n_emitted), n_emitted)
        active = active | fin
    return state, tok, keys, active, n_emitted, ok, emit, logits


# ------------------------------------------------ speculative decoding
#
# Draft/verify/commit rounds, greedy only (the JAX package's
# verify_round): each live lane drafts spec_k tokens from its own token
# history, the stack scores the C = spec_k + 1 positions with the decode
# recipe itself (blocks.apply_block_verify, at the decode shape
# [B, d]), the longest prefix that agrees with the model's greedy tokens
# is accepted, and only those positions' cache transactions are
# replayed into the durable caches (blocks.apply_block_verify_commit).
# Greedy outputs are token-identical to the plain segments.

SPEC_HISTORY = 64  # per-lane token-history window the drafter sees


def ngram_draft(hist, tok, k: int):
    """Self-draft k tokens from the lane's token history. hist: [B, H]
    the tokens consumed BEFORE the current carry, left-padded with -1,
    most recent last; tok: [B] the current carry. Finds the most recent
    earlier occurrence of the bigram (hist[-1], tok) and proposes its
    continuation; a lane with no match (or a continuation running off
    the known history) repeats its carry. Returns drafts [B, k] in
    hist's dtype (always valid vocab ids)."""
    B, H = hist.shape
    dev = hist.device
    ext = torch.cat([hist, tok[:, None].to(hist.dtype)], dim=1)  # [B,H+1]
    last, prev = ext[:, -1], ext[:, -2]
    p = torch.arange(1, H, device=dev)
    match = ((ext[:, 1:H] == last[:, None]) & (ext[:, :H - 1] == prev[:, None])
             & (ext[:, 1:H] >= 0) & (ext[:, :H - 1] >= 0))
    best = torch.where(match, p[None], torch.full_like(p[None], -1)).max(
        dim=1).values                                          # [B]
    idx = best[:, None] + torch.arange(1, k + 1, device=dev)[None]
    cont = torch.gather(ext, 1, idx.clamp(0, H))
    valid = (best >= 0)[:, None] & (idx <= H) & (cont >= 0)
    return torch.where(valid, cont, ext[:, -1:].expand(B, k))


def _verify_forward(model: Transformer, cfg, state, fed, live, policy,
                    scratch=None):
    """Phase A of a verify round: score the C candidate positions (fed
    [B, C]) through the stack WITHOUT writing ``state``: each block runs
    the decode recipe per position over a scratch copy of its cache
    (blocks.apply_block_verify). ``scratch`` maps a cache's pos shape to
    a static scratch cache (None: new ones). The final norm and the
    logits run per position at the decode shape [B, d], as decode_step
    runs them, since a GEMM at another shape may round otherwise.
    Returns (logits [B, C, Vp] float32, sigs: one signal dict per
    layer)."""
    x = _embed(model, fed)                                   # [B,C,d]
    t = state["t"]
    sigs = []
    for block, st in zip(model.layers, state["layers"]):
        sc = None if scratch is None else scratch[tuple(st["pos"].shape)]
        x, sig = blocks.apply_block_verify(block, cfg, x, st, t,
                                           policy=policy, live=live,
                                           scratch=sc)
        sigs.append(sig)
    logits = [compute_logits(model, cfg, rmsnorm_apply(
        model.final_norm.scale, x[:, j].contiguous(), cfg.norm_eps))
        for j in range(x.shape[1])]
    return torch.stack(logits, dim=1), sigs


def _verify_commit(cfg, state, sigs, n_commit, live, policy):
    """Phase B of a verify round: commit each lane's accepted prefix
    (n_commit [B], 0 for lanes not live) into the round-entry caches,
    in place (blocks.apply_block_verify_commit). Returns the state with
    its clock advanced by n_commit (a new t tensor)."""
    t = state["t"]
    for kind, st, sig in zip(cfg.layer_kinds(), state["layers"], sigs):
        blocks.apply_block_verify_commit(cfg, kind, st, sig, t, n_commit,
                                         live, policy)
    return {"t": t + n_commit.to(t.dtype), "layers": state["layers"]}


def verify_round(model: Transformer, cfg, state, tok, hist, active, live,
                 n_emitted, max_new, eos_id, spec_k: int, policy, *,
                 draft_fn=None, scratch=None):
    """One draft/verify/commit round over B lanes: drafts spec_k tokens
    per lane, scores C = spec_k + 1 positions, accepts the longest
    greedy-agreeing prefix (clipped at each lane's stop condition) and
    commits exactly those positions.

    tok [B]: carry token (emitted first); hist [B, SPEC_HISTORY]: the
    tokens before tok, -1 padded, recent last; active / live [B] bool
    (live = active lanes in this round); n_emitted, max_new, eos_id [B];
    draft_fn(hist, tok, k) -> [B, k] (default ngram_draft). The caches
    of ``state`` are committed in place.

    Returns (state, tok, hist, active, n_emitted, fed [B, C], emitted
    [B, C], ok [B], n_commit [B]): fed[l, j] is an output token iff
    emitted[l, j]; ok is False where a lane's logits were not finite at
    a committed position."""
    B = tok.shape[0]
    C = spec_k + 1
    dev = tok.device
    drafts = ((draft_fn or ngram_draft)(hist, tok, spec_k) if spec_k > 0
              else tok.new_zeros((B, 0)))
    fed = torch.cat([tok[:, None], drafts.to(tok.dtype)], dim=1)   # [B,C]
    logits, sigs = _verify_forward(model, cfg, state, fed, live, policy,
                                   scratch=scratch)
    y = torch.argmax(logits, dim=-1)                         # [B,C]
    if spec_k > 0:
        acc = torch.cumprod((fed[:, 1:] == y[:, :-1]).long(), dim=1)
        n_cand = 1 + acc.sum(dim=1)                          # [B] 1..C
    else:
        n_cand = torch.ones((B,), dtype=torch.long, device=dev)
    # a lane's stop conditions inside the accepted candidates: emitting
    # eos or the max_new-th token ends the request at that position
    s_idx = torch.arange(C, device=dev)
    stop = ((((eos_id[:, None] >= 0) & (fed == eos_id[:, None]))
             | (n_emitted[:, None] + s_idx[None] + 1 >= max_new[:, None]))
            & (s_idx[None] < n_cand[:, None]))
    first_stop = torch.where(stop, s_idx[None], C).min(dim=1).values
    n_commit = torch.where(live, torch.minimum(n_cand, first_stop + 1),
                           torch.zeros_like(n_cand))
    done = live & (first_stop < C)
    # health over committed positions only (position 0 is always
    # committed for a live lane, so a poisoned cache cannot hide)
    finite = torch.isfinite(logits).all(dim=-1)              # [B,C]
    ok = ((s_idx[None] >= n_commit[:, None]) | finite).all(dim=1)
    emitted = live[:, None] & (s_idx[None] < n_commit[:, None])
    state = _verify_commit(cfg, state, sigs, n_commit, live, policy)
    # the carry: the model's own token after the last committed one
    carry = torch.gather(y, 1, (n_commit - 1).clamp(min=0)[:, None])[:, 0]
    new_tok = torch.where(live, carry, tok)
    # the history takes the committed tokens (still not the carry)
    H = hist.shape[1]
    ext = torch.cat([hist, fed.to(hist.dtype)], dim=1)       # [B,H+C]
    shifted = torch.gather(
        ext, 1, torch.arange(H, device=dev)[None] + n_commit[:, None])
    hist = torch.where(live[:, None], shifted, hist)
    n_emitted = n_emitted + n_commit.to(n_emitted.dtype)
    return (state, new_tok, hist, active & ~done, n_emitted, fed, emitted,
            ok, n_commit)


def spec_segment_step(model: Transformer, cfg, state, tok, hist, active,
                      n_emitted, max_new, eos_id, ok, acc_tok, acc_rounds,
                      spec_k: int, policy, *, scratch=None):
    """One round of a speculative decode segment (the body of the JAX
    package's spec_decode_segment_loop) over the lanes in ``active``:
    verify_round, the health flags and the acceptance counters (acc_tok
    [B] committed tokens, acc_rounds [B] live rounds). Returns (state,
    tok, hist, active, n_emitted, ok, acc_tok, acc_rounds, fed,
    emitted)."""
    live = active
    state, tok, hist, active, n_emitted, fed, emitted, r_ok, nc = \
        verify_round(model, cfg, state, tok, hist, active, live, n_emitted,
                     max_new, eos_id, spec_k, policy, scratch=scratch)
    ok = ok & (~live | r_ok)
    acc_tok = acc_tok + nc.to(acc_tok.dtype)
    acc_rounds = acc_rounds + live.to(acc_rounds.dtype)
    return (state, tok, hist, active, n_emitted, ok, acc_tok, acc_rounds,
            fed, emitted)


def spec_mixed_step(model: Transformer, cfg, state, tok, keys, hist, active,
                    n_emitted, max_new, eos_id, ok, acc_tok, acc_rounds,
                    ctoks, nv, fin, new_keys, spec_k: int, policy,
                    serve_cfg, *, finishing: bool, scratch=None):
    """One step of a speculative interleaved segment (the body of the JAX
    package's spec_mixed_step_loop): the decode lanes run one
    verify_round, then the chunk sub-step and the finish transition of
    mixed_step (a finishing lane takes its prompt's greedy token as its
    carry; its history was seeded with the prompt tail at admission).
    Returns (state, tok, keys, hist, active, n_emitted, ok, acc_tok,
    acc_rounds, fed, emitted)."""
    (state, tok, hist, dec_active, n_emitted, ok, acc_tok, acc_rounds, fed,
     emitted) = spec_segment_step(model, cfg, state, tok, hist, active,
                                  n_emitted, max_new, eos_id, ok, acc_tok,
                                  acc_rounds, spec_k, policy,
                                  scratch=scratch)
    state, h_last = _prefill_chunk_step(model, cfg, ctoks, state, policy,
                                        serve_cfg, n_valid=nv)
    if finishing:
        lg = compute_logits(model, cfg, h_last)
        ok = ok & (~fin | torch.isfinite(lg).all(dim=-1))
        tok = torch.where(fin, torch.argmax(lg, dim=-1), tok)
        keys = torch.where(fin[:, None], new_keys, keys)
        n_emitted = torch.where(fin, torch.zeros_like(n_emitted), n_emitted)
        dec_active = dec_active | fin
    return (state, tok, keys, hist, dec_active, n_emitted, ok, acc_tok,
            acc_rounds, fed, emitted)


def _lane_programs(model, cfg, state, policy, serve_cfg, steps):
    """The serving layer's lane programs over ``state``, run eagerly:
    the loops below drive the same step programs that serve.scheduler
    replays as CUDA graphs."""
    from repro_torch.configs import ServeConfig
    from repro_torch.serve.graphs import LanePrograms   # builds on this module
    serve_cfg = ServeConfig() if serve_cfg is None else serve_cfg
    return LanePrograms(model, cfg, serve_cfg, policy, state, None,
                        steps=steps)


def decode_segment_loop(model: Transformer, cfg, state, tok, keys, active,
                        n_emitted, max_new, eos_id, n_steps: int, policy, *,
                        greedy=True, n_real=None, serve_cfg=None):
    """A masked continuous-batching decode segment: n_steps of
    segment_step over B lanes that may be mid-request, finished or
    empty, through the segment program of serve.graphs.LanePrograms
    (eager). Per-lane carries: tok [B], keys [B, 2] (the lanes' key
    chains), active [B] bool, n_emitted [B]; limits max_new [B] and
    eos_id [B] (-1 = never). Sampling follows serve_cfg.temperature
    unless ``greedy``. A lane that emits its eos or its max_new-th token
    turns inactive at the step's end. n_real (<= n_steps): only the
    first n_real steps run; the rest are the identity (no emission, no
    state or key change), as the JAX package masks a bucket's tail. The
    caches of ``state`` are updated in place. Returns (state, tok, keys,
    active, n_emitted, ids [B, n_steps], emitted [B, n_steps] bool, ok
    [B] bool); ids[l, j] is lane l's output iff emitted[l, j]."""
    lanes = _lane_programs(model, cfg, state, policy, serve_cfg, n_steps)
    lanes.tok.copy_(torch.as_tensor(tok))
    lanes.keys.copy_(torch.as_tensor(np.asarray(keys, np.int64)))
    lanes.upload_carries(active, n_emitted, max_new, eos_id)
    n_real = n_steps if n_real is None else int(n_real)
    lanes.run_segment(n_real, greedy=greedy)
    return (lanes.state, *lanes.results(n_steps, n_real))


def mixed_step_loop(model: Transformer, cfg, state, tok, keys, active,
                    n_emitted, max_new, eos_id, chunks, chunk_valid, finish,
                    new_keys, policy, serve_cfg, *, greedy=True,
                    mem_inputs=None, mem_install=None):
    """An interleaved prefill/decode segment through the mixed programs
    of serve.graphs.LanePrograms (eager): step j runs mixed_step with
    chunks[j] [B, C], chunk_valid[j] [B] and finish[j] [B] (a lane that
    consumes its last prompt chunk at step j takes its key from new_keys
    [B, 2] and starts emitting at step j + 1). A lane is in at most one
    mode per step (active lanes have chunk_valid 0). The variant with
    first-token logits runs only on steps where some lane finishes,
    chosen on the host, where the JAX package's lax.cond chooses on the
    device. Cross families: mem_inputs (the extra_inputs dict, padded
    [B, S, feat] and per-lane "mem_len") and mem_install ([B] bool: the
    lanes whose first prompt chunk rides in this segment) install those
    lanes' memory before their first chunk (the JAX package installs it
    before its scan; a lane is frozen until its first chunk, so the
    two agree). Returns the tuple of decode_segment_loop."""
    n_steps = int(np.shape(chunks)[0])
    lanes = _lane_programs(model, cfg, state, policy, serve_cfg, n_steps)
    lanes.tok.copy_(torch.as_tensor(tok))
    lanes.keys.copy_(torch.as_tensor(np.asarray(keys, np.int64)))
    lanes.upload_carries(active, n_emitted, max_new, eos_id)
    lanes.run_mixed(np.asarray(chunks), np.asarray(chunk_valid),
                    np.asarray(finish), np.asarray(new_keys, np.int64),
                    greedy=greedy,
                    memory=_memory_upload(cfg, mem_inputs, mem_install))
    return (lanes.state, *lanes.results(n_steps))


def spec_decode_segment_loop(model: Transformer, cfg, state, tok, keys,
                             active, n_emitted, max_new, eos_id, hist,
                             n_rounds: int, policy, *, spec_k: int,
                             n_real=None, serve_cfg=None):
    """Speculative counterpart of decode_segment_loop: n_rounds verify
    rounds through the spec_segment program of serve.graphs.LanePrograms
    (eager), each advancing every live lane by 1 to spec_k + 1 tokens.
    Greedy only (keys ride through untouched). n_real (<= n_rounds):
    only the first n_real rounds run. Returns (state, tok, keys,
    active, n_emitted, ids [B, n_rounds * (spec_k + 1)], emitted [same],
    ok [B], hist, acc_tok [B] committed tokens, acc_rounds [B] live
    rounds); ids columns are round-major, position-minor, so the ids
    where ``emitted`` is set are each lane's tokens in order (columns of
    rounds that did not run read as not emitted)."""
    import dataclasses
    from repro_torch.configs import ServeConfig
    serve_cfg = dataclasses.replace(serve_cfg or ServeConfig(),
                                    spec_k=spec_k)
    lanes = _lane_programs(model, cfg, state, policy, serve_cfg, n_rounds)
    lanes.tok.copy_(torch.as_tensor(tok))
    lanes.keys.copy_(torch.as_tensor(np.asarray(keys, np.int64)))
    lanes.upload_carries(active, n_emitted, max_new, eos_id, hist=hist)
    n_real = n_rounds if n_real is None else int(n_real)
    lanes.run_segment(n_real, spec=True)
    return (lanes.state, *lanes.results(n_rounds, n_real, spec=True))


def spec_mixed_step_loop(model: Transformer, cfg, state, tok, keys, active,
                         n_emitted, max_new, eos_id, hist, chunks,
                         chunk_valid, finish, new_keys, policy, serve_cfg, *,
                         spec_k: int, mem_inputs=None, mem_install=None):
    """Speculative counterpart of mixed_step_loop through the spec_mixed
    programs of serve.graphs.LanePrograms (eager): per step the decode
    lanes run one verify round while admitting lanes consume one prompt
    chunk. Greedy only; memory as in mixed_step_loop. Returns the
    spec_decode_segment_loop tuple (ids / emitted
    [B, n_steps * (spec_k + 1)])."""
    import dataclasses
    n_steps = int(np.shape(chunks)[0])
    serve_cfg = dataclasses.replace(serve_cfg, spec_k=spec_k)
    lanes = _lane_programs(model, cfg, state, policy, serve_cfg, n_steps)
    lanes.tok.copy_(torch.as_tensor(tok))
    lanes.keys.copy_(torch.as_tensor(np.asarray(keys, np.int64)))
    lanes.upload_carries(active, n_emitted, max_new, eos_id, hist=hist)
    lanes.run_mixed(np.asarray(chunks), np.asarray(chunk_valid),
                    np.asarray(finish), np.asarray(new_keys, np.int64),
                    spec=True,
                    memory=_memory_upload(cfg, mem_inputs, mem_install))
    return (lanes.state, *lanes.results(n_steps, spec=True))


def _memory_upload(cfg, mem_inputs, mem_install):
    """(mem [B, S, feat], mem_len [B], install [B]) numpy for
    LanePrograms.run_mixed from a mixed loop's memory arguments, or
    None."""
    if mem_inputs is None:
        return None
    return (np.asarray(mem_inputs[MEM_KEYS[cfg.family]], np.float32),
            np.asarray(mem_inputs["mem_len"], np.int32),
            np.asarray(mem_install, bool))


def reset_lanes(state, lane_mask):
    """Retire lanes in place: the masked lanes' slot metadata is cleared
    (core.cache.reset_lanes: pos -1, beta 1, aux 0; a cross layer's
    mem_len 0, so the next occupant never reads this memory) and their
    clock set to 0; K/V and memory bytes stay (invisible once masked).
    Other lanes are untouched. lane_mask: [B] bool. Returns the same
    state."""
    state["t"].masked_fill_(lane_mask, 0)
    for st in state["layers"]:
        cache_reset_lanes(st, lane_mask)
    return state


def scrub_lanes(state, lane_mask):
    """reset_lanes plus zeroed K/V and memory slabs
    (core.cache.scrub_lanes), in place: the quarantine primitive.
    Returns the same state."""
    state["t"].masked_fill_(lane_mask, 0)
    for st in state["layers"]:
        cache_scrub_lanes(st, lane_mask)
    return state


def extract_lanes(state, lanes):
    """Gather lanes ``lanes`` ([k] int) of the B-lane state into a new
    batch-k sub-state. Eviction keeps each lane's live KV inside its
    bounded M-slot slab, so the sub-state is the lane's complete movable
    state, O(M x layers) however many tokens it has generated."""
    idx = torch.as_tensor(lanes, dtype=torch.long, device=state["t"].device)
    return {"t": state["t"].index_select(0, idx),
            "layers": [{k: v.index_select(0, idx) for k, v in st.items()}
                       for st in state["layers"]]}


def insert_lanes(state, sub_state, lanes):
    """Scatter a batch-k sub_state into lanes ``lanes`` ([k] int) of the
    B-lane state, IN PLACE (every leaf of those lanes overwritten, K/V
    included): the static buffers of captured programs keep their
    addresses, where a rebound leaf would leave the next replay reading
    the old buffer. insert_lanes(s, extract_lanes(s, l), l) changes
    nothing. The JAX package also has a mask twin, install_lanes, for
    its mesh (lane-aligned, shard-local installs); resume here moves
    only the chosen lanes' rows. Returns the same state."""
    idx = torch.as_tensor(lanes, dtype=torch.long, device=state["t"].device)
    state["t"].index_copy_(0, idx, sub_state["t"])
    for st, sub in zip(state["layers"], sub_state["layers"]):
        for k, v in st.items():
            v.index_copy_(0, idx, sub[k])
    return state


def teacher_force_loop(model: Transformer, cfg, state, tokens, policy):
    """Feed gold tokens [B, L] through decode. Returns (state, preds
    [B, L]); preds[:, i] is the argmax after consuming tokens[:, i]."""
    tokens = torch.as_tensor(tokens, device=model.device)
    preds = []
    for i in range(tokens.shape[1]):
        state, logits = decode_step(model, cfg, state, tokens[:, i], policy)
        preds.append(torch.argmax(logits, dim=-1))
    return state, torch.stack(preds, dim=1)


def forward_train(model: Transformer, cfg, tokens, *, gated=False,
                  cap_M=None, remat=False):
    """tokens: [B, T] -> (hidden [B, T, d], aux).

    aux = {"cap": summed per-layer capacity losses, "router": summed MoE
    router aux (zero without experts), "n_gate_layers": python int}.
    When ``gated``, attention uses the retention bias (student);
    otherwise vanilla attention (teacher). ``remat`` runs each block
    under ``torch.utils.checkpoint`` (non-reentrant), keeping only the
    residual stream between blocks; backward recomputes the block, its
    L_cap forward included. Without autograd (the teacher under
    ``torch.no_grad``) nothing is checkpointed. The dense and moe
    families: the cross families' gate training is ROADMAP queue 1."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"training the {cfg.family!r} family is not ported to "
            f"repro_torch yet; see ROADMAP queue 1, gate training for the "
            f"cross families")
    h = _embed(model, tokens)
    cap_total = torch.zeros((), dtype=torch.float32, device=h.device)
    router_total = torch.zeros((), dtype=torch.float32, device=h.device)

    def body(block, h):
        return blocks.apply_block_train(block, cfg, h, gated=gated,
                                        cap_M=cap_M)

    for block in model.layers:
        h, cap, router = (checkpointed(body, block, h) if remat
                          else body(block, h))
        cap_total = cap_total + cap
        router_total = router_total + router
    h = rmsnorm_apply(model.final_norm.scale, h, cfg.norm_eps)
    return h, {"cap": cap_total, "router": router_total,
               "n_gate_layers": num_gate_layers(cfg)}
