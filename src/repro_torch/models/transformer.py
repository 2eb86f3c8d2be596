"""The dense stack: init, logits, decode state, single-shot and chunked
prefill, decode, sampling, the token loops and the training forward.

Ported from ``repro/models/transformer.py`` (dense path). The model is
a ``Transformer`` module holding its blocks in order; the JAX package's
scans over layers become Python loops, and its scans over tokens and
chunks become loops over step functions (``serve.graphs`` captures the
steps as CUDA graphs). The decode state is
{"t": [B] int32 per-lane clock, "layers": [one slot cache per layer]};
``bridge.state_to_numpy`` gives it the JAX package's layout. Decode
updates the caches in place.
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
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported to repro_torch yet; "
                f"only 'dense' is")
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

    @property
    def device(self) -> torch.device:
        return self.embed.device


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


def init_decode_state(cfg, batch: int, budget: int, device):
    dtype = to_dtype(cfg.dtype)
    return {
        "t": torch.zeros((batch,), dtype=torch.int32, device=device),
        "layers": [blocks.init_block_state(cfg, kind, batch, budget, dtype,
                                           device)
                   for kind in cfg.layer_kinds()],
    }


def _embed(model, tokens):
    return F.embedding(torch.as_tensor(tokens, device=model.device).long(),
                       model.embed)


def prefill(model: Transformer, cfg, tokens, state, policy, serve_cfg):
    """Single-shot prefill of tokens [B, T] into a fresh ``state``.
    Returns (state, last_hidden [B, d])."""
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
                       policy, serve_cfg):
    """Chunked prefill as a loop over chunks [n_chunks, B, C] with
    real-token counts n_valid [n_chunks] (C except the padded tail), or
    [n_chunks, B] for a ragged batch: mixed-length prompts on one chunk
    grid, each row with its own counts (full chunks, its tail, then
    zeros, which freeze the row). Returns (state, h_last [B, d] of each
    row's last real token, carried across its empty chunks)."""
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
                    new_keys, policy, serve_cfg, *, greedy=True):
    """An interleaved prefill/decode segment through the mixed programs
    of serve.graphs.LanePrograms (eager): step j runs mixed_step with
    chunks[j] [B, C], chunk_valid[j] [B] and finish[j] [B] (a lane that
    consumes its last prompt chunk at step j takes its key from new_keys
    [B, 2] and starts emitting at step j + 1). A lane is in at most one
    mode per step (active lanes have chunk_valid 0). The variant with
    first-token logits runs only on steps where some lane finishes,
    chosen on the host, where the JAX package's lax.cond chooses on the
    device. Returns the tuple of decode_segment_loop."""
    n_steps = int(np.shape(chunks)[0])
    lanes = _lane_programs(model, cfg, state, policy, serve_cfg, n_steps)
    lanes.tok.copy_(torch.as_tensor(tok))
    lanes.keys.copy_(torch.as_tensor(np.asarray(keys, np.int64)))
    lanes.upload_carries(active, n_emitted, max_new, eos_id)
    lanes.run_mixed(np.asarray(chunks), np.asarray(chunk_valid),
                    np.asarray(finish), np.asarray(new_keys, np.int64),
                    greedy=greedy)
    return (lanes.state, *lanes.results(n_steps))


def reset_lanes(state, lane_mask):
    """Retire lanes in place: the masked lanes' slot metadata is cleared
    (core.cache.reset_lanes: pos -1, beta 1, aux 0) and their clock set
    to 0; K/V bytes stay (invisible once pos < 0). Other lanes are
    untouched. lane_mask: [B] bool. Returns the same state."""
    state["t"].masked_fill_(lane_mask, 0)
    for st in state["layers"]:
        cache_reset_lanes(st, lane_mask)
    return state


def scrub_lanes(state, lane_mask):
    """reset_lanes plus zeroed K/V (core.cache.scrub_lanes), in place:
    the quarantine primitive. Returns the same state."""
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

    aux = {"cap": summed per-layer capacity losses, "n_gate_layers":
    python int}. When ``gated``, attention uses the retention bias
    (student); otherwise vanilla attention (teacher). ``remat`` runs
    each block under ``torch.utils.checkpoint`` (non-reentrant), keeping
    only the residual stream between blocks; backward recomputes the
    block, its L_cap forward included. Without autograd (the teacher
    under ``torch.no_grad``) nothing is checkpointed."""
    h = _embed(model, tokens)
    cap_total = torch.zeros((), dtype=torch.float32, device=h.device)

    def body(block, h):
        return blocks.apply_block_train(block, cfg, h, gated=gated,
                                        cap_M=cap_M)

    for block in model.layers:
        h, cap = checkpointed(body, block, h) if remat else body(block, h)
        cap_total = cap_total + cap
    h = rmsnorm_apply(model.final_norm.scale, h, cfg.norm_eps)
    return h, {"cap": cap_total, "n_gate_layers": num_gate_layers(cfg)}
