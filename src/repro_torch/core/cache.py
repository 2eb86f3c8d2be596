"""Bounded, slot-dense KV cache with per-(layer, kv-head) eviction.

Ported from ``repro/core/cache.py``. Layout: k/v [B, Hkv, M, Dh] in the
model dtype, with per-slot pos (int32, -1 = empty), beta and aux
(float32) [B, Hkv, M]. Keys are cached post-RoPE.

Unlike the JAX original, ``cache_insert`` updates the cache IN PLACE:
it writes the victim slot of each (lane, kv head) and nothing else, and
returns the same dict; so do ``reset_lanes``, ``scrub_lanes`` and
``cache_replay`` (speculative decoding's commit). ``cache_topm_merge``
builds new tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops

NEG_INF = -1e30


def init_cache(batch: int, n_kv_heads: int, budget: int, head_dim: int,
               dtype=torch.bfloat16, *, device):
    shape = (batch, n_kv_heads, budget)
    return {
        "k": torch.zeros(shape + (head_dim,), dtype=dtype, device=device),
        "v": torch.zeros(shape + (head_dim,), dtype=dtype, device=device),
        "beta": torch.ones(shape, dtype=torch.float32, device=device),
        "pos": torch.full(shape, -1, dtype=torch.int32, device=device),
        "aux": torch.zeros(shape, dtype=torch.float32, device=device),
    }


def lane_t(t, device=None):
    """Normalize a position — a Python int, a scalar tensor (lock-step
    batch) or a [B] tensor (per-lane clocks) — to broadcast against
    [B, Hkv, M] slot tensors."""
    t = torch.as_tensor(t, dtype=torch.int32, device=device)
    return t[:, None, None] if t.ndim == 1 else t


def cache_len(cache, *, per_lane: bool = False):
    """Number of filled slots, [B, Hkv] — or, with per_lane=True, the
    per-lane occupancy [B] (max over kv heads)."""
    filled = (cache["pos"] >= 0).sum(dim=-1, dtype=torch.int32)
    return filled.max(dim=-1).values if per_lane else filled


def _first_argmin(scores):
    """(index of the FIRST minimum, the minimum) along the last axis —
    the rules of jnp.argmin, spelled out so that they hold on every
    device: ties go to the first index, and a row holding a NaN takes
    its first NaN, with NaN as the minimum (``min`` propagates it)."""
    low = scores.min(dim=-1).values
    M = scores.shape[-1]
    iota = torch.arange(M, device=scores.device)
    hit = (scores == low[..., None]) | torch.isnan(scores)
    idx = torch.where(hit, iota, M).min(dim=-1).values
    return idx, low


# the leaves a quarantine zeroes besides the reset's metadata: the bulk
# K/V bytes of the slot cache and of a cross layer's memory slab (the
# JAX package's LANE_PAYLOAD_LEAVES)
PAYLOAD_LEAVES = ("k", "v", "xk", "xv")


def reset_lanes(cache, lane_mask):
    """Clear the masked lanes' slots in place: pos := -1, beta := 1,
    aux := 0, and a cross layer's memory length mem_len := 0 (its slab
    becomes unreadable). K/V and memory bytes stay: a slot with pos < 0
    is invisible to every attention read and scores -1e30 in eviction.
    lane_mask: [B] bool. Other lanes are untouched. Returns the same
    dict."""
    m = lane_mask[:, None, None]
    cache["pos"].masked_fill_(m, -1)
    cache["beta"].masked_fill_(m, 1.0)
    cache["aux"].masked_fill_(m, 0.0)
    if "mem_len" in cache:
        cache["mem_len"].masked_fill_(lane_mask, 0)
    return cache


def scrub_lanes(cache, lane_mask):
    """reset_lanes plus zeroed K/V (and memory slab) in the masked lanes
    (the quarantine primitive: a NaN payload byte would survive the
    metadata reset, since 0 x NaN = NaN in the p @ v product). In
    place."""
    reset_lanes(cache, lane_mask)
    m = lane_mask[:, None, None, None]
    for name in PAYLOAD_LEAVES:
        if name in cache:
            cache[name].masked_fill_(m, 0)
    return cache


def memory_pos(mem_len, S: int):
    """Pseudo slot positions of a cross-attention memory slab: 0 for
    the first mem_len slots of each lane, -1 beyond (the cache's
    convention: pos < 0 is invisible to every attention read). mem_len:
    int or [B] int32 (0 = no memory, e.g. a reset lane). Returns
    [B, 1, S] int32 (or [1, 1, S] for an int), broadcastable against
    [B, Hkv, S]."""
    ml = torch.as_tensor(mem_len, dtype=torch.int32)
    ml = ml.reshape(-1, 1, 1)
    iota = torch.arange(S, dtype=torch.int32, device=ml.device)[None, None]
    return torch.where(iota < ml, 0, -1).to(torch.int32)


def memory_attend(q_t, xk, xv, mem_len, t=0):
    """Decode-time cross-attention of one query per (lane, q head) over
    the lane's memory slab, masked by mem_len: the decode attention
    (``kernels.ops``: the CUDA kernel on the card, its plain version on
    the CPU) over the memory as a slot cache at memory_pos(mem_len, S),
    which the kernel derives from mem_len itself, without an in-flight
    token, so a lane with mem_len 0 reads exactly zero. q_t: [B, Hq, D]
    (no RoPE: memory is position-free); xk, xv: [B, Hkv, S, D] (the
    port's slab layout; the JAX package keeps [B, S, Hkv, D]); mem_len:
    int or [B] int32; t: the lanes' clock, which no window reads (pass
    a tensor inside a captured graph).
    Returns [B, Hq, D] in q_t's dtype."""
    B = xk.shape[0]
    ml = torch.as_tensor(mem_len, dtype=torch.int32, device=q_t.device)
    return ops.decode_attention(q_t, xk, xv, None, t,
                                mem_len=ml.expand(B).contiguous())


def cache_insert(cache, k_t, v_t, beta_t, t, keep_scores_fn,
                 incoming_score=None, incoming_aux=None, active=None):
    """Insert one token; evict the lowest-keep-score entry (Alg. 1).

    k_t, v_t: [B, Hkv, Dh] (k post-RoPE); beta_t: [B, Hkv]; t: position
    of the incoming token — int, scalar or [B] tensor. keep_scores_fn
    (cache, t) -> [B, Hkv, M] keep scores (empty slots -1e30). The
    incoming token takes part in the argmin: it is written only where
    its score (incoming_score; None = +1e30) is >= the victim's.

    active: optional [B] bool; a lane marked False inserts nothing
    (continuous batching freezes retired and prefilling lanes so).

    In place: each (lane, kv head) writes only its victim slot. Where
    the incoming token loses, or the lane is inactive, the slot is
    written with its own values, so nothing changes there. Returns the
    same dict.
    """
    B, H, _ = cache["pos"].shape
    scores = keep_scores_fn(cache, t)                       # [B,H,M]
    victim, victim_score = _first_argmin(scores)            # [B,H]
    inc = 1e30 if incoming_score is None else float(incoming_score)
    write = inc >= victim_score                             # [B,H] bool
    if active is not None:
        write = write & active[:, None]
    dev = victim.device
    bi = torch.arange(B, device=dev)[:, None]
    hi = torch.arange(H, device=dev)[None, :]
    slot = (bi, hi, victim)
    w1 = write[..., None]

    def put(name, new):
        leaf = cache[name]
        cur = leaf[slot]
        sel = w1 if cur.ndim == 3 else write
        leaf[slot] = torch.where(sel, new.to(leaf.dtype), cur)

    put("k", k_t)
    put("v", v_t)
    put("beta", beta_t.float())
    t_bh = torch.as_tensor(t, dtype=torch.int32, device=dev)
    put("pos", (t_bh[:, None] if t_bh.ndim == 1 else t_bh).expand(B, H))
    aux_in = (torch.zeros((B, H), dtype=torch.float32, device=dev)
              if incoming_aux is None else incoming_aux.float())
    put("aux", aux_in)
    return cache


def cache_replay(cache, k_c, v_c, beta_c, probs_kv_c, aux_new_c, t,
                 n_commit, live, policy, incoming_score=None):
    """Speculative decoding's commit (bounded rollback), in place: replay
    the first n_commit[b] positions' decode-time cache transactions
    (policy.decode_update, then cache_insert) from the round-entry
    cache, in position order, with the signals the verify pass recorded.

    k_c, v_c: [B, C, Hkv, Dh]; beta_c: [B, C, Hkv]; probs_kv_c
    [B, C, Hkv, M] and aux_new_c [B, C, Hkv]: each position's attention
    mass on the cache slots and its own incoming aux (None for a policy
    that reads no attention, whose decode_update changes nothing);
    t: round-entry clock ([B] or scalar); n_commit: [B] accepted-prefix
    length (0..C); live: [B] bool.

    Each position replays the transaction sequential decode runs (the
    same scores, victim and masked write), and positions j >= n_commit
    are masked out of the write, so the cache ends bit-identical to
    having decoded only the accepted prefix: a rejected token never
    reaches it. A masked lane keeps its leaves bit-identically, as the
    JAX package's per-step select keeps them: cache_insert writes such a
    lane's victim slot with its own values, and decode_update adds zeros
    to its aux (never -0.0, so the sum is the old bits). Returns the
    same dict."""
    C = k_c.shape[1]
    t = torch.as_tensor(t, dtype=torch.int32, device=k_c.device)
    for j in range(C):
        mask = live & (j < n_commit)
        if probs_kv_c is not None:
            policy.decode_update(cache, probs_kv_c[:, j], active=mask)
        cache_insert(cache, k_c[:, j], v_c[:, j], beta_c[:, j], t + j,
                     policy.keep_scores, incoming_score=incoming_score,
                     incoming_aux=(aux_new_c[:, j] if policy.needs_attn
                                   else None),
                     active=mask)
    return cache


def cache_topm_merge(cache, k_c, v_c, beta_c, pos_c, aux_c, t,
                     keep_scores_fn, chunk_scores):
    """Chunked-prefill merge: keep the top-M of (cache ∪ chunk) by keep
    score at time t. k_c, v_c: [B, Hkv, C, Dh]; beta_c, aux_c, pos_c
    (-1 = padding), chunk_scores: [B, Hkv, C]. Ties keep the lower
    index, as the JAX package's stable argsort of -scores does: cache
    slots first, then the earliest chunk tokens."""
    M = cache["pos"].shape[-1]
    cache_scores = keep_scores_fn(cache, t)
    all_scores = torch.cat([cache_scores, chunk_scores], dim=-1)
    idx = torch.sort(-all_scores, dim=-1, stable=True).indices[..., :M]

    def take(a, b):
        both = torch.cat([a, b.to(a.dtype)], dim=2)
        if both.ndim == 4:
            return torch.gather(
                both, 2, idx[..., None].expand(-1, -1, -1, both.shape[-1]))
        return torch.gather(both, 2, idx)

    return {
        "k": take(cache["k"], k_c),
        "v": take(cache["v"], v_c),
        "beta": take(cache["beta"], beta_c),
        "pos": take(cache["pos"], pos_c),
        "aux": take(cache["aux"], aux_c),
    }
