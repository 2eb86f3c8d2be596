"""Transformer blocks of the dense, MoE and cross-memory families: init,
state and apply in prefill, chunked-prefill, decode and training modes.

Ported from ``repro/models/blocks.py`` for the kinds "global" and
"local" (self-attention + FFN, ``DenseBlock``; the FFN is the SwiGLU
``MLP``, or for the moe family the top-k expert FFN ``MoE`` run by
``moe_apply``) and "cross"
(self-attention + tanh-gated cross-attention to a memory + FFN,
``CrossBlock``: the vision layers of the vlm family and the decoder
layers of the encdec family). A block is an ``nn.Module`` holding its
retention gate (or None); the apply functions are plain functions over
it. Self-attention goes through ``kernels.ops``, which runs the CUDA
kernels on the card and their plain versions on the CPU; so does the
decode-time cross-attention (the decode kernel over the memory slab,
as the JAX package's Pallas path runs it). The prefill-time
cross-attention and the encoder's bidirectional attention are the plain
``chunked_attention`` with key positions, as the JAX package computes
them in XLA. Block apply returns (x_out, new_state, None).

A block's state is one flat dict per layer: the slot cache (k, v
[B, Hkv, M, D], beta, pos, aux [B, Hkv, M]) and, for a cross layer, its
memory slab xk, xv [B, Hkv, S, D] (the JAX package keeps
[B, S, Hkv, D]; this is the decode kernel's layout, so no step moves an
axis) and mem_len [B] int32 (slots >= mem_len are masked; 0 = no
memory).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.core import gates as gates_lib
from repro_torch.core.cache import (cache_insert, cache_replay,
                                   cache_topm_merge, init_cache,
                                   memory_attend, memory_pos)
from repro_torch.core.gates import Gate
from repro_torch.kernels import ops
from repro_torch.models.common import (NEG_INF, MLP, RMSNorm, apply_rope,
                                       chunked_attention, dense,
                                       dense_apply, mlp_apply,
                                       rmsnorm_apply, to_dtype)

DENSE_KINDS = ("global", "local")
PORTED_KINDS = DENSE_KINDS + ("cross",)
# a layer state's slot-cache leaves and a cross layer's memory leaves
CACHE_LEAVES = ("k", "v", "beta", "pos", "aux")
MEMORY_LEAVES = ("xk", "xv", "mem_len")


class MoE(nn.Module):
    """The moe family's FFN, as ``init_ffn`` lays it out: a float32
    router [d, E] and SwiGLU experts gate_w, up_w [E, d, f] and down_w
    [E, f, d] in the config's dtype, N(0, 1) / sqrt(fan-in) from
    ``generator``. Every moe_apply adds its dropped (token, choice) pairs
    to ``drops``, a device counter that a CUDA graph replay keeps adding
    to (zero it to count from a point on)."""

    def __init__(self, cfg, *, dtype, device, generator):
        super().__init__()
        E, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff

        def normal(shape, fan_in, dt):
            w = torch.empty(shape, dtype=torch.float32, device=device)
            w.normal_(0.0, 1.0, generator=generator)
            return nn.Parameter((w / np.sqrt(fan_in)).to(dt))

        self.router = normal((d, E), d, torch.float32)
        self.gate_w = normal((E, d, f), d, dtype)
        self.up_w = normal((E, d, f), d, dtype)
        self.down_w = normal((E, f, d), f, dtype)
        self.register_buffer("drops", torch.zeros((), dtype=torch.int64,
                                                  device=device))


def is_moe(cfg) -> bool:
    return cfg.family == "moe" and cfg.num_experts > 0


def moe_capacity(cfg, S: int):
    """(group, n_groups, cap) of an MoE call over S tokens, as the JAX
    package's _moe_apply splits them: groups of min(2048, S) tokens, or
    one group of S when that does not divide, and an expert capacity of
    max(ceil(group * k / E * moe_capacity_factor), k) per group."""
    E, k = cfg.num_experts, cfg.experts_per_token
    group = min(2048, S)
    if S % group != 0:
        group = S
    cap = int(np.ceil(group * k / E * cfg.moe_capacity_factor))
    return group, S // group, max(cap, k)


def moe_route(router, xf, k: int):
    """The router of S tokens xf [S, d], in float32 (TF32 is off on the
    card): (probs [S, E], the top-k experts [S, k] with ties to the
    lower index as jax.lax.top_k breaks them, their renormalised
    probabilities [S, k])."""
    probs = torch.softmax(xf.float() @ router, dim=-1)
    top_idx = torch.sort(probs, dim=-1, descending=True,
                         stable=True).indices[:, :k]
    top_vals = probs.gather(1, top_idx)
    return probs, top_idx, top_vals / top_vals.sum(dim=-1, keepdim=True)


def moe_positions(top_idx, n_groups: int, E: int):
    """Each (token, choice)'s slot in its expert's queue, per group:
    [S, k] int32. A group's choices are queued column by column (every
    token's first choice in token order, then every second choice, ...),
    each expert's count carried from one column to the next: the JAX
    package's int32 cumsum per column, as one cumsum per expert over the
    column-major order (along the last axis, where the card's scan is
    fast)."""
    S, k = top_idx.shape
    g = S // n_groups
    cols = top_idx.reshape(n_groups, g, k).transpose(1, 2)   # [n,k,g]
    cols = cols.reshape(n_groups, 1, k * g)
    experts = torch.arange(E, device=top_idx.device)[None, :, None]
    pos = torch.cumsum(cols == experts, dim=-1, dtype=torch.int32) - 1
    pos = pos.gather(1, cols)[:, 0]                           # [n,k*g]
    return pos.reshape(n_groups, k, g).transpose(1, 2).reshape(S, k)


def moe_dispatch(ffn: MoE, xf, top_idx, cfg):
    """Queue each (token, choice) in its expert per group and gather the
    kept ones: (keep [S, k] bool, slot [S, k]: the choice's row in the
    experts' [E * n_groups * cap] rows, xin [E, n_groups * cap, d] in
    the weight dtype, an empty slot a zero row). A choice is kept when
    its place in its expert's queue (moe_positions) is below the
    capacity; a dropped one points at a dump row past the end."""
    S, d = xf.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    group, n_groups, cap = moe_capacity(cfg, S)
    pos = moe_positions(top_idx, n_groups, E)
    keep = pos < cap
    grp = (torch.arange(S, device=xf.device) // group)[:, None]
    slot = torch.where(keep, (top_idx * n_groups + grp) * cap + pos,
                       E * n_groups * cap)
    src = torch.full((E * n_groups * cap + 1,), S, dtype=torch.int64,
                     device=xf.device)
    src.scatter_(0, slot.reshape(-1),
                 torch.arange(S, device=xf.device).repeat_interleave(k))
    wdtype = ffn.gate_w.dtype
    xz = torch.cat([xf.to(wdtype), xf.new_zeros((1, d), dtype=wdtype)])
    return keep, slot, xz[src[:-1]].reshape(E, n_groups * cap, d)


def moe_experts(ffn: MoE, xin):
    """Every expert's SwiGLU over its slots xin [E, R, d] (batched
    matmuls in the weight dtype): [E, R, d]."""
    h = torch.nn.functional.silu(torch.bmm(xin, ffn.gate_w))
    return torch.bmm(h * torch.bmm(xin, ffn.up_w), ffn.down_w)


def moe_combine(eo, keep, slot, top_vals, dtype):
    """Each token's kept choices' expert rows, weighted by their
    renormalised probabilities rounded to the weight dtype, summed in
    float32 and cast to ``dtype``: [S, d]."""
    w = torch.where(keep, top_vals.to(eo.dtype).float(),
                    torch.zeros_like(top_vals))
    rows = eo.reshape(-1, eo.shape[-1])[torch.where(keep, slot, 0)]
    return (rows.float() * w[..., None]).sum(dim=1).to(dtype)


def moe_apply(ffn: MoE, x, cfg, *, return_keep=False):
    """GShard top-k dispatch with an expert capacity per group: the plain
    PyTorch counterpart of the JAX package's _moe_apply (XLA einsums
    there, no Pallas kernel). x: [..., d], its leading axes flattened in
    order into the S tokens the capacity is shared by. Returns (out
    [..., d] in x.dtype, the Switch aux E * sum(mean(probs) *
    mean(onehot(top1))) float32), and with return_keep the keep mask
    [..., k] (False: the choice overflowed its expert and is dropped).

    Four stages: the router (moe_route), the dispatch of the kept
    choices into [E, n_groups * cap, d] (moe_dispatch), the experts
    (moe_experts) and the combine (moe_combine), which compute what the
    JAX package's one-hot dispatch and combine in the weight dtype
    compute. No [g, E, cap] tensor is built, every shape is static and
    nothing leaves the device, so the step programs capture it."""
    shape = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    xf = x.reshape(-1, shape[-1])
    probs, top_idx, top_vals = moe_route(ffn.router, xf, k)
    me = probs.mean(dim=0)
    ce = torch.nn.functional.one_hot(top_idx[:, 0], E).float().mean(dim=0)
    aux = E * (me * ce).sum()
    keep, slot, xin = moe_dispatch(ffn, xf, top_idx, cfg)
    out = moe_combine(moe_experts(ffn, xin), keep, slot, top_vals,
                      x.dtype).reshape(shape)
    ffn.drops += (~keep).sum()
    if return_keep:
        return out, aux, keep.reshape(shape[:-1] + (k,))
    return out, aux


def ffn_apply(ffn, x, cfg):
    """The block FFN over x [..., d]: (out, router aux; None without
    experts)."""
    if isinstance(ffn, MoE):
        return moe_apply(ffn, x, cfg)
    return mlp_apply(ffn, x), None


def _require_ported(kind: str):
    if kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"layer kind {kind!r} is not ported to repro_torch yet; "
            f"ported: {PORTED_KINDS}")


def memory_len(cfg) -> int:
    """Length S of the static cross-attention memory (vision tokens or
    encoder frames); 0 for a family without one."""
    if cfg.family == "vlm":
        return cfg.num_image_tokens
    if cfg.family == "encdec":
        return cfg.source_len
    return 0


class Attention(nn.Module):
    def __init__(self, cfg, dtype, device, generator):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.wq = dense(cfg.d_model, cfg.q_dim, bias=cfg.qkv_bias, **kw)
        self.wk = dense(cfg.d_model, cfg.kv_dim, bias=cfg.qkv_bias, **kw)
        self.wv = dense(cfg.d_model, cfg.kv_dim, bias=cfg.qkv_bias, **kw)
        self.wo = dense(cfg.q_dim, cfg.d_model, **kw)


class DenseBlock(nn.Module):
    """Pre-norm self-attention + FFN (SwiGLU, or the moe family's
    experts), with an optional retention gate (``gate``) that scores the
    keys this block caches."""

    def __init__(self, cfg, kind: str, *, device, generator):
        super().__init__()
        _require_ported(kind)
        dtype = to_dtype(cfg.dtype)
        self.kind = kind
        self.norm1 = RMSNorm(cfg.d_model, device=device)
        self.attn = Attention(cfg, dtype, device, generator)
        self.norm2 = RMSNorm(cfg.d_model, device=device)
        self.ffn = (MoE(cfg, dtype=dtype, device=device, generator=generator)
                    if is_moe(cfg) else
                    MLP(cfg.d_model, cfg.d_ff, dtype=dtype, device=device,
                        generator=generator))
        self.gate = None


class CrossBlock(DenseBlock):
    """A DenseBlock with a tanh-gated cross-attention to the memory
    between its self-attention and its FFN: x + tanh(xgate) * xattn(
    normx(x), memory). xgate is a float32 scalar (0 at init, as in the
    JAX package, where the cross path then changes nothing)."""

    def __init__(self, cfg, kind: str, *, device, generator):
        super().__init__(cfg, kind, device=device, generator=generator)
        dtype = to_dtype(cfg.dtype)
        self.normx = RMSNorm(cfg.d_model, device=device)
        self.xattn = Attention(cfg, dtype, device, generator)
        self.xgate = nn.Parameter(torch.zeros((), dtype=torch.float32,
                                              device=device))


def init_block(cfg, kind: str, *, device, generator) -> DenseBlock:
    cls = CrossBlock if kind == "cross" else DenseBlock
    return cls(cfg, kind, device=device, generator=generator)


def init_block_gate(cfg, kind: str, *, device, generator):
    """Retention gate for a block that owns a growing KV cache."""
    _require_ported(kind)
    if not cfg.trimkv:
        return None
    return Gate(cfg.d_model, cfg.gate_hidden, cfg.num_kv_heads,
                cfg.gate_bias_init, device=device, generator=generator)


def init_block_state(cfg, kind: str, batch: int, budget: int, dtype,
                     device, slab_len: int | None = None):
    """A layer's state: the slot cache, and for a cross layer its memory
    slab of slab_len (default memory_len(cfg)) slots, all masked."""
    _require_ported(kind)
    M = (min(budget, cfg.window) if (kind == "local" and cfg.window > 0)
         else budget)
    cache = init_cache(batch, cfg.num_kv_heads, M, cfg.head_dim, dtype,
                       device=device)
    if kind == "cross":
        S = memory_len(cfg) if slab_len is None else slab_len
        shape = (batch, cfg.num_kv_heads, S, cfg.head_dim)
        cache["xk"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["xv"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["mem_len"] = torch.zeros((batch,), dtype=torch.int32,
                                       device=device)
    return cache


def _memory(state):
    """A cross layer state's memory leaves ({} for a dense layer)."""
    return {k: state[k] for k in MEMORY_LEAVES if k in state}


def make_memory_kv(attn: Attention, cfg, memory):
    """The cross-attention K/V of memory tokens [B, S, d]: xk, xv
    [B, Hkv, S, D] (no RoPE: memory is position-free)."""
    xk = _split_heads(dense_apply(attn.wk, memory), cfg.num_kv_heads,
                      cfg.head_dim)
    xv = _split_heads(dense_apply(attn.wv, memory), cfg.num_kv_heads,
                      cfg.head_dim)
    return xk.transpose(1, 2), xv.transpose(1, 2)


def cross_attn_apply(attn: Attention, cfg, x, xk, xv, mem_len):
    """Prefill-time cross-attention of x [B, T, d] over the memory slab
    xk, xv [B, Hkv, S, D], slots >= mem_len ([B]) masked from every
    query (a lane with mem_len 0 reads exactly zero): the plain
    chunked_attention with key positions, as the JAX package computes
    it in XLA. Returns [B, T, d]."""
    B, T, _ = x.shape
    S = xk.shape[2]
    q = _split_heads(dense_apply(attn.wq, x), cfg.num_heads, cfg.head_dim)
    kv_pos = memory_pos(mem_len, S)[:, 0].expand(B, S)
    out = chunked_attention(q, xk.transpose(1, 2), xv.transpose(1, 2),
                            causal=False, kv_positions=kv_pos,
                            q_block=cfg.attn_q_block,
                            kv_block=cfg.attn_kv_block)
    return dense_apply(attn.wo, out.reshape(B, T, cfg.q_dim))


def _cross_attn_decode(attn: Attention, cfg, x_t, state, t):
    """Decode-time cross-attention of x_t [B, d] over the lane's memory
    slab (core.cache.memory_attend: the decode kernel on the card, as the
    JAX package's Pallas path runs it). t: the lanes' clock, as the JAX
    package passes it (no window reads it; a tensor keeps the step
    capturable). Returns [B, d]."""
    B = x_t.shape[0]
    q = _split_heads(dense_apply(attn.wq, x_t), cfg.num_heads, cfg.head_dim)
    out = memory_attend(q, state["xk"], state["xv"], state["mem_len"], t)
    return dense_apply(attn.wo, out.reshape(B, cfg.q_dim).to(x_t.dtype))


def _cross_residual(block, cfg, x, xo_fn):
    """x + tanh(xgate) * xo for a cross block (tanh in float32, cast to
    the activations' dtype, as in the JAX package); x for the others.
    xo_fn(normed) computes the cross-attention of normx(x)."""
    if block.kind != "cross":
        return x
    xo = xo_fn(rmsnorm_apply(block.normx.scale, x, cfg.norm_eps))
    return x + torch.tanh(block.xgate).to(x.dtype) * xo


def _window(cfg, kind) -> int:
    return cfg.window if kind == "local" else 0


def _split_heads(x, n_heads, head_dim):
    return x.reshape(x.shape[:-1] + (n_heads, head_dim))


def _qkv(block: DenseBlock, cfg, normed, positions):
    """normed [B, T, d], positions [B, T] -> post-RoPE q [B, T, Hq, D],
    k and v [B, T, Hkv, D]."""
    a = block.attn
    q = _split_heads(dense_apply(a.wq, normed), cfg.num_heads, cfg.head_dim)
    k = _split_heads(dense_apply(a.wk, normed), cfg.num_kv_heads,
                     cfg.head_dim)
    v = _split_heads(dense_apply(a.wv, normed), cfg.num_kv_heads,
                     cfg.head_dim)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v.contiguous()


def _probs_to_kv(probs, cfg):
    """Fold grouped-query probs [B, Hq, M] to per-kv-head [B, Hkv, M]."""
    B, Hq, M = probs.shape
    group = Hq // cfg.num_kv_heads
    return probs.reshape(B, cfg.num_kv_heads, group, M).mean(dim=2)


def _beta(block, cfg, normed):
    """Retention scores beta [..., Hkv] float32 (all ones without a
    gate)."""
    if block.gate is not None and cfg.trimkv:
        return gates_lib.gate_beta(block.gate, normed)
    return torch.ones(normed.shape[:-1] + (cfg.num_kv_heads,),
                      dtype=torch.float32, device=normed.device)


def _ffn_residual(block, cfg, x):
    """(x + FFN(norm2(x)), router aux or None). The FFN sees exactly the
    rows the JAX package's _ffn_apply sees (a decode step's [B, d] is
    its [B, 1, d]): expert capacity couples them."""
    out, aux = ffn_apply(block.ffn, rmsnorm_apply(block.norm2.scale, x,
                                                  cfg.norm_eps), cfg)
    return x + out, aux


def _select_rows(mask, new, old):
    """Per-lane select over two block states (dicts of lane-leading
    leaves): lanes where mask ([B] bool) is False keep ``old``'s rows
    bit-identically."""
    def sel(n, o):
        return torch.where(mask.reshape((-1,) + (1,) * (n.ndim - 1)), n, o)
    return {k: sel(new[k], old[k]) for k in new}


def apply_block_decode(block: DenseBlock, cfg, x_t, state, t, *, policy,
                       active=None, return_sig=False):
    """x_t: [B, d]; state: the block's slot cache; t: [B] per-lane
    position of this token. Attends over (cache ∪ in-flight token), then
    evicts (Alg. 1). The cache is updated in place (see
    core.cache.cache_insert); active ([B] bool, optional) leaves the
    caches of lanes marked False bit-identical. Returns (x_out [B, d],
    cache, None), or with return_sig (speculative decoding's verify
    pass) the position's commit signal in place of None: {k, v, beta,
    pkv, auxn}, everything core.cache.cache_replay needs to rerun the
    eviction transaction; pkv (the probs folded to kv heads) and auxn
    (p_new folded) are None for a policy that reads no attention, whose
    replay needs neither. The signal is made of values the step
    computes anyway, so asking for it changes nothing else."""
    cache = state
    B = x_t.shape[0]
    normed = rmsnorm_apply(block.norm1.scale, x_t, cfg.norm_eps)
    positions = torch.as_tensor(t, dtype=torch.int32,
                                device=x_t.device).expand(B)[:, None]
    q, k, v = _qkv(block, cfg, normed[:, None], positions)
    q_t, k_t, v_t = q[:, 0], k[:, 0], v[:, 0]              # [B,H,D]
    beta_t = _beta(block, cfg, normed)                      # [B,Hkv]
    # a policy that reads no attention probabilities (needs_attn False)
    # has the kernel skip them; TRIM-KV discards them in the JAX block
    out = ops.decode_attention(q_t, cache["k"], cache["v"], cache["pos"], t,
                               window=_window(cfg, block.kind),
                               new_kv=(k_t, v_t),
                               return_probs=policy.needs_attn)
    aux_new = pkv = None
    if policy.needs_attn:
        out, probs, p_new = out
        # before the insert: its keep scores read the updated aux. The
        # serving step programs keep the caches as static buffers, so an
        # aux rebound (or a new dict returned) would be lost in a replay
        aux = cache["aux"]
        pkv = _probs_to_kv(probs, cfg)
        if (policy.decode_update(cache, pkv, active=active) is not cache
                or cache["aux"] is not aux):
            raise RuntimeError(f"policy {policy.name!r}: decode_update must "
                               f"write the cache's aux in place")
        aux_new = _probs_to_kv(p_new[..., None], cfg)[..., 0]
    inc = 1.0 if policy.name == "trimkv" else None
    cache = cache_insert(cache, k_t, v_t, beta_t, t, policy.keep_scores,
                         incoming_score=inc, incoming_aux=aux_new,
                         active=active)
    x = x_t + dense_apply(block.attn.wo,
                          out.reshape(B, cfg.q_dim).to(x_t.dtype))
    x = _cross_residual(block, cfg, x, lambda n: _cross_attn_decode(
        block.xattn, cfg, n, cache, t))
    sig = ({"k": k_t, "v": v_t, "beta": beta_t, "pkv": pkv,
            "auxn": aux_new} if return_sig else None)
    return _ffn_residual(block, cfg, x)[0], cache, sig


# ============================================ block: speculative verify
#
# Draft/verify speculative decoding scores C = spec_k + 1 candidate
# positions per lane in two phases, as the JAX package does:
#
#   * apply_block_verify (phase A): apply_block_decode itself, at the
#     decode shape [B, d], once per candidate position, over a SCRATCH
#     copy of the layer's cache, recording each position's eviction
#     transaction (return_sig). Every op is the decode op at the decode
#     shape, so the logits at every correctly fed position are
#     bit-identical to sequential decode. The scratch is discarded; the
#     durable cache is never written (the port's decode writes in place,
#     hence the copy).
#   * apply_block_verify_commit (phase B): once the accepted prefix
#     n_commit[b] is known, replay only those positions' transactions
#     on the durable cache (core.cache.cache_replay), in place.


def apply_block_verify(block: DenseBlock, cfg, x, state, t, *, policy,
                       live=None, scratch=None):
    """Phase A of a verify round. x: [B, C, d] residual stream of the C
    candidate positions; state: the layer's round-entry cache (not
    written); t: round-entry per-lane clock [B]; live: [B] bool lanes in
    the round. ``scratch`` (a cache of the same shapes, or None for a
    new one) receives a copy of ``state`` and carries the positions'
    evolving cache; the serving step programs pass one static scratch
    for every layer. Returns (x_out [B, C, d], sig), sig's leaves
    stacked on axis 1 (see apply_block_decode's return_sig). The scratch
    holds the slot cache only: a cross layer's memory is read-only at
    decode, so its positions read the state's slab."""
    B, C, _ = x.shape
    if is_moe(cfg):
        raise ValueError(
            "speculative verify is unsupported for MoE blocks: expert "
            "capacity couples tokens across the [B, C] grid, so "
            "speculative scoring cannot be bit-identical per row")
    if live is None:
        live = torch.ones((B,), dtype=torch.bool, device=x.device)
    if scratch is None:
        scratch = {k: state[k].clone() for k in CACHE_LEAVES}
    else:
        for k in CACHE_LEAVES:
            scratch[k].copy_(state[k])
    scratch = {**scratch, **_memory(state)}
    tb = torch.as_tensor(t, dtype=torch.int32, device=x.device).expand(B)
    rows, sigs = [], []
    for j in range(C):
        x_o, _, sig = apply_block_decode(block, cfg, x[:, j], scratch,
                                         tb + j, policy=policy, active=live,
                                         return_sig=True)
        rows.append(x_o)
        sigs.append(sig)
    stacked = {k: (None if sigs[0][k] is None
                   else torch.stack([s_[k] for s_ in sigs], dim=1))
               for k in sigs[0]}
    return torch.stack(rows, dim=1), stacked


def apply_block_verify_commit(cfg, kind, state, sig, t, n_commit, live,
                              policy):
    """Phase B of a verify round: commit the accepted prefix (bounded
    rollback) into the layer's round-entry cache ``state``, IN PLACE.
    sig: apply_block_verify's signals; n_commit: [B] accepted-prefix
    length (0..C, 0 for non-live lanes); t: round-entry clock. Returns
    the same cache, bit-identical to having decoded only the accepted
    prefix; a cross layer's memory is left as it is. (The recurrent and
    mamba kinds select a stacked snapshot in the JAX package; they come
    with their families.)"""
    _require_ported(kind)
    inc = 1.0 if policy.name == "trimkv" else None
    return cache_replay(state, sig["k"], sig["v"], sig["beta"], sig["pkv"],
                        sig["auxn"], t, n_commit, live, policy,
                        incoming_score=inc)


def apply_block_prefill(block: DenseBlock, cfg, x, state, *, policy,
                        budget, obs_window=32, q_offset=0):
    """Single-shot prefill over x [B, T, d] into an empty cache: causal
    attention through the retention kernel, then the top-M merge of the
    prompt's keys by keep score at t = q_offset + T - 1. A needs_attn
    policy's chunk aux is the mean attention of the last obs_window
    queries over the prompt (_obs_probs). A cross layer reads the memory
    installed in ``state`` (transformer.install_memory) and keeps it."""
    del budget  # the cache carries M
    B, T, _ = x.shape
    normed = rmsnorm_apply(block.norm1.scale, x, cfg.norm_eps)
    positions = (q_offset + torch.arange(T, device=x.device))[None].expand(
        B, T)
    q, k, v = _qkv(block, cfg, normed, positions)
    out = ops.retention_attention(q, k, v, causal=True,
                                  window=_window(cfg, block.kind),
                                  q_offset=q_offset)
    beta_c = _beta(block, cfg, normed).transpose(1, 2)     # [B,Hkv,T]
    if policy.needs_attn:
        W = min(obs_window, T)
        aux_c = _obs_probs(q[:, -W:], k, positions, q_offset + T - W,
                           _window(cfg, block.kind))
    else:
        aux_c = torch.zeros_like(beta_c)
    k_c, v_c = k.transpose(1, 2), v.transpose(1, 2)         # [B,Hkv,T,D]
    pos_c = positions[:, None].expand(B, cfg.num_kv_heads, T).to(torch.int32)
    t_end = q_offset + T - 1
    chunk_scores = policy.chunk_scores(pos_c=pos_c, beta_c=beta_c,
                                       aux_c=aux_c, k_c=k_c, t=t_end)
    cache = cache_topm_merge(state, k_c, v_c, beta_c, pos_c, aux_c, t_end,
                             policy.keep_scores, chunk_scores)
    x = x + dense_apply(block.attn.wo, out.reshape(B, T, cfg.q_dim))
    x = _cross_residual(block, cfg, x, lambda n: cross_attn_apply(
        block.xattn, cfg, n, state["xk"], state["xv"], state["mem_len"]))
    return _ffn_residual(block, cfg, x)[0], {**cache, **_memory(state)}, None


def apply_block_prefill_chunk(block: DenseBlock, cfg, x, state, t0, *,
                              policy, obs_window=32, n_valid=None):
    """Continue prefill with chunk x [B, C, d]. t0: [B] position of the
    chunk's first token. n_valid: real tokens in the chunk — None (all
    C), an int, or a [B] tensor (ragged: each row marks its own tail).
    Tail positions beyond n_valid are padding: position -1, masked out
    of attention, never kept. Attends through the chunk kernel, then
    merges the top M of (cache ∪ chunk) at t = t0 + n_valid - 1. With a
    [B] n_valid, rows whose n_valid is 0 keep their cache bit-identically
    (the merge could reorder their slots otherwise). n_valid never
    leaves the device, so a captured CUDA graph serves every tail.

    A needs_attn policy reads the chunk kernel's cache probabilities:
    their sum over the chunk's queries is added to the cache's aux (on
    a new tensor: the rows of ``state`` stay intact for the ragged
    select), and the chunk tokens' aux is the mean attention of each
    row's last obs_window real queries (_obs_probs_chunk_lanes)."""
    B, C, _ = x.shape
    dev = x.device
    normed = rmsnorm_apply(block.norm1.scale, x, cfg.norm_eps)
    idx = torch.arange(C, device=dev, dtype=torch.int32)
    t0b = torch.as_tensor(t0, dtype=torch.int32, device=dev).expand(B)
    positions = t0b[:, None] + idx[None, :]
    ragged = torch.is_tensor(n_valid) and n_valid.ndim == 1
    nvb = valid_counts(n_valid, B, C, dev)
    chunk_pos = torch.where(idx[None, :] < nvb[:, None], positions,
                            torch.full_like(positions, -1))
    t_end = t0b + nvb - 1                                   # [B]
    q, k, v = _qkv(block, cfg, normed, positions)
    window = _window(cfg, block.kind)
    out, probs_cache = ops.chunk_attention(q, k, v, state, chunk_pos,
                                           window=window,
                                           need_probs=policy.needs_attn)
    beta_c = _beta(block, cfg, normed).transpose(1, 2)     # [B,Hkv,C]
    cache = state
    if policy.needs_attn:
        W = min(obs_window, C)
        aux_c = _obs_probs_chunk_lanes(q, k, chunk_pos, nvb, t_end - W + 1,
                                       window, W)
        # padded queries were zeroed in the attention: they add nothing
        cache = {**state, "aux": state["aux"] + probs_cache.sum(dim=2)}
    else:
        aux_c = torch.zeros_like(beta_c)
    k_c, v_c = k.transpose(1, 2), v.transpose(1, 2)
    pos_c = chunk_pos[:, None].expand(B, cfg.num_kv_heads, C)
    chunk_scores = policy.chunk_scores(pos_c=pos_c, beta_c=beta_c,
                                       aux_c=aux_c, k_c=k_c, t=t_end)
    cache = cache_topm_merge(cache, k_c, v_c, beta_c, pos_c, aux_c, t_end,
                             policy.keep_scores, chunk_scores)
    if ragged:
        cache = _select_rows(nvb > 0, cache, state)
    x = x + dense_apply(block.attn.wo, out.reshape(B, C, cfg.q_dim))
    x = _cross_residual(block, cfg, x, lambda n: cross_attn_apply(
        block.xattn, cfg, n, state["xk"], state["xv"], state["mem_len"]))
    return _ffn_residual(block, cfg, x)[0], {**cache, **_memory(state)}, None


def _obs_probs(q_obs, k, positions, obs_start, window):
    """Mean attention of the obs-window queries over all keys, folded to
    kv heads (float32). q_obs: [B, W, Hq, D] at positions obs_start ..
    obs_start + W - 1; k: [B, T, Hkv, D]; positions: [B, T] ->
    [B, Hkv, T]."""
    B, W, Hq, D = q_obs.shape
    T, Hkv = k.shape[1], k.shape[2]
    qg = q_obs.float().reshape(B, W, Hkv, Hq // Hkv, D)
    s = torch.einsum("bwkgd,btkd->bkgwt", qg, k.float()) / np.sqrt(D)
    q_pos = obs_start + torch.arange(W, device=k.device)
    dist = q_pos[None, :, None] - positions[:, None, :]     # [B,W,T]
    mask = dist >= 0
    if window > 0:
        mask = mask & (dist < window)
    mask = mask[:, None, None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    return torch.softmax(s, dim=-1).mean(dim=3).mean(dim=2)


def _obs_probs_chunk_lanes(q, k, chunk_pos, n_valid, obs_start, window, W):
    """The padding-robust obs-window signal of chunked prefill, per lane:
    mean attention over the chunk's keys of each row's last W real
    queries, folded to kv heads (float32). The W query rows start at
    clamp(n_valid - W, 0, C - W), gathered on the device (no host sync:
    one captured graph serves every tail); padded rows (position -1)
    and rows before obs_start drop out of the mean. q: [B, C, Hq, D];
    k: [B, C, Hkv, D]; chunk_pos: [B, C] (-1 = padding); n_valid,
    obs_start: [B] -> [B, Hkv, C]."""
    B, C, Hq, D = q.shape
    Hkv = k.shape[2]
    start = (n_valid - W).clamp(0, C - W)
    rows = (start[:, None]
            + torch.arange(W, device=q.device, dtype=start.dtype)).long()
    q_obs = torch.gather(q, 1, rows[:, :, None, None].expand(B, W, Hq, D))
    q_pos = torch.gather(chunk_pos, 1, rows)                 # [B,W]
    qg = q_obs.float().reshape(B, W, Hkv, Hq // Hkv, D)
    s = torch.einsum("bwkgd,bckd->bkgwc", qg, k.float()) / np.sqrt(D)
    dist = q_pos[:, :, None] - chunk_pos[:, None, :]          # [B,W,C]
    mask = (chunk_pos[:, None, :] >= 0) & (dist >= 0)
    if window > 0:
        mask = mask & (dist < window)
    mask = mask[:, None, None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    probs = torch.where(mask, torch.softmax(s, dim=-1),
                        torch.zeros_like(s))
    obs = (q_pos >= obs_start[:, None]) & (q_pos >= 0)        # [B,W]
    n_obs = obs.float().sum(dim=-1).clamp(min=1.0)
    probs = (probs * obs[:, None, None, :, None]).sum(dim=3) \
        / n_obs[:, None, None, None]
    return probs.mean(dim=2)


def valid_counts(n_valid, B: int, C: int, device):
    """n_valid (None = all C, an int, a 0-d or a [B] tensor) as an int32
    [B] tensor on ``device``; no host round trip for a tensor."""
    if n_valid is None:
        n_valid = C
    return torch.as_tensor(n_valid, dtype=torch.int32,
                           device=device).expand(B)


# ======================================================== block: train


def self_attn_train(block: DenseBlock, cfg, x, *, gated, cap_M,
                    q_offset=0, causal=True, kv_positions=None):
    """Training-mode (full-sequence) self-attention over x [B, T, d];
    retention-gated when ``gated`` (paper Eq. 3): log_beta from the
    gate biases the logits, and with ``cap_M`` the block's L_cap goes
    through ``ops.capacity_loss_log`` (the CUDA kernels on the card).
    Attention itself is the plain ``chunked_attention``, as the JAX
    package computes it in XLA; kv_positions [B, T] (-1 = padded key)
    with causal=False is the encoder's bidirectional attention over a
    ragged batch. Returns (out [B, T, d], cap scalar)."""
    B, T, _ = x.shape
    normed = rmsnorm_apply(block.norm1.scale, x, cfg.norm_eps)
    positions = (q_offset + torch.arange(T, device=x.device))[None].expand(
        B, T)
    q, k, v = _qkv(block, cfg, normed, positions)
    log_beta = None
    cap = torch.zeros((), dtype=torch.float32, device=x.device)
    if gated and block.gate is not None:
        log_beta = gates_lib.gate_log_beta(block.gate, normed)  # [B,T,Hkv]
        if cap_M is not None:
            cap = ops.capacity_loss_log(log_beta, cap_M)
    out = chunked_attention(q, k, v, log_beta=log_beta, causal=causal,
                            window=_window(cfg, block.kind),
                            q_offset=q_offset, kv_positions=kv_positions,
                            q_block=cfg.attn_q_block,
                            kv_block=cfg.attn_kv_block)
    return dense_apply(block.attn.wo, out.reshape(B, T, cfg.q_dim)), cap


def apply_block_train(block: DenseBlock, cfg, x, *, gated=False,
                      cap_M=None, causal=True, kv_positions=None):
    """Training forward of a dense or MoE block over x [B, T, d] (with
    causal=False and kv_positions: an encoder layer). Returns (x_out,
    cap, router): the block's capacity loss, zero when not gated, and
    its MoE router aux, zero without experts. Cross blocks train with
    their family (ROADMAP queue 1)."""
    if block.kind not in DENSE_KINDS:
        raise NotImplementedError(
            f"training a {block.kind!r} block is not ported to repro_torch "
            f"yet; see ROADMAP queue 1, gate training for the cross "
            f"families")
    attn_out, cap = self_attn_train(block, cfg, x, gated=gated, cap_M=cap_M,
                                    causal=causal,
                                    kv_positions=kv_positions)
    x, router = _ffn_residual(block, cfg, x + attn_out)
    if router is None:
        router = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, cap, router
