"""Dense transformer blocks (kinds "global" and "local"): init, state
and apply in prefill, chunked-prefill, decode and training modes.

Ported from ``repro/models/blocks.py``, cut to the dense self-attention
path. A block is an ``nn.Module`` holding its retention gate (or None);
the apply functions are plain functions over it. Attention goes
through ``kernels.ops``, which runs the CUDA kernels on the card and
their plain versions on the CPU. Block apply returns (x_out, new_state,
None).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.core import gates as gates_lib
from repro_torch.core.cache import cache_insert, cache_topm_merge, init_cache
from repro_torch.core.gates import Gate
from repro_torch.kernels import ops
from repro_torch.models.common import (NEG_INF, MLP, RMSNorm, apply_rope,
                                       chunked_attention, dense,
                                       dense_apply, mlp_apply,
                                       rmsnorm_apply, to_dtype)

DENSE_KINDS = ("global", "local")


def _require_dense(kind: str):
    if kind not in DENSE_KINDS:
        raise NotImplementedError(
            f"layer kind {kind!r} is not ported to repro_torch yet; "
            f"ported: {DENSE_KINDS}")


class Attention(nn.Module):
    def __init__(self, cfg, dtype, device, generator):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.wq = dense(cfg.d_model, cfg.q_dim, bias=cfg.qkv_bias, **kw)
        self.wk = dense(cfg.d_model, cfg.kv_dim, bias=cfg.qkv_bias, **kw)
        self.wv = dense(cfg.d_model, cfg.kv_dim, bias=cfg.qkv_bias, **kw)
        self.wo = dense(cfg.q_dim, cfg.d_model, **kw)


class DenseBlock(nn.Module):
    """Pre-norm self-attention + SwiGLU FFN, with an optional retention
    gate (``gate``) that scores the keys this block caches."""

    def __init__(self, cfg, kind: str, *, device, generator):
        super().__init__()
        _require_dense(kind)
        dtype = to_dtype(cfg.dtype)
        self.kind = kind
        self.norm1 = RMSNorm(cfg.d_model, device=device)
        self.attn = Attention(cfg, dtype, device, generator)
        self.norm2 = RMSNorm(cfg.d_model, device=device)
        self.ffn = MLP(cfg.d_model, cfg.d_ff, dtype=dtype, device=device,
                       generator=generator)
        self.gate = None


def init_block(cfg, kind: str, *, device, generator) -> DenseBlock:
    return DenseBlock(cfg, kind, device=device, generator=generator)


def init_block_gate(cfg, kind: str, *, device, generator):
    """Retention gate for a block that owns a growing KV cache."""
    _require_dense(kind)
    if not cfg.trimkv:
        return None
    return Gate(cfg.d_model, cfg.gate_hidden, cfg.num_kv_heads,
                cfg.gate_bias_init, device=device, generator=generator)


def init_block_state(cfg, kind: str, batch: int, budget: int, dtype,
                     device):
    _require_dense(kind)
    M = (min(budget, cfg.window) if (kind == "local" and cfg.window > 0)
         else budget)
    return init_cache(batch, cfg.num_kv_heads, M, cfg.head_dim, dtype,
                      device)


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
    return x + mlp_apply(block.ffn, rmsnorm_apply(block.norm2.scale, x,
                                                  cfg.norm_eps))


def _select_rows(mask, new, old):
    """Per-lane select over two block states (dicts of lane-leading
    leaves): lanes where mask ([B] bool) is False keep ``old``'s rows
    bit-identically."""
    def sel(n, o):
        return torch.where(mask.reshape((-1,) + (1,) * (n.ndim - 1)), n, o)
    return {k: sel(new[k], old[k]) for k in new}


def apply_block_decode(block: DenseBlock, cfg, x_t, state, t, *, policy,
                       active=None):
    """x_t: [B, d]; state: the block's slot cache; t: [B] per-lane
    position of this token. Attends over (cache ∪ in-flight token), then
    evicts (Alg. 1). The cache is updated in place (see
    core.cache.cache_insert); active ([B] bool, optional) leaves the
    caches of lanes marked False bit-identical. Returns (x_out [B, d],
    cache, None)."""
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
    aux_new = None
    if policy.needs_attn:
        out, probs, p_new = out
        # before the insert: its keep scores read the updated aux. The
        # serving step programs keep the caches as static buffers, so an
        # aux rebound (or a new dict returned) would be lost in a replay
        aux = cache["aux"]
        if (policy.decode_update(cache, _probs_to_kv(probs, cfg),
                                 active=active) is not cache
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
    return _ffn_residual(block, cfg, x), cache, None


def apply_block_prefill(block: DenseBlock, cfg, x, state, *, policy,
                        budget, obs_window=32, q_offset=0):
    """Single-shot prefill over x [B, T, d] into an empty cache: causal
    attention through the retention kernel, then the top-M merge of the
    prompt's keys by keep score at t = q_offset + T - 1. A needs_attn
    policy's chunk aux is the mean attention of the last obs_window
    queries over the prompt (_obs_probs)."""
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
    return _ffn_residual(block, cfg, x), cache, None


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
    return _ffn_residual(block, cfg, x), cache, None


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
                    q_offset=0):
    """Training-mode (full-sequence) self-attention over x [B, T, d];
    retention-gated when ``gated`` (paper Eq. 3): log_beta from the
    gate biases the logits, and with ``cap_M`` the block's L_cap goes
    through ``ops.capacity_loss_log`` (the CUDA kernels on the card).
    Attention itself is the plain ``chunked_attention``, as the JAX
    package computes it in XLA. Returns (out [B, T, d], cap scalar)."""
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
    out = chunked_attention(q, k, v, log_beta=log_beta, causal=True,
                            window=_window(cfg, block.kind),
                            q_offset=q_offset, q_block=cfg.attn_q_block,
                            kv_block=cfg.attn_kv_block)
    return dense_apply(block.attn.wo, out.reshape(B, T, cfg.q_dim)), cap


def apply_block_train(block: DenseBlock, cfg, x, *, gated=False,
                      cap_M=None):
    """Training forward of a dense block over x [B, T, d]. Returns
    (x_out, cap): the block's capacity loss, zero when not gated."""
    _require_dense(block.kind)
    attn_out, cap = self_attn_train(block, cfg, x, gated=gated, cap_M=cap_M)
    return _ffn_residual(block, cfg, x + attn_out), cap
