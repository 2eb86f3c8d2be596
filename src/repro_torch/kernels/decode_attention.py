"""Flash-decode over the bounded slot cache: the CUDA kernel's wrapper
and its plain PyTorch version.

Replaces the Pallas kernel ``decode_attention_pallas``
(``repro/kernels/decode_attention.py``); the kernel itself is
``csrc/decode_attention.cu``. One query token per (lane, q head)
attends over the M-slot cache (slots with pos < 0 masked, optional
window against the per-lane clock t) and, when ``new_kv`` is given, the
in-flight token at distance 0. ``return_probs`` also returns the
normalized probabilities over the M slots [B, Hq, M] and, with
``new_kv``, the in-flight token's mass [B, Hq] (both float32).
A cross-attention memory slab passes ``mem_len`` [B] int32 with pos
None: slot j of lane b is at position 0 below mem_len[b] and empty past
it (``core.cache.memory_pos``), which the kernel computes itself.

The kernel splits the slots of each (lane, kv head) over a
thread-block cluster of up to 8 CTAs, one launch per call; each CTA
leaves a partial softmax in its shared memory and the cluster combines
the partials through distributed shared memory. ``split_plan`` picks
the number of splits.

``kernels.ops.decode_attention`` picks the version by the tensors'
device; call that, not these.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import build

NEG_INF = -1e30
# slots per tile of csrc/decode_attention.cu (TS), its largest cluster
# (MAX_SPLIT, the portable cluster size) and the CTAs it aims for: two
# per SM of the H100's 132
TILE = 64
MAX_SPLIT = 8
TARGET_CTAS = 2 * 132


def split_plan(M: int, n_rows: int) -> tuple[int, int]:
    """(n_split, split_len) of the decode kernel for an M-slot cache
    and n_rows = B * Hkv (lane, kv head) pairs: split s owns slots
    [s * split_len, min(M, (s + 1) * split_len)). split_len is a whole
    number of tiles; no split is empty; at most MAX_SPLIT splits, and no
    more than it takes to reach TARGET_CTAS CTAs in all."""
    n_tiles = max(1, -(-M // TILE))
    want = max(1, -(-TARGET_CTAS // max(1, n_rows)))
    n_split = min(MAX_SPLIT, n_tiles, want)
    per = -(-n_tiles // n_split)          # tiles per split
    return -(-n_tiles // per), per * TILE


def _lane_clock(t, device):
    """t as an int32 tensor broadcastable to [B, Hkv, M]."""
    t3 = torch.as_tensor(t, dtype=torch.int32, device=device)
    return t3[:, None, None] if t3.ndim == 1 else t3


def decode_attention_torch(q_t, k_cache, v_cache, pos, t, *, window=0,
                           new_kv=None, return_probs=False, mem_len=None):
    """Plain version, after ``repro/kernels/ref.py:decode_attention_ref``.
    q_t: [B, Hq, D]; k_cache, v_cache: [B, Hkv, M, D]; pos: [B, Hkv, M]
    int32, or None with mem_len [B] int32 (see the module docstring);
    t: int, scalar or [B]; new_kv: optional (k_t, v_t) [B, Hkv, D]."""
    B, Hq, D = q_t.shape
    Hkv, M = k_cache.shape[1], k_cache.shape[2]
    if pos is None:
        iota = torch.arange(M, dtype=torch.int32, device=q_t.device)
        pos = torch.where(iota < mem_len.reshape(-1, 1, 1), 0, -1).to(
            torch.int32).expand(B, Hkv, M)
    group = Hq // Hkv
    t3 = _lane_clock(t, q_t.device)
    if new_kv is not None:
        k_new, v_new = new_kv
        k_cache = torch.cat([k_cache, k_new[:, :, None].to(k_cache.dtype)],
                            dim=2)
        v_cache = torch.cat([v_cache, v_new[:, :, None].to(v_cache.dtype)],
                            dim=2)
        pos = torch.cat([pos, t3.expand(B, Hkv, 1)], dim=2)
    k = k_cache.repeat_interleave(group, dim=1).float()
    v = v_cache.repeat_interleave(group, dim=1).float()
    ok = pos >= 0
    if window > 0:
        ok = ok & ((t3 - pos) < window)
    valid = ok.repeat_interleave(group, dim=1)
    s = torch.einsum("bhd,bhmd->bhm", q_t.float(), k) / np.sqrt(D)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    p = torch.where(valid, p, torch.zeros_like(p))
    out = torch.einsum("bhm,bhmd->bhd", p, v).to(q_t.dtype)
    if not return_probs:
        return out
    if new_kv is not None:
        return out, p[..., :M], p[..., M]
    return out, p


def decode_attention_cuda(q_t, k_cache, v_cache, pos, t, *, window=0,
                          new_kv=None, return_probs=False, mem_len=None):
    """Launch ``csrc/decode_attention.cu``: B * Hkv clusters of
    ``split_plan(M, B * Hkv)[0]`` CTAs. Same contract as the plain
    version; every tensor must be a contiguous CUDA tensor, q/k/v in one
    dtype (bfloat16 or float32), pos int32; head dim at most 256 and a
    whole number of 16-byte chunks, tensors 16-byte aligned (the kernel
    copies 16 bytes at a time)."""
    build.check_device(q_t)
    dev, dt = q_t.device, q_t.dtype
    B, Hq, D = q_t.shape
    Hkv, M = k_cache.shape[1], k_cache.shape[2]
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    build.check_tensor("q_t", q_t, (B, Hq, D), dt, dev)
    build.check_tensor("k_cache", k_cache, (B, Hkv, M, D), dt, dev)
    build.check_tensor("v_cache", v_cache, (B, Hkv, M, D), dt, dev)
    if (pos is None) == (mem_len is None):
        raise ValueError("pass exactly one of pos and mem_len")
    if pos is None:
        build.check_tensor("mem_len", mem_len, (B,), torch.int32, dev)
    else:
        build.check_tensor("pos", pos, (B, Hkv, M), torch.int32, dev)
    t_arr = torch.as_tensor(t, dtype=torch.int32, device=dev)
    t_arr = t_arr.expand(B).contiguous()
    k_new = v_new = None
    if new_kv is not None:
        k_new, v_new = new_kv
        build.check_tensor("k_new", k_new, (B, Hkv, D), dt, dev)
        build.check_tensor("v_new", v_new, (B, Hkv, D), dt, dev)
    if D > 256 or (D * q_t.element_size()) % 16:
        raise ValueError(f"the decode kernel takes head dim <= 256 in "
                         f"16-byte chunks, got {D} in {dt}")
    out = torch.empty_like(q_t)
    build.check_aligned(q_t=q_t, k_cache=k_cache, v_cache=v_cache, out=out,
                        **({} if new_kv is None else
                           {"k_new": k_new, "v_new": v_new}))
    n_split, split_len = split_plan(M, B * Hkv)
    probs = (torch.empty((B, Hq, M), dtype=torch.float32, device=dev)
             if return_probs else None)
    p_new = (torch.empty((B, Hq), dtype=torch.float32, device=dev)
             if return_probs and new_kv is not None else None)
    ptr = lambda x: None if x is None else x.data_ptr()
    err = build.library().decode_attention_launch(
        int(dt == torch.bfloat16), ptr(q_t), ptr(k_cache), ptr(v_cache),
        ptr(pos), ptr(mem_len), ptr(t_arr), ptr(k_new), ptr(v_new), ptr(out),
        ptr(probs), ptr(p_new), B, Hq, Hkv, M, D, int(window), n_split,
        split_len, torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "decode_attention")
    if not return_probs:
        return out
    if new_kv is not None:
        return out, probs, p_new
    return out, probs
