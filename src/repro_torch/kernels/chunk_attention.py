"""Chunk-query attention over (slot cache ∪ chunk): the CUDA kernel's
wrapper and its plain PyTorch version.

Replaces the Pallas kernel ``chunk_attention_pallas``
(``repro/kernels/chunk_attention.py``) with two CUDA kernels, one per
dtype: bfloat16 runs ``csrc/chunk_attention_tc.cu`` (wgmma and TMA on
the tensor cores, head dim 64, 128 or 256), float32 runs
``csrc/chunk_attention.cu`` (full float32 FMAs on the CUDA cores,
register-blocked like an SGEMM on the tile step of the float32
retention kernel; one CTA serves the q heads of a kv head together;
head dim at most 256). The C queries of a
prefill chunk attend over the M cache slots (per-head positions, -1
empty) and causally over the chunk's own keys. A key is visible iff
its position is >= 0 and 0 <= q_pos - k_pos (< window when windowed);
chunk_pos -1 marks the padded tail, whose queries give zero. Returns (out [B, C, Hq, D],
probs_cache [B, Hkv, C, M] float32 — normalized attention over the
cache slots averaged over each GQA group — or None when need_probs is
False).

``kernels.ops.chunk_attention`` picks the version by the tensors'
device; call that, not these.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import build

NEG_INF = -1e30
# query rows a CTA of the float32 kernel holds at head dim <= 128
# (csrc/f32_flash.cuh, Tile<128>)
F32_ROWS = 128


def f32_tile(D: int) -> tuple[int, int]:
    """(query rows a CTA holds, keys a tile) of the float32 kernels at
    head dim D: the tile step holds 128 dims (128 rows, 64 keys) or, for
    D > 128, 256 (64 rows, 32 keys)."""
    return (F32_ROWS, 64) if D <= 128 else (64, 32)


def row_plan(C: int, G: int, D: int = 128) -> tuple[int, int]:
    """(positions per CTA, row tiles) of the float32 kernel for a chunk
    of C positions, G q heads per kv head and head dim D: a CTA holds the
    G heads of BQ = rows // G positions (f32_tile)."""
    bq = f32_tile(D)[0] // G
    return bq, -(-C // bq)


def _chunk_pos_2d(chunk_pos, B, C, device):
    cp = torch.as_tensor(chunk_pos, dtype=torch.int32, device=device)
    return torch.atleast_2d(cp).expand(B, C)


def chunk_attention_torch(q, k_c, v_c, cache_k, cache_v, cache_pos,
                          chunk_pos, *, window=0, need_probs=True):
    """Plain version, after ``repro/models/blocks.py:_chunk_attend``:
    materializes the [B, Hq, C, M + C] scores. q: [B, C, Hq, D]; k_c,
    v_c: [B, C, Hkv, D]; cache_k, cache_v: [B, Hkv, M, D]; cache_pos:
    [B, Hkv, M] int32; chunk_pos: [C] or [B, C] int32."""
    B, C, Hq, D = q.shape
    Hkv = k_c.shape[2]
    M = cache_pos.shape[-1]
    group = Hq // Hkv
    cp2 = _chunk_pos_2d(chunk_pos, B, C, q.device)
    keys = torch.cat([cache_k.float(), k_c.transpose(1, 2).float()], dim=2)
    vals = torch.cat([cache_v.float(), v_c.transpose(1, 2).float()], dim=2)
    pos = torch.cat([cache_pos, cp2[:, None].expand(B, Hkv, C)], dim=2)
    keys_r = keys.repeat_interleave(group, dim=1)
    vals_r = vals.repeat_interleave(group, dim=1)
    pos_r = pos.repeat_interleave(group, dim=1)              # [B,Hq,M+C]
    s = torch.einsum("bchd,bhnd->bhcn", q.float(), keys_r) / np.sqrt(D)
    qpos = cp2[:, None, :, None]
    dist = qpos - pos_r[:, :, None, :]
    mask = (pos_r[:, :, None, :] >= 0) & (dist >= 0)
    if window > 0:
        mask = mask & (dist < window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask, p, torch.zeros_like(p))
    out = torch.einsum("bhcn,bhnd->bchd", p, vals_r).to(q.dtype)
    if not need_probs:
        return out, None
    probs_cache = p[..., :M].reshape(B, Hkv, group, C, M).mean(dim=2)
    return out, probs_cache


def chunk_attention_cuda(q, k_c, v_c, cache_k, cache_v, cache_pos,
                         chunk_pos, *, window=0, need_probs=True):
    """Launch the kernel of q's dtype: bfloat16
    ``csrc/chunk_attention_tc.cu`` (head dim 64, 128 or 256,
    16-byte-aligned tensors, as TMA reads them; M + C up to ~8,000 keys
    at D 128, the positions it keeps in shared memory), float32
    ``csrc/chunk_attention.cu`` (head dim at most 256 and a multiple of
    4, 16-byte-aligned tensors, as cp.async copies them; M + C up to
    ~225,000 keys at D 128, a flag and a list entry per key tile in
    shared memory). Same contract as the
    plain version; every tensor must be a contiguous CUDA tensor, q/k/v
    and the cache in one dtype, positions int32."""
    build.check_device(q)
    dev, dt = q.device, q.dtype
    B, C, Hq, D = q.shape
    Hkv, M = cache_k.shape[1], cache_k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    build.check_tensor("q", q, (B, C, Hq, D), dt, dev)
    build.check_tensor("k_c", k_c, (B, C, Hkv, D), dt, dev)
    build.check_tensor("v_c", v_c, (B, C, Hkv, D), dt, dev)
    build.check_tensor("cache_k", cache_k, (B, Hkv, M, D), dt, dev)
    build.check_tensor("cache_v", cache_v, (B, Hkv, M, D), dt, dev)
    build.check_tensor("cache_pos", cache_pos, (B, Hkv, M), torch.int32,
                       dev)
    cp2 = _chunk_pos_2d(chunk_pos, B, C, dev).contiguous()
    out = torch.empty_like(q)
    probs = (torch.empty((B, Hq, C, M), dtype=torch.float32, device=dev)
             if need_probs else None)
    ptrs = (q.data_ptr(), k_c.data_ptr(), v_c.data_ptr(),
            cache_k.data_ptr(), cache_v.data_ptr(), cache_pos.data_ptr(),
            cp2.data_ptr(), out.data_ptr(),
            None if probs is None else probs.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    tensors = dict(q=q, k_c=k_c, v_c=v_c, cache_k=cache_k, cache_v=cache_v,
                   out=out)
    if dt == torch.bfloat16:
        build.check_tc(D, **tensors)
        err = build.library().chunk_attention_tc_launch(
            *ptrs, B, C, Hq, Hkv, M, D, int(window), stream)
    else:
        rows, keys = f32_tile(D)
        if Hq // Hkv > rows:
            raise ValueError(f"the float32 chunk kernel takes at most "
                             f"{rows} q heads per kv head at D={D}, got "
                             f"Hq={Hq}, Hkv={Hkv}")
        build.check_f32("chunk", D, **tensors)
        # the running max of each row after each cache tile, for the
        # probabilities' final rescale
        pmax = (torch.empty((B, Hq, C, -(-M // keys)), dtype=torch.float32,
                            device=dev) if need_probs else None)
        err = build.library().chunk_attention_launch(
            *ptrs, None if pmax is None else pmax.data_ptr(), B, C, Hq, Hkv,
            M, D, row_plan(C, Hq // Hkv, D)[0], int(window), stream)
    build.check(err, "chunk_attention")
    if not need_probs:
        return out, None
    return out, probs.reshape(B, Hkv, Hq // Hkv, C, M).mean(dim=2)
