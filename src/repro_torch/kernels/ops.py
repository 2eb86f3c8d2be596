"""Dispatch for the attention and capacity-loss kernels, by device.

A tensor on the CPU goes to the kernel's plain PyTorch version; a CUDA
tensor goes to the hand-written CUDA kernel, which launches or raises —
there is no fallback from one to the other. ``LAUNCHES`` counts the
kernel launches made through these functions, one per launch. The
attention kernels count under the name of the kernel that ran: bfloat16
retention and chunk attention run the tensor-core kernels
(``retention_attention``, ``chunk_attention``), float32 the CUDA-core
kernels (``retention_attention_f32``, ``chunk_attention_f32``). The
capacity loss counts its forward kernel under ``capacity_loss`` and,
when autograd runs its backward, the backward kernel under
``capacity_loss_bwd``; the hybrid family's RG-LRU scan under
``rg_lru_scan``, the ssm family's selective scan under
``selective_scan``. CPU calls count nothing.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.capacity_loss import (CapacityLoss,
                                               capacity_loss_torch)
from repro_torch.kernels.chunk_attention import (chunk_attention_cuda,
                                                 chunk_attention_torch)
from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                  decode_attention_torch)
from repro_torch.kernels.retention_attention import (
    retention_attention_cuda, retention_attention_torch)
from repro_torch.kernels.rg_lru import rg_lru_scan_cuda, rg_lru_scan_torch
from repro_torch.kernels.selective_scan import (selective_scan_cuda,
                                                selective_scan_torch)

KERNELS = ("decode_attention", "chunk_attention", "retention_attention",
           "chunk_attention_f32", "retention_attention_f32",
           "capacity_loss", "capacity_loss_bwd", "rg_lru_scan",
           "selective_scan")
LAUNCHES = dict.fromkeys(KERNELS, 0)


def reset_launches():
    for name in KERNELS:
        LAUNCHES[name] = 0


def _on_cpu(x) -> bool:
    return x.device.type == "cpu"


def _launched(name: str):
    LAUNCHES[name] += 1


def _route(name: str, x) -> str:
    """The launch count of x's attention kernel: the tensor-core one for
    bfloat16, the float32 one otherwise."""
    return name if x.dtype == torch.bfloat16 else name + "_f32"


def decode_attention(q_t, k_cache, v_cache, pos, t, *, window=0,
                     new_kv=None, return_probs=False, mem_len=None):
    """One decode position's attention over the slot cache (plus the
    in-flight token when new_kv is given), or over a memory slab of
    mem_len valid slots a lane with pos None; see
    kernels/decode_attention.py."""
    if _on_cpu(q_t):
        return decode_attention_torch(q_t, k_cache, v_cache, pos, t,
                                      window=window, new_kv=new_kv,
                                      return_probs=return_probs,
                                      mem_len=mem_len)
    LAUNCHES["decode_attention"] += 1
    return decode_attention_cuda(q_t, k_cache, v_cache, pos, t,
                                 window=window, new_kv=new_kv,
                                 return_probs=return_probs, mem_len=mem_len)


def chunk_attention(q, k_c, v_c, cache, chunk_pos, *, window=0,
                    need_probs=True):
    """Chunk-query attention over (bounded cache ∪ chunk); cache is the
    slot-cache dict (k, v, pos are read). See
    kernels/chunk_attention.py."""
    args = (q, k_c, v_c, cache["k"], cache["v"], cache["pos"], chunk_pos)
    if _on_cpu(q):
        return chunk_attention_torch(*args, window=window,
                                     need_probs=need_probs)
    LAUNCHES[_route("chunk_attention", q)] += 1
    return chunk_attention_cuda(*args, window=window, need_probs=need_probs)


def retention_attention(q, k, v, log_beta=None, *, causal=True, window=0,
                        q_offset=0):
    """Causal (retention-gated) flash attention; see
    kernels/retention_attention.py."""
    if _on_cpu(q):
        return retention_attention_torch(q, k, v, log_beta, causal=causal,
                                         window=window, q_offset=q_offset)
    LAUNCHES[_route("retention_attention", q)] += 1
    return retention_attention_cuda(q, k, v, log_beta, causal=causal,
                                    window=window, q_offset=q_offset)


def rg_lru_scan(a_log, bx, h0):
    """The RG-LRU recurrence over a_log, bx [B, T, W] from h0 [B, W]
    (float32): every h_t, [B, T, W]. See kernels/rg_lru.py."""
    if _on_cpu(a_log):
        return rg_lru_scan_torch(a_log, bx, h0)
    LAUNCHES["rg_lru_scan"] += 1
    return rg_lru_scan_cuda(a_log, bx, h0)


def selective_scan(dt, xs, Bm, Cm, A, h0, n_valid):
    """The Mamba-1 selective scan over T steps from h0 [B, di, n], steps
    past n_valid [B] the identity: (ys [B, T, di], h_last [B, di, n]),
    float32. See kernels/selective_scan.py."""
    if _on_cpu(dt):
        return selective_scan_torch(dt, xs, Bm, Cm, A, h0, n_valid)
    LAUNCHES["selective_scan"] += 1
    return selective_scan_cuda(dt, xs, Bm, Cm, A, h0, n_valid)


def capacity_loss_log(log_beta, M: float):
    """L_cap from log_beta [B, T, H] (the gates' log-space output), the
    form training calls; differentiable. See kernels/capacity_loss.py."""
    if _on_cpu(log_beta):
        return capacity_loss_torch(log_beta, M)
    return CapacityLoss.apply(log_beta, M, _launched)


def capacity_loss(beta, M: float):
    """L_cap from beta [B, T, H], taking logs as capacity_loss_pallas
    does: log(max(beta, 1e-30))."""
    b = beta.float()
    return capacity_loss_log(
        torch.log(torch.maximum(b, torch.full((), 1e-30, device=b.device))),
        M)
