"""Shared building blocks: devices, dtypes, linear layers, RMSNorm, the
SwiGLU MLP, half-split RoPE and the training attention.

Ported from ``repro/models/common.py``. Parameters live in cfg.dtype
(bf16 at full width); normalization and RoPE compute in float32, as in
the JAX package.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

# Minimum log-beta: beta -> 0 means "evict immediately"; clamp keeps
# exp((t-i)*log beta) finite.
LOG_BETA_MIN = -80.0
NEG_INF = -1e30


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. ``"cuda"`` (the default of
    every entry point) requires a card and raises without one: the port
    never falls back to the CPU unless the caller asks for it. Float32
    matmuls and convolutions run in full float32 on the card (TF32
    off), so a float32 run on the card is comparable with the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain PyTorch path")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device


def to_dtype(cfg_dtype: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg_dtype]


def dense(in_dim: int, out_dim: int, *, bias: bool = False, dtype,
          device, generator: torch.Generator, scale=None) -> nn.Linear:
    """``nn.Linear`` initialised as ``common.dense_init``: weights
    N(0, 1) * scale (default 1/sqrt(in)), bias zero. The draws come from
    ``generator`` on ``device``, so they differ from jax.random's; load
    the JAX package's weights through ``repro_torch.bridge`` to compare
    the two."""
    lin = torch.nn.utils.skip_init(nn.Linear, in_dim, out_dim, bias=bias,
                                   device=device, dtype=dtype)
    scale = scale if scale is not None else 1.0 / np.sqrt(in_dim)
    with torch.no_grad():
        w = torch.empty((out_dim, in_dim), dtype=torch.float32,
                        device=device)
        w.normal_(0.0, 1.0, generator=generator)
        lin.weight.copy_(w * scale)
        if bias:
            lin.bias.zero_()
    return lin


class RMSNorm(nn.Module):
    """Holds the float32 scale that ``rmsnorm_apply`` reads."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, dtype=torch.float32,
                                             device=device))


def rmsnorm_apply(scale, x, eps: float = 1e-6):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def dense_apply(lin: nn.Linear, x):
    """``x @ w (+ b)``; the input is cast to the layer's dtype first, as
    jnp promotes a bf16 activation against float32 gate weights."""
    return F.linear(x.to(lin.weight.dtype), lin.weight, lin.bias)


class MLP(nn.Module):
    """SwiGLU feed-forward: down(silu(gate(x)) * up(x))."""

    def __init__(self, d_model: int, d_ff: int, *, dtype, device,
                 generator):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.gate = dense(d_model, d_ff, **kw)
        self.up = dense(d_model, d_ff, **kw)
        self.down = dense(d_ff, d_model, **kw)


def mlp_apply(p: MLP, x):
    g = F.silu(dense_apply(p.gate, x))
    u = dense_apply(p.up, x)
    return dense_apply(p.down, g * u)


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    half = head_dim // 2
    return 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(head_dim: int, theta: float, device: torch.device):
    """rope_freqs as a tensor on ``device``, copied there once: a host
    copy per call would wait for the card at every layer."""
    return torch.as_tensor(rope_freqs(head_dim, theta), device=device)


@functools.lru_cache(maxsize=None)
def const(value: float, device: torch.device):
    """A float32 0-d tensor on ``device``, made once. ``torch.maximum``
    against it keeps ``jnp.maximum``'s tie gradient (0.5) without a fill
    kernel per call. Never written to; made outside inference mode so
    autograd may save it."""
    with torch.inference_mode(False):
        return torch.full((), value, dtype=torch.float32, device=device)


def checkpointed(fn, *args):
    """fn(*args) under non-reentrant ``torch.utils.checkpoint`` when
    autograd records (backward recomputes it), else a plain call."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def apply_rope(x, positions, theta: float):
    """Half-split RoPE. x: [..., T, H, Dh]; positions: broadcastable to
    [..., T] (int)."""
    head_dim = x.shape[-1]
    freqs = _rope_freqs_on(head_dim, float(theta), x.device)
    angles = positions[..., None].float() * freqs           # [..., T, Dh/2]
    angles = angles[..., None, :]                           # [..., T, 1, Dh/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------ attention
# Training attention (full sequence, differentiable): q-blocks x
# kv-blocks with an online-softmax carry, each q-block under
# torch.utils.checkpoint so backward memory is O(block^2), not O(T^2).
# Plain PyTorch with autograd, as the JAX package leaves it to XLA.


def _attend_block(q, k, v, bias, mask, carry):
    """One (q_blk, kv_blk) tile of online softmax.

    q: [B,H,Bq,D] k/v: [B,H,Bk,D] bias: [B,H,Bq,Bk] or None
    mask: [Bq,Bk] bool; carry = (m, l, acc).
    """
    m, l, acc = carry
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    s = s / np.sqrt(q.shape[-1])
    if bias is not None:
        s = s + bias
    s = torch.where(mask, s, NEG_INF)
    # torch.maximum and amax split a tie's gradient evenly, as JAX does
    m_new = torch.maximum(m, torch.amax(s, dim=-1))
    p = torch.exp(s - m_new[..., None])
    # re-zero masked keys: in a fully-masked block m_new is still
    # NEG_INF and exp(s - m_new) = 1 there
    p = torch.where(mask, p, 0.0)
    scale = torch.exp(m - m_new)
    l_new = l * scale + p.sum(dim=-1)
    acc_new = acc * scale[..., None] + torch.einsum(
        "bhqk,bhkd->bhqd", p, v.float())
    return m_new, l_new, acc_new


def chunked_attention(q, k, v, *, log_beta=None, causal=True, window=0,
                      q_offset=0, q_block=512, kv_block=512):
    """Memory-efficient attention with optional retention bias.

    q: [B, Tq, Hq, D]; k, v: [B, Tk, Hkv, D] (GQA: Hq % Hkv == 0)
    log_beta: [B, Tk, Hkv] per-key retention log-score; adds
        (t - i) * log_beta_i to the logit (paper Eq. 3).
    window: sliding-window size (0 = unbounded).
    q_offset: absolute position of q[0] (for prefill continuation).
    Returns [B, Tq, Hq, D] in q.dtype. Keys sit at positions 0..Tk-1
    (the JAX package's kv_positions, which only its encoder and cross
    attention pass, is not ported).

    The last q and kv blocks are cut short where the JAX package pads
    them (padded keys are masked there, padded queries dropped). A kv
    block that the causal mask or the window hides from every query of
    a q block is skipped: the JAX package scans it and it changes
    nothing.
    """
    B, Tq, Hq, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    dev = q.device
    qh = q.transpose(1, 2)                                   # [B,Hq,Tq,D]
    kh = k.transpose(1, 2).repeat_interleave(group, dim=1)   # [B,Hq,Tk,D]
    vh = v.transpose(1, 2).repeat_interleave(group, dim=1)
    lb = None
    if log_beta is not None:
        lb = log_beta.float().transpose(1, 2).repeat_interleave(
            group, dim=1)                                    # [B,Hq,Tk]
    q_block = min(q_block, Tq)
    kv_block = min(kv_block, Tk)

    def one_q_block(q_blk, kh, vh, lb, q0):
        Bq = q_blk.shape[2]
        q_pos = q_offset + q0 + torch.arange(Bq, device=dev)
        m = torch.full((B, Hq, Bq), NEG_INF, device=dev)
        l = torch.zeros((B, Hq, Bq), device=dev)
        acc = torch.zeros((B, Hq, Bq, D), device=dev)
        for k0 in range(0, Tk, kv_block):
            k1 = min(k0 + kv_block, Tk)
            if causal and k0 > q_offset + q0 + Bq - 1:
                break                              # every key is in the future
            if window > 0 and k1 - 1 <= q_offset + q0 - window:
                continue                           # every key left the window
            dist = q_pos[:, None] - torch.arange(k0, k1, device=dev)[None]
            mask = torch.ones_like(dist, dtype=torch.bool)    # [Bq,Bk]
            if causal:
                mask = mask & (dist >= 0)
            if window > 0:
                mask = mask & (dist < window)
            bias = None
            if lb is not None:
                bias = dist.float() * lb[:, :, None, k0:k1]
                bias = torch.where(mask, bias, 0.0)
            m, l, acc = _attend_block(q_blk, kh[:, :, k0:k1], vh[:, :, k0:k1],
                                      bias, mask, (m, l, acc))
        return acc / torch.maximum(l, torch.full((), 1e-30,
                                                 device=dev))[..., None]

    outs = [checkpointed(one_q_block, qh[:, :, q0:q0 + q_block], kh, vh, lb,
                         q0)
            for q0 in range(0, Tq, q_block)]
    out = torch.cat(outs, dim=2)                             # [B,Hq,Tq,D]
    return out.transpose(1, 2).to(q.dtype)


def full_attention_ref(q, k, v, *, log_beta=None, causal=True, window=0,
                       q_offset=0):
    """O(T^2)-memory oracle used by tests; same semantics as
    chunked_attention."""
    B, Tq, Hq, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    dev = q.device
    kr = k.repeat_interleave(group, dim=2)
    vr = v.repeat_interleave(group, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float()) / np.sqrt(D)
    q_pos = q_offset + torch.arange(Tq, device=dev)
    dist = q_pos[:, None] - torch.arange(Tk, device=dev)[None]   # [Tq,Tk]
    mask = torch.ones_like(dist, dtype=torch.bool)
    if causal:
        mask = mask & (dist >= 0)
    if window > 0:
        mask = mask & (dist < window)
    if log_beta is not None:
        lb = log_beta.repeat_interleave(group, dim=2)        # [B,Tk,Hq]
        bias = dist.float() * lb.float().transpose(1, 2)[:, :, None, :]
        s = s + torch.where(mask, bias, 0.0)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    # fully-masked rows: zero them, as chunked_attention gives
    p = torch.where(mask, p, 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vr.float())
    return out.to(q.dtype)
