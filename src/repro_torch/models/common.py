"""Shared building blocks: devices, dtypes, linear layers, RMSNorm, the
SwiGLU MLP and half-split RoPE.

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
