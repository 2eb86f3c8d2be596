"""Retention gates (the paper's learned component).

One gate per attention block: MLP d_model -> gate_hidden -> n_kv_heads,
sigmoid squashed, with a large positive bias so that beta ~= 1 at init.
Ported from ``repro/core/gates.py``; the gate runs in float32 whatever
the model dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import (LOG_BETA_MIN, const, dense,
                                       dense_apply)


class Gate(nn.Module):
    def __init__(self, d_model: int, hidden: int, n_kv_heads: int,
                 bias_init: float, *, device, generator):
        super().__init__()
        kw = dict(dtype=torch.float32, device=device, generator=generator)
        self.w1 = dense(d_model, hidden, **kw)
        self.w2 = dense(hidden, n_kv_heads, scale=0.02, **kw)
        self.b = nn.Parameter(torch.full((n_kv_heads,), float(bias_init),
                                         dtype=torch.float32, device=device))


def gate_logits(g: Gate, x):
    """x: [..., d_model] -> gate pre-sigmoid logits [..., n_kv_heads] f32."""
    h = F.silu(dense_apply(g.w1, x))
    return dense_apply(g.w2, h).float() + g.b


def gate_beta(g: Gate, x):
    """Retention score beta in [0, 1]. [..., n_kv_heads] float32."""
    return torch.sigmoid(gate_logits(g, x))


def gate_log_beta(g: Gate, x):
    """log(beta) as -softplus(-logits), clamped at LOG_BETA_MIN. The
    clamp is ``torch.maximum`` against a cached tensor: its gradient at
    the bound is 0.5, as ``jnp.maximum``'s (``torch.clamp`` would give
    1)."""
    lb = -F.softplus(-gate_logits(g, x))
    return torch.maximum(lb, const(LOG_BETA_MIN, lb.device))
