"""AdamW with decoupled weight decay and global-norm clipping, as plain
functions on lists of tensors.

A direct port of ``repro/optim/adamw.py``, kept step for step (not
``torch.optim.AdamW``): the clip is NaN-safe (a non-finite gradient
norm zeroes the step's gradients instead of poisoning the parameters),
the learning rate is taken at the incremented step, and weight decay
applies to the old parameter. Scalars are float32 tensors, as JAX
computes them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: Callable[[torch.Tensor], torch.Tensor] | float = 2e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0


def init_opt_state(params):
    """params: a list of tensors. The step is a Python int."""
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    return {"mu": [zeros(p) for p in params],
            "nu": [zeros(p) for p in params],
            "step": 0}


def global_norm(tensors):
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tensors))


def adamw_update(cfg: AdamWConfig, grads, opt_state, params):
    """Returns (new_params, new_opt_state, metrics); the inputs are not
    modified."""
    dev = params[0].device
    step = opt_state["step"] + 1
    step_f = torch.tensor(step, dtype=torch.float32, device=dev)
    gn = global_norm(grads)
    if cfg.grad_clip > 0:
        # NaN/inf-safe: a non-finite grad norm skips the update instead
        # of poisoning the params (inf * 0 = NaN inside the clip)
        scale = torch.where(
            torch.isfinite(gn),
            torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-9), max=1.0),
            0.0)
        grads = [torch.where(torch.isfinite(g), g, 0.0) * scale
                 for g in grads]
    lr = cfg.lr(step_f) if callable(cfg.lr) else torch.tensor(
        cfg.lr, dtype=torch.float32, device=dev)
    b1 = torch.tensor(cfg.b1, dtype=torch.float32, device=dev)
    b2 = torch.tensor(cfg.b2, dtype=torch.float32, device=dev)
    corr1, corr2 = 1 - b1 ** step_f, 1 - b2 ** step_f

    new_p, new_mu, new_nu = [], [], []
    for g, mu, nu, p in zip(grads, opt_state["mu"], opt_state["nu"],
                            params):
        g = g.float()
        mu = cfg.b1 * mu + (1 - cfg.b1) * g
        nu = cfg.b2 * nu + (1 - cfg.b2) * g * g
        delta = (mu / corr1) / (torch.sqrt(nu / corr2) + cfg.eps)
        pf = p.float()
        pf = pf - lr * (delta + cfg.weight_decay * pf)
        new_p.append(pf.to(p.dtype))
        new_mu.append(mu)
        new_nu.append(nu)
    return new_p, {"mu": new_mu, "nu": new_nu, "step": step}, {
        "grad_norm": gn, "lr": lr}


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """Linear warmup to base_lr, then cosine decay to 0 at ``total``;
    takes and returns float32 tensors."""
    def lr(step):
        s = step.float()
        warm = base_lr * s / max(warmup, 1)
        frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(s < warmup, warm, cos)
    return lr
