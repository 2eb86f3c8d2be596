"""TRIM-KV gate training: distillation from the frozen base model
(paper Sec 4.2).

Ported from ``repro/train/distill.py``. Only the gate parameters
receive gradients; the base model is frozen, and the teacher forward is
the same weights with vanilla attention, run under ``torch.no_grad``.
Loss:
  L = use_kl * KL(teacher || student) + use_ntp * CE + lambda_cap * L_cap
with L_cap averaged over gate-bearing layers. When use_kl is False the
teacher forward is skipped entirely (ablation Table 5). The train state
holds the model (its gates are what changes) and the optimizer state.
"""
from __future__ import annotations

import torch

from repro_torch.core.losses import kl_and_ntp_from_hidden
from repro_torch.models.transformer import (forward_train, gate_parameters,
                                            num_gate_layers)
from repro_torch.optim import AdamWConfig, adamw_update, cosine_schedule, \
    init_opt_state


def distill_loss(model, cfg, train_cfg, tokens, lm_labels):
    """tokens, lm_labels: [B, T]. Returns (loss, metrics) as float32
    scalar tensors; differentiable in the gates."""
    cap_M = train_cfg.capacity_M if train_cfg.use_cap else None
    h_s, aux = forward_train(model, cfg, tokens, gated=True, cap_M=cap_M,
                             remat=train_cfg.remat)
    if train_cfg.use_kl:
        with torch.no_grad():
            h_t, _ = forward_train(model, cfg, tokens, gated=False,
                                   remat=train_cfg.remat)
    else:
        h_t = h_s.detach()
    kl, ntp = kl_and_ntp_from_hidden(
        h_s, h_t, model.unembed, lm_labels, vocab_size=cfg.vocab_size,
        use_kl=train_cfg.use_kl, use_ntp=train_cfg.use_ntp)
    n_gates = max(num_gate_layers(cfg), 1)
    cap = aux["cap"] / n_gates
    loss = torch.zeros((), dtype=torch.float32, device=h_s.device)
    if train_cfg.use_kl:
        loss = loss + kl
    if train_cfg.use_ntp:
        loss = loss + ntp
    if train_cfg.use_cap:
        loss = loss + train_cfg.lambda_cap * cap
    return loss, {"kl": kl, "ntp": ntp, "cap": cap, "loss": loss}


def make_train_state(cfg, train_cfg, model):
    """Turn on gradients for the gates (the base stays frozen) and set up
    AdamW with the cosine schedule. Returns (state, opt_cfg)."""
    del cfg
    opt_cfg = AdamWConfig(
        lr=cosine_schedule(train_cfg.learning_rate, train_cfg.warmup_steps,
                           train_cfg.total_steps),
        weight_decay=train_cfg.weight_decay,
        grad_clip=train_cfg.grad_clip)
    gates = gate_parameters(model)
    for p in gates:
        p.requires_grad_(True)
    return {"model": model, "opt": init_opt_state(gates)}, opt_cfg


def train_step(state, batch, *, cfg, train_cfg, opt_cfg):
    """One distillation step. batch: {"tokens": [B,T], "lm_labels":
    [B,T]}. The gates are updated in place. Returns (state, metrics)."""
    model = state["model"]
    gates = gate_parameters(model)
    loss, metrics = distill_loss(model, cfg, train_cfg, batch["tokens"],
                                 batch["lm_labels"])
    grads = torch.autograd.grad(loss, gates, materialize_grads=True)
    new_gates, new_opt, opt_metrics = adamw_update(
        opt_cfg, list(grads), state["opt"], [p.detach() for p in gates])
    with torch.no_grad():
        for p, new in zip(gates, new_gates):
            p.copy_(new)
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics.update(opt_metrics)
    return {"model": model, "opt": new_opt}, metrics
