"""Training loop: data pipeline -> train_step -> metrics/checkpoint.

Ported from ``repro/train/trainer.py``. Gate checkpoints are written in
the JAX package's format and layout (``bridge.gates_to_jax``), so
either package restores them.
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from repro_torch import bridge
from repro_torch.checkpoint import ckpt
from repro_torch.data.pipeline import DataConfig, batches
from repro_torch.models.common import resolve_device
from repro_torch.models.transformer import init_gate_params, init_params
from repro_torch.train.distill import make_train_state, train_step


def train_loop(cfg, train_cfg, data_cfg: DataConfig, *, model=None,
               device="cuda", gate_seed: int = 1,
               steps: Optional[int] = None, ckpt_path: Optional[str] = None,
               ckpt_every: int = 200, log_every: int = 10, log_fn=print):
    """Train the gates of ``model`` (default: ``init_params`` from
    train_cfg.seed on ``device``). A model without gates gets fresh ones
    from ``init_gate_params`` with ``gate_seed``. Returns (state,
    history), one history entry per logged step."""
    if model is None:
        model = init_params(cfg, seed=train_cfg.seed,
                            device=resolve_device(device))
    if all(block.gate is None for block in model.layers):
        init_gate_params(model, cfg, seed=gate_seed)
    state, opt_cfg = make_train_state(cfg, train_cfg, model)
    total = steps if steps is not None else train_cfg.total_steps
    history = []
    t0 = time.time()
    for batch in batches(data_cfg):
        i = batch["step"]
        if i >= total:
            break
        dev_batch = {k: torch.as_tensor(batch[k], device=model.device)
                     for k in ("tokens", "lm_labels")}
        state, metrics = train_step(state, dev_batch, cfg=cfg,
                                    train_cfg=train_cfg, opt_cfg=opt_cfg)
        if i % log_every == 0 or i == total - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = i
            m["sec"] = time.time() - t0
            history.append(m)
            log_fn(f"step {i:5d} loss {m['loss']:.4f} kl {m['kl']:.4f} "
                   f"ntp {m['ntp']:.4f} cap {m['cap']:.4f} "
                   f"gnorm {m['grad_norm']:.3f}")
        if ckpt_path and (i + 1) % ckpt_every == 0:
            ckpt.save(ckpt_path, bridge.gates_to_jax(model, cfg), step=i)
    if ckpt_path:
        ckpt.save(ckpt_path, bridge.gates_to_jax(model, cfg), step=total)
    return state, history
