"""Where a gate-distillation step's time goes on the card.

    PYTHONPATH=src python3 -m repro_torch.launch.profile_train

Needs one CUDA card. Builds trimkv-paper-4b at full width (36 layers,
bf16, random weights from a seed, fresh gates at bias 18) and trains
its gates on batch 1 x 4096 tokens, M 256, as chip_smoke.py's train
phase does. After one warm-up step it:

1. times one train_step on the host clock, ending in a synchronize;
2. runs one more under torch.profiler (CPU and CUDA) and prints the
   device busy time (the sum of the kernels' self time), the card's
   idle share of the untraced step (1 - busy / wall), the device time
   of the capacity-loss kernels, and the top operators by device time
   and by host time.
"""
from __future__ import annotations

import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import TrainConfig, get_config
from repro_torch.data.pipeline import DataConfig, batches
from repro_torch.launch.profiling import device_kernels
from repro_torch.models import transformer as T
from repro_torch.train import distill

B, SEQ, CAP_M = 1, 4096, 256


def main():
    cfg = get_config("trimkv-paper-4b")
    train_cfg = TrainConfig(seq_len=SEQ, capacity_M=CAP_M)
    model = T.init_params(cfg, seed=0, device="cuda")
    T.init_gate_params(model, cfg, seed=1)
    state, opt_cfg = distill.make_train_state(cfg, train_cfg, model)
    data = batches(DataConfig(batch=B, seq_len=SEQ))

    def step(state):
        b = next(data)
        batch = {k: torch.as_tensor(b[k], device="cuda")
                 for k in ("tokens", "lm_labels")}
        state, _ = distill.train_step(state, batch, cfg=cfg,
                                      train_cfg=train_cfg, opt_cfg=opt_cfg)
        torch.cuda.synchronize()
        return state

    state = step(state)                                       # warm up
    t0 = time.perf_counter()
    state = step(state)
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state = step(state)
        traced_wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels, busy, _ = device_kernels(events)
    cap = sum(e.self_device_time_total for e in kernels
              if "capacity_" in e.key) / 1e3
    print(f"train step, {cfg.name} {cfg.num_layers} layers {cfg.dtype}, "
          f"batch {B} x {SEQ} tokens, M {CAP_M}: wall {wall:.3f} s "
          f"({B * SEQ / wall:.1f} train tokens/s)")
    print(f"traced ({len(events)} distinct ops, {len(kernels)} distinct "
          f"kernels): wall {traced_wall:.3f} s, device busy "
          f"{busy:.1f} ms; idle share of the untraced step "
          f"{1 - busy / (wall * 1e3):.3f}; capacity kernels {cap:.2f} ms "
          f"({cap / busy * 100:.2f} % of busy)")
    print(events.table(sort_by="self_device_time_total", row_limit=15))
    print(events.table(sort_by="self_cpu_time_total", row_limit=10))


if __name__ == "__main__":
    main()
