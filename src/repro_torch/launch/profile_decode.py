"""Where a decode step's time goes on the card: host enqueue against
device busy time.

    PYTHONPATH=src python3 -m repro_torch.launch.profile_decode

Needs one CUDA card. Builds trimkv-paper-4b at full width (36 layers,
bf16, random weights from a seed), prefills batch 4 x 2000 tokens in
chunks of 512 under budget 512, then:

1. runs 8 decode steps twice on the host clock: once stopping the
   clock when the Python loop returns (the enqueue; PyTorch returns
   before the card finishes) and once after a synchronize (the wall);
2. runs 8 more under torch.profiler (CPU and CUDA) and prints the
   device busy time and the kernel launches per step (the sum of the
   kernels' self time and calls), the card's idle share of the
   untraced wall (1 - busy / wall), and the top operators by host and
   by device time.

When enqueue and wall are equal and the idle share is high, decode is
bound by the host's launches, not by the card.
"""
from __future__ import annotations

import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.core.policies import TrimKV
from repro_torch.data.synthetic import make_batch
from repro_torch.launch.profiling import device_kernels
from repro_torch.models import transformer as T
from repro_torch.serve.engine import build_engine

B, PROMPT, BUDGET, CHUNK, STEPS = 4, 2000, 512, 512, 8


def _steps(model, cfg, state, tok, policy, n):
    for _ in range(n):
        state, logits = T.decode_step(model, cfg, state, tok, policy)
        tok = torch.argmax(logits, dim=-1)
    return state, tok


@torch.no_grad()
def main():
    cfg = get_config("trimkv-paper-4b")
    model = T.init_params(cfg, seed=0, device="cuda")
    T.init_gate_params(model, cfg, seed=1)
    eng = build_engine(cfg, model, device="cuda", budget=BUDGET,
                       prefill_chunk=CHUNK)
    tokens, _, _ = make_batch("copy", 0, B, PROMPT, cfg.vocab_size)
    state, h_last = eng.prefill(tokens, chunked=True)
    tok = torch.argmax(T.compute_logits(model, cfg, h_last), dim=-1)
    policy = TrimKV()
    state, tok = _steps(model, cfg, state, tok, policy, 2)     # warm up
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    state, tok = _steps(model, cfg, state, tok, policy, STEPS)
    enqueue = (time.perf_counter() - t0) / STEPS
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / STEPS

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, tok = _steps(model, cfg, state, tok, policy, STEPS)
        torch.cuda.synchronize()
        traced_wall = (time.perf_counter() - t0) / STEPS
    events = prof.key_averages()
    _, busy, launches = device_kernels(events)
    busy, launches = busy / STEPS, launches / STEPS
    print(f"decode step, {cfg.name} {cfg.num_layers} layers, batch {B}, "
          f"budget {BUDGET}: enqueue {enqueue * 1e3:.2f} ms, wall "
          f"{wall * 1e3:.2f} ms ({B / wall:.1f} tok/s)")
    print(f"traced ({len(events)} distinct ops): wall "
          f"{traced_wall * 1e3:.2f} ms, device busy "
          f"{busy:.2f} ms and {launches:.0f} kernel launches per step; "
          f"idle share of the untraced wall {1 - busy / (wall * 1e3):.3f}")
    print(events.table(sort_by="self_cpu_time_total", row_limit=12))
    print(events.table(sort_by="self_device_time_total", row_limit=12))


if __name__ == "__main__":
    main()
