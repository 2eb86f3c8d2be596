"""Where prefill's time goes on the card: wall time against device busy
time, and the operators that take it.

    PYTHONPATH=src python3 -m repro_torch.launch.profile_prefill \
        [--arch granite-moe-3b-a800m] [--smoke] [--layers 8]

Needs one CUDA card. Builds --arch (default trimkv-paper-4b; a dense
or MoE architecture, its smoke config with --smoke, cut to --layers)
at full width (bf16, random weights from a seed) and, for single-shot
prefill and for
chunked prefill (chunks of 512) eager and as the chunk program's CUDA
graph (one replay per chunk; what Engine.prefill runs when fused), of
batch 4 x 2000 tokens under budget 512:

1. runs one prefill to warm up (for the graph: its warm-up step and
   capture), then one on the host clock: the enqueue (the clock read
   when the call returns; the graph path syncs once, uploading its
   valid counts) and the wall (after a synchronize);
2. runs one more under torch.profiler (CPU and CUDA) and prints the
   device busy time and the kernel launches (the sum of the kernels'
   self time and calls), the graph replays, the card's idle share of
   the untraced wall (1 - busy / wall), and the top operators by device
   time. Where the trace shows no kernel of a replayed graph, busy is
   read from CUDA events around the call instead (an upper bound), and
   the script says so.

For an MoE architecture it then prints layer 0's FFN over a chunk's
[4, 512, d] and over the single-shot [4, 2000, d], split into router,
dispatch, experts and combine (profiling.print_moe_stages).
"""
from __future__ import annotations

import argparse
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.data.synthetic import make_batch
from repro_torch.launch.profiling import (add_arch_args, arch_config,
                                          device_kernels, print_moe_stages)
from repro_torch.models import transformer as T
from repro_torch.models.blocks import is_moe
from repro_torch.serve.engine import build_engine

B, PROMPT, BUDGET, CHUNK = 4, 2000, 512, 512


def _prefill(eng, tokens, chunked, fused):
    state, _ = eng.prefill(tokens, chunked=chunked, fused=fused)
    return state


def profile_mode(eng, tokens, chunked: bool, fused: bool):
    """Print one mode's enqueue, wall, device busy, idle share and top
    kernels; return (wall ms, busy ms)."""
    _prefill(eng, tokens, chunked, fused)                   # warm up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _prefill(eng, tokens, chunked, fused)
    enqueue = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    r0 = eng.graphs.replays
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _prefill(eng, tokens, chunked, fused)
        torch.cuda.synchronize()
        traced = (time.perf_counter() - t0) * 1e3
    replays = eng.graphs.replays - r0
    kernels, busy, launches = device_kernels(prof.key_averages())
    source = "profiler"
    if busy == 0:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        _prefill(eng, tokens, chunked, fused)
        end.record()
        torch.cuda.synchronize()
        busy, source = start.elapsed_time(end), \
            "CUDA events (the trace shows no kernel)"
    mode = ("single-shot" if not chunked else
            "chunked " + ("graph" if fused else "eager"))
    print(f"prefill {mode}, batch {B} x {PROMPT} tokens, budget {BUDGET}"
          f"{f', chunks of {CHUNK}' if chunked else ''}: enqueue "
          f"{enqueue:.2f} ms, wall {wall:.2f} ms "
          f"({B * PROMPT / wall * 1e3:.1f} tok/s); traced wall "
          f"{traced:.2f} ms, device busy {busy:.2f} ms ({source}), "
          f"{launches} kernel launches, {replays} graph replays; idle share "
          f"of the untraced wall {1 - busy / wall:.3f}")
    for e in kernels[:12]:
        ms = e.self_device_time_total / 1e3
        print(f"  {ms:10.3f} ms {ms / busy * 100:6.2f} %  {e.count:6d} x  "
              f"{e.key[:100]}")
    return wall, busy


@torch.no_grad()
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_arch_args(ap)
    cfg = arch_config(ap.parse_args(argv))
    model = T.init_params(cfg, seed=0, device="cuda")
    T.init_gate_params(model, cfg, seed=1)
    eng = build_engine(cfg, model, device="cuda", budget=BUDGET,
                       prefill_chunk=CHUNK)
    tokens, _, _ = make_batch("copy", 0, B, PROMPT, cfg.vocab_size)
    tokens = torch.as_tensor(tokens, device="cuda")
    print(f"{cfg.name} {cfg.num_layers} layers {cfg.dtype} on "
          f"{torch.cuda.get_device_name(0)}")
    for chunked, fused in ((False, False), (True, False), (True, True)):
        profile_mode(eng, tokens, chunked, fused)
    if is_moe(cfg):
        print_moe_stages(model, cfg, (B, CHUNK, cfg.d_model),
                         "chunk replay", cfg.num_layers)
        print_moe_stages(model, cfg, (B, PROMPT, cfg.d_model),
                         "single-shot prefill", cfg.num_layers)


if __name__ == "__main__":
    main()
