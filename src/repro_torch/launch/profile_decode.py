"""Where a decode step's time goes on the card: host enqueue against
device busy time, for the eager step and for its CUDA graph.

    PYTHONPATH=src python3 -m repro_torch.launch.profile_decode \
        [--policy h2o] [--budget 512] [--temperature 0.8]

Needs one CUDA card. Builds trimkv-paper-4b at full width (36 layers,
bf16, random weights from a seed), prefills batch 4 x 2000 tokens in
chunks of 512 under --budget (default 512) and --policy (default
trimkv; h2o, snapkv and rkv decode through the kernel's probabilities
and their aux update), then, for the eager decode step
(T.decode_step, one Python call per kernel) and for the decode step
program replayed as a CUDA graph (serve.graphs, what Engine.generate
runs when fused):

1. runs 8 decode steps twice on the host clock: once stopping the
   clock when the Python loop returns (the enqueue; PyTorch returns
   before the card finishes) and once after a synchronize (the wall);
2. runs 8 more under torch.profiler (CPU and CUDA) and prints the
   device busy time and the kernel launches per step (the sum of the
   kernels' self time and calls), the card's idle share of the
   untraced wall (1 - busy / wall), the graph replays per step, and the
   top operators by device time. Where the trace shows no kernel of a
   replayed graph, busy is read from CUDA events around the 8 steps
   instead (an upper bound: it includes the gaps between kernels), and
   the script says so.

With --temperature T > 0 the sampled decode step program (threefry
key split, gumbel noise over [4, Vp] and argmax, core.prng, captured in
the same graph) is measured after the greedy one, so its busy time and
top kernels stand beside the greedy step's.

When enqueue and wall are equal and the idle share is high, decode is
bound by the host's launches, not by the card.
"""
from __future__ import annotations

import argparse
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.core import prng
from repro_torch.core.policies import POLICIES
from repro_torch.data.synthetic import make_batch
from repro_torch.launch.profiling import device_kernels
from repro_torch.models import transformer as T
from repro_torch.serve.engine import build_engine

B, PROMPT, CHUNK, STEPS = 4, 2000, 512, 8


def _event_ms(run):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run(STEPS)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def measure(name, run, replays, budget):
    """Print one path's enqueue, wall, busy, idle share, launches and
    replays per step, and its top kernels."""
    run(2)                                               # warm up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(STEPS)
    enqueue = (time.perf_counter() - t0) / STEPS
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / STEPS
    r0 = replays()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(STEPS)
        torch.cuda.synchronize()
        traced_wall = (time.perf_counter() - t0) / STEPS
    n_replays = (replays() - r0) / STEPS
    events = prof.key_averages()
    kernels, busy, launches = device_kernels(events)
    busy, launches = busy / STEPS, launches / STEPS
    source = "profiler"
    if busy == 0:
        busy, launches, source = _event_ms(run) / STEPS, float("nan"), \
            "CUDA events (the trace shows no kernel)"
    print(f"{name}: decode step, batch {B}, budget {budget}: enqueue "
          f"{enqueue * 1e3:.3f} ms, wall {wall * 1e3:.3f} ms "
          f"({B / wall:.1f} tok/s); traced wall {traced_wall * 1e3:.3f} ms, "
          f"device busy {busy:.3f} ms ({source}), {launches:.0f} kernel "
          f"launches and {n_replays:.0f} graph replays per step; idle share "
          f"of the untraced wall {1 - busy / (wall * 1e3):.3f}")
    for e in kernels[:12]:
        ms = e.self_device_time_total / 1e3 / STEPS
        print(f"  {ms:10.4f} ms/step {e.count / STEPS:8.1f} x/step  "
              f"{e.key[:90]}")


@torch.no_grad()
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--policy", choices=tuple(POLICIES), default="trimkv")
    ap.add_argument("--budget", type=int, default=512)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="also measure the sampled step program at this "
                         "temperature")
    args = ap.parse_args(argv)
    cfg = get_config("trimkv-paper-4b")
    model = T.init_params(cfg, seed=0, device="cuda")
    T.init_gate_params(model, cfg, seed=1)
    eng = build_engine(cfg, model, device="cuda", budget=args.budget,
                       policy=args.policy, prefill_chunk=CHUNK,
                       temperature=args.temperature)
    tokens, _, _ = make_batch("copy", 0, B, PROMPT, cfg.vocab_size)
    _, h_last = eng.prefill(tokens, chunked=True)
    tok = [torch.argmax(T.compute_logits(model, cfg, h_last), dim=-1)]
    progs = eng._programs(B)       # its state is the prefilled one
    print(f"{cfg.name} {cfg.num_layers} layers {cfg.dtype}, policy "
          f"{args.policy}, on {torch.cuda.get_device_name(0)}")

    def eager(n):
        for _ in range(n):
            new, logits = T.decode_step(model, cfg, progs.state, tok[0],
                                        eng.policy)
            progs.state["t"].copy_(new["t"])
            tok[0] = torch.argmax(logits, dim=-1)

    def graph(n):
        for _ in range(n):
            tok[0] = progs.decode(tok[0])[0]

    measure("eager", eager, lambda: eng.graphs.replays, args.budget)
    measure("graph", graph, lambda: eng.graphs.replays, args.budget)
    if args.temperature > 0:
        progs.key.copy_(prng.prng_key(0, device="cuda"))

        def sampled(n):
            for _ in range(n):
                tok[0] = progs.decode(tok[0], sampled=True)[0]

        measure(f"graph sampled (T {args.temperature})", sampled,
                lambda: eng.graphs.replays, args.budget)


if __name__ == "__main__":
    main()
