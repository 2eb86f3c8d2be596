"""Serving launcher of the PyTorch port: batched generation under a KV
budget, one-shot or as a continuous-batching stream.

One-shot (the JAX package's non-stream mode): random weights from
--seed, a synthetic "copy" batch, one Engine.generate, then the decode
rate and the first row of ids.

  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
      --budget 32 --prompt-len 64 --max-new 16

Continuous batching (--stream): a synthetic Poisson request stream with
ragged prompt lengths and per-request decode budgets is served on
--lanes fixed lanes by the lane scheduler (serve.scheduler): requests
admit into free lanes, decode in segments, retire on EOS/max_new and
refill at once. A short warm-up drain first (two of the requests cut to
two tokens: it captures the step programs' CUDA graphs on the card),
then the measured run.

  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
      --stream --requests 6 --lanes 2 --prompt-len 40 --max-new 8 \\
      --prefill-chunk 16 --decode-segment 4 [--interleaved]

--device defaults to cuda (the hand-written kernels and, unless
--eager, the CUDA graphs); without a card it fails rather than fall back
to the CPU.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import PORTED_ARCHS, get_config, get_smoke_config
from repro_torch.core.policies import POLICIES
from repro_torch.data.synthetic import make_batch
from repro_torch.models import transformer as T
from repro_torch.serve.engine import build_engine
from repro_torch.serve.faults import FaultInjector
from repro_torch.serve.request import (TERMINAL_STATUSES, Request,
                                       latency_percentiles)
from repro_torch.serve.scheduler import Scheduler, warm_up


def poisson_requests(n, rate, *, vocab, prompt_lo, prompt_hi, new_lo,
                     new_hi, seed=0, eos_id=-1, priority_frac=0.0,
                     high_deadline_ms=None, low_deadline_ms=None,
                     timeout_ms=None):
    """Synthetic Poisson trace (a copy of the JAX launcher's, without
    its cross-memory and shared-prefix options): exponential
    inter-arrival gaps at `rate` req/s, ragged prompt lengths and
    per-request max_new drawn uniformly, one seed per request. A
    `priority_frac` fraction of requests is the high class (priority 1,
    deadline high_deadline_ms); the rest is priority 0 with
    low_deadline_ms. The same seed gives the JAX launcher's trace."""
    rng = np.random.RandomState(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, size=n))
    reqs = []
    for i in range(n):
        L = int(rng.randint(prompt_lo, prompt_hi + 1))
        high = bool(rng.rand() < priority_frac)
        prompt = rng.randint(0, vocab, size=L).astype(np.int32)
        reqs.append(Request(
            rid=i, prompt=prompt,
            max_new=int(rng.randint(new_lo, new_hi + 1)), seed=i,
            eos_id=eos_id, arrival=float(arrivals[i]),
            priority=1 if high else 0,
            deadline_ms=high_deadline_ms if high else low_deadline_ms,
            timeout_ms=timeout_ms))
    return reqs


def _pct(vals):
    p = latency_percentiles(vals)
    if p is None:
        return "n/a"
    return (f"p50 {p['p50'] * 1e3:.1f}ms p95 {p['p95'] * 1e3:.1f}ms "
            f"p99 {p['p99'] * 1e3:.1f}ms")


def _run_stream(cfg, model, args):
    eng = build_engine(cfg, model, device=args.device, budget=args.budget,
                       policy=args.policy, prefill_chunk=args.prefill_chunk,
                       decode_segment=args.decode_segment,
                       sched_policy=args.sched_policy,
                       prefill_budget=args.prefill_budget,
                       interleaved=args.interleaved,
                       shed_policy=args.shed_policy, fused=not args.eager,
                       temperature=args.temperature,
                       checkpoint_every=args.checkpoint_every,
                       snapshot_dir=args.snapshot_dir,
                       snapshot_host_bytes=args.snapshot_host_bytes)
    reqs = poisson_requests(
        args.requests, args.rate, vocab=cfg.vocab_size,
        prompt_lo=max(args.prompt_len // 4, 4), prompt_hi=args.prompt_len,
        new_lo=max(args.max_new // 4, 1), new_hi=args.max_new,
        seed=args.seed, priority_frac=args.priority_frac,
        high_deadline_ms=args.deadline_ms, timeout_ms=args.timeout_ms)
    greedy = args.temperature == 0.0
    injector = None
    if args.inject_faults:
        injector = FaultInjector(seed=args.fault_seed,
                                 corrupt_prob=args.corrupt_prob,
                                 delay_prob=args.delay_prob,
                                 delay_sec=args.delay_sec,
                                 burst_prob=args.burst_prob,
                                 snap_corrupt_prob=args.snap_corrupt_prob,
                                 io_error_prob=args.io_error_prob)
    # a short warm-up drain captures the step programs, so the printed
    # latencies measure serving
    warm_up(eng, args.lanes, reqs, greedy=greedy)
    sched = Scheduler(eng, n_lanes=args.lanes, greedy=greedy,
                      injector=injector)
    eng.dispatch_count = 0           # count the measured run only
    replays0 = eng.graphs.replays if eng.graphs is not None else 0
    results = sched.run(reqs, respect_arrivals=True)
    sched.close()
    lats = [results[r.rid].latency_sec for r in reqs
            if results[r.rid].latency_sec is not None] or [0.0]
    total_tok = sum(len(results[r.rid].tokens) for r in reqs)
    wall = max(rs.finish_sec or 0.0 for rs in results.values())
    st = sched.stats()
    print(f"stream: {args.requests} requests over {args.lanes} lanes "
          f"(device={eng.device} policy={args.policy} budget={args.budget} "
          f"segment={args.decode_segment} sched={args.sched_policy} "
          f"{'interleaved' if sched.interleaved else 'phased'}, "
          f"{'eager' if args.eager else 'fused'})")
    replays = (eng.graphs.replays - replays0 if eng.graphs is not None
               else "n/a (no card)")
    print(f"  dispatches={eng.dispatch_count} "
          f"(prefill rounds={sched.n_prefill_rounds}, "
          f"segments={sched.n_segments}, resets={sched.n_resets}, "
          f"preempted={sched.n_preempted}); steps {sched.steps_run}; "
          f"graph replays={replays}")
    print(f"  supervision: swaps={st['n_swaps']} "
          f"resumes={st['n_resumes']} retries={st['n_retries']} "
          f"quarantined={st['n_quarantined']} shed={st['n_shed']} "
          f"timeouts={st['n_timeouts']} failed={st['n_failed']} "
          f"faults_injected={st['n_faults_injected']}")
    print(f"  store: puts={st['store_puts']} "
          f"ram_hits={st['store_ram_hits']} "
          f"disk_hits={st['store_disk_hits']} "
          f"spills={st['store_spills']} "
          f"evictions={st['store_evictions']} "
          f"dropped={st['store_dropped']} "
          f"corrupt_detected={st['store_corrupt_detected']} "
          f"write_errors={st['store_write_errors']} "
          f"io_errors={st['store_io_errors']} "
          f"snapshot_lost={st['n_snapshot_lost']} "
          f"recovered_sessions={st['n_recovered_sessions']}")
    if injector is not None:
        n_terminal = sum(rs.status in TERMINAL_STATUSES
                         for rs in results.values())
        print(f"  chaos: {len(results)} submitted (bursts included), "
              f"{n_terminal} terminal; liveness "
              f"{'OK' if n_terminal == len(results) else 'VIOLATED'}")
    print(f"  {total_tok} tokens in {wall:.2f}s "
          f"= {total_tok / max(wall, 1e-9):.1f} tok/s; latency "
          f"mean {np.mean(lats):.2f}s p95 {np.percentile(lats, 95):.2f}s; "
          f"host enqueue {sched.enqueue_sec / max(sched.n_segments, 1) * 1e3:.2f}"
          f" ms per segment dispatch")
    for prio in sorted({r.priority for r in reqs}, reverse=True):
        states = [results[r.rid] for r in reqs if r.priority == prio]
        missed = [rs for rs in states if rs.missed_deadline]
        print(f"  priority {prio} ({len(states)} reqs): "
              f"ttft {_pct([rs.ttft_sec for rs in states])}, "
              f"tpot {_pct([rs.tpot_sec for rs in states])}, "
              f"deadline misses {len(missed)}")
    for r in reqs[: min(4, len(reqs))]:
        rs = results[r.rid]
        lat = (f"{rs.latency_sec:.2f}s" if rs.latency_sec is not None
               else rs.status.value)
        print(f"  req {r.rid}: prompt {r.prompt_len} -> "
              f"{len(rs.tokens)} tokens, latency {lat}, "
              f"ids {rs.ids[:8]}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=PORTED_ARCHS, default="trimkv-paper-4b")
    ap.add_argument("--smoke", action="store_true",
                    help="the architecture's reduced smoke config")
    ap.add_argument("--device", default="cuda",
                    help="cuda (CUDA kernels and graphs) or cpu (plain "
                         "PyTorch, eager)")
    ap.add_argument("--policy", choices=tuple(POLICIES), default="trimkv",
                    help="eviction policy (core.policies)")
    ap.add_argument("--budget", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--chunked", action="store_true")
    ap.add_argument("--prefill-chunk", type=int, default=2048,
                    help="chunk width for chunked prefill (the tail chunk "
                         "is padded to this width and masked)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eager", action="store_true",
                    help="run every step eagerly (fused=False) instead of "
                         "replaying its CUDA graph")
    ap.add_argument("--stream", action="store_true",
                    help="serve a synthetic Poisson request stream through "
                         "the lane scheduler")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--rate", type=float, default=4.0,
                    help="--stream: Poisson arrival rate (req/s)")
    ap.add_argument("--decode-segment", type=int, default=16)
    ap.add_argument("--sched-policy", choices=("fifo", "priority", "edf"),
                    default="fifo")
    ap.add_argument("--interleaved", action="store_true",
                    help="--stream: admission prefill inside the decode "
                         "segments instead of phased admission")
    ap.add_argument("--prefill-budget", type=int, default=0,
                    help="--stream: prompt tokens per interleaved segment "
                         "(0 = unlimited)")
    ap.add_argument("--priority-frac", type=float, default=0.25)
    ap.add_argument("--deadline-ms", type=float, default=500.0)
    ap.add_argument("--timeout-ms", type=float, default=None)
    ap.add_argument("--shed-policy", choices=("reject", "evict"),
                    default="reject")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy); each "
                         "request's threefry key chain starts from its "
                         "seed")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="--stream: snapshot decoding lanes every N "
                         "segments (0 = off) so fault replay resumes "
                         "from the last checkpoint")
    ap.add_argument("--snapshot-dir", default=None,
                    help="--stream: disk tier for lane snapshots "
                         "(np.memmap slab files + JSON manifest; parks "
                         "and checkpoints write through, and a restart "
                         "over the same dir recovers parked sessions)")
    ap.add_argument("--snapshot-host-bytes", type=int, default=0,
                    help="--stream: host-RAM budget of the snapshot "
                         "LRU pool in bytes (0 = unlimited); over "
                         "budget, cold snapshots spill to "
                         "--snapshot-dir or are dropped with a counter")
    ap.add_argument("--inject-faults", action="store_true",
                    help="--stream: attach a seeded FaultInjector and "
                         "report the liveness verdict")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="--inject-faults: injector RNG seed")
    ap.add_argument("--corrupt-prob", type=float, default=0.25,
                    help="--inject-faults: per-step probability of "
                         "NaN-poisoning one decoding lane's KV cache")
    ap.add_argument("--delay-prob", type=float, default=0.0,
                    help="--inject-faults: per-step probability of a "
                         "host-side dispatch delay")
    ap.add_argument("--delay-sec", type=float, default=0.05,
                    help="--inject-faults: length of an injected delay")
    ap.add_argument("--burst-prob", type=float, default=0.1,
                    help="--inject-faults: per-step probability of "
                         "burst-submitting hostile traffic")
    ap.add_argument("--snap-corrupt-prob", type=float, default=0.0,
                    help="--inject-faults: per-step probability of "
                         "flipping one bit in a stored snapshot slab")
    ap.add_argument("--io-error-prob", type=float, default=0.0,
                    help="--inject-faults: per-step probability of "
                         "arming a snapshot-store disk fault (write "
                         "failure or silent truncation)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = T.init_params(cfg, seed=args.seed, device=args.device)
    T.init_gate_params(model, cfg, seed=args.seed + 1)
    if args.stream:
        _run_stream(cfg, model, args)
        return
    tokens, _, _ = make_batch("copy", args.seed, args.batch,
                              args.prompt_len, cfg.vocab_size)
    eng = build_engine(cfg, model, device=args.device, budget=args.budget,
                       policy=args.policy, prefill_chunk=args.prefill_chunk,
                       fused=not args.eager, temperature=args.temperature)
    out = eng.generate(tokens, args.max_new, chunked=args.chunked,
                       greedy=args.temperature == 0.0, seed=args.seed)
    print(f"device={eng.device} policy={args.policy} budget={args.budget} "
          f"prefill {out['prefill_tok_per_sec']:.1f} tok/s, "
          f"decode {out['tok_per_sec']:.1f} tok/s "
          f"({out['decode_sec']:.2f}s for {args.max_new} steps)")
    print("first row ids:", out["ids"][0][:16])


if __name__ == "__main__":
    main()
