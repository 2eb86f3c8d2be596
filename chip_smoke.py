#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds every kernel from src/repro_torch/kernels/csrc with nvcc — the
decode kernel, the bf16 tensor-core retention and chunk kernels
(wgmma + TMA, head dim 64 and 128), the float32 CUDA-core retention
and chunk kernels and the capacity-loss kernels (a forward with its sum
pass, a backward) — then:

1. kernels — each CUDA kernel against its plain PyTorch version on the
   card at the main-path shapes (Hq 32, Hkv 8, D 128, B 4, M 512,
   C 512, T 2000) over its options: bfloat16 cases through the decode
   and tensor-core kernels, held row by row (ROW_TOL), float32 cases
   through the decode and CUDA-core kernels, element by element (TOL);
   both chunk kernels take their tiles' edges (M 500, n_valid 1 / 64 /
   65, one live cache slot), the float32 one also G 1 (Hkv 32) and
   G 8 (Hkv 4), the bf16 one M 2048 (the FullKV budget); both dtypes
   take the decode kernel's M 2048 and split edges (whole 64-slot
   splits empty, a lane with every slot empty with and without new_kv,
   a window that leaves whole splits invisible, M 500 / 64 / 100, each
   printed with its split count and grid) and both retention kernels'
   tile edges (Tq 1, Tk 129, window 96, a ragged q tile at Tq 1999);
   prints each case's errors beside their limits and
   times the kernel (printing achieved TFLOP/s beside the bound), the
   plain version and one PyTorch library call computing the same
   function (scaled_dot_product_attention, a yardstick the port never
   calls), and on lines of their own the variants the policy phase runs:
   the decode kernel with probs and p_new out and at M 2048, both chunk
   kernels with the cache probabilities out, the bf16 one at M 2048,
   each beside its bound (the probabilities' bytes added);
1a. cross kernels — the kernels at the cross families' shapes, each
   against its plain version and timed beside its bound and one SDPA
   call (cross_kernel_phase): the bf16 tensor-core retention and chunk
   kernels at head dim 64 with G 1 (seamless-m4t-large-v2: Hq 16 = Hkv
   16, B 4, T / C 512 and 1024, M 512) over their tile edges (Tq 1, Tk
   129, a ragged q tile, window 96, n_valid 1 / 64 / 65, probs out, an
   empty cache, M 500) and at head dim 128 with G 8
   (llama-3.2-vision-90b: Hq 64, Hkv 8); the decode kernel over memory
   slabs (no in-flight token, the per-lane mem_len in place of pos,
   held against the plain version at pos = memory_pos) at S 4096, G 1,
   D 64 and S 1601, G 8, D 128 with ragged mem_len including 0 (that lane
   reads exactly 0), bf16 and float32;
1b. MoE kernels — retention, chunk and decode at granite-moe-3b-a800m's
   shape (D 64, GQA group 3: Hq 24, Hkv 8; the float32 chunk kernel's
   CTA packs 42 positions, 126 rows), bf16 row by row and float32,
   against their plain versions (moe_kernel_phase); and at
   mixtral-8x7b's main-path shape (D 128, G 4, M 4096, window 4096,
   which binds: retention over T 4500, chunks of C 1024 at t0 4096 and
   8192, decode at clocks 4515 and 7000; mixtral_kernel_cases);
2. serve — trimkv-paper-4b at full width (36 layers, bfloat16, random
   weights from a seed, perturbed gate biases) through Engine.generate,
   batch 4, prompt 2000, budget 512, 32 new tokens, single-shot and
   chunked (chunks of 512, the last one padded), each fused (the step
   programs as CUDA graphs, serve/graphs.py) and eager (fused=False);
   asserts the exact kernel launch counts of each (the tensor-core
   kernels for prefill), finite logits, and graphs against eager:
   identical ids and slot positions in every layer, logits within
   GRAPH_LOGIT_TOL, and the policy's aux (aux_violations); prints
   prefill and decode tokens/s and the graph pool's size;
2a. policy — the same model and prompt under every eviction policy
   (trimkv, streaming_llm, h2o, snapkv, rkv, keydiff at budget 512;
   full at 2048, which covers 2000 + 32), single-shot and chunked, each
   fused and eager: exact launch counts (h2o, snapkv and rkv run the
   decode and chunk kernels with their probabilities out, inside the
   graphs), graphs against eager (ids and slot positions identical,
   logits and every layer's aux within GRAPH_LOGIT_TOL), the aux
   rules; then a warm chunked fused call per policy: prints prefill and
   decode tokens/s, the graph pool and the paper's Table 6 rows (decode
   tokens/s at the budget beside FullKV's, with the card's name and
   power limit);
2b. stream — continuous batching (serve/scheduler.py) of the same model
   on 4 lanes, budget 512, chunks of 512, segments of 16: 12 Poisson
   requests (seed 0, prompts 256-2000, max_new 16-64, 8 requests/s),
   phased, interleaved (prefill_budget 1024) and static; asserts every
   request DONE, dispatch_count equal to the scheduler's formula, the
   kernel launches its steps imply, finite logits (the lanes' health
   flags), and each request's ids equal to its one-shot
   Engine.generate up to the one-shot's first near tie (MARGIN_TOL);
   prints output tokens/s, TTFT p50 / p99, TPOT p50, segments,
   dispatches, graph replays and the host's enqueue time per segment;
   then, per mode, graphs against eager: the trace drained at once
   through the fused engine and a fused=False engine on the same model
   (the same step programs, captured and not), with identical ids,
   identical slot positions in every layer after every scheduler step
   and logits within GRAPH_LOGIT_TOL; then all of it in float32 at 2
   layers on 6 requests, where a sound run shows no divergence from
   the one-shot runs at all, under trimkv, h2o and rkv;
2c. reuse — the prefix KV cache (serve/prefix_cache.py) and
   speculative decoding on the scheduler: in bf16 at full width (the
   stream phase's model, 4 lanes, budget 512, chunks of 512, segments
   of 16) a shared-prefix trace (poisson_requests seed 0, 12 requests,
   2 pools of 1536 tokens drawn Zipf(1.1) before user turns of 64-464
   tokens, max_new 16-64, 8 requests/s), phased and interleaved, with
   the cache off and on (a cold 1 GiB trie, prefix_min_tokens 512):
   every request DONE, dispatch_count equal to the formula with its
   prefix terms, the launches the steps imply, a hit in each mode and
   ids identical on and off; prints hits, misses, reused tokens,
   installs, extracts, ms per install and per capture, TTFT and output
   tokens/s on and off; then spec_k 2 on the stream phase's own trace,
   phased and interleaved: ids identical to the stream phase's spec_k 0
   ids, the launches a verify round implies (layers x (spec_k + 1)
   decode launches), acceptance, output tokens/s and TPOT beside
   spec_k 0's, and the device ms of a replayed verify round beside a
   plain segment step's; then in float32 at 2 layers under trimkv and
   h2o, phased and interleaved, the cache off, cold and warm, spec_k 2,
   and both: every request's ids equal to its one-shot run's, warm to
   cold and spec + prefix to neither (check_reuse: every count 0);
2d. lifecycle — the lane lifecycle of trimkv-paper-4b at full width
   (36 layers, budget 512, chunks of 512, segments of 16, 4 lanes),
   sampled at temperature 0.8 on threefry key chains (core.prng):
   split keys and bits identical on the card and the CPU, gumbel floats
   within 1e-6 of max(1, |value|); in float32 and in bf16 a 12-request
   trace (seed 1, prompts 64-2000, max_new 17-48), phased and interleaved, each
   request's ids against its one-shot sampled Engine.generate up to the
   first near tie of the perturbed scores (SAMPLED_MARGIN_TOL; in
   float32 no divergence at all), exact launch counts, and the sampled
   decode program against its eager loop (identical ids and key); in
   float32 swap preemption (a priority stream whose arrivals preempt
   decoding lanes: swaps and resumes, one-shot ids, extract then resume
   bit-exact on every leaf), park / drop the scheduler / recover from
   the snapshot directory / revive (one-shot ids), and quarantine under
   a seeded FaultInjector with checkpoints every 2 segments (every
   request terminal, each quarantine answering an injected poison, DONE
   requests with their one-shot ids, one flipped bit in a stored slab
   caught and replayed); in bf16 the times: snapshot bytes per lane,
   swap-out (device-to-host, crc32, store.put), resume (get + verify,
   host-to-device + install), a disk write and read, the chunked
   prefill of 2000 tokens a swap saves, and a replayed sampled decode
   step against a greedy one;
2e. qwen2.5-14b — full width (GQA group 5, qkv biases drawn non-zero)
   cut to 4 layers, bf16: Engine.generate at batch 4, prompt 1024, 32
   new tokens, single-shot and chunked, fused and eager (exact launches,
   graphs against eager);
2f. cross — the cross-memory families (cross_phase), with seeded
   weights, gate biases ~ U(2, 8) and every cross layer's xgate ~
   U(0.5, 1.5) (0 at init, where the memory changes nothing):
   seamless-m4t-large-v2 at full width and depth (24 + 24 layers) and
   llama-3.2-vision-90b at full width cut to 10 layers (2 cross;
   VISION_LAYERS), bf16, through Engine.generate at batch 4, prompt
   1024, budget 512, 32 new tokens with ragged memories (2048-4096
   frames, 801-1601 image tokens), single-shot and chunked (512), fused
   and eager: exact launches (a decode step launches the decode kernel
   once per layer and once per cross layer over its memory: 48 for
   seamless), graphs against eager; teacher-forced logits under two
   memories differ by more than MEMORY_GAP_MIN of their scale; where a
   chunked admission's device time goes (the encoder or projection, the
   plain prefill cross-attention, the chunk kernels); then streams (4
   lanes, 8 poisson_requests, seed 0, prompts 256-1024, max_new 16-48,
   8 requests/s, each with its own ragged memory; seamless phased and
   interleaved, vision phased): every request DONE, dispatch_count on
   the formula, the launches the steps imply, ids against one-shot runs
   up to CROSS_MARGIN_STEPS, output tok/s, TTFT, TPOT, the lane row
   bytes, and
   one seamless lane's swap-out and resume ms; then float32 at 2 layers
   (one cross) for both families: card (kernels) against CPU (plain)
   teacher-forced logits within 1e-3 and identical slot positions under
   trimkv and h2o; the lane scheduler with swap preemption (one-shot
   ids, spec_k 2 = spec_k 0, reset lanes hold mem_len 0 and read zero
   memory, extract -> resume bit-exact on every leaf, a scrubbed slab
   all zero, its neighbour bit-identical), check_cross counts 0;
2g. moe — the MoE family (moe_phase): blocks.moe_apply against
   moe_reference (the JAX package's _moe_apply op by op: per-column
   int32 cumsums, one-hot [g, E, cap] dispatch and combine) in float32
   on one full-width layer of each config (decode of 4 lanes, chunks at
   factor 1.25 and 0.5, two groups): out within TOL, keep masks equal;
   granite-moe-3b-a800m at full width and depth (32 layers, 40
   experts top 8) and mixtral-8x7b at full width cut to MIXTRAL_LAYERS
   (8 experts top 2, window 4096; a prompt of 4500 at budget 4096, so
   the window masks kept slots in decode, counted and > 0), bf16,
   seeded weights, gate biases ~ U(2, 8): generate_pairs (exact
   launches, graphs against eager), 4-lane streams (granite phased and
   interleaved, mixtral phased: every request DONE, dispatches on the
   formula, launches the steps imply, dropped choices by layer), the
   granite stream at capacity factor E / k (no drop) against one-shot
   runs up to CROSS_MARGIN_STEPS; float32 card (kernels) against CPU
   (plain) through the scheduler (granite 2 layers, mixtral 1; 3
   lanes, a better-ranked arrival after the first step, phased and
   interleaved): ids and slot positions equal after every step, logits
   within TOL, every layer's dropped choices equal and > 0;
3. parity — the same config cut to 2 layers, one set of weights on the
   card (kernels) and on the CPU (plain versions), after single-shot
   and after chunked prefill, with exact launch counts: in float32
   (the CUDA-core kernels), teacher-forced logits within 1e-3 and
   identical slot positions in every layer; in bfloat16 (the
   tensor-core kernels), logits within BF16_LOGIT_TOL of their largest
   magnitude, beside the same gap with the card on the plain versions
   (the rounding floor), with the slots that differ counted; float32
   runs under every policy of the policy phase, with identical greedy
   ids, identical slot positions and every layer's aux within 1e-3;
4. capacity — the capacity-loss forward and backward kernels against
   their plain versions (core.losses.capacity_loss_chunked,
   capacity_loss_bwd_torch) at B 1, H 8, T 4096, M 256, at T 1000, at
   the beta = 1.0 tie (S_t = t + 1 meets M), at B 2, at T 129 and at
   H 1: value within rel 1e-5, S within rel 1e-5, gradient within rel
   1e-4 of its largest entry (CAP_TOL), and S, the loss and the
   gradient bit-identical on a second launch; times the forward (its
   kernel and sum pass) and backward kernels in a CUDA graph (and, on
   an earlier line, an event loop over the wrappers), the plain
   forward + backward, and prints the bound: the least float32 work
   (one multiply-add per (t, i) pair forward, two per pair over budget
   backward) at 67 TFLOP/s, beside each kernel's achieved GFLOP/s;
5. train — gate distillation of trimkv-paper-4b at full width (36
   layers, bf16, random weights from a seed, fresh gates at bias 18)
   for 3 train_step calls on batch 1 x 4096 tokens, M 256: asserts
   the exact capacity-kernel launch counts (per step 72 forward —
   36 in the student forward and 36 again when backward recomputes
   each checkpointed block — and 36 backward), finite loss, kl, ntp,
   cap and grad norm, cap > 0, gates changed and base weights
   bit-identical (against a copy on the host); prints seconds per
   step, tokens/s, peak device memory and the capacity kernels' share
   of a step;
6. train parity — the full-width config cut to 2 layers in float32,
   one set of weights on the card (kernels) and on the CPU (plain
   versions), T 256, M 64, perturbed gate biases: loss within rel
   1e-4 and gate gradients within rel 1e-3 of their largest entry;
   adamw_update on the CPU's gradients gives the same gates on both
   within atol 1e-6; one train_step on each gives the same loss
   within rel 1e-4 and moves the gates;
7. moe train — gate distillation of granite-moe-3b-a800m at full width
   cut to MOE_TRAIN_LAYERS (bf16, batch 1 x 2048, M 256), 3 steps:
   exact capacity launches, finite losses, gates moved, every base
   weight (routers and experts included) bit-identical.

Prints the card's name and power limit and a {"kernels": [...]} line
(each kernel's launches are those of the main paths that run it, each
counted from 0 just before its run: the decode and bf16 chunk kernels
over the serve and policy phases' generate calls, the bf16 stream's
phased run, the reuse phase's drains, the lifecycle phase, the
qwen2.5-14b calls, the cross phase's one-shot calls and phased
streams and the MoE phase's one-shot calls and phased streams, the
bf16 retention kernel over the serve, policy, qwen2.5-14b, cross and
MoE one-shot phases, the float32 chunk kernel over the float32 parity
runs, the reuse phase's float32 drains, the lifecycle phase and the
cross and MoE float32 parity runs, the float32 retention kernel over
the float32 parity runs (the cross ones included), the capacity
kernels over the train and MoE train phases) and each phase's seconds,
then, as the last line,
{"ok": true, "device": {...}}. Any failure raises: the script exits
non-zero and prints no result line. It exits non-zero at once when no
CUDA card is visible.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, dense bf16
# tensor-core FLOP/s, float32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
TOL = {"float32": 1e-4}   # abs and rel, see check()
# bf16 attention (the decode and tensor-core kernels) is held row by row
# (check_rows): a row's largest |error| over its largest |value|, for
# out rows of D and probability rows of M; a row that is all zero in
# the plain version (no visible key) must be all zero. Out is bf16 on
# both sides, so a sound row differs by at most about one bf16 ulp of
# its largest entry (2^-8 .. 2^-7 of it); probabilities are float32 on
# both sides and differ only by the order of the score sums. On the
# H100 the largest sound readings were 7.8e-3 (out) and 2.3e-6
# (probabilities), the smallest of eight planted faults' 0.15 and 0.33
# (launch/planted_faults.py; PERF.md): the limits are about 2x and 9x
# the sound readings.
ROW_TOL = {"out": 1.6e-2, "probs": 2e-5}


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, iters, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_graph_ms(fn, iters):
    """Device time per call of fn(i), i = 0 .. iters - 1, captured in
    one CUDA graph and timed over a replay: the host's cost per call
    (the wrapper's checks and allocations, the launch) is left out,
    where time_ms includes it whenever the host is the slower side."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check(name, got, want, dtype):
    """Max abs error of got vs want; fails beyond atol = rtol = TOL."""
    import torch
    tol = TOL[dtype]
    errs = []
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name}: non-finite kernel output")
        err = (g - w).abs()
        if (err > tol + tol * w.abs()).any():
            raise AssertionError(f"{name}: max abs err {err.max().item():.3e}"
                                 f" beyond atol=rtol={tol}")
        errs.append(err.max().item())
    e = max(errs)
    log(f"  {name:<48} max_abs_err {e:.3e}  tol {tol:g}")
    return e


def row_errors(got, want):
    """(max abs error, max row-relative error) of got vs want: per row
    (the last dim), max |got - want| over max |want|; inf for a row
    that is all zero in want and not in got, or a non-finite got."""
    import torch
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        return math.inf, math.inf
    err = (g - w).abs()
    row_err, scale = err.amax(-1), w.abs().amax(-1)
    rel = torch.where(scale > 0, row_err / scale.clamp(min=1e-30),
                      torch.where(row_err > 0, torch.full_like(row_err,
                                                               math.inf),
                                  torch.zeros_like(row_err)))
    return err.max().item(), rel.max().item()


def check_rows(name, got, want, kinds=("out", "probs")):
    """bf16 attention: got's tensors (out, then probabilities) against
    want's, row by row within ROW_TOL; returns the max abs error."""
    abs_errs, rels = [], []
    for g, w, kind in zip(got, want, kinds):
        a, r = row_errors(g, w)
        if not r <= ROW_TOL[kind]:
            raise AssertionError(f"{name}: {kind} row-relative err {r:.3e}"
                                 f" beyond {ROW_TOL[kind]}")
        abs_errs.append(a)
        rels.append(f"{kind} {r:.2e} (tol {ROW_TOL[kind]:g})")
    log(f"  {name:<48} max_abs_err {max(abs_errs):.3e}  row-rel err "
        + ", ".join(rels))
    return max(abs_errs)


def check_case(name, got, want, dtype):
    """A kernel case: bf16 row by row, float32 element by element."""
    if dtype == "bfloat16":
        return check_rows(name, got, want)
    return check(name, got, want, dtype)


def bound_ms(n_bytes, n_flops, flops_per_s=BF16_FLOPS):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / flops_per_s
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


# ------------------------------------------------------------ kernels


def rnd(g, shape, dtype):
    import torch
    return torch.randn(shape, generator=g, device="cuda").to(dtype)


def decode_pos(g, kind, M, t, empty):
    """Slot positions [B, Hkv, M] below each lane's clock t [B], a
    share `empty` of them -1, shaped by kind: None; "split holes"
    (splits 1, 2 and 5 of 64 slots all empty); "empty lane" (lane 2 all
    empty); "old splits" (slot j holds t - 1 - j, shuffled within its
    64-slot split, so a window of 128 leaves splits 2.. invisible)."""
    import torch
    B, Hkv = t.shape[0], 8
    if kind == "old splits":
        j = torch.arange(M, device="cuda")
        key = (j // 64) * 2.0 + torch.rand((B, Hkv, M), generator=g,
                                            device="cuda")
        order = key.argsort(-1)                  # a shuffle within splits
        pos = (t[:, None, None] - 1 - order).to(torch.int32)
    else:
        pos = torch.randint(0, 1800, (B, Hkv, M), generator=g, device="cuda",
                            dtype=torch.int32)
    drop = torch.rand((B, Hkv, M), generator=g, device="cuda") < empty
    if kind == "split holes":
        for s in (1, 2, 5):
            drop[..., 64 * s:64 * (s + 1)] = True
    if kind == "empty lane":
        drop[2] = True
    return torch.where(drop, torch.full_like(pos, -1), pos).contiguous()


def decode_phase(g):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                      decode_attention_torch,
                                                      split_plan)
    B, Hq, Hkv, D = 4, 32, 8, 128
    G = Hq // Hkv
    cases = [  # name, M, window, new_kv, return_probs, per-lane t, empty,
        #        pos kind
        ("main path (new_kv, [B] t)", 512, 0, True, False, True, 0.0, None),
        ("probs + p_new", 512, 0, True, True, True, 0.2, None),
        ("window 128 + probs", 512, 128, True, True, True, 0.2, None),
        ("no new_kv, scalar t, probs", 512, 0, False, True, False, 0.2, None),
        ("M 500 (ragged last split)", 500, 0, True, True, True, 0.2, None),
        # the split kernel's edges
        ("splits 1, 2, 5 empty + probs", 512, 0, True, True, True, 0.2,
         "split holes"),
        ("lane 2 empty, new_kv + probs", 512, 0, True, True, True, 0.0,
         "empty lane"),
        ("lane 2 empty, no new_kv + probs", 512, 0, False, True, True, 0.0,
         "empty lane"),
        ("window 128, splits 2-7 outside + probs", 512, 128, True, True,
         True, 0.1, "old splits"),
        ("window 128, splits 2-7 outside, no new_kv", 512, 128, False, True,
         True, 0.0, "old splits"),
        ("M 64 (one split) + probs", 64, 0, True, True, True, 0.2, None),
        ("M 100 (two splits, ragged) + probs", 100, 0, True, True, True, 0.2,
         None),
        # the FullKV budget of the policy phase
        ("M 2048 (FullKV)", 2048, 0, True, False, True, 0.0, None),
        ("M 2048 + probs", 2048, 0, True, True, True, 0.2, None),
    ]
    main_err = None
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        for name, M, window, with_new, probs, lane, empty, kind in cases:
            t = torch.tensor([2000, 1900, 1800, 2047], dtype=torch.int32,
                             device="cuda")
            q = rnd(g, (B, Hq, D), dtype)
            kc = rnd(g, (B, Hkv, M, D), dtype)
            vc = rnd(g, (B, Hkv, M, D), dtype)
            pos = decode_pos(g, kind, M, t if lane else torch.full_like(
                t, 2047), empty)
            new = (rnd(g, (B, Hkv, D), dtype), rnd(g, (B, Hkv, D), dtype)) \
                if with_new else None
            tt = t if lane else 2047
            kw = dict(window=window, new_kv=new, return_probs=probs)
            got = decode_attention_cuda(q, kc, vc, pos, tt, **kw)
            want = decode_attention_torch(q, kc, vc, pos, tt, **kw)
            got = got if probs else (got,)
            want = want if probs else (want,)
            # probs over the cache and p_new: one row of M + 1
            got, want = [x if len(x) < 3 else
                         (x[0], torch.cat([x[1], x[2][..., None]], -1))
                         for x in (got, want)]
            n_split, split_len = split_plan(M, B * Hkv)
            err = check_case(f"decode {dn} {name} [{n_split} splits of "
                             f"{split_len}, grid {B * Hkv * n_split}]",
                             got, want, dn)
            if dtype == torch.bfloat16 and name.startswith("main"):
                main_err = err

    # timing at the main-path shape: full cache, in-flight token, no
    # probs, bf16; 8 input sets in rotation (67 MB > the 50 MB L2), as
    # each layer's decode finds its cache cold. The kernel and the
    # library call are timed in a CUDA graph: an event loop over the
    # wrapper measures the host's ~35 us per call, not the card
    M, dtype = 512, torch.bfloat16
    sets = []
    for _ in range(8):
        pos = torch.randint(0, 1800, (B, Hkv, M), generator=g, device="cuda",
                            dtype=torch.int32)
        sets.append((rnd(g, (B, Hq, D), dtype), rnd(g, (B, Hkv, M, D), dtype),
                     rnd(g, (B, Hkv, M, D), dtype), pos,
                     (rnd(g, (B, Hkv, D), dtype), rnd(g, (B, Hkv, D), dtype))))
    t = torch.full((B,), 2000, dtype=torch.int32, device="cuda")
    n_split, _ = split_plan(M, B * Hkv)
    log(f"  decode main path: one launch of {B * Hkv * n_split} CTAs, "
        f"{B * Hkv} clusters of {n_split}")
    kern = lambda i=0: decode_attention_cuda(  # noqa: E731
        *sets[i % 8][:4], t, new_kv=sets[i % 8][4])
    ms = time_graph_ms(kern, 200)
    loop_ms = time_ms(kern, 200)
    plain = time_ms(lambda i=0: decode_attention_torch(
        *sets[i % 8][:4], t, new_kv=sets[i % 8][4]), 50)
    # yardstick: SDPA over the cache with the in-flight token appended
    # and a key mask; the concatenation and GQA repeat are made before
    # timing
    lib_in = []
    for q, kc, vc, pos, (kn, vn) in sets:
        k = torch.cat([kc, kn[:, :, None]], 2).repeat_interleave(G, 1)
        v = torch.cat([vc, vn[:, :, None]], 2).repeat_interleave(G, 1)
        ok = torch.cat([pos >= 0, torch.ones((B, Hkv, 1), dtype=torch.bool,
                                             device="cuda")], 2)
        lib_in.append((q[:, :, None], k, v,
                       ok.repeat_interleave(G, 1)[:, :, None]))
    lib_fn = lambda i=0: F.scaled_dot_product_attention(  # noqa: E731
        *lib_in[i % 8][:3], attn_mask=lib_in[i % 8][3])
    lib = time_graph_ms(lib_fn, 200)
    lib_loop = time_ms(lib_fn, 200)
    n_bytes, n_flops = decode_work(B, Hq, Hkv, M, D)
    b_ms, b_by = bound_ms(n_bytes, n_flops)
    log(f"  decode_attention timing (CUDA graph): {ms:.4f} ms; bound "
        f"{b_ms:.5f} ms ({b_by}); library {lib:.4f} ms; event loop over "
        f"the calls (host-bound): kernel {loop_ms:.4f} ms, library "
        f"{lib_loop:.4f} ms")
    # the variants the policy phase serves: probs and p_new out (H2O,
    # SnapKV, R-KV) at M 512, and the FullKV budget M 2048 without them
    probs_ms = time_graph_ms(lambda i=0: decode_attention_cuda(
        *sets[i % 8][:4], t, new_kv=sets[i % 8][4], return_probs=True), 200)
    pb_ms, pb_by = bound_ms(*decode_work(B, Hq, Hkv, M, D, probs=True))
    log(f"  decode_attention + probs, p_new (M {M}) timing (CUDA graph): "
        f"{probs_ms:.4f} ms; bound {pb_ms:.5f} ms ({pb_by}; the probs add "
        f"{B * Hq * (M + 1) * 4 / 1e3:.1f} KB)")
    del sets, lib_in
    M2 = 2048
    sets2 = [(rnd(g, (B, Hq, D), dtype), rnd(g, (B, Hkv, M2, D), dtype),
              rnd(g, (B, Hkv, M2, D), dtype),
              torch.randint(0, 1800, (B, Hkv, M2), generator=g,
                            device="cuda", dtype=torch.int32),
              (rnd(g, (B, Hkv, D), dtype), rnd(g, (B, Hkv, D), dtype)))
             for _ in range(8)]
    m2_ms = time_graph_ms(lambda i=0: decode_attention_cuda(
        *sets2[i % 8][:4], t, new_kv=sets2[i % 8][4]), 200)
    m2_plain = time_ms(lambda i=0: decode_attention_torch(
        *sets2[i % 8][:4], t, new_kv=sets2[i % 8][4]), 20)
    m2_b, m2_by = bound_ms(*decode_work(B, Hq, Hkv, M2, D))
    log(f"  decode_attention M {M2} (FullKV) timing (CUDA graph): "
        f"{m2_ms:.4f} ms; bound {m2_b:.5f} ms ({m2_by}); plain "
        f"{m2_plain:.4f} ms; {split_plan(M2, B * Hkv)[0]} splits")
    del sets2
    return {"name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:112",
            "max_abs_err": main_err, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}


def decode_work(B, Hq, Hkv, M, D, probs=False, el=2):
    """(bytes, operations) of one decode call: q in and out, the cache's
    K, V and positions, the clocks and the in-flight K, V; with probs
    also the [B, Hq, M] probabilities and [B, Hq] p_new out (float32)."""
    n_bytes = (B * Hq * D * el * 2 + 2 * B * Hkv * M * D * el
               + B * Hkv * M * 4 + B * 4 + 2 * B * Hkv * D * el)
    if probs:
        n_bytes += B * Hq * (M + 1) * 4
    return n_bytes, 4 * B * Hq * D * (M + 1)


def achieved(name, ms, n_flops, b_ms, b_by, lib):
    log(f"  {name} timing: {ms:.4f} ms = {n_flops / ms / 1e9:.1f} TFLOP/s "
        f"({n_flops / 1e9:.2f} GFLOP); bound {b_ms:.4f} ms ({b_by}); "
        f"library {lib:.4f} ms")


def chunk_phase(g):
    """The tensor-core kernel (bf16) and the CUDA-core kernel (float32)
    against the plain version; returns an entry for each."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.chunk_attention import (chunk_attention_cuda,
                                                     chunk_attention_torch)
    B, C, Hq, Hkv, M, D = 4, 512, 32, 8, 512, 128
    G = Hq // Hkv
    idx = torch.arange(C, device="cuda", dtype=torch.int32)

    def inputs(dtype, t0, n_valid, empty, first, M=M, keep_one=False,
               Hkv=Hkv):
        q = rnd(g, (B, C, Hq, D), dtype)
        kc, vc = rnd(g, (B, C, Hkv, D), dtype), rnd(g, (B, C, Hkv, D), dtype)
        ck, cv = rnd(g, (B, Hkv, M, D), dtype), rnd(g, (B, Hkv, M, D), dtype)
        cpos = torch.randint(0, max(t0, 1), (B, Hkv, M), generator=g,
                             device="cuda", dtype=torch.int32)
        drop = torch.rand((B, Hkv, M), generator=g, device="cuda") < empty
        if first or keep_one:
            drop[:] = True
        if keep_one:                   # one live slot per (lane, kv head)
            drop[..., 300] = False
        cpos = torch.where(drop, torch.full_like(cpos, -1), cpos)
        nv = torch.tensor(n_valid, dtype=torch.int32, device="cuda")
        chunk_pos = torch.where(idx[None] < nv[:, None], t0 + idx[None],
                                torch.full_like(idx[None], -1))
        return q, kc, vc, ck, cv, cpos, chunk_pos.contiguous()

    full = [C] * B
    cases = [  # name, t0, n_valid, window, need_probs, empty, first, extra
        ("main path (full cache)", 1024, full, 0, False, 0.0, False, {}),
        ("ragged [B,C] tail + probs", 1024, [512, 464, 300, 17], 0, True,
         0.2, False, {}),
        ("window 256 + probs", 1024, full, 256, True, 0.2, False, {}),
        ("first chunk (empty cache)", 0, [512, 464, 512, 100], 0, True, 0.0,
         True, {}),
    ]
    edges = [  # both kernels' tile edges
        ("M 500 (ragged tile) + probs", 1024, full, 0, True, 0.2, False,
         {"M": 500}),
        ("n_valid [1, 64, 65, 512] + probs", 1024, [1, 64, 65, 512], 0,
         True, 0.2, False, {}),
        ("one live cache slot + probs", 1024, [512, 300, 512, 65], 0, True,
         0.0, False, {"keep_one": True}),
    ]
    fullkv = [  # the bf16 kernel at the policy phase's FullKV budget
        ("M 2048 (FullKV)", 2560, full, 0, False, 0.0, False, {"M": 2048}),
        ("M 2048 + probs", 2560, [512, 464, 300, 17], 0, True, 0.2, False,
         {"M": 2048}),
    ]
    groups = [  # the float32 kernel's GQA packing: G 1 and G 8
        ("G 1 (Hkv 32) + probs", 1024, [512, 464, 300, 17], 0, True, 0.2,
         False, {"Hkv": 32}),
        ("G 8 (Hkv 4), window 256 + probs", 1024, [512, 464, 300, 17], 256,
         True, 0.2, False, {"Hkv": 4}),
    ]
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        for name, t0, nv, window, probs, empty, first, extra in (
                cases + edges + fullkv if dtype == torch.bfloat16
                else cases + edges + groups):
            args = inputs(dtype, t0, nv, empty, first, **extra)
            kw = dict(window=window, need_probs=probs)
            got = chunk_attention_cuda(*args, **kw)
            want = chunk_attention_torch(*args, **kw)
            n = 2 if probs else 1
            err = check_case(f"chunk {dn} {name}", got[:n], want[:n], dn)
            if name.startswith("main"):
                errs[dtype] = err
            del args, got, want

    out = []
    for dtype, name, src, fps in (
            (torch.bfloat16, "chunk_attention", "chunk_attention_tc.cu",
             BF16_FLOPS),
            (torch.float32, "chunk_attention_f32", "chunk_attention.cu",
             FP32_FLOPS)):
        args = inputs(dtype, 1024, full, 0.0, False)
        ms = time_ms(lambda i=0: chunk_attention_cuda(*args, need_probs=False),
                     50 if dtype == torch.bfloat16 else 20)
        plain = time_ms(lambda i=0: chunk_attention_torch(
            *args, need_probs=False), 5)
        q, kc, vc, ck, cv, cpos, chunk_pos = args
        keys = torch.cat([ck, kc.transpose(1, 2)], 2).repeat_interleave(G, 1)
        vals = torch.cat([cv, vc.transpose(1, 2)], 2).repeat_interleave(G, 1)
        kpos = torch.cat([cpos, chunk_pos[:, None].expand(B, Hkv, C)], 2)
        dist = chunk_pos[:, None, :, None] - kpos[:, :, None, :]
        vis = (kpos[:, :, None, :] >= 0) & (dist >= 0)     # [B,Hkv,C,M+C]
        qh = q.transpose(1, 2).contiguous()
        mask = vis.repeat_interleave(G, 1)
        lib = time_ms(lambda i=0: F.scaled_dot_product_attention(
            qh, keys, vals, attn_mask=mask), 20)
        el = q.element_size()
        n_bytes = (2 * B * C * Hq * D * el + 2 * B * C * Hkv * D * el
                   + 2 * B * Hkv * M * D * el + B * Hkv * M * 4 + B * C * 4)
        n_flops = 4 * D * G * int(vis.sum().item())
        b_ms, b_by = bound_ms(n_bytes, n_flops, fps)
        achieved(name, ms, n_flops, b_ms, b_by, lib)
        # the policy phase's variant: the cache probabilities out (the
        # kernel's [B, Hq, C, M] float32, then the wrapper's GQA mean)
        probs_ms = time_ms(lambda i=0: chunk_attention_cuda(
            *args, need_probs=True), 20 if dtype == torch.bfloat16 else 10)
        pb_ms, pb_by = bound_ms(n_bytes + B * Hq * C * M * 4, n_flops, fps)
        log(f"  {name} + probs timing: {probs_ms:.4f} ms (the kernel and "
            f"the GQA mean); bound {pb_ms:.4f} ms ({pb_by}; the probs add "
            f"{B * Hq * C * M * 4 / 1e6:.1f} MB)")
        if dtype == torch.bfloat16:
            m2 = inputs(dtype, 2560, full, 0.0, False, M=2048)
            m2_ms = time_ms(lambda i=0: chunk_attention_cuda(
                *m2, need_probs=False), 20)
            m2_plain = time_ms(lambda i=0: chunk_attention_torch(
                *m2, need_probs=False), 3)
            m2_bytes = n_bytes + (2 * B * Hkv * 1536 * D * el
                                  + B * Hkv * 1536 * 4)
            m2_flops = 4 * D * G * B * Hkv * C * (2048 + (C + 1) / 2)
            m2_b, m2_by = bound_ms(m2_bytes, m2_flops, fps)
            log(f"  {name} M 2048 (FullKV) timing: {m2_ms:.4f} ms = "
                f"{m2_flops / m2_ms / 1e9:.1f} TFLOP/s; bound {m2_b:.4f} ms "
                f"({m2_by}); plain {m2_plain:.4f} ms")
            del m2
        out.append({"name": name, "route": "cuda",
                    "source": f"src/repro_torch/kernels/csrc/{src}",
                    "replaces": "src/repro/kernels/chunk_attention.py:117",
                    "max_abs_err": errs[dtype], "ms": ms, "plain_ms": plain,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib})
        del args, keys, vals, mask, qh
        torch.cuda.empty_cache()
    return out


def retention_phase(g):
    """The tensor-core kernel (bf16) and the CUDA-core kernel (float32)
    against the plain version; returns an entry for each."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.retention_attention import (
        retention_attention_cuda, retention_attention_torch)
    B, T, Hq, Hkv, D = 4, 2000, 32, 8, 128
    G = Hq // Hkv
    cases = [  # name, Tq, Tk, q_offset, window, log_beta
        ("main path (causal, T 2000)", T, T, 0, 0, False),
        ("log_beta + window 512", T, T, 0, 512, True),
        ("q_offset 1500 (Tq 500)", 500, T, 1500, 0, True),
    ]
    edges = [  # both kernels' tile edges
        ("Tq 1 at q_offset 1999", 1, T, 1999, 0, False),
        ("Tk 129 (one key past a tile)", 129, 129, 0, 0, True),
        ("window 96 (T 2000)", T, T, 0, 96, False),
        ("Tq 1999 at q_offset 1 (ragged q tile)", 1999, T, 1, 0, False),
    ]
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        for name, Tq, Tk, off, window, use_beta in cases + edges:
            q = rnd(g, (B, Tq, Hq, D), dtype)
            k, v = rnd(g, (B, Tk, Hkv, D), dtype), rnd(g, (B, Tk, Hkv, D),
                                                       dtype)
            lb = (-torch.rand((B, Tk, Hkv), generator=g, device="cuda") * 0.01
                  if use_beta else None)
            kw = dict(window=window, q_offset=off)
            got = retention_attention_cuda(q, k, v, lb, **kw)
            want = retention_attention_torch(q, k, v, lb, **kw)
            del q, k, v
            err = check_case(f"retention {dn} {name}", (got,), (want,), dn)
            del got, want
            torch.cuda.empty_cache()
            if name.startswith("main"):
                errs[dtype] = err

    out = []
    for dtype, name, src, fps in (
            (torch.bfloat16, "retention_attention",
             "retention_attention_tc.cu", BF16_FLOPS),
            (torch.float32, "retention_attention_f32",
             "retention_attention.cu", FP32_FLOPS)):
        q = rnd(g, (B, T, Hq, D), dtype)
        k, v = rnd(g, (B, T, Hkv, D), dtype), rnd(g, (B, T, Hkv, D), dtype)
        ms = time_ms(lambda i=0: retention_attention_cuda(q, k, v),
                     20 if dtype == torch.bfloat16 else 10)
        plain = time_ms(lambda i=0: retention_attention_torch(q, k, v), 3)
        qh = q.transpose(1, 2).contiguous()
        kh = k.transpose(1, 2).repeat_interleave(G, 1).contiguous()
        vh = v.transpose(1, 2).repeat_interleave(G, 1).contiguous()
        lib = time_ms(lambda i=0: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True), 10)
        el = q.element_size()
        n_bytes = 2 * B * T * Hq * D * el + 2 * B * T * Hkv * D * el
        n_flops = 4 * B * Hq * D * (T * (T + 1) // 2)
        b_ms, b_by = bound_ms(n_bytes, n_flops, fps)
        achieved(name, ms, n_flops, b_ms, b_by, lib)
        out.append({"name": name, "route": "cuda",
                    "source": f"src/repro_torch/kernels/csrc/{src}",
                    "replaces": "src/repro/kernels/retention_attention.py:79",
                    "max_abs_err": errs[dtype], "ms": ms, "plain_ms": plain,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib})
        del q, k, v, qh, kh, vh
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------ capacity loss


# capacity-loss limits, relative to the largest entry of the plain
# version: the value and S sum ~T float32 terms in another order; the
# gradient's sums are blocked (csrc/capacity_loss.cu). "repeat" is the
# largest |difference| of two backward launches on the same inputs, and
# "forward repeat" that of two forward launches' S and loss: both must
# be bit-identical
CAP_TOL = {"value": 1e-5, "S": 1e-5, "grad": 1e-4, "grad vs autograd": 1e-4,
           "repeat": 0.0, "forward repeat": 0.0}


def check_capacity(name, errs):
    """Raise unless every capacity reading is within CAP_TOL."""
    for k, tol in CAP_TOL.items():
        if not errs[k] <= tol:
            raise AssertionError(f"capacity {name}: {k} err {errs[k]:.3e} "
                                 f"beyond {tol}")


def capacity_phase(g):
    import torch
    from repro_torch.kernels.capacity_loss import (
        bwd_plan, capacity_fwd_launch, capacity_loss_bwd_cuda,
        capacity_loss_bwd_torch, capacity_loss_fwd_cuda, capacity_loss_torch,
        fwd_buffers, fwd_plan, occupancy_torch)

    def log_beta(B, T, H, mode):
        if mode == "tie":                       # beta = 1.0 exactly
            return torch.zeros((B, T, H), device="cuda")
        if mode == "train start":               # gates at bias 18 (+ noise)
            x = 18.0 + torch.randn((B, T, H), generator=g, device="cuda")
        else:                                   # beta spread below 1
            x = 6.0 + 4.0 * torch.randn((B, T, H), generator=g,
                                        device="cuda")
        return -torch.nn.functional.softplus(-x)

    def rel(got, want, scale=None):
        scale = want.abs().max() if scale is None else scale
        return ((got - want).abs().max() / scale.clamp(min=1e-30)).item()

    def repeat(*pairs):
        """0 when every pair is bit-identical, else the largest
        |difference| (inf where that is 0, e.g. a NaN)"""
        if all(torch.equal(a, b) for a, b in pairs):
            return 0.0
        return max((a - b).abs().max().item() for a, b in pairs) or math.inf

    cases = [  # name, B, H, T, M, mode
        ("main path (B 1, H 8, T 4096, M 256)", 1, 8, 4096, 256,
         "train start"),
        ("spread beta, T 1000 (ragged tile)", 1, 8, 1000, 256, "spread"),
        ("beta = 1.0 tie at M 256", 1, 8, 4096, 256, "tie"),
        ("spread beta, B 2, H 8", 2, 8, 4096, 256, "spread"),
        ("spread beta, T 129 (one row past a tile), M 16", 1, 8, 129, 16,
         "spread"),
        ("spread beta, H 1, T 4096 (few columns)", 1, 1, 4096, 256, "spread"),
    ]
    gout = torch.tensor(0.7, device="cuda")
    main_err = None
    for name, B, H, T, M, mode in cases:
        lb = log_beta(B, T, H, mode).contiguous()
        loss, S, rows = capacity_loss_fwd_cuda(lb, M)
        loss2, S2, _ = capacity_loss_fwd_cuda(lb, M)
        dlb = capacity_loss_bwd_cuda(rows, S, M, gout, H)
        again = capacity_loss_bwd_cuda(rows, S, M, gout, H)
        want_S = occupancy_torch(lb)
        x = lb.clone().requires_grad_(True)
        want = capacity_loss_torch(x, M)
        (auto,) = torch.autograd.grad(want * gout, x)
        want_dlb = capacity_loss_bwd_torch(lb, want_S, M, gout)
        torch.cuda.synchronize()
        errs = {"value": rel(loss, want.detach(), want.detach().abs()),
                "S": rel(S, want_S),
                "grad": rel(dlb, want_dlb),
                "grad vs autograd": rel(dlb, auto),
                "repeat": repeat((dlb, again)),
                "forward repeat": repeat((S, S2), (loss, loss2))}
        check_capacity(name, errs)
        if not (torch.isfinite(dlb).all() and float(loss) > 0):
            raise AssertionError(f"capacity {name}: loss {float(loss)}")
        if mode == "tie" and not torch.equal(S[:, M - 1], torch.full_like(
                S[:, M - 1], float(M))):
            raise AssertionError("capacity tie: S_{M-1} != M")
        n_items, n_groups = bwd_plan(T, B * H)
        f_items, f_split, f_rows = fwd_plan(T, B * H)
        log(f"  capacity {name:<46} loss {float(loss):.6e}  rel err value "
            f"{errs['value']:.2e} S {errs['S']:.2e} (tol 1e-5) grad "
            f"{errs['grad']:.2e} / autograd {errs['grad vs autograd']:.2e} "
            f"(tol 1e-4); forward and backward bit-identical on a second "
            f"launch; forward grid {f_items * f_split} x {B * H} CTAs of "
            f"{16 * f_rows} threads; backward grid {n_items} x {B * H} CTAs "
            f"of {n_groups} x 4 warps")
        if name.startswith("main"):
            main_err = (dlb - want_dlb).abs().max().item(), \
                (loss - want).abs().item()
            main = (lb, S, rows)

    # timing at the main-path shape: each train step calls these on one
    # layer's log_beta [1, 4096, 8]. The kernels take tens of us, near
    # the host's cost of a wrapper call, so they are timed in a CUDA
    # graph: the forward kernel and its sum pass (two launches) on the
    # wrapper's buffers (without the wrapper's transpose and partial
    # sum), the backward through its wrapper (one launch, no other
    # kernel)
    lb, S, rows = main
    B, T, H, M = 1, 4096, 8, 256
    bufs = fwd_buffers(B * H, T, "cuda")
    fwd_ms = time_graph_ms(lambda i=0: capacity_fwd_launch(rows, *bufs, M),
                           100)
    bwd_ms = time_graph_ms(lambda i=0: capacity_loss_bwd_cuda(rows, S, M,
                                                              gout, H), 100)
    fwd_loop = time_ms(lambda i=0: capacity_loss_fwd_cuda(lb, M), 100)
    bwd_loop = time_ms(lambda i=0: capacity_loss_bwd_cuda(rows, S, M, gout,
                                                          H), 100)
    plain_fwd = time_ms(lambda i=0: capacity_loss_torch(lb, M), 10)
    plain_bwd = time_ms(lambda i=0: capacity_loss_bwd_torch(lb, S, M, gout),
                        10)

    def plain_fwd_bwd(i=0):
        x = lb.clone().requires_grad_(True)
        torch.autograd.grad(capacity_loss_torch(x, M), x)

    plain_both = time_ms(plain_fwd_bwd, 5)
    # least work, in float32 FLOPs (the tolerance needs float32): an exp
    # per (t, i) pair is not needed, since beta_i^(t0+j-i) = beta_i^j *
    # beta_i^(t0-i) makes a row block's sums a product of the power
    # table beta_i^j (j < k) with one carry per (block, column); that is
    # one multiply-add per pair (2 FLOPs) in the forward, and two in the
    # backward (sum_t w_t (t-i) beta_i^(t-i) splits into the weights
    # against beta_i^j and j beta_i^j), with exps and the table 1/k of
    # that. The backward needs only the pairs of rows over budget
    # (weight != 0) in this run's S.
    fwd_pairs = B * H * T * (T + 1) // 2
    over = (S - M >= 0).float()
    bwd_pairs = int((over * torch.arange(1, T + 1, device="cuda")).sum())
    # bytes: the forward reads lb and writes S, the backward reads lb and
    # S and writes the gradient (float32 each)
    fwd_bound, fwd_by = bound_ms(2 * B * H * T * 4, 2 * fwd_pairs,
                                 FP32_FLOPS)
    bwd_bound, bwd_by = bound_ms(3 * B * H * T * 4, 4 * bwd_pairs,
                                 FP32_FLOPS)
    log(f"  capacity event loop over the wrappers (the host's cost per "
        f"call included): forward {fwd_loop:.4f} ms (with its transpose and "
        f"partial sum), backward {bwd_loop:.4f} ms")
    log(f"  capacity timing (CUDA graph; B 1, H 8, T 4096, M 256): forward "
        f"{fwd_ms:.4f} ms = {2 * fwd_pairs / fwd_ms / 1e6:.1f} GFLOP/s "
        f"(bound {fwd_bound:.4f}, {fwd_pairs / 1e6:.1f} M pairs x 2 FLOPs), "
        f"backward {bwd_ms:.4f} ms = {4 * bwd_pairs / bwd_ms / 1e6:.1f} "
        f"GFLOP/s (bound {bwd_bound:.4f}, {bwd_pairs / 1e6:.1f} M pairs x 4 "
        f"FLOPs) at {FP32_FLOPS:.3g} float32 FLOP/s; plain forward "
        f"{plain_fwd:.3f} ms, backward {plain_bwd:.3f} ms, forward + "
        f"autograd backward {plain_both:.3f} ms")
    src = "src/repro_torch/kernels/csrc/capacity_loss.cu"
    return [
        {"name": "capacity_loss", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/capacity_loss.py:55",
         "max_abs_err": main_err[1], "ms": fwd_ms, "plain_ms": plain_fwd,
         "bound_ms": fwd_bound, "bound_by": fwd_by, "library_ms": None},
        {"name": "capacity_loss_bwd", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/capacity_loss.py:55",
         "max_abs_err": main_err[0], "ms": bwd_ms, "plain_ms": plain_bwd,
         "bound_ms": bwd_bound, "bound_by": bwd_by, "library_ms": None},
    ]


# -------------------------------------------------------------- serve


def perturb_gates(model, seed):
    """Gate biases b ~ U(2, 8) per (layer, kv head): beta spreads below
    1, so eviction is decided by the keep scores, not by ties."""
    import torch
    g = torch.Generator(device=model.device)
    g.manual_seed(seed)
    for block in model.layers:
        b = block.gate.b
        b.copy_(2.0 + 6.0 * torch.rand(b.shape, generator=g,
                                       device=model.device))


# graph (fused) against eager serving on the same inputs, logits as a
# share of their largest magnitude: the same kernels at the same shapes.
# On the H100 sound runs read 0 (bit-identical); a planted fault in the
# chunk program's copy-back reads far above (launch/planted_faults.py;
# PERF.md). The limit only allows for a cuBLAS choice that would differ
# under capture.
GRAPH_LOGIT_TOL = 1e-6


def check_graphs(name, readings):
    """Raise unless graphs and eager agree: ids and slot positions
    identical (readings count what differs), logits and the policies'
    aux within GRAPH_LOGIT_TOL of their largest magnitude."""
    if (readings["ids differ"] or readings["slot positions differ"]
            or not readings["logit gap"] <= GRAPH_LOGIT_TOL
            or not readings["aux gap"] <= GRAPH_LOGIT_TOL):
        raise AssertionError(f"{name}: graphs and eager disagree: "
                             f"{readings}")


def full_width_model():
    """trimkv-paper-4b at full width with the serve phase's seeded
    weights and perturbed gates: (cfg, model)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = get_config("trimkv-paper-4b")
    t0 = time.perf_counter()
    model = T.init_params(cfg, seed=0, device="cuda")
    T.init_gate_params(model, cfg, seed=1)
    perturb_gates(model, seed=2)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"serve: {cfg.name} {cfg.num_layers} layers {cfg.dtype}, "
        f"{n_params / 1e9:.3f} B parameters, init "
        f"{time.perf_counter() - t0:.1f} s")
    return cfg, model


SERVE_SHAPE = dict(B=4, P=2000, N=32, chunk=512)


def aux_violations(policy, state):
    """What the policies' aux must show after a decode step, counted
    over every (layer, lane, kv head): the last decoded token (position
    t - 1) is kept, as each policy's recency or score keeps it; under a
    policy that reads attention its slot holds its own step's attention
    mass (p_new, > 0: softmax mass over finite scores), and under the
    others no slot holds any aux."""
    B = state["t"].shape[0]
    t_last = (state["t"] - 1)[:, None, None]
    missing = bad = 0
    for st in state["layers"]:
        newest = st["pos"] == t_last
        missing += B * st["pos"].shape[1] - int(newest.sum())
        bad += int(((st["aux"] <= 0) & newest).sum() if policy.needs_attn
                   else (st["aux"] != 0).sum())
    return {"newest token not kept": missing,
            ("newest token without its attention mass" if policy.needs_attn
             else "aux without attention"): bad}


def check_aux(name, violations):
    """Raise unless every count of aux_violations is 0."""
    if any(violations.values()):
        raise AssertionError(f"{name}: {violations}")


def generate_pairs(eng, cfg, tokens, label, extra_inputs=None,
                   shape=SERVE_SHAPE):
    """Engine.generate per mode (single-shot, chunked), fused then eager,
    on the same inputs (extra_inputs: a cross family's memory): each
    call's launches against the exact count (a decode step launches the
    decode kernel once per layer and once more per cross layer, over its
    memory), finite logits, valid ids, the policy's aux
    (aux_violations); then graphs against eager (check_graphs):
    identical ids and slot positions in every layer, logits and every
    layer's aux within GRAPH_LOGIT_TOL of their largest magnitude.
    Returns the outputs by mode ("chunked fused", ...)."""
    import torch
    from repro_torch.kernels import ops

    B, N = tokens.shape[0], shape["N"]
    L, n_chunks = cfg.num_layers, -(-tokens.shape[1] // shape["chunk"])
    n_dec = L + cfg.layer_kinds().count("cross")
    sfx = "" if cfg.dtype == "bfloat16" else "_f32"
    none = dict.fromkeys(ops.KERNELS, 0)        # serving trains nothing
    expect = {
        False: {**none, "retention_attention" + sfx: L,
                "decode_attention": n_dec * N},
        True: {**none, "chunk_attention" + sfx: L * n_chunks,
               "decode_attention": n_dec * N},
    }
    if eng.device.type == "cpu":          # the plain versions count none
        expect = {False: none, True: none}
    results = {}
    before = dict(ops.LAUNCHES)
    for chunked in (False, True):
        for fused in (True, False):
            replays = eng.graphs.replays if eng.graphs else 0
            out = eng.generate(tokens, N, chunked=chunked, fused=fused,
                               extra_inputs=extra_inputs)
            now = dict(ops.LAUNCHES)
            got = {k: now[k] - before[k] for k in now}
            before = now
            mode = (f"{'chunked' if chunked else 'single-shot'} "
                    f"{'fused' if fused else 'eager'}")
            if got != expect[chunked]:
                raise AssertionError(f"{label} {mode}: launches {got}, "
                                     f"expected {expect[chunked]}")
            logits = out["logits"]
            if tuple(logits.shape) != (B, cfg.padded_vocab) or \
                    not torch.isfinite(logits[:, :cfg.vocab_size]).all():
                raise AssertionError(f"{label}: non-finite or misshapen "
                                     f"logits")
            ids = out["ids"]
            if ids.shape != (B, N) or ids.min() < 0 or \
                    ids.max() >= cfg.vocab_size:
                raise AssertionError(f"{label}: bad ids {ids.shape}")
            log(f"{label} {mode}: launches {got}; graph replays "
                f"{(eng.graphs.replays if eng.graphs else 0) - replays}; "
                f"prefill "
                f"{out['prefill_sec']:.3f} s = "
                f"{out['prefill_tok_per_sec']:.1f} tok/s; decode "
                f"{out['decode_sec']:.3f} s = {out['tok_per_sec']:.1f} "
                f"tok/s; ids[0][:8] {ids[0][:8].tolist()}")
            layers = out["state"]["layers"]
            check_aux(f"{label} {mode}", aux_violations(eng.policy,
                                                         out["state"]))
            results[mode] = {"ids": ids, "logits": logits.clone(),
                             "pos": [st["pos"].clone() for st in layers],
                             "aux": [st["aux"].clone() for st in layers],
                             "state bytes": state_bytes(out["state"]),
                             "tok_per_sec": out["tok_per_sec"],
                             "prefill_tok_per_sec":
                                 out["prefill_tok_per_sec"]}
            del out
        name = "chunked" if chunked else "single-shot"
        g, e = (results[f"{name} {m}"] for m in ("fused", "eager"))
        aux_scale = max(a.abs().max().item() for a in e["aux"])
        readings = {
            "ids differ": int((g["ids"] != e["ids"]).sum()),
            "slot positions differ": sum(int((a != b).sum())
                                         for a, b in zip(g["pos"], e["pos"])),
            "logit gap": ((g["logits"] - e["logits"]).abs().max()
                          / e["logits"][:, :cfg.vocab_size].abs().max()
                          ).item(),
            "aux gap": max((a - b).abs().max().item()
                           for a, b in zip(g["aux"], e["aux"]))
            / max(aux_scale, 1e-30)}
        log(f"{label} {name}: graphs vs eager: {readings['ids differ']} ids "
            f"and {readings['slot positions differ']} slot positions (all "
            f"{L} layers) differ, logits |diff| / max |logit| "
            f"{readings['logit gap']:.3e}, aux |diff| / max |aux| "
            f"{readings['aux gap']:.3e} (tol {GRAPH_LOGIT_TOL}), "
            f"bit-identical logits {torch.equal(g['logits'], e['logits'])}")
        check_graphs(f"{label} {name}", readings)
    return results


def serve_phase(cfg, model):
    """Engine.generate at full width under TRIM-KV, single-shot and
    chunked, each fused (the step programs' CUDA graphs) and eager
    (fused=False) on the same inputs (generate_pairs). Returns the
    launch counts (counted from 0 just before the first call) and the
    outputs by mode."""
    import torch
    from repro_torch.data.synthetic import make_batch
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import build_engine

    sh = SERVE_SHAPE
    eng = build_engine(cfg, model, device="cuda", budget=512,
                       prefill_chunk=sh["chunk"])
    tokens, _, _ = make_batch("copy", 0, sh["B"], sh["P"], cfg.vocab_size)
    ops.reset_launches()
    results = generate_pairs(eng, cfg, tokens, "serve")
    log(f"serve: graph pool {eng.graphs.bytes / 2**20:.1f} MiB over "
        f"{eng.graphs.captures} captures; static decode state "
        f"{results['chunked fused']['state bytes'] / 2**20:.1f} MiB per "
        f"batch of {sh['B']}")
    main_launches = dict(ops.LAUNCHES)
    del eng
    torch.cuda.empty_cache()
    return main_launches, results


# ------------------------------------------------------------- policies

# the policy phase's budgets: 512 as the serve phase, FullKV one that
# covers the prompt and the new tokens (2000 + 32)
# warm chunked fused calls per policy for its rates (their medians)
WARM_CALLS = 3
POLICY_BUDGETS = (("trimkv", 512), ("streaming_llm", 512), ("h2o", 512),
                  ("snapkv", 512), ("rkv", 512), ("keydiff", 512),
                  ("full", 2048))


def policy_phase(cfg, model):
    """Every eviction policy at full width on the serve phase's model and
    prompt (batch 4, prompt 2000 in chunks of 512, 32 new tokens; budget
    512, FullKV 2048): generate_pairs per policy (exact launches, graphs
    against eager: ids and slot positions identical, logits and aux
    within GRAPH_LOGIT_TOL), then WARM_CALLS chunked fused calls, warm,
    whose medians are its rates. Prints each policy's prefill and decode
    tokens/s, its graph pool and the paper's Table 6 rows (decode tok/s
    at budget M against FullKV at the whole context). Returns the launch
    counts of all its calls (counted from 0 just before the first) and
    the rows."""
    import gc

    import torch
    from repro_torch.data.synthetic import make_batch
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import build_engine

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: R-KV's and KeyDiff's "
                             "float32 Gram products would pick other "
                             "victims")
    sh = SERVE_SHAPE
    tokens, _, _ = make_batch("copy", 0, sh["B"], sh["P"], cfg.vocab_size)
    total = dict.fromkeys(ops.KERNELS, 0)
    rows = []
    for name, budget in POLICY_BUDGETS:
        t0 = time.perf_counter()
        ops.reset_launches()
        eng = build_engine(cfg, model, device="cuda", budget=budget,
                           prefill_chunk=sh["chunk"], policy=name)
        label = f"policy {name} (budget {budget})"
        generate_pairs(eng, cfg, tokens, label)
        warm = [eng.generate(tokens, sh["N"], chunked=True)
                for _ in range(WARM_CALLS)]
        dec = sorted(w["decode_sec"] for w in warm)[WARM_CALLS // 2]
        pre = sorted(w["prefill_sec"] for w in warm)[WARM_CALLS // 2]
        for k, n in ops.LAUNCHES.items():
            total[k] += n
        rows.append({"policy": name, "budget": budget,
                     "needs_attn": eng.policy.needs_attn,
                     "decode": sh["B"] * sh["N"] / dec,
                     "prefill": sh["B"] * sh["P"] / pre,
                     "pool": eng.graphs.bytes,
                     "launches": dict(ops.LAUNCHES)})
        log(f"{label}: {WARM_CALLS} warm chunked fused calls, medians: "
            f"prefill {pre * 1e3:.1f} ms = {rows[-1]['prefill']:.1f} tok/s, "
            f"decode {dec / sh['N'] * 1e3:.3f} ms a step = "
            f"{rows[-1]['decode']:.1f} tok/s (decode steps of the calls "
            f"{[round(w['decode_sec'] / sh['N'] * 1e3, 3) for w in warm]} "
            f"ms); graph pool {eng.graphs.bytes / 2**20:.1f} MiB over "
            f"{eng.graphs.captures} captures; phase "
            f"{time.perf_counter() - t0:.1f} s")
        del eng, warm
        gc.collect()
        torch.cuda.empty_cache()
    full = next(r for r in rows if r["policy"] == "full")["decode"]
    log(f"Table 6 (batch {sh['B']}, prompt {sh['P']}, {sh['N']} new tokens, "
        f"medians of {WARM_CALLS} warm chunked fused calls; "
        f"{card_line()}):")
    log(f"  {'policy':<14} {'budget':>6} {'decode tok/s':>13} "
        f"{'x full':>7} {'prefill tok/s':>14} {'pool MiB':>9}")
    for r in rows:
        log(f"  {r['policy']:<14} {r['budget']:>6} {r['decode']:>13.1f} "
            f"{r['decode'] / full:>7.3f} {r['prefill']:>14.1f} "
            f"{r['pool'] / 2**20:>9.1f}")
    attn = {k: sum(r["launches"][k] for r in rows if r["needs_attn"])
            for k in ("decode_attention", "chunk_attention")}
    log(f"policy phase: launches {total}; with the probabilities out "
        f"(h2o, snapkv, rkv): {attn}")
    return total, rows


def state_bytes(state):
    return sum(v.numel() * v.element_size() for st in state["layers"]
               for v in st.values()) + state["t"].numel() * 4


# ------------------------------------------------------------- stream

# The stream phase holds each request's ids against a one-shot
# Engine.generate(prompt[None], max_new, chunked=True) of the same
# request: identical up to the first step where the one-shot's top-two
# logit margin is under MARGIN_TOL[dtype] (there a lane batch of 4 and
# a batch of 1, whose cuBLAS kernels differ, may pick the other token).
# The reading is, over the requests that differ, the largest of their
# smallest one-shot margins up to the first differing token; it must
# be under the limit. The limits sit between that reading in sound runs
# and in runs with planted lane faults (launch/planted_faults.py,
# PERF.md): on the H100 every bf16 divergence of a sound run sat at an
# exact tie (margin 0: the bf16 logits of the top two tokens were
# equal); 0.02 admits one bf16 rounding step of a logit below 4 (the
# top logits read up to ~5) and nothing more. No float32 run diverged.
MARGIN_TOL = {"bfloat16": 0.02, "float32": 1e-3}


def check_stream(name, violations, margin=0.0, tol=math.inf):
    """Raise unless every stream count is 0 (requests or counters that
    broke a rule) and the one-shot margin reading is under tol."""
    bad = {k: v for k, v in violations.items() if v}
    if bad or not margin < tol:
        raise AssertionError(f"stream {name}: {bad}, one-shot margin "
                             f"reading {margin:.3e} (limit {tol})")


def first_divergence(got, want):
    """Index of the first differing id (the shorter length when one is a
    prefix of the other), or None."""
    n = min(len(got), len(want))
    return next((i for i in range(n) if got[i] != want[i]),
                None if len(got) == len(want) else n)


def traced_drain(eng, lanes, reqs, kw, later=()):
    """Serve reqs on a fresh Scheduler with every request submitted at
    once (no arrival times: the schedule depends on the trace alone),
    and the requests of ``later`` after the first step, one step() at a
    time. After each step, record every layer's slot positions and aux
    and the lanes' last decode logits. Returns (results, trace)."""
    from repro_torch.serve.scheduler import Scheduler
    sched = Scheduler(eng, n_lanes=lanes, **kw)
    for r in sorted(reqs, key=lambda r: r.arrival):
        sched.submit(r)
    trace, pending = [], list(later)
    while sched.queue or sched.n_running or pending:
        sched.step()
        for r in pending:
            sched.submit(r)
        pending = []
        layers = sched.lanes.state["layers"]
        trace.append(([st["pos"].clone() for st in layers],
                      sched.lanes.logits.clone(),
                      [st["aux"].clone() for st in layers]))
    return sched.results, trace


def twin_readings(fused, eager, vocab):
    """Graphs against eager over two traced drains: requests whose ids
    or status differ, slot positions that differ over every step and
    layer (a differing number of steps counts as 2**31), and the largest
    logit and aux gaps of a step as a share of its largest |logit| and
    |aux| (0 where a step's aux is all 0)."""
    (res_f, tr_f), (res_e, tr_e) = fused, eager
    ids = sum(res_f[k].tokens != res_e[k].tokens
              or res_f[k].status is not res_e[k].status for k in res_e)
    pos, gap = (0 if len(tr_f) == len(tr_e) else 2 ** 31), 0.0
    aux_gap = 0.0
    for (pf, lf, af), (pe, le, ae) in zip(tr_f, tr_e):
        pos += sum(int((a != b).sum()) for a, b in zip(pf, pe))
        lf, le = lf[:, :vocab], le[:, :vocab]
        gap = max(gap, ((lf - le).abs().max()
                        / le.abs().max().clamp_min(1e-30)).item())
        scale = max(a.abs().max().item() for a in ae)
        aux_gap = max(aux_gap, max((a - b).abs().max().item()
                                   for a, b in zip(af, ae))
                      / max(scale, 1e-30))
    return {"ids differ": ids, "slot positions differ": pos,
            "logit gap": gap, "aux gap": aux_gap}


def stream_model(dtype="bfloat16", num_layers=None):
    """The stream phase's model: trimkv-paper-4b at full width (num_layers
    cuts the depth, and then dtype applies), seeded weights (9), gates
    (10) and perturbed gate biases (11). Returns (cfg, model)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = get_config("trimkv-paper-4b")
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers, dtype=dtype)
    model = T.init_params(cfg, seed=9, device="cuda")
    T.init_gate_params(model, cfg, seed=10)
    perturb_gates(model, seed=11)
    return cfg, model


def stream_phase(dtype="bfloat16", num_layers=None, n_requests=12,
                 policy="trimkv"):
    """Continuous batching of trimkv-paper-4b (full width; num_layers
    cuts the depth) through Scheduler.run on 4 lanes, budget 512,
    prefill_chunk 512, decode_segment 16: a Poisson trace (seed 0) of
    n_requests prompts of 256-2000 tokens and max_new 16-64 arriving at
    8 requests/s, served phased, interleaved (prefill_budget 1024) and
    static (continuous=False). Per mode: every request DONE with its
    max_new tokens, dispatch_count equal to the scheduler's formula,
    kernel launches equal to what its steps imply, every logit finite
    (the scheduler raises on a lane's health flag otherwise), and each
    request's ids against its one-shot run (see MARGIN_TOL). Then, per
    mode, graphs against eager: the trace drained at once by the fused
    engine and by a fused=False engine on the same model, which run the
    same step programs with and without capture, with identical ids,
    identical slot positions after every step and logits (and aux)
    within GRAPH_LOGIT_TOL (check_graphs). ``policy`` names the eviction
    policy. Returns the launch counts of the phased run (counted from 0
    just before it) and the readings by mode (with each request's ids,
    ``ids``, {rid: tokens})."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import poisson_requests
    from repro_torch.serve.engine import build_engine
    from repro_torch.serve.request import Status, latency_percentiles
    from repro_torch.serve.scheduler import Scheduler, warm_up

    cfg, model = stream_model(dtype, num_layers)
    L, lanes, tol = cfg.num_layers, 4, MARGIN_TOL[dtype]
    serve_kw = dict(device="cuda", budget=512, prefill_chunk=512,
                    decode_segment=16, prefill_budget=1024,
                    swap_preempt=False, policy=policy)
    eng = build_engine(cfg, model, **serve_kw)
    reqs = poisson_requests(n_requests, 8.0, vocab=cfg.vocab_size,
                            prompt_lo=256, prompt_hi=2000, new_lo=16,
                            new_hi=64, seed=0)
    name = f"{dtype} {L} layers" + ("" if policy == "trimkv"
                                    else f" {policy}")
    log(f"stream {name}: {len(reqs)} requests, prompts "
        f"{[r.prompt_len for r in reqs]}, max_new "
        f"{[r.max_new for r in reqs]}, arrivals over "
        f"{reqs[-1].arrival:.2f} s; {lanes} lanes, budget 512, chunk 512, "
        f"segment 16")
    # the one-shot references (the B = 1 programs), then a warm-up drain
    # in both admission modes, which captures every lane program before
    # the measured runs
    oneshot = {r.rid: eng.generate(r.prompt[None], r.max_new, chunked=True)
               for r in reqs}
    margins = np.concatenate([o["margins"][0] for o in oneshot.values()])
    top = max(o["logits"][0, :cfg.vocab_size].abs().max().item()
              for o in oneshot.values())
    log(f"  one-shot top-two margins over {margins.size} steps: "
        f"{int((margins == 0).sum())} exact ties, "
        f"{int((margins < tol).sum())} under {tol}, median "
        f"{np.median(margins):.3e}; largest |logit| of the last steps "
        f"{top:.3f}")
    for interleaved in (False, True):
        warm_up(eng, lanes, reqs, interleaved=interleaved)
    readings, launches_phased, ids_by_mode = {}, None, {}
    sfx = "" if dtype == "bfloat16" else "_f32"
    modes = (("phased", {}), ("interleaved", {"interleaved": True}),
             ("static", {"continuous": False}))
    for mode, kw in modes:
        ops.reset_launches()
        eng.dispatch_count = 0
        replays = eng.graphs.replays
        sched = Scheduler(eng, n_lanes=lanes, **kw)
        t0 = time.perf_counter()
        res = sched.run(reqs, respect_arrivals=True)
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        if mode == "phased":
            launches_phased = launches
        steps = sched.steps_run
        expect = dict.fromkeys(ops.KERNELS, 0)
        expect["decode_attention"] = L * (steps["segment"] + steps["mixed"])
        expect["chunk_attention" + sfx] = L * (steps["chunk"]
                                               + steps["mixed"])
        formula = sched.n_prefill_rounds + sched.n_segments + sched.n_resets
        margin, report = 0.0, []
        for r in reqs:
            ref = oneshot[r.rid]
            got = res[r.rid].tokens
            diff = first_divergence(got, ref["ids"][0].tolist())
            if diff is not None:
                m = float(ref["margins"][0][:diff + 1].min())
                margin = max(margin, m)
                report.append(f"{r.rid}: at {diff} of {len(got)} (margin "
                              f"{ref['margins'][0][min(diff, r.max_new - 1)]:.3e}"
                              f", smallest up to it {m:.3e})"
                              f"{'' if m < tol else ' BEFORE A NEAR TIE'}")
        live = torch.stack([(st["pos"] >= 0).flatten(1).any(1)
                            for st in sched.lanes.state["layers"]])
        violations = {
            # every lane was reset when it last retired, and an inactive
            # lane writes nothing, so a drained scheduler holds no slot
            "lanes holding slots after the drain": int(live.any(0).sum()),
            "requests not DONE with max_new tokens": sum(
                res[r.rid].status is not Status.DONE
                or len(res[r.rid].tokens) != r.max_new for r in reqs),
            "dispatch_count off the formula": int(
                eng.dispatch_count != formula),
            "launches off the schedule": int(launches != expect),
        }
        n_tok = sum(len(res[r.rid].tokens) for r in reqs)
        ttft = latency_percentiles([res[r.rid].ttft_sec for r in reqs])
        tpot = latency_percentiles([res[r.rid].tpot_sec for r in reqs])
        log(f"stream {name} {mode}: {n_tok} tokens in {wall:.3f} s = "
            f"{n_tok / wall:.1f} output tok/s; TTFT p50 "
            f"{ttft['p50'] * 1e3:.1f} ms p99 {ttft['p99'] * 1e3:.1f} ms; "
            f"TPOT p50 {tpot['p50'] * 1e3:.2f} ms; segments "
            f"{sched.n_segments} ({sched.n_segment_splits} split), prefill "
            f"rounds {sched.n_prefill_rounds}, resets {sched.n_resets}, "
            f"dispatches {eng.dispatch_count} (formula {formula}); steps "
            f"{steps}; graph replays {eng.graphs.replays - replays}; host "
            f"enqueue {sched.enqueue_sec / sched.n_segments * 1e3:.2f} ms "
            f"per segment dispatch; launches {launches}")
        log(f"  one-shot comparison: {len(report)} of {len(reqs)} requests "
            f"differ; margin reading {margin:.3e} (limit {tol}): "
            + ("; ".join(report) if report else "none"))
        check_stream(f"{name} {mode}", violations, margin, tol)
        ids_by_mode[mode] = [res[r.rid].tokens for r in reqs]
        readings[mode] = {"violations": violations, "margin": margin,
                          "tok_per_sec": n_tok / wall, "ttft": ttft,
                          "tpot": tpot,
                          "ids": {r.rid: res[r.rid].tokens for r in reqs}}
    # every mode runs the same programs at the same shapes, and a lane's
    # rows never meet another lane's, so the schedule cannot change a
    # token: this holds every token, past the one-shot's first near tie
    same = sum(a == b == c for a, b, c in zip(*ids_by_mode.values()))
    log(f"stream {name}: ids identical in the three modes for {same} of "
        f"{len(reqs)} requests")
    check_stream(f"{name} modes", {
        "requests whose ids differ between the modes": len(reqs) - same})
    # graphs against eager: the same step programs, captured and not
    eager = build_engine(cfg, model, fused=False, **serve_kw)
    for mode, kw in modes:
        t0 = time.perf_counter()
        fused_run = traced_drain(eng, lanes, reqs, kw)
        t1 = time.perf_counter()
        eager_run = traced_drain(eager, lanes, reqs, kw)
        t2 = time.perf_counter()
        twins = twin_readings(fused_run, eager_run, cfg.vocab_size)
        log(f"stream {name} {mode}: graphs vs eager over "
            f"{len(eager_run[1])} steps ({t1 - t0:.2f} s against "
            f"{t2 - t1:.2f} s): {twins['ids differ']} requests' ids and "
            f"{twins['slot positions differ']} slot positions (all {L} "
            f"layers, after every step) differ, logits |diff| / max "
            f"|logit| {twins['logit gap']:.3e}, aux |diff| / max |aux| "
            f"{twins['aux gap']:.3e} (tol {GRAPH_LOGIT_TOL})")
        check_graphs(f"stream {name} {mode}", twins)
        readings[mode]["graphs vs eager"] = twins
        del fused_run, eager_run
    log(f"stream {name}: graph pool {eng.graphs.bytes / 2**20:.1f} MiB over "
        f"{eng.graphs.captures} captures")
    del eng, eager, model
    torch.cuda.empty_cache()
    return launches_phased, readings


# ------------------------------------------------------------- reuse

# The reuse phase's counts (requests or counters that broke a rule) must
# all read 0: prefix-cache ids against cache-off ids, speculative ids
# against the stream phase's spec_k 0 ids, float32 ids against one-shot
# runs, warm against cold. Exact equality is what the design gives:
# every lane runs the same kernels at the same shapes with the cache on
# or off and with spec_k 2 or 0, and a lane's rows never meet another
# lane's. Four planted faults (launch/planted_faults.py --reuse) read
# above 0.
PREFIX_TRIE_BYTES = 1 << 30        # 13 full-width bf16 slabs
SPEC_K = 2


def check_reuse(name, violations):
    """Raise unless every reuse count is 0."""
    bad = {k: v for k, v in violations.items() if v}
    if bad:
        raise AssertionError(f"reuse {name}: {bad}")


def _time_lane_ops(lanes):
    """Time LanePrograms.install and extract (prefix-cache installs and
    captures, each ending in a synchronize) on the host clock for one
    scheduler run, from a synchronize (so no queued step is counted):
    returns {op: [(seconds, lanes), ...]}; _untime_lane_ops restores the
    methods. The first extract of a LanePrograms also allocates its
    pinned staging buffer."""
    times = {"install": [], "extract": []}
    for name, calls in times.items():
        fn = getattr(lanes, name)

        def wrapped(sel, *a, _fn=fn, _calls=calls, **k):
            _sync(lanes.tok.device)
            t0 = time.perf_counter()
            out = _fn(sel, *a, **k)
            _calls.append((time.perf_counter() - t0, len(sel)))
            return out
        setattr(lanes, name, wrapped)
    return times


def _untime_lane_ops(lanes):
    for name in ("install", "extract"):
        lanes.__dict__.pop(name, None)


def reuse_drain(eng, reqs, trie, respect, totals, **kw):
    """One drain of ``reqs`` on a fresh 4-lane Scheduler over ``eng``
    with the prefix trie ``trie`` (None: the cache off), its kernel
    launches counted from 0 and added to ``totals``: returns (scheduler,
    results, wall seconds, lane-op times, the counts that broke a rule:
    requests not DONE with max_new tokens, dispatch_count off the
    formula, kernel launches off what the steps imply)."""
    from repro_torch.kernels import ops
    from repro_torch.serve.request import Status
    from repro_torch.serve.scheduler import Scheduler
    eng.prefix_cache = trie
    ops.reset_launches()
    eng.dispatch_count = 0
    sched = Scheduler(eng, n_lanes=4, **kw)
    times = _time_lane_ops(sched.lanes)
    _sync(eng.device)
    t0 = time.perf_counter()
    res = sched.run(reqs, respect_arrivals=respect)
    wall = time.perf_counter() - t0
    _untime_lane_ops(sched.lanes)
    for k, n in ops.LAUNCHES.items():
        totals[k] += n
    L, C = eng.cfg.num_layers, sched.spec_k + 1
    sfx = "" if eng.cfg.dtype == "bfloat16" else "_f32"
    steps = sched.steps_run
    expect = dict.fromkeys(ops.KERNELS, 0)
    if eng.device.type == "cuda":   # the plain versions count no launch
        expect["decode_attention"] = L * (
            steps["segment"] + steps["mixed"]
            + C * (steps["spec_segment"] + steps["spec_mixed"]))
        expect["chunk_attention" + sfx] = L * (
            steps["chunk"] + steps["mixed"] + steps["spec_mixed"])
    formula = (sched.n_prefill_rounds + sched.n_segments + sched.n_resets
               + sched.n_swaps + sched.n_resumes + sched.n_prefix_installs
               + sched.n_prefix_extracts)
    violations = {
        "requests not DONE with max_new tokens": sum(
            res[r.rid].status is not Status.DONE
            or len(res[r.rid].tokens) != r.max_new for r in reqs),
        "dispatch_count off the formula": int(eng.dispatch_count
                                              != formula),
        "launches off the schedule": int(dict(ops.LAUNCHES) != expect),
    }
    return sched, res, wall, times, violations


def _ids_differ(res, want):
    """Requests whose ids differ from want ({rid: tokens}); the first
    divergence of each as text."""
    report = []
    for rid, ids in want.items():
        d = first_divergence(res[rid].tokens, list(ids))
        if d is not None:
            report.append(f"{rid} at {d}")
    return report


def _per_lane_ms(calls):
    n = sum(k for _, k in calls)
    return sum(t for t, _ in calls) / n * 1e3 if n else float("nan")


def _stream_line(res, reqs, wall):
    from repro_torch.serve.request import latency_percentiles
    n_tok = sum(len(res[r.rid].tokens) for r in reqs)
    ttft = latency_percentiles([res[r.rid].ttft_sec for r in reqs])
    tpot = latency_percentiles([res[r.rid].tpot_sec for r in reqs])
    return n_tok / wall, ttft, tpot


def _replay_ms(lanes, name, n=8):
    """Ms of one replay of the lane program ``name`` (n replays, after
    one replay that captures it), with every lane active: device time
    from CUDA events on the card, the host clock on the CPU."""
    import numpy as np
    import torch
    B = lanes.batch
    prog = lanes.program(name)
    lanes.upload_carries(np.ones(B, bool), np.zeros(B, np.int32),
                         np.full(B, 1 << 20, np.int32),
                         np.full(B, -1, np.int32),
                         hist=lanes.hist.cpu().numpy())
    prog.run()
    lanes.upload_carries(np.ones(B, bool), np.zeros(B, np.int32),
                         np.full(B, 1 << 20, np.int32),
                         np.full(B, -1, np.int32),
                         hist=lanes.hist.cpu().numpy())
    if lanes.tok.device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(n):
            prog.run()
        return (time.perf_counter() - t0) * 1e3 / n
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    for _ in range(n):
        prog.run()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / n


def reuse_prefix_bf16(cfg, model, totals):
    """The prefix cache at full width in bf16: a shared-prefix trace
    (poisson_requests seed 0, 12 requests at 8/s, 2 pools of 1536 tokens
    drawn Zipf(1.1) before user turns of 64-464 tokens, max_new 16-64)
    on 4 lanes, phased and interleaved, the cache off and on (a cold
    trie of PREFIX_TRIE_BYTES, prefix_min_tokens 512) on one engine.
    Counts: reuse_drain's, modes without a hit, requests whose ids
    differ on and off."""
    from repro_torch.launch.serve import poisson_requests
    from repro_torch.serve.engine import build_engine
    from repro_torch.serve.prefix_cache import PrefixCache
    from repro_torch.serve.scheduler import warm_up
    eng = build_engine(cfg, model, device=model.device, budget=512,
                       prefill_chunk=512, decode_segment=16,
                       prefill_budget=1024, swap_preempt=False,
                       prefix_cache_bytes=PREFIX_TRIE_BYTES,
                       prefix_min_tokens=512)
    reqs = poisson_requests(12, 8.0, vocab=cfg.vocab_size, prompt_lo=64,
                            prompt_hi=464, new_lo=16, new_hi=64, seed=0,
                            prefix_pools=2, prefix_len=1536, zipf_alpha=1.1)
    log(f"reuse prefix bf16 {cfg.num_layers} layers: prompts "
        f"{[r.prompt_len for r in reqs]}, pools "
        f"{[int(r.prompt[0]) for r in reqs]} (first token), max_new "
        f"{[r.max_new for r in reqs]}; trie {PREFIX_TRIE_BYTES} B")
    eng.prefix_cache = None
    for interleaved in (False, True):
        warm_up(eng, 4, reqs, interleaved=interleaved)
    out = {}
    for mode, kw in (("phased", {}), ("interleaved", {"interleaved": True})):
        runs = {}
        for cache in ("off", "on"):
            trie = (PrefixCache(PREFIX_TRIE_BYTES) if cache == "on"
                    else None)
            runs[cache] = reuse_drain(eng, reqs, trie, True, totals, **kw)
        (s_off, r_off, w_off, _, v_off), (s_on, r_on, w_on, times,
                                          v_on) = runs["off"], runs["on"]
        st = s_on.stats()
        differ = _ids_differ(r_on, {r.rid: r_off[r.rid].tokens
                                    for r in reqs})
        violations = {**{f"off: {k}": v for k, v in v_off.items()},
                      **{f"on: {k}": v for k, v in v_on.items()},
                      "no prefix hit": int(st["n_prefix_hits"] == 0),
                      "ids differ on and off": len(differ)}
        lines = []
        for cache, (sched, res, wall, _, _) in runs.items():
            tps, ttft, tpot = _stream_line(res, reqs, wall)
            chunk_steps = sched.steps_run["chunk"] + sched.steps_run["mixed"]
            lines.append(f"cache {cache}: {tps:.1f} output tok/s, TTFT p50 "
                         f"{ttft['p50'] * 1e3:.1f} ms p99 "
                         f"{ttft['p99'] * 1e3:.1f} ms, TPOT p50 "
                         f"{tpot['p50'] * 1e3:.2f} ms, chunk steps "
                         f"{chunk_steps}, segments {sched.n_segments}")
            out[(mode, cache)] = {"tok_per_sec": tps, "ttft": ttft,
                                  "tpot": tpot}
        log(f"reuse prefix bf16 {mode}: hits {st['n_prefix_hits']}, misses "
            f"{st['n_prefix_misses']}, reused tokens (prefill skipped) "
            f"{st['n_prefix_reused_tokens']}, installs "
            f"{st['n_prefix_installs']}, extracts "
            f"{st['n_prefix_extracts']}, inserts {st['prefix_inserts']}, "
            f"entries {st['prefix_entries']} ({st['prefix_bytes']} B); "
            f"ms per lane: install {_per_lane_ms(times['install']):.2f} "
            f"({len(times['install'])} calls), capture "
            f"{_per_lane_ms(times['extract']):.2f} "
            f"({len(times['extract'])} calls: "
            + ", ".join(f"{t * 1e3:.2f}" for t, _ in times["extract"])
            + " ms)")
        log(f"reuse prefix bf16 {mode} streams: {'; '.join(lines)}; ids "
            f"differ on vs off: {', '.join(differ) or 'none'}")
        out[(mode, "stats")] = st
        check_reuse(f"prefix bf16 {mode}", violations)
    eng.prefix_cache = None
    return out


def reuse_spec_bf16(cfg, model, totals, stream=None):
    """Speculative decoding at full width in bf16, spec_k SPEC_K, on the
    stream phase's trace (poisson_requests seed 0, 12 requests, prompts
    256-2000, max_new 16-64, 8/s) and lanes, phased and interleaved:
    each request's ids against the stream phase's spec_k 0 ids
    (``stream``: its readings by mode; None runs the spec_k 0 drains
    here), exact. Prints acceptance, verify rounds, output tok/s and
    TPOT p50 beside spec_k 0's, and the ms of one replayed verify
    round beside a plain segment step's."""
    from repro_torch.launch.serve import poisson_requests
    from repro_torch.serve.engine import build_engine
    from repro_torch.serve.scheduler import warm_up
    kw = dict(device=model.device, budget=512, prefill_chunk=512,
              decode_segment=16, prefill_budget=1024, swap_preempt=False)
    reqs = poisson_requests(12, 8.0, vocab=cfg.vocab_size, prompt_lo=256,
                            prompt_hi=2000, new_lo=16, new_hi=64, seed=0)
    modes = (("phased", {}), ("interleaved", {"interleaved": True}))
    if stream is None:
        base = build_engine(cfg, model, **kw)
        for interleaved in (False, True):
            warm_up(base, 4, reqs, interleaved=interleaved)
        stream = {}
        for mode, mkw in modes:
            _, res, wall, _, v = reuse_drain(base, reqs, None, True,
                                             totals, **mkw)
            check_reuse(f"spec bf16 baseline {mode}", v)
            tps, ttft, tpot = _stream_line(res, reqs, wall)
            stream[mode] = {"ids": {r.rid: res[r.rid].tokens for r in reqs},
                            "tok_per_sec": tps, "tpot": tpot}
        del base
    eng = build_engine(cfg, model, spec_k=SPEC_K, **kw)
    for interleaved in (False, True):
        warm_up(eng, 4, reqs, interleaved=interleaved)
    out = {}
    for mode, mkw in modes:
        sched, res, wall, _, v = reuse_drain(eng, reqs, None, True, totals,
                                             **mkw)
        st = sched.stats()
        differ = _ids_differ(res, stream[mode]["ids"])
        tps, ttft, tpot = _stream_line(res, reqs, wall)
        base_tpot = stream[mode]["tpot"]["p50"]
        log(f"reuse spec bf16 {mode} (spec_k {SPEC_K}): acceptance "
            f"{st['n_spec_tokens'] / max(st['n_spec_rounds'], 1):.3f} tokens"
            f" per live round ({st['n_spec_tokens']} / "
            f"{st['n_spec_rounds']}), verify rounds {st['n_verify_rounds']}"
            f", {tps:.1f} output tok/s against "
            f"{stream[mode]['tok_per_sec']:.1f} at spec_k 0, TPOT p50 "
            f"{tpot['p50'] * 1e3:.2f} ms against {base_tpot * 1e3:.2f}, "
            f"TTFT p50 {ttft['p50'] * 1e3:.1f} ms; dispatches "
            f"{eng.dispatch_count}, steps {sched.steps_run}; ids differ from"
            f" spec_k 0: {', '.join(differ) or 'none'}")
        check_reuse(f"spec bf16 {mode}", {
            **v, "ids differ from spec_k 0": len(differ)})
        out[mode] = {"tok_per_sec": tps, "tpot": tpot, "stats": st}
    lanes = eng.lane_closures(4)
    turns = [("segment", _replay_ms(lanes, "segment")),
             ("spec_segment", _replay_ms(lanes, "spec_segment")),
             ("spec_segment", _replay_ms(lanes, "spec_segment")),
             ("segment", _replay_ms(lanes, "segment"))]
    clock = "device" if model.device.type == "cuda" else "host"
    log(f"reuse spec bf16: ms of one replay ({clock} clock), in turns: "
        + ", ".join(f"{n} {ms:.3f}" for n, ms in turns)
        + f"; a verify round ({SPEC_K + 1} positions, {cfg.num_layers} "
        f"layers) against a plain step: "
        f"{(turns[1][1] + turns[2][1]) / (turns[0][1] + turns[3][1]):.2f}x")
    out["round_ms"] = (turns[1][1] + turns[2][1]) / 2
    out["step_ms"] = (turns[0][1] + turns[3][1]) / 2
    del eng
    return out


def reuse_float32(policy, totals):
    """float32 at 2 layers (the float32 stream phase's model) under
    ``policy``: a shared-prefix trace (poisson_requests seed 0, 6
    requests, 2 pools of 1536 tokens, user turns 64-464, max_new 16-64),
    phased and interleaved, the cache off, cold and warm, spec_k SPEC_K,
    and spec_k SPEC_K on the same warm trie (its slabs came from the
    spec_k 0 engine: the same chunks, the same state). Counts:
    reuse_drain's, requests whose ids differ from their one-shot runs
    (every run), warm from cold, spec + prefix from neither, a warm run
    without a hit (a cold trie may legitimately see none: its captures
    can land after the pool's last admission)."""
    from repro_torch.launch.serve import poisson_requests
    from repro_torch.serve.engine import build_engine
    from repro_torch.serve.prefix_cache import PrefixCache
    cfg, model = stream_model("float32", 2)
    kw = dict(device=model.device, budget=512, prefill_chunk=512,
              decode_segment=16, prefill_budget=1024, swap_preempt=False,
              policy=policy, prefix_min_tokens=512)
    base = build_engine(cfg, model, **kw)
    spec = build_engine(cfg, model, spec_k=SPEC_K, **kw)
    reqs = poisson_requests(6, 8.0, vocab=cfg.vocab_size, prompt_lo=64,
                            prompt_hi=464, new_lo=16, new_hi=64, seed=0,
                            prefix_pools=2, prefix_len=1536, zipf_alpha=1.1)
    oneshot = {r.rid: base.generate(r.prompt[None], r.max_new,
                                    chunked=True)["ids"][0].tolist()
               for r in reqs}
    for mode, mkw in (("phased", {}), ("interleaved", {"interleaved": True})):
        trie = PrefixCache(PREFIX_TRIE_BYTES)
        runs = {}
        for name, eng, t in (("neither", base, None),
                             ("prefix cold", base, trie),
                             ("prefix warm", base, trie),
                             ("spec", spec, None),
                             ("spec + prefix", spec, trie)):
            runs[name] = reuse_drain(eng, reqs, t, False, totals, **mkw)
        violations, report = {}, []
        for name, (sched, res, _, _, v) in runs.items():
            violations.update({f"{name}: {k}": n for k, n in v.items()})
            differ = _ids_differ(res, oneshot)
            violations[f"{name}: ids differ from one-shot"] = len(differ)
            if name in ("prefix warm", "spec + prefix"):
                violations[f"{name}: no prefix hit"] = int(
                    sched.n_prefix_hits == 0)
            report.append(f"{name} {len(differ)}"
                          + (f" ({', '.join(differ)})" if differ else "")
                          + (f", hits {sched.n_prefix_hits}"
                             if sched._pc is not None else "")
                          + (f", acceptance {sched.n_spec_tokens}/"
                             f"{sched.n_spec_rounds}" if sched.spec_k
                             else ""))
        ids = {name: {r.rid: run[1][r.rid].tokens for r in reqs}
               for name, run in runs.items()}
        violations["prefix warm: ids differ from cold"] = len(
            _ids_differ(runs["prefix warm"][1], ids["prefix cold"]))
        violations["spec + prefix: ids differ from neither"] = len(
            _ids_differ(runs["spec + prefix"][1], ids["neither"]))
        log(f"reuse float32 2 layers {policy} {mode}: requests differing "
            f"from one-shot: {'; '.join(report)}")
        check_reuse(f"float32 {policy} {mode}", violations)
    base.prefix_cache = spec.prefix_cache = None
    del base, spec, model


def reuse_phase(stream=None):
    """The prefix KV cache and speculative decoding on the lane
    scheduler: bf16 at full width (reuse_prefix_bf16, reuse_spec_bf16
    against the stream phase's readings ``stream``), then float32 at 2
    layers under trimkv and h2o (reuse_float32). Returns (the kernel
    launches of the phase's drains, each counted from 0, the bf16
    readings)."""
    import gc
    import torch
    from repro_torch.kernels import ops
    totals = dict.fromkeys(ops.KERNELS, 0)
    cfg, model = stream_model("bfloat16")
    readings = {"prefix": reuse_prefix_bf16(cfg, model, totals),
                "spec": reuse_spec_bf16(cfg, model, totals, stream)}
    on_card = model.device.type == "cuda"
    del model
    gc.collect()
    torch.cuda.empty_cache()
    for policy in ("trimkv", "h2o"):
        reuse_float32(policy, totals)
        gc.collect()
        torch.cuda.empty_cache()
    path = ("decode_attention", "chunk_attention", "chunk_attention_f32")
    if on_card:   # the plain versions count no launch
        check_reuse("launches", {f"{k} never launched": int(totals[k] == 0)
                                 for k in path})
    log(f"reuse launches: {totals}")
    return totals, readings


# ------------------------------------------------------------- lifecycle

# Sampled lanes are held to their one-shot runs as the stream phase
# holds greedy ones, on the scores a sampled step takes the argmax of:
# logits / T plus the gumbel noise (Engine.generate's margins). A lane
# batch of 4 and a batch of 1 may round a bf16 logit one step apart;
# over T that moves a score by the step / T, and the two leading
# candidates can move apart by twice that. The stream phase's logits
# reach ~5, where a bf16 step is 2^-5: 2 * 2^-5 / 0.8 = 0.078, so 0.08.
# float32 rounds alike in both (no float32 stream has diverged): the
# stream phase's float32 limit over T.
TEMPERATURE = 0.8
SAMPLED_MARGIN_TOL = {"bfloat16": 0.08,
                      "float32": MARGIN_TOL["float32"] / TEMPERATURE}


def check_lifecycle(name, violations, margin=0.0, tol=math.inf):
    """Raise unless every lifecycle count is 0 and the one-shot margin
    reading (oneshot_margin) is under tol."""
    bad = {k: v for k, v in violations.items() if v}
    if bad or not margin < tol:
        raise AssertionError(f"lifecycle {name}: {bad}, one-shot margin "
                             f"reading {margin:.3e} (limit {tol})")


def lifecycle_model(dtype):
    """trimkv-paper-4b at full width (36 layers) in ``dtype`` with seeded
    weights and perturbed gates: (cfg, model)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_config("trimkv-paper-4b"), dtype=dtype)
    model = T.init_params(cfg, seed=21, device="cuda")
    T.init_gate_params(model, cfg, seed=22)
    perturb_gates(model, seed=23)
    return cfg, model


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def oneshot_margin(res, oneshot, reqs):
    """The stream phase's one-shot reading over sampled runs: for the
    requests whose ids part from their one-shot run, the largest of
    their smallest one-shot margins up to the first differing token
    (0 when none parts). Returns (reading, report)."""
    margin, report = 0.0, []
    for r in reqs:
        ref = oneshot[r.rid]
        got = res[r.rid].tokens
        diff = first_divergence(got, ref["ids"][0].tolist())
        if diff is not None:
            m = float(ref["margins"][0][:diff + 1].min())
            margin = max(margin, m)
            report.append(f"{r.rid}: at {diff} of {len(got)} (smallest "
                          f"margin up to it {m:.3e})")
    return margin, report


def threefry_on_card():
    """The same keys give the same split keys and bits on the card and
    on the CPU (exact integers), and gumbel floats within 1e-6 of
    max(1, |value|)."""
    import numpy as np
    import torch
    from repro_torch.core import prng
    from repro_torch.serve.scheduler import _prng_keys
    keys = torch.as_tensor(_prng_keys([0, 7, 2**31 + 3, 123456789012])
                           .astype(np.int64))
    V = 151936
    out = {}
    for dev in ("cpu", "cuda"):
        k = keys.to(dev)
        new, sub = prng.split(k)
        rows = prng.random_bits(sub, V)
        flat = prng.random_bits(sub[0], 4 * V)
        out[dev] = (new.cpu(), sub.cpu(), rows.cpu(), flat.cpu(),
                    prng.gumbel_from_bits(rows).cpu())
    c, g = out["cpu"], out["cuda"]
    diff = (c[4] - g[4]).abs()
    # one float32 ulp of a gumbel value of 8-16 is 9.5e-7: the gap is
    # read against max(1, |value|)
    rel = diff / c[4].abs().clamp_min(1.0)
    violations = {
        "split keys that differ": int((c[0] != g[0]).sum()
                                      + (c[1] != g[1]).sum()),
        "bits that differ": int((c[2] != g[2]).sum() + (c[3] != g[3]).sum()),
        "gumbel beyond 1e-6 of max(1, |value|)": int(rel.gt(1e-6).sum()),
    }
    log(f"lifecycle threefry: card vs CPU over 4 keys x {V} and one key x "
        f"{4 * V}: {violations}; gumbel |diff| max {diff.max().item():.3e}, "
        f"over max(1, |value|) {rel.max().item():.3e}")
    check_lifecycle("threefry", violations)


def sampled_stream(cfg, eng, reqs, oneshot, tol):
    """Sampled lanes (T 0.8), phased and interleaved, every request
    submitted at once: DONE with max_new tokens, the dispatch formula,
    the kernel launches its steps imply, and ids against the one-shot
    runs (see SAMPLED_MARGIN_TOL)."""
    from repro_torch.kernels import ops
    from repro_torch.serve.request import Status
    from repro_torch.serve.scheduler import Scheduler, warm_up
    sfx = "" if cfg.dtype == "bfloat16" else "_f32"
    L = cfg.num_layers
    for interleaved in (False, True):
        warm_up(eng, 4, reqs, interleaved=interleaved, greedy=False)
        before = dict(ops.LAUNCHES)
        eng.dispatch_count = 0
        sched = Scheduler(eng, n_lanes=4, greedy=False,
                          interleaved=interleaved)
        t0 = time.perf_counter()
        res = sched.run(reqs)
        wall = time.perf_counter() - t0
        sched.close()
        steps = sched.steps_run
        expect = dict.fromkeys(ops.KERNELS, 0)
        expect["decode_attention"] = L * (steps["segment"] + steps["mixed"])
        expect["chunk_attention" + sfx] = L * (steps["chunk"]
                                               + steps["mixed"])
        margin, report = oneshot_margin(res, oneshot, reqs)
        mode = "interleaved" if interleaved else "phased"
        violations = {
            "requests not DONE with max_new tokens": sum(
                res[r.rid].status is not Status.DONE
                or len(res[r.rid].tokens) != r.max_new for r in reqs),
            "dispatch_count off the formula": int(
                eng.dispatch_count != sched.n_prefill_rounds
                + sched.n_segments + sched.n_resets),
            "launches off the schedule": int(
                {k: ops.LAUNCHES[k] - before[k] for k in before} != expect),
        }
        n_tok = sum(len(res[r.rid].tokens) for r in reqs)
        log(f"lifecycle sampled stream {cfg.dtype} {mode}: {n_tok} tokens "
            f"in {wall:.2f} s, segments {sched.n_segments}, dispatches "
            f"{eng.dispatch_count}; {len(report)} of {len(reqs)} requests "
            f"part from their one-shot run, margin reading {margin:.3e} "
            f"(limit {tol:.3e}){': ' + '; '.join(report) if report else ''}")
        check_lifecycle(f"sampled stream {cfg.dtype} {mode}", violations,
                        margin, tol)


def sampled_program_vs_eager(eng, cfg):
    """The sampled decode program (a CUDA graph) against the eager loop
    on the same prompt: identical ids and final key."""
    import numpy as np
    tokens = np.random.RandomState(5).randint(0, cfg.vocab_size, (4, 700))
    runs = [eng.generate(tokens, 16, chunked=True, greedy=False, seed=99,
                         fused=fused) for fused in (True, False)]
    violations = {
        "ids that differ": int((runs[0]["ids"] != runs[1]["ids"]).sum()),
        "key words that differ": int((runs[0]["key"]
                                      != runs[1]["key"]).sum()),
    }
    log(f"lifecycle sampled decode program vs eager loop {cfg.dtype} "
        f"(batch 4, 16 steps): {violations}")
    check_lifecycle(f"sampled program vs eager {cfg.dtype}", violations)


def extract_resume_exact(lanes):
    """Extract every lane, scrub them, resume them: every leaf of the
    static state, the carried tokens and the keys bit-exact."""
    import torch
    before = {"t": lanes.state["t"].clone(),
              "layers": [{k: v.clone() for k, v in st.items()}
                         for st in lanes.state["layers"]]}
    tok, keys = lanes.tok.clone(), lanes.keys.clone()
    all_lanes = list(range(lanes.batch))
    snaps = lanes.extract(all_lanes)
    lanes.scrub(torch.ones(lanes.batch, dtype=torch.bool,
                           device=lanes.tok.device))
    lanes.tok.zero_()
    lanes.keys.zero_()
    lanes.resume(all_lanes, *zip(*snaps))
    n = int(not torch.equal(lanes.state["t"], before["t"]))
    for a, b in zip(lanes.state["layers"], before["layers"]):
        n += sum(not torch.equal(a[k], b[k]) for k in a)
    return n + int(not torch.equal(lanes.tok, tok)) + int(
        not torch.equal(lanes.keys, keys))


def swap_preemption(cfg, eng, reqs, oneshot):
    """A priority stream on 4 lanes, swap_preempt=True (the default):
    eight priority-0 requests, one step (four admitted, a segment of 16
    decode steps; every max_new is over 16, so all four still decode),
    then four priority-1 ones, which preempt the decoding lanes. Swaps
    and resumes happen, every request DONE with its one-shot ids;
    extract then resume is bit-exact on every leaf."""
    from repro_torch.serve.request import Status
    from repro_torch.serve.scheduler import Scheduler
    eng.serve = dataclasses.replace(eng.serve, sched_policy="priority")
    eng.dispatch_count = 0
    reqs = [dataclasses.replace(r, priority=int(i >= 8))
            for i, r in enumerate(reqs)]
    sched = Scheduler(eng, n_lanes=4, greedy=False)
    for r in reqs[:8]:
        sched.submit(r)
    sched.step()
    leaves = extract_resume_exact(sched.lanes)
    for r in reqs[8:]:
        sched.submit(r)
    res = sched.run()
    sched.close()
    margin, report = oneshot_margin(res, oneshot, reqs)
    tol = SAMPLED_MARGIN_TOL[cfg.dtype]
    violations = {
        "no swap": int(sched.n_swaps == 0),
        "no resume": int(sched.n_resumes == 0),
        "requests not DONE with max_new tokens": sum(
            res[r.rid].status is not Status.DONE
            or len(res[r.rid].tokens) != r.max_new for r in reqs),
        "dispatch_count off the formula": int(
            eng.dispatch_count != sched.n_prefill_rounds + sched.n_segments
            + sched.n_resets + sched.n_swaps + sched.n_resumes),
        "leaves not bit-exact after extract and resume": leaves,
    }
    log(f"lifecycle swap preemption {cfg.dtype}: swaps {sched.n_swaps}, "
        f"resumes {sched.n_resumes}, preempted {sched.n_preempted}, "
        f"dispatches {eng.dispatch_count}; margin reading {margin:.3e} "
        f"(limit {tol:.3e}){': ' + '; '.join(report) if report else ''}; "
        f"{violations}")
    eng.serve = dataclasses.replace(eng.serve, sched_policy="fifo")
    check_lifecycle(f"swap {cfg.dtype}", violations, margin, tol)


def park_and_recover(cfg, eng, reqs, oneshot):
    """Two decoding requests parked with a snapshot directory; the
    scheduler is dropped; a new one over the directory recovers both as
    PARKED, revives them and finishes them with their one-shot ids."""
    import shutil
    import tempfile
    from repro_torch.serve.request import Status
    from repro_torch.serve.scheduler import Scheduler
    pick = sorted(reqs, key=lambda r: -r.max_new)[:2]
    tmp = tempfile.mkdtemp(prefix="lifecycle_")
    try:
        eng.serve = dataclasses.replace(eng.serve, snapshot_dir=tmp)
        first = Scheduler(eng, n_lanes=4, greedy=False)
        for r in pick:
            first.submit(r)
        first.step()
        for r in pick:
            first.park(r.rid)
        first.close()
        del first
        second = Scheduler(eng, n_lanes=4, greedy=False)
        recovered = second.n_recovered_sessions
        parked = sum(rs.status is Status.PARKED
                     for rs in second.results.values())
        for r in pick:
            second.revive(r.rid)
        res = second.run()
        second.close()
        st = second.stats()
    finally:
        eng.serve = dataclasses.replace(eng.serve, snapshot_dir=None)
        shutil.rmtree(tmp, ignore_errors=True)
    margin, report = oneshot_margin(res, oneshot, pick)
    tol = SAMPLED_MARGIN_TOL[cfg.dtype]
    violations = {
        "sessions not recovered": 2 - recovered,
        "recovered sessions not PARKED": 2 - parked,
        "slabs not read from disk": 2 - st["store_disk_hits"],
        "requests not DONE with max_new tokens": sum(
            res[r.rid].status is not Status.DONE
            or len(res[r.rid].tokens) != r.max_new for r in pick),
    }
    log(f"lifecycle park, restart, revive {cfg.dtype}: recovered "
        f"{recovered}, disk hits {st['store_disk_hits']}, resumes "
        f"{second.n_resumes}; margin reading {margin:.3e}"
        f"{': ' + '; '.join(report) if report else ''}; {violations}")
    check_lifecycle(f"park and recover {cfg.dtype}", violations, margin,
                    tol)


def quarantine(cfg, eng, oneshot):
    """Six requests with prompts of 64-400 tokens (seed 2) and their
    one-shot runs; a seeded FaultInjector poisons decoding lanes for the
    first six steps, checkpoint_every=2: every request terminates, DONE or FAILED
    only past max_retries, each quarantine answers an injected poison,
    and DONE requests carry their one-shot ids. Then a parked request's
    stored slab gets one flipped bit: its checksum catches it at the
    revival (n_snapshot_lost) and the request is replayed to its
    one-shot ids."""
    import numpy as np
    from repro_torch.launch.serve import poisson_requests
    from repro_torch.serve.faults import FaultInjector
    from repro_torch.serve.request import TERMINAL_STATUSES, Status
    from repro_torch.serve.scheduler import Scheduler
    # prompts under the budget, so a lane's next occupant leaves slots
    # empty (a poisoned payload that was not zeroed would show there)
    short = poisson_requests(6, 8.0, vocab=cfg.vocab_size, prompt_lo=64,
                             prompt_hi=400, new_lo=17, new_hi=48, seed=2)
    short = [dataclasses.replace(r, rid=100 + r.rid) for r in short]
    oneshot = dict(oneshot)
    oneshot.update({r.rid: eng.generate(r.prompt[None], r.max_new,
                                        chunked=True, greedy=False,
                                        seed=r.seed) for r in short})
    eng.serve = dataclasses.replace(eng.serve, checkpoint_every=2,
                                    max_retries=2)
    eng.dispatch_count = 0
    inj = FaultInjector(seed=3, corrupt_prob=0.5)
    sched = Scheduler(eng, n_lanes=4, greedy=False, injector=inj)
    for r in short:
        sched.submit(r)
    for _ in range(6):
        sched.step()
    inj.corrupt_prob = 0.0
    res = sched.run()
    sched.close()
    done = [r for r in short if res[r.rid].status is Status.DONE]
    margin, report = oneshot_margin(res, oneshot, done)
    tol = SAMPLED_MARGIN_TOL[cfg.dtype]
    violations = {
        "requests not terminal": sum(res[r.rid].status
                                     not in TERMINAL_STATUSES
                                     for r in short),
        "FAILED within max_retries": sum(
            res[r.rid].status is Status.FAILED
            and res[r.rid].n_retries <= 2 for r in short),
        "no quarantine": int(sched.n_quarantined == 0),
        "quarantines beyond the injected poisons": max(
            0, sched.n_quarantined - sched.n_faults_injected),
        "DONE requests short of max_new": sum(
            len(res[r.rid].tokens) != r.max_new for r in done),
        "dispatch_count off the formula": int(
            eng.dispatch_count != sched.n_prefill_rounds + sched.n_segments
            + sched.n_resets + sched.n_swaps + sched.n_resumes
            + sched.n_faults_injected),
    }
    st = sched.stats()
    log(f"lifecycle quarantine {cfg.dtype}: poisons "
        f"{sched.n_faults_injected}, quarantined {sched.n_quarantined}, "
        f"retries {st['n_retries']}, failed {sched.n_failed}, DONE "
        f"{len(done)} of {len(short)}, checkpoints (swaps) {sched.n_swaps}, "
        f"resumes {sched.n_resumes}, prefill rounds "
        f"{sched.n_prefill_rounds}; margin reading {margin:.3e}"
        f"{': ' + '; '.join(report) if report else ''}; {violations}")
    # one flipped bit in a parked slab
    eng.serve = dataclasses.replace(eng.serve, checkpoint_every=0)
    r = max(short, key=lambda r: r.max_new)
    sched = Scheduler(eng, n_lanes=4, greedy=False)
    sched.submit(r)
    sched.step()
    sched.park(r.rid)
    where = sched.store.chaos_corrupt(np.random.default_rng(0), rid=r.rid)
    sched.revive(r.rid)
    res = sched.run()
    sched.close()
    margin2, _ = oneshot_margin(res, oneshot, [r])
    violations.update({
        "flipped bit not caught": int(where != "ram"
                                      or sched.n_snapshot_lost != 1),
        "replayed request not DONE with max_new tokens": int(
            res[r.rid].status is not Status.DONE
            or len(res[r.rid].tokens) != r.max_new),
    })
    log(f"lifecycle flipped snapshot bit {cfg.dtype}: corrupted {where}, "
        f"snapshots lost {sched.n_snapshot_lost}, store corrupt detected "
        f"{sched.stats()['store_corrupt_detected']}, prefill rounds "
        f"{sched.n_prefill_rounds}, status {res[r.rid].status.value}")
    eng.serve = dataclasses.replace(eng.serve, max_retries=2)
    check_lifecycle(f"quarantine {cfg.dtype}", violations,
                    max(margin, margin2), tol)


def _median_ms(fn, n=5):
    import statistics
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def lifecycle_times(cfg, eng):
    """Per-lane snapshot bytes; swap-out split into the device-to-host
    copy (and, within it, the copy out of the pinned staging buffer into
    new host arrays, beside the same copy into arrays touched before),
    crc32 and store.put; resume into get + verify and
    host-to-device + install; a disk write and read; the recompute a
    swap saves (a chunked prefill of a 2000-token prompt, one lane); and
    a replayed sampled decode step against a greedy one. Host clock
    medians of 5 (each ends in a synchronize), decode steps by CUDA
    events over 32 replays in turns."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.serve.graphs import host_row_template
    from repro_torch.serve.request import LaneSnapshot
    from repro_torch.serve.store import (SnapshotStore, checksum_snapshot,
                                         snapshot_nbytes, state_spec)
    lanes = eng.lane_closures(4)
    dev = lanes.tok.device
    row, tok, key = lanes.extract([1])[0]
    snap = LaneSnapshot(state=row, tok=tok, key=key, n_emitted=0,
                        n_tokens=0)
    nbytes = snapshot_nbytes(snap)
    d2h = _median_ms(lambda: lanes.extract([1]))
    # extract's copy out of its pinned staging buffer into ordinary host
    # memory (part of d2h): one host copy of every leaf of a lane's row,
    # into new arrays (as extract copies) and into arrays touched before
    leaves = [row["t"]] + [v for st in row["layers"] for v in st.values()]
    copy_out = _median_ms(lambda: [np.copy(a) for a in leaves])
    held = [np.copy(a) for a in leaves]
    copy_into = _median_ms(
        lambda: [np.copyto(b, a) for a, b in zip(leaves, held)])
    del held
    crc = _median_ms(lambda: checksum_snapshot(snap))
    store = SnapshotStore()
    put = _median_ms(lambda: store.put(0, snap))
    get = _median_ms(lambda: store.get(0))
    install = _median_ms(lambda: lanes.resume([1], [row], [tok], [key]))
    tmp = tempfile.mkdtemp(prefix="lifecycle_times_")
    try:
        expected = state_spec(host_row_template(cfg, eng.serve.budget))
        disk = SnapshotStore(directory=tmp, expected_spec=expected)
        t0 = time.perf_counter()
        disk.put(0, snap, kind="park")
        disk.flush()
        write = (time.perf_counter() - t0) * 1e3
        disk.close()
        again = SnapshotStore(directory=tmp, expected_spec=expected)
        t0 = time.perf_counter()
        ok = again.get(0) is not None
        read = (time.perf_counter() - t0) * 1e3
        again.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    prompt = np.random.RandomState(6).randint(0, cfg.vocab_size, (1, 2000))

    def recompute():
        eng.prefill(prompt, chunked=True)
        _sync(dev)

    recompute()
    prefill = _median_ms(recompute)
    progs = eng._programs(4)
    tokens = np.random.RandomState(7).randint(0, cfg.vocab_size, (4, 2000))
    eng.prefill(tokens, chunked=True)
    tk = [progs.tok.clone()]

    def steps(sampled):
        def go():
            for _ in range(32):
                tk[0] = progs.decode(tk[0], sampled=sampled)[0]
        go()                                   # capture and warm
        _sync(dev)
        if dev.type != "cuda":
            return _median_ms(go, 1) / 32
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        go()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 32

    turns = [steps(s) for s in (False, True, True, False)]
    greedy_ms = (turns[0] + turns[3]) / 2
    sampled_ms = (turns[1] + turns[2]) / 2
    times = {"snapshot_bytes": nbytes, "d2h_ms": d2h,
             "copy_out_ms": copy_out, "copy_into_ms": copy_into,
             "crc32_ms": crc,
             "put_ms": put, "get_verify_ms": get, "h2d_install_ms": install,
             "disk_write_ms": write, "disk_read_ms": read,
             "recompute_prefill_ms": prefill, "greedy_step_ms": greedy_ms,
             "sampled_step_ms": sampled_ms, "step_turns_ms": turns}
    log(f"lifecycle snapshot bytes per lane {cfg.dtype}: {nbytes} "
        f"({nbytes / 2**20:.1f} MiB)")
    log(f"lifecycle swap-out per lane: device-to-host {d2h:.2f} ms (its "
        f"copy out of the pinned staging buffer {copy_out:.2f} ms, the "
        f"same copy into arrays touched before {copy_into:.2f} ms), crc32 "
        f"{crc:.2f} ms, store.put {put:.2f} ms (its crc32 included)")
    log(f"lifecycle resume per lane: store.get + verify {get:.2f} ms, "
        f"host-to-device + install {install:.2f} ms")
    log(f"lifecycle disk tier: write {write:.2f} ms (put + flush), read "
        f"{read:.2f} ms (a new store's get + verify; ok {ok})")
    log(f"lifecycle recompute a swap saves: chunked prefill of 2000 tokens, "
        f"one lane, {prefill:.2f} ms")
    log(f"lifecycle decode step, batch 4, replayed: greedy "
        f"{greedy_ms:.3f} ms, sampled (T {TEMPERATURE}) {sampled_ms:.3f} ms "
        f"(+{(sampled_ms / greedy_ms - 1) * 100:.1f} %; turns greedy, "
        f"sampled, sampled, greedy: "
        f"{', '.join(f'{t:.3f}' for t in turns)})")
    check_lifecycle("disk read", {"disk slab not read back": int(not ok)})
    return times


def lifecycle_phase(parts=("float32", "bfloat16"), paths=("float32",)):
    """The lane lifecycle of trimkv-paper-4b at full width (36 layers,
    budget 512, chunks of 512, segments of 16, 4 lanes), sampled at
    T 0.8: threefry on the card against the CPU; then per dtype in
    ``parts`` a 12-request trace (poisson_requests seed 1, prompts
    64-2000, max_new 17-48) with each request's one-shot sampled run,
    the sampled stream phased and interleaved, the sampled decode
    program against its eager loop, and for the dtypes in ``paths``
    swap preemption, park / restart / revive and quarantine; in
    bfloat16 the times (lifecycle_times). Returns (the launches of the
    phase's runs, counted from 0 before it, the bfloat16 times or
    None)."""
    import gc
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import poisson_requests
    from repro_torch.serve.engine import build_engine
    threefry_on_card()
    ops.reset_launches()
    times = None
    for dtype in parts:
        cfg, model = lifecycle_model(dtype)
        eng = build_engine(cfg, model, device=model.device, budget=512,
                           prefill_chunk=512, decode_segment=16,
                           prefill_budget=1024, temperature=TEMPERATURE)
        reqs = poisson_requests(12, 8.0, vocab=cfg.vocab_size, prompt_lo=64,
                                prompt_hi=2000, new_lo=17, new_hi=48, seed=1)
        log(f"lifecycle {dtype} {cfg.num_layers} layers: prompts "
            f"{[r.prompt_len for r in reqs]}, max_new "
            f"{[r.max_new for r in reqs]}, T {TEMPERATURE}")
        oneshot = {r.rid: eng.generate(r.prompt[None], r.max_new,
                                       chunked=True, greedy=False,
                                       seed=r.seed) for r in reqs}
        sampled_stream(cfg, eng, reqs, oneshot, SAMPLED_MARGIN_TOL[dtype])
        sampled_program_vs_eager(eng, cfg)
        if dtype in paths:
            swap_preemption(cfg, eng, reqs, oneshot)
            park_and_recover(cfg, eng, reqs, oneshot)
            quarantine(cfg, eng, oneshot)
        if dtype == "bfloat16":
            times = lifecycle_times(cfg, eng)
        del eng, model, oneshot
        gc.collect()
        torch.cuda.empty_cache()
    total = dict(ops.LAUNCHES)
    path = ["decode_attention"] + [
        "chunk_attention" + ("" if d == "bfloat16" else "_f32")
        for d in parts]
    check_lifecycle("launches", {f"{k} never launched": int(total[k] == 0)
                                 for k in path})
    log(f"lifecycle launches: {total}")
    return total, times


# bf16 card-vs-CPU logits, as a share of the step's largest |logit|:
# card and CPU round to bf16 at different places in every projection,
# norm and residual add, and the tensor-core kernels round P to bf16
# before P.V. The floor of that gap is the card running the plain
# versions (plain_attention_on_card) on the same weights: 2.8e-2 and
# 3.4e-2 on the H100 (single-shot, chunked), the kernels' run 3.3e-2
# and 3.4e-2, a planted skipped key tile 0.66-0.79
# (launch/planted_faults.py; PERF.md). The limit sits between.
BF16_LOGIT_TOL = 5e-2


@contextlib.contextmanager
def plain_attention_on_card():
    """A control for the bf16 parity, never the main path: ops' three
    attention entry points call their plain versions on card tensors
    too, so card-vs-CPU gaps without the kernels can be read."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.chunk_attention import chunk_attention_torch
    from repro_torch.kernels.decode_attention import decode_attention_torch
    from repro_torch.kernels.retention_attention import (
        retention_attention_torch)

    def chunk(q, k_c, v_c, cache, chunk_pos, **kw):
        return chunk_attention_torch(q, k_c, v_c, cache["k"], cache["v"],
                                     cache["pos"], chunk_pos, **kw)

    saved = ops.decode_attention, ops.chunk_attention, ops.retention_attention
    ops.decode_attention = decode_attention_torch
    ops.chunk_attention = chunk
    ops.retention_attention = retention_attention_torch
    try:
        yield
    finally:
        (ops.decode_attention, ops.chunk_attention,
         ops.retention_attention) = saved


def slot_flips(a, b):
    """How two final states' caches differ, summed over layers: slots
    whose position differs slot by slot; positions kept in a and not in
    b; and where a's positions of the second kind sit: their keep score
    (t - pos) * log(beta) above the lowest kept score of their (lane,
    kv head), as a share of that row's score range (0 = at the eviction
    edge), the largest of them beside the median kept slot's."""
    import torch
    by_slot, edge, spread = 0, [], []
    t = a["t"].cpu().long()
    for la, lb_ in zip(a["layers"], b["layers"]):
        pa, pb = la["pos"].cpu().long(), lb_["pos"].cpu().long()
        by_slot += int((pa != pb).sum())
        kept = pa >= 0
        ls = (t[:, None, None] - pa).float() * torch.log(
            la["beta"].cpu().float().clamp(min=1e-30))
        lo = torch.where(kept, ls, torch.full_like(ls, math.inf)).amin(-1)
        hi = torch.where(kept, ls, torch.full_like(ls, -math.inf)).amax(-1)
        share = (ls - lo[..., None]) / (hi - lo).clamp(min=1e-30)[..., None]
        flipped = kept & ~(pa[..., :, None] == pb[..., None, :]).any(-1)
        edge.append(share[flipped])
        spread.append(share[kept])
    edge = torch.cat(edge)
    return {"by slot": by_slot, "kept": int(edge.numel()),
            "edge share": edge.max().item() if edge.numel() else 0.0,
            "median share": torch.cat(spread).median().item()}


def parity_phase(dtype="float32", policy="trimkv"):
    """Card (kernels) vs CPU (plain versions) on the full-width config
    cut to 2 layers, with one set of weights, after single-shot and
    after chunked prefill, 16 teacher-forced decode steps each, under
    the eviction ``policy``. float32: logits within 1e-3, identical
    greedy ids (the argmax of every step), every layer's aux within
    1e-3 and identical slot positions. bfloat16:
    logits within BF16_LOGIT_TOL of the step's largest |logit|, beside
    the same gap with the card on the plain versions (the rounding
    floor) and the kernels' gap to that; the slot positions that
    differ are counted and printed, not asserted (bf16 rounding of beta
    may flip a near-tie), with where the flipped slots' keep scores sit.
    Returns the launch counts of the card's kernel run and, per mode,
    the readings."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_batch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import build_engine

    cfg = dataclasses.replace(get_config("trimkv-paper-4b"), num_layers=2,
                              dtype=dtype)
    gpu = T.init_params(cfg, seed=3, device="cuda")
    T.init_gate_params(gpu, cfg, seed=4)
    perturb_gates(gpu, seed=5)
    cpu = copy.deepcopy(gpu).to("cpu")
    B, P, L, budget, chunk = 2, 200, 16, 64, 64
    tokens, _, _ = make_batch("copy", 1, B, P + L, cfg.vocab_size)
    n_chunks, nl = -(-P // chunk), cfg.num_layers
    sfx = "" if dtype == "bfloat16" else "_f32"
    expect = dict.fromkeys(ops.KERNELS, 0)
    expect.update({"retention_attention" + sfx: nl,
                   "chunk_attention" + sfx: nl * n_chunks,
                   "decode_attention": 2 * nl * L})
    sides = {"card": (gpu, "cuda", contextlib.nullcontext),
             "cpu": (cpu, "cpu", contextlib.nullcontext)}
    if dtype == "bfloat16":
        sides["plain on card"] = (gpu, "cuda", plain_attention_on_card)

    def run(chunked, model, device, ctx):
        """Logits [L, B, V] on the host and the final state."""
        steps = []
        with ctx(), torch.no_grad():
            eng = build_engine(cfg, model, device=device, budget=budget,
                               prefill_chunk=chunk, policy=policy)
            state = eng.prefill(tokens[:, :P], chunked=chunked)[0]
            for i in range(L):
                state, logits = T.decode_step(model, cfg, state,
                                              tokens[:, P + i], eng.policy)
                steps.append(logits.cpu().float())
        return torch.stack(steps), state

    def gap(a, b):
        """Largest |a - b| of a step (over the real vocabulary in bf16,
        where padded ids are masked) over that step's largest |b|."""
        if dtype == "float32":
            return (a - b).abs().max().item()
        a, b = a[..., :cfg.vocab_size], b[..., :cfg.vocab_size]
        return ((a - b).abs().amax((1, 2))
                / b.abs().amax((1, 2))).max().item()

    ops.reset_launches()
    readings = {}
    for chunked in (False, True):
        out = {}
        for side, (model, device, ctx) in sides.items():
            out[side] = run(chunked, model, device, ctx)
        (card, s_card), (host, s_host) = out["card"], out["cpu"]
        mode = "chunked" if chunked else "single-shot"
        err = gap(card, host)
        flips = slot_flips(s_host, s_card)
        if not torch.isfinite(card[..., :cfg.vocab_size]).all():
            raise AssertionError(f"{dtype} {mode}: non-finite logits")
        if dtype == "float32":
            label = f"parity float32 {policy} {mode}"
            ids_differ = int((card.argmax(-1) != host.argmax(-1)).sum())
            aux_err = max((a["aux"].cpu() - b["aux"]).abs().max().item()
                          for a, b in zip(s_card["layers"],
                                          s_host["layers"]))
            log(f"{label}: {L} teacher-forced steps, max |logit diff| "
                f"{err:.3e} (tol 1e-3), {ids_differ} greedy ids differ, "
                f"max |aux diff| {aux_err:.3e} (tol 1e-3), "
                f"{flips['by slot']} slot positions differ (all {nl} "
                f"layers)")
            if flips["by slot"]:
                raise AssertionError(f"{label}: {flips['by slot']} slot "
                                     f"positions differ card vs CPU")
            if not err <= 1e-3 or ids_differ or not aux_err <= 1e-3:
                raise AssertionError(f"{label}: logits differ by {err} "
                                     f"(tol 1e-3), {ids_differ} ids differ, "
                                     f"aux by {aux_err} (tol 1e-3)")
            continue
        plain, s_plain = out["plain on card"]
        r = {"kernels vs cpu": err, "plain on card vs cpu": gap(plain, host),
             "kernels vs plain on card": gap(card, plain),
             "flips kernels vs cpu": flips,
             "flips plain on card vs cpu": slot_flips(s_host, s_plain),
             "flips kernels vs plain on card": slot_flips(s_plain, s_card),
             "slots": sum(int(x["pos"].numel()) for x in s_host["layers"])}
        readings[mode] = r
        pairs = ", ".join(
            f"{k[6:]} {r[k]['by slot']} / {r[k]['kept']}" for k in
            ("flips kernels vs cpu", "flips plain on card vs cpu",
             "flips kernels vs plain on card"))
        log(f"parity bfloat16 {mode}: {L} teacher-forced steps, max |logit "
            f"diff| / max |logit|: card {r['kernels vs cpu']:.3e} (tol "
            f"{BF16_LOGIT_TOL}), plain versions on the card "
            f"{r['plain on card vs cpu']:.3e} (the floor), card kernels vs "
            f"plain on the card {r['kernels vs plain on card']:.3e}; of "
            f"{r['slots']} slots, differing slot by slot / positions kept "
            f"by one side only: {pairs}; those kept by the CPU only sit "
            f"at most {flips['edge share']:.3e} of their row's keep-score "
            f"range above its lowest kept score (median kept slot "
            f"{flips['median share']:.3e})")
        if not err <= BF16_LOGIT_TOL:
            raise AssertionError(f"bfloat16 {mode}: logits differ by {err} "
                                 f"of their scale (tol {BF16_LOGIT_TOL})")
    launches = dict(ops.LAUNCHES)       # the plain versions count none
    if launches != expect:
        raise AssertionError(f"parity {dtype}: launches {launches}, "
                             f"expected {expect}")
    return launches, readings


# ------------------------------------------------ cross-memory families

# the cross phase's one-shot shape: batch 4, prompt 1024, 32 new tokens,
# chunks of 512; llama-3.2-vision-90b is cut to 10 layers (2 units of
# its pattern, 2 cross layers: ~22 GB in bf16, where 100 layers take
# ~181 GB)
CROSS_SHAPE = dict(B=4, P=1024, N=32, chunk=512)
VISION_LAYERS = 10
# memory lengths of the one-shot batch: ragged, 2048-4096 frames and
# 801-1601 image tokens
CROSS_LENS = {"seamless-m4t-large-v2": [4096, 2048, 3001, 2500],
              "llama-3.2-vision-90b": [1601, 801, 1200, 1000]}
# teacher-forced logits under two memories must differ by more than
# this share of their largest magnitude: the cross path is live
MEMORY_GAP_MIN = 1e-2
# the cross streams hold each request's ids against its one-shot run up
# to the first step whose one-shot top-two margin is at most this many
# bf16 rounding steps of the largest logit (see MARGIN_TOL: a lane batch
# of 4 and a batch of 1 run other splits and cuBLAS kernels; the logits
# reach 4-8, where one step is 2**-5 and MARGIN_TOL's 0.02 admits exact
# ties only). On the H100 the 31 first divergences of eight sound
# streams (seven seamless, one vision) sat at 0 steps (21) or 1 step
# (10), never more; 2 leaves one step of room.
# This comparison catches little; what catches a wrong lane is
# cross_lanes_float32's exact check of the scheduler against one-shot
# runs in float32
CROSS_MARGIN_STEPS = 2


def check_cross(name, violations):
    """Raise unless every count of the cross phase is 0."""
    bad = {k: v for k, v in violations.items() if v}
    if bad:
        raise AssertionError(f"cross {name}: {bad}")


def cross_model(arch, dtype="bfloat16", num_layers=None, seed=20,
                device="cuda"):
    """A cross family at full width (num_layers cuts the decoder, and a
    2-layer cut keeps one cross layer: the vision pattern becomes
    (global, cross), the encoder 2 layers), seeded weights, gates and
    gate biases ~ U(2, 8), and every cross layer's xgate ~ U(0.5, 1.5)
    (0 at init, where the memory would change nothing). The phases
    that use it serve on the model's device (a CPU model rehearses them,
    counting no launch). Returns (cfg, model)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_config(arch), dtype=dtype)
    if num_layers is not None:
        cut = {"num_layers": num_layers}
        if num_layers == 2:
            cut.update(attn_pattern=("global", "cross")
                       if cfg.family == "vlm" else cfg.attn_pattern,
                       encoder_layers=min(cfg.encoder_layers, 2))
        cfg = dataclasses.replace(cfg, **cut)
    t0 = time.perf_counter()
    model = T.init_params(cfg, seed=seed, device=device)
    T.init_gate_params(model, cfg, seed=seed + 1)
    perturb_gates(model, seed=seed + 2)
    g = torch.Generator(device=device)
    g.manual_seed(seed + 3)
    for block in model.layers:
        if block.kind == "cross":
            block.xgate.copy_(0.5 + torch.rand((), generator=g,
                                               device=device))
    n_params = sum(p.numel() for p in model.parameters())
    log(f"cross: {cfg.name} {cfg.num_layers} decoder layers "
        f"({cfg.layer_kinds().count('cross')} cross), "
        f"{cfg.encoder_layers} encoder layers, {cfg.dtype}, "
        f"{n_params / 1e9:.3f} B parameters, init "
        f"{time.perf_counter() - t0:.1f} s")
    return cfg, model


def cross_memory(eng, B, seed, lens):
    """extra_inputs of B random memories (numpy, unit scale, as a vision
    tower's or speech encoder's embeddings run; the launcher's streams
    draw 0.1) padded to the family's S, with mem_len lens."""
    import numpy as np
    S, feat = eng.mem_shape
    rng = np.random.RandomState(seed)
    return {eng.mem_key: rng.randn(B, S, feat).astype(np.float32),
            "mem_len": np.asarray(lens, np.int32)}


def _device_ms(fn, n=3):
    """Median device time of fn() over n calls after a warm one (CUDA
    events on the current stream)."""
    import statistics
    import torch
    fn()
    ts = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        ts.append(start.elapsed_time(end))
    return statistics.median(ts)


def cross_admission_ms(eng, cfg, extra, tokens):
    """Where a chunked cross admission's device time goes (CUDA events,
    medians of 3, on the programs the one-shot calls captured): the
    whole chunked fused prefill (the packed memory's upload, the memory
    program, a chunk program replay a chunk), the memory program alone
    (the front end, encoder or vision projection, then every cross
    layer's memory K/V and its install), one chunk replay, and, timed
    alone at a chunk's shape, one cross layer's plain prefill
    cross-attention and one layer's chunk kernel."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import blocks
    from repro_torch.models import transformer as T
    model = eng.model
    if model.device.type == "cpu":
        return {}
    B, C = tokens.shape[0], CROSS_SHAPE["chunk"]
    n_chunks = -(-tokens.shape[1] // C)
    n_cross = cfg.layer_kinds().count("cross")
    launches = dict(ops.LAUNCHES)
    state = eng.prefill(tokens, chunked=True, extra_inputs=extra)[0]
    progs = eng._programs(B, eng.mem_shape[0])
    cache = {k: state["layers"][0][k].clone() for k in ("k", "v", "pos")}
    memory, mem_len = T.memory_from_inputs(model, cfg, extra)
    blk = next(b for b in model.layers if b.kind == "cross")
    xk, xv = blocks.make_memory_kv(blk.xattn, cfg, memory)
    x = torch.randn((B, C, cfg.d_model), device="cuda").to(memory.dtype)
    q = torch.randn((B, C, cfg.num_heads, cfg.head_dim),
                    device="cuda").to(memory.dtype)
    kc = torch.randn((B, C, cfg.num_kv_heads, cfg.head_dim),
                     device="cuda").to(memory.dtype)
    # a chunk after the prompt, over the prefill's full cache
    cpos = (tokens.shape[1] + torch.arange(C, device="cuda",
                                           dtype=torch.int32))[None].expand(
        B, C).contiguous()
    ms = {
        "prefill": _device_ms(lambda: eng.prefill(
            tokens, chunked=True, extra_inputs=extra)),
        "memory program": _device_ms(lambda: progs.program("memory").run()),
        "chunk program": _device_ms(lambda: progs.program("chunk").run()),
        "cross attention a layer": _device_ms(
            lambda: blocks.cross_attn_apply(blk.xattn, cfg, x, xk, xv,
                                            mem_len)),
        "chunk kernel a layer": _device_ms(lambda: ops.chunk_attention(
            q, kc, kc, cache, cpos, need_probs=False)),
    }
    ops.LAUNCHES.update(launches)        # timing is not the main path
    pre, chunk = ms["prefill"], ms["chunk program"]
    log(f"cross {cfg.name} admission (chunked fused prefill, batch {B}, "
        f"prompt {tokens.shape[1]}, memory lengths {extra['mem_len']}): "
        f"{pre:.2f} ms = memory program {ms['memory program']:.2f} ms "
        f"({ms['memory program'] / pre * 100:.1f} %) + {n_chunks} chunk "
        f"replays of {chunk:.2f} ms ({n_chunks * chunk / pre * 100:.1f} %) "
        f"+ the packed memory's upload and the rest; a chunk replay holds "
        f"{n_cross} cross attentions of "
        f"{ms['cross attention a layer']:.2f} ms "
        f"({n_cross * ms['cross attention a layer'] / chunk * 100:.1f} % of "
        f"it) and {cfg.num_layers} chunk kernels of "
        f"{ms['chunk kernel a layer']:.3f} ms "
        f"({cfg.num_layers * ms['chunk kernel a layer'] / chunk * 100:.1f} "
        f"%), timed alone")
    return ms


def cross_oneshot(arch, num_layers=None):
    """A cross family in bf16 at full width through Engine.generate
    (generate_pairs: single-shot and chunked, fused and eager, exact
    launch counts, graphs against eager), then the memory is shown live:
    the teacher-forced next-token logits of the same prompt under two
    memories differ by more than MEMORY_GAP_MIN of their scale. Returns
    (launch counts from 0 before the first call, the admission ms)."""
    import torch
    from repro_torch.data.synthetic import make_batch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import build_engine

    sh = CROSS_SHAPE
    cfg, model = cross_model(arch, num_layers=num_layers)
    eng = build_engine(cfg, model, device=model.device, budget=512,
                       prefill_chunk=sh["chunk"])
    tokens, _, _ = make_batch("copy", 0, sh["B"], sh["P"], cfg.vocab_size)
    extra = cross_memory(eng, sh["B"], 0, CROSS_LENS[arch])
    label = f"cross {cfg.name}"
    ops.reset_launches()
    results = generate_pairs(eng, cfg, tokens, label, extra_inputs=extra,
                             shape=sh)
    launches = dict(ops.LAUNCHES)
    other = cross_memory(eng, sh["B"], 1, CROSS_LENS[arch])
    logits = [T.compute_logits(model, cfg, eng.prefill(
        tokens, chunked=True, extra_inputs=e)[1]) for e in (extra, other)]
    gap = ((logits[0] - logits[1])[:, :cfg.vocab_size].abs().max()
           / logits[0][:, :cfg.vocab_size].abs().max()).item()
    log(f"{label}: teacher-forced logits under two memories differ by "
        f"{gap:.3e} of their largest magnitude (must exceed "
        f"{MEMORY_GAP_MIN}); graph pool "
        f"{(eng.graphs.bytes if eng.graphs else 0) / 2**20:.1f} MiB; "
        f"static decode state "
        f"{results['chunked fused']['state bytes'] / 2**20:.1f} MiB per "
        f"batch of {sh['B']}")
    check_cross(f"{cfg.name} memory", {
        "memory does not move the logits": int(not gap > MEMORY_GAP_MIN)})
    ms = cross_admission_ms(eng, cfg, extra, tokens)
    del eng, model, results, logits
    torch.cuda.empty_cache()
    return launches, ms


def cross_stream(arch, num_layers=None, modes=("phased", "interleaved"),
                 swap_times=False):
    """Continuous batching of a cross family in bf16 at full width: 4
    lanes, budget 512, chunks 512, segments 16, 8 requests from
    poisson_requests (seed 0, prompts 256-1024, max_new 16-48, 8
    requests/s, each with its own ragged memory), per mode: every
    request DONE with its max_new tokens, dispatch_count equal to the
    formula, the launches the steps imply (the decode kernel once per
    layer and cross layer a decode step, the chunk kernel once per layer
    a chunk), ids against each request's one-shot run (its memory padded
    to the family's S) up to CROSS_MARGIN_STEPS; prints output tok/s,
    TTFT p50 / p99 and TPOT p50. With swap_times,
    one lane is swapped out and resumed, timed. Returns the phased run's
    launch counts."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import poisson_requests
    from repro_torch.serve.engine import build_engine
    from repro_torch.serve.graphs import host_row_template
    from repro_torch.serve.prefix_cache import state_row_bytes
    from repro_torch.serve.request import Status, latency_percentiles
    from repro_torch.serve.scheduler import Scheduler, warm_up

    cfg, model = cross_model(arch, num_layers=num_layers, seed=30)
    L, lanes = cfg.num_layers, 4
    n_dec = L + cfg.layer_kinds().count("cross")
    eng = build_engine(cfg, model, device=model.device, budget=512,
                       prefill_chunk=512, decode_segment=16,
                       prefill_budget=1024, swap_preempt=False)
    reqs = poisson_requests(8, 8.0, vocab=cfg.vocab_size, prompt_lo=256,
                            prompt_hi=1024, new_lo=16, new_hi=48, seed=0,
                            mem_key=eng.mem_key, mem_shape=eng.mem_shape)
    name = f"{cfg.name} {L} layers"
    row = state_row_bytes(host_row_template(cfg, 512))
    log(f"cross stream {name}: {len(reqs)} requests, prompts "
        f"{[r.prompt_len for r in reqs]}, memories "
        f"{[r.extra_inputs[eng.mem_key].shape[0] for r in reqs]}, max_new "
        f"{[r.max_new for r in reqs]}; a bf16 lane row {row:,} B")
    # the one-shot references take the memory padded to the lanes' S
    # (mem_len marks it), so the decode kernel reads a slab of the lanes'
    # shape; a B = 1 batch and a lane batch of 4 still run other splits
    S, feat = eng.mem_shape
    oneshot = {}
    for r in reqs:
        m = r.extra_inputs[eng.mem_key]
        mem = np.zeros((1, S, feat), np.float32)
        mem[0, :m.shape[0]] = m
        oneshot[r.rid] = eng.generate(
            r.prompt[None], r.max_new, chunked=True,
            extra_inputs={eng.mem_key: mem,
                          "mem_len": np.array([m.shape[0]], np.int32)})
    # the margin limit: CROSS_MARGIN_STEPS bf16 rounding steps at the
    # largest |logit| of the one-shot runs (MARGIN_TOL admits one at
    # trimkv-paper-4b's logits below 4; these logits reach the next
    # binade, where one step is 2**-5)
    top = max(o["logits"][0, :cfg.vocab_size].abs().max().item()
              for o in oneshot.values())
    step = 2.0 ** (math.floor(math.log2(top)) - 7)
    tol = math.nextafter(CROSS_MARGIN_STEPS * step, math.inf)
    log(f"  one-shot largest |logit| {top:.3f}: one bf16 rounding step "
        f"{step:g}; margin limit {CROSS_MARGIN_STEPS} steps")
    for mode in modes:
        warm_up(eng, lanes, reqs, interleaved=mode == "interleaved")
    launches_phased = None
    for mode in modes:
        ops.reset_launches()
        eng.dispatch_count = 0
        sched = Scheduler(eng, n_lanes=lanes,
                          interleaved=mode == "interleaved")
        t0 = time.perf_counter()
        res = sched.run(reqs, respect_arrivals=True)
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        if mode == "phased":
            launches_phased = launches
        steps = sched.steps_run
        expect = dict.fromkeys(ops.KERNELS, 0)
        if eng.device.type == "cuda":      # the plain versions count none
            expect["decode_attention"] = n_dec * (steps["segment"]
                                                  + steps["mixed"])
            expect["chunk_attention"] = L * (steps["chunk"] + steps["mixed"])
        formula = sched.n_prefill_rounds + sched.n_segments + sched.n_resets
        margin, report = 0.0, []
        for r in reqs:
            ref = oneshot[r.rid]
            got = res[r.rid].tokens
            diff = first_divergence(got, ref["ids"][0].tolist())
            if diff is not None:
                m = float(ref["margins"][0][:diff + 1].min())
                margin = max(margin, m)
                report.append(f"{r.rid}: at {diff} of {len(got)} (smallest "
                              f"margin up to it {m:.3e})")
        violations = {
            "requests not DONE with max_new tokens": sum(
                res[r.rid].status is not Status.DONE
                or len(res[r.rid].tokens) != r.max_new for r in reqs),
            "dispatch_count off the formula": int(
                eng.dispatch_count != formula),
            "launches off the schedule": int(launches != expect),
            "lanes holding memory after the drain": sum(
                int((st["mem_len"] != 0).sum())
                for st in sched.lanes.state["layers"] if "mem_len" in st),
        }
        n_tok = sum(len(res[r.rid].tokens) for r in reqs)
        ttft = latency_percentiles([res[r.rid].ttft_sec for r in reqs])
        tpot = latency_percentiles([res[r.rid].tpot_sec for r in reqs])
        log(f"cross stream {name} {mode}: {n_tok} tokens in {wall:.3f} s = "
            f"{n_tok / wall:.1f} output tok/s; TTFT p50 "
            f"{ttft['p50'] * 1e3:.1f} ms p99 {ttft['p99'] * 1e3:.1f} ms; "
            f"TPOT p50 {tpot['p50'] * 1e3:.2f} ms; segments "
            f"{sched.n_segments}, prefill rounds {sched.n_prefill_rounds}, "
            f"dispatches {eng.dispatch_count} (formula {formula}); steps "
            f"{steps}; launches {launches}")
        log(f"  one-shot comparison: {len(report)} of {len(reqs)} requests "
            f"differ; margin reading {margin:.3e} (limit {tol}): "
            + ("; ".join(report) if report else "none"))
        check_stream(f"cross {name} {mode}", violations, margin, tol)
    if swap_times:
        sched = Scheduler(eng, n_lanes=lanes)
        r = reqs[0]
        sched.submit(dataclasses.replace(r, max_new=64))
        sched.step()
        lane = sched.results[r.rid].lane
        _sync(eng.device)
        t0 = time.perf_counter()
        sched._swap_out([lane])
        t1 = time.perf_counter()
        snap = sched.store.get(r.rid)
        sched.lanes.resume([lane], [snap.state], [snap.tok], [snap.key])
        _sync(eng.device)
        t2 = time.perf_counter()
        m = r.extra_inputs[eng.mem_key]
        mem = np.zeros((1, S, feat), np.float32)
        mem[0, :m.shape[0]] = m
        recompute = _median_ms(lambda: (eng.prefill(
            r.prompt[None], chunked=True, extra_inputs={
                eng.mem_key: mem,
                "mem_len": np.array([m.shape[0]], np.int32)}),
            _sync(eng.device)), 3)
        log(f"cross {name}: one lane's swap-out (extract, crc32, put) "
            f"{(t1 - t0) * 1e3:.2f} ms and resume (get + verify, install) "
            f"{(t2 - t1) * 1e3:.2f} ms for {row:,} B; a recompute (its "
            f"chunked prefill at batch 1, warm: the front end and "
            f"{r.prompt_len} prompt tokens) {recompute:.2f} ms")
        sched.close()
    del eng, model
    torch.cuda.empty_cache()
    return launches_phased


def cross_parity(cfg, gpu, cpu, policy):
    """float32 at 2 layers (one cross), one set of weights on the card
    (gpu: kernels) and on the CPU (cpu: plain versions), ragged
    memories, batch 2, prompt 96 over budget 64 (chunks of 64, the
    second ragged): after single-shot and after chunked prefill, 12
    teacher-forced decode steps under ``policy``: logits within 1e-3 and
    identical slot positions in every layer, exact launch counts.
    Returns the card's launch counts."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import build_engine

    B, P, L, budget, chunk = 2, 96, 12, 64, 64
    rng = __import__("numpy").random.RandomState(3)
    tokens = rng.randint(0, cfg.vocab_size, (B, P + L))
    nl = cfg.num_layers
    n_dec = nl + cfg.layer_kinds().count("cross")
    expect = dict.fromkeys(ops.KERNELS, 0)
    if gpu.device.type == "cuda":          # the plain versions count none
        expect.update({"retention_attention_f32": nl,
                       "chunk_attention_f32": nl * -(-P // chunk),
                       "decode_attention": 2 * n_dec * L})

    def run(chunked, model, device):
        steps = []
        eng = build_engine(cfg, model, device=device, budget=budget,
                           prefill_chunk=chunk, policy=policy)
        S = eng.mem_shape[0]
        extra = cross_memory(eng, B, 4, [S, S // 2 + 1])
        state = eng.prefill(tokens[:, :P], chunked=chunked,
                            extra_inputs=extra)[0]
        for i in range(L):
            state, logits = T.decode_step(model, cfg, state,
                                          torch.as_tensor(tokens[:, P + i]),
                                          eng.policy)
            steps.append(logits.cpu())
        return torch.stack(steps), state

    ops.reset_launches()
    for chunked in (False, True):
        with torch.no_grad():
            card, s_card = run(chunked, gpu, gpu.device)
            host, s_host = run(chunked, cpu, "cpu")
        err = (card - host).abs().max().item()
        flips = sum(int((a["pos"].cpu() != b["pos"]).sum())
                    for a, b in zip(s_card["layers"], s_host["layers"]))
        label = (f"cross parity {cfg.name} float32 {policy} "
                 f"{'chunked' if chunked else 'single-shot'}")
        log(f"{label}: {L} teacher-forced steps, max |logit diff| {err:.3e} "
            f"(tol 1e-3), {flips} slot positions differ")
        check_cross(label, {"logits beyond 1e-3": int(not err <= 1e-3),
                            "slot positions that differ": flips})
    launches = dict(ops.LAUNCHES)
    log(f"cross parity {cfg.name} float32 {policy}: launches {launches}")
    check_cross(f"parity {cfg.name} launches",
                {"launches off the count": int(launches != expect)})
    return launches


def cross_lanes_float32(cfg, model):
    """float32 at 2 layers on the card, the lane scheduler (priority, 2
    lanes, budget 64, chunks 64, segments 4): a trace whose third,
    better-ranked request swaps a decoding lane out, phased and
    interleaved: every request's ids equal its one-shot run, swaps and
    resumes happen, every lane reset after the drain holds mem_len 0 and
    reads zero memory; extract -> scrub -> resume bit-exact on every
    leaf (xk, xv and mem_len included); a scrubbed lane's slab all zero
    with its neighbour bit-identical; spec_k 2 ids equal to spec_k 0's.
    Counts must be 0 (check_cross). cfg, model: a cross family in
    float32 at 2 layers (cross_float32_model)."""
    import numpy as np
    import torch
    from repro_torch.models.blocks import _cross_attn_decode
    from repro_torch.serve.engine import build_engine
    from repro_torch.serve.request import Request
    from repro_torch.serve.scheduler import Scheduler

    dev = model.device
    serve = dict(device=dev, budget=64, prefill_chunk=64,
                 decode_segment=4, sched_policy="priority")
    eng = build_engine(cfg, model, **serve)
    S, feat = eng.mem_shape
    rng = np.random.RandomState(5)
    reqs = [Request(rid=i, prompt=rng.randint(0, cfg.vocab_size, n),
                    max_new=m, seed=i, priority=pr,
                    extra_inputs={eng.mem_key: rng.randn(s, feat).astype(
                        np.float32) * 0.1})
            for i, (n, m, pr, s) in enumerate([(150, 24, 0, S),
                                               (90, 20, 0, S // 2 + 3),
                                               (130, 8, 3, S - 7)])]
    oneshot = {r.rid: eng.generate(
        r.prompt[None], r.max_new, chunked=True,
        extra_inputs={eng.mem_key: r.extra_inputs[eng.mem_key][None]}
    )["ids"][0].tolist() for r in reqs}

    def drive(sched):
        sched.submit(reqs[0])
        sched.submit(reqs[1])
        sched.step()
        sched.submit(reqs[2])
        return {rid: rs.tokens for rid, rs in sched.run().items()}

    blk = next(b for b in model.layers if b.kind == "cross")
    violations = {}
    for interleaved in (False, True):
        mode = "interleaved" if interleaved else "phased"
        sched = Scheduler(eng, n_lanes=2, interleaved=interleaved)
        ids = drive(sched)
        cross = [st for st in sched.lanes.state["layers"] if "xk" in st]
        read = _cross_attn_decode(blk.xattn, cfg, torch.randn(
            (2, cfg.d_model), device=dev), cross[0],
            sched.lanes.state["t"])
        violations.update({
            f"{mode}: requests apart from their one-shot run": sum(
                ids[rid] != want for rid, want in oneshot.items()),
            f"{mode}: no swap": int(sched.n_swaps < 1
                                    or sched.n_resumes < 1),
            f"{mode}: reset lanes holding memory": sum(
                int((st["mem_len"] != 0).sum()) for st in cross),
            f"{mode}: reset lanes reading memory": int((read != 0).sum()),
        })
        spec = Scheduler(build_engine(cfg, model, spec_k=2, **serve),
                         n_lanes=2, interleaved=interleaved)
        violations[f"{mode}: spec_k 2 ids apart from spec_k 0"] = sum(
            a != ids[rid] for rid, a in drive(spec).items())
    # a lane mid-decode: extract / scrub / resume, then scrub one lane
    sched = Scheduler(eng, n_lanes=2)
    sched.submit(reqs[0])
    sched.submit(reqs[1])
    sched.step()
    lanes = sched.lanes
    violations["extract -> resume leaves apart"] = extract_resume_exact(lanes)
    before = [{k: v.clone() for k, v in st.items()}
              for st in lanes.state["layers"]]
    lanes.scrub(torch.tensor([True, False], device=dev))
    violations["scrubbed slab bytes not zero"] = sum(
        int(st[k][0].count_nonzero()) for st in lanes.state["layers"]
        for k in ("xk", "xv") if k in st)
    violations["neighbour leaves changed by the scrub"] = sum(
        int(not torch.equal(st[k][1], b[k][1]))
        for st, b in zip(lanes.state["layers"], before) for k in st)
    log(f"cross lanes {cfg.name} float32: {violations}")
    check_cross(f"lanes {cfg.name} float32", violations)
    del eng, sched, lanes
    torch.cuda.empty_cache()


def cross_float32_model(arch):
    """A cross family in float32 at 2 layers (one cross) on the card,
    for the parity runs and the lane checks: (cfg, model)."""
    return cross_model(arch, "float32", num_layers=2, seed=40)


def cross_phase():
    """The cross-memory families on the card: one-shot and streams in
    bf16 at full width (seamless-m4t-large-v2 at full depth,
    llama-3.2-vision-90b at VISION_LAYERS), then float32 at 2 layers
    (card vs CPU under trimkv and h2o, the lane scheduler). Returns the
    bf16 launch counts of its main paths (one-shot calls and phased
    streams) and the float32 ones of its parity runs."""
    import torch
    total = None

    def add(launches):
        nonlocal total
        total = dict(launches) if total is None else {
            k: total[k] + launches[k] for k in total}

    seamless, vision = "seamless-m4t-large-v2", "llama-3.2-vision-90b"
    with timed("cross seamless one-shot"):
        launches, _ = cross_oneshot(seamless)
        add(launches)
    with timed("cross seamless stream"):
        add(cross_stream(seamless, swap_times=True))
    with timed("cross vision one-shot"):
        launches, _ = cross_oneshot(vision, num_layers=VISION_LAYERS)
        add(launches)
    with timed("cross vision stream"):
        add(cross_stream(vision, num_layers=VISION_LAYERS,
                         modes=("phased",)))
    with timed("cross float32"):
        for arch in (seamless, vision):
            cfg, gpu = cross_float32_model(arch)
            cpu = copy.deepcopy(gpu).to("cpu")
            for policy in ("trimkv", "h2o"):
                add(cross_parity(cfg, gpu, cpu, policy))
            del cpu
            cross_lanes_float32(cfg, gpu)
            del gpu
            torch.cuda.empty_cache()
    return total


def dense_config_phase():
    """qwen2.5-14b at full width (GQA group 5, qkv biases drawn from
    N(0, 0.5): its init leaves them 0) cut to 4 layers, bf16, through
    Engine.generate (generate_pairs at CROSS_SHAPE: exact launches,
    graphs against eager). Returns its launch counts."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_batch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import build_engine

    cfg = dataclasses.replace(get_config("qwen2.5-14b"), num_layers=4)
    model = T.init_params(cfg, seed=60, device="cuda")
    T.init_gate_params(model, cfg, seed=61)
    perturb_gates(model, seed=62)
    g = torch.Generator(device="cuda")
    g.manual_seed(63)
    for block in model.layers:
        for lin in (block.attn.wq, block.attn.wk, block.attn.wv):
            lin.bias.copy_(0.5 * torch.randn(lin.bias.shape, generator=g,
                                             device="cuda"))
    sh = CROSS_SHAPE
    eng = build_engine(cfg, model, device="cuda", budget=512,
                       prefill_chunk=sh["chunk"])
    tokens, _, _ = make_batch("copy", 0, sh["B"], sh["P"], cfg.vocab_size)
    ops.reset_launches()
    generate_pairs(eng, cfg, tokens, f"{cfg.name} 4 layers", shape=sh)
    launches = dict(ops.LAUNCHES)
    del eng, model
    torch.cuda.empty_cache()
    return launches


def cross_kernel_phase(g):
    """The kernels at the cross families' shapes, each against its plain
    version and timed (CUDA events; the decode kernel in a CUDA graph)
    beside its bound and one scaled_dot_product_attention call: the bf16
    tensor-core retention and chunk kernels at head dim 64 with G 1
    (seamless-m4t-large-v2: Hq 16 = Hkv 16, B 4, T / C 512 and 1024, M
    512) over the tile edges (Tq 1, Tk 129, a ragged q tile, window 96,
    n_valid 1 / 64 / 65, the cache probabilities out, an empty cache),
    and at head dim 128 with G 8 (llama-3.2-vision-90b: Hq 64, Hkv 8);
    the decode kernel over memory slabs (the per-lane mem_len in place
    of pos, against the plain version at pos = memory_pos(mem_len, S),
    no in-flight token) at both families' S, G and D, with ragged
    mem_len including 0 (that lane reads exactly 0), in bf16 (row by
    row, ROW_TOL) and float32 (TOL). Returns {case: (ms, bound ms,
    bound by, plain ms, library ms)} of the timed cases."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.cache import memory_pos
    from repro_torch.kernels.chunk_attention import (chunk_attention_cuda,
                                                     chunk_attention_torch)
    from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                      decode_attention_torch)
    from repro_torch.kernels.retention_attention import (
        retention_attention_cuda, retention_attention_torch)

    bf = torch.bfloat16
    out = {}
    shapes = {"D 64, G 1": (16, 16, 64), "D 128, G 8": (64, 8, 128)}
    # retention (single-shot prefill of the decoder's self-attention)
    B = 4
    for shape, (Hq, Hkv, D) in shapes.items():
        for name, Tq, Tk, off, window, use_beta in (
                ("T 1024, causal", 1024, 1024, 0, 0, False),
                ("T 512, log_beta + window 96", 512, 512, 0, 96, True),
                ("Tq 1 at q_offset 1023", 1, 1024, 1023, 0, False),
                ("Tk 129", 129, 129, 0, 0, True),
                ("Tq 1023 at q_offset 1 (ragged q tile)", 1023, 1024, 1, 0,
                 False)):
            q = rnd(g, (B, Tq, Hq, D), bf)
            k, v = rnd(g, (B, Tk, Hkv, D), bf), rnd(g, (B, Tk, Hkv, D), bf)
            lb = (-torch.rand((B, Tk, Hkv), generator=g, device="cuda")
                  * 0.01 if use_beta else None)
            kw = dict(window=window, q_offset=off)
            check_case(f"retention bfloat16 {shape} {name}",
                       (retention_attention_cuda(q, k, v, lb, **kw),),
                       (retention_attention_torch(q, k, v, lb, **kw),),
                       "bfloat16")
        T = 1024
        q = rnd(g, (B, T, Hq, D), bf)
        k, v = rnd(g, (B, T, Hkv, D), bf), rnd(g, (B, T, Hkv, D), bf)
        G = Hq // Hkv
        qh, kh, vh = (q.transpose(1, 2).contiguous(),
                      k.transpose(1, 2).repeat_interleave(G, 1).contiguous(),
                      v.transpose(1, 2).repeat_interleave(G, 1).contiguous())
        n_flops = 4 * B * Hq * D * (T * (T + 1) // 2)
        b = bound_ms(2 * B * T * Hq * D * 2 + 2 * B * T * Hkv * D * 2,
                     n_flops)
        out[f"retention bf16 {shape}, B 4, T 1024"] = (
            time_ms(lambda i=0: retention_attention_cuda(q, k, v), 20), *b,
            time_ms(lambda i=0: retention_attention_torch(q, k, v), 3),
            time_ms(lambda i=0: F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True), 20))
        del q, k, v, qh, kh, vh
    # chunk (chunked prefill of the decoder's self-attention)
    M, t0 = 512, 1024
    for shape, (Hq, Hkv, D) in shapes.items():
        G = Hq // Hkv
        for C in (512, 1024):
            idx = torch.arange(C, device="cuda", dtype=torch.int32)

            def inputs(n_valid, empty, first=False, Mc=M):
                q = rnd(g, (B, C, Hq, D), bf)
                kc, vc = rnd(g, (B, C, Hkv, D), bf), rnd(g, (B, C, Hkv, D), bf)
                ck, cv = (rnd(g, (B, Hkv, Mc, D), bf),
                          rnd(g, (B, Hkv, Mc, D), bf))
                cpos = torch.randint(0, t0, (B, Hkv, Mc), generator=g,
                                     device="cuda", dtype=torch.int32)
                drop = torch.rand((B, Hkv, Mc), generator=g,
                                  device="cuda") < empty
                if first:
                    drop[:] = True
                cpos = torch.where(drop, torch.full_like(cpos, -1), cpos)
                nv = torch.tensor(n_valid, dtype=torch.int32, device="cuda")
                cp = torch.where(idx[None] < nv[:, None], t0 + idx[None],
                                 torch.full_like(idx[None], -1))
                return q, kc, vc, ck, cv, cpos, cp.contiguous()

            for name, nv, probs, empty, first, Mc in (
                    ("full cache", [C] * B, False, 0.0, False, M),
                    ("n_valid [1, 64, 65, C] + probs", [1, 64, 65, C], True,
                     0.2, False, M),
                    ("first chunk (empty cache) + probs", [C, 300, C, 17],
                     True, 0.0, True, M),
                    ("M 500 (ragged tile) + probs", [C] * B, True, 0.2,
                     False, 500)):
                args = inputs(nv, empty, first, Mc)
                n = 2 if probs else 1
                check_case(f"chunk bfloat16 {shape} C {C} {name}",
                           chunk_attention_cuda(*args, need_probs=probs)[:n],
                           chunk_attention_torch(*args, need_probs=probs)[:n],
                           "bfloat16")
            args = inputs([C] * B, 0.0)
            q, kc, vc, ck, cv, cpos, cp = args
            keys = torch.cat([ck, kc.transpose(1, 2)], 2).repeat_interleave(
                G, 1)
            vals = torch.cat([cv, vc.transpose(1, 2)], 2).repeat_interleave(
                G, 1)
            kpos = torch.cat([cpos, cp[:, None].expand(B, Hkv, C)], 2)
            vis = (kpos[:, :, None, :] >= 0) & (
                cp[:, None, :, None] - kpos[:, :, None, :] >= 0)
            mask = vis.repeat_interleave(G, 1)
            qh = q.transpose(1, 2).contiguous()
            n_bytes = (2 * B * C * Hq * D * 2 + 2 * B * C * Hkv * D * 2
                       + 2 * B * Hkv * M * D * 2 + B * Hkv * M * 4 + B * C * 4)
            b = bound_ms(n_bytes, 4 * D * G * int(vis.sum().item()))
            out[f"chunk bf16 {shape}, B 4, C {C}, M 512"] = (
                time_ms(lambda i=0: chunk_attention_cuda(
                    *args, need_probs=False), 20), *b,
                time_ms(lambda i=0: chunk_attention_torch(
                    *args, need_probs=False), 3),
                time_ms(lambda i=0: F.scaled_dot_product_attention(
                    qh, keys, vals, attn_mask=mask), 10))
            del args, keys, vals, mask, qh, vis
    # the decode kernel over memory slabs
    for shape, (Hq, Hkv, D), S, lens in (
            ("seamless", shapes["D 64, G 1"], 4096, [4096, 2048, 3001, 0]),
            ("vision", shapes["D 128, G 8"], 1601, [1601, 801, 1200, 0])):
        G = Hq // Hkv
        ml = torch.tensor(lens, dtype=torch.int32, device="cuda")
        pos = memory_pos(ml, S).expand(B, Hkv, S).contiguous()
        t = torch.zeros((B,), dtype=torch.int32, device="cuda")
        for dt in (bf, torch.float32):
            dn = str(dt).split(".")[1]
            q, xk, xv = (rnd(g, (B, Hq, D), dt), rnd(g, (B, Hkv, S, D), dt),
                         rnd(g, (B, Hkv, S, D), dt))
            got = decode_attention_cuda(q, xk, xv, None, t, mem_len=ml)
            check_case(f"decode {dn} memory slab {shape} (S {S}, mem_len "
                       f"{lens})", (got,),
                       (decode_attention_torch(q, xk, xv, pos, t),), dn)
            if got[3].count_nonzero():
                raise AssertionError(f"memory decode {shape}: the lane with "
                                     f"mem_len 0 reads memory")
        sets = [(rnd(g, (B, Hq, D), bf), rnd(g, (B, Hkv, S, D), bf),
                 rnd(g, (B, Hkv, S, D), bf)) for _ in range(4)]
        n_valid = int(sum(lens))
        n_bytes = (2 * B * Hq * D * 2 + 2 * Hkv * n_valid * D * 2
                   + 2 * B * 4)
        b = bound_ms(n_bytes, 4 * Hq * D * n_valid)
        mask = (pos >= 0).repeat_interleave(G, 1)[:, :, None]
        lib_in = [(q[:, :, None], xk.repeat_interleave(G, 1),
                   xv.repeat_interleave(G, 1)) for q, xk, xv in sets]
        out[f"decode memory slab {shape} (S {S}, Hq {Hq}, Hkv {Hkv}, "
            f"D {D}, mem_len {lens})"] = (
            time_graph_ms(lambda i=0: decode_attention_cuda(
                *sets[i % 4], None, t, mem_len=ml), 100), *b,
            time_ms(lambda i=0: decode_attention_torch(*sets[i % 4], pos, t),
                    10),
            time_graph_ms(lambda i=0: F.scaled_dot_product_attention(
                *lib_in[i % 4], attn_mask=mask), 100))
        del sets, lib_in
    torch.cuda.empty_cache()
    for case, (ms, b_ms, b_by, plain, lib) in out.items():
        log(f"  {case} timing: {ms:.4f} ms; bound {b_ms:.5f} ms ({b_by}); "
            f"plain {plain:.4f} ms; library {lib:.4f} ms")
    return out


# ---------------------------------------------------------------- moe

# The MoE family (granite-moe-3b-a800m, mixtral-8x7b). Expert capacity
# couples every row of an FFN call (the JAX package's _moe_apply, GShard
# top-k dispatch), so a lane's tokens depend on its neighbours' under
# drops: the bf16 streams are held against one-shot runs only at the
# no-drop capacity factor E / k, and the float32 runs hold the card
# against the CPU on the same requests, drop counts included.
MOE_SHAPE = dict(B=4, P=1024, N=32, chunk=512, budget=512)
# mixtral at full width is ~94 GB in bf16: 8 of its 32 layers (~24 GB),
# a prompt above its window of 4096 and a budget of 4096 (M = min(budget,
# window)), so the window binds in prefill and, once the oldest kept
# slots fall out of it, in decode
MIXTRAL_LAYERS = 8
MIXTRAL_SHAPE = dict(B=2, P=4500, N=16, chunk=1024, budget=4096)
MOE_TRAIN_LAYERS = 8


def check_moe(name, violations):
    """Raise unless every MoE count is 0."""
    bad = {k: v for k, v in violations.items() if v}
    if bad:
        raise AssertionError(f"moe {name}: {bad}")


def moe_model(arch, dtype="bfloat16", num_layers=None, seed=70,
              device="cuda"):
    """An MoE config at full width (num_layers cuts the depth), seeded
    weights, gates and gate biases ~ U(2, 8). Returns (cfg, model)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_config(arch), dtype=dtype)
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    t0 = time.perf_counter()
    model = T.init_params(cfg, seed=seed, device=device)
    T.init_gate_params(model, cfg, seed=seed + 1)
    perturb_gates(model, seed=seed + 2)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"moe: {cfg.name} {cfg.num_layers} layers {cfg.dtype}, "
        f"{cfg.num_experts} experts top {cfg.experts_per_token}, "
        f"{n_params / 1e9:.3f} B parameters, init "
        f"{time.perf_counter() - t0:.1f} s")
    return cfg, model


def zero_drops(model):
    """Set every MoE layer's drop counter to 0."""
    for block in model.layers:
        block.ffn.drops.zero_()


def layer_drops(model):
    return [int(block.ffn.drops) for block in model.layers]


def moe_oneshot(arch, num_layers=None, shape=MOE_SHAPE):
    """An MoE config in bf16 at full width through Engine.generate
    (generate_pairs: single-shot and chunked, fused and eager, exact
    launch counts, graphs against eager) at shape's budget; for a local
    layer, the kept slots whose position the last decode step's window
    masked, which must be above 0 (the window binds in decode). Returns
    (launch counts from 0 before the first call, cfg, model)."""
    import torch
    from repro_torch.data.synthetic import make_batch
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import build_engine

    cfg, model = moe_model(arch, num_layers=num_layers)
    eng = build_engine(cfg, model, device="cuda", budget=shape["budget"],
                       prefill_chunk=shape["chunk"])
    tokens, _, _ = make_batch("copy", 0, shape["B"], shape["P"],
                              cfg.vocab_size)
    label = f"moe {cfg.name} {cfg.num_layers} layers"
    ops.reset_launches()
    results = generate_pairs(eng, cfg, tokens, label, shape=shape)
    launches = dict(ops.LAUNCHES)
    if cfg.window:
        t = shape["P"] + shape["N"] - 1          # the last decode step
        for mode in ("single-shot fused", "chunked fused"):
            pos = results[mode]["pos"]
            out = sum(int(((p >= 0) & (t - p >= cfg.window)).sum())
                      for p in pos)
            log(f"{label} {mode}: {out} of {sum(p.numel() for p in pos)} "
                f"kept slots at positions the window {cfg.window} masked "
                f"in the last decode step (t {t})")
            check_moe(f"{label} {mode}", {"window never binds": int(not out)})
    log(f"{label}: graph pool {eng.graphs.bytes / 2**20:.1f} MiB; static "
        f"decode state {results['chunked fused']['state bytes'] / 2**20:.1f}"
        f" MiB per batch of {shape['B']}")
    del eng, results
    torch.cuda.empty_cache()
    return launches, cfg, model


def moe_stream(cfg, model, n_requests=8, modes=("phased", "interleaved"),
               no_drop=False):
    """Continuous batching of an MoE config in bf16: 4 lanes, budget
    512, chunks 512, segments 16, n_requests from poisson_requests (seed
    0, prompts 256-1024, max_new 16-48, 8 requests/s), per mode: every
    request DONE with its max_new tokens, dispatch_count on the formula,
    the launches the steps imply; prints output tok/s, TTFT p50 / p99,
    TPOT p50, dispatches and the FFN calls' dropped choices. With
    no_drop the capacity factor is E / k (a choice is never dropped, so
    a lane's tokens do not depend on its neighbours) and every
    request's ids are held against its one-shot run under the streams'
    margin rule: up to the one-shot's first near tie, CROSS_MARGIN_STEPS
    bf16 rounding steps at its largest |logit| (MARGIN_TOL's 0.02 is one
    step below 4; granite's logits reach the next binade). That limit
    admits what bf16 batch-4 and batch-1 GEMMs round apart; the gate for
    a wrong lane is moe_parity's exact float32 ids, card against CPU, and
    planted_faults --moe reads this limit against two lane faults.
    Returns the phased run's launch counts."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import poisson_requests
    from repro_torch.serve.engine import build_engine
    from repro_torch.serve.request import Status, latency_percentiles
    from repro_torch.serve.scheduler import Scheduler, warm_up

    if no_drop:
        cfg = dataclasses.replace(
            cfg, moe_capacity_factor=cfg.num_experts / cfg.experts_per_token)
    L, lanes, tol = cfg.num_layers, 4, math.inf
    eng = build_engine(cfg, model, device="cuda", budget=512,
                       prefill_chunk=512, decode_segment=16,
                       prefill_budget=1024, swap_preempt=False)
    reqs = poisson_requests(n_requests, 8.0, vocab=cfg.vocab_size,
                            prompt_lo=256, prompt_hi=1024, new_lo=16,
                            new_hi=48, seed=0)
    name = (f"{cfg.name} {L} layers, capacity factor "
            f"{cfg.moe_capacity_factor:g}")
    log(f"moe stream {name}: {len(reqs)} requests, prompts "
        f"{[r.prompt_len for r in reqs]}, max_new "
        f"{[r.max_new for r in reqs]}")
    oneshot = ({r.rid: eng.generate(r.prompt[None], r.max_new, chunked=True)
                for r in reqs} if no_drop else {})
    if no_drop:
        top = max(o["logits"][0, :cfg.vocab_size].abs().max().item()
                  for o in oneshot.values())
        step = 2.0 ** (math.floor(math.log2(top)) - 7)
        tol = math.nextafter(CROSS_MARGIN_STEPS * step, math.inf)
        log(f"  one-shot largest |logit| {top:.3f}: one bf16 rounding step "
            f"{step:g}; margin limit {CROSS_MARGIN_STEPS} steps")
    for mode in modes:
        warm_up(eng, lanes, reqs, interleaved=mode == "interleaved")
    launches_phased = None
    for mode in modes:
        ops.reset_launches()
        zero_drops(model)
        eng.dispatch_count = 0
        sched = Scheduler(eng, n_lanes=lanes,
                          interleaved=mode == "interleaved")
        t0 = time.perf_counter()
        res = sched.run(reqs, respect_arrivals=True)
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        if mode == "phased":
            launches_phased = launches
        steps = sched.steps_run
        expect = dict.fromkeys(ops.KERNELS, 0)
        expect["decode_attention"] = L * (steps["segment"] + steps["mixed"])
        expect["chunk_attention"] = L * (steps["chunk"] + steps["mixed"])
        formula = sched.n_prefill_rounds + sched.n_segments + sched.n_resets
        margin, report = 0.0, []
        for rid, ref in oneshot.items():
            got = res[rid].tokens
            diff = first_divergence(got, ref["ids"][0].tolist())
            if diff is not None:
                m = float(ref["margins"][0][:diff + 1].min())
                margin = max(margin, m)
                report.append(f"{rid}: at {diff} of {len(got)} (smallest "
                              f"margin up to it {m:.3e})")
        drops = layer_drops(model)
        violations = {
            "requests not DONE with max_new tokens": sum(
                res[r.rid].status is not Status.DONE
                or len(res[r.rid].tokens) != r.max_new for r in reqs),
            "dispatch_count off the formula": int(
                eng.dispatch_count != formula),
            "launches off the schedule": int(launches != expect),
            "drops at the no-drop factor": sum(drops) if no_drop else 0,
        }
        n_tok = sum(len(res[r.rid].tokens) for r in reqs)
        ttft = latency_percentiles([res[r.rid].ttft_sec for r in reqs])
        tpot = latency_percentiles([res[r.rid].tpot_sec for r in reqs])
        log(f"moe stream {name} {mode}: {n_tok} tokens in {wall:.3f} s = "
            f"{n_tok / wall:.1f} output tok/s; TTFT p50 "
            f"{ttft['p50'] * 1e3:.1f} ms p99 {ttft['p99'] * 1e3:.1f} ms; "
            f"TPOT p50 {tpot['p50'] * 1e3:.2f} ms; segments "
            f"{sched.n_segments}, prefill rounds {sched.n_prefill_rounds}, "
            f"dispatches {eng.dispatch_count} (formula {formula}); steps "
            f"{steps}; dropped choices by layer (the warm-up excluded) "
            f"{drops}; launches {launches}")
        if no_drop:
            log(f"  one-shot comparison: {len(report)} of {len(reqs)} "
                f"requests differ; margin reading {margin:.3e} (limit "
                f"{tol}): " + ("; ".join(report) if report else "none"))
        check_stream(f"moe {name} {mode}", violations, margin, tol)
        sched.close()
    del eng
    torch.cuda.empty_cache()
    return launches_phased


def moe_parity(arch, num_layers):
    """float32 at full width cut to num_layers, one set of weights on the
    card (kernels) and on the CPU (plain versions): the lane scheduler
    (3 lanes, budget 64, chunks 64, segments 4, priority order, swap
    preemption) drains the same 5 requests (prompts 40-150; after the
    first step a better-ranked one arrives, which swaps a decoding lane
    out, and one more), phased and interleaved, on both (traced_drain):
    ids exact, slot positions equal after every step, logits within TOL
    of the largest |logit|, and every layer's dropped choices equal on
    both and above 0 (the drop order held on the card). Returns the
    card's launch counts."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import build_engine
    from repro_torch.serve.request import Request

    cfg, gpu = moe_model(arch, "float32", num_layers=num_layers, seed=80)
    cpu = copy.deepcopy(gpu).to("cpu")
    rng = np.random.RandomState(6)
    reqs = [Request(rid=i, prompt=rng.randint(0, cfg.vocab_size, n),
                    max_new=m, seed=i, priority=pr)
            for i, (n, m, pr) in enumerate([(150, 12, 0), (97, 10, 0),
                                            (64, 9, 0), (40, 6, 3),
                                            (120, 5, 0)])]
    serve = dict(budget=64, prefill_chunk=64, decode_segment=4,
                 sched_policy="priority")
    L = cfg.num_layers
    total = dict.fromkeys(ops.KERNELS, 0)
    for mode, kw in (("phased", {}), ("interleaved", {"interleaved": True})):
        runs, drops = {}, {}
        for dev, model in (("cuda", gpu), ("cpu", cpu)):
            zero_drops(model)
            eng = build_engine(cfg, model, device=dev, **serve)
            ops.reset_launches()
            with torch.no_grad():
                runs[dev] = traced_drain(eng, 3, reqs[:3], kw, reqs[3:])
            drops[dev] = layer_drops(model)
            if dev == "cuda":
                launches = dict(ops.LAUNCHES)
                total = {k: total[k] + launches[k] for k in total}
            del eng
        res, trace = runs["cuda"]
        runs["cuda"] = res, [([p.cpu() for p in pos], logits.cpu(),
                              [a.cpu() for a in aux])
                             for pos, logits, aux in trace]
        twins = twin_readings(runs["cuda"], runs["cpu"], cfg.vocab_size)
        label = f"moe parity {cfg.name} {L} layers float32 {mode}"
        log(f"{label}: card vs CPU over {len(runs['cpu'][1])} scheduler "
            f"steps: {twins['ids differ']} requests' ids and "
            f"{twins['slot positions differ']} slot positions differ, "
            f"logits |diff| / max |logit| {twins['logit gap']:.3e} (tol "
            f"{TOL['float32']}); dropped choices by layer: card "
            f"{drops['cuda']}, CPU {drops['cpu']}; card launches {launches}")
        check_moe(label, {
            "requests whose ids differ": twins["ids differ"],
            "slot positions that differ": twins["slot positions differ"],
            "logits beyond TOL": int(not twins["logit gap"]
                                     <= TOL["float32"]),
            "layers whose drops differ": sum(
                a != b for a, b in zip(drops["cuda"], drops["cpu"])),
            "layers without a drop": sum(d == 0 for d in drops["cpu"]),
            "no launch on the card": int(not launches["decode_attention"]
                                         or not launches[
                                             "chunk_attention_f32"]),
        })
    del cpu, gpu
    torch.cuda.empty_cache()
    return total


def moe_train():
    """Three distillation steps of granite-moe-3b-a800m at full width cut
    to MOE_TRAIN_LAYERS, bf16, batch 1 x 2048 tokens, M 256: exact
    capacity-kernel launches, finite loss terms, cap > 0, the gates
    moved and every base weight (the experts and routers included)
    bit-identical. Returns the launch counts."""
    import torch
    from repro_torch.configs import TrainConfig
    from repro_torch.data.pipeline import DataConfig, batches
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.train import distill

    cfg, model = moe_model("granite-moe-3b-a800m",
                           num_layers=MOE_TRAIN_LAYERS, seed=90)
    B, Tn, steps = 1, 2048, 3
    train_cfg = TrainConfig(seq_len=Tn, capacity_M=256, lambda_cap=1.0)
    gates = T.gate_parameters(model)
    gate_ids = {id(p) for p in gates}
    base = [p for p in model.parameters() if id(p) not in gate_ids]
    base0 = [p.cpu() for p in base]
    gates0 = [p.clone() for p in gates]
    state, opt_cfg = distill.make_train_state(cfg, train_cfg, model)
    data = batches(DataConfig(batch=B, seq_len=Tn))
    L = cfg.num_layers
    expect = dict.fromkeys(ops.KERNELS, 0)
    expect.update(capacity_loss=2 * L * steps, capacity_loss_bwd=L * steps)
    ops.reset_launches()
    secs = []
    for _ in range(steps):
        b = next(data)
        batch = {k: torch.as_tensor(b[k], device="cuda")
                 for k in ("tokens", "lm_labels")}
        t0 = time.perf_counter()
        state, m = distill.train_step(state, batch, cfg=cfg,
                                      train_cfg=train_cfg, opt_cfg=opt_cfg)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        m = {k: float(v) for k, v in m.items()}
        if not all(math.isfinite(v) for v in m.values()) or m["cap"] <= 0:
            raise AssertionError(f"moe train step {len(secs) - 1}: {m}")
        log(f"moe train step {len(secs) - 1}: {secs[-1]:.3f} s, loss "
            f"{m['loss']:.4f} kl {m['kl']:.4e} ntp {m['ntp']:.4f} cap "
            f"{m['cap']:.4f} grad_norm {m['grad_norm']:.4e}")
    launches = dict(ops.LAUNCHES)
    moved = max((p - q).abs().max().item() for p, q in zip(gates, gates0))
    check_moe("train", {
        "launches off the count": int(launches != expect),
        "base weights changed": sum(not torch.equal(p.cpu(), q)
                                    for p, q in zip(base, base0)),
        "gates unmoved": int(not moved > 0)})
    step_s = sum(secs[1:]) / (steps - 1)
    log(f"moe train: {cfg.name} {L} layers {cfg.dtype}, batch {B} x {Tn}, "
        f"M {train_cfg.capacity_M}: launches {launches}; {step_s:.3f} s per "
        f"step after the first = {B * Tn / step_s:.1f} train tokens/s; "
        f"largest gate change {moved:.3e}")
    del state, model, base, base0, gates, gates0
    torch.cuda.empty_cache()
    return launches


def moe_reference(ffn, x, cfg):
    """The JAX package's _moe_apply transcribed op by op, independent of
    blocks.moe_apply: per group, a loop over the top-k columns with an
    int32 cumsum each (the counts carried), one-hot dispatch and combine
    tensors [g, E, cap] in the weight dtype, einsums for the experts, the
    combine summed in float32. Ties in the router are left to
    torch.topk: the inputs here are random. Returns (out [S, d] in
    x.dtype, keep [S, k])."""
    import numpy as np
    import torch
    F = torch.nn.functional
    E, k = cfg.num_experts, cfg.experts_per_token
    xf = x.reshape(-1, x.shape[-1])
    S = xf.shape[0]
    group = min(2048, S)
    n_groups = S // group if S % group == 0 else 1
    if S % group != 0:
        group = S
    cap = max(int(np.ceil(group * k / E * cfg.moe_capacity_factor)), k)
    probs = torch.softmax(xf.float() @ ffn.router, dim=-1)
    top_vals, top_idx = torch.topk(probs, k)
    top_vals = top_vals / top_vals.sum(dim=-1, keepdim=True)
    wd = ffn.gate_w.dtype
    outs, keeps = [], []
    for gi in range(n_groups):
        rows = slice(gi * group, (gi + 1) * group)
        ti, tv, xg = top_idx[rows], top_vals[rows], xf[rows]
        counts = torch.zeros((E,), dtype=torch.int32, device=x.device)
        disp = torch.zeros((group, E, cap), dtype=wd, device=x.device)
        comb = torch.zeros_like(disp)
        keep = []
        for j in range(k):
            oh = F.one_hot(ti[:, j], E).to(torch.int32)
            pos = torch.cumsum(oh, dim=0, dtype=torch.int32) - 1 + counts
            ok = (pos < cap) & (oh > 0)
            pos_oh = F.one_hot(torch.where(ok, pos, cap).long(),
                               cap + 1)[..., :cap].to(wd)
            sel = (oh * ok).to(wd)[..., None] * pos_oh
            disp = disp + sel
            comb = comb + sel * tv[:, j][:, None, None].to(wd)
            counts = counts + oh.sum(dim=0, dtype=torch.int32)
            keep.append(ok.any(dim=-1))
        xin = torch.einsum("gec,gd->ecd", disp, xg.to(wd))
        h = F.silu(torch.einsum("ecd,edf->ecf", xin, ffn.gate_w))
        u = torch.einsum("ecd,edf->ecf", xin, ffn.up_w)
        eo = torch.einsum("ecf,efd->ecd", h * u, ffn.down_w)
        outs.append(torch.einsum("gec,ecd->gd", comb.float(),
                                 eo.float()).to(x.dtype))
        keeps.append(torch.stack(keep, dim=1))
    return torch.cat(outs), torch.cat(keeps)


def moe_apply_phase():
    """blocks.moe_apply on the card against moe_reference (the JAX
    package's op-by-op form), float32, one full-width layer of each MoE
    config with seeded weights, over a decode step of 4 lanes (3 of them
    alike, so mixtral's capacity 2 drops), a chunk of 4 x 64 at the
    config's capacity factor and at 0.5 (drops forced) and 2 x 2048 (two
    groups): out within TOL (|diff| <= TOL * (1 + |value|)) and the keep
    masks equal; the drops counted. Counts must be 0 (check_moe)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import blocks

    violations = {}
    for arch in ("granite-moe-3b-a800m", "mixtral-8x7b"):
        base = dataclasses.replace(get_config(arch), dtype="float32")
        g = torch.Generator(device="cuda")
        g.manual_seed(100)
        ffn = blocks.MoE(base, dtype=torch.float32, device="cuda",
                         generator=g)
        d = base.d_model
        for name, shape, factor in (
                ("decode 4 lanes", (4, 1, d), base.moe_capacity_factor),
                ("chunk 4 x 64", (4, 64, d), base.moe_capacity_factor),
                ("chunk 4 x 64, factor 0.5", (4, 64, d), 0.5),
                ("2 x 2048 (two groups)", (2, 2048, d),
                 base.moe_capacity_factor)):
            cfg = dataclasses.replace(base, moe_capacity_factor=factor)
            x = torch.randn(shape, generator=g, device="cuda")
            if shape[1] == 1:
                x[1:3] = x[0]
            with torch.no_grad():
                got, _, keep = blocks.moe_apply(ffn, x, cfg,
                                                return_keep=True)
                want, want_keep = moe_reference(ffn, x, cfg)
            got = got.reshape(want.shape)
            err = ((got - want).abs() / (1 + want.abs())).max().item()
            flips = int((keep.reshape(want_keep.shape) != want_keep).sum())
            log(f"  moe_apply {arch} float32 {name}: |diff| / (1 + |value|)"
                f" {err:.3e} (tol {TOL['float32']}), keep flips {flips}, "
                f"drops {int((~want_keep).sum())} of {want_keep.numel()}")
            label = f"{arch} {name}"
            violations[f"{label}: out beyond TOL"] = int(
                not err <= TOL["float32"])
            violations[f"{label}: keep flips"] = flips
        del ffn
    torch.cuda.empty_cache()
    check_moe("moe_apply vs reference", violations)


def moe_kernel_phase(g):
    """The attention kernels at granite-moe-3b-a800m's shape, head dim 64
    with GQA group 3 (Hq 24, Hkv 8; the float32 chunk kernel packs
    row_plan(C, 3) = 42 positions, 126 of its 128 rows, a CTA), each
    against its plain version: retention (T 1024 causal, window 96 with
    log_beta, a ragged q tile), chunk (C 512, M 512: full cache, n_valid
    1 / 64 / 65 / C with probs) and decode (M 512, a window), bf16 row
    by row and float32 element by element."""
    import torch
    from repro_torch.kernels.chunk_attention import (chunk_attention_cuda,
                                                     chunk_attention_torch)
    from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                      decode_attention_torch)
    from repro_torch.kernels.retention_attention import (
        retention_attention_cuda, retention_attention_torch)

    B, Hq, Hkv, D, M, C, t0 = 4, 24, 8, 64, 512, 512, 1024
    for dt in (torch.bfloat16, torch.float32):
        dn = str(dt).split(".")[1]
        for name, Tq, Tk, off, window, use_beta in (
                ("T 1024, causal", 1024, 1024, 0, 0, False),
                ("T 512, log_beta + window 96", 512, 512, 0, 96, True),
                ("Tq 1023 at q_offset 1", 1023, 1024, 1, 0, False)):
            q = rnd(g, (B, Tq, Hq, D), dt)
            k, v = rnd(g, (B, Tk, Hkv, D), dt), rnd(g, (B, Tk, Hkv, D), dt)
            lb = (-torch.rand((B, Tk, Hkv), generator=g, device="cuda")
                  * 0.01 if use_beta else None)
            kw = dict(window=window, q_offset=off)
            check_case(f"retention {dn} D 64, G 3 {name}",
                       (retention_attention_cuda(q, k, v, lb, **kw),),
                       (retention_attention_torch(q, k, v, lb, **kw),), dn)
        idx = torch.arange(C, device="cuda", dtype=torch.int32)
        for name, nv, probs in (("full cache", [C] * B, False),
                                ("n_valid [1, 64, 65, C] + probs",
                                 [1, 64, 65, C], True)):
            q = rnd(g, (B, C, Hq, D), dt)
            kc, vc = rnd(g, (B, C, Hkv, D), dt), rnd(g, (B, C, Hkv, D), dt)
            ck, cv = rnd(g, (B, Hkv, M, D), dt), rnd(g, (B, Hkv, M, D), dt)
            cpos = torch.randint(0, t0, (B, Hkv, M), generator=g,
                                 device="cuda", dtype=torch.int32)
            nvt = torch.tensor(nv, dtype=torch.int32, device="cuda")
            cp = torch.where(idx[None] < nvt[:, None], t0 + idx[None],
                             torch.full_like(idx[None], -1)).contiguous()
            args = (q, kc, vc, ck, cv, cpos, cp)
            n = 2 if probs else 1
            check_case(f"chunk {dn} D 64, G 3 C {C} {name}",
                       chunk_attention_cuda(*args, need_probs=probs)[:n],
                       chunk_attention_torch(*args, need_probs=probs)[:n],
                       dn)
        for name, window in (("M 512", 0), ("M 512, window 300", 300)):
            t = torch.tensor([t0, t0 + 7, 600, 900], dtype=torch.int32,
                             device="cuda")
            q = rnd(g, (B, Hq, D), dt)
            ck, cv = rnd(g, (B, Hkv, M, D), dt), rnd(g, (B, Hkv, M, D), dt)
            cpos = torch.randint(0, 600, (B, Hkv, M), generator=g,
                                 device="cuda", dtype=torch.int32)
            kn, vn = rnd(g, (B, Hkv, D), dt), rnd(g, (B, Hkv, D), dt)
            kw = dict(window=window, new_kv=(kn, vn))
            check_case(f"decode {dn} D 64, G 3 {name}",
                       (decode_attention_cuda(q, ck, cv, cpos, t, **kw),),
                       (decode_attention_torch(q, ck, cv, cpos, t, **kw),),
                       dn)
    torch.cuda.empty_cache()


def mixtral_kernel_cases(g):
    """The attention kernels at mixtral-8x7b's main-path shape
    (MIXTRAL_SHAPE: B 2, a prompt of 4500 in chunks of 1024, M =
    min(budget, window) = 4096; D 128, Hq 32, Hkv 8, G 4, every layer
    local with window 4096), where the window binds, each against its
    plain version in bf16 (row by row, ROW_TOL) and float32 (TOL):
    retention over the whole prompt with log_beta; chunk at the
    prompt's last chunk (t0 4096, n_valid [404, C], the cache holding
    positions 0..4095 in shuffled slots, probs out) and at t0 8192 over
    random older positions; decode at lane clocks 4515 and 7000 over
    random positions below them (a share empty) with the new token.
    Each case's count of (query, key) pairs the window masks among the
    causally visible ones must be above 0 (check_moe)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.chunk_attention import (chunk_attention_cuda,
                                                     chunk_attention_torch)
    from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                      decode_attention_torch)
    from repro_torch.kernels.retention_attention import (
        retention_attention_cuda, retention_attention_torch)

    cfg, sh = get_config("mixtral-8x7b"), MIXTRAL_SHAPE
    B, P, C, W = sh["B"], sh["P"], sh["chunk"], cfg.window
    Hq, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    M = min(sh["budget"], W)
    label = f"D {D}, G {Hq // Hkv}, window {W}"
    binds = {}
    for dt in (torch.bfloat16, torch.float32):
        dn = str(dt).split(".")[1]
        q = rnd(g, (B, P, Hq, D), dt)
        k, v = rnd(g, (B, P, Hkv, D), dt), rnd(g, (B, P, Hkv, D), dt)
        lb = -torch.rand((B, P, Hkv), generator=g, device="cuda") * 0.01
        name = f"retention {dn} {label} T {P}"
        check_case(name,
                   (retention_attention_cuda(q, k, v, lb, window=W),),
                   (retention_attention_torch(q, k, v, lb, window=W),), dn)
        binds[name] = (P - W) * (P - W + 1) // 2
        del q, k, v, lb
        torch.cuda.empty_cache()
        idx = torch.arange(C, device="cuda", dtype=torch.int32)
        for t0, nv, probs in ((C * (P // C), [P % C, C], True),
                              (8192, [C] * B, False)):
            q = rnd(g, (B, C, Hq, D), dt)
            kc, vc = rnd(g, (B, C, Hkv, D), dt), rnd(g, (B, C, Hkv, D), dt)
            ck, cv = rnd(g, (B, Hkv, M, D), dt), rnd(g, (B, Hkv, M, D), dt)
            if t0 == M:                  # every position below t0, once
                cpos = torch.rand((B, Hkv, M), generator=g,
                                  device="cuda").argsort(-1)
            else:
                cpos = torch.randint(0, t0, (B, Hkv, M), generator=g,
                                     device="cuda")
            cpos = cpos.to(torch.int32)
            nvt = torch.tensor(nv, dtype=torch.int32, device="cuda")
            cp = torch.where(idx[None] < nvt[:, None], t0 + idx[None],
                             torch.full_like(idx[None], -1)).contiguous()
            args = (q, kc, vc, ck, cv, cpos, cp)
            n = 2 if probs else 1
            name = (f"chunk {dn} {label} C {C} M {M} at t0 {t0}, n_valid "
                    f"{nv}" + (" + probs" if probs else ""))
            check_case(name,
                       chunk_attention_cuda(*args, window=W,
                                            need_probs=probs)[:n],
                       chunk_attention_torch(*args, window=W,
                                             need_probs=probs)[:n], dn)
            dist = cp[:, None, :, None] - cpos[:, :, None, :]
            binds[name] = int(((cp[:, None, :, None] >= 0)
                               & (dist >= W)).sum())
            del q, kc, vc, ck, cv, args, dist
        t = torch.tensor([P + sh["N"] - 1, 7000], dtype=torch.int32,
                         device="cuda")
        q = rnd(g, (B, Hq, D), dt)
        ck, cv = rnd(g, (B, Hkv, M, D), dt), rnd(g, (B, Hkv, M, D), dt)
        cpos = (torch.rand((B, Hkv, M), generator=g, device="cuda")
                * t[:, None, None]).to(torch.int32)
        empty = torch.rand((B, Hkv, M), generator=g, device="cuda") < 0.05
        cpos = torch.where(empty, torch.full_like(cpos, -1), cpos)
        kn, vn = rnd(g, (B, Hkv, D), dt), rnd(g, (B, Hkv, D), dt)
        kw = dict(window=W, new_kv=(kn, vn))
        name = f"decode {dn} {label} M {M} at t {t.tolist()}"
        check_case(name,
                   (decode_attention_cuda(q, ck, cv, cpos, t, **kw),),
                   (decode_attention_torch(q, ck, cv, cpos, t, **kw),), dn)
        binds[name] = int(((cpos >= 0)
                           & (t[:, None, None] - cpos >= W)).sum())
        del q, ck, cv, cpos
        torch.cuda.empty_cache()
    for n, c in binds.items():
        log(f"  {n}: {c} (query, key) pairs the window masks")
    check_moe("kernels at mixtral's shape",
              {f"{n}: the window never binds": int(not c)
               for n, c in binds.items()})


def moe_phase():
    """The MoE family on the card: moe_apply against its op-by-op
    reference (moe_apply_phase), granite-moe-3b-a800m in bf16 at full
    width and depth (one-shot pairs, the 4-lane stream phased and
    interleaved, the same stream at the no-drop factor against one-shot
    runs), mixtral-8x7b in bf16 at full width cut to MIXTRAL_LAYERS
    (one-shot pairs with a prompt above the window, a phased stream),
    float32 card-vs-CPU scheduler parity of both (granite 2 layers,
    mixtral 1); granite's gate training is moe_train. Returns the launch
    counts of its main paths: the bf16 one-shot calls and phased
    streams and the float32 parity runs on the card."""
    import torch
    total = None

    def add(launches):
        nonlocal total
        total = dict(launches) if total is None else {
            k: total[k] + launches[k] for k in total}

    with timed("moe_apply vs reference"):
        moe_apply_phase()
    with timed("moe granite one-shot"):
        launches, cfg, model = moe_oneshot("granite-moe-3b-a800m")
        add(launches)
    with timed("moe granite stream"):
        add(moe_stream(cfg, model))
    with timed("moe granite stream, no drops"):
        moe_stream(cfg, model, modes=("phased",), no_drop=True)
    del model
    torch.cuda.empty_cache()
    with timed("moe mixtral one-shot"):
        launches, cfg, model = moe_oneshot(
            "mixtral-8x7b", num_layers=MIXTRAL_LAYERS, shape=MIXTRAL_SHAPE)
        add(launches)
    with timed("moe mixtral stream"):
        add(moe_stream(cfg, model, n_requests=6, modes=("phased",)))
    del model
    torch.cuda.empty_cache()
    with timed("moe float32 parity"):
        add(moe_parity("granite-moe-3b-a800m", 2))
        add(moe_parity("mixtral-8x7b", 1))
    return total


# -------------------------------------------------------------- train


def train_phase(kernel_ms):
    """Three distillation steps of trimkv-paper-4b at full width on the
    card. Returns the launch counts of the run."""
    import torch
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data.pipeline import DataConfig, batches
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.train import distill

    cfg = get_config("trimkv-paper-4b")
    B, Tn, steps = 1, 4096, 3
    train_cfg = TrainConfig(seq_len=Tn, capacity_M=256, lambda_cap=1.0)
    model = T.init_params(cfg, seed=0, device="cuda")
    T.init_gate_params(model, cfg, seed=1)
    gates = T.gate_parameters(model)
    gate_ids = {id(p) for p in gates}
    base = [p for p in model.parameters() if id(p) not in gate_ids]
    # the bit-check copy stays on the host, out of the peak device memory
    base0 = [p.cpu() for p in base]
    gates0 = [p.clone() for p in gates]
    state, opt_cfg = distill.make_train_state(cfg, train_cfg, model)
    data = batches(DataConfig(batch=B, seq_len=Tn))
    L = cfg.num_layers
    expect = dict.fromkeys(ops.KERNELS, 0)
    expect.update(capacity_loss=2 * L * steps, capacity_loss_bwd=L * steps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    secs = []
    for _ in range(steps):
        b = next(data)
        batch = {k: torch.as_tensor(b[k], device="cuda")
                 for k in ("tokens", "lm_labels")}
        t0 = time.perf_counter()
        state, m = distill.train_step(state, batch, cfg=cfg,
                                      train_cfg=train_cfg, opt_cfg=opt_cfg)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        m = {k: float(v) for k, v in m.items()}
        if not all(math.isfinite(v) for v in m.values()) or m["cap"] <= 0:
            raise AssertionError(f"train step {len(secs) - 1}: {m}")
        log(f"train step {len(secs) - 1} ({b['task']}): {secs[-1]:.3f} s, "
            f"loss {m['loss']:.4f} kl {m['kl']:.4e} ntp {m['ntp']:.4f} "
            f"cap {m['cap']:.4f} grad_norm {m['grad_norm']:.4e} "
            f"lr {m['lr']:.3e}")
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if launches != expect:
        raise AssertionError(f"train launches {launches}, expected {expect}")
    if not all(torch.equal(p.cpu(), q) for p, q in zip(base, base0)):
        raise AssertionError("a base weight changed in training")
    moved = max((p - q).abs().max().item() for p, q in zip(gates, gates0))
    if not moved > 0:
        raise AssertionError("the gates did not change")
    step_s = sum(secs[1:]) / (steps - 1)
    cap_ms = (2 * L * kernel_ms["capacity_loss"]
              + L * kernel_ms["capacity_loss_bwd"])
    log(f"train: {cfg.name} {L} layers {cfg.dtype}, batch {B} x {Tn} "
        f"tokens, M {train_cfg.capacity_M}: launches {launches}; steps "
        f"{[round(s, 3) for s in secs]} s, {step_s:.3f} s per step after "
        f"the first = {B * Tn / step_s:.1f} train tokens/s; peak device "
        f"memory {peak / 2**30:.2f} GiB; capacity kernels {cap_ms:.3f} ms "
        f"per step = {cap_ms / (step_s * 1e3) * 100:.3f} % of a step (timed "
        f"kernel ms x launches); largest gate change {moved:.3e}")
    del state, model, base, base0, gates, gates0
    torch.cuda.empty_cache()
    return launches


def train_parity_phase():
    """Card (kernels) vs CPU (plain versions) on the full-width config cut
    to 2 layers, float32, one set of weights: the loss and the gate
    gradients; the optimizer on identical gradients; one train_step."""
    import torch
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data.pipeline import DataConfig, batches
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_update, init_opt_state
    from repro_torch.train import distill

    cfg = dataclasses.replace(get_config("trimkv-paper-4b"), num_layers=2,
                              dtype="float32")
    train_cfg = TrainConfig(seq_len=256, capacity_M=64)
    gpu = T.init_params(cfg, seed=6, device="cuda")
    T.init_gate_params(gpu, cfg, seed=7)
    perturb_gates(gpu, seed=8)
    cpu = copy.deepcopy(gpu).to("cpu")
    b = next(batches(DataConfig(batch=1, seq_len=256)))
    out = []
    for model in (gpu, cpu):
        dev = model.device
        batch = {k: torch.as_tensor(b[k], device=dev)
                 for k in ("tokens", "lm_labels")}
        state, opt_cfg = distill.make_train_state(cfg, train_cfg, model)
        gates = T.gate_parameters(model)
        gates0 = [p.detach().clone() for p in gates]
        loss, _ = distill.distill_loss(model, cfg, train_cfg,
                                       batch["tokens"], batch["lm_labels"])
        grads = torch.autograd.grad(loss, gates)
        state, m = distill.train_step(state, batch, cfg=cfg,
                                      train_cfg=train_cfg, opt_cfg=opt_cfg)
        moved = max((p - q).abs().max().item()
                    for p, q in zip(gates, gates0))
        out.append({"loss": loss.item(), "grads": [g.cpu() for g in grads],
                    "gates0": gates0, "opt_cfg": opt_cfg, "moved": moved,
                    "m": {k: float(v) for k, v in m.items()}})
    card, host = out
    loss_rel = abs(card["loss"] - host["loss"]) / abs(host["loss"])
    grad_rel = max(((a - b_).abs().max() / b_.abs().max()).item()
                   for a, b_ in zip(card["grads"], host["grads"]))
    # the first AdamW step moves an entry by about lr * sign(g), so a
    # gradient entry within the card-vs-CPU noise may step either way:
    # the optimizer is held on identical (the CPU's) gradients instead
    step = []
    for side, dev in ((card, "cuda"), (host, "cpu")):
        params = [p.to(dev) for p in side["gates0"]]
        new, _, _ = adamw_update(
            side["opt_cfg"], [g.to(dev) for g in host["grads"]],
            init_opt_state(params), params)
        step.append([p.cpu() for p in new])
    opt_err = max((a - b_).abs().max().item() for a, b_ in zip(*step))
    step_rel = abs(card["m"]["loss"] - host["m"]["loss"]) / abs(
        host["m"]["loss"])
    if not (loss_rel <= 1e-4 and grad_rel <= 1e-3 and opt_err <= 1e-6
            and step_rel <= 1e-4 and host["m"]["cap"] > 0
            and card["moved"] > 0 and host["moved"] > 0):
        raise AssertionError(
            f"train parity: loss rel {loss_rel:.3e}, grad rel "
            f"{grad_rel:.3e}, optimizer {opt_err:.3e}, train_step loss rel "
            f"{step_rel:.3e}, cap {host['m']['cap']}, gates moved "
            f"{card['moved']:.3e} / {host['moved']:.3e}")
    log(f"train parity: loss {card['loss']:.6f} (card) vs "
        f"{host['loss']:.6f} (CPU), rel {loss_rel:.2e} (tol 1e-4); gate "
        f"grads rel {grad_rel:.2e} (tol 1e-3); adamw_update on identical "
        f"gradients max |diff| {opt_err:.2e} (tol 1e-6); train_step loss "
        f"rel {step_rel:.2e} (tol 1e-4), cap {card['m']['cap']:.6f} vs "
        f"{host['m']['cap']:.6f}, gates moved {card['moved']:.2e} / "
        f"{host['moved']:.2e}")


@contextlib.contextmanager
def timed(phase):
    """Print a phase's seconds on the host clock when it ends."""
    t0 = time.perf_counter()
    yield
    log(f"phase {phase}: {time.perf_counter() - t0:.1f} s")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.models.common import resolve_device

    resolve_device("cuda")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    lib = build.build()
    build.library()
    log(f"built {lib.name} in {time.perf_counter() - t0:.1f} s")
    for line in build.build_log().splitlines():
        if ("registers" in line or "spill" in line or "entry function" in line
                or line.startswith("==")):
            log("  " + line.strip())

    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    with torch.no_grad(), timed("kernels"):
        log("kernels (kernel vs plain version on the card):")
        kernels = [decode_phase(g), *chunk_phase(g), *retention_phase(g)]
        torch.cuda.empty_cache()
        log("kernels at the cross families' shapes:")
        cross_kernel_phase(g)
        torch.cuda.empty_cache()
        log("kernels at granite-moe-3b-a800m's shape (D 64, G 3):")
        moe_kernel_phase(g)
        log("kernels at mixtral-8x7b's shape (D 128, G 4, window 4096):")
        mixtral_kernel_cases(g)
    with timed("capacity"):
        kernels += capacity_phase(g)
    torch.cuda.empty_cache()
    with torch.no_grad():
        with timed("serve"):
            cfg, model = full_width_model()
            launches, _ = serve_phase(cfg, model)
        with timed("policy"):
            pol, _ = policy_phase(cfg, model)
        del model
        torch.cuda.empty_cache()
        for k in ("decode_attention", "chunk_attention",
                  "retention_attention"):
            launches[k] += pol[k]
        # the serving paths: Engine.generate and the scheduler's stream
        with timed("stream bfloat16"):
            stream, stream_readings = stream_phase("bfloat16")
        for k in ("decode_attention", "chunk_attention"):
            launches[k] += stream[k]
        for policy in ("trimkv", "h2o", "rkv"):
            with timed(f"stream float32 {policy}"):
                stream_phase("float32", num_layers=2, n_requests=6,
                             policy=policy)
        # the prefix KV cache and speculative decoding on the scheduler
        with timed("reuse"):
            reuse, _ = reuse_phase(stream_readings)
        for k in ("decode_attention", "chunk_attention",
                  "chunk_attention_f32"):
            launches[k] += reuse[k]
        # the lane lifecycle: sampled lanes, swaps, parks, quarantine
        with timed("lifecycle"):
            life, _ = lifecycle_phase()
        for k in ("decode_attention", "chunk_attention",
                  "chunk_attention_f32"):
            launches[k] += life[k]
        # a dense config of another width and GQA group, with qkv biases
        with timed("qwen2.5-14b"):
            dense = dense_config_phase()
        for k in ("decode_attention", "chunk_attention",
                  "retention_attention"):
            launches[k] += dense[k]
        # the cross-memory families (vlm, encdec)
        cross = cross_phase()
        for k in ("decode_attention", "chunk_attention",
                  "retention_attention", "chunk_attention_f32",
                  "retention_attention_f32"):
            launches[k] += cross[k]
        # the MoE family (granite-moe-3b-a800m, mixtral-8x7b)
        moe = moe_phase()
        for k in ("decode_attention", "chunk_attention",
                  "retention_attention", "chunk_attention_f32",
                  "retention_attention_f32"):
            launches[k] += moe[k]
    # the float32 attention kernels' path is the float32 parity runs
    for policy, _ in POLICY_BUDGETS:
        with timed(f"parity float32 {policy}"):
            f32, _ = parity_phase("float32", policy)
        for k in ("retention_attention_f32", "chunk_attention_f32"):
            launches[k] += f32[k]
    with timed("parity bfloat16"):
        parity_phase("bfloat16")
    with timed("train"):
        train_launches = train_phase({k["name"]: k["ms"] for k in kernels})
    with timed("moe train"):
        moe_train_launches = moe_train()
    launches.update({k: train_launches[k] + moe_train_launches[k]
                     for k in ("capacity_loss", "capacity_loss_bwd")})
    with timed("train parity"):
        train_parity_phase()
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']} never ran on the main path")
    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    print(json.dumps({"kernels": [{key: k[key] for key in order}
                                  for k in kernels]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
