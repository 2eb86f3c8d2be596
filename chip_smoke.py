#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the three attention kernels and the two capacity-loss kernels
from src/repro_torch/kernels/csrc with nvcc, then:

1. kernels — each CUDA kernel against its plain PyTorch version on the
   card at the main-path shapes (Hq 32, Hkv 8, D 128, B 4, M 512,
   C 512, T 2000), in bfloat16 and float32, over its options; prints
   each case's max error beside its tolerance and times the kernel,
   the plain version and one PyTorch library call computing the same
   function (scaled_dot_product_attention, a yardstick the port never
   calls);
2. serve — trimkv-paper-4b at full width (36 layers, bfloat16, random
   weights from a seed, perturbed gate biases) through Engine.generate,
   batch 4, prompt 2000, budget 512, 32 new tokens, single-shot and
   chunked (chunks of 512, the last one padded); asserts the exact
   kernel launch counts of each and finite logits, prints tokens/s;
3. parity — the same config cut to 2 layers in float32, one set of
   weights on the card (kernels) and on the CPU (plain versions):
   teacher-forced logits within 1e-3 and identical slot positions in
   every layer, after single-shot and after chunked prefill;
4. capacity — the capacity-loss forward and backward kernels against
   their plain versions (core.losses.capacity_loss_chunked,
   capacity_loss_bwd_torch) at B 1, H 8, T 4096, M 256, at T 1000, at
   the beta = 1.0 tie (S_t = t + 1 meets M) and at B 2: value within
   rel 1e-5, S within rel 1e-5, gradient within rel 1e-4 of its
   largest entry; times the forward, the backward and the plain
   forward + backward, and prints the bound: the least float32 work
   (one multiply-add per (t, i) pair forward, two per pair over budget
   backward) at 67 TFLOP/s;
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
   within rel 1e-4 and moves the gates.

Prints the card's name and power limit and a {"kernels": [...]} line,
then, as the last line, {"ok": true, "device": {...}}. Any failure
raises: the script exits non-zero and prints no result line. It exits
non-zero at once when no CUDA card is visible.
"""
from __future__ import annotations

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
TOL = {"bfloat16": 2e-2, "float32": 1e-4}   # abs and rel, see check()


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


def bound_ms(n_bytes, n_flops, flops_per_s=BF16_FLOPS):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / flops_per_s
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


# ------------------------------------------------------------ kernels


def rnd(g, shape, dtype):
    import torch
    return torch.randn(shape, generator=g, device="cuda").to(dtype)


def decode_phase(g):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                      decode_attention_torch)
    B, Hq, Hkv, D = 4, 32, 8, 128
    G = Hq // Hkv
    cases = [  # name, M, window, new_kv, return_probs, per-lane t, empty
        ("main path (new_kv, [B] t)", 512, 0, True, False, True, 0.0),
        ("probs + p_new", 512, 0, True, True, True, 0.2),
        ("window 128 + probs", 512, 128, True, True, True, 0.2),
        ("no new_kv, scalar t, probs", 512, 0, False, True, False, 0.2),
        ("M 500 (ragged tile)", 500, 0, True, True, True, 0.2),
    ]
    main_err = None
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        for name, M, window, with_new, probs, lane, empty in cases:
            t = torch.tensor([2000, 1900, 1800, 2047], dtype=torch.int32,
                             device="cuda")
            q = rnd(g, (B, Hq, D), dtype)
            kc = rnd(g, (B, Hkv, M, D), dtype)
            vc = rnd(g, (B, Hkv, M, D), dtype)
            pos = torch.randint(0, 1800, (B, Hkv, M), generator=g,
                                device="cuda", dtype=torch.int32)
            drop = torch.rand((B, Hkv, M), generator=g, device="cuda") < empty
            pos = torch.where(drop, torch.full_like(pos, -1), pos)
            new = (rnd(g, (B, Hkv, D), dtype), rnd(g, (B, Hkv, D), dtype)) \
                if with_new else None
            tt = t if lane else 2047
            kw = dict(window=window, new_kv=new, return_probs=probs)
            got = decode_attention_cuda(q, kc, vc, pos, tt, **kw)
            want = decode_attention_torch(q, kc, vc, pos, tt, **kw)
            got = got if probs else (got,)
            want = want if probs else (want,)
            err = check(f"decode {dn} {name}", got, want, dn)
            if dtype == torch.bfloat16 and name.startswith("main"):
                main_err = err

    # timing at the main-path shape: full cache, in-flight token, no
    # probs, bf16; 8 input sets in rotation (67 MB > the 50 MB L2), as
    # each layer's decode finds its cache cold
    M, dtype = 512, torch.bfloat16
    sets = []
    for _ in range(8):
        pos = torch.randint(0, 1800, (B, Hkv, M), generator=g, device="cuda",
                            dtype=torch.int32)
        sets.append((rnd(g, (B, Hq, D), dtype), rnd(g, (B, Hkv, M, D), dtype),
                     rnd(g, (B, Hkv, M, D), dtype), pos,
                     (rnd(g, (B, Hkv, D), dtype), rnd(g, (B, Hkv, D), dtype))))
    t = torch.full((B,), 2000, dtype=torch.int32, device="cuda")
    ms = time_ms(lambda i=0: decode_attention_cuda(
        *sets[i % 8][:4], t, new_kv=sets[i % 8][4]), 200)
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
    lib = time_ms(lambda i=0: F.scaled_dot_product_attention(
        *lib_in[i % 8][:3], attn_mask=lib_in[i % 8][3]), 200)
    el = 2
    n_bytes = (B * Hq * D * el * 2 + 2 * B * Hkv * M * D * el
               + B * Hkv * M * 4 + B * 4 + 2 * B * Hkv * D * el)
    n_flops = 4 * B * Hq * D * (M + 1)
    b_ms, b_by = bound_ms(n_bytes, n_flops)
    return {"name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:112",
            "max_abs_err": main_err, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}


def chunk_phase(g):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.chunk_attention import (chunk_attention_cuda,
                                                     chunk_attention_torch)
    B, C, Hq, Hkv, M, D = 4, 512, 32, 8, 512, 128
    G = Hq // Hkv
    idx = torch.arange(C, device="cuda", dtype=torch.int32)

    def inputs(dtype, t0, n_valid, empty, first):
        q = rnd(g, (B, C, Hq, D), dtype)
        kc, vc = rnd(g, (B, C, Hkv, D), dtype), rnd(g, (B, C, Hkv, D), dtype)
        ck, cv = rnd(g, (B, Hkv, M, D), dtype), rnd(g, (B, Hkv, M, D), dtype)
        cpos = torch.randint(0, max(t0, 1), (B, Hkv, M), generator=g,
                             device="cuda", dtype=torch.int32)
        drop = torch.rand((B, Hkv, M), generator=g, device="cuda") < empty
        if first:
            drop[:] = True
        cpos = torch.where(drop, torch.full_like(cpos, -1), cpos)
        nv = torch.tensor(n_valid, dtype=torch.int32, device="cuda")
        chunk_pos = torch.where(idx[None] < nv[:, None], t0 + idx[None],
                                torch.full_like(idx[None], -1))
        return q, kc, vc, ck, cv, cpos, chunk_pos.contiguous()

    full = [C] * B
    cases = [  # name, t0, n_valid, window, need_probs, empty, first chunk
        ("main path (full cache)", 1024, full, 0, False, 0.0, False),
        ("ragged [B,C] tail + probs", 1024, [512, 464, 300, 17], 0, True,
         0.2, False),
        ("window 256 + probs", 1024, full, 256, True, 0.2, False),
        ("first chunk (empty cache)", 0, [512, 464, 512, 100], 0, True, 0.0,
         True),
    ]
    main_err = None
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        for name, t0, nv, window, probs, empty, first in cases:
            args = inputs(dtype, t0, nv, empty, first)
            kw = dict(window=window, need_probs=probs)
            got = chunk_attention_cuda(*args, **kw)
            want = chunk_attention_torch(*args, **kw)
            n = 2 if probs else 1
            err = check(f"chunk {dn} {name}", got[:n], want[:n], dn)
            if dtype == torch.bfloat16 and name.startswith("main"):
                main_err = err

    dtype = torch.bfloat16
    args = inputs(dtype, 1024, full, 0.0, False)
    ms = time_ms(lambda i=0: chunk_attention_cuda(*args, need_probs=False), 20)
    plain = time_ms(lambda i=0: chunk_attention_torch(*args, need_probs=False),
                    5)
    q, kc, vc, ck, cv, cpos, chunk_pos = args
    keys = torch.cat([ck, kc.transpose(1, 2)], 2).repeat_interleave(G, 1)
    vals = torch.cat([cv, vc.transpose(1, 2)], 2).repeat_interleave(G, 1)
    kpos = torch.cat([cpos, chunk_pos[:, None].expand(B, Hkv, C)], 2)
    dist = chunk_pos[:, None, :, None] - kpos[:, :, None, :]  # [B,Hkv,C,M+C]
    vis = (kpos[:, :, None, :] >= 0) & (dist >= 0)
    qh = q.transpose(1, 2).contiguous()
    mask = vis.repeat_interleave(G, 1)
    lib = time_ms(lambda i=0: F.scaled_dot_product_attention(
        qh, keys, vals, attn_mask=mask), 20)
    el = 2
    n_bytes = (2 * B * C * Hq * D * el + 2 * B * C * Hkv * D * el
               + 2 * B * Hkv * M * D * el + B * Hkv * M * 4 + B * C * 4)
    n_flops = 4 * D * G * int(vis.sum().item())
    b_ms, b_by = bound_ms(n_bytes, n_flops)
    return {"name": "chunk_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/chunk_attention.cu",
            "replaces": "src/repro/kernels/chunk_attention.py:117",
            "max_abs_err": main_err, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}


def retention_phase(g):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.retention_attention import (
        retention_attention_cuda, retention_attention_torch)
    B, T, Hq, Hkv, D = 4, 2000, 32, 8, 128
    G = Hq // Hkv
    cases = [  # name, Tq, q_offset, window, log_beta
        ("main path (causal, T 2000)", T, 0, 0, False),
        ("log_beta + window 512", T, 0, 512, True),
        ("q_offset 1500 (Tq 500)", 500, 1500, 0, True),
    ]
    main_err = None
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        for name, Tq, off, window, use_beta in cases:
            q = rnd(g, (B, Tq, Hq, D), dtype)
            k, v = rnd(g, (B, T, Hkv, D), dtype), rnd(g, (B, T, Hkv, D), dtype)
            lb = (-torch.rand((B, T, Hkv), generator=g, device="cuda") * 0.01
                  if use_beta else None)
            kw = dict(window=window, q_offset=off)
            got = retention_attention_cuda(q, k, v, lb, **kw)
            want = retention_attention_torch(q, k, v, lb, **kw)
            del q, k, v
            err = check(f"retention {dn} {name}", (got,), (want,), dn)
            del got, want
            torch.cuda.empty_cache()
            if dtype == torch.bfloat16 and name.startswith("main"):
                main_err = err

    dtype = torch.bfloat16
    q = rnd(g, (B, T, Hq, D), dtype)
    k, v = rnd(g, (B, T, Hkv, D), dtype), rnd(g, (B, T, Hkv, D), dtype)
    ms = time_ms(lambda i=0: retention_attention_cuda(q, k, v), 10)
    plain = time_ms(lambda i=0: retention_attention_torch(q, k, v), 3)
    qh = q.transpose(1, 2).contiguous()
    kh = k.transpose(1, 2).repeat_interleave(G, 1).contiguous()
    vh = v.transpose(1, 2).repeat_interleave(G, 1).contiguous()
    lib = time_ms(lambda i=0: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True), 10)
    el = 2
    n_bytes = 2 * B * T * Hq * D * el + 2 * B * T * Hkv * D * el
    n_flops = 4 * B * Hq * D * (T * (T + 1) // 2)
    b_ms, b_by = bound_ms(n_bytes, n_flops)
    return {"name": "retention_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/retention_attention.cu",
            "replaces": "src/repro/kernels/retention_attention.py:79",
            "max_abs_err": main_err, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}


# ------------------------------------------------------ capacity loss


def capacity_phase(g):
    import torch
    from repro_torch.kernels.capacity_loss import (
        capacity_loss_bwd_cuda, capacity_loss_bwd_torch,
        capacity_loss_fwd_cuda, capacity_loss_torch, occupancy_torch)

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

    cases = [  # name, B, H, T, M, mode
        ("main path (B 1, H 8, T 4096, M 256)", 1, 8, 4096, 256,
         "train start"),
        ("spread beta, T 1000 (ragged tile)", 1, 8, 1000, 256, "spread"),
        ("beta = 1.0 tie at M 256", 1, 8, 4096, 256, "tie"),
        ("spread beta, B 2, H 8", 2, 8, 4096, 256, "spread"),
    ]
    gout = torch.tensor(0.7, device="cuda")
    main_err = None
    for name, B, H, T, M, mode in cases:
        lb = log_beta(B, T, H, mode).contiguous()
        loss, S = capacity_loss_fwd_cuda(lb, M)
        dlb = capacity_loss_bwd_cuda(lb, S, M, gout)
        want_S = occupancy_torch(lb)
        x = lb.clone().requires_grad_(True)
        want = capacity_loss_torch(x, M)
        (auto,) = torch.autograd.grad(want * gout, x)
        want_dlb = capacity_loss_bwd_torch(lb, want_S, M, gout)
        torch.cuda.synchronize()
        errs = {"value": rel(loss, want.detach(), want.detach().abs()),
                "S": rel(S, want_S),
                "grad": rel(dlb, want_dlb),
                "grad vs autograd": rel(dlb, auto)}
        for k, tol in (("value", 1e-5), ("S", 1e-5), ("grad", 1e-4),
                       ("grad vs autograd", 1e-4)):
            if not errs[k] <= tol:
                raise AssertionError(f"capacity {name}: {k} rel err "
                                     f"{errs[k]:.3e} beyond {tol}")
        if not (torch.isfinite(dlb).all() and float(loss) > 0):
            raise AssertionError(f"capacity {name}: loss {float(loss)}")
        if mode == "tie" and not torch.equal(S[:, M - 1], torch.full_like(
                S[:, M - 1], float(M))):
            raise AssertionError("capacity tie: S_{M-1} != M")
        log(f"  capacity {name:<40} loss {float(loss):.6e}  rel err value "
            f"{errs['value']:.2e} S {errs['S']:.2e} (tol 1e-5) grad "
            f"{errs['grad']:.2e} / autograd {errs['grad vs autograd']:.2e} "
            f"(tol 1e-4)")
        if name.startswith("main"):
            main_err = (dlb - want_dlb).abs().max().item(), \
                (loss - want).abs().item()
            main = (lb, S)

    # timing at the main-path shape: each train step calls these on one
    # layer's log_beta [1, 4096, 8]
    lb, S = main
    B, T, H, M = 1, 4096, 8, 256
    fwd_ms = time_ms(lambda i=0: capacity_loss_fwd_cuda(lb, M), 100)
    bwd_ms = time_ms(lambda i=0: capacity_loss_bwd_cuda(lb, S, M, gout), 100)
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
    # backward (sum_t w_t (t-i) beta_i^(t-i) splits into the weights w_t
    # and j * w_t against the same powers), with exps and the table
    # 1/k of that. The backward needs only the pairs of rows over budget
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
    log(f"  capacity timing (B 1, H 8, T 4096, M 256): forward {fwd_ms:.4f}"
        f" ms (bound {fwd_bound:.4f}, {fwd_pairs / 1e6:.1f} M pairs x 2 "
        f"FLOPs), backward {bwd_ms:.4f} ms (bound {bwd_bound:.4f}, "
        f"{bwd_pairs / 1e6:.1f} M pairs x 4 FLOPs) at {FP32_FLOPS:.3g} "
        f"float32 FLOP/s; plain forward {plain_fwd:.3f} ms, backward "
        f"{plain_bwd:.3f} ms, forward + autograd backward "
        f"{plain_both:.3f} ms")
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


def serve_phase():
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_batch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import build_engine

    cfg = get_config("trimkv-paper-4b")
    B, P, N, budget, chunk = 4, 2000, 32, 512, 512
    t0 = time.perf_counter()
    model = T.init_params(cfg, seed=0, device="cuda")
    T.init_gate_params(model, cfg, seed=1)
    perturb_gates(model, seed=2)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"serve: {cfg.name} {cfg.num_layers} layers {cfg.dtype}, "
        f"{n_params / 1e9:.3f} B parameters, init "
        f"{time.perf_counter() - t0:.1f} s")
    eng = build_engine(cfg, model, device="cuda", budget=budget,
                       prefill_chunk=chunk)
    tokens, _, _ = make_batch("copy", 0, B, P, cfg.vocab_size)
    L = cfg.num_layers
    n_chunks = -(-P // chunk)
    none = dict.fromkeys(ops.KERNELS, 0)        # serving trains nothing
    expect = {
        False: {**none, "retention_attention": L, "decode_attention": L * N},
        True: {**none, "chunk_attention": L * n_chunks,
               "decode_attention": L * N},
    }
    results = {}
    ops.reset_launches()
    before = dict(ops.LAUNCHES)
    for chunked in (False, True):
        out = eng.generate(tokens, N, chunked=chunked)
        now = dict(ops.LAUNCHES)
        got = {k: now[k] - before[k] for k in now}
        before = now
        if got != expect[chunked]:
            raise AssertionError(f"chunked={chunked}: launches {got}, "
                                 f"expected {expect[chunked]}")
        logits = out["logits"]
        if tuple(logits.shape) != (B, cfg.padded_vocab) or \
                not torch.isfinite(logits[:, :cfg.vocab_size]).all():
            raise AssertionError("non-finite or misshapen logits")
        ids = out["ids"]
        if ids.shape != (B, N) or ids.min() < 0 or ids.max() >= cfg.vocab_size:
            raise AssertionError(f"bad ids {ids.shape}")
        mode = "chunked" if chunked else "single-shot"
        log(f"serve {mode}: launches {got}; prefill {out['prefill_sec']:.3f}"
            f" s = {out['prefill_tok_per_sec']:.1f} tok/s; decode "
            f"{out['decode_sec']:.3f} s = {out['tok_per_sec']:.1f} tok/s; "
            f"ids[0][:8] {ids[0][:8].tolist()}")
        results[mode] = out
    main_launches = dict(ops.LAUNCHES)
    del eng, model
    torch.cuda.empty_cache()
    return main_launches, results


def parity_phase():
    """Card (kernels) vs CPU (plain versions) on the full-width config
    cut to 2 layers, float32, with one set of weights."""
    import torch
    from repro_torch.bridge import state_to_numpy
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import build_engine

    cfg = dataclasses.replace(get_config("trimkv-paper-4b"), num_layers=2,
                              dtype="float32")
    gpu = T.init_params(cfg, seed=3, device="cuda")
    T.init_gate_params(gpu, cfg, seed=4)
    perturb_gates(gpu, seed=5)
    cpu = copy.deepcopy(gpu).to("cpu")
    B, P, L, budget, chunk = 2, 200, 16, 64, 64
    tokens, _, _ = make_batch("copy", 1, B, P + L, cfg.vocab_size)
    worst = 0.0
    for chunked in (False, True):
        engines = [build_engine(cfg, m, device=d, budget=budget,
                                prefill_chunk=chunk)
                   for m, d in ((gpu, "cuda"), (cpu, "cpu"))]
        states = [e.prefill(tokens[:, :P], chunked=chunked)[0]
                  for e in engines]
        with torch.no_grad():
            for i in range(L):
                outs = [T.decode_step(e.model, cfg, s, tokens[:, P + i],
                                      e.policy)
                        for e, s in zip(engines, states)]
                states = [o[0] for o in outs]
                err = (outs[0][1].cpu() - outs[1][1]).abs().max().item()
                worst = max(worst, err)
                if not err <= 1e-3:
                    raise AssertionError(f"step {i}: logits differ by {err}")
        a, b = (state_to_numpy(s, cfg) for s in states)
        for la, lb_ in zip(a["layers"], b["layers"]):
            if not (la["pos"] == lb_["pos"]).all():
                raise AssertionError("slot positions differ card vs CPU")
        log(f"parity {'chunked' if chunked else 'single-shot'}: {L} "
            f"teacher-forced steps, max |logit diff| {worst:.3e} (tol 1e-3), "
            f"pos identical in all {cfg.num_layers} layers")
    return worst


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
        if "registers" in line or "spill" in line or line.startswith("=="):
            log("  " + line.strip())

    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    with torch.no_grad():
        log("kernels (kernel vs plain version on the card):")
        kernels = [decode_phase(g), chunk_phase(g), retention_phase(g)]
        torch.cuda.empty_cache()
    kernels += capacity_phase(g)
    torch.cuda.empty_cache()
    with torch.no_grad():
        launches, _ = serve_phase()
    parity_phase()
    train_launches = train_phase({k["name"]: k["ms"] for k in kernels})
    launches.update({k: train_launches[k]
                     for k in ("capacity_loss", "capacity_loss_bwd")})
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
