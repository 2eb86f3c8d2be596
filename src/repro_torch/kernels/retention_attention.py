"""Retention-gated causal flash attention: the CUDA kernel's wrapper and
its plain PyTorch version.

Replaces the Pallas kernel ``retention_attention_pallas``
(``repro/kernels/retention_attention.py``) with two CUDA kernels, one
per dtype: bfloat16 runs ``csrc/retention_attention_tc.cu`` (wgmma and
TMA on the tensor cores, head dim 64, 128 or 256), float32 runs
``csrc/retention_attention.cu`` (full float32 FMAs on the CUDA cores,
register-blocked like an SGEMM; one CTA serves the q heads of a kv
head together, so each K/V tile is staged once per group; head dim
at most 256). Attention of q
[B, Tq, Hq, D] over k, v [B, Tk, Hkv, D] with GQA, an optional causal
mask and window from the absolute query position q_offset + row, and
an optional retention bias (q_pos - i) * log_beta_i on visible logits
(log_beta [B, Tk, Hkv] float32). Single-shot prefill calls it causal
with log_beta None.

``kernels.ops.retention_attention`` picks the version by the tensors'
device; call that, not these.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import build

NEG_INF = -1e30


def retention_attention_torch(q, k, v, log_beta=None, *, causal=True,
                              window=0, q_offset=0):
    """Plain version, after
    ``repro/kernels/ref.py:retention_attention_ref``; a row with no
    visible key gives zero, as in the kernel (the reference returns the
    mean value there; no caller produces such a row)."""
    B, Tq, Hq, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    dev = q.device
    kr = k.repeat_interleave(group, dim=2).float()
    vr = v.repeat_interleave(group, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) / np.sqrt(D)
    dist = ((q_offset + torch.arange(Tq, device=dev))[:, None]
            - torch.arange(Tk, device=dev)[None, :])
    mask = torch.ones((Tq, Tk), dtype=torch.bool, device=dev)
    if causal:
        mask = mask & (dist >= 0)
    if window > 0:
        mask = mask & (dist < window)
    if log_beta is not None:
        lb = log_beta.repeat_interleave(group, dim=2).float()
        bias = dist[None, None].float() * lb.transpose(1, 2)[:, :, None, :]
        s = s + torch.where(mask, bias, torch.zeros_like(bias))
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask, p, torch.zeros_like(p))
    return torch.einsum("bhqk,bkhd->bqhd", p, vr).to(q.dtype)


def retention_attention_cuda(q, k, v, log_beta=None, *, causal=True,
                             window=0, q_offset=0):
    """Launch the kernel of q's dtype: bfloat16
    ``csrc/retention_attention_tc.cu`` (head dim 64, 128 or 256,
    16-byte-aligned tensors, as TMA reads them), float32
    ``csrc/retention_attention.cu`` (head dim at most 256 and a multiple
    of 4, 16-byte-aligned tensors, as cp.async copies them; at most 128
    q heads per kv head, 64 at D > 128). Same contract as the plain version;
    contiguous CUDA tensors, q/k/v in one dtype, log_beta float32,
    q_offset a Python int."""
    build.check_device(q)
    dev, dt = q.device, q.dtype
    B, Tq, Hq, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    build.check_tensor("q", q, (B, Tq, Hq, D), dt, dev)
    build.check_tensor("k", k, (B, Tk, Hkv, D), dt, dev)
    build.check_tensor("v", v, (B, Tk, Hkv, D), dt, dev)
    if log_beta is not None:
        build.check_tensor("log_beta", log_beta, (B, Tk, Hkv),
                           torch.float32, dev)
    out = torch.empty_like(q)
    lb = None if log_beta is None else log_beta.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    opts = (int(bool(causal)), int(window), int(q_offset), stream)
    if dt == torch.bfloat16:
        build.check_tc(D, q=q, k=k, v=v, out=out)
        err = build.library().retention_attention_tc_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lb, out.data_ptr(), B,
            Tq, Tk, Hq, Hkv, D, *opts)
    else:
        build.check_f32("retention", D, q=q, k=k, v=v, out=out)
        err = build.library().retention_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lb, out.data_ptr(),
            B, Tq, Tk, Hq, Hkv, D, *opts)
    build.check(err, "retention_attention")
    return out
