"""The RG-LRU scan of the hybrid family's recurrent blocks: the CUDA
kernel's wrapper and its plain PyTorch version.

``h_t = a_t * h_{t-1} + sqrt(max(1 - a_t^2, 1e-12)) * bx_t`` with
``a_t = exp(a_log_t)``, over a_log, bx [B, T, W] float32 from h0
[B, W] float32; returns every h_t, [B, T, W] float32. The JAX package
computes it (``repro/models/blocks.py:_rg_lru_scan``) as one
``lax.associative_scan`` in XLA: there is no Pallas kernel, so the CUDA
kernel (``csrc/rg_lru_scan.cu``) replaces none. It runs sequentially
over T, one thread per (lane, channel); so does the plain version, one
step at a time, which rounds like the kernel up to the fused
multiply-add and differs from the associative scan's order within
float32 rounding.

``kernels.ops.rg_lru_scan`` picks the version by the tensors' device;
call that, not these.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def rg_lru_gates(a_log, bx):
    """(a, the gated input sqrt(max(1 - a^2, 1e-12)) * bx), float32."""
    a = torch.exp(a_log)
    return a, torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * bx


def rg_lru_scan_torch(a_log, bx, h0):
    """Plain version: a loop over the T steps."""
    a, g = rg_lru_gates(a_log, bx)
    h, out = h0, []
    for t in range(a_log.shape[1]):
        h = a[:, t] * h + g[:, t]
        out.append(h)
    return torch.stack(out, dim=1)


def rg_lru_scan_cuda(a_log, bx, h0):
    """Launch ``csrc/rg_lru_scan.cu``. Same contract as the plain
    version; contiguous float32 CUDA tensors."""
    build.check_device(a_log)
    dev = a_log.device
    B, T, W = a_log.shape
    build.check_tensor("a_log", a_log, (B, T, W), torch.float32, dev)
    build.check_tensor("bx", bx, (B, T, W), torch.float32, dev)
    build.check_tensor("h0", h0, (B, W), torch.float32, dev)
    out = torch.empty_like(a_log)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = build.library().rg_lru_scan_launch(
        a_log.data_ptr(), bx.data_ptr(), h0.data_ptr(), out.data_ptr(), B, T,
        W, stream)
    build.check(err, "rg_lru_scan")
    return out
