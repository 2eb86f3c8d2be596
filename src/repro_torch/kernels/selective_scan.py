"""The Mamba-1 selective scan of the ssm family's mamba blocks: the CUDA
kernel's wrapper and its plain PyTorch version.

``h_t = exp(dt_t * A) * h_{t-1} + (dt_t * xs_t) * B_t`` (dt, xs
[B, T, di] broadcast over the state axis n, B_t [B, n] over the
channels) from h0 [B, di, n] float32, and ``ys[b, t, d] = sum_n
h_t[b, d, n] * C_t[b, n]``. dt is float32 (after softplus), xs, Bm and
Cm [B, T, n] are in the model dtype, A = -exp(A_log) [di, n] float32.
Steps at or past n_valid[b] ([B] int32) are the identity (dA 1, dBx 0),
as the JAX package pads a chunk, so h_last is h at the last real step;
ys there is still h . C_t. Returns (ys [B, T, di] float32, h_last
[B, di, n] float32).

The JAX package runs the recurrence as a ``lax.scan`` over time in XLA
(``repro/models/blocks.py``: ``_mamba_prefill``, ``_mamba_prefill_chunk``),
materialising dA and dBx [B, T, di, n]; there is no Pallas kernel, so
the CUDA kernel (``csrc/selective_scan.cu``) replaces none. It never
forms the [B, T, di, n] tensors: a thread keeps 8 states of one (lane,
channel) in registers and walks T in order. The plain version is the
JAX code's loop, in its order of operations.

``kernels.ops.selective_scan`` picks the version by the tensors'
device; call that, not these.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

# the state size the kernel takes (falcon-mamba-7b's ssm_state), and the
# states a thread of it holds
STATES = 16
STATES_PER_THREAD = 8


def selective_scan_torch(dt, xs, Bm, Cm, A, h0, n_valid):
    """Plain version: dA and dBx as the JAX code makes them, padded steps
    set to (1, 0), then a loop over the T steps."""
    T = dt.shape[1]
    dA = torch.exp(dt[..., None] * A)                          # [B,T,di,n]
    dBx = (dt * xs.float())[..., None] * Bm[:, :, None, :].float()
    valid = (torch.arange(T, device=dt.device)[None]
             < n_valid.to(dt.device)[:, None])[..., None, None]
    dA = torch.where(valid, dA, torch.ones_like(dA))
    dBx = torch.where(valid, dBx, torch.zeros_like(dBx))
    Cf = Cm.float()
    h, ys = h0, []
    for t in range(T):
        h = dA[:, t] * h + dBx[:, t]
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]))
    return torch.stack(ys, dim=1), h


def selective_scan_cuda(dt, xs, Bm, Cm, A, h0, n_valid):
    """Launch ``csrc/selective_scan.cu``. Same contract as the plain
    version; contiguous CUDA tensors, n = STATES, Bm and Cm 16-byte
    aligned."""
    build.check_device(xs)
    dev = xs.device
    B, T, di = dt.shape
    n = A.shape[-1]
    if n != STATES:
        raise ValueError(f"the selective-scan kernel takes ssm_state "
                         f"{STATES}, got {n}")
    build.check_tensor("dt", dt, (B, T, di), torch.float32, dev)
    build.check_tensor("xs", xs, (B, T, di), xs.dtype, dev)
    build.check_tensor("Bm", Bm, (B, T, n), xs.dtype, dev)
    build.check_tensor("Cm", Cm, (B, T, n), xs.dtype, dev)
    build.check_tensor("A", A, (di, n), torch.float32, dev)
    build.check_tensor("h0", h0, (B, di, n), torch.float32, dev)
    build.check_tensor("n_valid", n_valid, (B,), torch.int32, dev)
    build.check_aligned(Bm=Bm, Cm=Cm)
    ys = torch.empty((B, T, di), dtype=torch.float32, device=dev)
    h_last = torch.empty_like(h0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = build.library().selective_scan_launch(
        dt.data_ptr(), xs.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        A.data_ptr(), h0.data_ptr(), n_valid.data_ptr(), ys.data_ptr(),
        h_last.data_ptr(), B, T, di, n, int(xs.dtype == torch.bfloat16),
        stream)
    build.check(err, "selective_scan")
    return ys, h_last
