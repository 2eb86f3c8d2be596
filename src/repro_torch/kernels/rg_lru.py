"""The RG-LRU scan of the hybrid family's recurrent blocks: the CUDA
kernel's wrapper and its plain PyTorch version.

``h_t = a_t * h_{t-1} + sqrt(max(1 - a_t^2, 1e-12)) * bx_t`` with
``a_t = exp(a_log_t)``, over a_log, bx [B, T, W] float32 from h0
[B, W] float32; returns every h_t, [B, T, W] float32. The JAX package
computes it (``repro/models/blocks.py:_rg_lru_scan``) as one
``lax.associative_scan`` in XLA: there is no Pallas kernel, so the CUDA
kernel (``csrc/rg_lru_scan.cu``) replaces none.

The kernel is bound by bytes (12 a lane, step and channel), and a walk
over T one step at a time keeps too few loads in flight to reach the
card's memory rate. So it scans in chunks over time: each step is the
affine map (a_t, g_t), and maps compose as (a1, g1) then (a2, g2) =
(a1 a2, a2 g1 + g2). A CTA owns one lane and ``cw`` channels and walks
T in tiles of SUBS chunks of CHUNK steps; each thread composes one
chunk of one channel in registers, every thread then walks its
channel's SUBS chunk maps in order from the carry (h before the tile)
and writes h_u = A_u c + B_u. The order is fixed by CHUNK and SUBS
alone, so a launch rounds the same every time, whatever the shapes;
padded steps (a 1, g 0) compose exactly, so a padded tail repeats h at
the last real step bit for bit. ``scan_plan`` picks the grid. The plain
version is the sequential loop, which rounds differently, within
float32 rounding (|a| <= 1).

``kernels.ops.rg_lru_scan`` picks the version by the tensors' device;
call that, not these.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


# steps of a chunk (one thread's run, csrc/rg_lru_scan.cu's U), chunks
# a tile (SUBS), the kernel's channel tiles, widest first, and the CTAs
# it aims for: two per SM of the H100's 132
CHUNK = 16
SUBS = 8
CHANNEL_TILES = (32, 16, 8)
TARGET_CTAS = 2 * 132


def scan_plan(B: int, T: int, W: int) -> tuple[int, int, int, tuple]:
    """(chunk, cw, n_sub, grid) of the kernel for a_log [B, T, W]: CTA
    (x, b) owns lane b and channels [x * cw, min(W, (x + 1) * cw)), of
    n_sub * cw threads; thread s * cw + c takes channel c and, in each
    tile of n_sub * chunk steps, the steps [s * chunk, (s + 1) * chunk)
    of it. cw is the widest of CHANNEL_TILES whose grid reaches
    TARGET_CTAS (else the narrowest); n_sub is SUBS, or fewer where one
    tile covers T (a whole number of warps), which composes as a full
    tile would. grid = (ceil(W / cw), B)."""
    for cw in CHANNEL_TILES:
        if B * -(-W // cw) >= TARGET_CTAS:
            break
    per_warp = 32 // cw                   # chunks a warp holds
    n_chunks = -(-T // CHUNK)
    n_sub = min(SUBS, -(-n_chunks // per_warp) * per_warp)
    return CHUNK, cw, n_sub, (-(-W // cw), B)


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
    """Launch ``csrc/rg_lru_scan.cu`` on ``scan_plan(B, T, W)``. Same
    contract as the plain version; contiguous float32 CUDA tensors."""
    build.check_device(a_log)
    dev = a_log.device
    B, T, W = a_log.shape
    build.check_tensor("a_log", a_log, (B, T, W), torch.float32, dev)
    build.check_tensor("bx", bx, (B, T, W), torch.float32, dev)
    build.check_tensor("h0", h0, (B, W), torch.float32, dev)
    _, cw, n_sub, _ = scan_plan(B, T, W)
    out = torch.empty_like(a_log)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = build.library().rg_lru_scan_launch(
        a_log.data_ptr(), bx.data_ptr(), h0.data_ptr(), out.data_ptr(), B, T,
        W, cw, n_sub, stream)
    build.check(err, "rg_lru_scan")
    return out
