"""Capacity loss L_cap (paper Eq. 5): the CUDA kernels' wrappers, the
autograd function that joins them, and their plain PyTorch versions.

Replaces the Pallas kernel ``capacity_loss_pallas``
(``repro/kernels/capacity_loss.py``), which is forward-only; the
kernels are ``csrc/capacity_loss.cu``, a forward and a backward. With
lb = log beta [B, T, H] float32 and S_t = sum_{i<=t} exp((t-i) lb_i)
per (b, h), L_cap = mean over (b, h) of (1/T) sum_t max(0, S_t - M)/(t+1).
The forward keeps S [B*H, T] and log beta's [B*H, T] rows as the
residuals its backward reads; ``fwd_plan`` and ``bwd_plan`` size the
two kernels' grids.

``kernels.ops.capacity_loss`` / ``capacity_loss_log`` pick the version
by the tensor's device; call those, not these.
"""
from __future__ import annotations

import torch

from repro_torch.core.losses import capacity_loss_chunked
from repro_torch.kernels import build
from repro_torch.models.common import const


def _rows(log_beta):
    """[B, T, H] -> contiguous float32 [B*H, T], as the kernels read it."""
    B, T, H = log_beta.shape
    return log_beta.float().transpose(1, 2).reshape(B * H, T).contiguous()


# both kernels (csrc/capacity_loss.cu): columns per column tile, rows
# per row block
TILE_COLS = 128
BLOCK_ROWS = 32
# the forward: the most micro-rows (4 row blocks each, 16 threads) a CTA
# takes at a time, and the CTAs it aims for: one on each of the H100's
# 132 SMs
FWD_MAX_ROWS = 40
FWD_TARGET_CTAS = 132
# the backward (a group of 4 warps, one column per thread; one warp's 32
# columns span one row block): the most groups a CTA holds, and the
# warps it aims for: 16 on each SM
BWD_MAX_GROUPS = 4
BWD_TARGET_WARPS = 16 * 132


def fwd_plan(T: int, BH: int) -> tuple[int, int, int]:
    """(n_items, n_split, n_rows) of the forward kernel for B*H = BH
    rows of T. Item p takes column tiles p and n - 1 - p (n =
    ceil(T / TILE_COLS)): its list of micro-rows (4 row blocks of 32 rows
    each) is tile p's n - p, then tile n - 1 - p's p + 1, so n + 1 for
    every item but a middle one. Where n_items x BH CTAs would leave SMs
    idle, n_split CTAs share an item's list, n_rows micro-rows at a time
    each (16 n_rows threads: two groups of 8 per micro-row, each taking
    two column blocks of 32). The grid is n_items * n_split x BH."""
    n = -(-T // TILE_COLS)
    n_items = (n + 1) // 2
    length = n + 1 if n > 1 else 1
    n_split = max(1, min(length, FWD_TARGET_CTAS // (n_items * BH)))
    n_rows = min(FWD_MAX_ROWS, -(-length // n_split))
    return n_items, min(n_split, -(-length // n_rows)), n_rows


def bwd_plan(T: int, BH: int) -> tuple[int, int]:
    """(n_items, n_groups) of the backward kernel for B*H = BH rows of
    T: item p is the CTA that takes column tiles p and n - 1 - p (n =
    ceil(T / TILE_COLS)), whose pairs sum to about the same for every p;
    its n_groups groups of 4 warps split each column's row blocks. The
    grid is n_items x BH CTAs of 128 * n_groups threads."""
    n_items = (-(-T // TILE_COLS) + 1) // 2
    per_cta = TILE_COLS // 32
    want = -(-BWD_TARGET_WARPS // (per_cta * max(1, BH * n_items)))
    return n_items, max(1, min(BWD_MAX_GROUPS, want))


# ------------------------------------------------------- plain versions


def capacity_loss_torch(log_beta, M: float):
    """Plain forward: the port's ``core.losses.capacity_loss_chunked`` in
    log space (autograd gives its gradient)."""
    return capacity_loss_chunked(None, M, log_beta=log_beta)


def _decay(lb_row):
    """dist [T, T] (t - i, float) and E [T, T] with E[t, i] =
    exp((t - i) lb_i) below the diagonal and 0 above it (the mask comes
    before the exp)."""
    idx = torch.arange(lb_row.shape[0], device=lb_row.device)
    dist = (idx[:, None] - idx[None, :]).float()
    expo = torch.where(dist >= 0, dist * lb_row[None, :],
                       const(-1e9, lb_row.device))
    return dist, torch.exp(expo)


def occupancy_torch(log_beta):
    """S [B*H, T]: S_t = sum_{i<=t} exp((t-i) lb_i), one (b, h) row at a
    time ([T, T] each)."""
    lb = _rows(log_beta)
    return torch.stack([_decay(row)[1].sum(dim=1) for row in lb])


def capacity_loss_bwd_torch(log_beta, S, M: float, g):
    """Plain backward: dL/dlb [B, T, H] in closed form from the saved S,

        g/(B*H*T) * sum_{t>=i} h(S_t - M)/(t+1) * (t-i) exp((t-i) lb_i),

    with h = 1 above 0, 0.5 at 0 (jnp.maximum's tie rule) and 0 below."""
    B, T, H = log_beta.shape
    lb = _rows(log_beta)
    x = S - M
    h = torch.where(x > 0, 1.0, torch.where(x == 0, 0.5, 0.0))
    w = h / torch.arange(1, T + 1, device=lb.device).float()     # [BH, T]
    out = []
    for lb_r, w_r in zip(lb, w):
        dist, E = _decay(lb_r)
        out.append((w_r[:, None] * dist * E).sum(dim=0))
    scale = torch.as_tensor(g, dtype=torch.float32, device=lb.device) \
        / (B * H * T)
    return (torch.stack(out) * scale).reshape(B, H, T).transpose(1, 2)


# ------------------------------------------------------- CUDA kernels


def capacity_fwd_launch(rows, S, part, partial, M: float):
    """The forward kernel and its sum pass alone, on the wrapper's
    checked buffers: rows [B*H, T] (log beta) and fwd_buffers' S, part
    and partial."""
    BH, T = rows.shape
    n_items, n_split, n_rows = fwd_plan(T, BH)
    err = build.library().capacity_loss_fwd_launch(
        rows.data_ptr(), S.data_ptr(), part.data_ptr(), partial.data_ptr(),
        BH, T, n_items, n_split, n_rows, float(M),
        torch.cuda.current_stream(rows.device).cuda_stream)
    build.check(err, "capacity_loss_fwd")


def fwd_buffers(BH: int, T: int, device):
    """The forward's outputs and scratch, float32: S [BH, T]; the column
    tiles' partial rows part [BH, n, 4 ceil(T / 4)] (n = ceil(T / 128));
    the hinge terms' sums per 32 rows, partial [BH, ceil(T / 32)]."""
    n = -(-T // TILE_COLS)
    f = dict(dtype=torch.float32, device=device)
    return (torch.empty((BH, T), **f),
            torch.empty((BH, n, -(-T // 4) * 4), **f),
            torch.empty((BH, -(-T // BLOCK_ROWS)), **f))


def capacity_loss_fwd_cuda(log_beta, M: float):
    """Launch the forward kernel (and its sum pass). log_beta:
    contiguous float32 CUDA [B, T, H]. Returns (loss scalar, S [B*H, T]
    float32, log_beta's rows [B*H, T] float32): S and the rows are what
    the backward reads."""
    build.check_device(log_beta)
    B, T, H = log_beta.shape
    build.check_tensor("log_beta", log_beta, (B, T, H), torch.float32,
                       log_beta.device)
    rows = _rows(log_beta)
    S, part, partial = fwd_buffers(B * H, T, rows.device)
    capacity_fwd_launch(rows, S, part, partial, M)
    return partial.sum() / (B * H) / T, S, rows


def capacity_loss_bwd_cuda(rows, S, M: float, g, H: int):
    """Launch the backward kernel. rows (log beta) and S [B*H, T]
    float32 on the card, as the forward returned them, g a float32 CUDA
    scalar (the loss's incoming gradient, read by the kernel), H the
    gates' heads. Returns dL/dlb [B, T, H]."""
    build.check_device(rows)
    BH, T = rows.shape
    if BH % H:
        raise ValueError(f"{BH} rows are not a multiple of H={H}")
    dev = rows.device
    build.check_tensor("rows", rows, (BH, T), torch.float32, dev)
    build.check_tensor("S", S, (BH, T), torch.float32, dev)
    build.check_tensor("g", g, (), torch.float32, dev)
    dlb = torch.empty((BH // H, T, H), dtype=torch.float32, device=dev)
    n_items, n_groups = bwd_plan(T, BH)
    err = build.library().capacity_loss_bwd_launch(
        rows.data_ptr(), S.data_ptr(), g.data_ptr(), dlb.data_ptr(),
        BH // H, H, T, n_items, n_groups, float(M),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "capacity_loss_bwd")
    return dlb


class CapacityLoss(torch.autograd.Function):
    """L_cap from log_beta through the forward kernel, with the backward
    kernel as its gradient. ``on_launch(name)`` is called once per
    kernel launch (``kernels.ops`` counts them)."""

    @staticmethod
    def forward(ctx, log_beta, M, on_launch):
        lb = log_beta.float().contiguous()
        on_launch("capacity_loss")
        loss, S, rows = capacity_loss_fwd_cuda(lb, M)
        ctx.save_for_backward(rows, S)
        ctx.M, ctx.H, ctx.on_launch = M, lb.shape[2], on_launch
        return loss

    @staticmethod
    def backward(ctx, g):
        rows, S = ctx.saved_tensors
        ctx.on_launch("capacity_loss_bwd")
        dlb = capacity_loss_bwd_cuda(rows, S, ctx.M, g.float().contiguous(),
                                     ctx.H)
        return dlb, None, None
