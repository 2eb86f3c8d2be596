"""Capacity loss L_cap (paper Eq. 5): the CUDA kernels' wrappers, the
autograd function that joins them, and their plain PyTorch versions.

Replaces the Pallas kernel ``capacity_loss_pallas``
(``repro/kernels/capacity_loss.py``), which is forward-only; the
kernels are ``csrc/capacity_loss.cu``, a forward and a backward. With
lb = log beta [B, T, H] float32 and S_t = sum_{i<=t} exp((t-i) lb_i)
per (b, h), L_cap = mean over (b, h) of (1/T) sum_t max(0, S_t - M)/(t+1).
The forward keeps S [B*H, T] as the residual its backward reads.

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


def capacity_loss_fwd_cuda(log_beta, M: float):
    """Launch the forward kernel. log_beta: contiguous float32 CUDA
    [B, T, H]. Returns (loss scalar, S [B*H, T] float32)."""
    build.check_device(log_beta)
    B, T, H = log_beta.shape
    build.check_tensor("log_beta", log_beta, (B, T, H), torch.float32,
                       log_beta.device)
    lb = _rows(log_beta)
    n_tiles = -(-T // 128)
    S = torch.empty((B * H, T), dtype=torch.float32, device=lb.device)
    partial = torch.empty((B * H, n_tiles), dtype=torch.float32,
                          device=lb.device)
    err = build.library().capacity_loss_fwd_launch(
        lb.data_ptr(), S.data_ptr(), partial.data_ptr(), B * H, T, float(M),
        torch.cuda.current_stream(lb.device).cuda_stream)
    build.check(err, "capacity_loss_fwd")
    return partial.sum() / (B * H) / T, S


def capacity_loss_bwd_cuda(log_beta, S, M: float, g):
    """Launch the backward kernel. log_beta [B, T, H] and S [B*H, T]
    float32 on the card, g a float32 CUDA scalar (the loss's incoming
    gradient, read by the kernel). Returns dL/dlb [B, T, H]."""
    build.check_device(log_beta)
    B, T, H = log_beta.shape
    dev = log_beta.device
    build.check_tensor("log_beta", log_beta, (B, T, H), torch.float32, dev)
    build.check_tensor("S", S, (B * H, T), torch.float32, dev)
    build.check_tensor("g", g, (), torch.float32, dev)
    lb = _rows(log_beta)
    dlb = torch.empty((B, T, H), dtype=torch.float32, device=dev)
    err = build.library().capacity_loss_bwd_launch(
        lb.data_ptr(), S.data_ptr(), g.data_ptr(), dlb.data_ptr(), B, H, T,
        float(M), torch.cuda.current_stream(dev).cuda_stream)
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
        loss, S = capacity_loss_fwd_cuda(lb, M)
        ctx.save_for_backward(lb, S)
        ctx.M, ctx.on_launch = M, on_launch
        return loss

    @staticmethod
    def backward(ctx, g):
        lb, S = ctx.saved_tensors
        ctx.on_launch("capacity_loss_bwd")
        dlb = capacity_loss_bwd_cuda(lb, S, ctx.M, g.float().contiguous())
        return dlb, None, None
