"""Training losses (paper Sec 4.2, Eqs. 4-6).

L = L_KL + L_NTP + lambda_cap * L_cap
  L_KL  : forward KL(teacher || student) over the vocab, token-averaged
  L_NTP : next-token cross-entropy of the gated student
  L_cap : hinge on effective cache occupancy S_t = sum_{i<=t} beta_i^{t-i}
          (per layer & kv-head): (1/T) sum_t (1/t) max(0, S_t - M)

Ported from ``repro/core/losses.py``. The vocab-heavy losses are
computed in chunks over time, each under ``torch.utils.checkpoint``, so
full [B, T, V] logits are never live. These are the plain versions: on
the card, training computes L_cap through the CUDA kernels of
``kernels/capacity_loss.py`` (``kernels.ops.capacity_loss_log``).
Hinges use ``torch.maximum`` against a tensor, whose gradient at a tie
is 0.5 as ``jnp.maximum``'s is.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import checkpointed


def _zero(like):
    return torch.zeros((), dtype=torch.float32, device=like.device)


def kl_and_ntp_from_hidden(h_student, h_teacher, unembed, labels, *,
                           vocab_size: int, chunk: int = 256,
                           use_kl: bool = True, use_ntp: bool = True):
    """Chunked-over-time forward-KL + next-token CE.

    h_*: [B, T, d]; unembed: the model's unembedding ``nn.Linear``
    (weight [Vp, d]); labels: [B, T] (next tokens, -1 = pad/ignored).
    Logits above vocab_size are masked. Returns (kl_mean, ntp_mean)
    scalars (per-valid-token averages)."""
    B, T, _ = h_student.shape
    w = unembed.weight
    Vp = w.shape[0]
    labels = torch.as_tensor(labels, device=h_student.device).long()
    vocab_mask = torch.arange(Vp, device=w.device) < vocab_size
    neg = torch.full((), -1e30, device=w.device)

    def one_chunk(hs_c, ht_c, lb_c):
        logit_s = torch.where(vocab_mask, F.linear(hs_c, w).float(), neg)
        logp_s = F.log_softmax(logit_s, dim=-1)
        valid = lb_c >= 0
        n_valid = valid.sum()
        kl = _zero(hs_c)
        if use_kl:
            logit_t = torch.where(vocab_mask, F.linear(ht_c, w).float(), neg)
            logp_t = F.log_softmax(logit_t, dim=-1)
            p_t = torch.exp(logp_t)
            kl_tok = torch.sum(p_t * (logp_t - logp_s), dim=-1)
            kl = torch.where(valid, kl_tok, 0.0).sum()
        ntp = _zero(hs_c)
        if use_ntp:
            lb_safe = torch.clamp(lb_c, min=0)
            ce_tok = -torch.gather(logp_s, -1, lb_safe[..., None])[..., 0]
            ntp = torch.where(valid, ce_tok, 0.0).sum()
        return kl, ntp, n_valid

    kl_sum, ntp_sum = _zero(h_student), _zero(h_student)
    n_sum = torch.zeros((), dtype=torch.long, device=h_student.device)
    for s in range(0, T, chunk):
        args = (h_student[:, s:s + chunk], h_teacher[:, s:s + chunk],
                labels[:, s:s + chunk])
        kl, ntp, n = checkpointed(one_chunk, *args)
        kl_sum, ntp_sum, n_sum = kl_sum + kl, ntp_sum + ntp, n_sum + n
    denom = torch.clamp(n_sum, min=1).float()
    return kl_sum / denom, ntp_sum / denom


def _hinge(S, M):
    return torch.maximum(S - M, torch.zeros((), device=S.device))


def capacity_loss_ref(beta, M: float):
    """O(T^2)-memory oracle. beta: [B, T, H] in [0,1].
    Returns scalar mean over (B, H) of (1/T) sum_t (1/t) max(0, S_t - M).
    """
    B, T, H = beta.shape
    b = beta.float().transpose(1, 2)                          # [B,H,T]
    t_idx = torch.arange(T, device=beta.device)
    dist = t_idx[:, None] - t_idx[None, :]                    # t - i
    causal = dist >= 0
    logb = torch.log(torch.maximum(b, torch.full((), 1e-30,
                                                 device=b.device)))
    expo = dist.float() * logb[:, :, None, :]                 # [B,H,T,T]
    expo = torch.where(causal, expo, -1e9)                    # pre-exp mask
    S = torch.exp(expo).sum(dim=-1)                           # [B,H,T]
    inv_t = 1.0 / (t_idx + 1).float()
    return (_hinge(S, M) * inv_t).mean(dim=-1).mean()


def capacity_loss_chunked(beta, M: float, *, block: int = 256,
                          log_beta=None):
    """Memory-efficient capacity loss: tiles the (t, i) triangle in
    ``block``-sized chunks, never materializing T x T, each row block
    under ``torch.utils.checkpoint``. Same math as capacity_loss_ref.
    beta: [B, T, H] (may be None when log_beta is given).

    Pass ``log_beta`` when available (the gates compute it natively):
    log(exp(log_beta)) has gradient 1/beta -> 1e30 as beta -> the e^-80
    clamp; the log-space path has bounded gradients throughout. Column
    blocks above a row block's diagonal are skipped: masked, they add
    exact zeros."""
    if log_beta is not None:
        logb = log_beta.float().transpose(1, 2)               # [B,H,T]
    else:
        b = beta.float().transpose(1, 2)
        logb = torch.log(torch.maximum(b, torch.full((), 1e-30,
                                                     device=b.device)))
    B, H, T = logb.shape
    n_blk = -(-T // block)
    pad = n_blk * block - T
    if pad:
        # padded columns are masked out below (-80 as in the JAX package)
        logb = F.pad(logb, (0, pad), value=-80.0)
    dev = logb.device
    ar = torch.arange(block, device=dev)

    def row_block(logb, ti):
        t_pos = ti * block + ar                               # [bt]
        S = torch.zeros((B, H, block), dtype=torch.float32, device=dev)
        for ii in range(ti + 1):
            i_pos = ii * block + ar                           # [bi]
            lb = logb[:, :, ii * block:(ii + 1) * block]
            dist = t_pos[:, None] - i_pos[None, :]            # [bt,bi]
            mask = (dist >= 0) & (i_pos[None, :] < T)
            # mask BEFORE exp: the upper triangle has dist<0, logb<0 ->
            # exp(+big) = inf, and inf x 0 in the backward is NaN
            expo = torch.where(mask, dist.float() * lb[:, :, None, :], -1e9)
            S = S + torch.exp(expo).sum(dim=-1)
        inv_t = 1.0 / (t_pos + 1).float()
        contrib = torch.where(t_pos < T, _hinge(S, M) * inv_t, 0.0)
        return contrib.sum(dim=-1)                            # [B,H]

    acc = torch.zeros((B, H), dtype=torch.float32, device=dev)
    for ti in range(n_blk):
        acc = acc + checkpointed(row_block, logb, ti)
    return acc.mean() / T
