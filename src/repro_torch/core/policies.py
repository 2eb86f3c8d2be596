"""Eviction policies over the bounded slot cache.

Ported from ``repro/core/policies.py``; only TRIM-KV so far. A policy
exposes keep_scores(cache, t) -> [B, Hkv, M] (higher = keep, empty
slots -1e30), chunk_scores(...) for freshly prefilled chunk tokens,
decode_update(cache, probs_kv) and needs_attn (whether decode must hand
it attention probabilities). ``t`` may be an int, a scalar or a [B]
per-lane tensor.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.cache import lane_t

NEG_INF = -1e30

# policies of the JAX package that the port has not reached yet
NOT_PORTED = ("streaming_llm", "h2o", "snapkv", "rkv", "keydiff", "full")


def _mask_empty(scores, pos):
    return torch.where(pos >= 0, scores, torch.full_like(scores, NEG_INF))


@dataclasses.dataclass(frozen=True)
class Policy:
    name: str = "base"
    needs_attn: bool = False
    recent_window: int = 32
    sink_tokens: int = 4

    def keep_scores(self, cache, t):
        raise NotImplementedError

    def chunk_scores(self, *, pos_c, beta_c, aux_c, k_c, t):
        """Score chunk tokens with the same formula as cached ones, by
        building a pseudo-cache."""
        pseudo = {"pos": pos_c, "beta": beta_c, "aux": aux_c, "k": k_c}
        return self.keep_scores(pseudo, t)

    def decode_update(self, cache, probs_kv):
        return cache


@dataclasses.dataclass(frozen=True)
class TrimKV(Policy):
    """The paper: keep score = beta_j^(t - pos_j) (Alg. 1 argmin),
    computed as exp(dist * log(max(beta, 1e-30))) in float32."""
    name: str = "trimkv"

    def keep_scores(self, cache, t):
        pos = cache["pos"]
        dist = (lane_t(t, pos.device) - pos).float()
        logb = torch.log(torch.clamp(cache["beta"], min=1e-30))
        return _mask_empty(torch.exp(dist * logb), pos)


POLICIES = {"trimkv": TrimKV}


def make_policy(serve_cfg) -> Policy:
    name = serve_cfg.policy
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"policy {name!r} is not ported to repro_torch yet; "
            f"ported: {tuple(POLICIES)}")
    if name not in POLICIES:
        raise KeyError(f"unknown policy {name!r}")
    return POLICIES[name](recent_window=serve_cfg.recent_window,
                          sink_tokens=serve_cfg.sink_tokens)
