"""Eviction policies over the bounded slot cache.

Ported from ``repro/core/policies.py``: TRIM-KV and the paper's
baselines. A policy exposes keep_scores(cache, t) -> [B, Hkv, M]
(higher = keep, empty slots -1e30), chunk_scores(...) for freshly
prefilled chunk tokens, decode_update(cache, probs_kv, active=None)
and needs_attn (whether decode must hand it attention probabilities:
H2O, SnapKV and R-KV do, which is the paper's Table 6 cost claim).
``t`` may be an int, a scalar or a [B] per-lane tensor.

decode_update writes the cache's ``aux`` IN PLACE and returns the same
dict, as cache_insert does: the serving step programs (serve.graphs)
keep the caches as static buffers. The dense block's decode raises
where a policy breaks this.

Baselines, after the papers cited in TRIM-KV Sec 5:
  StreamingLLM (Xiao+23): sinks + recency.
  H2O (Zhang+23): accumulated attention mass + recency floor.
  SnapKV (Li+24c): obs-window pooled attention at prefill, recency decode.
  R-KV (Cai+25): attention importance + key-diversity redundancy.
  KeyDiff (Park+25): pure key diversity.
  FullKV: no eviction (the budget must cover the sequence).
All scores are float32, with the JAX package's constants: BIG + pos is
1e30 in float32 (so SnapKV's recent slots tie), norm01's range floor is
1e-6.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.cache import lane_t

NEG_INF = -1e30
BIG = 1e30


def _mask_empty(scores, pos):
    return torch.where(pos >= 0, scores, torch.full_like(scores, NEG_INF))


def _key_diversity(k, pos):
    """Negative max cosine similarity to any other cached key, float32.
    k: [B, H, M, D] -> [B, H, M]; higher = more diverse = keep. The
    diagonal and pairs with an empty slot read -1, so a slot with no
    other valid slot scores 1."""
    kf = k.float()
    kn = kf / (torch.linalg.vector_norm(kf, dim=-1, keepdim=True) + 1e-6)
    sim = torch.matmul(kn, kn.transpose(-1, -2))            # [B,H,M,M]
    valid = pos >= 0
    M = sim.shape[-1]
    eye = torch.eye(M, dtype=torch.bool, device=sim.device)
    pair_ok = valid[..., None, :] & valid[..., :, None] & ~eye
    sim = torch.where(pair_ok, sim, torch.full_like(sim, -1.0))
    return -sim.amax(dim=-1)


def _lane_probs(probs_kv, active):
    """Zero the attention-aux contribution of inactive lanes, so a
    retired or empty lane's accumulated mass stays frozen (the policy's
    own guarantee, whatever the block layer does)."""
    if active is None:
        return probs_kv
    return torch.where(active[:, None, None], probs_kv,
                       torch.zeros_like(probs_kv))


def _accumulate(cache, probs_kv, active):
    """aux += probs_kv on the lanes in ``active``, in place (H2O and R-KV
    decode_update)."""
    cache["aux"].add_(_lane_probs(probs_kv, active))
    return cache


def _recent(pos, t, window):
    return (lane_t(t, pos.device) - pos) < window


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

    def decode_update(self, cache, probs_kv, active=None):
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


@dataclasses.dataclass(frozen=True)
class StreamingLLM(Policy):
    name: str = "streaming_llm"

    def keep_scores(self, cache, t):
        pos = cache["pos"]
        s = pos.float()                                     # newer = keep
        s = torch.where(pos < self.sink_tokens, torch.full_like(s, BIG), s)
        return _mask_empty(s, pos)


@dataclasses.dataclass(frozen=True)
class H2O(Policy):
    """Heavy-hitter oracle: accumulated attention mass (aux) + recency."""
    name: str = "h2o"
    needs_attn: bool = True

    def keep_scores(self, cache, t):
        pos, s = cache["pos"], cache["aux"]
        s = torch.where(_recent(pos, t, self.recent_window),
                        torch.full_like(s, BIG), s)
        return _mask_empty(s, pos)

    def decode_update(self, cache, probs_kv, active=None):
        return _accumulate(cache, probs_kv, active)


@dataclasses.dataclass(frozen=True)
class SnapKV(Policy):
    """Prefill: keep tokens most attended by the obs-window queries
    (aux = pooled obs attention, set by the block). Decode: recency."""
    name: str = "snapkv"
    needs_attn: bool = True

    def keep_scores(self, cache, t):
        pos = cache["pos"]
        s = torch.where(_recent(pos, t, self.recent_window),
                        BIG + pos.float(), cache["aux"])
        return _mask_empty(s, pos)


@dataclasses.dataclass(frozen=True)
class RKV(Policy):
    """R-KV: lam * attention-importance + (1-lam) * key-diversity."""
    name: str = "rkv"
    needs_attn: bool = True
    rkv_lambda: float = 0.5

    def _combine(self, imp, div, pos, t):
        valid = pos >= 0

        def norm01(x):
            lo = torch.where(valid, x, torch.full_like(x, BIG)).amin(
                dim=-1, keepdim=True)
            hi = torch.where(valid, x, torch.full_like(x, -BIG)).amax(
                dim=-1, keepdim=True)
            return (x - lo) / torch.clamp(hi - lo, min=1e-6)

        s = (self.rkv_lambda * norm01(imp)
             + (1 - self.rkv_lambda) * norm01(div))
        s = torch.where(_recent(pos, t, self.recent_window),
                        torch.full_like(s, BIG), s)
        return _mask_empty(s, pos)

    def keep_scores(self, cache, t):
        div = _key_diversity(cache["k"], cache["pos"])
        return self._combine(cache["aux"], div, cache["pos"], t)

    def decode_update(self, cache, probs_kv, active=None):
        return _accumulate(cache, probs_kv, active)


@dataclasses.dataclass(frozen=True)
class KeyDiff(Policy):
    """Query-agnostic key-diversity eviction (paper App. B)."""
    name: str = "keydiff"

    def keep_scores(self, cache, t):
        pos = cache["pos"]
        div = _key_diversity(cache["k"], pos)
        div = torch.where(_recent(pos, t, self.recent_window),
                          torch.full_like(div, BIG), div)
        return _mask_empty(div, pos)


@dataclasses.dataclass(frozen=True)
class FullKV(Policy):
    """No eviction: keep score = position + 2, so the oldest is evicted
    only on true overflow (the budget should cover the sequence)."""
    name: str = "full"

    def keep_scores(self, cache, t):
        pos = cache["pos"]
        return _mask_empty(pos.float() + 2.0, pos)


POLICIES = {
    "trimkv": TrimKV,
    "streaming_llm": StreamingLLM,
    "h2o": H2O,
    "snapkv": SnapKV,
    "rkv": RKV,
    "keydiff": KeyDiff,
    "full": FullKV,
}


def make_policy(serve_cfg) -> Policy:
    """The policy ServeConfig.policy names; KeyError for an unknown
    name, as in the JAX package."""
    return POLICIES[serve_cfg.policy](recent_window=serve_cfg.recent_window,
                                      sink_tokens=serve_cfg.sink_tokens)
