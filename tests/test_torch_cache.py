"""The port's slot cache against the JAX package's: cache_insert (Alg. 1
eviction) and cache_topm_merge (the prefill merge) under the TRIM-KV
keep score.

Discrete outcomes must match exactly — every slot's pos, k, v, beta
and aux, hence every victim — with tied scores (beta = 1, the default
gates, where the tie-break alone picks the victim) and with spread
(perturbed) beta. Inputs are drawn with numpy and handed to both. The
JAX package's cache_insert runs jitted per (policy, incoming_score):
one compile a shape, where an eager call compiles each operation.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cache as jcache
from repro.core.policies import TrimKV as JTrimKV
from repro_torch.core import cache as tcache
from repro_torch.core.policies import TrimKV

B, H, M, D = 2, 2, 8, 4
# the heuristic policies' windows in test_cache_insert_admits_the_token_*
HEURISTIC_KW = dict(recent_window=8, sink_tokens=2)


@functools.lru_cache(maxsize=None)
def _jax_insert(policy="trimkv", incoming_score=None):
    """jcache.cache_insert under the JAX policy's keep score, jitted."""
    from repro.core.policies import POLICIES as JPOL
    keep = (JTrimKV() if policy == "trimkv" else
            JPOL[policy](**HEURISTIC_KW)).keep_scores
    return jax.jit(lambda c, k, v, beta, t, aux=None: jcache.cache_insert(
        c, k, v, beta, t, keep, incoming_score=incoming_score,
        incoming_aux=aux))


def _cache(rng, beta_mode, t=20):
    pos = np.full((B, H, M), -1, np.int32)
    pos[0] = np.stack([rng.choice(t, M, replace=False) for _ in range(H)])
    pos[1, :, :5] = np.stack([rng.choice(t, 5, replace=False)
                              for _ in range(H)])
    beta = (np.ones((B, H, M), np.float32) if beta_mode == "tied" else
            rng.uniform(0.5, 1.0, (B, H, M)).astype(np.float32))
    return {"k": rng.randn(B, H, M, D).astype(np.float32),
            "v": rng.randn(B, H, M, D).astype(np.float32),
            "beta": beta, "pos": pos,
            "aux": np.zeros((B, H, M), np.float32)}


@jax.jit
def _jax_merge(c, k_c, v_c, beta_c, pos_c, aux_c, t_end):
    """The JAX package's TRIM-KV chunk scores and top-M merge, jitted."""
    jpol = JTrimKV()
    js = jpol.chunk_scores(pos_c=pos_c, beta_c=beta_c, aux_c=aux_c, k_c=k_c,
                           t=t_end)
    return jcache.cache_topm_merge(c, k_c, v_c, beta_c, pos_c, aux_c, t_end,
                                   jpol.keep_scores, js)


def _to_jax(c):
    return {k: jnp.asarray(v) for k, v in c.items()}


def _to_torch(c):
    return {k: torch.as_tensor(v).clone() for k, v in c.items()}


def _assert_same(got, want):
    for name in ("pos", "k", "v", "beta", "aux"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)


@pytest.mark.parametrize("beta_mode", ["tied", "perturbed"])
@pytest.mark.parametrize("lane_clock", [False, True])
def test_cache_insert_sequence_matches_jax(beta_mode, lane_clock):
    """Twelve inserts into a partly filled cache: empty slots fill
    first, then the lowest keep score (first index on ties) goes."""
    rng = np.random.RandomState(0)
    c0 = _cache(rng, beta_mode)
    cj, ct = _to_jax(c0), _to_torch(c0)
    tpol = TrimKV()
    t = np.array([20, 23], np.int32) if lane_clock else np.int32(20)
    for step in range(12):
        k_t = rng.randn(B, H, D).astype(np.float32)
        v_t = rng.randn(B, H, D).astype(np.float32)
        beta_t = (np.ones((B, H), np.float32) if beta_mode == "tied" else
                  rng.uniform(0.5, 1.0, (B, H)).astype(np.float32))
        ts = t + step
        cj = _jax_insert(incoming_score=1.0)(
            cj, jnp.asarray(k_t), jnp.asarray(v_t), jnp.asarray(beta_t),
            jnp.asarray(ts))
        out = tcache.cache_insert(ct, torch.as_tensor(k_t),
                                  torch.as_tensor(v_t),
                                  torch.as_tensor(beta_t),
                                  torch.as_tensor(ts), tpol.keep_scores,
                                  incoming_score=1.0)
        assert out is ct                     # updated in place
        _assert_same(ct, cj)


def test_cache_insert_writes_nothing_when_incoming_loses():
    """An incoming score below every kept score leaves a full lane
    untouched, while a lane with an empty slot still takes the token."""
    rng = np.random.RandomState(1)
    c0 = _cache(rng, "perturbed")
    cj, ct = _to_jax(c0), _to_torch(c0)
    k_t = rng.randn(B, H, D).astype(np.float32)
    beta_t = np.full((B, H), 0.9, np.float32)
    cj = _jax_insert(incoming_score=0.0)(
        cj, jnp.asarray(k_t), jnp.asarray(k_t), jnp.asarray(beta_t), 20)
    tcache.cache_insert(ct, torch.as_tensor(k_t), torch.as_tensor(k_t),
                        torch.as_tensor(beta_t), 20, TrimKV().keep_scores,
                        incoming_score=0.0)
    _assert_same(ct, cj)
    for name in ("pos", "k", "v", "beta"):
        np.testing.assert_array_equal(ct[name][0].numpy(), c0[name][0])
    assert (ct["pos"][1] == 20).sum(dim=-1).tolist() == [1, 1]


@pytest.mark.parametrize("beta_mode", ["tied", "perturbed"])
@pytest.mark.parametrize("lane_clock", [False, True])
def test_cache_topm_merge_matches_jax(beta_mode, lane_clock):
    """Top-M of (cache ∪ chunk) with a padded chunk tail; ties keep the
    cache, then the earliest chunk tokens."""
    rng = np.random.RandomState(2)
    C = 6
    c0 = _cache(rng, beta_mode)
    t_end = np.array([25, 24], np.int32) if lane_clock else np.int32(25)
    pos_c = np.broadcast_to((20 + np.arange(C, dtype=np.int32)),
                            (B, H, C)).copy()
    pos_c[1, :, 5:] = -1                     # padded tail on lane 1
    k_c = rng.randn(B, H, C, D).astype(np.float32)
    v_c = rng.randn(B, H, C, D).astype(np.float32)
    beta_c = (np.ones((B, H, C), np.float32) if beta_mode == "tied" else
              rng.uniform(0.5, 1.0, (B, H, C)).astype(np.float32))
    aux_c = np.zeros((B, H, C), np.float32)
    tpol = TrimKV()
    jargs = [jnp.asarray(a) for a in (k_c, v_c, beta_c, pos_c, aux_c)]
    targs = [torch.as_tensor(a) for a in (k_c, v_c, beta_c, pos_c, aux_c)]
    ts = tpol.chunk_scores(pos_c=targs[3], beta_c=targs[2], aux_c=targs[4],
                           k_c=targs[0], t=torch.as_tensor(t_end))
    want = _jax_merge(_to_jax(c0), *jargs, jnp.asarray(t_end))
    got = tcache.cache_topm_merge(_to_torch(c0), *targs,
                                  torch.as_tensor(t_end), tpol.keep_scores,
                                  ts)
    _assert_same(got, want)
    assert (got["pos"][1] != 25).all()       # the padded token never wins


def test_cache_len_matches_jax():
    c0 = _cache(np.random.RandomState(3), "tied")
    np.testing.assert_array_equal(
        tcache.cache_len(_to_torch(c0)).numpy(),
        np.asarray(jcache.cache_len(_to_jax(c0))))
    np.testing.assert_array_equal(
        tcache.cache_len(_to_torch(c0), per_lane=True).numpy(),
        np.asarray(jcache.cache_len(_to_jax(c0), per_lane=True)))


def _nan_cache(case):
    """One lane, two kv heads of four slots filled at t 0..3; kv head 0
    holds a NaN beta (in one slot, in every slot, or beside an empty
    slot), kv head 1 finite betas."""
    beta = np.array([[[0.9, np.nan, 0.5, 0.7], [0.9, 0.3, 0.8, 0.7]]],
                    np.float32)
    pos = np.broadcast_to(np.arange(4, dtype=np.int32), (1, 2, 4)).copy()
    if case == "every slot":
        beta[0, 0] = np.nan
    if case == "beside an empty slot":
        pos[0, 0, 3] = -1
    rng = np.random.RandomState(4)
    return {"k": rng.randn(1, 2, 4, D).astype(np.float32),
            "v": rng.randn(1, 2, 4, D).astype(np.float32),
            "beta": beta, "pos": pos, "aux": np.zeros((1, 2, 4), np.float32)}


@pytest.mark.parametrize("case", ["one slot", "every slot",
                                  "beside an empty slot"])
def test_cache_insert_nan_beta_freezes_the_head(case):
    """A NaN keep score follows jnp.argmin: the first NaN is the victim,
    its score NaN loses to the incoming token, so that kv head writes
    nothing (not even into an empty slot) and the other evicts as usual."""
    c0 = _nan_cache(case)
    rng = np.random.RandomState(5)
    k_t = rng.randn(1, 2, D).astype(np.float32)
    beta_t = np.full((1, 2), 0.95, np.float32)
    cj = _jax_insert(incoming_score=1.0)(
        _to_jax(c0), jnp.asarray(k_t), jnp.asarray(k_t), jnp.asarray(beta_t),
        4)
    ct = tcache.cache_insert(_to_torch(c0), torch.as_tensor(k_t),
                             torch.as_tensor(k_t), torch.as_tensor(beta_t), 4,
                             TrimKV().keep_scores, incoming_score=1.0)
    _assert_same(ct, cj)
    for name in ("pos", "k", "v", "beta", "aux"):
        np.testing.assert_array_equal(ct[name][0, 0].numpy(), c0[name][0, 0])
    assert ct["pos"][0, 1].tolist() == [0, 4, 2, 3]


HEURISTIC = ("streaming_llm", "h2o", "snapkv", "rkv", "keydiff", "full")


@pytest.mark.parametrize("name", HEURISTIC)
def test_cache_insert_admits_the_token_under_heuristic_policies(name):
    """incoming_score None (+1e30) admits the new token under every
    heuristic policy, also where every slot is recent and so scores
    1e30 itself (lane 0, a recency window over the whole cache); the
    incoming aux lands in the victim's slot. Eight inserts against the
    JAX package, identical slots."""
    from repro_torch.core.policies import POLICIES as TPOL
    rng = np.random.RandomState(6)
    c0 = _cache(rng, "perturbed")
    c0["pos"][0] = np.arange(12, 20, dtype=np.int32)   # all recent at t 20
    c0["aux"] = rng.uniform(0, 1, (B, H, M)).astype(np.float32)
    tpol = TPOL[name](**HEURISTIC_KW)
    cj, ct = _to_jax(c0), _to_torch(c0)
    for step in range(8):
        k_t = rng.randn(B, H, D).astype(np.float32)
        aux_t = rng.uniform(0, 1, (B, H)).astype(np.float32)
        beta_t = rng.uniform(0.5, 1.0, (B, H)).astype(np.float32)
        ts = np.array([20, 21], np.int32) + step
        cj = _jax_insert(name)(cj, jnp.asarray(k_t), jnp.asarray(k_t),
                               jnp.asarray(beta_t), jnp.asarray(ts),
                               jnp.asarray(aux_t))
        tcache.cache_insert(ct, torch.as_tensor(k_t), torch.as_tensor(k_t),
                            torch.as_tensor(beta_t), torch.as_tensor(ts),
                            tpol.keep_scores,
                            incoming_aux=torch.as_tensor(aux_t))
        _assert_same(ct, cj)
        assert ((ct["pos"] == torch.as_tensor(ts)[:, None, None])
                .sum(-1) == 1).all(), "the new token was not admitted"
        got_aux = ct["aux"][ct["pos"] == torch.as_tensor(ts)[:, None, None]]
        np.testing.assert_array_equal(got_aux.numpy(), aux_t.reshape(-1))
