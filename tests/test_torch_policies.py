"""The port's eviction policies and the dense block's attention-aux paths
against the JAX package's.

Policies: keep_scores, chunk_scores and decode_update of all seven on
seeded numpy caches (a full lane, a lane with empty slots, a lane whose
only valid slot is alone, so _key_diversity has no other key), under a
scalar and a [B] clock. Blocks: decode (with an active mask), single-shot
prefill and ragged chunked prefill (n_valid with a 0 row and a row
shorter than obs_window) under the policies that read attention
(H2O, SnapKV, R-KV), on the smoke config of trimkv-paper-4b with the JAX
package's weights; the JAX side runs attn_impl="pallas" in interpret
mode, so its probs, p_new and probs_cache come from the Pallas kernels'
path, and the port runs the plain PyTorch versions.

Floats agree within 1e-4 absolute and relative; slot positions and
victims (the first argmin of the keep scores) are identical.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import policies as jpol
from repro.models import blocks as JB
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.core import policies as tpol
from repro_torch.models import blocks as TB

ARCH = "trimkv-paper-4b"
TOL = dict(atol=1e-4, rtol=1e-4)
NAMES = tuple(jpol.POLICIES)
ATTN_POLICIES = ("h2o", "snapkv", "rkv")
# small windows, so that recency, sinks and scores all decide something
KW = dict(recent_window=6, sink_tokens=2)


def test_the_port_has_every_policy():
    assert tuple(tpol.POLICIES) == NAMES
    for name in NAMES:
        j, t = jpol.POLICIES[name](**KW), tpol.POLICIES[name](**KW)
        assert (t.name, t.needs_attn) == (j.name, j.needs_attn)
    with pytest.raises(KeyError):
        tpol.make_policy(type("S", (), dict(policy="lru", **KW))())


# ------------------------------------------------------- policy level

B, H, M, D, T_NOW = 3, 2, 8, 4, 40


def _cache(seed):
    """Lane 0 full, lane 1 with three empty slots per head, lane 2 with
    one valid slot in head 0 and none in head 1."""
    rng = np.random.RandomState(seed)
    pos = np.full((B, H, M), -1, np.int32)
    for h in range(H):
        pos[0, h] = rng.choice(T_NOW - 3, M, replace=False)
        pos[1, h, :5] = rng.choice(T_NOW - 3, 5, replace=False)
    pos[2, 0, 3] = 7
    return {"k": rng.randn(B, H, M, D).astype(np.float32),
            "v": rng.randn(B, H, M, D).astype(np.float32),
            "beta": rng.uniform(0.5, 1.0, (B, H, M)).astype(np.float32),
            "pos": pos,
            "aux": rng.uniform(0.0, 2.0, (B, H, M)).astype(np.float32)}


def _jax(c):
    return {k: jnp.asarray(v) for k, v in c.items()}


def _torch(c):
    return {k: torch.as_tensor(v).clone() for k, v in c.items()}


def _clocks():
    return [("scalar", T_NOW), ("lanes", np.array([40, 37, 45], np.int32))]


def _assert_scores(got, want):
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_allclose(got, want, **TOL)
    # the victim: the first lowest keep score of each (lane, head)
    np.testing.assert_array_equal(got.argmin(-1), want.argmin(-1))


@pytest.mark.parametrize("clock", _clocks(), ids=lambda c: c[0])
@pytest.mark.parametrize("name", NAMES)
def test_keep_scores_match_jax(name, clock):
    t = clock[1]
    c = _cache(0)
    want = jpol.POLICIES[name](**KW).keep_scores(_jax(c), jnp.asarray(t))
    got = tpol.POLICIES[name](**KW).keep_scores(_torch(c),
                                                torch.as_tensor(t))
    _assert_scores(got, want)


@pytest.mark.parametrize("name", NAMES)
def test_chunk_scores_match_jax(name):
    """A pseudo-cache of 6 chunk tokens, the last two padding (-1), at
    per-lane ends of the chunk."""
    rng = np.random.RandomState(1)
    C = 6
    t_end = np.array([33, 20, 7], np.int32)
    pos_c = (t_end[:, None, None] - C + 1 + np.arange(C)).astype(np.int32)
    pos_c = np.broadcast_to(pos_c, (B, H, C)).copy()
    pos_c[..., 4:] = -1
    kw = dict(pos_c=pos_c,
              beta_c=rng.uniform(0.5, 1.0, (B, H, C)).astype(np.float32),
              aux_c=rng.uniform(0.0, 1.0, (B, H, C)).astype(np.float32),
              k_c=rng.randn(B, H, C, D).astype(np.float32))
    want = jpol.POLICIES[name](**KW).chunk_scores(
        **{k: jnp.asarray(v) for k, v in kw.items()}, t=jnp.asarray(t_end))
    got = tpol.POLICIES[name](**KW).chunk_scores(
        **{k: torch.as_tensor(v) for k, v in kw.items()},
        t=torch.as_tensor(t_end))
    _assert_scores(got, want)


@pytest.mark.parametrize("active", [None, [True, False, True]],
                         ids=["all", "masked"])
@pytest.mark.parametrize("name", NAMES)
def test_decode_update_matches_jax_in_place(name, active):
    """decode_update writes aux in place (the step programs keep the
    caches as static buffers) and leaves every other leaf alone; an
    inactive lane's aux is bit-identical."""
    c = _cache(2)
    probs = np.random.RandomState(3).uniform(0, 1, (B, H, M)).astype(
        np.float32)
    act = None if active is None else np.array(active)
    want = jpol.POLICIES[name](**KW).decode_update(
        _jax(c), jnp.asarray(probs),
        active=None if act is None else jnp.asarray(act))
    tc = _torch(c)
    aux = tc["aux"]
    got = tpol.POLICIES[name](**KW).decode_update(
        tc, torch.as_tensor(probs),
        active=None if act is None else torch.as_tensor(act))
    assert got is tc and got["aux"] is aux
    for k in c:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)
    if act is not None:
        np.testing.assert_array_equal(got["aux"][1].numpy(), c["aux"][1])


def test_key_diversity_matches_jax_on_lone_and_empty_slots():
    c = _cache(4)
    want = np.asarray(jpol._key_diversity(jnp.asarray(c["k"]),
                                          jnp.asarray(c["pos"])))
    got = tpol._key_diversity(torch.as_tensor(c["k"]),
                              torch.as_tensor(c["pos"])).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # no other valid key: every pair reads -1, so the score is 1
    assert got[2, 0, 3] == 1.0 and (got[2, 1] == 1.0).all()


# -------------------------------------------------------- block level


@functools.lru_cache(maxsize=None)
def _layer():
    """Layer 0 of the smoke config, perturbed gate biases: (cfg_j, JAX
    params and gate of the layer, cfg, the port's block)."""
    torch.set_num_threads(1)
    cfg_j, cfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    params = jax.device_get(JT.init_params(jax.random.PRNGKey(0), cfg_j))
    gates = jax.device_get(JT.init_gate_params(jax.random.PRNGKey(1), cfg_j))
    g0 = dict(gates["layers"][0])
    g0["b"] = np.random.RandomState(7).uniform(
        2.0, 8.0, g0["b"].shape).astype(np.float32)
    gates = {"layers": (g0,), "tail": gates["tail"]}
    model = bridge.params_from_jax(params, cfg, device="cpu")
    bridge.gates_from_jax(gates, cfg, model)
    p = jax.tree.map(jnp.asarray, bridge._per_layer(params, cfg)[0])
    g = jax.tree.map(jnp.asarray, bridge._per_layer(gates, cfg)[0])
    return cfg_j, p, g, cfg, model.layers[0]


def _block_cache(rng, cfg, Bn, Mn, t):
    """A slot cache below each lane's clock t [Bn], a quarter empty."""
    Hk, Dh = cfg.num_kv_heads, cfg.head_dim
    pos = np.stack([np.stack([rng.choice(t[b], Mn, replace=False)
                              for _ in range(Hk)]) for b in range(Bn)])
    pos = np.where(rng.rand(Bn, Hk, Mn) < 0.25, -1, pos).astype(np.int32)
    return {"k": rng.randn(Bn, Hk, Mn, Dh).astype(np.float32),
            "v": rng.randn(Bn, Hk, Mn, Dh).astype(np.float32),
            "beta": rng.uniform(0.5, 1.0, (Bn, Hk, Mn)).astype(np.float32),
            "pos": pos,
            "aux": rng.uniform(0.0, 2.0, (Bn, Hk, Mn)).astype(np.float32)}


def _assert_block(got, want):
    (gx, gs), (wx, ws) = got, want
    np.testing.assert_allclose(gx.numpy(), np.asarray(wx), **TOL)
    ws = jax.device_get(ws)
    np.testing.assert_array_equal(gs["pos"].numpy(), ws["pos"],
                                  err_msg="pos")
    for k in ("k", "v", "beta", "aux"):
        np.testing.assert_allclose(gs[k].numpy(), ws[k], err_msg=k, **TOL)


def _policies(name):
    return jpol.POLICIES[name](**KW), tpol.POLICIES[name](**KW)


@pytest.mark.parametrize("name", ATTN_POLICIES)
def test_block_decode_matches_jax(name):
    """One decode step of 3 lanes on their own clocks, lane 1 inactive:
    the kernel's probs feed decode_update before the insert and p_new
    is the new token's aux; the inactive lane's cache is bit-identical."""
    cfg_j, p, g, cfg, block = _layer()
    jp, tp = _policies(name)
    rng = np.random.RandomState(10)
    t = np.array([30, 25, 41], np.int32)
    c = _block_cache(rng, cfg, 3, 16, t)
    x = rng.randn(3, cfg.d_model).astype(np.float32)
    active = np.array([True, False, True])
    wx, ws, _ = JB.apply_block_decode(
        p, g, cfg_j, "global", jnp.asarray(x), _jax(c), jnp.asarray(t),
        policy=jp, attn_impl="pallas", active=jnp.asarray(active))
    gx, gs, _ = TB.apply_block_decode(
        block, cfg, torch.as_tensor(x), _torch(c), torch.as_tensor(t),
        policy=tp, active=torch.as_tensor(active))
    _assert_block((gx, gs), (wx, ws))
    for k in c:
        np.testing.assert_array_equal(gs[k][1].numpy(), c[k][1], err_msg=k)


class _RebindsAux(tpol.H2O):
    def decode_update(self, cache, probs_kv, active=None):
        cache["aux"] = cache["aux"] + probs_kv
        return cache


class _ReturnsNewCache(tpol.H2O):
    def decode_update(self, cache, probs_kv, active=None):
        return {**cache, "aux": cache["aux"] + probs_kv}


@pytest.mark.parametrize("policy_cls", [_RebindsAux, _ReturnsNewCache])
def test_block_decode_refuses_an_aux_not_written_in_place(policy_cls):
    """The serving step programs keep the caches as static buffers, so
    the block refuses a decode_update that rebinds aux or returns a new
    cache instead of writing aux in place."""
    _, _, _, cfg, block = _layer()
    rng = np.random.RandomState(11)
    t = np.array([30, 25], np.int32)
    c = _block_cache(rng, cfg, 2, 16, t)
    x = rng.randn(2, cfg.d_model).astype(np.float32)
    with pytest.raises(RuntimeError, match="in place"):
        TB.apply_block_decode(block, cfg, torch.as_tensor(x), _torch(c),
                              torch.as_tensor(t), policy=policy_cls(**KW))


@pytest.mark.parametrize("name", ATTN_POLICIES)
def test_block_prefill_matches_jax(name):
    """Single-shot prefill of 24 tokens into 16 empty slots: the chunk
    aux is the obs-window (8 queries) attention."""
    cfg_j, p, g, cfg, block = _layer()
    jp, tp = _policies(name)
    rng = np.random.RandomState(11)
    x = rng.randn(2, 24, cfg.d_model).astype(np.float32)
    empty = {"k": np.zeros((2, cfg.num_kv_heads, 16, cfg.head_dim),
                           np.float32),
             "v": np.zeros((2, cfg.num_kv_heads, 16, cfg.head_dim),
                           np.float32),
             "beta": np.ones((2, cfg.num_kv_heads, 16), np.float32),
             "pos": np.full((2, cfg.num_kv_heads, 16), -1, np.int32),
             "aux": np.zeros((2, cfg.num_kv_heads, 16), np.float32)}
    wx, ws, _ = JB.apply_block_prefill(
        p, g, cfg_j, "global", jnp.asarray(x), _jax(empty), policy=jp,
        budget=16, obs_window=8, attn_impl="pallas")
    gx, gs, _ = TB.apply_block_prefill(
        block, cfg, torch.as_tensor(x), _torch(empty), policy=tp, budget=16,
        obs_window=8)
    _assert_block((gx, gs), (wx, ws))


@pytest.mark.parametrize("name", ATTN_POLICIES)
def test_block_prefill_chunk_matches_jax(name):
    """A ragged chunk of 16 over a filled cache of 16 slots: n_valid
    [16, 0, 5, 12] (a frozen row, a row shorter than the obs window of
    8), per-lane start positions. The cache's aux gains the chunk
    queries' attention mass, the chunk tokens take the obs-window mean,
    and the frozen row keeps its cache bit-identically."""
    cfg_j, p, g, cfg, block = _layer()
    jp, tp = _policies(name)
    rng = np.random.RandomState(12)
    t0 = np.array([40, 30, 33, 50], np.int32)
    c = _block_cache(rng, cfg, 4, 16, t0)
    x = rng.randn(4, 16, cfg.d_model).astype(np.float32)
    nv = np.array([16, 0, 5, 12], np.int32)
    wx, ws, _ = JB.apply_block_prefill_chunk(
        p, g, cfg_j, "global", jnp.asarray(x), _jax(c), jnp.asarray(t0),
        policy=jp, obs_window=8, n_valid=jnp.asarray(nv),
        attn_impl="pallas")
    state = _torch(c)
    aux = state["aux"].clone()
    gx, gs, _ = TB.apply_block_prefill_chunk(
        block, cfg, torch.as_tensor(x), state, torch.as_tensor(t0),
        policy=tp, obs_window=8, n_valid=torch.as_tensor(nv))
    _assert_block((gx, gs), (wx, ws))
    assert torch.equal(state["aux"], aux)     # the input state is intact
    for k in c:
        np.testing.assert_array_equal(gs[k][1].numpy(), c[k][1], err_msg=k)


def test_obs_probs_chunk_lanes_matches_jax():
    """The per-lane obs-window signal alone, with a window: rows of
    every length, including one of 0 and one under W."""
    rng = np.random.RandomState(13)
    Bn, C, Hq, Hk, Dh, W = 4, 12, 4, 2, 8, 5
    q = rng.randn(Bn, C, Hq, Dh).astype(np.float32)
    k = rng.randn(Bn, C, Hk, Dh).astype(np.float32)
    t0 = np.array([3, 9, 0, 20], np.int32)
    nv = np.array([12, 3, 0, 7], np.int32)
    idx = np.arange(C)
    cp = np.where(idx[None] < nv[:, None], t0[:, None] + idx[None],
                  -1).astype(np.int32)
    start = t0 + nv - W
    want = JB._obs_probs_chunk_lanes(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(cp), jnp.asarray(nv),
        jnp.asarray(start), 4, W)
    got = TB._obs_probs_chunk_lanes(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(cp),
        torch.as_tensor(nv), torch.as_tensor(start), 4, W)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
