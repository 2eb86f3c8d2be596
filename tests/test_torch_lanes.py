"""The port's continuous-batching lane layer against the JAX package's:
decode_step(active=), the ragged prefill_chunk_loop,
decode_segment_loop with n_real, mixed_step_loop, reset_lanes and
scrub_lanes, and phased admission into reset lanes (against the JAX
package's prefill of a fresh sub-state and install_lanes), on the
scheduler tests' tiny config (2 layers, d_model 64,
float32, gate bias 3, so beta spreads and eviction is decided by the
keep scores) with the JAX package's weights loaded through
repro_torch.bridge, JAX on attn_impl "xla".

Floats (hidden states, logits, cached k/v/beta) agree within 1e-5 of
their largest magnitude; ids, slot positions (hence victims), emitted,
n_emitted, active and ok are exactly equal; lanes that are inactive or
have n_valid 0 come back bit-identical to their state before the step.
The port's loops and admission drive the scheduler's own step programs
(serve.graphs.LanePrograms) eagerly on the CPU; on the card the
scheduler replays the same programs as CUDA graphs.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ServeConfig as JServeConfig
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import cache as jcache
from repro.core.policies import TrimKV as JTrimKV
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import ServeConfig, get_smoke_config
from repro_torch.core import cache as tcache
from repro_torch.core.policies import TrimKV
from repro_torch.models import transformer as T
from repro_torch.serve.graphs import LanePrograms

ARCH = "trimkv-paper-4b"
TINY = dict(num_layers=2, d_model=64, d_ff=128, num_heads=4, num_kv_heads=2,
            vocab_size=64, gate_bias_init=3.0)
BUDGET, CHUNK, B = 8, 8, 3
REL = 1e-5


@functools.lru_cache(maxsize=None)
def _setup():
    """(jax cfg, jax params, jax gates, port cfg, port model)."""
    torch.set_num_threads(1)
    cfg_j = dataclasses.replace(jax_smoke_config(ARCH), **TINY)
    cfg = dataclasses.replace(get_smoke_config(ARCH), **TINY)
    params = JT.init_params(jax.random.PRNGKey(0), cfg_j)
    gates = JT.init_gate_params(jax.random.PRNGKey(1), cfg_j)
    model = bridge.params_from_jax(jax.device_get(params), cfg, device="cpu")
    bridge.gates_from_jax(jax.device_get(gates), cfg, model)
    return cfg_j, params, gates, cfg, model


def _serve():
    return (JServeConfig(budget=BUDGET, prefill_chunk=CHUNK),
            ServeConfig(budget=BUDGET, prefill_chunk=CHUNK))


def _close(got, want, name=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= REL, f"{name}: {err:.3e} of the largest magnitude"


def _assert_states(got, want):
    """got: port state; want: JAX state. Slot positions exact, floats
    within REL."""
    cfg = _setup()[3]
    g = bridge.state_to_numpy(got, cfg)
    w = jax.device_get(want)
    np.testing.assert_array_equal(g["t"], w["t"])
    for gl, wl in zip(g["layers"], w["layers"]):
        np.testing.assert_array_equal(gl["pos"], wl["pos"], err_msg="pos")
        for name in ("k", "v", "beta"):
            _close(gl[name], wl[name], name)


def _clone(state):
    return {"t": state["t"].clone(),
            "layers": [{k: v.clone() for k, v in st.items()}
                       for st in state["layers"]]}


def _assert_lanes_frozen(after, before, lanes):
    for lane in lanes:
        assert torch.equal(after["t"][lane], before["t"][lane])
        for a, b in zip(after["layers"], before["layers"]):
            for k in a:
                assert torch.equal(a[k][lane], b[k][lane]), (lane, k)


def _to_jax_state(state):
    """The port's state in the JAX layout, as jax arrays."""
    return jax.tree.map(jnp.asarray,
                        bridge.state_to_numpy(state, _setup()[3]))


def _prompts(lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, TINY["vocab_size"], size=L).astype(np.int32)
            for L in lens]


def _grid(prompts):
    """Ragged prompts on one chunk grid: chunks [n, B, C], n_valid
    [n, B] (full chunks, each prompt's tail, then zeros)."""
    n = max(-(-p.size // CHUNK) for p in prompts)
    chunks = np.zeros((n, len(prompts), CHUNK), np.int32)
    nv = np.zeros((n, len(prompts)), np.int32)
    for b, p in enumerate(prompts):
        flat = np.zeros(n * CHUNK, np.int32)
        flat[: p.size] = p
        chunks[:, b] = flat.reshape(n, CHUNK)
        nv[:, b] = np.clip(p.size - np.arange(n) * CHUNK, 0, CHUNK)
    return chunks, nv


@functools.lru_cache(maxsize=None)
def _ragged_prefill():
    """Both sides' ragged chunked prefill of three prompts of 21, 9 and
    3 tokens from fresh states: (port state, port h_last, JAX state,
    JAX h_last)."""
    cfg_j, params, gates, cfg, model = _setup()
    sj, st = _serve()
    chunks, nv = _grid(_prompts([21, 9, 3]))
    js, jh = JT.prefill_chunk_loop(
        params, gates, cfg_j, jnp.asarray(chunks), jnp.asarray(nv),
        JT.init_decode_state(cfg_j, B, BUDGET), JTrimKV(), sj)
    ts, th = T.prefill_chunk_loop(model, cfg, torch.as_tensor(chunks),
                                  torch.as_tensor(nv),
                                  T.init_decode_state(cfg, B, BUDGET, "cpu"),
                                  TrimKV(), st)
    return ts, th, js, jh


def test_ragged_prefill_chunk_loop_matches_jax():
    """Three prompts of 3, 2 and 1 chunks on one grid: each row's last
    hidden state (carried across its empty chunks) and the whole state,
    evictions included."""
    ts, th, js, jh = _ragged_prefill()
    _close(th.numpy(), np.asarray(jh), "h_last")
    _assert_states(ts, js)


def test_zero_n_valid_rows_frozen_and_match_jax():
    """One chunk step with n_valid [8, 0, 3] on the prefilled lanes: row
    1 comes back bit-identical, the others match the JAX step."""
    cfg_j, params, gates, cfg, model = _setup()
    sj, st = _serve()
    ts, _, js, _ = _ragged_prefill()
    ts = _clone(ts)
    chunk = np.asarray(_prompts([CHUNK] * B, seed=1))
    nv = np.array([8, 0, 3], np.int32)
    before = _clone(ts)
    ts2, th = T._prefill_chunk_step(model, cfg, torch.as_tensor(chunk), ts,
                                    TrimKV(), st, n_valid=torch.as_tensor(nv))
    js2, jh = JT._prefill_chunk_step(params, gates, cfg_j,
                                     jnp.asarray(chunk), js, JTrimKV(), sj,
                                     n_valid=jnp.asarray(nv))
    _assert_lanes_frozen(ts2, before, [1])
    _assert_states(ts2, js2)
    _close(th.numpy()[[0, 2]], np.asarray(jh)[[0, 2]], "h_last")


def test_decode_step_active_matches_jax():
    """decode_step with lane 1 inactive: logits of every lane and the
    state match JAX; lane 1's caches and clock are bit-identical."""
    cfg_j, params, gates, cfg, model = _setup()
    ts, _, js, _ = _ragged_prefill()
    ts = _clone(ts)
    tok = np.array([5, 17, 42], np.int32)
    active = np.array([True, False, True])
    before = _clone(ts)
    ts2, tl = T.decode_step(model, cfg, ts, torch.as_tensor(tok), TrimKV(),
                            active=torch.as_tensor(active))
    js2, jl = JT.decode_step(params, gates, cfg_j, js, jnp.asarray(tok),
                             JTrimKV(), active=jnp.asarray(active))
    _close(tl.numpy(), np.asarray(jl), "logits")
    _assert_lanes_frozen(ts2, before, [1])
    _assert_states(ts2, js2)


def _lane_ops(n_emitted, max_new, eos):
    return (np.asarray(n_emitted, np.int32), np.asarray(max_new, np.int32),
            np.asarray(eos, np.int32))


def _assert_segment(got, want):
    """decode_segment_loop / mixed_step_loop outputs: the port's and
    JAX's (state, tok, keys, active, n_emitted, ids, emitted, ok)."""
    ts, ttok, tkeys, tact, tne, tids, tem, tok_ = got
    js, jtok, jkeys, jact, jne, jids, jem, jok = want
    np.testing.assert_array_equal(tkeys.numpy(), np.asarray(jkeys))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tem.numpy(), np.asarray(jem))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tact.numpy(), np.asarray(jact))
    np.testing.assert_array_equal(tne.numpy(), np.asarray(jne))
    np.testing.assert_array_equal(tok_.numpy(), np.asarray(jok))
    _assert_states(ts, js)


def test_decode_segment_loop_matches_jax():
    """A 6-step segment with n_real 4 over three lanes: lane 0 stops on
    its eos (its carried token), lane 1 at max_new, lane 2 is inactive
    throughout and stays bit-identical; the masked tail emits nothing."""
    cfg_j, params, gates, cfg, model = _setup()
    ts, th, js, _ = _ragged_prefill()
    ts = _clone(ts)
    tok = torch.argmax(T.compute_logits(model, cfg, th), dim=-1)
    active = np.array([True, True, False])
    n_emitted, max_new, eos = _lane_ops([0, 2, 0], [6, 4, 5],
                                        [int(tok[0]), -1, -1])
    before = _clone(ts)
    got = T.decode_segment_loop(model, cfg, ts, tok, np.zeros((B, 2)),
                                active, n_emitted, max_new, eos, 6,
                                TrimKV(), n_real=4)
    want = JT.decode_segment_loop(
        params, gates, cfg_j, js, jnp.asarray(tok.numpy(), jnp.int32),
        jnp.zeros((B, 2), jnp.uint32), jnp.asarray(active),
        jnp.asarray(n_emitted), jnp.asarray(max_new), jnp.asarray(eos), 6,
        JTrimKV(), n_real=jnp.int32(4))
    _assert_segment(got, want)
    _assert_lanes_frozen(got[0], before, [2])
    assert got[6].numpy()[:, 4:].sum() == 0


def test_mixed_step_loop_matches_jax():
    """Three interleaved steps: lane 0 decodes, lane 1 (reset) takes a
    2-chunk prompt and starts decoding at step 2, lane 2 idles."""
    cfg_j, params, gates, cfg, model = _setup()
    sj, st = _serve()
    ts, th, js, _ = _ragged_prefill()
    mask = np.array([False, True, False])
    ts = T.reset_lanes(_clone(ts), torch.as_tensor(mask))
    js = JT.reset_lanes(js, jnp.asarray(mask))
    tok = torch.argmax(T.compute_logits(model, cfg, th), dim=-1)
    active = np.array([True, False, False])
    n_emitted, max_new, eos = _lane_ops([1, 0, 0], [8, 8, 8], [-1] * B)
    chunks = np.zeros((3, B, CHUNK), np.int32)
    chunks[:2, 1] = _prompts([2 * CHUNK], seed=2)[0].reshape(2, CHUNK)
    cv = np.zeros((3, B), np.int32)
    cv[:2, 1] = [CHUNK, 5]
    finish = np.zeros((3, B), bool)
    finish[1, 1] = True
    got = T.mixed_step_loop(model, cfg, ts, tok, np.zeros((B, 2)), active,
                            n_emitted, max_new, eos, chunks, cv, finish,
                            np.zeros((B, 2)), TrimKV(), st)
    want = JT.mixed_step_loop(
        params, gates, cfg_j, js, jnp.asarray(tok.numpy(), jnp.int32),
        jnp.zeros((B, 2), jnp.uint32), jnp.asarray(active),
        jnp.asarray(n_emitted), jnp.asarray(max_new), jnp.asarray(eos),
        jnp.asarray(chunks), jnp.asarray(cv), jnp.asarray(finish),
        jnp.zeros((B, 2), jnp.uint32), JTrimKV(), sj)
    _assert_segment(got, want)
    assert got[6].numpy()[1].tolist() == [False, False, True]


@pytest.mark.parametrize("helper", ["reset", "scrub"])
def test_lane_helpers_match_jax(helper):
    """reset_lanes and scrub_lanes (in place in the port) on the same
    state in both layouts: pure data movement, so every leaf is exactly
    equal."""
    ts, _, _, _ = _ragged_prefill()
    cfg = _setup()[3]
    js = _to_jax_state(ts)
    mask = np.array([True, False, True])
    got = getattr(T, f"{helper}_lanes")(_clone(ts), torch.as_tensor(mask))
    want = getattr(JT, f"{helper}_lanes")(js, jnp.asarray(mask))
    g, w = bridge.state_to_numpy(got, cfg), jax.device_get(want)
    np.testing.assert_array_equal(g["t"], w["t"])
    for gl, wl in zip(g["layers"], w["layers"]):
        for k in wl:
            np.testing.assert_array_equal(gl[k], wl[k], err_msg=k)


@pytest.mark.parametrize("n_real", [0, 6])
def test_decode_segment_loop_n_real_edges_match_jax(n_real):
    """n_real 0 (the whole segment masked: nothing emitted, every lane
    bit-identical, ids the carried tokens) and n_real == n_steps."""
    cfg_j, params, gates, cfg, model = _setup()
    ts, th, js, _ = _ragged_prefill()
    ts = _clone(ts)
    tok = torch.argmax(T.compute_logits(model, cfg, th), dim=-1)
    active = np.array([True, False, True])
    n_emitted, max_new, eos = _lane_ops([0, 0, 3], [6, 6, 5], [-1] * B)
    before = _clone(ts)
    got = T.decode_segment_loop(model, cfg, ts, tok, np.zeros((B, 2)),
                                active, n_emitted, max_new, eos, 6,
                                TrimKV(), n_real=n_real)
    want = JT.decode_segment_loop(
        params, gates, cfg_j, js, jnp.asarray(tok.numpy(), jnp.int32),
        jnp.zeros((B, 2), jnp.uint32), jnp.asarray(active),
        jnp.asarray(n_emitted), jnp.asarray(max_new), jnp.asarray(eos), 6,
        JTrimKV(), n_real=jnp.int32(n_real))
    _assert_segment(got, want)
    _assert_lanes_frozen(got[0], before, [1] if n_real else [0, 1, 2])


def test_phased_admission_matches_jax_install():
    """The scheduler's phased admission (LanePrograms.admit: the chunk
    program over a ragged grid straight into reset lanes 0 and 2, lane 1
    riding as all-zero rows) against the JAX package's: prefill a fresh
    sub-state, install its rows into the reset lanes. Prompts of at
    least BUDGET tokens overwrite every slot, so the reset lanes' stale
    K/V bytes are gone in both; lane 1 is bit-identical, and the
    admitted lanes' first tokens are equal."""
    cfg_j, params, gates, cfg, model = _setup()
    sj, st = _serve()
    ts, th, js, _ = _ragged_prefill()
    mask = np.array([True, False, True])
    prompts = _prompts([13, 1, 20], seed=4)
    prompts[1] = prompts[1][:0]
    chunks, nv = _grid(prompts)
    lanes = LanePrograms(model, cfg, st, TrimKV(), _clone(ts), None)
    lanes.tok.copy_(torch.argmax(T.compute_logits(model, cfg, th), dim=-1))
    before = _clone(lanes.state)
    tok_before = lanes.tok.clone()
    lanes.reset(torch.as_tensor(mask))
    lanes.admit(chunks, nv, mask)
    sub, jh = JT.prefill_chunk_loop(
        params, gates, cfg_j, jnp.asarray(chunks), jnp.asarray(nv),
        JT.init_decode_state(cfg_j, B, BUDGET), JTrimKV(), sj)
    want = JT.install_lanes(JT.reset_lanes(js, jnp.asarray(mask)), sub,
                            jnp.asarray(mask))
    first = np.asarray(jnp.argmax(JT.compute_logits(params, cfg_j, jh),
                                  axis=-1))
    _assert_lanes_frozen(lanes.state, before, [1])
    _assert_states(lanes.state, want)
    np.testing.assert_array_equal(lanes.tok.numpy()[mask], first[mask])
    assert int(lanes.tok[1]) == int(tok_before[1])


def test_cache_lane_ops_and_inactive_insert_match_jax():
    """core.cache: reset_lanes and scrub_lanes (in place in the port),
    and cache_insert with an active mask, from the same numpy cache."""
    rng = np.random.RandomState(3)
    Bc, H, M, D = 3, 2, 8, 4
    c0 = {"k": rng.randn(Bc, H, M, D).astype(np.float32),
          "v": rng.randn(Bc, H, M, D).astype(np.float32),
          "beta": rng.uniform(0.5, 1.0, (Bc, H, M)).astype(np.float32),
          "pos": np.stack([rng.permutation(20)[:M] for _ in range(Bc * H)]
                          ).reshape(Bc, H, M).astype(np.int32),
          "aux": np.zeros((Bc, H, M), np.float32)}
    mask = np.array([False, True, True])
    for name in ("reset_lanes", "scrub_lanes"):
        got = getattr(tcache, name)(
            {k: torch.as_tensor(v).clone() for k, v in c0.items()},
            torch.as_tensor(mask))
        want = getattr(jcache, name)({k: jnp.asarray(v)
                                      for k, v in c0.items()},
                                     jnp.asarray(mask))
        for k in c0:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]), err_msg=k)
    k_t, v_t = rng.randn(2, Bc, H, D).astype(np.float32)
    beta_t = rng.uniform(0.5, 1.0, (Bc, H)).astype(np.float32)
    active = np.array([True, False, True])
    t = np.array([20, 21, 22], np.int32)
    got = tcache.cache_insert(
        {k: torch.as_tensor(v).clone() for k, v in c0.items()},
        torch.as_tensor(k_t), torch.as_tensor(v_t), torch.as_tensor(beta_t),
        torch.as_tensor(t), TrimKV().keep_scores, incoming_score=1.0,
        active=torch.as_tensor(active))
    want = jcache.cache_insert(
        {k: jnp.asarray(v) for k, v in c0.items()}, jnp.asarray(k_t),
        jnp.asarray(v_t), jnp.asarray(beta_t), jnp.asarray(t),
        JTrimKV().keep_scores, incoming_score=1.0,
        active=jnp.asarray(active))
    for k in c0:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
        np.testing.assert_array_equal(got[k].numpy()[1], c0[k][1])
