"""The port's speculative decoding against the JAX package's.

ngram_draft on seeded histories and cache_replay on seeded caches and
signals (every leaf exact); one verify round (logits within 1e-5 of
their largest magnitude, fed, emitted, n_commit, the carry, the
history and slot positions exact, cached floats within 1e-5; and,
on the port alone, the committed state bit-identical to decode_step
over the accepted tokens); and the scheduler with spec_k 2, on the tiny
config of the JAX package's tests/test_speculative.py (2 layers,
d_model 64, vocab 64, float32, gate bias 3, budget 16, chunks of 8,
segments of 4) with the JAX package's weights through
repro_torch.bridge, JAX on attn_impl "xla", the port eager on the CPU:
ids, statuses, every counter (n_verify_rounds, n_spec_rounds,
n_spec_tokens included) and dispatch_count equal the JAX scheduler's,
and ids equal spec_k 0's, phased and interleaved, under TRIM-KV and
H2O, with swap preemption and with a warm prefix cache. Sampled
schedulers run spec_k 0; spec_k < 0 raises.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _jax_weights as jax_weights
from repro.configs import ServeConfig as JServeConfig
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import cache as jcache
from repro.core.policies import make_policy as jax_make_policy
from repro.models import transformer as JT
from repro.serve import Request as JRequest
from repro.serve import Scheduler as JScheduler
from repro.serve import build_engine as jax_build_engine
from repro.serve.prefix_cache import PrefixCache as JPrefixCache
from repro_torch import bridge
from repro_torch.configs import ServeConfig, get_smoke_config
from repro_torch.core import cache as tcache
from repro_torch.core.policies import make_policy
from repro_torch.models import transformer as T
from repro_torch.serve.engine import build_engine
from repro_torch.serve.request import Request, Status
from repro_torch.serve.scheduler import Scheduler

ARCH = "trimkv-paper-4b"
TINY = dict(num_layers=2, d_model=64, d_ff=128, num_heads=4, num_kv_heads=2,
            vocab_size=64, gate_bias_init=3.0)
C = 8
SERVE = dict(budget=16, prefill_chunk=C, decode_segment=4)
REL = 1e-5


@functools.lru_cache(maxsize=None)
def _models():
    torch.set_num_threads(1)
    cfg_j = dataclasses.replace(jax_smoke_config(ARCH), **TINY)
    cfg = dataclasses.replace(get_smoke_config(ARCH), **TINY)
    params = jax_weights.init_params(cfg_j)
    gates = jax_weights.init_gate_params(cfg_j)
    model = bridge.params_from_jax(jax.device_get(params), cfg, device="cpu")
    bridge.gates_from_jax(jax.device_get(gates), cfg, model)
    return cfg_j, params, gates, cfg, model


def _close(got, want, name=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                1e-30)
    assert err <= REL, f"{name}: {err:.3e} of the largest magnitude"


# ------------------------------------------------------------- drafter


@pytest.mark.parametrize("k", [1, 2, 4])
def test_ngram_draft_matches_jax(k):
    """Seeded histories over a small vocabulary (so bigrams repeat), -1
    left padding of every length, carries that do and do not match."""
    rng = np.random.RandomState(k)
    B, H = 16, 64
    hist = rng.randint(0, 4, size=(B, H)).astype(np.int32)
    for b in range(B):
        hist[b, :int(rng.randint(0, H + 1))] = -1
    tok = rng.randint(0, 5, size=(B,)).astype(np.int32)
    want = np.asarray(jax.jit(JT.ngram_draft, static_argnums=2)(
        jnp.asarray(hist), jnp.asarray(tok), k))
    got = T.ngram_draft(torch.as_tensor(hist, dtype=torch.int64),
                        torch.as_tensor(np.array(tok), dtype=torch.int64), k)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != tok[:, None]).any()          # some lanes found a bigram


# ---------------------------------------------------------- cache_replay


@pytest.mark.parametrize("policy", ["trimkv", "h2o", "rkv"])
def test_cache_replay_matches_jax(policy):
    """n_commit 0..C over four lanes, one of them not live, from a seeded
    cache with empty slots; every leaf equal to the JAX package's.
    A policy that reads no attention gets no probs (None), as the
    port's verify pass records none."""
    rng = np.random.RandomState(3)
    B, H, M, D, Cc = 4, 2, 8, 4, 3
    t = np.asarray([10, 11, 12, 13], np.int32)
    pos = np.stack([rng.permutation(10)[:M] for _ in range(B * H)]).reshape(
        B, H, M).astype(np.int32)
    pos[:, :, -1] = -1
    cache = {"k": rng.randn(B, H, M, D).astype(np.float32),
             "v": rng.randn(B, H, M, D).astype(np.float32),
             "beta": rng.uniform(0.5, 1.0, (B, H, M)).astype(np.float32),
             "pos": pos,
             "aux": rng.uniform(0, 1, (B, H, M)).astype(np.float32)}
    k_c = rng.randn(B, Cc, H, D).astype(np.float32)
    v_c = rng.randn(B, Cc, H, D).astype(np.float32)
    beta_c = rng.uniform(0.5, 1.0, (B, Cc, H)).astype(np.float32)
    pkv = rng.dirichlet(np.ones(M), size=(B, Cc, H)).astype(np.float32)
    auxn = rng.uniform(0, 0.2, (B, Cc, H)).astype(np.float32)
    n_commit = np.asarray([0, 1, 2, 3], np.int32)
    live = np.asarray([True, True, False, True])
    inc = 1.0 if policy == "trimkv" else None
    jpol = jax_make_policy(JServeConfig(policy=policy))
    tpol = make_policy(ServeConfig(policy=policy))
    want = jcache.cache_replay(
        {k: jnp.asarray(v) for k, v in cache.items()}, jnp.asarray(k_c),
        jnp.asarray(v_c), jnp.asarray(beta_c), jnp.asarray(pkv),
        jnp.asarray(auxn), jnp.asarray(t), jnp.asarray(n_commit),
        jnp.asarray(live), jpol, incoming_score=inc)
    got = {k: torch.as_tensor(v.copy()) for k, v in cache.items()}
    out = tcache.cache_replay(
        got, torch.as_tensor(k_c), torch.as_tensor(v_c),
        torch.as_tensor(beta_c),
        torch.as_tensor(pkv) if tpol.needs_attn else None,
        torch.as_tensor(auxn) if tpol.needs_attn else None,
        torch.as_tensor(t), torch.as_tensor(n_commit), torch.as_tensor(live),
        tpol, incoming_score=inc)
    assert out is got                            # in place
    for k in cache:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    # the lane not live and the lane with n_commit 0 are untouched
    for lane in (0, 2):
        for k in cache:
            np.testing.assert_array_equal(got[k][lane].numpy(),
                                          cache[k][lane])
    assert (got["pos"].numpy() != cache["pos"]).any()


# ----------------------------------------------------------- verify round


@functools.lru_cache(maxsize=None)
def _prefilled(budget=8):
    """Three prompts (21, 9 and 3 tokens) prefilled on both sides from
    fresh states on one ragged grid: (JAX state, port state, carry
    tokens [3], histories [3, SPEC_HISTORY])."""
    cfg_j, params, gates, cfg, model = _models()
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 64, size=L).astype(np.int32)
               for L in (21, 9, 3)]
    n = 3
    chunks = np.zeros((n, 3, C), np.int32)
    nv = np.zeros((n, 3), np.int32)
    hist = np.full((3, T.SPEC_HISTORY), -1, np.int32)
    for b, p in enumerate(prompts):
        flat = np.zeros(n * C, np.int32)
        flat[:p.size] = p
        chunks[:, b] = flat.reshape(n, C)
        nv[:, b] = np.clip(p.size - np.arange(n) * C, 0, C)
        hist[b, -p.size:] = p
    sj = JServeConfig(budget=budget, prefill_chunk=C)

    def jax_prefill(p, g, c, n):      # jitted: one compile of the scan
        js, jh = JT.prefill_chunk_loop(
            p, g, cfg_j, c, n, JT.init_decode_state(cfg_j, 3, budget),
            jax_make_policy(sj), sj)
        return js, jnp.argmax(JT.compute_logits(p, cfg_j, jh), -1)

    js, tok = jax.jit(jax_prefill)(params, gates, jnp.asarray(chunks),
                                   jnp.asarray(nv))
    tok = np.asarray(tok, np.int32)
    st = ServeConfig(budget=budget, prefill_chunk=C)
    ts, _ = T.prefill_chunk_loop(model, cfg, torch.as_tensor(chunks),
                                 torch.as_tensor(nv),
                                 T.init_decode_state(cfg, 3, budget, "cpu"),
                                 make_policy(st), st)
    return js, ts, tok, hist


def _clone(state):
    return {"t": state["t"].clone(),
            "layers": [{k: v.clone() for k, v in st.items()}
                       for st in state["layers"]]}


@functools.lru_cache(maxsize=None)
def _jax_verify(policy, spec_k):
    """The JAX package's verify_round and _verify_forward for a policy,
    jitted once and shared by the cases (drafts an argument; the eager
    calls would compile their scans anew each time): (round, forward)."""
    cfg_j = _models()[0]
    jpol = jax_make_policy(JServeConfig(policy=policy, budget=8))

    def round_(params, gates, state, tok, hist, active, live, n_emitted,
               max_new, eos, drafts):
        return JT.verify_round(params, gates, cfg_j, state, tok, hist,
                               active, live, n_emitted, max_new, eos,
                               spec_k, jpol,
                               draft_fn=lambda h, t, k: drafts)

    def forward(params, gates, state, fed, live):
        return JT._verify_forward(params, gates, cfg_j, state, fed, live,
                                  jpol)[0]
    return jax.jit(round_), jax.jit(forward)


def _greedy_run(model, cfg, state, tok, n, policy):
    """n greedy tokens per lane by sequential decode from a copy."""
    st, out = _clone(state), []
    tok = torch.as_tensor(np.array(tok), dtype=torch.int64)
    for _ in range(n):
        st, logits = T.decode_step(model, cfg, st, tok, policy)
        tok = torch.argmax(logits, dim=-1)
        out.append(tok)
    return torch.stack(out, dim=1).numpy()


@pytest.mark.parametrize("case", ["accept", "clip"])
@pytest.mark.parametrize("policy", ["trimkv", "h2o"])
def test_verify_round_matches_jax(policy, case):
    """Injected drafts (lane 0 the model's own greedy continuation,
    lane 1 its first token then a wrong one, lane 2 wrong at once);
    "clip" also stops lane 0 at max_new inside the accepted drafts,
    stops lane 1 at an eos and leaves lane 2 out of the round."""
    cfg_j, params, gates, cfg, model = _models()
    js, ts, tok, hist = _prefilled()
    spec_k, Cc = 3, 4
    tpol = make_policy(ServeConfig(policy=policy, budget=8))
    greedy = _greedy_run(model, cfg, ts, tok, spec_k, tpol)
    drafts = greedy.copy()
    drafts[1, 1:] = (greedy[1, 1:] + 1) % 64
    drafts[2] = (greedy[2] + 1) % 64
    n_emitted = np.asarray([2, 0, 5], np.int32)
    max_new = np.asarray([50, 50, 50], np.int32)
    eos = np.full((3,), -1, np.int32)
    live = np.ones((3,), bool)
    if case == "clip":
        max_new[0] = n_emitted[0] + 3              # stops at position 2
        eos[1] = drafts[1, 0]                      # emitted at position 1
        live[2] = False
    td = lambda h, t, k: torch.as_tensor(drafts, dtype=torch.int64)  # noqa
    j_round, j_forward = _jax_verify(policy, spec_k)
    want = j_round(params, gates, js, jnp.asarray(tok), jnp.asarray(hist),
                   jnp.ones((3,), bool), jnp.asarray(live),
                   jnp.asarray(n_emitted), jnp.asarray(max_new),
                   jnp.asarray(eos), jnp.asarray(drafts))
    j_logits = j_forward(
        params, gates, js,
        jnp.concatenate([jnp.asarray(tok)[:, None], jnp.asarray(drafts)], 1),
        jnp.asarray(live))
    entry = _clone(ts)
    state = _clone(ts)
    t_args = (torch.as_tensor(np.array(tok), dtype=torch.int64),
              torch.as_tensor(np.array(hist), dtype=torch.int64),
              torch.ones((3,), dtype=torch.bool), torch.as_tensor(live),
              torch.as_tensor(n_emitted), torch.as_tensor(max_new),
              torch.as_tensor(eos), spec_k, tpol)
    fed = torch.cat([t_args[0][:, None], td(None, None, None)], dim=1)
    t_logits, _ = T._verify_forward(model, cfg, _clone(ts), fed,
                                    torch.as_tensor(live), tpol)
    got = T.verify_round(model, cfg, state, *t_args, draft_fn=td)
    _close(t_logits.numpy(), np.asarray(j_logits), "logits")
    (g_state, g_tok, g_hist, g_active, g_nem, g_fed, g_emit, g_ok,
     g_nc) = got
    (w_state, w_tok, w_hist, w_active, w_nem, w_fed, w_emit, w_ok,
     w_nc) = want
    for g, w, name in ((g_tok, w_tok, "tok"), (g_hist, w_hist, "hist"),
                       (g_active, w_active, "active"),
                       (g_nem, w_nem, "n_emitted"), (g_fed, w_fed, "fed"),
                       (g_emit, w_emit, "emitted"), (g_ok, w_ok, "ok"),
                       (g_nc, w_nc, "n_commit")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    nc = g_nc.numpy()
    assert nc.tolist() == ([4, 2, 1] if case == "accept" else [3, 2, 0])
    if case == "clip":
        assert not g_active.numpy()[:2].any()      # both lanes stopped
    g = bridge.state_to_numpy(g_state, cfg)
    w = jax.device_get(w_state)
    np.testing.assert_array_equal(g["t"], w["t"])
    for gl, wl in zip(g["layers"], w["layers"]):
        np.testing.assert_array_equal(gl["pos"], wl["pos"], err_msg="pos")
        for name in ("k", "v", "beta", "aux"):
            _close(gl[name], wl[name], name)
    # the port alone: the commit equals sequential decode of the accepted
    # tokens, bit for bit, and so do the logits of the committed positions
    seq = _clone(entry)
    fed_np = g_fed.numpy()
    for j in range(Cc):
        act = torch.as_tensor(live & (j < nc))
        seq, logits = T.decode_step(model, cfg, seq,
                                    torch.as_tensor(fed_np[:, j]), tpol,
                                    active=act)
        for b in np.flatnonzero(act.numpy()):
            assert torch.equal(logits[b], t_logits[b, j]), (b, j)
    assert torch.equal(seq["t"], g_state["t"])
    for a, b in zip(seq["layers"], g_state["layers"]):
        for k in a:
            assert torch.equal(a[k], b[k]), k


# --------------------------------------------------------------- loops


def _assert_state_close(g_state, w_state):
    g = bridge.state_to_numpy(g_state, _models()[3])
    w = jax.device_get(w_state)
    np.testing.assert_array_equal(g["t"], w["t"])
    for gl, wl in zip(g["layers"], w["layers"]):
        np.testing.assert_array_equal(gl["pos"], wl["pos"], err_msg="pos")
        for name in ("k", "v", "beta", "aux"):
            _close(gl[name], wl[name], name)


def _assert_spec_loop(got, want, n_cols):
    """The spec loops' tuples (state, tok, keys, active, n_emitted, ids,
    emitted, ok, hist, acc_tok, acc_rounds): ids exact in the first
    n_cols columns (the rounds that ran) and wherever emitted, every
    other output exact, the state as _assert_state_close."""
    names = ("tok", "keys", "active", "n_emitted", "ids", "emitted", "ok",
             "hist", "acc_tok", "acc_rounds")
    for g, w, name in zip(got[1:], want[1:], names):
        g, w = g.numpy(), np.asarray(w)
        if name == "ids":
            np.testing.assert_array_equal(g[:, :n_cols], w[:, :n_cols])
            em = np.asarray(want[6])
            np.testing.assert_array_equal(g[em], w[em], err_msg=name)
        else:
            np.testing.assert_array_equal(g.astype(w.dtype), w,
                                          err_msg=name)
    _assert_state_close(got[0], want[0])


@pytest.mark.parametrize("policy", ["trimkv", "h2o"])
def test_spec_decode_segment_loop_matches_jax(policy):
    """Four verify rounds with n_real 3 over three lanes (lane 1 stops at
    max_new inside an accepted prefix, lane 2 is inactive throughout):
    the port's loop (the spec_segment program, eager) against the JAX
    package's scan."""
    cfg_j, params, gates, cfg, model = _models()
    js, ts, tok, hist = _prefilled()
    spec_k, rounds, n_real = 2, 4, 3
    jpol = jax_make_policy(JServeConfig(policy=policy, budget=8))
    st = ServeConfig(policy=policy, budget=8, prefill_chunk=C)
    active = np.asarray([True, True, False])
    n_emitted = np.asarray([0, 3, 0], np.int32)
    max_new = np.asarray([40, 5, 40], np.int32)
    eos = np.full((3,), -1, np.int32)
    keys = np.zeros((3, 2), np.uint32)
    want = JT.spec_decode_segment_loop(
        params, gates, cfg_j, js, jnp.asarray(tok), jnp.asarray(keys),
        jnp.asarray(active), jnp.asarray(n_emitted), jnp.asarray(max_new),
        jnp.asarray(eos), jnp.asarray(hist), rounds, jpol, spec_k=spec_k,
        n_real=jnp.int32(n_real))
    got = T.spec_decode_segment_loop(
        model, cfg, _clone(ts),
        torch.as_tensor(np.array(tok), dtype=torch.int64), keys, active,
        n_emitted, max_new, eos, hist, rounds, make_policy(st),
        spec_k=spec_k, n_real=n_real, serve_cfg=st)
    _assert_spec_loop(got, want, n_real * (spec_k + 1))
    assert got[3].numpy().tolist() == [True, False, False]


@pytest.mark.parametrize("policy", ["trimkv", "h2o"])
def test_spec_mixed_step_loop_matches_jax(policy):
    """Three speculative interleaved steps: lanes 0 and 2 run verify
    rounds while lane 1 (reset) takes a 2-chunk prompt, its history
    seeded with the prompt as admission seeds it, and starts decoding
    at step 2: the port's loop (the spec_mixed programs, eager) against
    the JAX package's scan."""
    cfg_j, params, gates, cfg, model = _models()
    js, ts, tok, hist = _prefilled()
    spec_k, steps = 2, 3
    sj = JServeConfig(policy=policy, budget=8, prefill_chunk=C)
    st = ServeConfig(policy=policy, budget=8, prefill_chunk=C)
    mask = np.asarray([False, True, False])
    js = JT.reset_lanes(js, jnp.asarray(mask))
    ts = T.reset_lanes(_clone(ts), torch.as_tensor(mask))
    prompt = np.random.RandomState(5).randint(0, 64, size=13).astype(np.int32)
    chunks = np.zeros((steps, 3, C), np.int32)
    flat = np.zeros(2 * C, np.int32)
    flat[:13] = prompt
    chunks[:2, 1] = flat.reshape(2, C)
    cv = np.zeros((steps, 3), np.int32)
    cv[:2, 1] = [C, 13 - C]
    finish = np.zeros((steps, 3), bool)
    finish[1, 1] = True
    hist = hist.copy()
    hist[1] = -1
    hist[1, -13:] = prompt
    active = np.asarray([True, False, True])
    n_emitted = np.asarray([1, 0, 2], np.int32)
    max_new = np.asarray([40, 40, 40], np.int32)
    eos = np.full((3,), -1, np.int32)
    keys = np.zeros((3, 2), np.uint32)
    want = JT.spec_mixed_step_loop(
        params, gates, cfg_j, js, jnp.asarray(tok), jnp.asarray(keys),
        jnp.asarray(active), jnp.asarray(n_emitted), jnp.asarray(max_new),
        jnp.asarray(eos), jnp.asarray(hist), jnp.asarray(chunks),
        jnp.asarray(cv), jnp.asarray(finish), jnp.asarray(keys),
        jax_make_policy(sj), sj, spec_k=spec_k)
    got = T.spec_mixed_step_loop(
        model, cfg, ts, torch.as_tensor(np.array(tok), dtype=torch.int64),
        keys, active, n_emitted, max_new, eos, hist, chunks, cv, finish,
        keys, make_policy(st), st, spec_k=spec_k)
    _assert_spec_loop(got, want, steps * (spec_k + 1))
    assert got[6].numpy()[1, :2 * (spec_k + 1)].sum() == 0
    assert got[6].numpy()[1, 2 * (spec_k + 1)]


# ------------------------------------------------------ scheduler parity


@functools.lru_cache(maxsize=None)
def _jax_engine_cached(policy, spec_k):
    cfg_j, params, gates, _, _ = _models()
    return jax_build_engine(cfg_j, params, gates, policy=policy,
                            spec_k=spec_k, **SERVE)


@functools.lru_cache(maxsize=None)
def _jax_serve(policy, spec_k):
    return _jax_engine_cached(policy, spec_k).serve


def _engines(policy="trimkv", spec_k=2, **host):
    """(JAX engine, port engine): the JAX one cached per (policy, spec_k)
    so its closures compile once, with the host-side fields of ``host``
    over its own serve config (a prefix_cache_bytes there gives both a
    new trie)."""
    je = _jax_engine_cached(policy, spec_k)
    je.serve = dataclasses.replace(_jax_serve(policy, spec_k), **host)
    je.prefix_cache = (JPrefixCache(host["prefix_cache_bytes"])
                       if host.get("prefix_cache_bytes") else None)
    _, _, _, cfg, model = _models()
    te = build_engine(cfg, model, device="cpu", policy=policy,
                      spec_k=spec_k, **{**SERVE, **host})
    return je, te


def _requests(cls, lens, max_new, priority=None):
    rng = np.random.RandomState(7)
    return [cls(rid=i, prompt=rng.randint(0, 64, size=L).astype(np.int32),
                max_new=m, seed=i,
                priority=0 if priority is None else priority[i])
            for i, (L, m) in enumerate(zip(lens, max_new))]


def _formula(s):
    return (s.n_prefill_rounds + s.n_segments + s.n_resets + s.n_swaps
            + s.n_resumes + s.n_faults_injected + s.n_prefix_installs
            + s.n_prefix_extracts)


def _assert_same(ts, js, te, je):
    """Equal ids, statuses, stats() and dispatch counts; the formula and
    the verify-round ledger exact; every request's acceptance adds up."""
    for rid, rs in js.results.items():
        got = ts.results[rid]
        assert got.status is Status.DONE
        assert rs.status.value == Status.DONE.value
        assert got.tokens == rs.tokens, rid
        assert (got.spec_rounds, got.spec_tokens) == (rs.spec_rounds,
                                                       rs.spec_tokens)
        assert got.spec_tokens == len(got.tokens) > 0
    st = ts.stats()
    assert st == js.stats()
    assert te.dispatch_count == je.dispatch_count == _formula(ts)
    assert st["n_verify_rounds"] == te.serve.decode_segment * (
        st["n_segments"] - st["n_segment_splits"])
    assert st["n_spec_tokens"] >= st["n_spec_rounds"] > 0


def _run(eng, sched_cls, req_cls, reqs_args, interleaved, n_lanes=2,
         preempt=False):
    eng.dispatch_count = 0
    sched = sched_cls(eng, n_lanes=n_lanes, interleaved=interleaved)
    reqs = _requests(req_cls, *reqs_args)
    if preempt:
        # the first n_lanes requests decode, then a better-ranked arrival
        # swaps one of them out
        for r in reqs[:n_lanes]:
            sched.submit(r)
        for _ in range(4):
            sched.step()
        assert all(sched.active)
        sched.submit(reqs[n_lanes])
        sched.run()
    else:
        sched.run(reqs)
    return sched


@pytest.mark.parametrize("interleaved", [False, True])
@pytest.mark.parametrize("policy", ["trimkv", "h2o"])
def test_spec_scheduler_matches_jax(policy, interleaved):
    """Four requests on two lanes (prompts of 1 and 2 chunks, so every
    admission grid is the JAX scheduler's 1- or 2-chunk bucket, which
    the swap case shares): ids, stats() and dispatches equal the JAX
    scheduler's, and ids equal spec_k 0's."""
    trace = ([5, 11, 15, 8], [6, 3, 8, 5])
    je, te = _engines(policy)
    js = _run(je, JScheduler, JRequest, trace, interleaved)
    ts = _run(te, Scheduler, Request, trace, interleaved)
    _assert_same(ts, js, te, je)
    _, base = _engines(policy, spec_k=0)
    plain = _run(base, Scheduler, Request, trace, interleaved)
    for rid, rs in plain.results.items():
        assert ts.results[rid].tokens == rs.tokens, rid
    assert plain.stats()["n_verify_rounds"] == 0


@pytest.mark.parametrize("interleaved", [False, True])
def test_spec_swap_preempt_matches_jax(interleaved):
    """A request swapped out mid-generation with speculation on resumes
    (its drafter history reseeded from its tokens), as in the JAX
    scheduler, and its ids equal spec_k 0's. Two lanes, as the other
    scheduler cases (so the JAX engine's compiled lane programs serve
    both): both decode when a better-ranked arrival takes one."""
    host = dict(decode_segment=2, sched_policy="priority")
    trace = ([9, 7, 10], [12, 12, 4], [0, 0, 3])
    je, te = _engines(**host)
    js = _run(je, JScheduler, JRequest, trace, interleaved, 2, True)
    ts = _run(te, Scheduler, Request, trace, interleaved, 2, True)
    _assert_same(ts, js, te, je)
    assert ts.n_swaps >= 1 and ts.n_resumes >= 1
    assert sum(r.n_preempts for r in ts.results.values()) >= 1
    _, base = _engines(spec_k=0, **host)
    plain = _run(base, Scheduler, Request, trace, interleaved, 2, True)
    for rid, rs in plain.results.items():
        assert ts.results[rid].tokens == rs.tokens, rid


@pytest.mark.parametrize("interleaved", [False, True])
def test_spec_prefix_cache_warm_equals_cold(interleaved):
    """Speculation with the prefix cache on: a cold drain, then a warm
    one (every request hits) equal to the JAX scheduler's and to each
    other; every cached slab's clock sits at its chunk-aligned token
    count (no speculated token reached a slab)."""
    rng = np.random.RandomState(3)
    pool = rng.randint(0, 64, size=24).astype(np.int32)
    tails = [rng.randint(0, 64, size=t).astype(np.int32)
             for t in (5, 11, 3, 9)]

    def reqs(cls):
        return [cls(rid=i, prompt=np.concatenate([pool, tl]), max_new=m,
                    seed=10 + i) for i, (tl, m) in enumerate(zip(
                        tails, [6, 3, 8, 5]))]

    je, te = _engines(prefix_cache_bytes=1 << 22, prefix_min_tokens=C)
    drains = []
    for _ in range(2):
        runs = []
        for eng, sched_cls, cls in ((je, JScheduler, JRequest),
                                    (te, Scheduler, Request)):
            eng.dispatch_count = 0
            sched = sched_cls(eng, n_lanes=2, interleaved=interleaved)
            sched.run(reqs(cls))
            runs.append(sched)
        _assert_same(runs[1], runs[0], te, je)
        assert runs[1].stats()["prefix_pinned"] == 0
        drains.append(runs[1])
    for rid, rs in drains[0].results.items():
        assert drains[1].results[rid].tokens == rs.tokens, rid
    warm = drains[1].stats()
    assert warm["n_prefix_hits"] == 4 and warm["n_prefix_misses"] == 0
    entries = list(te.prefix_cache._entries.values())
    assert entries
    for e in entries:
        assert e.n_tokens % C == 0
        assert int(e.state["t"][0]) == e.n_tokens


def test_spec_sampled_runs_plain_and_negative_k_raises():
    """Under temperature sampling the scheduler runs spec_k 0 (no verify
    round) and each request's ids equal its one-shot sampled run;
    spec_k < 0 is refused at engine build."""
    _, _, _, cfg, model = _models()
    eng = build_engine(cfg, model, device="cpu", spec_k=2, temperature=0.8,
                       **SERVE)
    sched = Scheduler(eng, n_lanes=2, greedy=False)
    reqs = _requests(Request, [5, 11, 19], [6, 3, 8])
    res = sched.run(reqs)
    assert sched.spec_k == 0
    st = sched.stats()
    assert st["n_verify_rounds"] == st["n_spec_rounds"] == 0
    for r in reqs:
        want = eng.generate(r.prompt[None], r.max_new, chunked=True,
                            greedy=False, seed=r.seed)["ids"][0]
        assert res[r.rid].tokens == want.tolist()
    with pytest.raises(ValueError, match="spec_k"):
        build_engine(cfg, model, device="cpu", spec_k=-1, **SERVE)
