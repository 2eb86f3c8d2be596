"""The port's prefix KV cache against the JAX package's.

The radix trie (repro_torch.serve.prefix_cache, numpy) against
repro.serve.prefix_cache.PrefixCache on seeded operation sequences;
the byte count of a port slab row against the JAX row's; and the
scheduler with the cache on, on the tiny config of the JAX package's
tests/test_prefix_cache.py (2 layers, d_model 64, vocab 64, float32,
gate bias 3, budget 16, chunks of 8, segments of 4) with the JAX
package's weights through repro_torch.bridge, JAX on attn_impl "xla",
the port eager on the CPU: ids, statuses, every counter (prefix_* and
n_prefix_* included) and dispatch_count equal the JAX scheduler's, in
phased and interleaved admission, cold and warm, and a warm drain's ids
equal a cold drain's and a drain's with the cache off. Also the LRU
churn case (a trie of 1.5 slabs), the prefix_min_tokens gate, and the
shared-prefix Poisson trace of launch/serve.py against the JAX
launcher's.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import _jax_weights as jax_weights
from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch.serve import poisson_requests as jax_poisson_requests
from repro.models import transformer as JT
from repro.serve import Request as JRequest
from repro.serve import Scheduler as JScheduler
from repro.serve import build_engine as jax_build_engine
from repro.serve.prefix_cache import PrefixCache as JPrefixCache
from repro.serve.prefix_cache import state_row_bytes as jax_row_bytes
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve import poisson_requests
from repro_torch.serve.engine import build_engine
from repro_torch.serve.graphs import host_row_template
from repro_torch.serve.prefix_cache import PrefixCache, state_row_bytes
from repro_torch.serve.request import Request, Status
from repro_torch.serve.scheduler import Scheduler

ARCH = "trimkv-paper-4b"
TINY = dict(num_layers=2, d_model=64, d_ff=128, num_heads=4, num_kv_heads=2,
            vocab_size=64, gate_bias_init=3.0)
C = 8
SERVE = dict(budget=16, prefill_chunk=C, decode_segment=4)


# ------------------------------------------------------------ the trie


def _row(tag: int, n: int):
    return {"x": np.full((n,), tag, np.float32)}


def _trie_ops(seed: int, ttl: float):
    """Drive both tries through one seeded operation sequence (inserts
    of keys drawn from three shared pools so edges split mid-way,
    lookups under a limit with and without a pin, releases, observes,
    contains, clock steps for the TTL) and assert every return value,
    every stats() and the entry keys equal after each operation."""
    rng = np.random.RandomState(seed)
    now = [0.0]
    slab = 64 * 4
    kw = dict(ttl_sec=ttl, clock=lambda: now[0], observe_window=4)
    port, ref = PrefixCache(5 * slab, **kw), JPrefixCache(5 * slab, **kw)
    pools = [rng.randint(0, 6, size=24).astype(np.int32) for _ in range(3)]

    def key():
        p = pools[rng.randint(3)]
        n = int(rng.randint(1, 24))
        k = p[:n].copy()
        if rng.rand() < 0.3:
            k[int(rng.randint(n))] = int(rng.randint(6, 9))
        return k

    for step in range(160):
        op = rng.randint(7)
        if op == 0:
            k, n = key(), int(rng.choice([16, 64, 96, 512]))
            got = port.insert(k, _row(step, n))
            want = ref.insert(k, _row(step, n))
        elif op in (1, 2):
            k = key()
            limit = int(rng.randint(0, k.size + 2))
            pin = int(rng.randint(4)) if op == 2 else None
            g, w = (port.lookup(k, limit=limit, pin=pin),
                    ref.lookup(k, limit=limit, pin=pin))
            got = None if g is None else (g.tokens.tobytes(), g.nbytes)
            want = None if w is None else (w.tokens.tobytes(), w.nbytes)
        elif op == 3:
            rid = int(rng.randint(4))
            got, want = port.release(rid), ref.release(rid)
        elif op == 4:
            k = key()
            got, want = port.observe(k), ref.observe(k)
        elif op == 5:
            k = key()
            got, want = port.contains(k), ref.contains(k)
        else:
            now[0] += float(rng.choice([0.5, 2.0, 7.0]))
            got = want = None
        assert got == want, (step, op)
        assert port.stats() == ref.stats(), step
        assert set(port._entries) == set(ref._entries), step
    return port.stats()


@pytest.mark.parametrize("seed,ttl", [(0, 0.0), (1, 0.0), (2, 5.0),
                                      (3, 5.0)])
def test_trie_matches_jax(seed, ttl):
    stats = _trie_ops(seed, ttl)
    assert stats["inserts"] > 0 and stats["evictions"] > 0
    if ttl:
        assert stats["expirations"] > 0


def test_trie_guards_match_jax():
    """A zero capacity raises in both; a slab over capacity is rejected
    with a counter; a pinned entry blocks eviction until released."""
    for cls in (PrefixCache, JPrefixCache):
        with pytest.raises(ValueError):
            cls(0)
    outs = []
    for cls in (PrefixCache, JPrefixCache):
        pc = cls(16)
        a, b = np.asarray([1, 2], np.int32), np.asarray([3, 4], np.int32)
        outs.append((pc.insert(a, _row(0, 4096)), pc.insert(a, _row(1, 4)),
                     pc.lookup(a, pin=9) is not None,
                     pc.insert(b, _row(2, 4)), pc.release(9),
                     pc.insert(b, _row(3, 4)), pc.stats()))
    assert outs[0] == outs[1]
    assert outs[0][-1]["rejected"] == 2 and outs[0][-1]["evictions"] == 1


# ------------------------------------------------------------ row bytes


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


@pytest.mark.parametrize("tiny", [True, False])
def test_row_bytes_match_jax(tiny):
    """A port slab row (extract's layout: bfloat16 leaves as int16 bits)
    counts the bytes the JAX row of the same lane counts, in float32 (the
    tiny config) and bfloat16 (the smoke config)."""
    cfg_j, cfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    if tiny:
        cfg_j, cfg = _models()[0], _models()[3]
    budget = 16
    want = jax_row_bytes(jax.device_get(
        JT.init_decode_state(cfg_j, 1, budget)))
    assert state_row_bytes(host_row_template(cfg, budget)) == want
    if tiny:
        # a row as the scheduler stores it: LanePrograms.extract
        eng = build_engine(cfg, _models()[4], device="cpu", **SERVE)
        lanes = eng.lane_closures(2)
        lanes.fresh()
        (row, _, _), = lanes.extract([1])
        assert state_row_bytes(row) == want


# ------------------------------------------------------ scheduler parity


@functools.lru_cache(maxsize=None)
def _jax_engine_cached(policy):
    cfg_j, params, gates, _, _ = _models()
    return jax_build_engine(cfg_j, params, gates, policy=policy,
                            prefix_cache_bytes=1 << 22, **SERVE)


def _engines(policy="trimkv", capacity=1 << 22, min_tokens=C):
    """(JAX engine, port engine) with empty tries of ``capacity`` bytes;
    the JAX engine is cached per policy (its closures compile once) and
    takes a new trie and the host-side fields."""
    je = _jax_engine_cached(policy)
    je.serve = dataclasses.replace(je.serve, prefix_min_tokens=min_tokens,
                                   prefix_cache_bytes=capacity)
    je.prefix_cache = JPrefixCache(capacity)
    _, _, _, cfg, model = _models()
    te = build_engine(cfg, model, device="cpu", policy=policy,
                      prefix_cache_bytes=capacity,
                      prefix_min_tokens=min_tokens, **SERVE)
    return je, te


def _shared_requests(cls, pools, tails, max_new, seed0=10):
    """Prompts = a pool (shared hot prefix) + a ragged private tail."""
    rng = np.random.RandomState(3)
    pool_toks = [rng.randint(0, 64, size=L).astype(np.int32) for L in pools]
    reqs = []
    for i, (p, t, m) in enumerate(zip(
            np.resize(np.arange(len(pools)), len(tails)), tails, max_new)):
        prompt = np.concatenate(
            [pool_toks[p], rng.randint(0, 64, size=t).astype(np.int32)])
        reqs.append(cls(rid=i, prompt=prompt, max_new=m, seed=seed0 + i))
    return reqs


def _formula(s):
    return (s.n_prefill_rounds + s.n_segments + s.n_resets + s.n_swaps
            + s.n_resumes + s.n_faults_injected + s.n_prefix_installs
            + s.n_prefix_extracts)


def _drain_both(je, te, pools, tails, max_new, interleaved):
    """One drain of the trace on each side; asserts equal ids, statuses,
    stats() and dispatch counts, the formula and no pin left. Returns
    the port's scheduler."""
    runs = []
    for eng, sched_cls, cls in ((je, JScheduler, JRequest),
                                (te, Scheduler, Request)):
        eng.dispatch_count = 0
        sched = sched_cls(eng, n_lanes=2, interleaved=interleaved)
        sched.run(_shared_requests(cls, pools, tails, max_new))
        runs.append(sched)
    js, ts = runs
    for rid, rs in js.results.items():
        assert ts.results[rid].status is Status.DONE
        assert rs.status.value == Status.DONE.value
        assert ts.results[rid].tokens == rs.tokens, rid
    assert ts.stats() == js.stats()
    assert te.dispatch_count == je.dispatch_count == _formula(ts)
    assert ts.stats()["prefix_pinned"] == 0
    return ts


@pytest.mark.parametrize("interleaved", [False, True])
@pytest.mark.parametrize("policy", ["trimkv", "h2o"])
def test_prefix_scheduler_matches_jax(policy, interleaved):
    """Cold drain, then warm drain on the same tries: equal to the JAX
    scheduler's each time; the warm drain hits on every request, and
    both drains' ids equal a drain with the cache off."""
    je, te = _engines(policy)
    trace = ([24], [5, 11, 3, 9, 6], [6, 3, 8, 5, 7])
    cold = _drain_both(je, te, *trace, interleaved)
    warm = _drain_both(je, te, *trace, interleaved)
    cs, ws = cold.stats(), warm.stats()
    assert cs["n_prefix_hits"] > 0 and cs["prefix_inserts"] > 0
    assert ws["n_prefix_hits"] == 5 and ws["n_prefix_misses"] == 0
    assert ws["n_prefix_reused_tokens"] >= 24 * 5
    if interleaved:
        assert warm.n_prefix_installs > 0
    else:
        assert warm.n_prefix_installs == warm.n_prefix_extracts == 0
    _, _, _, cfg, model = _models()
    off = Scheduler(build_engine(cfg, model, device="cpu", policy=policy,
                                 **SERVE), n_lanes=2,
                    interleaved=interleaved)
    off.run(_shared_requests(Request, *trace))
    for rid, rs in off.results.items():
        assert cold.results[rid].tokens == warm.results[rid].tokens \
            == rs.tokens, rid


@pytest.mark.parametrize("interleaved", [False, True])
def test_lru_churn_matches_jax(interleaved):
    """A trie of 1.5 slabs and three rotating 16-token pools: captures
    evict each other mid-serve; equal to the JAX scheduler's, formula
    exact, no pin left."""
    slab = state_row_bytes(host_row_template(_models()[3], SERVE["budget"]))
    je, te = _engines(capacity=int(1.5 * slab))
    ts = _drain_both(je, te, [16, 16, 16], [5, 7, 4, 6, 5, 8], [4] * 6,
                     interleaved)
    st = ts.stats()
    assert st["prefix_evictions"] + st["prefix_rejected"] > 0, st


def test_min_tokens_gate_matches_jax():
    """prefix_min_tokens above every shared prefix: no hits, no
    captures, in both modes, as in the JAX scheduler."""
    je, te = _engines(min_tokens=1000)
    for interleaved in (False, True):
        ts = _drain_both(je, te, [24], [5, 11, 3], [4, 4, 4], interleaved)
        st = ts.stats()
        assert st["n_prefix_hits"] == 0 and st["prefix_inserts"] == 0


def test_shared_prefix_trace_matches_jax_launcher():
    """poisson_requests with prefix_pools: the JAX launcher's trace for
    the same seed (arrivals, prompts with their Zipf-drawn pools, max_new,
    seeds)."""
    kw = dict(vocab=64, prompt_lo=4, prompt_hi=20, new_lo=2, new_hi=9,
              seed=5, prefix_pools=3, prefix_len=12, zipf_alpha=1.1,
              priority_frac=0.25, high_deadline_ms=300.0)
    got = poisson_requests(9, 4.0, **kw)
    want = jax_poisson_requests(9, 4.0, **kw)
    pools = set()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.prompt, w.prompt)
        assert (g.max_new, g.seed, g.arrival, g.priority, g.deadline_ms) \
            == (w.max_new, w.seed, w.arrival, w.priority, w.deadline_ms)
        pools.add(g.prompt[:12].tobytes())
    assert len(pools) > 1


def test_capture_chunk_matches_jax():
    """The prefix cache's boundary snapshots as the scheduler takes them
    (LanePrograms.prefill_chunks with ``capture``, eager on the CPU: each
    lane's row extracted right after its capture-th chunk, 0 = none)
    against the JAX package's prefill_chunk_loop(capture_chunk=): slot
    positions and clocks exactly, floats within 1e-5 of their largest
    magnitude; and the phased admission (LanePrograms.admit) gives the
    same rows bit for bit."""
    import jax.numpy as jnp
    from repro.configs import ServeConfig as JServeConfig
    from repro.core.policies import make_policy as jax_make_policy
    cfg_j, params, gates, cfg, model = _models()
    rng = np.random.RandomState(4)
    lens = (21, 9, 17)
    n = 3
    chunks = np.zeros((n, 3, C), np.int32)
    nv = np.zeros((n, 3), np.int32)
    for b, L in enumerate(lens):
        flat = np.zeros(n * C, np.int32)
        flat[:L] = rng.randint(0, 64, size=L)
        chunks[:, b] = flat.reshape(n, C)
        nv[:, b] = np.clip(L - np.arange(n) * C, 0, C)
    capture = np.asarray([2, 0, 1], np.int32)
    sj = JServeConfig(budget=8, prefill_chunk=C)
    _, _, jsnap = JT.prefill_chunk_loop(
        params, gates, cfg_j, jnp.asarray(chunks), jnp.asarray(nv),
        JT.init_decode_state(cfg_j, 3, 8), jax_make_policy(sj), sj,
        capture_chunk=jnp.asarray(capture))
    want = jax.device_get(jsnap)
    eng = build_engine(cfg, model, device="cpu", budget=8, prefill_chunk=C)
    lanes = eng.lane_closures(3)
    lanes.fresh()
    _, rows = lanes.prefill_chunks(chunks, nv, capture)
    assert sorted(rows) == [0, 2]
    for lane, row in rows.items():
        # the row in the JAX package's layout (layers stacked per group)
        got = bridge.state_to_numpy(
            {"t": torch.as_tensor(row["t"]),
             "layers": [{k: torch.as_tensor(v) for k, v in layer.items()}
                        for layer in row["layers"]]}, cfg)
        assert int(got["t"][0]) == int(want["t"][lane]) == [16, 0, 8][lane]
        for gl, wl in zip(got["layers"], want["layers"]):
            np.testing.assert_array_equal(gl["pos"][:, 0], wl["pos"][:, lane])
            for k in ("k", "v", "beta"):
                w = wl[k][:, lane]
                scale = max(float(np.abs(w).max()), 1e-30)
                err = float(np.abs(gl[k][:, 0] - w).max()) / scale
                assert err <= 1e-5, (lane, k, err)
    lanes.fresh()
    admitted = lanes.admit(chunks, nv, np.ones(3, bool), capture=capture)
    assert sorted(admitted) == [0, 2]
    for lane, row in admitted.items():
        np.testing.assert_array_equal(row["t"], rows[lane]["t"])
        for al, rl in zip(row["layers"], rows[lane]["layers"]):
            for k in rl:
                np.testing.assert_array_equal(al[k], rl[k], err_msg=k)
