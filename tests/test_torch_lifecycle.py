"""The port's lane lifecycle against the JAX package's: sampled
generation on threefry key chains, swap preemption, park / revive,
crash recovery over a snapshot directory, and fault quarantine.

On the tiny config of the JAX package's tests/test_faults.py (2 layers,
d_model 64, vocab 64, float32, gate bias 3, budget 16, chunks of 8,
segments of 2) with the JAX package's weights through
repro_torch.bridge; JAX on attn_impl "xla", the port eager on the CPU.
Every case compares discrete outcomes exactly: ids, statuses, the
scheduler's counters and dispatch_count (the JAX formula
n_prefill_rounds + n_segments + n_resets + n_swaps + n_resumes
+ n_faults_injected), and, for lane surgery, every state leaf.
"""
import dataclasses
import functools
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import transformer as JT
from repro.serve import FaultInjector as JFaultInjector
from repro.serve import Request as JRequest
from repro.serve import Scheduler as JScheduler
from repro.serve import build_engine as jax_build_engine
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.models import transformer as T
from repro_torch.serve.engine import build_engine
from repro_torch.serve.faults import FaultInjector
from repro_torch.serve.request import TERMINAL_STATUSES, Request, Status
from repro_torch.serve.scheduler import Scheduler

ARCH = "trimkv-paper-4b"
TINY = dict(num_layers=2, d_model=64, d_ff=128, num_heads=4, num_kv_heads=2,
            vocab_size=64, gate_bias_init=3.0)
SERVE = dict(budget=16, prefill_chunk=8, decode_segment=2, temperature=0.8)
# counters that must agree (the store's and the prefix cache's aside)
COUNTERS = ("n_prefill_rounds", "n_segments", "n_resets", "n_preempted",
            "n_swaps", "n_resumes", "n_quarantined", "n_failed",
            "n_faults_injected", "n_retries", "n_snapshot_lost",
            "n_recovered_sessions")


@functools.lru_cache(maxsize=None)
def _models():
    torch.set_num_threads(1)
    cfg_j = dataclasses.replace(jax_smoke_config(ARCH), **TINY)
    cfg = dataclasses.replace(get_smoke_config(ARCH), **TINY)
    params = JT.init_params(jax.random.PRNGKey(0), cfg_j)
    gates = JT.init_gate_params(jax.random.PRNGKey(1), cfg_j)
    model = bridge.params_from_jax(jax.device_get(params), cfg, device="cpu")
    bridge.gates_from_jax(jax.device_get(gates), cfg, model)
    return cfg_j, params, gates, cfg, model


@functools.lru_cache(maxsize=None)
def _jax_engine_cached(policy):
    cfg_j, params, gates, _, _ = _models()
    return jax_build_engine(cfg_j, params, gates, policy=policy, **SERVE)


@functools.lru_cache(maxsize=None)
def _jax_serve(policy):
    return _jax_engine_cached(policy).serve


def _jax_engine(policy="trimkv", **host):
    """One JAX engine per policy, so its compiled closures are shared; a
    case swaps in the host-side fields its scheduler reads, over the
    engine's own serve config (no field carries over from a case)."""
    je = _jax_engine_cached(policy)
    je.serve = dataclasses.replace(_jax_serve(policy), **host)
    je.dispatch_count = 0
    return je


def _port_engine(policy="trimkv", **host):
    _, _, _, cfg, model = _models()
    return build_engine(cfg, model, device="cpu", policy=policy, **SERVE,
                        **host)


def _requests(cls, lens, max_new, *, seeds=None, priority=None,
              timeout_ms=None):
    rng = np.random.RandomState(7)
    return [cls(rid=i, prompt=rng.randint(0, 64, size=L).astype(np.int32),
                max_new=m, seed=i if seeds is None else seeds[i],
                priority=0 if priority is None else priority[i],
                timeout_ms=None if timeout_ms is None else timeout_ms[i])
            for i, (L, m) in enumerate(zip(lens, max_new))]


def _dispatch_formula(s):
    return (s.n_prefill_rounds + s.n_segments + s.n_resets + s.n_swaps
            + s.n_resumes + s.n_faults_injected)


def _assert_same(port, jax_, pe, je):
    """Equal ids, statuses, counters and dispatch totals."""
    for rid, rs in jax_.results.items():
        got = port.results[rid]
        assert got.status.value == rs.status.value, rid
        assert got.tokens == rs.tokens, rid
        assert got.n_retries == rs.n_retries, rid
    ps, js = port.stats(), jax_.stats()
    assert {k: ps[k] for k in COUNTERS} == {k: js[k] for k in COUNTERS}
    assert pe.dispatch_count == je.dispatch_count == _dispatch_formula(port)


# ------------------------------------------------------ sampled one-shot


@pytest.mark.parametrize("batch,seed", [(1, 3), (3, 2**31 + 5)])
def test_sampled_generate_matches_jax(batch, seed):
    """Engine.generate(greedy=False, seed) at temperature 0.8: the
    graphs' step programs (fused, eager here) and the reference loop
    (fused=False) give the JAX package's ids; batch 3 draws from one key
    over [3, Vp], so a per-row draw would part from it."""
    tokens = np.random.RandomState(batch).randint(0, 64, (batch, 13))
    want = _jax_engine().generate(tokens, 8, chunked=True, greedy=False,
                                  seed=seed)["ids"]
    greedy = _jax_engine().generate(tokens, 8, chunked=True)["ids"]
    assert (want != greedy).any()         # the draw is not the argmax
    pe = _port_engine()
    for fused in (True, False):
        got = pe.generate(tokens, 8, chunked=True, greedy=False, seed=seed,
                          fused=fused)["ids"]
        np.testing.assert_array_equal(got, want, err_msg=f"fused={fused}")


# ----------------------------------------------------- sampled scheduler


@pytest.mark.parametrize("interleaved", [False, True])
def test_sampled_scheduler_matches_jax(interleaved):
    """Sampled lanes (greedy=False) on 2 lanes, in submission order and
    reversed: the port's ids, counters and dispatches equal the JAX
    scheduler's in both orders, are the same in both, and equal each
    request's one-shot sampled generation. Seeds include one >= 2^32
    (the lanes' key layout keeps its high word)."""
    lens, new = [11, 5, 17, 8], [6, 4, 5, 7]
    seeds = [3, 2**32 + 9, 11, 12345]
    ids = []
    for order in (1, -1):
        je = _jax_engine()
        js = JScheduler(je, n_lanes=2, greedy=False, interleaved=interleaved)
        js.run(_requests(JRequest, lens, new, seeds=seeds)[::order])
        pe = _port_engine()
        ps = Scheduler(pe, n_lanes=2, greedy=False, interleaved=interleaved)
        ps.run(_requests(Request, lens, new, seeds=seeds)[::order])
        _assert_same(ps, js, pe, je)
        ids.append({rid: rs.tokens for rid, rs in ps.results.items()})
    assert ids[0] == ids[1]
    for r in _requests(Request, lens, new, seeds=seeds):
        want = pe.generate(r.prompt[None], r.max_new, chunked=True,
                           greedy=False, seed=r.seed)["ids"][0]
        assert ids[0][r.rid] == want.tolist(), r.rid


# ------------------------------------------------------------ lane surgery


def test_extract_insert_resume_bit_exact():
    """extract_lanes / insert_lanes equal the JAX package's on the same
    state and round-trip as a no-op; LanePrograms.extract then resume
    into scrubbed lanes restores every leaf, the carried tokens and the
    keys bit-exactly, also for bfloat16 K/V (carried as int16 bits)."""
    cfg_j, params, gates, cfg, model = _models()
    pe = _port_engine()
    tokens = np.random.RandomState(3).randint(0, 64, (3, 20))
    state, _ = pe.prefill(tokens, chunked=True, fused=False)
    js, _ = _jax_engine().prefill(tokens, chunked=True)
    lanes = [2, 0]
    sub = T.extract_lanes(state, lanes)
    jsub = jax.device_get(JT.extract_lanes(js, np.asarray(lanes, np.int32)))
    got = bridge.state_to_numpy(sub, cfg)
    for gl, wl in zip(got["layers"], jsub["layers"]):
        np.testing.assert_array_equal(gl["pos"], wl["pos"])
    before = {"t": state["t"].clone(),
              "layers": [{k: v.clone() for k, v in st.items()}
                         for st in state["layers"]]}
    T.insert_lanes(state, sub, lanes)
    for dtype in (torch.float32, torch.bfloat16):
        st = {"t": before["t"].clone(),
              "layers": [{k: (v.to(dtype) if k in ("k", "v") else v.clone())
                          for k, v in l.items()} for l in before["layers"]]}
        progs = pe._lane_programs(3, None)
        progs.state = st
        progs.tok.copy_(torch.tensor([5, 6, 7]))
        progs.keys.copy_(torch.tensor([[1, 2], [3, 4], [2**32 - 1, 9]]))
        snaps = progs.extract(lanes)
        assert snaps[0][0]["layers"][0]["k"].dtype == (
            np.int16 if dtype == torch.bfloat16 else np.float32)
        mask = torch.tensor([True, False, True])
        progs.scrub(mask)
        progs.tok.zero_()
        progs.keys.zero_()
        progs.resume(lanes, [s[0] for s in snaps], [s[1] for s in snaps],
                     [s[2] for s in snaps])
        assert progs.tok.tolist() == [5, 0, 7]
        assert progs.keys[2].tolist() == [2**32 - 1, 9]
        for lane in lanes:
            assert torch.equal(progs.state["t"][lane], before["t"][lane])
            for a, b in zip(progs.state["layers"], before["layers"]):
                for k in a:
                    w = b[k][lane].to(a[k].dtype)
                    assert torch.equal(a[k][lane], w), (dtype, lane, k)
    for a, b in zip(state["layers"], before["layers"]):
        for k in a:
            assert torch.equal(a[k], b[k]), k


# --------------------------------------------------------- swap and park


@pytest.mark.parametrize("interleaved", [False, True])
@pytest.mark.parametrize("policy,greedy", [("trimkv", False), ("h2o", True)])
def test_swap_resume_matches_jax(policy, greedy, interleaved):
    """swap_preempt=True (the default), one lane: a decoding request is
    swapped out by a higher-priority arrival and resumed; ids, n_swaps,
    n_resumes and dispatches equal the JAX scheduler's, and the victim's
    ids its uninterrupted one-shot run's."""
    runs = []
    for cls, make_eng, make_sched in (
            (JRequest, _jax_engine, JScheduler),
            (Request, _port_engine, Scheduler)):
        eng = make_eng(policy, sched_policy="priority")
        sched = make_sched(eng, n_lanes=1, greedy=greedy,
                           interleaved=interleaved)
        reqs = _requests(cls, [9, 7], [12, 4], priority=[0, 3])
        sched.submit(reqs[0])
        for _ in range(4):
            sched.step()
        assert sched.active[0]
        sched.submit(reqs[1])
        sched.run()
        runs.append((sched, eng))
    (js, je), (ps, pe) = runs
    _assert_same(ps, js, pe, je)
    assert ps.n_swaps >= 1 and ps.n_resumes >= 1
    assert ps.results[0].n_preempts >= 1
    r = _requests(Request, [9], [12])[0]
    want = pe.generate(r.prompt[None], r.max_new, chunked=True,
                       greedy=greedy, seed=r.seed)["ids"][0]
    assert ps.results[0].tokens == want.tolist()


def test_park_revive_matches_jax():
    """park frees a decoding lane (snapshot + reset), the queue drains
    around it, revive resumes it; misuse raises in both."""
    runs = []
    for cls, make_eng, make_sched in (
            (JRequest, _jax_engine, JScheduler),
            (Request, _port_engine, Scheduler)):
        eng = make_eng()
        sched = make_sched(eng, n_lanes=1, greedy=False)
        reqs = _requests(cls, [9, 7], [10, 4])
        sched.submit(reqs[0])
        for _ in range(2):
            sched.step()
        assert sched.park(0).status.value == "parked"
        with pytest.raises(ValueError, match="not running"):
            sched.park(0)
        sched.submit(reqs[1])
        sched.run()
        with pytest.raises(ValueError, match="not parked"):
            sched.revive(1)
        sched.revive(0)
        sched.run()
        runs.append((sched, eng))
    (js, je), (ps, pe) = runs
    _assert_same(ps, js, pe, je)
    assert ps.n_swaps == 1 and ps.n_resumes == 1
    ps.close()


@pytest.mark.parametrize("exempt", [True, False])
def test_parked_timeout_matches_jax(exempt):
    """serve.park_exempts_timeout, as the JAX package's tests of it: with
    True (the default) a PARKED request outlives its timeout_ms and,
    revived long past it, times out while queued; with False it goes
    TIMED_OUT while parked, with no dispatch, and its snapshot is
    released. Statuses, reasons, counters and dispatches equal the JAX
    scheduler's."""
    runs = []
    for cls, make_eng, make_sched in (
            (JRequest, _jax_engine, JScheduler),
            (Request, _port_engine, Scheduler)):
        eng = make_eng(park_exempts_timeout=exempt)
        sched = make_sched(eng, n_lanes=1, greedy=False)
        sched.submit(_requests(cls, [9], [8], timeout_ms=[5])[0])
        sched.step()
        sched.park(0)
        assert sched.store.has(0)
        time.sleep(0.02)                 # well past timeout_ms=5
        before = eng.dispatch_count
        for _ in range(3):
            sched.step()
        rs = sched.results[0]
        if exempt:
            assert rs.status.value == "parked" and sched.n_timeouts == 0
            sched.revive(0)
            sched.run()
            assert "while queued" in rs.reason
        else:
            assert "while parked" in rs.reason
            assert eng.dispatch_count == before
            sched.store.flush()
            assert not sched.store.has(0)
            with pytest.raises(ValueError, match="not parked"):
                sched.revive(0)
        assert rs.status.value == "timed_out" and sched.n_timeouts == 1
        runs.append((sched, eng))
    (js, je), (ps, pe) = runs
    _assert_same(ps, js, pe, je)
    assert ps.results[0].reason == js.results[0].reason
    ps.close()


def test_park_restart_revive_matches_jax(tmp_path):
    """Two sampled requests parked with a snapshot directory; the
    scheduler is dropped; a new one over the directory recovers both as
    PARKED, revives and finishes them with the ids of the JAX
    scheduler's uninterrupted run."""
    lens, new = [9, 13], [10, 8]
    je = _jax_engine()
    js = JScheduler(je, n_lanes=2, greedy=False)
    want = js.run(_requests(JRequest, lens, new))
    d = str(tmp_path)
    pe = _port_engine(snapshot_dir=d)
    first = Scheduler(pe, n_lanes=2, greedy=False)
    for r in _requests(Request, lens, new):
        first.submit(r)
    for _ in range(3):
        first.step()
    for rid in (0, 1):
        first.park(rid)
    first.run()
    first.close()
    del first
    second = Scheduler(_port_engine(snapshot_dir=d), n_lanes=2, greedy=False)
    assert second.n_recovered_sessions == 2
    assert {r.status for r in second.results.values()} == {Status.PARKED}
    for rid in (0, 1):
        second.revive(rid)
    got = second.run()
    second.close()
    assert second.n_resumes == 1 and second.n_prefill_rounds == 0
    assert second.stats()["store_disk_hits"] == 2
    for rid, rs in want.items():
        assert got[rid].status is Status.DONE
        assert got[rid].tokens == rs.tokens, rid


# --------------------------------------------------- quarantine and replay


def _fault_runs(make_injector_kw, *, lens, new, host, toggle=None):
    """The same injector schedule against both schedulers, sampled lanes
    on one lane. toggle(sched, inj, i) may change the injector before
    step i (None: run to the end). Returns ((js, je), (ps, pe))."""
    runs = []
    for cls, make_eng, make_sched, make_inj in (
            (JRequest, _jax_engine, JScheduler, JFaultInjector),
            (Request, _port_engine, Scheduler, FaultInjector)):
        eng = make_eng(**host)
        inj = make_inj(**make_injector_kw)
        sched = make_sched(eng, n_lanes=1, greedy=False, injector=inj)
        for r in _requests(cls, lens, new):
            sched.submit(r)
        if toggle is not None:
            for i in range(3):
                toggle(sched, inj, i)
                sched.step()
            inj.corrupt_prob = 0.0
        sched.run()
        runs.append((sched, eng))
    return runs


def test_nan_poison_recovery_matches_jax():
    """A NaN-poisoned lane trips its health flag, is scrubbed and
    replayed from scratch, and finishes with the JAX scheduler's (and
    its one-shot run's) ids."""
    def toggle(sched, inj, i):
        inj.corrupt_prob = 1.0 if i == 1 else 0.0

    (js, je), (ps, pe) = _fault_runs(
        dict(seed=0), lens=[9], new=[8], host=dict(max_retries=2),
        toggle=toggle)
    _assert_same(ps, js, pe, je)
    assert ps.n_quarantined == 1 and ps.results[0].n_retries == 1
    assert ps.results[0].status is Status.DONE
    r = _requests(Request, [9], [8])[0]
    want = pe.generate(r.prompt[None], r.max_new, chunked=True,
                       greedy=False, seed=r.seed)["ids"][0]
    assert ps.results[0].tokens == want.tolist()


def test_persistent_corruption_fails_matches_jax():
    (js, je), (ps, pe) = _fault_runs(
        dict(seed=0, corrupt_prob=1.0), lens=[9], new=[12],
        host=dict(max_retries=1))
    _assert_same(ps, js, pe, je)
    assert ps.results[0].status is Status.FAILED
    assert "non-finite" in ps.results[0].reason
    assert ps.results[0].n_retries == 2 and ps.n_failed == 1


def test_checkpoint_replay_matches_jax():
    """checkpoint_every=1: a poisoned lane is replayed from its last
    checkpoint (a resume, no second prefill), with the JAX scheduler's
    ids and counters."""
    def toggle(sched, inj, i):
        inj.corrupt_prob = 1.0 if i == 2 else 0.0

    (js, je), (ps, pe) = _fault_runs(
        dict(seed=0), lens=[9], new=[10],
        host=dict(max_retries=2, checkpoint_every=1), toggle=toggle)
    _assert_same(ps, js, pe, je)
    assert ps.n_resumes >= 1 and ps.n_prefill_rounds == 1
    assert ps.n_quarantined == 1
    assert ps.results[0].status is Status.DONE
    ps.close()


def test_flipped_snapshot_bit_replays_matches_jax():
    """A bit flipped in a stored checkpoint is caught by its checksum at
    the resume (n_snapshot_lost) and the request is replayed from its
    prompt, as in the JAX scheduler."""
    def toggle(sched, inj, i):
        inj.corrupt_prob = 1.0 if i == 2 else 0.0
        if i == 2:
            assert sched.store.chaos_corrupt(np.random.default_rng(0)) \
                == "ram"

    (js, je), (ps, pe) = _fault_runs(
        dict(seed=0), lens=[9], new=[10],
        host=dict(max_retries=2, checkpoint_every=1), toggle=toggle)
    _assert_same(ps, js, pe, je)
    assert ps.n_snapshot_lost == 1 and ps.n_prefill_rounds == 2
    assert ps.results[0].status is Status.DONE
    ps.close()


# ------------------------------------------------------------ chaos soak

INJECTOR_COUNTERS = ("n_corrupted", "n_delayed", "n_bursts",
                     "n_burst_submitted", "n_snap_corrupted_ram",
                     "n_snap_corrupted_disk", "n_io_errors_armed")
STORE_COUNTERS = ("store_puts", "store_ram_hits", "store_disk_hits",
                  "store_misses", "store_spills", "store_dropped",
                  "store_corrupt_detected",
                  "store_write_errors", "store_io_errors",
                  "store_chaos_corrupted", "n_shed", "n_timeouts")


@pytest.mark.parametrize("store_chaos", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_chaos_soak_matches_jax(tmp_path, seed, store_chaos):
    """The JAX package's seeded chaos soak (tests/test_faults.py
    _chaos_run) against both schedulers, sampled: lane poisons, dispatch
    delays and bursts of hostile traffic (malformed requests rejected,
    the queue of 4 shedding) over a preemptible priority workload with
    checkpoints every 2 segments; with store_chaos, bits flipped in
    stored slabs and armed disk IO errors (failed and torn writes) over
    a snapshot directory. The timeouts are set far out, so that wall
    time (the two runs differ in speed) decides nothing. Every request,
    bursts included, ends in one terminal status with a reason where it
    did not finish; statuses, ids, retries, the scheduler's, the
    store's and the injector's counters and the dispatch totals equal
    the JAX scheduler's; a DONE user request has its one-shot ids."""
    runs = []
    for cls, make_eng, make_sched, make_inj, sub in (
            (JRequest, _jax_engine, JScheduler, JFaultInjector, "jax"),
            (Request, _port_engine, Scheduler, FaultInjector, "port")):
        host = dict(sched_policy="priority", max_queue=4, max_retries=1,
                    checkpoint_every=2,
                    snapshot_dir=(str(tmp_path / sub) if store_chaos
                                  else None))
        eng = make_eng(**host)
        inj = make_inj(seed=seed, corrupt_prob=0.25, delay_prob=0.2,
                       delay_sec=0.002, burst_prob=0.5, burst_size=6,
                       max_bursts=3, burst_invalid_frac=0.3,
                       snap_corrupt_prob=0.5 if store_chaos else 0.0,
                       io_error_prob=0.3 if store_chaos else 0.0)
        sched = make_sched(eng, n_lanes=2, greedy=False, injector=inj)
        reqs = _requests(cls, [9, 7, 12, 5, 8], [8, 4, 6, 5, 4],
                         priority=[0, 3, 1, 0, 2],
                         timeout_ms=[None, 600_000, None, 600_000, None])
        for r in reqs:
            sched.submit(r)
        sched.run()
        sched.store.flush()            # the writer's counters settle
        runs.append((sched, eng))
    (js, je), (ps, pe) = runs
    _assert_same(ps, js, pe, je)
    assert ps.results.keys() == js.results.keys()
    pst, jst = ps.stats(), js.stats()
    # which queued write an armed IO fault meets is up to the writer
    # thread's timing (an arm waits for the next write the thread takes,
    # and a second arm before it replaces the first), so the count of
    # failed writes is not held across the two runs; under store chaos
    # every slab keeps its RAM copy, so no outcome depends on it
    same = [k for k in STORE_COUNTERS
            if not (store_chaos and k == "store_write_errors")]
    assert {k: pst[k] for k in same} == {k: jst[k] for k in same}
    for k in INJECTOR_COUNTERS:
        assert getattr(ps.injector, k) == getattr(js.injector, k), k
    ps.close()
    assert ps.idle and ps.injector.n_burst_submitted > 0
    assert pst["store_puts"] > 0
    for rid, rs in ps.results.items():
        assert rs.status in TERMINAL_STATUSES and rs.finish_sec is not None
        if rs.status in (Status.REJECTED, Status.FAILED, Status.TIMED_OUT):
            assert rs.reason, rid
    inj = ps.injector
    if store_chaos:
        assert (inj.n_snap_corrupted_ram + inj.n_snap_corrupted_disk
                + inj.n_io_errors_armed) > 0
    else:
        assert pst["store_corrupt_detected"] == 0
        assert pst["n_snapshot_lost"] == 0
    for r in _requests(Request, [9, 7, 12, 5, 8], [8, 4, 6, 5, 4]):
        if ps.results[r.rid].status is Status.DONE:
            want = pe.generate(r.prompt[None], r.max_new, chunked=True,
                               greedy=False, seed=r.seed)["ids"][0]
            assert ps.results[r.rid].tokens == want.tolist(), r.rid
