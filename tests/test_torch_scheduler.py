"""The port's continuous-batching Scheduler against the JAX package's on
one request trace: per-request ids and statuses, the stats() counters
and the engine's dispatch_count are equal, in phased and interleaved
admission, under fifo, priority and edf ordering, with continuous
batching on and off, and under recompute preemption
(swap_preempt=False). The tiny config of the JAX scheduler tests
(float32) with the JAX package's weights through repro_torch.bridge;
JAX on attn_impl "xla". The port runs its step programs eagerly on the
CPU.

Also: on the smoke config of tests/test_torch_model.py every request's
ids equal the port's own one-shot Engine.generate(prompt[None],
chunked=True), graphs' eager twin against the reference loops; and the
parts of the JAX scheduler the port has not reached raise
NotImplementedError, while those it has run.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import transformer as JT
from repro.serve import Request as JRequest
from repro.serve import Scheduler as JScheduler
from repro.serve import build_engine as jax_build_engine
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.models import transformer as T
from repro_torch.serve.engine import build_engine
from repro_torch.serve.request import Request, Status
from repro_torch.serve.scheduler import Scheduler

ARCH = "trimkv-paper-4b"
TINY = dict(num_layers=2, d_model=64, d_ff=128, num_heads=4, num_kv_heads=2,
            vocab_size=64, gate_bias_init=3.0)
SERVE = dict(budget=8, prefill_chunk=8, decode_segment=4)
LENS = [21, 7, 30, 12, 3]
MAX_NEW = [6, 3, 9, 5, 2]
PRIORITY = [0, 1, 0, 2, 1]
DEADLINE = [900.0, 300.0, None, 100.0, 500.0]


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
def _jax_engine():
    """One JAX engine for every mode, so its compiled lane closures are
    shared: a mode swaps in the serve config's host-side scheduling
    fields (ordering, prefill budget), which no closure reads."""
    cfg_j, params, gates, _, _ = _models()
    return jax_build_engine(cfg_j, params, gates, swap_preempt=False,
                            **SERVE)


def _trace(cls, eos=None):
    rng = np.random.RandomState(11)
    prompts = [rng.randint(0, TINY["vocab_size"], size=L).astype(np.int32)
               for L in LENS]
    return [cls(rid=i, prompt=p, max_new=m, seed=i, priority=pr,
                deadline_ms=dl, eos_id=-1 if eos is None else eos[i])
            for i, (p, m, pr, dl) in enumerate(zip(prompts, MAX_NEW,
                                                   PRIORITY, DEADLINE))]


def _drive(sched, reqs, preempt):
    """Serve the trace: all at once, or (preempt) the two long
    priority-0 requests alone for one round before the others arrive,
    so better-ranked arrivals find every lane busy."""
    if preempt:
        first = [r for r in reqs if r.rid in (0, 2)]
        for r in first:
            sched.submit(r)
        sched.step()
        for r in reqs:
            if r not in first:
                sched.submit(r)
        return sched.run()
    return sched.run(reqs)


# edf deadlines are absolute on each scheduler's wall clock, so edf runs
# submit the whole trace at once (the order is then the deadlines');
# preemption is driven under priority, which has no clock in it
MODES = [  # sched_policy, interleaved, continuous, prefill_budget, preempt
    ("fifo", False, True, 0, False),
    ("fifo", True, True, 8, False),
    ("fifo", False, False, 0, False),
    ("priority", False, True, 0, True),
    ("priority", True, True, 0, True),
    ("edf", True, True, 16, False),
    ("edf", False, False, 0, False),
]


@pytest.mark.parametrize("mode", MODES, ids=lambda m: "-".join(map(str, m)))
def test_scheduler_matches_jax(mode):
    policy, interleaved, continuous, budget, preempt = mode
    _, _, _, cfg, model = _models()
    eos = [-1, -1, 0, -1, -1]
    je = _jax_engine()
    je.serve = dataclasses.replace(je.serve, sched_policy=policy,
                                   prefill_budget=budget)
    je.dispatch_count = 0
    js = JScheduler(je, n_lanes=2, interleaved=interleaved,
                    continuous=continuous)
    want = _drive(js, _trace(JRequest, eos), preempt)
    te = build_engine(cfg, model, device="cpu", sched_policy=policy,
                      swap_preempt=False, prefill_budget=budget, **SERVE)
    ts = Scheduler(te, n_lanes=2, interleaved=interleaved,
                   continuous=continuous)
    got = _drive(ts, _trace(Request, eos), preempt)
    for rid, rs in want.items():
        assert got[rid].status.value == rs.status.value, rid
        assert got[rid].tokens == rs.tokens, rid
        assert got[rid].n_preempts == rs.n_preempts, rid
    stats = ts.stats()
    assert stats == {k: js.stats()[k] for k in stats}
    assert te.dispatch_count == je.dispatch_count == (
        ts.n_prefill_rounds + ts.n_segments + ts.n_resets)
    assert ts.decode_bucket_lengths == js.decode_bucket_lengths
    assert ts.prefill_bucket_lengths == js.prefill_bucket_lengths
    if preempt:
        assert ts.n_preempted >= 1


@functools.lru_cache(maxsize=None)
def _smoke_model():
    cfg = get_smoke_config(ARCH)
    model = T.init_params(cfg, seed=0, device="cpu")
    T.init_gate_params(model, cfg, seed=1)
    return cfg, model


@pytest.mark.parametrize("interleaved", [False, True])
def test_scheduler_matches_port_oneshot(interleaved):
    """Each request's ids equal its one-shot chunked generation, fused
    (the step programs) and eager (the reference loops)."""
    cfg, model = _smoke_model()
    serve = dict(budget=32, prefill_chunk=16, decode_segment=4)
    rng = np.random.RandomState(5)
    reqs = [Request(rid=i, prompt=rng.randint(0, cfg.vocab_size, size=L),
                    max_new=m)
            for i, (L, m) in enumerate([(40, 6), (9, 3), (70, 5), (16, 4)])]
    eng = build_engine(cfg, model, device="cpu", **serve)
    res = Scheduler(eng, n_lanes=2, interleaved=interleaved).run(reqs)
    for r in reqs:
        assert res[r.rid].status is Status.DONE
        for fused in (True, False):
            want = eng.generate(r.prompt[None], r.max_new, chunked=True,
                                fused=fused)["ids"][0]
            np.testing.assert_array_equal(res[r.rid].ids, want)


def test_unported_parts_raise():
    """The prefix cache, speculative decoding and cross-memory families
    raise; the parts this module ported since (sampled lanes, park and
    revive, an injector, checkpoints and a snapshot directory, and swap
    preemption, the default) run."""
    _, _, _, cfg, model = _models()
    eng = build_engine(cfg, model, device="cpu", **SERVE)
    for kw in (dict(prefix_cache_bytes=1 << 20), dict(spec_k=2)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Scheduler(build_engine(cfg, model, device="cpu", **SERVE, **kw),
                      n_lanes=2)
    reqs = _trace(Request)
    for kw in (dict(checkpoint_every=2), dict(snapshot_host_bytes=1 << 30)):
        sched = Scheduler(build_engine(cfg, model, device="cpu", **SERVE,
                                       **kw), n_lanes=2)
        res = sched.run(reqs[:2])
        sched.close()
        assert all(res[r.rid].status is Status.DONE for r in reqs[:2])
    from repro_torch.serve.faults import FaultInjector
    sched = Scheduler(eng, n_lanes=2, injector=FaultInjector(seed=0))
    res = sched.run(reqs[:2])
    assert all(res[r.rid].status is Status.DONE for r in reqs[:2])
    sampled = Scheduler(build_engine(cfg, model, device="cpu",
                                     temperature=0.7, **SERVE),
                        n_lanes=2, greedy=False)
    res = sampled.run(reqs[:2])
    assert all(len(res[r.rid].tokens) == r.max_new for r in reqs[:2])
    sched = Scheduler(eng, n_lanes=2)
    sched.submit(reqs[0])
    sched.step()
    assert sched.park(0).status is Status.PARKED
    assert sched.revive(0).status is Status.QUEUED
    assert sched.run()[0].status is Status.DONE
    # a decoding victim under swap_preempt=True is swapped out
    swap = Scheduler(build_engine(cfg, model, device="cpu",
                                  sched_policy="priority", **SERVE),
                     n_lanes=1)
    res = _drive(swap, [reqs[0], reqs[3]], preempt=True)
    assert swap.n_swaps >= 1 and swap.n_resumes >= 1
    assert res[0].status is res[3].status is Status.DONE
