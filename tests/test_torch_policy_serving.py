"""Serving under every eviction policy, the port against the JAX package,
on the JAX package's weights through repro_torch.bridge (JAX on its
plain path, attn_impl "xla"; the port on its plain PyTorch versions,
through the same step programs it replays as CUDA graphs on the card).

- Engine.generate, greedy, single-shot and chunked, per policy on the
  smoke config of tests/test_torch_model.py (perturbed gate biases,
  recency and observation windows of 8 under a budget of 32):
  identical ids and every layer's slot positions, aux (and k, v, beta)
  within 1e-4; FullKV with a budget that covers prompt and output.
- Engine.teacher_forced_accuracy under the policies that read attention.
- The continuous-batching Scheduler, phased and interleaved, under H2O
  and R-KV against the JAX Scheduler on the tiny config of
  tests/test_torch_scheduler.py: per-request ids, statuses, counters.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _jax_weights as jax_weights
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.policies import POLICIES
from repro.models import transformer as JT
from repro.serve import Request as JRequest
from repro.serve import Scheduler as JScheduler
from repro.serve.engine import build_engine as jax_build_engine
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.data.synthetic import make_batch
from repro_torch.serve.engine import build_engine
from repro_torch.serve.request import Request
from repro_torch.serve.scheduler import Scheduler

ARCH = "trimkv-paper-4b"
TOL = dict(atol=1e-4, rtol=1e-4)
PROMPT, NEW = 70, 8


def _budget(name):
    return PROMPT + NEW + 2 if name == "full" else 32


@functools.lru_cache(maxsize=None)
def _smoke(tiny=False):
    """(cfg_j, params, gates, cfg, model): the smoke config with
    perturbed gate biases, or (tiny) the scheduler tests' tiny config."""
    torch.set_num_threads(1)
    cfg_j, cfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    if tiny:
        kw = dict(num_layers=2, d_model=64, d_ff=128, num_heads=4,
                  num_kv_heads=2, vocab_size=64, gate_bias_init=3.0)
        cfg_j = dataclasses.replace(cfg_j, **kw)
        cfg = dataclasses.replace(cfg, **kw)
    params = jax.device_get(jax_weights.init_params(cfg_j))
    gates = jax.device_get(jax_weights.init_gate_params(cfg_j))
    if not tiny:
        g0 = dict(gates["layers"][0])
        g0["b"] = np.random.RandomState(7).uniform(
            2.0, 8.0, g0["b"].shape).astype(np.float32)
        gates = {"layers": (g0,), "tail": gates["tail"]}
    model = bridge.params_from_jax(params, cfg, device="cpu")
    bridge.gates_from_jax(gates, cfg, model)
    return (cfg_j, jax.tree.map(jnp.asarray, params),
            jax.tree.map(jnp.asarray, gates), cfg, model)


def _serve(name):
    # windows well inside the budget: the scores, not recency, evict
    return dict(budget=_budget(name), policy=name, prefill_chunk=16,
                recent_window=8, obs_window=8)


@functools.lru_cache(maxsize=None)
def _jax_engine(name):
    """One JAX engine per policy: its generate and teacher-forcing cases
    share its compiled closures."""
    cfg_j, params, gates, _, _ = _smoke()
    return jax_build_engine(cfg_j, params, gates, **_serve(name))


def _engines(name):
    _, _, _, cfg, model = _smoke()
    return (_jax_engine(name),
            build_engine(cfg, model, device="cpu", **_serve(name)))


def _assert_states(got, want, cfg):
    g = bridge.state_to_numpy(got, cfg)
    w = jax.device_get(want)
    np.testing.assert_array_equal(g["t"], w["t"])
    for gl, wl in zip(g["layers"], w["layers"]):
        np.testing.assert_array_equal(gl["pos"], wl["pos"], err_msg="pos")
        for k in ("aux", "k", "v", "beta"):
            np.testing.assert_allclose(gl[k], wl[k], err_msg=k, **TOL)


@pytest.mark.parametrize("chunked", [False, True],
                         ids=["single-shot", "chunked"])
@pytest.mark.parametrize("name", tuple(POLICIES))
def test_generate_matches_jax(name, chunked):
    """A 70-token prompt (chunks of 16, the last padded) and 8 greedy
    tokens: the JAX engine's generate is its prefill and fused decode
    loop, run here step by step to read its final state."""
    je, te = _engines(name)
    tokens, _, _ = make_batch("copy", 2, 2, PROMPT,
                              get_smoke_config(ARCH).vocab_size)
    js, jh = je.prefill(tokens, chunked=chunked)
    js, want = je._decode_loop(js, jh, jax.random.PRNGKey(0), NEW, True)
    out = te.generate(tokens, NEW, chunked=chunked)
    np.testing.assert_array_equal(out["ids"], np.asarray(want))
    _assert_states(out["state"], js, get_smoke_config(ARCH))


@pytest.mark.parametrize("name", ("h2o", "snapkv", "rkv"))
def test_teacher_forced_accuracy_matches_jax(name):
    je, te = _engines(name)
    tokens, labels, _ = make_batch("copy", 3, 2, 64,
                                   get_smoke_config(ARCH).vocab_size)
    want = je.teacher_forced_accuracy(tokens, labels, chunked=True)
    assert te.teacher_forced_accuracy(tokens, labels, chunked=True) == want


SERVE = dict(budget=8, prefill_chunk=8, decode_segment=4)
LENS, MAX_NEW = [21, 7, 30, 12, 3], [6, 3, 9, 5, 2]


def _sched_serve(name):
    return dict(policy=name, swap_preempt=False, prefill_budget=8,
                recent_window=3, obs_window=4, **SERVE)


@functools.lru_cache(maxsize=None)
def _jax_sched_engine(name):
    """One JAX engine per policy for both admission modes (the segment
    closure is compiled once); a case resets its dispatch count."""
    cfg_j, params, gates, _, _ = _smoke(tiny=True)
    return jax_build_engine(cfg_j, params, gates, **_sched_serve(name))


def _trace(cls):
    rng = np.random.RandomState(11)
    return [cls(rid=i, prompt=rng.randint(0, 64, size=L).astype(np.int32),
                max_new=m, seed=i)
            for i, (L, m) in enumerate(zip(LENS, MAX_NEW))]


@pytest.mark.parametrize("interleaved", [False, True],
                         ids=["phased", "interleaved"])
@pytest.mark.parametrize("name", ("h2o", "rkv"))
def test_scheduler_matches_jax(name, interleaved):
    """Five requests on two lanes: ragged admission grids, retired and
    refilled lanes, frozen lanes whose aux must not move."""
    _, _, _, cfg, model = _smoke(tiny=True)
    je = _jax_sched_engine(name)
    je.dispatch_count = 0
    want = JScheduler(je, n_lanes=2, interleaved=interleaved).run(
        _trace(JRequest))
    te = build_engine(cfg, model, device="cpu", **_sched_serve(name))
    ts = Scheduler(te, n_lanes=2, interleaved=interleaved)
    got = ts.run(_trace(Request))
    for rid, rs in want.items():
        assert got[rid].status.value == rs.status.value, rid
        assert got[rid].tokens == rs.tokens, rid
    assert te.dispatch_count == je.dispatch_count
    # a drained scheduler's lanes were reset: no slot, no aux left
    for st in ts.lanes.state["layers"]:
        assert (st["pos"] < 0).all() and (st["aux"] == 0).all()
