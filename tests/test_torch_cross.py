"""The port's cross-memory families (vlm: llama-3.2-vision-90b, encdec:
seamless-m4t-large-v2) against the JAX package's, on their smoke
configs (2 layers, float32), and the three D-128 dense configs
(qwen2.5-14b, codeqwen1.5-7b, minitron-8b).

Weights: drawn with numpy as the JAX package's init draws them
(tests/_jax_weights.py), moved to the port through
repro_torch.bridge, with every cross layer's xgate drawn from
U(0.5, 1.5) first: the JAX init sets it to 0, where tanh(xgate) = 0
makes the memory change nothing, so a parity test on the init would hold
nothing of cross-attention. Gate biases are drawn from U(2, 8), so
eviction is decided by the scores; the dense configs' qkv biases
(zero in the JAX init) are drawn from N(0, 0.5). Inputs come from numpy
seeds. The JAX side runs its XLA path (its plain reference of the
Pallas kernels); the port runs its plain PyTorch versions.

Tolerances: memory tokens within 1e-5 (absolute and relative; float32
in another summation order), attention outputs within 1e-5; greedy ids,
slot positions, statuses, stats() and dispatch counts exactly.

Cost: the JAX scheduler runs in exactly the four scheduler cases; the
other JAX runs are one-shot generates and single functions.
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
from repro.core import cache as jcache
from repro.models import common as jcommon
from repro.models import transformer as JT
from repro.serve import Request as JRequest
from repro.serve import Scheduler as JScheduler
from repro.serve.engine import build_engine as jax_build_engine
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.core.cache import memory_attend
from repro_torch.models import common
from repro_torch.models import transformer as T
from repro_torch.serve.engine import build_engine
from repro_torch.serve.graphs import host_row_template
from repro_torch.serve.prefix_cache import state_row_bytes
from repro_torch.serve.request import Request, Status
from repro_torch.serve.scheduler import Scheduler

CROSS = ("seamless-m4t-large-v2", "llama-3.2-vision-90b")
DENSE = ("qwen2.5-14b", "codeqwen1.5-7b", "minitron-8b")
POLICIES = ("trimkv", "streaming_llm", "h2o", "snapkv", "rkv", "keydiff",
            "full")
TOL = dict(atol=1e-5, rtol=1e-5)
SERVE = dict(budget=16, prefill_chunk=16, decode_segment=4)


def _perturb(tree, rng, gates):
    """A copy of a numpy params (or gates) tree with xgate ~ U(0.5, 1.5)
    and qkv biases ~ N(0, 0.5) (params), or gate biases ~ U(2, 8)
    (gates)."""
    if isinstance(tree, tuple):
        return tuple(_perturb(v, rng, gates) for v in tree)
    if not isinstance(tree, dict):
        return tree
    out = {k: _perturb(v, rng, gates) for k, v in tree.items()}
    if gates and "w1" in tree:
        out["b"] = rng.uniform(2.0, 8.0, tree["b"].shape).astype(np.float32)
    if not gates and "xgate" in tree:
        out["xgate"] = rng.uniform(0.5, 1.5,
                                   np.shape(tree["xgate"])).astype(np.float32)
    if not gates:
        for name in ("wq", "wk", "wv"):
            if name in tree and "b" in tree[name]:
                out[name] = dict(out[name], b=rng.normal(
                    0, 0.5, tree[name]["b"].shape).astype(np.float32))
    return out


@functools.lru_cache(maxsize=None)
def _models(arch):
    """(JAX cfg, params, gates, port cfg, port model): one set of
    weights."""
    torch.set_num_threads(1)
    cfg_j, cfg = jax_smoke_config(arch), get_smoke_config(arch)
    rng = np.random.RandomState(7)
    params = _perturb(jax.device_get(jax_weights.init_params(cfg_j)), rng,
                      False)
    gates = _perturb(jax.device_get(jax_weights.init_gate_params(cfg_j)), rng,
                     True)
    model = bridge.params_from_jax(params, cfg, device="cpu")
    bridge.gates_from_jax(gates, cfg, model)
    return (cfg_j, jax.tree.map(jnp.asarray, params),
            jax.tree.map(jnp.asarray, gates), cfg, model)


def _mem_spec(cfg):
    """(extra_inputs key, S, feat) of a cross family."""
    if cfg.family == "vlm":
        return "vision_embeds", cfg.num_image_tokens, cfg.vision_dim
    return "source_embeds", cfg.source_len, cfg.d_model


def _memory(cfg, B, seed, lens=None):
    """extra_inputs of B padded memories (lens: valid rows per lane)."""
    key, S, feat = _mem_spec(cfg)
    rng = np.random.RandomState(seed)
    extra = {key: rng.randn(B, S, feat).astype(np.float32)}
    if lens is not None:
        extra["mem_len"] = np.asarray(lens, np.int32)
    return extra


def _tokens(cfg, B, L, seed):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (B, L)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_engine(arch, **kw):
    """One JAX engine per (arch, serve fields): the cases that share one
    share its compiled closures."""
    cfg_j, params, gates, _, _ = _models(arch)
    return jax_build_engine(cfg_j, params, gates, **{**SERVE, **kw})


def _engines(arch, **kw):
    """(JAX engine, port engine); the JAX one cached, its dispatch count
    reset."""
    _, _, _, cfg, model = _models(arch)
    je = _jax_engine(arch, **kw)
    je.dispatch_count = 0
    return je, build_engine(cfg, model, device="cpu", **{**SERVE, **kw})


# ------------------------------------------------------ bridge and memory


@pytest.mark.parametrize("arch", CROSS)
def test_memory_from_inputs_matches_jax(arch):
    """The vision projection, and the encoder over a ragged batch: the
    valid rows of the memory tokens within 1e-5."""
    cfg_j, params, _, cfg, model = _models(arch)
    _, S, _ = _mem_spec(cfg)
    lens = [S, S // 2 + 1, 1]
    extra = _memory(cfg, 3, 1, lens)
    want, want_len = JT._memory_from_inputs(
        params, cfg_j, {k: jnp.asarray(v) for k, v in extra.items()})
    got, got_len = T.memory_from_inputs(model, cfg, extra)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    for b, n in enumerate(lens):
        np.testing.assert_allclose(got[b, :n].numpy(),
                                   np.asarray(want)[b, :n], **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_chunked_attention_kv_positions_matches_jax(causal):
    """chunked_attention with key positions (-1 masked; a row with every
    key masked gives exactly 0) against the JAX package's, across
    ragged q and kv blocks."""
    rng = np.random.RandomState(3)
    B, Tq, Tk, Hq, Hkv, D = 3, 21, 37, 4, 2, 8
    q = rng.randn(B, Tq, Hq, D).astype(np.float32)
    k = rng.randn(B, Tk, Hkv, D).astype(np.float32)
    v = rng.randn(B, Tk, Hkv, D).astype(np.float32)
    lb = -np.abs(rng.randn(B, Tk, Hkv)).astype(np.float32) * 0.1
    pos = np.tile(np.arange(Tk, dtype=np.int32), (B, 1))
    pos[0, 30:] = -1
    pos[1, ::3] = -1
    pos[2] = -1                                   # no visible key at all
    kw = dict(causal=causal, q_block=8, kv_block=16)
    want = jcommon.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), log_beta=jnp.asarray(lb),
                                     kv_positions=jnp.asarray(pos), **kw)
    got = common.chunked_attention(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
        log_beta=torch.as_tensor(lb), kv_positions=torch.as_tensor(pos), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not got[2].any()


def test_memory_attend_matches_jax():
    """The plain decode over memory_pos: the port's [B, Hkv, S, D] slab
    against the JAX package's [B, S, Hkv, D] one; mem_len 0 reads
    exactly 0."""
    rng = np.random.RandomState(4)
    B, S, Hq, Hkv, D = 4, 19, 8, 2, 16
    q = rng.randn(B, Hq, D).astype(np.float32)
    xk = rng.randn(B, S, Hkv, D).astype(np.float32)
    xv = rng.randn(B, S, Hkv, D).astype(np.float32)
    mem_len = np.array([S, 7, 0, 1], np.int32)
    want = jcache.memory_attend(jnp.asarray(q), jnp.asarray(xk),
                                jnp.asarray(xv), jnp.asarray(mem_len))
    got = memory_attend(torch.as_tensor(q),
                        torch.as_tensor(xk.transpose(0, 2, 1, 3)),
                        torch.as_tensor(xv.transpose(0, 2, 1, 3)),
                        torch.as_tensor(mem_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not got[2].any()


# -------------------------------------------------------- one-shot runs


ONESHOT = [  # arch, chunked, policy
    (arch, chunked, policy) for arch in CROSS
    for chunked, policy in ((False, "trimkv"), (True, "trimkv"),
                            (True, "h2o"))]


@pytest.mark.parametrize("case", ONESHOT, ids=lambda c: "-".join(map(str, c)))
def test_generate_matches_jax(case):
    """Engine.generate over a ragged batch of 2 (memories of S and
    S // 2 + 1 rows): greedy ids equal to the JAX engine's, and, chunked,
    every layer's slot positions after the prefill; the port's fused
    and eager paths give the same ids."""
    arch, chunked, policy = case
    je, te = _engines(arch, policy=policy)
    cfg = te.cfg
    _, S, _ = _mem_spec(cfg)
    extra = _memory(cfg, 2, 5, [S, S // 2 + 1])
    tokens = _tokens(cfg, 2, 45, 6)
    want = je.generate(tokens, 8, extra_inputs=extra, chunked=chunked)
    got = te.generate(tokens, 8, extra_inputs=extra, chunked=chunked)
    np.testing.assert_array_equal(got["ids"], want["ids"])
    eager = te.generate(tokens, 8, extra_inputs=extra, chunked=chunked,
                        fused=False)
    np.testing.assert_array_equal(eager["ids"], want["ids"])
    if chunked:
        js, _ = je.prefill(tokens, extra, chunked=True)
        ts, _ = te.prefill(tokens, chunked=True, extra_inputs=extra)
        g = bridge._per_layer(bridge.state_to_numpy(ts, cfg), cfg)
        w = bridge._per_layer(jax.device_get(js), cfg)
        assert len(g) == len(w) == cfg.num_layers
        for gl, wl in zip(g, w):
            if "cache" in wl:
                np.testing.assert_array_equal(gl["mem_len"], wl["mem_len"])
                np.testing.assert_allclose(gl["xk"], wl["xk"], **TOL)
                gl, wl = gl["cache"], wl["cache"]
            np.testing.assert_array_equal(gl["pos"], wl["pos"])


@pytest.mark.parametrize("arch", CROSS)
def test_ids_depend_on_the_memory(arch):
    """With xgate non-zero the memory moves the output: two memories
    give two id streams, and a zero xgate makes them equal again."""
    _, _, _, cfg, model = _models(arch)
    eng = build_engine(cfg, model, device="cpu", **SERVE)
    tokens = _tokens(cfg, 2, 40, 8)
    a = eng.generate(tokens, 12, extra_inputs=_memory(cfg, 2, 1))["ids"]
    b = eng.generate(tokens, 12, extra_inputs=_memory(cfg, 2, 2))["ids"]
    assert (a != b).any()
    gates = [blk.xgate.clone() for blk in model.layers if blk.kind == "cross"]
    try:
        for blk in model.layers:
            if blk.kind == "cross":
                blk.xgate.zero_()
        a = eng.generate(tokens, 12, extra_inputs=_memory(cfg, 2, 1))["ids"]
        b = eng.generate(tokens, 12, extra_inputs=_memory(cfg, 2, 2))["ids"]
        np.testing.assert_array_equal(a, b)
    finally:
        for blk, x in zip((b_ for b_ in model.layers if b_.kind == "cross"),
                          gates):
            blk.xgate.copy_(x)


@pytest.mark.parametrize("arch", CROSS)
def test_oneshot_programs_stay_bounded(arch):
    """One-shot calls whose memories have three lengths S keep one
    program set for their batch size (rebuilt for each new S, the old
    one released), and each call's ids equal the eager loop's."""
    _, _, _, cfg, model = _models(arch)
    eng = build_engine(cfg, model, device="cpu", **SERVE)
    key, S, feat = _mem_spec(cfg)
    tokens = _tokens(cfg, 2, 40, 9)
    for n in (S, S // 2, S - 3):
        extra = {key: np.random.RandomState(n).randn(2, n, feat).astype(
            np.float32)}
        got = eng.generate(tokens, 6, chunked=True, extra_inputs=extra)
        assert list(eng._batch_programs) == [2]
        assert eng._batch_programs[2].slab_len == n
        want = eng.generate(tokens, 6, chunked=True, extra_inputs=extra,
                            fused=False)
        np.testing.assert_array_equal(got["ids"], want["ids"])


# ------------------------------------------------------------ scheduler


def _trace(cls, cfg, seed=3):
    """3 requests with distinct ragged memories: two priority-0 requests
    and a priority-3 one that arrives after the first round."""
    key, S, feat = _mem_spec(cfg)
    rng = np.random.RandomState(seed)
    return [cls(rid=i, prompt=rng.randint(0, cfg.vocab_size, L).astype(
                np.int32), max_new=m, seed=i, priority=pr,
                extra_inputs={key: rng.randn(n, feat).astype(np.float32)})
            for i, (L, m, pr, n) in enumerate([(30, 12, 0, S),
                                               (21, 10, 0, S - 5),
                                               (40, 5, 3, S // 2)])]


def _drive(sched, reqs):
    """Two lanes busy decoding when the better-ranked request arrives:
    one is swapped out, and a lane is reused."""
    sched.submit(reqs[0])
    sched.submit(reqs[1])
    sched.step()
    sched.submit(reqs[2])
    return sched.run()


@pytest.mark.parametrize("interleaved", [False, True])
@pytest.mark.parametrize("arch", CROSS)
def test_scheduler_matches_jax(arch, interleaved):
    """The port's Scheduler against the JAX Scheduler (priority order,
    swap preemption): ids, statuses, stats() and dispatch_count equal."""
    je, te = _engines(arch, sched_policy="priority")
    js = JScheduler(je, n_lanes=2, interleaved=interleaved)
    want = _drive(js, _trace(JRequest, te.cfg))
    ts = Scheduler(te, n_lanes=2, interleaved=interleaved)
    got = _drive(ts, _trace(Request, te.cfg))
    for rid, rs in want.items():
        assert got[rid].status.value == rs.status.value == "done", rid
        assert got[rid].tokens == rs.tokens, rid
    stats = ts.stats()
    assert stats == {k: js.stats()[k] for k in stats}
    assert te.dispatch_count == je.dispatch_count
    assert ts.n_swaps >= 1 and ts.n_resumes >= 1


def _oneshot(eng, r):
    return list(eng.generate(
        r.prompt[None], r.max_new, chunked=True,
        extra_inputs={k: v[None] for k, v in r.extra_inputs.items()})["ids"][0])


@pytest.mark.parametrize("policy", POLICIES)
def test_scheduler_matches_port_oneshot(policy):
    """Every request's ids equal its own one-shot chunked generate (its
    unpadded memory), both families, phased and interleaved, under every
    policy."""
    for arch in CROSS:
        _, _, _, cfg, model = _models(arch)
        eng = build_engine(cfg, model, device="cpu", policy=policy,
                           sched_policy="priority", **SERVE)
        want = {r.rid: _oneshot(eng, r) for r in _trace(Request, cfg, 9)}
        for interleaved in (False, True):
            res = _drive(Scheduler(eng, n_lanes=2, interleaved=interleaved),
                         _trace(Request, cfg, 9))
            assert {rid: rs.tokens for rid, rs in res.items()} == want


@pytest.mark.parametrize("arch", CROSS)
def test_spec_decoding_matches_plain(arch):
    """spec_k 2 gives the ids of spec_k 0, phased and interleaved."""
    _, _, _, cfg, model = _models(arch)
    for interleaved in (False, True):
        ids = []
        for k in (0, 2):
            eng = build_engine(cfg, model, device="cpu", spec_k=k,
                               sched_policy="priority", **SERVE)
            sched = Scheduler(eng, n_lanes=2, interleaved=interleaved)
            res = _drive(sched, _trace(Request, cfg, 11))
            ids.append({rid: rs.tokens for rid, rs in res.items()})
            assert (sched.n_verify_rounds > 0) == (k > 0)
        assert ids[0] == ids[1]


@pytest.mark.parametrize("arch", CROSS)
def test_reset_and_scrub_of_a_cross_lane(arch):
    """Reset sets the lane's mem_len to 0 (its decode reads zero memory)
    and scrub zeroes its slab; the neighbour lanes stay bit-identical."""
    _, _, _, cfg, model = _models(arch)
    eng = build_engine(cfg, model, device="cpu", **SERVE)
    _, S, _ = _mem_spec(cfg)
    state, _ = eng.prefill(_tokens(cfg, 3, 20, 2), chunked=True,
                           extra_inputs=_memory(cfg, 3, 3, [S, 5, S - 1]))
    before = T.extract_lanes(state, [0, 2])
    mask = torch.tensor([False, True, False])
    T.reset_lanes(state, mask)
    cross = [st for st in state["layers"] if "xk" in st]
    assert cross and all(int(st["mem_len"][1]) == 0 for st in cross)
    assert all(st["xk"][1].abs().sum() > 0 for st in cross)
    from repro_torch.models.blocks import _cross_attn_decode
    blk = next(b for b in model.layers if b.kind == "cross")
    xo = _cross_attn_decode(blk.xattn, cfg, torch.randn(3, cfg.d_model),
                            cross[0], state["t"])
    assert not xo[1].any() and xo[0].any()
    T.scrub_lanes(state, mask)
    assert all(not st["xk"][1].any() and not st["xv"][1].any()
               for st in cross)
    after = T.extract_lanes(state, [0, 2])
    for a, b in zip(before["layers"], after["layers"]):
        for k in a:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("arch", CROSS)
def test_submit_rejects_bad_memory(arch):
    """A request without memory, under another key, of the wrong
    feature width, not 2-D or longer than the family's S is REJECTED at
    submit with a reason; a whole one is served."""
    _, _, _, cfg, model = _models(arch)
    key, S, feat = _mem_spec(cfg)
    sched = Scheduler(build_engine(cfg, model, device="cpu", **SERVE),
                      n_lanes=2)
    prompt = np.arange(5, dtype=np.int32)
    bad = [None, {key: np.zeros((3, feat + 1), np.float32)},
           {key: np.zeros((S + 1, feat), np.float32)},
           {"other": np.zeros((3, feat), np.float32)}]
    for i, extra in enumerate(bad):
        rs = sched.submit(Request(rid=i, prompt=prompt, max_new=2,
                                  extra_inputs=extra))
        assert rs.status is Status.REJECTED and rs.reason, extra
    rs = sched.submit(Request(rid=9, prompt=prompt, max_new=2,
                              extra_inputs={key: np.zeros((feat,),
                                                          np.float32)}))
    assert rs.status is Status.REJECTED
    good = sched.submit(Request(rid=10, prompt=prompt, max_new=2,
                                extra_inputs={key: np.ones((S, feat),
                                                           np.float32)}))
    assert good.status is Status.QUEUED
    assert sched.run()[10].status is Status.DONE


@pytest.mark.parametrize("arch", CROSS)
def test_prefix_cache_is_bypassed(arch):
    """With a prefix-cache budget a cross family's scheduler never probes
    or fills the trie, and its ids are those without it."""
    _, _, _, cfg, model = _models(arch)
    res = []
    for nbytes in (0, 1 << 24):
        eng = build_engine(cfg, model, device="cpu", prefix_cache_bytes=nbytes,
                           sched_policy="priority", **SERVE)
        sched = Scheduler(eng, n_lanes=2)
        res.append({rid: rs.tokens for rid, rs in
                    _drive(sched, _trace(Request, cfg, 12)).items()})
        assert sched._pc is None
        assert sched.n_prefix_hits == sched.n_prefix_misses == 0
        if nbytes:
            assert eng.prefix_cache.stats()["entries"] == 0
    assert res[0] == res[1]


@pytest.mark.parametrize("arch", CROSS)
def test_row_bytes_match_jax(arch):
    """A cross lane's snapshot row (the store's and the prefix cache's
    unit) has the bytes of the JAX package's row, whatever the slab's
    axis order; from shapes alone (jax.eval_shape)."""
    cfg_j, _, _, cfg, _ = _models(arch)
    for dtype in ("float32", "bfloat16"):
        shapes = jax.eval_shape(lambda: JT.init_decode_state(
            dataclasses.replace(cfg_j, dtype=dtype), 1, SERVE["budget"]))
        want = sum(int(np.prod(a.shape)) * a.dtype.itemsize
                   for a in jax.tree.leaves(shapes))
        row = host_row_template(dataclasses.replace(cfg, dtype=dtype),
                                SERVE["budget"])
        assert state_row_bytes(row) == want


# ------------------------------------------------ the D-128 dense configs


@pytest.mark.parametrize("arch", DENSE)
def test_dense_config_matches_jax(arch):
    """One-shot chunked generate on each smoke config (qkv biases drawn
    non-zero where the config has them): ids equal to the JAX
    engine's."""
    je, te = _engines(arch)
    tokens = _tokens(te.cfg, 2, 45, 4)
    want = je.generate(tokens, 8, chunked=True)["ids"]
    np.testing.assert_array_equal(te.generate(tokens, 8, chunked=True)["ids"],
                                  want)
    if te.cfg.qkv_bias:
        assert te.model.layers[0].attn.wq.bias.abs().sum() > 0
