"""The port's hybrid family (recurrentgemma-2b: RG-LRU recurrent blocks
with one local-attention layer in three) against the JAX package's, on
its smoke config (3 layers: recurrent, recurrent, local; window 16;
float32), and gemma3-12b's smoke config (a local layer of window 16 and
a global one at budget 32, so the layers' M differ).

Weights: the trees of the JAX package's init_params / init_gate_params
(their shapes, from jax.eval_shape), drawn with numpy by each leaf's
init law (_LAWS: tests/_jax_weights.py has no law for the hybrid
leaves), moved to the port through repro_torch.bridge; every recurrent
block's conv_b is drawn from N(0, 0.1) (0 at init, where the conv bias
path would hold nothing) and gate biases from U(2, 8), so eviction is
decided by the scores. Inputs
come from numpy seeds. The JAX side runs its XLA path (an
associative_scan for the RG-LRU, the plain reference of its Pallas
kernels); the port its plain PyTorch versions (a sequential scan).

Tolerances: the sequential scan rounds differently from the
associative one, and a GEMM on the CPU sums in another order than
XLA's, so recurrences h, conv states (pre-conv projections), hidden
states and logits are held within 1e-5 (absolute and relative;
float32); greedy ids, slot positions (so victims), statuses, stats()
and dispatch counts exactly.

Cost: one JAX engine per serve config, shared by the cases that use
it; the JAX scheduler runs in the scheduler cases only.
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
from repro.core.policies import make_policy as jax_make_policy
from repro.models import blocks as JB
from repro.models import transformer as JT
from repro.serve import Request as JRequest
from repro.serve import Scheduler as JScheduler
from repro.serve.engine import build_engine as jax_build_engine
from repro.serve.prefix_cache import PrefixCache as JPrefixCache
from repro_torch import bridge
from repro_torch.configs import ServeConfig, get_config, get_smoke_config
from repro_torch.core.policies import make_policy
from repro_torch.kernels import ops, rg_lru
from repro_torch.models import blocks
from repro_torch.models import transformer as T
from repro_torch.serve.engine import build_engine
from repro_torch.serve.graphs import host_row_template
from repro_torch.serve.prefix_cache import state_row_bytes
from repro_torch.serve.request import Request, Status
from repro_torch.serve.scheduler import Scheduler

HYBRID = "recurrentgemma-2b"
GEMMA3 = "gemma3-12b"
TOL = dict(atol=1e-5, rtol=1e-5)
SERVE = dict(budget=8, prefill_chunk=8, decode_segment=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread (a pool of eight waits ~10 ms
    per op for its threads while XLA's own pool is live)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lam(shape, rng):
    """The JAX init's lru_lam: a = exp(-8 softplus(lam)) over (0.9,
    0.999), from its own fixed numpy seed."""
    return np.log(np.expm1(-np.log(np.random.RandomState(0).uniform(
        0.9, 0.999, size=shape)) / blocks.RG_LRU_C))


# each leaf's law, by the last keys of its path: the JAX init's, except
# the biases (gate biases U(2, 8), conv biases N(0, 0.1))
_LAWS = {
    ("embed",): lambda s, rng: 0.02 * rng.randn(*s),
    ("scale",): lambda s, rng: np.ones(s),
    ("w2", "w"): lambda s, rng: 0.02 * rng.randn(*s),
    ("w",): lambda s, rng: rng.randn(*s) / np.sqrt(s[-2]),
    ("b",): lambda s, rng: rng.uniform(2.0, 8.0, s),
    ("conv_w",): lambda s, rng: 0.1 * rng.randn(*s),
    ("conv_b",): lambda s, rng: 0.1 * rng.randn(*s),
    ("lru_lam",): _lam,
}


def _draw(init, cfg_j, rng):
    """The numpy tree of init(key, cfg_j), each leaf drawn by _LAWS."""
    shapes = jax.eval_shape(lambda k: init(k, cfg_j), jax.random.PRNGKey(0))

    def leaf(path, sd):
        keys = [k.key for k in path if isinstance(getattr(k, "key", None),
                                                   str)]
        law = _LAWS.get(tuple(keys[-2:])) or _LAWS[tuple(keys[-1:])]
        return np.asarray(law(sd.shape, rng), sd.dtype)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@functools.lru_cache(maxsize=None)
def _models(arch):
    """(JAX cfg, params, gates, port cfg, port model): one set of
    weights."""
    cfg_j, cfg = jax_smoke_config(arch), get_smoke_config(arch)
    rng = np.random.RandomState(17)
    params = _draw(JT.init_params, cfg_j, rng)
    gates = _draw(JT.init_gate_params, cfg_j, rng)
    model = bridge.params_from_jax(params, cfg, device="cpu")
    bridge.gates_from_jax(gates, cfg, model)
    return (cfg_j, jax.tree.map(jnp.asarray, params),
            jax.tree.map(jnp.asarray, gates), cfg, model)


def _serve(**kw):
    return tuple(sorted({**SERVE, **kw}.items()))


# the serve fields that only the host-side scheduler reads: cases that
# differ in nothing else share one JAX engine (and its compiled closures)
HOST_FIELDS = ("sched_policy", "swap_preempt", "prefix_cache_bytes",
               "prefix_min_tokens")


@functools.lru_cache(maxsize=None)
def _jax_engine_cached(arch, serve):
    cfg_j, params, gates, _, _ = _models(arch)
    return jax_build_engine(cfg_j, params, gates, **dict(serve))


def _jax_engine(arch, serve):
    """The JAX engine of (arch, serve fields), one per set of fields its
    closures read; the host-side fields are swapped in over its serve
    config (a prefix_cache_bytes there gives it a new, cold trie)."""
    kw = dict(serve)
    host = {k: kw.pop(k) for k in HOST_FIELDS if k in kw}
    je = _jax_engine_cached(arch, tuple(sorted(kw.items())))
    je.serve = JServeConfig(**kw, **host)
    je.prefix_cache = (JPrefixCache(host["prefix_cache_bytes"])
                       if host.get("prefix_cache_bytes") else None)
    je.dispatch_count = 0
    return je


def _tokens(cfg, B, L, seed):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (B, L)).astype(np.int32)


def _layers(state, cfg):
    """Per-layer numpy dicts of a JAX decode state or the port's."""
    if isinstance(state["t"], torch.Tensor):
        state = bridge.state_to_numpy(state, cfg)
    return bridge._per_layer(jax.device_get(state), cfg)


def _assert_states(got, want, cfg):
    """Slot positions exact, recurrences within TOL, conv states within
    TOL (a conv input is a projection of a hidden state)."""
    for g, w in zip(_layers(got, cfg), _layers(want, cfg)):
        assert g.keys() == w.keys()
        if "pos" in g:
            np.testing.assert_array_equal(g["pos"], w["pos"])
        else:
            np.testing.assert_allclose(g["h"], w["h"], **TOL)
            np.testing.assert_allclose(g["conv"], w["conv"], **TOL)


# ------------------------------------------------------------ the scan


@pytest.mark.parametrize("T_,tails", [(1, None), (37, None),
                                      (37, [37, 20, 1, 0])])
def test_rg_lru_scan_matches_jax(T_, tails):
    """The plain sequential scan against _rg_lru_scan (an associative
    scan) from h0 != 0, within 1e-5; ragged identity tails (a_log 0,
    bx 0) carry h unchanged, bit for bit."""
    rng = np.random.RandomState(T_)
    B, W = 4, 24
    a_log = (-8.0 * rng.rand(B, T_, W) * 0.05).astype(np.float32)
    bx = rng.randn(B, T_, W).astype(np.float32)
    if tails is not None:
        pad = np.arange(T_)[None, :, None] >= np.array(tails)[:, None, None]
        a_log[np.broadcast_to(pad, a_log.shape)] = 0.0
        bx[np.broadcast_to(pad, bx.shape)] = 0.0
    h0 = rng.randn(B, W).astype(np.float32)
    want = np.asarray(jax.jit(JB._rg_lru_scan)(
        jnp.asarray(a_log), jnp.asarray(bx), jnp.asarray(h0)))
    got = ops.rg_lru_scan(torch.as_tensor(a_log), torch.as_tensor(bx),
                          torch.as_tensor(h0)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    if tails is not None:
        for b, n in enumerate(tails):
            np.testing.assert_array_equal(
                got[b, -1], got[b, n - 1] if n else h0[b])


def _plan_hits(T, W):
    """How often the kernel, as scan_plan launches it for one lane,
    writes each (step, channel): CTA x, thread s * cw + c takes channel
    x * cw + c (if < W) and, in each tile of n_sub * chunk steps, steps
    s * chunk .. (s + 1) * chunk - 1 of it (if < T)."""
    chunk, cw, n_sub, (gx, gy) = rg_lru.scan_plan(1, T, W)
    assert gy == 1 and (n_sub * cw) % 32 == 0
    assert n_sub == rg_lru.SUBS or T <= n_sub * chunk
    t = (np.arange(0, T, n_sub * chunk)[:, None, None]
         + np.arange(n_sub)[:, None] * chunk + np.arange(chunk)).reshape(-1)
    t = t[t < T]
    idx = []
    for x in range(gx):
        w = x * cw + np.arange(cw)
        idx.append((t[:, None] * W + w[w < W]).reshape(-1))
    return np.bincount(np.concatenate(idx), minlength=T * W)


@pytest.mark.parametrize("W", [2560, 24])
def test_rg_lru_scan_plan_covers_every_step_once(W):
    """scan_plan's grid and threads cover every (lane, step, channel)
    exactly once, for T about a chunk (L), a tile, a verify round and a
    long prompt; at W 2560 the grid reaches two CTAs an SM for B 1 to 8
    (the channel tile narrows to 8 at B 1, 16 at B 2)."""
    L, tile = rg_lru.CHUNK, rg_lru.SUBS * rg_lru.CHUNK
    for T in (1, 3, L - 1, L, L + 1, tile - 1, tile, tile + 1, 4096):
        hits = _plan_hits(T, W)
        assert hits.shape == (T * W,) and (hits == 1).all(), T
    if W == 2560:
        for B, cw in ((1, 8), (2, 16), (4, 32), (8, 32)):
            assert rg_lru.scan_plan(B, 4096, W)[1] == cw
            assert rg_lru.scan_plan(B, 4096, W)[3][0] * B >= \
                rg_lru.TARGET_CTAS


def _fma(x, y, z):
    """float32 fma: the product of two float32 is exact in float64."""
    return (x.astype(np.float64) * y + z).astype(np.float32)


def _chunked_scan(a_log, bx, h0):
    """The kernel's composition order in numpy float32: gates as the
    plain version makes them; per tile of SUBS chunks of CHUNK steps,
    each chunk's running map (A_u, B_u) from its first step, then the
    chunk maps walked in order from the carry, h_u = fma(A_u, c, B_u)."""
    a, g = (x.numpy() for x in rg_lru.rg_lru_gates(torch.as_tensor(a_log),
                                                    torch.as_tensor(bx)))
    B, T, W = a.shape
    L, S = rg_lru.CHUNK, rg_lru.SUBS
    n = -(-T // (S * L)) * S * L
    a = np.concatenate([a, np.ones((B, n - T, W), np.float32)], 1)
    g = np.concatenate([g, np.zeros((B, n - T, W), np.float32)], 1)
    h, out = h0.copy(), np.empty((B, n, W), np.float32)
    for t0 in range(0, n, S * L):
        at = a[:, t0:t0 + S * L].reshape(B, S, L, W)
        A = at.copy()
        Bc = g[:, t0:t0 + S * L].reshape(B, S, L, W).copy()
        for u in range(1, L):
            A[:, :, u] = A[:, :, u - 1] * at[:, :, u]
            Bc[:, :, u] = _fma(at[:, :, u], Bc[:, :, u - 1], Bc[:, :, u])
        cin = np.empty((B, S, 1, W), np.float32)
        for k in range(S):
            cin[:, k, 0] = h
            h = _fma(A[:, k, -1], h, Bc[:, k, -1])
        out[:, t0:t0 + S * L] = _fma(A, cin, Bc).reshape(B, S * L, W)
    return out[:, :T]


@pytest.mark.parametrize("T_,tails", [(129, None),
                                      (600, [600, 300, 129, 128, 17, 0])])
def test_rg_lru_chunked_order_matches_plain_and_jax(T_, tails):
    """The kernel's chunked composition order, emulated in numpy
    float32, against the plain sequential scan and _rg_lru_scan (an
    associative scan) within 1e-5, from h0 != 0; with ragged identity
    tails that end inside a chunk, on a chunk's and a tile's edge and
    before the first step, every lane ends on the bits of its last real
    step (h0 with none)."""
    rng = np.random.RandomState(T_)
    B, W = (len(tails) if tails else 2), 40
    a_log = (-8.0 * rng.rand(B, T_, W) * 0.05).astype(np.float32)
    bx = rng.randn(B, T_, W).astype(np.float32)
    if tails is not None:
        pad = np.arange(T_)[None, :, None] >= np.array(tails)[:, None, None]
        a_log[np.broadcast_to(pad, a_log.shape)] = 0.0
        bx[np.broadcast_to(pad, bx.shape)] = 0.0
    h0 = rng.randn(B, W).astype(np.float32)
    got = _chunked_scan(a_log, bx, h0)
    plain = rg_lru.rg_lru_scan_torch(torch.as_tensor(a_log),
                                     torch.as_tensor(bx),
                                     torch.as_tensor(h0)).numpy()
    want = np.asarray(jax.jit(JB._rg_lru_scan)(
        jnp.asarray(a_log), jnp.asarray(bx), jnp.asarray(h0)))
    np.testing.assert_allclose(got, plain, **TOL)
    np.testing.assert_allclose(got, want, **TOL)
    if tails is not None:
        for b, n in enumerate(tails):
            np.testing.assert_array_equal(
                got[b, -1].view(np.int32),
                (got[b, n - 1] if n else h0[b]).view(np.int32))


# ------------------------------------------------------------ the block


def _recurrent_state(cfg, B, rng):
    """A recurrent layer state with h and conv drawn N(0, 1)."""
    return {"h": rng.randn(B, cfg.lru_width).astype(np.float32),
            "conv": rng.randn(B, cfg.conv_width - 1,
                              cfg.lru_width).astype(np.float32)}


BLOCK_CASES = {  # mode, B, T, n_valid
    "decode": ("decode", 3, 1, None),
    "prefill T 9": ("prefill", 3, 9, None),
    "prefill T 2 (< conv_width - 1)": ("prefill", 3, 2, None),
    "chunk, all valid": ("chunk", 3, 8, None),
    "chunk, ragged [8, 2, 0]": ("chunk", 3, 8, [8, 2, 0]),
    "decode, lane 1 inactive": ("decode", 3, 1, [1, 0, 1]),
}


@functools.lru_cache(maxsize=None)
def _jax_block(mode):
    """The JAX package's recurrent block in one mode ("decode",
    "prefill", "chunk") under TRIM-KV, jitted (one compile a shape, where
    an eager call compiles each of its operations)."""
    cfg_j = _models(HYBRID)[0]
    pol = jax_make_policy(JServeConfig())
    if mode == "decode":
        return jax.jit(lambda p, x, st, t, active: JB.apply_block_decode(
            p, None, cfg_j, "recurrent", x, st, t, policy=pol,
            active=active))
    if mode == "prefill":
        return jax.jit(lambda p, x, st: JB.apply_block_prefill(
            p, None, cfg_j, "recurrent", x, st, policy=pol, budget=8))
    return jax.jit(lambda p, x, st, t, nv: JB.apply_block_prefill_chunk(
        p, None, cfg_j, "recurrent", x, st, t, policy=pol, n_valid=nv))


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_recurrent_block_matches_jax(case):
    """One recurrent block in each mode against the JAX block: x_out,
    h and conv within TOL. Decode from a drawn state (with an inactive lane
    frozen bit-identically), single-shot prefill from a fresh state
    (including a prompt shorter than conv_width - 1, whose conv tail is
    left-padded) and chunks from a drawn state with a ragged n_valid (a
    row with 0 keeps its state)."""
    mode, B, T_, nv = BLOCK_CASES[case]
    _, params, _, cfg, model = _models(HYBRID)
    p = jax.tree.map(np.asarray,
                     bridge._per_layer(jax.device_get(params), cfg)[1])
    block = model.layers[1]
    assert block.kind == "recurrent"
    rng = np.random.RandomState(len(case))
    x = rng.randn(B, T_, cfg.d_model).astype(np.float32)
    st = (_recurrent_state(cfg, B, rng) if mode != "prefill" else
          {"h": np.zeros((B, cfg.lru_width), np.float32),
           "conv": np.zeros((B, cfg.conv_width - 1, cfg.lru_width),
                            np.float32)})
    jst = {k: jnp.asarray(v) for k, v in st.items()}
    tst = {k: torch.as_tensor(v.copy()) for k, v in st.items()}
    pol = make_policy(ServeConfig())
    t = jnp.full((B,), 5, jnp.int32)
    with torch.no_grad():
        if mode == "decode":
            active = None if nv is None else np.array(nv, bool)
            want_x, want_st, _ = _jax_block("decode")(
                p, jnp.asarray(x[:, 0]), jst, t,
                None if active is None else jnp.asarray(active))
            got_x, got_st, _ = blocks.apply_block_decode(
                block, cfg, torch.as_tensor(x[:, 0]), tst,
                torch.as_tensor(np.array(t)), policy=pol,
                active=None if active is None else torch.as_tensor(active))
            assert got_st is tst       # written in place
        elif mode == "prefill":
            want_x, want_st, _ = _jax_block("prefill")(p, jnp.asarray(x),
                                                      jst)
            got_x, got_st, _ = blocks.apply_block_prefill(
                block, cfg, torch.as_tensor(x), tst, policy=pol, budget=8)
        else:
            jnv = None if nv is None else jnp.asarray(nv, jnp.int32)
            want_x, want_st, _ = _jax_block("chunk")(p, jnp.asarray(x),
                                                    jst, t, jnv)
            got_x, got_st, _ = blocks.apply_block_prefill_chunk(
                block, cfg, torch.as_tensor(x), tst,
                torch.as_tensor(np.array(t)), policy=pol,
                n_valid=None if nv is None else torch.as_tensor(
                    np.array(nv, np.int32)))
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), **TOL)
    np.testing.assert_allclose(got_st["h"].numpy(),
                               np.asarray(want_st["h"]), **TOL)
    np.testing.assert_allclose(got_st["conv"].numpy(),
                               np.asarray(want_st["conv"]), **TOL)
    if nv is not None:           # frozen rows keep their state exactly
        for b in np.flatnonzero(np.array(nv) == 0):
            for k in ("h", "conv"):
                np.testing.assert_array_equal(got_st[k][b].numpy(), st[k][b])


# ------------------------------------------------------- one-shot runs


ONESHOT = [(chunked, policy, budget) for policy in ("trimkv", "h2o")
           for budget in (8, 32) for chunked in (False, True)]


@pytest.mark.parametrize("case", ONESHOT, ids=lambda c: "-".join(map(str, c)))
def test_generate_matches_jax(case):
    """A batch of 3 prompts of 45 tokens (past the window of 16), budget
    8 (local M 8) and 32 (local M 16, the window): the last hidden state
    within TOL and every layer's state after prefill (slot positions
    exact, h within TOL), then 5 decode steps from the JAX engine's
    state and the port's (logits within TOL, states after each), and
    Engine.generate's ids, fused and eager, equal to the JAX engine's
    prefill and decode steps' greedy tokens."""
    chunked, policy, budget = case
    cfg_j, _, _, cfg, model = _models(HYBRID)
    serve = _serve(policy=policy, budget=budget, prefill_chunk=16)
    je = _jax_engine(HYBRID, serve)
    te = build_engine(cfg, model, device="cpu", **dict(serve))
    tokens = _tokens(cfg, 3, 45, 6)
    js, jh = je.prefill(tokens, chunked=chunked)
    ts, th = te.prefill(tokens, chunked=chunked)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    _assert_states(ts, js, cfg)
    tok = np.array(je._first_token(jh))
    ids = [tok]
    for _ in range(5):
        js, jl = je._decode(js, jnp.asarray(tok))
        ts, tl = T.decode_step(model, cfg, ts, torch.as_tensor(tok),
                               te.policy)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _assert_states(ts, js, cfg)
        tok = np.array(jnp.argmax(jl, axis=-1), np.int32)
        ids.append(tok)
    want = np.stack(ids, axis=1)
    for fused in (True, False):
        got = te.generate(tokens, 6, chunked=chunked, fused=fused)["ids"]
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ scheduler


def _trace(cls, cfg, seed=3):
    """4 requests, each a 24-token shared prefix and its own turn (25 to
    40 tokens, past the window of 16): three priority-0 prompts and a
    priority-3 one that arrives after the first step. One trace for
    every scheduler case, so the JAX engines' compiled shapes serve them
    all."""
    rng = np.random.RandomState(seed)
    prefix = rng.randint(0, cfg.vocab_size, 24)
    return [cls(rid=i, prompt=np.concatenate(
                    [prefix, rng.randint(0, cfg.vocab_size, L)]).astype(
                    np.int32), max_new=m, seed=i, priority=pr)
            for i, (L, m, pr) in enumerate([(6, 12, 0), (1, 10, 0),
                                            (11, 9, 0), (16, 5, 3)])]


def _drive(sched, reqs, park=False):
    """Three lanes busy when the better-ranked request arrives; with
    ``park`` request 0 is parked after the first step and revived one
    step later."""
    for r in reqs[:3]:
        sched.submit(r)
    sched.step()
    if park:
        sched.park(0)
        sched.step()
        sched.revive(0)
    sched.submit(reqs[3])
    return sched.run()


PRIORITY = dict(sched_policy="priority")
PREFIX = dict(prefix_cache_bytes=1 << 22, prefix_min_tokens=8)
SCHED = {  # serve fields, interleaved, park
    "swap, phased": (PRIORITY, False, False),
    "swap, interleaved": (PRIORITY, True, False),
    "swap, phased, h2o": (dict(PRIORITY, policy="h2o"), False, False),
    "recompute": (dict(PRIORITY, swap_preempt=False), False, False),
    "spec_k 2, phased": (dict(PRIORITY, spec_k=2), False, False),
    "spec_k 2, interleaved": (dict(PRIORITY, spec_k=2), True, False),
    "prefix cache, phased": (PREFIX, False, False),
    "prefix cache, interleaved": (PREFIX, True, False),
    "park / revive": ({}, False, True),
}


@functools.lru_cache(maxsize=None)
def _port_run(serve, interleaved, park):
    """The port scheduler on the trace: (results, stats, dispatch count,
    the scheduler); cached, so a spec_k 0 run serves the spec cases."""
    _, _, _, cfg, model = _models(HYBRID)
    te = build_engine(cfg, model, device="cpu", **dict(serve))
    ts = Scheduler(te, n_lanes=3, interleaved=interleaved)
    res = _drive(ts, _trace(Request, cfg), park)
    return res, ts.stats(), te.dispatch_count, ts


@pytest.mark.parametrize("case", list(SCHED))
def test_scheduler_matches_jax(case):
    """The port's Scheduler against the JAX Scheduler (3 lanes): ids,
    statuses, stats() and dispatch_count equal under swap and recompute
    preemption (a swap and a resume where phased), under H2O, spec_k 2
    (whose ids also equal spec_k 0's), the prefix cache (a hit) and
    park / revive, phased and interleaved."""
    kw, interleaved, park = SCHED[case]
    _, _, _, cfg, _ = _models(HYBRID)
    je = _jax_engine(HYBRID, _serve(**kw))
    js = JScheduler(je, n_lanes=3, interleaved=interleaved)
    want = _drive(js, _trace(JRequest, cfg), park)
    got, stats, dispatches, ts = _port_run(_serve(**kw), interleaved, park)
    for rid, rs in want.items():
        assert got[rid].status.value == rs.status.value == "done", rid
        assert got[rid].tokens == rs.tokens, rid
    assert stats == {k: js.stats()[k] for k in stats}
    assert dispatches == je.dispatch_count
    if kw.get("spec_k"):
        plain = _port_run(_serve(**{**kw, "spec_k": 0}), interleaved,
                          park)[0]
        assert all(got[r].tokens == plain[r].tokens for r in got)
        assert stats["n_verify_rounds"] > 0
    if kw is PREFIX:
        assert ts.n_prefix_hits >= 1
    if kw.get("sched_policy") == "priority":
        assert ts.n_preempted >= 1
        if kw.get("swap_preempt", True) and not interleaved:
            assert ts.n_swaps >= 1 and ts.n_resumes >= 1


# ------------------------------------------------------------ lane ops


def test_reset_and_scrub_of_a_hybrid_lane():
    """reset_lanes and scrub_lanes zero a recurrent layer's h and conv
    in the masked lanes, as the JAX package's fills do, and leave the
    other lanes bit-identical; a NaN planted in h is gone after a
    scrub."""
    _, _, _, cfg, model = _models(HYBRID)
    te = build_engine(cfg, model, device="cpu", **SERVE)
    state, _ = te.prefill(_tokens(cfg, 3, 20, 2), chunked=True)
    rec = [st for st in state["layers"] if "h" in st]
    assert rec and all(st["h"].abs().sum() > 0 for st in rec)
    rec[0]["h"][1, 3] = float("nan")
    before = [{k: v.clone() for k, v in st.items()} for st in rec]
    mask = torch.tensor([False, True, False])
    for op in (T.reset_lanes, T.scrub_lanes):
        op(state, mask)
        for st, old in zip(rec, before):
            for k in blocks.RECURRENT_LEAVES:
                assert (st[k][1] == 0).all()
                assert torch.equal(st[k][~mask], old[k][~mask])
    assert int(state["t"][1]) == 0


def test_quarantined_lane_leaks_no_nan():
    """A NaN planted in a decoding lane's h makes its logits
    non-finite: the scheduler quarantines the lane (scrub: h and conv
    zeroed), replays the request, and both it and the next request on
    that lane give the ids of a clean run."""
    _, _, _, cfg, model = _models(HYBRID)
    reqs = _trace(Request, cfg)[:2]
    clean = Scheduler(build_engine(cfg, model, device="cpu", **SERVE),
                      n_lanes=1).run(_trace(Request, cfg)[:2])
    sched = Scheduler(build_engine(cfg, model, device="cpu", **SERVE),
                      n_lanes=1)
    for r in reqs:
        sched.submit(r)
    sched.step()
    for st in sched.lanes.state["layers"]:
        if "h" in st:
            st["h"][0] = float("nan")
    res = sched.run()
    assert sched.n_quarantined == 1
    for r in reqs:
        assert res[r.rid].status is Status.DONE
        assert res[r.rid].tokens == clean[r.rid].tokens
    for st in sched.lanes.state["layers"]:
        if "h" in st:
            assert torch.isfinite(st["h"]).all()


# ------------------------------------------------------- the bridge etc.


def test_bridge_round_trip_and_row_bytes():
    """Params and gates through the bridge and back give the JAX trees
    (a recurrent layer has no gate: its gates subtree is None); the
    port's decode state in the JAX layout has the JAX state's leaves;
    a lane's snapshot row has the JAX row's bytes (h float32 in a bf16
    model too)."""
    cfg_j, params, gates, cfg, model = _models(HYBRID)
    got = bridge.gates_to_jax(model, cfg)
    want = jax.device_get(gates)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g, w)
    p = bridge._per_layer(jax.device_get(params), cfg)
    for block, pl in zip(model.layers, p):
        if block.kind == "recurrent":
            np.testing.assert_array_equal(block.conv_w.numpy(),
                                          pl["conv_w"])
            np.testing.assert_array_equal(block.lru_lam.numpy(),
                                          pl["lru_lam"])
            np.testing.assert_array_equal(block.in_x.weight.numpy().T,
                                          pl["in_x"]["w"])
    state = T.init_decode_state(cfg, 2, 8, "cpu")
    jstate = jax.eval_shape(lambda: JT.init_decode_state(cfg_j, 2, 8))
    assert (jax.tree.structure(bridge.state_to_numpy(state, cfg))
            == jax.tree.structure(jstate))
    for dtype in ("float32", "bfloat16"):
        shapes = jax.eval_shape(lambda: JT.init_decode_state(
            dataclasses.replace(cfg_j, dtype=dtype), 1, 8))
        want = sum(int(np.prod(a.shape)) * a.dtype.itemsize
                   for a in jax.tree.leaves(shapes))
        row = host_row_template(dataclasses.replace(cfg, dtype=dtype), 8)
        assert state_row_bytes(row) == want
        assert row["layers"][0]["h"].dtype == np.float32


def test_configs_and_refusals():
    """Both configs load at full width (26 layers: 18 recurrent, 8
    local; gemma3 head dim 256); the port's layer kinds are the JAX
    package's; training a hybrid model raises NotImplementedError naming
    its queue item."""
    cfg = get_config(HYBRID)
    kinds = cfg.layer_kinds()
    assert (len(kinds), kinds.count("recurrent"), kinds.count("local")) \
        == (26, 18, 8)
    assert kinds[-2:] == ("recurrent", "recurrent")
    assert get_config(GEMMA3).head_dim == 256
    assert T.num_gate_layers(cfg) == 8
    _, _, _, scfg, model = _models(HYBRID)
    tokens = torch.as_tensor(_tokens(scfg, 1, 16, 1))
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        T.forward_train(model, scfg, tokens)
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        blocks.apply_block_train(model.layers[0], scfg,
                                 torch.zeros(1, 4, scfg.d_model))


# ----------------------------------------------------------- gemma3-12b


@pytest.mark.parametrize("chunked", [False, True])
def test_gemma3_matches_jax(chunked):
    """gemma3's smoke config at budget 32 (local layer M 16, global M
    32): the layers' M differ, and one-shot ids and slot positions
    equal the JAX engine's; then the port's scheduler (3 lanes, swap)
    against the JAX scheduler: ids and dispatches equal."""
    _, _, _, cfg, model = _models(GEMMA3)
    serve = _serve(budget=32, prefill_chunk=16)
    je = _jax_engine(GEMMA3, serve)
    te = build_engine(cfg, model, device="cpu", **dict(serve))
    tokens = _tokens(cfg, 3, 45, 9)
    js, _ = je.prefill(tokens, chunked=chunked)
    ts, _ = te.prefill(tokens, chunked=chunked)
    assert [st["pos"].shape[-1] for st in ts["layers"]] == [16, 32]
    _assert_states(ts, js, cfg)
    want = je.generate(tokens, 6, chunked=chunked)["ids"]
    np.testing.assert_array_equal(
        te.generate(tokens, 6, chunked=chunked)["ids"], want)
    if chunked:
        je.dispatch_count = te.dispatch_count = 0
        jw = _drive(JScheduler(je, n_lanes=3), _trace(JRequest, cfg))
        got = _drive(Scheduler(te, n_lanes=3), _trace(Request, cfg))
        assert all(got[r].tokens == jw[r].tokens for r in jw)
        assert te.dispatch_count == je.dispatch_count
