"""The port's ssm family (falcon-mamba-7b: Mamba-1 blocks, no attention,
no retention gates) against the JAX package's, on its smoke config (2
layers, d 128, d_inner 256, ssm_state 8, dt_rank 8, float32).

Weights: the trees of the JAX package's init_params / init_gate_params
(their shapes, from jax.eval_shape; the gate tree holds no gate), drawn
with numpy by each leaf's init law (_LAWS), moved to the port through
repro_torch.bridge. conv_b, the dt_proj bias and D are drawn away from
their init values (0, 0 and 1), where their paths would hold nothing.
Inputs come from numpy seeds. The JAX side runs its XLA path (a
lax.scan over time); the port its plain PyTorch versions (the same
loop, kernels/selective_scan.py).

Tolerances: a GEMM and the sum over the state axis on the CPU add in
another order than XLA's, so recurrences h, conv states (pre-conv
projections), hidden states and logits are held within 1e-5 (absolute
and relative; float32); greedy ids, statuses, stats() and dispatch
counts exactly.

Cost: one JAX engine per serve config that its closures read, shared by
the cases that use it (the scheduler fields are swapped in over it).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ServeConfig as JServeConfig
from repro.configs import get_config as jax_config
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
from repro_torch.kernels import ops, selective_scan
from repro_torch.models import blocks
from repro_torch.models import transformer as T
from repro_torch.serve.engine import build_engine
from repro_torch.serve.faults import poison_lanes
from repro_torch.serve.graphs import host_row_template
from repro_torch.serve.prefix_cache import state_row_bytes
from repro_torch.serve.request import Request, Status
from repro_torch.serve.scheduler import Scheduler

SSM = "falcon-mamba-7b"
TOL = dict(atol=1e-5, rtol=1e-5)
SERVE = dict(budget=8, prefill_chunk=16, decode_segment=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread (a pool of eight waits ~10 ms
    per op for its threads while XLA's own pool is live)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _a_log(shape, rng):
    """The JAX init's A_log: log(1 .. ssm_state) in every channel."""
    return np.log(np.tile(np.arange(1, shape[-1] + 1, dtype=np.float32),
                          shape[:-1] + (1,)))


# each leaf's law, by the last keys of its path: the JAX init's, except
# conv_b ~ N(0, 0.1), the dt_proj bias ~ U(-3, 0) and D ~ U(0.5, 1.5)
_LAWS = {
    ("embed",): lambda s, rng: 0.02 * rng.randn(*s),
    ("scale",): lambda s, rng: np.ones(s),
    ("w",): lambda s, rng: rng.randn(*s) / np.sqrt(s[-2]),
    ("b",): lambda s, rng: rng.uniform(-3.0, 0.0, s),
    ("conv_w",): lambda s, rng: 0.1 * rng.randn(*s),
    ("conv_b",): lambda s, rng: 0.1 * rng.randn(*s),
    ("A_log",): _a_log,
    ("D",): lambda s, rng: rng.uniform(0.5, 1.5, s),
}


def _draw(init, cfg_j, rng):
    """The numpy tree of init(key, cfg_j), each leaf drawn by _LAWS."""
    shapes = jax.eval_shape(lambda k: init(k, cfg_j), jax.random.PRNGKey(0))

    def leaf(path, sd):
        keys = [k.key for k in path if isinstance(getattr(k, "key", None),
                                                   str)]
        return np.asarray(_LAWS[tuple(keys[-1:])](sd.shape, rng), sd.dtype)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@functools.lru_cache(maxsize=None)
def _models():
    """(JAX cfg, params, gates, port cfg, port model): one set of
    weights."""
    cfg_j, cfg = jax_smoke_config(SSM), get_smoke_config(SSM)
    rng = np.random.RandomState(23)
    params = _draw(JT.init_params, cfg_j, rng)
    gates = _draw(JT.init_gate_params, cfg_j, rng)
    model = bridge.params_from_jax(params, cfg, device="cpu")
    bridge.gates_from_jax(gates, cfg, model)
    return (cfg_j, jax.tree.map(jnp.asarray, params),
            jax.tree.map(jnp.asarray, gates), cfg, model)


# the serve fields that only the host-side scheduler reads: cases that
# differ in nothing else share one JAX engine (and its compiled closures)
HOST_FIELDS = ("sched_policy", "swap_preempt", "prefix_cache_bytes",
               "prefix_min_tokens")


@functools.lru_cache(maxsize=None)
def _jax_engine_cached(serve):
    cfg_j, params, gates, _, _ = _models()
    return jax_build_engine(cfg_j, params, gates, **dict(serve))


def _jax_engine(**kw):
    """The JAX engine of SERVE with kw, one per set of fields its
    closures read; the host-side fields are swapped in over its serve
    config (a prefix_cache_bytes there gives it a new, cold trie)."""
    kw = {**SERVE, **kw}
    host = {k: kw.pop(k) for k in HOST_FIELDS if k in kw}
    je = _jax_engine_cached(tuple(sorted(kw.items())))
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
    """Every layer's h and conv within TOL."""
    for g, w in zip(_layers(got, cfg), _layers(want, cfg)):
        assert g.keys() == w.keys() == {"h", "conv"}
        np.testing.assert_allclose(g["h"], w["h"], **TOL)
        np.testing.assert_allclose(g["conv"], w["conv"], **TOL)


# ------------------------------------------------------------ the scan


def _scan_inputs(B, T_, di, n, seed):
    rng = np.random.RandomState(seed)
    dt = np.log1p(np.exp(rng.randn(B, T_, di) - 1.0)).astype(np.float32)
    xs, Bm, Cm = (rng.randn(*s).astype(np.float32)
                  for s in ((B, T_, di), (B, T_, n), (B, T_, n)))
    A = -np.exp(_a_log((di, n), rng) + 0.1 * rng.randn(di, n)).astype(
        np.float32)
    h0 = rng.randn(B, di, n).astype(np.float32)
    return dt, xs, Bm, Cm, A, h0


def _fma(x, y, z):
    """float32 fma: the product of two float32 is exact in float64."""
    return (np.float64(x) * y + z).astype(np.float32)


def _kernel_order_scan(dt, xs, Bm, Cm, A, h0, n_valid):
    """The CUDA kernel's order of operations in numpy float32 (its exp2
    is the SFU's, within 2 ulp of numpy's): per step
    h = fma(exp2(dt (A log2 e)), h, (dt x) B) on the real steps (held by a
    select on padded ones); y the fma chain over each thread's
    STATES_PER_THREAD states, then the threads' partial sums added by
    the xor shuffle (offsets TPC / 2 .. 1)."""
    B, T_, di = dt.shape
    n = A.shape[-1]
    spt = selective_scan.STATES_PER_THREAD
    a2 = A * np.float32(np.log2(np.e))
    h, ys = h0.copy(), np.empty((B, T_, di), np.float32)
    for t in range(T_):
        live = (t < n_valid)[:, None, None]
        dtx = (dt[:, t] * xs[:, t])[..., None]
        dA = np.exp2(dt[:, t, :, None] * a2)
        h = np.where(live, _fma(dA, h, (dtx * Bm[:, t, None, :]).astype(
            np.float32)), h)
        hc = h.reshape(B, di, n // spt, spt)
        c = Cm[:, t].reshape(B, 1, n // spt, spt)
        y = hc[..., 0] * c[..., 0]
        for s in range(1, spt):
            y = _fma(hc[..., s], c[..., s], y)
        o = n // spt // 2
        while o:
            y = y + y[..., np.arange(y.shape[-1]) ^ o]
            o //= 2
        ys[:, t] = y[..., 0]
    return ys, h


@jax.jit
def _jax_scan(dt, xs, Bm, Cm, A, h0, n_valid):
    """The JAX package's recurrence (_mamba_prefill_chunk's): dA and dBx
    materialised, padded steps (1, 0), a lax.scan over time."""
    valid = (jnp.arange(dt.shape[1])[None] < n_valid[:, None])[..., None,
                                                                None]
    dA = jnp.where(valid, jnp.exp(dt[..., None] * A), 1.0)
    dBx = jnp.where(valid, (dt * xs)[..., None] * Bm[:, :, None, :], 0.0)

    def step(h, inp):
        dA_t, dBx_t, C_t = inp
        h = dA_t * h + dBx_t
        return h, jnp.einsum("bdn,bn->bd", h, C_t)

    h, ys = jax.lax.scan(step, h0, (jnp.moveaxis(dA, 1, 0),
                                    jnp.moveaxis(dBx, 1, 0),
                                    jnp.moveaxis(Cm, 1, 0)))
    return jnp.moveaxis(ys, 0, 1), h


SCAN_CASES = {  # B, T, n_valid; n = the kernel's STATES
    "T 1": (2, 1, None),
    "T 37, ragged [37, 20, 1, 0]": (4, 37, [37, 20, 1, 0]),
    "T 21, ragged [21, 9]": (2, 21, [21, 9]),
}


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_selective_scan_orders_agree(case):
    """The plain scan (ops.selective_scan on the CPU) and the kernel's
    order of operations emulated in numpy, from h0 != 0, within 1e-5 of
    each other and of the JAX code's lax.scan (dA and dBx materialised,
    padded steps (1, 0)); ragged identity tails hold h bit for bit and
    still read y = h . C."""
    B, T_, nv = SCAN_CASES[case]
    args = _scan_inputs(B, T_, 40, selective_scan.STATES, T_)
    nv = np.array(nv if nv is not None else [T_] * B, np.int32)
    ys, h = ops.selective_scan(*map(torch.as_tensor, args),
                               torch.as_tensor(nv))
    ys, h = ys.numpy(), h.numpy()
    k_ys, k_h = _kernel_order_scan(*args, nv)
    np.testing.assert_allclose(k_ys, ys, **TOL)
    np.testing.assert_allclose(k_h, h, **TOL)
    j_ys, j_h = _jax_scan(*map(jnp.asarray, args), jnp.asarray(nv))
    np.testing.assert_allclose(ys, np.asarray(j_ys), **TOL)
    np.testing.assert_allclose(h, np.asarray(j_h), **TOL)
    # padded steps read C alone: other dt, x and B there change no bit
    pad = np.arange(T_)[None] >= nv[:, None]
    alt = [a.copy() for a in args]
    for a in alt[:3]:
        a[pad] = 7.0
    ys2, h2 = ops.selective_scan(*map(torch.as_tensor, alt),
                                 torch.as_tensor(nv))
    np.testing.assert_array_equal(ys2.numpy(), ys)
    np.testing.assert_array_equal(h2.numpy(), h)
    for b in np.flatnonzero(nv == 0):     # no real step: h0 held
        np.testing.assert_array_equal(h[b], args[5][b])


def test_selective_scan_cuda_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper takes CUDA tensors only (ops routes a CPU
    tensor to the plain version; nothing falls back)."""
    args = [torch.as_tensor(a) for a in _scan_inputs(1, 2, 8, 8, 0)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        selective_scan.selective_scan_cuda(
            *args, torch.ones(1, dtype=torch.int32))


# ------------------------------------------------------------ the block


def _mamba_state(cfg, B, rng):
    """A mamba layer state with h and conv drawn N(0, 1)."""
    return {"h": rng.randn(B, cfg.d_inner, cfg.ssm_state).astype(np.float32),
            "conv": rng.randn(B, cfg.conv_width - 1,
                              cfg.d_inner).astype(np.float32)}


BLOCK_CASES = {  # mode, B, T, n_valid (decode: active)
    "decode": ("decode", 3, 1, None),
    "decode, lane 1 inactive": ("decode", 3, 1, [1, 0, 1]),
    "prefill T 9": ("prefill", 3, 9, None),
    "prefill T 2 (< conv_width - 1)": ("prefill", 3, 2, None),
    "chunk, all valid": ("chunk", 3, 8, None),
    "chunk, ragged [8, 2, 0]": ("chunk", 3, 8, [8, 2, 0]),
}


@functools.lru_cache(maxsize=None)
def _jax_block(mode):
    """The JAX package's mamba block in one mode, jitted (one compile a
    shape, where an eager call compiles each of its operations)."""
    cfg_j = _models()[0]
    pol = jax_make_policy(JServeConfig())
    if mode == "decode":
        return jax.jit(lambda p, x, st, t, active: JB.apply_block_decode(
            p, None, cfg_j, "mamba", x, st, t, policy=pol, active=active))
    if mode == "prefill":
        return jax.jit(lambda p, x, st: JB.apply_block_prefill(
            p, None, cfg_j, "mamba", x, st, policy=pol, budget=8))
    return jax.jit(lambda p, x, st, t, nv: JB.apply_block_prefill_chunk(
        p, None, cfg_j, "mamba", x, st, t, policy=pol, n_valid=nv))


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_mamba_block_matches_jax(case):
    """One mamba block in each mode against the JAX block (_mamba_step,
    _mamba_prefill, _mamba_prefill_chunk): x_out, h and conv within
    TOL. Decode from a drawn state, written in place (an inactive lane
    frozen bit-identically); single-shot prefill from a fresh state
    (a prompt shorter than conv_width - 1 too, whose conv tail is
    left-padded); chunks from a drawn state, the conv over its history
    rows, with a ragged n_valid (a row with 0 keeps its state)."""
    mode, B, T_, nv = BLOCK_CASES[case]
    _, params, _, cfg, model = _models()
    p = jax.tree.map(np.asarray,
                     bridge._per_layer(jax.device_get(params), cfg)[1])
    block = model.layers[1]
    assert block.kind == "mamba" and block.gate is None
    rng = np.random.RandomState(len(case))
    x = rng.randn(B, T_, cfg.d_model).astype(np.float32)
    st = (_mamba_state(cfg, B, rng) if mode != "prefill" else
          {k: np.zeros_like(v) for k, v in _mamba_state(cfg, B,
                                                        rng).items()})
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
    for k in ("h", "conv"):
        np.testing.assert_allclose(got_st[k].numpy(), np.asarray(want_st[k]),
                                   **TOL)
    if nv is not None:           # frozen rows keep their state exactly
        for b in np.flatnonzero(np.array(nv) == 0):
            for k in ("h", "conv"):
                np.testing.assert_array_equal(got_st[k][b].numpy(), st[k][b])


# ------------------------------------------------------- one-shot runs


@pytest.mark.parametrize("chunked", [False, True])
def test_generate_matches_jax(chunked):
    """A batch of 3 prompts of 45 tokens, single-shot or in chunks of 16
    (the last one padded): the last hidden state and every layer's h and
    conv after prefill within TOL, then 5 decode steps from the JAX
    engine's state and the port's (logits and states within TOL after
    each), and Engine.generate's ids, fused and eager, equal to the JAX
    engine's prefill and decode steps' greedy tokens."""
    _, _, _, cfg, model = _models()
    je = _jax_engine()
    te = build_engine(cfg, model, device="cpu", **SERVE)
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
    """4 requests, each a 24-token shared prefix and its own turn (prompts
    25 to 40 tokens, past a chunk of 16): three priority-0 prompts and a
    priority-3 one that arrives after the first step."""
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
SCHED = {  # serve fields, interleaved, park
    "swap, phased": (PRIORITY, False, False),
    "spec_k 2, interleaved": (dict(PRIORITY, spec_k=2), True, False),
    "prefix cache, phased": (dict(prefix_cache_bytes=1 << 22,
                                  prefix_min_tokens=16), False, False),
    "park / revive": ({}, False, True),
}


def _port_run(kw, interleaved, park):
    """The port scheduler on the trace: (results, stats, dispatch
    count, the scheduler)."""
    _, _, _, cfg, model = _models()
    te = build_engine(cfg, model, device="cpu", **{**SERVE, **kw})
    ts = Scheduler(te, n_lanes=3, interleaved=interleaved)
    res = _drive(ts, _trace(Request, cfg), park)
    return res, ts.stats(), te.dispatch_count, ts


@pytest.mark.parametrize("case", list(SCHED))
def test_scheduler_matches_jax(case):
    """The port's Scheduler against the JAX Scheduler (3 lanes): ids,
    statuses, stats() and dispatch_count equal under swap preemption (a
    swap and a resume), spec_k 2 interleaved (whose ids also equal
    spec_k 0's), the prefix cache (a hit: the lanes' h and conv rows
    installed) and park / revive."""
    kw, interleaved, park = SCHED[case]
    _, _, _, cfg, _ = _models()
    je = _jax_engine(**kw)
    js = JScheduler(je, n_lanes=3, interleaved=interleaved)
    want = _drive(js, _trace(JRequest, cfg), park)
    got, stats, dispatches, ts = _port_run(kw, interleaved, park)
    for rid, rs in want.items():
        assert got[rid].status.value == rs.status.value == "done", rid
        assert got[rid].tokens == rs.tokens, rid
    assert stats == {k: js.stats()[k] for k in stats}
    assert dispatches == je.dispatch_count
    if kw.get("spec_k"):
        plain = _port_run({**kw, "spec_k": 0}, interleaved, park)[0]
        assert all(got[r].tokens == plain[r].tokens for r in got)
        assert stats["n_verify_rounds"] > 0
    if kw.get("prefix_cache_bytes"):
        assert ts.n_prefix_hits >= 1
    if kw is PRIORITY:
        assert ts.n_preempted >= 1 and ts.n_swaps >= 1 and ts.n_resumes >= 1


# ------------------------------------------------------------ lane ops


def test_reset_scrub_and_poison_of_an_ssm_lane():
    """reset_lanes and scrub_lanes zero a mamba layer's h and conv in the
    masked lanes, as the JAX package's fills do, and leave the other
    lanes bit-identical; a NaN planted in h is gone after a scrub. The
    fault injector's poison_lanes touches no leaf of an ssm state (it
    poisons K and V, which no layer has)."""
    _, _, _, cfg, model = _models()
    te = build_engine(cfg, model, device="cpu", **SERVE)
    state, _ = te.prefill(_tokens(cfg, 3, 20, 2), chunked=True)
    layers = state["layers"]
    assert all(st["h"].abs().sum() > 0 for st in layers)
    before = [{k: v.clone() for k, v in st.items()} for st in layers]
    poison_lanes(state, torch.tensor([True, True, True]))
    for st, old in zip(layers, before):
        assert all(torch.equal(st[k], old[k]) for k in st)
    layers[0]["h"][1, 3, 2] = float("nan")
    before[0]["h"][1, 3, 2] = float("nan")
    mask = torch.tensor([False, True, False])
    for op in (T.reset_lanes, T.scrub_lanes):
        op(state, mask)
        for st, old in zip(layers, before):
            for k in blocks.RECURRENT_LEAVES:
                assert (st[k][1] == 0).all()
                assert torch.equal(st[k][~mask], old[k][~mask])
    assert int(state["t"][1]) == 0


def test_quarantined_lane_leaks_no_nan():
    """A NaN planted in a decoding lane's h makes its logits non-finite:
    the scheduler quarantines the lane (scrub: h and conv zeroed),
    replays the request, and both it and the next request on that lane
    give the ids of a clean run."""
    _, _, _, cfg, model = _models()
    reqs = _trace(Request, cfg)[:2]
    clean = Scheduler(build_engine(cfg, model, device="cpu", **SERVE),
                      n_lanes=1).run(_trace(Request, cfg)[:2])
    sched = Scheduler(build_engine(cfg, model, device="cpu", **SERVE),
                      n_lanes=1)
    for r in reqs:
        sched.submit(r)
    sched.step()
    sched.lanes.state["layers"][1]["h"][0] = float("nan")
    res = sched.run()
    assert sched.n_quarantined == 1
    for r in reqs:
        assert res[r.rid].status is Status.DONE
        assert res[r.rid].tokens == clean[r.rid].tokens
    for st in sched.lanes.state["layers"]:
        assert torch.isfinite(st["h"]).all()


# ------------------------------------------------------- the bridge etc.


def test_bridge_row_bytes_and_refusals():
    """Params and gates through the bridge and back: no layer has a gate
    (the gates tree round-trips with None leaves) and the mamba leaves
    arrive as drawn; the decode state in the JAX layout has the JAX
    state's leaves; a lane's snapshot row has the JAX row's bytes, at
    full width in bf16 64 * 8192 * 16 * 4 + 64 * 3 * 8192 * 2 =
    36,700,160 B (h float32). falcon-mamba-7b loads at full width (64
    mamba layers); training the family raises NotImplementedError
    naming its queue item."""
    cfg_j, params, gates, cfg, model = _models()
    got = bridge.gates_to_jax(model, cfg)
    assert jax.tree.structure(got) == jax.tree.structure(
        jax.device_get(gates))
    assert jax.tree.leaves(got) == [] and T.num_gate_layers(cfg) == 0
    for block, pl in zip(model.layers,
                         bridge._per_layer(jax.device_get(params), cfg)):
        for k in ("conv_b", "A_log", "D"):
            np.testing.assert_array_equal(getattr(block, k).numpy(), pl[k])
        np.testing.assert_array_equal(block.dt_proj.bias.numpy(),
                                      pl["dt_proj"]["b"])
        np.testing.assert_array_equal(block.x_proj.weight.numpy().T,
                                      pl["x_proj"]["w"])
    state = T.init_decode_state(cfg, 2, 8, "cpu")
    jstate = jax.eval_shape(lambda: JT.init_decode_state(cfg_j, 2, 8))
    assert (jax.tree.structure(bridge.state_to_numpy(state, cfg))
            == jax.tree.structure(jstate))
    full = get_config(SSM)
    assert full.layer_kinds() == ("mamba",) * 64 and not full.trimkv
    for c, cj in ((cfg, cfg_j), (full, jax_config(SSM))):
        c = dataclasses.replace(c, dtype="bfloat16")
        cj = dataclasses.replace(cj, dtype="bfloat16")
        shapes = jax.eval_shape(lambda: JT.init_decode_state(cj, 1, 8))
        want = sum(int(np.prod(a.shape)) * a.dtype.itemsize
                   for a in jax.tree.leaves(shapes))
        row = host_row_template(c, 8)
        assert state_row_bytes(row) == want
        assert row["layers"][0]["h"].dtype == np.float32
    assert state_row_bytes(host_row_template(dataclasses.replace(
        full, dtype="bfloat16"), 512)["layers"]) == 36_700_160
    tokens = torch.as_tensor(_tokens(cfg, 1, 16, 1))
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        T.forward_train(model, cfg, tokens)
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        blocks.apply_block_train(model.layers[0], cfg,
                                 torch.zeros(1, 4, cfg.d_model))
