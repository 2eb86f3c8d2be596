"""The port's MoE family (granite-moe-3b-a800m, mixtral-8x7b) against
the JAX package's, on their smoke configs (2 layers, 4 experts, top 2,
float32; mixtral's window 16 binds below the prompts' lengths).

Weights: drawn with numpy as the JAX package's init draws them
(tests/_jax_weights.py) and moved to the port through
repro_torch.bridge, with each router redrawn N(0, 9 / d) (three times
the init's scale, so routing is decisive and no top-k choice sits near
a tie) and gate biases U(2, 8), so eviction is decided by the scores.
Inputs come from numpy seeds. The JAX side runs its XLA path
(the plain reference of its Pallas kernels); the port its plain
PyTorch versions.

Expert capacity couples every row of an FFN call: whether a token's
choice is dropped depends on every other row of the same [B, T] grid.
So parity is held against the JAX engine and scheduler on the same
calls, never against one-shot runs of one request.

Tolerances: moe_apply's output within 1e-5 of its largest magnitude
(float32 in another summation order; bf16 weights: one bf16 step), its
aux within 1e-6, keep masks exact; hidden states and logits within
1e-5 (absolute and relative); greedy ids, slot positions (so victims),
statuses, stats() and dispatch counts exactly; distill_loss within rel
1e-4, gate gradients within 1e-3 of each leaf's largest entry.

Cost: the JAX scheduler runs in exactly the two scheduler cases; the
other JAX runs are the engine's prefill and decode steps and single
functions.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _jax_weights as jax_weights
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import blocks as JB
from repro.models import transformer as JT
from repro.serve import Request as JRequest
from repro.serve import Scheduler as JScheduler
from repro.serve.engine import build_engine as jax_build_engine
from repro.train import distill as jdistill
from repro_torch import bridge
from repro_torch.configs import ServeConfig, TrainConfig, get_smoke_config
from repro_torch.core.policies import make_policy
from repro_torch.models import blocks
from repro_torch.models import transformer as T
from repro_torch.serve.engine import build_engine
from repro_torch.serve.request import Request
from repro_torch.serve.scheduler import Scheduler
from repro_torch.train import distill

MOE = ("granite-moe-3b-a800m", "mixtral-8x7b")
TOL = dict(atol=1e-5, rtol=1e-5)
SERVE = dict(budget=16, prefill_chunk=16, decode_segment=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread (a pool of eight waits ~10 ms
    per op for its threads while XLA's own pool is live)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturb(tree, rng, gates):
    """A copy of a numpy params (or gates) tree with every router
    N(0, 9 / d) (params) or every gate bias U(2, 8) (gates)."""
    if isinstance(tree, tuple):
        return tuple(_perturb(v, rng, gates) for v in tree)
    if not isinstance(tree, dict):
        return tree
    out = {k: _perturb(v, rng, gates) for k, v in tree.items()}
    if gates and "w1" in tree:
        out["b"] = rng.uniform(2.0, 8.0, tree["b"].shape).astype(np.float32)
    if not gates and "router" in tree:
        w = tree["router"]["w"]
        out["router"] = {"w": (rng.randn(*w.shape) * 3
                               / np.sqrt(w.shape[-2])).astype(np.float32)}
    return out


@functools.lru_cache(maxsize=None)
def _models(arch):
    """(JAX cfg, params, gates, port cfg, port model): one set of
    weights."""
    cfg_j, cfg = jax_smoke_config(arch), get_smoke_config(arch)
    rng = np.random.RandomState(11)
    params = _perturb(jax.device_get(jax_weights.init_params(cfg_j)), rng,
                      False)
    gates = _perturb(jax.device_get(jax_weights.init_gate_params(cfg_j)), rng,
                     True)
    model = bridge.params_from_jax(params, cfg, device="cpu")
    bridge.gates_from_jax(gates, cfg, model)
    return (cfg_j, jax.tree.map(jnp.asarray, params),
            jax.tree.map(jnp.asarray, gates), cfg, model)


@functools.lru_cache(maxsize=None)
def _jax_engine(arch, **kw):
    """One JAX engine per (arch, serve fields): the cases that share one
    share its compiled closures."""
    cfg_j, params, gates, _, _ = _models(arch)
    return jax_build_engine(cfg_j, params, gates, **SERVE, **kw)


def _tokens(cfg, B, L, seed):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (B, L)).astype(np.int32)


# ------------------------------------------------------------ moe_apply


def _jax_keep(p, x, cfg_j):
    """The keep mask [S, k] of the JAX package's _moe_apply on x [B, T,
    d], replayed in numpy from its own router and top-k (its
    positioning loop: one int32 cumsum per top-k column, the counts
    carried)."""
    E, k = cfg_j.num_experts, cfg_j.experts_per_token
    xf = x.reshape(-1, x.shape[-1])
    S = xf.shape[0]
    probs = jax.nn.softmax(jnp.asarray(xf) @ p["router"]["w"], axis=-1)
    top_idx = np.asarray(jax.lax.top_k(probs, k)[1])
    group = min(2048, S)
    if S % group:
        group = S
    cap = max(int(np.ceil(group * k / E * cfg_j.moe_capacity_factor)), k)
    keep = np.zeros((S, k), bool)
    for g0 in range(0, S, group):
        ti = top_idx[g0:g0 + group]
        counts = np.zeros(E, np.int32)
        for j in range(k):
            oh = np.eye(E, dtype=np.int32)[ti[:, j]]
            pos = np.cumsum(oh, axis=0) - 1 + counts[None]
            keep[g0:g0 + group, j] = (pos < cap)[np.arange(len(ti)), ti[:, j]]
            counts = counts + oh.sum(axis=0)
    return keep


MOE_CASES = {  # name: (arch, B, T, capacity factor, dtype)
    "two_groups": ("granite-moe-3b-a800m", 2, 2048, 1.25, "float32"),
    "one_group": ("mixtral-8x7b", 3, 37, 1.25, "float32"),
    "drops": ("granite-moe-3b-a800m", 2, 50, 0.5, "float32"),
    "no_drops": ("mixtral-8x7b", 2, 50, 2.0, "float32"),
    "decode_3_lanes": ("mixtral-8x7b", 3, 1, 1.25, "float32"),
    "bf16": ("granite-moe-3b-a800m", 2, 50, 0.5, "bfloat16"),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_apply_matches_jax(case):
    """moe_apply against _moe_apply on one layer's experts: the output
    within 1e-5 of its largest magnitude (bf16 weights: one bf16 step),
    the aux within 1e-6, and the keep mask exact. Two groups of 2048
    (S 4096), S 111 in one group (it does not divide), capacity factor
    0.5 (drops forced), E / k (no drops) and a decode step of 3 lanes
    (cap 2: the third lane choosing an expert drops)."""
    arch, B, Tn, factor, dtype = MOE_CASES[case]
    cfg_j, params, _, cfg, model = _models(arch)
    over = dict(moe_capacity_factor=factor, dtype=dtype)
    cfg_j, cfg = (dataclasses.replace(cfg_j, **over),
                  dataclasses.replace(cfg, **over))
    p = bridge._per_layer(jax.device_get(params), cfg)[1]["ffn"]
    ffn = blocks.MoE(cfg, dtype=getattr(torch, dtype), device="cpu",
                     generator=torch.Generator())
    with torch.no_grad():
        ffn.router.copy_(torch.from_numpy(np.array(p["router"]["w"])))
        for name in ("gate_w", "up_w", "down_w"):
            getattr(ffn, name).copy_(torch.from_numpy(np.array(p[name])))
    jp = {"router": {"w": jnp.asarray(p["router"]["w"])},
          **{n: jnp.asarray(p[n]).astype(jnp.dtype(dtype))
             for n in ("gate_w", "up_w", "down_w")}}
    x = np.random.RandomState(3).randn(B, Tn, cfg.d_model).astype(np.float32)
    if Tn == 1:
        x[2] = x[0]              # two lanes choose alike: the later drops
    xj = jnp.asarray(x).astype(jnp.dtype(dtype))
    want, want_aux = jax.jit(JB._moe_apply, static_argnums=2)(jp, xj, cfg_j)
    with torch.no_grad():
        got, aux, keep = blocks.moe_apply(
            ffn, torch.as_tensor(x).to(getattr(torch, dtype)), cfg,
            return_keep=True)
    want = np.asarray(want.astype(jnp.float32))
    scale = np.abs(want).max()
    atol = scale * (2.0 ** -7 if dtype == "bfloat16" else 1e-5)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=1e-6)
    want_keep = _jax_keep(jp, np.asarray(xj.astype(jnp.float32)), cfg_j)
    np.testing.assert_array_equal(keep.reshape(-1, cfg.experts_per_token)
                                  .numpy(), want_keep)
    assert (~want_keep).any() == (case in ("drops", "decode_3_lanes",
                                           "bf16"))


def test_drop_counter_counts_in_place():
    """Every moe_apply adds its dropped choices to the layer's device
    counter (in place: a captured step program keeps adding)."""
    _, _, _, cfg, model = _models("mixtral-8x7b")
    ffn = model.layers[0].ffn
    cfg = dataclasses.replace(cfg, moe_capacity_factor=0.5)
    x = torch.as_tensor(np.random.RandomState(5).randn(2, 9, cfg.d_model),
                        dtype=torch.float32)
    counter = ffn.drops
    ffn.drops.zero_()
    _, _, keep = blocks.moe_apply(ffn, x, cfg, return_keep=True)
    blocks.moe_apply(ffn, x, cfg)
    assert ffn.drops is counter
    assert int(ffn.drops) == 2 * int((~keep).sum()) > 0
    ffn.drops.zero_()


# -------------------------------------------------------- one-shot runs


ONESHOT = [(arch, chunked, policy) for arch in MOE
           for chunked, policy in ((False, "trimkv"), (True, "trimkv"),
                                   (True, "h2o"))]


@pytest.mark.parametrize("case", ONESHOT, ids=lambda c: "-".join(map(str, c)))
def test_generate_matches_jax(case):
    """A batch of 3 prompts of 45 tokens: the last hidden state and every
    layer's slot positions after prefill, then 6 decode steps from the
    JAX engine's state and the port's (logits and slot positions, so
    the victims, after each), and Engine.generate's ids equal to the
    JAX engine's, fused and eager."""
    arch, chunked, policy = case
    cfg_j, params, gates, cfg, model = _models(arch)
    je = _jax_engine(arch, policy=policy)
    te = build_engine(cfg, model, device="cpu", policy=policy, **SERVE)
    tokens = _tokens(cfg, 3, 45, 6)
    js, jh = je.prefill(tokens, chunked=chunked)
    ts, th = te.prefill(tokens, chunked=chunked)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    tok = np.array(je._first_token(jh))
    ids = [tok]
    for _ in range(6):
        js, jl = je._decode(js, jnp.asarray(tok))
        ts, tl = T.decode_step(model, cfg, ts, torch.as_tensor(tok),
                               te.policy)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        g = bridge._per_layer(bridge.state_to_numpy(ts, cfg), cfg)
        w = bridge._per_layer(jax.device_get(js), cfg)
        for gl, wl in zip(g, w):
            np.testing.assert_array_equal(gl["pos"], wl["pos"])
        tok = np.array(jnp.argmax(jl, axis=-1), np.int32)
        ids.append(tok)
    want = np.stack(ids[:6], axis=1)
    for fused in (True, False):
        got = te.generate(tokens, 6, chunked=chunked, fused=fused)["ids"]
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ scheduler


def _trace(cls, cfg, seed=3):
    """4 requests: three priority-0 prompts above the window, and a
    priority-3 one that arrives after the first round."""
    rng = np.random.RandomState(seed)
    return [cls(rid=i, prompt=rng.randint(0, cfg.vocab_size, L).astype(
                np.int32), max_new=m, seed=i, priority=pr)
            for i, (L, m, pr) in enumerate([(30, 12, 0), (21, 10, 0),
                                            (35, 9, 0), (40, 5, 3)])]


def _drive(sched, reqs):
    """Three lanes busy decoding when the better-ranked request arrives:
    one is swapped out, and a lane is reused."""
    for r in reqs[:3]:
        sched.submit(r)
    sched.step()
    sched.submit(reqs[3])
    return sched.run()


@pytest.mark.parametrize("interleaved", [False, True])
def test_scheduler_matches_jax(interleaved):
    """The port's Scheduler against the JAX Scheduler on mixtral's smoke
    config (3 lanes, so decode steps drop: cap 2; priority order, swap
    preemption): ids, statuses, stats() and dispatch_count equal, and
    the port's FFN calls dropped choices."""
    cfg_j, params, gates, cfg, model = _models("mixtral-8x7b")
    je = _jax_engine("mixtral-8x7b", sched_policy="priority")
    je.dispatch_count = 0
    js = JScheduler(je, n_lanes=3, interleaved=interleaved)
    want = _drive(js, _trace(JRequest, cfg))
    te = build_engine(cfg, model, device="cpu", sched_policy="priority",
                      **SERVE)
    ffns = [b.ffn for b in model.layers]
    for f in ffns:
        f.drops.zero_()
    ts = Scheduler(te, n_lanes=3, interleaved=interleaved)
    got = _drive(ts, _trace(Request, cfg))
    for rid, rs in want.items():
        assert got[rid].status.value == rs.status.value == "done", rid
        assert got[rid].tokens == rs.tokens, rid
    stats = ts.stats()
    assert stats == {k: js.stats()[k] for k in stats}
    assert te.dispatch_count == je.dispatch_count
    assert ts.n_swaps >= 1 and ts.n_resumes >= 1
    assert all(int(f.drops) > 0 for f in ffns)
    for f in ffns:
        f.drops.zero_()


# ------------------------------------------------------------- refusals


def test_spec_k_is_refused_with_the_jax_message():
    """spec_k > 0 is refused at engine build, with the JAX engine's
    message; spec_k 0 builds."""
    cfg_j, params, gates, cfg, model = _models("granite-moe-3b-a800m")
    with pytest.raises(ValueError) as want:
        jax_build_engine(cfg_j, params, gates, spec_k=2, **SERVE)
    with pytest.raises(ValueError) as got:
        build_engine(cfg, model, device="cpu", spec_k=2, **SERVE)
    assert str(got.value) == str(want.value)
    build_engine(cfg, model, device="cpu", spec_k=0, **SERVE)


def test_block_verify_is_refused_with_the_jax_message():
    """apply_block_verify raises for an MoE block, with the JAX
    package's message."""
    cfg_j, params, gates, cfg, model = _models("mixtral-8x7b")
    policy = make_policy(ServeConfig(**SERVE))
    x = np.zeros((2, 3, cfg.d_model), np.float32)
    jp = jax.tree.map(lambda a: a[0], params["layers"][0])
    jst = JT.init_decode_state(cfg_j, 2, 16)["layers"][0]
    with pytest.raises(ValueError) as want:
        JB.apply_block_verify(jp, None, cfg_j, "local", jnp.asarray(x),
                              jax.tree.map(lambda a: a[0], jst), 0,
                              policy=policy)
    state = T.init_decode_state(cfg, 2, 16, "cpu")["layers"][0]
    with pytest.raises(ValueError) as got:
        blocks.apply_block_verify(model.layers[0], cfg, torch.as_tensor(x),
                                  state, 0, policy=policy)
    assert str(got.value) == str(want.value)


# -------------------------------------------------------------- training


@functools.lru_cache(maxsize=None)
def _distill_case():
    """The JAX package's distill_loss and gate gradients on granite's
    smoke config (T 40, capacity_M 8), and its weights."""
    cfg_j, params, gates, cfg, _ = _models("granite-moe-3b-a800m")
    tc_j = JTrainConfig(capacity_M=8, seq_len=40)
    tokens = _tokens(cfg, 2, 40, 13)
    labels = np.concatenate([tokens[:, 1:], -np.ones((2, 1), np.int32)], 1)
    (_, metrics), grads = jax.jit(jax.value_and_grad(
        lambda g, p, t, l: jdistill.distill_loss(g, p, cfg_j, tc_j, t, l),
        has_aux=True))(gates, params, jnp.asarray(tokens),
                       jnp.asarray(labels))
    return (tokens, labels, jax.device_get(metrics), jax.device_get(grads),
            jax.device_get(params), jax.device_get(gates))


def test_distill_matches_jax():
    """MoE gate distillation: distill_loss and its terms within rel 1e-4
    (the router aux is not in the loss, in either package), gate
    gradients within 1e-3 of each leaf's largest entry, and
    forward_train's summed router aux against the JAX package's."""
    tokens, labels, want, want_g, np_params, np_gates = _distill_case()
    cfg_j, params, gates, cfg, _ = _models("granite-moe-3b-a800m")
    model = bridge.params_from_jax(np_params, cfg, device="cpu")
    bridge.gates_from_jax(np_gates, cfg, model)
    tc = TrainConfig(capacity_M=8, seq_len=40)
    gp = T.gate_parameters(model)
    for p in gp:
        p.requires_grad_(True)
    loss, got = distill.distill_loss(model, cfg, tc, torch.as_tensor(tokens),
                                     torch.as_tensor(labels))
    for k in ("loss", "kl", "ntp", "cap"):
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]),
                                   rtol=1e-4, atol=1e-7, err_msg=k)
    grads = torch.autograd.grad(loss, gp)
    with torch.no_grad():
        for p, g in zip(gp, grads):
            p.copy_(g)
    g_tree = bridge.gates_to_jax(model, cfg)
    for name in ("b", "w1", "w2"):
        g = g_tree["layers"][0][name]
        w = want_g["layers"][0][name]
        g, w = (g["w"], w["w"]) if name != "b" else (g, w)
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-3 * np.abs(w).max(),
                                   err_msg=name)
    _, aux_j = JT.forward_train(params, gates, cfg_j, jnp.asarray(tokens))
    with torch.no_grad():
        _, aux = T.forward_train(model, cfg, torch.as_tensor(tokens))
    np.testing.assert_allclose(float(aux["router"]), float(aux_j["router"]),
                               rtol=1e-5)
    assert float(aux["router"]) > 0
