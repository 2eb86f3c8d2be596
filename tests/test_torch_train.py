"""The port's gate-distillation training against the JAX package's, on
the smoke config of trimkv-paper-4b (2 layers, d_model 128, float32)
with attention blocks of 32, so the q/kv block loop and its short tail
both run at T = 70. The JAX package's weights come through
repro_torch.bridge; the JAX references are computed once per module.

Tolerances (float32 on both sides, summed in other orders):
- forward_train hidden and L_cap: 1e-5 absolute and relative;
- distill_loss and its kl / ntp / cap: 1e-5 relative;
- gate gradients: rtol 1e-4, with an absolute floor of 1e-4 times the
  leaf's largest magnitude (the default gates' gradients span many
  decades);
- AdamW on identical gradients: parameters 1e-6 absolute and relative,
  moments 1e-6 relative above 1e-9 (the clip scales each gradient by
  clip / |g|, whose sum of squares rounds in another order);
- three train_loop steps: losses 1e-4 relative, gates after atol 1e-6
  + rtol 1e-4 (the optimizer turns gradient rounding into step
  rounding);
- checkpoints: exact.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_smoke_config as jax_smoke_config
from repro.data import DataConfig as JDataConfig
from repro.models import common as jcommon
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro.train import distill as jdistill
from repro.train.trainer import train_loop as jax_train_loop
from repro_torch import bridge
from repro_torch.checkpoint import ckpt
from repro_torch.configs import TrainConfig, get_smoke_config
from repro_torch.data.pipeline import DataConfig, batches
from repro_torch.models import common
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.train import distill
from repro_torch.train.trainer import train_loop

ARCH = "trimkv-paper-4b"
BLOCKS = dict(attn_q_block=32, attn_kv_block=32)
CAP_M = 16
TRAIN_VARIANTS = {
    "default": {},
    "no_kl": {"use_kl": False},
    "no_cap": {"use_cap": False},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread. A pool of eight
    takes ~10 ms to wake for each op while XLA's own pool is live."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    return (dataclasses.replace(jax_smoke_config(ARCH), **BLOCKS),
            dataclasses.replace(get_smoke_config(ARCH), **BLOCKS))


def _np_tree(shapes, rng, gate_bias=None):
    """Weights in the JAX package's layout, drawn with numpy: dense "w"
    N(0, 1/in) (gate w2 N(0, 0.02^2)), the embedding N(0, 0.02^2),
    norm scales 1 + N(0, 0.1^2), gate biases ``gate_bias``."""
    def leaf(path, sd):
        key = jax.tree_util.keystr(path)
        if key.endswith("['b']"):
            return np.broadcast_to(gate_bias, sd.shape).astype(np.float32)
        if key.endswith("['scale']"):
            return (1 + 0.1 * rng.randn(*sd.shape)).astype(np.float32)
        scale = (0.02 if key == "['embed']" or "['w2']" in key
                 else 1 / np.sqrt(sd.shape[-2]))
        return (scale * rng.randn(*sd.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@functools.lru_cache(maxsize=None)
def _weights(gates_mode):
    """(jax params, jax gates, numpy params, numpy gates) from a numpy
    seed. Gate biases: 18, the paper's start ("default", beta rounds to
    1.0), or b ~ U(2, 8) per (layer, kv head) ("perturbed": beta spreads
    below 1 and some heads fall under the budget)."""
    cfg_j, _ = _cfgs()
    key = jax.random.PRNGKey(0)
    rng = np.random.RandomState(0)
    np_params = _np_tree(jax.eval_shape(
        lambda k: JT.init_params(k, cfg_j), key), rng)
    bias = (18.0 if gates_mode == "default"
            else rng.uniform(2.0, 8.0, (cfg_j.num_layers,
                                        cfg_j.num_kv_heads)))
    np_gates = _np_tree(jax.eval_shape(
        lambda k: JT.init_gate_params(k, cfg_j), key), rng, gate_bias=bias)
    return (jax.tree.map(jnp.asarray, np_params),
            jax.tree.map(jnp.asarray, np_gates), np_params, np_gates)


def _model(gates_mode):
    """A fresh port model holding the same weights."""
    _, _, np_params, np_gates = _weights(gates_mode)
    _, cfg = _cfgs()
    model = bridge.params_from_jax(np_params, cfg, device="cpu")
    return bridge.gates_from_jax(np_gates, cfg, model)


@functools.lru_cache(maxsize=None)
def _batch():
    """tokens and lm_labels [2, 70]; the last label is -1 (ignored)."""
    b = next(batches(DataConfig(batch=2, seq_len=70)))
    return b["tokens"], b["lm_labels"]


def _train_cfgs(variant, **kw):
    over = dict(capacity_M=CAP_M, seq_len=70, **TRAIN_VARIANTS[variant], **kw)
    return JTrainConfig(**over), TrainConfig(**over)


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad():
    """jax.value_and_grad of distill_loss under the default TrainConfig
    (capacity_M 16), compiled once for both gate modes."""
    cfg_j, _ = _cfgs()
    tc_j, _ = _train_cfgs("default")
    return jax.jit(jax.value_and_grad(
        lambda g, p, t, l: jdistill.distill_loss(g, p, cfg_j, tc_j, t, l),
        has_aux=True))


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(gates_mode):
    params, gates, _, _ = _weights(gates_mode)
    tokens, labels = _batch()
    (_, metrics), grads = _jax_value_and_grad()(
        gates, params, jnp.asarray(tokens), jnp.asarray(labels))
    return jax.device_get(metrics), jax.device_get(grads)


def _jax_metrics(variant):
    if variant == "default":
        return _jax_loss_and_grads("perturbed")[0]
    cfg_j, _ = _cfgs()
    tc_j, _ = _train_cfgs(variant)
    params, gates, _, _ = _weights("perturbed")
    tokens, labels = _batch()
    fn = jax.jit(lambda g, p, t, l: jdistill.distill_loss(g, p, cfg_j, tc_j,
                                                          t, l)[1])
    return jax.device_get(fn(gates, params, jnp.asarray(tokens),
                             jnp.asarray(labels)))


@pytest.mark.parametrize("gated", [True, False])
def test_forward_train_matches_jax(gated):
    cfg_j, cfg = _cfgs()
    params, gates, _, _ = _weights("perturbed")
    tokens, _ = _batch()
    cap_M = CAP_M if gated else None
    h_j, aux_j = jax.jit(lambda p, g, t: JT.forward_train(
        p, g, cfg_j, t, gated=gated, cap_M=cap_M))(params, gates,
                                                    jnp.asarray(tokens))
    model = _model("perturbed")
    with torch.no_grad():
        h, aux = T.forward_train(model, cfg, torch.as_tensor(tokens),
                                 gated=gated, cap_M=cap_M)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_j), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(aux["cap"]), float(aux_j["cap"]),
                               atol=1e-5, rtol=1e-5)
    assert aux["n_gate_layers"] == 2
    assert (float(aux["cap"]) > 0) == gated


@pytest.mark.parametrize("variant", list(TRAIN_VARIANTS))
def test_distill_loss_matches_jax(variant):
    want = _jax_metrics(variant)
    _, cfg = _cfgs()
    _, tc = _train_cfgs(variant)
    tokens, labels = _batch()
    with torch.no_grad():
        _, got = distill.distill_loss(_model("perturbed"), cfg, tc,
                                      torch.as_tensor(tokens),
                                      torch.as_tensor(labels))
    for k in ("loss", "kl", "ntp", "cap"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    if variant == "no_kl":
        assert float(got["kl"]) == 0.0
    if variant == "default":
        assert float(got["kl"]) > 0 and float(got["cap"]) > 0


@pytest.mark.parametrize("gates_mode", ["default", "perturbed"])
def test_gate_gradients_match_jax(gates_mode):
    """d distill_loss / d gates, leaf by leaf in the JAX layout."""
    _, want = _jax_loss_and_grads(gates_mode)
    _, cfg = _cfgs()
    _, tc = _train_cfgs("default")
    model = _model(gates_mode)
    gates = T.gate_parameters(model)
    for p in gates:
        p.requires_grad_(True)
    tokens, labels = _batch()
    loss, _ = distill.distill_loss(model, cfg, tc, torch.as_tensor(tokens),
                                   torch.as_tensor(labels))
    grads = torch.autograd.grad(loss, gates)
    with torch.no_grad():                    # gradients in the gates' place
        for p, g in zip(gates, grads):
            p.copy_(g)
    got = bridge.gates_to_jax(model, cfg)
    for name in ("b", "w1", "w2"):
        g = got["layers"][0][name]
        w = want["layers"][0][name]
        g, w = (g["w"], w["w"]) if name != "b" else (g, w)
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


def _opt_inputs(seed, poison=False):
    rng = np.random.RandomState(seed)
    shapes = [(128, 32), (32, 2), (2,)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    # norm ~ 30: the clip at 1.0 is active
    grads = [rng.randn(*s).astype(np.float32) for s in shapes]
    if poison:
        grads[1][3, 1] = np.inf
    return params, grads


@pytest.mark.parametrize("poison", [False, True])
def test_adamw_update_matches_jax(poison):
    """Two AdamW steps on identical gradients: the cosine schedule's
    warmup, bias correction, the active clip and, with an inf in the
    second step's gradient, the NaN-safe skip (gradients zeroed, the
    moments and weight decay still move the parameters)."""
    sched = dict(base_lr=2e-4, warmup=100, total=1000)
    jcfg = jadamw.AdamWConfig(lr=jadamw.cosine_schedule(**sched))
    tcfg = adamw.AdamWConfig(lr=adamw.cosine_schedule(**sched))
    params, _ = _opt_inputs(0)
    jp = [jnp.asarray(p) for p in params]
    tp = [torch.as_tensor(p) for p in params]
    js, ts = jadamw.init_opt_state(jp), adamw.init_opt_state(tp)
    j_update = jax.jit(functools.partial(jadamw.adamw_update, jcfg))
    for step in range(2):
        _, grads = _opt_inputs(1 + step, poison=poison and step == 1)
        jp, js, jm = j_update([jnp.asarray(g) for g in grads], js, jp)
        tp, ts, tm = adamw.adamw_update(tcfg, [torch.as_tensor(g)
                                               for g in grads], ts, tp)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6)
        for a, b in zip(ts["mu"] + ts["nu"], js["mu"] + js["nu"]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-9)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
    assert ts["step"] == int(js["step"]) == 2
    if poison:
        assert not np.isfinite(float(tm["grad_norm"]))
        assert all(torch.isfinite(p).all() for p in tp)


@functools.lru_cache(maxsize=None)
def _train_loops():
    """Three steps of each package's train_loop from the same weights,
    with the capacity term active; the port writes a gate checkpoint."""
    cfg_j, cfg = _cfgs()
    over = dict(capacity_M=CAP_M, seq_len=64, warmup_steps=1)
    data = dict(batch=2, seq_len=64)
    params, gates, _, _ = _weights("perturbed")
    j_state, j_hist = jax_train_loop(
        cfg_j, JTrainConfig(**over), JDataConfig(**data), steps=3,
        log_every=1, params=params, gate_params=gates, log_fn=lambda s: None)
    model = _model("perturbed")
    _, t_hist = train_loop(cfg, TrainConfig(**over), DataConfig(**data),
                           model=model, steps=3, log_every=1,
                           log_fn=lambda s: None)
    return (jax.device_get(j_state["gates"]), j_hist,
            bridge.gates_to_jax(model, cfg), t_hist)


def test_train_loop_matches_jax():
    j_gates, j_hist, t_gates, t_hist = _train_loops()
    assert [m["step"] for m in t_hist] == [m["step"] for m in j_hist] \
        == [0, 1, 2]
    for tm, jm in zip(t_hist, j_hist):
        for k in ("loss", "kl", "ntp", "cap", "grad_norm", "lr"):
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, atol=1e-8,
                                       err_msg=k)
    _, _, _, start = _weights("perturbed")
    moved = 0.0
    for got, want, first in zip(jax.tree.leaves(t_gates),
                                jax.tree.leaves(j_gates),
                                jax.tree.leaves(start)):
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-4)
        moved = max(moved, float(np.abs(got - first).max()))
    assert moved > 1e-5                      # the gates did train


def test_gate_checkpoints_cross_restore(tmp_path):
    """A checkpoint the port writes restores in the JAX package, and
    the reverse, leaf for leaf."""
    _, cfg = _cfgs()
    _, _, np_params, np_gates = _weights("perturbed")
    model = _model("perturbed")
    t_tree = bridge.gates_to_jax(model, cfg)
    ckpt.save(str(tmp_path / "port"), t_tree, step=3)
    got = jckpt.restore(str(tmp_path / "port"), np_gates)
    assert jckpt.latest_step(str(tmp_path / "port")) == 3
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(np_gates)):
        np.testing.assert_array_equal(np.asarray(a), b)

    j_gates = jax.tree.map(lambda a: a * 2.0, np_gates)
    jckpt.save(str(tmp_path / "jax"), j_gates, step=5)
    restored = ckpt.restore(str(tmp_path / "jax"), t_tree)
    assert ckpt.latest_step(str(tmp_path / "jax")) == 5
    bridge.gates_from_jax(restored, cfg, model)
    for a, b in zip(jax.tree.leaves(bridge.gates_to_jax(model, cfg)),
                    jax.tree.leaves(j_gates)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_chunked_attention_matches_jax():
    """Values and gradients in q and log_beta against the JAX package's
    chunked_attention (retention bias and a window of 24, so kv blocks
    are skipped on both sides of the band) at blocks of 32 over T = 70."""
    rng = np.random.RandomState(8)
    q, k, v, lb = _attn_inputs(rng)
    kw = dict(window=24, q_block=32, kv_block=32)

    def jf(q_, lb_):
        out = jcommon.chunked_attention(q_, jnp.asarray(k), jnp.asarray(v),
                                        log_beta=lb_, **kw)
        return jnp.sum(out * jnp.cos(out)), out

    (_, want), (gq_j, glb_j) = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True))(jnp.asarray(q), jnp.asarray(lb))
    qt = torch.as_tensor(q).requires_grad_(True)
    lbt = torch.as_tensor(lb).requires_grad_(True)
    out = common.chunked_attention(qt, torch.as_tensor(k), torch.as_tensor(v),
                                   log_beta=lbt, **kw)
    gq, glb = torch.autograd.grad((out * torch.cos(out)).sum(), (qt, lbt))
    tol = dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(gq.numpy(), np.asarray(gq_j), **tol)
    np.testing.assert_allclose(glb.numpy(), np.asarray(glb_j), **tol)


def _attn_inputs(rng):
    B, T_, Hq, Hkv, D = 2, 70, 4, 2, 32
    q = rng.randn(B, T_, Hq, D).astype(np.float32)
    k = rng.randn(B, T_, Hkv, D).astype(np.float32)
    v = rng.randn(B, T_, Hkv, D).astype(np.float32)
    lb = (-np.abs(rng.randn(B, T_, Hkv)) * 0.05).astype(np.float32)
    return q, k, v, lb


@pytest.mark.parametrize("use_beta,window", [(False, 0), (True, 0),
                                             (False, 24), (True, 24)])
def test_chunked_attention_matches_full_reference(use_beta, window):
    """The blocked online softmax against the port's O(T^2) oracle."""
    q, k, v, lb = (torch.as_tensor(a) for a in _attn_inputs(
        np.random.RandomState(9)))
    lb = lb if use_beta else None
    got = common.chunked_attention(q, k, v, log_beta=lb, window=window,
                                   q_block=32, kv_block=32)
    want = common.full_attention_ref(q, k, v, log_beta=lb, window=window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)
