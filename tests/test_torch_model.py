"""The port's dense stack and engine against the JAX package's, on the
smoke config of trimkv-paper-4b (2 layers, d_model 128, float32) with
the JAX package's own weights loaded through repro_torch.bridge.

The JAX side runs its Pallas kernels in interpret mode
(attn_impl="pallas"); the port runs the plain PyTorch versions. Floats
(logits, hidden states, cached k/v/beta) must agree within 1e-4
absolute and relative — every layer adds float32 rounding in another
summation order; discrete outcomes (greedy ids, every layer's slot
positions) must be identical. Both under the default gates, where
beta is exactly 1.0 and every TRIM-KV score ties, and under perturbed
gate biases b ~ U(2, 8) per (layer, kv head), where beta spreads and
eviction is decided by the scores.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _jax_weights as jax_weights
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.policies import TrimKV as JTrimKV
from repro.models import transformer as JT
from repro.serve.engine import build_engine as jax_build_engine
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.core.policies import TrimKV
from repro_torch.data.synthetic import make_batch
from repro_torch.models import transformer as T
from repro_torch.serve.engine import build_engine

ARCH = "trimkv-paper-4b"
TOL = dict(atol=1e-4, rtol=1e-4)
BUDGET = 32


@functools.lru_cache(maxsize=None)
def _models(gates_mode):
    """(jax params, jax gates, port model) with identical weights."""
    cfg_j = jax_smoke_config(ARCH)
    params = jax_weights.init_params(cfg_j)
    gates = jax_weights.init_gate_params(cfg_j)
    np_params, np_gates = jax.device_get(params), jax.device_get(gates)
    if gates_mode == "perturbed":
        g0 = dict(np_gates["layers"][0])
        rng = np.random.RandomState(7)
        g0["b"] = rng.uniform(2.0, 8.0, g0["b"].shape).astype(np.float32)
        np_gates = {"layers": (g0,), "tail": np_gates["tail"]}
        gates = jax.tree.map(jnp.asarray, np_gates)
    cfg = get_smoke_config(ARCH)
    model = bridge.params_from_jax(np_params, cfg, device="cpu")
    bridge.gates_from_jax(np_gates, cfg, model)
    return params, gates, model


def _tokens(B, Tn, seed=0):
    return make_batch("copy", seed, B, Tn, get_smoke_config(ARCH).vocab_size)


@functools.lru_cache(maxsize=None)
def _jax_engine(gates_mode, **kw):
    """One JAX engine per (gates, serve fields): the cases that share
    one share its compiled closures."""
    params, gates, _ = _models(gates_mode)
    return jax_build_engine(jax_smoke_config(ARCH), params, gates,
                            budget=BUDGET, attn_impl="pallas", **kw)


def _engines(gates_mode, **kw):
    _, _, model = _models(gates_mode)
    te = build_engine(get_smoke_config(ARCH), model, device="cpu",
                      budget=BUDGET, **kw)
    return _jax_engine(gates_mode, **kw), te


def _assert_states(got, want):
    """got: port state; want: JAX state (device arrays)."""
    g = bridge.state_to_numpy(got, get_smoke_config(ARCH))
    w = jax.device_get(want)
    np.testing.assert_array_equal(g["t"], w["t"])
    for gl, wl in zip(g["layers"], w["layers"]):
        np.testing.assert_array_equal(gl["pos"], wl["pos"], err_msg="pos")
        for name in ("k", "v", "beta", "aux"):
            np.testing.assert_allclose(gl[name], wl[name], err_msg=name,
                                       **TOL)
    assert g["tail"] == () and w["tail"] == ()


def test_default_gates_give_beta_exactly_one():
    """sigmoid(18 + small) rounds to 1.0 in float32 on both sides, so
    every TRIM-KV keep score ties under the default gates."""
    from repro_torch.core.gates import gate_beta
    _, _, model = _models("default")
    x = torch.as_tensor(np.random.RandomState(0).randn(64, 128),
                        dtype=torch.float32)
    for block in model.layers:
        assert (gate_beta(block.gate, x) == 1.0).all()


@pytest.mark.parametrize("gates_mode", ["default", "perturbed"])
@pytest.mark.parametrize("chunked", [False, True])
def test_prefill_matches_jax(gates_mode, chunked):
    """Single-shot prefill, and chunked prefill of a 70-token prompt in
    chunks of 16 (the last one padded): last hidden state and the
    whole state after the prompt is compressed to the 32-slot budget."""
    je, te = _engines(gates_mode, prefill_chunk=16)
    tokens, _, _ = _tokens(2, 70)
    js, jh = je.prefill(tokens, chunked=chunked)
    ts, th = te.prefill(tokens, chunked=chunked)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    _assert_states(ts, js)


@pytest.mark.parametrize("gates_mode", ["default", "perturbed"])
def test_decode_step_matches_jax(gates_mode):
    """Four decode steps from the same prefilled state: logits and the
    whole state (evictions included) after every step."""
    params, gates, model = _models(gates_mode)
    cfg_j, cfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    je, te = _engines(gates_mode)
    tokens, _, _ = _tokens(2, 40, seed=1)
    js, _ = je.prefill(tokens)
    ts, _ = te.prefill(tokens)
    step = jax.jit(lambda s, tok: JT.decode_step(
        params, gates, cfg_j, s, tok, JTrimKV(), attn_impl="pallas"))
    for i in range(4):
        tok = tokens[:, i]
        js, jl = step(js, jnp.asarray(tok))
        ts, tl = T.decode_step(model, cfg, ts, torch.as_tensor(tok),
                               TrimKV())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _assert_states(ts, js)


@pytest.mark.parametrize("gates_mode", ["default", "perturbed"])
@pytest.mark.parametrize("chunked", [False, True])
def test_generate_greedy_ids_match_jax(gates_mode, chunked):
    """Engine.generate: 16 greedy tokens identical to the JAX engine's,
    with the 70-token prompt evicted down to 32 slots."""
    je, te = _engines(gates_mode, prefill_chunk=16)
    tokens, _, _ = _tokens(2, 70, seed=2)
    want = je.generate(tokens, 16, chunked=chunked)["ids"]
    got = te.generate(tokens, 16, chunked=chunked)["ids"]
    np.testing.assert_array_equal(got, want)


def test_teacher_forced_accuracy_matches_jax():
    je, te = _engines("perturbed")
    tokens, labels, _ = _tokens(2, 64, seed=3)
    want = je.teacher_forced_accuracy(tokens, labels)
    assert te.teacher_forced_accuracy(tokens, labels) == want


def test_probs_to_kv_matches_jax():
    """The GQA fold of per-q-head probabilities to kv heads."""
    from repro.models.blocks import _probs_to_kv as jax_fold
    from repro_torch.models.blocks import _probs_to_kv

    p = np.random.RandomState(4).rand(2, 4, 40).astype(np.float32)
    np.testing.assert_allclose(
        _probs_to_kv(torch.as_tensor(p), get_smoke_config(ARCH)).numpy(),
        np.asarray(jax_fold(jnp.asarray(p), jax_smoke_config(ARCH))), **TOL)


def test_gates_match_jax():
    """beta and log beta of the perturbed gates, from the same input."""
    from repro.core import gates as jgates
    from repro_torch.core import gates as tgates

    _, gates, model = _models("perturbed")
    x = np.random.RandomState(5).randn(3, 7, 128).astype(np.float32)
    g_j = jax.tree.map(lambda a: a[0], gates["layers"][0])
    g_t = model.layers[0].gate
    for jf, tf in ((jgates.gate_beta, tgates.gate_beta),
                   (jgates.gate_log_beta, tgates.gate_log_beta)):
        np.testing.assert_allclose(tf(g_t, torch.as_tensor(x)).numpy(),
                                   np.asarray(jf(g_j, jnp.asarray(x))), **TOL)
