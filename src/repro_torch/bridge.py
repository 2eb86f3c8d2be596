"""Load the JAX package's weights into the port, give the port's
retention gates and decode state the JAX package's layout.

The JAX pytrees arrive as numpy arrays (the caller runs
``jax.device_get``); this module imports no JAX. In those trees the
``layers`` leaves carry a leading repeat axis R over a tuple of the U
kinds of ``cfg.attn_pattern`` (layer r * U + u), and the ``tail`` tuple
holds the num_layers % U layers after them. Dense weights are
[in, out] there and [out, in] in ``nn.Linear``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.gates import Gate
from repro_torch.models.common import resolve_device
from repro_torch.models.transformer import Transformer


def _unit_and_counts(cfg):
    unit = cfg.attn_pattern
    U = len(unit)
    return U, cfg.num_layers // U, tuple(unit[: cfg.num_layers % U])


def _tree_map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _per_layer(tree, cfg):
    """Per-layer subtrees of a params or gates tree, in layer order."""
    U, R, tail = _unit_and_counts(cfg)
    out = []
    for r in range(R):
        for u in range(U):
            out.append(_tree_map(lambda a: a[r], tree["layers"][u]))
    out.extend(tree["tail"])
    return out


def _copy(dst, src, transpose=False):
    a = torch.as_tensor(np.array(src, dtype=np.float32))
    dst.copy_((a.T if transpose else a).to(dst.dtype))


def _copy_dense(lin, p):
    _copy(lin.weight, p["w"], transpose=True)
    if "b" in p:
        _copy(lin.bias, p["b"])


@torch.no_grad()
def params_from_jax(np_tree, cfg, *, device="cuda") -> Transformer:
    """A Transformer holding the weights of ``T.init_params``' tree."""
    device = resolve_device(device)
    g = torch.Generator(device=device)
    model = Transformer(cfg, device=device, generator=g)
    _copy(model.embed, np_tree["embed"])
    _copy(model.final_norm.scale, np_tree["final_norm"]["scale"])
    _copy_dense(model.unembed, np_tree["unembed"])
    for block, p in zip(model.layers, _per_layer(np_tree, cfg)):
        _copy(block.norm1.scale, p["norm1"]["scale"])
        _copy(block.norm2.scale, p["norm2"]["scale"])
        for name in ("wq", "wk", "wv", "wo"):
            _copy_dense(getattr(block.attn, name), p["attn"][name])
        for name in ("gate", "up", "down"):
            _copy_dense(getattr(block.ffn, name), p["ffn"][name])
    return model.requires_grad_(False)


@torch.no_grad()
def gates_from_jax(np_gates, cfg, model: Transformer) -> Transformer:
    """Attach the retention gates of ``T.init_gate_params``' tree to the
    model's blocks (None where a layer has no gate)."""
    dev = model.device
    g = torch.Generator(device=dev)
    for block, p in zip(model.layers, _per_layer(np_gates, cfg)):
        if p is None:
            block.gate = None
            continue
        gate = Gate(cfg.d_model, cfg.gate_hidden, cfg.num_kv_heads,
                    cfg.gate_bias_init, device=dev, generator=g)
        _copy_dense(gate.w1, p["w1"])
        _copy_dense(gate.w2, p["w2"])
        _copy(gate.b, p["b"])
        block.gate = gate.requires_grad_(False)
    return model


def _stack_layers(per_layer, cfg):
    """Per-layer numpy subtrees -> the JAX layout: ``layers`` a tuple of
    U subtrees with leaves stacked on a leading R axis (None when
    R = 0), ``tail`` a tuple of the num_layers % U layers after them."""
    U, R, _ = _unit_and_counts(cfg)
    layers = None
    if R > 0:
        layers = tuple(
            _stack([per_layer[r * U + u] for r in range(R)])
            for u in range(U))
    return {"layers": layers, "tail": tuple(per_layer[R * U:])}


def _stack(trees):
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return np.stack(trees)


def _dense_to_numpy(lin):
    p = {"w": lin.weight.detach().float().cpu().numpy().T.copy()}
    if lin.bias is not None:
        p["b"] = lin.bias.detach().float().cpu().numpy()
    return p


def gates_to_jax(model: Transformer, cfg):
    """The model's retention gates as numpy leaves in the layout of
    ``T.init_gate_params``' tree (the inverse of ``gates_from_jax``):
    per layer {"w1": {"w": [d, hidden]}, "w2": {"w": [hidden, Hkv]},
    "b": [Hkv]}, None for a layer without a gate."""
    per_layer = [
        None if block.gate is None else {
            "w1": _dense_to_numpy(block.gate.w1),
            "w2": _dense_to_numpy(block.gate.w2),
            "b": block.gate.b.detach().float().cpu().numpy()}
        for block in model.layers]
    return _stack_layers(per_layer, cfg)


def state_to_numpy(state, cfg):
    """The port's decode state in the JAX package's layout: ``t`` [B],
    ``layers`` a tuple of U dicts with leaves [R, B, ...] (None when
    R = 0), ``tail`` a tuple of per-layer dicts. bfloat16 leaves come
    back as float32 (numpy has no bfloat16)."""

    def host_leaf(v):
        v = v.detach().cpu()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()

    host = [{k: host_leaf(v) for k, v in st.items()}
            for st in state["layers"]]
    return {"t": state["t"].cpu().numpy(), **_stack_layers(host, cfg)}
