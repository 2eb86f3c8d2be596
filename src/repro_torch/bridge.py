"""Load the JAX package's weights into the port, give the port's
retention gates and decode state the JAX package's layout.

The JAX pytrees arrive as numpy arrays (the caller runs
``jax.device_get``); this module imports no JAX. In those trees the
``layers`` leaves carry a leading repeat axis R over a tuple of the U
kinds of ``cfg.attn_pattern`` (layer r * U + u), and the ``tail`` tuple
holds the num_layers % U layers after them. Dense weights are
[in, out] there and [out, in] in ``nn.Linear``. The cross families add
``vis_proj`` (vlm) or ``encoder`` ({"layers": a 1-tuple of global
blocks stacked over encoder_layers, "final_norm"}, encdec), and a cross
block's ``normx``, ``xattn`` and ``xgate``. An MoE block's ``ffn`` is
{"router": {"w": [d, E]}, "gate_w", "up_w": [E, d, f], "down_w":
[E, f, d]}, the port's layout too (nothing is transposed). A cross
layer's memory slab is [B, S, Hkv, D] in the JAX decode state and
[B, Hkv, S, D] in the port's. A recurrent block (hybrid family) holds
in_x, in_gate, lru_wa, lru_wx and out as dense layers, conv_w
[conv_width, W], conv_b and the float32 lru_lam as they are, and no
gate (its gates subtree is None); its state {h, conv} has one layout
in both. So does a mamba block's (ssm family: norm, in_proj, x_proj,
dt_proj with its bias and out_proj as dense layers, conv_w, conv_b and
the float32 A_log and D as they are; no gate in any layer).
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
        _copy_block(block, p)
    if model.vis_proj is not None:
        _copy_dense(model.vis_proj, np_tree["vis_proj"])
    if model.encoder is not None:
        enc = np_tree["encoder"]
        for i, block in enumerate(model.encoder):
            _copy_block(block, _tree_map(lambda a: a[i], enc["layers"][0]))
        _copy(model.encoder_norm.scale, enc["final_norm"]["scale"])
    return model.requires_grad_(False)


def _copy_block(block, p):
    if block.kind == "mamba":
        _copy(block.norm.scale, p["norm"]["scale"])
        for name in ("in_proj", "x_proj", "dt_proj", "out_proj"):
            _copy_dense(getattr(block, name), p[name])
        for name in ("conv_w", "conv_b", "A_log", "D"):
            _copy(getattr(block, name), p[name])
        return
    _copy(block.norm1.scale, p["norm1"]["scale"])
    _copy(block.norm2.scale, p["norm2"]["scale"])
    if block.kind == "recurrent":
        for name in ("in_x", "in_gate", "lru_wa", "lru_wx", "out"):
            _copy_dense(getattr(block, name), p[name])
        for name in ("conv_w", "conv_b", "lru_lam"):
            _copy(getattr(block, name), p[name])
        for name in ("gate", "up", "down"):
            _copy_dense(getattr(block.ffn, name), p["ffn"][name])
        return
    for name in ("wq", "wk", "wv", "wo"):
        _copy_dense(getattr(block.attn, name), p["attn"][name])
    if "router" in p["ffn"]:
        _copy(block.ffn.router, p["ffn"]["router"]["w"])
        for name in ("gate_w", "up_w", "down_w"):
            _copy(getattr(block.ffn, name), p["ffn"][name])
    else:
        for name in ("gate", "up", "down"):
            _copy_dense(getattr(block.ffn, name), p["ffn"][name])
    if block.kind == "cross":
        _copy(block.normx.scale, p["normx"]["scale"])
        for name in ("wq", "wk", "wv", "wo"):
            _copy_dense(getattr(block.xattn, name), p["xattn"][name])
        _copy(block.xgate, p["xgate"])


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
    R = 0), ``tail`` a tuple of per-layer dicts; a cross layer is
    {"cache": its slot cache, "xk", "xv": [B, S, Hkv, D], "mem_len"}.
    bfloat16 leaves come back as float32 (numpy has no bfloat16)."""

    def host_leaf(v):
        v = v.detach().cpu()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()

    def host_layer(st):
        out = {k: host_leaf(v) for k, v in st.items()}
        if "xk" not in out:
            return out
        mem = {k: out.pop(k) for k in ("xk", "xv", "mem_len")}
        return {"cache": out, "xk": mem["xk"].transpose(0, 2, 1, 3),
                "xv": mem["xv"].transpose(0, 2, 1, 3),
                "mem_len": mem["mem_len"]}

    host = [host_layer(st) for st in state["layers"]]
    return {"t": state["t"].cpu().numpy(), **_stack_layers(host, cfg)}
