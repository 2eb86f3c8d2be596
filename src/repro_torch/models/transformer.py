"""The dense stack: init, logits, decode state, single-shot and chunked
prefill, decode, sampling, the token loops and the training forward.

Ported from ``repro/models/transformer.py`` (dense path). The model is
a ``Transformer`` module holding its blocks in order; the JAX package's
scans over layers and tokens become Python loops. The decode state is
{"t": [B] int32 per-lane clock, "layers": [one slot cache per layer]};
``bridge.state_to_numpy`` gives it the JAX package's layout. Decode
updates the caches in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import blocks
from repro_torch.models.common import (RMSNorm, checkpointed, dense,
                                       resolve_device, rmsnorm_apply,
                                       to_dtype)


class Transformer(nn.Module):
    """Embedding, the blocks (each with its retention gate once
    init_gate_params ran), final norm and unembedding."""

    def __init__(self, cfg, *, device, generator):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported to repro_torch yet; "
                f"only 'dense' is")
        dtype = to_dtype(cfg.dtype)
        Vp = cfg.padded_vocab
        embed = torch.empty((Vp, cfg.d_model), dtype=torch.float32,
                            device=device)
        embed.normal_(0.0, 1.0, generator=generator)
        self.embed = nn.Parameter((embed * 0.02).to(dtype))
        self.final_norm = RMSNorm(cfg.d_model, device=device)
        self.unembed = dense(cfg.d_model, Vp, dtype=dtype, device=device,
                             generator=generator)
        self.layers = nn.ModuleList(
            blocks.init_block(cfg, kind, device=device, generator=generator)
            for kind in cfg.layer_kinds())

    @property
    def device(self) -> torch.device:
        return self.embed.device


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def init_params(cfg, *, seed: int = 0, device="cuda") -> Transformer:
    """Random weights from ``seed`` (a torch.Generator on ``device``),
    scaled as the JAX package's init_params. Inference only: no
    parameter requires grad."""
    device = resolve_device(device)
    model = Transformer(cfg, device=device,
                        generator=_generator(seed, device))
    return model.requires_grad_(False)


def init_gate_params(model: Transformer, cfg, *, seed: int = 1):
    """Attach a retention gate to every block that owns a KV cache
    (bias gate_bias_init, so beta ~= 1). Returns the model."""
    g = _generator(seed, model.device)
    for block in model.layers:
        gate = blocks.init_block_gate(cfg, block.kind, device=model.device,
                                      generator=g)
        if gate is not None:
            block.gate = gate.requires_grad_(False)
    return model


def num_gate_layers(cfg) -> int:
    return sum(1 for k in cfg.layer_kinds()
               if cfg.trimkv and k in ("global", "local", "cross"))


def gate_parameters(model: Transformer):
    """The retention gates' parameters, in layer order: what training
    updates (the base stays frozen)."""
    return [p for block in model.layers if block.gate is not None
            for p in block.gate.parameters()]


def compute_logits(model: Transformer, cfg, hidden):
    """[..., d] -> [..., Vp] float32, padded-vocab columns at -1e30."""
    logits = F.linear(hidden, model.unembed.weight).float()
    mask = torch.arange(cfg.padded_vocab, device=logits.device) \
        < cfg.vocab_size
    return torch.where(mask, logits, torch.full_like(logits, -1e30))


def init_decode_state(cfg, batch: int, budget: int, device):
    dtype = to_dtype(cfg.dtype)
    return {
        "t": torch.zeros((batch,), dtype=torch.int32, device=device),
        "layers": [blocks.init_block_state(cfg, kind, batch, budget, dtype,
                                           device)
                   for kind in cfg.layer_kinds()],
    }


def _embed(model, tokens):
    return F.embedding(torch.as_tensor(tokens, device=model.device).long(),
                       model.embed)


def prefill(model: Transformer, cfg, tokens, state, policy, serve_cfg):
    """Single-shot prefill of tokens [B, T] into a fresh ``state``.
    Returns (state, last_hidden [B, d])."""
    h = _embed(model, tokens)
    B, T = h.shape[:2]
    layers = []
    for block, st in zip(model.layers, state["layers"]):
        h, ns, _ = blocks.apply_block_prefill(
            block, cfg, h, st, policy=policy, budget=serve_cfg.budget,
            obs_window=serve_cfg.obs_window)
        layers.append(ns)
    h = rmsnorm_apply(model.final_norm.scale, h, cfg.norm_eps)
    t = torch.full((B,), T, dtype=torch.int32, device=h.device)
    return {"t": t, "layers": layers}, h[:, -1]


def _prefill_chunk_step(model: Transformer, cfg, tokens, state, policy,
                        serve_cfg, n_valid=None):
    """One chunk of chunked prefill: embed -> per-layer chunk attention
    + top-M merge -> final norm. tokens: [B, C]; n_valid: real tokens
    (None = all C). Returns (state, h_last [B, d] of the last real
    token)."""
    h = _embed(model, tokens)
    C = h.shape[1]
    t0 = state["t"]
    layers = []
    for block, st in zip(model.layers, state["layers"]):
        h, ns, _ = blocks.apply_block_prefill_chunk(
            block, cfg, h, st, t0, policy=policy,
            obs_window=serve_cfg.obs_window, n_valid=n_valid)
        layers.append(ns)
    h = rmsnorm_apply(model.final_norm.scale, h, cfg.norm_eps)
    nv = C if n_valid is None else int(n_valid)
    return {"t": t0 + nv, "layers": layers}, h[:, nv - 1]


def prefill_chunk_loop(model: Transformer, cfg, chunks, n_valid, state,
                       policy, serve_cfg):
    """Chunked prefill as a loop over chunks [n_chunks, B, C] with
    real-token counts n_valid [n_chunks] (C except the padded tail).
    Returns (state, h_last [B, d])."""
    h_last = None
    for tokens, nv in zip(chunks, n_valid):
        state, h_last = _prefill_chunk_step(model, cfg, tokens, state,
                                            policy, serve_cfg,
                                            n_valid=int(nv))
    return state, h_last


def decode_step(model: Transformer, cfg, state, token, policy):
    """token: [B]. Returns (state, logits [B, Vp] float32); the caches
    in ``state`` are updated in place and the clock advances by one."""
    x = _embed(model, token)
    t = state["t"]
    layers = []
    for block, st in zip(model.layers, state["layers"]):
        x, ns, _ = blocks.apply_block_decode(block, cfg, x, st, t,
                                             policy=policy)
        layers.append(ns)
    x = rmsnorm_apply(model.final_norm.scale, x, cfg.norm_eps)
    return {"t": t + 1, "layers": layers}, compute_logits(model, cfg, x)


def sample_token(logits, *, greedy: bool, temperature: float,
                 generator=None):
    """logits [B, Vp] -> token [B] (int64). Greedy argmax (the first
    maximum), or a temperature draw from ``generator``."""
    if greedy or temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def decode_loop(model: Transformer, cfg, state, first_token, n_steps: int,
                policy, *, greedy=True, temperature=0.0, generator=None):
    """n_steps of emit -> decode -> sample. first_token [B] (from the
    prefill logits) is emitted first. Returns (state, ids [B, n_steps],
    the last step's logits [B, Vp])."""
    tok = first_token
    out = []
    logits = None
    for _ in range(n_steps):
        out.append(tok)
        state, logits = decode_step(model, cfg, state, tok, policy)
        tok = sample_token(logits, greedy=greedy, temperature=temperature,
                           generator=generator)
    return state, torch.stack(out, dim=1), logits


def teacher_force_loop(model: Transformer, cfg, state, tokens, policy):
    """Feed gold tokens [B, L] through decode. Returns (state, preds
    [B, L]); preds[:, i] is the argmax after consuming tokens[:, i]."""
    tokens = torch.as_tensor(tokens, device=model.device)
    preds = []
    for i in range(tokens.shape[1]):
        state, logits = decode_step(model, cfg, state, tokens[:, i], policy)
        preds.append(torch.argmax(logits, dim=-1))
    return state, torch.stack(preds, dim=1)


def forward_train(model: Transformer, cfg, tokens, *, gated=False,
                  cap_M=None, remat=False):
    """tokens: [B, T] -> (hidden [B, T, d], aux).

    aux = {"cap": summed per-layer capacity losses, "n_gate_layers":
    python int}. When ``gated``, attention uses the retention bias
    (student); otherwise vanilla attention (teacher). ``remat`` runs
    each block under ``torch.utils.checkpoint`` (non-reentrant), keeping
    only the residual stream between blocks; backward recomputes the
    block, its L_cap forward included. Without autograd (the teacher
    under ``torch.no_grad``) nothing is checkpointed."""
    h = _embed(model, tokens)
    cap_total = torch.zeros((), dtype=torch.float32, device=h.device)

    def body(block, h):
        return blocks.apply_block_train(block, cfg, h, gated=gated,
                                        cap_M=cap_M)

    for block in model.layers:
        h, cap = checkpointed(body, block, h) if remat else body(block, h)
        cap_total = cap_total + cap
    h = rmsnorm_apply(model.final_norm.scale, h, cfg.norm_eps)
    return h, {"cap": cap_total, "n_gate_layers": num_gate_layers(cfg)}
