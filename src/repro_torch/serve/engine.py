"""Batched serving engine: prefill (single-shot or chunked) + decode
under the TRIM-KV policy over the bounded KV cache.

Ported from ``repro/serve/engine.py`` (``Engine.prefill``,
``generate``, ``teacher_forced_accuracy``, ``build_engine``) for the
dense family. PyTorch runs eagerly, so the JAX package's fused scans
are Python loops here; on the card the attention runs through the
hand-written CUDA kernels (``kernels.ops``). There are no lane
closures, no mesh and no prefix cache yet.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.configs import ServeConfig
from repro_torch.core.policies import make_policy
from repro_torch.models import transformer as T
from repro_torch.models.common import resolve_device


class Engine:
    def __init__(self, cfg, model: T.Transformer, serve_cfg: ServeConfig,
                 *, device="cuda"):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"the repro_torch engine serves the dense family only, "
                f"got {cfg.family!r}")
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"model lives on {model.device}, engine runs "
                             f"on {self.device}")
        self.cfg = cfg
        self.model = model
        self.serve = serve_cfg
        self.policy = make_policy(serve_cfg)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def fresh_state(self, batch: int):
        return T.init_decode_state(self.cfg, batch, self.serve.budget,
                                   self.model.device)

    def _first_token(self, h_last):
        """Greedy token from the prefill's last hidden state [B, d]."""
        return torch.argmax(T.compute_logits(self.model, self.cfg, h_last),
                            dim=-1)

    @torch.no_grad()
    def prefill(self, tokens, chunked: bool = False):
        """tokens: [B, T] (numpy or tensor). Returns (state, last_hidden).

        Chunked: the prompt is padded up to whole prefill_chunk-sized
        chunks and the tail chunk's padding is masked (n_valid), as the
        JAX engine does; chunked=True always runs the chunk pipeline,
        even for a prompt within one chunk."""
        tokens = torch.as_tensor(tokens, device=self.model.device)
        B, Tn = tokens.shape
        state = self.fresh_state(B)
        if not chunked:
            return T.prefill(self.model, self.cfg, tokens, state,
                             self.policy, self.serve)
        C = self.serve.prefill_chunk
        n_chunks = -(-Tn // C)
        pad = n_chunks * C - Tn
        if pad:
            tokens = torch.nn.functional.pad(tokens, (0, pad))
        n_valid = [C] * n_chunks
        n_valid[-1] = C - pad
        chunks = tokens.reshape(B, n_chunks, C).transpose(0, 1)
        return T.prefill_chunk_loop(self.model, self.cfg, chunks, n_valid,
                                    state, self.policy, self.serve)

    @torch.no_grad()
    def generate(self, tokens, max_new: int, chunked: bool = False,
                 greedy: bool = True, seed: int = 0):
        """Prefill, then max_new decode steps. Returns a dict with ids
        [B, max_new] (numpy), the last step's logits [B, Vp] (a tensor
        on the engine's device), prefill_sec and decode_sec (host clock
        around work that ends in a device synchronize) and the token
        rates."""
        tokens = torch.as_tensor(tokens, device=self.model.device)
        B, Tn = tokens.shape
        self._sync()
        t0 = time.perf_counter()
        state, h_last = self.prefill(tokens, chunked)
        first = self._first_token(h_last)
        self._sync()
        t1 = time.perf_counter()
        gen = torch.Generator(device=self.model.device)
        gen.manual_seed(seed)
        greedy = greedy or self.serve.temperature == 0.0
        state, ids, logits = T.decode_loop(self.model, self.cfg, state, first,
                                   max_new, self.policy, greedy=greedy,
                                   temperature=self.serve.temperature,
                                   generator=gen)
        ids = ids.cpu().numpy()
        t2 = time.perf_counter()
        prefill_sec, decode_sec = t1 - t0, t2 - t1
        return {"ids": ids, "logits": logits, "prefill_sec": prefill_sec,
                "decode_sec": decode_sec,
                "prefill_tok_per_sec": B * Tn / max(prefill_sec, 1e-9),
                "tok_per_sec": ids.size / max(decode_sec, 1e-9)}

    @torch.no_grad()
    def teacher_forced_accuracy(self, tokens, labels, chunked: bool = False):
        """Feed gold tokens; argmax-match rate on positions where
        labels >= 0. tokens/labels: [B, T]."""
        tokens = np.asarray(tokens)
        labels = np.asarray(labels)
        Tn = tokens.shape[1]
        first_label = int(np.min(np.where(labels >= 0)[1]))
        prefix_len = max(first_label, 1)
        state, h_last = self.prefill(tokens[:, :prefix_len], chunked)
        preds0 = self._first_token(h_last)[:, None]
        if prefix_len < Tn:
            state, preds = T.teacher_force_loop(
                self.model, self.cfg, state, tokens[:, prefix_len:],
                self.policy)
            preds = torch.cat([preds0, preds], dim=1)
        else:
            preds = preds0
        preds = preds.cpu().numpy()
        labs = labels[:, prefix_len - 1:]
        sel = labs >= 0
        correct = int((preds[sel] == labs[sel]).sum())
        return correct / max(int(sel.sum()), 1)


def build_engine(cfg, model, *, device="cuda", **serve_kwargs) -> Engine:
    return Engine(cfg, model, ServeConfig(**serve_kwargs), device=device)
