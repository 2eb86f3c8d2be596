"""Batched serving engine: prefill (single-shot or chunked) + decode
under the TRIM-KV policy over the bounded KV cache.

Ported from ``repro/serve/engine.py`` (``Engine.prefill``,
``generate``, ``teacher_forced_accuracy``, ``lane_closures``,
``build_engine``) for the dense, moe, vlm and encdec families. On the
card the attention runs through the hand-written CUDA kernels
(``kernels.ops``). The moe family refuses ``spec_k`` > 0, as the JAX
engine does: expert capacity couples the rows of a call.

Cross-memory families (vlm, encdec) take each request's memory in
``extra_inputs`` ({mem_key: [B, S, feat], optionally "mem_len": [B]}),
as the JAX engine does: the one-shot paths adopt the request's own S
(the programs of a batch size are rebuilt when S changes), the
scheduler pads to
the family's ``mem_shape``. The memory is installed before the first
chunk (``LanePrograms.install_memory``, a captured program with the
encoder in it), and the prefix cache is bypassed for these families.

Step programs (``serve.graphs``): with ``serve_cfg.fused`` (the
default) chunked prefill, greedy decode and teacher forcing run their
steps as CUDA graphs on the card, one replay per chunk or token, where
the JAX package runs one scanned program; ``fused=False`` runs the
same steps as Python loops, the parity reference (the scheduler's lane
programs then run uncaptured: ``serve.graphs.LanePrograms`` without a
pool). Single-shot prefill
is one eager pass either way (the card is busy through it, and a graph
per prompt length would buy nothing). Sampled (temperature) decoding
replays the sampled decode program, which draws from a threefry key
chain seeded as ``jax.random.PRNGKey(seed)`` (core.prng), so a seed
gives the JAX package's tokens. On the CPU every step runs eagerly.

``dispatch_count`` counts what the JAX engine counts: one per
single-shot prefill, per fused chunked prefill (one per chunk when
eager), per fused decode loop (one per token when eager), per
teacher-forcing loop, and, through the scheduler, its lane dispatches.
``graphs.replays`` (on the card) counts the replays behind them.

The engine keeps one graph memory pool (``graphs.bytes``) and, per
batch size, the static decode state its programs run over: a fused
call's state is that buffer and stays valid until the next fused call
at the same batch size.

With ``serve_cfg.prefix_cache_bytes`` > 0 the engine owns the prefix
KV cache (``prefix_cache``, serve.prefix_cache), so successive
schedulers on one engine share one warm trie. The JAX engine's
``fresh_lane_row`` fills the rows of non-hit lanes in a lane-aligned
admission sub-state; the port installs only the hit lanes' slabs into
their lanes (``LanePrograms.admit`` / ``install``), as its resume moves
only the resumed lanes, so it needs no fresh row. Speculative decoding
(``serve_cfg.spec_k`` > 0) runs in the scheduler's lanes only, and
there only when greedy.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.configs import ServeConfig
from repro_torch.core import prng
from repro_torch.core.policies import make_policy
from repro_torch.models import transformer as T
from repro_torch.models.blocks import is_moe
from repro_torch.models.common import resolve_device
from repro_torch.serve.graphs import GraphPool, LanePrograms, copy_state
from repro_torch.serve.prefix_cache import PrefixCache


class Engine:
    def __init__(self, cfg, model: T.Transformer, serve_cfg: ServeConfig,
                 *, device="cuda"):
        if cfg.family not in T.FAMILIES:
            raise NotImplementedError(
                f"the repro_torch engine serves the families {T.FAMILIES}, "
                f"got {cfg.family!r}")
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"model lives on {model.device}, engine runs "
                             f"on {self.device}")
        if serve_cfg.spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {serve_cfg.spec_k}")
        if serve_cfg.spec_k > 0 and is_moe(cfg):
            raise ValueError(
                "spec_k > 0 is unsupported for the MoE family: expert "
                "capacity couples tokens across the verify chunk, so "
                "chunk-shaped scoring cannot be bit-identical per row")
        self.cfg = cfg
        self.model = model
        self.serve = serve_cfg
        self.policy = make_policy(serve_cfg)
        self.dispatch_count = 0
        # one graph pool for every program of this engine (None on the
        # CPU, where programs run eagerly)
        self.graphs = (GraphPool(self.model.device)
                       if self.device.type == "cuda" else None)
        self._batch_programs = {}
        self._lane_closures = {}
        # the prefix KV cache lives on the engine, so every scheduler on
        # it shares one warm trie
        self.prefix_cache = (
            PrefixCache(serve_cfg.prefix_cache_bytes,
                        ttl_sec=serve_cfg.prefix_ttl_sec)
            if serve_cfg.prefix_cache_bytes > 0 else None)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _fused(self, fused) -> bool:
        return self.serve.fused if fused is None else fused

    @property
    def mem_key(self):
        """The extra_inputs key of this family's cross-attention memory
        (None for a family without one)."""
        return T.MEM_KEYS.get(self.cfg.family)

    @property
    def mem_shape(self):
        """(S, feat) of one request's full-length memory: the shape the
        scheduler pads ragged memories to (None without memory)."""
        return T.memory_shape(self.cfg)

    def _slab_len(self, extra_inputs):
        """The slab length S of a one-shot call's memory (None without)."""
        if self.mem_key is None:
            return None
        if not extra_inputs or self.mem_key not in extra_inputs:
            raise ValueError(f"family {self.cfg.family!r} requires "
                             f"extra_inputs[{self.mem_key!r}]")
        return int(np.shape(extra_inputs[self.mem_key])[1])

    def _lane_programs(self, batch: int, pool, slab_len=None) -> LanePrograms:
        return LanePrograms(self.model, self.cfg, self.serve, self.policy,
                            self.fresh_state(batch, slab_len), pool)

    def _programs(self, batch: int, slab_len=None) -> LanePrograms:
        """The lock-step programs of this batch size, as captured graphs
        on the card (the fused path). One set is kept a batch size: a
        cross family's is built for one memory slab length S, and a call
        with another S releases it (its state, memory buffers and
        graphs) and builds the new S's."""
        if slab_len is None and self.mem_key is not None:
            slab_len = self.mem_shape[0]
        progs = self._batch_programs.get(batch)
        if progs is not None and progs.slab_len != slab_len:
            progs.release()
            progs = None
        if progs is None:
            progs = self._batch_programs[batch] = self._lane_programs(
                batch, self.graphs, slab_len)
        return progs

    def fresh_state(self, batch: int, slab_len=None):
        return T.init_decode_state(self.cfg, batch, self.serve.budget,
                                   self.model.device, slab_len=slab_len)

    def lane_closures(self, n_lanes: int) -> LanePrograms:
        """The continuous-batching programs of ``n_lanes`` lanes
        (serve.scheduler), greedy and sampled alike (the caller picks per
        dispatch), made once per engine and keyed by n_lanes, so that
        every Scheduler on it shares one set of graphs; a Scheduler
        resets their static state when it starts. Captured graphs when
        ``serve.fused`` on the card."""
        if n_lanes not in self._lane_closures:
            self._lane_closures[n_lanes] = self._lane_programs(
                n_lanes, self.graphs if self.serve.fused else None)
        return self._lane_closures[n_lanes]

    def _first_token(self, h_last):
        """Greedy token and its top-two margin from the prefill's last
        hidden state [B, d]."""
        logits = T.compute_logits(self.model, self.cfg, h_last)
        return torch.argmax(logits, dim=-1), T.top2_margin(logits)

    def _chunk_grid(self, tokens):
        """tokens [B, T] (device) padded to whole prefill_chunk-sized
        chunks: (chunks [n, B, C], n_valid [n, B] numpy; the tail chunk's
        padding masked)."""
        B, Tn = tokens.shape
        C = self.serve.prefill_chunk
        n_chunks = -(-Tn // C)
        pad = n_chunks * C - Tn
        if pad:
            tokens = torch.nn.functional.pad(tokens, (0, pad))
        n_valid = np.full((n_chunks, B), C, np.int32)
        n_valid[-1] = C - pad
        return tokens.reshape(B, n_chunks, C).transpose(0, 1), n_valid

    @torch.no_grad()
    def prefill(self, tokens, chunked: bool = False, fused=None,
                extra_inputs=None):
        """tokens: [B, T] (numpy or tensor); extra_inputs: a cross
        family's memory (see the module docstring). Returns (state,
        last_hidden).

        Chunked: the prompt is padded up to whole prefill_chunk-sized
        chunks and the tail chunk's padding is masked (n_valid), as the
        JAX engine does; chunked=True always runs the chunk pipeline,
        even for a prompt within one chunk. fused (default
        serve_cfg.fused): the chunk program's graph, replayed per chunk,
        into the engine's static state of this batch size; else the
        eager per-chunk loop into a fresh state."""
        tokens = torch.as_tensor(tokens, device=self.model.device)
        B, Tn = tokens.shape
        S = self._slab_len(extra_inputs)
        if not chunked:
            self.dispatch_count += 1
            return T.prefill(self.model, self.cfg, tokens,
                             self.fresh_state(B, S), self.policy, self.serve,
                             extra_inputs=extra_inputs)
        chunks, n_valid = self._chunk_grid(tokens)
        if self._fused(fused):
            progs = self._programs(B, S)
            progs.fresh()
            self.dispatch_count += 1
            if S is not None:
                mem_len = extra_inputs.get("mem_len", np.full(B, S))
                progs.install_memory(extra_inputs[self.mem_key], mem_len,
                                     np.ones(B, bool))
            h_last, _ = progs.prefill_chunks(chunks, n_valid)
            return progs.state, h_last.clone()
        self.dispatch_count += len(n_valid)
        return T.prefill_chunk_loop(self.model, self.cfg, chunks,
                                    n_valid[:, 0], self.fresh_state(B, S),
                                    self.policy, self.serve,
                                    extra_inputs=extra_inputs)

    @torch.no_grad()
    def generate(self, tokens, max_new: int, chunked: bool = False,
                 greedy: bool = True, seed: int = 0, fused=None,
                 extra_inputs=None):
        """Prefill, then max_new decode steps. Returns a dict with ids
        [B, max_new] (numpy), margins [B, max_new] (numpy: the top-two
        margin of the scores the step that chose each id took the argmax
        of: the logits, or under sampling logits / T plus gumbel noise),
        the final key [2] (numpy; the seed's own key when greedy), the
        last step's logits [B, Vp] and the final state (tensors on the
        engine's device), prefill_sec and decode_sec (host clock around work that
        ends in a device synchronize) and the token rates. The first
        token is the prefill's greedy token; with ``greedy`` False (and
        serve.temperature > 0) every later one is drawn from the key
        chain of ``seed``: one split per step, one categorical draw over
        the whole [B, Vp] logits. fused (default serve_cfg.fused): the
        decode program's graph (greedy or sampled) replays per token;
        fused=False runs the eager loop. extra_inputs: a cross family's
        memory (see the module docstring)."""
        fused = self._fused(fused)
        tokens = torch.as_tensor(tokens, device=self.model.device)
        B, Tn = tokens.shape
        self._sync()
        t0 = time.perf_counter()
        state, h_last = self.prefill(tokens, chunked, fused=fused,
                                     extra_inputs=extra_inputs)
        tok, margin0 = self._first_token(h_last)
        self._sync()
        t1 = time.perf_counter()
        greedy = greedy or self.serve.temperature == 0.0
        key = prng.prng_key(seed, device=self.model.device)
        if fused:
            progs = self._programs(B, self._slab_len(extra_inputs))
            if state is not progs.state:         # single-shot prefill
                copy_state(progs.state, state)
            progs.key.copy_(key)
            self.dispatch_count += 1
            outs, margins, logits = [], [margin0], None
            for _ in range(max_new):
                outs.append(tok.clone())
                tok, margin, logits = progs.decode(tok, sampled=not greedy)
                margins.append(margin.clone())
            state, ids = progs.state, torch.stack(outs, dim=1)
            margins = torch.stack(margins[:max_new], dim=1)
            logits = None if logits is None else logits.clone()
            key = progs.key.clone()
        else:
            self.dispatch_count += max_new
            state, ids, logits, steps, key = T.decode_loop(
                self.model, self.cfg, state, tok, max_new, self.policy,
                greedy=greedy, temperature=self.serve.temperature, key=key)
            margins = torch.cat([margin0[:, None], steps], dim=1)[:, :max_new]
        ids, margins = ids.cpu().numpy(), margins.cpu().numpy()
        t2 = time.perf_counter()
        prefill_sec, decode_sec = t1 - t0, t2 - t1
        return {"ids": ids, "margins": margins, "logits": logits,
                "key": key.cpu().numpy(),
                "state": state, "prefill_sec": prefill_sec,
                "decode_sec": decode_sec,
                "prefill_tok_per_sec": B * Tn / max(prefill_sec, 1e-9),
                "tok_per_sec": ids.size / max(decode_sec, 1e-9)}

    @torch.no_grad()
    def teacher_forced_accuracy(self, tokens, labels, chunked: bool = False,
                                fused=None, extra_inputs=None):
        """Feed gold tokens; argmax-match rate on positions where
        labels >= 0. tokens/labels: [B, T]."""
        fused = self._fused(fused)
        labels = np.asarray(labels)
        tokens = torch.as_tensor(tokens, device=self.model.device)
        B, Tn = tokens.shape
        first_label = int(np.min(np.where(labels >= 0)[1]))
        prefix_len = max(first_label, 1)
        state, h_last = self.prefill(tokens[:, :prefix_len], chunked,
                                     fused=fused, extra_inputs=extra_inputs)
        preds = [self._first_token(h_last)[0]]
        if prefix_len < Tn:
            self.dispatch_count += 1
            gold = tokens[:, prefix_len:]
            if fused:
                progs = self._programs(B, self._slab_len(extra_inputs))
                if state is not progs.state:
                    copy_state(progs.state, state)
                for i in range(gold.shape[1]):
                    preds.append(progs.decode(gold[:, i])[0].clone())
            else:
                state, rest = T.teacher_force_loop(self.model, self.cfg,
                                                   state, gold, self.policy)
                preds.extend(rest.unbind(dim=1))
        preds = torch.stack(preds, dim=1).cpu().numpy()
        labs = labels[:, prefix_len - 1:]
        sel = labs >= 0
        correct = int((preds[sel] == labs[sel]).sum())
        return correct / max(int(sel.sum()), 1)


def build_engine(cfg, model, *, device="cuda", **serve_kwargs) -> Engine:
    return Engine(cfg, model, ServeConfig(**serve_kwargs), device=device)
