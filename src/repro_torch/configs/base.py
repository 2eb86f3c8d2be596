"""Config dataclasses for the PyTorch port.

Copies of the JAX package's ``ModelConfig`` and ``TrainConfig`` (field
for field, so one config describes the same model and the same
training in both packages) and a ``ServeConfig``
with the JAX package's serving and scheduler fields and defaults (a
field whose subsystem is not ported yet, the prefix cache and
speculative decoding, raises ``NotImplementedError`` where the
scheduler would use it). The port
imports nothing from the JAX package, so the architecture table and
the lookup helpers live here too; an architecture the port cannot run
yet raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | encdec
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    attn_pattern: Tuple[str, ...] = ("global",)
    window: int = 0                   # local-attn window size
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # --- SSM (mamba-1) ---
    ssm_state: int = 0
    d_inner: int = 0
    conv_width: int = 4
    dt_rank: int = 0
    # --- hybrid (RG-LRU) ---
    lru_width: int = 0
    # --- VLM ---
    vision_dim: int = 0
    num_image_tokens: int = 0
    # --- enc-dec ---
    encoder_layers: int = 0
    source_len: int = 0
    # --- misc ---
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # --- TRIM-KV (the paper's technique) ---
    trimkv: bool = True               # attach retention gates to attn layers
    gate_hidden: int = 512
    gate_bias_init: float = 18.0      # paper: large positive bias => beta~1 at init
    # --- fields the JAX package reads for XLA lowering; kept so that one
    # config means the same model in both packages ---
    unroll_layers: bool = False
    attn_q_block: int = 512
    attn_kv_block: int = 512
    context_parallel: bool = False
    source: str = ""                  # citation for the config numbers

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256; logits beyond vocab_size
        are masked to -1e30."""
        return ((self.vocab_size + 255) // 256) * 256

    def layer_kinds(self) -> Tuple[str, ...]:
        """Expanded per-layer kind list of length num_layers."""
        unit = self.attn_pattern
        out = []
        while len(out) < self.num_layers:
            out.extend(unit)
        return tuple(out[: self.num_layers])


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    global_batch: int = 256
    seq_len: int = 4096
    learning_rate: float = 2e-4       # paper App. B.1
    weight_decay: float = 0.01        # paper App. B.1
    warmup_steps: int = 100
    total_steps: int = 1000
    grad_clip: float = 1.0
    capacity_M: int = 256             # paper Sec 5.1: M=256 (math), 1024 (long-ctx)
    lambda_cap: float = 1.0           # paper Sec 5.1
    use_kl: bool = True
    use_ntp: bool = True
    use_cap: bool = True
    remat: bool = True
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    budget: int = 1024                # KV budget M per (layer, kv-head)
    policy: str = "trimkv"            # a name of core.policies.POLICIES
    sink_tokens: int = 4
    recent_window: int = 32
    obs_window: int = 32
    prefill_chunk: int = 2048
    max_decode_steps: int = 64
    temperature: float = 0.0
    # fused: Engine.generate / teacher_forced_accuracy and
    # Engine.prefill(chunked=True) run their step programs as captured
    # CUDA graphs (serve.graphs), one replay per step; False runs the
    # same steps eagerly, the parity reference. The lane closures of the
    # scheduler follow it too. On the CPU every step runs eagerly.
    fused: bool = True
    # --- continuous batching (serve.scheduler); the JAX package's
    # fields and defaults ---
    decode_segment: int = 16          # decode steps per scheduler segment
    eos_id: int = -1                  # default stop token (-1 = none)
    max_queue: int = 64               # submit() sheds beyond this
    sched_policy: str = "fifo"        # fifo | priority | edf
    interleaved: bool = False         # admission prefill inside segments
    prefill_budget: int = 0           # prompt tokens per interleaved
    #                                   segment (0 = unlimited)
    preempt: bool = True              # priority/edf may evict a lane
    # swap_preempt: a decoding victim is swapped out to a host snapshot
    # and resumes where it stopped; False restarts every victim from
    # scratch (recompute-style preemption)
    swap_preempt: bool = True
    # max_retries: fault recoveries (quarantine + replay) a request may
    # consume before it is FAILED terminally. A lane whose segment
    # produced non-finite logits is scrubbed (T.scrub_lanes) and its
    # request replayed from its last snapshot (or from scratch).
    max_retries: int = 2
    # snapshot every decoding lane every N segments (0 = off), so a
    # fault replays from the checkpoint instead of from scratch
    checkpoint_every: int = 0
    shed_policy: str = "reject"       # reject | evict
    # snapshot store (serve.store): RAM budget for host snapshots in
    # bytes (0 = unlimited) and an optional disk tier, where parked and
    # checkpointed sessions survive a restart of the process
    snapshot_host_bytes: int = 0
    snapshot_dir: Optional[str] = None
    # park_exempts_timeout: True (default) exempts PARKED sessions from
    # Request.timeout_ms — parking is an explicit caller decision, and
    # an idle parked chat session may far outlive any per-request SLO.
    # False enforces the timeout while parked too: an expired parked
    # request goes TIMED_OUT (zero dispatches) and its snapshots are
    # released from every tier.
    park_exempts_timeout: bool = True
    prefix_cache_bytes: int = 0       # prefix KV cache (not ported)
    spec_k: int = 0                   # speculative decoding (not ported)


ARCH_IDS = (
    "recurrentgemma-2b",
    "mixtral-8x7b",
    "gemma3-12b",
    "llama-3.2-vision-90b",
    "granite-moe-3b-a800m",
    "falcon-mamba-7b",
    "qwen2.5-14b",
    "codeqwen1.5-7b",
    "seamless-m4t-large-v2",
    "minitron-8b",
    "trimkv-paper-4b",
)

# architectures whose config module the port carries (dense GQA only)
PORTED_ARCHS = ("trimkv-paper-4b",)


def _module(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    if arch_id not in PORTED_ARCHS:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported to repro_torch yet; "
            f"ported: {PORTED_ARCHS}")
    name = arch_id.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke()
