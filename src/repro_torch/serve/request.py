"""Request model for the continuous-batching scheduler.

A copy of the JAX package's ``repro/serve/request.py`` (numpy only; the
port imports nothing of that package). A `Request` is one user
generation: a ragged prompt, its own decode budget (`max_new`), an RNG
seed (its lane's threefry key chain under temperature sampling), an
optional stop token, and its SLO metadata: a `priority` class (higher =
more urgent) and an optional `deadline_ms` latency target.
`RequestState` is the scheduler-side bookkeeping: queue -> lane -> done
lifecycle, emitted tokens, and the timestamps the stream launcher turns
into TTFT/TPOT/latency percentiles. `LaneSnapshot` is one lane's state
on the host, the record the snapshot store (serve.store) holds.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional

import numpy as np


def latency_percentiles(vals):
    """mean/p50/p95/p99 (seconds) of a latency sample, dropping None
    entries (e.g. TPOT of single-token requests); None when nothing
    remains. The single definition behind the stream launcher's and
    chip_smoke.py's printouts."""
    vals = [v for v in vals if v is not None]
    if not vals:
        return None
    a = np.asarray(vals, np.float64)
    return {"mean": float(a.mean()),
            "p50": float(np.percentile(a, 50)),
            "p95": float(np.percentile(a, 95)),
            "p99": float(np.percentile(a, 99))}


class Status(enum.Enum):
    QUEUED = "queued"        # accepted, waiting for a free lane
    RUNNING = "running"      # occupying a lane (prefilling or decoding)
    PARKED = "parked"        # swapped out on purpose (Scheduler.park);
    #                          held OFF the queue until revive()
    DONE = "done"            # retired on EOS or max_new
    FAILED = "failed"        # gave up after max_retries recoveries
    TIMED_OUT = "timed_out"  # cancelled by its wall-clock timeout_ms
    REJECTED = "rejected"    # refused at submit (validation / overload)


# Every submitted request must reach EXACTLY ONE of these — the
# liveness oracle the chaos suite (tests/test_faults.py) asserts under
# arbitrary injected fault schedules.
TERMINAL_STATUSES = frozenset(
    {Status.DONE, Status.FAILED, Status.TIMED_OUT, Status.REJECTED})


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request. prompt: int32 token ids, any length >= 1
    (prompts are RAGGED — the scheduler packs mixed lengths into one
    padded chunk grid). eos_id -1 = never stop early. arrival: optional
    stream-mode arrival offset in seconds (Poisson traces).
    priority: admission class, higher wins under sched_policy="priority"
    (ties FIFO). deadline_ms: optional latency SLO relative to submit;
    sched_policy="edf" admits by earliest absolute deadline and the
    preemptor may evict a later-deadline lane for an earlier one.

    extra_inputs: per-request cross-attention memory for the
    vlm/encdec families — {"vision_embeds": [S, vision_dim]} or
    {"source_embeds": [S, d_model]} float32, UNBATCHED, any S between 1
    and the family's memory length (ragged memory: the scheduler packs
    mixed lengths into one padded slab with a per-lane mem_len mask).
    Required by the scheduler for those families, ignored otherwise."""
    rid: int
    prompt: np.ndarray
    max_new: int
    seed: int = 0
    eos_id: int = -1
    arrival: float = 0.0
    priority: int = 0
    deadline_ms: Optional[float] = None
    # hard wall-clock budget (submit -> finish). Exceeding it cancels
    # the request (lane reset, Status.TIMED_OUT) instead of letting a
    # stuck generation pin a lane forever. None = no timeout.
    timeout_ms: Optional[float] = None
    extra_inputs: Optional[Dict[str, np.ndarray]] = None

    def __post_init__(self):
        # Construction only NORMALIZES — it never raises. Malformed
        # requests (empty prompt, max_new < 1, bad deadlines, bad
        # memory shapes) are reported by validation_error() and turned
        # into a structured Status.REJECTED at Scheduler.submit, so a
        # bad request in a stream can never crash the serving loop.
        prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        object.__setattr__(self, "prompt", prompt)
        if self.extra_inputs is not None:
            extra = {k: np.asarray(v, np.float32)
                     for k, v in self.extra_inputs.items()}
            object.__setattr__(self, "extra_inputs", extra)

    def validation_error(self) -> Optional[str]:
        """Reason this request can never be served (None = valid).
        Scheduler.submit turns a non-None reason into Status.REJECTED
        on the RequestState instead of raising at the caller."""
        if self.prompt.size < 1:
            return "empty prompt"
        if self.max_new < 1:
            return f"max_new must be >= 1, got {self.max_new}"
        if self.deadline_ms is not None and self.deadline_ms <= 0:
            return f"deadline_ms must be positive, got {self.deadline_ms}"
        if self.timeout_ms is not None and self.timeout_ms <= 0:
            return f"timeout_ms must be positive, got {self.timeout_ms}"
        if self.extra_inputs is not None:
            for k, v in self.extra_inputs.items():
                if v.ndim != 2 or v.shape[0] < 1:
                    return (f"extra_inputs[{k!r}] must be a [S>=1, feat] "
                            f"array (unbatched), got shape {v.shape}")
        return None

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    def to_meta(self) -> dict:
        """JSON-able record of everything needed to reconstruct this
        request after a process restart — persisted in the snapshot
        store's manifest alongside a parked session's slab, so a
        revived-from-disk request can still fall back to
        recompute-from-prompt (and re-pack its cross memory) if its
        slab fails verification."""
        meta = {"rid": int(self.rid),
                "prompt": [int(t) for t in self.prompt],
                "max_new": int(self.max_new), "seed": int(self.seed),
                "eos_id": int(self.eos_id), "arrival": float(self.arrival),
                "priority": int(self.priority),
                "deadline_ms": self.deadline_ms,
                "timeout_ms": self.timeout_ms, "extra_inputs": None}
        if self.extra_inputs is not None:
            # float32 -> python float -> float32 is exact (f32 ⊂ f64)
            meta["extra_inputs"] = {
                k: {"shape": list(v.shape),
                    "data": [float(x) for x in v.reshape(-1)]}
                for k, v in self.extra_inputs.items()}
        return meta

    @classmethod
    def from_meta(cls, meta: dict) -> "Request":
        extra = None
        if meta.get("extra_inputs") is not None:
            extra = {k: np.asarray(v["data"], np.float32).reshape(
                         v["shape"])
                     for k, v in meta["extra_inputs"].items()}
        return cls(rid=int(meta["rid"]),
                   prompt=np.asarray(meta["prompt"], np.int32),
                   max_new=int(meta["max_new"]), seed=int(meta["seed"]),
                   eos_id=int(meta["eos_id"]),
                   arrival=float(meta.get("arrival", 0.0)),
                   priority=int(meta.get("priority", 0)),
                   deadline_ms=meta.get("deadline_ms"),
                   timeout_ms=meta.get("timeout_ms"),
                   extra_inputs=extra)


@dataclasses.dataclass
class LaneSnapshot:
    """Host-side copy of one lane's COMPLETE movable state, gathered by
    LanePrograms.extract: the retained KV slab of every layer (K/V, slot
    positions, retention betas, policy aux; bfloat16 leaves as their
    int16 bits), the per-lane clock state["t"], the carried next-token,
    the lane's RNG chain, and the emission count. Restoring it with
    LanePrograms.resume is bit-identical to never having left the
    device, and its footprint is O(M x layers), small by construction
    (eviction already compressed the lane), which is what makes swap-out
    preemption, parking, and replay-on-fault affordable.

    `n_tokens` records len(RequestState.tokens) at capture so a replay
    can truncate the host-side stream to the snapshot point.

    Snapshots live in the Scheduler's `SnapshotStore` (serve.store),
    which stamps `crc`/`meta_crc` at capture — crc32 over the state
    leaves' bytes in flatten order plus a metadata digest — and
    verifies them on every fetch, so a silently-corrupted-but-finite
    slab is detected instead of reviving as wrong tokens."""
    state: dict                      # batch-1 state (numpy leaves)
    tok: np.ndarray                  # [] int32 next token to emit/feed
    key: np.ndarray                  # [2] uint32 RNG chain
    n_emitted: int
    n_tokens: int                    # len(rs.tokens) when captured
    crc: Optional[int] = None        # slab checksum (store.put stamps)
    meta_crc: Optional[int] = None   # metadata digest


@dataclasses.dataclass
class RequestState:
    """Scheduler-side lifecycle of one request."""
    request: Request
    status: Status = Status.QUEUED
    lane: int = -1                      # -1 while queued / after retire
    tokens: List[int] = dataclasses.field(default_factory=list)
    submit_seq: int = 0                 # FIFO tie-break order
    submit_sec: float = 0.0             # when the scheduler accepted it
    admit_sec: Optional[float] = None   # when it won a lane (prefill)
    # first_token_sec is derived from the first emission's STEP inside
    # its segment (linear interpolation over the segment wall time),
    # not the segment-harvest wall clock — a large decode_segment no
    # longer quantizes TTFT up by the whole segment width.
    first_token_sec: Optional[float] = None
    first_emit_step: Optional[int] = None  # global scheduler step index
    #                                        of the first emission
    #                                        (deterministic, unlike the
    #                                        wall-clock timestamps)
    finish_sec: Optional[float] = None  # when it retired
    n_preempts: int = 0                 # times evicted mid-flight
    #                                     (swap-out + resume, or
    #                                     restart-from-scratch recompute
    #                                     for mid-prefill victims)
    n_retries: int = 0                  # fault recoveries (quarantine +
    #                                     replay) consumed so far
    spec_rounds: int = 0                # verify rounds this request was
    #                                     live in (speculative decode)
    spec_tokens: int = 0                # tokens committed by those
    #                                     rounds; spec_tokens /
    #                                     spec_rounds = mean acceptance
    #                                     length (>= 1 when live)
    reason: Optional[str] = None        # why REJECTED / FAILED /
    #                                     TIMED_OUT (None otherwise)
    # NOTE: the request's last swap-out/checkpoint/park snapshot lives
    # in the Scheduler's SnapshotStore (serve.store), keyed by rid —
    # NOT here — so snapshots are capacity-accounted, spillable to disk
    # and checksum-verified instead of pinned on the RequestState.

    @property
    def rid(self) -> int:
        return self.request.rid

    @property
    def done(self) -> bool:
        return self.status is Status.DONE

    @property
    def terminal(self) -> bool:
        """True once the request reached one of the four terminal
        statuses (DONE | FAILED | TIMED_OUT | REJECTED) — the liveness
        invariant: every submitted request terminates exactly once."""
        return self.status in TERMINAL_STATUSES

    @property
    def ids(self) -> np.ndarray:
        return np.asarray(self.tokens, np.int32)

    @property
    def deadline_sec(self) -> float:
        """Absolute deadline on the scheduler clock (inf = none)."""
        if self.request.deadline_ms is None:
            return float("inf")
        return self.submit_sec + self.request.deadline_ms / 1000.0

    @property
    def latency_sec(self) -> Optional[float]:
        if self.finish_sec is None:
            return None
        return self.finish_sec - self.submit_sec

    @property
    def ttft_sec(self) -> Optional[float]:
        """Time to first token (submit -> first harvested emission)."""
        if self.first_token_sec is None:
            return None
        return self.first_token_sec - self.submit_sec

    @property
    def tpot_sec(self) -> Optional[float]:
        """Time per output token after the first (None until done or
        when only one token was emitted)."""
        if self.finish_sec is None or self.first_token_sec is None:
            return None
        n = len(self.tokens)
        if n < 2:
            return None
        return (self.finish_sec - self.first_token_sec) / (n - 1)

    @property
    def missed_deadline(self) -> Optional[bool]:
        if self.finish_sec is None or self.request.deadline_ms is None:
            return None
        return self.finish_sec > self.deadline_sec
