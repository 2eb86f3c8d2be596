"""Lane-based continuous batching over the serving step programs, with
SLO-aware admission, swap preemption, a snapshot store and fault
supervision.

Ported from ``repro/serve/scheduler.py``. The `Scheduler` owns B fixed
LANES (the batch dim of one static decode state, ``Engine.lane_closures``).
Each lane holds at most one in-flight request; the scheduler

  1. ADMITS queued requests into free lanes in `sched_policy` order
     (fifo | priority | edf). Phased mode packs their ragged prompts
     into ONE padded chunk grid and prefills it as one admission
     dispatch (the chunk program, one replay per chunk, then the first
     tokens and the requests' key chains) before decoding resumes;
     INTERLEAVED mode (ServeConfig.interleaved /
     Scheduler(interleaved=True)) threads one prompt chunk per
     admitting lane into each step of the next segments (the mixed
     programs), bounded by `prefill_budget` tokens per segment, so a
     long prompt never stalls in-flight decodes. Requests holding a
     LaneSnapshot (swapped-out preemption victims, parked sessions,
     fault replays from a checkpoint) are RESUMED instead: one dispatch
     copies their snapshots back into lanes, bit-identical to never
     having left the device;
  2. runs bounded DECODE SEGMENTS (the segment program, replayed once
     per step, or the mixed programs while any lane is still
     prefilling): serve_cfg.decode_segment steps with per-lane active
     masks, clocks, key chains, max_new and eos. Remainder segments
     (the pure-decode half of a drain-split) are rounded up to
     power-of-two buckets as the JAX package does
     (`decode_bucket_lengths`); the masked tail of a bucket is the
     identity, so it is not replayed;
  3. RETIRES lanes whose request emitted its eos_id or max_new-th token
     at the segment boundary (pos := -1, one reset dispatch) and
     immediately refills them. Under priority/edf it may also PREEMPT
     the worst running lane when a strictly better-ranked request waits
     with no free lane: with serve_cfg.swap_preempt (default) a
     decoding victim is SWAPPED OUT to a host LaneSnapshot in the
     SnapshotStore (serve.store) and resumes with its emitted tokens
     intact; mid-prefill victims (and swap_preempt=False) restart from
     scratch. Either way the output stays token-identical to an
     uninterrupted run. `park` / `revive` swap a decoding request out
     and back on purpose; with serve_cfg.snapshot_dir a new Scheduler
     over the same directory recovers parked and checkpointed sessions
     as PARKED;
  4. SUPERVISES every dispatch: the step programs carry a per-lane
     health flag (`ok`: non-finite logits on a step the lane was live),
     and a flagged lane is QUARANTINED at the segment boundary: its
     emissions are discarded, its state scrubbed (reset + K/V zeroed,
     so NaN bytes cannot leak through the masked p@v product), and its
     request replayed from its last checkpoint (serve.checkpoint_every)
     or from scratch, up to serve_cfg.max_retries times before a
     terminal FAILED. A snapshot that fails its checksum at resume is
     replayed from scratch on the same budget. An optional
     FaultInjector (serve.faults) acts at the top of every step.

Dispatch accounting: every dispatch bumps the Engine's
`dispatch_count`, and the total is n_prefill_rounds + n_segments +
n_resets + n_swaps + n_resumes (+ n_faults_injected under injection),
the JAX scheduler's formula without its prefix-cache terms. Interleaved
mode keeps n_prefill_rounds at 0. `steps_run` counts the step programs
run by kind (replays on the card), from which the kernel launches of a
run follow: per layer one decode launch per segment step, one chunk
launch per chunk step, both per mixed step.

Correctness contract: each request's output is token-identical to a
one-shot `Engine.generate(prompt[None], max_new, chunked=True,
seed=seed)` (truncated at its eos), greedy or sampled (each lane's key
chain starts from its request's seed, as the one-shot chain does), in
both admission modes, any admission order, under preemption, parking
and fault replay, where both runs make the same rounding (on the CPU,
and in float32 on the card). On the card in bf16 a lane batch of B and
a one-shot batch of 1 run different kernels (the decode kernel's split
plan and cuBLAS's choice depend on B), so a token may differ after a
near tie.

`continuous=False` degrades the same machinery to static batching
(admission waits until every lane is free).

Not ported yet; each raises NotImplementedError naming its ROADMAP
queue 1 item: the prefix cache, speculative decoding and cross-memory
families.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.serve.engine import Engine
from repro_torch.serve.graphs import host_row_template
from repro_torch.serve.request import (LaneSnapshot, Request, RequestState,
                                       Status)
from repro_torch.serve.store import SnapshotStore, state_spec

SCHED_POLICIES = ("fifo", "priority", "edf")
SHED_POLICIES = ("reject", "evict")


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported to repro_torch yet; "
                               f"see {item}")


def _chunk_prompt(prompt: np.ndarray, C: int):
    """One prompt -> its padded chunk sequence, exactly as one-shot
    chunked prefill chunks it: full C-token chunks, then the
    zero-padded tail. Returns (chunks [n_chunks, C] int32,
    n_valid [n_chunks] int32)."""
    n_chunks = -(-prompt.size // C)
    grid = np.zeros((n_chunks * C,), np.int32)
    grid[: prompt.size] = prompt
    n_valid = np.clip(prompt.size - np.arange(n_chunks) * C,
                      0, C).astype(np.int32)
    return grid.reshape(n_chunks, C), n_valid


def _prng_keys(seeds) -> np.ndarray:
    """[k, 2] uint32 threefry keys, one per request seed (core.prng's
    layout), built on the host so admission costs no extra dispatch.
    Each lane's chain therefore reproduces a B = 1
    Engine.generate(seed=seed) stream."""
    return np.stack([prng.prng_key(s).numpy() for s in seeds]).astype(
        np.uint32)


@dataclasses.dataclass
class _LanePrefill:
    """Host-side progress of one interleaved admission prefill: the
    request's prompt chunked as one-shot chunked prefill chunks it, fed
    one chunk per segment step until done."""
    chunks: np.ndarray                 # [n_chunks, C] int32
    n_valid: np.ndarray                # [n_chunks] int32 (C ... tail)
    next_chunk: int = 0

    @property
    def n_chunks(self) -> int:
        return int(self.chunks.shape[0])

    @property
    def done(self) -> bool:
        return self.next_chunk >= self.n_chunks


class Scheduler:
    def __init__(self, engine: Engine, n_lanes: int, *, greedy: bool = True,
                 continuous: bool = True,
                 interleaved: Optional[bool] = None,
                 injector=None):
        self.eng = engine
        self.cfg, self.serve = engine.cfg, engine.serve
        self.policy = engine.policy
        self.n_lanes = n_lanes
        self.continuous = continuous
        self.interleaved = (self.serve.interleaved if interleaved is None
                            else interleaved)
        self.sched_policy = self.serve.sched_policy
        if self.sched_policy not in SCHED_POLICIES:
            raise ValueError(f"unknown sched_policy "
                             f"{self.sched_policy!r}; "
                             f"expected one of {SCHED_POLICIES}")
        if self.serve.shed_policy not in SHED_POLICIES:
            raise ValueError(f"unknown shed_policy "
                             f"{self.serve.shed_policy!r}; "
                             f"expected one of {SHED_POLICIES}")
        if self.cfg.family in ("vlm", "encdec"):
            raise _not_ported("a cross-memory family",
                              "ROADMAP queue 1, cross-memory families")
        if self.serve.prefix_cache_bytes > 0:
            raise _not_ported("the prefix cache",
                              "ROADMAP queue 1, prefix cache")
        if self.serve.spec_k > 0:
            raise _not_ported("speculative decoding",
                              "ROADMAP queue 1, speculative decoding")
        self.greedy = greedy or self.serve.temperature == 0.0
        # chaos adversary (serve.faults.FaultInjector), None in
        # production: step() gives it first crack at the scheduler
        self.injector = injector
        # the step programs and their static lane state live on the
        # Engine, so successive schedulers share one set of graphs; a new
        # scheduler starts from fresh lanes
        self.lanes = engine.lane_closures(n_lanes)
        self.lanes.fresh()
        # host lane bookkeeping (uploaded once per dispatch)
        self.active = np.zeros(n_lanes, bool)
        self.n_emitted = np.zeros(n_lanes, np.int32)
        self.max_new = np.ones(n_lanes, np.int32)
        self.eos = np.full(n_lanes, -1, np.int32)
        self.lane_req: List[Optional[RequestState]] = [None] * n_lanes
        self.lane_prefill: List[Optional[_LanePrefill]] = [None] * n_lanes
        self.queue: List[RequestState] = []
        self._submit_seq = 0
        self.results: Dict[int, RequestState] = {}
        # dispatch accounting, the JAX scheduler's counters
        self.n_prefill_rounds = 0
        self.n_segments = 0
        self.n_resets = 0
        self.n_preempted = 0
        self.n_swaps = 0
        self.n_resumes = 0
        self.n_shed = 0
        self.n_quarantined = 0
        self.n_timeouts = 0
        self.n_failed = 0
        self.n_faults_injected = 0
        self.n_snapshot_lost = 0
        self.n_recovered_sessions = 0
        self.n_segment_splits = 0
        self.n_verify_rounds = 0
        self.n_spec_tokens = 0
        self.n_spec_rounds = 0
        self.decode_bucket_lengths = set()
        self.prefill_bucket_lengths = set()
        # step programs run, by kind, and the host's time issuing the
        # segment dispatches (until the last step is enqueued)
        self.steps_run = {"chunk": 0, "segment": 0, "mixed": 0}
        self.enqueue_sec = 0.0
        self._steps_done = 0
        self._t0 = time.monotonic()
        # the snapshot store owns every LaneSnapshot: RAM LRU under
        # serve.snapshot_host_bytes, disk under serve.snapshot_dir, each
        # checksummed at capture and verified at fetch; the expected
        # single-lane spec fences off records of another config
        expected = state_spec(host_row_template(self.cfg, self.serve.budget))
        self.store = SnapshotStore(
            host_bytes=self.serve.snapshot_host_bytes,
            directory=self.serve.snapshot_dir, expected_spec=expected)
        self._recover_sessions()

    def _recover_sessions(self) -> None:
        """Replay the snapshot store's manifest (when serve.snapshot_dir
        holds a previous process's snapshots): rebuild each record's
        Request and a PARKED RequestState with its emitted tokens, as if
        this Scheduler had parked it. Records without session metadata,
        or that fail to rebuild, are skipped."""
        for record in self.store.recoverable():
            meta = record.get("request")
            rid = record.get("rid")
            if meta is None or rid in self.results:
                continue
            try:
                req = Request.from_meta(meta)
            except (KeyError, TypeError, ValueError):
                continue
            rs = RequestState(request=req, status=Status.PARKED,
                              submit_seq=self._submit_seq,
                              submit_sec=self._now())
            self._submit_seq += 1
            rs.tokens = [int(t) for t in record.get("tokens", [])]
            self.results[rid] = rs
            self.n_recovered_sessions += 1

    def close(self) -> None:
        """Drain the snapshot store's writes and join its writer."""
        self.store.close()

    # ---------------------------------------------------------- queueing

    def _now(self) -> float:
        return time.monotonic() - self._t0

    def _shed(self, rs: RequestState) -> Optional[str]:
        """Queue overload: serve_cfg.max_queue requests already wait.
        shed_policy "reject" refuses the newcomer; "evict" sheds the
        worst queued request instead when the newcomer strictly outranks
        it under sched_policy. Returns the newcomer's rejection reason,
        or None if it won a slot."""
        if self.serve.shed_policy == "evict" and self.queue:
            worst = max(self.queue, key=self._order_key)
            if self._order_key(rs) < self._order_key(worst):
                self.queue.remove(worst)
                worst.status = Status.REJECTED
                worst.reason = ("shed under overload for "
                                f"request {rs.rid}")
                worst.finish_sec = self._now()
                self.n_shed += 1
                return None
        self.n_shed += 1
        return f"queue full (max_queue={self.serve.max_queue})"

    def submit(self, request: Request) -> RequestState:
        """Accept a request into the waiting queue. Always returns its
        RequestState (recorded in `results`): a malformed request or an
        overloaded queue yields Status.REJECTED with `reason` set, never
        an exception."""
        rs = RequestState(request=request, submit_seq=self._submit_seq,
                          submit_sec=self._now())
        self._submit_seq += 1
        self.results[request.rid] = rs
        reason = request.validation_error()
        if reason is None and len(self.queue) >= self.serve.max_queue:
            reason = self._shed(rs)
        if reason is not None:
            rs.status, rs.reason = Status.REJECTED, reason
            rs.finish_sec = self._now()
            return rs
        self.queue.append(rs)
        return rs

    def _order_key(self, rs: RequestState):
        """Admission order under sched_policy; smaller is served first.
        fifo: submit order. priority: highest Request.priority, ties
        FIFO. edf: earliest absolute deadline (none sorts last), ties
        FIFO."""
        if self.sched_policy == "priority":
            return (-rs.request.priority, rs.submit_seq)
        if self.sched_policy == "edf":
            return (rs.deadline_sec, rs.submit_seq)
        return (rs.submit_seq,)

    def _pop_next(self) -> RequestState:
        rs = min(self.queue, key=self._order_key)
        self.queue.remove(rs)
        return rs

    @property
    def n_running(self) -> int:
        return sum(rs is not None for rs in self.lane_req)

    @property
    def idle(self) -> bool:
        return not self.queue and self.n_running == 0

    # ----------------------------------------------- snapshots (swap-out)

    def _swap_out(self, lanes: List[int], kind: str = "swap") -> None:
        """ONE extract dispatch copies the lanes' complete movable state
        (retained KV slab, positions, betas, aux, clock), carried token
        and key chain into host LaneSnapshots, handed to the
        SnapshotStore (checksummed at capture; the durable kinds "park"
        and "checkpoint" write through to the disk tier). O(M) per lane:
        eviction already compressed each lane to its budget."""
        self.eng.dispatch_count += 1
        self.n_swaps += 1
        for lane, (row, tok, key) in zip(lanes, self.lanes.extract(lanes)):
            rs = self.lane_req[lane]
            snap = LaneSnapshot(state=row, tok=tok, key=key,
                                n_emitted=int(self.n_emitted[lane]),
                                n_tokens=len(rs.tokens))
            self.store.put(rs.rid, snap, request_meta=rs.request.to_meta(),
                           tokens=rs.tokens, kind=kind)

    def _resume_lanes(
            self,
            batch: List[Tuple[RequestState, LaneSnapshot, int]]) -> None:
        """ONE resume dispatch copies k verified LaneSnapshots (fetched
        by _take_admissions from the RAM or disk tier) back into their
        lanes, in place, so each request continues its exact token
        stream. The host-side stream is rolled back to the snapshot
        point (tokens truncated to snapshot.n_tokens: a no-op after a
        plain swap-out, a real rollback on fault replay)."""
        self.eng.dispatch_count += 1
        self.n_resumes += 1
        self.lanes.resume([lane for _, _, lane in batch],
                          [snap.state for _, snap, _ in batch],
                          [snap.tok for _, snap, _ in batch],
                          [snap.key for _, snap, _ in batch])
        now = self._now()
        for rs, snap, lane in batch:
            rs.status, rs.lane = Status.RUNNING, lane
            if rs.admit_sec is None:
                rs.admit_sec = now
            del rs.tokens[snap.n_tokens:]
            self.lane_req[lane] = rs
            self.lane_prefill[lane] = None
            self.active[lane] = True
            self.n_emitted[lane] = snap.n_emitted
            self.max_new[lane] = rs.request.max_new
            self.eos[lane] = rs.request.eos_id

    def park(self, rid: int) -> RequestState:
        """Swap a RUNNING (decoding) request out on purpose: its lane is
        snapshotted and freed, the request held OFF the queue in
        Status.PARKED until revive()."""
        rs = self.results[rid]
        if rs.status is not Status.RUNNING or rs.lane < 0:
            raise ValueError(f"request {rid} is not running "
                             f"(status={rs.status.value})")
        lane = rs.lane
        if self.lane_prefill[lane] is not None:
            raise ValueError(f"request {rid} is still prefilling; "
                             f"park applies to decoding lanes")
        self._swap_out([lane], kind="park")
        self._reset_lanes([lane])
        rs.status, rs.lane = Status.PARKED, -1
        self.lane_req[lane] = None
        self.active[lane] = False
        return rs

    def revive(self, rid: int) -> RequestState:
        """Re-enqueue a PARKED request; the next admission round resumes
        it from its snapshot (tokens intact)."""
        rs = self.results[rid]
        if rs.status is not Status.PARKED:
            raise ValueError(f"request {rid} is not parked "
                             f"(status={rs.status.value})")
        rs.status = Status.QUEUED
        self.queue.append(rs)
        return rs

    # -------------------------------------------------------- preemption

    def _outranks(self, cand: RequestState, victim: RequestState) -> bool:
        """Strict SLO dominance, the only condition under which a waiting
        request may evict a running one (FIFO never preempts)."""
        if self.sched_policy == "priority":
            return cand.request.priority > victim.request.priority
        if self.sched_policy == "edf":
            return cand.deadline_sec < victim.deadline_sec
        return False

    def _reset_lanes(self, lanes: List[int]) -> None:
        """One reset dispatch for every lane in ``lanes``."""
        mask = np.zeros(self.n_lanes, bool)
        mask[lanes] = True
        self.eng.dispatch_count += 1
        self.n_resets += 1
        self.lanes.reset(torch.as_tensor(mask, device=self.lanes.tok.device))

    def _maybe_preempt(self) -> None:
        """Evict the worst running lane(s) when a strictly better-ranked
        request waits with no free lane. With serve_cfg.swap_preempt
        (default) decoding victims are swapped out by one extract
        dispatch and keep their emitted tokens; mid-prefill victims and
        swap_preempt=False restart from scratch. All victims share one
        reset dispatch."""
        if (not self.serve.preempt or self.sched_policy == "fifo"
                or not self.continuous or not self.queue):
            return
        victims: List[int] = []
        running = {l: rs for l, rs in enumerate(self.lane_req)
                   if rs is not None}
        if len(running) < self.n_lanes:
            return
        pool = sorted(self.queue, key=self._order_key)
        for cand in pool:
            if not running:
                break
            worst_lane = max(running, key=lambda l:
                             self._order_key(running[l]))
            if not self._outranks(cand, running[worst_lane]):
                break
            victims.append(worst_lane)
            del running[worst_lane]
        if not victims:
            return
        swapped = set()
        if self.serve.swap_preempt:
            swapped = {l for l in victims if self.lane_prefill[l] is None}
            if swapped:
                self._swap_out(sorted(swapped))
        self._reset_lanes(victims)
        for lane in victims:
            rs = self.lane_req[lane]
            rs.status, rs.lane = Status.QUEUED, -1
            if lane not in swapped:
                # recompute path: discard progress, restart from scratch
                self.store.drop(rs.rid)
                rs.admit_sec = rs.first_token_sec = None
                rs.first_emit_step = None
                rs.tokens.clear()
            rs.n_preempts += 1
            self.n_preempted += 1
            self.lane_req[lane] = None
            self.lane_prefill[lane] = None
            self.active[lane] = False
            self.queue.append(rs)

    # ---------------------------------------------------------- timeouts

    def _expire_timeouts(self) -> None:
        """Cancel requests whose wall clock exceeded their timeout_ms:
        queued ones leave the queue with no dispatch; running ones free
        their lanes with one reset dispatch. Terminal status TIMED_OUT,
        snapshots released from every tier. PARKED requests are exempt
        while serve.park_exempts_timeout (the default: parking is the
        caller's decision); with it False they expire too."""
        now = self._now()

        def expired(rs):
            tm = rs.request.timeout_ms
            return tm is not None and (now - rs.submit_sec) * 1e3 > tm

        for rs in [q for q in self.queue if expired(q)]:
            self.queue.remove(rs)
            rs.status, rs.finish_sec = Status.TIMED_OUT, now
            rs.reason = (f"exceeded timeout_ms="
                         f"{rs.request.timeout_ms} while queued")
            self.store.drop(rs.rid)
            self.n_timeouts += 1
        if not self.serve.park_exempts_timeout:
            for rs in [r for r in self.results.values()
                       if r.status is Status.PARKED and expired(r)]:
                rs.status, rs.finish_sec = Status.TIMED_OUT, now
                rs.reason = (f"exceeded timeout_ms="
                             f"{rs.request.timeout_ms} while parked")
                self.store.drop(rs.rid)
                self.n_timeouts += 1
        lanes = [l for l, rs in enumerate(self.lane_req)
                 if rs is not None and expired(rs)]
        if not lanes:
            return
        self._reset_lanes(lanes)
        for lane in lanes:
            rs = self.lane_req[lane]
            rs.status, rs.finish_sec, rs.lane = Status.TIMED_OUT, now, -1
            rs.reason = (f"exceeded timeout_ms={rs.request.timeout_ms} "
                         f"while running")
            self.store.drop(rs.rid)
            self.n_timeouts += 1
            self.lane_req[lane] = None
            self.lane_prefill[lane] = None
            self.active[lane] = False

    # --------------------------------------------------------- admission

    def _pack_prompts(self, slots: List[Tuple[int, RequestState]]):
        """Pack ragged prompts into one padded, lane-aligned chunk grid:
        chunks [n_chunks, B, C] and the valid matrix [n_chunks, B] (full
        chunks, then each request's tail, then zeros, which freeze the
        row). The chunk axis is rounded up to a power of two, as the JAX
        package rounds it; chunks where no lane has a token are not run
        (LanePrograms.prefill_chunks)."""
        C = self.serve.prefill_chunk
        per = {lane: _chunk_prompt(rs.request.prompt, C)
               for lane, rs in slots}
        n_chunks = max(ch.shape[0] for ch, _ in per.values())
        n_chunks = 1 << (n_chunks - 1).bit_length()
        self.prefill_bucket_lengths.add(n_chunks)
        chunks = np.zeros((n_chunks, self.n_lanes, C), np.int32)
        n_valid = np.zeros((n_chunks, self.n_lanes), np.int32)
        for lane, (ch, nv) in per.items():
            chunks[: ch.shape[0], lane] = ch
            n_valid[: nv.shape[0], lane] = nv
        return chunks, n_valid

    def _claim_lanes(self) -> List[int]:
        """Which free lanes can be filled now (static batching waits for
        the full drain)."""
        free = [l for l in range(self.n_lanes) if self.lane_req[l] is None]
        if not self.continuous and len(free) < self.n_lanes:
            return []
        return free

    def _snapshot_lost(self, rs: RequestState) -> bool:
        """A stored snapshot failed verification (checksum mismatch,
        torn disk write, IO error) at resume: replay from the prompt on
        the quarantine's budget, or fail terminally once the request has
        used max_retries. Returns True if the request survives."""
        self.store.drop(rs.rid)
        self.n_snapshot_lost += 1
        rs.n_retries += 1
        if rs.n_retries > self.serve.max_retries:
            rs.status, rs.finish_sec = Status.FAILED, self._now()
            rs.reason = ("snapshot failed integrity verification and "
                         f"replay budget ({self.serve.max_retries}) "
                         "is exhausted")
            self.n_failed += 1
            return False
        rs.tokens.clear()
        rs.admit_sec = rs.first_token_sec = None
        rs.first_emit_step = None
        return True

    def _take_admissions(self) -> Tuple[
            List[Tuple[RequestState, LaneSnapshot, int]],
            List[Tuple[RequestState, int]]]:
        """Pop up to len(free) queued requests in _order_key order and
        split them into (resume, fresh) lane assignments: a request with
        a stored snapshot resumes, after the store fetches and verifies
        it; a failed verification demotes it to fresh (_snapshot_lost),
        or fails it once out of retries. A request whose snapshot the
        store dropped for capacity (no disk tier) recomputes from its
        prompt without spending a retry."""
        free = self._claim_lanes()
        k = min(len(free), len(self.queue))
        batch = [self._pop_next() for _ in range(k)]
        resume, fresh = [], []
        for rs in batch:
            if self.store.has(rs.rid):
                snap = self.store.get(rs.rid)
                if snap is not None:
                    resume.append((rs, snap))
                    continue
                if not self._snapshot_lost(rs):
                    continue             # terminal FAILED: lane unused
            elif rs.tokens:
                rs.tokens.clear()
                rs.admit_sec = rs.first_token_sec = None
                rs.first_emit_step = None
            fresh.append(rs)
        lanes = iter(free)
        return ([(rs, snap, next(lanes)) for rs, snap in resume],
                [(rs, next(lanes)) for rs in fresh])

    def _start(self, rs: RequestState, lane: int, active: bool) -> None:
        rs.status, rs.lane, rs.admit_sec = Status.RUNNING, lane, self._now()
        self.lane_req[lane] = rs
        self.active[lane] = active
        self.n_emitted[lane] = 0
        self.max_new[lane] = rs.request.max_new
        self.eos[lane] = rs.request.eos_id

    def _admit(self) -> int:
        """Phased admission: fill free lanes from the queue. The whole
        admission batch (ragged prefill, first tokens and key chains) is
        ONE dispatch however many requests it packs; decode lanes sit
        idle while it runs. Snapshot-holding requests are restored by
        one resume dispatch instead."""
        resume, fresh = self._take_admissions()
        if resume:
            self._resume_lanes(resume)
        if not fresh:
            return len(resume)
        chunks, n_valid = self._pack_prompts([(l, rs) for rs, l in fresh])
        mask = np.zeros(self.n_lanes, bool)
        mask[[lane for _, lane in fresh]] = True
        seeds = [0] * self.n_lanes
        for rs, lane in fresh:
            seeds[lane] = rs.request.seed
        self.eng.dispatch_count += 1
        self.n_prefill_rounds += 1
        self.steps_run["chunk"] += int(n_valid.any(axis=1).sum())
        self.lanes.admit(chunks, n_valid, mask, _prng_keys(seeds))
        for rs, lane in fresh:
            self._start(rs, lane, active=True)
        return len(resume) + len(fresh)

    def _admit_interleaved(self) -> int:
        """Interleaved admission: assign requests to free lanes and chunk
        their prompts on the host; the prefill itself rides in the
        coming mixed segments (zero dedicated dispatches). The lane was
        reset at retire time, so chunk-prefilling straight into it gives
        the tokens of one-shot prefill into a fresh state.
        Snapshot-holding requests are restored by one resume dispatch:
        they have no prompt left to prefill."""
        resume, fresh = self._take_admissions()
        if resume:
            self._resume_lanes(resume)
        C = self.serve.prefill_chunk
        for rs, lane in fresh:
            self.lane_prefill[lane] = _LanePrefill(
                *_chunk_prompt(rs.request.prompt, C))
            self._start(rs, lane, active=False)   # activates in the step
            #                                      that takes its last chunk
        return len(resume) + len(fresh)

    # ---------------------------------------------------------- decoding

    def _build_prefill_schedule(self, n_steps: int):
        """Lay this segment's prompt chunks onto the [n_steps, B] grid:
        one chunk per prefilling lane per step, lanes visited in
        sched_policy order, capped at serve.prefill_budget prompt tokens
        per segment (0 = unlimited; the first chunk of a segment always
        proceeds). Returns (chunks, n_valid, finish, the key chains of
        the lanes finishing in this segment [B, 2], the per-lane chunk
        counts to commit after the dispatch, the drain step: the first
        step with no chunk left)."""
        C = self.serve.prefill_chunk
        B = self.n_lanes
        chunks = np.zeros((n_steps, B, C), np.int32)
        nv = np.zeros((n_steps, B), np.int32)
        finish = np.zeros((n_steps, B), bool)
        new_keys = np.zeros((B, 2), np.uint32)
        budget = self.serve.prefill_budget
        lanes = [l for l in range(B) if self.lane_prefill[l] is not None]
        lanes.sort(key=lambda l: self._order_key(self.lane_req[l]))
        progress = {l: self.lane_prefill[l].next_chunk for l in lanes}
        spent, drain = 0, 0
        for j in range(n_steps):
            for lane in lanes:
                pf = self.lane_prefill[lane]
                i = progress[lane]
                if i >= pf.n_chunks:
                    continue
                tok_count = int(pf.n_valid[i])
                if budget > 0 and spent > 0 and spent + tok_count > budget:
                    continue
                chunks[j, lane] = pf.chunks[i]
                nv[j, lane] = tok_count
                if i == pf.n_chunks - 1:
                    finish[j, lane] = True
                    new_keys[lane] = _prng_keys(
                        [self.lane_req[lane].request.seed])[0]
                progress[lane] = i + 1
                spent += tok_count
                drain = j + 1
        scheduled = {l: progress[l] - self.lane_prefill[l].next_chunk
                     for l in lanes}
        return chunks, nv, finish, new_keys, scheduled, drain

    def _harvest(self, n_steps: int):
        """Read a dispatch's results back (the one sync of a dispatch)
        and take its carries into the host bookkeeping. Returns
        (ids, emitted, ok)."""
        active, n_emitted, ok, ids, emitted = self.lanes.download(n_steps)
        self.active, self.n_emitted = active, n_emitted
        return ids, emitted, ok

    def _dispatch_mixed(self, chunks, nv, finish, new_keys, scheduled):
        """One mixed prefill/decode dispatch running the prebuilt
        schedule (chunks [d, B, C], sliced to the drain step); commits
        the host-side chunk progress. Returns (ids, emitted, ok)."""
        self.eng.dispatch_count += 1
        self.n_segments += 1
        self.steps_run["mixed"] += int(chunks.shape[0])
        t0 = time.perf_counter()
        self.lanes.upload_carries(self.active, self.n_emitted, self.max_new,
                                  self.eos)
        self.lanes.run_mixed(chunks, nv, finish, new_keys,
                             greedy=self.greedy)
        self.enqueue_sec += time.perf_counter() - t0
        for lane, n in scheduled.items():
            pf = self.lane_prefill[lane]
            pf.next_chunk += n
            if pf.done:
                self.lane_prefill[lane] = None       # decoding now
        return self._harvest(int(chunks.shape[0]))

    def _dispatch_decode(self, n_steps: int):
        """One pure-decode dispatch of n_steps steps (a full segment, or
        the drained remainder of a split interleaved segment). The
        remainder's bucket is the JAX package's power of two; its masked
        tail is the identity and is not replayed."""
        seg = self.serve.decode_segment
        if n_steps >= seg:
            bucket = n_steps
        else:
            bucket = min(1 << (n_steps - 1).bit_length(), seg)
        self.decode_bucket_lengths.add(bucket)
        self.eng.dispatch_count += 1
        self.n_segments += 1
        self.steps_run["segment"] += n_steps
        t0 = time.perf_counter()
        self.lanes.upload_carries(self.active, self.n_emitted, self.max_new,
                                  self.eos)
        self.lanes.run_segment(n_steps, greedy=self.greedy)
        self.enqueue_sec += time.perf_counter() - t0
        return self._harvest(n_steps)

    def _quarantine(self, bad: List[int]) -> None:
        """Recover lanes whose segment produced non-finite outputs:
        scrub their state (reset + K/V zeroed, one dispatch), discard
        this segment's emissions, and replay each request from its last
        stored snapshot (or from scratch) unless it has used
        serve_cfg.max_retries; then it is FAILED."""
        mask = np.zeros(self.n_lanes, bool)
        mask[bad] = True
        self.eng.dispatch_count += 1
        self.n_resets += 1
        self.lanes.scrub(torch.as_tensor(mask, device=self.lanes.tok.device))
        self.n_quarantined += len(bad)
        now = self._now()
        for lane in bad:
            rs = self.lane_req[lane]
            self.lane_req[lane] = None
            self.lane_prefill[lane] = None
            self.active[lane] = False
            rs.lane = -1
            rs.n_retries += 1
            if rs.n_retries > self.serve.max_retries:
                rs.status, rs.finish_sec = Status.FAILED, now
                rs.reason = (f"non-finite outputs persisted after "
                             f"{self.serve.max_retries} replays")
                self.store.drop(rs.rid)
                self.n_failed += 1
                continue
            rs.status = Status.QUEUED
            n_tok = self.store.peek_n_tokens(rs.rid)
            if n_tok is not None:
                # replay from the last stored checkpoint: roll the host
                # stream back to it (the slab is verified at the fetch)
                del rs.tokens[n_tok:]
            else:
                rs.tokens.clear()
                rs.admit_sec = rs.first_token_sec = None
                rs.first_emit_step = None
            self.queue.append(rs)

    def _run_segment(self) -> List[RequestState]:
        """One logical segment (serve.decode_segment steps) over all
        lanes: plain decode, or, while any lane is still prefilling
        (interleaved admission), the mixed programs up to the drain step
        and the pure-decode program for the rest (each half one
        dispatch). Harvest emissions, quarantine lanes whose health flag
        tripped, retire lanes that finished inside the segment, and
        every serve.checkpoint_every segments snapshot the decoding
        lanes; TTFT derives from each lane's first-emission step,
        interpolated over the segment's wall time."""
        n_steps = self.serve.decode_segment
        prefilling = any(pf is not None for pf in self.lane_prefill)
        t_seg0 = self._now()
        if prefilling:
            chunks, nv, finish, new_keys, scheduled, drain = \
                self._build_prefill_schedule(n_steps)
            ids, emitted, ok = self._dispatch_mixed(
                chunks[:drain], nv[:drain], finish[:drain], new_keys,
                scheduled)
            if drain < n_steps:
                self.n_segment_splits += 1
                ids2, emitted2, ok2 = self._dispatch_decode(n_steps - drain)
                ids = np.concatenate([ids, ids2], axis=1)
                emitted = np.concatenate([emitted, emitted2], axis=1)
                ok = ok & ok2
        else:
            ids, emitted, ok = self._dispatch_decode(n_steps)
        bad = [l for l in range(self.n_lanes)
               if not ok[l] and self.lane_req[l] is not None]
        finished, retired_lanes, now = [], [], self._now()
        for lane in range(self.n_lanes):
            rs = self.lane_req[lane]
            if rs is None or lane in bad:
                continue                 # bad lanes: emissions suspect
            new_toks = ids[lane][emitted[lane]]
            if new_toks.size and not rs.tokens:
                j0 = int(np.argmax(emitted[lane]))
                rs.first_emit_step = self._steps_done + j0
                rs.first_token_sec = t_seg0 + (now - t_seg0) * \
                    (j0 + 1) / ids.shape[1]
            rs.tokens.extend(int(x) for x in new_toks)
            if not self.active[lane] and self.lane_prefill[lane] is None:
                rs.status, rs.finish_sec, rs.lane = Status.DONE, now, -1
                self.lane_req[lane] = None
                self.store.drop(rs.rid)  # release snapshots, every tier
                finished.append(rs)
                retired_lanes.append(lane)
        self._steps_done += ids.shape[1]
        if bad:
            self._quarantine(bad)
        if retired_lanes:
            self._reset_lanes(retired_lanes)
        every = self.serve.checkpoint_every
        if every > 0 and self.n_segments % every == 0:
            decoding = [l for l in range(self.n_lanes)
                        if self.lane_req[l] is not None
                        and self.lane_prefill[l] is None
                        and self.active[l]]
            if decoding:
                # a fault replays from here instead of from scratch
                self._swap_out(decoding, kind="checkpoint")
        return finished

    # --------------------------------------------------------- top level

    def step(self) -> List[RequestState]:
        """One scheduling round: let the fault injector act, expire
        timeouts, preempt if an SLO demands it, admit or resume into
        free lanes, then run one segment. Returns the requests that
        finished."""
        if self.injector is not None:
            self.injector.on_step(self)
        self._expire_timeouts()
        self._maybe_preempt()
        if self.interleaved:
            self._admit_interleaved()
            if self.active.any() or any(pf is not None
                                        for pf in self.lane_prefill):
                return self._run_segment()
            return []
        self._admit()
        if self.active.any():
            return self._run_segment()
        return []

    def stats(self) -> Dict[str, int]:
        """The JAX scheduler's counters, the snapshot store's prefixed
        store_ (without its prefix-cache entries: not ported)."""
        out = {
            "n_prefill_rounds": self.n_prefill_rounds,
            "n_segments": self.n_segments,
            "n_segment_splits": self.n_segment_splits,
            "n_resets": self.n_resets,
            "n_preempted": self.n_preempted,
            "n_swaps": self.n_swaps,
            "n_resumes": self.n_resumes,
            "n_shed": self.n_shed,
            "n_quarantined": self.n_quarantined,
            "n_timeouts": self.n_timeouts,
            "n_failed": self.n_failed,
            "n_faults_injected": self.n_faults_injected,
            "n_retries": sum(rs.n_retries for rs in self.results.values()),
            "n_snapshot_lost": self.n_snapshot_lost,
            "n_recovered_sessions": self.n_recovered_sessions,
            "n_verify_rounds": self.n_verify_rounds,
            "n_spec_rounds": self.n_spec_rounds,
            "n_spec_tokens": self.n_spec_tokens,
        }
        out.update({f"store_{k}": v for k, v in self.store.stats().items()})
        return out

    def run(self, requests: Iterable[Request] = (),
            respect_arrivals: bool = False) -> Dict[int, RequestState]:
        """Drain: serve every given (plus already queued) request to a
        terminal status and return {rid: RequestState}. With
        respect_arrivals, each request is submitted once wall-clock
        reaches its `arrival` offset (fast-forwarding when the lanes go
        idle). Arrivals wait while the queue is at max_queue. Requests
        PARKED via park() stay parked. The snapshot writer is drained
        before returning, so parked and checkpointed sessions are on
        disk."""
        pending = sorted(requests, key=lambda r: r.arrival)
        pending.reverse()                # pop() takes the earliest
        with torch.no_grad():
            while pending or self.queue or self.n_running:
                now = self._now()
                while pending and (not respect_arrivals or
                                   pending[-1].arrival <= now or self.idle):
                    if len(self.queue) >= self.serve.max_queue:
                        break
                    self.submit(pending.pop())
                self.step()
        self.store.flush()
        return self.results


def warm_up(engine: Engine, n_lanes: int, requests: List[Request], *,
            interleaved: Optional[bool] = None, greedy: bool = True) -> None:
    """Run the lane programs of one admission mode once before a measured
    run: a drain of the first two requests cut to max_new 2 (phased: the
    chunk and segment programs; interleaved: the mixed programs and the
    segment program of a split). On the card the first run of a program
    captures its graph, so the measured run only replays."""
    warm = [dataclasses.replace(r, max_new=2) for r in requests[:2]]
    sched = Scheduler(engine, n_lanes, interleaved=interleaved,
                      greedy=greedy)
    sched.run(warm)
    sched.close()
