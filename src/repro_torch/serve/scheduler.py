"""Lane-based continuous batching over the serving step programs, with
SLO-aware admission and recompute-style preemption.

Ported from ``repro/serve/scheduler.py``. The `Scheduler` owns B fixed
LANES (the batch dim of one static decode state, ``Engine.lane_closures``).
Each lane holds at most one in-flight request; the scheduler

  1. ADMITS queued requests into free lanes in `sched_policy` order
     (fifo | priority | edf). Phased mode packs their ragged prompts
     into ONE padded chunk grid and prefills it as one admission
     dispatch (the chunk program, one replay per chunk, then the first
     tokens) before decoding resumes; INTERLEAVED mode
     (ServeConfig.interleaved / Scheduler(interleaved=True)) threads
     one prompt chunk per admitting lane into each step of the next
     segments (the mixed programs), bounded by `prefill_budget` tokens
     per segment, so a long prompt never stalls in-flight decodes;
  2. runs bounded DECODE SEGMENTS (the segment program, replayed once
     per step, or the mixed programs while any lane is still
     prefilling): serve_cfg.decode_segment steps with per-lane active
     masks, clocks, max_new and eos. Remainder segments (the
     pure-decode half of a drain-split) are rounded up to power-of-two
     buckets as the JAX package does (`decode_bucket_lengths`); the
     masked tail of a bucket is the identity, so it is not replayed;
  3. RETIRES lanes whose request emitted its eos_id or max_new-th token
     at the segment boundary (pos := -1, one reset dispatch) and
     immediately refills them. Under priority/edf it may also PREEMPT
     the worst running lane when a strictly better-ranked request waits
     with no free lane: the victim restarts from scratch
     (recompute-style, swap_preempt=False), so its final output stays
     token-identical to an uninterrupted run.

Dispatch accounting: every dispatch bumps the Engine's
`dispatch_count`, and the total is n_prefill_rounds + n_segments +
n_resets, the JAX scheduler's formula with no swaps, resumes or prefix
traffic. Interleaved mode keeps n_prefill_rounds at 0. `steps_run`
counts the step programs run by kind (replays on the card), from which
the kernel launches of a run follow: per layer one decode launch per
segment step, one chunk launch per chunk step, both per mixed step.

Correctness contract: each request's output is token-identical to a
one-shot `Engine.generate(prompt[None], max_new, chunked=True)`
(truncated at its eos), in both admission modes, any admission order
and under preemption, where both runs make the same rounding (on the
CPU, and in float32 on the card). On the card in bf16 a lane batch of B
and a one-shot batch of 1 run different kernels (the decode kernel's
split plan and cuBLAS's choice depend on B), so a token may differ
after a near tie.

`continuous=False` degrades the same machinery to static batching
(admission waits until every lane is free).

Not ported yet; each raises NotImplementedError naming its ROADMAP
queue 1 item where it would act: swap preemption, park / revive and
checkpoints (the snapshot store), fault injection and quarantine, the
prefix cache, speculative decoding, sampled lanes and cross-memory
families.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.serve.engine import Engine
from repro_torch.serve.request import Request, RequestState, Status

SCHED_POLICIES = ("fifo", "priority", "edf")
SHED_POLICIES = ("reject", "evict")
STORE_ITEM = "ROADMAP queue 1: swap preemption, park/revive and recovery " \
    "with serve/store.py"


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
        if injector is not None:
            raise _not_ported("fault injection and quarantine",
                              "ROADMAP queue 1, fault quarantine")
        if self.serve.prefix_cache_bytes > 0:
            raise _not_ported("the prefix cache",
                              "ROADMAP queue 1, prefix cache")
        if self.serve.spec_k > 0:
            raise _not_ported("speculative decoding",
                              "ROADMAP queue 1, speculative decoding")
        if (self.serve.checkpoint_every > 0 or self.serve.snapshot_dir
                or self.serve.snapshot_host_bytes > 0):
            raise _not_ported("lane snapshots", STORE_ITEM)
        self.greedy = greedy or self.serve.temperature == 0.0
        # the step programs and their static lane state live on the
        # Engine, so successive schedulers share one set of graphs; a new
        # scheduler starts from fresh lanes
        self.lanes = engine.lane_closures(self.greedy, n_lanes)
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

    def park(self, rid: int) -> RequestState:
        raise _not_ported("park", STORE_ITEM)

    def revive(self, rid: int) -> RequestState:
        raise _not_ported("revive", STORE_ITEM)

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
        request waits with no free lane. Victims restart from scratch
        (recompute-style); a decoding victim under swap_preempt would be
        swapped out to a snapshot, which is not ported and raises. All
        victims share one reset dispatch."""
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
        if self.serve.swap_preempt and any(self.lane_prefill[l] is None
                                           for l in victims):
            raise _not_ported("swap preemption (swap_preempt=True)",
                              STORE_ITEM)
        self._reset_lanes(victims)
        for lane in victims:
            rs = self.lane_req[lane]
            rs.status, rs.lane = Status.QUEUED, -1
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
        their lanes with one reset dispatch. Terminal status TIMED_OUT."""
        now = self._now()

        def expired(rs):
            tm = rs.request.timeout_ms
            return tm is not None and (now - rs.submit_sec) * 1e3 > tm

        for rs in [q for q in self.queue if expired(q)]:
            self.queue.remove(rs)
            rs.status, rs.finish_sec = Status.TIMED_OUT, now
            rs.reason = (f"exceeded timeout_ms="
                         f"{rs.request.timeout_ms} while queued")
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

    def _take_admissions(self) -> List[Tuple[RequestState, int]]:
        """Pop up to len(free) queued requests in _order_key order and
        assign them to free lanes (every admission is fresh: without a
        snapshot store nothing resumes)."""
        free = self._claim_lanes()
        k = min(len(free), len(self.queue))
        return [(self._pop_next(), lane) for lane in free[:k]]

    def _start(self, rs: RequestState, lane: int, active: bool) -> None:
        rs.status, rs.lane, rs.admit_sec = Status.RUNNING, lane, self._now()
        self.lane_req[lane] = rs
        self.active[lane] = active
        self.n_emitted[lane] = 0
        self.max_new[lane] = rs.request.max_new
        self.eos[lane] = rs.request.eos_id

    def _admit(self) -> int:
        """Phased admission: fill free lanes from the queue. The whole
        admission batch (ragged prefill and first tokens) is ONE
        dispatch however many requests it packs; decode lanes sit idle
        while it runs."""
        fresh = self._take_admissions()
        if not fresh:
            return 0
        chunks, n_valid = self._pack_prompts([(l, rs) for rs, l in fresh])
        mask = np.zeros(self.n_lanes, bool)
        mask[[lane for _, lane in fresh]] = True
        self.eng.dispatch_count += 1
        self.n_prefill_rounds += 1
        self.steps_run["chunk"] += int(n_valid.any(axis=1).sum())
        self.lanes.admit(chunks, n_valid, mask)
        for rs, lane in fresh:
            self._start(rs, lane, active=True)
        return len(fresh)

    def _admit_interleaved(self) -> int:
        """Interleaved admission: assign requests to free lanes and chunk
        their prompts on the host; the prefill itself rides in the
        coming mixed segments (zero dedicated dispatches). The lane was
        reset at retire time, so chunk-prefilling straight into it gives
        the tokens of one-shot prefill into a fresh state."""
        fresh = self._take_admissions()
        C = self.serve.prefill_chunk
        for rs, lane in fresh:
            self.lane_prefill[lane] = _LanePrefill(
                *_chunk_prompt(rs.request.prompt, C))
            self._start(rs, lane, active=False)   # activates in the step
            #                                      that takes its last chunk
        return len(fresh)

    # ---------------------------------------------------------- decoding

    def _build_prefill_schedule(self, n_steps: int):
        """Lay this segment's prompt chunks onto the [n_steps, B] grid:
        one chunk per prefilling lane per step, lanes visited in
        sched_policy order, capped at serve.prefill_budget prompt tokens
        per segment (0 = unlimited; the first chunk of a segment always
        proceeds). Returns (chunks, n_valid, finish, the per-lane chunk
        counts to commit after the dispatch, the drain step: the first
        step with no chunk left)."""
        C = self.serve.prefill_chunk
        B = self.n_lanes
        chunks = np.zeros((n_steps, B, C), np.int32)
        nv = np.zeros((n_steps, B), np.int32)
        finish = np.zeros((n_steps, B), bool)
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
                progress[lane] = i + 1
                spent += tok_count
                drain = j + 1
        scheduled = {l: progress[l] - self.lane_prefill[l].next_chunk
                     for l in lanes}
        return chunks, nv, finish, scheduled, drain

    def _harvest(self, n_steps: int):
        """Read a dispatch's results back (the one sync of a dispatch)
        and take its carries into the host bookkeeping. Returns
        (ids, emitted, ok)."""
        active, n_emitted, ok, ids, emitted = self.lanes.download(n_steps)
        self.active, self.n_emitted = active, n_emitted
        return ids, emitted, ok

    def _dispatch_mixed(self, chunks, nv, finish, scheduled):
        """One mixed prefill/decode dispatch running the prebuilt
        schedule (chunks [d, B, C], sliced to the drain step); commits
        the host-side chunk progress. Returns (ids, emitted, ok)."""
        self.eng.dispatch_count += 1
        self.n_segments += 1
        self.steps_run["mixed"] += int(chunks.shape[0])
        t0 = time.perf_counter()
        self.lanes.upload_carries(self.active, self.n_emitted, self.max_new,
                                  self.eos)
        self.lanes.run_mixed(chunks, nv, finish)
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
        self.lanes.run_segment(n_steps)
        self.enqueue_sec += time.perf_counter() - t0
        return self._harvest(n_steps)

    def _run_segment(self) -> List[RequestState]:
        """One logical segment (serve.decode_segment steps) over all
        lanes: plain decode, or, while any lane is still prefilling
        (interleaved admission), the mixed programs up to the drain step
        and the pure-decode program for the rest (each half one
        dispatch). Harvest emissions and retire lanes that finished
        inside the segment; TTFT derives from each lane's first-emission
        step, interpolated over the segment's wall time. A lane whose
        logits were not finite stops the run: quarantine and replay are
        not ported."""
        n_steps = self.serve.decode_segment
        prefilling = any(pf is not None for pf in self.lane_prefill)
        t_seg0 = self._now()
        if prefilling:
            chunks, nv, finish, scheduled, drain = \
                self._build_prefill_schedule(n_steps)
            ids, emitted, ok = self._dispatch_mixed(
                chunks[:drain], nv[:drain], finish[:drain], scheduled)
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
        if bad:
            raise _not_ported(
                f"recovering lanes {bad} from non-finite logits (quarantine "
                f"and replay)", "ROADMAP queue 1, fault quarantine")
        finished, retired_lanes, now = [], [], self._now()
        for lane in range(self.n_lanes):
            rs = self.lane_req[lane]
            if rs is None:
                continue
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
                finished.append(rs)
                retired_lanes.append(lane)
        self._steps_done += ids.shape[1]
        if retired_lanes:
            self._reset_lanes(retired_lanes)
        return finished

    # --------------------------------------------------------- top level

    def step(self) -> List[RequestState]:
        """One scheduling round: expire timeouts, preempt if an SLO
        demands it, admit into free lanes, then run one segment. Returns
        the requests that finished."""
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
        """The JAX scheduler's counters (without its snapshot-store and
        prefix-cache entries, whose subsystems are not ported)."""
        return {
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

    def run(self, requests: Iterable[Request] = (),
            respect_arrivals: bool = False) -> Dict[int, RequestState]:
        """Drain: serve every given (plus already queued) request to a
        terminal status and return {rid: RequestState}. With
        respect_arrivals, each request is submitted once wall-clock
        reaches its `arrival` offset (fast-forwarding when the lanes go
        idle). Arrivals wait while the queue is at max_queue."""
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
        return self.results


def warm_up(engine: Engine, n_lanes: int, requests: List[Request], *,
            interleaved: Optional[bool] = None) -> None:
    """Run the lane programs of one admission mode once before a measured
    run: a drain of the first two requests cut to max_new 2 (phased: the
    chunk and segment programs; interleaved: the mixed programs and the
    segment program of a split). On the card the first run of a program
    captures its graph, so the measured run only replays."""
    warm = [dataclasses.replace(r, max_new=2) for r in requests[:2]]
    Scheduler(engine, n_lanes, interleaved=interleaved).run(warm)
