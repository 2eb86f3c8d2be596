"""Fault injection for the serving loop (chaos testing).

Ported from ``repro/serve/faults.py``. The supervision machinery itself
— non-finite detection, quarantine + replay, timeouts, load shedding —
lives in serve.scheduler; this module provides the adversary: a seeded,
deterministic `FaultInjector` the Scheduler calls at the top of every
step, able to

  * CORRUPT a decoding lane's KV cache (NaN-poison its K and V slots in
    place in the static state: the poisoned slots' attention scores go
    NaN, the softmax and p@v products follow, and the lane's logits
    come back non-finite, which the in-program `ok` health flag reports
    at the segment boundary). The JAX package poisons K alone; the V
    payload is poisoned too so that a quarantine which resets the
    lane's slots without zeroing their bytes shows: a reset slot is
    masked out of the scores, but its V still meets a zero weight in
    p@v, and 0 x NaN = NaN;
  * DELAY dispatches (host-side sleep, so per-request wall-clock
    timeouts actually fire under test);
  * BURST-SUBMIT oversized / malformed traffic through the ordinary
    submit path, exercising validation rejection and load shedding;
  * SILENTLY CORRUPT a stored snapshot: flip one seeded bit in a
    LaneSnapshot slab (the host-RAM copy or the at-rest disk file), a
    FINITE corruption that only the store's capture-time crc32 catches
    at resume;
  * INJECT IO ERRORS on the snapshot store's disk tier: arm the next
    slab write to fail (OSError, counted, RAM-only) or to silently
    truncate (the torn write the size/crc check catches on read).

Every injected fault is drawn from one seeded np.random.Generator, so a
chaos schedule replays exactly from its seed. The injector's poison
dispatches are counted on `Scheduler.n_faults_injected`, keeping the
scheduler's exact dispatch accounting intact under injection:

  dispatches == n_prefill_rounds + n_segments + n_resets
                + n_swaps + n_resumes + n_faults_injected
"""
from __future__ import annotations

import dataclasses
import time
from typing import List

import numpy as np
import torch

from repro_torch.serve.request import Request


def poison_lanes(state, lane_mask):
    """Overwrite the masked lanes' K and V slots with NaN, IN PLACE (the
    static state of captured programs keeps its addresses): occupied
    slots' scores then go NaN and the lane's next logits are
    non-finite, whatever the policy. Neighbor lanes untouched.
    lane_mask: [B] bool on the state's device. Returns the state."""
    m = lane_mask[:, None, None, None]
    for st in state["layers"]:
        if "k" in st:   # a recurrent layer has no K/V (JAX poisons "k" only)
            st["k"].masked_fill_(m, float("nan"))
            st["v"].masked_fill_(m, float("nan"))
    return state


@dataclasses.dataclass
class FaultInjector:
    """Seeded chaos adversary for a Scheduler. Attach via
    `Scheduler(..., injector=FaultInjector(seed=..., corrupt_prob=...))`
    or `launch/serve.py --stream --inject-faults`; every step it rolls
    each fault class independently against its probability knob."""
    seed: int = 0
    corrupt_prob: float = 0.0     # NaN-poison one random decoding lane
    delay_prob: float = 0.0       # sleep delay_sec before the segment
    delay_sec: float = 0.0
    burst_prob: float = 0.0       # burst-submit burst_size requests
    burst_size: int = 8
    max_bursts: int = 16          # total burst cap — keeps a chaos drain
    #                               finite even when the burst load alone
    #                               exceeds the lanes' service rate
    burst_prompt_len: int = 3     # valid burst prompts' length
    burst_max_new: int = 4
    burst_invalid_frac: float = 0.25  # fraction of burst requests that
    #                                   are MALFORMED (empty prompt /
    #                                   bad max_new) — must be REJECTED
    snap_corrupt_prob: float = 0.0  # flip one bit in a stored snapshot
    #                                 slab (RAM copy or at-rest disk
    #                                 file) — finite silent corruption,
    #                                 detectable only by checksum
    io_error_prob: float = 0.0      # arm a store disk fault: the next
    #                                 slab write fails (OSError) or
    #                                 silently truncates (torn write)

    def __post_init__(self):
        self.rng = np.random.default_rng(self.seed)
        self.n_corrupted = 0
        self.n_delayed = 0
        self.n_bursts = 0
        self.n_burst_submitted = 0
        self.n_snap_corrupted_ram = 0
        self.n_snap_corrupted_disk = 0
        self.n_io_errors_armed = 0
        self._rid = 1_000_000_000  # burst rid space, clear of user rids

    # ------------------------------------------------------------ hooks

    def on_step(self, sched) -> None:
        """Called by Scheduler.step() before supervision/admission."""
        if self.delay_prob > 0 and self.rng.random() < self.delay_prob:
            self.n_delayed += 1
            time.sleep(self.delay_sec)
        if (self.burst_prob > 0 and self.n_bursts < self.max_bursts
                and self.rng.random() < self.burst_prob):
            self.n_bursts += 1
            for r in self.make_burst(self.burst_size):
                sched.submit(r)
                self.n_burst_submitted += 1
        if self.corrupt_prob > 0 and self.rng.random() < self.corrupt_prob:
            self._corrupt_one(sched)
        if (self.snap_corrupt_prob > 0
                and self.rng.random() < self.snap_corrupt_prob):
            # host-side bit flip on a stored slab — zero dispatches, so
            # the exact dispatch formula is untouched; the store's own
            # chaos helper keeps the corruption model identical to the
            # unit tests'
            where = sched.store.chaos_corrupt(self.rng)
            if where == "ram":
                self.n_snap_corrupted_ram += 1
            elif where == "disk":
                self.n_snap_corrupted_disk += 1
        if self.io_error_prob > 0 and self.rng.random() < self.io_error_prob:
            mode = "fail" if self.rng.random() < 0.5 else "truncate"
            sched.store.chaos_arm_io_error(mode)
            self.n_io_errors_armed += 1

    def _corrupt_one(self, sched) -> None:
        """Poison one random DECODING lane's cache (mid-prefill and
        empty lanes are skipped: they have no occupied K slots to
        poison, so the fault would be a silent no-op)."""
        lanes = [l for l in range(sched.n_lanes)
                 if sched.lane_req[l] is not None
                 and sched.lane_prefill[l] is None and sched.active[l]]
        if not lanes:
            return
        mask = np.zeros(sched.n_lanes, bool)
        mask[int(self.rng.choice(lanes))] = True
        sched.eng.dispatch_count += 1
        sched.n_faults_injected += 1
        poison_lanes(sched.lanes.state,
                     torch.as_tensor(mask, device=sched.lanes.tok.device))
        self.n_corrupted += 1

    # ---------------------------------------------------------- traffic

    def make_burst(self, n: int, vocab: int = 64) -> List[Request]:
        """n requests of hostile traffic: mostly tiny valid requests
        (they flood the queue, exercising backpressure/shedding), a
        burst_invalid_frac slice malformed (empty prompt or max_new<1 —
        they must come back REJECTED with a reason, never crash)."""
        out = []
        for _ in range(n):
            self._rid += 1
            if self.rng.random() < self.burst_invalid_frac:
                if self.rng.random() < 0.5:
                    out.append(Request(rid=self._rid,
                                       prompt=np.zeros((0,), np.int32),
                                       max_new=self.burst_max_new))
                else:
                    out.append(Request(
                        rid=self._rid,
                        prompt=self.rng.integers(
                            1, vocab, self.burst_prompt_len).astype(
                                np.int32),
                        max_new=0))
            else:
                out.append(Request(
                    rid=self._rid,
                    prompt=self.rng.integers(
                        1, vocab, self.burst_prompt_len).astype(np.int32),
                    max_new=self.burst_max_new,
                    seed=int(self.rng.integers(0, 2**31))))
        return out
