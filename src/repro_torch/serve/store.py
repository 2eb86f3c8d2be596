"""Tiered snapshot store: checksummed host pool + disk spill.

Ported from ``repro/serve/store.py`` (numpy and the standard library
only; the port imports nothing of that package). The `SnapshotStore`
owns every LaneSnapshot of a Scheduler and tiers them

  RAM   — an LRU pool accounted in bytes against
          `ServeConfig.snapshot_host_bytes` (0 = unlimited). Hot
          snapshots (recent swap-outs, imminent resumes) stay here;
          `get` promotes on access.
  disk  — np.memmap slab files (one per request: the snapshot's state
          leaves concatenated in flatten order) plus one JSON manifest
          (`manifest.json`, atomically rewritten via tmp + os.replace)
          under `ServeConfig.snapshot_dir`. Durable kinds ("park",
          "checkpoint") write through on capture; transient swap-outs
          spill only under RAM pressure. All writes go through ONE
          bounded-queue writer thread — a full queue blocks the
          producer (backpressure) instead of growing without bound;
          `close` drains and joins it.

Integrity: every snapshot is content-checksummed AT CAPTURE —
`crc32` over the state leaves' bytes in flatten order (the slab crc)
plus a crc over the canonical metadata blob (leaf spec, carried token,
RNG chain, emission counts) — and VERIFIED on every `get`, whether the
copy comes from RAM or disk. A silently-corrupted-but-finite slab
therefore surfaces as a `get -> None` miss that the Scheduler routes
through its bounded replay (recompute from the prompt, terminal FAILED
after max_retries), instead of reviving as wrong tokens.

Degradation contract: the store NEVER raises into the serving loop.
IO errors, tier-full conditions, spec mismatches and corruption all
degrade to a miss plus a counter (`stats()`), and a miss just means
recompute-from-prompt — the request still terminates.

Crash-restart: a new store over the same directory replays the
manifest and exposes the recovered records via `recoverable()`; the
Scheduler turns them back into PARKED sessions whose revival is
bit-identical to an in-process resume (slabs are read lazily, verified
at `get`). The disk tier may LAG the RAM tier by design — it holds the
last durable capture — which is safe because generation is
deterministic from any snapshot point.

Chaos hooks (`serve.faults.FaultInjector`): `chaos_corrupt` flips one
seeded bit in a stored slab (RAM copy, or the at-rest disk file) and
`chaos_arm_io_error` makes the next disk write fail or silently
truncate.
"""
from __future__ import annotations

import dataclasses
import json
import os
import queue
import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serve.request import LaneSnapshot

# snapshot kinds — durable ones write through to disk on capture
DURABLE_KINDS = ("park", "checkpoint")

_MANIFEST = "manifest.json"


# ----------------------------------------------------------------- trees
#
# Snapshot states are trees of dicts and lists with numpy leaves: the
# port's decode state of one lane, {"t": [1], "layers": [one dict of
# k, v, beta, pos, aux per layer]} (bfloat16 leaves as int16 bits). They
# are serialized in FLATTEN ORDER: dict keys sorted, list items in
# order; paths are JSON ([["k", name] for dict keys, ["i", idx] for list
# items]), and the slab file is the leaves' bytes concatenated in that
# order. The JAX package's directories hold other paths and shapes (its
# layers stacked on a repeat axis, a "tail" tuple), so their records
# are fenced as an alien spec at read time.


def _walk(node, path):
    if isinstance(node, dict):
        for k in sorted(node):
            yield from _walk(node[k], path + [["k", str(k)]])
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _walk(v, path + [["i", i]])
    else:
        yield path, node


def flatten_state(state) -> List[Tuple[List[List[Any]], np.ndarray]]:
    """(json_path, leaf) pairs in canonical flatten order."""
    return [(path, np.asarray(leaf)) for path, leaf in _walk(state, [])]


def rebuild_state(paths: List[List[List[Any]]],
                  leaves: List[np.ndarray]) -> dict:
    """Invert flatten_state: nested dicts keyed by path steps, then
    "i"-keyed nodes collapse to lists (in index order)."""
    root: dict = {}
    for path, leaf in zip(paths, leaves):
        node = root
        for step in path[:-1]:
            node = node.setdefault(tuple(step), {})
        node[tuple(path[-1])] = leaf

    def finalize(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and keys[0][0] == "i":
            return [finalize(node[k])
                    for k in sorted(keys, key=lambda k: k[1])]
        return {k[1]: finalize(v) for k, v in node.items()}

    return finalize(root)


def state_spec(state) -> List[Dict[str, Any]]:
    """Leaf spec in flatten order: path / dtype / shape (JSON-able).
    Reads only each leaf's dtype and shape, so a Scheduler derives its
    EXPECTED single-lane spec from unwritten arrays."""
    return [{"path": path,
             "dtype": np.dtype(leaf.dtype).name,
             "shape": [int(s) for s in leaf.shape]}
            for path, leaf in _walk(state, [])]


def _spec_nbytes(spec) -> List[int]:
    return [int(np.dtype(e["dtype"]).itemsize * np.prod(e["shape"],
                                                        dtype=np.int64))
            for e in spec]


# ------------------------------------------------------------- checksums

def _meta_blob(spec, tok, key, n_emitted, n_tokens) -> bytes:
    """Canonical metadata blob: the leaf spec plus every scalar a
    resume depends on. Covered by meta_crc so a tampered manifest (or a
    stale spec) is as detectable as a tampered slab."""
    return json.dumps(
        {"spec": spec, "tok": int(tok), "key": [int(k) for k in key],
         "n_emitted": int(n_emitted), "n_tokens": int(n_tokens)},
        sort_keys=True, separators=(",", ":")).encode()


def checksum_snapshot(snap: LaneSnapshot) -> Tuple[int, int]:
    """(crc, meta_crc): crc32 over the state leaves' bytes in flatten
    order + crc32 over the metadata blob. Computed AT CAPTURE and
    stamped on the snapshot; verify_snapshot recomputes both."""
    crc = 0
    flat = flatten_state(snap.state)
    for _, leaf in flat:
        crc = zlib.crc32(leaf.tobytes(), crc)
    spec = state_spec(snap.state)
    meta_crc = zlib.crc32(_meta_blob(spec, snap.tok, snap.key,
                                     snap.n_emitted, snap.n_tokens))
    return crc, meta_crc


def verify_snapshot(snap: LaneSnapshot) -> bool:
    """True iff the snapshot's bytes + metadata still match the
    checksums stamped at capture (unstamped snapshots fail closed)."""
    if snap.crc is None or snap.meta_crc is None:
        return False
    crc, meta_crc = checksum_snapshot(snap)
    return crc == snap.crc and meta_crc == snap.meta_crc


def snapshot_nbytes(snap: LaneSnapshot) -> int:
    return sum(leaf.nbytes for _, leaf in flatten_state(snap.state))


# ----------------------------------------------------------- store entry

@dataclasses.dataclass
class _Entry:
    """One request's tier residency. snap None = spilled (disk only)."""
    snap: Optional[LaneSnapshot]
    nbytes: int
    kind: str
    request_meta: Optional[dict] = None  # JSON-able session metadata,
    tokens: tuple = ()                   # captured with the snapshot —
    #                                      what a crash-restart rebuilds
    #                                      the PARKED session from
    record: Optional[dict] = None    # manifest record once written
    on_disk: bool = False
    pending: int = 0                 # queued writes not yet completed


class SnapshotStore:
    """Tiered LaneSnapshot pool (see module docstring). Thread-safe
    between the serving loop and its single writer thread; all file IO
    happens on the writer, all lookups on the caller."""

    def __init__(self, host_bytes: int = 0,
                 directory: Optional[str] = None,
                 expected_spec: Optional[List[dict]] = None,
                 write_queue: int = 8):
        self.host_bytes = int(host_bytes)
        self.directory = directory
        self.expected_spec = expected_spec
        self._pool: Dict[int, _Entry] = {}   # insertion order = LRU
        self._lock = threading.RLock()
        self.ram_bytes = 0
        # structured degradation counters (never raise; always count)
        self.n_puts = 0
        self.n_ram_hits = 0
        self.n_disk_hits = 0
        self.n_misses = 0
        self.n_spills = 0            # writes enqueued (durable + pressure)
        self.n_evictions = 0         # RAM copies freed (disk copy kept)
        self.n_dropped = 0           # evicted with NO disk tier: the
        #                              snapshot is lost and the request
        #                              falls back to recompute-from-prompt
        self.n_corrupt_detected = 0  # checksum / size verification failures
        self.n_spec_mismatch = 0     # disk record from another config
        self.n_write_errors = 0      # failed slab/manifest writes
        self.n_io_errors = 0         # failed reads / unparsable manifest
        self.n_backpressure = 0      # producer blocked on a full queue
        self.n_recovered = 0         # manifest records adopted at init
        self.n_recover_skipped = 0   # records dropped at init (bad file)
        # chaos hooks (FaultInjector)
        self._fault_next_write: Optional[str] = None
        self.n_chaos_corrupted = 0
        self._writer: Optional[threading.Thread] = None
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, write_queue))
        if self.directory is not None:
            os.makedirs(self.directory, exist_ok=True)
            self._recover_manifest()

    # ------------------------------------------------------------ public

    def put(self, rid: int, snap: LaneSnapshot, *, request_meta=None,
            tokens=(), kind: str = "swap") -> None:
        """Adopt a freshly captured snapshot: stamp its checksums, take
        RAM ownership (replacing any previous capture for this rid),
        write through to disk for durable kinds, then enforce the RAM
        budget. request_meta/tokens are what a crash-restart needs to
        rebuild the PARKED session (see Scheduler recovery)."""
        snap.crc, snap.meta_crc = checksum_snapshot(snap)
        nbytes = snapshot_nbytes(snap)
        with self._lock:
            old = self._pool.pop(rid, None)
            if old is not None and old.snap is not None:
                self.ram_bytes -= old.nbytes
            entry = _Entry(snap=snap, nbytes=nbytes, kind=kind,
                           request_meta=request_meta,
                           tokens=tuple(int(t) for t in tokens))
            if old is not None:
                # keep the previous durable copy visible until (and
                # unless) a newer write replaces it: deterministic
                # replay makes resuming an older capture safe
                entry.on_disk, entry.record = old.on_disk, old.record
                entry.pending = old.pending
                if request_meta is None:
                    entry.request_meta = old.request_meta
                    entry.tokens = old.tokens
            self._pool[rid] = entry
            self.ram_bytes += nbytes
            self.n_puts += 1
        if kind in DURABLE_KINDS and self.directory is not None:
            self._enqueue_write(rid, snap, kind)
        self._evict_to_budget()

    def get(self, rid: int) -> Optional[LaneSnapshot]:
        """Fetch-and-verify: RAM hit (promote) -> disk hit (read,
        verify, promote into RAM) -> None. ANY verification failure —
        bad crc, bad size, alien spec — discards the copy, bumps a
        counter and returns None; the caller treats that exactly like
        a missing snapshot (recompute-from-prompt via bounded replay)."""
        corrupt = False
        with self._lock:
            entry = self._pool.get(rid)
            if entry is None:
                self.n_misses += 1
                return None
            if entry.snap is not None:
                if verify_snapshot(entry.snap):
                    self._pool[rid] = self._pool.pop(rid)  # LRU promote
                    self.n_ram_hits += 1
                    return entry.snap
                self.n_corrupt_detected += 1
                corrupt = True
            record = entry.record
        if corrupt:
            self._discard(rid)
            return None
        # disk tier — IO outside the lock
        snap = self._read_slab(record) if record is not None else None
        if snap is None:
            self._discard(rid)
            return None
        with self._lock:
            entry = self._pool.get(rid)
            if entry is None:            # dropped while reading
                self.n_misses += 1
                return None
            entry.snap = snap
            self.ram_bytes += entry.nbytes
            self._pool[rid] = self._pool.pop(rid)
            self.n_disk_hits += 1
        self._evict_to_budget()
        return snap

    def has(self, rid: int) -> bool:
        with self._lock:
            return rid in self._pool

    def peek_n_tokens(self, rid: int) -> Optional[int]:
        """n_tokens without a verify/read — the quarantine rollback
        point (verification happens at the subsequent get)."""
        with self._lock:
            entry = self._pool.get(rid)
            if entry is None:
                return None
            if entry.snap is not None:
                return entry.snap.n_tokens
            return int(entry.record["n_tokens"])

    def drop(self, rid: int) -> None:
        """Release a request's snapshots in every tier (terminal
        statuses, recompute preemption). Disk deletion rides the writer
        queue so the serving loop never blocks on the filesystem."""
        with self._lock:
            entry = self._pool.pop(rid, None)
            if entry is None:
                return
            if entry.snap is not None:
                self.ram_bytes -= entry.nbytes
            on_disk = entry.on_disk or entry.pending > 0
        if on_disk and self.directory is not None:
            self._submit_job(("drop", rid))

    def recoverable(self) -> List[dict]:
        """Manifest records adopted at construction (sorted by rid) —
        what a restarted Scheduler turns back into PARKED sessions.
        Slabs are NOT read here; get() verifies on revival."""
        with self._lock:
            return sorted((dict(e.record) for e in self._pool.values()
                           if e.record is not None and e.snap is None),
                          key=lambda r: r["rid"])

    def flush(self) -> None:
        """Drain the writer queue (tests / clean handoff of a dir)."""
        if self._writer is not None:
            self._q.join()

    def close(self) -> None:
        """Drain the writer queue and stop and join the writer thread
        (a later write starts a new one)."""
        if self._writer is None:
            return
        self._q.put(("stop",))
        self._writer.join()
        self._writer = None

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "puts": self.n_puts,
                "ram_hits": self.n_ram_hits,
                "disk_hits": self.n_disk_hits,
                "misses": self.n_misses,
                "spills": self.n_spills,
                "evictions": self.n_evictions,
                "dropped": self.n_dropped,
                "corrupt_detected": self.n_corrupt_detected,
                "spec_mismatch": self.n_spec_mismatch,
                "write_errors": self.n_write_errors,
                "io_errors": self.n_io_errors,
                "backpressure": self.n_backpressure,
                "recovered": self.n_recovered,
                "recover_skipped": self.n_recover_skipped,
                "chaos_corrupted": self.n_chaos_corrupted,
                "ram_bytes": self.ram_bytes,
                "entries": len(self._pool),
            }

    # ------------------------------------------------------- chaos hooks

    def chaos_corrupt(self, rng: np.random.Generator,
                      rid: Optional[int] = None) -> Optional[str]:
        """Flip ONE seeded bit in a stored snapshot — the RAM copy when
        resident, else the at-rest disk slab. Returns "ram"/"disk"/None
        (nothing stored). This is the FINITE silent-corruption fault the
        checksum exists to catch; tests and the FaultInjector both go
        through here so the corruption model is identical."""
        with self._lock:
            rids = sorted(self._pool) if rid is None else [rid]
            rids = [r for r in rids if r in self._pool]
            if not rids:
                return None
            rid = int(rng.choice(rids))
            entry = self._pool[rid]
            if entry.snap is not None:
                flat = flatten_state(entry.snap.state)
                paths = [p for p, _ in flat]
                leaves = [l for _, l in flat]
                i = int(rng.integers(len(leaves)))
                buf = np.array(leaves[i])          # device_get views are
                #                                    read-only: copy-flip
                raw = buf.view(np.uint8).reshape(-1)
                raw[int(rng.integers(raw.size))] ^= np.uint8(
                    1 << int(rng.integers(8)))
                leaves[i] = buf
                entry.snap.state = rebuild_state(paths, leaves)
                self.n_chaos_corrupted += 1
                return "ram"
            record = entry.record
        if record is None or self.directory is None:
            return None
        path = os.path.join(self.directory, record["slab"])
        try:
            with open(path, "r+b") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                if size == 0:
                    return None
                off = int(rng.integers(size))
                f.seek(off)
                byte = f.read(1)
                f.seek(off)
                f.write(bytes([byte[0] ^ (1 << int(rng.integers(8)))]))
        except OSError:
            return None
        with self._lock:
            self.n_chaos_corrupted += 1
        return "disk"

    def chaos_arm_io_error(self, mode: str) -> None:
        """Make the NEXT slab write misbehave: "fail" (OSError, caught
        and counted) or "truncate" (half the bytes land, write reports
        success — the torn-write case the size/crc check catches)."""
        assert mode in ("fail", "truncate")
        self._fault_next_write = mode

    # -------------------------------------------------------- RAM budget

    def _evict_to_budget(self) -> None:
        """Walk LRU order until ram_bytes fits host_bytes: free copies
        already on disk; schedule a spill for ones that are not (their
        RAM copy is freed once the write lands); with NO disk tier the
        coldest entry is dropped outright (counted — the request will
        recompute from its prompt)."""
        if self.host_bytes <= 0:
            return
        jobs = []
        with self._lock:
            for rid in list(self._pool):
                if self.ram_bytes <= self.host_bytes:
                    break
                entry = self._pool[rid]
                if entry.snap is None:
                    continue
                if entry.on_disk:
                    entry.snap = None
                    self.ram_bytes -= entry.nbytes
                    self.n_evictions += 1
                elif self.directory is not None:
                    if entry.pending == 0:
                        jobs.append((rid, entry.snap, entry.kind))
                else:
                    self._pool.pop(rid)
                    self.ram_bytes -= entry.nbytes
                    self.n_dropped += 1
        for rid, snap, kind in jobs:
            self._enqueue_write(rid, snap, kind)

    # ------------------------------------------------------- disk writer

    def _writer_loop(self) -> None:
        while True:
            job = self._q.get()
            try:
                if job[0] == "stop":
                    return
                if job[0] == "write":
                    self._do_write(*job[1:])
                elif job[0] == "drop":
                    self._do_drop(job[1])
            except Exception:            # never kill the writer: the
                with self._lock:         # serving loop must outlive any
                    self.n_write_errors += 1  # disk failure
            finally:
                self._q.task_done()

    def _submit_job(self, job) -> None:
        if self._writer is None:
            self._writer = threading.Thread(
                target=self._writer_loop, daemon=True,
                name="snapshot-store-writer")
            self._writer.start()
        try:
            self._q.put_nowait(job)
        except queue.Full:
            with self._lock:
                self.n_backpressure += 1
            self._q.put(job)             # bounded queue: block, don't grow

    def _enqueue_write(self, rid, snap, kind) -> None:
        """Serialize on the PRODUCER (so later mutations can't race the
        writer) and hand the bytes + manifest record to the queue."""
        flat = flatten_state(snap.state)
        spec = state_spec(snap.state)
        sizes = _spec_nbytes(spec)
        offset = 0
        for e, sz in zip(spec, sizes):
            e["offset"], offset = offset, offset + sz
        blob = b"".join(leaf.tobytes() for _, leaf in flat)
        with self._lock:
            entry = self._pool.get(rid)
            if entry is None:
                return
            record = {
                "rid": int(rid), "kind": kind, "slab": f"snap_{rid}.bin",
                "nbytes": len(blob), "crc": int(snap.crc),
                "meta_crc": int(snap.meta_crc),
                "tok": int(snap.tok), "key": [int(k) for k in snap.key],
                "n_emitted": int(snap.n_emitted),
                "n_tokens": int(snap.n_tokens),
                "leaves": spec,
                "tokens": list(entry.tokens),
                "request": entry.request_meta,
            }
            entry.pending += 1
            self.n_spills += 1
        self._submit_job(("write", rid, blob, record))

    def _do_write(self, rid: int, blob: bytes, record: dict) -> None:
        fault, self._fault_next_write = self._fault_next_write, None
        path = os.path.join(self.directory, record["slab"])
        tmp = path + ".tmp"
        try:
            if fault == "fail":
                raise OSError("injected write failure")
            data = blob if fault != "truncate" else blob[: len(blob) // 2]
            mm = np.memmap(tmp, dtype=np.uint8, mode="w+",
                           shape=(max(len(data), 1),))
            mm[: len(data)] = np.frombuffer(data, np.uint8)
            mm.flush()
            del mm
            os.replace(tmp, path)
        except OSError:
            with self._lock:
                self.n_write_errors += 1
                entry = self._pool.get(rid)
                if entry is not None:
                    entry.pending = max(0, entry.pending - 1)
            return                       # RAM copy (if any) stays sole
        with self._lock:
            entry = self._pool.get(rid)
            if entry is not None:
                entry.pending = max(0, entry.pending - 1)
                entry.on_disk = True
                entry.record = record
        self._rewrite_manifest()

    def _do_drop(self, rid: int) -> None:
        try:
            os.remove(os.path.join(self.directory, f"snap_{rid}.bin"))
        except OSError:
            pass
        self._rewrite_manifest()

    def _rewrite_manifest(self) -> None:
        with self._lock:
            records = [e.record for e in self._pool.values()
                       if e.record is not None]
        path = os.path.join(self.directory, _MANIFEST)
        tmp = path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump({"version": 1, "snapshots": records}, f)
            os.replace(tmp, path)
        except OSError:
            with self._lock:
                self.n_write_errors += 1

    # ----------------------------------------------------- disk recovery

    def _recover_manifest(self) -> None:
        """Adopt the directory's manifest: records whose slab exists at
        its full recorded size become disk-tier entries (read + verified
        lazily at get); anything torn or missing is skipped WITH a
        counter — a partially-written snapshot must never wedge or
        crash a restart."""
        path = os.path.join(self.directory, _MANIFEST)
        if not os.path.exists(path):
            return
        try:
            with open(path) as f:
                records = json.load(f).get("snapshots", [])
        except (OSError, ValueError):
            self.n_io_errors += 1
            return
        for record in records:
            try:
                rid = int(record["rid"])
                slab = os.path.join(self.directory, record["slab"])
                if os.path.getsize(slab) != max(int(record["nbytes"]), 1):
                    raise ValueError("slab size mismatch")
                nbytes = int(record["nbytes"])
            except (OSError, ValueError, KeyError, TypeError):
                self.n_recover_skipped += 1
                continue
            self._pool[rid] = _Entry(snap=None, nbytes=nbytes,
                                     kind=record.get("kind", "park"),
                                     record=record, on_disk=True)
            self.n_recovered += 1

    def _read_slab(self, record: dict) -> Optional[LaneSnapshot]:
        """Disk -> verified LaneSnapshot, or None (+ the right counter):
        size mismatch / bad crc -> corruption; alien leaf spec -> spec
        mismatch; unreadable file -> IO error."""
        if self.directory is None:
            return None
        spec = record["leaves"]
        if (self.expected_spec is not None
                and [{k: e[k] for k in ("path", "dtype", "shape")}
                     for e in spec] != self.expected_spec):
            with self._lock:
                self.n_spec_mismatch += 1
            return None
        path = os.path.join(self.directory, record["slab"])
        try:
            mm = np.memmap(path, dtype=np.uint8, mode="r")
            raw = bytes(mm)
            del mm
        except (OSError, ValueError):
            with self._lock:
                self.n_io_errors += 1
            return None
        if len(raw) != int(record["nbytes"]) or \
                zlib.crc32(raw) != int(record["crc"]):
            with self._lock:
                self.n_corrupt_detected += 1
            return None
        leaves, paths = [], []
        for e in spec:
            dt = np.dtype(e["dtype"])
            size = int(dt.itemsize * np.prod(e["shape"], dtype=np.int64))
            off = int(e["offset"])
            leaves.append(np.frombuffer(
                raw[off: off + size], dt).reshape(e["shape"]).copy())
            paths.append(e["path"])
        snap = LaneSnapshot(
            state=rebuild_state(paths, leaves),
            tok=np.int32(record["tok"]),
            key=np.asarray(record["key"], np.uint32),
            n_emitted=int(record["n_emitted"]),
            n_tokens=int(record["n_tokens"]),
            crc=int(record["crc"]), meta_crc=int(record["meta_crc"]))
        if not verify_snapshot(snap):    # end-to-end: bytes AND metadata
            with self._lock:
                self.n_corrupt_detected += 1
            return None
        return snap

    def _discard(self, rid: int) -> None:
        """Remove a failed-verification entry from every tier. The disk
        drop rides the writer queue OUTSIDE the lock (a blocked producer
        holding the lock would deadlock the writer)."""
        with self._lock:
            entry = self._pool.pop(rid, None)
            if entry is None:
                self.n_misses += 1
                return
            if entry.snap is not None:
                self.ram_bytes -= entry.nbytes
            need_drop = (entry.on_disk or entry.pending > 0) \
                and self.directory is not None
        if need_drop:
            self._submit_job(("drop", rid))
