"""Radix-trie prefix KV cache: retained-slab prompt reuse.

A copy of the JAX package's ``repro/serve/prefix_cache.py`` in numpy
(the port imports nothing of that package). Production traffic is
dominated by shared prefixes: system prompts, few-shot templates, hot
documents. This module is the host side of prefix reuse for the lane
scheduler: a radix trie over TOKEN prefixes whose terminal nodes own
RETAINED KV slabs, single-lane decode-state rows in the layout
``LanePrograms.extract`` gives ({"t": [1] int32, "layers": [one dict
of numpy leaves per layer]}, bfloat16 leaves as int16 bits). On an
admission hit the scheduler installs the cached slab into a free lane
and prefills only the NOVEL SUFFIX of the prompt.

What makes entries parity-exact:

  * Entries live ONLY at prefill_chunk-aligned prompt boundaries. The
    chunked-prefill pipeline merges evictions per chunk, so the state
    after k full chunks is a pure function of the first k*C tokens —
    replaying the remaining chunks on a cached boundary state is
    bit-identical to the cold prefill.
  * A hit is always a STRICT prefix of the new prompt (lookup takes an
    explicit `limit`), so at least one suffix chunk remains and the
    first output token still comes from the live prefill's last hidden
    state — nothing logits-shaped needs to be cached.
  * TRIM-KV eviction makes the slab SMALLER than the raw prefix: an
    entry is O(budget M x layers) bytes however long its prompt prefix
    is.

Capture policy (what gets inserted): `observe()` keeps a bounded window
of recently seen prompts, and the scheduler captures a new prompt's
slab at the deepest chunk-aligned boundary it SHARES with that window
(its longest common prefix, capped below the prompt's own last chunk).
Shared system prompts therefore converge to one slab per pool after
their second appearance, and chained hits deepen entries as traffic
reveals longer shared structure.

Eviction is byte-accounted LRU (capacity_bytes over the slab bytes of
all entries) with optional TTL expiry (ttl_sec since last touch,
injectable clock for tests), both skipping PINNED entries: a hit pins
its entry for the requesting rid until the scheduler releases it when
the request leaves its lane. A port row's byte count equals the JAX
package's row of the same lane (the same leaves, bfloat16 as 2 bytes),
so both caches evict alike. All structural traffic is counted
(stats()).
"""
from __future__ import annotations

import time
from collections import deque
from typing import Dict, Optional

import numpy as np


def state_row_bytes(row) -> int:
    """Byte footprint of one host-side slab row (the sum of its numpy
    leaves' nbytes, walking dicts, lists and tuples) — the unit the LRU
    budget is accounted in."""
    if isinstance(row, dict):
        return sum(state_row_bytes(v) for v in row.values())
    if isinstance(row, (list, tuple)):
        return sum(state_row_bytes(v) for v in row)
    if row is None:
        return 0
    return int(np.asarray(row).nbytes)


def _match_len(a: np.ndarray, b: np.ndarray) -> int:
    """Length of the common prefix of two int token arrays."""
    n = min(a.size, b.size)
    if n == 0:
        return 0
    neq = np.nonzero(a[:n] != b[:n])[0]
    return int(neq[0]) if neq.size else n


class PrefixEntry:
    """One terminal payload: the retained slab for the prompt prefix
    `tokens` (a single-lane state row as LanePrograms.extract gives it,
    host numpy),
    plus the LRU/TTL/pin bookkeeping."""
    __slots__ = ("tokens", "state", "nbytes", "last_touch", "pins",
                 "node")

    def __init__(self, tokens, state, nbytes, now):
        self.tokens = tokens
        self.state = state
        self.nbytes = nbytes
        self.last_touch = now
        self.pins: set = set()       # rids whose lane was built from it
        self.node: Optional[_Node] = None

    @property
    def n_tokens(self) -> int:
        return int(self.tokens.size)

    @property
    def pinned(self) -> bool:
        return bool(self.pins)


class _Node:
    """Radix-trie node: `edge` is the token run from the parent,
    children are keyed by their edge's first token, and `entry` (if
    set) is the slab cached at exactly this node's depth."""
    __slots__ = ("edge", "children", "entry", "parent")

    def __init__(self, edge: np.ndarray, parent: Optional["_Node"]):
        self.edge = edge
        self.children: Dict[int, _Node] = {}
        self.entry: Optional[PrefixEntry] = None
        self.parent = parent


class PrefixCache:
    def __init__(self, capacity_bytes: int, *, ttl_sec: float = 0.0,
                 clock=time.monotonic, observe_window: int = 64):
        if capacity_bytes <= 0:
            raise ValueError("capacity_bytes must be positive "
                             "(0 disables the cache at the scheduler)")
        self.capacity = int(capacity_bytes)
        self.ttl = float(ttl_sec)
        self._clock = clock
        self._root = _Node(np.zeros((0,), np.int32), None)
        self._entries: Dict[bytes, PrefixEntry] = {}
        self._pins: Dict[int, PrefixEntry] = {}       # rid -> entry
        self._recent: deque = deque(maxlen=observe_window)
        self._bytes = 0
        self.n_inserts = 0
        self.n_evictions = 0
        self.n_expirations = 0
        self.n_rejected = 0

    # ------------------------------------------------------------- sizes

    @property
    def n_entries(self) -> int:
        return len(self._entries)

    @property
    def bytes_used(self) -> int:
        return self._bytes

    # --------------------------------------------------------- trie walk

    def lookup(self, tokens, *, limit: Optional[int] = None,
               pin: Optional[int] = None) -> Optional[PrefixEntry]:
        """Longest cached prefix of `tokens` no longer than `limit`
        (the scheduler passes the last chunk-aligned length STRICTLY
        below the prompt, so a hit always leaves a suffix to prefill).
        Touches the winning entry (LRU recency) and, with `pin=rid`,
        pins it for that rid until release(rid)."""
        self._expire()
        tokens = np.asarray(tokens, np.int32)
        limit = tokens.size if limit is None else min(int(limit),
                                                     tokens.size)
        node, depth, best = self._root, 0, None
        while True:
            if node.entry is not None:
                best = node.entry
            if depth >= limit:
                break
            child = node.children.get(int(tokens[depth]))
            if child is None or child.edge.size > limit - depth:
                break
            if _match_len(child.edge,
                          tokens[depth:depth + child.edge.size]) \
                    < child.edge.size:
                break
            node, depth = child, depth + child.edge.size
        if best is None:
            return None
        best.last_touch = self._clock()
        if pin is not None:
            self.release(pin)
            best.pins.add(pin)
            self._pins[pin] = best
        return best

    def contains(self, tokens) -> bool:
        """Exact-key membership (refreshes recency on a match) — the
        scheduler's pre-capture dedupe check."""
        entry = self._entries.get(
            np.asarray(tokens, np.int32).tobytes())
        if entry is None:
            return False
        entry.last_touch = self._clock()
        return True

    def observe(self, tokens) -> int:
        """Record `tokens` in the recent-prompt window and return the
        longest common prefix (in tokens) it shares with any prompt
        already in the window — the capture-boundary signal: a prefix
        is worth a slab only once traffic has actually repeated it."""
        tokens = np.asarray(tokens, np.int32)
        shared = 0
        for prev in self._recent:
            shared = max(shared, _match_len(tokens, prev))
            if shared == tokens.size:
                break
        self._recent.append(tokens)
        return shared

    # ----------------------------------------------------------- mutation

    def insert(self, tokens, state_row) -> bool:
        """Cache `state_row` (host single-lane slab, extract's layout)
        under the exact key `tokens`. Returns True if a NEW entry was
        created; an existing key is refreshed in place (deterministic
        prefill makes the bytes identical). Evicts cold unpinned
        entries LRU-first until the new slab fits; if pins keep it from
        ever fitting (or the slab alone exceeds capacity) the insert is
        REJECTED with a counter, never an error."""
        self._expire()
        tokens = np.ascontiguousarray(np.asarray(tokens, np.int32))
        key = tokens.tobytes()
        now = self._clock()
        existing = self._entries.get(key)
        if existing is not None:
            existing.last_touch = now
            return False
        nbytes = state_row_bytes(state_row)
        if nbytes > self.capacity:
            self.n_rejected += 1
            return False
        while self._bytes + nbytes > self.capacity:
            victim = self._lru_unpinned()
            if victim is None:
                self.n_rejected += 1
                return False
            self._remove(victim)
            self.n_evictions += 1
        node = self._descend(tokens)
        entry = PrefixEntry(tokens, state_row, nbytes, now)
        entry.node, node.entry = node, entry
        self._entries[key] = entry
        self._bytes += nbytes
        self.n_inserts += 1
        return True

    def release(self, rid: int) -> None:
        """Drop rid's pin (idempotent) — called whenever the request
        leaves its lane (retire / preempt / timeout / quarantine)."""
        entry = self._pins.pop(rid, None)
        if entry is not None:
            entry.pins.discard(rid)

    # ----------------------------------------------------------- internal

    def _descend(self, tokens: np.ndarray) -> _Node:
        """Walk/extend the trie to the node at exactly len(tokens),
        splitting edges where the new key diverges mid-edge."""
        node, depth = self._root, 0
        while depth < tokens.size:
            first = int(tokens[depth])
            child = node.children.get(first)
            if child is None:
                child = _Node(np.ascontiguousarray(tokens[depth:]), node)
                node.children[first] = child
                return child
            m = _match_len(child.edge, tokens[depth:])
            if m < child.edge.size:
                # split child's edge at m: parent -> mid -> child
                mid = _Node(np.ascontiguousarray(child.edge[:m]), node)
                node.children[first] = mid
                child.edge = np.ascontiguousarray(child.edge[m:])
                child.parent = mid
                mid.children[int(child.edge[0])] = child
                child = mid
            node, depth = child, depth + m
        return node

    def _remove(self, entry: PrefixEntry) -> None:
        node = entry.node
        node.entry = None
        self._bytes -= entry.nbytes
        del self._entries[entry.tokens.tobytes()]
        # prune now-useless leaves back toward the root
        while (node is not None and node.parent is not None
               and node.entry is None and not node.children):
            del node.parent.children[int(node.edge[0])]
            node = node.parent

    def _lru_unpinned(self) -> Optional[PrefixEntry]:
        pool = [e for e in self._entries.values() if not e.pinned]
        return min(pool, key=lambda e: e.last_touch) if pool else None

    def _expire(self) -> None:
        if self.ttl <= 0:
            return
        now = self._clock()
        for entry in list(self._entries.values()):
            if not entry.pinned and now - entry.last_touch > self.ttl:
                self._remove(entry)
                self.n_expirations += 1

    # -------------------------------------------------------------- stats

    def stats(self) -> Dict[str, int]:
        return {
            "entries": self.n_entries,
            "bytes": self._bytes,
            "inserts": self.n_inserts,
            "evictions": self.n_evictions,
            "expirations": self.n_expirations,
            "rejected": self.n_rejected,
            "pinned": sum(e.pinned for e in self._entries.values()),
        }
