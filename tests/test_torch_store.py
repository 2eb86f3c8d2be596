"""The port's snapshot store (repro_torch.serve.store), numpy only: the
cases of the JAX package's tests/test_store.py that need no model,
over snapshots shaped like the port's lane rows ({"t": [1], "layers":
[one dict of k, v, beta, pos, aux per layer]}, k and v as bfloat16
bits in int16):

- flatten / rebuild round-trips the tree (lists stay lists) bit-exactly;
- crc32 at capture and verify at fetch: zero false positives over many
  clean cycles, an unstamped snapshot fails closed, one flipped bit is
  always caught, in RAM and at rest;
- disk round trip, LRU spill and promote, the coldest dropped without a
  disk tier;
- a restart skips a truncated slab and an unparsable manifest, and
  fences a record of another spec (a JAX-written directory among them);
- injected IO errors degrade to counters, never raise.

Every store is closed (its writer thread drained and joined).
"""
import os

import numpy as np
import pytest

from repro_torch.serve.request import LaneSnapshot
from repro_torch.serve.store import (SnapshotStore, checksum_snapshot,
                                     flatten_state, rebuild_state,
                                     snapshot_nbytes, state_spec,
                                     verify_snapshot)


def _snap(seed, *, n_layers=2, scale=1):
    rng = np.random.RandomState(seed)
    M, D = 4, 8 * scale

    def layer():
        return {"k": rng.randint(-2**15, 2**15, (1, 2, M, D)).astype(np.int16),
                "v": rng.randint(-2**15, 2**15, (1, 2, M, D)).astype(np.int16),
                "beta": rng.rand(1, 2, M).astype(np.float32),
                "pos": rng.randint(-1, 9, (1, 2, M)).astype(np.int32),
                "aux": rng.randn(1, 2, M).astype(np.float32)}

    state = {"t": np.asarray([rng.randint(0, 100)], np.int32),
             "layers": [layer() for _ in range(n_layers)]}
    return LaneSnapshot(state=state, tok=np.int32(rng.randint(0, 64)),
                        key=rng.randint(0, 2**31, 2).astype(np.uint32),
                        n_emitted=int(rng.randint(0, 9)),
                        n_tokens=int(rng.randint(0, 9)))


def _assert_snap_equal(a, b):
    fa, fb = flatten_state(a.state), flatten_state(b.state)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, xa), (_, xb) in zip(fa, fb):
        np.testing.assert_array_equal(xa, xb, err_msg=str(p))
        assert xa.dtype == xb.dtype
    assert isinstance(b.state["layers"], list)
    assert int(a.tok) == int(b.tok)
    np.testing.assert_array_equal(a.key, b.key)
    assert a.n_emitted == b.n_emitted and a.n_tokens == b.n_tokens


@pytest.fixture
def stores():
    """Stores made by a test, closed after it."""
    made = []

    def make(**kw):
        made.append(SnapshotStore(**kw))
        return made[-1]

    yield make
    for s in made:
        s.close()
        assert s._writer is None


@pytest.mark.parametrize("n_layers", [1, 3])
def test_flatten_rebuild_round_trip(n_layers):
    snap = _snap(3, n_layers=n_layers)
    flat = flatten_state(snap.state)
    assert flat[-1][0] == [["k", "t"]]            # dict keys sorted
    rebuilt = rebuild_state([p for p, _ in flat], [l for _, l in flat])
    assert isinstance(rebuilt["layers"], list)
    assert len(rebuilt["layers"]) == n_layers
    for (pa, a), (pb, b) in zip(flat, flatten_state(rebuilt)):
        assert pa == pb
        np.testing.assert_array_equal(a, b)


def test_checksum_zero_false_positives_many_clean_cycles(stores):
    store = stores()
    for seed in range(24):
        snap = _snap(seed)
        assert checksum_snapshot(snap) == checksum_snapshot(snap)
        store.put(seed, snap)
        got = store.get(seed)
        assert got is snap and verify_snapshot(got)
    assert store.stats()["corrupt_detected"] == 0
    assert store.stats()["ram_hits"] == 24


def test_unstamped_snapshot_fails_closed():
    assert not verify_snapshot(_snap(0))


@pytest.mark.parametrize("seed", range(6))
def test_single_bit_flip_always_detected_in_ram(stores, seed):
    store = stores()
    store.put(0, _snap(seed))
    assert store.chaos_corrupt(np.random.default_rng(seed)) == "ram"
    assert store.get(0) is None
    st = store.stats()
    assert st["corrupt_detected"] == 1 and st["chaos_corrupted"] == 1
    assert not store.has(0)
    assert store.get(0) is None and store.stats()["misses"] == 1


@pytest.mark.parametrize("seed", range(3))
def test_single_bit_flip_always_detected_at_rest(stores, tmp_path, seed):
    d = str(tmp_path)
    store = stores(directory=d)
    store.put(0, _snap(seed), kind="park")
    store.flush()
    store2 = stores(directory=d)
    assert store2.stats()["recovered"] == 1
    assert store2.chaos_corrupt(np.random.default_rng(seed)) == "disk"
    assert store2.get(0) is None
    assert store2.stats()["corrupt_detected"] == 1


def test_disk_round_trip_bit_exact(stores, tmp_path):
    d = str(tmp_path)
    store = stores(directory=d)
    snap = _snap(7)
    store.put(5, snap, request_meta={"rid": 5}, tokens=(1, 2, 3),
              kind="park")
    store.flush()
    store2 = stores(directory=d)
    recs = store2.recoverable()
    assert [r["rid"] for r in recs] == [5]
    assert recs[0]["tokens"] == [1, 2, 3] and recs[0]["request"] == {"rid": 5}
    assert store2.peek_n_tokens(5) == snap.n_tokens
    got = store2.get(5)
    assert got is not None and verify_snapshot(got)
    _assert_snap_equal(snap, got)
    assert store2.stats()["disk_hits"] == 1


def test_lru_spill_promote_ordering(stores, tmp_path):
    one = snapshot_nbytes(_snap(0))
    store = stores(host_bytes=2 * one, directory=str(tmp_path))
    snaps = {r: _snap(10 + r) for r in range(3)}
    for r in range(3):
        store.put(r, snaps[r])
        store.flush()
        store.put(r, snaps[r])
    store.flush()
    st = store.stats()
    assert st["spills"] >= 1 and st["evictions"] >= 1
    assert st["ram_bytes"] <= 2 * one
    got = store.get(0)                   # the coldest: from disk
    assert got is not None
    _assert_snap_equal(snaps[0], got)
    assert store.stats()["disk_hits"] == 1
    store.flush()
    store.put(99, _snap(99))
    store.flush()
    store.put(99, _snap(99))
    store.flush()
    assert store.get(1) is not None      # evicted to disk, still served
    _assert_snap_equal(snaps[1], store.get(1))
    assert store.stats()["corrupt_detected"] == 0


def test_no_disk_tier_drops_coldest(stores):
    one = snapshot_nbytes(_snap(0))
    store = stores(host_bytes=2 * one)
    for r in range(3):
        store.put(r, _snap(r))
    st = store.stats()
    assert st["dropped"] == 1 and st["entries"] == 2
    assert store.get(0) is None and store.stats()["misses"] == 1
    assert store.get(2) is not None


def test_restart_skips_truncated_slab(stores, tmp_path):
    d = str(tmp_path)
    store = stores(directory=d)
    store.put(0, _snap(0), kind="park")
    store.put(1, _snap(1), kind="park")
    store.flush()
    slab = os.path.join(d, "snap_1.bin")
    with open(slab, "r+b") as f:
        f.truncate(os.path.getsize(slab) // 2)
    store2 = stores(directory=d)
    st = store2.stats()
    assert st["recovered"] == 1 and st["recover_skipped"] == 1
    assert store2.has(0) and not store2.has(1)
    assert store2.get(0) is not None


def test_restart_skips_unparsable_manifest(stores, tmp_path):
    d = str(tmp_path)
    with open(os.path.join(d, "manifest.json"), "w") as f:
        f.write("{ not json")
    store = stores(directory=d)
    assert store.stats()["io_errors"] == 1
    assert store.stats()["entries"] == 0


@pytest.mark.parametrize("alien", ["wider", "jax layout"])
def test_restart_fences_alien_spec(stores, tmp_path, alien):
    """A record of another config (wider heads), or of the JAX
    package's layout (layers stacked on a repeat axis, a "tail"), is
    adopted from the manifest but refused at read."""
    d = str(tmp_path)
    store = stores(directory=d)
    store.put(0, _snap(0), kind="park")
    store.flush()
    if alien == "wider":
        expected = state_spec(_snap(0, scale=2).state)
    else:
        row = _snap(0).state
        expected = state_spec({"t": row["t"], "tail": (),
                               "layers": (row["layers"][0],)})
    store2 = stores(directory=d, expected_spec=expected)
    assert store2.stats()["recovered"] == 1
    assert store2.get(0) is None
    assert store2.stats()["spec_mismatch"] == 1


def test_injected_io_errors_degrade_to_counters(stores, tmp_path):
    d = str(tmp_path)
    store = stores(directory=d)
    store.chaos_arm_io_error("fail")
    snap = _snap(0)
    store.put(0, snap, kind="park")
    store.flush()
    assert store.stats()["write_errors"] == 1
    assert store.get(0) is snap               # the RAM copy still serves
    store.chaos_arm_io_error("truncate")
    store.put(1, _snap(1), kind="park")
    store.flush()
    assert store.stats()["write_errors"] == 1  # the torn write "succeeded"
    store2 = stores(directory=d)
    assert not store2.has(1)                   # its size check catches it
    assert store2.stats()["recover_skipped"] >= 1
