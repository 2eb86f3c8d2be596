"""The port's plain kernel versions against the JAX package's Pallas
kernels (interpret mode on the CPU, as tests/test_kernels.py runs them)
and, for the capacity loss's gradient, against jax.grad of the JAX
package's differentiable capacity_loss_chunked.

Every input is drawn once with numpy from a fixed seed and handed to
both. Tolerances: attention 2e-5 absolute and relative in float32, the
bar of tests/test_kernels.py — the two sides sum in different orders;
the capacity loss rtol 1e-5 (atol 1e-7) on the value and rtol 1e-4
(atol 1e-7) on the log-space value and its gradient, the bars of the
capacity tests there. The CUDA kernels themselves run only on a card:
chip_smoke.py holds each against these plain versions there.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.losses import capacity_loss_chunked as jax_capacity_chunked
from repro.kernels import ops as jops
from repro_torch.core.losses import capacity_loss_ref
from repro_torch.kernels import ops
from repro_torch.kernels.capacity_loss import (BLOCK_ROWS, TILE_COLS,
                                               bwd_plan,
                                               capacity_loss_bwd_torch,
                                               fwd_plan, occupancy_torch)
from repro_torch.kernels.chunk_attention import F32_ROWS, row_plan
from repro_torch.kernels.decode_attention import MAX_SPLIT, TILE, split_plan

TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread. A pool of eight
    takes ~10 ms to wake for each op while XLA's own pool is live."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x, np.float32)


def _jit(fn, **options):
    """fn with its keyword options bound, jitted: one compile of the
    whole call, where an eager call runs each operation around the
    interpreted kernel on its own."""
    return jax.jit(functools.partial(fn, **options))


def _close(got, want, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=msg, **TOL)


def _slot_positions(rng, B, Hkv, M, t, empty_frac=0.3):
    """Post-eviction slot positions: distinct, out of order, below t,
    with some slots empty (-1)."""
    pos = np.full((B, Hkv, M), -1, np.int32)
    for b in range(B):
        for h in range(Hkv):
            n = int(M * (1 - empty_frac))
            slots = rng.choice(M, size=n, replace=False)
            pos[b, h, slots] = rng.choice(t, size=n, replace=False)
    return pos


# ------------------------------------------------------------- decode


# each option on and off, in six combinations
@pytest.mark.parametrize("window,with_new,return_probs,lane_clock", [
    (0, False, False, False), (16, True, True, True), (0, True, True, False),
    (16, False, True, True), (16, True, False, False), (0, True, False, True),
])
def test_decode_attention_matches_pallas(window, with_new, return_probs,
                                         lane_clock):
    rng = np.random.RandomState(0)
    B, Hq, Hkv, M, D = 2, 4, 2, 40, 32
    q = rng.randn(B, Hq, D).astype(np.float32)
    kc = rng.randn(B, Hkv, M, D).astype(np.float32)
    vc = rng.randn(B, Hkv, M, D).astype(np.float32)
    kn = rng.randn(B, Hkv, D).astype(np.float32)
    vn = rng.randn(B, Hkv, D).astype(np.float32)
    t = np.array([70, 55], np.int32) if lane_clock else 70
    pos = _slot_positions(rng, B, Hkv, M, 55)
    new_j = (jnp.asarray(kn), jnp.asarray(vn)) if with_new else None
    new_t = (torch.as_tensor(kn), torch.as_tensor(vn)) if with_new else None
    want = _jit(jops.decode_attention, window=window,
                return_probs=return_probs, impl="pallas")(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(pos),
        jnp.asarray(t), new_kv=new_j)
    got = ops.decode_attention(
        torch.as_tensor(q), torch.as_tensor(kc), torch.as_tensor(vc),
        torch.as_tensor(pos), torch.as_tensor(t), window=window,
        new_kv=new_t, return_probs=return_probs)
    if not return_probs:
        want, got = (want,), (got,)
    assert len(got) == len(want)
    for name, g, w in zip(("out", "probs", "p_new"), got, want):
        _close(g, w, name)


def test_decode_attention_all_slots_empty():
    """An empty cache without the in-flight token attends to nothing:
    zero output and zero probabilities, as the Pallas kernel gives."""
    B, Hq, Hkv, M, D = 1, 2, 1, 40, 32
    q = np.random.RandomState(1).randn(B, Hq, D).astype(np.float32)
    kc = np.ones((B, Hkv, M, D), np.float32)
    pos = np.full((B, Hkv, M), -1, np.int32)
    want = _jit(jops.decode_attention, return_probs=True, impl="pallas")(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(kc), jnp.asarray(pos), 3)
    got = ops.decode_attention(torch.as_tensor(q), torch.as_tensor(kc),
                               torch.as_tensor(kc), torch.as_tensor(pos), 3,
                               return_probs=True)
    for g, w in zip(got, want):
        _close(g, w)
        assert not _np(g).any()


@pytest.mark.parametrize("M,n_rows", [
    (512, 32), (500, 32), (64, 32), (100, 32), (4096, 32), (1, 2), (40, 2),
    (512, 512),
])
def test_decode_split_plan_covers_every_slot_once(M, n_rows):
    """The CUDA decode kernel's split plan (pure Python, in the
    wrapper): at most MAX_SPLIT (8, the portable cluster size) splits of
    whole tiles, none empty, and every slot in exactly one."""
    n_split, split_len = split_plan(M, n_rows)
    assert 1 <= n_split <= MAX_SPLIT == 8
    assert split_len > 0 and split_len % TILE == 0
    hits = np.zeros(M, int)
    for s in range(n_split):
        lo, hi = s * split_len, min(M, (s + 1) * split_len)
        assert lo < hi, f"split {s} is empty"
        hits[lo:hi] += 1
    assert (hits == 1).all()


def test_decode_split_plan_main_path_and_small_cache():
    """The main path (M 512, B * Hkv = 32) runs at least one CTA per SM
    of the H100's 132; M 64 (the float32 parity run) is one split."""
    n_split, _ = split_plan(512, 32)
    assert 32 * n_split >= 132
    assert split_plan(64, 32)[0] == 1


# -------------------------------------------------------------- chunk


def _cta_rows(cta, B, C, Hq, Hkv):
    """The (lane, position, q head) of each row CTA `cta` of the float32
    chunk kernel's grid of B * Hkv * n_qt holds, as csrc/chunk_attention.cu
    reads its blockIdx: the last row tiles first, then (lane, kv head);
    row r is (position c0 + r // G, head kvh * G + r % G) for
    r < n_pos * G."""
    G = Hq // Hkv
    bq, n_qt = row_plan(C, G)
    n_bh = B * Hkv
    qt, bh = n_qt - 1 - cta // n_bh, cta % n_bh
    b, kvh, c0 = bh // Hkv, bh % Hkv, qt * bq
    return [(b, c0 + r // G, kvh * G + r % G)
            for r in range(min(bq, C - c0) * G)]


@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("C", [512, 500, 17])
def test_chunk_f32_row_plan_covers_every_row_once(G, C):
    """The float32 chunk kernel's row plan (pure Python, in the
    wrapper): its grid of B * Hkv * n_qt CTAs of F32_ROWS rows holds
    every (lane, position, q head) exactly once, G heads of a kv head
    together."""
    B, Hkv = 2, 8 // min(G, 8)
    Hq = G * Hkv
    bq, n_qt = row_plan(C, G)
    assert bq * G <= F32_ROWS and (n_qt - 1) * bq < C <= n_qt * bq
    hits = np.zeros((B, C, Hq), int)
    for cta in range(B * Hkv * n_qt):
        rows = _cta_rows(cta, B, C, Hq, Hkv)
        assert len(rows) <= F32_ROWS
        assert len({h // G for _, _, h in rows}) <= 1   # one kv head
        for b, c, h in rows:
            hits[b, c, h] += 1
    assert (hits == 1).all()


def _case(*args, shape=None, id=None):
    """A parametrized case; the cases without a shape keep the ids they
    had before shapes were added."""
    return pytest.param(*args, shape,
                        id=id or "-".join(str(a) for a in args))


@pytest.mark.parametrize("Hq,Hkv,need_probs,window,shape", [
    _case(2, 2, False, 0), _case(4, 2, True, 12), _case(2, 2, True, 12),
    _case(4, 2, False, 0),
    # the tensor-core kernel's tile edges at small width: M not a
    # multiple of 16, a lane with one valid query
    _case(4, 2, True, 0, shape=(37, (1, 24)), id="M37-n_valid1"),
    _case(4, 2, False, 12, shape=(37, (24, 1)), id="M37-n_valid1-window"),
])
def test_chunk_attention_matches_pallas(Hq, Hkv, need_probs, window, shape):
    rng = np.random.RandomState(2)
    B, C, M, D = 2, 24, 40, 32
    n_valid = np.array([24, 17])                       # ragged tail on lane 1
    if shape is not None:
        M, n_valid = shape[0], np.array(shape[1])
    t0 = np.array([60, 48], np.int32)
    q = rng.randn(B, C, Hq, D).astype(np.float32)
    kc = rng.randn(B, C, Hkv, D).astype(np.float32)
    vc = rng.randn(B, C, Hkv, D).astype(np.float32)
    cache = {"k": rng.randn(B, Hkv, M, D).astype(np.float32),
             "v": rng.randn(B, Hkv, M, D).astype(np.float32),
             "pos": _slot_positions(rng, B, Hkv, M, 48)}
    idx = np.arange(C)
    chunk_pos = np.where(idx[None] < n_valid[:, None], t0[:, None] + idx,
                         -1).astype(np.int32)
    want = _jit(jops.chunk_attention, window=window, need_probs=need_probs,
                impl="pallas")(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        {k: jnp.asarray(v) for k, v in cache.items()}, jnp.asarray(chunk_pos))
    got = ops.chunk_attention(
        torch.as_tensor(q), torch.as_tensor(kc), torch.as_tensor(vc),
        {k: torch.as_tensor(v) for k, v in cache.items()},
        torch.as_tensor(chunk_pos), window=window, need_probs=need_probs)
    _close(got[0], want[0], "out")
    if need_probs:
        _close(got[1], want[1], "probs_cache")
    else:
        assert got[1] is None and want[1] is None
    # padded queries give zero
    assert not _np(got[0])[1, n_valid[1]:].any()


def test_chunk_attention_empty_cache_first_chunk():
    """The first chunk of a prompt sees an empty cache: only the causal
    chunk keys count, and the cache probabilities are all zero."""
    rng = np.random.RandomState(3)
    B, C, Hq, Hkv, M, D = 1, 16, 4, 2, 40, 32
    q = rng.randn(B, C, Hq, D).astype(np.float32)
    kc = rng.randn(B, C, Hkv, D).astype(np.float32)
    vc = rng.randn(B, C, Hkv, D).astype(np.float32)
    cache = {"k": np.zeros((B, Hkv, M, D), np.float32),
             "v": np.zeros((B, Hkv, M, D), np.float32),
             "pos": np.full((B, Hkv, M), -1, np.int32)}
    chunk_pos = np.arange(C, dtype=np.int32)
    want = _jit(jops.chunk_attention, impl="pallas")(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        {k: jnp.asarray(v) for k, v in cache.items()}, jnp.asarray(chunk_pos))
    got = ops.chunk_attention(
        torch.as_tensor(q), torch.as_tensor(kc), torch.as_tensor(vc),
        {k: torch.as_tensor(v) for k, v in cache.items()},
        torch.as_tensor(chunk_pos))
    _close(got[0], want[0], "out")
    _close(got[1], want[1], "probs_cache")
    assert not _np(got[1]).any()


# ---------------------------------------------------------- retention


@pytest.mark.parametrize("use_beta,q_offset,window,shape", [
    _case(False, 0, 0), _case(True, 0, 0), _case(False, 0, 24),
    _case(True, 30, 0), _case(True, 30, 24),
    # the tensor-core kernel's tile edges at small width: one query at
    # the end of the keys, and Tk one past a power of two
    _case(False, 69, 0, shape=1, id="Tq1-q_offset69"),
    _case(True, 64, 24, shape=1, id="Tq1-q_offset64-window"),
    _case(False, 0, 0, shape=65, id="Tk65"),
])
def test_retention_attention_matches_pallas(use_beta, q_offset, window,
                                            shape):
    rng = np.random.RandomState(4)
    B, Tq, Hq, Hkv, D = 2, 70, 4, 2, 32
    if shape is not None:
        Tq = shape
    Tk = Tq + q_offset
    q = rng.randn(B, Tq, Hq, D).astype(np.float32)
    k = rng.randn(B, Tk, Hkv, D).astype(np.float32)
    v = rng.randn(B, Tk, Hkv, D).astype(np.float32)
    lb = (-np.abs(rng.randn(B, Tk, Hkv)) * 0.05).astype(np.float32)
    want = _jit(jops.retention_attention, window=window, q_offset=q_offset,
                impl="pallas")(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(lb) if use_beta else None)
    got = ops.retention_attention(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
        torch.as_tensor(lb) if use_beta else None, window=window,
        q_offset=q_offset)
    _close(got, want)


# ------------------------------------------------------- capacity loss


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


# the JAX package's chunked XLA and reference paths take M as a traced
# argument
_CAPACITY_JIT = {impl: jax.jit(functools.partial(jops.capacity_loss,
                                                 impl=impl))
                 for impl in ("xla", "ref")}


@pytest.mark.parametrize("impl", ["pallas", "xla", "ref"])
@pytest.mark.parametrize("B,H,T", [(1, 1, 64), (2, 3, 200), (1, 2, 257)])
@pytest.mark.parametrize("M", [1, 8, 64])
def test_capacity_loss_matches_jax(impl, B, H, T, M):
    """L_cap from beta against capacity_loss_pallas and the chunked XLA
    path, on the grid of tests/test_kernels.py; the port's O(T^2)
    oracle against the JAX package's."""
    rng = np.random.RandomState(10)
    beta = _sigmoid(2.0 * rng.randn(B, T, H)).astype(np.float32)
    if impl == "pallas":      # the kernel bakes M in
        want = _jit(jops.capacity_loss, M=float(M), impl=impl)(
            jnp.asarray(beta))
    else:                     # one compile a shape, shared by every M
        want = _CAPACITY_JIT[impl](jnp.asarray(beta), jnp.float32(M))
    if impl == "ref":
        got = capacity_loss_ref(torch.as_tensor(beta), M)
    else:
        got = ops.capacity_loss(torch.as_tensor(beta), M)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-7)


def _log_beta(rng, B, T, H):
    """-softplus(-logits), the gates' log-space output."""
    x = 3.0 * rng.randn(B, T, H) + 4.0      # beta from 0.5 to ~1
    return (-np.logaddexp(0.0, -x)).astype(np.float32)


@pytest.mark.parametrize("B,H,T,M", [(1, 1, 64, 1), (2, 3, 200, 8),
                                     (1, 2, 257, 64)])
def test_capacity_loss_log_matches_jax(B, H, T, M):
    """The log-space form training calls, value and gradient in
    log_beta, against capacity_loss_chunked(log_beta=...) and
    jax.grad."""
    lb = _log_beta(np.random.RandomState(11), B, T, H)
    want, g_want = jax.jit(jax.value_and_grad(
        lambda x: jax_capacity_chunked(jnp.exp(x), float(M), log_beta=x)))(
            jnp.asarray(lb))
    lbt = torch.as_tensor(lb).requires_grad_(True)
    got = ops.capacity_loss_log(lbt, M)
    (g_got,) = torch.autograd.grad(got, lbt)
    assert float(want) > 0
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(g_got.numpy(), np.asarray(g_want), rtol=1e-4,
                               atol=1e-7)


def _bwd_case(case):
    """(log_beta [B, T, H], M): random gates over budget; beta = 1.0
    exactly, where S_t = t + 1 meets the integer M at t = M - 1 (a
    tie); beta = 0.1, where S_t < 1.12 stays under budget."""
    if case == "random":
        return _log_beta(np.random.RandomState(12), 2, 200, 3), 8
    if case == "tie":
        return np.zeros((1, 64, 2), np.float32), 8
    return np.full((1, 32, 1), np.log(np.float32(0.1)), np.float32), 32


@pytest.mark.parametrize("case", ["random", "tie", "under_budget"])
def test_capacity_loss_bwd_closed_form(case):
    """capacity_loss_bwd_torch (the backward kernel's plain version)
    against autograd of the plain forward and against jax.grad, with an
    incoming gradient g = 0.7."""
    lb, M = _bwd_case(case)
    B, T, H = lb.shape
    g = 0.7
    lbt = torch.as_tensor(lb)
    S = occupancy_torch(lbt)
    got = capacity_loss_bwd_torch(lbt, S, M, torch.tensor(g))
    x = lbt.clone().requires_grad_(True)
    (auto,) = torch.autograd.grad(ops.capacity_loss_log(x, M) * g, x)
    j_grad = jax.jit(jax.grad(lambda x: g * jax_capacity_chunked(
        jnp.exp(x), float(M), log_beta=x)))(jnp.asarray(lb))
    np.testing.assert_allclose(got.numpy(), auto.numpy(), rtol=1e-4,
                               atol=1e-7)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_grad), rtol=1e-4,
                               atol=1e-7)
    # S is the occupancy the loss is made of
    t1 = torch.arange(1, T + 1, dtype=torch.float32)
    loss = (torch.clamp(S - M, min=0) / t1).mean()
    np.testing.assert_allclose(float(loss), float(ops.capacity_loss_log(
        lbt, M)), rtol=1e-5, atol=1e-7)
    if case == "tie":
        assert torch.equal(S, t1.expand(B * H, T))    # S_{M-1} = M exactly
        row = torch.arange(T) == M - 1
        above, below = (capacity_loss_bwd_torch(
            lbt, torch.where(row, S + d, S), M, torch.tensor(g))
            for d in (0.5, -0.5))
        # the tied row weighs half: halfway between over and under budget
        assert (above != below).any()
        np.testing.assert_allclose(got.numpy(), ((above + below) / 2).numpy(),
                                   rtol=1e-6, atol=1e-9)
    if case == "under_budget":
        assert not got.numpy().any()


def _bwd_units(T, item, n_groups, group, warp):
    """The (column block, row block) pairs, in blocks of 32, that warp
    `warp` (0..3) of group `group` of CTA `item` walks, as the backward
    kernel (csrc/capacity_loss.cu) does: column tile ii (p, then
    n - 1 - p) gives column block cb = 4 ii + warp; its row blocks run
    from the diagonal cb to the last, block rb to group rb % n_groups.
    Column i = 32 cb + lane and row t = 32 rb + j count where
    i <= t < T (on the diagonal, j >= lane)."""
    n_tiles = -(-T // TILE_COLS)
    nrb = -(-T // BLOCK_ROWS)
    out = []
    for ii in dict.fromkeys((item, n_tiles - 1 - item)):
        cb = ii * (TILE_COLS // BLOCK_ROWS) + warp
        out += [(cb, rb) for rb in range(cb, nrb) if rb % n_groups == group]
    return out


@pytest.mark.parametrize("T", [1, 129, 1000, 4096])
def test_capacity_bwd_plan_covers_lower_triangle_once(T):
    """The capacity backward's work plan (bwd_plan, and _bwd_units as
    the kernel walks it): every pair t >= i of each (b, h) row exactly
    once, nothing above the diagonal; at T 4096 no CTA and no group
    holds more than 1.25x the mean pairs."""
    BH = 8
    n_items, n_groups = bwd_plan(T, BH)
    assert n_items == (-(-T // TILE_COLS) + 1) // 2
    assert 1 <= n_groups <= 4
    lane = np.arange(BLOCK_ROWS)
    hits = np.zeros((T + BLOCK_ROWS, T + TILE_COLS), np.int8)   # [t, i]
    cta_pairs, group_pairs = [], []
    for item in range(n_items):
        per_cta = 0
        for group in range(n_groups):
            pairs = 0
            for warp in range(TILE_COLS // BLOCK_ROWS):
                for cb, rb in _bwd_units(T, item, n_groups, group,
                                         warp):
                    t0, i0 = rb * BLOCK_ROWS, cb * BLOCK_ROWS
                    blk = np.ones((BLOCK_ROWS, BLOCK_ROWS), np.int8)
                    if rb == cb:                  # the diagonal: j >= lane
                        blk = (lane[:, None] >= lane[None, :]).astype(np.int8)
                    assert rb >= cb
                    hits[t0:t0 + BLOCK_ROWS, i0:i0 + BLOCK_ROWS] += blk
                    pairs += int(blk[:max(0, T - t0), :max(0, T - i0)].sum())
            group_pairs.append(pairs)
            per_cta += pairs
        cta_pairs.append(per_cta)
    hits = hits[:T, :T]
    assert (hits == np.tri(T, dtype=np.int8)).all()
    assert sum(cta_pairs) == T * (T + 1) // 2
    if T == 4096:
        assert max(cta_pairs) <= 1.25 * np.mean(cta_pairs)
        assert max(group_pairs) <= 1.25 * np.mean(group_pairs)
        assert BH * n_items * n_groups * 4 >= 8 * 132   # 8 warps per SM


def _blocked_bwd(lb, S, M, g, K=32):
    """The backward kernel's sum in numpy float32: rows in blocks of K;
    a block after column i is beta_i^(t0-i) ((t0-i) A + Bq), A and Bq
    sums of its weights against the table beta_i^j and j beta_i^j
    (j < K, one exp2 each), the block on the diagonal one exp2 per
    pair; blocks accumulate in order."""
    f = np.float32
    B, T, H = lb.shape
    rows = lb.transpose(0, 2, 1).reshape(B * H, T)
    x = S - f(M)
    w = (np.where(x > 0, f(1), np.where(x == 0, f(0.5), f(0)))
         * (f(1) / np.arange(1, T + 1, dtype=f))).astype(f)
    nrb = -(-T // K)
    w = np.concatenate([w, np.zeros((B * H, nrb * K - T), f)], 1)
    i = np.arange(T)
    j = np.arange(K, dtype=f)
    out = np.zeros((B * H, T), f)
    for r in range(B * H):
        lb2 = (rows[r] * f(1.4426950408889634)).astype(f)          # [T]
        pw = np.exp2(j[None, :] * lb2[:, None]).astype(f)          # [T, K]
        qw = (j[None, :] * pw).astype(f)
        acc = np.zeros(T, f)
        for rb in range(nrb):
            wb = w[r, rb * K:(rb + 1) * K]
            full = i // K < rb
            d0 = (rb * K - i[full]).astype(f)
            a = (pw[full] @ wb).astype(f)
            bq = (qw[full] @ wb).astype(f)
            acc[full] += (np.exp2(d0 * lb2[full]) * (d0 * a + bq)).astype(f)
            diag = np.nonzero(i // K == rb)[0]
            if diag.size:
                d = j[None, :] - (diag % K)[:, None].astype(f)        # j - lane
                term = np.where(d >= 0, (wb[None, :] * d) * np.exp2(
                    np.maximum(d, 0) * lb2[diag, None]), f(0)).astype(f)
                acc[diag] += term.sum(1, dtype=f)
        out[r] = acc
    out *= f(g) / f(B * H * T)
    return out.reshape(B, H, T).transpose(0, 2, 1)


@pytest.mark.parametrize("mode", ["spread", "tie"])
def test_capacity_bwd_blocked_sum_matches_plain(mode):
    """The backward kernel's blocked power-table sum (K 32), emulated in
    numpy float32, against capacity_loss_bwd_torch within 1e-5 of the
    gradient's largest entry, for beta spread below 1 and for beta =
    1.0 exactly."""
    B, H, T, M = 1, 2, 1000, 64
    if mode == "tie":
        lb = np.zeros((B, T, H), np.float32)
    else:
        lb = _log_beta(np.random.RandomState(13), B, T, H)
    lbt = torch.as_tensor(lb)
    S = occupancy_torch(lbt)
    want = capacity_loss_bwd_torch(lbt, S, M, torch.tensor(0.7)).numpy()
    got = _blocked_bwd(lb, S.numpy(), M, 0.7)
    assert np.abs(want).max() > 0
    np.testing.assert_array_less(np.abs(got - want).max(),
                                 1e-5 * np.abs(want).max())


def _fwd_units(T, item, n_split, split, n_rows):
    """The (column tile ii, row block rb, column block cb, kind) units
    that CTA (item, split) of the forward kernel (csrc/capacity_loss.cu)
    computes, as it walks them: its list of micro-rows is tile item's
    n - item, then tile n - 1 - item's item + 1 (one list when the two
    are one tile), n_rows entries a round from entry split * n_rows,
    rounds n_rows * n_split apart; micro-row m of tile ii holds row
    blocks 4 (ii + m) + r, r < 4, and against column block cb = 4 ii + w
    a block is whole where m > 0 or w < r, the diagonal (rows j >= lane)
    where m = 0 and w = r, and nothing above it."""
    n = -(-T // TILE_COLS)
    tiles = list(dict.fromkeys((item, n - 1 - item)))
    entries = [(ii, m) for ii in tiles for m in range(n - ii)]
    out = []
    for g0 in range(split * n_rows, len(entries), n_rows * n_split):
        for ii, m in entries[g0:g0 + n_rows]:
            for r in range(4):
                for w in range(4):
                    if m > 0 or w < r:
                        kind = "whole"
                    elif w == r:
                        kind = "diagonal"
                    else:
                        continue
                    out.append((ii, 4 * (ii + m) + r, 4 * ii + w, kind))
    return out


@pytest.mark.parametrize("T", [1, 129, 1000, 4096])
def test_capacity_fwd_plan_covers_lower_triangle_once(T):
    """The capacity forward's work plan (fwd_plan, and _fwd_units as the
    kernel walks it): every pair t >= i of each (b, h) row exactly once,
    nothing above the diagonal, each block's partial written under its
    own column tile; at T 4096 (B*H 8) one CTA per item, 128 CTAs of 33
    micro-rows, and no CTA above 1.25x the mean pairs."""
    BH = 8
    n_items, n_split, n_rows = fwd_plan(T, BH)
    assert n_items == (-(-T // TILE_COLS) + 1) // 2
    assert n_items * n_split * BH <= 132 or n_split == 1
    lane = np.arange(BLOCK_ROWS)
    hits = np.zeros((T + 4 * TILE_COLS, T + TILE_COLS), np.int8)   # [t, i]
    cta_pairs = []
    for item in range(n_items):
        for split in range(n_split):
            pairs = 0
            for ii, rb, cb, kind in _fwd_units(T, item, n_split, split,
                                               n_rows):
                assert rb >= cb and cb // 4 == ii
                t0, i0 = rb * BLOCK_ROWS, cb * BLOCK_ROWS
                blk = np.ones((BLOCK_ROWS, BLOCK_ROWS), np.int8)
                if kind == "diagonal":                    # j >= lane
                    blk = (lane[:, None] >= lane[None, :]).astype(np.int8)
                hits[t0:t0 + BLOCK_ROWS, i0:i0 + BLOCK_ROWS] += blk
                pairs += int(blk[:max(0, T - t0), :max(0, T - i0)].sum())
            cta_pairs.append(pairs)
    hits = hits[:T, :T]
    assert (hits == np.tri(T, dtype=np.int8)).all()
    assert sum(cta_pairs) == T * (T + 1) // 2
    if T == 4096:
        assert (n_items, n_split, n_rows) == (16, 1, 33)
        assert max(cta_pairs) <= 1.25 * np.mean(cta_pairs)


def _blocked_fwd(lb, K=32, cols=128):
    """The forward kernel's sums in numpy float32: per column tile, the
    table beta_i^j (j < K) and the carries beta_i^(t0-i) of the row
    blocks wholly after each column (one exp2 each; 0 above the
    diagonal and past T) multiplied, plus the diagonal blocks' one exp2
    per pair; then each row adds its tiles' partials in a fixed order:
    tiles v, v + 8, ... for v < 8 (the sum pass's warps, rows in groups
    of 32), then those 8 sums in order. Returns S [B*H, T]."""
    f = np.float32
    B, T, H = lb.shape
    rows = lb.transpose(0, 2, 1).reshape(B * H, T)
    n = -(-T // cols)
    j = np.arange(K, dtype=f)
    S = np.zeros((B * H, T), f)
    for r in range(B * H):
        lb2 = np.zeros(n * cols, f)
        lb2[:T] = rows[r] * f(1.4426950408889634)
        part = np.zeros((n, 4 * n * K), f)
        for ii in range(n):
            i = ii * cols + np.arange(cols)
            P = np.exp2(lb2[i, None] * j[None, :]).astype(f)         # [c, j]
            rb = np.arange(4 * ii, 4 * n)
            whole = (i[None, :] // K < rb[:, None]) & (i[None, :] < T)
            d0 = np.where(whole, rb[:, None] * K - i[None, :], 0).astype(f)
            C = np.where(whole, np.exp2(d0 * lb2[i][None, :]), f(0)).astype(f)
            out = (C @ P).astype(f)                                   # [rb, j]
            for w in range(4):                  # diagonal block rb = cb
                lane = ii * cols + w * K + np.arange(K)
                d = j[:, None] - np.arange(K, dtype=f)[None, :]       # j - lane
                term = np.where((d >= 0) & (lane[None, :] < T), np.exp2(
                    np.maximum(d, 0) * lb2[lane][None, :]), f(0)).astype(f)
                out[w] += term.sum(1, dtype=f)
            part[ii, 4 * ii * K:] = out.reshape(-1)
        for t in range(T):
            last = t // 32 * 32 // cols
            warp = [part[v:last + 1:8, t].sum(dtype=f) for v in range(8)]
            s = f(0)
            for x in warp:
                s = f(s + x)
            S[r, t] = s
    return S


@pytest.mark.parametrize("mode", ["spread", "tie"])
def test_capacity_fwd_blocked_sum_matches_plain(mode):
    """The forward kernel's blocked power-table sums (K 32, tiles of 128
    columns, partials added in a fixed order), emulated in numpy
    float32, against occupancy_torch within 1e-5 of S's largest entry,
    for beta spread below 1 and for beta = 1.0 exactly, where every sum
    is an exact integer: S_t = t + 1."""
    B, H, T = 1, 2, 1000
    if mode == "tie":
        lb = np.zeros((B, T, H), np.float32)
    else:
        lb = _log_beta(np.random.RandomState(14), B, T, H)
    want = occupancy_torch(torch.as_tensor(lb)).numpy()
    got = _blocked_fwd(lb)
    np.testing.assert_array_less(np.abs(got - want).max(),
                                 1e-5 * np.abs(want).max())
    if mode == "tie":
        np.testing.assert_array_equal(
            got, np.broadcast_to(np.arange(1, T + 1, dtype=np.float32),
                                 (B * H, T)))
