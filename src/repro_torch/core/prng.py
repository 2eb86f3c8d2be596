"""Threefry-2x32 key chains: the port's copy of what serving needs of
``jax.random`` (with ``jax_threefry_partitionable``, JAX's default).

A key is an int64 tensor ``[..., 2]`` holding two uint32 words in
[0, 2^32): torch has no full uint32 arithmetic, so every add and rotate
is masked back to 32 bits. Keys are plain tensors, so a chain lives in a
static buffer of a captured step program and advances in place; no
``torch.Generator`` state is involved.

- ``prng_key(seed)`` is ``[seed >> 32, seed & 0xFFFFFFFF]``, the layout
  of ``jax.random.PRNGKey`` (for seeds below 2^32 in JAX's default
  32-bit mode, which drops a larger seed's high word) and of the
  scheduler's per-request keys.
- ``split(key)`` gives (new key, subkey): the threefry outputs
  (x0[c], x1[c]) for counters c = 0 and 1, as ``jax.random.split``.
- ``random_bits(key, n)`` is x0 ^ x1 over the counters (idx >> 32,
  idx & 0xFFFFFFFF) of the flattened index, as ``jax.random.bits``.
- ``categorical(key, logits)`` is ``jax.random.categorical``: the first
  argmax of gumbel noise plus the logits, the noise drawn over the
  logits' whole shape from the one key.

Lanes draw with one key per row (``categorical_rows``), as the JAX
package's ``vmap(categorical)``: row r's counters run 0..V-1 under its
own key.
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
TINY = torch.finfo(torch.float32).tiny


def prng_key(seed: int, device=None):
    """[2] int64 key words of an integer seed."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & MASK, seed & MASK],
                        dtype=torch.int64, device=device)


def _rotl(v, r: int):
    return ((v << r) | (v >> (32 - r))) & MASK


def threefry2x32(k0, k1, x0, x1):
    """The threefry-2x32 block cipher (20 rounds) on broadcastable int64
    tensors of uint32 words. Returns (y0, y1)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def _counters(n: int, device):
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return idx >> 32, idx & MASK


def split(key):
    """key [..., 2] -> (new key [..., 2], subkey [..., 2])."""
    hi, lo = _counters(2, key.device)
    y0, y1 = threefry2x32(key[..., :1], key[..., 1:], hi, lo)
    return (torch.stack([y0[..., 0], y1[..., 0]], dim=-1),
            torch.stack([y0[..., 1], y1[..., 1]], dim=-1))


def random_bits(key, n: int):
    """key [..., 2] -> [..., n] int64 uint32 words: bits 0..n-1 of the
    key's stream (each leading row of ``key`` its own stream)."""
    hi, lo = _counters(n, key.device)
    y0, y1 = threefry2x32(key[..., :1], key[..., 1:], hi, lo)
    return y0 ^ y1


def uniform_from_bits(bits):
    """uint32 words -> float32 in [tiny, 1), as jax.random.uniform(...,
    minval=tiny, maxval=1) builds them: the top 23 bits as a mantissa of
    [1, 2), minus 1, scaled and clamped."""
    f = (((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
         - 1.0)
    # f * (1 - tiny) + tiny in float32, where 1 - tiny rounds to 1
    return torch.clamp_min(f + TINY, TINY)


def gumbel_from_bits(bits):
    return -torch.log(-torch.log(uniform_from_bits(bits)))


def perturb(key, logits):
    """gumbel noise + logits [B, V] (float32), the noise drawn from the
    single key [2] with counters over the whole [B, V] array, row major:
    what categorical takes the first argmax of."""
    B, V = logits.shape
    return gumbel_from_bits(random_bits(key, B * V)).reshape(B, V) + logits


def perturb_rows(keys, logits):
    """perturb with row r's own key keys[r] ([B, 2]), counters 0..V-1 in
    every row."""
    return gumbel_from_bits(random_bits(keys, logits.shape[-1])) + logits


def categorical(key, logits):
    """One draw per row of logits [B, V] from the single key [2].
    Returns [B] int64."""
    return torch.argmax(perturb(key, logits), dim=-1)


def categorical_rows(keys, logits):
    """One draw per row of logits [B, V], row r with its own key keys[r].
    Returns [B] int64."""
    return torch.argmax(perturb_rows(keys, logits), dim=-1)
