"""The reference's ``jax.random`` draws that the port repeats, on the host.

The JAX package draws the Valiant shuffle's shift with
``jax.random.randint(key, (), 0, t)`` (``models/moe.py``).  With JAX's
default threefry2x32 generator and ``jax_threefry_partitionable`` on (the
default since JAX 0.5), that draw is:

* ``split``: key ``i`` of ``n`` is ``threefry2x32(key, (0, i))``;
* 32 random bits of a scalar: the two output words of
  ``threefry2x32(k, (0, 0))``, XOR-ed;
* ``randint``: two such draws (``hi`` from the first half of a split,
  ``lo`` from the second) folded into ``[minval, maxval)`` by
  ``((hi % span) * ((2^16 % span)^2 % span) + lo % span) % span`` in
  wrapping uint32 arithmetic.

A key is the reference's key data, two uint32 words: what
``jax.random.key_data(jax.random.PRNGKey(seed))`` holds, ``(0, seed)`` for a
seed below 2^32 (``prng_key``).  Everything here is numpy on the host, one
scalar a call: every rank that holds the same key draws the same value with
no communication.
"""

from __future__ import annotations

import numpy as np

__all__ = ["prng_key", "threefry2x32", "split", "random_bits32", "randint"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def prng_key(seed: int) -> np.ndarray:
    """The key data of ``jax.random.PRNGKey(seed)``: (seed >> 32, seed & 0xFFFFFFFF)."""
    seed = int(seed) % 2**64
    return np.array([seed >> 32, seed & 0xFFFFFFFF], dtype=np.uint32)


def _key(key) -> np.ndarray:
    """Two uint32 words from a key (numpy, a tensor, a list)."""
    if hasattr(key, "detach"):
        key = key.detach().cpu().numpy()
    words = np.asarray(key).reshape(-1)
    if words.shape != (2,):
        raise ValueError(f"a key is two uint32 words, got shape {np.asarray(key).shape}")
    return words.astype(np.uint32)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, count) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011), as JAX computes
    it: ``key`` two uint32 words, ``count`` a pair of uint32 arrays of one
    shape; returns the pair of output words."""
    k0, k1 = _key(key)
    x0, x1 = (np.asarray(c, dtype=np.uint32).copy() for c in count)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):
        x0 += ks[0]
        x1 += ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 += x1
                x1 = _rotl(x1, r) ^ x0
            x0 += ks[(i + 1) % 3]
            x1 += ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``'s key data, [num, 2] uint32."""
    hi, lo = threefry2x32(key, (np.zeros(num, np.uint32), np.arange(num, dtype=np.uint32)))
    return np.stack([hi, lo], axis=1)


def random_bits32(key) -> np.uint32:
    """``jax.random.bits(key, (), jnp.uint32)``: one 32-bit word."""
    hi, lo = threefry2x32(key, (np.zeros((), np.uint32), np.zeros((), np.uint32)))
    return np.uint32(hi ^ lo)


def randint(key, minval: int, maxval: int) -> int:
    """``jax.random.randint(key, (), minval, maxval)`` for int32 bounds, as
    a Python int (``minval`` where ``maxval <= minval``)."""
    if maxval <= minval:
        return int(minval)
    k1, k2 = split(key)
    hi, lo = random_bits32(k1), random_bits32(k2)
    span = np.uint32(maxval - minval)
    with np.errstate(over="ignore"):
        mult = np.uint32(2**16) % span
        mult = np.uint32(mult * mult) % span
        offset = np.uint32(np.uint32(hi % span) * mult + lo % span) % span
    return int(minval) + int(offset)
