"""Counter-based hash RNG of the streaming engine and the traffic
generators, on tensors.

The port's copy of the JAX package's ``core/hashrng.py``: every draw is a
pure function of ``(seed, call-path key, global counter)``, so draw i is
identical whatever chunk it arrives in, and identical on the CPU and on
the card.  The core is the splitmix64 finalizer over uint64.  Torch has
no uint64 arithmetic on the card, so a word is held in an ``int64``
tensor with the same 64 bits: multiplication and addition wrap mod 2^64
as uint64 arithmetic does, and every right shift is masked, because
``>>`` on ``int64`` is arithmetic (it copies the top bit down) where
numpy's on ``uint64`` is logical.  Salts are derived with blake2b on the
host, so results do not depend on ``PYTHONHASHSEED``.

:func:`pseudo_permutation` is a pseudorandom bijection on ``[0, domain)``:
a balanced Feistel network with cycle-walking.
"""

from __future__ import annotations

import hashlib

import torch

__all__ = [
    "hash_randint",
    "hash_u01",
    "mix64",
    "pseudo_permutation",
    "salt_for",
]

_M64 = (1 << 64) - 1


def _signed(word: int) -> int:
    """The int64 that holds the uint64 ``word``'s bits."""
    word &= _M64
    return word - (1 << 64) if word >> 63 else word


_GAMMA = _signed(0x9E3779B97F4A7C15)
_MIX1 = _signed(0xBF58476D1CE4E5B9)
_MIX2 = 0x94D049BB133111EB


def _shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of the uint64 words held in ``x``."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer: a bijective avalanche over uint64 (held in
    ``int64``; see the module docstring)."""
    x = x ^ _shr(x, 30)
    x = x * _MIX1
    x = x ^ _shr(x, 27)
    x = x * _signed(_MIX2)
    return x ^ _shr(x, 31)


def salt_for(seed: int, *parts) -> int:
    """Stable 64-bit salt from (seed, call key, stage), as an int in
    ``[0, 2^64)``: blake2b, not ``hash()``."""
    h = hashlib.blake2b(repr((seed,) + parts).encode(), digest_size=8).digest()
    return int.from_bytes(h, "little")


def _words(gidx) -> torch.Tensor:
    return torch.as_tensor(gidx, dtype=torch.int64)


def hash_u01(gidx: torch.Tensor, salt: int) -> torch.Tensor:
    """Uniform [0, 1) per global index, float64.  ``h >> 11`` has 53 bits,
    so its conversion and the product with 2^-53 are exact on any device."""
    h = mix64(_words(gidx) * _GAMMA + _signed(int(salt)))
    return _shr(h, 11).to(torch.float64) * (2.0 ** -53)


def hash_randint(gidx: torch.Tensor, bound, salt: int) -> torch.Tensor:
    """Uniform integers in [0, bound) per global index; ``bound`` may be a
    scalar or a per-index tensor.  One IEEE product and a truncation, as
    numpy computes it."""
    u = hash_u01(gidx, salt)
    b = torch.as_tensor(bound, dtype=torch.int64, device=u.device)
    return torch.minimum((u * b.to(torch.float64)).to(torch.int64), b - 1)


def _feistel(x: torch.Tensor, half_bits: int, salt: int, rounds: int) -> torch.Tensor:
    """One pass of a balanced Feistel network over ``2 * half_bits`` bits
    (at most 62, so every word here is non-negative)."""
    mask = (1 << half_bits) - 1
    hi = (x >> half_bits) & mask
    lo = x & mask
    for r in range(rounds):
        round_salt = _signed(int(salt) ^ ((r * _MIX2) & _M64))
        f = mix64(lo * _GAMMA + round_salt) & mask
        hi, lo = lo, hi ^ f
    return (hi << half_bits) | lo


def pseudo_permutation(idx, domain: int, salt: int, rounds: int = 4) -> torch.Tensor:
    """Evaluate a pseudorandom bijection of ``[0, domain)`` at ``idx``: a
    balanced Feistel network over the smallest even-split power of two >=
    ``domain``, with cycle-walking (one host sync per walk step).
    Deterministic in ``(idx, domain, salt)``.  ``domain`` is at most 2^62
    here, so that every word stays a non-negative ``int64``."""
    domain = int(domain)
    out = _words(idx).clone()
    if domain <= 1:
        return torch.zeros(out.shape, dtype=torch.int64, device=out.device)
    if domain > 1 << 62:
        raise ValueError(f"domain must be at most 2^62, got {domain}")
    if bool(((out < 0) | (out >= domain)).any()):
        raise ValueError(f"indices must lie in [0, {domain})")
    half_bits = max(1, ((domain - 1).bit_length() + 1) // 2)
    out = _feistel(out, half_bits, salt, rounds)
    walking = torch.nonzero(out >= domain).flatten()
    while walking.numel():
        out[walking] = _feistel(out[walking], half_bits, salt, rounds)
        walking = walking[out[walking] >= domain]
    return out
