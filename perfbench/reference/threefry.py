"""The JAX default PRNG (threefry2x32) in numpy: the reference's own copy,
for the trainer's initialisation.

The program's ``init_params`` draws a model's first parameters from a seed
with this generator; the reference works them out again here, so it takes
no parameter that the program made.  The parts of ``jax.random`` that
initialisation needs, under the
default configuration of jax 0.9 (``jax_threefry_partitionable`` on):

  * ``key(seed)``: the raw key ``[seed >> 32, seed & 0xFFFFFFFF]`` as uint32;
  * ``split(key, num)``: threefry2x32 of the key over the counters
    ``(0, i)``, i < num; key i is ``(bits1[i], bits2[i])``;
  * ``random_bits(key, shape)``: threefry2x32 over the 64-bit iota of the
    shape, split into (high, low) 32-bit counters; the 32-bit bits are
    ``bits1 ^ bits2``;
  * ``uniform(key, shape, minval, maxval)`` for float32: the top 23 bits as
    the mantissa of a float in [1, 2), minus 1, scaled and shifted in one
    rounding (as XLA's CPU backend fuses them), then clamped below at
    ``minval``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["key", "split", "random_bits", "uniform", "threefry2x32"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(k1, k2, x1: np.ndarray, x2: np.ndarray) -> tuple:
    """The 20-round Threefry-2x32 hash of the counter pairs (x1, x2) under
    the key (k1, k2); uint32 arrays in, uint32 arrays out."""
    ks = (np.uint32(k1), np.uint32(k2), np.uint32(k1) ^ np.uint32(k2) ^ _PARITY)
    with np.errstate(over="ignore"):
        x = [np.asarray(x1, np.uint32) + ks[0], np.asarray(x2, np.uint32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def key(seed: int) -> np.ndarray:
    """The raw (2,) uint32 key of an integer seed."""
    seed = int(seed)
    if not -2**63 <= seed < 2**64:
        raise ValueError(f"seed {seed} does not fit 64 bits")
    seed &= 0xFFFFFFFFFFFFFFFF
    return np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint32)


def _iota_2x32(shape) -> tuple:
    n = int(np.prod(shape, dtype=np.int64))
    iota = np.arange(n, dtype=np.uint64).reshape(shape)
    return ((iota >> np.uint64(32)).astype(np.uint32),
            (iota & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def split(k: np.ndarray, num: int = 2) -> np.ndarray:
    """(num, 2) uint32: ``num`` new keys from ``k``."""
    b1, b2 = threefry2x32(k[0], k[1], *_iota_2x32((num,)))
    return np.stack([b1, b2], axis=1)


def random_bits(k: np.ndarray, shape) -> np.ndarray:
    """uint32 bits of the given shape."""
    b1, b2 = threefry2x32(k[0], k[1], *_iota_2x32(tuple(shape)))
    return b1 ^ b2


def uniform(k: np.ndarray, shape, minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """float32 samples in [minval, maxval), as ``jax.random.uniform``."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = random_bits(k, shape)
    one = np.array(1.0, np.float32).view(np.uint32)
    floats = ((bits >> np.uint32(9)) | one).view(np.float32) - np.float32(1.0)
    # XLA fuses the scale and shift into one fused multiply-add.  A 23-bit
    # float times the 24-bit width, plus minval, is exact in float64, so one
    # rounding to float32 gives the fused result.
    scaled = (floats.astype(np.float64) * np.float64(hi - lo)
              + np.float64(lo)).astype(np.float32)
    return np.maximum(lo, scaled)
