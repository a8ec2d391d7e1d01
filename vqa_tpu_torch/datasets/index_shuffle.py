"""The shuffle order of Grain's ``IndexSampler``, in numpy.

``vqa_tpu/datasets/vqa2.py::grain_loader`` shuffles with Grain's sampler,
whose epoch ``e`` reads record ``index_shuffle(i, n - 1, (seed + e) % 2**32,
rounds=4)`` at position ``i``: a compiled cycle-walking permutation built on
the Simon block cipher. The port's ``item_loader`` must read the same records
in the same order, and importing ``grain`` loads jax, so this module computes
that permutation itself, a whole epoch at once:

  * the round keys are ``std::seed_seq{seed}.generate`` of ``rounds`` 32-bit
    words (the C++ standard's algorithm, [rand.util.seedseq]);
  * the block has ``max(16, b + b % 2)`` bits, ``b = ceil(log2(max_index))``
    in double precision, split into two words of ``W`` bits;
  * each pair of rounds is ``left ^= f(right) ^ k[r]``, ``right ^= f(left) ^
    k[r + 1]``, with ``f(x) = rotl(x, 2) ^ (rotl(x, 8) & rotl(x, 1))`` on
    ``W`` bits (Simon's round function), every key cut to ``W`` bits;
  * an index is encrypted again until it lands at or below ``max_index``.

Grain's pure-Python ``index_shuffle_python`` is another permutation (md5
Feistel rounds): the compiled one is what its sampler runs.
tests/test_torch_item_loader.py holds this module equal to the compiled
module for every index of several sizes and seeds.
"""

from __future__ import annotations

import math

import numpy as np

_MASK32 = 0xFFFFFFFF
MIN_BLOCK_BITS = 16


def seed_seq_generate(seeds, n: int) -> list:
    """``std::seed_seq(seeds).generate`` of ``n`` 32-bit words."""
    v = [int(s) & _MASK32 for s in seeds]
    s = len(v)
    out = [0x8B8B8B8B] * n
    if n == 0:
        return out
    t = 11 if n >= 623 else 7 if n >= 68 else 5 if n >= 39 else 3 if n >= 7 else (n - 1) // 2
    p = (n - t) // 2
    q = p + t
    m = max(s + 1, n)

    def mix(x: int) -> int:
        return x ^ (x >> 27)

    for k in range(m):
        r1 = (1664525 * mix(out[k % n] ^ out[(k + p) % n] ^ out[(k - 1) % n])) & _MASK32
        r2 = (r1 + (s if k == 0 else (k % n + v[k - 1]) if k <= s else k % n)) & _MASK32
        out[(k + p) % n] = (out[(k + p) % n] + r1) & _MASK32
        out[(k + q) % n] = (out[(k + q) % n] + r2) & _MASK32
        out[k % n] = r2
    for k in range(m, m + n):
        r3 = (1566083941 * mix((out[k % n] + out[(k + p) % n] + out[(k - 1) % n]) & _MASK32)) \
            & _MASK32
        r4 = (r3 - k % n) & _MASK32
        out[(k + p) % n] ^= r3
        out[(k + q) % n] ^= r4
        out[k % n] = r4
    return out


def block_bits(max_index: int) -> int:
    """The cipher's block size for ``[0, max_index]``, as the compiled
    dispatcher picks it (from a double-precision log2)."""
    bits = math.ceil(math.log2(float(max_index)))
    return max(MIN_BLOCK_BITS, bits + bits % 2)


def _encrypt(block: np.ndarray, keys, w: int) -> np.ndarray:
    mask = np.uint64((1 << w) - 1)

    def rotl(x, k):
        return ((x >> np.uint64(w - k)) | (x << np.uint64(k))) & mask

    def f(x):
        return rotl(x, 2) ^ (rotl(x, 8) & rotl(x, 1))

    left = (block >> np.uint64(w)) & mask
    right = block & mask
    for r in range(0, len(keys), 2):
        left = left ^ f(right) ^ (np.uint64(keys[r]) & mask)
        right = right ^ f(left) ^ (np.uint64(keys[r + 1]) & mask)
    return (left << np.uint64(w)) | right


def index_shuffle(index, max_index: int, seed: int, rounds: int = 4) -> np.ndarray:
    """Where Grain's ``index_shuffle(index, max_index, seed, rounds)`` sends
    each of ``index`` (an int or an array of ints in ``[0, max_index]``), as
    an int64 array of ``index``'s shape."""
    if rounds < 4 or rounds % 2:
        raise ValueError(f"rounds must be even and at least 4, got {rounds}")
    if not 0 <= seed < 2**32:
        raise ValueError(f"seed must be a 32-bit unsigned integer, got {seed}")
    index = np.asarray(index)
    if index.size and (index.min() < 0 or index.max() > max_index):
        raise ValueError(f"index out of [0, {max_index}]")
    index = index.astype(np.uint64)
    if max_index == 0:
        return np.zeros(index.shape, np.int64)
    bits = block_bits(max_index)
    if bits > 64:
        raise ValueError(f"max_index {max_index} needs more than 64 bits")
    keys = seed_seq_generate([seed], rounds)
    top = np.uint64(max_index)
    if bits == MIN_BLOCK_BITS:
        # a small range in the smallest block walks ~2**16 / max_index steps:
        # tabulate the cipher over the whole block, then let every value jump
        # to the first value on its cycle at or below max_index (pointer
        # doubling: each round, a value still above max_index takes its
        # target's target)
        nxt = _encrypt(np.arange(1 << bits, dtype=np.uint64), keys, bits // 2)
        while (nxt[: max_index + 1] > top).any():
            nxt = np.where(nxt > top, nxt[nxt], nxt)
        # (the cipher reads a block's low bits only: max_index = 2**16 reads
        # index 2**16 as 0)
        return nxt[index & np.uint64((1 << bits) - 1)].astype(np.int64)
    # a block of at most 4 * (max_index + 1) values: short walks
    out = _encrypt(index.ravel(), keys, bits // 2)
    walking = np.flatnonzero(out > top)
    while walking.size:  # cycle-walk back into [0, max_index]
        out[walking] = _encrypt(out[walking], keys, bits // 2)
        walking = walking[out[walking] > top]
    return out.reshape(index.shape).astype(np.int64)


def epoch_permutation(n: int, seed: int, epoch: int) -> np.ndarray:
    """The records epoch ``epoch`` of a shuffling ``IndexSampler`` over
    ``n`` records with ``seed`` reads, in order."""
    return index_shuffle(np.arange(n), n - 1, (seed + epoch) % 2**32)
