"""Baseline hash functions MATE is compared against (paper §7.2).

Copy of ``repro.core.hashes`` (numpy only): the port keeps its own so that it
imports nothing of the reference package.

Every function maps ``str -> int`` bitmask of ``bits`` width; super keys are
built by OR-aggregating per-cell hashes exactly like XASH, so the comparison
isolates the hash function (as in the paper, "all the competing hash
functions benefit from all of MATE's optimizations and only differ in the
applied hash function during row filtering").

Implementations are deterministic and dependency-free:
  * murmur128 — MurmurHash3 x64 128-bit (faithful port).
  * md5       — hashlib MD5 truncated/extended to ``bits``.
  * city128   — CityHash-class uniform 128-bit mix (FNV/murmur finalizer
                construction; the paper's point is only that such hashes
                set ~50% of bits uniformly).
  * simhash   — Charikar simhash over character 2-grams.
  * ht        — hash table: ONE bit per value (murmur mod bits).
  * bf        — bloom filter with ``n_hash`` bits per value (murmur, seeds),
                n_hash fixed from the corpus' average row width (§7.2: BF
                "calculates the number of hash functions based on the average
                number of columns in the corpus tables").
"""

from __future__ import annotations

import hashlib
import math

MASK64 = (1 << 64) - 1


def _rotl64(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & MASK64


def _fmix64(k: int) -> int:
    k ^= k >> 33
    k = (k * 0xFF51AFD7ED558CCD) & MASK64
    k ^= k >> 33
    k = (k * 0xC4CEB9FE1A85EC53) & MASK64
    k ^= k >> 33
    return k


def murmur3_x64_128(data: bytes, seed: int = 0) -> int:
    """Faithful MurmurHash3 x64 128-bit."""
    c1, c2 = 0x87C37B91114253D5, 0x4CF5AD432745937F
    h1 = h2 = seed & MASK64
    length = len(data)
    nblocks = length // 16
    for i in range(nblocks):
        k1 = int.from_bytes(data[i * 16 : i * 16 + 8], "little")
        k2 = int.from_bytes(data[i * 16 + 8 : i * 16 + 16], "little")
        k1 = (k1 * c1) & MASK64
        k1 = _rotl64(k1, 31)
        k1 = (k1 * c2) & MASK64
        h1 ^= k1
        h1 = _rotl64(h1, 27)
        h1 = (h1 + h2) & MASK64
        h1 = (h1 * 5 + 0x52DCE729) & MASK64
        k2 = (k2 * c2) & MASK64
        k2 = _rotl64(k2, 33)
        k2 = (k2 * c1) & MASK64
        h2 ^= k2
        h2 = _rotl64(h2, 31)
        h2 = (h2 + h1) & MASK64
        h2 = (h2 * 5 + 0x38495AB5) & MASK64
    tail = data[nblocks * 16 :]
    k1 = k2 = 0
    if len(tail) > 8:
        k2 = int.from_bytes(tail[8:].ljust(8, b"\0"), "little")
        k2 = (k2 * c2) & MASK64
        k2 = _rotl64(k2, 33)
        k2 = (k2 * c1) & MASK64
        h2 ^= k2
    if len(tail) > 0:
        k1 = int.from_bytes(tail[:8].ljust(8, b"\0"), "little")
        k1 = (k1 * c1) & MASK64
        k1 = _rotl64(k1, 31)
        k1 = (k1 * c2) & MASK64
        h1 ^= k1
    h1 ^= length
    h2 ^= length
    h1 = (h1 + h2) & MASK64
    h2 = (h2 + h1) & MASK64
    h1 = _fmix64(h1)
    h2 = _fmix64(h2)
    h1 = (h1 + h2) & MASK64
    h2 = (h2 + h1) & MASK64
    return h1 | (h2 << 64)


def _extend_to_bits(h128: int, bits: int) -> int:
    """Extend/truncate a 128-bit value to ``bits`` by chained remixing."""
    if bits <= 128:
        return h128 & ((1 << bits) - 1)
    out, acc, got = 0, h128, 0
    while got < bits:
        out |= (acc & ((1 << 128) - 1)) << got
        got += 128
        acc = _fmix64(acc & MASK64) | (_fmix64((acc >> 64) ^ 0x9E3779B97F4A7C15) << 64)
    return out & ((1 << bits) - 1)


def hash_murmur(value: str, bits: int = 128) -> int:
    return _extend_to_bits(murmur3_x64_128(value.encode("utf-8")), bits)


def hash_md5(value: str, bits: int = 128) -> int:
    d = hashlib.md5(value.encode("utf-8")).digest()
    h = int.from_bytes(d, "little")
    return _extend_to_bits(h, bits)


def hash_city(value: str, bits: int = 128) -> int:
    """CityHash-class uniform mix (two seeded 64-bit FNV-1a + murmur finalize)."""
    data = value.encode("utf-8")
    h1, h2 = 0xCBF29CE484222325, 0x100000001B3 ^ 0x9E3779B97F4A7C15
    for b in data:
        h1 = ((h1 ^ b) * 0x100000001B3) & MASK64
        h2 = ((h2 ^ (b + 0x9E)) * 0x100000001B3) & MASK64
    h1, h2 = _fmix64(h1 ^ len(data)), _fmix64(h2 + len(data))
    return _extend_to_bits(h1 | (h2 << 64), bits)


def hash_simhash(value: str, bits: int = 128) -> int:
    """Charikar simhash over character 2-grams."""
    data = value.encode("utf-8")
    grams = [data[i : i + 2] for i in range(max(len(data) - 1, 1))]
    counts = [0] * bits
    for g in grams:
        gh = _extend_to_bits(murmur3_x64_128(g, seed=7), bits)
        for i in range(bits):
            counts[i] += 1 if (gh >> i) & 1 else -1
    out = 0
    for i in range(bits):
        if counts[i] >= 0:
            out |= 1 << i
    return out


def hash_ht(value: str, bits: int = 128) -> int:
    """Hash table: a single bit per value."""
    return 1 << (murmur3_x64_128(value.encode("utf-8")) % bits)


def make_bloom(n_hash: int):
    def hash_bf(value: str, bits: int = 128) -> int:
        data = value.encode("utf-8")
        out = 0
        for s in range(n_hash):
            out |= 1 << (murmur3_x64_128(data, seed=0xB10F + s) % bits)
        return out

    hash_bf.__name__ = f"hash_bf{n_hash}"
    return hash_bf


def optimal_bloom_hashes(bits: int, avg_row_width: float) -> int:
    """k = (m/n) ln 2 with n = average #values OR-ed into one super key."""
    return max(1, round(bits / max(avg_row_width, 1.0) * math.log(2)))


# Registry used by the index/benchmarks. 'xash' is handled natively by
# repro.core.xash; entries here are ``fn(value, bits) -> int``.
BASELINE_HASHES = {
    "murmur": hash_murmur,
    "md5": hash_md5,
    "city": hash_city,
    "simhash": hash_simhash,
    "ht": hash_ht,
}
