"""Fixed-width string encoding for MATE.

Copy of ``repro.core.encoding`` (numpy only): the port keeps its own so that it
imports nothing of the reference package.

The paper's XASH operates on the 37-character alphanumeric alphabet
(a-z, 0-9, space).  TPU-side code cannot hold Python strings, so every cell
value is encoded once, offline, into a fixed-width ``uint8`` vector:

    0          -> padding (also: missing cell)
    1 .. 26    -> 'a' .. 'z'   (values are lowercased)
    27 .. 36   -> '0' .. '9'
    37         -> ' '  (any character outside the alphabet maps to space)

``MAX_LEN`` bounds the value length; longer values are truncated (the paper's
length feature uses ``l_v mod L`` so truncation only perturbs, never breaks,
the no-false-negative property as long as the SAME encoding is used on both
the corpus and the query side — which it is).
"""

from __future__ import annotations

import numpy as np

ALPHABET_SIZE = 37
PAD = 0
MAX_LEN = 48  # default fixed width; configurable per corpus

_CHAR_TO_CODE = np.zeros(256, dtype=np.uint8)
for _i in range(26):
    _CHAR_TO_CODE[ord("a") + _i] = 1 + _i
    _CHAR_TO_CODE[ord("A") + _i] = 1 + _i
for _i in range(10):
    _CHAR_TO_CODE[ord("0") + _i] = 27 + _i
# everything else (incl. real spaces) → space code 37, except NUL padding
for _b in range(1, 256):
    if _CHAR_TO_CODE[_b] == 0:
        _CHAR_TO_CODE[_b] = 37
_CHAR_TO_CODE[0] = 0


# English letter frequencies (per-mille, approximate; Lewand ordering) plus
# digit/space priors.  XASH picks the LEAST frequent characters of a value as
# its most discriminative features; the paper computes corpus-level
# frequencies offline — ``CorpusIndex.char_frequencies`` does that too, and
# this table is the query-independent default prior.
DEFAULT_CHAR_FREQ = np.array(
    [
        # a      b      c      d      e      f      g      h      i
        8.167, 1.492, 2.782, 4.253, 12.702, 2.228, 2.015, 6.094, 6.966,
        # j      k      l      m      n      o      p      q      r
        0.153, 0.772, 4.025, 2.406, 6.749, 7.507, 1.929, 0.095, 5.987,
        # s      t      u      v      w      x      y      z
        6.327, 9.056, 2.758, 0.978, 2.360, 0.150, 1.974, 0.074,
        # 0     1     2     3     4     5     6     7     8     9
        1.0, 1.2, 0.9, 0.8, 0.7, 0.7, 0.6, 0.6, 0.6, 0.6,
        # space
        13.000,
    ],
    dtype=np.float64,
)
assert DEFAULT_CHAR_FREQ.shape == (ALPHABET_SIZE,)


def freq_rank(char_freq: np.ndarray | None = None) -> np.ndarray:
    """Rank of each character code (0-based char id) by ascending frequency.

    ``rank[char_id]`` is small for rare characters.  Ties break by char id so
    the ranking — and therefore XASH — is fully deterministic.
    """
    f = DEFAULT_CHAR_FREQ if char_freq is None else np.asarray(char_freq)
    order = np.lexsort((np.arange(ALPHABET_SIZE), f))
    rank = np.empty(ALPHABET_SIZE, dtype=np.int32)
    rank[order] = np.arange(ALPHABET_SIZE, dtype=np.int32)
    return rank


def encode_value(value: str, max_len: int = MAX_LEN) -> np.ndarray:
    """Encode one string to a ``uint8[max_len]`` vector."""
    raw = value.encode("utf-8", errors="replace")[:max_len]
    out = np.zeros(max_len, dtype=np.uint8)
    if raw:
        out[: len(raw)] = _CHAR_TO_CODE[np.frombuffer(raw, dtype=np.uint8)]
    return out


def encode_values(values: list[str], max_len: int = MAX_LEN) -> np.ndarray:
    """Encode a list of strings to ``uint8[n, max_len]`` (vectorised)."""
    n = len(values)
    out = np.zeros((n, max_len), dtype=np.uint8)
    for i, v in enumerate(values):
        raw = v.encode("utf-8", errors="replace")[:max_len]
        if raw:
            out[i, : len(raw)] = _CHAR_TO_CODE[np.frombuffer(raw, dtype=np.uint8)]
    return out


def decode_value(enc: np.ndarray) -> str:
    """Best-effort inverse of :func:`encode_value` (for debugging)."""
    chars = []
    for code in enc:
        if code == PAD:
            break
        if 1 <= code <= 26:
            chars.append(chr(ord("a") + code - 1))
        elif 27 <= code <= 36:
            chars.append(chr(ord("0") + code - 27))
        else:
            chars.append(" ")
    return "".join(chars)
