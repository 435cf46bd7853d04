"""XASH — the paper's hash function (§5), plus a pure-Python oracle.

Port of ``repro.core.xash``.  The layout, the oracle and the config are the
reference's; the vectorised functions are PyTorch and are the PLAIN version
of the hand-written XASH kernel (``kernels.xash_kernel``), which computes the
same lanes on the card.

Layout of the ``bits``-wide hash (bit index 0 is the LEFTMOST bit, the
paper's convention; we store the array as ``bits//32`` 32-bit lanes with
bit ``b`` living in lane ``b // 32`` at in-lane offset ``b % 32``):

    [ length segment : L bits ][ character region : 37*c bits ]

* ``c``   = max c with 37*c < bits            (Eq. 6; c=3 for 128 bits)
* ``L``   = bits - 37*c                       (17 for 128 bits)
* ``ones``= argmin_i C(bits, i) > n_unique    (Eq. 5; 6 for 128b / 700M)
  → 1 length bit + (ones-1) character bits.

Per value v (length l_v = #characters):
  1. pick the ``ones-1`` least-frequent DISTINCT characters of v (within-
     value occurrence count, ties by the global character-frequency prior,
     then by char id);
  2. for each, average occurrence position (1-based) -> segment-local bit
     x = ceil(avg * c / l_v)                  (Eq. 7, exact integer math)
     region position p = char_id * c + (x-1);
  3. rotate the character region LEFT by l_v: p' = (p - l_v) mod (37*c);
  4. set length bit (l_v mod L) in the leftmost segment (§5.3.4).

Lanes as tensors: torch on the CPU refuses ``~`` and ``<<`` on
``torch.uint32``, and the filter predicate ``(q & ~r) == 0`` needs ``~``.
So every lane tensor in the port is ``torch.int32`` holding the uint32 BIT
PATTERN; ``lanes_to_torch`` / ``lanes_to_numpy`` reinterpret at the numpy
boundary (numpy arrays stay ``uint32``, as in the reference).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import encoding


@dataclasses.dataclass(frozen=True)
class XashConfig:
    bits: int = 128
    n_unique: int = 700_000_000  # DWTC-scale default (paper §5.3.1)
    n_ones: int | None = None  # override Eq. 5 if set
    char_freq: tuple | None = None  # corpus char frequencies (37,)
    max_len: int = encoding.MAX_LEN
    # component ablation switches (paper Fig. 6): full XASH = all True
    use_location: bool = True  # character-location bit within segment
    use_length: bool = True  # length segment bit
    use_rotation: bool = True  # rotate char region by l_v

    @property
    def lanes(self) -> int:
        assert self.bits % 32 == 0
        return self.bits // 32

    @property
    def c(self) -> int:
        """Bits per character segment (Eq. 6)."""
        return (self.bits - 1) // encoding.ALPHABET_SIZE

    @property
    def char_region(self) -> int:
        return encoding.ALPHABET_SIZE * self.c

    @property
    def len_segment(self) -> int:
        return self.bits - self.char_region

    @property
    def ones(self) -> int:
        """Total 1-bits per hash (Eq. 5): 1 length bit + (ones-1) char bits."""
        if self.n_ones is not None:
            return self.n_ones
        i = 1
        while math.comb(self.bits, i) <= self.n_unique:
            i += 1
        return i

    @property
    def n_char_bits(self) -> int:
        return self.ones - 1

    def freq_rank(self) -> np.ndarray:
        f = None if self.char_freq is None else np.asarray(self.char_freq)
        return encoding.freq_rank(f)


DEFAULT_CONFIG = XashConfig()


# ---------------------------------------------------------------------------
# Pure-Python oracle (operates on raw strings; ground truth for tests)
# ---------------------------------------------------------------------------

def xash_oracle(value: str, cfg: XashConfig = DEFAULT_CONFIG) -> int:
    """Reference XASH of one string as an arbitrary-precision Python int.

    Bit b of the conceptual layout (0 = leftmost) is represented as
    ``1 << b`` so that lane packing can be checked exactly.
    """
    enc = encoding.encode_value(value, cfg.max_len)
    return xash_oracle_encoded(enc, cfg)


def xash_oracle_encoded(enc: np.ndarray, cfg: XashConfig = DEFAULT_CONFIG) -> int:
    codes = [int(x) for x in enc if x != encoding.PAD]
    l_v = len(codes)
    if l_v == 0:
        return 0
    rank = cfg.freq_rank()
    occ: dict[int, list[int]] = {}
    for pos, code in enumerate(codes, start=1):
        occ.setdefault(code - 1, []).append(pos)
    present = sorted(occ, key=lambda cid: (len(occ[cid]), int(rank[cid]), cid))
    chosen = present[: cfg.n_char_bits]

    h = 0
    c, region, lseg = cfg.c, cfg.char_region, cfg.len_segment
    for cid in chosen:
        positions = occ[cid]
        sum_pos, count = sum(positions), len(positions)
        if cfg.use_location:
            x = -((-sum_pos * c) // (count * l_v))
            x = min(max(x, 1), c)
        else:
            x = 1
        p = cid * c + (x - 1)
        p_rot = (p - l_v) % region if cfg.use_rotation else p
        h |= 1 << (lseg + p_rot)
    if cfg.use_length:
        h |= 1 << (l_v % lseg)
    return h


def int_to_lanes(h: int, cfg: XashConfig = DEFAULT_CONFIG) -> np.ndarray:
    """Pack an oracle hash int into uint32 lanes (bit b -> lane b//32, bit b%32)."""
    out = np.zeros(cfg.lanes, dtype=np.uint32)
    for lane in range(cfg.lanes):
        out[lane] = (h >> (32 * lane)) & 0xFFFFFFFF
    return out


def lanes_to_int(lanes: np.ndarray) -> int:
    h = 0
    for i, lane in enumerate(np.asarray(lanes, dtype=np.uint64)):
        h |= int(lane) << (32 * i)
    return h


# ---------------------------------------------------------------------------
# numpy <-> torch lane boundary
# ---------------------------------------------------------------------------

def lanes_to_torch(lanes: np.ndarray, device=None) -> torch.Tensor:
    """uint32 numpy lanes -> int32 tensor with the same bit pattern (copied)."""
    arr = np.ascontiguousarray(lanes, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(arr).to(device=device, copy=True)


def lanes_to_numpy(lanes: torch.Tensor) -> np.ndarray:
    """int32 lane tensor -> uint32 numpy lanes with the same bit pattern."""
    return lanes.detach().cpu().contiguous().numpy().view(np.uint32)


def _int64_to_lane_bits(x: torch.Tensor) -> torch.Tensor:
    """Values in [0, 2**32) held in int64 -> int32 with the same low 32 bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


# ---------------------------------------------------------------------------
# Vectorised PyTorch implementation (the plain version of the XASH kernel)
# ---------------------------------------------------------------------------

_BIG = 1 << 24


def _bit_positions(enc: torch.Tensor, cfg: XashConfig, rank: torch.Tensor):
    """Per-value bit positions to set.

    Args:
      enc: uint8[n, max_len] encoded values.
      rank: int64[37] ascending-frequency rank of each char id.
    Returns:
      (positions int64[n, ones], valid bool[n, ones]) — global bit indices
      per value (length bit last).
    """
    a = encoding.ALPHABET_SIZE
    n, max_len = enc.shape
    c, region, lseg = cfg.c, cfg.char_region, cfg.len_segment
    dev = enc.device

    codes = enc.long()
    is_char = codes > 0
    l_v = is_char.sum(dim=-1)  # [n]
    # per-char counts and 1-based position sums; column 0 collects padding
    # (and codes past the alphabet land nowhere, as in the one-hot reference)
    slot = torch.where(codes <= a, codes, torch.zeros_like(codes))
    count = torch.zeros(n, a + 1, dtype=torch.int64, device=dev)
    count.scatter_add_(1, slot, torch.ones_like(slot))
    pos = torch.arange(1, max_len + 1, dtype=torch.int64, device=dev).expand(n, max_len)
    sum_pos = torch.zeros(n, a + 1, dtype=torch.int64, device=dev)
    sum_pos.scatter_add_(1, slot, pos)
    count, sum_pos = count[:, 1:], sum_pos[:, 1:]

    # rarest (n_char_bits) present chars: least within-value count first, then
    # global-frequency rank (scores of present chars are distinct, rank being
    # a permutation, so the order among ties at _BIG never matters)
    score = torch.where(count > 0, count * 64 + rank, torch.full_like(count, _BIG))
    k = cfg.n_char_bits
    top, chosen_ids = torch.topk(score, k, dim=-1, largest=False, sorted=True)
    chosen_valid = top < _BIG

    ch_count = torch.gather(count, 1, chosen_ids)
    ch_sum = torch.gather(sum_pos, 1, chosen_ids)
    if cfg.use_location:
        # x = ceil(sum_pos * c / (count * l_v)) exactly, in integers
        denom = torch.clamp(ch_count * l_v[:, None], min=1)
        x = -torch.div(-ch_sum * c, denom, rounding_mode="floor")
        x = torch.clamp(x, 1, c)
    else:
        x = torch.ones_like(chosen_ids)
    p = chosen_ids * c + (x - 1)
    p_rot = torch.remainder(p - l_v[:, None], region) if cfg.use_rotation else p
    char_bits = lseg + p_rot  # [n, k]

    len_bit = torch.remainder(l_v, lseg)[:, None]
    len_valid = (l_v > 0)[:, None] & cfg.use_length

    positions = torch.cat([char_bits, len_bit], dim=-1)
    valid = torch.cat([chosen_valid, len_valid], dim=-1) & (l_v[:, None] > 0)
    return positions, valid


def _pack(positions: torch.Tensor, valid: torch.Tensor, cfg: XashConfig) -> torch.Tensor:
    """Set each valid bit position in int32 lanes [n, lanes].

    The positions of one value are distinct (distinct char ids, a bijective
    rotation, and a length bit below every char bit), so summing the
    one-bit words of a lane equals OR-ing them.
    """
    n = positions.shape[0]
    word = torch.where(
        valid, torch.ones_like(positions) << (positions & 31), torch.zeros_like(positions)
    )
    acc = torch.zeros(n, cfg.lanes, dtype=torch.int64, device=positions.device)
    acc.scatter_add_(1, positions >> 5, word)
    return _int64_to_lane_bits(acc)


def xash(enc: torch.Tensor, cfg: XashConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """XASH of encoded values.

    Args:
      enc: uint8[..., max_len] encoded values (see encoding.py).
    Returns:
      int32[..., lanes] hash lanes (uint32 bit patterns).
    """
    lead, max_len = enc.shape[:-1], enc.shape[-1]
    flat = enc.reshape(-1, max_len)
    rank = torch.as_tensor(cfg.freq_rank(), dtype=torch.int64, device=enc.device)
    positions, valid = _bit_positions(flat, cfg, rank)
    return _pack(positions, valid, cfg).reshape(*lead, cfg.lanes)


def superkey(enc_row: torch.Tensor, cfg: XashConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """Super key of rows: OR-aggregation of per-cell XASH (§5 'super key').

    Args:
      enc_row: uint8[..., n_cols, max_len] — all cells of each row.
    Returns:
      int32[..., lanes].
    """
    hashes = xash(enc_row, cfg)  # [..., n_cols, lanes]
    acc = torch.zeros(
        *hashes.shape[:-2], cfg.lanes, dtype=torch.int32, device=enc_row.device
    )
    for col in range(hashes.shape[-2]):
        acc |= hashes[..., col, :]
    return acc


def subsumes(query_sk: torch.Tensor, row_sk: torch.Tensor) -> torch.Tensor:
    """Row-filter predicate (§6.3): True iff query_sk ⊆ row_sk lane-wise.

    Broadcasts: query int32[..., lanes] against rows int32[..., lanes].
    """
    return ((query_sk & ~row_sk) == 0).all(dim=-1)
