"""XASH parity: the PyTorch port (plain path) against the JAX reference.

The same encoded inputs go through ``repro.core.xash`` (XLA) and
``repro_torch.core.xash`` / ``repro_torch.kernels.xash_kernel`` (their CPU
path is the kernel's plain PyTorch version).  Lanes are integers, so the
tolerance is exact: bit-identical at 128/256/512 bits, for every ablation
flag and for empty strings.  (``repro.kernels.ops.superkey`` is not an
oracle here: the reference's Pallas XASH kernel does not run on this jax.)
"""

import numpy as np
import pytest
import torch

from repro.core import encoding as ref_encoding
from repro.core import xash as ref_xash
from repro_torch.core import encoding, xash
from repro_torch.kernels import ref, xash_kernel

ALL_BITS = (128, 256, 512)
# ablation flags — bit 0: use_location, bit 1: use_length, bit 2: use_rotation.
# Every combination at 128 bits, none and all at the wider widths (each case
# costs one reference compile).
WIDTH_FLAGS = [(128, f) for f in range(8)] + [
    (bits, f) for bits in (256, 512) for f in (0, 7)
]

# the inputs of tests/test_xash.py, plus seeded random strings
FIXED_VALUES = [
    "", " ", "loop", "pool", "aa", "aaa", "ab", "x", "0123456789", "a-b",
    "hello world", "hello world 42", "massachusetts institute of technology",
    "Adam Sandler", "Nick Adams", "z" * 60, "q1 x2 z3 j4",
]


def _values(seed=0, n=300):
    rng = np.random.default_rng(seed)
    alphabet = list("abcdefghijklmnopqrstuvwxyzABCXYZ0123456789 -_.,!é")
    rand = [
        "".join(rng.choice(alphabet, size=int(rng.integers(0, 55))))
        for _ in range(n)
    ]
    return FIXED_VALUES + rand


VALUES = _values()


def _cfgs(bits, flags, **kw):
    kwargs = dict(
        bits=bits,
        use_location=bool(flags & 1),
        use_length=bool(flags & 2),
        use_rotation=bool(flags & 4),
        **kw,
    )
    return ref_xash.XashConfig(**kwargs), xash.XashConfig(**kwargs)


@pytest.mark.parametrize("bits", ALL_BITS)
def test_config_derivations_match_reference(bits):
    rc, pc = _cfgs(bits, 7)
    for name in ("lanes", "c", "char_region", "len_segment", "ones", "n_char_bits"):
        assert getattr(pc, name) == getattr(rc, name), name
    assert np.array_equal(pc.freq_rank(), rc.freq_rank())


def test_encoding_matches_reference():
    assert np.array_equal(
        encoding.encode_values(VALUES), ref_encoding.encode_values(VALUES)
    )
    for v in FIXED_VALUES:
        assert encoding.decode_value(encoding.encode_value(v)) == ref_encoding.decode_value(
            ref_encoding.encode_value(v)
        )


@pytest.mark.parametrize("bits,flags", WIDTH_FLAGS)
def test_xash_bit_identical_to_reference(bits, flags):
    rc, pc = _cfgs(bits, flags)
    enc = ref_encoding.encode_values(VALUES, rc.max_len)
    want = np.asarray(ref_xash.xash(enc, rc))
    got = xash.lanes_to_numpy(xash.xash(torch.from_numpy(enc), pc))
    assert got.dtype == np.uint32
    assert np.array_equal(got, want)


@pytest.mark.parametrize("flags", (0, 7))
@pytest.mark.parametrize("bits", ALL_BITS)
def test_superkey_bit_identical_to_reference(bits, flags):
    rc, pc = _cfgs(bits, flags)
    enc = ref_encoding.encode_values(VALUES[:312], rc.max_len).reshape(78, 4, rc.max_len)
    want = np.asarray(ref_xash.superkey(enc, rc))
    got = xash.lanes_to_numpy(xash.superkey(torch.from_numpy(enc), pc))
    assert np.array_equal(got, want)
    # the kernel wrapper on a CPU tensor is its plain version
    wrapped = xash.lanes_to_numpy(xash_kernel.xash_superkey(torch.from_numpy(enc), pc))
    assert np.array_equal(wrapped, want)


@pytest.mark.parametrize("bits", ALL_BITS)
def test_corpus_char_freq_rank(bits):
    """A corpus frequency prior changes the rarest-char choice identically."""
    rng = np.random.default_rng(bits)
    freq = tuple(rng.random(ref_encoding.ALPHABET_SIZE).tolist())
    rc, pc = _cfgs(bits, 7, char_freq=freq)
    enc = ref_encoding.encode_values(VALUES, rc.max_len)
    want = np.asarray(ref_xash.xash(enc, rc))
    got = xash.lanes_to_numpy(xash_kernel.xash_values(torch.from_numpy(enc), pc))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("flags", range(8))
@pytest.mark.parametrize("bits", ALL_BITS)
def test_oracle_matches_reference_oracle(bits, flags):
    rc, pc = _cfgs(bits, flags)
    for v in VALUES[:120]:
        h = xash.xash_oracle(v, pc)
        assert h == ref_xash.xash_oracle(v, rc), v
        assert np.array_equal(xash.int_to_lanes(h, pc), ref_xash.int_to_lanes(h, rc))
        assert xash.lanes_to_int(xash.int_to_lanes(h, pc)) == h


def test_empty_values_set_nothing():
    pc = xash.XashConfig(bits=256)
    enc = torch.zeros(3, 2, pc.max_len, dtype=torch.uint8)
    assert int(xash.superkey(enc, pc).abs().sum()) == 0
    assert xash.xash_oracle("", pc) == 0


def test_lane_numpy_roundtrip_keeps_bit_patterns():
    lanes = np.array([[0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF]], dtype=np.uint32)
    t = xash.lanes_to_torch(lanes, "cpu")
    assert t.dtype == torch.int32
    assert np.array_equal(xash.lanes_to_numpy(t), lanes)


def test_refs_and_subsumes():
    pc = xash.XashConfig()
    enc = torch.from_numpy(encoding.encode_values(VALUES[:40]))
    assert torch.equal(ref.xash_ref(enc, pc), xash.xash(enc, pc))
    rows = ref.xash_superkey_ref(enc.reshape(10, 4, -1), pc)
    keys = ref.xash_ref(enc[::4], pc)  # the first value of each row
    match = ref.filter_match_ref(rows, keys)
    assert bool(match.diagonal().all())  # no false negatives (§6.3 lemma)
    assert torch.equal(ref.filter_count_ref(rows, keys), match.sum(dim=0, dtype=torch.int32))


def test_wrapper_rejects_bad_input():
    with pytest.raises(ValueError):
        xash_kernel.xash_superkey(torch.zeros(2, 4, dtype=torch.uint8), xash.XashConfig())
    with pytest.raises(ValueError):
        xash_kernel.xash_superkey(torch.zeros(2, 1, 4, dtype=torch.int32), xash.XashConfig())


# ---------------------------------------------------------------------------
# The edge inputs that chip_smoke.py holds the CUDA kernel to, here through
# the kernel's plain version against the reference's XLA superkey: one
# character over the full width, all 37 characters, codes above 37, empty
# cells inside rows and empty rows, at widths 48 (the encoder's), 20 and 80
# ---------------------------------------------------------------------------

def _chip_smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _edge_rows(max_len, n=101):
    rng = np.random.default_rng(max_len)
    uniq = ref_encoding.encode_values(VALUES, 48)
    return _chip_smoke().xash_edge_inputs(rng, uniq, n, max_len)


EDGE_CASES = [(bits, f, 48) for bits in ALL_BITS for f in range(8)] + [
    (128, 7, 20), (128, 7, 80), (512, 5, 80),
]


@pytest.mark.parametrize("bits,flags,max_len", EDGE_CASES)
def test_superkey_edge_inputs_bit_identical_to_reference(bits, flags, max_len):
    rc, pc = _cfgs(bits, flags, max_len=max_len)
    enc = _edge_rows(max_len)
    want = np.asarray(ref_xash.superkey(enc, rc))
    got = xash.lanes_to_numpy(xash_kernel.xash_superkey(torch.from_numpy(enc), pc))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n_ones", [9, 12])
def test_superkey_edge_inputs_with_many_char_bits(n_ones):
    """More chosen characters than the CUDA kernel's register selection keeps."""
    rc, pc = _cfgs(128, 7, n_ones=n_ones)
    enc = _edge_rows(48)[:30]  # the main path's query-key shape [30, 3, 48]
    want = np.asarray(ref_xash.superkey(enc, rc))
    got = xash.lanes_to_numpy(xash_kernel.xash_superkey(torch.from_numpy(enc), pc))
    assert np.array_equal(got, want)
