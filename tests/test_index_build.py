"""Native two-pass index build vs the numpy reference path, and the
memory-mapped cache loader."""

import os

import numpy as np
import pytest

from bsmap_jax import native
from bsmap_jax.params import Param
from bsmap_jax.reference import load_genome
import bsmap_jax.index as ix


def _write_genome(tmp_path, seqs):
    p = tmp_path / "g.fa"
    with open(p, "w") as fh:
        for i, s in enumerate(seqs):
            fh.write(f">chr{i}\n{s}\n")
    return str(p)


@pytest.fixture()
def genome_path(tmp_path):
    rng = np.random.default_rng(7)
    base = np.array(list("ACGT"))

    def seq(n):
        s = base[rng.integers(0, 4, n)]
        # N runs split the sequence into multiple unmasked blocks
        for start in rng.integers(0, max(n - 40, 1), 3):
            s[start: start + rng.integers(1, 30)] = "N"
        return "".join(s)

    return _write_genome(tmp_path, [seq(5000), seq(3000), seq(800)])


@pytest.mark.parametrize("s,i", [(16, 4), (12, 1), (10, 16), (8, 16)])
def test_native_matches_numpy(genome_path, s, i):
    lib = native.get_lib()
    if lib is None:
        pytest.skip("native lib unavailable")
    p = Param()
    p.set_seed_size(s)
    p.index_interval = i
    p.init_mapping()
    g = load_genome(genome_path, p)
    os.environ["BSMAP_JAX_NATIVE_INDEX"] = "0"
    try:
        a = ix.build_index(g, p)
    finally:
        os.environ["BSMAP_JAX_NATIVE_INDEX"] = "1"
    b = ix._build_wgbs_native(g, p, lib)
    assert np.array_equal(a.offsets, b.offsets)
    assert np.array_equal(a.locs, b.locs)
    assert np.array_equal(a.wcounts, b.wcounts)
    assert len(a.locs) > 0


def test_mmap_cache_roundtrip(genome_path, tmp_path):
    p = Param()
    p.init_mapping()
    g = load_genome(genome_path, p)
    idx = ix.build_index(g, p)
    path = str(tmp_path / "idx.npz")
    ix.save_index(path, idx)
    back = ix.load_index(path, mmap=True)
    assert back.seed_size == idx.seed_size
    assert np.array_equal(np.asarray(back.offsets), idx.offsets)
    assert np.array_equal(np.asarray(back.locs), idx.locs)
    assert np.array_equal(np.asarray(back.wcounts), idx.wcounts)
    # the big arrays really are memory maps, not heap copies
    assert isinstance(back.locs, np.memmap)
