"""Phase-B index sharding: byte parity of --engine index-sharded on an
8-virtual-device CPU mesh vs the host engine and the reference binary
(BASELINE configs 4-5; the last §2 parallelism-inventory row)."""

import subprocess
import sys

import numpy as np
import pytest

from .conftest import REPO, simulate
from .test_golden_se import assert_same, run_ref


def run_sharded(workdir, args, ndev=8):
    env = {"PYTHONPATH": str(REPO), "BSMAP_JAX_CPU_JIT_CACHE": "1", "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={ndev}",
           "BSMAP_JAX_DEV_BATCH": "1024", "BSMAP_JAX_CANDS_PER_READ": "16",
           "HOME": "/root"}
    r = subprocess.run([sys.executable, "-m", "bsmap_jax.cli"] + args
                       + ["--engine", "index-sharded"],
                       cwd=workdir, capture_output=True, env=env)
    assert r.returncode == 0, r.stderr.decode()


@pytest.fixture(scope="module")
def shard_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("idxshard")
    simulate(d, genome_out="ref.fa", reads_out="reads.fq", n_reads=700,
             read_len=60, chr_len=20000, n_chr=3, seed=31, error_rate=0.02)
    return d


def test_region_shards_partition():
    """Every index entry is owned by exactly one shard and in-bucket order
    is preserved."""
    import io
    from bsmap_jax.params import Param
    from bsmap_jax.reference import load_genome
    from bsmap_jax.index import build_index
    from bsmap_jax.parallel.index_sharded import build_region_shards

    p = Param()
    p.set_seed_size(10)
    rng = np.random.RandomState(3)
    fa = "".join(f">c{i}\n" + "".join(
        "ACGT"[b] for b in rng.randint(0, 4, 6000)) + "\n" for i in range(2))
    genome = load_genome(io.StringIO(fa), p)
    index = build_index(genome, p)
    ndev = 4
    bounds, tabs, wl_s, cl_s = build_region_shards(genome, index, ndev)
    counts = np.diff(index.offsets)
    wc = index.wcounts
    assert tabs[:, :, 2].sum() == wc.sum()
    assert tabs[:, :, 4].sum() == counts.sum()
    # per-bucket: local counts sum to global
    assert (tabs[:, :, 2].sum(axis=0) == wc).all()
    assert (tabs[:, :, 4].sum(axis=0) == counts).all()
    # local watson slices ascend within each bucket
    for d in range(ndev):
        off, cnt = tabs[d, :, 0], tabs[d, :, 2]
        for b in np.nonzero(cnt > 1)[0][:50]:
            seg = wl_s[d, off[b]: off[b] + cnt[b]]
            assert (np.diff(seg.astype(np.int64)) >= 0).all()


@pytest.mark.parametrize("cfg", [
    ["-S", "1", "-v", "2", "-u"],
    ["-S", "1", "-v", "2", "-u", "-n", "1"],
    ["-S", "1", "-v", "3", "-r", "0", "-u"],
])
def test_index_sharded_parity(reference_binary, shard_data, cfg):
    base = ["-a", "reads.fq", "-d", "ref.fa"]
    run_ref(reference_binary, shard_data, base + ["-o", "ref.sam"] + cfg)
    run_sharded(shard_data, base + ["-o", "our_is.sam"] + cfg)
    assert_same(shard_data, "ref.sam", "our_is.sam")


def run_mesh(workdir, args, engine, ndev=8):
    env = {"PYTHONPATH": str(REPO), "BSMAP_JAX_CPU_JIT_CACHE": "1", "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={ndev}",
           "BSMAP_JAX_DEV_BATCH": "1024", "BSMAP_JAX_CANDS_PER_READ": "16",
           "HOME": "/root"}
    r = subprocess.run([sys.executable, "-m", "bsmap_jax.cli"] + args
                       + ["--engine", engine],
                       cwd=workdir, capture_output=True, env=env)
    assert r.returncode == 0, r.stderr.decode()


@pytest.fixture(scope="module")
def pe_mesh_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_pe")
    simulate(d, genome_out="pe.fa", reads_out="p1.fq", reads2_out="p2.fq",
             pe=True, n_reads=500, read_len=60, chr_len=30000, seed=41,
             error_rate=0.01)
    return d


@pytest.mark.parametrize("engine", ["sharded", "index-sharded"])
def test_pe_mesh_engine_parity(reference_binary, pe_mesh_data, engine):
    """PE over BOTH mesh engines (r4 verdict item 4): the PairDeviceEngine
    wraps the sharded SE engines; under index sharding the kernel's K-hit
    lists psum-merge at each hit's global discovery rank."""
    base = ["-a", "p1.fq", "-b", "p2.fq", "-d", "pe.fa",
            "-S", "1", "-v", "2", "-u"]
    run_ref(reference_binary, pe_mesh_data, base + ["-o", "refpm.sam"])
    run_mesh(pe_mesh_data, base + ["-o", f"ourpm_{engine}.sam"], engine)
    assert_same(pe_mesh_data, "refpm.sam", f"ourpm_{engine}.sam")


def test_rrbs_sharded_engine_parity(reference_binary, tmp_path_factory):
    """RRBS on the data-parallel mesh engine (--engine sharded): the rrbs
    kernel + tag-partitioned index replicate across devices like WGBS.
    (The index-sharded engine still routes RRBS to other engines.)"""
    import random
    import re
    d = tmp_path_factory.mktemp("rrbs_mesh")
    rng = random.Random(17)
    parts, pos = [], 0
    while pos < 40000:
        seg = "".join(rng.choice("ACGT")
                      for _ in range(rng.randint(30, 250)))
        parts += [seg, "CCGG"]
        pos += len(seg) + 4
    g = "".join(parts)
    with open(d / "g.fa", "w") as f:
        f.write(">chr1\n")
        for i in range(0, len(g), 70):
            f.write(g[i:i + 70] + "\n")
    sites = [m.start() for m in re.finditer("CCGG", g)]
    comp = str.maketrans("ACGT", "TGCA")
    with open(d / "r.fq", "w") as f:
        n = 0
        for _ in range(3000):
            i = rng.randrange(len(sites) - 1)
            frag = g[sites[i] + 1: sites[i + 1] + 3]
            if not (28 <= len(frag) <= 500):
                continue
            L = min(60, len(frag))
            s = (frag[:L] if rng.random() < 0.5
                 else frag[::-1].translate(comp)[:L])
            s = "".join("T" if c == "C" and rng.random() < 0.9 else c
                        for c in s)
            f.write(f"@r{n}\n{s}\n+\n{'I' * L}\n")
            n += 1
            if n >= 800:
                break
    base = ["-a", "r.fq", "-d", "g.fa", "-D", "C-CGG",
            "-S", "1", "-v", "2", "-u"]
    run_ref(reference_binary, d, base + ["-o", "ref.sam"])
    run_mesh(d, base + ["-o", "our.sam"], "sharded")
    assert_same(d, "ref.sam", "our.sam")
