"""Multi-device data-parallel engine vs the single-device engine (8-way
virtual CPU mesh, see conftest)."""

import pathlib
import subprocess
import sys

import pytest

from .conftest import REPO, simulate


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded")
    simulate(d, genome_out="g.fa", reads_out="r.fq", n_reads=3000,
             read_len=64, chr_len=60000, n_chr=2, seed=11)
    return d


def _run_cli(d, out, extra):
    env = dict(__import__("os").environ)
    cmd = [sys.executable, "-m", "bsmap_jax.cli", "-a", str(d / "r.fq"),
           "-d", str(d / "g.fa"), "-o", str(d / out), "-S", "3", "-v", "2",
           "-u"] + extra
    subprocess.run(cmd, check=True, cwd=REPO, env=env,
                   stdout=subprocess.DEVNULL)
    return (d / out).read_text()


def test_sharded_matches_device(data):
    a = _run_cli(data, "dev.sam", ["--engine", "device"])
    b = _run_cli(data, "shard.sam", ["--engine", "sharded"])
    assert a == b


def test_sharded_engine_inprocess(data):
    import jax
    from bsmap_jax.params import Param
    from bsmap_jax.reference import load_genome
    from bsmap_jax.index import build_index
    from bsmap_jax.readio import open_read_stream
    from bsmap_jax.parallel import ShardedDeviceEngine, make_mesh
    from bsmap_jax.engine.device_engine import DeviceEngine, DeviceView

    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    p = Param()
    p.randseed = 3
    g = load_genome(str(data / "g.fa"), p)
    idx = build_index(g, p)
    p2 = Param()
    p2.randseed = 3
    mesh = make_mesh(8)
    eng_s = ShardedDeviceEngine(g, idx, p, mesh=mesh)
    eng_1 = DeviceEngine(g, idx, p2)
    s = open_read_stream(str(data / "r.fq"), p, readset=0)
    batch = s.next_batch(3000)
    s.close()
    rs = eng_s.align_batch(list(batch))
    r1 = eng_1.align_batch(list(batch))
    n_cmp = 0
    for a, b in zip(rs, r1):
        if isinstance(a, DeviceView) and isinstance(b, DeviceView):
            assert a.found == b.found
            if a.found:   # hit/level/ssum are undefined for unfound reads
                assert a.level == b.level
                assert a.ssum == b.ssum
                assert a.hit == b.hit
            n_cmp += 1
    assert n_cmp > 2000
    assert int(eng_s.last_n_aligned.sum()) > 0
