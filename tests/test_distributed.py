"""Multi-host data parallelism: N-process contiguous read-range sharding
with exact MateState reconstruction at range boundaries must be
byte-identical to the single-process run (parallel/distributed.py) — a
stronger guarantee than the reference's manual -B/-E splitting, which
resets the per-process aligner state."""

import subprocess
import sys

import pytest

from .conftest import REPO, simulate


@pytest.fixture(scope="module")
def dist_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    simulate(d, genome_out="g.fa", reads_out="r.fq", n_reads=1500,
             read_len=51, chr_len=30000, n_chr=2, seed=23, error_rate=0.02)
    # mixed 50/51nt: the stale-schedule corner must survive the range cut
    raw = (d / "r.fq").read_text().splitlines()
    out = []
    for k in range(0, len(raw), 4):
        name, seq, plus, qual = raw[k: k + 4]
        if (k // 4) % 2 == 0:
            seq, qual = seq[:50], qual[:50]
        out += [name, seq, plus, qual]
    (d / "rm.fq").write_text("\n".join(out) + "\n")
    return d


def _run(d, out, extra):
    import os
    cmd = [sys.executable, "-m", "bsmap_jax.cli", "-a", str(d / "rm.fq"),
           "-d", str(d / "g.fa"), "-o", str(d / out), "-S", "1", "-v", "2",
           "-u"] + extra
    return subprocess.Popen(cmd, cwd=REPO, env=dict(os.environ),
                            stdout=subprocess.DEVNULL)


@pytest.mark.parametrize("engine", ["device", "host"])
def test_two_process_equals_one(dist_data, engine):
    d = dist_data
    _run(d, "one.sam", ["--engine", engine]).wait()
    p1 = _run(d, "two.sam", ["--engine", engine, "--nprocs", "2",
                             "--proc-id", "1"])
    p0 = _run(d, "two.sam", ["--engine", engine, "--nprocs", "2",
                             "--proc-id", "0"])
    assert p0.wait() == 0 and p1.wait() == 0
    assert (d / "one.sam").read_bytes() == (d / "two.sam").read_bytes()


@pytest.fixture(scope="module")
def dist_pe_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("distpe")
    simulate(d, genome_out="g.fa", reads_out="ra.fq", reads2_out="rb.fq",
             pe=True, n_reads=900, read_len=50, chr_len=30000, n_chr=2,
             seed=29, error_rate=0.02)
    return d


def _run_pe(d, out, extra):
    import os
    cmd = [sys.executable, "-m", "bsmap_jax.cli", "-a", str(d / "ra.fq"),
           "-b", str(d / "rb.fq"), "-d", str(d / "g.fa"),
           "-o", str(d / out), "-S", "1", "-v", "2", "-u"] + extra
    return subprocess.Popen(cmd, cwd=REPO, env=dict(os.environ),
                            stdout=subprocess.DEVNULL)


def test_two_process_pe_equals_one(dist_pe_data):
    """--nprocs with -b must run the PAIR path per range (round-2 bug:
    it silently aligned only -a as single-end)."""
    d = dist_pe_data
    _run_pe(d, "one.sam", ["--engine", "host"]).wait()
    p1 = _run_pe(d, "two.sam", ["--engine", "host", "--nprocs", "2",
                                "--proc-id", "1"])
    p0 = _run_pe(d, "two.sam", ["--engine", "host", "--nprocs", "2",
                                "--proc-id", "0"])
    assert p0.wait() == 0 and p1.wait() == 0
    assert (d / "one.sam").read_bytes() == (d / "two.sam").read_bytes()


def test_p_flag_local_multiprocess_bsp(dist_data):
    """-p N on a per-read path (BSP output) shards locally and merges
    byte-identical to -p 1 (the reference's C18 thread pool recast)."""
    import os
    d = dist_data
    env = dict(os.environ)
    for out, extra in (("one.bsp", ["-p", "1"]), ("two.bsp", ["-p", "2"])):
        cmd = [sys.executable, "-m", "bsmap_jax.cli", "-a", str(d / "rm.fq"),
               "-d", str(d / "g.fa"), "-o", str(d / out), "-S", "1",
               "-v", "2", "--engine", "host"] + extra
        r = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True)
        assert r.returncode == 0, r.stderr.decode()
    assert (d / "one.bsp").read_bytes() == (d / "two.bsp").read_bytes()


def test_two_process_with_real_coordinator(dist_data):
    """Exercise jax.distributed.initialize with a REAL coordinator
    (r4 verdict item 9: the --coordinator path had never run).  Two CPU
    processes join a coordination service on a local port; output must
    equal the coordinator-free 2-process run."""
    import os
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "bsmap_jax.cli", "-a",
             str(dist_data / "rm.fq"), "-d", str(dist_data / "g.fa"),
             "-o", str(dist_data / "coord.sam"), "-S", "1", "-v", "2",
             "-u", "--engine", "host", "--nprocs", "2", "--proc-id",
             str(k), "--coordinator", coord],
            cwd=REPO, env=env, stdout=subprocess.DEVNULL)
        for k in range(2)]
    rcs = [q.wait(timeout=600) for q in procs]
    assert rcs == [0, 0], rcs
    # reference output: plain 2-process run without a coordinator
    procs = [_run(dist_data, "nocoord.sam",
                  ["--engine", "host", "--nprocs", "2", "--proc-id",
                   str(k)]) for k in range(2)]
    assert [q.wait(timeout=600) for q in procs] == [0, 0]
    assert (dist_data / "coord.sam").read_bytes() == \
        (dist_data / "nocoord.sam").read_bytes()
