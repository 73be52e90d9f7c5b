"""Golden-output tests: byte-identical SAM/BSP vs the compiled reference
binary on simulated single-end data (the acceptance bar, BASELINE.json)."""

import subprocess
import sys

import pytest

from .conftest import REPO, simulate


def run_ref(binary, workdir, args):
    # the reference aborts in its end-of-run summary print (locale issue);
    # output files are complete — ignore the exit status.
    subprocess.run([binary] + args + ["-p", "1"], cwd=workdir,
                   capture_output=True)


def run_ours(workdir, args, engine="host", extra_env=None):
    env = {"PYTHONPATH": str(REPO), "BSMAP_JAX_CPU_JIT_CACHE": "1", "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu",
           "BSMAP_JAX_DEV_BATCH": "2048", "BSMAP_JAX_CANDS_PER_READ": "16",
           "HOME": "/root"}
    if extra_env:
        env.update(extra_env)
    r = subprocess.run([sys.executable, "-m", "bsmap_jax.cli"] + args
                       + ["--engine", engine],
                       cwd=workdir, capture_output=True, env=env)
    assert r.returncode == 0, r.stderr.decode()


def assert_same(workdir, a, b):
    ta = (workdir / a).read_bytes()
    tb = (workdir / b).read_bytes()
    if ta != tb:
        la, lb = ta.decode().splitlines(), tb.decode().splitlines()
        for i, (x, y) in enumerate(zip(la, lb)):
            assert x == y, f"line {i}:\nref: {x}\nours: {y}"
        assert len(la) == len(lb), f"line count {len(la)} != {len(lb)}"


@pytest.fixture(scope="module")
def se_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("se")
    simulate(d, genome_out="ref.fa", reads_out="reads.fq", n_reads=800,
             read_len=50, chr_len=40000, seed=11, error_rate=0.02)
    simulate(d, genome_out="ref3.fa", reads_out="reads100.fq", n_reads=500,
             read_len=100, chr_len=15000, n_chr=3, seed=12, error_rate=0.02)
    return d


@pytest.mark.parametrize("cfg", [
    ["-S", "1", "-v", "2"],
    ["-S", "1", "-v", "2", "-u", "-R"],
    ["-S", "1", "-v", "3", "-r", "0", "-u"],
    ["-S", "1", "-v", "2", "-s", "12"],
    ["-S", "1", "-v", "2", "-I", "2"],
    ["-S", "1", "-v", "2", "-n", "1"],
])
def test_se_sam_parity(reference_binary, se_data, cfg):
    base = ["-a", "reads.fq", "-d", "ref.fa"]
    run_ref(reference_binary, se_data, base + ["-o", "ref.sam"] + cfg)
    run_ours(se_data, base + ["-o", "our.sam"] + cfg)
    assert_same(se_data, "ref.sam", "our.sam")


@pytest.mark.parametrize("cfg", [
    ["-S", "1", "-v", "2", "-u", "-R"],
    ["-S", "1", "-v", "2"],
])
def test_se_bsp_parity(reference_binary, se_data, cfg):
    base = ["-a", "reads100.fq", "-d", "ref3.fa"]
    run_ref(reference_binary, se_data, base + ["-o", "ref.bsp"] + cfg)
    run_ours(se_data, base + ["-o", "our.bsp"] + cfg)
    assert_same(se_data, "ref.bsp", "our.bsp")


def test_se_multichr_100nt(reference_binary, se_data):
    base = ["-a", "reads100.fq", "-d", "ref3.fa", "-S", "7", "-v", "2", "-u"]
    run_ref(reference_binary, se_data, base + ["-o", "ref100.sam"])
    run_ours(se_data, base + ["-o", "our100.sam"])
    assert_same(se_data, "ref100.sam", "our100.sam")
