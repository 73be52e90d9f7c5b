"""Tests for methratio, bsp2sam and the BAM layer (C21-C24)."""

import subprocess
import sys

import numpy as np
import pytest

from .conftest import REPO, simulate
from .test_golden_se import run_ref, run_ours, assert_same


@pytest.fixture(scope="module")
def aligned_data(reference_binary, tmp_path_factory):
    d = tmp_path_factory.mktemp("aux")
    simulate(d, genome_out="ref.fa", reads_out="reads.fq", n_reads=600,
             read_len=50, chr_len=30000, seed=13, error_rate=0.01)
    run_ref(reference_binary, d,
            ["-a", "reads.fq", "-d", "ref.fa", "-o", "out.sam",
             "-S", "1", "-v", "2"])
    run_ref(reference_binary, d,
            ["-a", "reads.fq", "-d", "ref.fa", "-o", "out.bsp",
             "-S", "1", "-v", "2"])
    return d


def _run_module(mod, args, cwd):
    env = {"PYTHONPATH": str(REPO), "BSMAP_JAX_CPU_JIT_CACHE": "1", "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu", "HOME": "/root"}
    r = subprocess.run([sys.executable, "-m", mod] + args, cwd=cwd,
                       capture_output=True, env=env)
    assert r.returncode == 0, r.stderr.decode()


def _ref_methratio(d, args):
    """Run the /tmp py3-converted reference methratio with a samtools -X
    shim on PATH (built on demand)."""
    import os
    import textwrap
    shim_dir = d / "bin"
    shim_dir.mkdir(exist_ok=True)
    shim = shim_dir / "samtools"
    shim.write_text(textwrap.dedent("""\
        #!/usr/bin/env python3
        import sys
        path = sys.argv[-1]
        def letters(flag):
            s = ""
            for bit, ch in ((1,"p"),(2,"P"),(4,"u"),(8,"U"),(16,"r"),
                            (32,"R"),(64,"1"),(128,"2"),(256,"s"),
                            (512,"f"),(1024,"d")):
                if flag & bit: s += ch
            return s
        for line in open(path):
            if line.startswith("@"): continue
            col = line.rstrip("\\n").split("\\t")
            col[1] = letters(int(col[1]))
            print("\\t".join(col))
        """))
    shim.chmod(0o755)
    from .conftest import ensure_methratio3
    ref_script = ensure_methratio3()
    if ref_script is None:
        pytest.skip("reference methratio.py not available")
    env = dict(os.environ)
    env["PATH"] = f"{shim_dir}:/usr/bin:/bin"
    r = subprocess.run([sys.executable, ref_script] + args, cwd=d,
                       capture_output=True, env=env)
    assert r.returncode == 0, r.stderr.decode()


@pytest.mark.parametrize("src,extra", [
    ("out.sam", []),
    ("out.bsp", []),
    ("out.sam", ["-u", "-r", "-t", "3", "-g", "-m", "2", "-z"]),
])
def test_methratio_parity(aligned_data, src, extra):
    d = aligned_data
    _ref_methratio(d, ["-d", "ref.fa", "-o", "ref_m.txt", "-q"]
                   + extra + [src])
    _run_module("bsmap_jax.methratio",
                ["-d", "ref.fa", "-o", "our_m.txt", "-q"] + extra + [src],
                d)
    assert_same(d, "ref_m.txt", "our_m.txt")


def test_bam_roundtrip(aligned_data):
    d = aligned_data
    import shutil
    shutil.copy(d / "out.sam", d / "rt.bam")
    sys.path.insert(0, str(REPO))
    from bsmap_jax.bamio import sam_to_bam, bam_sam_lines
    sam_to_bam(str(d / "rt.bam"))
    body = sorted(l for l in open(d / "out.sam") if not l.startswith("@"))
    back = sorted(bam_sam_lines(str(d / "rt.bam")))
    assert len(body) == len(back)
    assert body == back
    assert (d / "rt.bam.bai").exists()


def test_bam_as_input_parity(reference_binary, aligned_data):
    """Our BAM fed to the reference's libbam reader and to our own reader
    must produce identical alignments (BGZF/BAM interop)."""
    d = aligned_data
    import shutil
    shutil.copy(d / "out.sam", d / "in.bam")
    sys.path.insert(0, str(REPO))
    from bsmap_jax.bamio import sam_to_bam
    sam_to_bam(str(d / "in.bam"))
    base = ["-a", "in.bam", "-d", "ref.fa", "-S", "1", "-v", "2"]
    run_ref(reference_binary, d, base + ["-o", "refb.sam"])
    run_ours(d, base + ["-o", "ourb.sam"])
    assert_same(d, "refb.sam", "ourb.sam")


def test_bsp2sam(aligned_data):
    d = aligned_data
    _run_module("bsmap_jax.bsp2sam",
                ["-d", "ref.fa", "-o", "b2s.sam", "-q", "out.bsp"], d)
    lines = [l for l in open(d / "b2s.sam")]
    assert lines[0].startswith("@HD")
    assert any(l.startswith("@SQ\tSN:chr1") for l in lines)
    body = [l for l in lines if not l.startswith("@")]
    assert len(body) > 100
    cols = body[0].split("\t")
    assert cols[5].endswith("M")
