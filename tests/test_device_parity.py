"""Device engines vs the exact host engine, byte for byte, on the CPU.

The host engine is the oracle (golden-tested against the reference binary
where that binary can be built); these cases need no reference, so they run
everywhere.  The device path runs under JAX on the CPU here; chip_smoke.py
runs the same comparison on the GPU at full size.  SE and PE reads come
from tools/simulate.py (errors, methylation, quality); RRBS reads from
tools/genreads.py, whose reads start at MspI digestion sites.
"""

import sys

import pytest

from .conftest import REPO, simulate
from .test_golden_se import assert_same, run_ours

ADAPT = "AGATCGGAAGAGC"

# case -> (CLI arguments, output suffix, engine compared with --engine host)
CASES = {
    "se_sam": (["-a", "se.fq", "-d", "g.fa", "-S", "1", "-v", "2", "-u"],
               ".sam", "device"),
    "se_bsp": (["-a", "se.fq", "-d", "g.fa", "-S", "1", "-v", "2", "-u"],
               ".bsp", "device"),
    "rrbs_trim": (["-a", "rr.fq", "-d", "rr.fa", "-D", "C-CGG", "-A", ADAPT,
                   "-q", "2", "-S", "1", "-u", "-p", "1"], ".sam", "device"),
    "pe_sam": (["-a", "p1.fq", "-b", "p2.fq", "-d", "gp.fa", "-S", "1",
                "-v", "2", "-u"], ".sam", "device"),
    # repeat-rich genome: multi-hit reads, whose selection the
    # fixed-schedule round must not commit on engines without lean rows
    "repeats_index_sharded": (["-a", "rep.fq", "-d", "rep.fa", "-S", "1",
                               "-u"], ".sam", "index-sharded"),
}


@pytest.fixture(scope="module")
def parity_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("parity")
    simulate(d, genome_out="g.fa", reads_out="se.fq", n_reads=2000,
             read_len=90, chr_len=60000, n_chr=2, seed=61, error_rate=0.02)
    simulate(d, genome_out="gp.fa", reads_out="p1.fq", reads2_out="p2.fq",
             pe=True, n_reads=1000, read_len=76, chr_len=60000, seed=62,
             error_rate=0.01)
    sys.path.insert(0, str(REPO))
    from tools import genreads
    chrs = genreads.make_genome(63, 1, 300_000)
    genreads.write_genome(str(d / "rr.fa"), chrs)
    genreads.write_fastq(str(d / "rr.fq"),
                         genreads.make_rrbs_reads(63, chrs, 2000, 76))
    chrs = genreads.make_genome(21, 1, 300_000, repeat_frac=0.08)
    genreads.write_genome(str(d / "rep.fa"), chrs)
    genreads.write_fastq(str(d / "rep.fq"),
                         genreads.make_reads(21, chrs, 3000, 100))
    return d


@pytest.mark.parametrize("case", sorted(CASES))
def test_device_matches_host(parity_data, case):
    args, suffix, engine = CASES[case]
    outs = []
    for eng in ("host", engine):
        out = f"{case}_{eng}{suffix}"
        run_ours(parity_data, args + ["-o", out], engine=eng)
        outs.append(out)
    assert (parity_data / outs[0]).stat().st_size > 0
    assert_same(parity_data, *outs)
