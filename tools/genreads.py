"""Fast vectorized bench-data generator (numpy; ~1M reads/s).

Unlike tools/simulate.py (the golden-test simulator, which models methylation
levels, errors and adapters read-by-read), this produces fully-converted
bisulfite reads in bulk for throughput benchmarking: every read is a genome
window with C->T on the sampled strand.
"""

from __future__ import annotations

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
COMP = np.zeros(256, dtype=np.uint8)
for a, b in zip(b"ACGT", b"TGCA"):
    COMP[a] = b


def make_genome(seed: int, n_chr: int, chr_len: int,
                repeat_frac: float = 0.0, repeat_unit: int = 300,
                repeat_mut: float = 0.02):
    """Random genome; with repeat_frac > 0, that fraction of each
    chromosome is pasted-in copies of a small repeat library (2% mutated),
    producing the power-law seed-bucket sizes of real genomes (the hard
    case for candidate capacity, SURVEY.md section 7)."""
    rng = np.random.RandomState(seed)
    lib = [BASES[rng.randint(0, 4, size=repeat_unit)] for _ in range(16)]
    out = []
    for _ in range(n_chr):
        c = BASES[rng.randint(0, 4, size=chr_len)]
        if repeat_frac > 0:
            n_copies = int(chr_len * repeat_frac / repeat_unit)
            pos = rng.randint(0, chr_len - repeat_unit, size=n_copies)
            which = rng.randint(0, len(lib), size=n_copies)
            for p, w in zip(pos, which):
                unit = lib[w].copy()
                nmut = rng.binomial(repeat_unit, repeat_mut)
                if nmut:
                    mi = rng.randint(0, repeat_unit, size=nmut)
                    unit[mi] = BASES[rng.randint(0, 4, size=nmut)]
                c[p: p + repeat_unit] = unit
        out.append(c)
    return out


def write_genome(path: str, chrs) -> None:
    with open(path, "wb") as f:
        for i, c in enumerate(chrs):
            f.write(b">chr%d\n" % (i + 1))
            for j in range(0, len(c), 70):
                f.write(c[j: j + 70].tobytes() + b"\n")


def make_reads(seed: int, chrs, n_reads: int, read_len: int) -> np.ndarray:
    """(n_reads, read_len) uint8 array of fully-converted reads."""
    rng = np.random.RandomState(seed + 1)
    ci = rng.randint(0, len(chrs), size=n_reads)
    out = np.empty((n_reads, read_len), dtype=np.uint8)
    offs = np.arange(read_len)
    for c, chrseq in enumerate(chrs):
        sel = np.where(ci == c)[0]
        pos = rng.randint(0, len(chrseq) - read_len, size=len(sel))
        win = chrseq[pos[:, None] + offs[None, :]]
        out[sel] = win
    # half the reads from the Crick strand (reverse complement)
    flip = rng.random_sample(n_reads) < 0.5
    out[flip] = COMP[out[flip]][:, ::-1]
    # bisulfite: full conversion C->T
    out[out == ord("C")] = ord("T")
    return out


def write_fastq(path: str, reads: np.ndarray) -> None:
    n, L = reads.shape
    qual = b"I" * L
    with open(path, "wb") as f:
        buf = []
        for i in range(n):
            buf.append(b"@r%d\n%s\n+\n%s\n" % (i, reads[i].tobytes(), qual))
            if len(buf) >= 10000:
                f.write(b"".join(buf))
                buf.clear()
        f.write(b"".join(buf))


def generate(out_dir: str, seed: int = 7, n_chr: int = 2,
             chr_len: int = 5_000_000, n_reads: int = 200_000,
             read_len: int = 100, repeat_frac: float = 0.0,
             tag: str = ""):
    import os
    os.makedirs(out_dir, exist_ok=True)
    gpath = os.path.join(out_dir, f"genome{tag}.fa")
    rpath = os.path.join(out_dir, f"reads{tag}.fq")
    stamp = os.path.join(
        out_dir, f"gen{tag}_{seed}_{n_chr}_{chr_len}_{n_reads}_{read_len}"
        f"_{repeat_frac}.ok")
    if os.path.exists(stamp):
        return gpath, rpath
    # genome{tag}.fa/reads{tag}.fq are shared filenames: drop stale stamps
    # of THIS tag's other param sets (a stamp's tag is followed by the
    # numeric seed, so other tags' stamps never match) so a later call with
    # those params regenerates instead of trusting an overwritten file
    import glob
    for old in glob.glob(os.path.join(out_dir, f"gen{tag}_[0-9]*.ok")):
        os.remove(old)
    chrs = make_genome(seed, n_chr, chr_len, repeat_frac=repeat_frac)
    write_genome(gpath, chrs)
    write_fastq(rpath, make_reads(seed, chrs, n_reads, read_len))
    open(stamp, "w").close()
    return gpath, rpath


def make_pe_reads(seed: int, chrs, n_pairs: int, read_len: int,
                  ins_min: int = 100, ins_max: int = 400):
    """(r1, r2) fully-converted bisulfite read-pair arrays: r1 = fragment
    start with C->T, r2 = fragment end reverse-complemented (G->A after
    revcomp), half the fragments on the Crick strand."""
    rng = np.random.RandomState(seed + 2)
    ci = rng.randint(0, len(chrs), size=n_pairs)
    ins = rng.randint(ins_min, ins_max + 1, size=n_pairs)
    r1 = np.empty((n_pairs, read_len), dtype=np.uint8)
    r2 = np.empty((n_pairs, read_len), dtype=np.uint8)
    offs = np.arange(read_len)
    for c, chrseq in enumerate(chrs):
        sel = np.where(ci == c)[0]
        pos = rng.randint(0, len(chrseq) - ins_max - 1, size=len(sel))
        insc = ins[sel]
        w1 = chrseq[pos[:, None] + offs[None, :]]
        w2 = COMP[chrseq[(pos + insc)[:, None] - 1 - offs[None, :]]]
        flip = rng.random_sample(len(sel)) < 0.5
        a = np.where(flip[:, None], w2, w1)     # sequenced mate 1
        b = np.where(flip[:, None], w1, w2)     # sequenced mate 2
        r1[sel] = np.where(a == ord("C"), ord("T"), a)
        r2[sel] = np.where(b == ord("G"), ord("A"), b)
    return r1, r2


def make_rrbs_reads(seed: int, chrs, n_reads: int, read_len: int,
                    min_frag: int = 40, max_frag: int = 220) -> np.ndarray:
    """Fully-converted reads starting at MspI (C^CGG) digestion-fragment
    starts whose fragment length is within [min_frag, max_frag]."""
    rng = np.random.RandomState(seed + 3)
    pools = []
    for c, a in enumerate(chrs):
        m = ((a[:-3] == ord("C")) & (a[1:-2] == ord("C"))
             & (a[2:-1] == ord("G")) & (a[3:] == ord("G")))
        sites = np.nonzero(m)[0]
        if len(sites) < 2:
            continue
        gaps = np.diff(sites)
        ok = (gaps >= min_frag) & (gaps <= max_frag)
        starts = sites[:-1][ok] + 1
        starts = starts[starts + read_len <= len(a)]
        if len(starts):
            pools.append((c, starts))
    assert pools, "no digestion fragments in genome"
    out = np.empty((n_reads, read_len), dtype=np.uint8)
    offs = np.arange(read_len)
    pick = rng.randint(0, len(pools), size=n_reads)
    for k, (c, starts) in enumerate(pools):
        sel = np.where(pick == k)[0]
        pos = starts[rng.randint(0, len(starts), size=len(sel))]
        win = chrs[c][pos[:, None] + offs[None, :]]
        out[sel] = win
    out[out == ord("C")] = ord("T")
    return out


def generate_pe(out_dir: str, seed: int = 11, chr_len: int = 4_600_000,
                n_pairs: int = 200_000, read_len: int = 76):
    """BASELINE config 2 class: E. coli-sized genome, 76nt pairs."""
    import os
    os.makedirs(out_dir, exist_ok=True)
    gpath = os.path.join(out_dir, "genome_pe.fa")
    r1path = os.path.join(out_dir, "reads_pe_1.fq")
    r2path = os.path.join(out_dir, "reads_pe_2.fq")
    stamp = os.path.join(out_dir,
                         f"genpe_{seed}_{chr_len}_{n_pairs}_{read_len}.ok")
    if os.path.exists(stamp):
        return gpath, r1path, r2path
    chrs = make_genome(seed, 1, chr_len)
    write_genome(gpath, chrs)
    r1, r2 = make_pe_reads(seed, chrs, n_pairs, read_len)
    write_fastq(r1path, r1)
    write_fastq(r2path, r2)
    open(stamp, "w").close()
    return gpath, r1path, r2path


def generate_rrbs(out_dir: str, seed: int = 13, chr_len: int = 10_000_000,
                  n_reads: int = 200_000, read_len: int = 76):
    """BASELINE config 3 class: MspI digestion-constrained reads."""
    import os
    os.makedirs(out_dir, exist_ok=True)
    gpath = os.path.join(out_dir, "genome_rrbs.fa")
    rpath = os.path.join(out_dir, "reads_rrbs.fq")
    stamp = os.path.join(out_dir,
                         f"genrr_{seed}_{chr_len}_{n_reads}_{read_len}.ok")
    if os.path.exists(stamp):
        return gpath, rpath
    chrs = make_genome(seed, 1, chr_len)
    write_genome(gpath, chrs)
    write_fastq(rpath, make_rrbs_reads(seed, chrs, n_reads, read_len))
    open(stamp, "w").close()
    return gpath, rpath


def generate_chr21(out_dir: str, n_reads: int = 1_000_000):
    """BASELINE config 4 class: one 46.7 Mb chromosome with 8% repeat
    content (power-law seed buckets), 100nt fully-converted reads."""
    return generate(out_dir, seed=21, n_chr=1, chr_len=46_700_000,
                    n_reads=n_reads, read_len=100, repeat_frac=0.08,
                    tag="_chr21")


if __name__ == "__main__":
    import sys
    generate(sys.argv[1] if len(sys.argv) > 1 else "bench_data")
