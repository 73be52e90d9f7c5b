"""BASELINE config 5 end-to-end at available scale (r4 verdict item 5).

Chain: 3.12 Gb synthetic hg38-class FASTA -> packed-genome + index caches
-> 2M streamed 100nt PE pairs through the DEVICE engine (one card, native
PE block pipeline) -> bsmap_jax.methratio (chromosome-batched) to the final
ratio table.  Also runs a small slice through the index-sharded engine on
every visible device.

Prints one JSON line with per-stage wall / RSS numbers for PERF.md.

Usage: python tools/config5_e2e.py [n_pairs] [--skip-mesh]
"""

from __future__ import annotations

import json
import os
import resource
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = os.environ.get("BSMAP_JAX_BENCH_DIR",
                           os.path.join(REPO, ".bench_data"))


def gen_pe_reads(gpath: str, r1: str, r2: str, n_pairs: int) -> None:
    """Vectorized PE read generation straight from the FASTA."""
    import numpy as np
    from tools.genreads import make_pe_reads, write_fastq

    if os.path.exists(r1 + ".ok"):
        return
    chrs = []
    name = None
    parts: list[bytes] = []
    t0 = time.time()
    with open(gpath, "rb") as f:
        for line in f:
            if line.startswith(b">"):
                if name is not None:
                    chrs.append(np.frombuffer(b"".join(parts), np.uint8))
                name = line
                parts = []
            else:
                parts.append(line.strip())
    if name is not None:
        chrs.append(np.frombuffer(b"".join(parts), np.uint8))
    print(f"# fasta -> arrays {time.time()-t0:.0f}s", flush=True)
    t0 = time.time()
    a, b = make_pe_reads(38, chrs, n_pairs, 100)
    write_fastq(r1, a)
    write_fastq(r2, b)
    open(r1 + ".ok", "w").close()
    print(f"# reads generated {time.time()-t0:.0f}s", flush=True)


def peak_rss_of(cmd, env=None, timeout=7200):
    """Run a child and return (rc, wall_s, child_peak_rss_gb)."""
    t0 = time.time()
    pre = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss
    r = subprocess.run(cmd, env=env, timeout=timeout)
    wall = time.time() - t0
    post = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss
    return r.returncode, wall, max(post, pre) / 1e6


def main() -> None:
    n_pairs = int(sys.argv[1]) if len(sys.argv) > 1 else 2_000_000
    skip_mesh = "--skip-mesh" in sys.argv
    gpath = os.path.join(BENCH_DIR, "genome_hg38s.fa")
    if not os.path.exists(gpath):
        from tools.hg38_scale import gen_genome
        gen_genome(gpath)
    r1 = os.path.join(BENCH_DIR, "hg38s_1.fq")
    r2 = os.path.join(BENCH_DIR, "hg38s_2.fq")
    gen_pe_reads(gpath, r1, r2, n_pairs)

    cache = os.path.join(BENCH_DIR, "index")
    out = {"n_pairs": n_pairs, "genome": gpath}
    sam = os.path.join(BENCH_DIR, "hg38s_pe.sam")

    # stage 1: PE alignment, device engine, native block pipeline
    env = dict(os.environ)
    rc, wall, rss = peak_rss_of(
        [sys.executable, "-m", "bsmap_jax.cli", "-a", r1, "-b", r2,
         "-d", gpath, "-o", sam, "-S", "17", "-v", "2", "-u",
         "--index-cache", cache, "--engine", "device"], env=env)
    assert rc == 0, "PE alignment failed"
    out["align"] = {"wall_s": round(wall, 1), "peak_rss_gb": round(rss, 1),
                    "pairs_per_sec_wall": round(n_pairs / wall, 1),
                    "sam_bytes": os.path.getsize(sam)}
    print(f"# align: {out['align']}", flush=True)

    # stage 2: methratio, chromosome-batched (RSS-bounded)
    meth = os.path.join(BENCH_DIR, "hg38s.meth")
    rc, wall, rss = peak_rss_of(
        [sys.executable, "-m", "bsmap_jax.methratio", "-d", gpath,
         "-o", meth, "-u", "-p", sam, "-q"], env=env)
    assert rc == 0, "methratio failed"
    nlines = sum(1 for _ in open(meth))
    out["methratio"] = {"wall_s": round(wall, 1),
                        "peak_rss_gb": round(rss, 1),
                        "ratio_lines": nlines}
    print(f"# methratio: {out['methratio']}", flush=True)

    # stage 3: index-sharded mesh slice over every visible device
    if not skip_mesh:
        env2 = dict(os.environ)
        sam2 = os.path.join(BENCH_DIR, "hg38s_slice.sam")
        rc, wall, rss = peak_rss_of(
            [sys.executable, "-m", "bsmap_jax.cli", "-a", r1, "-b", r2,
             "-d", gpath, "-o", sam2, "-S", "17", "-v", "2", "-u",
             "-E", "5000", "--index-cache", cache,
             "--engine", "index-sharded"], env=env2)
        assert rc == 0, "index-sharded mesh slice failed"
        out["mesh_slice"] = {"wall_s": round(wall, 1),
                             "peak_rss_gb": round(rss, 1), "pairs": 5000}
        print(f"# mesh slice: {out['mesh_slice']}", flush=True)

    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
