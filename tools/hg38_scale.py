"""Human-genome-scale index proof (VERDICT r3 item 7).

Generates a synthetic hg38-sized genome (13 x 240 Mb = 3.12 Gb), builds the
WGBS seed index with the native two-pass count/fill builder, persists it to
the mmap-able cache, splits it into 8 region shards (the multi-chip memory
plan, parallel/index_sharded.py), and host-aligns a sample of reads drawn
from the genome as an end-to-end correctness smoke test at scale.

Prints one JSON line with build time, RSS, index bytes, per-shard bytes.
"""

from __future__ import annotations

import json
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BENCH_DIR = os.environ.get(
    "BSMAP_JAX_BENCH_DIR",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 ".bench_data"))
N_CHR = int(os.environ.get("HG38_N_CHR", 13))
CHR_LEN = int(os.environ.get("HG38_CHR_LEN", 239_999_970))


def rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def gen_genome(path: str) -> None:
    import numpy as np
    rng = np.random.RandomState(38)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    assert CHR_LEN % 70 == 0
    with open(path, "wb") as f:
        for c in range(N_CHR):
            f.write(b">chr%d\n" % (c + 1))
            for off in range(0, CHR_LEN, 70_000_000):
                n = min(70_000_000, CHR_LEN - off)
                chunk = bases[rng.randint(0, 4, size=n).astype(np.uint8)]
                arr = chunk.reshape(-1, 70)
                lines = np.empty((arr.shape[0], 71), np.uint8)
                lines[:, :70] = arr
                lines[:, 70] = 10
                f.write(lines.tobytes())


def main() -> None:
    import numpy as np
    from bsmap_jax.params import Param
    from bsmap_jax.reference import load_genome
    from bsmap_jax.index import build_index, save_index, load_index
    from bsmap_jax.parallel.index_sharded import build_region_shards

    os.makedirs(BENCH_DIR, exist_ok=True)
    gpath = os.path.join(BENCH_DIR, "genome_hg38s.fa")
    stamp = gpath + f".{N_CHR}x{CHR_LEN}.ok"
    if not os.path.exists(stamp):
        t0 = time.time()
        gen_genome(gpath)
        print(f"# genome generated in {time.time()-t0:.0f}s", flush=True)
        open(stamp, "w").close()

    p = Param()
    p.out_sam = 1
    out = {"genome_bp": N_CHR * CHR_LEN}
    t0 = time.time()
    genome = load_genome(gpath, p)
    out["load_genome_s"] = round(time.time() - t0, 1)
    print(f"# loaded {out['genome_bp']/1e9:.2f} Gb in "
          f"{out['load_genome_s']}s rss={rss_gb():.1f} GB", flush=True)

    t0 = time.time()
    index = build_index(genome, p)
    out["index_build_s"] = round(time.time() - t0, 1)
    out["index_entries"] = int(len(index.locs))
    out["index_bytes"] = int(index.locs.nbytes + index.offsets.nbytes
                             + index.wcounts.nbytes)
    out["build_rss_gb"] = round(rss_gb(), 1)
    print(f"# index: {out['index_entries']/1e9:.2f}G entries, "
          f"{out['index_bytes']/1e9:.1f} GB, built in "
          f"{out['index_build_s']}s, rss={out['build_rss_gb']} GB",
          flush=True)

    cache = os.path.join(BENCH_DIR, "index")
    os.makedirs(cache, exist_ok=True)
    cpath = os.path.join(cache, f"hg38s_{N_CHR}x{CHR_LEN}.npz")
    if not os.path.exists(cpath):
        t0 = time.time()
        save_index(cpath, index)
        out["index_save_s"] = round(time.time() - t0, 1)
    t0 = time.time()
    mm = load_index(cpath, mmap=True)
    out["index_mmap_load_s"] = round(time.time() - t0, 2)
    assert int(mm.offsets[-1]) == len(index.locs)

    # region shards: the per-device memory plan of the index-sharded engine
    t0 = time.time()
    bounds, tabs, wl_s, cl_s = build_region_shards(genome, index, 8)
    out["shard_split_s"] = round(time.time() - t0, 1)
    out["per_shard_locs_mb"] = round((wl_s.nbytes + cl_s.nbytes) / 8 / 1e6, 1)
    out["replicated_tab_mb"] = round(tabs[0].nbytes / 1e6, 1)
    out["catcat_mb"] = round((genome.refcat.nbytes
                              + genome.crefcat.nbytes) / 1e6, 1)
    del tabs, wl_s, cl_s

    # end-to-end correctness smoke test at scale: host-align genome reads
    from bsmap_jax.engine.host_engine import HostEngine
    from bsmap_jax.readio import Read
    from bsmap_jax.encoding import unpack_u32
    rng = np.random.RandomState(1)
    eng = HostEngine(genome, index, p)
    nt = "ACGT"
    n_ok = 0
    n_reads = 200
    t0 = time.time()
    for i in range(n_reads):
        c = rng.randint(0, genome.n_chr)
        pos = rng.randint(0, int(genome.sizes[c]) - 100)
        g0 = int(genome.anchors[c])
        codes = unpack_u32(genome.refcat[(g0 + pos) // 16:
                                         (g0 + pos) // 16 + 8])
        sl = (g0 + pos) % 16
        seq = "".join(nt[x] for x in codes[sl: sl + 100])
        seq = seq.replace("C", "T")          # fully converted
        res = eng.run_align(Read(index=i, readset=0, name=f"r{i}",
                                 seq=seq, qual="I" * 100), 2)
        found = any(len(h) for h in res.hits) or any(
            len(h) for h in res.chits)
        n_ok += bool(found)
    out["host_align_found"] = f"{n_ok}/{n_reads}"
    out["host_align_s"] = round(time.time() - t0, 1)
    out["peak_rss_gb"] = round(rss_gb(), 1)
    print(json.dumps(out), flush=True)
    assert n_ok >= int(0.95 * n_reads), "alignment sanity failed at scale"


if __name__ == "__main__":
    main()
