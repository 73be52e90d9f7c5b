"""Measure the reference BSMAP binary on the EXACT bench configs/data.

The r4 verdict flagged the chr21 `vs_baseline` as apples-to-oranges (every
config was divided by the SE-headline CPU number).  This tool runs
`/tmp/bsmap_ref/bsmap` single-thread on the same generated data and flags as
each bench config, isolates the alignment phase by wall-clocking a
setup-only run (-E 100) and subtracting it from the full run, and writes
BASELINE_MEASURED.json next to bench.py.  bench.py divides each config by
its matching measured number when the file exists.

Usage: python tools/ref_baseline.py [ref_binary]
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

BENCH_DIR = os.environ.get(
    "BSMAP_JAX_BENCH_DIR",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 ".bench_data"))
OUT = os.path.join(REPO, "BASELINE_MEASURED.json")


def run_ref(binary: str, args: list[str], n_units: int, workdir: str):
    """Run the reference single-thread; returns (units/s align-phase,
    align_secs, total_secs).  The binary's own progress timestamps are
    integer seconds, so the align phase is wall-clocked externally:
    a setup-only run (-E 100: genome load + index build + 100 reads)
    subtracted from the full run.  The binary aborts in its summary print
    (locale bad_cast) AFTER output is complete — ignored."""
    t0 = time.time()
    subprocess.run([binary] + args + ["-p", "1", "-E", "100"], cwd=workdir,
                   capture_output=True, text=True)
    setup = time.time() - t0
    t0 = time.time()
    subprocess.run([binary] + args + ["-p", "1"], cwd=workdir,
                   capture_output=True, text=True)
    total = time.time() - t0
    align = max(total - setup, 0.05)
    return n_units / align, align, total


def main() -> None:
    binary = sys.argv[1] if len(sys.argv) > 1 else "/tmp/bsmap_ref/bsmap"
    if not os.path.exists(binary):
        sys.exit(f"reference binary not found: {binary} "
                 "(build per .claude/skills/verify)")
    from tools.genreads import (generate, generate_chr21, generate_pe,
                                generate_rrbs)

    res: dict = {"binary": binary, "host": os.uname().nodename,
                 "note": "reference BSMAP v2.6, -O3, single thread (-p 1), "
                         "align phase = full-run wall minus -E 100 "
                         "setup-run wall; same data and flags as bench.py"}

    n = int(os.environ.get("BSMAP_JAX_BENCH_READS", 1_000_000))
    g, r = generate(BENCH_DIR, n_reads=n)
    ups, al, tot = run_ref(binary, ["-a", os.path.basename(r),
                                    "-d", os.path.basename(g),
                                    "-o", "ref_head.sam", "-S", "17", "-u"],
                           n, BENCH_DIR)
    res["se_wgbs_100nt_v2"] = {"reads_per_sec": round(ups, 1),
                               "align_s": round(al, 2),
                               "total_s": round(tot, 2), "n": n}
    print("headline:", res["se_wgbs_100nt_v2"], flush=True)

    n21 = min(n, 500_000)
    g21, r21 = generate_chr21(BENCH_DIR, n_reads=n21)
    ups, al, tot = run_ref(binary, ["-a", os.path.basename(r21),
                                    "-d", os.path.basename(g21),
                                    "-o", "ref_chr21.sam", "-S", "17", "-u"],
                           n21, BENCH_DIR)
    res["chr21_class"] = {"reads_per_sec": round(ups, 1),
                          "align_s": round(al, 2),
                          "total_s": round(tot, 2), "n": n21}
    print("chr21:", res["chr21_class"], flush=True)

    gp, r1, r2 = generate_pe(BENCH_DIR)
    npairs = sum(1 for _ in open(r1)) // 4
    ups, al, tot = run_ref(binary, ["-a", os.path.basename(r1),
                                    "-b", os.path.basename(r2),
                                    "-d", os.path.basename(gp),
                                    "-o", "ref_pe.sam", "-S", "17", "-u"],
                           npairs, BENCH_DIR)
    res["pe_76nt"] = {"pairs_per_sec": round(ups, 1),
                      "align_s": round(al, 2), "total_s": round(tot, 2),
                      "n": npairs}
    print("pe:", res["pe_76nt"], flush=True)

    gr, rr = generate_rrbs(BENCH_DIR)
    nr = sum(1 for _ in open(rr)) // 4
    ups, al, tot = run_ref(binary, ["-a", os.path.basename(rr),
                                    "-d", os.path.basename(gr),
                                    "-o", "ref_rrbs.sam", "-S", "17", "-u",
                                    "-D", "C-CGG", "-A", "AGATCGGAAGAGC",
                                    "-q", "2"],
                           nr, BENCH_DIR)
    res["rrbs_mspi_trim"] = {"reads_per_sec": round(ups, 1),
                             "align_s": round(al, 2),
                             "total_s": round(tot, 2), "n": nr}
    print("rrbs:", res["rrbs_mspi_trim"], flush=True)

    with open(OUT, "w") as f:
        json.dump(res, f, indent=1)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
