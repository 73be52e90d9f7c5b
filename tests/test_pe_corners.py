"""PE corner regressions on repeat-heavy data (r5):

* multi-hit UNPAIRED fallback draws index lists SORTED by (chr, loc)
  (SortHits4PE, pairs.cpp:163-168) — the r4 device engine served the
  kernel's discovery-order pick (diverged 50/50 on cross-segment repeats);
* -r 0 multi-PAIR fall-through uses hit lists frozen at step i*
  (RunAlign breaks, pairs.cpp:171) — rank-0 commits reproduce them, i*>0
  pairs replay on the host engine.
"""

import random

import pytest

from .test_golden_se import assert_same, run_ours, run_ref

COMP = str.maketrans("ACGT", "TGCA")


@pytest.fixture(scope="module")
def repeat_pe_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("pe_rep")
    rng = random.Random(5)
    filler = lambda n: "".join(rng.choice("ACGT") for _ in range(n))
    # one segment duplicated at three scattered loci => multi-hit pairs
    # and multi-hit unpaired mates; A/G-only core avoids C/T ambiguity so
    # planted mismatches survive bisulfite conversion
    core = "".join(rng.choice("AG") for _ in range(240))
    flip = lambda c: "G" if c == "A" else "A"
    # copies with mismatches planted in DIFFERENT seed segments (out-of-
    # position-order discovery, the r4 sorted-order bug trigger)
    c1 = core[:10] + flip(core[10]) + core[11:]
    c2 = core[:26] + flip(core[26]) + core[27:]
    g = (filler(3000) + core + filler(5000) + c1 + filler(4000) + c2
         + filler(3000) + core + filler(2000))
    with open(d / "g.fa", "w") as f:
        f.write(">chr1\n")
        for i in range(0, len(g), 60):
            f.write(g[i:i + 60] + "\n")
    with open(d / "p1.fq", "w") as f1, open(d / "p2.fq", "w") as f2:
        for k in range(300):
            ins = rng.randint(120, 220)
            pos = rng.randint(0, len(core) - ins) if ins < len(core) else 0
            frag = core[pos: pos + ins]
            r1 = frag[:76].replace("C", "T")
            r2 = frag[::-1].translate(COMP)[:76].replace("G", "A")
            if k % 3 == 0:
                r2 = filler(76)          # unmappable mate: unpaired path
            f1.write(f"@q{k}/1\n{r1}\n+\n{'I' * len(r1)}\n")
            f2.write(f"@q{k}/2\n{r2}\n+\n{'I' * len(r2)}\n")
    return d


@pytest.mark.parametrize("cfg", [
    ["-S", "17", "-v", "2", "-u"],
    ["-S", "17", "-v", "2", "-u", "-r", "0"],
])
def test_pe_repeat_corners(reference_binary, repeat_pe_data, cfg):
    base = ["-a", "p1.fq", "-b", "p2.fq", "-d", "g.fa"]
    tag = "".join(c.lstrip("-") for c in cfg)
    run_ref(reference_binary, repeat_pe_data,
            base + ["-o", f"ref_{tag}.sam"] + cfg)
    run_ours(repeat_pe_data, base + ["-o", f"our_{tag}.sam"] + cfg,
             engine="device")
    assert_same(repeat_pe_data, f"ref_{tag}.sam", f"our_{tag}.sam")


def test_pe_repeat_s0_device_vs_host(repeat_pe_data):
    """-S 0 (sequential rand_r): device vs host with a pinned rand_r seed
    (the reference seeds from pid*time, so cross-binary comparison is
    impossible; the host engine is its golden-tested oracle)."""
    base = ["-a", "p1.fq", "-b", "p2.fq", "-d", "g.fa",
            "-S", "0", "-v", "2", "-u"]
    pin = {"BSMAP_JAX_RANDR_SEED": "1"}
    run_ours(repeat_pe_data, base + ["-o", "s0_host.sam"], engine="host",
             extra_env=pin)
    run_ours(repeat_pe_data, base + ["-o", "s0_dev.sam"], engine="device",
             extra_env=pin)
    assert_same(repeat_pe_data, "s0_host.sam", "s0_dev.sam")
