"""Run the aligner's device path once on an NVIDIA GPU and check it.

    python chip_smoke.py              # one card: phases (d), (a), (b), (c)
    python chip_smoke.py --chips 4    # four cards: the mesh engines only

Every alignment goes through ``bsmap_jax.cli.run`` with its normal options,
in this one process (the ``-p 2`` run spawns the CLI's own two workers,
each pinned to a card with its share of the memory; this process allocates
device memory on demand so that they fit beside it).  Data comes from
``tools/genreads.py`` with fixed seeds, in ``.smoke_data/`` (git-ignored);
the compile cache is wherever ``bsmap_jax`` puts it
(``JAX_COMPILATION_CACHE_DIR`` when set).

One card, phases at the sizes of the bench configurations:
  (a) SE WGBS, 1M x 100 nt on a 10 Mb genome;
  (b) SE on a chr21-class genome (46.7 Mb, 8% repeats), 500k x 100 nt —
      drives the probe, packing and replay paths;
  (c) PE, 200k x 76 nt pairs on 4.6 Mb;
  (d) RRBS -D C-CGG with adapter and -q 2 trimming, 200k x 76 nt on 10 Mb,
      with -p 1 and again with -p 2.
Each phase prints one JSON line: the engine and where its arrays live, the
native block path, cold and persistent-cache compile seconds, reads/s of
the full run beside the card's name and power limit, peak device memory,
and parity: the host engine's SAM on the first 20,000 reads (-E) must be
byte-identical to the device run's records for them (the device path is
integer-only, so the tolerance is zero).

``--chips 4`` runs (b) through --engine auto, sharded and index-sharded and
(c) through sharded and index-sharded, each against --engine device on
card 0, byte for byte, and checks that the mesh engines' arrays span four
devices.

Any failure raises (exit status != 0).  Without a GPU the script exits
non-zero before printing any result.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(REPO, ".smoke_data")
PARITY_READS = 20_000
RRBS_ARGS = ["-D", "C-CGG", "-A", "AGATCGGAAGAGC", "-q", "2"]


def require_gpu(devices) -> None:
    """Raise unless JAX computes on a GPU (no CPU stand-in)."""
    if not devices or devices[0].platform != "gpu":
        plat = devices[0].platform if devices else "none"
        raise RuntimeError(f"no GPU: JAX platform is {plat}")


def card_line() -> str:
    """The cards' name and power limit, read by nvidia-smi (not JAX)."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return "; ".join(x.strip() for x in r.stdout.splitlines() if x.strip())


def contract_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def _records(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def host_parity(common: list[str], dev_out: str,
                n: int = PARITY_READS) -> dict:
    """Run --engine host on the first n reads (pairs) and require its SAM to
    be a byte prefix of the device run's: the same header and the same
    records for those reads, in order."""
    host_out = dev_out + ".host.sam"
    stats, _ = aligned_run(common + ["--engine", "host", "-E", str(n),
                                     "-o", host_out])
    if stats["reads"] != n:
        raise AssertionError(f"host run aligned {stats['reads']} of {n}")
    host = _records(host_out)
    dev = _records(dev_out)
    recs = sum(1 for ln in host.splitlines() if not ln.startswith(b"@"))
    if not dev.startswith(host):
        a, b = host.splitlines(), dev.splitlines()
        i = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        raise AssertionError(f"device differs from host at line {i}:\n"
                             f"host:   {a[i]!r}\ndevice: {b[i]!r}")
    return {"host_reads": n, "records": recs, "identical": True}


def compile_seconds(common: list[str], warm, out_dir: str) -> dict:
    """Warm-up seconds of the engine the CLI would build for ``common``:
    once as this process first meets the programs, and again after JAX's
    in-process caches are cleared, i.e. from the persistent cache."""
    import jax

    from bsmap_jax import cli
    from bsmap_jax.engine.pair_pipeline import make_pair_engine

    o = cli.parse_args(common + ["-o", os.path.join(out_dir, "warmup.sam")])
    genome = cli.load_reference(o)
    index = cli.get_index(o, genome)
    make = make_pair_engine if o.query_b else cli.make_engine
    out = {}
    for key in ("compile_cold_s", "compile_cached_s"):
        eng = make(o, genome, index)
        t = time.perf_counter()
        warm(eng)
        out[key] = time.perf_counter() - t
        del eng
        gc.collect()
        jax.clear_caches()
    out["cache_dir"] = jax.config.jax_compilation_cache_dir
    return out


def aligned_run(argv: list[str]) -> tuple[dict, float]:
    from bsmap_jax import cli
    stats: dict = {}
    t = time.perf_counter()
    rc = cli.run(argv, stats)
    dt = time.perf_counter() - t
    if rc != 0:
        raise RuntimeError(f"cli.run exited {rc}: {argv}")
    return stats, dt


def engine_facts(engine) -> dict:
    """Engine class and where its genome array and seed locations live."""
    se = getattr(engine, "se", engine)
    return {"engine": type(engine).__name__,
            "se_engine": type(se).__name__,
            "array_platform": sorted({d.platform
                                      for d in se.d_catcat.devices()}),
            "catcat_devices": sorted(d.id for d in se.d_catcat.devices()),
            "locs_devices": sorted({s.device.id
                                    for s in se.d_wlocs.addressable_shards})}


def run_phase(name: str, common: list[str], warm, card: str,
              out_dir: str = DATA, expect_platform: str = "gpu",
              unit: str = "reads", n_parity: int = PARITY_READS) -> dict:
    """One phase: compile timing, the full device run, host parity.
    Prints its JSON line and returns it."""
    import jax

    from bsmap_jax import native

    line = {"phase": name}
    line.update(compile_seconds(common, warm, out_dir))
    dev_out = os.path.join(out_dir, f"{name}.sam")
    stats, dt = aligned_run(common + ["-o", dev_out])
    facts = engine_facts(stats.pop("engine"))
    if facts["array_platform"] != [expect_platform]:
        raise AssertionError(f"engine arrays on {facts['array_platform']}")
    line.update(facts)
    line["native_lib"] = native.get_lib() is not None
    line["block_path"] = bool(stats["block_path"])
    if not (line["native_lib"] and line["block_path"]):
        raise AssertionError("native block path not taken")
    line[unit] = stats["reads"]
    line["run_s"] = dt
    line[f"{unit}_per_s"] = stats["reads"] / dt
    line["card"] = card
    mem = jax.local_devices()[0].memory_stats() or {}
    line["peak_bytes_in_use"] = mem.get("peak_bytes_in_use")
    line["parity"] = host_parity(common, dev_out, n_parity)
    print(json.dumps(line), flush=True)
    return line


def phase_p2(common: list[str], p1_out: str) -> dict:
    """-p 2 (two CLI worker processes) must equal the -p 1 output."""
    out = p1_out[:-len(".sam")] + "_p2.sam"
    argv = list(common)
    argv[argv.index("-p") + 1] = "2"
    stats, dt = aligned_run(argv + ["-o", out])
    if stats.get("workers") != 2:
        raise AssertionError("-p 2 did not run two workers")
    same = _records(out) == _records(p1_out)
    if not same:
        raise AssertionError("-p 2 output differs from -p 1")
    return {"p2_run_s": dt, "p2_equals_p1": same}


def datasets():
    from tools import genreads
    a = genreads.generate(DATA, n_reads=1_000_000)
    b = genreads.generate_chr21(DATA, n_reads=500_000)
    c = genreads.generate_pe(DATA)
    d = genreads.generate_rrbs(DATA)
    return a, b, c, d


def one_card(card: str) -> None:
    (ga, ra), (gb, rb), (gc_, r1, r2), (gd, rd) = datasets()
    cache = ["--index-cache", os.path.join(DATA, "index")]
    se = lambda g, r: ["-a", r, "-d", g, "-S", "1", "-u", "-p", "1"] + cache
    warm_se = lambda eng: eng.warmup_programs("f", 7, True)
    warm_pe = lambda eng: eng.warmup_programs(7)
    # (d) first: its -p 2 workers need card memory while this process still
    # holds little
    d = se(gd, rd) + RRBS_ARGS
    run_phase("d_rrbs", d, warm_se, card)
    print(json.dumps({"phase": "d_rrbs_p2",
                      **phase_p2(d, os.path.join(DATA, "d_rrbs.sam"))}),
          flush=True)
    run_phase("a_se_wgbs", se(ga, ra), warm_se, card)
    run_phase("b_se_chr21", se(gb, rb), warm_se, card)
    run_phase("c_pe", ["-a", r1, "-b", r2, "-d", gc_, "-S", "1", "-u",
                       "-p", "1"] + cache, warm_pe, card, unit="pairs")


def four_cards(card: str) -> None:
    import jax
    if len(jax.devices()) != 4:
        raise RuntimeError(f"--chips 4 needs 4 GPUs, have "
                           f"{len(jax.devices())}")
    _, (gb, rb), (gc_, r1, r2), _ = datasets()
    cache = ["--index-cache", os.path.join(DATA, "index")]
    cells = [("b_se_chr21", ["-a", rb, "-d", gb], "reads",
              ("auto", "sharded", "index-sharded")),
             ("c_pe", ["-a", r1, "-b", r2, "-d", gc_], "pairs",
              ("sharded", "index-sharded"))]
    for name, inp, unit, engines in cells:
        common = inp + ["-S", "1", "-u", "-p", "1"] + cache
        ref_out = os.path.join(DATA, f"{name}_device.sam")
        for eng in ("device",) + engines:
            out = os.path.join(DATA, f"{name}_{eng}.sam")
            stats, dt = aligned_run(common + ["--engine", eng, "-o", out])
            facts = engine_facts(stats.pop("engine"))
            want = 1 if eng == "device" else 4
            if len(facts["catcat_devices"]) != want \
                    or len(facts["locs_devices"]) != want:
                raise AssertionError(f"{eng}: arrays on {facts}")
            line = {"phase": name, "engine_option": eng, **facts,
                    unit: stats["reads"], "run_s": dt,
                    f"{unit}_per_s": stats["reads"] / dt,
                    "card": card}
            if eng != "device":
                if _records(out) != _records(ref_out):
                    raise AssertionError(f"{name}: {eng} output differs "
                                         "from --engine device")
                line["equals_device"] = True
            print(json.dumps(line), flush=True)
            gc.collect()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1)
    args = ap.parse_args()
    # allocate on demand: the -p 2 phase's workers share this card
    os.environ.setdefault("XLA_PYTHON_CLIENT_PREALLOCATE", "false")
    import jax
    devices = jax.devices()
    require_gpu(devices)
    card = card_line()
    print(f"card: {card} | device_kind: {devices[0].device_kind} | "
          f"count: {len(devices)} | jax {jax.__version__}", flush=True)
    sys.path.insert(0, REPO)
    os.makedirs(DATA, exist_ok=True)
    if args.chips == 4:
        four_cards(card)
    else:
        one_card(card)
    print(f"card: {card}", flush=True)
    print(contract_line(devices), flush=True)


if __name__ == "__main__":
    main()
