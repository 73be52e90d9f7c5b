"""Command-line driver with the reference's option surface (main.cpp:182-289).

Supports both ``-x val`` and ``-x=val`` forms.  Output format is chosen by
the -o suffix: .sam / .bam / anything-else = BSP (main.cpp:293-296).
"""

from __future__ import annotations

import os
import sys

from .index import (build_index, index_cache_key, load_index, save_index)
from .output.sam import SamFormatter, sam_header
from .params import MAXSNPS, Param, MAXHITS
from .readio import BATCH_NUM, open_read_stream
from .reference import load_genome
from .utils import RandR, StepTimer

USAGE = """Usage: bsmap_jax [options]
       -a  <str>   query a file, FASTA/FASTQ/BAM format
       -d  <str>   reference sequences file, FASTA format
       -o  <str>   output alignment file, BSP/SAM/BAM format
       -s  <int>   seed size, default=16 (WGBS), 12 (RRBS). min=8, max=16
       -v  <int>   max mismatches per read (<=15), default=2
       -w  <int>   max equal best hits to count (<=1000)
       -B  <int>   start from the Nth read or pair, default 1
       -E  <int>   end at the Nth read or pair
       -I  <int>   index interval, default=4
       -p  <int>   processors (accepted for compatibility)
       -D  <str>   RRBS digestion site, e.g. C-CGG
       -S  <int>   random seed for multi-hit selection (0 = clock)
       -n  [0,1]   map to 2 forward strands (0) or all 4 (1)
       -M  <str>   alignment transition, default TC
       -q  <int>   quality trim threshold, default 0
       -z  <int>   base quality zero, default 33
       -f  <int>   filter reads with >n Ns, default 5
       -A  <str>   3' adapter sequence
       -L  <int>   map first N nucleotides
       -r  [0,1]   repeat-hit reporting: 0 none, 1 random one
       -R          print reference sequence (XR tag)
       -u          report unmapped reads
       -b  <str>   query b file (pair-end)
       -m  <int>   min insert size, default 28
       -x  <int>   max insert size, default 500
       -2  <str>   output for unpaired PE hits (BSP mode)
       --engine {auto,host,device,sharded,index-sharded}
                   alignment engine (default auto: sharded over all devices
                   when >1, else single-device; index-sharded = seed index
                   region-sharded across the mesh, reads replicated)
       --index-cache <dir>           persist/reuse the seed index
       --nprocs <int>       multi-host: total processes (data-parallel over
                            contiguous read ranges; byte-exact merge)
       --proc-id <int>      multi-host: this process id (0-based)
       --coordinator <a:p>  multi-host: jax.distributed coordinator address
       -h          help
"""


class Options:
    def __init__(self) -> None:
        self.param = Param()
        self.query_a = ""
        self.query_b = ""
        self.ref_file = ""
        self.out_file = ""
        self.out_unpair = ""
        self.engine = "auto"
        self.index_cache = os.environ.get("BSMAP_JAX_INDEX_CACHE", "")
        self.nprocs = 1
        self.proc_id = 0
        self.coordinator = ""
        # filled by the run for a caller that passed run(argv, stats):
        # engine object, whether the native block path ran, reads aligned
        self.stats: dict = {}


def parse_args(argv: list[str]) -> Options:
    o = Options()
    p = o.param
    i = 0

    def val(flag_takes_value=True):
        nonlocal i
        a = argv[i]
        if len(a) > 2 and a[2] == "=":
            return a[3:]
        i += 1
        return argv[i]

    while i < len(argv):
        a = argv[i]
        if a == "--engine":
            i += 1
            o.engine = argv[i]
        elif a.startswith("--engine="):
            o.engine = a.split("=", 1)[1]
        elif a == "--index-cache":
            i += 1
            o.index_cache = argv[i]
        elif a.startswith("--index-cache="):
            o.index_cache = a.split("=", 1)[1]
        elif a == "--nprocs":
            i += 1
            o.nprocs = int(argv[i])
        elif a.startswith("--nprocs="):
            o.nprocs = int(a.split("=", 1)[1])
        elif a == "--proc-id":
            i += 1
            o.proc_id = int(argv[i])
        elif a.startswith("--proc-id="):
            o.proc_id = int(a.split("=", 1)[1])
        elif a == "--coordinator":
            i += 1
            o.coordinator = argv[i]
        elif a.startswith("--coordinator="):
            o.coordinator = a.split("=", 1)[1]
        elif a.startswith("-") and len(a) >= 2:
            c = a[1]
            if c == "a":
                o.query_a = val()
            elif c == "b":
                o.query_b = val()
                p.pairend = 1
            elif c == "d":
                o.ref_file = val()
            elif c == "o":
                o.out_file = val()
            elif c == "2":
                o.out_unpair = val()
            elif c == "s":
                p.set_seed_size(int(val()))
                if p.RRBS_flag:
                    p.set_seed_size(12)
            elif c == "m":
                p.min_insert = int(val())
            elif c == "x":
                p.max_insert = int(val())
            elif c == "r":
                p.report_repeat_hits = int(val())
            elif c == "I":
                p.index_interval = int(val())
                if p.RRBS_flag:
                    p.index_interval = 1
                if p.index_interval > 16:
                    sys.exit("index interval exceeds max value:16")
            elif c == "v":
                p.max_snp_num = int(val())
                if p.max_snp_num > MAXSNPS:
                    sys.exit(f"number of mismatches exceeds max value:{MAXSNPS}")
            elif c == "w":
                p.max_num_hits = int(val())
                if p.max_num_hits > MAXHITS:
                    sys.exit(f"number of multi-hits exceeds max value:{MAXHITS}")
            elif c == "q":
                p.qual_threshold = int(val())
            elif c == "f":
                p.max_ns = int(val())
            elif c == "z":
                p.zero_qual = int(val())
            elif c == "p":
                p.num_procs = int(val())
            elif c == "A":
                p.adapters.append(val())
            elif c == "R":
                p.out_ref = 1
            elif c == "u":
                p.out_unmap = 1
            elif c == "B":
                p.read_start = max(int(val()), 1)
            elif c == "E":
                p.read_end = int(val())
            elif c == "D":
                p.set_digestion_site(val())
            elif c == "M":
                v = val()
                p.set_align(v[0], v[1])
            elif c == "L":
                p.max_readlen = int(val())
            elif c == "S":
                p.randseed = int(val())
            elif c == "n":
                p.chains = 1 if int(val()) != 0 else 0
            elif c == "h":
                print(USAGE)
                sys.exit(0)
            else:
                sys.exit(f"unknown option: {a}")
        else:
            sys.exit(f"unknown option: {a}")
        i += 1
    if o.engine not in ENGINES:
        sys.exit(f"unknown engine: {o.engine} (one of {', '.join(ENGINES)})")
    if o.out_file.endswith(".sam"):
        p.out_sam = 1
    elif o.out_file.endswith(".bam"):
        p.out_sam = 2
    p.init_mapping()
    return o


def load_reference(o: Options):
    """The packed genome of -d (through --index-cache when given)."""
    if o.index_cache:
        from .reference import load_genome_cached
        genome = load_genome_cached(o.ref_file, o.param, o.index_cache)
    else:
        genome = load_genome(o.ref_file, o.param)
    o.param.total_ref_seq = genome.n_chr
    return genome


def get_index(o: Options, genome, log=print):
    p = o.param
    if o.index_cache:
        os.makedirs(o.index_cache, exist_ok=True)
        key = index_cache_key(o.ref_file, p)
        path = os.path.join(o.index_cache, f"idx_{key}.npz")
        if os.path.exists(path):
            log(f"loading cached index {path}")
            try:
                # memory-mapped: N local -p workers share one page-cached
                # copy instead of N private heaps (main.cpp:45-131 shares
                # one index across threads)
                return load_index(path, mmap=True)
            except ValueError:       # old compressed-format cache
                return load_index(path)
        idx = build_index(genome, p)
        save_index(path, idx)
        return idx
    return build_index(genome, p)


ENGINES = ("auto", "host", "device", "sharded", "index-sharded")


def make_engine(o: Options, genome, index):
    """The SE engine --engine names.  'auto' is the data-parallel mesh
    engine when this process sees more than one device, else the
    single-device engine; it never substitutes the host engine."""
    if o.engine == "host":
        from .engine.host_engine import HostEngine
        return HostEngine(genome, index, o.param)
    import jax
    from .engine.device_engine import DeviceEngine, device_summary
    if o.engine == "sharded" or (o.engine == "auto"
                                 and len(jax.local_devices()) > 1):
        from .parallel import ShardedDeviceEngine as cls
    elif o.engine == "index-sharded":
        from .parallel import IndexShardedEngine as cls
    else:
        cls = DeviceEngine
    engine = cls(genome, index, o.param)
    print(f"Engine {cls.__name__} on {device_summary()}")
    return engine


def run(argv: list[str], stats: dict | None = None) -> int:
    """Align as the command line says; returns the exit status.  A caller
    that passes ``stats`` gets the engine used, whether the native block
    path ran and the number of reads (pairs) aligned written into it."""
    if not argv:
        print(USAGE)
        return 1
    o = parse_args(argv)
    if stats is not None:
        o.stats = stats
    p = o.param
    timer = StepTimer()
    if not o.ref_file:
        sys.exit("fatal error: failed to open ref file")
    tmp_cache = None
    if o.nprocs == 1 and _wants_local_mp(o) and not o.index_cache:
        # -p worker processes re-run genome pack + index build otherwise
        # (the reference's threads share ONE in-RAM copy, main.cpp:45-131);
        # auto-provision a cache dir: this parent builds + saves once,
        # workers mmap-load the shared page-cached copy
        import tempfile
        tmp_cache = tempfile.mkdtemp(prefix="bsmap_jax_idx_")
        o.index_cache = tmp_cache
        argv = list(argv) + ["--index-cache", tmp_cache]
    genome = load_reference(o)
    print(f"Load in {genome.n_chr} db seqs, total size {genome.sum_length} bp."
          f" {timer.total():.1f} secs passed")
    index = get_index(o, genome)
    print(f"Create seed table. {timer.total():.1f} secs passed")

    if o.nprocs > 1:
        if o.query_a and o.query_b:
            n = run_multihost_pair(o, genome, index)
        else:
            n = run_multihost_se(o, genome, index)
    elif _wants_local_mp(o):
        try:
            n = run_local_multiprocess(o, argv)
        finally:
            if tmp_cache:
                import shutil
                shutil.rmtree(tmp_cache, ignore_errors=True)
    elif o.query_a and o.query_b:
        from .engine.pair_pipeline import run_pair_end
        n = run_pair_end(o, genome, index)
    else:
        n = run_single_end(o, genome, index)
    print(f"Total time consumed:  {timer.total():.1f} secs")
    return 0


def _wants_local_mp(o: Options) -> bool:
    """-p N (>1) parallelizes the per-read Python paths (RRBS, trimming,
    PE formatting) by local process sharding — the reference's pthread
    pool (main.cpp:45-131) recast as the byte-exact --nprocs range
    machinery.  The native SE block path (SAM, BSP, -R) is already
    pipeline-threaded and device-bound, so -p is a no-op there."""
    p = o.param
    if p.num_procs <= 1 or os.environ.get("BSMAP_JAX_LOCAL_MP") == "0":
        return False
    pe = bool(o.query_a and o.query_b)
    block_path = (not p.RRBS_flag and not p.adapters
                  and p.qual_threshold == 0
                  and (not pe or (p.out_sam >= 1 and not p.out_ref)))
    return not block_path


def run_local_multiprocess(o: Options, argv: list[str]) -> int:
    """Spawn -p worker processes over contiguous read ranges (each takes
    the o.nprocs > 1 branch); output is merged byte-identical.  Read-range
    shards are idempotent (SURVEY.md §5: the -B/-E mechanism is the
    reference's only restart primitive), so a crashed worker is simply
    re-run once before giving up.

    This process never initializes a JAX backend (that would reserve a
    card); each worker pins itself to one card of the host with its share
    of that card's memory (parallel.distributed.initialize)."""
    import subprocess
    import time as _time

    n = o.param.num_procs
    o.stats.update(workers=n)

    from . import REPO_DIR
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        filter(None, [REPO_DIR, env.get("PYTHONPATH")]))

    def spawn(k: int):
        cmd = [sys.executable, "-m", "bsmap_jax.cli"] + argv + [
            "--nprocs", str(n), "--proc-id", str(k)]
        return subprocess.Popen(cmd, env=env)

    # monitor + PROMPT respawn: worker 0 blocks in merge_shards waiting for
    # every shard's .done sentinel, so a crashed worker must be retried as
    # soon as it dies (the old wait-then-retry left 0 stuck until the merge
    # timeout); shard ranges are idempotent, one retry each
    procs = {k: spawn(k) for k in range(n)}
    retried: set[int] = set()
    rc: dict[int, int] = {}
    while len(rc) < n:
        for k in list(procs):
            if k in rc:
                continue
            r = procs[k].poll()
            if r is None:
                continue
            if r != 0 and k not in retried:
                print(f"retrying failed worker shard {k} "
                      "(idempotent range)")
                retried.add(k)
                procs[k] = spawn(k)
            else:
                rc[k] = r
        _time.sleep(0.2)
    if any(rc.values()):
        _cleanup_shards(o, n)
        sys.exit(f"worker process failed after retry: {rc}")
    return 0


def _cleanup_shards(o: Options, n: int) -> None:
    """Remove partial shard litter after a failed multi-process run."""
    for base in (o.out_file, o.out_unpair):
        if not base:
            continue
        for k in range(n):
            for suf in (f".shard{k}", f".shard{k}.done", f".shard{k}.tmp"):
                try:
                    os.remove(base + suf)
                except OSError:
                    pass


def run_multihost_se(o: Options, genome, index) -> int:
    """Multi-host SE: contiguous read-range shard per process, exact
    MateState reconstruction at the range boundary, ordered shard merge on
    process 0 (parallel/distributed.py)."""
    from .parallel import distributed as dist

    p = o.param
    dist.initialize(o.coordinator, o.nprocs, o.proc_id)
    total = dist.count_reads(o.query_a, p)
    s, e = dist.plan_range(total, o.nprocs, o.proc_id,
                           p.read_start, p.read_end)
    final_out = o.out_file
    engine = make_engine(o, genome, index)
    if s > 1:
        dist.reconstruct_state(engine, o.query_a, p, s)
    p.read_start, p.read_end = s, e
    # write through a .tmp + atomic rename: a shard that dies midway never
    # looks complete to the merger (failure/elastic hardening, SURVEY.md §5)
    shard_path = final_out + f".shard{o.proc_id}"
    o.out_file = shard_path + ".tmp"
    fmt = SamFormatter(genome, p, RandR(1))
    timer = StepTimer()
    from .readio import detect_format
    if (getattr(engine, "supports_blocks", lambda: False)()
            and detect_format(o.query_a) < 2):
        total_n = run_single_end_blocks(o, engine, fmt, genome, timer,
                                        header=False)
    else:
        total_n = run_single_end_reads(o, engine, fmt, genome, timer,
                                       header=False)
    os.replace(o.out_file, shard_path)
    o.out_file = shard_path
    open(shard_path + ".done", "w").close()
    print(f"shard {o.proc_id}: {total_n} reads, "
          f"{fmt.n_aligned} aligned")
    if o.proc_id == 0:
        dist.merge_shards(final_out, o.nprocs,
                          sam_header(genome) if p.out_sam else "")
        print(f"merged {o.nprocs} shards -> {final_out}")
    o.out_file = final_out
    if p.out_sam == 2 and o.proc_id == 0:
        from .output.bam import sam_to_bam
        sam_to_bam(o.out_file)
    return total_n


def run_multihost_pair(o: Options, genome, index) -> int:
    """Multi-host PE: contiguous PAIR-range shard per process with both
    per-mate MateStates reconstructed exactly at the boundary (the
    reference's manual -B/-E splitting covers pairs too: README.txt:83-86,
    main.cpp:87-114); ordered shard merge on process 0."""
    from .engine.pair_pipeline import (make_pair_engine,
                                       run_pair_end_blocks,
                                       run_pair_end_reads)
    from .output.pair_sam import PairFormatter
    from .parallel import distributed as dist
    from .readio import detect_format

    p = o.param
    dist.initialize(o.coordinator, o.nprocs, o.proc_id)
    total = dist.count_reads(o.query_a, p)
    s, e = dist.plan_range(total, o.nprocs, o.proc_id,
                           p.read_start, p.read_end)
    engine = make_pair_engine(o, genome, index)
    if s > 1:
        dist.reconstruct_pair_state(engine, o.query_a, o.query_b, p, s)
    p.read_start, p.read_end = s, e
    final_out, final_unpair = o.out_file, o.out_unpair
    if not p.out_sam and not final_unpair:
        sys.exit("failed to open output file for unpaired hits "
                 "(check -2 option)")
    fmt = PairFormatter(genome, p, RandR(1))
    shard_path = f"{final_out}.shard{o.proc_id}"
    o.out_file = shard_path + ".tmp"
    up_path = ""
    if final_unpair:
        up_path = f"{final_unpair}.shard{o.proc_id}"
        o.out_unpair = up_path + ".tmp"
    if (getattr(engine, "supports_pair_blocks", lambda: False)()
            and detect_format(o.query_a) < 2
            and detect_format(o.query_b) < 2):
        total_n = run_pair_end_blocks(o, genome, engine, fmt, header=False)
    else:
        total_n = run_pair_end_reads(o, genome, engine, fmt, header=False)
    os.replace(o.out_file, shard_path)
    open(shard_path + ".done", "w").close()
    if not p.out_sam and final_unpair:
        os.replace(o.out_unpair, up_path)
        open(up_path + ".done", "w").close()
    o.out_file, o.out_unpair = final_out, final_unpair
    print(f"shard {o.proc_id}: {total_n} pairs, "
          f"{fmt.n_aligned_pairs} aligned pairs")
    if o.proc_id == 0:
        dist.merge_shards(final_out, o.nprocs,
                          sam_header(genome) if p.out_sam else "")
        if not p.out_sam and final_unpair:
            dist.merge_shards(final_unpair, o.nprocs, "")
        print(f"merged {o.nprocs} shards -> {final_out}")
        if p.out_sam == 2:
            from .output.bam import sam_to_bam
            sam_to_bam(final_out)
    return total_n


def _randr_seed() -> int:
    """rand_r seed for -S 0: getpid()*time() like the reference
    (main.cpp-era semantics: explicitly non-reproducible, README.txt:91-92);
    BSMAP_JAX_RANDR_SEED pins it for internal parity tests."""
    env = os.environ.get("BSMAP_JAX_RANDR_SEED")
    if env is not None:
        return int(env)
    return os.getpid() * int(__import__("time").time()) & 0xFFFFFFFF


def run_single_end(o: Options, genome, index) -> int:
    p = o.param
    engine = make_engine(o, genome, index)
    fmt = SamFormatter(genome, p, RandR(_randr_seed()))
    timer = StepTimer()
    from .readio import detect_format
    blocks = (getattr(engine, "supports_blocks", lambda: False)()
              and detect_format(o.query_a) < 2)
    if blocks:
        total = run_single_end_blocks(o, engine, fmt, genome, timer)
    else:
        total = run_single_end_reads(o, engine, fmt, genome, timer)
    o.stats.update(engine=engine, block_path=blocks, reads=total)
    denom = max(total, 1)
    print(f"Total number of aligned reads: {fmt.n_aligned} "
          f"({100.0 * fmt.n_aligned / denom:.2g}%)")
    if p.out_sam == 2:
        from .output.bam import sam_to_bam
        sam_to_bam(o.out_file)
    return 0


def run_single_end_reads(o: Options, engine, fmt, genome, timer,
                         header: bool = True) -> int:
    """Per-read path: exact for every configuration (BSP, -R, RRBS, trim)."""
    p = o.param
    stream = open_read_stream(o.query_a, p, readset=0)
    with open(o.out_file, "w") as fout:
        if p.out_sam and header:
            fout.write(sam_header(genome))
        total = 0
        while True:
            batch = stream.next_batch(BATCH_NUM)
            if not batch:
                break
            fout.write(engine.format_batch(batch, fmt)
                       if hasattr(engine, "format_batch")
                       else "".join(fmt.string_align(r, engine.align(r))
                                    for r in batch))
            total += len(batch)
            print(f"{total} reads finished. {timer.total():.1f} secs passed")
    stream.close()
    return total


def run_single_end_blocks(o: Options, engine, fmt, genome, timer,
                          header: bool = True) -> int:
    """Native block pipeline: chunked parse -> device align -> native SAM
    format, with parse-ahead and write-behind threads (C18 thread runtime;
    the native calls release the GIL)."""
    import queue
    import threading

    from . import native
    from .blockio import BlockReadStream

    p = o.param
    lib = native.get_lib()
    stream = BlockReadStream(o.query_a, p, readset=0, lib=lib)
    # 4 dispatch windows per block: windows within a block pipeline on the
    # device while the producer thread parses the next block and the writer
    # thread formats the previous one (the native format call releases the
    # GIL) — three-stage pipeline over the reference's C18 thread runtime
    blk_win = int(os.environ.get("BSMAP_JAX_BLOCK_WINDOWS", 8))
    blk_n = blk_win * getattr(engine, "B", BATCH_NUM)
    q_in: "queue.Queue" = queue.Queue(maxsize=2)
    q_out: "queue.Queue" = queue.Queue(maxsize=4)

    def producer():
        # geometric ramp (1, 2, 4, ... windows): the device starts on the
        # first window after ~1/blk_win of the full-block parse time
        # instead of idling through it; the parser outruns the device and
        # catches up within a few blocks
        size = getattr(engine, "B", BATCH_NUM)
        while True:
            blk = stream.next_block(min(size, blk_n))
            size *= 2
            if blk is not None and hasattr(engine, "encode_block"):
                # native filter+encode here (GIL released): overlaps the
                # previous block's device time instead of serializing
                # between blocks in the align thread
                engine.encode_block(blk)
            q_in.put(blk)
            if blk is None:
                break

    def writer():
        with open(o.out_file, "wb") as fout:
            if p.out_sam and header:
                fout.write(sam_header(genome).encode("latin1"))
            while True:
                item = q_out.get()
                if item is None:
                    break
                blk, aligned = item
                fout.write(engine.format_aligned_block(blk, aligned, fmt))

    t_prod = threading.Thread(target=producer, daemon=True)
    t_wr = threading.Thread(target=writer, daemon=True)
    t_prod.start()
    t_wr.start()
    total = 0
    try:
        while True:
            blk = q_in.get()
            if blk is None:
                break
            q_out.put((blk, engine.align_block(blk)))
            total += len(blk)
            print(f"{total} reads finished. {timer.total():.1f} secs passed")
    finally:
        q_out.put(None)
        t_wr.join()
        t_prod.join()
        stream.close()
    return total


def main() -> None:
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()
