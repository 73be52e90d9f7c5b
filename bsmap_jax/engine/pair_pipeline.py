"""Pair-end batch driver (Do_PairAlign equivalent, main.cpp:116-131).

SAM mode writes paired + unpaired lines into one file; BSP mode writes pairs
to -o and unpaired hits to the -2 file (main.cpp:103-107).

The native PE block pipeline (SAM, no trimming/RRBS) streams both mates
through chunked native parsing, two fused kernel dispatches per window, the
vectorized K x K join, and the native pair formatter — with parse-ahead and
write-behind threads like the SE block path (C18 thread runtime)."""

from __future__ import annotations

import os
import queue
import threading

from ..output.pair_sam import PairFormatter
from ..output.sam import sam_header
from ..readio import BATCH_NUM, detect_format, open_read_stream
from ..utils import RandR, StepTimer


def run_pair_end(o, genome, index) -> int:
    p = o.param
    engine = make_pair_engine(o, genome, index)
    from ..cli import _randr_seed
    fmt = PairFormatter(genome, p, RandR(_randr_seed()))
    blocks = (getattr(engine, "supports_pair_blocks", lambda: False)()
              and detect_format(o.query_a) < 2
              and detect_format(o.query_b) < 2)
    if blocks:
        total = run_pair_end_blocks(o, genome, engine, fmt)
    else:
        total = run_pair_end_reads(o, genome, engine, fmt)
    o.stats.update(engine=engine, block_path=blocks, reads=total)
    denom = max(total, 1)
    print("Total number of aligned reads: \n"
          f"pairs:       {fmt.n_aligned_pairs} "
          f"({100.0 * fmt.n_aligned_pairs / denom:.2g}%)\n"
          f"single a:    {fmt.n_aligned_a} "
          f"({100.0 * fmt.n_aligned_a / denom:.2g}%)\n"
          f"single b:    {fmt.n_aligned_b} "
          f"({100.0 * fmt.n_aligned_b / denom:.2g}%)")
    if p.out_sam == 2:
        from ..output.bam import sam_to_bam
        sam_to_bam(o.out_file)
    return 0


def run_pair_end_reads(o, genome, engine, fmt, header: bool = True) -> int:
    """Per-pair path: exact for every configuration (BSP, -R, RRBS, trim)."""
    p = o.param
    sa = open_read_stream(o.query_a, p, readset=1)
    sb = open_read_stream(o.query_b, p, readset=2)
    timer = StepTimer()
    fout = open(o.out_file, "w")
    fout_unpair = None
    if p.out_sam:
        if header:
            fout.write(sam_header(genome))
    else:
        if not o.out_unpair:
            raise SystemExit(
                "failed to open output file for unpaired hits "
                "(check -2 option)")
        fout_unpair = open(o.out_unpair, "w")

    total = 0
    while True:
        batch_a = sa.next_batch(BATCH_NUM)
        batch_b = sb.next_batch(BATCH_NUM)
        if not batch_a or len(batch_a) != len(batch_b):
            break
        paired_out, unpair_out = engine.format_batch(batch_a, batch_b, fmt)
        fout.write(paired_out)
        if fout_unpair is not None:
            fout_unpair.write(unpair_out)
        else:
            fout.write(unpair_out)
        total += len(batch_a)
        print(f"{total} reads finished. {timer.total():.1f} secs passed")
    fout.close()
    if fout_unpair is not None:
        fout_unpair.close()
    sa.close()
    sb.close()
    return total


def run_pair_end_blocks(o, genome, engine, fmt, header: bool = True) -> int:
    """Native PE block pipeline: parse-ahead producer, align+format main
    loop, write-behind thread (the native calls release the GIL)."""
    from .. import native
    from ..blockio import BlockReadStream

    p = o.param
    lib = native.get_lib()
    if hasattr(engine, "warmup_programs"):
        engine.warmup_programs()
    sa = BlockReadStream(o.query_a, p, readset=1, lib=lib)
    sb = BlockReadStream(o.query_b, p, readset=2, lib=lib)
    # smaller blocks than SE: the deferred-finish overlap (phase 2 + join +
    # format of block N under block N+1's phase 1) needs several blocks in
    # flight to engage
    blk_win = int(os.environ.get("BSMAP_JAX_PE_BLOCK_WINDOWS", 2))
    blk_n = blk_win * engine.se.B
    q_in: "queue.Queue" = queue.Queue(maxsize=2)
    q_out: "queue.Queue" = queue.Queue(maxsize=4)

    def producer():
        # geometric first-block ramp, as in the SE pipeline: the device
        # starts on a one-window block instead of idling through the full
        # first parse
        size = engine.se.B
        while True:
            ba = sa.next_block(min(size, blk_n))
            bb = sb.next_block(min(size, blk_n))
            size *= 2
            if ba is None or bb is None or len(ba) != len(bb):
                q_in.put(None)
                break
            if hasattr(engine, "encode_block_pair"):
                engine.encode_block_pair(ba, bb)   # GIL-releasing natives
            q_in.put((ba, bb))

    def writer():
        with open(o.out_file, "wb") as fout:
            if p.out_sam and header:
                fout.write(sam_header(genome).encode("latin1"))
            while True:
                item = q_out.get()
                if item is None:
                    break
                fout.write(item)

    t_prod = threading.Thread(target=producer, daemon=True)
    t_wr = threading.Thread(target=writer, daemon=True)
    t_prod.start()
    t_wr.start()
    timer = StepTimer()
    total = 0
    prev = None            # (finish, n): block N-1, finished only after
    try:                   # block N's phase 1 is on the device
        while True:
            item = q_in.get()
            if item is None:
                break
            ba, bb = item
            cur = (engine.align_block_pair(ba, bb)
                   if hasattr(engine, "align_block_pair")
                   else None)
            if prev is not None:
                q_out.put(prev[0](fmt))
                total += prev[1]
                print(f"{total} read pairs finished. "
                      f"{timer.total():.1f} secs passed")
            prev = (cur, len(ba)) if cur is not None else None
            if cur is None:          # non-deferring engine: inline
                q_out.put(engine.format_block_pair(ba, bb, fmt))
                total += len(ba)
        if prev is not None:
            q_out.put(prev[0](fmt))
            total += prev[1]
            print(f"{total} read pairs finished. "
                  f"{timer.total():.1f} secs passed")
    finally:
        q_out.put(None)
        t_wr.join()
        t_prod.join()
        sa.close()
        sb.close()
    return total


def make_pair_engine(o, genome, index):
    """PE engine honoring --engine: PairDeviceEngine wraps whichever SE
    engine ``cli.make_engine`` picks (sharded and index-sharded included),
    since it only uses the dispatch/replay surface.  Pair-end RRBS has no
    device path: 'auto' runs it on the exact host engine and says so; an
    explicit device engine refuses it (EngineUnsupported)."""
    if o.engine == "host" or (o.engine == "auto" and o.param.RRBS_flag):
        if o.engine == "auto":
            print("Engine PairHostEngine: pair-end RRBS has no device path")
        return HostPairBatch(genome, index, o.param)
    from ..cli import make_engine
    from .pair_device import PairDeviceEngine
    return PairDeviceEngine(genome, index, o.param,
                            se_engine=make_engine(o, genome, index))


class HostPairBatch:
    """Batch wrapper over the exact per-pair engine."""

    def __init__(self, genome, index, param):
        from .pair_host import PairHostEngine
        self.engine = PairHostEngine(genome, index, param)
        self.param = param

    def format_batch(self, batch_a, batch_b, fmt: PairFormatter):
        p = self.param
        main_parts = []
        unpair_parts = []
        # the reference appends pair + unpaired lines per read, in read
        # order; in SAM mode both go to the same stream (pairs.cpp:213-217)
        for ra, rb in zip(batch_a, batch_b):
            pres = self.engine.align_pair(ra, rb)
            fell = 1
            if pres.paired:
                text, fell = fmt.string_align_pair(ra, rb, pres)
                main_parts.append(text)
            if fell == 1 or not pres.paired:
                up = fmt.string_align_unpair(
                    ra, rb, pres.filtered_a, pres.filtered_b, pres)
                (main_parts if p.out_sam else unpair_parts).append(up)
        return "".join(main_parts), "".join(unpair_parts)
