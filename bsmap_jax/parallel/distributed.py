"""Multi-host data-parallel launch (first-class -B/-E sharding).

The reference's multi-node story is manual: the user splits the input with
-B/-E and runs N processes (README.txt:83-86, reads.cpp:54-75), with FRESH
per-process aligner state — so its multi-process output differs from a
single-process run on the stale-seed-schedule corner reads.  This module
makes sharding first-class AND byte-exact:

  * ``initialize()`` wires ``jax.distributed`` when a coordinator is given;
    pure filesystem coordination otherwise (single-node multi-process).
    Either way each process computes on one card of its host
    (``worker_env`` / ``local_device_ids``) with its share of that card's
    memory, and aligns its own read range on its local devices only.
  * Each process takes a contiguous read range (computed from a fast native
    count pass), aligns it, and writes ``<out>.shard<k>``; process 0 merges
    the shards in order — identical bytes to a single-process run.
  * ``reconstruct_state()`` rebuilds the aligner's cross-read MateState at
    a range boundary from the *preceding* reads' content (seed-buffer
    last-writer-wins fill + the ReorderSeed offset recompute), so the
    stale-schedule corner reads still match the single-process run —
    something the reference itself does not achieve.
"""

from __future__ import annotations

import os
import time

import numpy as np


# a worker's share of a card: the rest is left to the driver and the CUDA
# context of each process
CARD_MEM_SHARE = 0.9
NVIDIA_GPUS_DIR = "/proc/driver/nvidia/gpus"


def visible_cards(env, gpus_dir: str = NVIDIA_GPUS_DIR) -> list[str]:
    """CUDA device ids of this host's cards, found without initializing
    JAX (which would reserve a card): CUDA_VISIBLE_DEVICES when set, else
    every card the NVIDIA driver lists; none when JAX is held to the CPU."""
    plats = env.get("JAX_PLATFORMS", "")
    if plats and not any(x in plats for x in ("cuda", "gpu")):
        return []
    cvd = env.get("CUDA_VISIBLE_DEVICES")
    if cvd is not None:
        return [c.strip() for c in cvd.split(",") if c.strip()]
    if os.path.isdir(gpus_dir):
        return [str(i) for i in range(len(os.listdir(gpus_dir)))]
    import shutil
    import subprocess
    if shutil.which("nvidia-smi") is None:
        return []
    r = subprocess.run(["nvidia-smi", "--query-gpu=index",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return [x.strip() for x in r.stdout.splitlines() if x.strip()]


def worker_env(env, k: int, n_workers: int, cards: list[str]) -> dict:
    """Environment for process k of n_workers on one host: one card,
    round-robin over ``cards`` (CUDA_VISIBLE_DEVICES), and
    XLA_PYTHON_CLIENT_MEM_FRACTION = CARD_MEM_SHARE / (processes on that
    card) unless ``env`` already sets a fraction, so the processes of one
    card fit on it together.  Without cards ``env`` is returned as is."""
    out = dict(env)
    if cards:
        c = k % len(cards)
        out["CUDA_VISIBLE_DEVICES"] = cards[c]
        share = CARD_MEM_SHARE / len(range(c, n_workers, len(cards)))
        out.setdefault("XLA_PYTHON_CLIENT_MEM_FRACTION", f"{share:.4f}")
    return out


def initialize(coordinator: str | None, num_processes: int,
               process_id: int) -> None:
    """Pin this process to its card of the host (``worker_env``), then
    bring up jax.distributed when a coordinator is given (single-node
    multi-process runs coordinate via files).  Must run before the first
    JAX computation: the variables are read when the backend starts."""
    os.environ.update(worker_env(os.environ, process_id, num_processes,
                                 visible_cards(os.environ)))
    if coordinator:
        import jax
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)


def count_reads(path: str, param) -> int:
    """Fast full-file read count with the native tokenizer (one pass)."""
    from .. import native
    from ..blockio import BlockReadStream
    lib = native.get_lib()
    if lib is None:
        from ..readio import ReadStream
        s = ReadStream(path, param, 0)
        n = 0
        while True:
            b = s.next_batch(50000)
            if not b:
                break
            n += len(b)
        s.close()
        return n
    s = BlockReadStream(path, param, 0, lib)
    n = 0
    while True:
        blk = s.next_block(1 << 18)
        if blk is None:
            break
        n += len(blk)
    s.close()
    return n


def plan_range(total: int, num_processes: int, process_id: int,
               read_start: int = 1, read_end: int | None = None):
    """Contiguous per-process (read_start, read_end) 1-based inclusive range
    within the user's own -B/-E window."""
    lo = read_start
    hi = min(read_end if read_end else total, total)
    n = max(0, hi - lo + 1)
    per = (n + num_processes - 1) // num_processes
    s = lo + process_id * per
    e = min(lo + (process_id + 1) * per - 1, hi)
    return s, e


def _reconstruct_into(host, state, path: str, param, range_start: int,
                      readset: int = 0, window: int = 4096) -> None:
    """Rebuild one MateState exactly as if reads [1, range_start) of the
    given stream had been aligned, from read content alone.

    Buffers are content-pure (last-writer-wins of each read's seed values);
    the chosen start offsets are those of the last read with max_offset > 0,
    computed against the buffer state at ITS point in the stream (a second,
    temporary fill).  The window doubles until it contains such a read (or
    reaches the start of the file)."""
    from ..engine.host_engine import MateState, fill_seed_buffers
    from ..readio import ReadStream
    from ..trim import filter_read

    if range_start <= 1:
        return
    p = param
    S, I = p.seed_size, p.index_interval
    while True:
        w0 = max(1, range_start - window)
        import copy
        p2 = copy.copy(p)
        p2.read_start = w0
        p2.read_end = range_start - 1
        s = ReadStream(path, p2, readset)
        reads = s.next_batch(range_start - w0)
        s.close()
        live = []
        for rd in reads:
            filtered, _ = filter_read(rd, p)
            if not filtered:
                live.append(rd)
        mo = [(len(r.seq) - I + 1) % S for r in live]
        has_offset_read = any(m > 0 for m in mo)
        if has_offset_read or w0 == 1:
            break
        window *= 2

    n = len(live)
    fill_seed_buffers(p, state, lambda k: live[k], 0, n, MateState.SEEDBUF)
    if has_offset_read:
        L = max(k for k in range(n) if mo[k] > 0)
        tmp = MateState()
        fill_seed_buffers(p, tmp, lambda k: live[k], 0, L + 1,
                          MateState.SEEDBUF)
        rd = live[L]
        budget = p.read_max_snp_num(len(rd.seq), rd.raw_len or len(rd.seq))
        host.sync_schedule(rd, budget, state=tmp)
        state.seed_start_offset = tmp.seed_start_offset
        state.cseed_start_offset = tmp.cseed_start_offset


def reconstruct_state(engine, path: str, param, range_start: int,
                      window: int = 4096) -> None:
    """SE: rebuild the engine's single MateState at a range boundary."""
    host = getattr(engine, "host", engine)
    _reconstruct_into(host, host.mate_state, path, param, range_start,
                      readset=0, window=window)


def reconstruct_pair_state(pair_engine, path_a: str, path_b: str, param,
                           range_start: int, window: int = 4096) -> None:
    """PE: rebuild both per-mate MateStates (PairAlign owns _sa and _sb,
    pairs.h:50-51) at a pair-range boundary."""
    ph = getattr(pair_engine, "pair_host", None) or pair_engine.engine
    host = ph.single
    _reconstruct_into(host, ph.state_a, path_a, param, range_start,
                      readset=1, window=window)
    _reconstruct_into(host, ph.state_b, path_b, param, range_start,
                      readset=2, window=window)


def merge_shards(out_file: str, num_processes: int, header: str = "",
                 timeout_s: float = 3600.0) -> None:
    """Process 0: wait for every shard's .done sentinel, then concatenate
    shards in process order (byte-identical to the single-process output)."""
    t0 = time.time()
    for k in range(num_processes):
        while not os.path.exists(f"{out_file}.shard{k}.done"):
            if time.time() - t0 > timeout_s:
                raise TimeoutError(f"shard {k} did not finish")
            time.sleep(0.2)
    with open(out_file, "wb") as out:
        if header:
            out.write(header.encode("latin1"))
        for k in range(num_processes):
            with open(f"{out_file}.shard{k}", "rb") as f:
                while True:
                    chunk = f.read(1 << 22)
                    if not chunk:
                        break
                    out.write(chunk)
    for k in range(num_processes):
        os.remove(f"{out_file}.shard{k}")
        os.remove(f"{out_file}.shard{k}.done")
