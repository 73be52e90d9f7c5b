"""Vectorized JAX alignment engine — the device fast path.

Design (a batched reformulation rather than a port of align.cpp):

  * The genome lives on device as one uint32 array ``catcat`` =
    refcat ++ crefcat (2-bit packed, 16 bases/word) plus the CSR seed index.
    All large arrays are runtime buffers (never baked into the program).
  * Stage 1 (read axis): pack the active read chain(s), compute per-position
    seed values and bucket costs, and run the full seed schedule
    (ReorderSeed/AdjustSeedStartArray/seedindex, align.cpp:454-577).  The
    reference's CountSeeds sums are *sliding-window sums* of the
    per-position bucket costs (the probed positions for segment n are the
    I consecutive offsets [n*S, n*S+I)), so the whole cost table is two
    cumsums — no gathers.
  * Stage 2 (candidate axis): all reads' bucket entries are laid out on one
    global candidate axis (total work proportional to the actual number of
    candidate loci, load-balanced across the power-law bucket sizes), in
    exact reference discovery order (read, segment rank, chain, phase,
    bucket entry).  Each candidate gathers its 11 reference words, gets
    phase-aligned with two shifts, and is scored by the bitwise XOR/popcount
    CountMismatch lane math (align.h:167-200).  Dedup, the
    progressive-sensitivity early exit (align.cpp:445-449), per-level
    counts and reproducible multi-hit selection are sort/scan/scatter ops
    on the candidate axis.

Shape rules:

  * Gathers use flat 1-D index arrays (``_g1``/``_rowg``/``_taa``).
  * Static specialization: ``maxseg`` is ``max_snp_num + 1`` (not the
    MAXSNPS=15 ceiling), the unused read chain is skipped entirely for
    SE / per-mate PE batches, and the seed-position table size POSMAX
    depends only on the config — one compiled program per run config,
    no per-batch-length recompiles.
  * No separate candidate-count pre-pass on clean data: chunks are
    dispatched optimistically at a small candidate capacity and the (rare)
    overflow tail is re-dispatched, exactly bin-packed.
  * The program is int32/uint32-only (x64 disabled); the 64-bit
    reproducible myrand hash (utilities.cpp:40-50) is computed host-side
    in vectorized numpy and fed in as a uint32 per read.

Exactness: the fast path assumes a static mismatch threshold (no bucket-cap
tightening) and no -r 0 abort.  Reads where those sequential semantics could
change anything are detected (level count >= max_num_hits, candidate
overflow, -r 0 multi-hits) and replayed on the exact host engine.  Reads
whose seed schedule could touch *stale* seed-buffer state (the reference's
SingleAlign reuses per-instance buffers across reads: align.cpp:454-469 —
visible when ``(len - I + 1) % S == 0`` or when probe/cost positions exceed
``len - S``, i.e. short or mixed-length reads) are detected host-side from
the length vector alone and replayed with an exactly reconstructed
MateState, preserving bit parity at batch throughput.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from ..index import SeedIndex
from ..params import (FIXELEMENT, FIXSIZE, MAXSNPS, Param, REG_ALPHABET,
                      REV_CHAR, SEGLEN)
from ..readio import Read
from ..reference import PackedGenome
from ..trim import filter_read
from ..utils import myrand_hash
from .host_engine import HostEngine, MateState, SEResult

import os as _os
import time as _time

# reads per device dispatch / candidates per read of dispatch capacity
# (fixed shapes: one compiled program); env-overridable so CPU test runs can
# use small, fast-to-compile shapes.
#
# CANDS_PER_READ is deliberately small: kernel work is ~linear in the
# candidate capacity and the mean per-read demand is <<2 on clean batches.
# Reads whose candidates overflow re-window (head always fits); single
# reads exceeding the whole capacity escalate to the
# CANDS_BIG_PER_READ-sized program before the exact host replay.  Both
# sizes were chosen on another platform and are not re-tuned for the GPU.
DEV_BATCH = int(_os.environ.get("BSMAP_JAX_DEV_BATCH", 65536))
CANDS_PER_READ = int(_os.environ.get("BSMAP_JAX_CANDS_PER_READ", 2))
CANDS_BIG_PER_READ = int(_os.environ.get("BSMAP_JAX_CANDS_BIG_PER_READ", 16))
BIGLEVEL = 99
SATLIM = np.uint32(1 << 30)    # saturating-cumsum fixed point (overflow guard)


def device_summary() -> str:
    """'<platform> <device_kind> x<count>' of the devices this process
    computes on (printed at engine start so no run hides its device)."""
    devs = jax.local_devices()
    return f"{devs[0].platform} {devs[0].device_kind} x{len(devs)}"


class EngineUnsupported(ValueError):
    """Raised when the device fast path cannot handle this configuration."""


def rc_tuple_of(param) -> tuple:
    """Static 2-bit complement permutation + RC 'N' code for a Param."""
    rc = tuple(int(param.alphabet[REV_CHAR[ord(param.useful_nt[c])]])
               for c in range(4))
    return rc, int(param.rev_alphabet[ord("N")])


def make_cfg(param, W: int, n_chr: int, chains_mode: str, maxseg: int,
             lean: bool = False, nw: int = FIXELEMENT) -> "Cfg":
    """Kernel Cfg from a Param + genome shape facts alone."""
    S, I = param.seed_size, param.index_interval
    P = min(16 * nw - S + 1, maxseg * S + 2 * I)
    rc, rc_n = rc_tuple_of(param)
    return Cfg(S=S, I=I, maxseg=maxseg, chains_mode=chains_mode, P=P,
               max_num_hits=param.max_num_hits,
               report_repeat_hits=param.report_repeat_hits,
               W=W, n_chr=n_chr, lean=lean,
               rrbs=bool(param.RRBS_flag), min_ins=param.min_insert,
               max_ins=param.max_insert,
               tail=len(param.digest_site) - 2 * param.digest_pos
               if param.RRBS_flag else 0,
               rc=rc, rc_n=rc_n, nw=nw)


class Cfg(NamedTuple):
    """Static (compile-time) configuration of the kernels."""

    S: int
    I: int
    maxseg: int            # seed segments per read: min(MAXSNPS, -v) + 1
    chains_mode: str       # 'f' fwd-only, 'r' rc-only, 'b' both
    P: int                 # seed positions in the schedule table
    max_num_hits: int
    report_repeat_hits: int
    W: int                 # words per catcat half
    n_chr: int
    lean: bool = False     # 2-int32 packed rows (SAM fast path) vs full rows
    pe: bool = False       # pair-end enumeration: no progressive early exit
                           # (PairAlign runs every segment, pairs.cpp:163),
                           # no -r 0 abort (align.cpp:210 pairend guard)
    hits_k: int = 0        # also emit up to K compacted hits per read
    rrbs: bool = False     # digestion-site index: tag-filtered candidates,
                           # chr-local coords, SE fragment filter
                           # (align.cpp:175-251, dbseq.cpp:541-567)
    min_ins: int = 0       # RRBS fragment-length window (-m/-x)
    max_ins: int = 0
    tail: int = 0          # len(digest_site) - 2*digest_pos
    rc: tuple = (3, 2, 1, 0)   # 2-bit complement permutation (rc_code);
                               # static so the RC chain is pure lane math
    rc_n: int = 3          # rev_alphabet['N'] code for RC-chain N lanes
    shard_axis: str = ""   # non-empty inside an index-sharded shard_map:
                           # locs/offsets are the LOCAL region shard, the
                           # kmer table carries global+local counts, and
                           # counts/early-exit/selection merge with
                           # psum/pmin/all_gather over this mesh axis
    probe: bool = False    # totals-only pre-pass: run stage 1 and return
                           # each read's full-rank candidate total, so the
                           # host can bin-pack verify dispatches exactly
                           # (repeat-heavy genomes; the reference's answer
                           # is cheap-segment-first ordering align.cpp:471)
    fixed: bool = False    # fixed-schedule fast path: probe the pigeonhole
                           # covering at start offset 0 in natural segment
                           # order, skipping ReorderSeed/zigzag/seedindex
                           # (align.cpp:454-577) entirely.  At full
                           # sensitivity the HIT SET is schedule-independent
                           # (any covering finds every <=budget alignment;
                           # dedup canonicalizes), so found/NM, best level,
                           # best-level count and the unique hit are exact;
                           # reads whose output DOES depend on the schedule
                           # (multi-hit selection order, BSP histograms,
                           # partial-sensitivity lengths) re-dispatch on the
                           # exact-schedule program
    nw: int = FIXELEMENT   # packed words per read this dispatch: 7 when
                           # every read is <= 112 nt (25% less H2D, 8 vs 11
                           # reference-word gathers in verify), else 10

    @property
    def nch(self) -> int:
        return 2 if self.chains_mode == "b" else 1

    @property
    def NB(self) -> int:
        return self.maxseg * self.nch * self.I


# ---------------------------------------------------------------------------
# flat-index helpers (all gathers must use 1-D index arrays: fast path)
# ---------------------------------------------------------------------------

def _g1(tab, idx):
    """Gather tab[idx] with idx flattened to 1-D."""
    flat = tab.reshape(-1)[idx.reshape(-1)]
    return flat.reshape(idx.shape)


def _rowg(tab2d, idx):
    """Row-gather tab2d[idx] for 1-D idx (fast path for (N, k) tables)."""
    return tab2d[idx.reshape(-1)].reshape(idx.shape + tab2d.shape[1:])


def _taa(a, idx):
    """take_along_axis(a, idx, axis=1) via a flat 1-D gather."""
    B, K = a.shape
    r = jnp.arange(B, dtype=jnp.int32)[:, None] * K
    return _g1(a, r + idx)


def _satadd_scan(x):
    """Inclusive saturating-add scan (monotone even when true sums would
    overflow int32; saturating add is associative for nonneg values)."""
    sat = lambda a, b: jnp.minimum(a + b, SATLIM)
    return jax.lax.associative_scan(sat, x)


# ---------------------------------------------------------------------------
# stage 1: read-axis pack + seed schedule
# ---------------------------------------------------------------------------

def _seed_array_w(qw, S, P, pos=None):
    """Base-3 collapsed seed value at every read offset (align.cpp:97-105)
    — or only at `pos` (the fixed path probes NB static offsets instead of
    all P) — computed from the 2-bit packed words: vectorized
    funnel-shift windows (one fancy-index per operand
    instead of P scalar slices), T(11)->C(01) lane collapse, then base-3
    accumulation of the top S lanes."""
    B, F = qw.shape
    qwp = jnp.concatenate([qw, jnp.zeros((B, 1), jnp.uint32)], axis=1)
    if pos is None:
        pos = np.arange(P)
    karr = jnp.asarray(pos >> 4, dtype=jnp.int32)
    zz = jnp.asarray(((pos & 15) * 2), dtype=jnp.uint32)[None, :]
    a = qwp[:, karr]                                        # (B, P)
    b = qwp[:, karr + 1]
    bs = b >> (jnp.uint32(32) - jnp.maximum(zz, jnp.uint32(1)))
    w = jnp.where(zz == 0, a, (a << zz) | bs)
    t = w & (w >> jnp.uint32(1)) & jnp.uint32(0x55555555)   # lanes == 11
    cw = w ^ (t << jnp.uint32(1))                           # T -> C (01)
    acc = jnp.zeros((B, len(pos)), dtype=jnp.int32)
    for j in range(S):
        acc = acc * 3 + ((cw >> jnp.uint32(2 * (15 - j)))
                         & jnp.uint32(3)).astype(jnp.int32)
    return acc


def _len_mask_words(lens, F):
    """(B, F) uint32 masks: 11 in lanes < len, 00 beyond."""
    j = jnp.arange(F, dtype=jnp.int32)[None, :]
    v = jnp.clip(lens[:, None] - 16 * j, 0, 16)
    sh = (2 * (16 - v)).astype(jnp.uint32)
    return jnp.where(v > 0,
                     jnp.uint32(0xFFFFFFFF) << jnp.minimum(sh, jnp.uint32(30)),
                     jnp.uint32(0))


def _rc_words(cfg: Cfg, qw, rw, lens):
    """Reverse-complement chain as packed words (ConvertBinaySeq
    align.cpp:131-161): per-lane complement via the static rc permutation,
    2-bit-group reversal within words, word-order reversal, then a per-read
    funnel shift left by (FIXSIZE - len) bases.  N lanes (reg 00 within the
    read) are forced to rev_alphabet['N'] so RC-chain seed values match the
    reference's cseq."""
    B, F = qw.shape
    if tuple(cfg.rc) == (3, 2, 1, 0):
        comp = ~qw
    else:
        comp = jnp.zeros_like(qw)
        for v in range(4):
            if cfg.rc[v] == 0:
                continue
            x = qw ^ jnp.uint32(v * 0x55555555)
            ind = ~(x | (x >> jnp.uint32(1))) & jnp.uint32(0x55555555)
            comp = comp | ind * jnp.uint32(cfg.rc[v])

    def rev_lanes(w):
        M33, M0F = jnp.uint32(0x33333333), jnp.uint32(0x0F0F0F0F)
        MFF = jnp.uint32(0x00FF00FF)
        w = ((w & M33) << jnp.uint32(2)) | ((w >> jnp.uint32(2)) & M33)
        w = ((w & M0F) << jnp.uint32(4)) | ((w >> jnp.uint32(4)) & M0F)
        w = ((w & MFF) << jnp.uint32(8)) | ((w >> jnp.uint32(8)) & MFF)
        return (w << jnp.uint32(16)) | (w >> jnp.uint32(16))

    zpad = jnp.zeros((B, F), jnp.uint32)
    rcp = jnp.concatenate([rev_lanes(comp)[:, ::-1], zpad], axis=1)
    rrp = jnp.concatenate([rev_lanes(rw)[:, ::-1], zpad], axis=1)
    sh = (16 * F - lens).astype(jnp.int32)
    k0 = sh >> 4
    z = ((sh & 15) * 2).astype(jnp.uint32)[:, None]
    idx = k0[:, None] + jnp.arange(F, dtype=jnp.int32)[None, :]

    def funnel(tab):
        a = _taa(tab, idx)
        b = _taa(tab, idx + 1)
        bs = b >> (jnp.uint32(32) - jnp.maximum(z, jnp.uint32(1)))
        return jnp.where(z == 0, a, (a << z) | bs)

    cqw0 = funnel(rcp)
    crw = funnel(rrp)
    npat = jnp.uint32((cfg.rc_n * 0x55555555) & 0xFFFFFFFF)
    cqw = (cqw0 & crw) | (npat & _len_mask_words(lens, F) & ~crw)
    return cqw, crw


def _fixed_schedule_impl(cfg: Cfg, qw, rw, d_kmer_tab, lens, budgets,
                         maxrank):
    """cfg.fixed stage 1: probe the pigeonhole covering at start offset 0 —
    seeds at NB STATIC read offsets, one bucket-row gather, no offset
    optimization (ReorderSeed/zigzag).  Segments are still ordered
    cheapest-first PER READ (argsort over the maxseg probed counts) so
    rank-0 dispatches enumerate the smallest bucket — any deterministic
    order is valid because committed results are order-independent, and
    cheap-first keeps the candidate mass near the exact schedule's.
    Callers guarantee (host-side eligibility check) full sensitivity
    (seedseg == budget+1) and in-range probes, so the resulting HIT SET
    equals the exact schedule's."""
    B = qw.shape[0]
    S, I, MS, NB, nch = cfg.S, cfg.I, cfg.maxseg, cfg.NB, cfg.nch
    # static probe layout, natural (segment, chain, phase) order:
    # a = ceil((n*S + i) / I) * I (param.cpp:85-93), k = a - i, h = -a + i
    a_np = np.array([[-(-(n * S + i) // I) * I for i in range(I)]
                     for n in range(MS)], dtype=np.int32)
    k_nat = np.stack([a_np[n, i] - i for n in range(MS)
                      for _c in range(nch) for i in range(I)])
    vals = [_seed_array_w(qw[:, c], S, 0, pos=k_nat) for c in range(nch)]
    if nch == 2:
        is_c = np.array([c for _n in range(MS) for c in range(nch)
                         for _i in range(I)], dtype=bool)
        sv = jnp.where(jnp.asarray(is_c)[None, :], vals[1], vals[0])
    else:
        sv = vals[0]                                        # (B, NB)
    rows = _rowg(d_kmer_tab, sv)                            # (B, NB, ncol)
    ncol = rows.shape[-1]
    cnt_col = 4 if ncol > 4 else 1
    fresh = jnp.asarray(k_nat)[None, :] <= (lens - S)[:, None]
    h_nat = jnp.broadcast_to(jnp.asarray(-k_nat)[None, :], (B, NB))
    cnt_nat = jnp.where(fresh, rows[..., cnt_col], 0)
    # per-read, per-chain cheapest-segment-first ordering
    shp = (B, MS, nch, I)
    seg_cost = cnt_nat.reshape(shp).sum(axis=3)             # (B, MS, nch)
    ord_ = jnp.argsort(jnp.swapaxes(seg_cost, 1, 2), axis=2,
                       stable=True)                         # (B, nch, MS)
    ord_ = jnp.swapaxes(ord_, 1, 2).astype(jnp.int32)       # (B, MS, nch)

    def permute(nat):
        nat4 = nat.reshape(shp)
        out = nat4
        for m in range(MS):
            out = jnp.where((ord_ == m)[..., None], nat4[:, m][:, None],
                            out)
        return out.reshape(B, NB)

    zero = jnp.zeros((B,), jnp.int32)
    return (permute(h_nat), permute(rows[..., 0]), permute(rows[..., 3]),
            permute(rows[..., 2]), permute(cnt_nat),
            jnp.zeros((B, NB), jnp.int32), zero, zero)


def _schedule_impl(cfg: Cfg, prof_a, d_kmer_tab, d_tag_off,
                   rc_code, rc_n_code, qw0, rw0, lens, budgets, maxrank):
    B = qw0.shape[0]
    S, I, P, MS = cfg.S, cfg.I, cfg.P, cfg.maxseg

    chains = []
    if cfg.chains_mode in ("f", "b"):
        chains.append((qw0, rw0))
    if cfg.chains_mode in ("r", "b"):
        chains.append(_rc_words(cfg, qw0, rw0, lens))

    qw = jnp.stack([c for c, _ in chains], axis=1)          # (B, nch, 10)
    rw = jnp.stack([r for _, r in chains], axis=1)

    seedseg = jnp.clip(jnp.minimum((lens - I + 1) // S, budgets + 1), 0, MS)
    max_off = (lens - I + 1) % S

    if cfg.fixed:
        (h, off0, off3, wcnt, cnt, wantv, s_off_out,
         c_off_out) = _fixed_schedule_impl(cfg, qw, rw, d_kmer_tab, lens,
                                           budgets, maxrank)
        slot_rank_f = jnp.asarray(
            np.repeat(np.arange(MS, dtype=np.int32), cfg.nch * I))
        seg_ok = slot_rank_f[None, :] < seedseg[:, None]
        cnt_full = jnp.where(seg_ok, cnt, 0)
        cnt_cl = jnp.minimum(cnt_full.astype(jnp.uint32),
                             jnp.uint32(1 << 27)).astype(jnp.int32)
        srn = np.repeat(np.arange(MS), cfg.nch * I)
        onehot = np.zeros((len(srn), MS), dtype=np.int32)
        onehot[np.arange(len(srn)), srn] = 1
        per_rank = cnt_cl @ jnp.asarray(onehot)
        ftot_rank = jnp.minimum(jnp.cumsum(per_rank, axis=1), 1 << 27)
        cnt = jnp.where(slot_rank_f[None, :] <= maxrank[:, None],
                        cnt_full, 0)
        return (qw, rw, h, off0, off3, wcnt, cnt, wantv, s_off_out,
                c_off_out, ftot_rank)

    n_i = jnp.arange(MS, dtype=jnp.int32)
    off_i = jnp.arange(S, dtype=jnp.int32)
    BIGU = jnp.uint32(0xFFFFFFFF)

    def chain_schedule(cwords, koff):
        sarr = _seed_array_w(cwords, S, P)          # (B, P) int32
        # per-position bucket costs: the only random-access gather of
        # stage 1.  Bucket row = [watson_off, total_count, watson_count,
        # crick_off]; under index sharding two extra columns:
        # [.., local_total, local_crick] — cost/schedule math uses the
        # GLOBAL total (col 1, replicated so every device computes the
        # identical schedule), enumeration uses the LOCAL shard counts
        # (cols 4, 2, and offsets 0/3).
        rows = _rowg(d_kmer_tab, sarr)              # (B, P, 4|6) int32
        cnt = rows[..., 1]
        if cfg.rrbs:
            # RRBS: one probed position per segment (I=1), no offset scan
            # or refinement; segments ordered by RAW bucket size
            # (host_engine._reorder RRBS branch, align.cpp:471-503)
            a_n = prof_a[: MS, 0]                              # (MS,)
            pos = jnp.clip(a_n[None, :] + koff[:, None], 0, P - 1)
            cost_n = _taa(cnt, pos).astype(jnp.uint32)         # (B, MS)
            seg_mask = (n_i[None, :] < seedseg[:, None])
            cost_s = cost_n ^ jnp.uint32(0x80000000)
            key_hi = jnp.where(seg_mask, cost_s, BIGU)
            order = jnp.argsort(key_hi, axis=1,
                                stable=True).astype(jnp.int32)
            start_arr = jnp.zeros((B, MS), jnp.int32)
            return (start_arr, order, rows, jnp.zeros((B,), jnp.int32),
                    sarr)
        # reference cost includes the +2 CSR header slots (dbseq.cpp:381).
        # Sums are WRAPPING uint32 like the reference's bit32_t totals
        # (align.cpp:455,507).
        cost = jnp.where(cnt > 0, cnt + 2, 0).astype(jnp.uint32)

        # CountSeeds(n, off) = sum of cost over positions [n*S+off,
        # n*S+off+I): a sliding-window sum.
        WLEN = MS * S + I
        cost_p = jnp.zeros((B, WLEN + 1), jnp.uint32)
        cost_p = cost_p.at[:, 1: min(P, WLEN) + 1].set(cost[:, :WLEN])
        cs = jnp.cumsum(cost_p, axis=1)
        Ws = cs[:, I:] - cs[:, :-I]                 # W[k] = sum k..k+I-1
        T = Ws[:, : MS * S].reshape(B, MS, S)

        seg_mask = (n_i[None, :] < seedseg[:, None])
        tot = jnp.where(seg_mask[:, :, None], T, 0).sum(axis=1,
                                                        dtype=jnp.uint32)
        off_ok = off_i[None, :] < max_off[:, None]
        tot_m = jnp.where(off_ok, tot, BIGU)
        s_off = jnp.where(max_off > 0,
                          jnp.argmin(tot_m, axis=1), 0).astype(jnp.int32)

        # zig-zag per-segment refinement (align.cpp:506-547), unrolled:
        # MS is small and static, and fori_loop's while-lowering blocks XLA
        # fusion
        def zig_body(it, start_arr):
            half = it // 2
            ptr = jnp.where(it % 2 == 0, half, seedseg - 1 - half)
            active = (it < seedseg)
            ptr_c = jnp.clip(ptr, 0, MS - 1).astype(jnp.int32)
            prev = _taa(start_arr,
                        jnp.clip(ptr_c - 1, 0, MS - 1)[:, None])[:, 0]
            nxt = _taa(start_arr,
                       jnp.clip(ptr_c + 1, 0, MS - 1)[:, None])[:, 0]
            costs = _taa(T.reshape(B, MS * S),
                         ptr_c[:, None] * S + off_i[None, :])  # (B, S)
            lo = jnp.where(ptr_c == 0, 0, prev)
            hi = jnp.where(ptr_c == seedseg - 1, max_off, nxt)
            rng_ok = (off_i[None, :] >= lo[:, None]) & \
                     (off_i[None, :] <= hi[:, None])
            costs_m = jnp.where(rng_ok, costs, BIGU)
            best = jnp.argmin(costs_m, axis=1).astype(jnp.int32)
            onehot = (n_i[None, :] == ptr_c[:, None]) & active[:, None]
            return jnp.where(onehot, best[:, None], start_arr)

        start_arr = jnp.broadcast_to(s_off[:, None], (B, MS))
        for it in range(MS):
            start_arr = zig_body(it, start_arr)

        # segment ordering cheapest-bucket-first (seedindex align.cpp:471-503)
        # std::sort on pair<int,int>(cost, n): cost compared as SIGNED int,
        # ties by segment id (stable argsort over ascending n).
        cost_n = _taa(T.reshape(B, MS * S), n_i[None, :] * S + start_arr)
        cost_s = cost_n ^ jnp.uint32(0x80000000)    # order uint as int32
        key_hi = jnp.where(seg_mask, cost_s, BIGU)
        order = jnp.argsort(key_hi, axis=1, stable=True).astype(jnp.int32)
        return start_arr, order, rows, s_off, sarr

    # per-chain RRBS position shift: the RC chain probes a + (len % S)
    # (align.cpp:175-251 cseed_offset); 0 for WGBS and forward chains
    rc_shift = (lens % S).astype(jnp.int32) if cfg.rrbs \
        else jnp.zeros_like(lens)
    zero_off = jnp.zeros_like(lens)
    if cfg.chains_mode == "f":
        koffs = [zero_off]
    elif cfg.chains_mode == "r":
        koffs = [rc_shift]
    else:
        koffs = [zero_off, rc_shift]

    scheds = [chain_schedule(c, k) for (c, _), k in zip(chains, koffs)]

    # --- slot grid in discovery order: (rank, chain, phase) -----------------
    NB, nch = cfg.NB, cfg.nch
    slot_rank_np = np.repeat(np.arange(MS, dtype=np.int32), nch * I)
    slot_phase_np = np.tile(np.arange(I, dtype=np.int32), nch * MS)
    slot_rank = jnp.asarray(slot_rank_np)                    # (NB,)
    slot_cs = jnp.tile(jnp.repeat(jnp.arange(nch, dtype=jnp.int32), I), MS)
    slot_phase = jnp.asarray(slot_phase_np)

    def slot_desc(start_arr, order, rows_p, koff, is_rc, sarr_p):
        mode = _taa(order, jnp.broadcast_to(slot_rank[None, :], (B, NB)))
        a = _g1(prof_a, mode * I + slot_phase[None, :])
        st = _taa(start_arr, mode)
        k = a + st - slot_phase[None, :] + koff[:, None]
        k_c = jnp.clip(k, 0, P - 1)
        h = -a + slot_phase[None, :] - st - koff[:, None]
        # positions beyond the read's fresh seed range are stale-state
        # corners handled by host replay; zero them so the device result
        # (discarded for those reads) stays in-bounds
        fresh = (k >= 0) & (k <= (lens - S)[:, None])
        if cfg.rrbs:
            # the probed (segment, strand) class (align.cpp:183-196): the
            # index is TAG-PARTITIONED, so look up this class's sub-bucket
            # directly instead of scanning + filtering the raw bucket
            want = jnp.where(is_rc, lens[:, None] // S - 1 - mode, mode)
            sv = _taa(sarr_p, k_c)                          # (B, NB)
            J2 = (d_tag_off.shape[0] - 1) // (3 ** cfg.S)
            cls = want * 2 + (1 if is_rc else 0)
            idx_t = jnp.clip(sv * J2 + cls, 0, d_tag_off.shape[0] - 2)
            off_t = _g1(d_tag_off, idx_t)
            cnt_t = _g1(d_tag_off, idx_t + 1) - off_t
            ok_t = fresh & (want >= 0) & (want * 2 + 1 < J2)
            z = jnp.zeros_like(off_t)
            return (off_t, jnp.where(ok_t, cnt_t, 0), z, z, h, want)
        want = mode
        # one consolidated row gather for all slot-table columns
        ncol = rows_p.shape[-1]
        flat = jnp.arange(B, dtype=jnp.int32)[:, None] * P + k_c
        rs = _rowg(rows_p.reshape(B * P, ncol), flat)       # (B, NB, ncol)
        cnt_col = 4 if ncol > 4 else 1
        return (rs[..., 0], jnp.where(fresh, rs[..., cnt_col], 0),
                rs[..., 2], rs[..., 3], h, want)

    descs = [slot_desc(st, o, rp, koff, bool(is_rc), sp)
             for (st, o, rp, _, sp), koff, is_rc in zip(
                 scheds, koffs,
                 [cfg.chains_mode == "r"] if nch == 1 else [False, True])]
    if nch == 2:
        is_c = (slot_cs[None, :] == 1)
        off0 = jnp.where(is_c, descs[1][0], descs[0][0])
        cnt = jnp.where(is_c, descs[1][1], descs[0][1])
        wcnt = jnp.where(is_c, descs[1][2], descs[0][2])
        off3 = jnp.where(is_c, descs[1][3], descs[0][3])
        h = jnp.where(is_c, descs[1][4], descs[0][4])
        wantv = jnp.where(is_c, descs[1][5], descs[0][5])
    else:
        off0, cnt, wcnt, off3, h, wantv = descs[0]

    # per-rank cumulative candidate totals (clamped; anything >= the clamp
    # is replay territory anyway): the host's exact bin-packing input —
    # column r = what a maxrank=r dispatch would enumerate for this read
    seg_ok = slot_rank[None, :] < seedseg[:, None]
    cnt_full = jnp.where(seg_ok, cnt, 0)
    cnt_cl = jnp.minimum(cnt_full.astype(jnp.uint32),
                         jnp.uint32(1 << 27)).astype(jnp.int32)
    slot_rank_np = np.repeat(np.arange(MS), cfg.nch * I)   # static layout
    onehot = np.zeros((len(slot_rank_np), MS), dtype=np.int32)
    onehot[np.arange(len(slot_rank_np)), slot_rank_np] = 1
    per_rank = cnt_cl @ jnp.asarray(onehot)              # (B, MS)
    ftot_rank = jnp.minimum(jnp.cumsum(per_rank, axis=1), 1 << 27)
    # progressive-sensitivity escalation: only ranks <= maxrank enumerate
    # candidates this pass (the reference's per-segment early exit recast
    # as batched passes; unresolved reads re-dispatch at full rank)
    cnt = jnp.where(slot_rank[None, :] <= maxrank[:, None], cnt_full, 0)
    # MateState carry: per-chain chosen global start offsets (s_off / c_off)
    s_off_out = scheds[0][3]
    c_off_out = scheds[-1][3] if cfg.chains_mode != "f" else \
        jnp.zeros((B,), jnp.int32)
    if cfg.chains_mode == "r":
        s_off_out = jnp.zeros((B,), jnp.int32)
    return (qw, rw, h, off0, off3, wcnt, cnt, wantv, s_off_out, c_off_out,
            ftot_rank)


# ---------------------------------------------------------------------------
# stage 2: candidate-axis enumerate + verify + control-flow emulation
# ---------------------------------------------------------------------------

def _verify_impl(cfg: Cfg, CANDS: int, d_catcat, d_anchors, d_sizes,
                 d_rcoff, d_wlocs, d_clocs, d_tags, d_sites, d_site_off,
                 qw, rw, lens, budgets, rand32, maxrank,
                 h, off0, off3, wcnt, cnt, wantv, s_off, c_off, ftot,
                 bounds=None):
    B = qw.shape[0]
    W, NB, nch, I, MS = cfg.W, cfg.NB, cfg.nch, cfg.I, cfg.maxseg
    ax = cfg.shard_axis or None
    if ax:
        # bin-packing capacity is per shard: pack by the max local demand
        ftot = jax.lax.pmax(ftot, ax)
    sidx = jnp.arange(CANDS, dtype=jnp.int32)

    # --- global candidate layout: saturating cumsum of slot counts ----------
    cnt_flat = jnp.minimum(cnt.reshape(-1), SATLIM).astype(jnp.uint32)
    gcum_i = _satadd_scan(cnt_flat)                          # inclusive
    starts = jnp.concatenate([jnp.zeros(1, jnp.uint32),
                              gcum_i[:-1]]).astype(jnp.int32)
    ends = gcum_i.astype(jnp.int32)
    total_all = ends[-1]

    # candidate -> slot id: scatter each nonempty slot's id at its start,
    # then a forward running max (1-D scatter + scan).
    slot_ids = jnp.arange(B * NB, dtype=jnp.int32)
    tgt = jnp.where((cnt_flat > 0) & (starts < CANDS), starts, CANDS)
    fid0 = jnp.full((CANDS + 1,), -1, jnp.int32).at[tgt].max(slot_ids)
    fid = jax.lax.associative_scan(jnp.maximum, fid0[:CANDS])
    fid = jnp.clip(fid, 0, B * NB - 1)
    live = sidx < total_all
    rid = fid // NB
    b = fid - rid * NB
    rank = b // (nch * I)
    if nch == 2:
        chain = (b // I) % 2
    else:
        chain = jnp.zeros((CANDS,), jnp.int32) if cfg.chains_mode == "f" \
            else jnp.ones((CANDS,), jnp.int32)
    e = sidx - _g1(starts, fid)

    g_off0 = _g1(off0, fid)
    g_off3 = _g1(off3, fid)
    g_wc = _g1(wcnt, fid)
    g_h = _g1(h, fid)

    tag_ok = None
    if cfg.rrbs:
        # RRBS entries are (tag, chr-local loc), TAG-PARTITIONED: this
        # slot's sub-bucket holds exactly its (segment, strand) class
        # (the reference scans the raw bucket filtering on the tag,
        # align.cpp:183 — same accepted sequence, no foreign entries)
        eidx = jnp.clip(g_off0 + e, 0, d_wlocs.shape[0] - 1)
        entry_loc = _g1(d_wlocs, eidx).astype(jnp.int32)
        tag = _g1(d_tags, eidx)
        chrp_t = (tag & 0xFFFF).astype(jnp.int32)
        c = chrp_t >> 1
        crick = (chrp_t & 1) == 1
        loc_local = entry_loc + g_h                     # chr-local int32
        tag_ok = loc_local >= 0
        g = (_g1(d_anchors, c)
             + jnp.clip(loc_local, 0, None).astype(jnp.uint32))
    else:
        # entry coordinates are PER-STRAND uint32 (genomes up to ~4.2 Gb
        # per strand; hg38 4-strand works in 32 bits because Watson and
        # Crick have separate locs arrays and separate catcat halves)
        crick = e >= g_wc
        w_entry = _g1(d_wlocs, jnp.clip(g_off0 + e, 0, d_wlocs.shape[0] - 1))
        c_entry = _g1(d_clocs, jnp.clip(g_off3 + (e - g_wc), 0,
                                        d_clocs.shape[0] - 1))
        entry = jnp.where(crick, c_entry, w_entry)          # uint32
        g = entry + g_h.astype(jnp.uint32)                  # (CANDS,) uint32

    # --- gather + phase-align the reference windows (11 x 1-D gathers) ------
    NW = cfg.nw
    wbase = ((g >> 4).astype(jnp.int32)
             + jnp.where(crick, jnp.int32(W), 0))
    wbase = jnp.clip(wbase, 0, 2 * W - NW - 1)
    words = jnp.stack([_g1(d_catcat, wbase + k)
                       for k in range(NW + 1)], axis=1)
    z = g & 15
    sl = (z * 2)[:, None]
    w_lo = words[:, :NW] << sl
    w_hi = words[:, 1:] >> (jnp.uint32(32) - sl)
    sref = jnp.where(sl == 0, words[:, :NW], w_lo | w_hi)

    # --- CountMismatch lanes (align.h:167-200) ------------------------------
    qrow = rid * nch + (chain if nch == 2 else 0)
    q = _rowg(qw.reshape(B * nch, NW), qrow)
    r = _rowg(rw.reshape(B * nch, NW), qrow)
    xc = ((~sref) << jnp.uint32(1)) | sref | jnp.uint32(0x55555555)
    x = ((q & xc) ^ sref) & r
    lanes = (x | (x >> jnp.uint32(1))) & jnp.uint32(0x55555555)
    wmm = jax.lax.population_count(lanes).sum(axis=-1).astype(jnp.int32)

    # --- coordinate transform + bounds (align.cpp:271-291) ------------------
    # d_anchors is uint32 (global per-strand coords); chr-local values fit
    # int32 (chromosome sizes < 2^31)
    llen = _g1(lens, rid)
    if not cfg.rrbs:
        c = jnp.clip(jnp.searchsorted(d_anchors, g, side="right") - 1,
                     0, cfg.n_chr - 1).astype(jnp.int32)
        loc_local = (g - _g1(d_anchors, c)).astype(jnp.int32)
    wloc = jnp.where(crick, _g1(d_rcoff, c) - llen - loc_local, loc_local)
    in_bounds = (wloc >= 0) & (loc_local >= 0) & \
        (wloc + llen <= _g1(d_sizes, c))

    eligible = live & in_bounds & (wmm <= _g1(budgets, rid))
    if tag_ok is not None:
        eligible = eligible & tag_ok

    # --- dedup by (read, chr, watson_loc): first discovery wins -------------
    # The key matches the reference hitset's: hitset[_hit.chr >> 1] keyed
    # by loc (align.cpp:201,274) — parity is DROPPED, so a Watson and a
    # Crick hit sharing the same Watson 5' coordinate do merge.
    # Cascaded scatter-hash tables instead of a global sort.  Same-key
    # candidates always hash to the same slot, so a scatter-min of the
    # discovery index per slot resolves each key group exactly (min is
    # order-independent) unless a FOREIGN key occupies
    # the slot first — those cascade to the next table with an independent
    # hash; reads still unresolved after the cascade are host-replayed
    # (exactness never depends on hash luck).
    T = 1 << (2 * CANDS - 1).bit_length()
    shift = jnp.uint32(32 - (T.bit_length() - 1))
    rid_u = rid.astype(jnp.uint32)
    c_u = c.astype(jnp.uint32)
    w_u = wloc.astype(jnp.uint32)
    first = jnp.zeros(CANDS, bool)
    unresolved = eligible
    _MULS = ((0x9E3779B1, 0x85EBCA6B, 0xC2B2AE35),
             (0x27D4EB2F, 0x165667B1, 0x9E3779B1),
             (0xC2B2AE35, 0x27D4EB2F, 0x85EBCA6B))
    for m1, m2, m3 in _MULS:
        h = (rid_u * jnp.uint32(m1) + c_u * jnp.uint32(m2)
             + w_u * jnp.uint32(m3))
        h = h ^ (h >> jnp.uint32(16))
        slot = ((h * jnp.uint32(0x9E3779B1)) >> shift).astype(jnp.int32)
        tbl = jnp.full((T,), CANDS, jnp.int32).at[slot].min(
            jnp.where(unresolved, sidx, CANDS))
        w = jnp.clip(_g1(tbl, slot), 0, CANDS - 1)
        same = ((_g1(rid, w) == rid) & (_g1(c, w) == c)
                & (_g1(wloc, w) == wloc))
        is_me = w == sidx
        first = first | (unresolved & is_me)
        unresolved = unresolved & ~(is_me | same)
    dedup_fail = unresolved
    acc_pre = eligible & first

    corner_read = None
    if ax:
        # Region-sharded exactness: entries are owned by the region of
        # their (Watson-projected) coordinate, so same-dedup-key candidates
        # are co-located — EXCEPT when the dedup key (anchors[c] + wloc)
        # falls across a region boundary from the owning entry (possible
        # within one read length of a boundary).  Those reads replay on the
        # exact host engine; the span is <= FIXSIZE bases per boundary.
        my = jax.lax.axis_index(ax).astype(jnp.int32)
        gkey = _g1(d_anchors, c) + jnp.clip(wloc, 0, None).astype(jnp.uint32)
        reg = (jnp.searchsorted(bounds, gkey, side="right")
               .astype(jnp.int32) - 1)
        corner_read = jnp.zeros((B,), bool).at[rid].max(
            eligible & (reg != my))

    if cfg.rrbs and not cfg.pe:
        # SE RRBS fragment filter (align.cpp:202-207): the hit must fall in
        # a digestion fragment of valid length.  NOTE hitset insertion (the
        # dedup above) happens BEFORE this filter in the reference.
        # CCGG_seglen (dbseq.cpp:541-567): seg_start = the floor site (its
        # binary search never returns the last site), seg_end = the first
        # site at/after right0 whose end covers the read (else the last
        # site's end, the documented OOB deviation).
        nsit = _g1(d_site_off, c + 1) - _g1(d_site_off, c)
        key1 = _g1(d_anchors, c) + jnp.clip(wloc, 0, None).astype(jnp.uint32)
        left_g = jnp.searchsorted(d_sites, key1, side="right").astype(
            jnp.int32) - 1
        lo_c = _g1(d_site_off, c)
        left_g = jnp.clip(left_g, lo_c,
                          jnp.maximum(lo_c + nsit - 2, lo_c))
        seg_start = (_g1(d_sites, jnp.clip(left_g, 0, d_sites.shape[0] - 1))
                     - _g1(d_anchors, c)).astype(jnp.int32)
        right0 = jnp.minimum(left_g + 1, lo_c + nsit - 1)
        key2 = (_g1(d_anchors, c)
                + jnp.clip(wloc + llen - cfg.tail, 0,
                           None).astype(jnp.uint32))
        first = jnp.searchsorted(d_sites, key2,
                                 side="left").astype(jnp.int32)
        right = jnp.clip(jnp.maximum(right0, first), lo_c,
                         lo_c + jnp.maximum(nsit - 1, 0))
        seg_end = (_g1(d_sites, jnp.clip(right, 0, d_sites.shape[0] - 1))
                   - _g1(d_anchors, c)).astype(jnp.int32) + cfg.tail
        zl = jnp.where(nsit > 0, seg_end - seg_start, 0)
        frag_ok = (zl >= cfg.min_ins) & (zl <= cfg.max_ins)
        # the filter applies to forward-chain hits only (align.cpp:202)
        acc_pre = acc_pre & (frag_ok | (chain != 0))

    # --- progressive-sensitivity early exit (align.cpp:445-449) -------------
    seedseg = jnp.clip(jnp.minimum((lens - cfg.I + 1) // cfg.S,
                                   budgets + 1), 0, MS)
    if cfg.pe or cfg.rrbs:
        # PairAlign runs every segment of both mates (pairs.cpp:163-172);
        # RRBS checks only after all segments (align.cpp:450)
        accepted = acc_pre
        resolved = jnp.ones((B,), bool)
    else:
        lev = jnp.where(acc_pre, wmm, BIGLEVEL)
        minw_rank = jnp.full((B * MS,), BIGLEVEL, jnp.int32).at[
            rid * MS + rank].min(lev).reshape(B, MS)
        if ax:
            # the early exit must see hits found on ANY device's shard
            minw_rank = jax.lax.pmin(minw_rank, ax)
        prefmin = jax.lax.associative_scan(jnp.minimum, minw_rank, axis=1)
        r_i = jnp.arange(MS, dtype=jnp.int32)
        stopped = (prefmin <= r_i[None, :]) & \
            (r_i[None, :] <= maxrank[:, None])
        any_stop = stopped.any(axis=1)
        s_star = jnp.where(any_stop, jnp.argmax(stopped, axis=1), MS - 1)
        accepted = acc_pre & (rank <= _g1(s_star, rid))
        # resolved: the read stopped within the enumerated ranks, or it has
        # no more segments to run — otherwise the host escalates maxrank
        resolved = any_stop | (maxrank >= seedseg - 1)

    # --- per-level/chain counts ---------------------------------------------
    label = jnp.where(accepted, wmm * 2 + chain, 2 * MS)
    counts = jnp.zeros((B * (2 * MS + 1),), jnp.int32).at[
        rid * (2 * MS + 1) + label].add(1).reshape(B, 2 * MS + 1)
    counts = counts[:, : 2 * MS].reshape(B, MS, 2)
    if ax:
        counts = jax.lax.psum(counts, ax)   # exact global histograms

    lev_sums = counts.sum(axis=2)                       # (B, maxseg)
    found = lev_sums.sum(axis=1) > 0
    ii = jnp.argmax(lev_sums > 0, axis=1).astype(jnp.int32)
    ssum = _taa(lev_sums, ii[:, None])[:, 0]

    # --- replay detection ----------------------------------------------------
    replay = (lev_sums >= cfg.max_num_hits).any(axis=1)
    # hash-dedup cascade exhausted for some candidate of this read
    dd = jnp.zeros((B,), bool).at[rid].max(dedup_fail)
    if ax:
        dd = jax.lax.psum(dd.astype(jnp.int32), ax) > 0
        replay = replay | (jax.lax.psum(corner_read.astype(jnp.int32),
                                        ax) > 0)
    replay = replay | dd
    if cfg.report_repeat_hits == 0 and not cfg.pe:
        # the -r 0 second-equal-best abort is SE-only (align.cpp:210 guard)
        replay = replay | (found & (ssum > 1))

    # --- reproducible multi-hit selection (align.cpp:623-625) ---------------
    j = (rand32 % jnp.maximum(ssum, 1).astype(jnp.uint32)).astype(jnp.int32)
    nfwd = _taa(counts[:, :, 0], ii[:, None])[:, 0]
    sel_chain = (j >= nfwd).astype(jnp.int32)
    target = jnp.where(sel_chain == 1, j - nfwd, j) + 1
    ind = accepted & (wmm == _g1(ii, rid)) & (chain == _g1(sel_chain, rid))
    chrp = 2 * c + crick.astype(jnp.int32)
    ind0 = accepted & (wmm == 0) & (chain == 0)

    if ax:
        # Exact global discovery rank across region shards.  Within a slot
        # (one bucket probe) the global entry order is: Watson entries in
        # ascending-region order across devices, then Crick entries in
        # DESCENDING-region order (Crick coordinates ascend as Watson
        # positions descend).  A (B, NB, 2) per-slot/per-strand count
        # all_gather gives every device the global offsets.
        my = jax.lax.axis_index(ax).astype(jnp.int32)
        fid_c = jnp.clip(fid, 0, B * NB - 1)
        pid = fid_c * 2 + crick.astype(jnp.int32)

        def global_rank_of(match):
            cnt_sp = jnp.zeros((B * NB * 2,), jnp.int32).at[pid].add(
                jnp.where(match, 1, 0)).reshape(B, NB, 2)
            allc = jax.lax.all_gather(cnt_sp, ax)    # (ndev, B, NB, 2)
            devv = jax.lax.broadcasted_iota(
                jnp.int32, (allc.shape[0], 1, 1), 0)
            w_all, c_all = allc[..., 0], allc[..., 1]
            w_pre = jnp.where(devv < my, w_all, 0).sum(axis=0)
            c_pre = jnp.where(devv > my, c_all, 0).sum(axis=0)
            w_tot = w_all.sum(axis=0)
            slot_tot = w_tot + c_all.sum(axis=0)     # (B, NB)
            base_slot = jnp.cumsum(slot_tot.reshape(B * NB)).reshape(
                B, NB) - slot_tot
            # slots are per-read contiguous; rebase to the read's first slot
            base_slot = base_slot - base_slot[:, :1]
            off_w = (base_slot + w_pre).reshape(-1)
            off_c = (base_slot + w_tot + c_pre).reshape(-1)
            csl = jnp.cumsum(match.astype(jnp.int32))
            pos0 = _g1(starts, fid_c) + jnp.where(crick, g_wc, 0)
            p0 = jnp.clip(pos0 - 1, 0, CANDS - 1)
            basel = jnp.where(pos0 > 0, _g1(csl, p0), 0)
            lrank = csl - basel                      # 1-based where match
            offs = jnp.where(crick, _g1(off_c, fid_c), _g1(off_w, fid_c))
            return offs + lrank

        def psum_pick(selm, vals):
            return jax.lax.psum(jnp.zeros((B,), jnp.int32).at[rid].add(
                jnp.where(selm, vals, 0)), ax)

        sel = ind & (global_rank_of(ind) == _g1(target, rid))
        sel_chrp = psum_pick(sel, chrp)
        sel_wloc = psum_pick(sel, wloc)
        sel0 = ind0 & (global_rank_of(ind0) == 1)
        h00_found = jax.lax.psum(jnp.zeros((B,), jnp.int32).at[rid].max(
            jnp.where(ind0, 1, 0)), ax) > 0
        h00_chrp = psum_pick(sel0, chrp)
        h00_wloc = psum_pick(sel0, wloc)
    else:
        cs = jnp.cumsum(ind.astype(jnp.int32))
        read_start = _g1(starts, rid * NB)
        start_pos = jnp.clip(read_start, 0, CANDS - 1)
        base = jnp.where(read_start > 0, _g1(cs, start_pos - 1), 0)
        local_rank = cs - base
        sel = ind & (local_rank == _g1(target, rid))
        sel_sidx = jnp.full((B,), CANDS, jnp.int32).at[rid].min(
            jnp.where(sel, sidx, CANDS))
        safe_sel = jnp.clip(sel_sidx, 0, CANDS - 1)
        sel_chrp = _g1(chrp, safe_sel)
        sel_wloc = _g1(wloc, safe_sel)

        # first level-0 forward hit (hits[0][0] slot leak, see output/sam.py)
        h00_sidx = jnp.full((B,), CANDS, jnp.int32).at[rid].min(
            jnp.where(ind0, sidx, CANDS))
        h00_found = h00_sidx < CANDS
        safe = jnp.clip(h00_sidx, 0, CANDS - 1)
        h00_chrp = _g1(chrp, safe)
        h00_wloc = _g1(wloc, safe)

    # per-read totals (saturated; anything >= CANDS triggers retry anyway)
    rstart = starts.reshape(B, NB)[:, 0]
    rend = jnp.concatenate([rstart[1:], total_all[None]])
    totals = rend - rstart
    if ax:
        # ok only when EVERY device's stripe of the read fit its capacity;
        # big when any single device overflowed alone
        ok_all = jax.lax.psum((rend > CANDS).astype(jnp.int32), ax) == 0
        big_any = jax.lax.psum((totals > CANDS).astype(jnp.int32), ax) > 0
        totals = jax.lax.psum(totals, ax)
    else:
        ok_all = rend <= CANDS
        big_any = totals > CANDS

    if cfg.lean:
        # SAM fast path: everything the formatter needs in 12 bytes/read
        # (BIT_* layout below).  ok/overflow bits are computed on device;
        # column 2 carries the full-rank candidate total so the host can
        # bin-pack any re-dispatch exactly.
        multi = ssum != 1
        if cfg.fixed:
            # under the fixed schedule, the committed result must be
            # schedule-independent: multi-hit reads (selection order) and
            # any read whose enumerated-candidate count could let the
            # reference's max_num_hits cap fire (align.cpp:211) re-dispatch
            # on the exact-schedule program (the host treats this bit as
            # "needs exact", not as a replay)
            multi = multi | (totals >= cfg.max_num_hits)
        w1 = (found.astype(jnp.int32)
              | (sel_chain << 1)
              | (replay.astype(jnp.int32) << 2)
              | (ok_all.astype(jnp.int32) << 3)
              | (big_any.astype(jnp.int32) << 4)
              | (multi.astype(jnp.int32) << 5)
              | (ii << 6)
              | (sel_chrp << 10)
              | (resolved.astype(jnp.int32) << 26))
        return jnp.stack([sel_wloc, w1, ftot], axis=1)

    hit_cols = []
    if cfg.hits_k:
        # compacted per-read hit list (discovery order): wloc + packed
        # (wmm 4b | chain<<4 | seg-rank<<5 | chrp<<9); reads with more than
        # K accepted hits raise the replay bit (exact host fallback).
        # Under index sharding each hit's slot is its GLOBAL discovery rank
        # and the lists psum-merge exactly (each hit is owned by exactly
        # one region shard, so slots are disjoint across devices).
        K = cfg.hits_k
        acc_i = accepted.astype(jnp.int32)
        if ax:
            hrank = global_rank_of(accepted) - 1      # 0-based within read
        else:
            hcs = jnp.cumsum(acc_i)
            read_start = _g1(starts, rid * NB)
            hbase = jnp.where(read_start > 0,
                              _g1(hcs, jnp.clip(read_start - 1, 0,
                                                CANDS - 1)), 0)
            hrank = hcs - hbase - 1                   # 0-based within read
        tgt = jnp.where(accepted & (hrank < K), rid * K + hrank, B * K)
        hw1 = wmm | (chain << 4) | (rank << 5) | (chrp << 9)
        hits_loc = jnp.zeros((B * K + 1,), jnp.int32).at[tgt].set(
            wloc, mode="drop").at[B * K].set(0)[: B * K].reshape(B, K)
        hits_w1 = jnp.zeros((B * K + 1,), jnp.int32).at[tgt].set(
            hw1 + 1, mode="drop")[: B * K].reshape(B, K)
        nacc = jnp.zeros((B,), jnp.int32).at[rid].add(acc_i)
        if ax:
            hits_loc = jax.lax.psum(hits_loc, ax)
            hits_w1 = jax.lax.psum(hits_w1, ax)
            nacc = jax.lax.psum(nacc, ax)
        hits_w1 = hits_w1 - 1                         # empty slots -> -1
        replay = replay | (nacc > K)
        hit_cols = [hits_loc, hits_w1]

    # one packed int32 output array -> a single device-to-host transfer
    extras = jnp.stack(
        [found.astype(jnp.int32), ii, ssum, sel_chain, sel_chrp, sel_wloc,
         h00_found.astype(jnp.int32), h00_chrp, h00_wloc,
         replay.astype(jnp.int32), totals, s_off, c_off,
         ok_all.astype(jnp.int32),
         big_any.astype(jnp.int32),
         resolved.astype(jnp.int32), ftot], axis=1)
    return jnp.concatenate([counts.reshape(B, 2 * MS), extras] + hit_cols,
                           axis=1)


N_EXTRAS = 17
(X_FOUND, X_II, X_SSUM, X_CHAIN, X_CHRP, X_WLOC, X_H00F, X_H00C, X_H00W,
 X_REPLAY, X_TOTAL, X_SOFF, X_COFF, X_OK, X_BIG, X_RESOLVED,
 X_FTOT) = range(N_EXTRAS)

# lean row bit layout (word 1; word 0 = watson loc), shared with the native
# formatter (bsmap_native.cpp)
BIT_FOUND, BIT_CHAIN, BIT_REPLAY, BIT_OK, BIT_BIG, BIT_MULTI = (
    1, 2, 4, 8, 16, 32)
LEAN_II_SHIFT, LEAN_CHRP_SHIFT = 6, 10
BIT_RESOLVED = 1 << 26


# packed input row (one H2D transfer per dispatch): int32 columns
# [qwords (2-bit packed read, FIXELEMENT) | rwords (valid-mask lanes) |
#  len | budget | rand32 | maxrank] — 96 B/read at FIXELEMENT=10, and the
# words are already in the layout the verify stage consumes (no device-side
# per-base unpack or repack).
ROW_I32 = 2 * FIXELEMENT + 4
ROW_BYTES = 4 * ROW_I32
SC_LEN, SC_BUD, SC_RAND, SC_RANK = (2 * FIXELEMENT, 2 * FIXELEMENT + 1,
                                    2 * FIXELEMENT + 2, 2 * FIXELEMENT + 3)


def pack_words_np(codes_or_regs: np.ndarray) -> np.ndarray:
    """(B, FIXSIZE) uint8 -> (B, FIXELEMENT) uint32 words, first base in the
    top bits of each word (dbseq.cpp:71-75 layout)."""
    B = codes_or_regs.shape[0]
    lanes = codes_or_regs.reshape(B, FIXELEMENT, SEGLEN).astype(np.uint32)
    shifts = (np.arange(SEGLEN - 1, -1, -1, dtype=np.uint32) * 2)
    return (lanes << shifts[None, None, :]).sum(axis=-1, dtype=np.uint32)


def _pack_inputs(codes, regs, lens, buds, rand32, maxrank):
    """(B, ROW_I32) int32 dispatch rows from per-base codes/regs."""
    B = len(lens)
    buf = np.empty((B, ROW_I32), dtype=np.int32)
    buf[:, :FIXELEMENT] = pack_words_np(codes).view(np.int32)
    buf[:, FIXELEMENT: 2 * FIXELEMENT] = pack_words_np(regs).view(np.int32)
    buf[:, SC_LEN] = lens
    buf[:, SC_BUD] = buds
    buf[:, SC_RAND] = rand32.astype(np.uint32).view(np.int32)
    buf[:, SC_RANK] = maxrank
    return buf


def _unpack_inputs(packed):
    nw = (packed.shape[1] - 4) // 2
    qw = jax.lax.bitcast_convert_type(packed[:, :nw], jnp.uint32)
    rw = jax.lax.bitcast_convert_type(packed[:, nw: 2 * nw], jnp.uint32)
    lens = packed[:, 2 * nw]
    buds = packed[:, 2 * nw + 1]
    rand32 = jax.lax.bitcast_convert_type(packed[:, 2 * nw + 2], jnp.uint32)
    maxrank = packed[:, 2 * nw + 3]
    return qw, rw, lens, buds, rand32, maxrank


@functools.partial(jax.jit, static_argnames=("cfg", "CANDS"))
def _align_fused_kernel(cfg: Cfg, CANDS: int, prof_a, d_kmer_tab,
                        rc_code, rc_n_code, d_catcat, d_anchors, d_sizes,
                        d_rcoff, d_wlocs, d_clocs, d_tags, d_sites,
                        d_site_off, d_tag_off, packed, bounds=None):
    """Single-dispatch chunk: schedule + verify fused.  Candidate capacity is
    fixed; reads whose candidates ran past it are detected from the returned
    ok/overflow bits and re-dispatched (or host-replayed when one read
    exceeds it)."""
    qw0, rw0, lens, budgets, rand32, maxrank = _unpack_inputs(packed)
    (qw, rw, h, off0, off3, wcnt, cnt, wantv, s_off, c_off,
     ftot_rank) = _schedule_impl(
        cfg, prof_a, d_kmer_tab, d_tag_off, rc_code, rc_n_code,
        qw0, rw0, lens, budgets, maxrank)
    if cfg.probe:
        # totals-only pre-pass: stage 1 alone; column r = candidates a
        # maxrank=r dispatch would enumerate (the bin-packing input)
        if cfg.shard_axis:
            ftot_rank = jax.lax.pmax(ftot_rank, cfg.shard_axis)
        return ftot_rank
    return _verify_impl(cfg, CANDS, d_catcat, d_anchors, d_sizes, d_rcoff,
                        d_wlocs, d_clocs, d_tags, d_sites, d_site_off,
                        qw, rw, lens, budgets, rand32, maxrank, h,
                        off0, off3, wcnt, cnt, wantv, s_off, c_off,
                        ftot_rank[:, -1], bounds=bounds)


# ---------------------------------------------------------------------------
# engine front-end
# ---------------------------------------------------------------------------

class DeviceEngine:
    def __init__(self, genome: PackedGenome, index: SeedIndex, param: Param):
        # -S 0 (the reference default): selection draws a sequential glibc
        # rand_r per FOUND read (align.cpp:623-625).  Unique reads are
        # rand-independent (j = draw % 1), so the kernel runs with
        # rand32 = 0, the formatter keeps the stream position, and only
        # genuinely multi-hit reads replay on the exact host engine.
        self.genome = genome
        self.index = index
        self.param = param
        if param.profile is None:
            param.init_mapping()
        self.host = HostEngine(genome, index, param)  # exact replay path

        W = len(genome.refcat)
        # Per-strand uint32 coordinates: each strand's catcat and locs array
        # is separate, so genomes up to ~4.2 Gb (hg38 4-strand included) fit
        # 32-bit math on a single device.  Larger genomes need the region-
        # sharded mesh path.
        if int(genome.anchors[-1]) >= 2 ** 32 - (FIXSIZE + SEGLEN) \
                or genome.n_chr >= 1 << 15:
            raise EngineUnsupported("genome exceeds 32-bit per-strand "
                                    "coordinates; shard across devices")
        self.W = W
        dev = jax.local_devices()[0]
        put = functools.partial(jax.device_put, device=dev)
        self.d_catcat = put(jnp.asarray(
            np.concatenate([genome.refcat, genome.crefcat]),
            dtype=jnp.uint32))
        self.d_anchors = put(jnp.asarray(
            genome.anchors[:genome.n_chr].astype(np.uint32)))
        self.d_sizes = put(jnp.asarray(genome.sizes, dtype=jnp.int32))
        self.d_rcoff = put(jnp.asarray(genome.rc_offsets, dtype=jnp.int32))
        tk = index.total_kmers
        counts = np.diff(index.offsets)
        one = np.zeros(1, dtype=np.uint32)      # keep gathers well-defined
        if param.RRBS_flag:
            # RRBS CSR, TAG-PARTITIONED: site-anchored seeds concentrate
            # into few buckets (every j=0 seed starts at a digestion site),
            # so scanning whole buckets and filtering by tag (the
            # reference's loop, align.cpp:183-196) enumerates mostly
            # foreign entries.  Entries are reordered by (seed, tag-class,
            # original bucket position) — tag-class = 2*segment + rc — with
            # a (3^S * J2 + 1) offset table, so each probe enumerates
            # EXACTLY its own (segment, strand) entries; within a class the
            # original bucket order is preserved, so discovery order (and
            # the filtered sequence the reference would see) is unchanged.
            kmer_tab = np.zeros((tk, 4), dtype=np.int32)
            kmer_tab[:, 0] = index.offsets[:-1]
            kmer_tab[:, 1] = counts          # RAW size: schedule cost parity
            self.d_kmer_tab = put(jnp.asarray(kmer_tab))
            J2 = 2 * param.max_seedseg_num
            self._rrbs_j2 = J2
            if len(index.locs):
                tags_u = index.tags.astype(np.uint32)
                cls = (((tags_u >> 16) & 0xFF) * 2
                       + ((tags_u >> 24) & 1)).astype(np.int64)
                bucket_id = np.repeat(np.arange(tk, dtype=np.int64),
                                      counts)
                order = np.lexsort(
                    (np.arange(len(cls)), cls, bucket_id))
                locs_t = index.locs[order]
                tags_t = tags_u[order].astype(np.int64).astype(np.int32)
                key2 = bucket_id[order] * J2 + cls[order]
                tag_off = np.zeros(tk * J2 + 1, dtype=np.int32)
                tag_off[1:] = np.cumsum(
                    np.bincount(key2, minlength=tk * J2)).astype(np.int32)
                self.d_wlocs = put(jnp.asarray(locs_t))
                self.d_tags = put(jnp.asarray(tags_t))
                self.d_tag_off = put(jnp.asarray(tag_off))
            else:
                self.d_wlocs = put(jnp.asarray(one))
                self.d_tags = put(jnp.asarray(one.astype(np.int32)))
                self.d_tag_off = put(jnp.asarray(
                    np.zeros(tk * J2 + 1, dtype=np.int32)))
            self.d_clocs = put(jnp.asarray(one))
            site_off = np.zeros(genome.n_chr + 1, dtype=np.int32)
            np.cumsum([len(s) for s in genome.ccgg_sites], out=site_off[1:])
            sites_g = (np.concatenate(
                [s + genome.anchors[c]
                 for c, s in enumerate(genome.ccgg_sites)])
                if site_off[-1] else one.astype(np.int64))
            self.d_sites = put(jnp.asarray(sites_g.astype(np.uint32)))
            self.d_site_off = put(jnp.asarray(site_off))
        else:
            # per-bucket row [watson_off, total_count, watson_count,
            # crick_off]: one 16B gather per seed position in the
            # scheduler; Watson and Crick entries live in separate arrays
            # so each stays < 2^31 long
            wc = index.wcounts.astype(np.int64)
            cc = counts - wc
            kmer_tab = np.zeros((tk, 4), dtype=np.int32)
            kmer_tab[:, 1] = counts
            kmer_tab[:, 2] = wc
            np.cumsum(wc[:-1], out=kmer_tab[1:, 0])
            np.cumsum(cc[:-1], out=kmer_tab[1:, 3])
            self.d_kmer_tab = put(jnp.asarray(kmer_tab))
            # split locs by strand, preserving in-bucket order (interval-
            # mask via a +1/-1 diff array: bounded running sum, no loop)
            total = len(index.locs)
            diff = np.zeros(total + 1, dtype=np.int8)
            nz = wc > 0
            np.add.at(diff, index.offsets[:-1][nz], 1)
            np.add.at(diff, (index.offsets[:-1] + wc)[nz], -1)
            is_w = np.cumsum(diff[:total], dtype=np.int8) > 0
            wl = index.locs[is_w]
            cl = index.locs[~is_w]
            self.d_wlocs = put(jnp.asarray(wl if len(wl) else one))
            self.d_clocs = put(jnp.asarray(cl if len(cl) else one))
            self.d_tags = put(jnp.asarray(one.astype(np.int32)))
            self.d_tag_off = put(jnp.asarray(one.astype(np.int32)))
            self.d_sites = put(jnp.asarray(one))
            self.d_site_off = put(jnp.asarray(
                np.zeros(genome.n_chr + 1, dtype=np.int32)))
        I = param.index_interval
        self.prof_a = put(jnp.asarray(
            [[param.profile[n][i].a for i in range(I)]
             for n in range(MAXSNPS + 1)], dtype=jnp.int32))
        rc = [int(param.alphabet[REV_CHAR[ord(param.useful_nt[c])]])
              for c in range(4)]
        self.rc_code = put(jnp.asarray(rc, dtype=jnp.uint8))
        self.rc_n_code = put(jnp.asarray(int(param.rev_alphabet[ord("N")]),
                                         dtype=jnp.uint8))
        self._rc_tuple = tuple(rc)
        self._rc_n_int = int(param.rev_alphabet[ord("N")])
        self.B = DEV_BATCH             # reads per device dispatch
        self._set_tiers(self.B)
        import threading
        self._execs: dict = {}         # (kernel, statics, width) -> Future
        self._execs_lock = threading.Lock()
        self._probe_ok = True          # subclasses whose dispatch wrapper
                                       # can't take the probe output disable
        self.n_filtered = 0
        self.n_replayed = 0
        self.n_dispatched = 0
        # wall-clock phase accumulators (printed by bench tooling): enqueue
        # = host side of dispatch (pad + transfer enqueue), collect = wait
        # for device rows
        self.t_enqueue = 0.0
        self.t_collect = 0.0
        self.t_h2d = 0.0        # host->device transfer enqueue inside dispatch
        self.t_call = 0.0       # executable call (dispatch proper)
        # MateState bookkeeping for stale-schedule reads (see module
        # docstring); lazily reconstructed from spans of device-handled reads
        self._maxseg = min(MAXSNPS, param.max_snp_num) + 1
        self._amax_cache: dict[int, int] = {}
        self._cmax_cache: dict[int, int] = {}
        # chromosome-name table for the native SAM block formatter
        name_bytes = [n.encode("latin1") for n in genome.names]
        self._chrname_buf = np.frombuffer(b"".join(name_bytes), dtype=np.uint8)
        self._chrname_off = np.zeros(len(name_bytes) + 1, dtype=np.int64)
        np.cumsum([len(b) for b in name_bytes], out=self._chrname_off[1:])
        # persistent context buffer for native XR/BSP formatting (the
        # reference's _mapseq is stateful across reads: align.h:132, and
        # its stale leading slots are visible when loc < 2)
        self._mapseq_buf = np.zeros(256, dtype=np.uint8)
        self._anchors_i64 = genome.anchors[: genome.n_chr].astype(np.int64)
        # chr-local digestion sites for the native ZP/ZL tags (dbseq.cpp:541)
        if param.RRBS_flag and genome.ccgg_sites is not None:
            so = np.zeros(genome.n_chr + 1, dtype=np.int64)
            np.cumsum([len(s) for s in genome.ccgg_sites], out=so[1:])
            self._sites_local = (np.concatenate(genome.ccgg_sites)
                                 .astype(np.int64) if so[-1]
                                 else np.zeros(1, np.int64))
            self._site_off_l = so
            self._rr_tail = len(param.digest_site) - 2 * param.digest_pos
        else:
            self._sites_local = np.zeros(1, np.int64)
            self._site_off_l = np.zeros(genome.n_chr + 1, np.int64)
            self._rr_tail = 0

    def _set_tiers(self, b: int) -> None:
        """Two candidate capacities only (each distinct capacity is a
        separate compiled program): a SMALL one for optimistic
        round-1 windows and a BIG one for exactly bin-packed re-dispatches.
        Kernel time is ~linear in capacity, so the big program amortizes
        its cost over a full load of packed candidates.

        RRBS gets ONE big tier: demand is structurally ~10-20 candidates
        per read even tag-partitioned (site-anchored seeds share sequence
        context), so a small round would overflow wholesale."""
        if self.param.RRBS_flag:
            cap = max(CANDS_BIG_PER_READ, CANDS_PER_READ) * b
            self.cands_tiers = [cap]
            self.CANDS = self.CANDS_BIG = cap
        else:
            mults = sorted({CANDS_PER_READ, max(CANDS_BIG_PER_READ,
                                                CANDS_PER_READ)})
            self.cands_tiers = [m * b for m in mults]
            self.CANDS = self.cands_tiers[0]
            self.CANDS_BIG = self.cands_tiers[-1]
        # probe mode (repeat-heavy genomes, self-tuned): round 1 becomes a
        # cheap stage-1-only totals pre-pass and ALL verify dispatches are
        # exactly bin-packed — no optimistic overflow rounds at all
        self.probe_mode = False
        self.n_probe = 0
        # progressive-sensitivity start rank: 0 = probe only the cheapest
        # segment first (most reads on clean data resolve there); bumped to
        # maxseg-1 (enumerate all segments in one pass) when a first round
        # leaves most reads rank-unresolved (error-rich reads escalate
        # anyway, and one wide dispatch beats several narrow ones)
        self.rank_start = 0

    def _cfg(self, chains_mode: str, lean: bool = False,
             nw: int = FIXELEMENT) -> Cfg:
        return make_cfg(self.param, self.W, self.genome.n_chr, chains_mode,
                        self._maxseg, lean=lean, nw=nw)

    def _chains_mode(self, rsets: np.ndarray) -> str:
        if self.param.chains:
            return "b"
        if (rsets == 2).all():
            return "r"
        if (rsets < 2).all():
            return "f"
        return "b"

    # -- stale-schedule (MateState) detection --------------------------------

    def _probe_amax(self, seedseg: int) -> int:
        """Max over (segment, phase) of profile.a - phase for the last
        segment: bounds how far probe positions reach past seedseg*S."""
        if seedseg not in self._amax_cache:
            p = self.param
            if seedseg <= 0:
                self._amax_cache[seedseg] = 0
            else:
                self._amax_cache[seedseg] = max(
                    p.profile[seedseg - 1][i].a - i
                    for i in range(p.index_interval))
        return self._amax_cache[seedseg]

    def _fx_eligible(self, lens: np.ndarray, budgets: np.ndarray) -> bool:
        """True when EVERY read supports the fixed-schedule fast path:
        full sensitivity (seedseg == budget+1, so the pigeonhole hit set is
        schedule-independent) and all offset-0 probes within the fresh seed
        range.  Short / partial-sensitivity reads keep the exact path."""
        p = self.param
        if p.RRBS_flag or len(lens) == 0:
            return False
        S, I = p.seed_size, p.index_interval
        lens = np.ascontiguousarray(lens, dtype=np.int64)
        seedseg = np.clip(np.minimum((lens - I + 1) // S, budgets + 1),
                          0, self._maxseg)
        full_sens = ((lens - I + 1) // S >= budgets + 1) & (seedseg >= 1)
        amax = np.array([self._probe_amax(int(m))
                         for m in range(self._maxseg + 1)], dtype=np.int64)
        return bool((full_sens & (amax[seedseg] <= lens - S)).all())

    def _stale_risk(self, lens: np.ndarray, budgets: np.ndarray) -> np.ndarray:
        """True for reads whose schedule may read stale per-instance state
        (previous reads' seed buffers / start offsets, align.cpp:454-469):
        max_offset == 0, or any probed / cost position can exceed len - S.
        RRBS never reads that state (fixed zero offsets, in-range probes)."""
        p = self.param
        if p.RRBS_flag:
            return np.zeros(len(lens), dtype=bool)
        S, I = p.seed_size, p.index_interval
        lens = np.ascontiguousarray(lens, dtype=np.int32)
        max_off = (lens - I + 1) % S
        seedseg = np.clip(np.minimum((lens - I + 1) // S, budgets + 1),
                          0, self._maxseg)
        amax = np.array([self._probe_amax(int(m))
                         for m in range(self._maxseg + 1)], dtype=np.int32)
        probe_max = amax[seedseg] + max_off
        cost_max = (seedseg - 1) * S + max_off + I - 1
        reach = np.maximum(probe_max, cost_max)
        return (max_off == 0) | (reach > lens - S)

    def _sync_state_span(self, read_of, lo: int, hi: int,
                         dev_soff, dev_coff, lens, replay_flag, mode: str,
                         state=None):
        """Apply the MateState effects of device-handled reads [lo, hi) (batch
        order) before a host replay that may read stale state.  Seed buffers:
        last-writer-wins backward fill; start offsets: last read with
        max_offset > 0 (align.cpp:458-468).  Replayed reads already updated
        the state through run_align, so only a *later* device-handled read
        may overwrite the offsets."""
        if hi <= lo:
            return
        p = self.param
        st = state if state is not None else self.host.mate_state
        S, I = p.seed_size, p.index_interval
        # start offsets: last preceding read with max_off > 0; skip if that
        # read was itself host-replayed (its run_align already set them)
        span_lens = lens[lo:hi]
        mo = (span_lens - I + 1) % S
        nz = np.nonzero(mo > 0)[0]
        offset_read = None
        if len(nz):
            k = lo + int(nz[-1])
            if not replay_flag[k]:
                if dev_soff is None:
                    # lean rows don't carry the chosen offsets; recompute
                    # them with the exact host schedule after the buffer
                    # fill below (no-risk reads read only fresh entries, so
                    # the recompute is deterministic)
                    offset_read = k
                else:
                    if mode in ("f", "b"):
                        st.seed_start_offset = int(dev_soff[k])
                    if mode in ("r", "b"):
                        st.cseed_start_offset = int(dev_coff[k])
        # seed buffers: walk backward, filling uncovered entries
        from .host_engine import fill_seed_buffers
        cover = max(0, int(lens[lo:hi].max()) - S + 1)
        fill_seed_buffers(p, st, read_of, lo, hi, cover)
        if offset_read is not None:
            rd = read_of(offset_read)
            self.host.sync_schedule(rd, int(
                (p.max_snp_num + 1) * (len(rd.seq) - 1) // len(rd.seq)),
                state=st)

    # -- batch orchestration -------------------------------------------------

    def _filter_batch(self, batch: list[Read], results):
        """Trim/filter; returns (live indices, budgets).  When no trimming is
        configured (no adapters, -q 0) the filter is pure arithmetic;
        otherwise per-read (FilterReads align.cpp:579-589)."""
        p = self.param
        live_idx, budgets = [], []
        if not p.adapters and p.qual_threshold == 0:
            for i, rd in enumerate(batch):
                L = len(rd.seq)
                rd.raw_len = L
                if L < p.min_read_size:
                    results[i] = SEResult(filtered=True)
                    continue
                sb = np.frombuffer(rd.seq.encode("latin1"), dtype=np.uint8)
                if int((REG_ALPHABET[sb] == 0).sum()) > p.max_ns:
                    results[i] = SEResult(filtered=True)
                    continue
                live_idx.append(i)
                budgets.append((p.max_snp_num + 1) * (L - 1) // L)
            self.n_filtered += len(batch) - len(live_idx)
            return live_idx, budgets
        for i, rd in enumerate(batch):
            filtered, budget = filter_read(rd, p)
            if filtered:
                results[i] = SEResult(filtered=True)
                self.n_filtered += 1
            else:
                live_idx.append(i)
                budgets.append(budget)
        return live_idx, budgets

    def _pack_host(self, batch, idxs, budgets):
        """Encode reads into padded fixed-shape numpy arrays (C11 analogue of
        ConvertBinaySeq's host half; the packing itself runs on device)."""
        p = self.param
        n = len(idxs)
        codes = np.zeros((n, FIXSIZE), dtype=np.uint8)
        regs = np.zeros((n, FIXSIZE), dtype=np.uint8)
        lens = np.zeros(n, dtype=np.int32)
        ridx = np.zeros(n, dtype=np.uint64)
        rsets = np.zeros(n, dtype=np.int32)
        buds = np.asarray(budgets, dtype=np.int32)
        seqs = [batch[i].seq for i in idxs]
        if n and len(set(map(len, seqs))) == 1:
            L = len(seqs[0])
            sb = np.frombuffer("".join(seqs).encode("latin1"),
                               dtype=np.uint8).reshape(n, L)
            codes[:, :L] = p.alphabet[sb]
            regs[:, :L] = REG_ALPHABET[sb]
            lens[:] = L
        else:
            for t, s in enumerate(seqs):
                sb = np.frombuffer(s.encode("latin1"), dtype=np.uint8)
                codes[t, :len(sb)] = p.alphabet[sb]
                regs[t, :len(sb)] = REG_ALPHABET[sb]
                lens[t] = len(sb)
        ridx[:] = [batch[i].index for i in idxs]
        rsets[:] = [batch[i].readset for i in idxs]
        return codes, regs, lens, buds, rsets, ridx

    # -- compiled programs ----------------------------------------------------
    # Each (kernel, statics, input width) compiles once per engine through
    # jit(...).lower(...).compile(), which XLA's persistent compilation cache
    # covers.  A compile blocks its caller, so the XLA compiles of distinct
    # programs run on concurrent threads; tracing runs one at a time.

    def _engine_args(self):
        return (self.prof_a, self.d_kmer_tab, self.rc_code,
                self.rc_n_code, self.d_catcat, self.d_anchors, self.d_sizes,
                self.d_rcoff, self.d_wlocs, self.d_clocs, self.d_tags,
                self.d_sites, self.d_site_off, self.d_tag_off)

    def _lower(self, kernel, statics: tuple, width: int, n_packed: int = 1):
        sd = jax.ShapeDtypeStruct
        specs = tuple(sd(a.shape, a.dtype) for a in self._engine_args())
        specs += (sd((self.B, width), jnp.int32),) * n_packed
        return kernel.lower(*statics, *specs)

    def _compiled(self, kernel, statics: tuple, width: int,
                  n_packed: int = 1, lowered=None):
        """Executable of ``kernel(*statics, *engine args, *packed)`` for
        n_packed (B, width) int32 windows; compiles on first use (from
        ``lowered`` when the caller already traced it).  Thread-safe:
        concurrent callers of one key wait for one compile."""
        from concurrent.futures import Future
        key = (kernel, statics, width)
        with self._execs_lock:
            fut = self._execs.get(key)
            mine = fut is None
            if mine:
                fut = Future()
                self._execs[key] = fut
        if mine:
            try:
                if lowered is None:
                    lowered = self._lower(kernel, statics, width, n_packed)
                fut.set_result(lowered.compile())
            except BaseException as e:  # let waiters fail too, allow retry
                fut.set_exception(e)
                with self._execs_lock:
                    self._execs.pop(key, None)
                raise
        return fut.result()

    def _compile_all(self, jobs) -> None:
        """Compile every ``(kernel, statics, width, n_packed)`` job and wait
        for all (a failure raises).  New jobs are traced one at a time
        (tracing holds the GIL) and their XLA compiles run concurrently."""
        todo = [j for j in jobs if (j[0], j[1], j[2]) not in self._execs]
        if len(todo) > 1:
            import concurrent.futures as cf
            lowered = [self._lower(*j) for j in todo]
            with cf.ThreadPoolExecutor(max_workers=len(todo)) as ex:
                futs = [ex.submit(self._compiled, *j, low)
                        for j, low in zip(todo, lowered)]
            for f in futs:
                f.result()
        for j in jobs:
            self._compiled(*j)

    def _get_exec(self, cfg: Cfg, cap: int, width: int):
        return self._compiled(_align_fused_kernel, (cfg, cap), width)

    def _programs(self, cfg: Cfg) -> list:
        """Every (cfg, capacity) a batch of this config may dispatch: both
        capacity tiers, the fixed-schedule round (lean SAM) and the totals
        probe (repeat-heavy genomes; never for RRBS or PE)."""
        progs = [(cfg, cap) for cap in self.cands_tiers]
        if cfg.lean and not cfg.rrbs:
            progs.append((cfg._replace(fixed=True), self.CANDS))
        if self._probe_ok and not (cfg.rrbs or cfg.pe):
            progs.append((cfg._replace(probe=True, lean=False, hits_k=0), 1))
        return progs

    def _compile_programs(self, cfg: Cfg, width: int) -> list:
        """Compile (concurrently, once) every program of this config before
        its first dispatch, so no compile lands mid-run; returns them."""
        if type(self)._dispatch is not DeviceEngine._dispatch:
            return []   # subclasses with their own dispatch keep the jit path
        progs = self._programs(cfg)
        self._compile_all([(_align_fused_kernel, pr, width, 1)
                           for pr in progs])
        return progs

    def _dispatch(self, cfg: Cfg, packed, cands: int | None = None):
        """One async kernel dispatch on a packed (B, ROW_I32) window."""
        cap = self.CANDS if cands is None else cands
        exe = self._get_exec(cfg, cap, packed.shape[1])
        t0 = _time.time()
        dev = jnp.asarray(packed)
        self.t_h2d += _time.time() - t0
        t0 = _time.time()
        out = exe(*self._engine_args(), dev)
        self.t_call += _time.time() - t0
        return out

    def warmup_programs(self, chains_mode: str = "f", nw: int = 7,
                        lean: bool = True) -> None:
        """Compile every program a run of this shape may touch (see
        _programs) concurrently, then execute each once on a zero window."""
        width = 2 * nw + 4
        progs = self._compile_programs(
            self._cfg(chains_mode, lean=lean, nw=nw), width)
        z = np.zeros((self.B, width), dtype=np.int32)
        z[:, width - 4] = min(100, 16 * nw)   # plausible read length
        z[:, width - 3] = min(self.param.max_snp_num, MAXSNPS)
        jax.block_until_ready([self._dispatch(c, z, cap) for c, cap in progs])

    def _pad_rows(self, rows, sel, ranks=None):
        """Zero-padded (B, row_width) window of dispatch rows `sel`, with
        the per-read enumeration rank written into the maxrank column."""
        m = len(sel)
        width = rows.shape[1]
        out = np.zeros((self.B, width), dtype=np.int32)
        s0 = int(sel[0]) if m else 0
        if m and int(sel[-1]) - s0 + 1 == m:
            out[:m] = rows[s0: s0 + m]          # contiguous: slice copy
        else:
            np.take(rows, sel, axis=0, out=out[:m])
        out[:m, width - 1] = (self._maxseg - 1 if ranks is None
                              else ranks[sel])
        return out

    def _pad_window(self, arrs, sel, ranks=None):
        """Compat wrapper over per-base arrays (codes, regs, lens, buds,
        rand32): pack rows `sel` into one zero-padded transfer buffer."""
        codes, regs, lens, buds, rand32 = arrs
        if ranks is None:
            ranks = np.full(len(lens), self._maxseg - 1, np.int32)
        out = np.zeros((self.B, ROW_I32), dtype=np.int32)
        out[: len(sel)] = _pack_inputs(codes[sel], regs[sel], lens[sel],
                                       buds[sel], rand32[sel], ranks[sel])
        return out

    def align_batch(self, batch: list[Read]):
        results: list = [None] * len(batch)
        live_idx, budgets = self._filter_batch(batch, results)
        n = len(live_idx)
        if n == 0:
            return results
        codes, regs, lens, buds, rsets, ridx = self._pack_host(
            batch, live_idx, budgets)
        rand32 = (np.zeros(n, np.uint32) if self.param.randseed == 0
                  else myrand_hash(ridx, self.param.randseed))
        cfg = self._cfg(self._chains_mode(rsets))
        rows = _pack_inputs(codes, regs, lens, buds, rand32,
                            np.zeros(n, np.int32))
        out_rows, replays = self._align_arrays(
            cfg, rows, lambda t: batch[live_idx[t]])
        for t, res in replays.items():
            results[live_idx[t]] = res
        MS = cfg.maxseg
        for t in range(n):
            if t not in replays:
                results[live_idx[t]] = DeviceView(out_rows[t], MS,
                                                  int(buds[t]))
        return results

    def _align_arrays(self, cfg: Cfg, rows, read_of, risk=None,
                      fx_ok: bool = False, defer: bool = False):
        """Core orchestration over pre-encoded live reads: windowed
        optimistic dispatches, overflow retry with candidate-capacity
        escalation, exact host replay with MateState maintenance.  ``rows``
        is the (n, ROW_I32) dispatch buffer (maxrank column ignored);
        ``read_of(t)`` lazily materializes live row t as a Read (only
        replays and state syncs need it).  Returns
        (out_rows, {row: SEResult for replayed rows})."""
        in_w = rows.shape[1]
        lens = rows[:, in_w - 4]
        buds = rows[:, in_w - 3]
        n = len(lens)
        if risk is None:
            risk = self._stale_risk(lens, buds)
        self._compile_programs(cfg, in_w)

        # results come back as packed int32 rows, one per live read
        MS = cfg.maxseg
        width = 3 if cfg.lean else 2 * MS + N_EXTRAS + 2 * cfg.hits_k
        out_rows = np.zeros((n, width), dtype=np.int32)
        done = np.zeros(n, dtype=bool)
        served = np.zeros(n, dtype=bool)         # enumerated within capacity
        ftot = np.zeros(n, dtype=np.int64)       # full-rank candidate totals
        full_rank = MS - 1
        FTOT_CLAMP = 1 << 27

        def mark_replay(sel):
            out_rows[sel] = 0
            if cfg.lean:
                out_rows[sel, 1] = BIT_REPLAY | BIT_RESOLVED
            else:
                out_rows[sel, 2 * MS + X_REPLAY] = 1

        def collect(sel, out, fx: bool = False):
            """Collect one dispatch; returns (#done, #ok-but-unresolved)."""
            t0 = _time.time()
            orows = np.asarray(out)[: len(sel)]
            self.t_collect += _time.time() - t0
            # a read's result is exact iff its whole candidate range fit in
            # the dispatch capacity (ok bit, computed on device)
            if cfg.lean:
                ok = (orows[:, 1] & BIT_OK) != 0
                res = (orows[:, 1] & BIT_RESOLVED) != 0
                ftot[sel] = orows[:, 2]
            else:
                ok = orows[:, 2 * MS + X_OK] != 0
                res = orows[:, 2 * MS + X_RESOLVED] != 0
                ftot[sel] = orows[:, 2 * MS + X_FTOT]
            fin = ok & res
            if fx:
                # fixed-schedule round: only schedule-independent results
                # commit; the rest re-dispatch on the exact program
                fin = fin & ((orows[:, 1] & BIT_MULTI) == 0)
            out_rows[sel[fin]] = orows[fin]
            done[sel[fin]] = True
            served[sel[ok]] = True
            return int(fin.sum()), int((ok & ~res).sum())

        # --- round 1: either optimistic full windows at the small capacity
        # (clean data: nearly every read finishes in one pass) or, in probe
        # mode (repeat-heavy genomes), a stage-1-only totals pre-pass -------
        probing = (self.probe_mode and self._probe_ok
                   and not (cfg.pe or cfg.rrbs))
        init_rank = full_rank if (cfg.pe or cfg.rrbs) \
            else min(self.rank_start, full_rank)
        cap_max = min(self.CANDS_BIG, FTOT_CLAMP - 1)

        def dispatch_packs(rem, demand, maxrank, collect_now=True):
            """Exactly bin-packed dispatches over reads `rem` (batch order)
            whose per-read candidate demand at this maxrank is `demand`.
            With collect_now=False the dispatches are only enqueued and the
            pending list is returned (deferred-collection pipelining)."""
            d = np.maximum(np.asarray(demand, dtype=np.int64), 1)
            csum = np.cumsum(d)
            spans = []
            s = 0
            base = 0
            for k in range(len(rem)):
                if k - s == self.B or csum[k] - base > self.CANDS_BIG:
                    spans.append((s, k))
                    s = k
                    base = csum[k - 1]
            spans.append((s, len(rem)))
            pend = []
            t0 = _time.time()
            ranks = np.full(n, maxrank, dtype=np.int32)
            for a, b in spans:
                sel = rem[a: b]
                mass = int(csum[b - 1] - (csum[a - 1] if a else 0))
                cap = self.CANDS if mass <= self.CANDS else self.CANDS_BIG
                out = self._dispatch(cfg, self._pad_rows(rows, sel, ranks),
                                     cap)
                pend.append((sel, out))
                self.n_dispatched += 1
            self.t_enqueue += _time.time() - t0
            if not collect_now:
                return pend
            nd = ne = 0
            t0 = _time.time()
            arrs = jax.device_get([o for _, o in pend])
            self.t_collect += _time.time() - t0
            for (sel, _), arr in zip(pend, arrs):
                d_, e_ = collect(sel, arr)
                nd += d_
                ne += e_
            return nd, ne

        def probe_enqueue(rem):
            """Enqueue the stage-1-only totals pre-pass over reads `rem`."""
            pend = []
            t0 = _time.time()
            pcfg = cfg._replace(probe=True, lean=False, hits_k=0)
            for i in range(0, len(rem), self.B):
                sel = rem[i: i + self.B]
                out = self._dispatch(pcfg, self._pad_rows(rows, sel, None),
                                     1)
                pend.append((i, sel, out))
                self.n_probe += 1
            self.t_enqueue += _time.time() - t0
            return pend

        def probe_collect(pendp, nrem):
            """(nrem, maxseg) per-rank cumulative candidate totals."""
            ftr = np.zeros((nrem, MS), dtype=np.int64)
            t0 = _time.time()
            arrs = jax.device_get([o for _, _, o in pendp])
            for (i, sel, _), arr in zip(pendp, arrs):
                ftr[i: i + len(sel)] = arr[: len(sel)]
            self.t_collect += _time.time() - t0
            return ftr

        def probe_rank_totals(rem):
            return probe_collect(probe_enqueue(rem), len(rem))

        def packed_rank_rounds(rem, ftr):
            """Round A at the progressive start rank (most reads resolve at
            the cheapest segment, align.cpp:445-449), exactly packed; the
            full-rank round 2 below picks up whatever escalates."""
            nonlocal n_done, n_esc
            ftot[rem] = ftr[:, -1]
            too_big = rem[ftr[:, init_rank] >= cap_max]
            if len(too_big):
                mark_replay(too_big)
                done[too_big] = True
            live = ~done[rem]
            rem = rem[live]
            if len(rem):
                d, e = dispatch_packs(rem, ftr[live, init_rank], init_rank)
                n_done += d
                n_esc += e

        n_done = n_esc = 0
        n_win = (n + self.B - 1) // self.B
        pend1 = pendp = rem0 = None
        if probing:
            rem0 = np.arange(n, dtype=np.int64)
            pendp = probe_enqueue(rem0)
        else:
            pend1 = []
            t0 = _time.time()
            # fixed-schedule fast path for the bulk round: ~5x cheaper
            # stage 1; multi-hit / capped reads re-dispatch exactly below
            rcfg = cfg._replace(fixed=True) if fx_ok else cfg
            ranks = np.full(n, init_rank, dtype=np.int32)
            for i in range(0, n, self.B):
                sel = np.arange(i, min(i + self.B, n), dtype=np.int64)
                out = self._dispatch(rcfg, self._pad_rows(rows, sel, ranks),
                                     self.CANDS)
                pend1.append((sel, out))
                self.n_dispatched += 1
            self.t_enqueue += _time.time() - t0

        def complete_rounds():
            """Round-1 collection (+ probe packing + self-tuning) and the
            round-2 full-rank dispatch; returns round 2's pending
            dispatches for finish() to collect."""
            nonlocal n_done, n_esc
            if probing:
                ftr = probe_collect(pendp, n)
                if ftr[:, -1].sum() < n_win * self.CANDS // 2:
                    self.probe_mode = False      # genome turned out clean
                packed_rank_rounds(rem0, ftr)
            else:
                t0 = _time.time()
                arrs = jax.device_get([o for _, o in pend1])
                self.t_collect += _time.time() - t0
                for (sel, _), arr in zip(pend1, arrs):
                    d, e = collect(sel, arr, fx=fx_ok)
                    n_done += d
                    n_esc += e
                if n:
                    rem_mass = int(ftot[~done].sum())
                    if rem_mass > 2 * n_win * self.CANDS and self._probe_ok:
                        # most of the demand overflowed the optimistic
                        # round: repeat-heavy genome — switch to probe +
                        # exact packing, for THIS call's leftovers too (a
                        # repeat-heavy first block otherwise pays a
                        # full-rank packed sweep)
                        self.probe_mode = True
                        # only reads whose enumeration overflowed: already-
                        # served rank-escapees go straight to round 2
                        rem = np.nonzero(~done & ~served)[0]
                        if len(rem) and not (cfg.pe or cfg.rrbs):
                            packed_rank_rounds(rem, probe_rank_totals(rem))

            # self-tuning (future calls): when rank escalation dominates,
            # start at full enumeration instead of paying the extra round
            if n and init_rank < full_rank and n_done + n_esc > 0 \
                    and n_esc > n_done:
                self.rank_start = full_rank

            # round 2: everything unresolved re-dispatches ONCE at full
            # rank (always exact: the kernel applies the progressive-
            # sensitivity semantics internally), exactly bin-packed
            rem = np.nonzero(~done)[0]
            if len(rem):
                too_big = rem[ftot[rem] >= cap_max]
                if len(too_big):
                    # one read exceeding the big capacity: exact host replay
                    mark_replay(too_big)
                    done[too_big] = True
                    rem = rem[ftot[rem] < cap_max]
            return (dispatch_packs(rem, ftot[rem], full_rank,
                                   collect_now=False) if len(rem) else [])

        # Round-1 collection and the round-2 dispatch run here, in the
        # calling (align) thread; only round 2's collection and the host
        # replays are deferred to finish(), which the block pipeline runs in
        # its writer thread.  This split is not measured on the H100.
        pend2 = complete_rounds()

        def finish():
            t0 = _time.time()
            arrs2 = jax.device_get([o for _, o in pend2])
            self.t_collect += _time.time() - t0
            for (sel, _), arr in zip(pend2, arrs2):
                collect(sel, arr)
            left = np.nonzero(~done)[0]
            if len(left):      # defensive: packed dispatches always fit
                mark_replay(left)
                done[left] = True

            # --- in-order collection with exact MateState maintenance -------
            if cfg.lean:
                replay_flag = ((out_rows[:, 1] & BIT_REPLAY) != 0) | risk
                dev_soff = dev_coff = None
            else:
                replay_flag = (out_rows[:, 2 * MS + X_REPLAY] != 0) | risk
                dev_soff = out_rows[:, 2 * MS + X_SOFF]
                dev_coff = out_rows[:, 2 * MS + X_COFF]
            if self.param.randseed == 0:
                # -S 0: the kernel selected with rand32=0; only unique-hit
                # reads are draw-independent — multi-hit reads replay so the
                # formatter's sequential rand_r picks the real j-th hit
                if cfg.lean:
                    multi = (((out_rows[:, 1] & BIT_FOUND) != 0)
                             & ((out_rows[:, 1] & BIT_MULTI) != 0))
                else:
                    multi = ((out_rows[:, 2 * MS + X_FOUND] != 0)
                             & (out_rows[:, 2 * MS + X_SSUM] != 1))
                replay_flag = replay_flag | multi
            replay_pos = np.nonzero(replay_flag)[0]
            replays: dict[int, SEResult] = {}
            cursor = 0
            for rpos in replay_pos:
                rpos = int(rpos)
                if risk[rpos]:
                    # replay may READ stale state: sync it first
                    self._sync_state_span(read_of, cursor, rpos, dev_soff,
                                          dev_coff, lens, replay_flag,
                                          cfg.chains_mode)
                    cursor = rpos + 1   # run_align updates the state itself
                replays[rpos] = self.host.run_align(read_of(rpos),
                                                    int(buds[rpos]))
                self.n_replayed += 1
            # keep the state current through the batch tail: a LATER batch
            # may contain stale-schedule reads whose replay reads this state
            self._sync_state_span(read_of, cursor, n, dev_soff, dev_coff,
                                  lens, replay_flag, cfg.chains_mode)
            return out_rows, replays

        return finish if defer else finish()

    def format_batch(self, batch: list[Read], fmt) -> str:
        results = self.align_batch(batch)
        out = []
        for rd, res in zip(batch, results):
            if isinstance(res, DeviceView):
                out.append(fmt.emit_device(rd, res))
            else:
                out.append(fmt.string_align(rd, res))
        return "".join(out)

    # -- block fast path (no per-read Python objects) -------------------------

    def supports_blocks(self) -> bool:
        """Every SE configuration runs on the native block path now: SAM /
        BAM-bound SAM / BSP / -R, RRBS (native ZP/ZL + the rrbs kernel),
        and trimming (native FilterReads)."""
        from .. import native
        return native.get_lib() is not None

    def encode_block(self, block):
        """Native filter + encode for one ReadBlock; runs in the
        parse-ahead thread (the native calls release the GIL, so it
        overlaps the previous block's device time).  Caches and returns
        (nw, rows, info) on the block."""
        if block.enc is not None:
            return block.enc
        from .. import native
        p = self.param
        lib = native.get_lib()
        info = None
        if p.adapters or p.qual_threshold > 0:
            # native FilterReads: trims rec in place; the -z SAM rescale
            # quirk rewrites quality bytes, so the buffer is swapped for a
            # writable copy exactly when that branch can fire
            rescale = bool(p.out_sam and p.zero_qual != ord("!")
                           and p.qual_threshold > 0)
            if rescale:
                mbuf = np.frombuffer(bytearray(block.buf), dtype=np.uint8)
            else:
                mbuf = np.frombuffer(block.buf, dtype=np.uint8)
            info = native.filter_block(lib, mbuf, block.rec, p,
                                       block.synth_qual)
            if rescale:
                block.buf = mbuf.tobytes()
                if block.is_fasta:
                    # synthetic quality is rescaled too (align.cpp:63-67)
                    block.synth_qual = ord("!") + p.default_qual
        # word count per read: 7 covers reads <= 112 nt (25% less H2D and
        # 8 instead of 11 reference-word gathers in verify)
        max_len = int(block.rec[:, 3].max()) if len(block) else 0
        nw = 7 if min(max_len, p.max_readlen) <= 112 else FIXELEMENT
        rows = native.encode_block_words(
            lib, block.buf, block.rec, p.alphabet, REG_ALPHABET, nw)
        block.enc = (nw, rows, info)
        return block.enc

    def align_block(self, block):
        """Align one ReadBlock.  Returns (live_pos, finish, buds_all):
        round 1 is dispatched AND collected here, round 2 is dispatched but
        only collected by finish() — the block pipeline calls finish() from
        the writer thread, overlapping round-2 latency and the exact host
        replays with the next block's round 1.  finish() -> (rows, replays)
        where row t is block read live_pos[t] in the packed 3-int32 lean
        layout (BIT_*) and replays maps row -> exact SEResult; buds_all is
        each block read's post-trim mismatch budget (BSP histogram width)."""
        p = self.param
        n_all = len(block)
        buds_all = np.zeros(n_all, dtype=np.int32)
        nw, rows, info = self.encode_block(block)
        lens = rows[:, 2 * nw]
        if info is not None:
            live = info[:, 0] == 0
        else:
            ncnt = rows[:, 2 * nw + 3]   # encoder parks the N count here
            live = (lens >= p.min_read_size) & (ncnt <= p.max_ns)
        live_pos = np.nonzero(live)[0]
        self.n_filtered += len(block) - len(live_pos)
        n = len(live_pos)
        if n == 0:
            return (live_pos, lambda: (np.zeros((0, 3), np.int32), {}),
                    buds_all)
        rows_l = rows[live_pos]
        lens_l = rows_l[:, 2 * nw]
        if info is not None:
            buds = info[live_pos, 1].astype(np.int32)
        else:
            buds = ((p.max_snp_num + 1) * (lens_l - 1)
                    // lens_l).astype(np.int32)
        buds_all[live_pos] = buds
        rows_l[:, 2 * nw + 1] = buds
        rows_l[:, 2 * nw + 2] = (0 if p.randseed == 0 else myrand_hash(
            block.indices[live_pos], p.randseed).astype(np.uint32).view(
            np.int32))
        rows_l[:, 2 * nw + 3] = 0
        risk = self._stale_risk(lens_l, buds)
        # BSP needs the per-level histograms and XR reads the selection
        # context — both ride the FULL result rows; plain SAM uses lean rows
        plain_sam = p.out_sam >= 1 and not p.out_ref
        lean = plain_sam and not risk.any()
        cfg = self._cfg("b" if p.chains
                        else ("r" if block.readset == 2 else "f"), lean=lean,
                        nw=nw)
        # the fixed-schedule round needs lean rows (BIT_MULTI); engines
        # whose _cfg refuses lean rows keep the exact schedule
        fx_ok = cfg.lean and self._fx_eligible(lens_l, buds)
        fin = self._align_arrays(
            cfg, rows_l, lambda t: block.read_obj(int(live_pos[t])),
            risk=risk, fx_ok=fx_ok, defer=True)

        def finish():
            out_rows, replays = fin()
            if not cfg.lean and plain_sam:
                return _pack_rows_lean(out_rows, cfg.maxseg), replays
            return out_rows, replays

        return live_pos, finish, buds_all

    def format_block(self, block, fmt) -> bytes:
        """Align + format one ReadBlock as SAM bytes (see align_block /
        format_aligned_block, split so the block pipeline can format in the
        writer thread while the next block aligns)."""
        return self.format_aligned_block(block, self.align_block(block), fmt)

    def _select_vals(self, read, res, fmt):
        """string_align's selection half (align.cpp:610-627) without the
        formatting: first nonempty level, reproducible draw (consumed HERE,
        so the sequential -S 0 stream stays exact), selected hit."""
        from ..utils import myrand
        p = self.param
        ii = ssum = 0
        for ii in range(res.read_max_snp_num + 1):
            ssum = int(res.n_hit[ii] + res.n_chit[ii])
            if ssum > 0:
                break
        if ssum == 0:
            return (0, ii, 0, 0, 0, 0)
        j = myrand(read.index, p.randseed, fmt.rand_r) % ssum
        if j < res.n_hit[ii]:
            chain, hit = 0, res.hits[ii][j]
        else:
            chain, hit = 1, res.chits[ii][j - int(res.n_hit[ii])]
        return (1, ii, ssum, chain, int(hit[0]), int(hit[1]))

    def _format_block_full(self, block, aligned, fmt) -> bytes:
        """BSP / -R SAM native block formatting over FULL result rows.
        Host-replayed reads are not text-spliced: their selection runs in
        Python (drawing from the exact hit lists) and the result is
        synthesized into a row, so the stateful reference-context buffer
        (_mapseq stale slots) advances in one place — the native side."""
        from .. import native
        p = self.param
        lib = native.get_lib()
        live_pos, fin, buds_all = aligned
        out_rows, replays = fin()
        MS = self._maxseg
        width = 2 * MS + N_EXTRAS
        n_all = len(block)
        status = np.ones(n_all, dtype=np.int32)          # 1 = QC-filtered
        rows_all = np.zeros((n_all, width), dtype=np.int32)
        status[live_pos] = 2
        if len(live_pos):
            rows_all[live_pos] = out_rows[:, :width]
        rep = sorted((int(live_pos[t]), t) for t in replays)
        is_replay = np.zeros(n_all, dtype=bool)
        for pos, _ in rep:
            is_replay[pos] = True
        fcum = None
        if p.randseed == 0:
            found_dev = ((status == 2) & ~is_replay
                         & (rows_all[:, 2 * MS + X_FOUND] != 0))
            fcum = np.concatenate([[0], np.cumsum(found_dev)])
        prev = 0
        for pos, t in rep:
            if fcum is not None:
                fmt.rand_r.skip(int(fcum[pos] - fcum[prev]))
                prev = pos
            res = replays[t]
            found, ii, ssum, chain, chrp, wloc = self._select_vals(
                block.read_obj(pos), res, fmt)
            row = np.zeros(width, dtype=np.int32)
            row[0: 2 * MS: 2] = res.n_hit[:MS]
            row[1: 2 * MS: 2] = res.n_chit[:MS]
            ex = 2 * MS
            row[ex + X_FOUND] = found
            row[ex + X_II] = ii
            row[ex + X_SSUM] = ssum
            row[ex + X_CHAIN] = chain
            row[ex + X_CHRP] = chrp
            row[ex + X_WLOC] = wloc
            rows_all[pos] = row
        if fcum is not None:
            fmt.rand_r.skip(int(fcum[n_all] - fcum[prev]))
        un = self.param.useful_nt[:4].encode("latin1")
        total_codes = len(self.genome.refcat) * SEGLEN
        if p.out_sam >= 1:
            out, _lo, na = native.format_sam_block_xr(
                lib, block.buf, block.rec, status,
                _pack_rows_lean(rows_all, MS)[:, :2],
                self._chrname_buf, self._chrname_off, REV_CHAR,
                0x40 * block.readset, bool(p.out_unmap),
                p.report_repeat_hits, block.synth_qual,
                self.genome.refcat, total_codes, self._anchors_i64, un,
                self._mapseq_buf, int(p.RRBS_flag), self._sites_local,
                self._site_off_l, self._rr_tail)
        else:
            out, _lo, na = native.format_bsp_block(
                lib, block.buf, block.rec, status, rows_all, MS,
                self._chrname_buf, self._chrname_off, REV_CHAR,
                bool(p.out_unmap), p.report_repeat_hits, p.max_snp_num,
                p.max_num_hits, block.synth_qual,
                self.genome.refcat, total_codes, self._anchors_i64, un,
                self._mapseq_buf, buds_all)
        fmt.n_aligned += na
        return out

    def format_aligned_block(self, block, aligned, fmt):
        """Format one aligned ReadBlock as SAM bytes via the native
        formatter; replayed reads are formatted exactly in Python and
        spliced back in order.  SAM-only: the BSP stale-hits[0][0] leak
        (output/sam.py) never affects SAM lines, so device rows are
        order-free here."""
        from .. import native
        p = self.param
        if p.out_sam == 0 or p.out_ref:
            return self._format_block_full(block, aligned, fmt)
        lib = native.get_lib()
        live_pos, fin, _buds_all = aligned
        out_rows, replays = fin()
        n_all = len(block)
        status = np.ones(n_all, dtype=np.int32)          # 1 = QC-filtered
        rows_all = np.zeros((n_all, 2), dtype=np.int32)
        status[live_pos] = 2
        rows_all[live_pos] = out_rows[:, :2]
        replay_pos = sorted(int(live_pos[t]) for t in replays)
        rmap = {int(live_pos[t]): t for t in replays}
        status[replay_pos] = 0                           # Python-formatted
        out, line_off, na = native.format_sam_block(
            lib, block.buf, block.rec, status, rows_all,
            self._chrname_buf, self._chrname_off, REV_CHAR,
            0x40 * block.readset, bool(p.out_unmap), p.report_repeat_hits,
            block.synth_qual, int(p.RRBS_flag), self._sites_local,
            self._site_off_l, self._rr_tail)
        fmt.n_aligned += na
        fcum = None
        if p.randseed == 0:
            # -S 0: every found device-handled read consumed one rand_r
            # draw in the reference (align.cpp:623); keep the formatter's
            # sequential stream in sync so replayed multi-hit reads (which
            # draw inside string_align) get the exact draw
            found_dev = (status == 2) & ((rows_all[:, 1] & BIT_FOUND) != 0)
            fcum = np.concatenate([[0], np.cumsum(found_dev)])
        if not replay_pos:
            if fcum is not None:
                fmt.rand_r.skip(int(fcum[-1]))
            return out
        pieces, prev = [], 0
        prev_read = 0
        for i in replay_pos:
            cut = int(line_off[i])
            pieces.append(out[prev:cut])
            if fcum is not None:
                fmt.rand_r.skip(int(fcum[i] - fcum[prev_read]))
                prev_read = i + 1
            res = replays[rmap[i]]
            pieces.append(fmt.string_align(block.read_obj(i), res)
                          .encode("latin1"))
            prev = cut
        pieces.append(out[prev:])
        if fcum is not None:
            fmt.rand_r.skip(int(fcum[n_all] - fcum[prev_read]))
        return b"".join(pieces)


def _pack_rows_lean(rows: np.ndarray, maxseg: int) -> np.ndarray:
    """Repack full kernel rows into the lean 3-int32 layout (BIT_*) for the
    native SAM formatter."""
    ex = 2 * maxseg
    w1 = ((rows[:, ex + X_FOUND] != 0).astype(np.int32) * BIT_FOUND
          | (rows[:, ex + X_CHAIN] << 1)
          | (rows[:, ex + X_REPLAY] != 0).astype(np.int32) * BIT_REPLAY
          | BIT_OK
          | (rows[:, ex + X_SSUM] != 1).astype(np.int32) * BIT_MULTI
          | (rows[:, ex + X_II] << LEAN_II_SHIFT)
          | (rows[:, ex + X_CHRP] << LEAN_CHRP_SHIFT))
    return np.stack([rows[:, ex + X_WLOC], w1,
                     rows[:, ex + X_FTOT]], axis=1).astype(np.int32)


class DeviceView:
    """Per-read result of the device fast path, duck-typing the fields the
    output formatter needs (SEResult-compatible subset + preselected hit)."""

    filtered = False

    def __init__(self, row: np.ndarray, maxseg: int, budget: int):
        counts = row[: 2 * maxseg].reshape(maxseg, 2)
        ex = row[2 * maxseg:]
        # pad histograms to MAXSNPS+1 (BSP prints 0..read_max_snp_num)
        self.n_hit = np.zeros(MAXSNPS + 1, dtype=np.int32)
        self.n_chit = np.zeros(MAXSNPS + 1, dtype=np.int32)
        self.n_hit[:maxseg] = counts[:, 0]
        self.n_chit[:maxseg] = counts[:, 1]
        self.read_max_snp_num = budget
        self.found = bool(ex[X_FOUND])
        self.level = int(ex[X_II])
        self.ssum = int(ex[X_SSUM])
        self.chain = int(ex[X_CHAIN])
        self.hit = (int(ex[X_CHRP]), int(ex[X_WLOC]))
        self.h00_found = bool(ex[X_H00F])
        self.h00 = (int(ex[X_H00C]), int(ex[X_H00W]))
