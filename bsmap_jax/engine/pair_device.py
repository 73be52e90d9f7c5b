"""Vectorized pair-end engine (pairs.cpp rebuilt for the device fast path).

A batched reformulation of the reference's lockstep escalation
(pairs.cpp:137-190): because a hit with w mismatches discovered at segment
rank r is available for pairing at step i iff r <= i, and GetPairs at step i
sweeps exactly the (na, nb) combos with max(na, nb) == i, the winning step is

    i* = min over valid pairs of max(na, nb)   with rank_a, rank_b <= max(na, nb)

— a pure function of the COMPLETE per-mate hit enumerations.  So both mates
run the fused SE kernel once (cfg.pe: every segment, no early exit,
align.cpp:210's -r 0 abort disabled for PE) emitting compacted per-read hit
lists, and the pairing (eligibility, winning step/total, reference sweep
order, reproducible selection) is a vectorized K x K join on the host.

Unpaired-fallback selection is exact: the reference draws from per-level hit
lists SORTED by (chr, loc) (SortHits4PE runs every level for pairing,
pairs.cpp:163-168; the draw indexes the sorted lists at pairs.cpp:258-271),
so the per-mate pick is recomputed host-side from the K compacted hits in
sorted order — the kernel's discovery-order pick is only valid for SE.

Sequential corners are detected and the PAIR replayed on the exact host
engine (PairHostEngine), with MateState kept bit-exact per mate:
  * per-mate bucket-cap / snp_thres tightening (kernel replay bit),
  * > K accepted hits for a mate (kernel replay bit),
  * pairhits bucket reaching max_num_hits (sweep truncation, pairs.cpp:107),
  * stale seed-schedule reads (mixed/short lengths),
  * a filtered mate (the surviving mate then follows the SE early-exit
    semantics of run_align: pairs.cpp:206-212).

The BLOCK path (format_block_pair) is the native PE pipeline: chunked
native parse (blockio) -> native encode-to-rows -> two kernel dispatches ->
vectorized join -> native pair SAM formatter (bsmap_native.cpp
bsmap_format_pair_block), with only the rare replays touching Python.
"""

from __future__ import annotations

import os as _os
import time as _time

import numpy as np

from ..index import SeedIndex
from ..params import FIXELEMENT, MAXSNPS, Param, REG_ALPHABET, REV_CHAR
from ..readio import Read
from ..reference import PackedGenome
from ..utils import myrand_hash
from .device_engine import (DeviceEngine, EngineUnsupported, N_EXTRAS,
                            X_CHAIN, X_CHRP, X_FOUND, X_FTOT, X_II, X_OK,
                            X_REPLAY, X_SOFF, X_COFF, X_SSUM, X_WLOC,
                            _align_fused_kernel, _pack_inputs)
from .host_engine import SEResult
from .pair_host import PairHit, PairHostEngine, PairResult, fix_pair_read_name
from ..trim import filter_read

PAIR_HITS_K = int(_os.environ.get("BSMAP_JAX_PAIR_HITS_K", 16))
BIG = np.int32(0x3FFFFFFF)

# compact on-device-join row layout, int32 x 11 (44 B/pair, against
# 2 x 220 B/pair of full per-mate rows)
(J_ALOC, J_BLOC, J_INS, J_WLOC_A, J_WLOC_B, J_FTOT, J_PAIR, J_CHRS,
 J_MATE_A, J_MATE_B, J_FLAGS) = range(11)
JN_COLS = 11
# J_PAIR: paired(5b) | cnt<<5 (11b, clamped 2047) | chain<<16 | na<<17 (4b)
#         | nb<<21 (4b)
# J_CHRS: a_chr | b_chr<<16
# J_MATE_*: found | sch<<1 | ii<<2 (4b) | min(ssum,1023)<<6 | chrp<<16
# J_FLAGS: replay_a | replay_b<<1 | ok_both<<2 | cap_join<<3


def _device_pair_join(MS: int, K: int, min_ins: int, max_ins: int,
                      max_hits: int, rows_a, rows_b, la, lb,
                      buds_a, buds_b, rand_a, rand_b, ftot):
    """The K x K GetPairs join (pairs.cpp:34-135) + the SortHits4PE-sorted
    unpaired-fallback selection, ON DEVICE — a jnp port of `_join` /
    `_unpaired_sel` emitting the compact JN_COLS rows.  Runs inside the
    fused pair kernel so the per-mate hit lists never leave the device."""
    import jax
    import jax.numpy as jnp
    from .device_engine import (N_EXTRAS, X_FOUND, X_II, X_OK, X_REPLAY,
                                X_SSUM)

    B = rows_a.shape[0]
    base = 2 * MS + N_EXTRAS
    BIGJ = jnp.int32(0x3FFFFFFF)

    def unpack(rows):
        loc = rows[:, base: base + K]
        w1 = rows[:, base + K: base + 2 * K]
        v = w1 >= 0
        return (loc, w1 & 15, (w1 >> 4) & 1, (w1 >> 5) & 15,
                (w1 >> 9) & 0xFFFF, v)

    locA, wA, chA, rkA, cpA, vA = unpack(rows_a)
    locB, wB, chB, rkB, cpB, vB = unpack(rows_b)
    aloc = locA[:, :, None]
    bloc = locB[:, None, :]
    wa, wb = wA[:, :, None], wB[:, None, :]
    m = jnp.maximum(wa, wb)
    pchain = jnp.where(chA[:, :, None] == 0, 0, 1)
    chain_ok = (chA[:, :, None] ^ chB[:, None, :]) == 1
    same_chr = cpA[:, :, None] == cpB[:, None, :]
    avail = (rkA[:, :, None] <= m) & (rkB[:, None, :] <= m)
    odd = cpA[:, :, None] & 1
    a_end_form = odd != pchain
    ins = jnp.where(a_end_form, aloc + la[:, None, None] - bloc,
                    bloc + lb[:, None, None] - aloc)
    elig = (vA[:, :, None] & vB[:, None, :] & chain_ok & same_chr & avail
            & (wa <= buds_a[:, None, None]) & (wb <= buds_b[:, None, None])
            & (ins >= min_ins) & (ins <= max_ins))
    m_m = jnp.where(elig, m, BIGJ)
    i_star = m_m.min(axis=(1, 2))
    paired = i_star < BIGJ
    at_win = elig & (m == i_star[:, None, None])
    tot = wa + wb
    win_total = jnp.where(at_win, tot, BIGJ).min(axis=(1, 2))
    F = at_win & (tot == win_total[:, None, None])
    cnt = F.sum(axis=(1, 2))
    cap_join = cnt >= max_hits
    combo = jnp.where(wa == wb, 0,
                      jnp.where(wb < wa, 1 + 2 * wb, 2 + 2 * wa))

    def sorted_rank(loc, w, ch, cp, v):
        same = (v[:, :, None] & v[:, None, :]
                & (w[:, :, None] == w[:, None, :])
                & (ch[:, :, None] == ch[:, None, :]))
        less = ((cp[:, None, :] < cp[:, :, None])
                | ((cp[:, None, :] == cp[:, :, None])
                   & (loc[:, None, :] < loc[:, :, None])))
        return (same & less).sum(axis=2)

    raA = sorted_rank(locA, wA, chA, cpA, vA)
    raB = sorted_rank(locB, wB, chB, cpB, vB)
    # combo<=32 (6b) |pchain -> 7b, |raA (6b) -> 13b, |raB (6b) -> 19b,
    # |kidx (8b for K=16) -> 27b: fits int32
    key = ((((combo << 1) | pchain) << 6 | raA[:, :, None]) << 6) \
        | raB[:, None, :]
    kidx = jnp.arange(K * K, dtype=jnp.int32).reshape(1, K, K)
    keyp = jnp.where(F, (key << 8) | kidx, BIGJ).reshape(B, K * K)
    keyp = jnp.sort(keyp, axis=1)
    j = (rand_a % jnp.maximum(cnt, 1).astype(jnp.uint32)).astype(jnp.int32)
    selp = jnp.take_along_axis(keyp, j[:, None], axis=1)[:, 0]
    sel_kl = selp & 0xFF
    sel_k, sel_l = sel_kl // K, sel_kl % K
    r = jnp.arange(B)
    s_chain = jnp.where(paired, chA[r, sel_k], 0)
    s_na = wA[r, sel_k]
    s_nb = wB[r, sel_l]
    s_ins = jnp.where(paired, ins[r, sel_k, sel_l], 0)
    s_achr = cpA[r, sel_k]
    s_aloc = locA[r, sel_k]
    s_bchr = cpB[r, sel_l]
    s_bloc = locB[r, sel_l]

    def unpaired_sel(loc, w, ch, cp, v, rows, rand):
        ii = rows[:, 2 * MS + X_II]
        ssum = rows[:, 2 * MS + X_SSUM]
        best = v & (w == ii[:, None])
        kbig = jnp.int32(0x7FFFFFFF)
        k_ch = jnp.where(best, ch, kbig)
        k_cp = jnp.where(best, cp, kbig)
        k_lo = jnp.where(best, loc, kbig)
        order = jnp.lexsort((k_lo, k_cp, k_ch))          # (B, K)
        jj = (rand % jnp.maximum(ssum, 1).astype(jnp.uint32)) \
            .astype(jnp.int32)
        sel = jnp.take_along_axis(order, jj[:, None], axis=1)[:, 0]
        return (ch[r, sel], cp[r, sel], loc[r, sel], ii, ssum)

    sch_a, scp_a, swl_a, ii_a, ssum_a = unpaired_sel(
        locA, wA, chA, cpA, vA, rows_a, rand_a)
    sch_b, scp_b, swl_b, ii_b, ssum_b = unpaired_sel(
        locB, wB, chB, cpB, vB, rows_b, rand_b)

    def pack_mate(rows, sch, scp, swl, ii, ssum):
        fnd = (rows[:, 2 * MS + X_FOUND] != 0).astype(jnp.int32)
        return (fnd | (sch << 1) | (ii << 2)
                | (jnp.minimum(ssum, 1023) << 6) | (scp << 16))

    ok_both = ((rows_a[:, 2 * MS + X_OK] != 0)
               & (rows_b[:, 2 * MS + X_OK] != 0))
    flags = ((rows_a[:, 2 * MS + X_REPLAY] != 0).astype(jnp.int32)
             | ((rows_b[:, 2 * MS + X_REPLAY] != 0).astype(jnp.int32) << 1)
             | (ok_both.astype(jnp.int32) << 2)
             | (cap_join.astype(jnp.int32) << 3))
    jpair = (jnp.where(paired, i_star + 1, 0)
             | (jnp.minimum(cnt, 2047) << 5)
             | (s_chain << 16) | (s_na << 17) | (s_nb << 21))
    return jnp.stack([
        s_aloc, s_bloc, s_ins, swl_a, swl_b, ftot, jpair,
        s_achr | (s_bchr << 16),
        pack_mate(rows_a, sch_a, scp_a, swl_a, ii_a, ssum_a),
        pack_mate(rows_b, sch_b, scp_b, swl_b, ii_b, ssum_b),
        flags], axis=1)


class _SelList:
    """Stand-in for a per-level hit list when only the reproducibly-selected
    element will ever be indexed (string_align_unpair's myrand pick)."""

    def __init__(self, n: int, hit):
        self._n = n
        self._hit = hit

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, k):
        return self._hit


class PairSEView:
    """SEResult-compatible view of one mate's full kernel row (counts +
    the exact sorted-order selection), for the unpaired-fallback formatter.
    The hit-list views are built LAZILY: properly-paired pairs (the vast
    majority) never touch them, and eager construction measured 25 s per
    200k pairs."""

    filtered = False
    aborted_repeat = False
    __slots__ = ("n_hit", "n_chit", "read_max_snp_num", "_hit",
                 "_hits", "_chits")

    def __init__(self, row: np.ndarray, maxseg: int, budget: int, hit):
        counts = row[: 2 * maxseg].reshape(maxseg, 2)
        self.n_hit = np.zeros(MAXSNPS + 1, dtype=np.int64)
        self.n_chit = np.zeros(MAXSNPS + 1, dtype=np.int64)
        self.n_hit[:maxseg] = counts[:, 0]
        self.n_chit[:maxseg] = counts[:, 1]
        self.read_max_snp_num = budget
        # `hit` is the exact draw: the myrand-index-th entry of the
        # concatenated fwd-then-rc (chr, loc)-sorted best-level lists,
        # recomputed from the kernel's K compacted hits (_unpaired_sel)
        self._hit = hit
        self._hits = None
        self._chits = None

    @property
    def hits(self):
        if self._hits is None:
            self._hits = [_SelList(int(h), self._hit) for h in self.n_hit]
        return self._hits

    @property
    def chits(self):
        if self._chits is None:
            self._chits = [_SelList(int(h), self._hit) for h in self.n_chit]
        return self._chits


import functools as _functools

import jax as _jax
import jax.numpy as _jnp


@_functools.partial(_jax.jit, static_argnames=("cfg_a", "cfg_b", "CANDS"))
def _pair_fused_kernel(cfg_a, cfg_b, CANDS, prof_a, d_kmer_tab, rc_code,
                       rc_n_code, d_catcat, d_anchors, d_sizes,
                       d_rcoff, d_wlocs, d_clocs, d_tags, d_sites,
                       d_site_off, d_tag_off, packed_a, packed_b):
    """ONE program per window: both mates' schedule+verify AND the pair
    join run on device; only the compact JN_COLS rows come home."""
    from .device_engine import (_schedule_impl, _unpack_inputs, _verify_impl,
                                X_FTOT)
    outs = []
    rands = []
    lens2 = []
    buds2 = []
    for cfg, packed in ((cfg_a, packed_a), (cfg_b, packed_b)):
        qw0, rw0, lens, budgets, rand32, maxrank = _unpack_inputs(packed)
        (qw, rw, h, off0, off3, wcnt, cnt, wantv, s_off, c_off,
         ftot_rank) = _schedule_impl(
            cfg, prof_a, d_kmer_tab, d_tag_off, rc_code, rc_n_code,
            qw0, rw0, lens, budgets, maxrank)
        outs.append(_verify_impl(
            cfg, CANDS, d_catcat, d_anchors, d_sizes, d_rcoff, d_wlocs,
            d_clocs, d_tags, d_sites, d_site_off, qw, rw, lens, budgets,
            rand32, maxrank, h, off0, off3, wcnt, cnt, wantv, s_off, c_off,
            ftot_rank[:, -1]))
        rands.append(rand32)
        lens2.append(lens)
        buds2.append(budgets)
    MS, K = cfg_a.maxseg, cfg_a.hits_k
    ftot = _jnp.maximum(outs[0][:, 2 * MS + X_FTOT],
                        outs[1][:, 2 * MS + X_FTOT])
    return _device_pair_join(MS, K, cfg_a.min_ins, cfg_a.max_ins,
                             cfg_a.max_num_hits, outs[0], outs[1],
                             lens2[0], lens2[1], buds2[0], buds2[1],
                             rands[0], rands[1], ftot)


class PairDeviceEngine:
    """Batch PE aligner: one fused dispatch per window (both mates +
    on-device join) on the single-device engine; two SE dispatches + host
    join over the mesh engines."""

    def __init__(self, genome: PackedGenome, index: SeedIndex, param: Param,
                 se_engine: DeviceEngine | None = None):
        if param.RRBS_flag:
            raise EngineUnsupported("pair-end RRBS has no device path: "
                                    "use --engine auto or host")
        # -S 0 (the reference default) is handled like the SE engine does:
        # the sequential rand_r draws fire only for a multi-hit pair
        # (pairs.cpp:235) or an unpaired mate with >1 best hits
        # (pairs.cpp:258,271) — those pairs replay on the exact host engine
        # (real hit lists for the formatter's draw); draw-free pairs stay on
        # device and consume nothing, so the stream stays in sync.
        self.param = param
        self.se = se_engine or DeviceEngine(genome, index, param)
        self.pair_host = PairHostEngine(self.se.host)   # exact replay path
        self.K = PAIR_HITS_K
        self.MS = self.se._maxseg
        self.n_replayed = 0

    def _cfg(self, readset: int, nw: int = FIXELEMENT):
        # min/max insert ride the cfg for the on-device join (the kernel
        # only reads them under cfg.rrbs otherwise)
        mode = "b" if self.param.chains else ("f" if readset == 1 else "r")
        return self.se._cfg(mode, nw=nw)._replace(
            pe=True, hits_k=self.K, min_ins=self.param.min_insert,
            max_ins=self.param.max_insert)

    def supports_pair_blocks(self) -> bool:
        """SAM/BAM PE output without trimming/RRBS/-R runs on the native
        block path; everything else uses the per-pair path."""
        from .. import native
        p = self.param
        return (native.get_lib() is not None and not p.RRBS_flag
                and not p.adapters and p.qual_threshold == 0
                and p.out_sam >= 1 and not p.out_ref
                and type(self.se)._dispatch is DeviceEngine._dispatch)

    def _fused_ok(self) -> bool:
        return (type(self.se)._dispatch is DeviceEngine._dispatch
                and _os.environ.get("BSMAP_JAX_PE_FUSED", "1") != "0")

    def warmup_programs(self, nw: int = 7) -> None:
        """Compile the PE programs at every capacity concurrently, then
        execute each once on a zero window.  Idempotent: repeat calls are
        free."""
        se = self.se
        if type(se)._dispatch is not DeviceEngine._dispatch:
            return
        if getattr(self, "_warmed", None) == nw:
            return
        width = 2 * nw + 4
        z = np.zeros((se.B, width), dtype=np.int32)
        z[:, width - 4] = min(100, 16 * nw)
        z[:, width - 3] = min(self.param.max_snp_num, MAXSNPS)
        z[:, width - 1] = self.MS - 1
        if self._fused_ok():
            cfg_a, cfg_b = self._cfg(1, nw), self._cfg(2, nw)
            jobs = [(_pair_fused_kernel, (cfg_a, cfg_b, cap), width, 2)
                    for cap in se.cands_tiers]
            se._compile_all(jobs)
            dz = _jnp.asarray(z)
            outs = [se._compiled(*job)(*se._engine_args(), dz, dz)
                    for job in jobs]
        else:
            cfgs = [(cfg, cap) for cfg in (self._cfg(1, nw), self._cfg(2, nw))
                    for cap in se.cands_tiers]
            se._compile_all([(_align_fused_kernel, pr, width, 1)
                             for pr in cfgs])
            outs = [se._dispatch(cfg, z, cap) for cfg, cap in cfgs]
        _jax.block_until_ready(outs)
        self._warmed = nw

    # -- the vectorized GetPairs sweep (pairs.cpp:34-135) ---------------------

    def _join(self, rows_a, rows_b, La, Lb, buds_a, buds_b, rand_a):
        """Vectorized pairing, chunked to bound the (chunk, K, K) workspace."""
        CH = 4096
        n = rows_a.shape[0]
        if n > CH:
            parts = [self._join(rows_a[s: s + CH], rows_b[s: s + CH],
                                La[s: s + CH], Lb[s: s + CH],
                                buds_a[s: s + CH], buds_b[s: s + CH],
                                rand_a[s: s + CH])
                     for s in range(0, n, CH)]
            out = {k: np.concatenate([p[k] for p in parts])
                   for k in parts[0] if k != "sel"}
            out["sel"] = {k: np.concatenate([p["sel"][k] for p in parts])
                          for k in parts[0]["sel"]}
            return out
        p = self.param
        MS, K = self.MS, self.K
        base = 2 * MS + N_EXTRAS
        n = rows_a.shape[0]

        def unpack(rows):
            loc = rows[:, base: base + K]
            w1 = rows[:, base + K: base + 2 * K]
            v = w1 >= 0
            return (loc, w1 & 15, (w1 >> 4) & 1, (w1 >> 5) & 15,
                    (w1 >> 9) & 0xFFFF, v)

        locA, wA, chA, rkA, cpA, vA = unpack(rows_a)
        locB, wB, chB, rkB, cpB, vB = unpack(rows_b)
        # hits fill a dense 0-based-rank prefix of the K slots: crop the
        # hit axes to this chunk's max fill (the K x K workspace and the
        # sorted_rank compares are quadratic in it; typical fill is 1-2)
        ka = max(1, int(vA.sum(axis=1).max(initial=0)))
        kb = max(1, int(vB.sum(axis=1).max(initial=0)))
        locA, wA, chA, rkA, cpA, vA = (x[:, :ka] for x in
                                       (locA, wA, chA, rkA, cpA, vA))
        locB, wB, chB, rkB, cpB, vB = (x[:, :kb] for x in
                                       (locB, wB, chB, rkB, cpB, vB))

        aloc = locA[:, :, None].astype(np.int64)
        bloc = locB[:, None, :].astype(np.int64)
        wa, wb = wA[:, :, None], wB[:, None, :]
        m = np.maximum(wa, wb)
        # chain 0: a-fwd x b-rc; chain 1: a-rc x b-fwd (pairs.cpp:60,88)
        pchain = np.where(chA[:, :, None] == 0, 0, 1)
        chain_ok = (chA[:, :, None] ^ chB[:, None, :]) == 1
        same_chr = cpA[:, :, None] == cpB[:, None, :]
        avail = (rkA[:, :, None] <= m) & (rkB[:, None, :] <= m)
        odd = (cpA[:, :, None] & 1)
        a_end_form = odd != pchain
        ins = np.where(a_end_form,
                       aloc + La[:, None, None] - bloc,
                       bloc + Lb[:, None, None] - aloc)
        elig = (vA[:, :, None] & vB[:, None, :] & chain_ok & same_chr
                & avail & (wa <= buds_a[:, None, None])
                & (wb <= buds_b[:, None, None])
                & (ins >= p.min_insert) & (ins <= p.max_insert))

        m_m = np.where(elig, m, BIG)
        i_star = m_m.min(axis=(1, 2))
        paired = i_star < BIG
        at_win = elig & (m == i_star[:, None, None])
        tot = wa + wb
        win_total = np.where(at_win, tot, BIG).min(axis=(1, 2))
        F = at_win & (tot == win_total[:, None, None])
        cnt = F.sum(axis=(1, 2))
        cap_replay = cnt >= p.max_num_hits

        # reference sweep order at step i*: GetPairs(i,i), then j ascending
        # (i,j) before (j,i); within a combo chain 0 before chain 1; within
        # a sweep (a sorted rank, b sorted rank) lexicographic
        combo = np.where(wa == wb, 0,
                         np.where(wb < wa, 1 + 2 * wb, 2 + 2 * wa))

        def sorted_rank(loc, w, ch, cp, v):
            same = (v[:, :, None] & v[:, None, :]
                    & (w[:, :, None] == w[:, None, :])
                    & (ch[:, :, None] == ch[:, None, :]))
            less = ((cp[:, None, :] < cp[:, :, None])
                    | ((cp[:, None, :] == cp[:, :, None])
                       & (loc[:, None, :] < loc[:, :, None])))
            return (same & less).sum(axis=2).astype(np.int32)   # (n, K)

        raA = sorted_rank(locA, wA, chA, cpA, vA)
        raB = sorted_rank(locB, wB, chB, cpB, vB)
        key = ((((combo << 1) | pchain) << 6 | raA[:, :, None]) << 6) \
            | raB[:, None, :]
        # payload-packed keys: sort (n, ka*kb) and take the myrand-j-th
        kidx = np.arange(ka * kb, dtype=np.int64)
        keyp = np.where(F, (key.astype(np.int64) << 12) | kidx.reshape(
            1, ka, kb), np.int64(1) << 60).reshape(n, ka * kb)
        keyp.sort(axis=1)
        j = (rand_a % np.maximum(cnt, 1).astype(np.uint32)).astype(np.int64)
        selp = np.take_along_axis(keyp, j[:, None], axis=1)[:, 0]
        sel_kl = (selp & 0xFFF).astype(np.int32)
        sel_k, sel_l = sel_kl // kb, sel_kl % kb

        r = np.arange(n)
        return {
            "paired": np.where(paired, i_star + 1, 0).astype(np.int32),
            "win_total": win_total,
            "cnt": cnt.astype(np.int32),
            "cap_replay": cap_replay,
            "sel": {
                "chain": np.where(paired, chA[r, sel_k], 0),
                "na": wA[r, sel_k], "nb": wB[r, sel_l],
                "insert": np.where(paired, ins[r, sel_k, sel_l], 0),
                "a_chr": cpA[r, sel_k], "a_loc": locA[r, sel_k],
                "b_chr": cpB[r, sel_l], "b_loc": locB[r, sel_l],
            },
        }

    # -- exact unpaired-fallback selection ------------------------------------

    def _unpaired_sel(self, rows, rand):
        """string_align_unpair's draw (pairs.cpp:258-271) vectorized: at the
        first nonempty level the reference indexes the CONCATENATED
        fwd-then-rc lists, each sorted by (chr, loc) (SortHits4PE).  The
        kernel's compacted K hits are in discovery order, so the sorted-order
        pick is recomputed here.  Exact whenever the mate's enumeration fits
        K (else the kernel replay bit routed the pair to the host engine).
        Returns (chain, chrp, wloc) int32 arrays."""
        MS, K = self.MS, self.K
        n = rows.shape[0]
        if n == 0:
            z = np.zeros(0, dtype=np.int32)
            return z, z, z
        base = 2 * MS + N_EXTRAS
        loc = rows[:, base: base + K].astype(np.int64)
        w1 = rows[:, base + K: base + 2 * K]
        v = w1 >= 0
        w = w1 & 15
        ch = (w1 >> 4) & 1
        cp = (w1 >> 9) & 0xFFFF
        ii = rows[:, 2 * MS + X_II]
        ssum = rows[:, 2 * MS + X_SSUM]
        best = v & (w == ii[:, None])
        key = ((ch.astype(np.int64) << 48) | (cp.astype(np.int64) << 32)
               | loc)
        key = np.where(best, key, np.int64(1) << 62)
        order = np.argsort(key, axis=1, kind="stable")
        j = (rand % np.maximum(ssum, 1).astype(np.uint32)).astype(np.int64)
        r = np.arange(n)
        sel = order[r, j]
        return (ch[r, sel].astype(np.int32), cp[r, sel].astype(np.int32),
                loc[r, sel].astype(np.int32))

    # -- dispatch core ---------------------------------------------------------

    def _align_join(self, rows_in_a, rows_in_b, cfg_a, cfg_b, la, lb,
                    buds_a, buds_b, rand_a, rand_b, defer: bool = False):
        """Two-phase dispatch + join over both mates' packed input rows.

        Phase 1 enumerates RANK 0 ONLY (cheap, SE-bulk-round cost): the
        reference's step-0 pairing sweeps exactly the hits its cheapest
        segments discovered (pairs.cpp:163-172 breaks at the first step
        with a pair), so a complete rank-0 enumeration fully determines
        every i*==0 pair — the winning set, count, sweep order AND the
        mates' hit lists as the reference's formatter sees them (RunAlign
        stopped at step 0, so its lists hold rank-0 hits only).  Pairs
        without a step-0 pair re-dispatch ONCE at full rank, exactly
        bin-packed by the rank-0 round's full-rank totals.

        Returns (rows_a, rows_b, join, ftot)."""
        se = self.se
        MS, K = self.MS, self.K
        n = rows_in_a.shape[0]
        width = 2 * MS + N_EXTRAS + 2 * K
        rows_a = np.zeros((n, width), dtype=np.int32)
        rows_b = np.zeros((n, width), dtype=np.int32)
        if n == 0:
            out = (rows_a, rows_b, self._join(
                rows_a, rows_b, la, lb, buds_a, buds_b, rand_a),
                np.zeros(0, dtype=np.int64))
            return (lambda: out) if defer else out
        okp = np.zeros(n, dtype=bool)
        ftot = np.zeros(n, dtype=np.int64)

        def collect_pair(sel, oa, ob, into_ok):
            ra_ = np.asarray(oa)[: len(sel)]
            rb_ = np.asarray(ob)[: len(sel)]
            okb = (ra_[:, 2 * MS + X_OK] != 0) & \
                  (rb_[:, 2 * MS + X_OK] != 0)
            # per-dispatch capacity must hold BOTH mates' enumerations
            ftot[sel] = np.maximum(ra_[:, 2 * MS + X_FTOT],
                                   rb_[:, 2 * MS + X_FTOT])
            rows_a[sel[okb]] = ra_[okb]
            rows_b[sel[okb]] = rb_[okb]
            into_ok[sel[okb]] = True

        def dispatch_span(sel, cap, rank):
            ranks = np.full(n, rank, dtype=np.int32)
            oa = se._dispatch(cfg_a, se._pad_rows(rows_in_a, sel, ranks),
                              cap)
            ob = se._dispatch(cfg_b, se._pad_rows(rows_in_b, sel, ranks),
                              cap)
            return sel, oa, ob

        # --- phase 1: rank-0 windows at the small capacity (enqueue) --------
        pend1 = [dispatch_span(np.arange(i, min(i + se.B, n),
                                         dtype=np.int64), None, 0)
                 for i in range(0, n, se.B)]

        def finish():
            arrs1 = _jax.device_get([o for p in pend1 for o in p[1:]])
            for (sel, _, _), ra_, rb_ in zip(pend1, arrs1[0::2],
                                             arrs1[1::2]):
                collect_pair(sel, ra_, rb_, okp)
            join = self._join(rows_a, rows_b, la, lb, buds_a, buds_b,
                              rand_a)
            commit = okp & (join["paired"] == 1)   # i* == 0: exact

            # --- phase 2: full rank for the rest, exactly bin-packed -------
            rem = np.nonzero(~commit)[0]
            cap_max = min(se.CANDS_BIG, (1 << 27) - 1)
            too_big = rem[ftot[rem] >= cap_max]
            for k in too_big:
                rows_a[k] = 0
                rows_a[k, 2 * MS + X_REPLAY] = 1
                rows_b[k] = 0
            rem = rem[ftot[rem] < cap_max]
            if len(rem):
                ok2 = np.zeros(n, dtype=bool)
                d = np.maximum(ftot[rem], 1)
                csum = np.cumsum(d)
                spans = []
                s = 0
                base = 0
                for k in range(len(rem)):
                    if k - s == se.B or csum[k] - base > se.CANDS_BIG:
                        spans.append((s, k))
                        s = k
                        base = csum[k - 1]
                spans.append((s, len(rem)))
                pend2 = []
                for a0, b0 in spans:
                    mass = int(csum[b0 - 1] - (csum[a0 - 1] if a0 else 0))
                    cap = se.CANDS if mass <= se.CANDS else se.CANDS_BIG
                    pend2.append(dispatch_span(rem[a0: b0], cap, MS - 1))
                arrs2 = _jax.device_get([o for p in pend2 for o in p[1:]])
                for (sel, _, _), ra_, rb_ in zip(pend2, arrs2[0::2],
                                                 arrs2[1::2]):
                    collect_pair(sel, ra_, rb_, ok2)
                for k in rem[~ok2[rem]]:             # defensive
                    rows_a[k] = 0
                    rows_a[k, 2 * MS + X_REPLAY] = 1
                    rows_b[k] = 0
                join2 = self._join(rows_a[rem], rows_b[rem], la[rem],
                                   lb[rem], buds_a[rem], buds_b[rem],
                                   rand_a[rem])
                for key in ("paired", "win_total", "cnt", "cap_replay"):
                    join[key][rem] = join2[key]
                for key in join["sel"]:
                    join["sel"][key][rem] = join2["sel"][key]
            return rows_a, rows_b, join, ftot

        return finish if defer else finish()

    def _align_join_fused(self, rows_in_a, rows_in_b, cfg_a, cfg_b):
        """Two-phase dispatch of the FUSED pair kernel: phase 1 at rank 0
        (commits every i*==0 pair), phase 2 full-rank bin-packed for the
        rest.  Returns finish() -> (n, JN_COLS) compact join rows."""
        se = self.se
        MS = self.MS
        n = rows_in_a.shape[0]
        jrows = np.zeros((n, JN_COLS), dtype=np.int32)
        args = se._engine_args()
        width = rows_in_a.shape[1]
        se._compile_all([(_pair_fused_kernel, (cfg_a, cfg_b, cap), width, 2)
                         for cap in se.cands_tiers])

        def dispatch(sel, cap, rank):
            ranks = np.full(n, rank, dtype=np.int32)
            exe = se._compiled(_pair_fused_kernel, (cfg_a, cfg_b, cap),
                               width, n_packed=2)
            out = exe(*args,
                      _jnp.asarray(se._pad_rows(rows_in_a, sel, ranks)),
                      _jnp.asarray(se._pad_rows(rows_in_b, sel, ranks)))
            se.n_dispatched += 1
            return sel, out

        pend1 = [dispatch(np.arange(i, min(i + se.B, n), dtype=np.int64),
                          se.CANDS, 0)
                 for i in range(0, n, se.B)]

        def finish():
            t0 = _time.time()
            arrs1 = _jax.device_get([o for _, o in pend1])
            for (sel, _), arr in zip(pend1, arrs1):
                jrows[sel] = arr[: len(sel)]
            se.t_collect += _time.time() - t0
            ok = (jrows[:, J_FLAGS] >> 2) & 1
            paired = jrows[:, J_PAIR] & 31
            commit = (ok == 1) & (paired == 1)      # i* == 0: exact
            ftot = jrows[:, J_FTOT].astype(np.int64)
            rem = np.nonzero(~commit)[0]
            cap_max = min(se.CANDS_BIG, (1 << 27) - 1)
            too_big = rem[ftot[rem] >= cap_max]
            jrows[too_big] = 0
            jrows[too_big, J_FLAGS] = 1             # replay
            rem = rem[ftot[rem] < cap_max]
            if len(rem):
                d = np.maximum(ftot[rem], 1)
                csum = np.cumsum(d)
                spans = []
                s = 0
                base = 0
                for k in range(len(rem)):
                    if k - s == se.B or csum[k] - base > se.CANDS_BIG:
                        spans.append((s, k))
                        s = k
                        base = csum[k - 1]
                spans.append((s, len(rem)))
                pend2 = []
                for a0, b0 in spans:
                    mass = int(csum[b0 - 1] - (csum[a0 - 1] if a0 else 0))
                    cap = se.CANDS if mass <= se.CANDS else se.CANDS_BIG
                    pend2.append(dispatch(rem[a0: b0], cap, MS - 1))
                t0 = _time.time()
                arrs2 = _jax.device_get([o for _, o in pend2])
                for (sel, _), arr in zip(pend2, arrs2):
                    jrows[sel] = arr[: len(sel)]
                se.t_collect += _time.time() - t0
                bad = rem[((jrows[rem, J_FLAGS] >> 2) & 1) == 0]
                jrows[bad] = 0
                jrows[bad, J_FLAGS] = 1             # replay (defensive)
            return jrows

        return finish

    def _replay_flag_fused(self, jrows, risk):
        """Replay decisions from the compact join rows (mirrors
        _replay_flag)."""
        p = self.param
        flags = jrows[:, J_FLAGS]
        paired = jrows[:, J_PAIR] & 31
        cnt = (jrows[:, J_PAIR] >> 5) & 2047
        flag = ((flags & 3) != 0) | (((flags >> 3) & 1) != 0) | risk
        if p.report_repeat_hits == 0:
            flag = flag | ((paired > 1) & (cnt > 1))
        if p.randseed == 0:
            fnd_a = (jrows[:, J_MATE_A] & 1) != 0
            fnd_b = (jrows[:, J_MATE_B] & 1) != 0
            ss_a = (jrows[:, J_MATE_A] >> 6) & 1023
            ss_b = (jrows[:, J_MATE_B] >> 6) & 1023
            flag = flag | ((paired > 0) & (cnt > 1)) \
                | ((paired == 0) & ((fnd_a & (ss_a != 1))
                                    | (fnd_b & (ss_b != 1))))
        return flag

    @staticmethod
    def _prow_from_jrows(jrows):
        """Decode compact join rows into the native formatter's 22-col
        prow layout."""
        j = jrows
        pairw = j[:, J_PAIR]
        ma, mb = j[:, J_MATE_A], j[:, J_MATE_B]
        return np.stack([
            pairw & 31, (pairw >> 5) & 2047, (pairw >> 16) & 1,
            (pairw >> 17) & 15, (pairw >> 21) & 15, j[:, J_INS],
            j[:, J_CHRS] & 0xFFFF, j[:, J_ALOC],
            (j[:, J_CHRS] >> 16) & 0xFFFF, j[:, J_BLOC],
            ma & 1, (ma >> 2) & 15, (ma >> 6) & 1023, (ma >> 1) & 1,
            (ma >> 16) & 0xFFFF, j[:, J_WLOC_A],
            mb & 1, (mb >> 2) & 15, (mb >> 6) & 1023, (mb >> 1) & 1,
            (mb >> 16) & 0xFFFF, j[:, J_WLOC_B],
        ], axis=1).astype(np.int32)

    def _replay_flag(self, rows_a, rows_b, join, risk):
        """Pairs whose exact output needs the sequential host engine."""
        p = self.param
        MS = self.MS
        flag = ((rows_a[:, 2 * MS + X_REPLAY] != 0)
                | (rows_b[:, 2 * MS + X_REPLAY] != 0)
                | join["cap_replay"] | risk)
        paired = join["paired"] > 0
        if p.report_repeat_hits == 0:
            # -r 0 multi-pair falls through to the unpaired fallback, whose
            # hit lists the reference froze at step i* (RunAlign breaks) —
            # our i*>0 rows hold the FULL enumeration, so those pairs
            # replay; i*==0 pairs committed rank-0 rows and stay exact
            flag = flag | (paired & (join["cnt"] > 1)
                           & (join["paired"] > 1))
        if p.randseed == 0:
            # any pair whose output consumes a sequential rand_r draw:
            # multi-hit winning pair (pairs.cpp:235; -r 0 falls through
            # to unpaired where the same mates draw), or an unpaired
            # mate with >1 best-level hits (pairs.cpp:258,271)
            multi_pair = paired & (join["cnt"] > 1)
            ma = ((rows_a[:, 2 * MS + X_FOUND] != 0)
                  & (rows_a[:, 2 * MS + X_SSUM] != 1))
            mb = ((rows_b[:, 2 * MS + X_FOUND] != 0)
                  & (rows_b[:, 2 * MS + X_SSUM] != 1))
            flag = flag | multi_pair | (~paired & (ma | mb))
        return flag

    # -- batch orchestration ---------------------------------------------------

    def align_batch(self, batch_a: list[Read], batch_b: list[Read]):
        p = self.param
        se = self.se
        n0 = len(batch_a)
        results: list = [None] * n0

        filt_a = np.zeros(n0, dtype=bool)
        filt_b = np.zeros(n0, dtype=bool)
        buds_a0 = np.zeros(n0, dtype=np.int32)
        buds_b0 = np.zeros(n0, dtype=np.int32)
        for i, (ra, rb) in enumerate(zip(batch_a, batch_b)):
            fa, ba = filter_read(ra, p)
            fb, bb = filter_read(rb, p)
            fix_pair_read_name(ra, rb, p)
            filt_a[i], filt_b[i] = fa, fb
            buds_a0[i], buds_b0[i] = ba, bb

        live = ~(filt_a | filt_b)
        live_pos = np.nonzero(live)[0]
        n = len(live_pos)
        MS, K = self.MS, self.K

        if n:
            idxs = [int(i) for i in live_pos]
            arrs_a = se._pack_host(batch_a, idxs, buds_a0[live_pos])
            arrs_b = se._pack_host(batch_b, idxs, buds_b0[live_pos])
            ca, ga, la, ba_, _, ridx_a = arrs_a
            cb, gb, lb, bb_, _, ridx_b = arrs_b
            if p.randseed == 0:
                # draw-dependent pairs replay below; j = 0 % 1 for the rest
                rand_a = np.zeros(n, dtype=np.uint32)
                rand_b = np.zeros(n, dtype=np.uint32)
            else:
                rand_a = myrand_hash(ridx_a, p.randseed)
                rand_b = myrand_hash(ridx_b, p.randseed)
            rows_in_a = _pack_inputs(ca, ga, la, ba_, rand_a,
                                     np.full(n, MS - 1, np.int32))
            rows_in_b = _pack_inputs(cb, gb, lb, bb_, rand_b,
                                     np.full(n, MS - 1, np.int32))
            cfg_a, cfg_b = self._cfg(1), self._cfg(2)
            risk = se._stale_risk(la, ba_) | se._stale_risk(lb, bb_)
            rows_a, rows_b, join, _ = self._align_join(
                rows_in_a, rows_in_b, cfg_a, cfg_b, la.astype(np.int64),
                lb.astype(np.int64), ba_, bb_, rand_a, rand_b)
            replay_flag = self._replay_flag(rows_a, rows_b, join, risk)
            usel_a = self._unpaired_sel(rows_a, rand_a)
            usel_b = self._unpaired_sel(rows_b, rand_b)
        else:
            join = None
            replay_flag = np.zeros(0, dtype=bool)
            la = lb = None
            rows_a = rows_b = np.zeros((0, 1), dtype=np.int32)

        # --- in-order assembly with exact dual MateState maintenance --------
        # All host-path pairs (replays, and pairs with a filtered mate whose
        # surviving mate runs SE-style: pairs.cpp:206-212) must mutate the
        # per-mate states in BATCH order; device spans in between are synced
        # lazily before any host pair that may read stale state.
        st_a, st_b = self.pair_host.state_a, self.pair_host.state_b
        read_a = lambda t: batch_a[int(live_pos[t])]
        read_b = lambda t: batch_b[int(live_pos[t])]
        mode_a = "b" if p.chains else "f"
        mode_b = "b" if p.chains else "r"
        live_row = np.full(n0, -1, dtype=np.int64)
        live_row[live_pos] = np.arange(n)

        def sync_to(cursor: int, t: int) -> int:
            se._sync_state_span(read_a, cursor, t,
                                rows_a[:, 2 * MS + X_SOFF],
                                rows_a[:, 2 * MS + X_COFF], la,
                                replay_flag, mode_a, state=st_a)
            se._sync_state_span(read_b, cursor, t,
                                rows_b[:, 2 * MS + X_SOFF],
                                rows_b[:, 2 * MS + X_COFF], lb,
                                replay_flag, mode_b, state=st_b)
            return t

        cursor = 0
        next_live = 0
        for i in range(n0):
            t = int(live_row[i])
            if t >= 0:
                next_live = t + 1
                if not replay_flag[t]:
                    continue
                if risk[t]:
                    cursor = sync_to(cursor, t) + 1
                results[i] = self.pair_host.align_pair(batch_a[i],
                                                       batch_b[i])
                self.n_replayed += 1
            else:
                # filtered-mate pair: the surviving mate's run_align may
                # read schedule state -> sync the preceding device span
                cursor = sync_to(cursor, next_live)
                results[i] = self.pair_host.align_pair(batch_a[i],
                                                       batch_b[i])
        if n:
            sync_to(cursor, n)

        for t in range(n):
            if replay_flag[t]:
                continue
            i = int(live_pos[t])
            paired = int(join["paired"][t])
            pairhits: list = [[] for _ in range(2 * MAXSNPS + 1)]
            if paired:
                s = join["sel"]
                ph = PairHit(chain=int(s["chain"][t]), na=int(s["na"][t]),
                             nb=int(s["nb"][t]), insert=int(s["insert"][t]),
                             a=(int(s["a_chr"][t]), int(s["a_loc"][t])),
                             b=(int(s["b_chr"][t]), int(s["b_loc"][t])))
                cnt = int(join["cnt"][t])
                bucket = _SelList(cnt, ph)
                pairhits[int(join["win_total"][t])] = bucket
            hit_a = (int(usel_a[1][t]), int(usel_a[2][t]))
            hit_b = (int(usel_b[1][t]), int(usel_b[2][t]))
            results[i] = PairResult(
                paired=paired, pairhits=pairhits,
                res_a=PairSEView(rows_a[t], MS, int(buds_a0[i]), hit_a),
                res_b=PairSEView(rows_b[t], MS, int(buds_b0[i]), hit_b),
                filtered_a=False, filtered_b=False)
        return results

    def format_batch(self, batch_a, batch_b, fmt):
        """Same contract as pair_pipeline.HostPairBatch.format_batch."""
        p = self.param
        results = self.align_batch(batch_a, batch_b)
        main_parts: list[str] = []
        unpair_parts: list[str] = []
        for ra, rb, pres in zip(batch_a, batch_b, results):
            fell = 1
            if pres.paired:
                text, fell = fmt.string_align_pair(ra, rb, pres)
                main_parts.append(text)
            if fell == 1 or not pres.paired:
                up = fmt.string_align_unpair(
                    ra, rb, pres.filtered_a, pres.filtered_b, pres)
                (main_parts if p.out_sam else unpair_parts).append(up)
        return "".join(main_parts), "".join(unpair_parts)

    # -- native block path ----------------------------------------------------

    def format_block_pair(self, blk_a, blk_b, fmt) -> bytes:
        return self.align_block_pair(blk_a, blk_b)(fmt)

    def encode_block_pair(self, blk_a, blk_b):
        """Native name-fix + encode for one block pair; runs in the
        parse-ahead thread (native calls release the GIL).  Caches
        (nw, rows_a, rows_b) on blk_a."""
        if blk_a.enc is not None:
            return blk_a.enc
        from .. import native
        p = self.param
        lib = native.get_lib()
        bad = native.fix_pair_names(lib, blk_a.buf, blk_a.rec,
                                    blk_b.buf, blk_b.rec)
        if bad >= 0:
            raise ValueError("Paired reads name not match:\n"
                             f"{blk_a.name(bad)}\n{blk_b.name(bad)}")
        max_len = max(int(blk_a.rec[:, 3].max()),
                      int(blk_b.rec[:, 3].max())) if len(blk_a) else 0
        nw = 7 if min(max_len, p.max_readlen) <= 112 else FIXELEMENT
        rows_a = native.encode_block_words(
            lib, blk_a.buf, blk_a.rec, p.alphabet, REG_ALPHABET, nw)
        rows_b = native.encode_block_words(
            lib, blk_b.buf, blk_b.rec, p.alphabet, REG_ALPHABET, nw)
        blk_a.enc = (nw, rows_a, rows_b)
        return blk_a.enc

    def align_block_pair(self, blk_a, blk_b):
        """Encode one pair of ReadBlocks and ENQUEUE the phase-1 (rank-0)
        dispatches; returns finish(fmt) -> SAM bytes.  The block pipeline
        calls finish() for block N only after block N+1's phase 1 is on
        the device, so collect/join/format overlap kernel time."""
        from .. import native
        p = self.param
        se = self.se
        lib = native.get_lib()
        MS, K = self.MS, self.K
        n_all = len(blk_a)
        if len(blk_b) != n_all:
            raise ValueError("PE block length mismatch")
        nw, rows_in_a0, rows_in_b0 = self.encode_block_pair(blk_a, blk_b)
        ok_a = ((rows_in_a0[:, 2 * nw] >= p.min_read_size)
                & (rows_in_a0[:, 2 * nw + 3] <= p.max_ns))
        ok_b = ((rows_in_b0[:, 2 * nw] >= p.min_read_size)
                & (rows_in_b0[:, 2 * nw + 3] <= p.max_ns))
        live = ok_a & ok_b
        live_pos = np.nonzero(live)[0]
        n = len(live_pos)
        rows_in_a = rows_in_a0[live_pos]
        rows_in_b = rows_in_b0[live_pos]
        la = rows_in_a[:, 2 * nw].astype(np.int64)
        lb = rows_in_b[:, 2 * nw].astype(np.int64)
        buds_a = ((p.max_snp_num + 1) * (la - 1) // la).astype(np.int32) \
            if n else np.zeros(0, np.int32)
        buds_b = ((p.max_snp_num + 1) * (lb - 1) // lb).astype(np.int32) \
            if n else np.zeros(0, np.int32)
        if p.randseed == 0:
            rand_a = np.zeros(n, dtype=np.uint32)
            rand_b = np.zeros(n, dtype=np.uint32)
        else:
            rand_a = myrand_hash(
                blk_a.indices[live_pos].astype(np.uint64), p.randseed)
            rand_b = myrand_hash(
                blk_b.indices[live_pos].astype(np.uint64), p.randseed)
        rows_in_a[:, 2 * nw + 1] = buds_a
        rows_in_b[:, 2 * nw + 1] = buds_b
        rows_in_a[:, 2 * nw + 2] = rand_a.view(np.int32)
        rows_in_b[:, 2 * nw + 2] = rand_b.view(np.int32)
        rows_in_a[:, 2 * nw + 3] = 0
        rows_in_b[:, 2 * nw + 3] = 0
        cfg_a, cfg_b = self._cfg(1, nw), self._cfg(2, nw)
        risk = (se._stale_risk(la, buds_a) | se._stale_risk(lb, buds_b)) \
            if n else np.zeros(0, dtype=bool)

        if self._fused_ok():
            finf = (self._align_join_fused(rows_in_a, rows_in_b,
                                           cfg_a, cfg_b) if n else None)

            def finish_fused(fmt) -> bytes:
                if n:
                    jr = finf()
                    replay_flag = self._replay_flag_fused(jr, risk)
                    prow_live = self._prow_from_jrows(jr)
                else:
                    replay_flag = np.zeros(0, dtype=bool)
                    prow_live = np.zeros((0, 22), dtype=np.int32)
                return self._emit_block(
                    fmt, blk_a, blk_b, live, live_pos, la, lb, risk,
                    replay_flag, prow_live, None, None, None, None)

            return finish_fused

        fin = (self._align_join(rows_in_a, rows_in_b, cfg_a, cfg_b, la, lb,
                                buds_a, buds_b, rand_a, rand_b, defer=True)
               if n else None)

        def finish(fmt) -> bytes:
            if n:
                rows_a, rows_b, join, _ = fin()
                replay_flag = self._replay_flag(rows_a, rows_b, join, risk)
                usel_a = self._unpaired_sel(rows_a, rand_a)
                usel_b = self._unpaired_sel(rows_b, rand_b)
                ex = 2 * MS
                s = join["sel"]
                prow_live = np.stack([
                    join["paired"], join["cnt"], s["chain"], s["na"],
                    s["nb"], s["insert"], s["a_chr"], s["a_loc"],
                    s["b_chr"], s["b_loc"],
                    rows_a[:, ex + X_FOUND], rows_a[:, ex + X_II],
                    rows_a[:, ex + X_SSUM], usel_a[0], usel_a[1], usel_a[2],
                    rows_b[:, ex + X_FOUND], rows_b[:, ex + X_II],
                    rows_b[:, ex + X_SSUM], usel_b[0], usel_b[1], usel_b[2],
                ], axis=1).astype(np.int32)
                soff = (rows_a[:, ex + X_SOFF], rows_a[:, ex + X_COFF],
                        rows_b[:, ex + X_SOFF], rows_b[:, ex + X_COFF])
            else:
                replay_flag = np.zeros(0, dtype=bool)
                prow_live = np.zeros((0, 22), dtype=np.int32)
                soff = (None, None, None, None)
            return self._emit_block(fmt, blk_a, blk_b, live, live_pos,
                                    la, lb, risk, replay_flag, prow_live,
                                    *soff)

        return finish

    def _emit_block(self, fmt, blk_a, blk_b, live, live_pos, la, lb, risk,
                    replay_flag, prow_live, soff_a, coff_a, soff_b,
                    coff_b) -> bytes:
        """Shared block emit: exact host replays in pair order with
        MateState sync, prow scatter, native pair formatting + splicing.
        soff/coff may be None (recomputed by the sync machinery)."""
        from .. import native
        p = self.param
        se = self.se
        lib = native.get_lib()
        n_all = len(blk_a)
        n = len(live_pos)
        st_a, st_b = self.pair_host.state_a, self.pair_host.state_b
        read_a = lambda t: blk_a.read_obj(int(live_pos[t]))
        read_b = lambda t: blk_b.read_obj(int(live_pos[t]))
        mode_a = "b" if p.chains else "f"
        mode_b = "b" if p.chains else "r"

        def sync_to(cursor: int, t: int) -> int:
            se._sync_state_span(read_a, cursor, t, soff_a, coff_a, la,
                                replay_flag, mode_a, state=st_a)
            se._sync_state_span(read_b, cursor, t, soff_b, coff_b, lb,
                                replay_flag, mode_b, state=st_b)
            return t

        status = np.full(n_all, 2, dtype=np.int32)
        status[~live] = 0
        rflag_pos = live_pos[replay_flag] if n else live_pos[:0]
        status[rflag_pos] = 0
        py_parts: dict[int, str] = {}
        lcum = np.concatenate([[0], np.cumsum(live)])
        cursor = 0
        for i in np.nonzero(status == 0)[0]:
            i = int(i)
            t = int(lcum[i])              # live row of this pair (if live)
            if live[i]:
                if risk[t]:
                    cursor = sync_to(cursor, t) + 1
            else:
                cursor = sync_to(cursor, t)
            ra, rb = blk_a.read_obj(i), blk_b.read_obj(i)
            pres = self.pair_host.align_pair(ra, rb)
            self.n_replayed += 1
            fell = 1
            text = ""
            if pres.paired:
                ptext, fell = fmt.string_align_pair(ra, rb, pres)
                text += ptext
            if fell == 1 or not pres.paired:
                text += fmt.string_align_unpair(
                    ra, rb, pres.filtered_a, pres.filtered_b, pres)
            py_parts[i] = text
        if n:
            sync_to(cursor, n)

        prow = np.zeros((n_all, 22), dtype=np.int32)
        if n:
            prow[live_pos] = prow_live
        out, line_off, (npair, na_, nb_) = native.format_pair_block(
            lib, blk_a.buf, blk_a.rec, blk_b.buf, blk_b.rec, status,
            prow, se._chrname_buf, se._chrname_off, REV_CHAR,
            bool(p.out_unmap), p.report_repeat_hits, blk_a.synth_qual,
            blk_b.synth_qual)
        fmt.n_aligned_pairs += npair
        fmt.n_aligned_a += na_
        fmt.n_aligned_b += nb_
        if not py_parts:
            return out
        pieces, prev = [], 0
        for i in sorted(py_parts):
            cut = int(line_off[i])
            pieces.append(out[prev:cut])
            pieces.append(py_parts[i].encode("latin1"))
            prev = cut
        pieces.append(out[prev:])
        return b"".join(pieces)
