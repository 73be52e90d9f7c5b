// Native host runtime for bsmap_jax: FASTQ/FASTA block parsing, read
// encoding and SAM block formatting.
//
// The reference's host side is C++ (reads.cpp tokenized ingestion,
// align.cpp:631-765 output formatting); next to the device kernel the
// Python equivalents dominate the wall clock, so these stages are native
// here too.  Exposed as a plain C ABI consumed via ctypes
// (bsmap_jax/native/__init__.py); all arrays are caller-allocated numpy
// buffers.
//
// Parsing reproduces the reference's istream token semantics exactly
// (reads.cpp:83-146): `fin >> tok` reads one whitespace-delimited token
// (possibly crossing line boundaries) and `getline` discards the remainder
// of the current line.  A record is only emitted when every token is
// provably complete inside the buffer (or `is_final` says the buffer ends
// the file), so callers can stream the file in arbitrary chunks.

#include <cstdint>
#include <cstring>

static inline bool is_ws(uint8_t c) {
    // istream skips isspace() (reads.cpp uses default-locale streams)
    return c == ' ' || c == '\t' || c == '\r' || c == '\n' || c == '\v' ||
           c == '\f';
}

extern "C" {

// Parse up to `cap` reads from buf[0:len].
// rec layout per read (int64 x 6): name_off, name_len, seq_off, seq_len,
// qual_off (-1 = synthetic FASTA quality), qual_len.
// Returns the number of complete records; *consumed = stream position
// after the last record's final token (the rest of its line is discarded
// by the NEXT record's getline, mirroring the reference's stream state).
int64_t bsmap_parse_reads(const uint8_t* buf, int64_t len, int is_final,
                          int is_fasta, int64_t max_readlen, int64_t cap,
                          int64_t* rec, int64_t* consumed) {
    int64_t p = 0, n = 0;
    *consumed = 0;
    while (n < cap) {
        int64_t q = p;
        while (q < len && is_ws(buf[q])) q++;   // get_char: skip whitespace
        if (q >= len) {
            if (is_final) *consumed = len;
            break;
        }
        q++;                                    // consume the marker char
        while (q < len && is_ws(buf[q])) q++;   // name token
        if (q >= len) break;
        int64_t name_off = q;
        while (q < len && !is_ws(buf[q])) q++;
        if (q >= len && !is_final) break;
        int64_t name_len = q - name_off;
        while (q < len && buf[q] != '\n') q++;  // getline
        if (q < len) q++;
        else if (!is_final) break;
        while (q < len && is_ws(buf[q])) q++;   // seq token
        if (q >= len) break;
        int64_t seq_off = q;
        while (q < len && !is_ws(buf[q])) q++;
        if (q >= len && !is_final) break;
        int64_t seq_len = q - seq_off;
        int64_t qual_off = -1, qual_len = seq_len;
        if (!is_fasta) {
            while (q < len && is_ws(buf[q])) q++;    // '+' token
            if (q >= len) break;
            while (q < len && !is_ws(buf[q])) q++;
            if (q >= len && !is_final) break;
            while (q < len && buf[q] != '\n') q++;   // getline
            if (q < len) q++;
            else if (!is_final) break;
            while (q < len && is_ws(buf[q])) q++;    // qual token
            if (q >= len) break;
            qual_off = q;
            while (q < len && !is_ws(buf[q])) q++;
            if (q >= len && !is_final) break;
            qual_len = q - qual_off;
        }
        if (seq_len > max_readlen) {            // -L truncation
            seq_len = max_readlen;              // (reads.cpp:115-117)
            if (qual_len > max_readlen) qual_len = max_readlen;
        }
        rec[n * 6 + 0] = name_off;
        rec[n * 6 + 1] = name_len;
        rec[n * 6 + 2] = seq_off;
        rec[n * 6 + 3] = seq_len;
        rec[n * 6 + 4] = qual_off;
        rec[n * 6 + 5] = qual_len;
        n++;
        p = q;
        *consumed = p;
    }
    return n;
}

// Encode a parsed block: 2-bit alphabet codes + valid-base mask into
// caller-zeroed (n, fixsize) arrays, plus per-read length and N-count
// (FilterReads' CountNs, align.cpp:48).
void bsmap_encode_block(const uint8_t* buf, const int64_t* rec, int64_t n,
                        const uint8_t* alphabet, const uint8_t* reg_alphabet,
                        int64_t fixsize, uint8_t* codes, uint8_t* regs,
                        int32_t* lens, int32_t* ncnt) {
    for (int64_t i = 0; i < n; i++) {
        const uint8_t* s = buf + rec[i * 6 + 2];
        int64_t L = rec[i * 6 + 3];
        if (L > fixsize) L = fixsize;
        uint8_t* c = codes + i * fixsize;
        uint8_t* r = regs + i * fixsize;
        int32_t bad = 0;
        for (int64_t k = 0; k < L; k++) {
            uint8_t b = s[k];
            c[k] = alphabet[b];
            uint8_t g = reg_alphabet[b];
            r[k] = g;
            bad += (g == 0);
        }
        lens[i] = (int32_t)L;
        ncnt[i] = bad;
    }
}

// Encode a parsed block straight into the device dispatch row layout:
// int32 (n, 2*nwords + 4) rows = [read 2-bit-packed words | valid-mask
// words (lanes 11 valid / 00 invalid) | len | 0 | 0 | ncnt].  First base in
// the top bits of word 0 (dbseq.cpp:71-75 layout) — exactly the `qw`/`rw`
// arrays the device kernel's verify stage consumes, so the device never
// touches per-base codes.  Columns 2*nwords+1..2 (budget, rand32) are
// filled by the Python caller; ncnt rides in the maxrank slot until the
// caller overwrites it.
void bsmap_encode_block_words(const uint8_t* buf, const int64_t* rec,
                              int64_t n, const uint8_t* alphabet,
                              const uint8_t* reg_alphabet, int64_t nwords,
                              int32_t* rows) {
    const int64_t stride = 2 * nwords + 4;
    const int64_t fixsize = nwords * 16;
    for (int64_t i = 0; i < n; i++) {
        const uint8_t* s = buf + rec[i * 6 + 2];
        int64_t L = rec[i * 6 + 3];
        if (L > fixsize) L = fixsize;
        uint32_t* q = (uint32_t*)(rows + i * stride);
        uint32_t* r = q + nwords;
        int32_t bad = 0;
        uint32_t qa = 0, ra = 0;
        int64_t w = 0, k = 0;
        for (; k < L; k++) {
            uint8_t b = s[k];
            uint8_t g = reg_alphabet[b];
            qa = (qa << 2) | alphabet[b];
            ra = (ra << 2) | g;
            bad += (g == 0);
            if ((k & 15) == 15) { q[w] = qa; r[w] = ra; w++; qa = ra = 0; }
        }
        if (k & 15) {
            int sh = 2 * (16 - (k & 15));
            q[w] = qa << sh; r[w] = ra << sh; w++;
        }
        for (; w < nwords; w++) { q[w] = 0; r[w] = 0; }
        rows[i * stride + 2 * nwords] = (int32_t)L;
        rows[i * stride + 2 * nwords + 1] = 0;
        rows[i * stride + 2 * nwords + 2] = 0;
        rows[i * stride + 2 * nwords + 3] = bad;
    }
}

// Two-pass WGBS seed-index build (the dbseq.cpp:327-514 count-then-fill
// pattern; replaces the numpy global argsort, whose peak memory at
// human-genome scale is several times the index itself).
//
// blocks: (nb, 4) int64 rows [parity, chr, begin, end], pre-ordered by the
// caller exactly as the enumeration requires (Watson blocks in (id, begin)
// order first, then Crick: dbseq.cpp:441-480).  begin/end are chr-local.
// pass 1 fills counts[3^S] (and wcounts for Watson blocks); pass 2 scatters
// global per-strand coordinates into locs at offsets[seed] + cursor.
// Seeds roll forward by index_interval digits per sample (base-3, T->C
// collapsed lanes) instead of recomputing all S digits.
static inline int64_t seed_at(const uint32_t* base, int64_t pos, int64_t S) {
    int64_t v = 0;
    for (int64_t k = 0; k < S; k++) {
        int64_t p = pos + k;
        uint32_t c = (base[p >> 4] >> (2 * (15 - (p & 15)))) & 3u;
        v = v * 3 + (c == 3u ? 1u : c);
    }
    return v;
}

void bsmap_index_pass(const uint32_t* refcat, const uint32_t* crefcat,
                      const int64_t* chr_w0, const int64_t* anchors,
                      const int64_t* blocks, int64_t nb,
                      int64_t S, int64_t I, int32_t pass,
                      uint32_t* counts, uint32_t* wcounts,
                      const int64_t* offsets, int64_t* cursors,
                      uint32_t* locs) {
    int64_t pow_hi = 1;                      // 3^(S-I)
    for (int64_t k = 0; k < S - I; k++) pow_hi *= 3;
    for (int64_t b = 0; b < nb; b++) {
        int64_t parity = blocks[b * 4 + 0];
        int64_t chr = blocks[b * 4 + 1];
        int64_t begin = blocks[b * 4 + 2];
        int64_t end = blocks[b * 4 + 3];
        int64_t i0 = (begin / I) * I;
        int64_t i2 = ((end - S) / I) * I;
        if (i2 < i0) continue;
        const uint32_t* base =
            (parity ? crefcat : refcat) + chr_w0[chr];
        int64_t anchor = anchors[chr];
        int64_t v = seed_at(base, i0, S);
        for (int64_t pos = i0;; pos += I) {
            if (pass == 1) {
                counts[v]++;
                if (parity == 0) wcounts[v]++;
            } else {
                locs[offsets[v] + cursors[v]++] = (uint32_t)(anchor + pos);
            }
            if (pos + I > i2) break;
            if (I < S) {
                v %= pow_hi;                 // roll I digits forward
                for (int64_t j = 0; j < I; j++) {
                    int64_t p = pos + S + j;
                    uint32_t c =
                        (base[p >> 4] >> (2 * (15 - (p & 15)))) & 3u;
                    v = v * 3 + (c == 3u ? 1u : c);
                }
            } else {
                v = seed_at(base, pos + I, S);
            }
        }
    }
}

// FilterReads (align.cpp:579-589) over a parsed block, in place:
// TrimAdapter (align.cpp:371-425, incl. the RRBS digestion-prefix re-score)
// -> TrimLowQual (align.cpp:59-79, incl. the -z SAM rescale quirk that
// rewrites the quality bytes in place — callers pass a WRITABLE buffer
// exactly when out_sam && zero_qual != '!' && qual_threshold > 0)
// -> min-length and N-count checks -> mismatch-budget rescale
// (align.cpp:586).  rec seq/qual lengths are truncated in place.
// adapters: concatenated bytes with ad_off[n_ad+1] offsets.
// dig_prefix/prefix_len: digest_site[:len-digest_pos] for the RRBS re-score.
// info per read (int32 x 3): [filtered, budget, raw_len].
void bsmap_filter_block(uint8_t* buf, int64_t* rec, int64_t n,
                        const uint8_t* adapters, const int64_t* ad_off,
                        int64_t n_ad, int32_t rrbs,
                        const uint8_t* dig_prefix, int64_t prefix_len,
                        int32_t pairend, int64_t seed_size,
                        int32_t qual_threshold, int32_t zero_qual,
                        int32_t out_sam, int64_t min_read_size,
                        int64_t max_ns, int64_t max_snp_num,
                        uint8_t synth_qual, const uint8_t* reg_alphabet,
                        int32_t* info) {
    for (int64_t i = 0; i < n; i++) {
        int64_t* r = rec + i * 6;
        const uint8_t* seq = buf + r[2];
        int64_t L = r[3];
        int64_t raw = L;
        // --- TrimAdapter -------------------------------------------------
        int64_t cut = -1;
        if (rrbs) {
            for (int64_t a = 0; a < n_ad && cut < 0; a++) {
                const uint8_t* ad = adapters + ad_off[a];
                int64_t alen = ad_off[a + 1] - ad_off[a];
                for (int64_t pos = seed_size; pos < L - 5; pos++) {
                    int64_t m0 = 0, k = 0;
                    int64_t limit = alen < 15 ? alen : 15;
                    if (limit > L - pos) limit = L - pos;
                    while (k < limit) {
                        if (ad[k] != seq[pos + k]) { if (++m0 > 4) break; }
                        k++;
                    }
                    if (k < m0 * 5) continue;
                    // digestion-site prefix re-match, C->T tolerant
                    // (align.cpp:384-387); start = pos - prefix_len
                    int64_t start = pos - prefix_len;
                    int64_t m = m0;
                    for (int64_t t = 0; t < prefix_len; t++) {
                        uint8_t a2 = dig_prefix[t], r2 = seq[start + t];
                        if (a2 != r2 && !(a2 == 'C' && r2 == 'T')) m++;
                    }
                    if (k >= m * 5) { cut = pos; break; }
                    if (pairend) {      // G->A tolerant (align.cpp:394-405)
                        m = m0;
                        for (int64_t t = 0; t < prefix_len; t++) {
                            uint8_t a2 = dig_prefix[t], r2 = seq[start + t];
                            if (a2 != r2 && !(a2 == 'G' && r2 == 'A')) m++;
                        }
                        if (k >= m * 5) { cut = pos; break; }
                    }
                }
            }
        } else {
            for (int64_t a = 0; a < n_ad && cut < 0; a++) {
                const uint8_t* ad = adapters + ad_off[a];
                int64_t alen = ad_off[a + 1] - ad_off[a];
                for (int64_t pos = seed_size; pos < L - 4; pos++) {
                    int64_t m0 = 0, k = 0;
                    int64_t limit = alen < 15 ? alen : 15;
                    if (limit > L - pos) limit = L - pos;
                    while (k < limit) {
                        if (ad[k] != seq[pos + k]) { if (++m0 > 4) break; }
                        k++;
                    }
                    if (k >= m0 * 5 && k > 3) { cut = pos; break; }
                }
            }
        }
        if (cut >= 0) {
            r[3] = cut;
            if (r[5] > cut) r[5] = cut;
            L = cut;
        }
        // --- TrimLowQual -------------------------------------------------
        int32_t filtered = 0;
        int64_t qlen = r[5];
        if (qual_threshold > 0 && qlen != 1) {
            int32_t zq = zero_qual;
            if (r[4] >= 0) {
                uint8_t* q = buf + r[4];
                if (out_sam && zq != '!') {
                    int32_t delta = zq - '!';   // align.cpp:63-67 rescale
                    for (int64_t k = 0; k < qlen; k++)
                        q[k] = (uint8_t)(q[k] - delta);
                    zq = '!';
                }
                int32_t cutoff = zq + qual_threshold;
                int64_t ii = qlen;
                while (ii > 0 && q[ii - 1] <= cutoff) ii--;
                if (ii == 0 || ii < seed_size) filtered = 1;
                else {
                    if (r[5] > ii) r[5] = ii;
                    if (r[3] > ii) { r[3] = ii; L = ii; }
                }
            } else {
                // synthetic FASTA quality: every lane == synth_qual
                int32_t cutoff = ((out_sam && zq != '!') ? '!' : zq)
                                 + qual_threshold;
                int32_t synth = (out_sam && zq != '!')
                                ? synth_qual - (zq - '!') : synth_qual;
                if (synth <= cutoff || qlen < seed_size) filtered = 1;
            }
        }
        // --- length / N checks + budget ----------------------------------
        if (!filtered && L < min_read_size) filtered = 1;
        if (!filtered) {
            int64_t bad = 0;
            for (int64_t k = 0; k < L; k++)
                bad += (reg_alphabet[seq[k]] == 0);
            if (bad > max_ns) filtered = 1;
        }
        info[i * 3 + 0] = filtered;
        info[i * 3 + 1] = (int32_t)(raw > 0
            ? (max_snp_num + 1) * (L - 1) / raw : 0);
        info[i * 3 + 2] = (int32_t)raw;
    }
}

// CCGG_seglen (dbseq.cpp:541-567 as reproduced in reference.py:331-365):
// digestion fragment (1-based start, length) containing Watson pos.
// sites are CHR-LOCAL positions, flattened with per-chr offsets.
static inline void ccgg_seglen_c(const int64_t* sites, int64_t nsites,
                                 int64_t tail, int64_t pos, int64_t readlen,
                                 int64_t* zp, int64_t* zl) {
    if (nsites == 0) { *zp = 1; *zl = 0; return; }
    int64_t left = 0, right = nsites - 1;
    while (left < right - 1) {
        int64_t mid = (left + right) / 2;
        int64_t mv = sites[mid];
        if (mv == pos) { left = mid; right = mid + 1; break; }
        else if (mv < pos) left = mid;
        else right = mid;
    }
    int64_t seg_start = sites[left];
    int64_t seg_end = sites[nsites - 1] + tail;
    while (right < nsites) {
        seg_end = sites[right] + tail;
        if (seg_end >= pos + readlen) break;
        right++;
    }
    if (right < nsites) seg_end = sites[right] + tail;
    *zp = seg_start + 1;
    *zl = seg_end - seg_start;
}

static inline uint8_t* put_u32(uint8_t* o, uint32_t v) {
    char tmp[10];
    int k = 0;
    do {
        tmp[k++] = '0' + (v % 10);
        v /= 10;
    } while (v);
    while (k) *o++ = tmp[--k];
    return o;
}

static inline uint8_t* put_str(uint8_t* o, const char* s) {
    while (*s) *o++ = (uint8_t)*s++;
    return o;
}

static inline uint8_t* put_i32(uint8_t* o, int64_t v) {
    if (v < 0) { *o++ = '-'; v = -v; }
    return put_u32(o, (uint32_t)v);
}

// Reference-context string (XR tag / BSP column 9; align.cpp:670-688):
// 2 lowercase flank chars + the read span + 2 lowercase, decoded from the
// CONCATENATED Watson packing (pointer arithmetic reads straight past the
// chromosome end like the reference).  mapseq is a persistent 256-byte
// buffer whose leading slots keep their previous content when loc < 2 (the
// reference's ptr advances on `continue`: align.cpp:673).
// Returns the context length (read_len + 4).
static inline int64_t ref_context(const uint32_t* refcat, int64_t total_codes,
                                  const int64_t* anchors, const char* un,
                                  uint8_t* mapseq, int64_t chrp, int64_t loc,
                                  int64_t read_len) {
    int64_t anchor = anchors[chrp >> 1];
    int64_t ptr = 0;
    for (int64_t ii = 2; ii >= 1; ii--) {
        if (loc >= ii) {
            int64_t g = anchor + loc - ii;
            uint32_t c = (g >= 0 && g < total_codes)
                ? ((refcat[g >> 4] >> (2 * (15 - (g & 15)))) & 3u) : 0u;
            mapseq[ptr] = (uint8_t)(un[c] + 32);
        }
        ptr++;
    }
    for (int64_t ii = 0; ii < read_len + 2; ii++) {
        int64_t g = anchor + loc + ii;
        uint32_t c = (g >= 0 && g < total_codes)
            ? ((refcat[g >> 4] >> (2 * (15 - (g & 15)))) & 3u) : 0u;
        mapseq[ptr++] = (uint8_t)un[c];
    }
    mapseq[ptr - 1] += 32;
    mapseq[ptr - 2] += 32;
    return ptr;
}

// Format one block of SE SAM lines (s_OutHit SAM branch, align.cpp:631-765;
// no RRBS tags — callers route -D runs to the exact Python path).
//
// status per read: 0 = skip (formatted by the caller: replays/BSP),
//                  1 = QC-filtered, 2 = device result row.
// rows: (n, 2) int32 lean rows: word 0 = watson loc, word 1 = packed bits
// (device_engine.BIT_* layout: found|chain<<1|replay<<2|ok<<3|big<<4|
//  multi<<5|ii<<6|chrp<<10).
// Returns bytes written, or -1 if out_cap could be exceeded (caller grows
// the buffer and retries).  line_off (n+1 int64) gets per-read output
// offsets so the caller can splice Python-formatted reads in order.
int64_t bsmap_format_sam_block_xr(
    const uint8_t* buf, const int64_t* rec, int64_t n, const int32_t* status,
    const int32_t* rows, const uint8_t* chrnames, const int64_t* chrname_off,
    const uint8_t* revc, int32_t flag_base, int32_t out_unmap, int32_t rrhits,
    uint8_t synth_qual, int32_t out_ref, const uint32_t* refcat,
    int64_t total_codes, const int64_t* anchors, const char* useful_nt,
    uint8_t* mapseq, int32_t rrbs, const int64_t* rr_sites,
    const int64_t* rr_site_off, int64_t rr_tail,
    uint8_t* out, int64_t out_cap, int64_t* line_off,
    int64_t* n_aligned);

int64_t bsmap_format_sam_block(
    const uint8_t* buf, const int64_t* rec, int64_t n, const int32_t* status,
    const int32_t* rows,
    const uint8_t* chrnames, const int64_t* chrname_off,
    const uint8_t* revc,           // 256-entry complement table
    int32_t flag_base, int32_t out_unmap, int32_t rrhits,
    uint8_t synth_qual, int32_t rrbs, const int64_t* rr_sites,
    const int64_t* rr_site_off, int64_t rr_tail,
    uint8_t* out, int64_t out_cap,
    int64_t* line_off, int64_t* n_aligned) {
    return bsmap_format_sam_block_xr(
        buf, rec, n, status, rows, chrnames, chrname_off, revc, flag_base,
        out_unmap, rrhits, synth_qual, 0, 0, 0, 0, 0, 0,
        rrbs, rr_sites, rr_site_off, rr_tail, out, out_cap,
        line_off, n_aligned);
}

// SAM block formatter with optional XR:Z: reference-context tag (-R,
// align.cpp:684).  refcat/anchors/useful_nt/mapseq may be null when
// out_ref == 0; mapseq is the caller-held persistent 256-byte context
// buffer (stale-slot quirk, see ref_context).
int64_t bsmap_format_sam_block_xr(
    const uint8_t* buf, const int64_t* rec, int64_t n, const int32_t* status,
    const int32_t* rows,
    const uint8_t* chrnames, const int64_t* chrname_off,
    const uint8_t* revc,
    int32_t flag_base, int32_t out_unmap, int32_t rrhits,
    uint8_t synth_qual, int32_t out_ref,
    const uint32_t* refcat, int64_t total_codes, const int64_t* anchors,
    const char* useful_nt, uint8_t* mapseq, int32_t rrbs,
    const int64_t* rr_sites, const int64_t* rr_site_off, int64_t rr_tail,
    uint8_t* out, int64_t out_cap,
    int64_t* line_off, int64_t* n_aligned) {
    uint8_t* o = out;
    int64_t aligned = 0;
    for (int64_t i = 0; i < n; i++) {
        line_off[i] = o - out;
        int32_t st = status[i];
        if (st == 0) continue;
        // QC lines are suppressed entirely under -r 0 (string_align's outer
        // report_repeat_hits guard, output/sam.py:88-93)
        if (st == 1 && rrhits == 0) continue;
        const int64_t* r = rec + i * 6;
        int64_t name_off = r[0], name_len = r[1];
        int64_t seq_off = r[2], seq_len = r[3];
        int64_t qual_off = r[4], qual_len = r[5];
        if (out_cap - (o - out) <
            name_len + 3 * seq_len + qual_len + 192)
            return -1;
        int32_t wloc = rows[i * 2], w1 = rows[i * 2 + 1];
        int32_t found = w1 & 1, chain = (w1 >> 1) & 1, multi = (w1 >> 5) & 1;
        int32_t level = (w1 >> 6) & 15, chrp = (w1 >> 10) & 0xFFFF;
        uint32_t flag = (uint32_t)flag_base;
        bool mapped = (st == 2) && found;
        if (st == 1) flag |= 0x204;                       // QC (align.cpp:641)
        else if (!found) flag |= 0x4;                     // NM
        else if (multi && rrhits == 0) flag |= 0x104;     // suppressed multi
        else {
            if (multi) flag |= 0x100;
            if ((chain ^ (chrp & 1)) != 0) flag |= 0x10;
        }
        if (!mapped || (multi && rrhits == 0)) {
            if (!out_unmap) continue;
            memcpy(o, buf + name_off, name_len); o += name_len;
            *o++ = '\t'; o = put_u32(o, flag);
            o = put_str(o, "\t*\t0\t0\t*\t*\t0\t0\t");
            memcpy(o, buf + seq_off, seq_len); o += seq_len;
            *o++ = '\t';
            if (qual_off < 0) { memset(o, synth_qual, seq_len); o += seq_len; }
            else { memcpy(o, buf + qual_off, qual_len); o += qual_len; }
            *o++ = '\n';
            continue;
        }
        aligned++;
        memcpy(o, buf + name_off, name_len); o += name_len;
        *o++ = '\t'; o = put_u32(o, flag); *o++ = '\t';
        int64_t c2 = chrp >> 1;
        int64_t cl = chrname_off[c2 + 1] - chrname_off[c2];
        memcpy(o, chrnames + chrname_off[c2], cl); o += cl;
        *o++ = '\t'; o = put_u32(o, (uint32_t)(wloc + 1));
        o = put_str(o, "\t255\t"); o = put_u32(o, (uint32_t)seq_len);
        o = put_str(o, "M\t*\t0\t0\t");
        const uint8_t* s = buf + seq_off;
        if (flag & 0x10) {
            for (int64_t k = seq_len - 1; k >= 0; k--) *o++ = revc[s[k]];
            *o++ = '\t';
            if (qual_off < 0) { memset(o, synth_qual, seq_len); o += seq_len; }
            else {
                const uint8_t* qs = buf + qual_off;
                for (int64_t k = qual_len - 1; k >= 0; k--) *o++ = qs[k];
            }
        } else {
            memcpy(o, s, seq_len); o += seq_len;
            *o++ = '\t';
            if (qual_off < 0) { memset(o, synth_qual, seq_len); o += seq_len; }
            else { memcpy(o, buf + qual_off, qual_len); o += qual_len; }
        }
        o = put_str(o, "\tNM:i:"); o = put_u32(o, (uint32_t)level);
        if (out_ref) {
            o = put_str(o, "\tXR:Z:");
            int64_t cl2 = ref_context(refcat, total_codes, anchors,
                                      useful_nt, mapseq, chrp, wloc,
                                      seq_len);
            memcpy(o, mapseq, cl2); o += cl2;
        }
        if (rrbs) {                             // ZP/ZL tags (align.cpp:684-688)
            int64_t c3 = chrp >> 1;
            int64_t zp, zl;
            ccgg_seglen_c(rr_sites + rr_site_off[c3],
                          rr_site_off[c3 + 1] - rr_site_off[c3], rr_tail,
                          wloc, seq_len, &zp, &zl);
            o = put_str(o, "\tZP:i:"); o = put_i32(o, zp);
            o = put_str(o, "\tZL:i:"); o = put_i32(o, zl);
        }
        o = put_str(o, "\tZS:Z:");
        *o++ = (chrp & 1) ? '-' : '+';
        *o++ = chain ? '-' : '+';
        *o++ = '\n';
    }
    line_off[n] = o - out;
    *n_aligned += aligned;
    return o - out;
}

// Format one block of SE BSP lines (s_OutHit BSP branch, align.cpp:723-760).
// rows are FULL kernel result rows, (n, 2*maxseg + n_extras) int32:
// [per-level (fwd, rc) count pairs | extras], plus synthesized rows for
// host-replayed reads — every read is a row here (no text splicing).
// extras columns used: found, ii, ssum, chain, chrp, wloc (device_engine
// X_* order).  status: 1 = QC-filtered, 2 = result row, 0 = skip.
int64_t bsmap_format_bsp_block(
    const uint8_t* buf, const int64_t* rec, int64_t n, const int32_t* status,
    const int32_t* rows, int64_t row_w, int64_t maxseg,
    const uint8_t* chrnames, const int64_t* chrname_off,
    const uint8_t* revc, int32_t out_unmap, int32_t rrhits,
    int32_t max_snp_num, int32_t max_num_hits, uint8_t synth_qual,
    const uint32_t* refcat, int64_t total_codes, const int64_t* anchors,
    const char* useful_nt, uint8_t* mapseq, const int32_t* budgets,
    uint8_t* out, int64_t out_cap, int64_t* line_off, int64_t* n_aligned) {
    uint8_t* o = out;
    int64_t aligned = 0;
    for (int64_t i = 0; i < n; i++) {
        line_off[i] = o - out;
        int32_t st = status[i];
        if (st == 0) continue;
        // filtered reads emit nothing at all under -r 0 (string_align's
        // outer report_repeat_hits guard, align.cpp:599 path)
        if (st == 1 && rrhits == 0) continue;
        const int64_t* r = rec + i * 6;
        int64_t name_off = r[0], name_len = r[1];
        int64_t seq_off = r[2], seq_len = r[3];
        int64_t qual_off = r[4], qual_len = r[5];
        if (out_cap - (o - out) <
            name_len + 3 * seq_len + qual_len + 256)
            return -1;
        const int32_t* row = rows + i * row_w;
        const int32_t* ex = row + 2 * maxseg;
        // extras order: found, ii, ssum, chain, chrp, wloc (X_FOUND..X_WLOC)
        int32_t found = ex[0], level = ex[1], ssum = ex[2];
        int32_t chain = ex[3], chrp = ex[4], wloc = ex[5];
        int64_t nn = (st == 1) ? -1 : (found ? ssum : 0);
        // suppressed lines (out_unmap off): QC/NM and -r 0 multi
        if (!out_unmap && (nn <= 0 || (nn > 1 && rrhits == 0))) continue;
        memcpy(o, buf + name_off, name_len); o += name_len;
        *o++ = '\t';
        bool rc = nn > 0 && ((chain ^ (chrp & 1)) != 0);
        const uint8_t* s = buf + seq_off;
        if (rc) {
            for (int64_t k = seq_len - 1; k >= 0; k--) *o++ = revc[s[k]];
        } else {
            memcpy(o, s, seq_len); o += seq_len;
        }
        *o++ = '\t';
        if (qual_off < 0) { memset(o, synth_qual, seq_len); o += seq_len; }
        else if (rc) {
            const uint8_t* qs = buf + qual_off;
            for (int64_t k = qual_len - 1; k >= 0; k--) *o++ = qs[k];
        } else { memcpy(o, buf + qual_off, qual_len); o += qual_len; }
        *o++ = '\t';
        const char* cls = (nn < 0) ? "QC" : (nn == 0) ? "NM"
            : (nn == 1) ? "UM" : (nn >= max_num_hits) ? "OF" : "MA";
        *o++ = cls[0]; *o++ = cls[1];
        if ((nn > 0 && rrhits == 1) || (nn == 1 && rrhits == 0)) {
            aligned++;
            *o++ = '\t';
            int64_t c2 = chrp >> 1;
            int64_t cl = chrname_off[c2 + 1] - chrname_off[c2];
            memcpy(o, chrnames + chrname_off[c2], cl); o += cl;
            *o++ = '\t'; o = put_u32(o, (uint32_t)(wloc + 1));
            *o++ = '\t';
            *o++ = (chrp & 1) ? '-' : '+';
            *o++ = chain ? '-' : '+';
            o = put_str(o, "\t0\t");          // SE insert size
            int64_t cl2 = ref_context(refcat, total_codes, anchors,
                                      useful_nt, mapseq, chrp, wloc,
                                      seq_len);
            memcpy(o, mapseq, cl2); o += cl2;
            *o++ = '\t'; o = put_u32(o, (uint32_t)level); *o++ = '\t';
            // read_max_snp_num after trimming (align.cpp:586): computed by
            // the caller against the pre-trim raw length
            int64_t budget = budgets[i];
            for (int64_t ii = 0; ii <= budget; ii++) {
                if (ii) *o++ = ':';
                uint32_t h = (ii < maxseg)
                    ? (uint32_t)(row[2 * ii] + row[2 * ii + 1]) : 0u;
                o = put_u32(o, h);
            }
        }
        *o++ = '\n';
    }
    line_off[n] = o - out;
    *n_aligned += aligned;
    return o - out;
}

// ---------------------------------------------------------------------------
// Pair-end block runtime (pairs.cpp semantics, SAM branches)
// ---------------------------------------------------------------------------

// FixPairReadName (pairs.cpp:535-555) over parsed rec tables: truncate both
// names to the common prefix ending at its last digit (SAM mode only;
// callers gate).  Mutates name_len in both recs.  Returns the index of the
// first pair with no common prefix (fatal in the reference) or -1.
int64_t bsmap_fix_pair_names(const uint8_t* bufa, int64_t* reca,
                             const uint8_t* bufb, int64_t* recb, int64_t n) {
    for (int64_t i = 0; i < n; i++) {
        const uint8_t* na = bufa + reca[i * 6 + 0];
        const uint8_t* nb = bufb + recb[i * 6 + 0];
        int64_t la = reca[i * 6 + 1], lb = recb[i * 6 + 1];
        if (la == lb && memcmp(na, nb, (size_t)la) == 0) continue;
        int64_t d = -1, i0 = la < lb ? la : lb, k = 0;
        while (k < i0 && na[k] == nb[k]) {
            if (na[k] >= '0' && na[k] <= '9') d = k;
            k++;
        }
        if (k <= 0) return i;
        if (d < 0) d = k - 1;
        reca[i * 6 + 1] = d + 1;
        recb[i * 6 + 1] = d + 1;
    }
    return -1;
}

static inline uint8_t* put_seq_rc(uint8_t* o, const uint8_t* s, int64_t len,
                                  const uint8_t* revc, bool rc) {
    if (rc) { for (int64_t k = len - 1; k >= 0; k--) *o++ = revc[s[k]]; }
    else { memcpy(o, s, (size_t)len); o += len; }
    return o;
}

static inline uint8_t* put_qual2(uint8_t* o, const uint8_t* buf,
                                 int64_t qual_off, int64_t qual_len,
                                 int64_t seq_len, uint8_t synth, bool rev) {
    if (qual_off < 0) { memset(o, synth, (size_t)seq_len); return o + seq_len; }
    const uint8_t* q = buf + qual_off;
    if (rev) { for (int64_t k = qual_len - 1; k >= 0; k--) *o++ = q[k]; }
    else { memcpy(o, q, (size_t)qual_len); o += qual_len; }
    return o;
}

// Per-pair join row consumed by bsmap_format_pair_block (int32 columns).
// The SE-fallback selections (SCH/CHRP/WLOC) are the SORTED-order draws
// (SortHits4PE + the formatter's myrand index, pairs.cpp:163-168, 258-271)
// computed vectorized by the Python caller from the kernel's K-hit lists.
enum {
    P_PAIRED = 0, P_CNT, P_CHAIN, P_NA, P_NB, P_INS,
    P_ACHR, P_ALOC, P_BCHR, P_BLOC,
    P_FND_A, P_II_A, P_SSUM_A, P_SCH_A, P_CHRP_A, P_WLOC_A,
    P_FND_B, P_II_B, P_SSUM_B, P_SCH_B, P_CHRP_B, P_WLOC_B,
    P_NCOL
};

// s_OutHitUnpair SAM branch (pairs.cpp:426-498) for one mate.
static uint8_t* emit_unpair(
    uint8_t* o, const uint8_t* buf, const int64_t* r, int32_t readset,
    int32_t fnd, int32_t lvl, int32_t ssum, int32_t sch, int32_t chrp,
    int32_t wloc, int32_t m_fnd, int32_t m_ssum, int32_t m_sch,
    int32_t m_chrp, int32_t m_wloc, const uint8_t* chrnames,
    const int64_t* chrname_off, const uint8_t* revc, int32_t out_unmap,
    int32_t rrhits, uint8_t synth, int64_t* n_aligned_m) {
    int64_t name_off = r[0], name_len = r[1];
    int64_t seq_off = r[2], seq_len = r[3];
    int64_t qual_off = r[4], qual_len = r[5];
    int32_t ma = fnd ? ssum : 0;
    int32_t mb = m_fnd ? m_ssum : 0;
    uint32_t flag = 1u | (uint32_t)(0x40 * readset);
    bool mate_bad = (mb <= 0) || (mb > 1 && rrhits == 0);
    if (ma <= 0 || (ma > 1 && rrhits == 0)) {
        if (!out_unmap) return o;
        flag |= (ma == 0) ? 0x004u : 0x104u;
        if (mate_bad) {
            flag |= 0x008u;
            memcpy(o, buf + name_off, (size_t)name_len); o += name_len;
            *o++ = '\t'; o = put_u32(o, flag);
            o = put_str(o, "\t*\t0\t0\t*\t*\t0\t0\t");
        } else {
            if ((m_sch ^ (m_chrp & 1)) != 0) flag |= 0x020u;
            memcpy(o, buf + name_off, (size_t)name_len); o += name_len;
            *o++ = '\t'; o = put_u32(o, flag);
            o = put_str(o, "\t*\t0\t0\t*\t");
            int64_t c2 = m_chrp >> 1;
            int64_t cl = chrname_off[c2 + 1] - chrname_off[c2];
            memcpy(o, chrnames + chrname_off[c2], (size_t)cl); o += cl;
            *o++ = '\t'; o = put_u32(o, (uint32_t)(m_wloc + 1));
            o = put_str(o, "\t0\t");
        }
        memcpy(o, buf + seq_off, (size_t)seq_len); o += seq_len;
        *o++ = '\t';
        o = put_qual2(o, buf, qual_off, qual_len, seq_len, synth, false);
        *o++ = '\n';
        return o;
    }
    (*n_aligned_m)++;
    if (ma > 1) flag |= 0x100u;
    bool rc = (sch ^ (chrp & 1)) != 0;
    if (rc) flag |= 0x010u;
    if (mate_bad) flag |= 0x008u;
    else if ((m_sch ^ (m_chrp & 1)) != 0) flag |= 0x020u;
    memcpy(o, buf + name_off, (size_t)name_len); o += name_len;
    *o++ = '\t'; o = put_u32(o, flag); *o++ = '\t';
    int64_t c2 = chrp >> 1;
    int64_t cl = chrname_off[c2 + 1] - chrname_off[c2];
    memcpy(o, chrnames + chrname_off[c2], (size_t)cl); o += cl;
    *o++ = '\t'; o = put_u32(o, (uint32_t)(wloc + 1));
    o = put_str(o, "\t255\t"); o = put_u32(o, (uint32_t)seq_len);
    o = put_str(o, "M\t");
    if (mate_bad) {
        o = put_str(o, "*\t0\t0\t");
    } else {
        int64_t mc2 = m_chrp >> 1;
        int64_t mcl = chrname_off[mc2 + 1] - chrname_off[mc2];
        memcpy(o, chrnames + chrname_off[mc2], (size_t)mcl); o += mcl;
        *o++ = '\t'; o = put_u32(o, (uint32_t)(m_wloc + 1));
        o = put_str(o, "\t0\t");
    }
    o = put_seq_rc(o, buf + seq_off, seq_len, revc, rc);
    *o++ = '\t';
    o = put_qual2(o, buf, qual_off, qual_len, seq_len, synth, rc);
    o = put_str(o, "\tNM:i:"); o = put_u32(o, (uint32_t)lvl);
    o = put_str(o, "\tZS:Z:");
    *o++ = (chrp & 1) ? '-' : '+';
    *o++ = sch ? '-' : '+';
    *o++ = '\n';
    return o;
}

// Format one block of PE SAM lines: s_OutHitPair (pairs.cpp:288-424,
// overlap trimming included) + the unpaired fallback (pairs.cpp:244-286).
// No XR/RRBS tags — those configs route to the per-pair Python path.
// status per pair: 0 = skip (Python-formatted replay), 2 = device row.
// line_off: (n+1) int64 per-PAIR offsets for replay splicing.
// counters: int64[3] += {n_aligned_pairs, n_aligned_a, n_aligned_b}.
// Returns bytes written or -1 when out_cap could be exceeded.
int64_t bsmap_format_pair_block(
    const uint8_t* bufa, const int64_t* reca,
    const uint8_t* bufb, const int64_t* recb, int64_t n,
    const int32_t* status, const int32_t* prow,
    const uint8_t* chrnames, const int64_t* chrname_off,
    const uint8_t* revc, int32_t out_unmap, int32_t rrhits,
    uint8_t synth_a, uint8_t synth_b,
    uint8_t* out, int64_t out_cap, int64_t* line_off, int64_t* counters) {
    uint8_t* o = out;
    for (int64_t i = 0; i < n; i++) {
        line_off[i] = o - out;
        if (status[i] == 0) continue;
        const int64_t* ra = reca + i * 6;
        const int64_t* rb = recb + i * 6;
        const int32_t* pr = prow + i * P_NCOL;
        if (out_cap - (o - out) < ra[1] + rb[1] + 3 * (ra[3] + rb[3])
                + ra[5] + rb[5] + 512)
            return -1;
        int fell = 1;
        if (pr[P_PAIRED] > 0 && (pr[P_CNT] == 1 || rrhits == 1)) {
            fell = 0;
            counters[0]++;
            int32_t ins = pr[P_INS], chain = pr[P_CHAIN];
            int32_t achr = pr[P_ACHR], bchr = pr[P_BCHR];
            int64_t aloc = pr[P_ALOC], bloc = pr[P_BLOC];
            int64_t la = ra[3], qa = ra[5], lb = rb[3], qb = rb[5];
            // adapter run-through removal at output time (pairs.cpp:296-306)
            if (ins < la) {
                if ((chain ^ (achr & 1)) != 0) aloc += la - ins;
                la = ins; if (qa > ins) qa = ins;
            }
            if (ins < lb) {
                if (((1 - chain) ^ (bchr & 1)) != 0) bloc += lb - ins;
                lb = ins; if (qb > ins) qb = ins;
            }
            for (int m = 0; m < 2; m++) {
                const int64_t* r = m == 0 ? ra : rb;
                const uint8_t* buf = m == 0 ? bufa : bufb;
                int32_t chain_m = m == 0 ? chain : 1 - chain;
                int32_t chrp = m == 0 ? achr : bchr;
                int64_t loc = m == 0 ? aloc : bloc;
                int64_t mloc = m == 0 ? bloc : aloc;
                int32_t nm = m == 0 ? pr[P_NA] : pr[P_NB];
                int64_t slen = m == 0 ? la : lb;
                int64_t qlen = m == 0 ? qa : qb;
                uint8_t synth = m == 0 ? synth_a : synth_b;
                uint32_t flag = 0x3u | (pr[P_CNT] > 1 ? 0x100u : 0u)
                                | (uint32_t)(0x40 << m);
                bool rc = (chain_m ^ (chrp & 1)) != 0;
                flag |= rc ? 0x10u : 0x20u;
                int64_t isize = rc ? -(int64_t)ins : (int64_t)ins;
                memcpy(o, buf + r[0], (size_t)r[1]); o += r[1];
                *o++ = '\t'; o = put_u32(o, flag); *o++ = '\t';
                int64_t c2 = chrp >> 1;
                int64_t cl = chrname_off[c2 + 1] - chrname_off[c2];
                memcpy(o, chrnames + chrname_off[c2], (size_t)cl); o += cl;
                *o++ = '\t'; o = put_u32(o, (uint32_t)(loc + 1));
                o = put_str(o, "\t255\t"); o = put_u32(o, (uint32_t)slen);
                o = put_str(o, "M\t=\t");
                o = put_u32(o, (uint32_t)(mloc + 1));
                *o++ = '\t'; o = put_i32(o, isize); *o++ = '\t';
                o = put_seq_rc(o, buf + r[2], slen, revc, rc);
                *o++ = '\t';
                o = put_qual2(o, buf, r[4], qlen, slen, synth, rc);
                o = put_str(o, "\tNM:i:"); o = put_u32(o, (uint32_t)nm);
                o = put_str(o, "\tZS:Z:");
                *o++ = (chrp & 1) ? '-' : '+';
                *o++ = chain_m ? '-' : '+';
                *o++ = '\n';
            }
        }
        if (fell) {
            o = emit_unpair(o, bufa, ra, 1, pr[P_FND_A], pr[P_II_A],
                            pr[P_SSUM_A], pr[P_SCH_A], pr[P_CHRP_A],
                            pr[P_WLOC_A], pr[P_FND_B], pr[P_SSUM_B],
                            pr[P_SCH_B], pr[P_CHRP_B], pr[P_WLOC_B],
                            chrnames, chrname_off, revc, out_unmap, rrhits,
                            synth_a, &counters[1]);
            o = emit_unpair(o, bufb, rb, 2, pr[P_FND_B], pr[P_II_B],
                            pr[P_SSUM_B], pr[P_SCH_B], pr[P_CHRP_B],
                            pr[P_WLOC_B], pr[P_FND_A], pr[P_SSUM_A],
                            pr[P_SCH_A], pr[P_CHRP_A], pr[P_WLOC_A],
                            chrnames, chrname_off, revc, out_unmap, rrhits,
                            synth_b, &counters[2]);
        }
    }
    line_off[n] = o - out;
    return o - out;
}

}  // extern "C"
