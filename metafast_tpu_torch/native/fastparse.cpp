// Native FASTA/FASTQ parser: text buffer -> 2-bit packed codes + lengths.
//
// TPU-native replacement for the reference's dispatcher/worker read pool
// (src/io/ReadsDispatcher.java, itmo io/readers/*): one linear scan over
// the (already decompressed) text produces the concatenated 2-bit code
// stream and per-read lengths that feed the device k-mer kernels.
//
// Semantics mirrored from the reference readers:
//   - FASTA: lines between '>' headers concatenate into one read; any
//     invalid character (N, IUPAC, other) drops the whole read
//     (itmo FastaReader.java:55-66)
//   - FASTQ: 4-line records; any invalid sequence character or any
//     quality char equal to the phred offset (phred 0) drops the read
//     (itmo FastqReader.java:74-85, FastaReaderFromXQSource.java:63-77)
//
// Exposed via a plain C ABI for ctypes.

#include <cstdint>
#include <cstring>
#include <cstdlib>

namespace {

// ASCII -> 2-bit code (A=0, G=1, C=2, T=3; itmo DnaTools.java:31-64)
// 255 = invalid
struct Lut {
    uint8_t m[256];
    Lut() {
        memset(m, 255, sizeof(m));
        m[(int)'A'] = m[(int)'a'] = 0;
        m[(int)'G'] = m[(int)'g'] = 1;
        m[(int)'C'] = m[(int)'c'] = 2;
        m[(int)'T'] = m[(int)'t'] = 3;
    }
};
const Lut LUT;

}  // namespace

extern "C" {

// Parse FASTA text.
//   text, n          input buffer
//   codes, codes_cap output concatenated 2-bit codes (one byte per base)
//   lengths, max_reads  per-read lengths
// Returns number of reads written; *n_skipped counts dropped reads;
// *consumed is bytes of input processed (always n for one-shot use).
// A read whose codes would overflow codes_cap stops the scan early
// (*consumed < n lets the caller continue with the rest).
int64_t parse_fasta(const uint8_t* text, int64_t n,
                    uint8_t* codes, int64_t codes_cap,
                    int32_t* lengths, int64_t max_reads,
                    int64_t* n_skipped, int64_t* consumed) {
    int64_t reads = 0, skipped = 0;
    int64_t out = 0;
    int64_t i = 0;
    int64_t read_start_in = 0;  // input offset where current record started
    int64_t read_start_out = 0;
    bool in_read = false;
    uint8_t badacc = 0;  // valid codes only touch bits 0-1; 255 poisons the rest

    auto finish_read = [&]() {
        if (!in_read) return true;
        int64_t len = out - read_start_out;
        if ((badacc & 0xFCu) || len == 0) {
            out = read_start_out;
            skipped++;
        } else {
            if (reads >= max_reads) return false;
            lengths[reads++] = (int32_t)len;
            read_start_out = out;
        }
        in_read = false;
        badacc = 0;
        return true;
    };

    // Line-wise scan: memchr finds newlines at SIMD speed, and the
    // per-base translate loop below is branchless (the invalid-char test
    // accumulates into badacc instead of branching per byte).
    while (i < n) {
        const uint8_t* nl = (const uint8_t*)memchr(text + i, '\n', (size_t)(n - i));
        int64_t eol = nl ? (int64_t)(nl - text) : n;
        int64_t line_end = eol;
        while (line_end > i && text[line_end - 1] == '\r') line_end--;
        uint8_t c0 = text[i];
        if (c0 == '>' || c0 == ';') {
            if (!finish_read()) { *n_skipped = skipped; *consumed = read_start_in; return reads; }
            read_start_in = i;
            in_read = true;
            badacc = 0;
            read_start_out = out;
        } else if (in_read && line_end > i) {
            int64_t len = line_end - i;
            if (out + len > codes_cap) {
                // roll back the partial read; caller resumes at its header
                out = read_start_out;
                *n_skipped = skipped;
                *consumed = read_start_in;
                return reads;
            }
            const uint8_t* src = text + i;
            uint8_t acc = 0;
            for (int64_t p = 0; p < len; p++) {
                uint8_t v = LUT.m[src[p]];
                acc |= v;
                codes[out + p] = (uint8_t)(v & 3u);
            }
            badacc |= acc;
            out += len;
        }
        i = eol + 1;
    }
    finish_read();
    *n_skipped = skipped;
    *consumed = n;
    return reads;
}

// Parse FASTQ text (4-line records).  phred_offset: 33 or 64.
int64_t parse_fastq(const uint8_t* text, int64_t n, int32_t phred_offset,
                    uint8_t* codes, int64_t codes_cap,
                    int32_t* lengths, int64_t max_reads,
                    int64_t* n_skipped, int64_t* consumed) {
    int64_t reads = 0, skipped = 0;
    int64_t out = 0;
    int64_t i = 0;

    while (i < n) {
        int64_t rec_start = i;
        // line 1: @header
        if (text[i] != '@') { i++; continue; }
        while (i < n && text[i] != '\n') i++;
        if (i >= n) break;
        i++;
        // line 2: sequence
        int64_t seq_start = i;
        while (i < n && text[i] != '\n') i++;
        if (i >= n) break;
        int64_t seq_end = i;
        while (seq_end > seq_start && text[seq_end - 1] == '\r') seq_end--;
        i++;
        // line 3: +
        if (i >= n || text[i] != '+') break;
        while (i < n && text[i] != '\n') i++;
        if (i >= n) break;
        i++;
        // line 4: quality
        int64_t q_start = i;
        while (i < n && text[i] != '\n') i++;
        int64_t q_end = i;
        while (q_end > q_start && text[q_end - 1] == '\r') q_end--;
        if (q_end - q_start < seq_end - seq_start) {
            if (i >= n) { break; }  // truncated record: wait for more input
        }
        if (i < n) i++;

        int64_t len = seq_end - seq_start;
        if (reads >= max_reads || out + len > codes_cap) {
            *n_skipped = skipped;
            *consumed = rec_start;
            return reads;
        }
        bool bad = (q_end - q_start) < len;  // malformed: quality too short
        if (!bad) {
            // branchless: invalid chars poison badacc's high bits; any
            // phred-0 base drops the read ('.'/'N' carry phred 0 by
            // convention, itmo FastaReaderFromXQSource.java:63-77)
            const uint8_t* sp = text + seq_start;
            const uint8_t* qp = text + q_start;
            uint8_t badacc = 0, qbad = 0;
            for (int64_t p = 0; p < len; p++) {
                uint8_t v = LUT.m[sp[p]];
                badacc |= v;
                qbad |= (uint8_t)((int32_t)qp[p] <= phred_offset);
                codes[out + p] = (uint8_t)(v & 3u);
            }
            bad = (badacc & 0xFCu) || qbad;
        }
        if (bad) {
            skipped++;
        } else {
            out += len;
            lengths[reads++] = (int32_t)len;
        }
    }
    *n_skipped = skipped;
    *consumed = n;
    return reads;
}

// Canonical k-mer extraction on host (for CPU-side tools): fills keys
// with min(fw, rc) for every window of every read; returns #keys.
int64_t extract_canonical(const uint8_t* codes, const int32_t* lengths,
                          int64_t n_reads, int32_t k, int64_t* keys,
                          int64_t keys_cap) {
    int64_t out = 0;
    int64_t off = 0;
    const uint64_t mask = (k == 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
    for (int64_t r = 0; r < n_reads; r++) {
        int32_t len = lengths[r];
        if (len >= k) {
            uint64_t fw = 0, rc = 0;
            for (int32_t p = 0; p < len; p++) {
                uint64_t c = codes[off + p];
                fw = ((fw << 2) | c) & mask;
                rc = (rc >> 2) | ((3ULL - c) << (2 * (k - 1)));
                if (p >= k - 1) {
                    if (out >= keys_cap) return out;
                    keys[out++] = (int64_t)(fw < rc ? fw : rc);
                }
            }
        }
        off += len;
    }
    return out;
}

// Pack flat codes + read lengths into the overlapping word-column layout
// consumed by the flat-stream extraction kernel (ops/stream_extract.py).
//
//   codes    flat 2-bit codes (one byte per base), n_codes bytes
//   lengths  n_reads int32 read lengths (sum == n_codes)
//   k        k-mer size
//   col_w    [n_cols, ROWS=256] u32 row-major: rows 0..253 hold stream
//            words (16 codes each, code j at bits 2j), rows 254-255
//            duplicate the next column's first two words
//   col_v    same layout; low 16 bits of word w flag positions 16w+r
//            that start a window lying inside a single read (overlap
//            rows stay 0)
// The device transposes to [ROWS, n_cols]; callers zero col_v first.
void build_stream_cols(const uint8_t* codes, int64_t n_codes,
                       const int32_t* lengths, int64_t n_reads, int32_t k,
                       uint32_t* col_w, uint32_t* col_v, int64_t n_cols) {
    const int64_t ROWS = 256, PAYLOAD = 254;
    const int64_t payload_words = n_cols * PAYLOAD;

    // stream words, written to (col, row) plus the overlap duplicates
    for (int64_t w = 0; w < payload_words + 2; w++) {
        int64_t base = 16 * w;
        uint32_t val = 0;
        if (base + 16 <= n_codes) {
            const uint8_t* s = codes + base;
            for (int j = 0; j < 16; j++) val |= (uint32_t)s[j] << (2 * j);
        } else if (base < n_codes) {
            const uint8_t* s = codes + base;
            for (int64_t j = 0; j < n_codes - base; j++)
                val |= (uint32_t)s[j] << (2 * j);
        }
        if (w < payload_words)
            col_w[(w / PAYLOAD) * ROWS + (w % PAYLOAD)] = val;
        if (w % PAYLOAD < 2 && w >= PAYLOAD)
            col_w[(w / PAYLOAD - 1) * ROWS + PAYLOAD + (w % PAYLOAD)] = val;
        if (w >= payload_words)    // overlap rows of the final column
            col_w[(n_cols - 1) * ROWS + PAYLOAD + (w - payload_words)] = val;
    }

    // validity bitmask: read spanning [off, off+len) marks window starts
    // [off, off+len-k] (inclusive) when len >= k
    int64_t off = 0;
    for (int64_t r = 0; r < n_reads; r++) {
        int64_t len = lengths[r];
        if (len >= k) {
            int64_t start = off, end = off + len - k;   // inclusive
            int64_t w0 = start >> 4, w1 = end >> 4;
            for (int64_t w = w0; w <= w1; w++) {
                uint32_t m = 0xFFFFu;
                if (w == w0) m &= (0xFFFFu << (start & 15)) & 0xFFFFu;
                if (w == w1) m &= 0xFFFFu >> (15 - (end & 15));
                if (w < payload_words)
                    col_v[(w / PAYLOAD) * ROWS + (w % PAYLOAD)] |= m;
            }
        }
        off += len;
    }
}

// Pack a batch of reads into a row-padded 2-bit matrix in one pass.
//   codes     concatenated 2-bit-per-byte code stream
//   offsets   per-read start offsets into codes, n_reads+1 entries
//   out       rows x (L/4) bytes, rows >= n_reads; fully overwritten
// Replaces the two-pass NumPy pad-then-pack (native_reads.to_batches +
// pack_2bit), which costs ~1s per 100M bases on the host hot path.
void pack_batch(const uint8_t* codes, const int64_t* offsets,
                int64_t n_reads, int32_t L, uint8_t* out, int64_t rows) {
    const int64_t stride = L / 4;
    for (int64_t r = 0; r < n_reads; r++) {
        const uint8_t* src = codes + offsets[r];
        int64_t len = offsets[r + 1] - offsets[r];
        uint8_t* dst = out + r * stride;
        int64_t full = len / 4;
        int64_t j = 0;
        for (; j < full; j++) {
            const uint8_t* s = src + 4 * j;
            dst[j] = (uint8_t)(s[0] | (s[1] << 2) | (s[2] << 4) | (s[3] << 6));
        }
        if (4 * j < len) {
            uint8_t b = 0;
            for (int64_t t = 4 * j; t < len; t++)
                b |= (uint8_t)(src[t] << (2 * (t - 4 * j)));
            dst[j++] = b;
        }
        if (j < stride) memset(dst + j, 0, (size_t)(stride - j));
    }
    if (n_reads < rows)
        memset(out + n_reads * stride, 0, (size_t)((rows - n_reads) * stride));
}

// Compact 3-stream column builder (r5): each read starts at a fresh
// 16-code word boundary and contributes ONLY the words that contain
// valid window starts (ceil((len-k+1)/16) per read); the one/two-word
// lookahead context rides as separate aligned arrays, so the device
// kernel needs no overlap rows and the sort — the counting bound —
// runs on ~6% padding instead of ~21% + boundary waste.
//   codes/lengths  the parser's concatenated 2-bit codes
//   w0/w1/w2/vm    [n_cols, 256] u32 outputs (row-major numpy arrays;
//                  emit word g lands at flat index g); n_cols*256 must
//                  be >= the total emit word count (caller computes it)
void build_stream3_cols(const uint8_t* codes, int64_t n_codes,
                        const int32_t* lengths, int64_t n_reads,
                        int32_t k, uint32_t* w0, uint32_t* w1,
                        uint32_t* w2, uint32_t* vm, int64_t cap_words) {
    (void)n_codes;
    int64_t g = 0;        // global emit word index
    int64_t off = 0;      // read offset into codes
    for (int64_t r = 0; r < n_reads; r++) {
        int32_t len = lengths[r];
        if (len < k) { off += len; continue; }
        int32_t n_win = len - k + 1;
        int32_t e = (n_win + 15) / 16;
        const uint8_t* rc = codes + off;
        // pack words 0 .. e+1 of this read (zero beyond len)
        uint32_t prev = 0, cur = 0;
        // compute word t lazily: w(t) packs codes [16t, 16t+16)
        auto word_at = [&](int32_t t) -> uint32_t {
            uint32_t w = 0;
            int32_t base = 16 * t;
            int32_t end = base + 16 < len ? base + 16 : len;
            for (int32_t p = base; p < end; p++)
                w |= (uint32_t)(rc[p] & 3u) << (2 * (p - base));
            return w;
        };
        uint32_t wa = word_at(0), wb = word_at(1), wc = word_at(2);
        for (int32_t i = 0; i < e; i++) {
            if (g >= cap_words) return;    // caller sized this; safety
            w0[g] = wa;
            w1[g] = wb;
            w2[g] = wc;
            int32_t rem = n_win - 16 * i;
            vm[g] = rem >= 16 ? 0xFFFFu : ((1u << rem) - 1u);
            g++;
            wa = wb; wb = wc; wc = word_at(i + 3);
        }
        off += len;
        (void)prev; (void)cur;
    }
}

// Reference-style single-thread k-mer counter: rolling canonical ShortKmer
// loop + open-addressing hash table with linear probing and saturating
// 16-bit adds -- a native-speed stand-in for the Java toolkit's hot loop
// (itmo Long2ShortHashMap.java:119-157, src/io/IOUtils.java:756-769),
// used ONLY to calibrate the benchmark baseline (bench.py).
//   table_log2  log2 of table capacity (must leave <75% load)
// Returns number of k-mers counted; *n_unique gets the distinct count.
int64_t count_kmers_baseline(const uint8_t* codes, const int32_t* lengths,
                             int64_t n_reads, int32_t k,
                             uint64_t* table, uint16_t* counts,
                             int32_t table_log2, int64_t* n_unique) {
    const uint64_t mask = (k == 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
    const uint64_t tmask = (1ULL << table_log2) - 1;
    int64_t total = 0, uniq = 0;
    int64_t off = 0;
    for (int64_t r = 0; r < n_reads; r++) {
        int32_t len = lengths[r];
        if (len >= k) {
            uint64_t fw = 0, rc = 0;
            for (int32_t p = 0; p < len; p++) {
                uint64_t c = codes[off + p];
                fw = ((fw << 2) | c) & mask;
                rc = (rc >> 2) | ((3ULL - c) << (2 * (k - 1)));
                if (p >= k - 1) {
                    uint64_t key = (fw < rc ? fw : rc) + 1;  // 0 = empty
                    // murmur-style finalizer, like the reference's
                    // murmurHash3 position hash
                    uint64_t h = key;
                    h ^= h >> 33; h *= 0xFF51AFD7ED558CCDULL;
                    h ^= h >> 33; h *= 0xC4CEB9FE1A85EC53ULL;
                    h ^= h >> 33;
                    uint64_t pos = h & tmask;
                    while (table[pos] != 0 && table[pos] != key)
                        pos = (pos + 1) & tmask;
                    if (table[pos] == 0) { table[pos] = key; uniq++; }
                    if (counts[pos] < 32767) counts[pos]++;
                    total++;
                }
            }
        }
        off += len;
    }
    *n_unique = uniq;
    return total;
}

// ---------------------------------------------------------------------------
// Native graph-stage baselines.  Single-thread stand-ins for the reference's
// contig walk (src/algo/AddSequencesShiftingRightTask.java:74-99, probing via
// src/algo/HashMapOperations.java:13-47) and BFS component builder
// (src/algo/ComponentsBuilder.java:220-269, neighbors from
// src/algo/KmerOperations.java:9-27).  Used ONLY to calibrate bench.py's
// vs_native for the TPU graph stages -- these anchor the claim that the
// device formulations beat the toolkit's per-core rate, the way
// count_kmers_baseline anchors the counting core.

struct KHash {
    // open addressing, linear probing; key+1 stored so 0 = empty slot
    uint64_t* slots;
    int32_t* vals;
    uint64_t mask;
};

static inline uint64_t khash_mix(uint64_t h) {
    h ^= h >> 33; h *= 0xFF51AFD7ED558CCDULL;
    h ^= h >> 33; h *= 0xC4CEB9FE1A85EC53ULL;
    return h ^ (h >> 33);
}

static inline int64_t khash_find(const KHash& H, uint64_t key) {
    uint64_t k1 = key + 1;
    uint64_t pos = khash_mix(k1) & H.mask;
    while (H.slots[pos] != 0) {
        if (H.slots[pos] == k1) return (int64_t)pos;
        pos = (pos + 1) & H.mask;
    }
    return -1;
}

static inline void khash_put(KHash& H, uint64_t key, int32_t val) {
    uint64_t k1 = key + 1;
    uint64_t pos = khash_mix(k1) & H.mask;
    while (H.slots[pos] != 0 && H.slots[pos] != k1)
        pos = (pos + 1) & H.mask;
    H.slots[pos] = k1;
    H.vals[pos] = val;
}

static inline uint64_t rc_kmer(uint64_t v, int32_t k) {
    // complement (3-x per 2-bit nuc) then reverse 2-bit groups
    uint64_t x = ~v;
    x = ((x & 0x3333333333333333ULL) << 2) | ((x >> 2) & 0x3333333333333333ULL);
    x = ((x & 0x0F0F0F0F0F0F0F0FULL) << 4) | ((x >> 4) & 0x0F0F0F0F0F0F0F0FULL);
    x = ((x & 0x00FF00FF00FF00FFULL) << 8) | ((x >> 8) & 0x00FF00FF00FF00FFULL);
    x = ((x & 0x0000FFFF0000FFFFULL) << 16) | ((x >> 16) & 0x0000FFFF0000FFFFULL);
    x = (x << 32) | (x >> 32);
    return x >> (64 - 2 * k);
}

// unique right extension of oriented (fw, rc): 0..3, -1 none, -2 fork --
// the probe pattern of HashMapOperations.getRightNucleotide (4 map gets)
static inline int32_t right_nuc(const KHash& H, uint64_t fw, uint64_t rc,
                                uint64_t mask, int32_t k) {
    int32_t ans = -1;
    for (uint64_t nuc = 0; nuc < 4; nuc++) {
        uint64_t nfw = ((fw << 2) | nuc) & mask;
        uint64_t nrc = (rc >> 2) | ((3ULL - nuc) << (2 * (k - 1)));
        uint64_t can = nfw < nrc ? nfw : nrc;
        if (khash_find(H, can) >= 0) {
            if (ans >= 0) return -2;
            ans = (int32_t)nuc;
        }
    }
    return ans;
}

static inline int32_t left_nuc(const KHash& H, uint64_t fw, uint64_t rc,
                               uint64_t mask, int32_t k) {
    int32_t ans = -1;
    for (uint64_t nuc = 0; nuc < 4; nuc++) {
        uint64_t nfw = (fw >> 2) | (nuc << (2 * (k - 1)));
        uint64_t nrc = ((rc << 2) | (3ULL - nuc)) & mask;
        uint64_t can = nfw < nrc ? nfw : nrc;
        if (khash_find(H, can) >= 0) {
            if (ans >= 0) return -2;
            ans = (int32_t)nuc;
        }
    }
    return ans;
}

// Contig walk over a counted canonical k-mer table.  For every key, both
// orientations: detect "left end" (no unique left extension, or the left
// predecessor has a right fork), then walk right while extensions stay
// unique, accumulating length/weight -- the exact probe pattern of
// AddSequencesShiftingRightTask.processSequence (8 probes + 1 get per
// step).  Emits nothing; returns total chain nodes walked and fills
// n_seq/total_len so callers can sanity-check against the TPU stage.
int64_t contig_walk_baseline(const uint64_t* keys, const int32_t* counts,
                             int64_t n, int32_t k, int32_t len_threshold,
                             int32_t table_log2, int64_t* n_seq,
                             int64_t* total_len) {
    const uint64_t mask = (k == 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
    uint64_t cap = 1ULL << table_log2;
    KHash H;
    H.slots = (uint64_t*)calloc(cap, sizeof(uint64_t));
    H.vals = (int32_t*)malloc(cap * sizeof(int32_t));
    H.mask = cap - 1;
    if (!H.slots || !H.vals) { free(H.slots); free(H.vals); return -1; }
    for (int64_t i = 0; i < n; i++) khash_put(H, keys[i], counts[i]);

    int64_t walked = 0, seqs = 0, tlen = 0;
    for (int64_t i = 0; i < n; i++) {
        uint64_t fw0 = keys[i];
        uint64_t rc0 = rc_kmer(fw0, k);
        for (int o = 0; o < 2; o++) {
            uint64_t fw = o == 0 ? fw0 : rc0;
            uint64_t rc = o == 0 ? rc0 : fw0;
            // left-end test (AddSequencesShiftingRightTask.run)
            int32_t ln = left_nuc(H, fw, rc, mask, k);
            bool is_left = false;
            if (ln < 0) {
                is_left = true;
            } else {
                uint64_t pfw = (fw >> 2) | ((uint64_t)ln << (2 * (k - 1)));
                uint64_t prc = ((rc << 2) | (3ULL - (uint64_t)ln)) & mask;
                if (right_nuc(H, pfw, prc, mask, k) < 0) is_left = true;
            }
            if (!is_left) continue;
            // walk right (processSequence)
            uint64_t cfw = fw, crc = rc;
            int64_t len = k;
            int64_t guard = 2 * n + 4;     // palindromic-loop guard
            while (guard-- > 0) {
                int32_t rn = right_nuc(H, cfw, crc, mask, k);
                if (rn < 0) break;
                uint64_t nfw = ((cfw << 2) | (uint64_t)rn) & mask;
                uint64_t nrc = (crc >> 2) | ((3ULL - (uint64_t)rn) << (2 * (k - 1)));
                if (left_nuc(H, nfw, nrc, mask, k) < 0) break;
                cfw = nfw; crc = nrc;
                len++;
                walked++;
            }
            uint64_t st = fw < rc ? fw : rc;
            uint64_t en = cfw < crc ? cfw : crc;
            if (len >= len_threshold && st <= en) {
                seqs++;
                tlen += len;
            }
            walked++;                       // the start node itself
        }
    }
    free(H.slots);
    free(H.vals);
    *n_seq = seqs;
    *total_len = tlen;
    return walked;
}

// Depth-1 pivot component extraction over PRECOMPUTED neighbor index
// tables — the exact imperative mirror of graph/pivot.py's Python BFS
// (itself the parity spec for src/algo/ComponentsBuilderAroundPivot.java:
// unique continuations extend freely; forks are entered only via a
// line probe that reaches an unclaimed pivot; failed probe paths stay
// consumed, their branch head does not).  The traversal is inherently
// sequential (probe order and the visited set are semantics), so the
// hot loop lives here: ~50M nodes/s vs ~50K/s for per-node Python —
// the 10^7-table envelope VERDICT r4 #4 asks for.
//
//   left/right: [n, 4] neighbor indices (-1 = absent)
//   piv:        per-key pivot flag
//   starts:     candidate start indices, ascending
// Outputs: members (concatenated, with path duplicates exactly like the
// Python appends), comp_off ([n_comp+1] prefix), comp_weight/
// comp_npivot per component.  Returns n_comp, or -1 if members_cap or
// max_comps would overflow.
int64_t pivot_bfs_depth1(const int32_t* left, const int32_t* right,
                         const int64_t* counts, const uint8_t* piv,
                         int64_t n, const int64_t* starts,
                         int64_t n_starts, int32_t* members,
                         int64_t members_cap, int64_t* comp_off,
                         int64_t* comp_weight, int64_t* comp_npivot,
                         int64_t max_comps) {
    uint8_t* visited = (uint8_t*)calloc(n, 1);
    uint8_t* pivot_done = (uint8_t*)calloc(n, 1);
    // queue of (node, prev) pairs; each node enqueues at most once
    int32_t* qi = (int32_t*)malloc((size_t)n * sizeof(int32_t));
    int32_t* qp = (int32_t*)malloc((size_t)n * sizeof(int32_t));
    if (!visited || !pivot_done || !qi || !qp) {
        free(visited); free(pivot_done); free(qi); free(qp);
        return -1;
    }
    int64_t n_comp = 0, mout = 0;
    int64_t weight = 0, n_pivot = 0;
    int64_t qh = 0, qt = 0;
    bool overflow = false;

    auto away_side = [&](int32_t i, int32_t prev) -> const int32_t* {
        const int32_t* side = nullptr;
        const int32_t* L = left + 4 * (int64_t)i;
        const int32_t* R = right + 4 * (int64_t)i;
        for (int s = 0; s < 4; s++) if (L[s] == prev) { side = right; break; }
        for (int s = 0; s < 4; s++) if (R[s] == prev) { side = left; break; }
        return side;
    };

    auto visit = [&](int32_t i) {
        visited[i] = 1;
        if (mout < members_cap) members[mout++] = i; else overflow = true;
        weight += counts[i];
        if (piv[i] && !pivot_done[i]) { pivot_done[i] = 1; n_pivot++; }
    };

    // _probe_line: walk unique continuations from branch head j, marking
    // the path visited and claiming its pivots; head restored on failure
    auto probe_line = [&](int32_t j, int32_t parent, int64_t* path_beg,
                          int64_t* path_end) -> int64_t {
        int64_t np = 0;
        int32_t cur = j, prev = parent;
        visited[j] = 1;
        *path_beg = mout;
        while (true) {
            const int32_t* side = away_side(cur, prev);
            if (!side) break;
            const int32_t* row = side + 4 * (int64_t)cur;
            int32_t nxt = -1;
            int cnt = 0;
            for (int s = 0; s < 4; s++) {
                int32_t x = row[s];
                if (x >= 0 && !visited[x]) { nxt = x; cnt++; }
            }
            if (cnt != 1) break;
            if (mout < members_cap) members[mout++] = nxt;
            else { overflow = true; break; }
            visited[nxt] = 1;
            if (piv[nxt] && !pivot_done[nxt]) { pivot_done[nxt] = 1; np++; }
            prev = cur;
            cur = nxt;
        }
        *path_end = mout;
        if (np == 0) visited[j] = 0;
        return np;
    };

    auto expand = [&](int32_t i, const int32_t* side) {
        const int32_t* row = side + 4 * (int64_t)i;
        int32_t nbrs[4];
        int nn = 0;
        for (int s = 0; s < 4; s++) {
            int32_t j = row[s];
            if (j >= 0 && !visited[j]) nbrs[nn++] = j;
        }
        if (nn == 0) return;
        if (nn == 1) {
            int32_t j = nbrs[0];
            visit(j);
            qi[qt] = j; qp[qt] = i; qt++;
            return;
        }
        for (int b = 0; b < nn; b++) {
            int32_t j = nbrs[b];
            if (visited[j]) continue;
            int64_t pb, pe;
            int64_t np = probe_line(j, i, &pb, &pe);
            if (np > 0) {
                // path members were appended during the probe; the
                // probe does NOT add their weights (python adds them in
                // _add_path_member) — add now, then visit j (appends j)
                for (int64_t p = pb; p < pe; p++) weight += counts[members[p]];
                n_pivot += np;
                visit(j);
                int64_t plen = pe - pb;
                if (plen >= 2) {
                    qi[qt] = members[pe - 1]; qp[qt] = members[pe - 2];
                } else if (plen == 1) {
                    qi[qt] = members[pb]; qp[qt] = j;
                } else {
                    qi[qt] = j; qp[qt] = i;
                }
                qt++;
            } else {
                // failed probe: drop its appended path members from the
                // member list (they stay consumed via visited[], exactly
                // like the python which never appends them on failure)
                mout = pb;
            }
        }
    };

    for (int64_t si = 0; si < n_starts && !overflow; si++) {
        int32_t start = (int32_t)starts[si];
        if (pivot_done[start] || visited[start]) continue;
        if (n_comp >= max_comps) { overflow = true; break; }
        weight = 0; n_pivot = 0; qh = qt = 0;
        comp_off[n_comp] = mout;
        visit(start);
        expand(start, right);
        expand(start, left);
        while (qh < qt && !overflow) {
            int32_t i = qi[qh], prev = qp[qh];
            qh++;
            const int32_t* side = away_side(i, prev);
            if (!side) continue;
            expand(i, side);
        }
        comp_weight[n_comp] = weight;
        comp_npivot[n_comp] = n_pivot;
        n_comp++;
    }
    comp_off[n_comp] = mout;
    free(visited); free(pivot_done); free(qi); free(qp);
    return overflow ? -1 : n_comp;
}

// Colored component BFS (default, non-linear mode) — exact mirror of
// graph/colored.py _bfs: BFS from each unvisited colored seed in
// ascending index order; same-color neighbors are consumed (visited),
// gray (color -1) neighbors join the component WITHOUT being consumed
// (so one gray node can belong to several components), other colors
// stop the walk.  Reference: src/algo/ColoredComponentsBuilder.java.
//   nbrs: [n, 8] neighbor indices (-1 absent); color: [n] int8
//   n_comps: per-group component cap (-1 = unlimited)
// Returns the component count, or -1 on members/max_comps overflow
// (caller falls back to Python).
int64_t colored_bfs(const int32_t* nbrs, const int8_t* color, int64_t n,
                    int32_t n_groups, int32_t separate, int64_t n_comps,
                    int32_t* members, int64_t members_cap,
                    int64_t* comp_off, int32_t* comp_color,
                    int64_t max_comps) {
    uint8_t* visited = (uint8_t*)calloc(n, 1);
    int64_t* in_comp = (int64_t*)malloc((size_t)n * sizeof(int64_t));
    int32_t* queue = (int32_t*)malloc((size_t)n * 2 * sizeof(int32_t));
    int64_t* per_group = (int64_t*)calloc(n_groups, sizeof(int64_t));
    if (!visited || !in_comp || !queue || !per_group) {
        free(visited); free(in_comp); free(queue); free(per_group);
        return -1;
    }
    for (int64_t i = 0; i < n; i++) in_comp[i] = -1;
    int64_t n_comp = 0, mout = 0;
    bool overflow = false;
    for (int64_t start = 0; start < n && !overflow; start++) {
        if (n_comps != -1) {
            int64_t tot = 0;
            for (int32_t g2 = 0; g2 < n_groups; g2++) tot += per_group[g2];
            if (tot >= (int64_t)n_groups * n_comps) break;
        }
        if (visited[start]) continue;
        int32_t c = color[start];
        if (c < 0 || c >= n_groups) continue;
        if (n_comps != -1 && per_group[c] >= n_comps) continue;
        if (n_comp >= max_comps) { overflow = true; break; }
        comp_off[n_comp] = mout;
        int64_t qh = 0, qt = 0;
        visited[start] = 1;
        in_comp[start] = n_comp;
        if (mout < members_cap) members[mout++] = (int32_t)start;
        else { overflow = true; break; }
        queue[qt++] = (int32_t)start;
        while (qh < qt && !overflow) {
            int32_t i = queue[qh++];
            const int32_t* row = nbrs + 8 * (int64_t)i;
            for (int s = 0; s < 8; s++) {
                int32_t j = row[s];
                if (j < 0 || visited[j]) continue;
                int32_t cj = color[j];
                if (cj == c) {
                    visited[j] = 1;
                    in_comp[j] = n_comp;
                    if (mout < members_cap) members[mout++] = j;
                    else { overflow = true; break; }
                    queue[qt++] = j;
                } else if (!separate && cj == -1 && in_comp[j] != n_comp) {
                    in_comp[j] = n_comp;
                    if (mout < members_cap) members[mout++] = j;
                    else { overflow = true; break; }
                    queue[qt++] = j;
                }
            }
        }
        comp_color[n_comp] = c;
        per_group[c]++;
        n_comp++;
    }
    comp_off[n_comp] = mout;
    free(visited); free(in_comp); free(queue); free(per_group);
    return overflow ? -1 : n_comp;
}

// BFS connected components over a counted canonical k-mer table: scan for
// an unvisited key, BFS through the 8 canonical neighbor candidates
// (possibleNeighbours), mark visited by negating the stored count -- the
// control flow of ComponentsBuilder.bfs.  Returns total k-mers visited;
// fills n_components.
int64_t bfs_components_baseline(const uint64_t* keys, const int32_t* counts,
                                int64_t n, int32_t k, int32_t table_log2,
                                int64_t* n_components) {
    const uint64_t mask = (k == 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
    uint64_t cap = 1ULL << table_log2;
    KHash H;
    H.slots = (uint64_t*)calloc(cap, sizeof(uint64_t));
    H.vals = (int32_t*)malloc(cap * sizeof(int32_t));
    H.mask = cap - 1;
    uint64_t* queue = (uint64_t*)malloc((size_t)n * sizeof(uint64_t));
    if (!H.slots || !H.vals || !queue) {
        free(H.slots); free(H.vals); free(queue);
        return -1;
    }
    for (int64_t i = 0; i < n; i++)
        khash_put(H, keys[i], counts[i] > 0 ? counts[i] : 1);

    int64_t visited = 0, comps = 0;
    for (int64_t i = 0; i < n; i++) {
        int64_t p0 = khash_find(H, keys[i]);
        if (H.vals[p0] < 0) continue;       // already in a component
        comps++;
        int64_t head = 0, tail = 0;
        queue[tail++] = keys[i];
        H.vals[p0] = -H.vals[p0];
        visited++;
        while (head < tail) {
            uint64_t key = queue[head++];
            uint64_t fw = key;
            uint64_t rc = rc_kmer(fw, k);
            // 8 candidates: 4 right + 4 left, canonicalized
            for (int s = 0; s < 8; s++) {
                uint64_t nuc = (uint64_t)(s & 3);
                uint64_t nfw, nrc;
                if (s < 4) {
                    nfw = ((fw << 2) | nuc) & mask;
                    nrc = (rc >> 2) | ((3ULL - nuc) << (2 * (k - 1)));
                } else {
                    nfw = (fw >> 2) | (nuc << (2 * (k - 1)));
                    nrc = ((rc << 2) | (3ULL - nuc)) & mask;
                }
                uint64_t can = nfw < nrc ? nfw : nrc;
                int64_t p = khash_find(H, can);
                if (p >= 0 && H.vals[p] > 0) {
                    H.vals[p] = -H.vals[p];
                    queue[tail++] = can;
                    visited++;
                }
            }
        }
    }
    free(H.slots);
    free(H.vals);
    free(queue);
    *n_components = comps;
    return visited;
}

}  // extern "C"
