// k-mer prefilter core: similar-k-mer seeding + diagonal double-match
// detection + ungapped diagonal rescoring.
//
// Re-implementation of the reference prefilter pipeline semantics
// (lib/mmseqs/src/prefiltering/: KmerGenerator.cpp, IndexTable.h,
// CacheFriendlyOperations.cpp, UngappedAlignment.cpp, QueryMatcher.cpp)
// for byte-identical candidate sets, in this framework's own structure:
// one flat C ABI driven from Python, host-side only (the batched gapless
// rescore for throughput mode runs on the device via ops/ungapped.py; this core
// is the exact-parity path and the candidate-set oracle).
//
// Scope: amino-acid query vs amino-acid target, spaced k-mers with
// runtime k in {6,7}, diagonal scoring on (the reference default) and
// off, profile queries, chunked overflow handling for
// > max(1e6, dbSize)*2 collected matches (flush_chunk/merge_diag_dups
// mirror QueryMatcher.cpp:283-333), and persistent index save/load.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
#include <memory>
#include <unistd.h>
#include <x86intrin.h>
#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr int ALPH = 20;          // k-mer alphabet, X excluded
constexpr int A21 = 21;
constexpr int KK_MAX = 7;
// spaced patterns (Sequence.h:19-57): spaced_seed_6 = 1101010011,
// spaced_seed_7 = 11010110011
constexpr int PAT6_SPAN = 10;
constexpr int PAT6_POS[6] = {0, 1, 3, 5, 8, 9};
constexpr int PAT7_SPAN = 11;
constexpr int PAT7_POS[7] = {0, 1, 3, 5, 6, 9, 10};
constexpr size_t SUB2 = 20 * 20;
constexpr size_t SUB3 = 20 * 20 * 20;
constexpr size_t MAX_KMER_RESULT_SIZE = 262144UL * 32UL;

// packed to 6 bytes: the posting-list gather is the hottest phase of
// the match (memory bound), and 25% fewer bytes stream through it;
// x86 handles the unaligned loads natively
struct __attribute__((packed)) IndexEntry {
    uint32_t seqId;
    uint16_t pos_j;
};
static_assert(sizeof(IndexEntry) == 6, "IndexEntry must be packed");

// a collected (target id, diagonal) hit, partitioned by id&mask into
// per-bin buffers during the gather (the reference's cache-friendly
// trick, CacheFriendlyOperations.cpp) so duplicate detection is a
// single streaming pass per bin instead of bincount filtered re-scans
// of the whole hit list
struct __attribute__((packed)) BinHit {
    uint32_t id;
    uint16_t diag;
};
static_assert(sizeof(BinHit) == 6, "BinHit must be packed");

// phase cycle counters (METAEUK_PF_PROF=1), accumulated across threads
enum { PH_GEN = 0, PH_GATHER, PH_DUP, PH_RESCORE, PH_FINISH, PH_KEEPMAX, PH_CSORT, PH_EMIT, PH_N };
struct ProfAcc {
    uint64_t c[PH_N] = {0};
};
bool prof_enabled() {
    static int on = -1;
    if (on < 0) {
        const char *e = getenv("METAEUK_PF_PROF");
        on = (e && e[0] == '1') ? 1 : 0;
    }
    return on == 1;
}
struct PhaseTimer {
    ProfAcc *acc;
    int ph;
    uint64_t t0;
    PhaseTimer(ProfAcc *a, int p) : acc(a), ph(p),
        t0(a ? __rdtsc() : 0) {}
    ~PhaseTimer() { if (acc) acc->c[ph] += __rdtsc() - t0; }
};

struct Counter {
    uint32_t id;
    uint16_t diagonal;
    uint8_t count;
};

struct Hit {
    uint32_t seqId;
    int32_t prefScore;
    uint16_t diagonal;
};

// ExtendedSubstitutionMatrix for 3-mers: per row (3-mer index), all 8000
// 3-mer indices sorted by score desc (stable: ties ascending index,
// ExtendedSubstitutionMatrix.cpp:14-56)
struct ExtMat3 {
    std::vector<int16_t> score;   // SUB3 * SUB3
    std::vector<uint32_t> index;
};

// same for 2-mers (k=7 uses the [2,2,3] divide strategy,
// KmerGenerator::setDivideStrategy kmerSize%3==1 branch + reverse)
struct ExtMat2 {
    std::vector<int16_t> score;   // SUB2 * SUB2
    std::vector<uint32_t> index;
};

// Per-query scratch state, separated from PF so batched matching can
// run one instance per OpenMP thread (the duplicate bit-array and the
// multi-MB hit buffers are written during every match).
struct Scratch {
    std::vector<int8_t> byteArr;      // duplicate detection (zero-restored)
    std::vector<Counter> found;
    std::vector<uint32_t> klist;
    std::vector<uint32_t> klist2;     // bitmap-surviving (non-empty) k-mers
    std::vector<int32_t> rowids;      // per-position ExtMat3 row ids
    // collected hits, partitioned by (id & (bincount-1)) at gather time;
    // binTotal tracks the total across bins (the overflow budget)
    std::vector<std::vector<BinHit>> bins;
    size_t binTotal = 0;
    std::vector<std::pair<uint32_t, uint16_t>> dupTmp;
    std::vector<Counter> sorted;
    std::vector<int8_t> qprof;
    std::vector<int16_t> gscore[2];
    std::vector<uint32_t> gindex[2];
    std::vector<int16_t> psort_s;
    std::vector<uint8_t> psort_i;
    ProfAcc prof;
    void ensure_dup(size_t dup_bytes) {
        if (byteArr.size() != dup_bytes) byteArr.assign(dup_bytes, 0);
    }
    void ensure_bins(uint32_t bincount) {
        if (bins.size() != bincount) bins.resize(bincount);
    }
    void clear_bins() {
        for (auto &b : bins) b.clear();
        binTotal = 0;
    }
};

struct PF {
    int16_t vt[A21 * A21];        // VTML80 8-bit (k-mer seeding)
    int16_t bl[A21 * A21];        // BLOSUM62 2-bit biased (ungapped rescore)
    int64_t kmer_thr;
    int kk = 6;                   // k-mer size (6 or 7)
    int pat_span = PAT6_SPAN;
    const int *pat_pos = PAT6_POS;
    size_t kspace = SUB3 * SUB3;  // 20^kk
    std::shared_ptr<ExtMat3> m3;
    std::shared_ptr<ExtMat2> m2;  // k=7 only
    std::vector<uint32_t> offsets;        // KSPACE + 1
    // presence bitmap over k-mer space (1 bit per k-mer, 8 MB at k=6):
    // most generated similar k-mers have empty posting lists, and this
    // L3-resident filter avoids the latency-bound random load into the
    // 256 MB offsets table for them (an empty list can never trigger the
    // overflow flush — binTotal < maxDbMatches is invariant after
    // every append — so skipping empties is exactly
    // semantics-preserving vs QueryMatcher.cpp:281-322)
    std::vector<uint64_t> kbit;
    std::vector<IndexEntry> entries;
    std::vector<uint8_t> tdata;           // masked target residues
    std::vector<int64_t> toff;
    int64_t nseq = 0;
    uint32_t bincount = 2;
    uint32_t binbits = 1;
    // default scratch (reused across single-query pf_match calls;
    // per-call allocation of the multi-MB buffers dominated runtime on
    // many-query workloads); pf_match_batch uses per-thread instances
    Scratch scr;
    size_t dup_bytes = 3;         // duplicate bit-array size
};

inline int kidx3(const uint8_t *s) {          // Indexer::int2index base 20
    return s[0] + 20 * s[1] + 400 * s[2];
}

void build_ext3(PF *pf) {
    pf->m3 = std::make_shared<ExtMat3>();
    pf->m3->score.resize(SUB3 * SUB3);
    pf->m3->index.resize(SUB3 * SUB3);
    std::vector<std::pair<int16_t, uint32_t>> row(SUB3);
    for (size_t i = 0; i < SUB3; i++) {
        const int s0 = i % 20, s1 = (i / 20) % 20, s2 = i / 400;
        const int16_t *r0 = pf->vt + s0 * A21;
        const int16_t *r1 = pf->vt + s1 * A21;
        const int16_t *r2 = pf->vt + s2 * A21;
        size_t j = 0;
        for (int j2 = 0; j2 < 20; j2++) {
            const int16_t sc2 = r2[j2];
            for (int j1 = 0; j1 < 20; j1++) {
                const int16_t sc21 = sc2 + r1[j1];
                for (int j0 = 0; j0 < 20; j0++, j++) {
                    row[j] = {static_cast<int16_t>(sc21 + r0[j0]),
                              static_cast<uint32_t>(j)};
                }
            }
        }
        // stable counting sort, score descending: 3-mer scores span a
        // few hundred values, ~10x faster than the comparison sort that
        // dominated prefilter cold-start
        int16_t mn = row[0].first, mx = row[0].first;
        for (size_t z = 1; z < SUB3; z++) {
            mn = std::min(mn, row[z].first);
            mx = std::max(mx, row[z].first);
        }
        const int range = mx - mn + 1;
        std::vector<uint32_t> cnt((size_t)range + 1, 0);
        for (size_t z = 0; z < SUB3; z++) cnt[mx - row[z].first]++;
        uint32_t acc = 0;
        for (int b = 0; b < range; b++) {
            uint32_t c = cnt[b];
            cnt[b] = acc;
            acc += c;
        }
        int16_t *sr = pf->m3->score.data() + i * SUB3;
        uint32_t *ir = pf->m3->index.data() + i * SUB3;
        for (size_t z = 0; z < SUB3; z++) {
            uint32_t &pos = cnt[mx - row[z].first];
            sr[pos] = row[z].first;
            ir[pos] = row[z].second;
            pos++;
        }
    }
}

void build_ext2(PF *pf) {
    pf->m2 = std::make_shared<ExtMat2>();
    pf->m2->score.resize(SUB2 * SUB2);
    pf->m2->index.resize(SUB2 * SUB2);
    std::vector<std::pair<int16_t, uint32_t>> row(SUB2);
    for (size_t i = 0; i < SUB2; i++) {
        const int s0 = i % 20, s1 = i / 20;
        const int16_t *r0 = pf->vt + s0 * A21;
        const int16_t *r1 = pf->vt + s1 * A21;
        size_t j = 0;
        for (int j1 = 0; j1 < 20; j1++) {
            const int16_t sc1 = r1[j1];
            for (int j0 = 0; j0 < 20; j0++, j++) {
                row[j] = {static_cast<int16_t>(sc1 + r0[j0]),
                          static_cast<uint32_t>(j)};
            }
        }
        std::stable_sort(row.begin(), row.end(),
                         [](const std::pair<int16_t, uint32_t> &a,
                            const std::pair<int16_t, uint32_t> &b) {
            return a.first > b.first;
        });
        int16_t *sr = pf->m2->score.data() + i * SUB2;
        uint32_t *ir = pf->m2->index.data() + i * SUB2;
        for (size_t z = 0; z < SUB2; z++) {
            sr[z] = row[z].first;
            ir[z] = row[z].second;
        }
    }
}

void build_kbit(PF *pf) {
    pf->kbit.assign(pf->kspace / 64 + 1, 0);
    for (size_t k = 0; k < pf->kspace; k++) {
        if (pf->offsets[k + 1] != pf->offsets[k]) {
            pf->kbit[k >> 6] |= 1ULL << (k & 63);
        }
    }
}

uint64_t l2_cache_size() {
#ifdef _SC_LEVEL2_CACHE_SIZE
    long sz = sysconf(_SC_LEVEL2_CACHE_SIZE);
    if (sz > 0) return (uint64_t)sz;
#endif
    return 262144;
}

// initDiagonalMatcher bin-count rule (QueryMatcher.cpp:422-450)
uint32_t pick_bincount(size_t dbsize) {
    uint64_t l2 = l2_cache_size();
    for (uint32_t bc = 2; bc <= 1024; bc *= 2) {
        if (dbsize / bc < l2) return bc;
    }
    return 2048;
}

// spaced k-mer extraction; returns false if any informative position is X
inline bool extract_kmer(const PF *pf, const uint8_t *seq, int64_t pos,
                         uint8_t *out) {
    bool ok = true;
    for (int k = 0; k < pf->kk; k++) {
        out[k] = seq[pos + pf->pat_pos[k]];
        ok &= (out[k] != ALPH);
    }
    return ok;
}

// base-20 little-endian k-mer index (Indexer::int2index)
inline uint32_t kidx_full(const uint8_t *w, int kk) {
    uint32_t v = 0, p = 1;
    for (int i = 0; i < kk; i++) {
        v += (uint32_t)w[i] * p;
        p *= 20;
    }
    return v;
}

}  // namespace

extern "C" {

void *pf_create2(const int16_t *vtml8, const int16_t *blos2,
                 int64_t kmer_thr, int64_t kmer_size) {
    PF *pf = new PF();
    memcpy(pf->vt, vtml8, sizeof(pf->vt));
    memcpy(pf->bl, blos2, sizeof(pf->bl));
    pf->kmer_thr = kmer_thr;
    pf->kk = (int)kmer_size;
    if (pf->kk == 7) {
        pf->pat_span = PAT7_SPAN;
        pf->pat_pos = PAT7_POS;
        pf->kspace = 1;
        for (int i = 0; i < 7; i++) pf->kspace *= 20;
    } else {
        pf->kk = 6;
        pf->pat_span = PAT6_SPAN;
        pf->pat_pos = PAT6_POS;
        pf->kspace = SUB3 * SUB3;
    }
    // the product tables depend only on the seed matrix: share one copy
    // per process
    static std::shared_ptr<ExtMat3> cached3;
    static std::shared_ptr<ExtMat2> cached2;
    static int16_t cached_vt[A21 * A21];
    if (cached3 && memcmp(cached_vt, pf->vt, sizeof(cached_vt)) == 0) {
        pf->m3 = cached3;
        if (pf->kk == 7) {
            if (!cached2) {
                build_ext2(pf);
                cached2 = pf->m2;
            } else {
                pf->m2 = cached2;
            }
        }
    } else {
        build_ext3(pf);
        cached3 = pf->m3;
        cached2.reset();
        if (pf->kk == 7) {
            build_ext2(pf);
            cached2 = pf->m2;
        }
        memcpy(cached_vt, pf->vt, sizeof(cached_vt));
    }
    return pf;
}

void *pf_create(const int16_t *vtml8, const int16_t *blos2, int64_t kmer_thr) {
    return pf_create2(vtml8, blos2, kmer_thr, 6);
}

void pf_destroy(void *h) { delete static_cast<PF *>(h); }

// targets: already masked (tantan -> X) residue codes
void pf_add_targets(void *h, const uint8_t *data, const int64_t *offsets,
                    int64_t n) {
    PF *pf = static_cast<PF *>(h);
    pf->nseq = n;
    pf->toff.assign(offsets, offsets + n + 1);
    pf->tdata.assign(data, data + offsets[n]);
    pf->offsets.assign(pf->kspace + 1, 0);

    // count unique above-threshold k-mers per sequence (IndexTable::
    // addKmerCount, IndexTable.h:133-170)
    std::vector<std::pair<uint32_t, uint16_t>> buf;
    for (int64_t s = 0; s < n; s++) {
        const uint8_t *seq = pf->tdata.data() + pf->toff[s];
        const int64_t L = pf->toff[s + 1] - pf->toff[s];
        buf.clear();
        uint8_t w[KK_MAX];
        for (int64_t pos = 0; pos + pf->pat_span <= L; pos++) {
            if (!extract_kmer(pf, seq, pos, w)) continue;
            if (pf->kmer_thr > 0) {
                int sc = 0;
                for (int k = 0; k < pf->kk; k++)
                    sc += pf->vt[w[k] * A21 + w[k]];
                if (sc < pf->kmer_thr) continue;
            }
            uint32_t idx = kidx_full(w, pf->kk);
            buf.push_back({idx, (uint16_t)pos});
        }
        std::sort(buf.begin(), buf.end());
        uint32_t prev = UINT32_MAX;
        for (auto &kv : buf) {
            if (kv.first != prev) pf->offsets[kv.first]++;
            prev = kv.first;
        }
    }
    // prefix sum (IndexTable::init)
    uint64_t off = 0;
    for (size_t i = 0; i < pf->kspace; i++) {
        uint64_t c = pf->offsets[i];
        pf->offsets[i] = (uint32_t)off;
        off += c;
    }
    pf->offsets[pf->kspace] = (uint32_t)off;
    pf->entries.resize(off);
    // fill using offsets as write cursors, then revert
    // (IndexTable::addSequence + revertPointer, IndexTable.h:348-401,251-256)
    for (int64_t s = 0; s < n; s++) {
        const uint8_t *seq = pf->tdata.data() + pf->toff[s];
        const int64_t L = pf->toff[s + 1] - pf->toff[s];
        buf.clear();
        uint8_t w[KK_MAX];
        for (int64_t pos = 0; pos + pf->pat_span <= L; pos++) {
            if (!extract_kmer(pf, seq, pos, w)) continue;
            if (pf->kmer_thr > 0) {
                int sc = 0;
                for (int k = 0; k < pf->kk; k++)
                    sc += pf->vt[w[k] * A21 + w[k]];
                if (sc < pf->kmer_thr) continue;
            }
            uint32_t idx = kidx_full(w, pf->kk);
            buf.push_back({idx, (uint16_t)pos});
        }
        std::sort(buf.begin(), buf.end());
        uint32_t prev = UINT32_MAX;
        for (auto &kv : buf) {
            if (kv.first != prev) {
                pf->entries[pf->offsets[kv.first]++] = {(uint32_t)s, kv.second};
            }
            prev = kv.first;
        }
    }
    for (size_t i = pf->kspace; i > 0; i--) pf->offsets[i] = pf->offsets[i - 1];
    pf->offsets[0] = 0;
    build_kbit(pf);
    pf->bincount = pick_bincount((size_t)n);
    pf->binbits = 0;
    while ((1u << pf->binbits) < pf->bincount) pf->binbits++;
    // duplicateBitArray sizing: 2^ceil(log2(n)) >> bits (CacheFriendly
    // Operations ctor)
    size_t sz = 1;
    while (sz < (size_t)n) sz <<= 1;
    sz = std::max(sz >> pf->binbits, (size_t)1);
    pf->dup_bytes = sz + 2;
    pf->scr.ensure_dup(pf->dup_bytes);
}

int64_t pf_n_entries(void *h) {
    return (int64_t) static_cast<PF *>(h)->entries.size();
}

}  // extern "C"

namespace {

// k=7 similar-k-mer list: the reference's [2,2,3] divide strategy
// (KmerGenerator::setDivideStrategy kmerSize%3==1 + reverse;
// calculateArrayProduct chain, KmerGenerator.cpp:106-216). Parts:
// positions 0-1 (2-mer, x1), 2-3 (2-mer, x400), 4-6 (3-mer, x160000).
size_t gen_kmer_list7(const PF *pf, Scratch &sc, const uint8_t *w,
                      int threshold, uint32_t *out) {
    const int i0 = w[0] + 20 * w[1];
    const int i1 = w[2] + 20 * w[3];
    const int i2 = w[4] + 20 * w[5] + 400 * w[6];
    const int16_t *s0 = pf->m2->score.data() + (size_t)i0 * SUB2;
    const uint32_t *x0 = pf->m2->index.data() + (size_t)i0 * SUB2;
    const int16_t *s1 = pf->m2->score.data() + (size_t)i1 * SUB2;
    const uint32_t *x1 = pf->m2->index.data() + (size_t)i1 * SUB2;
    const int16_t *s2 = pf->m3->score.data() + (size_t)i2 * SUB3;
    const uint32_t *x2 = pf->m3->index.data() + (size_t)i2 * SUB3;
    const int rest1 = s2[0];
    const int rest0 = s1[0] + rest1;
    if (sc.gscore[0].size() < MAX_KMER_RESULT_SIZE) {
        sc.gscore[0].resize(MAX_KMER_RESULT_SIZE);
        sc.gindex[0].resize(MAX_KMER_RESULT_SIZE);
    }
    int16_t *as = sc.gscore[0].data();
    uint32_t *ax = sc.gindex[0].data();
    // stage 1: part0 x part1
    const int cutoff1 = threshold - rest0;
    size_t na = 0;
    for (size_t i = 0; i < SUB2 && s0[i] >= cutoff1; i++) {
        const int cutoff2 = threshold - s0[i] - rest1;
        for (size_t j = 0; j < SUB2 && (na + 1 < MAX_KMER_RESULT_SIZE)
                           && s1[j] >= cutoff2; j++) {
            as[na] = (int16_t)(s0[i] + s1[j]);
            ax[na] = x0[i] + x1[j] * 400u;
            na++;
        }
        if (na + 1 >= MAX_KMER_RESULT_SIZE) break;
    }
    // stage 2: (part0 x part1) x part2 (cutoff1 = -1000 after the first
    // product: every stage-1 entry is inspected)
    size_t counter = 0;
    for (size_t i = 0; i < na; i++) {
        const int cutoff2 = threshold - as[i];
        size_t jend = 0;
#if defined(__AVX512F__) && defined(__AVX512BW__)
        {
            const __m256i vcut = _mm256_set1_epi16((short)cutoff2);
            while (jend + 16 <= SUB3) {
                const __m256i v = _mm256_loadu_si256(
                    (const __m256i *)(s2 + jend));
                const __mmask16 m = _mm256_cmp_epi16_mask(
                    v, vcut, _MM_CMPINT_NLT);
                if (m != 0xFFFF) {
                    jend += __builtin_ctz(~(unsigned)m);
                    goto found7;
                }
                jend += 16;
            }
        }
#endif
        while (jend < SUB3 && s2[jend] >= cutoff2) jend++;
#if defined(__AVX512F__) && defined(__AVX512BW__)
        found7:
#endif
        {
            const size_t navail = MAX_KMER_RESULT_SIZE - 1 - counter;
            const size_t nn = jend < navail ? jend : navail;
            uint32_t *dst = out + counter;
            size_t j = 0;
#if defined(__AVX512F__)
            const __m512i va = _mm512_set1_epi32((int)ax[i]);
            const __m512i vmul = _mm512_set1_epi32(160000);
            for (; j + 16 <= nn; j += 16) {
                const __m512i vb = _mm512_loadu_si512(
                    (const void *)(x2 + j));
                _mm512_storeu_si512(
                    (void *)(dst + j),
                    _mm512_add_epi32(va, _mm512_mullo_epi32(vb, vmul)));
            }
#endif
            for (; j < nn; j++) dst[j] = ax[i] + x2[j] * 160000u;
            counter += nn;
        }
        if (counter + 1 >= MAX_KMER_RESULT_SIZE) return counter;
    }
    return counter;
}

// KmerGenerator::generateKmerList for the (3,3) split, addIdentity=false
// (KmerGenerator.cpp:106-185). Emits kmer indices in (a desc, b desc)
// score order. Returns count.
//
// The b-row prefix length (sb sorted desc, emit while sb[j] >= cutoff2)
// is found 16 lanes at a time and the emission out[c++] = xa[i] +
// xb[j]*SUB3 is a vector broadcast-add-store; identical output to the
// scalar loop.
size_t gen_kmer_list6(const PF *pf, const uint8_t *w, int threshold,
                      uint32_t *out) {
    const int ia = kidx3(w), ib = kidx3(w + 3);
    const int16_t *sa = pf->m3->score.data() + (size_t)ia * SUB3;
    const uint32_t *xa = pf->m3->index.data() + (size_t)ia * SUB3;
    const int16_t *sb = pf->m3->score.data() + (size_t)ib * SUB3;
    const uint32_t *xb = pf->m3->index.data() + (size_t)ib * SUB3;
    const int possibleRest = sb[0];
    const int cutoff1 = threshold - possibleRest;
    size_t counter = 0;
    for (size_t i = 0; i < SUB3 && sa[i] >= cutoff1; i++) {
        const int cutoff2 = threshold - sa[i];
        // jend = first j with sb[j] < cutoff2 (the row is sorted desc)
        size_t jend = 0;
#if defined(__AVX512F__) && defined(__AVX512BW__)
        {
            const __m256i vcut = _mm256_set1_epi16((short)cutoff2);
            while (jend + 16 <= SUB3) {
                const __m256i v = _mm256_loadu_si256(
                    (const __m256i *)(sb + jend));
                // mask bit set where sb[j] >= cutoff2
                const __mmask16 m = _mm256_cmp_epi16_mask(
                    v, vcut, _MM_CMPINT_NLT);
                if (m != 0xFFFF) {
                    jend += __builtin_ctz(~(unsigned)m);
                    goto found;
                }
                jend += 16;
            }
        }
#endif
        while (jend < SUB3 && sb[jend] >= cutoff2) jend++;
#if defined(__AVX512F__) && defined(__AVX512BW__)
        found:
#endif
        {
            const size_t navail = MAX_KMER_RESULT_SIZE - 1 - counter;
            const size_t n = jend < navail ? jend : navail;
            uint32_t *dst = out + counter;
            size_t j = 0;
#if defined(__AVX512F__)
            const __m512i va = _mm512_set1_epi32((int)xa[i]);
            const __m512i vmul = _mm512_set1_epi32((int)SUB3);
            for (; j + 16 <= n; j += 16) {
                const __m512i vb = _mm512_loadu_si512(
                    (const void *)(xb + j));
                _mm512_storeu_si512(
                    (void *)(dst + j),
                    _mm512_add_epi32(va, _mm512_mullo_epi32(vb, vmul)));
            }
#endif
            for (; j < n; j++) dst[j] = xa[i] + xb[j] * SUB3;
            counter += n;
        }
        if (counter + 1 >= MAX_KMER_RESULT_SIZE) return counter;
    }
    return counter;
}

size_t gen_kmer_list(const PF *pf, Scratch &sc, const uint8_t *w,
                     int threshold, uint32_t *out) {
    return pf->kk == 7 ? gen_kmer_list7(pf, sc, w, threshold, out)
                       : gen_kmer_list6(pf, w, threshold, out);
}

// ungapped diagonal score: running sum clamped at 0, max, then min(255,.)
// (UngappedAlignment::scalarDiagonalScoring + computeSingelSequenceScores)
int diag_score_raw(const PF *pf, const int8_t *qprof, int qlen,
                   const uint8_t *t, int tlen, uint16_t diag_u16) {
    const int16_t d = (int16_t)diag_u16;
    const uint16_t dist1 = (uint16_t)(0 - diag_u16);
    const uint16_t dist2 = diag_u16;
    const uint16_t minDist = std::min(dist1, dist2);
    int maxs = 0;
    if (d >= 0 && minDist < (uint16_t)qlen) {
        const int len = std::min(tlen, qlen - (int)minDist);
        const int8_t *p = qprof + (size_t)minDist * A21;
        int score = 0;
        for (int pos = 0; pos < len; pos++) {
            score += p[(size_t)pos * A21 + t[pos]];
            score = score < 0 ? 0 : score;
            maxs = score > maxs ? score : maxs;
        }
    } else if (d < 0 && minDist < (uint16_t)tlen) {
        const int len = std::min(tlen - (int)minDist, qlen);
        const uint8_t *tt = t + minDist;
        int score = 0;
        for (int pos = 0; pos < len; pos++) {
            score += qprof[(size_t)pos * A21 + tt[pos]];
            score = score < 0 ? 0 : score;
            maxs = score > maxs ? score : maxs;
        }
    }
    return maxs;
}

// CacheFriendlyOperations::findDuplicates, computeTotalScore=false
// (CacheFriendlyOperations.cpp:185-274): two successive hits with equal
// diagonal byte per id -> duplicate; dedup runs keeping first. Hits are
// already partitioned into per-bin buffers at gather time, so each bin
// is one streaming pass over its own hits (the old form filtered the
// whole hit list once per bin — bincount re-scans, the dominant cost of
// the match at large hit counts). Per-bin scan order equals posting
// order filtered by bin, and bins are visited 0..bincount-1, so the
// output sequence is byte-identical to the filtered-scan form.
size_t find_duplicates(PF *pf, Scratch &sc, Counter *out) {
    int8_t *ba = sc.byteArr.data();
    std::vector<std::pair<uint32_t, uint16_t>> &tmp = sc.dupTmp;
    size_t cnt = 0;
    for (uint32_t bin = 0; bin < pf->bincount; bin++) {
        const std::vector<BinHit> &bh = sc.bins[bin];
        tmp.clear();
        // find duplicates in this bin (scan order preserved)
        for (size_t n = 0; n < bh.size(); n++) {
            const uint32_t key = bh[n].id >> pf->binbits;
            const uint8_t currDiag = (uint8_t)bh[n].diag;
            const uint8_t prevDiag = (uint8_t)ba[key];
            if (currDiag == prevDiag) tmp.push_back({bh[n].id, bh[n].diag});
            ba[key] = (int8_t)currDiag;
        }
        // reset: first diagonal + 1 in reverse
        for (size_t n = tmp.size(); n-- > 0;) {
            ba[tmp[n].first >> pf->binbits] = (int8_t)((uint8_t)tmp[n].second + 1);
        }
        // extract: first of each run
        for (size_t n = 0; n < tmp.size(); n++) {
            const uint32_t key = tmp[n].first >> pf->binbits;
            out[cnt].id = tmp[n].first;
            out[cnt].count = 0;
            out[cnt].diagonal = tmp[n].second;
            cnt += ((uint8_t)ba[key] != (uint8_t)tmp[n].second) ? 1 : 0;
            ba[key] = (int8_t)(uint8_t)tmp[n].second;
        }
        // zero the touched slots (all-zero end state either way); a
        // flat memset is cheaper once the bin's hits outnumber the
        // byte-array bytes
        if (bh.size() > pf->dup_bytes / 8) {
            memset(ba, 0, pf->dup_bytes);
        } else {
            for (size_t n = 0; n < bh.size(); n++) {
                ba[bh[n].id >> pf->binbits] = 0;
            }
        }
    }
    return cnt;
}

// CacheFriendlyOperations::findDuplicates, computeTotalScore=true
// (CacheFriendlyOperations.cpp:214-237): per id, the first double-
// diagonal occurrence carries the total duplicate count (capped 255);
// later occurrences are suppressed by the zeroed slot. Bin-partitioned
// like find_duplicates above.
size_t find_duplicates_count(PF *pf, Scratch &sc, Counter *out) {
    int8_t *ba = sc.byteArr.data();
    std::vector<std::pair<uint32_t, uint16_t>> &tmp = sc.dupTmp;
    size_t cnt = 0;
    for (uint32_t bin = 0; bin < pf->bincount; bin++) {
        const std::vector<BinHit> &bh = sc.bins[bin];
        tmp.clear();
        // find duplicates in this bin (scan order preserved)
        for (size_t n = 0; n < bh.size(); n++) {
            const uint32_t key = bh[n].id >> pf->binbits;
            const uint8_t currDiag = (uint8_t)bh[n].diag;
            const uint8_t prevDiag = (uint8_t)ba[key];
            if (currDiag == prevDiag) tmp.push_back({bh[n].id, bh[n].diag});
            ba[key] = (int8_t)currDiag;
        }
        // zero the duplicate keys, then sum up (saturating at 255)
        for (auto &e : tmp) ba[e.first >> pf->binbits] = 0;
        for (auto &e : tmp) {
            const uint32_t key = e.first >> pf->binbits;
            ba[key] += ((uint8_t)ba[key] < 255) ? 1 : 0;
        }
        // extract: the first occurrence per id gets the full count
        for (auto &e : tmp) {
            const uint32_t key = e.first >> pf->binbits;
            out[cnt].id = e.first;
            out[cnt].count = (uint8_t)ba[key];
            out[cnt].diagonal = e.second;
            cnt += ((uint8_t)ba[key] != 0) ? 1 : 0;
            ba[key] = 0;
        }
        // bin cleanup — same all-zero end state (see find_duplicates)
        if (bh.size() > pf->dup_bytes / 8) {
            memset(ba, 0, pf->dup_bytes);
        } else {
            for (size_t n = 0; n < bh.size(); n++) {
                ba[bh[n].id >> pf->binbits] = 0;
            }
        }
    }
    return cnt;
}

// The diagonalScoring==false result path (QueryMatcher.cpp:186-205 +
// getResult<KMER_SCORE>): score = double-diagonal match count, no
// ungapped rescoring; identity hit scores UCHAR_MAX.
int64_t finish_match_count(PF *pf, Scratch &sc, size_t resultSize,
                           int64_t max_hits, int64_t min_diag_thr,
                           uint32_t identity_id, uint32_t *out_id,
                           int32_t *out_score, int16_t *out_diag) {
    std::vector<Counter> &found = sc.found;

    // threshold from the count histogram (computeScoreThreshold)
    uint64_t hist[256] = {0};
    for (size_t i = 0; i < resultSize; i++) hist[found[i].count]++;
    uint64_t acc = 0;
    unsigned int thr = 0;
    for (unsigned int s = 255; s > 0; s--) {
        acc += hist[s];
        if (acc >= (uint64_t)max_hits) { thr = s; break; }
    }
    thr = std::max((unsigned int)min_diag_thr, thr);

    // stable counting sort desc by count, keeping >= thr
    std::vector<Counter> &sorted = sc.sorted;
    {
        size_t start[257];
        size_t acc2 = 0;
        for (int s = 255; s >= (int)thr; s--) {
            start[s] = acc2;
            acc2 += hist[s];
            if (s == 0) break;
        }
        sorted.resize(acc2);
        for (size_t i = 0; i < resultSize; i++) {
            const uint8_t c = found[i].count;
            if (c >= thr) sorted[start[c]++] = found[i];
        }
    }

    // getResult<KMER_SCORE>
    std::vector<Hit> res;
    if (identity_id != UINT32_MAX) {
        res.push_back({identity_id, UINT8_MAX, 0});
    }
    for (size_t i = 0; i < sorted.size() && (int64_t)res.size() < max_hits;
         i++) {
        const uint32_t id = sorted[i].id;
        const unsigned int sc = sorted[i].count;
        if (sc < thr || id == identity_id) continue;
        res.push_back({id, (int32_t)sc, sorted[i].diagonal});
    }
    const size_t from = (identity_id != UINT32_MAX) ? 1 : 0;
    if (res.size() > 1) {
        std::sort(res.begin() + from, res.end(),
                  [](const Hit &a, const Hit &b) {
            if (std::abs(a.prefScore) > std::abs(b.prefScore)) return true;
            if (std::abs(b.prefScore) > std::abs(a.prefScore)) return false;
            return a.seqId < b.seqId;
        });
    }
    for (size_t i = 0; i < res.size(); i++) {
        out_id[i] = res[i].seqId;
        out_score[i] = res[i].prefScore;
        out_diag[i] = (int16_t)res[i].diagonal;
    }
    return (int64_t)res.size();
}

// CacheFriendlyOperations::keepMaxScoreElementOnly + keepMaxElement
// (CacheFriendlyOperations.cpp:74-80, 350-380)
size_t keep_max_only(PF *pf, Scratch &sc, std::vector<Counter> &arr, size_t n) {
    const uint32_t mask = pf->bincount - 1;
    int8_t *ba = sc.byteArr.data();
    std::vector<Counter> binned;
    binned.reserve(n);
    std::vector<Counter> out(n);
    size_t cnt = 0;
    for (uint32_t bin = 0; bin < pf->bincount; bin++) {
        binned.clear();
        for (size_t i = 0; i < n; i++) {
            if ((arr[i].id & mask) == bin) binned.push_back(arr[i]);
        }
        for (auto &e : binned) {
            const uint32_t key = e.id >> pf->binbits;
            const uint8_t cur = e.count, db = (uint8_t)ba[key];
            ba[key] = (int8_t)(cur > db ? cur : db);
        }
        for (auto &e : binned) {
            const uint32_t key = e.id >> pf->binbits;
            out[cnt] = e;
            const bool found = ((uint8_t)ba[key] == e.count);
            cnt += found;
            ba[key] = found ? 0 : ba[key];
        }
    }
    std::copy(out.begin(), out.begin() + cnt, arr.begin());
    return cnt;
}

// CacheFriendlyOperations::mergeElementsByDiagonal
// (CacheFriendlyOperations.cpp:61-70 + mergeDiagonal[KeepScoredHits]
// Duplicates): dedup the concatenated overflow chunks by (id, diagonal
// byte); keep_scored additionally keeps every already-scored entry
// (count != 0). Bin iteration order mirrors find_duplicates.
size_t merge_diag_dups(PF *pf, Scratch &sc, Counter *arr, size_t n,
                       bool keep_scored) {
    const uint32_t mask = pf->bincount - 1;
    int8_t *ba = sc.byteArr.data();
    std::vector<Counter> binned;
    std::vector<Counter> out;
    out.reserve(n);
    for (uint32_t bin = 0; bin < pf->bincount; bin++) {
        binned.clear();
        for (size_t i = 0; i < n; i++) {
            if ((arr[i].id & mask) == bin) binned.push_back(arr[i]);
        }
        if (keep_scored) {
            // forward pass marks, reverse pass extracts (the reference
            // keeps the LAST element of each same-diagonal run here;
            // output order is reversed within the bin, exactly like
            // mergeDiagonalKeepScoredHitsDuplicates)
            for (size_t i = 0; i < binned.size(); i++) {
                ba[binned[i].id >> pf->binbits] =
                    (int8_t)((uint8_t)binned[i].diagonal + 1);
            }
            for (size_t i = binned.size(); i-- > 0;) {
                const Counter &e = binned[i];
                const uint32_t key = e.id >> pf->binbits;
                if (e.count != 0 ||
                    (uint8_t)ba[key] != (uint8_t)e.diagonal) {
                    out.push_back(e);
                }
                ba[key] = (int8_t)(uint8_t)e.diagonal;
            }
        } else {
            for (size_t i = binned.size(); i-- > 0;) {
                ba[binned[i].id >> pf->binbits] =
                    (int8_t)((uint8_t)binned[i].diagonal + 1);
            }
            for (size_t i = 0; i < binned.size(); i++) {
                const Counter &e = binned[i];
                const uint32_t key = e.id >> pf->binbits;
                if ((uint8_t)ba[key] != (uint8_t)e.diagonal) out.push_back(e);
                ba[key] = (int8_t)(uint8_t)e.diagonal;
            }
        }
    }
    // ba stays diagonal-dirty in the reference too; the following
    // keepMaxScoreElementOnly pass restores the zero invariant for every
    // id present here (QueryMatcher.cpp:293-297, 109-149)
    std::copy(out.begin(), out.end(), arr);
    return out.size();
}

// CacheFriendlyOperations::mergeElementsByScore + mergeScoreDuplicates
// (CacheFriendlyOperations.cpp:~315): per id, first occurrence carries
// the 255-saturating sum of chunk counts; later occurrences reproduce
// the reference's quirk of re-emitting with count = previous element's
// diagonal byte when that byte is non-zero.
size_t merge_score_dups(PF *pf, Scratch &sc, Counter *arr, size_t n) {
    const uint32_t mask = pf->bincount - 1;
    int8_t *ba = sc.byteArr.data();
    std::vector<Counter> binned;
    std::vector<Counter> out;
    out.reserve(n);
    for (uint32_t bin = 0; bin < pf->bincount; bin++) {
        binned.clear();
        for (size_t i = 0; i < n; i++) {
            if ((arr[i].id & mask) == bin) binned.push_back(arr[i]);
        }
        for (auto &e : binned) {
            const uint32_t key = e.id >> pf->binbits;
            const uint8_t cur = e.count, db = (uint8_t)ba[key];
            ba[key] = (int8_t)((cur > 0xFF - db) ? 0xFF : db + cur);
        }
        for (auto &e : binned) {
            const uint32_t key = e.id >> pf->binbits;
            Counter c = e;
            c.count = (uint8_t)ba[key];
            if (c.count != 0) out.push_back(c);
            ba[key] = (int8_t)(uint8_t)e.diagonal;
        }
        // restore the zero invariant for the next query (the reference
        // leaves ba diagonal-dirty here — observable only as cross-query
        // thread-schedule-dependent state, which cannot be reproduced
        // deterministically; we re-zero instead)
        for (auto &e : binned) ba[e.id >> pf->binbits] = 0;
    }
    std::copy(out.begin(), out.end(), arr);
    return out.size();
}

// ungappedAlignment->align: diagonal-score every still-unscored entry
// (UngappedAlignment::computeScores skips count != 0,
// UngappedAlignment.cpp:37-39)
void align_unscored(PF *pf, const int8_t *qprof, int qlen, Counter *arr,
                    size_t n) {
    for (size_t i = 0; i < n; i++) {
        if (arr[i].count != 0) continue;
        const uint32_t id = arr[i].id;
        const uint8_t *t = pf->tdata.data() + pf->toff[id];
        const int tlen = (int)(pf->toff[id + 1] - pf->toff[id]);
        const int sc = diag_score_raw(pf, qprof, qlen, t, tlen,
                                      arr[i].diagonal);
        arr[i].count = (uint8_t)std::min(255, sc);
    }
}

// Per-query prefilter statistics (statistics_t, QueryMatcher.h:16)
struct QStats {
    uint64_t kmer_list_len = 0;
    uint64_t db_matches = 0;
    bool overflowed = false;
};

void ensure_found(PF *pf, Scratch &sc) {
    const size_t need = 2 * std::max((size_t)1000000, (size_t)pf->nseq) + 16;
    if (sc.found.size() < need) sc.found.resize(need);
}

// QueryMatcher::match overflow handling (QueryMatcher.cpp:283-311):
// dedup the collected posting chunk behind the carried results; on the
// second and later overflows merge + rescore + keep max per id. Returns
// the new carry count; clears the posting buffers.
size_t flush_chunk(PF *pf, Scratch &sc, size_t ovf, bool diag_scoring,
                   const int8_t *qprof, int qlen) {
    ensure_found(pf, sc);
    const size_t hitCount = diag_scoring
        ? find_duplicates(pf, sc, sc.found.data() + ovf)
        : find_duplicates_count(pf, sc, sc.found.data() + ovf);
    size_t newOvf;
    if (ovf != 0) {
        if (diag_scoring) {
            const size_t n2 =
                merge_diag_dups(pf, sc, sc.found.data(), ovf + hitCount, true);
            align_unscored(pf, qprof, qlen, sc.found.data(), n2);
            newOvf = keep_max_only(pf, sc, sc.found, n2);
        } else {
            newOvf = merge_score_dups(pf, sc, sc.found.data(), ovf + hitCount);
        }
    } else {
        newOvf = hitCount;
    }
    sc.clear_bins();
    return newOvf;
}

// Final dedup of the last posting chunk + merge with the overflow carry
// (QueryMatcher.cpp:325-333). Returns the deduped result count in
// sc.found.
size_t final_dedup(PF *pf, Scratch &sc, size_t ovf, bool diag_scoring,
                   QStats *st) {
    ensure_found(pf, sc);
    size_t hitCount = 0;
    if (sc.binTotal != 0) {
        hitCount = diag_scoring
            ? find_duplicates(pf, sc, sc.found.data() + ovf)
            : find_duplicates_count(pf, sc, sc.found.data() + ovf);
        if (ovf != 0) {
            hitCount = diag_scoring
                ? merge_diag_dups(pf, sc, sc.found.data(), ovf + hitCount,
                                  false)
                : merge_score_dups(pf, sc, sc.found.data(), ovf + hitCount);
        }
    }
    // when the final chunk is empty the reference discards the carry
    // entirely (QueryMatcher.cpp:325-333: hitCount stays 0 when
    // numMatches == 0) — replicated for parity
    sc.clear_bins();
    if (st) st->overflowed = st->overflowed || (ovf != 0);
    return hitCount;
}

// Shared back half of a prefilter match: duplicate detection over the
// collected (seqId, diagonal) stream, ungapped diagonal rescoring with
// the given query profile, histogram thresholding, 255-saturation
// rescale, and the final (score desc, id asc) hit ordering. self_seq is
// the residue string used for the saturation self-score
// (QueryMatcher::rescoreHits uses numSequence for profiles too).
int64_t finish_match(PF *pf, Scratch &sc, size_t resultSize,
                     const int8_t *qprof, const uint8_t *self_seq,
                     int64_t qlen, int64_t max_hits, int64_t min_diag_thr,
                     uint32_t identity_id, uint32_t *out_id,
                     int32_t *out_score, int16_t *out_diag) {
    std::vector<Counter> &found = sc.found;
    ProfAcc *pa = prof_enabled() ? &sc.prof : nullptr;

    // diagonal ungapped scoring for count==0 entries (ungappedAlignment->
    // align); entries carried through an overflow merge are already
    // scored and skipped (UngappedAlignment.cpp:37-39)
    {
        PhaseTimer t(pa, PH_RESCORE);
        align_unscored(pf, qprof, (int)qlen, found.data(), resultSize);
    }
    PhaseTimer tf(pa, PH_FINISH);
    {
        PhaseTimer tk(pa, PH_KEEPMAX);
        resultSize = keep_max_only(pf, sc, found, resultSize);
    }

    // threshold from score histogram (computeScoreThreshold)
    uint64_t hist[256] = {0};
    for (size_t i = 0; i < resultSize; i++) hist[found[i].count]++;
    uint64_t acc = 0;
    unsigned int thr = 0;
    for (unsigned int s = 255; s > 0; s--) {
        acc += hist[s];
        if (acc >= (uint64_t)max_hits) { thr = s; break; }
    }
    thr = std::max((unsigned int)min_diag_thr, thr);

    // stable counting sort desc by score, keeping >= thr (the
    // radixSortByScoreSize role): one placement pass instead of one
    // scan per score level
    std::vector<Counter> &sorted = sc.sorted;
    const bool truncated = thr >= 255;
    {
        PhaseTimer tc(pa, PH_CSORT);
        size_t start[257];
        size_t acc2 = 0;
        for (int s = 255; s >= (int)thr; s--) {
            start[s] = acc2;
            acc2 += hist[s];
        }
        sorted.resize(acc2);
        for (size_t i = 0; i < resultSize; i++) {
            const uint8_t c = found[i].count;
            if (c >= thr) sorted[start[c]++] = found[i];
        }
    }

    int rescale = 0;
    if (truncated) {
        // rescoreHits (QueryMatcher.cpp:526-548)
        int maxSelf = diag_score_raw(pf, qprof, (int)qlen, self_seq,
                                     (int)qlen, 0);
        maxSelf = std::max(1, std::min(maxSelf - 255, (int)UINT16_MAX));
        rescale = maxSelf;
        std::vector<Counter> rescored;
        for (size_t i = 0; i < sorted.size() && sorted[i].count >= 255; i++) {
            const uint32_t id = sorted[i].id;
            const uint8_t *t = pf->tdata.data() + pf->toff[id];
            const int tlen = (int)(pf->toff[id + 1] - pf->toff[id]);
            unsigned int ns = (unsigned int)diag_score_raw(
                pf, qprof, (int)qlen, t, tlen, sorted[i].diagonal);
            ns -= 255;
            const float score = (float)std::min(ns, (unsigned int)UINT16_MAX);
            Counter c = sorted[i];
            c.count = (uint8_t)((score / (float)maxSelf) * 255.0f + 0.5f);
            rescored.push_back(c);
        }
        // re-bucket desc with thr 0
        sorted.clear();
        for (int s = 255; s >= 0; s--) {
            for (auto &c : rescored) {
                if (c.count == (uint8_t)s) sorted.push_back(c);
            }
        }
        thr = 0;
    }

    // getResult<UNGAPPED_DIAGONAL_SCORE> (QueryMatcher.cpp:363-420)
    PhaseTimer te(pa, PH_EMIT);
    std::vector<Hit> res;
    if (identity_id != UINT32_MAX) {
        res.push_back({identity_id, UINT16_MAX, 0});
    }
    for (size_t i = 0; i < sorted.size() && (int64_t)res.size() < max_hits;
         i++) {
        const uint32_t id = sorted[i].id;
        const unsigned int sc = sorted[i].count;
        if (sc < thr || id == identity_id) continue;
        Hit hh{id, (int32_t)sc, sorted[i].diagonal};
        if (rescale != 0) {
            hh.prefScore = (int32_t)(255u + (sc * (unsigned int)rescale / 255u));
        } else if ((int)sc >= 255) {
            const uint8_t *t = pf->tdata.data() + pf->toff[id];
            const int tlen = (int)(pf->toff[id + 1] - pf->toff[id]);
            hh.prefScore = diag_score_raw(pf, qprof, (int)qlen, t, tlen,
                                          sorted[i].diagonal);
        }
        res.push_back(hh);
    }
    // final sort by |score| desc, id asc (hit_t::compareHitsByScoreAndId)
    const size_t from = (identity_id != UINT32_MAX) ? 1 : 0;
    if (res.size() > 1) {
        std::sort(res.begin() + from, res.end(), [](const Hit &a, const Hit &b) {
            if (std::abs(a.prefScore) > std::abs(b.prefScore)) return true;
            if (std::abs(b.prefScore) > std::abs(a.prefScore)) return false;
            return a.seqId < b.seqId;
        });
    }
    for (size_t i = 0; i < res.size(); i++) {
        out_id[i] = res[i].seqId;
        out_score[i] = res[i].prefScore;
        out_diag[i] = (int16_t)res[i].diagonal;
    }
    return (int64_t)res.size();
}

// Util::rankedDescSort20's comparator network (Util.cpp:88-114): sorts a
// 20-entry (score, residue) row descending by score. The exact exchange
// sequence is replicated because its tie order decides similar-k-mer
// enumeration order, which decides prefilter hit-stream order.
constexpr uint8_t RANK20_NET[][2] = {
    {0,16},{1,17},{2,18},{3,19},{4,12},{5,13},{6,14},{7,15},
    {0,8},{1,9},{2,10},{3,11},
    {8,16},{9,17},{10,18},{11,19},{0,4},{1,5},{2,6},{3,7},
    {8,12},{9,13},{10,14},{11,15},{4,16},{5,17},{6,18},{7,19},{0,2},{1,3},
    {4,8},{5,9},{6,10},{7,11},{12,16},{13,17},{14,18},{15,19},{0,1},
    {4,6},{5,7},{8,10},{9,11},{12,14},{13,15},{16,18},{17,19},
    {2,16},{3,17},{6,12},{7,13},{18,19},
    {2,8},{3,9},{10,16},{11,17},
    {2,4},{3,5},{6,8},{7,9},{10,12},{11,13},{14,16},{15,17},
    {2,3},{4,5},{6,7},{8,9},{10,11},{12,13},{14,15},{16,17},
    {1,16},{3,18},{5,12},{7,14},
    {1,8},{3,10},{9,16},{11,18},
    {1,4},{3,6},{5,8},{7,10},{9,12},{11,14},{13,16},{15,18},
    {1,2},{3,4},{5,6},{7,8},{9,10},{11,12},{13,14},{15,16},{17,18},
};

void rank20(int16_t *val, uint8_t *idx) {
    for (auto &p : RANK20_NET) {
        const int x = p[0], y = p[1];
        if (val[x] < val[y]) {
            std::swap(val[x], val[y]);
            std::swap(idx[x], idx[y]);
        }
    }
}

// KmerGenerator::generateKmerList with the per-position divide strategy
// (profile queries: one sorted 20-entry PSSM row per spaced position,
// KmerGenerator::setDivideStrategy(ScoreMatrix**) + generateKmerList,
// KmerGenerator.cpp:30-38,106-185). srow/irow: kk sorted rows.
size_t gen_profile_kmer_list(PF *pf, Scratch &sc, const int16_t *srow[KK_MAX],
                             const uint8_t *irow[KK_MAX], int threshold,
                             uint32_t *out) {
    static const uint32_t POW20[KK_MAX + 1] = {1, 20, 400, 8000, 160000,
                                               3200000, 64000000, 1280000000};
    const int KKr = pf->kk;
    int possibleRest[KK_MAX];
    possibleRest[KKr - 1] = 0;
    for (int k = KKr - 1; k >= 1; k--) {
        possibleRest[k - 1] = srow[k][0] + possibleRest[k];
    }
    for (int b = 0; b < 2; b++) {
        if (sc.gscore[b].size() < MAX_KMER_RESULT_SIZE) {
            sc.gscore[b].resize(MAX_KMER_RESULT_SIZE);
            sc.gindex[b].resize(MAX_KMER_RESULT_SIZE);
        }
    }
    int cutoff1 = threshold - possibleRest[0];
    // first input: position 0's sorted row itself (width-1 indices)
    int16_t s0[20];
    uint32_t x0[20];
    for (int j = 0; j < 20; j++) {
        s0[j] = srow[0][j];
        x0[j] = irow[0][j];
    }
    const int16_t *inScore = s0;
    const uint32_t *inIndex = x0;
    size_t inSize = 20;
    size_t counter = 0;
    for (int step = 0; step + 1 < KKr; step++) {
        int16_t *outScore = sc.gscore[step % 2].data();
        uint32_t *outIndex = sc.gindex[step % 2].data();
        const int16_t *ns = srow[step + 1];
        const uint8_t *nx = irow[step + 1];
        const uint32_t pw = POW20[step + 1];
        counter = 0;
        for (size_t a = 0; a < inSize; a++) {
            const int score_a = inScore[a];
            if (score_a < cutoff1) break;
            const uint32_t kmer_a = inIndex[a];
            const int cutoff2 = threshold - score_a - possibleRest[step + 1];
            for (size_t j = 0; j < 20 && (counter + 1 < MAX_KMER_RESULT_SIZE)
                               && ns[j] >= cutoff2; j++) {
                outScore[counter] = (int16_t)(score_a + ns[j]);
                outIndex[counter] = kmer_a + (uint32_t)nx[j] * pw;
                counter++;
            }
            if (counter + 1 >= MAX_KMER_RESULT_SIZE) break;
        }
        inScore = outScore;
        inIndex = outIndex;
        inSize = counter;
        cutoff1 = -1000;
    }
    memcpy(out, inIndex, counter * sizeof(uint32_t));
    return counter;
}

// Collect the (seqId, diagonal) match stream for one query
// QueryMatcher::match (QueryMatcher.cpp:213-340): scan query k-mers,
// gather postings into the chunk buffer, flushing overflowing chunks
// through flush_chunk; final dedup+merge leaves the result in sc.found.
// diag_scoring selects the per-chunk duplicate semantics (false = count
// mode). Returns the deduped result count.
size_t match_collect(PF *pf, Scratch &sc, const uint8_t *q, int64_t qlen,
                     const float *comp_bias, bool diag_scoring,
                     const int8_t *qprof, QStats *st) {
    const size_t maxDbMatches =
        std::max((size_t)1000000, (size_t)pf->nseq) * 2;
    sc.ensure_bins(pf->bincount);
    sc.clear_bins();
    std::vector<uint32_t> &klist = sc.klist;
    ProfAcc *pa = prof_enabled() ? &sc.prof : nullptr;
    size_t ovf = 0;
    uint8_t w[KK_MAX];
    // precompute each position's 3-mer row ids so the ExtMat3 row heads
    // (4 random streams into the 384 MB table pair) can be prefetched a
    // couple of positions ahead — the row head misses dominate the
    // k-mer list generation cost
    const int64_t npos = (qlen >= pf->pat_span)
        ? qlen - pf->pat_span + 1 : 0;
    if ((int64_t)sc.rowids.size() < 2 * npos + 4)
        sc.rowids.resize(2 * npos + 4);
    int32_t *rowids = sc.rowids.data();
    const bool k7 = (pf->kk == 7);
    for (int64_t i = 0; i < npos; i++) {
        if (extract_kmer(pf, q, i, w)) {
            if (k7) {
                // [2,2,3] parts: m3 row (positions 4-6) + first m2 row
                rowids[2 * i] = w[4] + 20 * w[5] + 400 * w[6];
                rowids[2 * i + 1] = w[0] + 20 * w[1];
            } else {
                rowids[2 * i] = kidx3(w);
                rowids[2 * i + 1] = kidx3(w + 3);
            }
        } else {
            rowids[2 * i] = -1;
        }
    }
    const int16_t *m3s = pf->m3->score.data();
    const uint32_t *m3x = pf->m3->index.data();
    const int16_t *m2s = k7 ? pf->m2->score.data() : nullptr;
    const uint32_t *m2x = k7 ? pf->m2->index.data() : nullptr;
    for (int64_t i = 0; i < npos; i++) {
        for (int64_t d = 2; d <= 2; d++) {
            if (i + d < npos && rowids[2 * (i + d)] >= 0) {
                const size_t ra = (size_t)rowids[2 * (i + d)] * SUB3;
                __builtin_prefetch(m3s + ra);
                __builtin_prefetch(m3x + ra);
                if (k7) {
                    const size_t rb =
                        (size_t)rowids[2 * (i + d) + 1] * SUB2;
                    __builtin_prefetch(m2s + rb);
                    __builtin_prefetch(m2x + rb);
                } else {
                    const size_t rb =
                        (size_t)rowids[2 * (i + d) + 1] * SUB3;
                    __builtin_prefetch(m3s + rb);
                    __builtin_prefetch(m3x + rb);
                }
            }
        }
        if (rowids[2 * i] < 0) continue;
        extract_kmer(pf, q, i, w);
        float biasCorrection = 0;
        for (int k = 0; k < pf->kk; k++)
            biasCorrection += comp_bias[i + pf->pat_pos[k]];
        const short bias = (short)((biasCorrection < 0.0f)
                                       ? biasCorrection - 0.5f
                                       : biasCorrection + 0.5f);
        const short thr = std::max((short)(pf->kmer_thr - bias), (short)0);
        if (klist.size() < MAX_KMER_RESULT_SIZE) klist.resize(MAX_KMER_RESULT_SIZE);
        size_t nk;
        {
            PhaseTimer t(pa, PH_GEN);
            nk = gen_kmer_list(pf, sc, w, thr, klist.data());
        }
        if (st) st->kmer_list_len += nk;
        PhaseTimer tg(pa, PH_GATHER);
        // pass A: presence-bitmap filter (8 MB, L3-resident) drops the
        // ~90+% of similar k-mers with empty posting lists before they
        // cost a random load into the 256 MB offsets table
        if (sc.klist2.size() < MAX_KMER_RESULT_SIZE)
            sc.klist2.resize(MAX_KMER_RESULT_SIZE);
        const uint64_t *kb = pf->kbit.data();
        uint32_t *kl2 = sc.klist2.data();
        size_t n2 = 0;
        for (size_t kp = 0; kp < nk; kp++) {
            if (kp + 48 < nk) __builtin_prefetch(&kb[klist[kp + 48] >> 6]);
            const uint32_t k = klist[kp];
            kl2[n2] = k;
            n2 += (size_t)((kb[k >> 6] >> (k & 63)) & 1u);
        }
        // pass B: gather postings for non-empty k-mers, offsets and
        // entries prefetched ahead (the loop is memory-latency-bound)
        const uint32_t mask = pf->bincount - 1;
        const uint16_t qpos = (uint16_t)i;
        for (size_t kp = 0; kp < n2; kp++) {
            if (kp + 8 < n2) __builtin_prefetch(&pf->offsets[kl2[kp + 8]]);
            if (kp + 4 < n2)
                __builtin_prefetch(&pf->entries[pf->offsets[kl2[kp + 4]]]);
            const uint64_t a = pf->offsets[kl2[kp]];
            const uint64_t b = pf->offsets[kl2[kp] + 1];
            if (sc.binTotal + (b - a) >= maxDbMatches) {
                if (st) st->overflowed = true;
                ovf = flush_chunk(pf, sc, ovf, diag_scoring, qprof, (int)qlen);
                // a single posting list larger than the whole buffer
                // ends the scan (QueryMatcher.cpp:312-314)
                if (b - a >= maxDbMatches) goto outer;
            }
            for (uint64_t e = a; e < b; e++) {
                const IndexEntry en = pf->entries[e];
                sc.bins[en.seqId & mask].push_back(
                    {en.seqId, (uint16_t)(qpos - en.pos_j)});
            }
            sc.binTotal += b - a;
            if (st) st->db_matches += b - a;
        }
    }
    outer:
    {
        PhaseTimer t(pa, PH_DUP);
        return final_dedup(pf, sc, ovf, diag_scoring, st);
    }
}

}  // namespace

extern "C" {

// host_ops.cpp: calcLocalAaBiasCorrection port
void comp_bias(const uint8_t *seq, int64_t n, const int32_t *scores,
               int64_t alpha, const double *pback, double scale,
               float *out);

// One query against the index. comp_bias: float per query position
// (calcLocalAaBiasCorrection with the VTML80 matrix). Returns hit count
// (<= max_hits); -1 on unsupported overflow.
int64_t pf_match_sc(PF *pf, Scratch &sc, const uint8_t *q, int64_t qlen,
                    const float *comp_bias, int64_t max_hits,
                    int64_t min_diag_thr, uint32_t identity_id,
                    uint32_t *out_id, int32_t *out_score,
                    int16_t *out_diag, QStats *st = nullptr) {
    max_hits = std::min(max_hits, pf->nseq);

    // query profile: biased BLOSUM62 2-bit + round(bias/4) per position
    // (UngappedAlignment::createProfile, UngappedAlignment.cpp:385-414)
    std::vector<int8_t> &qprof = sc.qprof;
    qprof.resize((size_t)qlen * A21);
    for (int64_t pos = 0; pos < qlen; pos++) {
        float b = comp_bias[pos];
        b = (b < 0.0f) ? b / 4 - 0.5f : b / 4 + 0.5f;
        const int8_t corr = (int8_t)(char)b;
        const int16_t *row = pf->bl + q[pos] * A21;
        for (int i = 0; i < A21; i++) {
            qprof[(size_t)pos * A21 + i] = (int8_t)(char)(row[i] + corr);
        }
    }

    const size_t resultSize =
        match_collect(pf, sc, q, qlen, comp_bias, true, qprof.data(), st);
    return finish_match(pf, sc, resultSize, qprof.data(), q, qlen, max_hits,
                        min_diag_thr, identity_id, out_id, out_score,
                        out_diag);
}

int64_t pf_match(void *h, const uint8_t *q, int64_t qlen,
                 const float *comp_bias, int64_t max_hits,
                 int64_t min_diag_thr, uint32_t identity_id,
                 uint32_t *out_id, int32_t *out_score, int16_t *out_diag) {
    PF *pf = static_cast<PF *>(h);
    pf->scr.ensure_dup(pf->dup_bytes);
    return pf_match_sc(pf, pf->scr, q, qlen, comp_bias, max_hits,
                       min_diag_thr, identity_id, out_id, out_score,
                       out_diag);
}

// Batched pf_match: nq queries concatenated in qdata with qoffs (nq+1
// prefix offsets). Composition bias is computed in-line per query with
// the supplied matrix (calcLocalAaBiasCorrection; scores==NULL -> zero
// bias). identity_ids may be NULL (no identity hit forcing). Outputs are
// (nq, cap) row-major blocks; out_counts[i] = hits for query i (or -1 on
// that query's overflow). Eliminates the per-query Python/ctypes round
// trip that dominated many-fragment workloads.
// out_stats (may be NULL): int64[5] accumulated over queries —
// [0] sum of similar-k-mer list lengths, [1] sum of query lengths,
// [2] sum of gathered DB matches, [3] queries that hit the posting-
// buffer overflow path, [4] sum of returned hit counts. These are the
// reference's per-run prefilter statistics
// (Prefiltering::printStatistics, Prefiltering.cpp:953-975).
int64_t pf_match_batch2(void *h, const uint8_t *qdata, const int64_t *qoffs,
                        int64_t nq, const int32_t *scores,
                        const double *pback, int64_t max_hits,
                        int64_t min_diag_thr, const uint32_t *identity_ids,
                        int64_t cap, uint32_t *out_id, int32_t *out_score,
                        int16_t *out_diag, int64_t *out_counts,
                        int64_t *out_stats) {
    PF *pf = static_cast<PF *>(h);
    int64_t s_klen = 0, s_qlen = 0, s_db = 0, s_ovf = 0, s_hits = 0;
    uint64_t prof_c[PH_N] = {0};
#ifdef _OPENMP
#pragma omp parallel reduction(+:s_klen, s_qlen, s_db, s_ovf, s_hits)
#endif
    {
        Scratch sc;  // per-thread: hit buffers + duplicate bit-array
        sc.ensure_dup(pf->dup_bytes);
        std::vector<float> bias;
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 8)
#endif
        for (int64_t qi = 0; qi < nq; qi++) {
            const uint8_t *q = qdata + qoffs[qi];
            const int64_t qlen = qoffs[qi + 1] - qoffs[qi];
            bias.assign((size_t)qlen, 0.0f);
            if (scores != nullptr) {
                comp_bias(q, qlen, scores, A21, pback, 1.0, bias.data());
            }
            QStats st;
            out_counts[qi] = pf_match_sc(
                pf, sc, q, qlen, bias.data(), max_hits, min_diag_thr,
                identity_ids ? identity_ids[qi] : 0xFFFFFFFFu,
                out_id + qi * cap, out_score + qi * cap,
                out_diag + qi * cap, &st);
            s_klen += (int64_t)st.kmer_list_len;
            s_qlen += qlen;
            s_db += (int64_t)st.db_matches;
            s_ovf += st.overflowed ? 1 : 0;
            s_hits += out_counts[qi] > 0 ? out_counts[qi] : 0;
        }
        if (prof_enabled()) {
#ifdef _OPENMP
#pragma omp critical
#endif
            for (int p = 0; p < PH_N; p++) prof_c[p] += sc.prof.c[p];
        }
    }
    if (prof_enabled()) {
        static const char *names[PH_N] = {"gen", "gather", "dup", "rescore",
                                          "finish", "keepmax", "csort", "emit"};
        fprintf(stderr, "[pf prof cycles]");
        for (int p = 0; p < PH_N; p++)
            fprintf(stderr, " %s=%.2fG", names[p], prof_c[p] / 1e9);
        fprintf(stderr, "\n");
    }
    if (out_stats != nullptr) {
        out_stats[0] = s_klen;
        out_stats[1] = s_qlen;
        out_stats[2] = s_db;
        out_stats[3] = s_ovf;
        out_stats[4] = s_hits;
    }
    return 0;
}

// Compact-output batched match: per-thread result buffers assembled
// into dense arrays after the parallel region, replacing the (nq, cap)
// row-major outputs whose sparse first-touch page faults dominated the
// batch runtime (median hit count is ~1 while cap is max_hits+1) and
// whose footprint is prohibitive at millions of queries. The caller
// provides out_counts (nq) and receives malloc'd dense arrays
// (*out_ids/*out_scores/*out_diags, total = sum counts, query-major
// order) to copy and release via pf_free_results.
int64_t pf_match_batch_compact(
        void *h, const uint8_t *qdata, const int64_t *qoffs, int64_t nq,
        const int32_t *scores, const double *pback, int64_t max_hits,
        int64_t min_diag_thr, const uint32_t *identity_ids,
        int64_t *out_counts, int64_t *out_stats, uint32_t **out_ids,
        int32_t **out_scores, int16_t **out_diags) {
    PF *pf = static_cast<PF *>(h);
    int64_t s_klen = 0, s_qlen = 0, s_db = 0, s_ovf = 0, s_hits = 0;
    uint64_t prof_c[PH_N] = {0};
    const int64_t cap = std::min(max_hits, pf->nseq) + 1;
    struct ThreadRes {
        std::vector<Hit> hits;                      // per-thread, appended
        std::vector<std::pair<int64_t, int64_t>> q; // (qi, start in hits)
    };
    std::vector<ThreadRes> tres;
#ifdef _OPENMP
#pragma omp parallel reduction(+:s_klen, s_qlen, s_db, s_ovf, s_hits)
#endif
    {
#ifdef _OPENMP
        const int tid = omp_get_thread_num();
#pragma omp single
        tres.resize(omp_get_num_threads());
#else
        const int tid = 0;
        tres.resize(1);
#endif
        ThreadRes &tr = tres[tid];
        Scratch sc;
        sc.ensure_dup(pf->dup_bytes);
        std::vector<float> bias;
        std::vector<uint32_t> lid(cap);
        std::vector<int32_t> lsc(cap);
        std::vector<int16_t> ldg(cap);
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 8)
#endif
        for (int64_t qi = 0; qi < nq; qi++) {
            const uint8_t *q = qdata + qoffs[qi];
            const int64_t qlen = qoffs[qi + 1] - qoffs[qi];
            bias.assign((size_t)qlen, 0.0f);
            if (scores != nullptr) {
                comp_bias(q, qlen, scores, A21, pback, 1.0, bias.data());
            }
            QStats st;
            const int64_t n = pf_match_sc(
                pf, sc, q, qlen, bias.data(), max_hits, min_diag_thr,
                identity_ids ? identity_ids[qi] : 0xFFFFFFFFu,
                lid.data(), lsc.data(), ldg.data(), &st);
            out_counts[qi] = n;
            tr.q.push_back({qi, (int64_t)tr.hits.size()});
            for (int64_t i = 0; i < n; i++) {
                tr.hits.push_back({lid[i], lsc[i], (uint16_t)ldg[i]});
            }
            s_klen += (int64_t)st.kmer_list_len;
            s_qlen += qlen;
            s_db += (int64_t)st.db_matches;
            s_ovf += st.overflowed ? 1 : 0;
            s_hits += n > 0 ? n : 0;
        }
        if (prof_enabled()) {
#ifdef _OPENMP
#pragma omp critical
#endif
            for (int p = 0; p < PH_N; p++) prof_c[p] += sc.prof.c[p];
        }
    }
    if (prof_enabled()) {
        static const char *names[PH_N] = {"gen", "gather", "dup", "rescore",
                                          "finish", "keepmax", "csort",
                                          "emit"};
        fprintf(stderr, "[pf prof cycles]");
        for (int p = 0; p < PH_N; p++)
            fprintf(stderr, " %s=%.2fG", names[p], prof_c[p] / 1e9);
        fprintf(stderr, "\n");
    }
    if (out_stats != nullptr) {
        out_stats[0] = s_klen;
        out_stats[1] = s_qlen;
        out_stats[2] = s_db;
        out_stats[3] = s_ovf;
        out_stats[4] = s_hits;
    }
    // dense query-major assembly
    int64_t total = 0;
    std::vector<int64_t> qoff(nq + 1, 0);
    for (int64_t qi = 0; qi < nq; qi++) {
        qoff[qi + 1] = qoff[qi] + std::max<int64_t>(out_counts[qi], 0);
    }
    total = qoff[nq];
    uint32_t *ids = (uint32_t *)malloc(sizeof(uint32_t) * total);
    int32_t *scs = (int32_t *)malloc(sizeof(int32_t) * total);
    int16_t *dgs = (int16_t *)malloc(sizeof(int16_t) * total);
    for (auto &tr : tres) {
        for (auto &qe : tr.q) {
            const int64_t qi = qe.first;
            const int64_t n = std::max<int64_t>(out_counts[qi], 0);
            const Hit *src = tr.hits.data() + qe.second;
            uint32_t *di = ids + qoff[qi];
            int32_t *dsc = scs + qoff[qi];
            int16_t *ddg = dgs + qoff[qi];
            for (int64_t i = 0; i < n; i++) {
                di[i] = src[i].seqId;
                dsc[i] = src[i].prefScore;
                ddg[i] = (int16_t)src[i].diagonal;
            }
        }
    }
    *out_ids = ids;
    *out_scores = scs;
    *out_diags = dgs;
    return total;
}

void pf_free_results(uint32_t *ids, int32_t *scores, int16_t *diags) {
    free(ids);
    free(scores);
    free(diags);
}

int64_t pf_match_batch(void *h, const uint8_t *qdata, const int64_t *qoffs,
                       int64_t nq, const int32_t *scores,
                       const double *pback, int64_t max_hits,
                       int64_t min_diag_thr, const uint32_t *identity_ids,
                       int64_t cap, uint32_t *out_id, int32_t *out_score,
                       int16_t *out_diag, int64_t *out_counts) {
    return pf_match_batch2(h, qdata, qoffs, nq, scores, pback, max_hits,
                           min_diag_thr, identity_ids, cap, out_id,
                           out_score, out_diag, out_counts, nullptr);
}

// The --diag-score 0 prefilter (cascaded clustering step 0): score =
// double-diagonal k-mer match count, no ungapped rescoring
// (QueryMatcher matchQuery diagonalScoring==false path).
int64_t pf_match_count(void *h, const uint8_t *q, int64_t qlen,
                       const float *comp_bias, int64_t max_hits,
                       int64_t min_diag_thr, uint32_t identity_id,
                       uint32_t *out_id, int32_t *out_score,
                       int16_t *out_diag) {
    PF *pf = static_cast<PF *>(h);
    max_hits = std::min(max_hits, pf->nseq);
    pf->scr.ensure_dup(pf->dup_bytes);
    const size_t resultSize = match_collect(pf, pf->scr, q, qlen, comp_bias,
                                            false, nullptr, nullptr);
    return finish_match_count(pf, pf->scr, resultSize, max_hits,
                              min_diag_thr, identity_id, out_id, out_score,
                              out_diag);
}

// One HMM-profile query against the index (blastpgp.sh / profile-query
// role; the index must have been built with kmer threshold 0 —
// Prefiltering.cpp:525-527 forces localKmerThr=0 for profile queries).
//   qnum:       L query letters (Sequence::numSequence for profiles,
//               data[pos*25+20]) — drives the X skip and the saturation
//               self-score
//   raw_scores: L*20 int16 stored PSSM scores (the 4x-scaled values)
//   qprof:      L*21 int8 alignment profile (stored/4, X column 0)
//   kmer_thr:   the profile k-mer list threshold (profile branch of
//               Prefiltering::getKmerThreshold); composition bias is
//               zero for profiles (QueryMatcher.cpp:92-99)
// per-thread scratch management: pf_match_profile_sc lets callers run
// concurrent profile matches against one shared index (the sliced
// profile search fans profiles over host threads; every mutable buffer
// lives in the Scratch, the PF index is read-only during matching)
void *pf_scratch_new(void *h) {
    PF *pf = static_cast<PF *>(h);
    Scratch *sc = new Scratch();
    sc->ensure_dup(pf->dup_bytes);
    return sc;
}

void pf_scratch_free(void *s) {
    delete static_cast<Scratch *>(s);
}

int64_t pf_match_profile_sc(void *h, void *scr, const uint8_t *qnum,
                            int64_t qlen, const int16_t *raw_scores,
                            const int8_t *qprof, int64_t kmer_thr,
                            int64_t max_hits, int64_t min_diag_thr,
                            uint32_t identity_id, uint32_t *out_id,
                            int32_t *out_score, int16_t *out_diag) {
    PF *pf = static_cast<PF *>(h);
    const size_t maxDbMatches = std::max((size_t)1000000, (size_t)pf->nseq) * 2;
    max_hits = std::min(max_hits, pf->nseq);

    // sorted PSSM rows (Sequence::mapProfile kmerSize!=0 branch:
    // rankedDescSort20 per position)
    Scratch &sc = *static_cast<Scratch *>(scr);
    sc.ensure_dup(pf->dup_bytes);
    sc.psort_s.resize((size_t)qlen * 20);
    sc.psort_i.resize((size_t)qlen * 20);
    for (int64_t pos = 0; pos < qlen; pos++) {
        int16_t *sr = sc.psort_s.data() + pos * 20;
        uint8_t *ir = sc.psort_i.data() + pos * 20;
        for (int a = 0; a < 20; a++) {
            sr[a] = raw_scores[pos * 20 + a];
            ir[a] = (uint8_t)a;
        }
        rank20(sr, ir);
    }

    sc.ensure_bins(pf->bincount);
    sc.clear_bins();
    std::vector<uint32_t> &klist = sc.klist;
    const int thr = std::max((int)kmer_thr, 0);
    const uint32_t mask = pf->bincount - 1;
    size_t ovf = 0;
    for (int64_t i = 0; i + pf->pat_span <= qlen; i++) {
        bool hasX = false;
        const int16_t *srow[KK_MAX];
        const uint8_t *irow[KK_MAX];
        for (int k = 0; k < pf->kk; k++) {
            const int64_t p = i + pf->pat_pos[k];
            hasX |= (qnum[p] == ALPH);
            srow[k] = sc.psort_s.data() + p * 20;
            irow[k] = sc.psort_i.data() + p * 20;
        }
        if (hasX) continue;
        if (klist.size() < MAX_KMER_RESULT_SIZE) klist.resize(MAX_KMER_RESULT_SIZE);
        const size_t nk = gen_profile_kmer_list(pf, sc, srow, irow, thr,
                                                klist.data());
        for (size_t kp = 0; kp < nk; kp++) {
            const uint64_t a = pf->offsets[klist[kp]];
            const uint64_t b = pf->offsets[klist[kp] + 1];
            if (sc.binTotal + (b - a) >= maxDbMatches) {
                // chunked overflow handling, same as the sequence path
                // (QueryMatcher::match is shared by profile queries)
                ovf = flush_chunk(pf, sc, ovf, true, qprof, (int)qlen);
                if (b - a >= maxDbMatches) goto outer;
            }
            for (uint64_t e = a; e < b; e++) {
                const IndexEntry en = pf->entries[e];
                sc.bins[en.seqId & mask].push_back(
                    {en.seqId, (uint16_t)((uint16_t)i - en.pos_j)});
            }
            sc.binTotal += b - a;
        }
    }
    outer:
    {
        const size_t resultSize = final_dedup(pf, sc, ovf, true, nullptr);
        return finish_match(pf, sc, resultSize, qprof, qnum, qlen, max_hits,
                            min_diag_thr, identity_id, out_id, out_score,
                            out_diag);
    }
}

int64_t pf_match_profile(void *h, const uint8_t *qnum, int64_t qlen,
                         const int16_t *raw_scores, const int8_t *qprof,
                         int64_t kmer_thr, int64_t max_hits,
                         int64_t min_diag_thr, uint32_t identity_id,
                         uint32_t *out_id, int32_t *out_score,
                         int16_t *out_diag) {
    PF *pf = static_cast<PF *>(h);
    return pf_match_profile_sc(h, &pf->scr, qnum, qlen, raw_scores, qprof,
                               kmer_thr, max_hits, min_diag_thr,
                               identity_id, out_id, out_score, out_diag);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Persistent index serialization (the createindex artifact role,
// workflow/CreateIndex.cpp + PrefilteringIndexReader — own compact format,
// not the reference's versioned binary): header + masked sequences +
// entries + sparse (kmer, start) ranges for non-empty k-mers.
// ---------------------------------------------------------------------------
#include <cstdio>

namespace {
constexpr uint64_t PF_IDX_MAGIC = 0x4d45554b49445833ULL;  // "MEUKIDX3"
                                  // v3: packed 6-byte IndexEntry
}

extern "C" {

int64_t pf_save_index(void *h, const char *path) {
    PF *pf = static_cast<PF *>(h);
    FILE *f = fopen(path, "wb");
    if (!f) return -1;
    uint64_t hdr[6] = {PF_IDX_MAGIC, (uint64_t)pf->kmer_thr,
                       (uint64_t)pf->nseq, (uint64_t)pf->tdata.size(),
                       (uint64_t)pf->entries.size(), (uint64_t)pf->kk};
    fwrite(hdr, sizeof(hdr), 1, f);
    fwrite(pf->toff.data(), sizeof(int64_t), pf->nseq + 1, f);
    fwrite(pf->tdata.data(), 1, pf->tdata.size(), f);
    fwrite(pf->entries.data(), sizeof(IndexEntry), pf->entries.size(), f);
    // sparse ranges
    std::vector<uint64_t> sparse;
    for (size_t k = 0; k < pf->kspace; k++) {
        if (pf->offsets[k + 1] != pf->offsets[k]) {
            sparse.push_back(((uint64_t)k << 32) | pf->offsets[k]);
        }
    }
    uint64_t nsparse = sparse.size();
    fwrite(&nsparse, sizeof(nsparse), 1, f);
    fwrite(sparse.data(), sizeof(uint64_t), nsparse, f);
    fclose(f);
    return 0;
}

int64_t pf_load_index(void *h, const char *path) {
    PF *pf = static_cast<PF *>(h);
    FILE *f = fopen(path, "rb");
    if (!f) return -1;
    uint64_t hdr[6];
    if (fread(hdr, sizeof(hdr), 1, f) != 1 || hdr[0] != PF_IDX_MAGIC ||
        (int64_t)hdr[1] != pf->kmer_thr || (int)hdr[5] != pf->kk) {
        fclose(f);
        return -2;  // wrong magic/threshold/k-mer size
    }
    pf->nseq = (int64_t)hdr[2];
    pf->toff.resize(pf->nseq + 1);
    pf->tdata.resize(hdr[3]);
    pf->entries.resize(hdr[4]);
    if (fread(pf->toff.data(), sizeof(int64_t), pf->nseq + 1, f) !=
            (size_t)(pf->nseq + 1) ||
        fread(pf->tdata.data(), 1, hdr[3], f) != hdr[3] ||
        fread(pf->entries.data(), sizeof(IndexEntry), hdr[4], f) != hdr[4]) {
        fclose(f);
        return -3;
    }
    uint64_t nsparse = 0;
    if (fread(&nsparse, sizeof(nsparse), 1, f) != 1) { fclose(f); return -3; }
    std::vector<uint64_t> sparse(nsparse);
    if (nsparse && fread(sparse.data(), sizeof(uint64_t), nsparse, f)
            != nsparse) {
        fclose(f);
        return -3;
    }
    fclose(f);
    pf->offsets.assign(pf->kspace + 1, 0);
    // reconstruct flat offsets: fill starts, then forward-fill ends
    for (uint64_t sv : sparse) {
        pf->offsets[sv >> 32] = (uint32_t)sv;
    }
    uint32_t total = (uint32_t)pf->entries.size();
    pf->offsets[pf->kspace] = total;
    uint32_t next = total;
    size_t si = sparse.size();
    for (size_t k = pf->kspace; k-- > 0;) {
        if (si > 0 && (sparse[si - 1] >> 32) == k) {
            next = (uint32_t)sparse[si - 1];
            si--;
            // offsets[k] already set to start
        } else {
            pf->offsets[k] = next;
        }
    }
    build_kbit(pf);
    pf->bincount = pick_bincount((size_t)pf->nseq);
    pf->binbits = 0;
    while ((1u << pf->binbits) < pf->bincount) pf->binbits++;
    size_t sz = 1;
    while (sz < (size_t)pf->nseq) sz <<= 1;
    sz = std::max(sz >> pf->binbits, (size_t)1);
    pf->dup_bytes = sz + 2;
    pf->scr.ensure_dup(pf->dup_bytes);
    return (int64_t)pf->nseq;
}

}  // extern "C"
