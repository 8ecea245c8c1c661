// metaeuk_tpu native host layer.
//
// C++ implementations of the host-side hot loops that surround the device
// compute path — the role the reference implements natively in
// lib/mmseqs/src (OpenMP C++): six-frame fragment scanning
// (Orf::findForward, commons/Orf.cpp:228-348) and the per-group exon
// chaining dynamic program (findoptimalsetbydp,
// src/exonpredictor/collectoptimalset.cpp:108-222).
//
// Exposed through a plain C ABI and loaded with ctypes
// (metaeuk_tpu/native.py); the Python/numpy implementations remain as
// fallback and oracle.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Six-frame stop-to-stop fragment scan (one strand).
//
// seq: uppercase ASCII (already U->T normalized), length n.
// stop_codons: packed 3-byte codons, n_stops entries.
// outputs (caller-allocated, capacity >= n/3 + 4):
//   out_from, out_to, out_flags (bit0 incomplete start, bit1 incomplete end),
//   out_close (scan-order key).
// returns number of fragments emitted.
int64_t orf_scan_strand(const uint8_t* seq, int64_t n,
                        const uint8_t* stop_codons, int64_t n_stops,
                        int64_t min_len, int64_t max_len, int64_t max_gaps,
                        int64_t* out_from, int64_t* out_to,
                        uint8_t* out_flags, int64_t* out_close) {
    if (n < 3) return 0;
    int64_t count = 0;
    // per-position codon classification
    std::vector<uint8_t> is_stop(n - 2, 0);
    std::vector<uint8_t> is_gapn(n - 2, 0);
    std::vector<uint8_t> bad(n, 0);
    static uint8_t revcomp_ok[256];
    static bool init_done = false;
    if (!init_done) {
        const char* pairs = "TVGH..CD..M.KN...YSAABW.R";
        memset(revcomp_ok, 0, sizeof(revcomp_ok));
        for (int i = 0; i < 25; i++) {
            if (pairs[i] != '.') {
                revcomp_ok['A' + i] = 1;
                revcomp_ok['a' + i] = 1;
            }
        }
        init_done = true;
    }
    for (int64_t i = 0; i < n; i++) {
        uint8_t c = seq[i];
        bad[i] = (c == 'N') || !revcomp_ok[c];
    }
    for (int64_t i = 0; i + 2 < n; i++) {
        uint32_t tri = (uint32_t(seq[i]) << 16) | (uint32_t(seq[i + 1]) << 8)
                       | seq[i + 2];
        for (int64_t s = 0; s < n_stops; s++) {
            const uint8_t* c = stop_codons + 3 * s;
            uint32_t code = (uint32_t(c[0]) << 16) | (uint32_t(c[1]) << 8) | c[2];
            if (tri == code) { is_stop[i] = 1; break; }
        }
        is_gapn[i] = bad[i] | bad[i + 1] | bad[i + 2];
    }
    for (int f = 0; f < 3; f++) {
        int64_t run_start = -1;     // codon position of run start
        int64_t run_len = 0, run_gaps = 0;
        bool first_run = true;
        int64_t last_pos = -1;
        for (int64_t p = f; p + 2 < n; p += 3) {
            last_pos = p;
            if (is_stop[p]) {
                if (run_len > 0 && run_gaps <= max_gaps &&
                    run_len >= min_len && run_len <= max_len) {
                    out_from[count] = run_start;
                    out_to[count] = p - 1;
                    out_flags[count] = first_run ? 1 : 0;  // !stop bit unset
                    out_close[count] = p;
                    count++;
                }
                run_start = -1; run_len = 0; run_gaps = 0; first_run = false;
            } else {
                if (run_start < 0) run_start = p;
                run_len++;
                if (is_gapn[p]) run_gaps++;
            }
        }
        // close at the last complete codon (isLast, no stop)
        if (run_len > 0 && run_gaps <= max_gaps &&
            run_len >= min_len && run_len <= max_len) {
            out_from[count] = run_start;
            out_to[count] = last_pos + 2;
            out_flags[count] = uint8_t((first_run ? 1 : 0) | 2);
            out_close[count] = last_pos;
            count++;
        }
    }
    // stable sort by close position (scan emission order)
    std::vector<int64_t> order(count);
    for (int64_t i = 0; i < count; i++) order[i] = i;
    std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
        return out_close[a] < out_close[b];
    });
    std::vector<int64_t> tf(count), tt(count), tc(count);
    std::vector<uint8_t> tg(count);
    for (int64_t i = 0; i < count; i++) {
        tf[i] = out_from[order[i]]; tt[i] = out_to[order[i]];
        tg[i] = out_flags[order[i]]; tc[i] = out_close[order[i]];
    }
    if (count) {  // empty vectors may hand memcpy a null source (UB)
        memcpy(out_from, tf.data(), count * sizeof(int64_t));
        memcpy(out_to, tt.data(), count * sizeof(int64_t));
        memcpy(out_flags, tg.data(), count * sizeof(uint8_t));
        memcpy(out_close, tc.data(), count * sizeof(int64_t));
    }
    return count;
}

// ---------------------------------------------------------------------------
// Exon chaining DP over one sorted candidate list
// (findoptimalsetbydp inner loops, collectoptimalset.cpp:162-200).
//
// Candidates must already be sorted by (contigStart, contigEnd) with used
// exons removed. Outputs prev_id/path_score per candidate plus the best
// path end; the traceback stays in the caller.
void chain_dp(int64_t n,
              const int64_t* contig_start, const int64_t* contig_end,
              const int64_t* t_start, const int64_t* t_end,
              const int64_t* bit_score, const int64_t* aa_len,
              int64_t target_len,
              int64_t min_intron, int64_t max_intron, int64_t max_overlap,
              int64_t gap_open, int64_t gap_extend, double tcov_thr,
              int64_t* prev_id, int64_t* path_score, int64_t* num_exons,
              int64_t* path_aa_len,
              int64_t* best_last_out, int64_t* best_score_out) {
    int64_t best_score = 0, best_last = 0;
    for (int64_t i = 0; i < n; i++) {
        prev_id[i] = i;
        path_score[i] = bit_score[i];
        num_exons[i] = 1;
        path_aa_len[i] = aa_len[i];
    }
    for (int64_t curr = 0; curr < n; curr++) {
        for (int64_t prev = 0; prev < curr; prev++) {
            // isPairCompatible (collectoptimalset.cpp:36-82)
            if (contig_end[curr] < contig_end[prev]) continue;
            int64_t diff_contig = contig_start[curr] - contig_end[prev] - 1;
            if (diff_contig < 0) continue;
            if (diff_contig < min_intron || diff_contig > max_intron) continue;
            int64_t diff_aas = t_start[curr] - t_end[prev] - 1;
            int64_t aa_overlap = 0;
            if (diff_aas < 0) {
                aa_overlap = -diff_aas;
                if (aa_overlap > max_overlap) continue;
            }
            if (t_start[curr] < t_start[prev]) continue;
            // getPenaltyForProtCoords (:84-106)
            int64_t cost;
            if (diff_aas < 0) cost = gap_open + gap_extend * (-diff_aas - 1);
            else if (diff_aas <= 1) cost = 0;
            else cost = gap_open + gap_extend * (diff_aas - 1);
            int64_t k = num_exons[prev] + 1;
            int64_t bonus = (int64_t)std::log2((double)k);
            int64_t cand = path_score[prev] + cost + bit_score[curr] + bonus;
            if (cand > path_score[curr]) {
                prev_id[curr] = prev;
                path_score[curr] = cand;
                num_exons[curr] = k;
                path_aa_len[curr] = path_aa_len[prev] + aa_len[curr] - aa_overlap;
            }
        }
        if ((double)path_aa_len[curr] / (double)target_len >= tcov_thr) {
            if (path_score[curr] > best_score) {
                best_last = curr;
                best_score = path_score[curr];
            }
        }
    }
    *best_last_out = best_last;
    *best_score_out = best_score;
}

// Batched single-round chaining over group-contiguous candidate arrays
// (the default --max-exon-sets 1 regime): per group, stable-sort the
// candidates by (contigStart, contigEnd) with original-position
// tie-break, run the chain DP, and write the traceback as global
// indices into path_out[starts[g]..starts[g]+path_len[g]). One call +
// OpenMP replaces millions of per-group ctypes round trips (the
// reference OMPs the same loop, collectoptimalset.cpp:273).
void chain_dp_groups(int64_t n_groups, const int64_t* starts,
                     const int64_t* contig_start, const int64_t* contig_end,
                     const int64_t* t_start, const int64_t* t_end,
                     const int64_t* bit_score, const int64_t* aa_len,
                     const int64_t* target_len,
                     int64_t min_intron, int64_t max_intron,
                     int64_t max_overlap, int64_t gap_open,
                     int64_t gap_extend, double tcov_thr,
                     int64_t* best_score_out, int64_t* path_len_out,
                     int64_t* path_out) {
#ifdef _OPENMP
#pragma omp parallel
#endif
    {
        std::vector<int64_t> ord, cs, ce, ts, te, bit, aa;
        std::vector<int64_t> prev_id, path_score, num_exons, path_aa;
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 64)
#endif
        for (int64_t g = 0; g < n_groups; g++) {
            const int64_t lo = starts[g], hi = starts[g + 1];
            const int64_t n = hi - lo;
            best_score_out[g] = 0;
            path_len_out[g] = 0;
            if (n == 0) continue;
            ord.resize(n);
            for (int64_t i = 0; i < n; i++) ord[i] = lo + i;
            std::stable_sort(ord.begin(), ord.end(),
                             [&](int64_t a, int64_t b) {
                if (contig_start[a] != contig_start[b])
                    return contig_start[a] < contig_start[b];
                return contig_end[a] < contig_end[b];
            });
            cs.resize(n); ce.resize(n); ts.resize(n); te.resize(n);
            bit.resize(n); aa.resize(n);
            for (int64_t i = 0; i < n; i++) {
                cs[i] = contig_start[ord[i]]; ce[i] = contig_end[ord[i]];
                ts[i] = t_start[ord[i]]; te[i] = t_end[ord[i]];
                bit[i] = bit_score[ord[i]]; aa[i] = aa_len[ord[i]];
            }
            prev_id.resize(n); path_score.resize(n);
            num_exons.resize(n); path_aa.resize(n);
            int64_t best_last = 0, best = 0;
            chain_dp(n, cs.data(), ce.data(), ts.data(), te.data(),
                     bit.data(), aa.data(), target_len[g], min_intron,
                     max_intron, max_overlap, gap_open, gap_extend,
                     tcov_thr, prev_id.data(), path_score.data(),
                     num_exons.data(), path_aa.data(), &best_last, &best);
            best_score_out[g] = best;
            if (best == 0) continue;
            // traceback low-to-high (the caller's reversed path order)
            int64_t cnt = 0;
            int64_t curr = best_last;
            while (prev_id[curr] != curr) { cnt++; curr = prev_id[curr]; }
            cnt++;
            path_len_out[g] = cnt;
            int64_t w = lo + cnt;
            curr = best_last;
            while (true) {
                path_out[--w] = ord[curr];
                if (prev_id[curr] == curr) break;
                curr = prev_id[curr];
            }
        }
    }
}

}  // extern "C"

extern "C" {

// ---------------------------------------------------------------------------
// Tandem-repeat / low-complexity masking probabilities.
//
// Faithful port of tantan's no-gap forward/backward path
// (lib/mmseqs/lib/tantan/tantan.cpp, struct Tantan: firstGapProb=0 as used
// by Masker::maskSequence, commons/Masker.cpp:21-33): per position the
// posterior probability of being in a repeat state, with the original
// 16-step rescaling and the float roundings of calcRepeatProbs.
//
// lr: alphabet x alphabet likelihood-ratio matrix (row-major),
//     lr[x][y] = P(x,y)/(P(x)P(y)).
void tantan_repeat_probs(const uint8_t* seq, int64_t n, int64_t alphabet,
                         int64_t max_offset, const double* lr,
                         double repeat_prob, double repeat_end_prob,
                         double decay, float* probs_out) {
    if (n <= 0) return;
    const int SCALE_STEP = 16;
    double b2b = 1 - repeat_prob;
    double f2b = repeat_end_prob;
    double f2f0 = 1 - repeat_end_prob;
    // firstRepeatOffsetProb (tantan.cpp:26-31)
    auto first_offset_prob = [&](double mult) {
        if (mult == 1.0) return 1.0 / max_offset;
        return (1 - mult) / (1 - std::pow(mult, (double)max_offset));
    };
    double b2f_first = repeat_prob * first_offset_prob(decay);
    std::vector<double> b2f(max_offset);
    double p = b2f_first;
    for (int64_t i = 0; i < max_offset; i++) { b2f[i] = p; p *= decay; }

    std::vector<double> fg(max_offset, 0.0);
    std::vector<double> scale_factors(n / SCALE_STEP, 1.0);
    double background = 1.0;

    // forward
    for (int64_t pos = 0; pos < n; pos++) {
        const double* lr_row = lr + (int64_t)seq[pos] * alphabet;
        int64_t max_off = std::min<int64_t>(pos, max_offset);
        double b = background;
        double from_fg = 0;
        for (int64_t i = 0; i < max_off; i++) {
            double f = fg[i];
            from_fg += f;
            fg[i] = (b * b2f[i] + f * f2f0) * lr_row[seq[pos - i - 1]];
        }
        for (int64_t i = max_off; i < max_offset; i++) {
            from_fg += fg[i];
            fg[i] = 0.0;
        }
        background = b * b2b + from_fg * f2b;
        if (pos % SCALE_STEP == SCALE_STEP - 1) {
            double scale = 1 / background;
            scale_factors[pos / SCALE_STEP] = scale;
            background *= scale;
            for (auto& f : fg) f *= scale;
        }
        probs_out[pos] = (float)background;
    }
    double from_fg_total = 0;
    for (auto f : fg) from_fg_total += f;
    double z = background * b2b + from_fg_total * f2b;

    // backward
    background = b2b;
    std::fill(fg.begin(), fg.end(), f2b);
    for (int64_t pos = n - 1; pos >= 0; pos--) {
        double non_repeat = probs_out[pos] * background / z;
        probs_out[pos] = 1 - (float)non_repeat;
        if (pos % SCALE_STEP == SCALE_STEP - 1) {
            double scale = scale_factors[pos / SCALE_STEP];
            background *= scale;
            for (auto& f : fg) f *= scale;
        }
        const double* lr_row = lr + (int64_t)seq[pos] * alphabet;
        int64_t max_off = std::min<int64_t>(pos, max_offset);
        double to_bg = f2b * background;
        double to_fg = 0;
        for (int64_t i = 0; i < max_off; i++) {
            double f = fg[i] * lr_row[seq[pos - i - 1]];
            to_fg += b2f[i] * f;
            fg[i] = to_bg + f2f0 * f;
        }
        for (int64_t i = max_off; i < max_offset; i++) {
            // emission prob is 0 beyond the sequence start
            to_fg += 0.0;
            fg[i] = to_bg;
        }
        background = b2b * background + to_fg;
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Banded Smith-Waterman traceback (CIGAR recovery).
//
namespace {

// Core of SmithWaterman::banded_sw (StripedSmithWaterman.cpp:1348-1600):
// banded DP over the [start..end] window with direction matrix, band
// doubling until the known score is reached, then traceback. Match score
// at (i, j) = prof[i*alphabet + t[j]] — per-query-position rows cover
// both the SEQ_SEQ path (submat row + bias, :1476) and the PROFILE_SEQ
// path (PSSM row, :1474). Emits the expanded M/I/D op string directly
// (computerBacktrace, :548-581 applies cigar runs in order; we write the
// same expansion). Returns the op count, or -1 on failure.
int64_t banded_core(const int32_t* prof, const uint8_t* t,
                    int64_t q_len, int64_t t_len,
                    int64_t score, int64_t gap_open, int64_t gap_extend,
                    int64_t band_width, int64_t alphabet,
                    uint8_t* out_ops, int64_t out_cap) {
    std::vector<int32_t> h_b, e_b, h_c;
    std::vector<int8_t> direction;
    int64_t width = 0, width_d = 0;
    int32_t max = 0;
    do {
        width = band_width * 2 + 3;
        width_d = band_width * 2 + 1;
        h_b.assign(width + 1, 0);
        e_b.assign(width + 1, 0);
        h_c.assign(width + 1, 0);
        direction.assign(width_d * q_len * 3, 0);
        max = 0;
        for (int64_t jj = 1; jj < width - 1; jj++) h_b[jj] = 0;
        for (int64_t i = 0; i < q_len; i++) {
            int64_t beg = std::max<int64_t>(0, i - band_width);
            int64_t end = std::min<int64_t>(t_len - 1, i + band_width);
            int64_t edge = std::min<int64_t>(end + 1, width - 1);
            int32_t f = 0;
            h_b[0] = e_b[0] = h_b[edge] = e_b[edge] = h_c[0] = 0;
            int8_t* dline = direction.data() + width_d * i * 3;
            int64_t u = 0;
            for (int64_t j = beg; j <= end; j++) {
                auto set_u = [&](int64_t ii, int64_t jj2) {
                    int64_t x = ii - band_width; x = x > 0 ? x : 0;
                    return jj2 - x + 1;
                };
                auto set_d = [&](int64_t ii, int64_t jj2, int64_t p) {
                    int64_t x = ii - band_width; x = x > 0 ? x : 0;
                    return (jj2 - x) * 3 + p;
                };
                u = set_u(i, j);
                int64_t e = set_u(i - 1, j);
                int64_t b = set_u(i, j - 1);
                int64_t d = set_u(i - 1, j - 1);
                int64_t de = set_d(i, j, 0);
                int64_t df = set_d(i, j, 1);
                int64_t dh = set_d(i, j, 2);

                int32_t temp1 = (i == 0) ? -(int32_t)gap_open
                                         : h_b[e] - (int32_t)gap_open;
                int32_t temp2 = (i == 0) ? -(int32_t)gap_extend
                                         : e_b[e] - (int32_t)gap_extend;
                e_b[u] = temp1 > temp2 ? temp1 : temp2;
                dline[de] = temp1 > temp2 ? 3 : 2;

                temp1 = h_c[b] - (int32_t)gap_open;
                temp2 = f - (int32_t)gap_extend;
                f = temp1 > temp2 ? temp1 : temp2;
                dline[df] = temp1 > temp2 ? 5 : 4;

                int32_t f1 = f > 0 ? f : 0;
                int32_t e1 = e_b[u] > 0 ? e_b[u] : 0;
                temp1 = e1 > f1 ? e1 : f1;
                temp2 = h_b[d] + prof[i * alphabet + t[j]];
                h_c[u] = temp1 > temp2 ? temp1 : temp2;
                if (h_c[u] > max) max = h_c[u];
                if (temp1 <= temp2) dline[dh] = 1;
                else dline[dh] = e1 > f1 ? dline[de] : dline[df];
            }
            for (int64_t jj = 1; jj <= u; jj++) h_b[jj] = h_c[jj];
        }
        band_width *= 2;
    } while (max < score && band_width <= 2 * std::max(q_len, t_len));
    band_width /= 2;
    if (max < score) return -1;

    // traceback, emitting ops in reverse order then flipping
    std::vector<uint8_t> rev;
    rev.reserve(q_len + t_len);
    int64_t i = q_len - 1, j = t_len - 1;
    int64_t state = 2;
    const int8_t* dline = direction.data() + width_d * i * 3;
    while (i > 0 || j > 0) {
        int64_t x = i - band_width; x = x > 0 ? x : 0;
        int64_t idx = (j - x) * 3 + state;
        switch (dline[idx]) {
            case 1: i--; j--; state = 2; dline -= width_d * 3; rev.push_back('M'); break;
            case 2: i--; state = 0; dline -= width_d * 3; rev.push_back('I'); break;
            case 3: i--; state = 2; dline -= width_d * 3; rev.push_back('I'); break;
            case 4: j--; state = 1; rev.push_back('D'); break;
            case 5: j--; state = 2; rev.push_back('D'); break;
            default: return -1;
        }
    }
    rev.push_back('M');  // the final cell (banded_sw appends the 1,'M')
    int64_t n = (int64_t)rev.size();
    if (n > out_cap) return -1;
    for (int64_t k2 = 0; k2 < n; k2++) out_ops[k2] = rev[n - 1 - k2];
    return n;
}

}  // namespace

extern "C" {

// SEQ_SEQ entry: per-position rows = submat[q[i]][:] + bias[i]
int64_t banded_sw_traceback(const uint8_t* q, const int8_t* bias,
                            const uint8_t* t,
                            int64_t q_len, int64_t t_len,
                            int64_t score, int64_t gap_open, int64_t gap_extend,
                            int64_t band_width,
                            const int32_t* submat, int64_t alphabet,
                            uint8_t* out_ops, int64_t out_cap) {
    std::vector<int32_t> prof((size_t)q_len * alphabet);
    for (int64_t i = 0; i < q_len; i++) {
        const int32_t* row = submat + (int64_t)q[i] * alphabet;
        for (int64_t a = 0; a < alphabet; a++) {
            prof[i * alphabet + a] = row[a] + (int32_t)bias[i];
        }
    }
    return banded_core(prof.data(), t, q_len, t_len, score, gap_open,
                       gap_extend, band_width, alphabet, out_ops, out_cap);
}

// PROFILE_SEQ entry: prof = the query PSSM window rows (L x alphabet)
int64_t banded_sw_traceback_prof(const int32_t* prof, const uint8_t* t,
                                 int64_t q_len, int64_t t_len,
                                 int64_t score, int64_t gap_open,
                                 int64_t gap_extend, int64_t band_width,
                                 int64_t alphabet,
                                 uint8_t* out_ops, int64_t out_cap) {
    return banded_core(prof, t, q_len, t_len, score, gap_open, gap_extend,
                       band_width, alphabet, out_ops, out_cap);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Hardware reciprocal with one Newton-Raphson iteration, exactly as the
// reference's SIMD w_contrib computation (lib/mmseqs/src/alignment/
// PSSMCalculator.cpp:506-520: simdf32_rcp + rcp+rcp - res*rcp*rcp).  The
// rcpps lookup table is CPU-specific, so parity requires executing the real
// instruction rather than emulating it.
// ---------------------------------------------------------------------------
#include <immintrin.h>

extern "C" {

// SubstitutionMatrix::calcLocalAaBiasCorrection
// (SubstitutionMatrix.cpp:79-109): int window sum, float average, then
// deltaS_i += pBack[a] * (float)subMat[a] accumulated IN FLOAT per term
// (double product rounded back to float32 each step).
void comp_bias(const uint8_t *seq, int64_t n, const int32_t *scores,
               int64_t alpha, const double *pback, double scale,
               float *out) {
    const int w = 20;  // windowSize / 2
    for (int64_t i = 0; i < n; i++) {
        const int64_t lo = std::max((int64_t)0, i - w);
        const int64_t hi = std::min(n, i + w);
        const int32_t *row = scores + (int64_t)seq[i] * alpha;
        int64_t sum = 0;
        for (int64_t j = lo; j < hi; j++) sum += row[seq[j]];
        sum -= row[seq[i]];
        float delta = (float)sum;
        // "deltaS_i /= -1.0 * (float)windowLength": double division
        delta = (float)((double)delta / (-1.0 * (double)(float)(hi - lo)));
        for (int64_t a = 0; a < alpha; a++) {
            delta = (float)((double)delta + pback[a] * (double)(float)row[a]);
        }
        out[i] = (float)(scale * (double)delta);
    }
}

// Batched bias over concatenated sequences with the SW-profile int8
// rounding fused (round half away from zero, ssw_init,
// StripedSmithWaterman.cpp:1230-1236). One call + OpenMP replaces
// millions of per-fragment ctypes round trips.
void comp_bias_batch_i8(const uint8_t *data, const int64_t *offs,
                        int64_t nseq, const int32_t *scores, int64_t alpha,
                        const double *pback, double scale, int8_t *out) {
#pragma omp parallel for schedule(dynamic, 256)
    for (int64_t s = 0; s < nseq; s++) {
        const uint8_t *seq = data + offs[s];
        const int64_t n = offs[s + 1] - offs[s];
        float *tmp = new float[n > 0 ? n : 1];
        comp_bias(seq, n, scores, alpha, pback, scale, tmp);
        int8_t *o = out + offs[s];
        for (int64_t i = 0; i < n; i++)
            o[i] = (int8_t)(tmp[i] < 0.0f ? tmp[i] - 0.5f : tmp[i] + 0.5f);
        delete[] tmp;
    }
}

void rcp_nr(const float *x, float *out, int64_t n) {
    int64_t i = 0;
    for (; i + 4 <= n; i += 4) {
        __m128 res = _mm_loadu_ps(x + i);
        __m128 rcp = _mm_rcp_ps(res);
        __m128 mul = _mm_mul_ps(res, _mm_mul_ps(rcp, rcp));
        _mm_storeu_ps(out + i, _mm_sub_ps(_mm_add_ps(rcp, rcp), mul));
    }
    if (i < n) {
        float tmp_in[4] = {1.f, 1.f, 1.f, 1.f}, tmp_out[4];
        for (int64_t j = i; j < n; j++) tmp_in[j - i] = x[j];
        __m128 res = _mm_loadu_ps(tmp_in);
        __m128 rcp = _mm_rcp_ps(res);
        __m128 mul = _mm_mul_ps(res, _mm_mul_ps(rcp, rcp));
        _mm_storeu_ps(tmp_out, _mm_sub_ps(_mm_add_ps(rcp, rcp), mul));
        for (int64_t j = i; j < n; j++) out[j] = tmp_out[j - i];
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Smith-Waterman island scan for Gumbel-parameter estimation
// (search/gumbel.py).  The island method (Altschul et al. 2001) records
// the peak score of every maximal positive excursion ("island") of the
// affine-gap SW matrix over random sequence pairs: thousands of islands
// per pair give far tighter (lambda, K) estimates than one maximum per
// pair.  The reference reaches the same parameters through the vendored
// ALP library's importance-sampling simulation
// (lib/alp/sls_alignment_evaluer.cpp:989 initGapped) whose realization
// counts are wall-clock-sized — this scan is deterministic instead.
//
// Gap model: a gap of length L costs go + (L-1)*ge where the caller
// passes go = open + extend (ALP's d_open1 = open1_ + epen1_ model,
// matching the convention used for the max-score simulation).
//
// Island bookkeeping: H/E/F each carry the id of the island their
// positive path originated from (diagonal step out of a zero cell).
// On merges the max-scoring predecessor's id wins (diag > E > F on
// ties); the absorbed island keeps the peak it already recorded —
// the standard island-method convention.  Islands whose anchor lies
// outside [0, len-margin)^2 are discarded so right/bottom edge
// truncation cannot bias the tail.
// ---------------------------------------------------------------------------
#include <vector>
#include <cstdint>

extern "C" {

// qdata/tdata: (n_pairs, len) uint8 letter codes (< alph); submat:
// alph*alph int32.  Appends island peak scores >= c_min with in-bounds
// anchors to out (capacity cap); returns the total count (callers must
// check count <= cap).
int64_t sw_islands(const uint8_t *qdata, const uint8_t *tdata,
                   int64_t n_pairs, int64_t len,
                   const int32_t *submat, int64_t alph,
                   int64_t go, int64_t ge,
                   int64_t margin, int64_t c_min,
                   int32_t *out, int64_t cap) {
    const int32_t NEG = INT32_MIN / 4;
    const int64_t lim = len - margin;
    int64_t total = 0;
#ifdef _OPENMP
#pragma omp parallel
#endif
    {
        std::vector<int32_t> H(len + 1), E(len + 1);
        std::vector<uint32_t> oH(len + 1), oE(len + 1);
        std::vector<int32_t> peak;        // per-island running peak
        std::vector<uint8_t> anchOk;      // anchor inside the core area
        std::vector<int32_t> local;       // this thread's emitted scores
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 8)
#endif
        for (int64_t p = 0; p < n_pairs; p++) {
            const uint8_t *q = qdata + p * len;
            const uint8_t *t = tdata + p * len;
            peak.clear();
            anchOk.clear();
            for (int64_t j = 0; j <= len; j++) {
                H[j] = 0; E[j] = NEG; oH[j] = 0; oE[j] = 0;
            }
            for (int64_t i = 0; i < len; i++) {
                const int32_t *srow = submat + (int64_t)q[i] * alph;
                int32_t Hdiag = 0;        // H(i-1, j-1), j=0 border
                uint32_t oDiag = 0;
                int32_t F = NEG;
                uint32_t oF = 0;
                for (int64_t j = 0; j < len; j++) {
                    // E/F updated from the PREVIOUS row/column H first
                    const int32_t e_open = H[j + 1] - (int32_t)go;
                    const int32_t e_ext = E[j + 1] - (int32_t)ge;
                    int32_t e;
                    uint32_t oe;
                    if (e_open >= e_ext) { e = e_open; oe = oH[j + 1]; }
                    else { e = e_ext; oe = oE[j + 1]; }
                    const int32_t f_open = H[j] - (int32_t)go;
                    const int32_t f_ext = F - (int32_t)ge;
                    if (f_open >= f_ext) { F = f_open; oF = oH[j]; }
                    else { F = f_ext; }
                    const int32_t diag = Hdiag + srow[t[j]];
                    int32_t h = diag;
                    uint32_t oh = oDiag;
                    bool fresh = (Hdiag == 0);
                    if (e > h) { h = e; oh = oe; fresh = false; }
                    if (F > h) { h = F; oh = oF; fresh = false; }
                    Hdiag = H[j + 1];
                    oDiag = oH[j + 1];
                    if (h <= 0) {
                        h = 0;
                        oh = 0;
                    } else if (fresh) {
                        // new island anchored at (i, j)
                        peak.push_back(h);
                        anchOk.push_back(i < lim && j < lim);
                        oh = (uint32_t)peak.size();  // 0 = no island
                    } else if (oh != 0 && h > peak[oh - 1]) {
                        peak[oh - 1] = h;
                    }
                    H[j + 1] = h;
                    oH[j + 1] = oh;
                    E[j + 1] = e;
                    oE[j + 1] = oe;
                }
            }
            for (size_t k = 0; k < peak.size(); k++) {
                if (anchOk[k] && peak[k] >= (int32_t)c_min) {
                    local.push_back(peak[k]);
                }
            }
        }
#ifdef _OPENMP
#pragma omp critical
#endif
        {
            for (size_t k = 0; k < local.size(); k++) {
                if (total < cap) out[total] = local[k];
                total++;
            }
        }
    }
    return total;
}

}  // extern "C"
