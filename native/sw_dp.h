// Smith-Waterman end positions for one (query, target) pair, computed by
// one thread: the DP core of the CUDA kernel (sw_cuda.cu), compiled for
// the host as well (sw_host.cpp) so its exact arithmetic is tested
// against the numpy oracle (metaeuk_tpu/ops/sw.py) on machines without a
// GPU.
//
// Contract (identical to ops/sw_jax.py and the oracle):
//   s(i, j) = prof[t_j][i]   per-query score profile, BLOSUM62 row plus
//                            composition bias, or a PSSM
//   affine gaps: open GO, extend GE; H floored at 0, saturated at CAP
//   end = the first target column that strictly improves the maximum,
//         then the smallest query row in that column
//         (StripedSmithWaterman.cpp:879-916)
//
// The query is walked in stripes of R rows whose H and E live in
// registers; the vertical gap F is chained through the stripe one row at
// a time (exact, no running max needed). Between stripes, the last row's
// H and the F entering the next stripe are kept per target column in a
// boundary array (global memory, mostly L2-resident on the GPU).
//
// REV walks the reversed prefixes q[rlast::-1], t[clast::-1] -- the
// reference's start-position pass (ssw_align_private:398-482). Results
// are in walk coordinates; the caller maps them back.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define SW_HD __host__ __device__ __forceinline__
typedef int2 SwBnd;
#else
#define SW_HD static inline
struct SwBnd {
  int x, y;
};
#endif

namespace swdp {

constexpr int R = 16;       // query rows per register stripe
constexpr int GO = 11;      // gap open
constexpr int GE = 1;       // gap extend
constexpr int CAP = 32767;  // sw_sse2_word saturation
constexpr int NEGF = -(1 << 28);
constexpr int SENT = -(1 << 20);  // score of rows past the query's end

// max(a + b, c, 0)
SW_HD int addmax_relu(int a, int b, int c) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  return __viaddmax_s32_relu(a, b, c);
#else
  int x = a + b;
  x = x > c ? x : c;
  return x > 0 ? x : 0;
#endif
}

// max(a + b, c)
SW_HD int addmax(int a, int b, int c) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  return __viaddmax_s32(a, b, c);
#else
  int x = a + b;
  return x > c ? x : c;
#endif
}

SW_HD int max3(int a, int b, int c) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  return __vimax3_s32(a, b, c);
#else
  int x = a > b ? a : b;
  return x > c ? x : c;
#endif
}

SW_HD int imax(int a, int b) { return a > b ? a : b; }
SW_HD int imin(int a, int b) { return a < b ? a : b; }

// Load the R scores of rows r0..r0+R-1 (walk coordinates) for residue
// column `pc` (one row of the profile, LP int16 entries).
template <bool REV>
SW_HD void load_scores(const int16_t* pc, int r0, int nrows, int rlast,
                       int* s) {
  if (!REV && r0 + R <= nrows) {
#if defined(__CUDA_ARCH__)
    union {
      uint4 u[2];
      int16_t h[R];
    } v;
    const uint4* p4 = reinterpret_cast<const uint4*>(pc + r0);
    v.u[0] = __ldg(p4);
    v.u[1] = __ldg(p4 + 1);
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = v.h[r];
#else
    for (int r = 0; r < R; ++r) s[r] = pc[r0 + r];
#endif
    return;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    int w = r0 + r;
    int i = REV ? rlast - w : w;
    s[r] = w < nrows ? (int)pc[i] : SENT;
  }
}

struct Ends {
  int score, row, col;  // row/col -1 when nothing aligns
};

// prof: this query's (A, LP) profile; t: the target's residue codes;
// nrows/ncols: the walked lengths; rlast/clast: the prefix ends (REV);
// bnd: this pair's boundary slot of column 0, columns `bstride` apart.
template <bool REV>
SW_HD Ends sw_pair(const int16_t* prof, int LP, const uint8_t* t, int nrows,
                   int ncols, int rlast, int clast, SwBnd* bnd, long bstride) {
  int gbest = 0, grow = -1, gcol = -1;
  for (int r0 = 0; r0 < nrows; r0 += R) {
    const bool first = r0 == 0;
    const bool last = r0 + R >= nrows;
    int H[R], E[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      H[r] = 0;
      E[r] = -GO;
    }
    int hb_prev = 0;  // H(r0 - 1, c - 1): the first row's diagonal
    int sbest = 0, srow = -1, scol = -1;
    for (int c = 0; c < ncols; ++c) {
      const int tc = REV ? t[clast - c] : t[c];
      int s[R];
      load_scores<REV>(prof + (long)tc * LP, r0, nrows, rlast, s);
      int hb = 0, F = NEGF;
      if (!first) {
        SwBnd v = bnd[c * bstride];
        hb = v.x;
        F = v.y;
      }
      int diag = hb_prev;
      hb_prev = hb;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int G = addmax_relu(diag, s[r], E[r]);
        diag = H[r];
        const int h = imin(imax(G, F), CAP);
        F = addmax(F, -GE, G - GO);
        E[r] = addmax(E[r], -GE, h - GO);
        H[r] = h;
      }
      if (!last) {
        SwBnd v;
        v.x = H[R - 1];
        v.y = F;
        bnd[c * bstride] = v;
      }
      int cmax = H[0];
#pragma unroll
      for (int r = 1; r + 1 < R; r += 2) cmax = max3(cmax, H[r], H[r + 1]);
      if (R % 2 == 0) cmax = imax(cmax, H[R - 1]);
      if (cmax > sbest) {
        sbest = cmax;
        scol = c;
        int row = R - 1;
#pragma unroll
        for (int r = R - 1; r >= 0; --r)
          if (H[r] == cmax) row = r;
        srow = r0 + row;
      }
    }
    // earlier stripes hold smaller rows: on equal score and column the
    // one already kept wins
    if (sbest > gbest || (sbest > 0 && sbest == gbest && scol < gcol)) {
      gbest = sbest;
      grow = srow;
      gcol = scol;
    }
  }
  Ends e;
  e.score = gbest;
  e.row = gbest > 0 ? grow : -1;
  e.col = gbest > 0 ? gcol : -1;
  return e;
}

}  // namespace swdp
