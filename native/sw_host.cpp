// Host build of the CUDA alignment kernel's DP core (sw_dp.h): the same
// per-pair code, looped over pairs, so tests check the kernel's
// arithmetic against the numpy oracle without a GPU.
#include <stdint.h>

#include <vector>

#include "sw_dp.h"

extern "C" void sw_ends_host(const int16_t* prof, int64_t A, int64_t LP,
                             const int32_t* pidx, const uint8_t* tcodes,
                             int64_t LT, const int32_t* tidx,
                             const int32_t* nrows, const int32_t* ncols,
                             const int32_t* rlast, const int32_t* clast,
                             int64_t B, int64_t reverse, int32_t* score,
                             int32_t* row, int32_t* col) {
  std::vector<SwBnd> bnd(LT > 0 ? LT : 1);
  for (int64_t b = 0; b < B; ++b) {
    swdp::Ends e{0, -1, -1};
    if (pidx[b] >= 0 && nrows[b] > 0 && ncols[b] > 0) {
      const int16_t* p = prof + pidx[b] * A * LP;
      const uint8_t* t = tcodes + (int64_t)tidx[b] * LT;
      e = reverse ? swdp::sw_pair<true>(p, (int)LP, t, nrows[b], ncols[b],
                                        rlast[b], clast[b], bnd.data(), 1)
                  : swdp::sw_pair<false>(p, (int)LP, t, nrows[b], ncols[b],
                                         rlast[b], clast[b], bnd.data(), 1);
    }
    score[b] = e.score;
    row[b] = e.row;
    col[b] = e.col;
  }
}
