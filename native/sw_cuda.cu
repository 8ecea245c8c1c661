// Smith-Waterman end positions on an NVIDIA GPU (sm_90a), called from JAX
// through the foreign function interface (metaeuk_tpu/ops/sw_cuda.py).
//
// One thread aligns one pair (sw_dp.h): the query's score profile is read
// 16 rows at a time with two 16-byte loads, the stripe's H and E stay in
// registers, and Hopper's DPX instructions fuse the add/max chains.
// Pairs that share a query sit next to each other in the batch (the
// prefilter emits candidates query by query), so a warp mostly reads one
// profile and it stays in L1.
//
// Build: python -m metaeuk_tpu.ops.sw_cuda
#include <cuda_runtime.h>
#include <stdint.h>

#include "sw_dp.h"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kThreads = 64;

template <bool REV>
__global__ void __launch_bounds__(kThreads)
    sw_ends_kernel(const int16_t* __restrict__ prof, int A, int LP,
                   const int32_t* __restrict__ pidx,
                   const uint8_t* __restrict__ tcodes, int LT,
                   const int32_t* __restrict__ tidx,
                   const int32_t* __restrict__ nrows,
                   const int32_t* __restrict__ ncols,
                   const int32_t* __restrict__ rlast,
                   const int32_t* __restrict__ clast, int B,
                   SwBnd* __restrict__ bnd, int32_t* __restrict__ score,
                   int32_t* __restrict__ row, int32_t* __restrict__ col) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  swdp::Ends e{0, -1, -1};
  const int p = pidx[b], nr = nrows[b], nc = ncols[b];
  if (p >= 0 && nr > 0 && nc > 0) {
    e = swdp::sw_pair<REV>(prof + (long)p * A * LP, LP,
                           tcodes + (long)tidx[b] * LT, nr, nc, rlast[b],
                           clast[b], bnd + b, B);
  }
  score[b] = e.score;
  row[b] = e.row;
  col[b] = e.col;
}

ffi::Error SwEndsImpl(cudaStream_t stream, ffi::Buffer<ffi::S16> prof,
                      ffi::Buffer<ffi::S32> pidx, ffi::Buffer<ffi::U8> tcodes,
                      ffi::Buffer<ffi::S32> tidx, ffi::Buffer<ffi::S32> nrows,
                      ffi::Buffer<ffi::S32> ncols, ffi::Buffer<ffi::S32> rlast,
                      ffi::Buffer<ffi::S32> clast, int32_t reverse,
                      ffi::ResultBuffer<ffi::S32> score,
                      ffi::ResultBuffer<ffi::S32> row,
                      ffi::ResultBuffer<ffi::S32> col,
                      ffi::ResultBuffer<ffi::S32> scratch) {
  auto pd = prof.dimensions();
  auto td = tcodes.dimensions();
  if (pd.size() != 3 || td.size() != 2)
    return ffi::Error::InvalidArgument("prof must be 3-D, tcodes 2-D");
  const int A = static_cast<int>(pd[1]);
  const int LP = static_cast<int>(pd[2]);
  const int LT = static_cast<int>(td[1]);
  const int B = static_cast<int>(pidx.element_count());
  if (LP % swdp::R != 0)
    return ffi::Error::InvalidArgument("profile length must be a multiple of 16");
  if (scratch->element_count() < 2 * static_cast<size_t>(LT) * B)
    return ffi::Error::InvalidArgument("scratch must hold (LT, B, 2) int32");
  if (B == 0) return ffi::Error::Success();
  const int grid = (B + kThreads - 1) / kThreads;
  SwBnd* bnd = reinterpret_cast<SwBnd*>(scratch->typed_data());
  if (reverse) {
    sw_ends_kernel<true><<<grid, kThreads, 0, stream>>>(
        prof.typed_data(), A, LP, pidx.typed_data(), tcodes.typed_data(), LT,
        tidx.typed_data(), nrows.typed_data(), ncols.typed_data(),
        rlast.typed_data(), clast.typed_data(), B, bnd, score->typed_data(),
        row->typed_data(), col->typed_data());
  } else {
    sw_ends_kernel<false><<<grid, kThreads, 0, stream>>>(
        prof.typed_data(), A, LP, pidx.typed_data(), tcodes.typed_data(), LT,
        tidx.typed_data(), nrows.typed_data(), ncols.typed_data(),
        rlast.typed_data(), clast.typed_data(), B, bnd, score->typed_data(),
        row->typed_data(), col->typed_data());
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(SwEnds, SwEndsImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S16>>()  // prof
                                  .Arg<ffi::Buffer<ffi::S32>>()  // pidx
                                  .Arg<ffi::Buffer<ffi::U8>>()   // tcodes
                                  .Arg<ffi::Buffer<ffi::S32>>()  // tidx
                                  .Arg<ffi::Buffer<ffi::S32>>()  // nrows
                                  .Arg<ffi::Buffer<ffi::S32>>()  // ncols
                                  .Arg<ffi::Buffer<ffi::S32>>()  // rlast
                                  .Arg<ffi::Buffer<ffi::S32>>()  // clast
                                  .Attr<int32_t>("reverse")
                                  .Ret<ffi::Buffer<ffi::S32>>()  // score
                                  .Ret<ffi::Buffer<ffi::S32>>()  // row
                                  .Ret<ffi::Buffer<ffi::S32>>()  // col
                                  .Ret<ffi::Buffer<ffi::S32>>()  // scratch
);
