// Tile helpers shared by the attention forward (attention.cu) and backward
// (attention_bwd.cu): 64-row tiles of one (N, D) slice in shared memory, 4
// warps per block, each warp owning 16 rows of the product it computes.
// bf16 products run on the tensor cores (wmma, bf16 in, f32 accumulate); the
// float instantiations (the parity path) use scalar FMAs.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace pvpu_attn {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int TQ = 64;   // query rows per tile
constexpr int TK = 64;   // key rows per tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

// S[TQ][TK] (f32) = Qs[TQ][D] . Ks[TK][D]^T
template <typename T>
__device__ void qk_tile(const T* Qs, const T* Ks, float* S, int D);

template <>
__device__ inline void qk_tile<bf16>(const bf16* Qs, const bf16* Ks, float* S,
                                     int D) {
  const int warp = threadIdx.x / 32;  // warp owns query rows warp*16..+15
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  for (int n = 0; n < TK / 16; ++n) {
    wmma::fill_fragment(acc, 0.0f);
    for (int k = 0; k < D; k += 16) {
      wmma::load_matrix_sync(a, Qs + warp * 16 * D + k, D);
      wmma::load_matrix_sync(b, Ks + n * 16 * D + k, D);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(S + warp * 16 * TK + n * 16, acc, TK,
                            wmma::mem_row_major);
  }
}

template <>
__device__ inline void qk_tile<float>(const float* Qs, const float* Ks,
                                      float* S, int D) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp * 16; r < warp * 16 + 16; ++r)
    for (int c = lane; c < TK; c += 32) {
      float s = 0.0f;
      for (int k = 0; k < D; ++k) s = fmaf(Qs[r * D + k], Ks[c * D + k], s);
      S[r * TK + c] = s;
    }
}

// O[TQ][D] (f32) += Ps[TQ][TK] . Vs[TK][D]
template <typename T>
__device__ void pv_tile(const T* Ps, const T* Vs, float* O, int D);

template <>
__device__ inline void pv_tile<bf16>(const bf16* Ps, const bf16* Vs, float* O,
                                     int D) {
  const int warp = threadIdx.x / 32;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  for (int n = 0; n < D; n += 16) {
    float* o = O + warp * 16 * D + n;
    wmma::load_matrix_sync(acc, o, D, wmma::mem_row_major);
    for (int k = 0; k < TK; k += 16) {
      wmma::load_matrix_sync(a, Ps + warp * 16 * TK + k, TK);
      wmma::load_matrix_sync(b, Vs + k * D + n, D);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(o, acc, D, wmma::mem_row_major);
  }
}

template <>
__device__ inline void pv_tile<float>(const float* Ps, const float* Vs,
                                      float* O, int D) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp * 16; r < warp * 16 + 16; ++r)
    for (int c = lane; c < D; c += 32) {
      float s = O[r * D + c];
      for (int j = 0; j < TK; ++j) s = fmaf(Ps[r * TK + j], Vs[j * D + c], s);
      O[r * D + c] = s;
    }
}

// rows [row0, row0 + 64) of one (N, D) slice into shared memory, zero-padded
template <typename T>
__device__ void load_tile(T* dst, const T* src, int row0, int n, int D) {
  const int vec = 16 / sizeof(T);  // elements per 16-byte load
  const int per_row = D / vec;
  for (int i = threadIdx.x; i < TQ * per_row; i += THREADS) {
    const int r = i / per_row, c = (i % per_row) * vec;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < n)
      v = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * D + c) = v;
  }
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffff, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffff, v, o);
  return v;
}

}  // namespace pvpu_attn
