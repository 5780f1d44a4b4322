// Helpers shared by the attention forward (attention.cu) and backward
// (attention_bwd.cu).
//
// Both take q, k, v (and dO, dq, dk, dv, out) as strided (B, N, H, D) views:
// `Ten` carries the data pointer and the batch, row and head strides in
// elements, the last dimension unit-stride and every row 16-byte aligned
// (checked by the Python wrapper). A block works on one (b*h) slice.
//
// bf16: the FlashAttention-2 structure on Hopper's warp-level tensor-core
// instruction, mma.sync.m16n8k16 (bf16 in, f32 accumulate). A warp owns 16
// rows; its scores stay in registers as mma accumulators, whose layout is
// the A-operand layout of the next product, so P (or dS) is converted to
// bf16 in registers and used directly. K/V tiles come through a two-stage
// shared-memory ring filled by 16-byte cp.async (the load of tile t+1 is in
// flight while tile t runs its products); rows are padded by 16 bytes, so
// the eight rows an ldmatrix phase reads fall in eight different bank
// groups (D/8 + 1 is odd for D % 16 == 0). Row statistics are reduced over
// the 4 threads that share a row (2 shuffles).
//
// float (the f32 parity path): 64-row tiles in shared memory, scalar FMAs.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace pvpu_attn {

using bf16 = __nv_bfloat16;

constexpr int TQ = 64;   // query rows per tile
constexpr int TK = 64;   // key rows per tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int STAGES = 2;                      // cp.async ring depth
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// A strided (B, N, H, D) tensor: element (b, n, h, d) at
// ptr + b*sb + n*sn + h*sh + d.
struct Ten {
  void* ptr;
  long long sb, sn, sh;
};

// the (N, D) slice of (b*h) = bh, rows sn apart
template <typename T>
__device__ __forceinline__ T* slice(const Ten& t, int bh, int heads) {
  return reinterpret_cast<T*>(t.ptr) + (long long)(bh / heads) * t.sb +
         (long long)(bh % heads) * t.sh;
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

// ---------------------------------------------------------------------------
// float path: shared-memory tiles and scalar FMAs
// ---------------------------------------------------------------------------

// S[TQ][TK] = Qs[TQ][D] . Ks[TK][D]^T; the warp owns rows warp*16..+15
__device__ inline void qk_tile_f32(const float* Qs, const float* Ks, float* S,
                                   int D) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp * 16; r < warp * 16 + 16; ++r)
    for (int c = lane; c < TK; c += 32) {
      float s = 0.0f;
      for (int k = 0; k < D; ++k) s = fmaf(Qs[r * D + k], Ks[c * D + k], s);
      S[r * TK + c] = s;
    }
}

// O[TQ][D] += Ps[TQ][TK] . Vs[TK][D]
__device__ inline void pv_tile_f32(const float* Ps, const float* Vs, float* O,
                                   int D) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp * 16; r < warp * 16 + 16; ++r)
    for (int c = lane; c < D; c += 32) {
      float s = O[r * D + c];
      for (int j = 0; j < TK; ++j) s = fmaf(Ps[r * TK + j], Vs[j * D + c], s);
      O[r * D + c] = s;
    }
}

// rows [row0, row0 + 64) of one (N, D) slice, rows sn apart, into a dense
// shared tile, zero-padded past n
__device__ inline void load_tile_f32(float* dst, const float* src,
                                     long long sn, int row0, int n, int D) {
  const int per_row = D / 4;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < TQ * per_row; i += THREADS) {
    const int r = i / per_row, c = (i % per_row) * 4;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < n)
      v = *reinterpret_cast<const uint4*>(src + (row0 + r) * sn + c);
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

// ---------------------------------------------------------------------------
// bf16 path: cp.async, ldmatrix and mma.sync.m16n8k16
// ---------------------------------------------------------------------------

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// rows [row0, row0 + 64) of a bf16 (N, D) slice into a padded shared tile
// (row stride D + 8), zero-filled past n
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long sn, int row0, int n) {
  constexpr int CH = D / 8;  // 16-byte chunks per row; TQ * CH % THREADS == 0
#pragma unroll
  for (int it = 0; it < TQ * CH / THREADS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = row0 + r < n;
    cp_async16(dst + r * (D + 8) + c, src + (ok ? (row0 + r) * sn : 0) + c, ok);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

// c (16 x 8, f32) += a (16 x 16, row) . b (16 x 8, col)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// reductions over the 4 threads of a quad (the threads that share a row of
// an mma accumulator)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffff, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffff, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffff, v, 1);
  return v + __shfl_xor_sync(0xffffffff, v, 2);
}

// A fragments of 16 rows x D of a padded shared tile (row stride D + 8)
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[D / 16][4], const bf16* As,
                                       int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldsm_x4(a[kk], As + (lane & 15) * (D + 8) + kk * 16 + ((lane >> 4) << 3));
}

// acc (16 x 64) = A (16 x D, fragments) . Bs^T, Bs 64 rows x D of a padded
// shared tile: the warp's rows of Q.K^T (or dO.V^T, K.Q^T, V.dO^T)
template <int D>
__device__ __forceinline__ void mma_abt(float (&acc)[8][4],
                                        const uint32_t (&a)[D / 16][4],
                                        const bf16* Bs, int lane) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldsm_x4(b, Bs + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * (D + 8) +
                     kk * 16 + (((lane >> 3) & 1) << 3));
      mma16816(acc[2 * np], a[kk], b[0], b[1]);
      mma16816(acc[2 * np + 1], a[kk], b[2], b[3]);
    }
}

// the accumulator layout of a 16 x 64 product, rounded to bf16, as the A
// fragments of a 16 x 64 (k = 64) operand
__device__ __forceinline__ void to_a(uint32_t (&pa)[4][4],
                                     const float (&p)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    pa[kk][0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    pa[kk][1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    pa[kk][2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    pa[kk][3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
  }
}

// acc (16 x D) += P (16 x 64, A fragments) . Bs, Bs 64 rows x D of a padded
// shared tile read transposed (P.V, dS.K, P^T.dO, dS^T.Q)
template <int D>
__device__ __forceinline__ void mma_ab(float (&acc)[D / 8][4],
                                       const uint32_t (&pa)[4][4],
                                       const bf16* Bs, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_t(b, Bs + (kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) *
                            (D + 8) + dp * 16 + ((lane >> 4) << 3));
      mma16816(acc[2 * dp], pa[kk], b[0], b[1]);
      mma16816(acc[2 * dp + 1], pa[kk], b[2], b[3]);
    }
}

// store the warp's 16 x D accumulator rows (row0 + g, row0 + g + 8) times
// `mul` to a bf16 slice, rows < n only
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, long long sn,
                                           const float (&acc)[D / 8][4],
                                           int row0, int n, int lane,
                                           float mul0, float mul1) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= n) continue;
    const float mul = r ? mul1 : mul0;
    bf16* out = dst + row * sn + 2 * tq;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<uint32_t*>(out + i * 8) =
          pack_bf16(acc[i][2 * r] * mul, acc[i][2 * r + 1] * mul);
  }
}

}  // namespace pvpu_attn

// The head dims the bf16 kernels are instantiated for; F is a macro taking
// the head dim as a constant.
#define PVPU_SWITCH_D(d, F)                                  \
  switch (d) {                                               \
    case 16: F(16); case 32: F(32); case 48: F(48);          \
    case 64: F(64); case 80: F(80); case 96: F(96);          \
    case 112: F(112); case 128: F(128);                      \
    default: return (int)cudaErrorInvalidValue;              \
  }
