// Attention forward for the ViT blocks: two entry points, one source.
//
// Replaces pvpuformer_tpu/ops/fused_attention.py:_fwd_kernel (fused entry,
// `fused_attention`) and pvpuformer_tpu/ops/attention.py:_flash_kernel
// (flash entry, `flash_attention`).
//
// Bound on the H100: at ViT-B@448 flip batch 2 the window blocks are
// (BH, N, D) = (96, 196, 64) and the global blocks (24, 784, 64): 4*BH*N^2*D
// = 0.94 / 3.8 GFLOP against 3*BH*N*D*2 = 7 MB of q/k/v, so the work is
// compute bound and the (N, N) scores (784^2 f32 = 2.4 MB per head) must
// never reach device memory. The TPU kernel keeps a whole score matrix in
// VMEM; 227 KB of shared memory cannot. Design: one block per (b*h, 64-query
// tile) with 4 warps; K/V tiles of 64 rows are staged through shared memory;
// QK^T and PV run on the tensor cores (wmma, bf16 in, f32 accumulate) and
// the output accumulator stays in shared memory in f32.
//   fused: two passes over K (row max and sum, then P normalized BEFORE it is
//          cast to the input dtype, then PV), as _fwd_kernel.
//   flash: one pass with online softmax; P is cast UN-normalized and the
//          output divided by the row sum at the end, with the l == 0 guard,
//          as _flash_kernel.
// Keys past seq_len are masked (-inf in the fused entry, MASK_VALUE in the
// flash entry); query rows past seq_len are computed on zeros and not stored.
// The float instantiation (parity) does both products with scalar FMAs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cfloat>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int TQ = 64;   // query rows per block
constexpr int TK = 64;   // key rows per tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr float MASK_VALUE = -0.7f * FLT_MAX;

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

// S[TQ][TK] (f32) = Qs[TQ][D] . Ks[TK][D]^T
template <typename T>
__device__ void qk_tile(const T* Qs, const T* Ks, float* S, int D);

template <>
__device__ void qk_tile<bf16>(const bf16* Qs, const bf16* Ks, float* S, int D) {
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
__device__ void qk_tile<float>(const float* Qs, const float* Ks, float* S,
                               int D) {
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
__device__ void pv_tile<bf16>(const bf16* Ps, const bf16* Vs, float* O, int D) {
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
__device__ void pv_tile<float>(const float* Ps, const float* Vs, float* O,
                               int D) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp * 16; r < warp * 16 + 16; ++r)
    for (int c = lane; c < D; c += 32) {
      float s = O[r * D + c];
      for (int j = 0; j < TK; ++j) s = fmaf(Ps[r * TK + j], Vs[j * D + c], s);
      O[r * D + c] = s;
    }
}

// rows [row0, row0 + TQ) of one (N, D) slice into shared memory, zero-padded
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

template <typename T, bool FLASH>
__global__ void __launch_bounds__(THREADS)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int n,
                     int D, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + TQ * D;
  T* Vs = Ks + TK * D;
  float* S = reinterpret_cast<float*>(Vs + TK * D);
  T* Ps = reinterpret_cast<T*>(S + TQ * TK);
  float* O = reinterpret_cast<float*>(Ps + TQ * TK);
  float* m_row = O + TQ * D;
  float* l_row = m_row + TQ;

  const size_t base = (size_t)blockIdx.y * n * D;
  const int q0 = blockIdx.x * TQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_tiles = (n + TK - 1) / TK;

  load_tile(Qs, q + base, q0, n, D);
  for (int i = threadIdx.x; i < TQ * D; i += THREADS) O[i] = 0.0f;
  if (threadIdx.x < TQ) {
    m_row[threadIdx.x] = -INFINITY;
    l_row[threadIdx.x] = 0.0f;
  }
  __syncthreads();

  if (!FLASH) {
    // pass 1: exact row max and row sum of exp(s - max)
    for (int t = 0; t < n_tiles; ++t) {
      load_tile(Ks, k + base, t * TK, n, D);
      __syncthreads();
      qk_tile<T>(Qs, Ks, S, D);
      __syncthreads();
      for (int r = warp * 16; r < warp * 16 + 16; ++r) {
        float s[2];
        for (int j = 0; j < 2; ++j) {
          const int c = lane + 32 * j;
          s[j] = (t * TK + c < n) ? S[r * TK + c] * scale : -INFINITY;
        }
        const float m_new = fmaxf(m_row[r], warp_max(fmaxf(s[0], s[1])));
        const float e = warp_sum(expf(s[0] - m_new) + expf(s[1] - m_new));
        __syncwarp();
        if (lane == 0) {
          l_row[r] = l_row[r] * expf(m_row[r] - m_new) + e;
          m_row[r] = m_new;
        }
        __syncwarp();
      }
      __syncthreads();
    }
  }

  // main pass: P tile -> O += P . V
  for (int t = 0; t < n_tiles; ++t) {
    load_tile(Ks, k + base, t * TK, n, D);
    load_tile(Vs, v + base, t * TK, n, D);
    __syncthreads();
    qk_tile<T>(Qs, Ks, S, D);
    __syncthreads();
    for (int r = warp * 16; r < warp * 16 + 16; ++r) {
      float s[2];
      for (int j = 0; j < 2; ++j) {
        const int c = lane + 32 * j;
        const bool ok = t * TK + c < n;
        s[j] = S[r * TK + c] * scale;
        if (!ok) s[j] = FLASH ? MASK_VALUE : -INFINITY;
      }
      if (FLASH) {
        const float m_prev = m_row[r];
        const float m_next = fmaxf(m_prev, warp_max(fmaxf(s[0], s[1])));
        const float alpha = expf(m_prev - m_next);
        const float p0 = expf(s[0] - m_next), p1 = expf(s[1] - m_next);
        const float psum = warp_sum(p0 + p1);
        Ps[r * TK + lane] = from_f<T>(p0);
        Ps[r * TK + lane + 32] = from_f<T>(p1);
        for (int c = lane; c < D; c += 32) O[r * D + c] *= alpha;
        __syncwarp();
        if (lane == 0) {
          l_row[r] = alpha * l_row[r] + psum;
          m_row[r] = m_next;
        }
        __syncwarp();
      } else {
        const float m = m_row[r], l = l_row[r];
        Ps[r * TK + lane] = from_f<T>(expf(s[0] - m) / l);
        Ps[r * TK + lane + 32] = from_f<T>(expf(s[1] - m) / l);
      }
    }
    __syncthreads();
    pv_tile<T>(Ps, Vs, O, D);
    __syncthreads();
  }

  for (int i = threadIdx.x; i < TQ * D; i += THREADS) {
    const int r = i / D;
    if (q0 + r >= n) continue;
    float o = O[i];
    if (FLASH) {
      const float l = l_row[r];
      o *= (l == 0.0f) ? 1.0f : 1.0f / l;
    }
    out[base + (size_t)q0 * D + i] = from_f<T>(o);
  }
}

template <typename T>
size_t smem_bytes(int D) {
  return sizeof(T) * (TQ * D + 2 * TK * D + TQ * TK) +
         sizeof(float) * (TQ * TK + TQ * D + 2 * TQ);
}

template <typename T, bool FLASH>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int n, int D, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(D);
  cudaFuncSetAttribute(attention_fwd_kernel<T, FLASH>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid((n + TQ - 1) / TQ, bh);
  attention_fwd_kernel<T, FLASH><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, n, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; flash: 0 = fused entry, 1 = flash entry.
// q, k, v, out: contiguous (bh, n, D); D % 16 == 0 and D <= 128 (checked by
// the Python wrapper).
extern "C" int pvpu_attention_fwd(const void* q, const void* k, const void* v,
                                  void* out, int bh, int n, int D, float scale,
                                  int dtype, int flash, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return flash ? launch<bf16, true>(q, k, v, out, bh, n, D, scale, s)
                 : launch<bf16, false>(q, k, v, out, bh, n, D, scale, s);
  return flash ? launch<float, true>(q, k, v, out, bh, n, D, scale, s)
               : launch<float, false>(q, k, v, out, bh, n, D, scale, s);
}
