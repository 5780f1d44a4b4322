// Fused LayerNorm + MLP + residual for the ViT blocks (bf16):
//   out = x + fc2(gelu_tanh(fc1(LN(x))))
//
// Replaces pvpuformer_tpu/ops/fused_mlp.py:_kernel (`fused_ln_mlp`).
// Bound on the H100: at ViT-B@448 flip batch 2, x is (1568, 768) and the
// weights (768, 3072) + (3072, 768): 2 x 7.4 GFLOP of bf16 products against
// 9.4 MB of weights, so compute bound. The TPU kernel keeps both weight
// matrices resident in VMEM; they do not fit in 227 KB of shared memory.
// Design: two launches from this source, both 64x128 output tiles on 8 warps
// with the products on the tensor cores (wmma, bf16 in, f32 accumulate) and
// 32-deep K chunks of the weights staged through shared memory:
//   (a) pvpu_ln_fc1_gelu: the block's 64 rows are layer-normed with f32
//       statistics into shared memory as bf16 (64 x D), then
//       h = gelu_tanh(y.W1 + b1) in f32, written as bf16 (1568 x 3072 = 9.6 MB,
//       which stays in the 50 MB L2 for launch (b));
//   (b) pvpu_fc2_residual: out = h.W2 + b2 + x in f32, cast to bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int TM = 64;    // rows per block
constexpr int TN = 128;   // output columns per block
constexpr int TKC = 32;   // K chunk
constexpr int THREADS = 256;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffff, v, o);
  return v;
}

// Bs[TKC][TN] <- w[k0:k0+TKC, n0:n0+TN] of a row-major (K, ldw) matrix
__device__ void load_b_chunk(bf16* Bs, const bf16* w, int k0, int n0, int ldw) {
  constexpr int per_row = TN / 8;
  for (int i = threadIdx.x; i < TKC * per_row; i += THREADS) {
    const int r = i / per_row, c = (i % per_row) * 8;
    *reinterpret_cast<uint4*>(Bs + r * TN + c) =
        *reinterpret_cast<const uint4*>(w + (size_t)(k0 + r) * ldw + n0 + c);
  }
}

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// acc[4] (warp's 16 x 64 slice) += A[16 rows][TKC] . Bs[TKC][64 cols]
__device__ void mma_chunk(FragC* acc, const bf16* A, int lda, const bf16* Bs) {
  const int warp = threadIdx.x / 32;
  const int wm = warp % 4, wn = warp / 4;
  FragA a;
  FragB b;
  for (int kk = 0; kk < TKC; kk += 16) {
    wmma::load_matrix_sync(a, A + wm * 16 * lda + kk, lda);
    for (int j = 0; j < 4; ++j) {
      wmma::load_matrix_sync(b, Bs + kk * TN + wn * 64 + j * 16, TN);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
}

__device__ void store_acc(float* C, FragC* acc) {
  const int warp = threadIdx.x / 32;
  const int wm = warp % 4, wn = warp / 4;
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(C + wm * 16 * TN + wn * 64 + j * 16, acc[j], TN,
                            wmma::mem_row_major);
}

__global__ void __launch_bounds__(THREADS)
ln_fc1_gelu_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ beta, const bf16* __restrict__ w1,
                   const float* __restrict__ b1, bf16* __restrict__ h, int M,
                   int D, int Hd, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Y = reinterpret_cast<bf16*>(smem);             // TM x D
  bf16* Bs = Y + TM * D;                                // TKC x TN
  float* C = reinterpret_cast<float*>(Bs + TKC * TN);  // TM x TN
  const int m0 = blockIdx.x * TM, n0 = blockIdx.y * TN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // LayerNorm with f32 statistics: warp w normalizes rows w*8 .. w*8+7
  for (int r = warp * 8; r < warp * 8 + 8; ++r) {
    const int gr = m0 + r;
    if (gr >= M) {
      for (int c = lane; c < D; c += 32) Y[r * D + c] = __float2bfloat16(0.0f);
      continue;
    }
    const bf16* xr = x + (size_t)gr * D;
    float s = 0.0f;
    for (int c = lane; c < D; c += 32) s += __bfloat162float(xr[c]);
    const float mean = warp_sum(s) / D;
    float q = 0.0f;
    for (int c = lane; c < D; c += 32) {
      const float d = __bfloat162float(xr[c]) - mean;
      q += d * d;
    }
    const float inv = rsqrtf(warp_sum(q) / D + eps);
    for (int c = lane; c < D; c += 32)
      Y[r * D + c] = __float2bfloat16(
          (__bfloat162float(xr[c]) - mean) * inv * gamma[c] + beta[c]);
  }

  FragC acc[4];
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.0f);
  for (int k0 = 0; k0 < D; k0 += TKC) {
    __syncthreads();
    load_b_chunk(Bs, w1, k0, n0, Hd);
    __syncthreads();
    mma_chunk(acc, Y + k0, D, Bs);
  }
  store_acc(C, acc);
  __syncthreads();

  for (int i = threadIdx.x; i < TM * TN; i += THREADS) {
    const int r = i / TN, c = i % TN;
    if (m0 + r >= M) continue;
    const float v = C[i] + b1[n0 + c];
    const float g = 0.5f * v * (1.0f + tanhf(0.7978845608028654f *
                                            (v + 0.044715f * v * v * v)));
    h[(size_t)(m0 + r) * Hd + n0 + c] = __float2bfloat16(g);
  }
}

__global__ void __launch_bounds__(THREADS)
fc2_residual_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w2,
                    const float* __restrict__ b2, const bf16* __restrict__ x,
                    bf16* __restrict__ out, int M, int D, int Hd) {
  __shared__ __align__(128) bf16 As[TM * TKC];
  __shared__ __align__(128) bf16 Bs[TKC * TN];
  __shared__ __align__(128) float C[TM * TN];
  const int m0 = blockIdx.x * TM, n0 = blockIdx.y * TN;

  FragC acc[4];
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.0f);
  for (int k0 = 0; k0 < Hd; k0 += TKC) {
    __syncthreads();
    {  // As <- h[m0:m0+TM, k0:k0+TKC], zero past M
      const int r = threadIdx.x / (TKC / 8), c = (threadIdx.x % (TKC / 8)) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (m0 + r < M)
        v = *reinterpret_cast<const uint4*>(h + (size_t)(m0 + r) * Hd + k0 + c);
      *reinterpret_cast<uint4*>(As + r * TKC + c) = v;
    }
    load_b_chunk(Bs, w2, k0, n0, D);
    __syncthreads();
    mma_chunk(acc, As, TKC, Bs);
  }
  store_acc(C, acc);
  __syncthreads();

  for (int i = threadIdx.x; i < TM * TN; i += THREADS) {
    const int r = i / TN, c = i % TN;
    if (m0 + r >= M) continue;
    const size_t o = (size_t)(m0 + r) * D + n0 + c;
    out[o] = __float2bfloat16(C[i] + b2[n0 + c] + __bfloat162float(x[o]));
  }
}

}  // namespace

// x, h, out, w1, w2: contiguous bf16; gamma, beta, b1, b2: contiguous f32.
// Shapes (checked by the Python wrapper): D % 128 == 0, Hd % 128 == 0,
// 2 * TM * D + 40960 bytes of shared memory within the H100's 227 KB.
extern "C" int pvpu_ln_fc1_gelu(const void* x, const void* gamma,
                                const void* beta, const void* w1,
                                const void* b1, void* h, int M, int D, int Hd,
                                float eps, void* stream) {
  const size_t smem = sizeof(bf16) * (TM * D + TKC * TN) + sizeof(float) * TM * TN;
  cudaFuncSetAttribute(ln_fc1_gelu_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid((M + TM - 1) / TM, Hd / TN);
  ln_fc1_gelu_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)gamma, (const float*)beta,
      (const bf16*)w1, (const float*)b1, (bf16*)h, M, D, Hd, eps);
  return (int)cudaGetLastError();
}

extern "C" int pvpu_fc2_residual(const void* h, const void* w2, const void* b2,
                                 const void* x, void* out, int M, int D, int Hd,
                                 void* stream) {
  dim3 grid((M + TM - 1) / TM, D / TN);
  fc2_residual_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)h, (const bf16*)w2, (const float*)b2, (const bf16*)x,
      (bf16*)out, M, D, Hd);
  return (int)cudaGetLastError();
}
