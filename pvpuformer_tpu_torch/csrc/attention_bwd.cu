// Attention backward of the fused entry: dq, dk, dv from q, k, v and dO.
//
// Replaces pvpuformer_tpu/ops/fused_attention.py:_bwd_kernel (the VJP of
// `fused_attention`). Same rounding points as that kernel and as the plain
// version `fused_attention_bwd_plain`: S = q.k^T*scale and p32 = softmax(S)
// in f32; p = p32 cast to the input dtype; dv = p^T.dO; dp = dO.v^T in f32;
// srow = sum_k p32*dp; ds = p32*(dp - srow) cast to the input dtype;
// dq = ds.k*scale and dk = ds^T.q*scale, each accumulated in f32 and cast.
//
// Bound on the H100: the function does five N x N x D products (S, dV, dP,
// dQ, dK), 10*BH*N^2*D operations (JAX's cost estimate says 12), against
// 7*BH*N*D*itemsize bytes. At the shipped training shapes (bf16, batch 32)
// the global blocks are (BH, N, D) = (384, 784, 64): 151 GFLOP against
// 270 MB, 0.153 ms on the tensor cores vs 0.081 ms of memory (operations
// bound); the window blocks (1536, 196, 64): 38 GFLOP against the same
// 270 MB, 0.038 vs 0.081 ms (bytes bound). Either way the (N, N) scores
// must stay out of device memory.
//
// The TPU kernel holds one head's whole (N, N) scores in VMEM and does
// everything in one grid step (784^2 f32 = 2.4 MB); a block here has 227 KB
// of shared memory, and blocks run in parallel, so no block can carry a
// row sum or a key-side accumulator to another. Design: two launches, no
// atomics, deterministic.
//   query side: one block per (b*h, 64-query tile) streams K/V tiles through
//     shared memory in three passes: (1) the row max and sum of exp, as the
//     fused forward; (2) srow = sum p32*dp; (3) ds and dq += ds.K in f32.
//     It writes dq and the per-row (max, sum, srow) to an f32 scratch.
//   key side: one block per (b*h, 64-key tile) streams Q/dO tiles, recomputes
//     p32 from the saved row statistics, and accumulates dv += p^T.dO and
//     dk += ds^T.Q in f32 shared memory.
// The products run on the tensor cores (wmma, bf16 in, f32 accumulate) with
// the tile helpers of the forward (attention_tiles.cuh); the float
// instantiation (parity) uses scalar FMAs. Keys past n are masked (p = 0);
// query rows past n are zero-padded, get p = 0 on the key side and are not
// stored. wgmma, TMA and a fused single pass are later work.
#include "attention_tiles.cuh"

namespace {

using namespace pvpu_attn;

// O[TK][D] (f32) += Ps[TQ][TK]^T . Xs[TQ][D]; the warp owns key rows
// warp*16..+15 of O
template <typename T>
__device__ void ptx_tile(const T* Ps, const T* Xs, float* O, int D);

template <>
__device__ void ptx_tile<bf16>(const bf16* Ps, const bf16* Xs, float* O,
                               int D) {
  const int warp = threadIdx.x / 32;
  // A = Ps^T: element (i, j) at Ps[j * TK + i], i.e. Ps read column-major
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  for (int n = 0; n < D; n += 16) {
    float* o = O + warp * 16 * D + n;
    wmma::load_matrix_sync(acc, o, D, wmma::mem_row_major);
    for (int k = 0; k < TQ; k += 16) {
      wmma::load_matrix_sync(a, Ps + k * TK + warp * 16, TK);
      wmma::load_matrix_sync(b, Xs + k * D + n, D);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(o, acc, D, wmma::mem_row_major);
  }
}

template <>
__device__ void ptx_tile<float>(const float* Ps, const float* Xs, float* O,
                                int D) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp * 16; r < warp * 16 + 16; ++r)
    for (int c = lane; c < D; c += 32) {
      float s = O[r * D + c];
      for (int j = 0; j < TQ; ++j) s = fmaf(Ps[j * TK + r], Xs[j * D + c], s);
      O[r * D + c] = s;
    }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
attention_bwd_q_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       T* __restrict__ dq, float* __restrict__ stats, int n,
                       int D, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + TQ * D;
  T* Ks = dOs + TQ * D;
  T* Vs = Ks + TK * D;
  float* S = reinterpret_cast<float*>(Vs + TK * D);
  float* DP = S + TQ * TK;
  T* DSs = reinterpret_cast<T*>(DP + TQ * TK);
  float* dQ = reinterpret_cast<float*>(DSs + TQ * TK);
  float* m_row = dQ + TQ * D;
  float* l_row = m_row + TQ;
  float* s_row = l_row + TQ;

  const size_t base = (size_t)blockIdx.y * n * D;
  const int q0 = blockIdx.x * TQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_tiles = (n + TK - 1) / TK;

  load_tile(Qs, q + base, q0, n, D);
  load_tile(dOs, dout + base, q0, n, D);
  for (int i = threadIdx.x; i < TQ * D; i += THREADS) dQ[i] = 0.0f;
  if (threadIdx.x < TQ) {
    m_row[threadIdx.x] = -INFINITY;
    l_row[threadIdx.x] = 0.0f;
    s_row[threadIdx.x] = 0.0f;
  }
  __syncthreads();

  // pass 1: exact row max and row sum of exp(s - max), as the forward
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

  // passes 2 and 3: S and dP tile by tile; pass 2 sums srow = sum p32*dp,
  // pass 3 forms ds and accumulates dq += ds . K
  for (int pass = 2; pass <= 3; ++pass) {
    for (int t = 0; t < n_tiles; ++t) {
      load_tile(Ks, k + base, t * TK, n, D);
      load_tile(Vs, v + base, t * TK, n, D);
      __syncthreads();
      qk_tile<T>(Qs, Ks, S, D);
      qk_tile<T>(dOs, Vs, DP, D);
      __syncthreads();
      for (int r = warp * 16; r < warp * 16 + 16; ++r) {
        const float m = m_row[r], l = l_row[r], sr = s_row[r];
        float acc = 0.0f;
        for (int j = 0; j < 2; ++j) {
          const int c = lane + 32 * j;
          const float p32 = (t * TK + c < n)
                                ? expf(S[r * TK + c] * scale - m) / l : 0.0f;
          const float dp = DP[r * TK + c];
          if (pass == 2)
            acc = fmaf(p32, dp, acc);
          else
            DSs[r * TK + c] = from_f<T>(p32 * (dp - sr));
        }
        if (pass == 2) {
          acc = warp_sum(acc);
          __syncwarp();
          if (lane == 0) s_row[r] += acc;
          __syncwarp();
        }
      }
      __syncthreads();
      if (pass == 3) {
        pv_tile<T>(DSs, Ks, dQ, D);
        __syncthreads();
      }
    }
  }

  for (int i = threadIdx.x; i < TQ * D; i += THREADS) {
    const int r = i / D;
    if (q0 + r < n) dq[base + (size_t)q0 * D + i] = from_f<T>(dQ[i] * scale);
  }
  if (threadIdx.x < TQ && q0 + threadIdx.x < n) {
    float* st = stats + ((size_t)blockIdx.y * n + q0 + threadIdx.x) * 3;
    st[0] = m_row[threadIdx.x];
    st[1] = l_row[threadIdx.x];
    st[2] = s_row[threadIdx.x];
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
attention_bwd_kv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ stats, T* __restrict__ dk,
                        T* __restrict__ dv, int n, int D, float scale) {
  // for float, P and dS overwrite S and dP in place (each thread reads and
  // then writes its own element): that keeps D = 128 within shared memory
  constexpr bool ALIAS = sizeof(T) == sizeof(float);
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + TK * D;
  T* Qs = Vs + TK * D;
  T* dOs = Qs + TQ * D;
  float* S = reinterpret_cast<float*>(dOs + TQ * D);
  float* DP = S + TQ * TK;
  T* Ps = ALIAS ? reinterpret_cast<T*>(S) : reinterpret_cast<T*>(DP + TQ * TK);
  T* DSs = ALIAS ? reinterpret_cast<T*>(DP) : Ps + TQ * TK;
  float* dK = ALIAS ? DP + TQ * TK
                    : reinterpret_cast<float*>(DSs + TQ * TK);
  float* dV = dK + TK * D;
  float* m_row = dV + TK * D;
  float* l_row = m_row + TQ;
  float* s_row = l_row + TQ;

  const size_t base = (size_t)blockIdx.y * n * D;
  const int k0 = blockIdx.x * TK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_tiles = (n + TQ - 1) / TQ;

  load_tile(Ks, k + base, k0, n, D);
  load_tile(Vs, v + base, k0, n, D);
  for (int i = threadIdx.x; i < TK * D; i += THREADS) {
    dK[i] = 0.0f;
    dV[i] = 0.0f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    load_tile(Qs, q + base, t * TQ, n, D);
    load_tile(dOs, dout + base, t * TQ, n, D);
    if (threadIdx.x < TQ) {
      const int r = t * TQ + threadIdx.x;
      const bool ok = r < n;
      const float* st = stats + ((size_t)blockIdx.y * n + (ok ? r : 0)) * 3;
      m_row[threadIdx.x] = ok ? st[0] : 0.0f;
      l_row[threadIdx.x] = ok ? st[1] : 1.0f;
      s_row[threadIdx.x] = ok ? st[2] : 0.0f;
    }
    __syncthreads();
    qk_tile<T>(Qs, Ks, S, D);      // S[query][key]
    qk_tile<T>(dOs, Vs, DP, D);    // dP[query][key]
    __syncthreads();
    for (int r = warp * 16; r < warp * 16 + 16; ++r) {
      const bool ok = t * TQ + r < n;
      const float m = m_row[r], l = l_row[r], sr = s_row[r];
      for (int j = 0; j < 2; ++j) {
        const int c = lane + 32 * j;
        const float s = S[r * TK + c], dp = DP[r * TK + c];
        const float p32 = ok ? expf(s * scale - m) / l : 0.0f;
        Ps[r * TK + c] = from_f<T>(p32);
        DSs[r * TK + c] = from_f<T>(p32 * (dp - sr));
      }
    }
    __syncthreads();
    ptx_tile<T>(Ps, dOs, dV, D);    // dv += p^T . dO
    ptx_tile<T>(DSs, Qs, dK, D);    // dk += ds^T . q
    __syncthreads();
  }

  for (int i = threadIdx.x; i < TK * D; i += THREADS) {
    const int r = i / D;
    if (k0 + r >= n) continue;
    const size_t o = base + (size_t)k0 * D + i;
    dk[o] = from_f<T>(dK[i] * scale);
    dv[o] = from_f<T>(dV[i]);
  }
}

template <typename T>
size_t smem_q(int D) {
  return sizeof(T) * (2 * TQ * D + 2 * TK * D + TQ * TK) +
         sizeof(float) * (2 * TQ * TK + TQ * D + 3 * TQ);
}

template <typename T>
size_t smem_kv(int D) {
  const size_t pds = sizeof(T) == sizeof(float) ? 0 : 2 * TQ * TK * sizeof(T);
  return sizeof(T) * (2 * TK * D + 2 * TQ * D) + pds +
         sizeof(float) * (2 * TQ * TK + 2 * TK * D + 3 * TQ);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* dout,
           void* dq, void* dk, void* dv, float* stats, int bh, int n, int D,
           float scale, cudaStream_t stream) {
  const dim3 grid((n + TQ - 1) / TQ, bh);
  const size_t sq = smem_q<T>(D), skv = smem_kv<T>(D);
  cudaFuncSetAttribute(attention_bwd_q_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sq);
  cudaFuncSetAttribute(attention_bwd_kv_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)skv);
  attention_bwd_q_kernel<T><<<grid, THREADS, sq, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (T*)dq, stats, n,
      D, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attention_bwd_kv_kernel<T><<<grid, THREADS, skv, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, stats, (T*)dk,
      (T*)dv, n, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, k, v, dout, dq, dk, dv: contiguous
// (bh, n, D) with D % 16 == 0 and D <= 128 (checked by the Python wrapper);
// stats: (bh, n, 3) f32 scratch written by the first launch, read by the
// second.
extern "C" int pvpu_attention_bwd(const void* q, const void* k, const void* v,
                                  const void* dout, void* dq, void* dk,
                                  void* dv, void* stats, int bh, int n, int D,
                                  float scale, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  float* st = (float*)stats;
  if (dtype == 1)
    return launch<bf16>(q, k, v, dout, dq, dk, dv, st, bh, n, D, scale, s);
  return launch<float>(q, k, v, dout, dq, dk, dv, st, bh, n, D, scale, s);
}
