// Attention backward of the fused entry: dq, dk, dv from q, k, v, dO and the
// forward's per-row statistics (m, l).
//
// Replaces pvpuformer_tpu/ops/fused_attention.py:_bwd_kernel (the VJP of
// `fused_attention`). Same rounding points as that kernel and as the plain
// version `fused_attention_bwd_plain`: S = q.k^T*scale and p32 =
// exp(s*scale - m) / l in f32; p = p32 cast to the input dtype; dv =
// p^T.dO; dp = dO.v^T in f32; srow = sum_k p32*dp (from p32*dp in f32, not
// the rowsum(dO * O) identity, which sums the bf16-rounded P.V); ds =
// p32*(dp - srow) cast to the input dtype; dq = ds.k*scale and dk =
// ds^T.q*scale, each accumulated in f32, scaled, then cast.
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
// atomics, bit-identical on repeat; the forward saved (m, l), so there is
// no statistics pass.
//   query side: one block of 4 warps per (b*h, 64-query tile) streams K/V
//     tiles through a two-stage cp.async ring in two passes: (A) S and dP
//     in registers, p32 from the saved (m, l), srow = sum p32*dp reduced in
//     registers; (B) S and dP again, ds = bf16(p32*(dp - srow)) in
//     registers, dq += ds.K in register accumulators. It writes dq and the
//     row terms (m*log2(e), 1/l, srow) of every row to an f32 (BH, N, 4)
//     scratch.
//   key side: one block per (b*h, 64-key tile); K and V stay in shared
//     memory, Q, dO and the row terms stream through the ring. S^T = K.Q^T
//     and dP^T = V.dO^T are recomputed in registers, so P^T and dS^T come
//     out of the accumulators already in the A-operand layout of
//     dv += P^T.dO and dk += dS^T.Q, which accumulate in registers.
// That is 9 N x N x D products (the function's 5, plus S and dP twice more
// on the query side and S, dP once more on the key side). The bf16 products
// run on mma.sync.m16n8k16 with ldmatrix (attention_tiles.cuh). Keys past n
// get p = 0; query rows past n are zero-filled, get p = 0 on the key side
// and are not stored.
// The float instantiation (the f32 parity path) keeps the shared-memory
// tiles and scalar FMAs, in the same two launches and the same scratch.
#include "attention_tiles.cuh"

namespace {

using namespace pvpu_attn;

// p32 of one score, from the row terms; both launches and both types use
// this expression, so the query and key sides agree on every p32
__device__ __forceinline__ float p_f32(float s, float sl2, float m2, float il) {
  return exp2f(s * sl2 - m2) * il;
}
__device__ __forceinline__ float p_bf16(float s, float sl2, float m2,
                                        float il) {
  return ex2(s * sl2 - m2) * il;
}

// the row terms (m*log2(e), 1/l) of query row `row` from the forward's
// statistics; zero past n (p = 0 there)
__device__ __forceinline__ void row_terms(const float* stats, int bh, int n,
                                          int row, float& m2, float& il) {
  if (row < n) {
    const float* st = stats + ((long long)bh * n + row) * 2;
    m2 = st[0] * LOG2E;
    il = 1.0f / st[1];
  } else {
    m2 = 0.0f;
    il = 0.0f;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
attention_bwd_q_bf16(Ten q, Ten k, Ten v, Ten dout, Ten dq,
                     const float* __restrict__ stats,
                     float4* __restrict__ rows, int heads, int n,
                     float scale) {
  constexpr int LD = D + 8, DN = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + TQ * LD;
  bf16* Ks = dOs + TQ * LD;            // [STAGES][TK][LD]
  bf16* Vs = Ks + STAGES * TK * LD;    // [STAGES][TK][LD]

  const int bh = blockIdx.y, q0 = blockIdx.x * TQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, tq = lane & 3;
  const bf16* ks = slice<bf16>(k, bh, heads);
  const bf16* vs = slice<bf16>(v, bh, heads);
  const int nt = (n + TK - 1) / TK;
  const float sl2 = scale * LOG2E;

  auto issue = [&](int s) {                // pass A steps 0..nt-1, B after
    const int t = s < nt ? s : s - nt, st = s % STAGES;
    load_rows<D>(Ks + st * TK * LD, ks, k.sn, t * TK, n);
    load_rows<D>(Vs + st * TK * LD, vs, v.sn, t * TK, n);
  };
  load_rows<D>(Qs, slice<bf16>(q, bh, heads), q.sn, q0, n);
  load_rows<D>(dOs, slice<bf16>(dout, bh, heads), dout.sn, q0, n);
  issue(0);
  cp_async_commit();

  const int row0 = q0 + warp * 16;
  float m2[2], il[2], sr[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r)
    row_terms(stats, bh, n, row0 + (lane >> 2) + 8 * r, m2[r], il[r]);
  float acc[DN][4];
#pragma unroll
  for (int i = 0; i < DN; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int s = 0; s < 2 * nt; ++s) {
    if (s + 1 < 2 * nt) issue(s + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int st = s % STAGES, t = s < nt ? s : s - nt;
    const bf16* Kt = Ks + st * TK * LD;
    if (s == nt)                           // srow complete: add the quad
#pragma unroll
      for (int r = 0; r < 2; ++r) sr[r] = quad_sum(sr[r]);
    uint32_t a[D / 16][4];
    float x[8][4], dp[8][4];
    load_a<D>(a, Qs + warp * 16 * LD, lane);
    mma_abt<D>(x, a, Kt, lane);
    load_a<D>(a, dOs + warp * 16 * LD, lane);
    mma_abt<D>(dp, a, Vs + st * TK * LD, lane);
    const bool ragged = (t + 1) * TK > n;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        x[i][j] = p_bf16(x[i][j], sl2, m2[j >> 1], il[j >> 1]);
        if (ragged && t * TK + i * 8 + 2 * tq + (j & 1) >= n) x[i][j] = 0.0f;
      }
    if (s < nt) {                          // pass A: srow
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sr[j >> 1] = fmaf(x[i][j], dp[i][j], sr[j >> 1]);
    } else {                               // pass B: ds, dq += ds.K
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          x[i][j] = x[i][j] * (dp[i][j] - sr[j >> 1]);
      uint32_t da[4][4];
      to_a(da, x);
      mma_ab<D>(acc, da, Kt, lane);
    }
    __syncthreads();
  }

  store_rows<D>(slice<bf16>(dq, bh, heads), dq.sn, acc, row0, n, lane, scale,
                scale);
  if (tq == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + (lane >> 2) + 8 * r;
      if (row < n)
        rows[(long long)bh * n + row] = make_float4(m2[r], il[r], sr[r], 0.0f);
    }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
attention_bwd_kv_bf16(Ten q, Ten k, Ten v, Ten dout,
                      const float4* __restrict__ rows, Ten dk, Ten dv,
                      int heads, int n, float scale) {
  constexpr int LD = D + 8, DN = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + TK * LD;
  bf16* Qs = Vs + TK * LD;             // [STAGES][TQ][LD]
  bf16* dOs = Qs + STAGES * TQ * LD;   // [STAGES][TQ][LD]
  float4* R = reinterpret_cast<float4*>(dOs + STAGES * TQ * LD);  // [STAGES][TQ]

  const int bh = blockIdx.y, k0 = blockIdx.x * TK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, tq = lane & 3;
  const bf16* qs = slice<bf16>(q, bh, heads);
  const bf16* dos = slice<bf16>(dout, bh, heads);
  const float4* rs = rows + (long long)bh * n;
  const int nt = (n + TQ - 1) / TQ;
  const float sl2 = scale * LOG2E;

  auto issue = [&](int t) {                // query tile t: Q, dO, row terms
    const int st = t % STAGES;
    load_rows<D>(Qs + st * TQ * LD, qs, q.sn, t * TQ, n);
    load_rows<D>(dOs + st * TQ * LD, dos, dout.sn, t * TQ, n);
    if (threadIdx.x < TQ) {
      const int r = t * TQ + threadIdx.x;
      cp_async16(R + st * TQ + threadIdx.x, rs + (r < n ? r : 0), r < n);
    }
  };
  load_rows<D>(Ks, slice<bf16>(k, bh, heads), k.sn, k0, n);
  load_rows<D>(Vs, slice<bf16>(v, bh, heads), v.sn, k0, n);
  issue(0);
  cp_async_commit();

  float dk_acc[DN][4], dv_acc[DN][4];
#pragma unroll
  for (int i = 0; i < DN; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.0f;

  for (int t = 0; t < nt; ++t) {
    if (t + 1 < nt) issue(t + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int st = t % STAGES;
    const bf16* Qt = Qs + st * TQ * LD;
    const bf16* dOt = dOs + st * TQ * LD;
    const float4* Rt = R + st * TQ;
    uint32_t a[D / 16][4];
    float x[8][4], dp[8][4];               // [key][query]
    load_a<D>(a, Ks + warp * 16 * LD, lane);
    mma_abt<D>(x, a, Qt, lane);
    load_a<D>(a, Vs + warp * 16 * LD, lane);
    mma_abt<D>(dp, a, dOt, lane);
    const bool ragged = (t + 1) * TQ > n;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {        // query column i*8 + 2*tq + c
        const int col = i * 8 + 2 * tq + c;
        const float4 rt = Rt[col];
        const bool ok = !ragged || t * TQ + col < n;
#pragma unroll
        for (int h = 0; h < 2; ++h) {      // key rows g, g + 8
          const int j = 2 * h + c;
          const float p = ok ? p_bf16(x[i][j], sl2, rt.x, rt.y) : 0.0f;
          x[i][j] = p;
          dp[i][j] = p * (dp[i][j] - rt.z);
        }
      }
    uint32_t pa[4][4];
    to_a(pa, x);
    mma_ab<D>(dv_acc, pa, dOt, lane);      // dv += p^T . dO
    to_a(pa, dp);
    mma_ab<D>(dk_acc, pa, Qt, lane);       // dk += ds^T . q
    __syncthreads();
  }

  const int row0 = k0 + warp * 16;
  store_rows<D>(slice<bf16>(dk, bh, heads), dk.sn, dk_acc, row0, n, lane,
                scale, scale);
  store_rows<D>(slice<bf16>(dv, bh, heads), dv.sn, dv_acc, row0, n, lane,
                1.0f, 1.0f);
}

// ---------------------------------------------------------------------------
// float path (parity): shared-memory tiles, scalar FMAs
// ---------------------------------------------------------------------------

// O[TK][D] += Ps[TQ][TK]^T . Xs[TQ][D]; the warp owns key rows
// warp*16..+15 of O
__device__ void ptx_tile_f32(const float* Ps, const float* Xs, float* O,
                             int D) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp * 16; r < warp * 16 + 16; ++r)
    for (int c = lane; c < D; c += 32) {
      float s = O[r * D + c];
      for (int j = 0; j < TQ; ++j) s = fmaf(Ps[j * TK + r], Xs[j * D + c], s);
      O[r * D + c] = s;
    }
}

__global__ void __launch_bounds__(THREADS)
attention_bwd_q_f32(Ten q, Ten k, Ten v, Ten dout, Ten dq,
                    const float* __restrict__ stats, float4* __restrict__ rows,
                    int heads, int n, int D, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + TQ * D;
  float* Ks = dOs + TQ * D;
  float* Vs = Ks + TK * D;
  float* S = Vs + TK * D;
  float* DP = S + TQ * TK;
  float* DSs = DP + TQ * TK;
  float* dQ = DSs + TQ * TK;
  float* m_row = dQ + TQ * D;
  float* l_row = m_row + TQ;               // holds 1 / l
  float* s_row = l_row + TQ;

  const int bh = blockIdx.y, q0 = blockIdx.x * TQ;
  const float* ks = slice<float>(k, bh, heads);
  const float* vs = slice<float>(v, bh, heads);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_tiles = (n + TK - 1) / TK;
  const float sl2 = scale * LOG2E;

  load_tile_f32(Qs, slice<float>(q, bh, heads), q.sn, q0, n, D);
  load_tile_f32(dOs, slice<float>(dout, bh, heads), dout.sn, q0, n, D);
  for (int i = threadIdx.x; i < TQ * D; i += THREADS) dQ[i] = 0.0f;
  if (threadIdx.x < TQ) {
    row_terms(stats, bh, n, q0 + threadIdx.x, m_row[threadIdx.x],
              l_row[threadIdx.x]);
    s_row[threadIdx.x] = 0.0f;
  }
  __syncthreads();

  // pass A sums srow = sum p32*dp; pass B forms ds and dq += ds . K
  for (int pass = 0; pass < 2; ++pass) {
    for (int t = 0; t < n_tiles; ++t) {
      load_tile_f32(Ks, ks, k.sn, t * TK, n, D);
      load_tile_f32(Vs, vs, v.sn, t * TK, n, D);
      __syncthreads();
      qk_tile_f32(Qs, Ks, S, D);
      qk_tile_f32(dOs, Vs, DP, D);
      __syncthreads();
      for (int r = warp * 16; r < warp * 16 + 16; ++r) {
        const float m2 = m_row[r], il = l_row[r], sr = s_row[r];
        float acc = 0.0f;
        for (int j = 0; j < 2; ++j) {
          const int c = lane + 32 * j;
          const float p32 =
              (t * TK + c < n) ? p_f32(S[r * TK + c], sl2, m2, il) : 0.0f;
          const float dp = DP[r * TK + c];
          if (pass == 0)
            acc = fmaf(p32, dp, acc);
          else
            DSs[r * TK + c] = from_f<float>(p32 * (dp - sr));
        }
        if (pass == 0) {
          acc = warp_sum(acc);
          __syncwarp();
          if (lane == 0) s_row[r] += acc;
          __syncwarp();
        }
      }
      __syncthreads();
      if (pass == 1) {
        pv_tile_f32(DSs, Ks, dQ, D);
        __syncthreads();
      }
    }
  }

  float* dqs = slice<float>(dq, bh, heads);
  for (int i = threadIdx.x; i < TQ * D; i += THREADS) {
    const int r = i / D;
    if (q0 + r < n) dqs[(q0 + r) * dq.sn + i % D] = dQ[i] * scale;
  }
  if (threadIdx.x < TQ && q0 + threadIdx.x < n)
    rows[(long long)bh * n + q0 + threadIdx.x] = make_float4(
        m_row[threadIdx.x], l_row[threadIdx.x], s_row[threadIdx.x], 0.0f);
}

__global__ void __launch_bounds__(THREADS)
attention_bwd_kv_f32(Ten q, Ten k, Ten v, Ten dout,
                     const float4* __restrict__ rows, Ten dk, Ten dv,
                     int heads, int n, int D, float scale) {
  // P and dS overwrite S and dP in place (each thread reads and then
  // writes its own element): that keeps D = 128 within shared memory
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + TK * D;
  float* Qs = Vs + TK * D;
  float* dOs = Qs + TQ * D;
  float* S = dOs + TQ * D;
  float* DP = S + TQ * TK;
  float* dK = DP + TQ * TK;
  float* dV = dK + TK * D;
  float4* R = reinterpret_cast<float4*>(dV + TK * D);

  const int bh = blockIdx.y, k0 = blockIdx.x * TK;
  const float* qs = slice<float>(q, bh, heads);
  const float* dos = slice<float>(dout, bh, heads);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_tiles = (n + TQ - 1) / TQ;
  const float sl2 = scale * LOG2E;

  load_tile_f32(Ks, slice<float>(k, bh, heads), k.sn, k0, n, D);
  load_tile_f32(Vs, slice<float>(v, bh, heads), v.sn, k0, n, D);
  for (int i = threadIdx.x; i < TK * D; i += THREADS) {
    dK[i] = 0.0f;
    dV[i] = 0.0f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    load_tile_f32(Qs, qs, q.sn, t * TQ, n, D);
    load_tile_f32(dOs, dos, dout.sn, t * TQ, n, D);
    if (threadIdx.x < TQ) {
      const int r = t * TQ + threadIdx.x;
      R[threadIdx.x] = r < n ? rows[(long long)bh * n + r]
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    __syncthreads();
    qk_tile_f32(Qs, Ks, S, D);      // S[query][key]
    qk_tile_f32(dOs, Vs, DP, D);    // dP[query][key]
    __syncthreads();
    for (int r = warp * 16; r < warp * 16 + 16; ++r) {
      const bool ok = t * TQ + r < n;
      const float4 rt = R[r];
      for (int j = 0; j < 2; ++j) {
        const int c = lane + 32 * j;
        const float p32 = ok ? p_f32(S[r * TK + c], sl2, rt.x, rt.y) : 0.0f;
        const float dp = DP[r * TK + c];
        S[r * TK + c] = p32;
        DP[r * TK + c] = p32 * (dp - rt.z);
      }
    }
    __syncthreads();
    ptx_tile_f32(S, dOs, dV, D);    // dv += p^T . dO
    ptx_tile_f32(DP, Qs, dK, D);    // dk += ds^T . q
    __syncthreads();
  }

  float* dks = slice<float>(dk, bh, heads);
  float* dvs = slice<float>(dv, bh, heads);
  for (int i = threadIdx.x; i < TK * D; i += THREADS) {
    const int r = i / D;
    if (k0 + r >= n) continue;
    dks[(k0 + r) * dk.sn + i % D] = dK[i] * scale;
    dvs[(k0 + r) * dv.sn + i % D] = dV[i];
  }
}

size_t smem_q_f32(int D) {
  return sizeof(float) * (5 * TQ * D + 3 * TQ * TK + 3 * TQ);
}
size_t smem_kv_f32(int D) {
  return sizeof(float) * (6 * TK * D + 2 * TQ * TK) + sizeof(float4) * TQ;
}

// launch a kernel with `smem` bytes of dynamic shared memory, unless raising
// its shared-memory limit (`attr`, set once per kernel) failed
template <typename Kernel, typename... Args>
cudaError_t run(Kernel kernel, const cudaError_t& attr, dim3 grid, size_t smem,
                cudaStream_t stream, Args... args) {
  if (attr != cudaSuccess) return attr;
  kernel<<<grid, THREADS, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <int D>
int launch_bf16(const Ten& q, const Ten& k, const Ten& v, const Ten& dout,
                const Ten& dq, const Ten& dk, const Ten& dv,
                const float* stats, float4* rows, int bh, int heads, int n,
                float scale, cudaStream_t stream) {
  constexpr int sq = (2 * TQ + 2 * STAGES * TK) * (D + 8) * (int)sizeof(bf16);
  constexpr int skv = (2 * TK + 2 * STAGES * TQ) * (D + 8) * (int)sizeof(bf16) +
                      STAGES * TQ * (int)sizeof(float4);
  static const cudaError_t aq = cudaFuncSetAttribute(
      attention_bwd_q_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, sq);
  static const cudaError_t akv = cudaFuncSetAttribute(
      attention_bwd_kv_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      skv);
  const dim3 grid((n + TQ - 1) / TQ, bh);
  cudaError_t err = run(attention_bwd_q_bf16<D>, aq, grid, sq, stream, q, k, v,
                        dout, dq, stats, rows, heads, n, scale);
  if (err != cudaSuccess) return (int)err;
  return (int)run(attention_bwd_kv_bf16<D>, akv, grid, skv, stream, q, k, v,
                  dout, (const float4*)rows, dk, dv, heads, n, scale);
}

int launch_f32(const Ten& q, const Ten& k, const Ten& v, const Ten& dout,
               const Ten& dq, const Ten& dk, const Ten& dv, const float* stats,
               float4* rows, int bh, int heads, int n, int D, float scale,
               cudaStream_t stream) {
  static const cudaError_t aq = cudaFuncSetAttribute(      // once, largest D
      attention_bwd_q_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_q_f32(128));
  static const cudaError_t akv = cudaFuncSetAttribute(
      attention_bwd_kv_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_kv_f32(128));
  const dim3 grid((n + TQ - 1) / TQ, bh);
  cudaError_t err = run(attention_bwd_q_f32, aq, grid, smem_q_f32(D), stream,
                        q, k, v, dout, dq, stats, rows, heads, n, D, scale);
  if (err != cudaSuccess) return (int)err;
  return (int)run(attention_bwd_kv_f32, akv, grid, smem_kv_f32(D), stream, q,
                  k, v, dout, (const float4*)rows, dk, dv, heads, n, D, scale);
}

}  // namespace

// q, k, v, dout, dq, dk, dv: strided (batch, n, heads, D) tensors (Ten);
// stats: the fused forward's (batch*heads, n, 2) f32 (m, l); rows: an f32
// (batch*heads, n, 4) scratch written by the first launch, read by the
// second. dtype: 0 = float32, 1 = bfloat16. D % 16 == 0, D <= 128, rows
// 16-byte aligned (checked by the Python wrapper).
extern "C" int pvpu_attention_bwd(Ten q, Ten k, Ten v, Ten dout, Ten dq,
                                  Ten dk, Ten dv, const void* stats,
                                  void* rows, int batch, int heads, int n,
                                  int D, float scale, int dtype,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* st = (const float*)stats;
  float4* rw = (float4*)rows;
  const int bh = batch * heads;
  if (dtype == 0)
    return launch_f32(q, k, v, dout, dq, dk, dv, st, rw, bh, heads, n, D,
                      scale, s);
#define PVPU_BWD(DD)                                                      \
  return launch_bf16<DD>(q, k, v, dout, dq, dk, dv, st, rw, bh, heads, n, \
                         scale, s)
  PVPU_SWITCH_D(D, PVPU_BWD)
#undef PVPU_BWD
}
