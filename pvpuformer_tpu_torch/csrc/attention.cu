// Attention forward for the ViT blocks: two entry points, one source.
//
// Replaces pvpuformer_tpu/ops/fused_attention.py:_fwd_kernel (fused entry,
// `fused_attention`) and pvpuformer_tpu/ops/attention.py:_flash_kernel
// (flash entry, `flash_attention`).
//
// Bound on the H100: at ViT-B@448 flip batch 2 the window blocks are
// (BH, N, D) = (96, 196, 64) and the global blocks (24, 784, 64): 4*BH*N^2*D
// = 0.94 / 3.8 GFLOP against 4*BH*N*D*2 = 10 MB of q/k/v/out, so the work is
// compute bound and the (N, N) scores (784^2 f32 = 2.4 MB per head) must
// never reach device memory. The TPU kernel keeps a whole score matrix in
// VMEM; 227 KB of shared memory cannot.
//
// Design (bf16, attention_tiles.cuh): one block of 4 warps per (b*h,
// 64-query tile); a warp owns 16 query rows. Q's fragments are loaded once;
// S = Q.K^T for a 64-key tile stays in registers (mma.sync.m16n8k16), the
// row max and sum are reduced over the quad that shares a row, P is cast to
// bf16 in registers and is the A operand of P.V, and O accumulates in
// registers and is written once. K/V tiles stream through a two-stage
// cp.async ring, so tile t+1 loads while tile t runs its products.
//   fused: P is normalised BEFORE the cast, as _fwd_kernel, so it needs the
//          final row sum: pass 1 runs Q.K^T alone with an online (m, l) in
//          registers (no P, no V); pass 2 forms bf16(exp(s*scale - m) / l)
//          and adds P.V into O. With `stats` it also writes the per-row
//          (m, l) in f32, (BH, N, 2), the backward's residual; the wrapper
//          passes a null pointer when no gradient is needed.
//   flash: one pass with online softmax; P is cast UN-normalised and the
//          output divided by the row sum at the end, with the l == 0 guard,
//          as _flash_kernel; keys past n are masked with MASK_VALUE.
// Keys past n get -inf (fused) or MASK_VALUE (flash); query rows past n are
// computed on zeros and not stored. q, k, v are read as strided (B, N, H, D)
// views (the qkv slices of models/vit.py need no copy); out is written as
// given, contiguous (B, N, H, D) from the wrapper.
//
// The float instantiation (the f32 parity path) keeps the shared-memory
// design with scalar FMAs: tensor cores would mean TF32.
#include <cfloat>

#include "attention_tiles.cuh"

namespace {

using namespace pvpu_attn;

constexpr float MASK_VALUE = -0.7f * FLT_MAX;

template <int D, bool FLASH>
__global__ void __launch_bounds__(THREADS)
attention_fwd_bf16(Ten q, Ten k, Ten v, Ten out, float* __restrict__ stats,
                   int heads, int n, float scale) {
  constexpr int LD = D + 8, DN = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + TQ * LD;             // [STAGES][TK][LD]
  bf16* Vs = Ks + STAGES * TK * LD;    // [STAGES][TK][LD]

  const int bh = blockIdx.y, q0 = blockIdx.x * TQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, tq = lane & 3;
  const bf16* qs = slice<bf16>(q, bh, heads);
  const bf16* ks = slice<bf16>(k, bh, heads);
  const bf16* vs = slice<bf16>(v, bh, heads);
  const int nt = (n + TK - 1) / TK;
  const int steps = FLASH ? nt : 2 * nt;   // fused: nt of pass 1, nt of pass 2
  const float sl2 = scale * LOG2E;         // scores in log2 units

  auto issue = [&](int s) {                // step s's K (and V) tile
    const int t = s < nt ? s : s - nt, st = s % STAGES;
    load_rows<D>(Ks + st * TK * LD, ks, k.sn, t * TK, n);
    if (FLASH || s >= nt)
      load_rows<D>(Vs + st * TK * LD, vs, v.sn, t * TK, n);
  };
  load_rows<D>(Qs, qs, q.sn, q0, n);
  issue(0);
  cp_async_commit();

  uint32_t qf[D / 16][4];
  float o[DN][4];
#pragma unroll
  for (int i = 0; i < DN; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = 0.0f;
  // per row (g, g + 8): running max (log2 units) and this thread's share
  // of the row sum; the quad's shares are added once, after the last tile
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float il[2] = {0.0f, 0.0f};              // fused pass 2: 1 / row sum

  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) issue(s + 1);
    cp_async_commit();                     // (an empty group on the last step)
    cp_async_wait<1>();                    // step s's tiles have landed
    __syncthreads();
    if (s == 0) load_a<D>(qf, Qs + warp * 16 * LD, lane);
    const int st = s % STAGES, t = s < nt ? s : s - nt;
    float x[8][4];
    mma_abt<D>(x, qf, Ks + st * TK * LD, lane);
    const bool ragged = (t + 1) * TK > n;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        x[i][j] *= sl2;
        if (ragged && t * TK + i * 8 + 2 * tq + (j & 1) >= n)
          x[i][j] = FLASH ? MASK_VALUE : -INFINITY;
      }
    if (!FLASH && s < nt) {                // fused pass 1: (m, l) only
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[r];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          mx = fmaxf(mx, fmaxf(x[i][2 * r], x[i][2 * r + 1]));
        mx = quad_max(mx);
        float sum = 0.0f;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          sum += ex2(x[i][2 * r] - mx) + ex2(x[i][2 * r + 1] - mx);
        l[r] = l[r] * ex2(m[r] - mx) + sum;
        m[r] = mx;
      }
      __syncthreads();
      continue;
    }
    if (FLASH) {                           // online softmax, P un-normalised
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[r];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          mx = fmaxf(mx, fmaxf(x[i][2 * r], x[i][2 * r + 1]));
        mx = quad_max(mx);
        const float alpha = ex2(m[r] - mx);
        m[r] = mx;
        float sum = 0.0f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          x[i][2 * r] = ex2(x[i][2 * r] - mx);
          x[i][2 * r + 1] = ex2(x[i][2 * r + 1] - mx);
          sum += x[i][2 * r] + x[i][2 * r + 1];
        }
        l[r] = alpha * l[r] + sum;
#pragma unroll
        for (int i = 0; i < DN; ++i) {
          o[i][2 * r] *= alpha;
          o[i][2 * r + 1] *= alpha;
        }
      }
    } else {                               // fused pass 2: P normalised
      if (s == nt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l[r] = quad_sum(l[r]);
          il[r] = 1.0f / l[r];
        }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          x[i][j] = ex2(x[i][j] - m[j >> 1]) * il[j >> 1];
    }
    uint32_t pa[4][4];
    to_a(pa, x);
    mma_ab<D>(o, pa, Vs + st * TK * LD, lane);
    __syncthreads();                       // stage st is refilled next step
  }

  const int row0 = q0 + warp * 16;
  float mul[2] = {1.0f, 1.0f};
  if (FLASH)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = quad_sum(l[r]);
      mul[r] = l[r] == 0.0f ? 1.0f : 1.0f / l[r];
    }
  store_rows<D>(slice<bf16>(out, bh, heads), out.sn, o, row0, n, lane,
                mul[0], mul[1]);
  if (!FLASH && stats != nullptr && tq == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + (lane >> 2) + 8 * r;
      if (row < n) {
        float* st = stats + ((long long)bh * n + row) * 2;
        st[0] = m[r] * LN2;                // the max of s*scale
        st[1] = l[r];
      }
    }
}

template <bool FLASH>
__global__ void __launch_bounds__(THREADS)
attention_fwd_f32(Ten q, Ten k, Ten v, Ten out, float* __restrict__ stats,
                  int heads, int n, int D, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + TQ * D;
  float* Vs = Ks + TK * D;
  float* S = Vs + TK * D;
  float* Ps = S + TQ * TK;
  float* O = Ps + TQ * TK;
  float* m_row = O + TQ * D;
  float* l_row = m_row + TQ;

  const int bh = blockIdx.y, q0 = blockIdx.x * TQ;
  const float* qs = slice<float>(q, bh, heads);
  const float* ks = slice<float>(k, bh, heads);
  const float* vs = slice<float>(v, bh, heads);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_tiles = (n + TK - 1) / TK;

  load_tile_f32(Qs, qs, q.sn, q0, n, D);
  for (int i = threadIdx.x; i < TQ * D; i += THREADS) O[i] = 0.0f;
  if (threadIdx.x < TQ) {
    m_row[threadIdx.x] = -INFINITY;
    l_row[threadIdx.x] = 0.0f;
  }
  __syncthreads();

  if (!FLASH) {
    // pass 1: exact row max and row sum of exp(s - max)
    for (int t = 0; t < n_tiles; ++t) {
      load_tile_f32(Ks, ks, k.sn, t * TK, n, D);
      __syncthreads();
      qk_tile_f32(Qs, Ks, S, D);
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
    load_tile_f32(Ks, ks, k.sn, t * TK, n, D);
    load_tile_f32(Vs, vs, v.sn, t * TK, n, D);
    __syncthreads();
    qk_tile_f32(Qs, Ks, S, D);
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
        Ps[r * TK + lane] = p0;
        Ps[r * TK + lane + 32] = p1;
        for (int c = lane; c < D; c += 32) O[r * D + c] *= alpha;
        __syncwarp();
        if (lane == 0) {
          l_row[r] = alpha * l_row[r] + psum;
          m_row[r] = m_next;
        }
        __syncwarp();
      } else {
        const float m = m_row[r], l = l_row[r];
        Ps[r * TK + lane] = expf(s[0] - m) / l;
        Ps[r * TK + lane + 32] = expf(s[1] - m) / l;
      }
    }
    __syncthreads();
    pv_tile_f32(Ps, Vs, O, D);
    __syncthreads();
  }

  float* os = slice<float>(out, bh, heads);
  for (int i = threadIdx.x; i < TQ * D; i += THREADS) {
    const int r = i / D;
    if (q0 + r >= n) continue;
    float o = O[i];
    if (FLASH) {
      const float l = l_row[r];
      o *= (l == 0.0f) ? 1.0f : 1.0f / l;
    }
    os[(q0 + r) * out.sn + i % D] = o;
  }
  if (!FLASH && stats != nullptr && threadIdx.x < TQ &&
      q0 + threadIdx.x < n) {
    float* st = stats + ((long long)bh * n + q0 + threadIdx.x) * 2;
    st[0] = m_row[threadIdx.x];
    st[1] = l_row[threadIdx.x];
  }
}

template <int D, bool FLASH>
int launch_bf16(const Ten& q, const Ten& k, const Ten& v, const Ten& out,
                float* stats, int bh, int heads, int n, float scale,
                cudaStream_t stream) {
  constexpr int smem = (TQ + 2 * STAGES * TK) * (D + 8) * (int)sizeof(bf16);
  static const cudaError_t attr = cudaFuncSetAttribute(
      attention_fwd_bf16<D, FLASH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);   // once
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((n + TQ - 1) / TQ, bh);
  attention_fwd_bf16<D, FLASH><<<grid, THREADS, smem, stream>>>(
      q, k, v, out, stats, heads, n, scale);
  return (int)cudaGetLastError();
}

size_t smem_f32(int D) {
  return sizeof(float) * (2 * TQ * D + 2 * TK * D + 2 * TQ * TK + 2 * TQ);
}

template <bool FLASH>
int launch_f32(const Ten& q, const Ten& k, const Ten& v, const Ten& out,
               float* stats, int bh, int heads, int n, int D, float scale,
               cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      attention_fwd_f32<FLASH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_f32(128));                 // once, for the largest D
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((n + TQ - 1) / TQ, bh);
  attention_fwd_f32<FLASH><<<grid, THREADS, smem_f32(D), stream>>>(
      q, k, v, out, stats, heads, n, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, out: strided (batch, n, heads, D) tensors (Ten); stats: null, or
// (batch*heads, n, 2) f32 for the fused entry's per-row (max of s*scale,
// sum of exp(s*scale - max)). dtype: 0 = float32, 1 = bfloat16; flash: 0 =
// fused entry, 1 = flash entry. D % 16 == 0, D <= 128, rows 16-byte
// aligned (checked by the Python wrapper).
extern "C" int pvpu_attention_fwd(Ten q, Ten k, Ten v, Ten out, void* stats,
                                  int batch, int heads, int n, int D,
                                  float scale, int dtype, int flash,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  float* st = flash ? nullptr : (float*)stats;
  const int bh = batch * heads;
  if (dtype == 0)
    return flash ? launch_f32<true>(q, k, v, out, st, bh, heads, n, D, scale, s)
                 : launch_f32<false>(q, k, v, out, st, bh, heads, n, D, scale,
                                     s);
#define PVPU_FWD(DD)                                                        \
  return flash ? launch_bf16<DD, true>(q, k, v, out, st, bh, heads, n,      \
                                       scale, s)                            \
               : launch_bf16<DD, false>(q, k, v, out, st, bh, heads, n,     \
                                        scale, s)
  PVPU_SWITCH_D(D, PVPU_FWD)
#undef PVPU_FWD
}
