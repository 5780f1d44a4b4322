// EDT min-plus row pass: D[r, c] = min_{c'} f[r, c'] + (c - c')^2, as an
// exact lower envelope in integer arithmetic.
//
// Replaces pvpuformer_tpu/ops/edt_pallas.py:_minplus_kernel (minplus_rows),
// which evaluates all W^2 candidates of a row (XLA cannot run the
// sequential envelope scan; a warp can).
//
// Domain and exactness. f is integer-valued f32 in [0, 2^24): the EDT's
// pass 1 gives f <= (H+1)^2. Every loaded value is checked and the kernel
// traps outside the domain (NaN and infinities included), so misuse fails
// the launch instead of returning a wrong row. Inside it, D[c] <= f[c] <
// 2^24 (the candidate c' = c), an exact integer in f32. The plain version
// (and the Pallas kernel) rounds candidates above 2^24 in f32, but rounding
// is monotone and 2^24 is representable, so no rounded candidate falls
// below D[c], and the candidate that attains D[c] is exact: the exact
// integer minimum below equals minplus_rows_plain bit for bit.
//
// Algorithm. Site c' is the point (c', Y = c'^2 + f[c']); then
// D[c] = c^2 + min_c' (Y - 2 c c'), the minimum of a linear function over
// the points, which their lower convex hull attains. One warp per row:
//  1. load the row into shared memory (coalesced, LOADS loads in flight
//     per lane) as int32, checking it;
//  2. each lane builds the lower hull of its band of ceil(W / 32) columns
//     with a monotone stack, as a list with int16 prev / next links;
//  3. five rounds merge neighbouring groups of bands (1 + 1, 2 + 2, ...,
//     16 + 16): the first lane of the left group walks the bridge between
//     the two hulls (the left tail back, the right head forward, the
//     textbook two-hull merge) and relinks; removed sites are marked dead;
//  4. each lane counts its band's survivors (a contiguous run of its band
//     hull), a warp scan gives offsets, and the survivors are compacted
//     into an array in hull order;
//  5. along the hull the candidate values of a column fall, then rise, and
//     the minimiser never moves left as the column grows: each lane finds
//     its first column's minimiser by binary search, then walks forward
//     over its band's columns;
//  6. the row leaves through shared memory, coalesced.
// Hull tests compare slopes by cross-multiplication: Y < 2^27 in int32,
// the products in int64; a candidate value (c - c')^2 + f[c'] < 2^27 in
// int32. No division, no float. Work per row is O(W): a site is pushed
// and removed at most once, a column walked once, plus 32 binary searches.
//
// Bound on the H100: the bytes, a 4-byte read and a 4-byte write per
// element (8 R W bytes at 3.35 TB/s: 0.96 us at (896, 448), 30.7 us at
// (28672, 448)); the ~20 int32 operations per element of a linear envelope
// (chip_smoke.MINPLUS_OPS) take half that at the int32 rate. The design
// keeps everything but the row's one read and one write in shared memory,
// 10 W bytes per row (4 rows a block, 2 at W = 8192).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_ROWS = 4;          // warps (rows) per block
constexpr int MAX_SMEM = 232448;     // 227 KB, the most a block may use
constexpr int LOADS = 8;             // loads in flight per lane
constexpr int16_t DEAD = -2;         // prev link of a site a merge removed
constexpr unsigned FULL = 0xffffffffu;

// Shared memory per row, 16-byte aligned: f as int32 (4 W), the prev and
// next links as int16 (2 W + 2 W, reused for the f32 output row once the
// hull is compacted), the compacted hull as int16 (2 W).
__host__ __device__ inline int row_bytes(int w) { return (10 * w + 15) & ~15; }

// q lies strictly below the segment from p to r (p < q < r): q stays on
// the lower hull. Collinear points go; they never attain a strict minimum.
__device__ __forceinline__ bool below(int p, int yp, int q, int yq, int r,
                                      int yr) {
  return (long long)(yq - yp) * (r - q) < (long long)(yr - yq) * (q - p);
}

__global__ void __launch_bounds__(32 * MAX_ROWS)
minplus_envelope_kernel(const float* __restrict__ f, float* __restrict__ out,
                        int rows, int w) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;                      // the whole warp
  unsigned char* base = smem + (size_t)(threadIdx.x >> 5) * row_bytes(w);
  int* g = reinterpret_cast<int*>(base);
  int16_t* prv = reinterpret_cast<int16_t*>(base + 4 * w);
  int16_t* nxt = prv + w;
  float* res = reinterpret_cast<float*>(base + 4 * w);   // over prv / nxt
  int16_t* hull = reinterpret_cast<int16_t*>(base + 8 * w);
  const float* src = f + (size_t)row * w;

  // 1. load (LOADS in flight per lane) and check the domain
  for (int c0 = lane; c0 < w; c0 += 32 * LOADS) {
    float v[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u)
      v[u] = c0 + 32 * u < w ? src[c0 + 32 * u] : 0.f;
    bool ok = true;
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int c = c0 + 32 * u;
      ok &= v[u] >= 0.f && v[u] < 16777216.f && v[u] == truncf(v[u]);
      if (c < w) g[c] = (int)v[u];
    }
    if (!ok) __trap();
  }
  __syncwarp();

  // 2. the lower hull of this lane's band [lo, hi); bands past W are empty
  const int band = (w + 31) >> 5;
  const int lo = lane * band, hi = min(lo + band, w);
  int head = -1, tail = -1;
  if (lo < w) {
    int top = -1, sec = -1, ytop = 0, ysec = 0;
    for (int i = lo; i < hi; ++i) {
      const int yi = i * i + g[i];
      while (sec >= 0 && !below(sec, ysec, top, ytop, i, yi)) {
        top = sec;
        ytop = ysec;
        sec = prv[top];
        if (sec >= 0) ysec = sec * sec + g[sec];
      }
      prv[i] = (int16_t)top;
      sec = top;
      ysec = ytop;
      top = i;
      ytop = yi;
    }
    for (int s = top, n = -1; s >= 0; n = s, s = prv[s]) nxt[s] = (int16_t)n;
    head = lo;
    tail = hi - 1;
  }
  __syncwarp();

  // 3. merge groups of 2^k bands; a group's head and tail always survive
  for (int span = 1; span < 32; span <<= 1) {
    const int rhead = __shfl_down_sync(FULL, head, span);
    const int rtail = __shfl_down_sync(FULL, tail, span);
    // bands fill lanes from 0 up, so a non-empty right group has a left one
    if ((lane & (2 * span - 1)) == 0 && rhead >= 0) {
      int a = tail, b = rhead;
      int ya = a * a + g[a], yb = b * b + g[b];
      for (;;) {
        const int ap = prv[a];
        if (ap >= 0) {
          const int yap = ap * ap + g[ap];
          if (!below(ap, yap, a, ya, b, yb)) {
            prv[a] = DEAD;
            a = ap;
            ya = yap;
            continue;
          }
        }
        const int bn = nxt[b];
        if (bn >= 0) {
          const int ybn = bn * bn + g[bn];
          if (!below(a, ya, b, yb, bn, ybn)) {
            prv[b] = DEAD;
            b = bn;
            yb = ybn;
            continue;
          }
        }
        break;
      }
      nxt[a] = (int16_t)b;
      prv[b] = (int16_t)a;
      tail = rtail;
    }
    const int first = lane & ~(2 * span - 1);
    head = __shfl_sync(FULL, head, first);
    tail = __shfl_sync(FULL, tail, first);
    __syncwarp();
  }

  // 4. compact the survivors: a run of the band hull, reached from lo
  int cnt = 0;
  for (int s = lo; s >= 0 && s < hi; s = nxt[s]) cnt += prv[s] != DEAD;
  int incl = cnt;
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += t;
  }
  const int n = __shfl_sync(FULL, incl, 31);
  int k = incl - cnt;
  for (int s = lo; s >= 0 && s < hi; s = nxt[s])
    if (prv[s] != DEAD) hull[k++] = (int16_t)s;
  __syncwarp();

  // 5. per column the minimum over the hull. Written as a walk nested in
  // the column loop: a flattened loop (one advance or one column per trip)
  // was miscompiled by ptxas at -O3 (CUDA 12.8, sm_90a), its next-vertex
  // load reading one vertex too far; -Xptxas -O0 gave the right rows.
  if (lo < w) {
    int l = 0, r = n - 1;         // the first site whose successor is no better
    while (l < r) {
      const int m = (l + r) >> 1;
      const int s0 = hull[m], s1 = hull[m + 1];
      const int v0 = (lo - s0) * (lo - s0) + g[s0];
      const int v1 = (lo - s1) * (lo - s1) + g[s1];
      if (v1 >= v0) r = m; else l = m + 1;
    }
    for (int c = lo; c < hi; ++c) {
      const int s = hull[l];
      int v = (c - s) * (c - s) + g[s];
      while (l + 1 < n) {
        const int s1 = hull[l + 1];
        const int v1 = (c - s1) * (c - s1) + g[s1];
        if (v1 > v) break;
        ++l;
        v = v1;
      }
      res[c] = (float)v;
    }
  }
  __syncwarp();

  // 6. store
  float* dst = out + (size_t)row * w;
  for (int c = lane; c < w; c += 32) dst[c] = res[c];
}

}  // namespace

extern "C" int pvpu_minplus_rows(const void* f, void* out, int rows, int w,
                                 void* stream) {
  const int per_row = row_bytes(w);
  const int fit = MAX_SMEM / per_row;
  const int rows_per_block = fit < MAX_ROWS ? fit : MAX_ROWS;
  static bool attr_set = false;
  if (!attr_set) {
    cudaFuncSetAttribute(minplus_envelope_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         MAX_SMEM);
    attr_set = true;
  }
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  minplus_envelope_kernel<<<blocks, 32 * rows_per_block,
                            (size_t)rows_per_block * per_row,
                            (cudaStream_t)stream>>>(
      (const float*)f, (float*)out, rows, w);
  return (int)cudaGetLastError();
}
