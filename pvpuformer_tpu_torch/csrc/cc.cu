// 8-connected component flooding: cc_labels and component_max, one launch
// per call.
//
// Replaces pvpuformer_tpu/ops/cc_pallas.py:_cc_kernel (cc_labels_pallas) and
// _prop_kernel (component_max_pallas). Both run exactly `iters` rounds of the
// flood of cc_pallas.py:_flood; one round is
//   1. the 3x3 max-pool of the labels (0 outside the image), masked;
//   2. the segmented run-max along each row, both directions (a run ends at
//      a pixel outside the mask);
//   3. the segmented run-max along each column, both directions;
//   4. the result masked again.
// Labels start at the flat index r * W + c + 1 (cc_labels) or at the given
// non-negative values (component_max), 0 outside the mask. A pixel outside
// the mask is 0 in every pass, so each pixel's result is the exact maximum
// over its run: integer max does not depend on order, and any scan that
// computes it gives the bits of the plain versions (ops/cc.py).
//
// Bound on the H100: int32 max / select on the CUDA cores, 16 per pixel per
// round for a linear scan (the separable 3x3 max-pool 4, the mask select 1,
// each axis's forward and backward segmented max with their combine 5, the
// final mask 1), at 64 integer min/max results per clock per SM on compute
// capability 9.0: 3.1 us at 8 rounds of (2, 448, 448); the bytes are the
// mask in and the labels out, 2 MB. What holds the kernel back is neither
// but latency: 2 * iters dependent phases, each a round trip to L2 and a
// short scan, with a grid barrier between them (the first version spent 16
// dependent launches per call on them).
//
// Design: one persistent cooperative grid (every block resident, sized by
// the occupancy calculator and capped by the work) runs all rounds; a round
// is a row phase and a column phase, separated by a grid barrier (2 * iters
// - 1 per call, on a self-resetting word of the caller's stream, so a CUDA
// graph can replay the launch). Labels ping-pong between `out` (column phase output) and
// `scratch` (row phase output), L2-resident at the prompt path's shape;
// data written inside the kernel is read with ld.cg (L2, never a stale L1
// line). Both phases cut a line into 32 segments and combine them by a
// segmented max-scan:
//   row phase: a block owns WARPS consecutive rows, a warp one row (lines
//     longer than 32 * ROW_E take several passes). Each warp stages its
//     label row in shared memory, coalesced, the edge warps also the rows
//     above and below the block's, so a label row is read from L2 about
//     1.25 times, not 3; the column max of three staged rows and the own
//     row's mask (as ballots) go to the warp's buffer; each lane then holds
//     ROW_E (odd: conflict-free) contiguous pooled values in registers,
//     scans them serially, and the 32 lane summaries combine in a 5-step
//     shuffle scan, forward and backward at once. The result goes back
//     through shared memory so the store is coalesced.
//   column phase: a block owns a strip of COL_W adjacent columns; thread
//     (segment s, column c) scans COL_E rows of column c serially, loads
//     coalesced across the strip (a warp reads 4 rows x 8 columns, four full
//     32-byte sectors). Segment summaries meet in shared memory, where warp c
//     combines column c's 32 segments by the same shuffle scan.
// Segment lengths are compile-time, so the load loops unroll with no guard
// and issue all their loads at once; addresses past a line's end are
// clamped into it and those pixels count as resets. A (value, reset) pair
// travels as one word, the reset flag in bit 31 (values are >= 0 wherever
// they are combined). A line longer than one pass is swept forward
// (carrying the run max into the next pass) and then backward over the
// first sweep's output, which is the run max up to the pass end.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;                     // warps per block
constexpr int THREADS = 32 * WARPS;
constexpr int ROW_E = 15;                    // pixels per lane, row phase
constexpr int ROW_SPAN = 32 * ROW_E;         // pixels per row pass
constexpr int COL_W = WARPS;                 // columns per strip
constexpr int COL_SEGS = THREADS / COL_W;    // 32 segments per column
constexpr int COL_E = 14;                    // rows per segment
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned RESET = 0x80000000u;      // reset flag of a packed pair
constexpr unsigned VALUE = 0x7fffffffu;

static_assert(COL_SEGS == 32, "a warp combines one column's segments");

enum Start { FROM_LABELS = 0, FROM_INDEX = 1, FROM_VALUES = 2 };

struct Flood {
  const uint8_t* mask;
  const int* values;
  int* out;
  int* scratch;
  unsigned* barrier;                 // this launch's grid barrier word
  int b, h, w, iters;
};

struct RowSmem {
  int rows[WARPS + 2][ROW_SPAN + 2]; // the block's label rows, halo rows and
                                     // columns included
  int buf[WARPS][ROW_SPAN + 2];      // column max (with a halo), then results
  unsigned bal[WARPS][ROW_E + 1];    // the row's mask, one ballot per 32
};

struct ColSmem {                     // rows padded to COL_W + 1 words
  unsigned fwd[COL_SEGS][COL_W + 1]; // per segment: trailing open run | reset
  unsigned bwd[COL_SEGS][COL_W + 1]; // per segment: leading open run | reset
  int cf[COL_SEGS][COL_W + 1];       // carries into each segment
  int cb[COL_SEGS][COL_W + 1];
};

// The grid barrier words, one per stream (the wrappers hand out the slots):
// arrivals in the low 16 bits (a resident grid has at most 8 blocks per SM),
// the generation in the high 16. The last block to arrive adds
// 2^16 - gridDim.x, which clears the count and opens the next generation in
// one atomic, so the word is ready for the next barrier and the next launch
// (a CUDA graph can replay the kernel). Launches on one stream run one after
// another, so no two running grids share a word. Zero when the module loads.
constexpr int BARRIERS = 1024;
__device__ unsigned g_barriers[BARRIERS];

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ void grid_sync(unsigned* word) {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned old;                          // release the block's writes,
    asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;"  // acquire
                 : "=r"(old) : "l"(word) : "memory");            // theirs
    if ((old & 0xffffu) == gridDim.x - 1) {
      asm volatile("red.release.gpu.global.add.u32 [%0], %1;"
                   :: "l"(word), "r"(0x10000u - gridDim.x) : "memory");
    } else {
      const unsigned long long t0 = global_ns();
      for (unsigned spin = 1;
           ((ld_acquire(word) ^ old) & 0xffff0000u) == 0; ++spin)
        if ((spin & 4095) == 0 && global_ns() - t0 > 10000000000ull)
          __trap();                        // a barrier that never opens
    }
  }
  __syncthreads();
}

// Segment summaries of N values (bit k of rb: pixel k is a reset, value 0):
// the packed (max of the trailing open run, any reset) and (max of the
// leading open run, any reset).
template <int N>
__device__ __forceinline__ void summarize(const int (&v)[N], unsigned rb,
                                          unsigned& fwd, unsigned& bwd) {
  int tail = 0, lead = 0;
  bool open = true;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (rb >> k & 1) {
      tail = 0;
      open = false;
    } else {
      tail = max(tail, v[k]);
      if (open) lead = max(lead, v[k]);
    }
  }
  const unsigned any = rb ? RESET : 0u;
  fwd = (unsigned)tail | any;
  bwd = (unsigned)lead | any;
}

// `later` follows `earlier` in scan order: the segmented max of the two.
__device__ __forceinline__ unsigned combine(unsigned earlier, unsigned later) {
  return (later & RESET) ? later
                         : max(earlier & VALUE, later) | (earlier & RESET);
}

__device__ __forceinline__ int carry(int pass_carry, unsigned summary) {
  return (summary & RESET) ? (int)(summary & VALUE)
                           : max(pass_carry, (int)(summary & VALUE));
}

// Lane i holds segment i of a line's pass: segmented max-scans over the 32
// segments, forward and backward at once. Returns each segment's carries in
// (from the segments before / after it, and the passes before / after this
// one: pcf / pcb), and moves pcf / pcb past this pass.
__device__ __forceinline__ void warp_carries(unsigned fwd, unsigned bwd,
                                             int lane, int& pcf, int& pcb,
                                             int& cf, int& cb) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned of = __shfl_up_sync(FULL, fwd, d);
    const unsigned ob = __shfl_down_sync(FULL, bwd, d);
    if (lane >= d) fwd = combine(of, fwd);
    if (lane + d < 32) bwd = combine(ob, bwd);
  }
  unsigned ef = __shfl_up_sync(FULL, fwd, 1);
  unsigned eb = __shfl_down_sync(FULL, bwd, 1);
  if (lane == 0) ef = 0;
  if (lane == 31) eb = 0;
  cf = carry(pcf, ef);
  cb = carry(pcb, eb);
  pcf = carry(pcf, __shfl_sync(FULL, fwd, 31));
  pcb = carry(pcb, __shfl_sync(FULL, bwd, 0));
}

// Each pixel's run max: the forward scan from carry cf and the backward scan
// from carry cb, two independent chains.
template <int N>
__device__ __forceinline__ void apply(int (&v)[N], unsigned rb, int cf,
                                      int cb) {
  int fwd[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    cf = (rb >> k & 1) ? 0 : max(cf, v[k]);
    fwd[k] = cf;
  }
#pragma unroll
  for (int k = N - 1; k >= 0; --k) {
    cb = (rb >> k & 1) ? 0 : max(cb, v[k]);
    v[k] = max(fwd[k], cb);
  }
}

// The label a round starts from at (r, c) of image `img`: the previous
// round's output, or in the first round the initial labels.
template <int START>
__device__ __forceinline__ int label_at(const Flood& f, size_t img, int r,
                                        int c) {
  const size_t i = img + (size_t)r * f.w + c;
  if (START == FROM_LABELS) return __ldcg(f.out + i);
  const int v = START == FROM_INDEX ? r * f.w + c + 1 : __ldg(f.values + i);
  return __ldg(f.mask + i) ? v : 0;
}

// The labels of row `row` of the flattened (B * H) rows, clamped into
// range, at columns [c0 - 1, c0 + ROW_SPAN] (clamped into the row), loaded
// coalesced and then stored to a shared-memory slot. A clamped row or
// column repeats one that is already in the 3x3 window, and the max-pool
// pads with 0 where every label is >= 0, so the pooled max is the same.
template <int START>
struct LabelRow {
  int v[ROW_E], halo;
  __device__ __forceinline__ void load(const Flood& f, long long row, int c0,
                                       int lane) {
    const long long rows = (long long)f.b * f.h;
    row = row < 0 ? 0 : (row >= rows ? rows - 1 : row);
    const size_t img = (size_t)(row / f.h) * f.h * f.w;
    const int r = (int)(row % f.h);
#pragma unroll
    for (int j = 0; j < ROW_E; ++j)
      v[j] = label_at<START>(f, img, r, min(c0 + 32 * j + lane, f.w - 1));
    const int hc = lane == 0 ? c0 - 1 : c0 + 32 * ROW_E;  // the halo columns
    halo = label_at<START>(f, img, r, min(max(hc, 0), f.w - 1));
  }
  __device__ __forceinline__ void store(int* slot, int lane) const {
#pragma unroll
    for (int j = 0; j < ROW_E; ++j) slot[1 + 32 * j + lane] = v[j];
    if (lane < 2) slot[lane == 0 ? 0 : 32 * ROW_E + 1] = halo;
  }
};

// One pass of a row: columns [c0, c0 + 32 * ROW_E). Sweep 1 (FIRST, called by
// every warp of the block) pools the labels: each warp stages its own row,
// warps 0 and WARPS - 1 also the rows above and below the block's. Sweep 2
// re-reads sweep 1's output from scratch. The result of the pass goes to
// scratch (for an active warp).
template <int START, bool FIRST>
__device__ __forceinline__ void row_pass(const Flood& f, RowSmem& s, int wid,
                                         int lane, long long row, bool active,
                                         int c0, int& pcf, int& pcb) {
  int* buf = s.buf[wid];
  unsigned* bal = s.bal[wid];
  const size_t img = (size_t)(row / f.h) * f.h * f.w;
  const int r = (int)(row % f.h);
  const size_t line = img + (size_t)r * f.w;
  uint8_t msk[ROW_E];
  int val[ROW_E];
#pragma unroll
  for (int j = 0; j < ROW_E; ++j) {
    const int c = min(c0 + 32 * j + lane, f.w - 1);
    msk[j] = __ldg(f.mask + line + c);
    if (!FIRST) val[j] = __ldcg(f.scratch + line + c);
  }
  if (FIRST) {                             // stage the block's rows
    const bool edge = wid == 0 || wid == WARPS - 1;
    LabelRow<START> own, extra;
    own.load(f, row, c0, lane);
    if (edge) extra.load(f, wid == 0 ? row - 1 : row + 1, c0, lane);
    __syncthreads();                       // the previous pass's readers
    own.store(s.rows[wid + 1], lane);
    if (edge) extra.store(s.rows[wid == 0 ? 0 : WARPS + 1], lane);
    __syncthreads();
  }
  __syncwarp();                            // the previous pass's reads
  const int* up = s.rows[r > 0 ? wid : wid + 1];     // row r-1, or r at
  const int* mid = s.rows[wid + 1];                  // the image's edge
  const int* down = s.rows[r + 1 < f.h ? wid + 2 : wid + 1];
#pragma unroll
  for (int j = 0; j < ROW_E; ++j) {
    const bool m = msk[j] && c0 + 32 * j + lane < f.w;
    bal[j] = __ballot_sync(FULL, m);      // every lane: the same value
    const int pos = 1 + 32 * j + lane;
    if (FIRST)
      buf[pos] = max(up[pos], max(mid[pos], down[pos]));
    else
      buf[pos - 1] = val[j];
  }
  if (FIRST && lane < 2) {
    const int pos = lane == 0 ? 0 : 32 * ROW_E + 1;
    buf[pos] = max(up[pos], max(mid[pos], down[pos]));
  }
  bal[ROW_E] = 0;
  __syncwarp();
  const int p0 = lane * ROW_E;             // this lane's first pixel
  const unsigned long long bits =
      bal[p0 >> 5] | ((unsigned long long)bal[(p0 >> 5) + 1] << 32);
  const unsigned rb =
      ~(unsigned)(bits >> (p0 & 31)) & ((1u << ROW_E) - 1);
  int v[ROW_E];
#pragma unroll
  for (int k = 0; k < ROW_E; ++k)
    v[k] = FIRST ? max(buf[p0 + k], max(buf[p0 + k + 1], buf[p0 + k + 2]))
                 : buf[p0 + k];
  unsigned sf, sb;
  summarize(v, rb, sf, sb);
  int cf, cb;
  warp_carries(sf, sb, lane, pcf, pcb, cf, cb);
  apply(v, rb, cf, cb);
  __syncwarp();                            // all lanes have read buf
#pragma unroll
  for (int k = 0; k < ROW_E; ++k) buf[p0 + k] = v[k];
  __syncwarp();
#pragma unroll
  for (int j = 0; j < ROW_E; ++j) {
    const int c = c0 + 32 * j + lane;
    if (active && c < f.w) f.scratch[line + c] = buf[32 * j + lane];
  }
}

// Row phase: pooled labels -> scratch, a warp per row, a block per WARPS
// consecutive rows (the loop is the same for every warp of a block, since
// sweep 1 synchronizes the block).
template <int START>
__device__ void row_phase(const Flood& f, RowSmem& s) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int passes = (f.w + ROW_SPAN - 1) / ROW_SPAN;
  const long long rows = (long long)f.b * f.h;
  for (long long base = (long long)blockIdx.x * WARPS; base < rows;
       base += (long long)gridDim.x * WARPS) {
    const bool active = base + wid < rows;
    const long long row = active ? base + wid : rows - 1;
    int pcf = 0, pcb = 0;
    for (int p = 0; p < passes; ++p) {
      pcb = 0;                 // sweep 1 carries forward; its last pass is
      row_pass<START, true>(f, s, wid, lane, row, active, p * ROW_SPAN, pcf,
                            pcb);
    }                          // final, and pcb is its backward carry out
    for (int p = passes - 2; p >= 0 && active; --p) {
      pcf = 0;                 // sweep 2 carries backward
      row_pass<START, false>(f, s, wid, lane, row, active, p * ROW_SPAN, pcf,
                             pcb);
    }
  }
}

// One pass of a column strip: rows [a0, a0 + 32 * COL_E) of column q. Reads
// `src`, writes `out` (masked).
__device__ __forceinline__ void col_pass(const Flood& f, ColSmem& s,
                                         const int* src, size_t img, int q,
                                         int a0, int& pcf, int& pcb) {
  const int t = threadIdx.x, cl = t % COL_W, seg = t / COL_W;
  const int lane = t & 31, wid = t >> 5;
  const int first = a0 + seg * COL_E;
  int v[COL_E];
  uint8_t msk[COL_E];
  const int qc = min(q, f.w - 1);          // loads clamped into the image
#pragma unroll
  for (int k = 0; k < COL_E; ++k) {
    const size_t i = img + (size_t)min(first + k, f.h - 1) * f.w + qc;
    v[k] = __ldcg(src + i);
    msk[k] = __ldg(f.mask + i);
  }
  unsigned rb = 0;
#pragma unroll
  for (int k = 0; k < COL_E; ++k)
    rb |= (unsigned)!(msk[k] && first + k < f.h && q < f.w) << k;
  unsigned sf, sb;
  summarize(v, rb, sf, sb);
  s.fwd[seg][cl] = sf;
  s.bwd[seg][cl] = sb;
  __syncthreads();
  {                                        // warp wid: column wid's segments
    int cf, cb;
    warp_carries(s.fwd[lane][wid], s.bwd[lane][wid], lane, pcf, pcb, cf, cb);
    s.cf[lane][wid] = cf;
    s.cb[lane][wid] = cb;
  }
  __syncthreads();
  apply(v, rb, s.cf[seg][cl], s.cb[seg][cl]);
#pragma unroll
  for (int k = 0; k < COL_E; ++k) {
    const int a = first + k;
    if (a < f.h && q < f.w) f.out[img + (size_t)a * f.w + q] = v[k];
  }
}

// Column phase: scratch -> out, a block per strip of COL_W columns.
__device__ void col_phase(const Flood& f, ColSmem& s) {
  const int cl = threadIdx.x % COL_W;
  constexpr int span = COL_SEGS * COL_E;
  const int passes = (f.h + span - 1) / span;
  const int strips = (f.w + COL_W - 1) / COL_W;
  const long long all = (long long)f.b * strips;
  for (long long st = blockIdx.x; st < all; st += gridDim.x) {
    const size_t img = (size_t)(st / strips) * f.h * f.w;
    const int q = (int)(st % strips) * COL_W + cl;
    int pcf = 0, pcb = 0;      // in warp c's lanes: column c's carries
    for (int p = 0; p < passes; ++p) {
      pcb = 0;                 // as in row_phase
      col_pass(f, s, f.scratch, img, q, p * span, pcf, pcb);
    }
    for (int p = passes - 2; p >= 0; --p) {
      pcf = 0;
      col_pass(f, s, f.out, img, q, p * span, pcf, pcb);
    }
  }
}

// All rounds.
template <int START>
__global__ void __launch_bounds__(THREADS, 2) flood_kernel(Flood f) {
  __shared__ union {
    RowSmem row;
    ColSmem col;
  } s;
  for (int it = 0; it < f.iters; ++it) {
    if (it == 0)
      row_phase<START>(f, s.row);
    else
      row_phase<FROM_LABELS>(f, s.row);
    grid_sync(f.barrier);
    col_phase(f, s.col);
    if (it + 1 < f.iters) grid_sync(f.barrier);
  }
}

// Blocks per SM x SMs, per device and instantiation, asked once.
template <int START>
int resident_blocks() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, flood_kernel<START>, THREADS, 0) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
    cached[dev] = per_sm * sms;
  }
  return cached[dev];
}

// The device's barrier words, per device, asked once.
unsigned* barrier_words() {
  static unsigned* cached[64] = {nullptr};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
    return nullptr;
  if (cached[dev] == nullptr &&
      cudaGetSymbolAddress((void**)&cached[dev], g_barriers) != cudaSuccess)
    cached[dev] = nullptr;
  return cached[dev];
}

template <int START>
int flood(const uint8_t* mask, const int* values, int* out, int* scratch,
          int b, int h, int w, int iters, int slot, cudaStream_t stream) {
  if (slot < 0 || slot >= BARRIERS) return (int)cudaErrorInvalidValue;
  const int resident = resident_blocks<START>();
  if (resident <= 0) {
    const cudaError_t err = cudaGetLastError();
    return err != cudaSuccess ? (int)err : (int)cudaErrorInvalidConfiguration;
  }
  // enough blocks for every row's warp or every column strip, no more
  const long long row_blocks = ((long long)b * h + WARPS - 1) / WARPS;
  const long long col_blocks = (long long)b * ((w + COL_W - 1) / COL_W);
  const long long want = row_blocks > col_blocks ? row_blocks : col_blocks;
  unsigned* const barriers = barrier_words();
  if (barriers == nullptr) {
    const cudaError_t err = cudaGetLastError();
    return err != cudaSuccess ? (int)err : (int)cudaErrorInvalidSymbol;
  }
  const Flood f{mask, values, out, scratch, barriers + slot, b, h, w, iters};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(want < resident ? want : resident));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;   // all blocks co-resident
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, flood_kernel<START>, f);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace

// `slot` picks the grid barrier word (0 <= slot < pvpu_cc_barriers()): a
// different one for every stream that may run a CC launch concurrently.
extern "C" int pvpu_cc_barriers() { return BARRIERS; }

extern "C" int pvpu_cc_labels(const void* mask, void* out, void* scratch,
                              int b, int h, int w, int iters, int slot,
                              void* stream) {
  return flood<FROM_INDEX>((const uint8_t*)mask, nullptr, (int*)out,
                           (int*)scratch, b, h, w, iters, slot,
                           (cudaStream_t)stream);
}

extern "C" int pvpu_component_max(const void* mask, const void* values,
                                  void* out, void* scratch, int b, int h,
                                  int w, int iters, int slot, void* stream) {
  return flood<FROM_VALUES>((const uint8_t*)mask, (const int*)values,
                            (int*)out, (int*)scratch, b, h, w, iters, slot,
                            (cudaStream_t)stream);
}
