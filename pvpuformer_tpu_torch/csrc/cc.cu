// 8-connected component flooding: cc_labels and component_max.
//
// Replaces pvpuformer_tpu/ops/cc_pallas.py:_cc_kernel (cc_labels_pallas) and
// _prop_kernel (component_max_pallas). Both run exactly `iters` rounds of the
// flood of cc_pallas.py:_flood; one round is
//   1. the 3x3 max-pool of the labels, masked;
//   2. the segmented run-max along each row, both directions (reset = !mask);
//   3. the segmented run-max along each column, both directions;
//   4. the result masked again.
// Labels start at the flat index r * W + c + 1 (cc_labels) or at the given
// non-negative values (component_max), 0 outside the mask.
//
// Bound on the H100: the work is int32 max / select on the CUDA cores (the
// Pallas CostEstimate counts 60 per pixel per round, 0.19 G at 8 rounds of
// (2, 448, 448)); the bytes are the mask in and the labels out, 2 MB. The
// TPU kernel holds a whole padded mask in VMEM for all rounds; 227 KB of
// shared memory cannot, and one block per image would use 2 of 132 SMs.
// Design: labels ping-pong between the output and a scratch buffer in
// device memory (1.6 MB at the path shape, L2-resident). A round is two
// launches of one pass kernel: the row pass (block = 8 rows, swept in
// chunks of 128 columns) takes the masked 3x3 max-pool of the previous
// labels as its input; the column pass (block = 8 columns, swept in chunks
// of 128 rows) takes the row pass's output. Inside a chunk the segmented
// run-max is log-step doubling in shared memory, as cc_pallas.py's
// _segmented_run_max; the running max carries from chunk to chunk, first
// forward, then backward. threadIdx.x always runs along the contiguous
// columns, so every load and store is coalesced (a warp covers 32 columns
// of a row in the row pass, 8 columns of 4 rows = 4 full 32-byte sectors in
// the column pass). No padding: ragged edges are masked in the kernel.
// Integer max does not depend on order, so the result is bit-identical to
// the plain version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 128;   // elements along the scan axis per sweep step
constexpr int ACROSS = 8;    // lines (rows or columns) per block

enum Start { FROM_LABELS = 0, FROM_INDEX = 1, FROM_VALUES = 2 };

// The labels a round starts from: the previous round's output (already
// masked), or, in the first round, the initial labels.
template <int START>
__device__ __forceinline__ int start_label(const uint8_t* __restrict__ mask,
                                           const int* __restrict__ src,
                                           size_t i, int r, int c, int w) {
  if (START == FROM_LABELS) return src[i];
  if (!mask[i]) return 0;
  return START == FROM_INDEX ? r * w + c + 1 : src[i];
}

// Element `a` of line `q` of image `img`: its value and its reset flag.
// Past the ragged edge an element is a reset with value 0.
template <int AXIS, int START>
__device__ __forceinline__ void load_elem(const uint8_t* __restrict__ mask,
                                          const int* __restrict__ src,
                                          size_t img, int h, int w, int a,
                                          int q, int& v, int& reset) {
  const int len = AXIS == 1 ? w : h, lines = AXIS == 1 ? h : w;
  v = 0;
  reset = 1;
  if (a >= len || q >= lines) return;
  const int r = AXIS == 1 ? q : a, c = AXIS == 1 ? a : q;
  const size_t i = img + (size_t)r * w + c;
  if (!mask[i]) return;
  reset = 0;
  if (AXIS == 0) {                      // column pass: the row pass's output
    v = src[i];
    return;
  }
  int m = 0;                            // row pass: masked 3x3 max-pool
  for (int rr = max(r - 1, 0); rr <= min(r + 1, h - 1); ++rr)
    for (int cc = max(c - 1, 0); cc <= min(c + 1, w - 1); ++cc)
      m = max(m, start_label<START>(mask, src, img + (size_t)rr * w + cc, rr,
                                    cc, w));
  v = m;
}

// Segmented prefix max of one chunk by log-step doubling: element a takes
// element a - dir * d unless it is a reset (a run starts there).
template <int STRIDE>
__device__ __forceinline__ void chunk_scan(int* tv, int* tr, int slot,
                                           int a_loc, int dir, int& v,
                                           int& r) {
  tv[slot] = v;
  tr[slot] = r;
  __syncthreads();
  for (int d = 1; d < CHUNK; d <<= 1) {
    const int an = a_loc - dir * d;
    int nv = v, nr = r;
    if (an >= 0 && an < CHUNK) {
      const int s = slot - dir * d * STRIDE;
      if (!r) nv = max(v, tv[s]);
      nr = r | tr[s];
    }
    __syncthreads();
    v = nv;
    r = nr;
    tv[slot] = v;
    tr[slot] = r;
    __syncthreads();
  }
}

// One segmented run-max pass along AXIS (1: rows, 0: columns) of b images.
// Block: ACROSS lines; it sweeps them in chunks of CHUNK elements.
template <int AXIS, int START>
__global__ void __launch_bounds__(CHUNK * ACROSS)
run_max_pass(const uint8_t* __restrict__ mask, const int* __restrict__ src,
             int* __restrict__ dst, int h, int w) {
  __shared__ int tv[CHUNK * ACROSS];
  __shared__ int tr[CHUNK * ACROSS];
  __shared__ int carry[ACROSS];
  constexpr int STRIDE = AXIS == 1 ? 1 : ACROSS;   // slot step along a line
  const int len = AXIS == 1 ? w : h, lines = AXIS == 1 ? h : w;
  const int tiles = (lines + ACROSS - 1) / ACROSS;
  const int b = blockIdx.x / tiles;
  const int a_loc = AXIS == 1 ? threadIdx.x : threadIdx.y;
  const int q_loc = AXIS == 1 ? threadIdx.y : threadIdx.x;
  const int q = (blockIdx.x % tiles) * ACROSS + q_loc;
  const int slot = AXIS == 1 ? q_loc * CHUNK + a_loc : a_loc * ACROSS + q_loc;
  const size_t img = (size_t)b * h * w;
  const int nchunks = (len + CHUNK - 1) / CHUNK;
  const bool in_line = q < lines;

  // forward sweep: fwd[a] = max over [run start, a]; stored in dst
  if (threadIdx.x + threadIdx.y == 0)
    for (int i = 0; i < ACROSS; ++i) carry[i] = 0;
  for (int k = 0; k < nchunks; ++k) {
    const int a = k * CHUNK + a_loc;
    int v, r;
    load_elem<AXIS, START>(mask, src, img, h, w, a, q, v, r);
    chunk_scan<STRIDE>(tv, tr, slot, a_loc, 1, v, r);
    const int fwd = r ? v : max(v, carry[q_loc]);
    if (in_line && a < len)
      dst[img + (AXIS == 1 ? (size_t)q * w + a : (size_t)a * w + q)] = fwd;
    __syncthreads();
    if (a_loc == CHUNK - 1) carry[q_loc] = fwd;
  }
  __syncthreads();
  // backward sweep: bwd[a] = max over [a, run end]; out = max(fwd, bwd)
  if (threadIdx.x + threadIdx.y == 0)
    for (int i = 0; i < ACROSS; ++i) carry[i] = 0;
  for (int k = nchunks - 1; k >= 0; --k) {
    const int a = k * CHUNK + a_loc;
    int v, r;
    load_elem<AXIS, START>(mask, src, img, h, w, a, q, v, r);
    chunk_scan<STRIDE>(tv, tr, slot, a_loc, -1, v, r);
    const int bwd = r ? v : max(v, carry[q_loc]);
    if (in_line && a < len) {
      int* o = dst + img + (AXIS == 1 ? (size_t)q * w + a : (size_t)a * w + q);
      *o = max(*o, bwd);              // this thread wrote *o in the forward sweep
    }
    __syncthreads();
    if (a_loc == 0) carry[q_loc] = bwd;
  }
}

// `iters` rounds; the first row pass reads the initial labels (START), the
// later ones the previous round's output. The result lands in `out`.
template <int START>
int flood(const uint8_t* mask, const int* values, int* out, int* scratch,
          int b, int h, int w, int iters, cudaStream_t s) {
  const dim3 row_block(CHUNK, ACROSS), col_block(ACROSS, CHUNK);
  const int row_grid = b * ((h + ACROSS - 1) / ACROSS);
  const int col_grid = b * ((w + ACROSS - 1) / ACROSS);
  for (int it = 0; it < iters; ++it) {
    if (it == 0)
      run_max_pass<1, START><<<row_grid, row_block, 0, s>>>(mask, values,
                                                            scratch, h, w);
    else
      run_max_pass<1, FROM_LABELS><<<row_grid, row_block, 0, s>>>(
          mask, out, scratch, h, w);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    run_max_pass<0, FROM_LABELS><<<col_grid, col_block, 0, s>>>(mask, scratch,
                                                                out, h, w);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pvpu_cc_labels(const void* mask, void* out, void* scratch,
                              int b, int h, int w, int iters, void* stream) {
  return flood<FROM_INDEX>((const uint8_t*)mask, nullptr, (int*)out,
                           (int*)scratch, b, h, w, iters,
                           (cudaStream_t)stream);
}

extern "C" int pvpu_component_max(const void* mask, const void* values,
                                  void* out, void* scratch, int b, int h,
                                  int w, int iters, void* stream) {
  return flood<FROM_VALUES>((const uint8_t*)mask, (const int*)values,
                            (int*)out, (int*)scratch, b, h, w, iters,
                            (cudaStream_t)stream);
}
