// EDT min-plus row pass: D[r, c] = min_{c'} f[r, c'] + (c - c')^2.
//
// Replaces pvpuformer_tpu/ops/edt_pallas.py:_minplus_kernel (minplus_rows).
// Bound on the H100: integer-valued f32 ALU work, W^2 min-adds per row
// (896 x 448^2 = 1.8e8 at the 448^2 click canvas); the bytes are only 2 x 1.6 MB.
// Design: a block stages ROWS rows of f in shared memory and each thread
// owns output columns, looping over c' with the row value broadcast to the
// whole warp (no bank conflicts). Every value is an exact integer below 2^24,
// so the result is bit-identical to the plain version whatever the order.
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 4;
constexpr int THREADS = 256;

__global__ void minplus_rows_kernel(const float* __restrict__ f,
                                    float* __restrict__ out, int rows, int w) {
  extern __shared__ float tile[];  // ROWS x w
  const int r0 = blockIdx.x * ROWS;
  const int nr = min(ROWS, rows - r0);
  for (int i = threadIdx.x; i < nr * w; i += blockDim.x)
    tile[i] = f[(size_t)r0 * w + i];
  __syncthreads();
  for (int r = 0; r < nr; ++r) {
    const float* row = tile + r * w;
    for (int c = threadIdx.x; c < w; c += blockDim.x) {
      float best = 3.4e38f;
      for (int cp = 0; cp < w; ++cp) {
        const float d = (float)(c - cp);
        best = fminf(best, row[cp] + d * d);
      }
      out[(size_t)(r0 + r) * w + c] = best;
    }
  }
}

}  // namespace

extern "C" int pvpu_minplus_rows(const void* f, void* out, int rows, int w,
                                 void* stream) {
  const int blocks = (rows + ROWS - 1) / ROWS;
  const size_t smem = sizeof(float) * ROWS * w;
  static bool attr_set = false;
  if (!attr_set) {
    cudaFuncSetAttribute(minplus_rows_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         ROWS * 8192 * (int)sizeof(float));
    attr_set = true;
  }
  minplus_rows_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)f, (float*)out, rows, w);
  return (int)cudaGetLastError();
}
