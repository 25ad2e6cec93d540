// K6: the type-2 positional distribution (piggy histogram), one env per
// block, one warp per vehicle row.
//
// Replaces diral_tpu/ops/pallas_kernels.py::_piggy_hist_kernel (called by
// piggy_histogram at pallas_kernels.py:77).  Per env and vehicle u, over
// u's table entries j: dx, dy from u's stored position of j to u's live
// position; d = sqrt(dx^2 + dy^2), signed by dx > 0; valid = age < 20 and
// j != u and d < R; bin = clip(floor((signed + R) * nbins / (2R)), 0,
// nbins - 1); out[u, k] = hits[k] * (1 / count)  (reference
// envs/network.py:473-513, the TPU kernel's floor rule, which agrees with
// np.histogram to within one ULP at the bin edges).
//
// What bounds it on the card: bytes.  Each env reads three N x N tables
// (120 KB at N = 100) and writes N x nbins floats, for ~10 operations per
// table entry.
//
// Design: lanes stride over a row's entries (neighbouring lanes read
// neighbouring addresses); hits are counted with integer shared-memory
// atomics in a per-warp histogram, so the counts are exact and their
// order does not matter; the count of valid entries is a warp sum.  Built
// with -fmad=false and spelled with __f*_rn so every float op rounds as
// the plain PyTorch version's separate ops do: the result is meant to
// equal piggy_histogram_plain bit for bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStale = 20;   // STALENESS_CUTOFF

__global__ void piggy_hist_kernel(
    const float* __restrict__ table_x, const float* __restrict__ table_y,
    const float* __restrict__ pos_x, const float* __restrict__ pos_y,
    const int* __restrict__ table_age, float* __restrict__ out,
    int N, int nbins, float R, float scale) {
  extern __shared__ int s_hist[];            // [kWarps][nbins]
  const int b = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int* hist = s_hist + warp * nbins;
  const size_t tab = static_cast<size_t>(b) * N * N;

  for (int u = warp; u < N; u += kWarps) {
    for (int k = lane; k < nbins; k += 32) hist[k] = 0;
    __syncwarp();
    const float pxu = pos_x[static_cast<size_t>(b) * N + u];
    const float pyu = pos_y[static_cast<size_t>(b) * N + u];
    const size_t row = tab + static_cast<size_t>(u) * N;
    int cnt = 0;
    for (int j = lane; j < N; j += 32) {
      const float dx = __fsub_rn(table_x[row + j], pxu);
      const float dy = __fsub_rn(table_y[row + j], pyu);
      const float d = sqrtf(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
      if (table_age[row + j] < kStale && j != u && d < R) {
        const float signed_d = dx > 0.0f ? d : -d;
        int idx = static_cast<int>(floorf(__fmul_rn(__fadd_rn(signed_d, R), scale)));
        idx = min(max(idx, 0), nbins - 1);
        atomicAdd(&hist[idx], 1);
        ++cnt;
      }
    }
    for (int off = 16; off > 0; off /= 2) cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
    __syncwarp();
    const float inv = cnt > 0 ? __fdiv_rn(1.0f, static_cast<float>(cnt)) : 0.0f;
    float* o = out + (static_cast<size_t>(b) * N + u) * nbins;
    for (int k = lane; k < nbins; k += 32) o[k] = __fmul_rn(static_cast<float>(hist[k]), inv);
    __syncwarp();
  }
}

}  // namespace

extern "C" const char* dtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int piggy_hist_launch(
    const float* table_x, const float* table_y, const float* pos_x,
    const float* pos_y, const int* table_age, float* out,
    int B, int N, int nbins, float R, float scale, void* stream) {
  if (B <= 0 || N <= 0 || nbins <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t shmem = static_cast<size_t>(kWarps) * nbins * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      piggy_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  piggy_hist_kernel<<<B, kThreads, shmem, static_cast<cudaStream_t>(stream)>>>(
      table_x, table_y, pos_x, pos_y, table_age, out, N, nbins, R, scale);
  return static_cast<int>(cudaGetLastError());
}
