// K6: the type-2 positional distribution (piggy histogram): one warp per
// vehicle row, blocks over (env, row tile) pairs.
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
// table entry.  On the serving and training paths K5 has just written the
// tables (~2 MB at 16 x 100), so they come from the 50 MB L2, and what is
// left is latency: the kernel has to spread its rows over every SM.
//
// Design: one warp per (env, vehicle row), ``warps`` warps a block, each
// taking ``rows_per_warp`` rows of one env in turn; the grid is envs x row
// tiles, sized by ops/piggy_hist._k6_plan from the shape alone, so 16 x
// 100 rows run as 208 blocks on 132 SMs (the one-block-per-env kernel it
// replaced ran 16).  Where N % 4 == 0 (and the tables are 16-byte
// aligned) a lane loads four entries of each table with one 16-byte load:
// a row of 100 is one load a lane.  Other N load one entry a lane.  Hits
// are counted with integer shared-memory atomics in the warp's own
// histogram, so the counts are exact and their order does not matter; the
// count of valid entries is a warp sum.  One int histogram a warp stays
// within 48 KB of shared memory at every plan (nbins <= 12288), so no
// opt-in attribute is set at launch.  Built with -fmad=false and spelled
// with __f*_rn so every float op rounds as the plain PyTorch version's
// separate ops do: the result equals piggy_histogram_plain bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kStale = 20;              // STALENESS_CUTOFF
constexpr int kMaxWarps = 8;            // ops/piggy_hist.MAX_WARPS
constexpr int kSmemLimit = 48 * 1024;   // ops/piggy_hist.SMEM_LIMIT

// Counts table entry j of vehicle u's row into the warp's histogram.
__device__ __forceinline__ void count_entry(
    float tx, float ty, int age, int j, int u, float pxu, float pyu, float R,
    float scale, int nbins, int* hist, int& cnt) {
  const float dx = __fsub_rn(tx, pxu);
  const float dy = __fsub_rn(ty, pyu);
  const float d = sqrtf(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
  if (age < kStale && j != u && d < R) {
    const float signed_d = dx > 0.0f ? d : -d;
    int idx = static_cast<int>(floorf(__fmul_rn(__fadd_rn(signed_d, R), scale)));
    idx = min(max(idx, 0), nbins - 1);
    atomicAdd(&hist[idx], 1);
    ++cnt;
  }
}

// VEC: table entries a lane loads at once (4: one 16-byte load a table).
template <int VEC>
__global__ void piggy_hist_kernel(
    const float* __restrict__ table_x, const float* __restrict__ table_y,
    const float* __restrict__ pos_x, const float* __restrict__ pos_y,
    const int* __restrict__ table_age, float* __restrict__ out,
    int N, int nbins, float R, float scale, int tiles, int rows_per_warp) {
  extern __shared__ int s_hist[];            // [warps][nbins]
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x - b * tiles;
  int* hist = s_hist + warp * nbins;

  for (int k = 0; k < rows_per_warp; ++k) {
    const int u = (tile * rows_per_warp + k) * warps + warp;
    if (u >= N) break;                       // the same for the whole warp
    for (int i = lane; i < nbins; i += 32) hist[i] = 0;
    __syncwarp();
    const size_t r = static_cast<size_t>(b) * N + u;
    const float pxu = pos_x[r], pyu = pos_y[r];
    const size_t row = r * N;
    int cnt = 0;
    if (VEC == 4) {
      const float4* x4 = reinterpret_cast<const float4*>(table_x + row);
      const float4* y4 = reinterpret_cast<const float4*>(table_y + row);
      const int4* a4 = reinterpret_cast<const int4*>(table_age + row);
      for (int q = lane; q < N / 4; q += 32) {
        const float4 x = __ldg(x4 + q), y = __ldg(y4 + q);
        const int4 a = __ldg(a4 + q);
        const int j = 4 * q;
        count_entry(x.x, y.x, a.x, j, u, pxu, pyu, R, scale, nbins, hist, cnt);
        count_entry(x.y, y.y, a.y, j + 1, u, pxu, pyu, R, scale, nbins, hist, cnt);
        count_entry(x.z, y.z, a.z, j + 2, u, pxu, pyu, R, scale, nbins, hist, cnt);
        count_entry(x.w, y.w, a.w, j + 3, u, pxu, pyu, R, scale, nbins, hist, cnt);
      }
    } else {
      for (int j = lane; j < N; j += 32)
        count_entry(__ldg(table_x + row + j), __ldg(table_y + row + j),
                    __ldg(table_age + row + j), j, u, pxu, pyu, R, scale,
                    nbins, hist, cnt);
    }
    cnt = __reduce_add_sync(0xffffffffu, cnt);
    __syncwarp();
    const float inv = cnt > 0 ? __fdiv_rn(1.0f, static_cast<float>(cnt)) : 0.0f;
    float* o = out + r * nbins;
    for (int i = lane; i < nbins; i += 32) o[i] = __fmul_rn(static_cast<float>(hist[i]), inv);
    __syncwarp();
  }
}

// The launch floor: an empty kernel behind a C entry that takes K6's
// argument list, so its time through ops/_build.launch is the least any
// wrapper on that path can take.
__global__ void noop_kernel() {}

}  // namespace

extern "C" const char* dtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// warps, rows_per_warp, vec: the plan of ops/piggy_hist._k6_plan(B, N,
// nbins); the row tiles and the shared bytes follow from them.  vec = 4
// falls back to one-entry loads where a table is not 16-byte aligned.
extern "C" int piggy_hist_launch(
    const float* table_x, const float* table_y, const float* pos_x,
    const float* pos_y, const int* table_age, float* out,
    int B, int N, int nbins, float R, float scale, int warps,
    int rows_per_warp, int vec, void* stream) {
  if (B <= 0 || N <= 0 || nbins <= 0 || warps < 1 || warps > kMaxWarps ||
      rows_per_warp < 1 || (vec != 1 && vec != 4) || (vec == 4 && N % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = static_cast<long long>(warps) * nbins * sizeof(int);
  const long long per_block = static_cast<long long>(warps) * rows_per_warp;
  const long long tiles = (N + per_block - 1) / per_block;
  const long long grid = static_cast<long long>(B) * tiles;
  if (smem > kSmemLimit || grid > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = ((reinterpret_cast<uintptr_t>(table_x) |
                         reinterpret_cast<uintptr_t>(table_y) |
                         reinterpret_cast<uintptr_t>(table_age)) & 15) == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4 && aligned)
    piggy_hist_kernel<4><<<static_cast<unsigned>(grid), 32 * warps, smem, s>>>(
        table_x, table_y, pos_x, pos_y, table_age, out, N, nbins, R, scale,
        static_cast<int>(tiles), rows_per_warp);
  else
    piggy_hist_kernel<1><<<static_cast<unsigned>(grid), 32 * warps, smem, s>>>(
        table_x, table_y, pos_x, pos_y, table_age, out, N, nbins, R, scale,
        static_cast<int>(tiles), rows_per_warp);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dtt_noop_launch(
    const float*, const float*, const float*, const float*, const int*,
    float*, int, int, int, float, float, int, int, int, void* stream) {
  noop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
