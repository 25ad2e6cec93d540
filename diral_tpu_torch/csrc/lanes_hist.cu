// K7: the exact batched piggy type-2 count histogram for small N (N*N <=
// 128), one thread per (env, vehicle row, bin).
//
// Replaces diral_tpu/ops/pallas_kernels.py::_lanes_hist_kernel (called by
// piggy_histogram_lanes at pallas_kernels.py:188).  Per env b and vehicle
// u, over u's N table entries j: hist[b, u, k] = #{j : valid[b, u, j] and
// edges[k] <= signed[b, u, j] < edges[k+1]} (the last bin right-closed:
// signed <= edges[nbins]), cnt[b, u] = #{j : valid[b, u, j]}.  That is
// np.histogram's membership against the exact np.linspace edges
// (ops/histogram.bin_membership), so out-of-range values and invalid
// entries count nowhere; the counts are integers stored as float32, equal
// to the plain version bit for bit.  The division by the count stays
// outside (envs/v2v_env.py).
//
// What bounds it on the card: bytes.  Per env it reads N*N floats and N*N
// validity bytes and writes N*(nbins + 1) floats, for a few compares per
// (entry, bin): at the PPO shape (16 envs, N = 6, 20 bins) that is ~10 KB,
// so a launch costs its launch latency, not its work.
//
// Design: the TPU kernel packs 128 // (N*N) envs into the 128 lanes and
// reduces the neighbour axis with a 0/1 selection matmul on the MXU; both
// are layout devices of the TPU.  Here each thread owns one output count:
// neighbouring threads take neighbouring bins of one row (coalesced
// stores), read the row's <= 11 entries through the read-only cache, and
// compare them against the two edges of their bin.  The edges are the
// host's np.linspace values, passed by value as a kernel argument (no
// recomputation as lo + k*step, which would move values that sit exactly
// on an edge).  Only compares and integer adds: no rounding anywhere.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBins = 128;

struct Edges {
  float v[kMaxBins + 1];
};

__global__ void lanes_hist_kernel(
    const float* __restrict__ signed_d, const unsigned char* __restrict__ valid,
    float* __restrict__ hist, float* __restrict__ cnt, const Edges edges,
    int B, int N, int nbins) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long total = static_cast<long long>(B) * N * nbins;
  if (i >= total) return;
  const int k = static_cast<int>(i % nbins);
  const long long row = i / nbins;                 // b * N + u
  const float* s = signed_d + row * N;             // [b, u, :] of [B, N*N]
  const unsigned char* v = valid + row * N;
  const float lo = edges.v[k];
  const float hi = edges.v[k + 1];
  const bool last = k == nbins - 1;
  int hits = 0, n_valid = 0;
  for (int j = 0; j < N; ++j) {
    const float x = __ldg(s + j);
    const bool ok = __ldg(v + j) != 0;
    const bool below_hi = last ? (x <= hi) : (x < hi);
    hits += (ok && x >= lo && below_hi) ? 1 : 0;
    n_valid += ok ? 1 : 0;
  }
  hist[i] = static_cast<float>(hits);
  if (k == 0) cnt[row] = static_cast<float>(n_valid);
}

}  // namespace

extern "C" const char* dtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// edges_host: nbins + 1 float32 values in host memory, copied into the
// launch's argument block.
extern "C" int lanes_hist_launch(
    const float* signed_d, const unsigned char* valid, float* hist,
    float* cnt, const float* edges_host, int B, int N, int nbins,
    void* stream) {
  if (B <= 0 || N <= 0 || N * N > 128 || nbins <= 0 || nbins > kMaxBins)
    return static_cast<int>(cudaErrorInvalidValue);
  Edges edges;
  for (int k = 0; k <= nbins; ++k) edges.v[k] = edges_host[k];
  const long long total = static_cast<long long>(B) * N * nbins;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  lanes_hist_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      signed_d, valid, hist, cnt, edges, B, N, nbins);
  return static_cast<int>(cudaGetLastError());
}
