// K5: the per-channel walk of step_channel, one env per block.
//
// Replaces diral_tpu/ops/pallas_step.py::_channel_phase_kernel (called by
// channel_phase at pallas_step.py:181).  Semantics are those of the
// canonical loop diral_tpu/envs/v2v_env.py:522-566 (reference
// envs/test_env.py:351-443): per channel, closest in-range transmitter
// per receiver (first-occurrence argmin), PRR -> reward designs 2/3/4,
// half-duplex obs column, last_arrival bookkeeping, and the seq-gated
// merge of the accepted transmitter's LIVE table row.
//
// What bounds it on the card: neither bytes nor operations.  One step
// moves ~80 KB of tables per env at N = 100 and does well under a
// million simple operations per env; the walk is a chain of C channels,
// each ending at a block-wide barrier, so the time is C x (barrier +
// one pass over an N x N tile) latency, with one block per env.
//
// Design: the distance matrix (N*N floats, 40 KB at N = 100) is computed
// once into shared memory; the five tables stay in global memory (the
// kernel copies them to the outputs, then walks the outputs in place) and
// live in L1/L2 between channels.  Per channel: phase A, one thread per
// receiver, finds the closest transmitter; barrier; phase B updates
// rewards, last_arrival and the merged rows with the block's threads
// strided over the N*N entries; barrier.  In phase B a receiver's row is
// written and only transmitters' rows are read, and a channel's
// transmitters are never its receivers, so no entry is both read and
// written by different threads.  table_seq is gathered as an integer
// (no 2^24 limit, unlike the TPU kernel's float32 one-hot matmul), and
// last_arrival keeps its [tx, rx] layout.
//
// Numerics: built with -fmad=false, and the distance is spelled with
// __fmul_rn/__fadd_rn, so every float op rounds as eager PyTorch's
// separate ops do; sqrtf, expf and '/' are the IEEE-rounded ones.  The
// result is meant to equal channel_phase_plain bit for bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNoTx = 100000.0f;   // NO_TX_DIST
constexpr int kThreads = 256;

__global__ void channel_phase_kernel(
    const float* __restrict__ pos_x, const float* __restrict__ pos_y,
    const int* __restrict__ actions,
    const float* __restrict__ tx_in, const float* __restrict__ ty_in,
    const int* __restrict__ ts_in, const int* __restrict__ ta_in,
    const int* __restrict__ la_in,
    float* tx, float* ty, int* ts, int* ta, int* la,
    float* __restrict__ rews, float* __restrict__ obs,
    int N, int C, int t_slot, float R, int design, int merge) {
  extern __shared__ unsigned char smem[];
  float* D = reinterpret_cast<float*>(smem);            // [N * N]
  int* s_act = reinterpret_cast<int*>(D + N * N);       // [N]
  int* s_cid = s_act + N;                               // [N]
  int* s_cnt = s_cid + N;                               // [C]
  unsigned char* s_tx = reinterpret_cast<unsigned char*>(s_cnt + C);  // [N]
  unsigned char* s_inv = s_tx + N;                      // [N] invoked
  unsigned char* s_acc = s_inv + N;                     // [N] invoked & has

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int NN = N * N;
  const size_t tab = static_cast<size_t>(b) * NN;
  const float* px = pos_x + static_cast<size_t>(b) * N;
  const float* py = pos_y + static_cast<size_t>(b) * N;
  tx += tab; ty += tab; ts += tab; ta += tab; la += tab;
  rews += static_cast<size_t>(b) * N;
  obs += static_cast<size_t>(b) * N * C;

  for (int k = tid; k < NN; k += blockDim.x) {
    tx[k] = tx_in[tab + k];
    ty[k] = ty_in[tab + k];
    ts[k] = ts_in[tab + k];
    ta[k] = ta_in[tab + k];
    la[k] = la_in[tab + k];
    const int i = k / N, j = k % N;
    const float dx = __fsub_rn(px[i], px[j]);
    const float dy = __fsub_rn(py[i], py[j]);
    D[k] = sqrtf(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
  }
  for (int k = tid; k < N * C; k += blockDim.x) obs[k] = 0.0f;
  for (int c = tid; c < C; c += blockDim.x) s_cnt[c] = 0;
  __syncthreads();
  for (int r = tid; r < N; r += blockDim.x) {
    const int a = actions[static_cast<size_t>(b) * N + r];
    s_act[r] = a;
    rews[r] = 0.0f;
    if (a >= 0 && a < C) atomicAdd(&s_cnt[a], 1);
  }
  __syncthreads();

  for (int ch = 0; ch < C; ++ch) {
    const int tot = s_cnt[ch];
    if (tot == 0) continue;   // uniform across the block: nothing happens

    // phase A: closest in-range transmitter per receiver
    for (int r = tid; r < N; r += blockDim.x) {
      const bool txr = s_act[r] == ch;
      float best = kNoTx;
      int best_i = 0;
      const float* Dr = D + r * N;
      for (int t = 0; t < N; ++t) {
        const float d = Dr[t];
        const float cand = (s_act[t] == ch && d < R) ? d : kNoTx;
        if (cand < best) { best = cand; best_i = t; }
      }
      s_tx[r] = txr;
      s_inv[r] = !txr;
      s_cid[r] = best_i;
      s_acc[r] = (!txr) && best < kNoTx;
      obs[r * C + ch] = txr ? 0.0f : 1.0f;
    }
    __syncthreads();

    // phase B.1: PRR and reward of each transmitter
    for (int u = tid; u < N; u += blockDim.x) {
      if (!s_tx[u]) continue;
      int in_range = 0, received = 0;
      const float* Du = D + u * N;
      for (int rx = 0; rx < N; ++rx) {
        if (!s_tx[rx] && Du[rx] < R) {
          ++in_range;
          // has[rx] is true for every non-transmitter with in-range tx
          if (s_acc[rx] && s_cid[rx] == u) ++received;
        }
      }
      const float prr = in_range > 0
          ? __fdiv_rn(static_cast<float>(received), static_cast<float>(in_range))
          : 1.0f;
      float r_coll, r_solo;
      if (design == 3) {
        r_coll = __fsub_rn(1.0f, expf(__fsub_rn(1.0f, prr)));
        r_solo = 1.0f;
      } else if (design == 4) {
        r_coll = -expf(__fsub_rn(1.0f, prr));
        r_solo = 2.718281828459045f;
      } else {
        r_coll = -__fsub_rn(1.0f, prr);
        r_solo = 1.0f;
      }
      rews[u] = tot > 1 ? r_coll : r_solo;
    }

    // phase B.2: last_arrival [tx, rx] and the merge of receiver rows
    for (int k = tid; k < NN; k += blockDim.x) {
      const int i = k / N, j = k % N;
      // last_arrival: i = transmitter, j = receiver
      if (s_tx[i] && s_inv[j] && D[k] >= R) la[k] = -1;
      if (s_acc[j] && s_cid[j] == i) la[k] = t_slot;
      // merge: i = receiver row, j = entry
      if (merge && s_acc[i]) {
        const int src = s_cid[i] * N + j;
        const int s = ts[src];
        if (s > ts[k]) {
          ts[k] = s;
          tx[k] = tx[src];
          ty[k] = ty[src];
          ta[k] = 0;
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" const char* dtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int channel_phase_launch(
    const float* pos_x, const float* pos_y, const int* actions,
    const float* tx_in, const float* ty_in, const int* ts_in,
    const int* ta_in, const int* la_in,
    float* tx, float* ty, int* ts, int* ta, int* la,
    float* rews, float* obs,
    int B, int N, int C, int t_slot, float R, int design, int merge,
    void* stream) {
  if (B <= 0 || N <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t shmem = static_cast<size_t>(N) * N * sizeof(float)
      + (2 * static_cast<size_t>(N) + C) * sizeof(int) + 3 * static_cast<size_t>(N);
  cudaError_t err = cudaFuncSetAttribute(
      channel_phase_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  channel_phase_kernel<<<B, kThreads, shmem, static_cast<cudaStream_t>(stream)>>>(
      pos_x, pos_y, actions, tx_in, ty_in, ts_in, ta_in, la_in,
      tx, ty, ts, ta, la, rews, obs, N, C, t_slot, R, design, merge);
  return static_cast<int>(cudaGetLastError());
}
