// K5: the channel walk of step_channel, in two passes.
//
// Replaces diral_tpu/ops/pallas_step.py::_channel_phase_kernel (its
// pallas_call at pallas_step.py:211).  Semantics are those of the
// canonical loop diral_tpu/envs/v2v_env.py:522-566 (reference
// envs/test_env.py:351-443): per channel, closest in-range transmitter
// per receiver (first-occurrence argmin), PRR -> reward designs 2/3/4,
// half-duplex obs column, last_arrival bookkeeping, and the seq-gated
// merge of the accepted transmitter's LIVE table row.
//
// Only the merge is sequential over channels.  Which transmitter a
// receiver accepts on a channel depends on positions and that channel's
// transmitter set alone, and so do PRR, rewards, the obs column and
// last_arrival: reward u and row u of last_arrival ([tx, rx]) are
// written on channel actions[u] only.  The merge of entry (i, j) reads
// entry (src, j) of the live tables, so each column j is an independent
// chain of the accepted pairs in channel order.  Two passes follow:
//
// * accept (one block per env): distances in range as bitmasks, each active channel's transmitters as a bitmask walked in
//   ascending id, the nearest in-range transmitter of every (active
//   channel, receiver), then rewards, obs and last_arrival, and the
//   env's accepted (receiver, source) pairs in channel order with
//   per-channel offsets into scratch.  Five block barriers in all.
// * merge (one block of 32 warps per env and slice of 32 columns; lanes
//   are columns): the slice of table_x/y/seq in shared memory, loaded
//   once; the pair list walked in channel order, a warp per pair (a
//   channel's pairs write disjoint rows and read rows none of them
//   writes: its transmitters are never its receivers), one barrier per
//   channel with pairs; the slice written out once.  A merge only takes a strictly newer seq, so
//   an entry was merged iff its seq grew, and table_age is zeroed there.
//
// The tables cross device memory once in and once out.  What bounds it
// on the card is neither bytes (~3.2 MB a call at 16 envs x N = 100) nor
// operations, but latency: each merge block walks its env's whole pair
// list (~1,800 pairs in ~43 channels at N = 100, C = 50: a few dependent
// shared-memory accesses a pair, a barrier a channel), and the accept
// pass is a chain of five dependent stages on one block per env.
//
// table_seq is gathered as an integer (no 2^24 limit, unlike the TPU
// kernel's float32 one-hot matmul).  User ids are packed in 8 bits (the
// pair list, the accepted-source table), so N <= 255.
//
// Numerics: built with -fmad=false, and the distance is spelled with
// __fsub_rn/__fmul_rn/__fadd_rn, so every float op rounds as eager
// PyTorch's separate ops do; sqrtf, expf and __fdiv_rn are the
// IEEE-rounded ones.  The result equals channel_phase_plain bit for bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNoTx = 100000.0f;   // NO_TX_DIST
constexpr int kMaxUsers = 255;       // ids in 8 bits, 0xff = none
constexpr unsigned char kNone = 0xff;
constexpr int kWidth = 32;           // merge: columns per block, one a lane
constexpr int kMergeWarps = 32;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline int words(int N) { return (N + 31) / 32; }

// shared bytes of each pass; ops/channel_phase.py::_k5_plan computes the
// same numbers and the launcher refuses a plan that disagrees
__host__ __device__ inline size_t accept_smem(int N) {
  const size_t n = static_cast<size_t>(N);
  return 4 * (9 * n + 2) + 8 * n * words(N) + n * n;
}

__host__ __device__ inline size_t merge_smem(int N) {
  const size_t n = static_cast<size_t>(N);
  return 12 * n * kWidth + 4 * (n + 1) + 2 * n * n;
}

__device__ __forceinline__ float dist(const float* px, const float* py,
                                      int i, int j) {
  const float dx = __fsub_rn(px[i], px[j]);
  const float dy = __fsub_rn(py[i], py[j]);
  return sqrtf(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
}

__global__ void __launch_bounds__(1024) channel_phase_accept_kernel(
    const float* __restrict__ pos_x, const float* __restrict__ pos_y,
    const int* __restrict__ actions, const int* __restrict__ la_in,
    int* __restrict__ la, float* __restrict__ rews, float* __restrict__ obs,
    unsigned short* __restrict__ pairs, int* __restrict__ meta,
    int N, int C, int t_slot, float R, int design, int merge) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int w32 = words(N);
  float* px = reinterpret_cast<float*>(smem);            // [N]
  float* py = px + N;                                     // [N]
  int* act = reinterpret_cast<int*>(py + N);              // [N] -1: none
  int* first = act + N;                                   // [N]
  int* kof = first + N;                                   // [N] rank of act
  int* chan = kof + N;                                    // [N] rank -> ch
  int* recv = chan + N;                                   // [N]
  int* cnt = recv + N;                                    // [N] pairs a rank
  int* off = cnt + N;                                     // [N + 1]
  int* nk = off + N + 1;                                  // [1]
  unsigned* txm = reinterpret_cast<unsigned*>(nk + 1);    // [N][w32]
  unsigned* inr = txm + N * w32;                          // [N][w32]
  unsigned char* res = reinterpret_cast<unsigned char*>(inr + N * w32);
                                                          // [N][N] src

  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int NN = N * N;
  pos_x += static_cast<size_t>(b) * N;
  pos_y += static_cast<size_t>(b) * N;
  actions += static_cast<size_t>(b) * N;
  la_in += static_cast<size_t>(b) * NN;
  la += static_cast<size_t>(b) * NN;
  rews += static_cast<size_t>(b) * N;
  obs += static_cast<size_t>(b) * N * C;
  pairs += static_cast<size_t>(b) * NN;
  meta += static_cast<size_t>(b) * (N + 2);

  if (tid == 0) *nk = 0;
  for (int u = tid; u < N; u += nt) {
    px[u] = pos_x[u];
    py[u] = pos_y[u];
    const int a = actions[u];
    act[u] = (a >= 0 && a < C) ? a : -1;   // outside [0, C): no channel
    recv[u] = 0;
    cnt[u] = 0;
  }
  for (int k = tid; k < N * w32; k += nt) txm[k] = 0;
  for (size_t k = tid; k < static_cast<size_t>(N) * C; k += nt) obs[k] = 0.0f;
  __syncthreads();

  // the active channels in ascending order: the lowest user of each
  for (int u = tid; u < N; u += nt) {
    const int a = act[u];
    bool f = a >= 0;
    for (int w = 0; w < u; ++w) f &= act[w] != a;
    first[u] = f;
    if (f) atomicAdd(nk, 1);
  }
  __syncthreads();
  const int K = *nk;

  for (int u = tid; u < N; u += nt) {
    const int a = act[u];
    int rank = -1;
    if (a >= 0) {
      rank = 0;
      for (int w = 0; w < N; ++w) rank += first[w] && act[w] < a;
      atomicOr(&txm[rank * w32 + (u >> 5)], 1u << (u & 31));
      if (first[u]) chan[rank] = a;
    }
    kof[u] = rank;
  }
  // inr[i] bit j: D[i][j] < R, a warp per 32 columns of a row
  for (int task = warp; task < N * w32; task += nw) {
    const int i = task / w32, j = (task - i * w32) * 32 + lane;
    const unsigned m = __ballot_sync(kFull, j < N && dist(px, py, i, j) < R);
    if (lane == 0) inr[task] = m;
  }
  __syncthreads();

  // nearest in-range transmitter of each (active channel, receiver): the
  // channel's in-range transmitters in ascending id and a strict <, so
  // the first of equal distances wins, as the plain argmin's does
  for (int item = tid; item < K * N; item += nt) {
    const int k = item / N, r = item - k * N;
    unsigned char got = kNone;
    if (kof[r] != k) {
      float best = kNoTx;
      for (int q = 0; q < w32; ++q) {
        unsigned m = txm[k * w32 + q] & inr[r * w32 + q];
        while (m) {
          const int t = q * 32 + __ffs(m) - 1;
          m &= m - 1;
          const float d = dist(px, py, r, t);
          if (d < best) {
            best = d;
            got = static_cast<unsigned char>(t);
          }
        }
      }
      obs[static_cast<size_t>(r) * C + chan[k]] = 1.0f;
      if (got != kNone) {
        atomicAdd(&recv[got], 1);
        atomicAdd(&cnt[k], 1);
      }
    }
    res[item] = got;
  }
  __syncthreads();

  // PRR and reward of each transmitter: receivers are the non-transmitters
  // of its channel in range, received those whose nearest is it
  for (int u = tid; u < N; u += nt) {
    const int k = kof[u];
    float rew = 0.0f;
    if (k >= 0) {
      int tot = 0, in_range = 0;
      for (int q = 0; q < w32; ++q) {
        const unsigned tm = txm[k * w32 + q];
        tot += __popc(tm);
        in_range += __popc(inr[u * w32 + q] & ~tm);
      }
      const float prr = in_range > 0
          ? __fdiv_rn(static_cast<float>(recv[u]), static_cast<float>(in_range))
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
      rew = tot > 1 ? r_coll : r_solo;
    }
    rews[u] = rew;
  }
  // per-channel offsets of the pair list: an exclusive scan of cnt
  if (warp == 0) {
    int carry = 0;
    for (int base = 0; base < K; base += 32) {
      const int k = base + lane;
      const int v = k < K ? cnt[k] : 0;
      int incl = v;
      for (int d = 1; d < 32; d <<= 1) {
        const int n = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += n;
      }
      if (k < K) off[k] = carry + incl - v;
      carry += __shfl_sync(kFull, incl, 31);
    }
    if (lane == 0) off[K] = carry;
  }
  // last_arrival [tx, rx]: row i changes on channel act[i] only -- the
  // slot index where j accepted i, else -1 where j is out of range and
  // does not transmit on that channel
#pragma unroll 4
  for (int e = tid; e < NN; e += nt) {
    const int i = e / N, j = e - i * N;
    const int k = kof[i];
    int v = la_in[e];
    if (k >= 0) {
      if (res[k * N + j] == i) {
        v = t_slot;
      } else if (kof[j] != k && !((inr[i * w32 + (j >> 5)] >> (j & 31)) & 1u)) {
        v = -1;
      }
    }
    la[e] = v;
  }
  __syncthreads();

  // the accepted (receiver, source) pairs in channel order, receivers
  // ascending within a channel: a warp per channel
  if (merge) {
    for (int k = warp; k < K; k += nw) {
      int pos = off[k];
      for (int base = 0; base < N; base += 32) {
        const int r = base + lane;
        const unsigned char s = r < N ? res[k * N + r] : kNone;
        const unsigned m = __ballot_sync(kFull, s != kNone);
        if (s != kNone) {
          pairs[pos + __popc(m & ((1u << lane) - 1u))] =
              static_cast<unsigned short>(r | (s << 8));
        }
        pos += __popc(m);
      }
    }
  }
  if (tid == 0) meta[0] = merge ? K : 0;
  for (int k = tid; k <= K; k += nt) meta[1 + k] = off[k];
}

__global__ void __launch_bounds__(kMergeWarps * 32) channel_phase_merge_kernel(
    const float* __restrict__ tx_in, const float* __restrict__ ty_in,
    const int* __restrict__ ts_in, const int* __restrict__ ta_in,
    const unsigned short* __restrict__ pairs, const int* __restrict__ meta,
    float* __restrict__ tx, float* __restrict__ ty, int* __restrict__ ts,
    int* __restrict__ ta, int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sx = reinterpret_cast<float*>(smem);                 // [N][kWidth]
  float* sy = sx + N * kWidth;                                // [N][kWidth]
  int* ss = reinterpret_cast<int*>(sy + N * kWidth);          // [N][kWidth]
  int* off = ss + N * kWidth;                                 // [N + 1]
  unsigned short* sp = reinterpret_cast<unsigned short*>(off + N + 1);
                                                              // [N * N]

  const int b = blockIdx.x, j0 = blockIdx.y * kWidth;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t tab = static_cast<size_t>(b) * N * N;
  pairs += tab;
  meta += static_cast<size_t>(b) * (N + 2);

#pragma unroll 4
  for (int e = tid; e < N * kWidth; e += blockDim.x) {
    const int i = e / kWidth, j = j0 + e % kWidth;
    const size_t g = tab + static_cast<size_t>(i) * N + j;
    const bool in = j < N;
    sx[e] = in ? tx_in[g] : 0.0f;
    sy[e] = in ? ty_in[g] : 0.0f;
    ss[e] = in ? ts_in[g] : 0;
  }
  const int K = meta[0];
  for (int k = tid; k <= K; k += blockDim.x) off[k] = meta[1 + k];
  const int P = K > 0 ? meta[1 + K] : 0;
  for (int p = tid; p < P; p += blockDim.x) sp[p] = pairs[p];
  __syncthreads();

  // each lane walks its column's chain, a warp per pair: a channel's
  // pairs touch disjoint rows and read rows that no pair of it writes
  for (int k = 0; k < K; ++k) {
    const int s = off[k], e = off[k + 1];
    if (s == e) continue;   // uniform across the block
    for (int p = s + warp; p < e; p += kMergeWarps) {
      const int v = sp[p];
      const int dst = (v & 0xff) * kWidth + lane;
      const int src = (v >> 8) * kWidth + lane;
      const int seq = ss[src];
      if (seq > ss[dst]) {
        ss[dst] = seq;
        sx[dst] = sx[src];
        sy[dst] = sy[src];
      }
    }
    __syncthreads();
  }

#pragma unroll 4
  for (int e = tid; e < N * kWidth; e += blockDim.x) {
    const int j = j0 + e % kWidth;
    if (j < N) {
      const size_t g = tab + static_cast<size_t>(e / kWidth) * N + j;
      tx[g] = sx[e];
      ty[g] = sy[e];
      ts[g] = ss[e];
      ta[g] = ss[e] > ts_in[g] ? 0 : ta_in[g];
    }
  }
}

}  // namespace

extern "C" const char* dtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Both passes on one stream.  The plan's numbers (ops/channel_phase.py
// ::_k5_plan) are checked against this file's own before anything runs.
extern "C" int channel_phase_launch(
    const float* pos_x, const float* pos_y, const int* actions,
    const float* tx_in, const float* ty_in, const int* ts_in,
    const int* ta_in, const int* la_in,
    float* tx, float* ty, int* ts, int* ta, int* la,
    float* rews, float* obs, unsigned short* pairs, int* meta,
    int B, int N, int C, int t_slot, float R, int design, int merge,
    int accept_threads, int accept_bytes, int merge_slices,
    int merge_threads, int merge_bytes, int width, void* stream) {
  if (B <= 0 || N <= 0 || N > kMaxUsers || C <= 0
      || accept_threads <= 0 || accept_threads > 1024 || accept_threads % 32
      || merge_threads != kMergeWarps * 32 || width != kWidth
      || merge_slices != (N + kWidth - 1) / kWidth
      || static_cast<size_t>(accept_bytes) != accept_smem(N)
      || static_cast<size_t>(merge_bytes) != merge_smem(N)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      channel_phase_accept_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, accept_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      channel_phase_merge_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, merge_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  channel_phase_accept_kernel<<<B, accept_threads, accept_bytes, s>>>(
      pos_x, pos_y, actions, la_in, la, rews, obs, pairs, meta,
      N, C, t_slot, R, design, merge);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  channel_phase_merge_kernel<<<dim3(B, merge_slices), merge_threads,
                               merge_bytes, s>>>(
      tx_in, ty_in, ts_in, ta_in, pairs, meta, tx, ty, ts, ta, N);
  return static_cast<int>(cudaGetLastError());
}
