// Fused VQ-EMA training step for Hopper (sm_90a): nearest-code assignment,
// masked statistics and the EMA codebook update.
//
// Replaces the Pallas TPU kernel
// vqnerf_release_tpu/ops/pallas/vq_kernel.py::vq_fused_train (body
// _vq_block_kernel). For rows x [N, D], codebook cb [D, K], row weights
// rowmask [N], usable-code mask sel [K], EMA hidden state hcs [K] and
// hdw [D, K], and the already-incremented step counter, it computes
//   distances  |x|^2 - 2 x.cb + |cb|^2, dropped codes (sel == 0) at 1e30,
//   indices    argmin over K, the first index on ties,
//   quantized  cb[:, indices[n]],
//   counts     sum_n rowmask[n] onehot[n, k],
//   dw         sum_n rowmask[n] x[n, d] onehot[n, k],
// and then, once, the Sonnet EMA: hidden' = hidden - (hidden - new)(1 -
// decay), debias by 1 - exp(counter log(decay)), Laplace smoothing of the
// cluster sizes, update = ema_dw / smoothed where counts > 0 and the old
// codebook column elsewhere. All fp32. Forward only: the JAX kernel has no
// VJP either, the loss terms stay outside.
//
// What bounds it on an H100: at the training shape (N 2048, D 256, K 15) it
// reads x (2.1 MB) and writes quantized (2.1 MB), about 1.3 us at 3.35 TB/s,
// and does 2 N D K = 15.7 MFLOP of distances and as much again for dw, far
// below a microsecond of fp32 rate. The bound is bytes; in practice the two
// launches and their dependency dominate.
//
// The TPU kernel runs its grid in order, adds counts and dw into a resident
// output block and runs the EMA on the last grid step. CUDA blocks run
// concurrently, so this is two launches:
//   vq_assign: one warp per row, the row in registers (D / 32 floats per
//     lane, coalesced), the codebook transposed in shared memory with
//     |cb|^2, K dot products reduced with shuffles so that every lane holds
//     every distance and takes the same argmin. Each block walks its rows
//     in rounds of one row per warp (grid-stride); after a round the block's
//     threads add the round's rows into the block's own dw and counts in
//     shared memory, thread d owning column d, rows in order. A block ends
//     by writing its partial sums to partial[block]. No atomics: the order
//     of every sum is fixed by N and the grid, so the result is the same
//     from run to run.
//   vq_finish: sums the partials in block order, each thread one (d, k)
//     element, and runs the EMA epilogue. Every block recomputes the K
//     counts and the smoothing (K * blocks loads), so no third launch or
//     grid-wide barrier is needed.
// The ragged tail is masked; nothing is padded.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;              // rows per round of a block
constexpr int kThreads = kWarps * 32;  // 256: one thread per column of dw
constexpr int kMaxPerLane = 8;         // D <= 256
constexpr int kMaxBlocks = 128;        // bounds the partial buffer
constexpr float kBig = 1e30f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Shared memory layout (floats): cbT [K, D], dw [K, D], stage [kWarps, D],
// cb_sq [K], sel [K], counts [K], stage_w [kWarps], then stage_idx
// [kWarps] ints.
__global__ void __launch_bounds__(kThreads)
    vq_assign(const float *__restrict__ x, const float *__restrict__ cb,
              const float *__restrict__ rowmask, const float *__restrict__ sel,
              int *__restrict__ indices, float *__restrict__ quantized,
              float *__restrict__ partial_dw, float *__restrict__ partial_counts,
              int n, int d, int k) {
  extern __shared__ float smem[];
  float *s_cbT = smem;
  float *s_dw = s_cbT + k * d;
  float *s_stage = s_dw + k * d;
  float *s_cbsq = s_stage + kWarps * d;
  float *s_sel = s_cbsq + k;
  float *s_counts = s_sel + k;
  float *s_stage_w = s_counts + k;
  int *s_stage_idx = reinterpret_cast<int *>(s_stage_w + kWarps);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < k * d; i += kThreads) {
    const int kk = i / d, dd = i - kk * d;
    s_cbT[i] = cb[dd * k + kk];
    s_dw[i] = 0.0f;
  }
  if (tid < k) {
    s_sel[tid] = sel[tid];
    s_counts[tid] = 0.0f;
  }
  __syncthreads();
  for (int kk = warp; kk < k; kk += kWarps) {
    float s = 0.0f;
    for (int dd = lane; dd < d; dd += 32) {
      const float c = s_cbT[kk * d + dd];
      s += c * c;
    }
    s = warp_sum(s);
    if (lane == 0) s_cbsq[kk] = s;
  }
  __syncthreads();

  const int rows_per_sweep = gridDim.x * kWarps;
  for (int base = blockIdx.x * kWarps; base < n; base += rows_per_sweep) {
    const int row = base + warp;
    if (row < n) {
      float xv[kMaxPerLane];
      float x_sq = 0.0f;
#pragma unroll
      for (int j = 0; j < kMaxPerLane; ++j) {
        const int dd = lane + 32 * j;
        xv[j] = dd < d ? x[(size_t)row * d + dd] : 0.0f;
        x_sq += xv[j] * xv[j];
      }
      x_sq = warp_sum(x_sq);

      float best = 0.0f;
      int best_k = 0;
      for (int kk = 0; kk < k; ++kk) {
        float cross = 0.0f;
#pragma unroll
        for (int j = 0; j < kMaxPerLane; ++j) {
          const int dd = lane + 32 * j;
          if (dd < d) cross += xv[j] * s_cbT[kk * d + dd];
        }
        cross = warp_sum(cross);
        float dist = x_sq - 2.0f * cross + s_cbsq[kk];
        if (!(s_sel[kk] > 0.0f)) dist = kBig;
        if (kk == 0 || dist < best) {  // strict: the first index wins a tie
          best = dist;
          best_k = kk;
        }
      }

      const float w = rowmask[row];
#pragma unroll
      for (int j = 0; j < kMaxPerLane; ++j) {
        const int dd = lane + 32 * j;
        if (dd < d) {
          quantized[(size_t)row * d + dd] = s_cbT[best_k * d + dd];
          s_stage[warp * d + dd] = xv[j] * w;
        }
      }
      if (lane == 0) {
        indices[row] = best_k;
        s_stage_idx[warp] = best_k;
        s_stage_w[warp] = w;
      }
    } else if (lane == 0) {
      s_stage_idx[warp] = -1;
    }
    __syncthreads();
    // the round's rows into the block's sums, in row order
    for (int dd = tid; dd < d; dd += kThreads) {
#pragma unroll
      for (int r = 0; r < kWarps; ++r) {
        const int kk = s_stage_idx[r];
        if (kk >= 0) s_dw[kk * d + dd] += s_stage[r * d + dd];
      }
    }
    if (tid < k) {
#pragma unroll
      for (int r = 0; r < kWarps; ++r)
        if (s_stage_idx[r] == tid) s_counts[tid] += s_stage_w[r];
    }
    __syncthreads();
  }

  float *out_dw = partial_dw + (size_t)blockIdx.x * d * k;
  for (int i = tid; i < d * k; i += kThreads) {
    const int dd = i / k, kk = i - dd * k;
    out_dw[i] = s_dw[kk * d + dd];  // [D, K] as the codebook
  }
  if (tid < k) partial_counts[blockIdx.x * k + tid] = s_counts[tid];
}

// One thread per (d, k) element. Shared: counts [K], smoothed [K].
__global__ void __launch_bounds__(kThreads)
    vq_finish(const float *__restrict__ partial_dw,
              const float *__restrict__ partial_counts,
              const float *__restrict__ cb, const float *__restrict__ hcs,
              const float *__restrict__ hdw, const float *__restrict__ counter,
              float *__restrict__ counts_out, float *__restrict__ new_hcs,
              float *__restrict__ new_hdw, float *__restrict__ update,
              int n_blocks, int d, int k, float decay, float one_m_decay,
              float epsilon) {
  extern __shared__ float smem[];
  float *s_counts = smem;
  float *s_smoothed = smem + k;

  const int tid = threadIdx.x;
  const float debias = 1.0f - expf(counter[0] * logf(decay));

  if (tid < k) {
    float c = 0.0f;
    for (int b = 0; b < n_blocks; ++b) c += partial_counts[b * k + tid];
    s_counts[tid] = c;
    const float h = hcs[tid] - (hcs[tid] - c) * one_m_decay;
    s_smoothed[tid] = h / debias;  // ema_cs until the smoothing below
    if (blockIdx.x == 0) {
      counts_out[tid] = c;
      new_hcs[tid] = h;
    }
  }
  __syncthreads();
  if (tid == 0) {
    float n_total = 0.0f;
    for (int kk = 0; kk < k; ++kk) n_total += s_smoothed[kk];
    for (int kk = 0; kk < k; ++kk)
      s_smoothed[kk] =
          (s_smoothed[kk] + epsilon) / (n_total + k * epsilon) * n_total;
  }
  __syncthreads();

  const int i = blockIdx.x * kThreads + tid;
  if (i < d * k) {
    const int kk = i % k;
    float dw = 0.0f;
#pragma unroll 8
    for (int b = 0; b < n_blocks; ++b) dw += partial_dw[(size_t)b * d * k + i];
    const float h = hdw[i] - (hdw[i] - dw) * one_m_decay;
    new_hdw[i] = h;
    const float used = s_counts[kk] > 0.0f ? 1.0f : 0.0f;
    update[i] = (h / debias) / s_smoothed[kk] * used + cb[i] * (1.0f - used);
  }
}

}  // namespace

// Number of blocks vq_assign uses for n rows; the caller sizes the partial
// buffers [blocks, D * K] and [blocks, K] with it.
extern "C" int vq_fused_train_blocks(int n) {
  const int needed = (n + kWarps - 1) / kWarps;
  return needed < kMaxBlocks ? (needed > 0 ? needed : 1) : kMaxBlocks;
}

// Shared memory of vq_assign in bytes; the caller keeps it within the
// default 48 KB.
extern "C" int vq_fused_train_smem(int d, int k) {
  return (int)(sizeof(float) * ((size_t)2 * k * d + (size_t)kWarps * d +
                                3 * (size_t)k + kWarps) +
               sizeof(int) * kWarps);
}

// Both launches on `stream`; returns cudaGetLastError() of the first one
// that fails (0 on success). Pointers are device pointers to contiguous
// arrays: x, quantized [n, d]; cb, hdw, new_hdw, update [d, k]; rowmask [n];
// sel, hcs, counts, new_hcs [k]; counter [1] (fp32, already incremented);
// indices [n] int32; partial_dw [blocks, d * k]; partial_counts [blocks, k].
// d <= 256, k <= 256. decay comes as a double so that 1 - decay is rounded to
// fp32 once, as the plain version rounds it: 1.0f - 0.999f is off by 1.3e-5
// of its value, which a count of 35,000 rows turns into 4e-4.
extern "C" int vq_fused_train_launch(
    const float *x, const float *cb, const float *rowmask, const float *sel,
    const float *hcs, const float *hdw, const float *counter, int *indices,
    float *quantized, float *counts, float *new_hcs, float *new_hdw,
    float *update, float *partial_dw, float *partial_counts, int n, int d,
    int k, double decay, double epsilon, void *stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = vq_fused_train_blocks(n);
  vq_assign<<<blocks, kThreads, vq_fused_train_smem(d, k), s>>>(
      x, cb, rowmask, sel, indices, quantized, partial_dw, partial_counts, n, d,
      k);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int finish_blocks = (d * k + kThreads - 1) / kThreads;
  vq_finish<<<finish_blocks, kThreads, sizeof(float) * 2 * k, s>>>(
      partial_dw, partial_counts, cb, hcs, hdw, counter, counts, new_hcs,
      new_hdw, update, blocks, d, k, static_cast<float>(decay),
      static_cast<float>(1.0 - decay), static_cast<float>(epsilon));
  return static_cast<int>(cudaGetLastError());
}
