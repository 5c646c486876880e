// Fused VQ-EMA training step for Hopper (sm_90a): nearest-code assignment,
// masked statistics and the EMA codebook update, in ONE launch.
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
// below a microsecond of fp32 rate. The bound is bytes, and at this size no
// kernel comes near it: a launch, a block's set-up and the dependent steps
// of a reduction across blocks are each microseconds. So the design spends
// its effort on having ONE launch, few dependent steps in it, and every
// step spread over as many SMs as it can use.
//
// The TPU kernel runs its grid in order, adds counts and dw into a resident
// output block and runs the EMA on the last grid step. CUDA blocks run
// concurrently, so here:
//   * one warp per row, 16-byte loads: a lane holds columns 4 lane .. + 3
//     and 128 + 4 lane .. + 3 of its row, and reads the same columns of the
//     codebook (transposed in shared memory, rows padded by 4 floats against
//     bank conflicts) as two 16-byte shared loads a code. A warp works on
//     kRows rows together, so that what it reads of the codebook serves all
//     of them: reading the whole codebook from shared memory for every row
//     was what a row cost. The first rows are asked for before the block's
//     set-up, the next at the top of each pass;
//   * the K dot products are reduced across the lanes sixteen codes at a
//     time by halving (8 + 4 + 2 + 1 exchanges and one last add: 16 shuffles
//     for 16 codes, where a butterfly a code took 80), which leaves distance
//     k in lanes 2k and 2k + 1; a five-step minimum with index, ties to the
//     lower index, gives every lane the same code;
//   * every WARP owns a [K, D] dw and a [K] counts in shared memory and
//     adds its rows into them as it goes, in row order, so the loop over
//     rows holds no block-wide barrier; the block adds its eight warps'
//     sums in warp order and writes them to its slot of the scratch buffer;
//   * all blocks then meet at the grid's barrier (a cooperative launch,
//     which the card refuses unless every block is resident at once: one a
//     SM, so at most as many blocks as SMs), and share what is left: the
//     float4 slots of the [K, D] sums are dealt round the blocks, each slot's
//     thread adds the blocks' partials IN BLOCK ORDER through L2 (__ldcg)
//     and runs the EMA epilogue on its four elements. Every block adds up
//     the K counts and the smoothing for itself (K numbers a block), so
//     there is no second barrier. A first design let the block that drew
//     the last of a ticket do all of this alone: one SM then read every
//     block's 15 KB through its own port to L2, 6 us for 32 blocks, and ran
//     the whole epilogue, 3 us, where here both are spread over the card.
//     There is no atomic: every floating-point sum has an order fixed by N
//     and the grid, so two calls give the same bits.
// The caller sizes the grid (about 32 rows a block, one pass of kRows rows
// a warp) and provides the scratch for the partials. The ragged tail is
// masked; nothing is padded. Calls on one stream are ordered; two streams
// must not share a scratch buffer.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 4;               // rows a warp works on together
constexpr int kThreads = kWarps * 32;  // 256
constexpr int kMaxDim = 256;           // a row is two float4 a lane
constexpr int kGroup = 16;             // codes reduced across lanes together
constexpr int kRowPad = 4;             // floats between transposed rows
constexpr int kBatch = 16;             // loads a thread keeps in flight
constexpr int kMaxSmem = 232448;       // 227 KB, what a block can be given
constexpr float kBig = 1e30f;
constexpr float kNever = 3e38f;        // a code past K: behind any dropped one

__host__ __device__ constexpr int padded_codes(int k) {
  return (k + kGroup - 1) / kGroup * kGroup;
}

// Shared memory in floats: cbT [K, D + pad], per-warp dw [kWarps, K, D]
// (reused behind the grid's barrier for the blocks' counts), cb_sq [KP],
// sel [KP] (reused for the summed counts and the smoothed sizes), per-warp
// counts [kWarps, KP].
__host__ __device__ constexpr size_t smem_floats(int d, int k) {
  return (size_t)k * (d + kRowPad) + (size_t)kWarps * k * d +
         (size_t)(2 + kWarps) * padded_codes(k);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// With -DVQ_TIMING thread 0 of every block writes the SM's cycle counter at
// the ends of its phases (and the global nanosecond timer first and last)
// behind the partial counts, 16 words of 8 bytes a block, for the card-only
// study of where a call's time goes; the caller then makes the scratch
// buffer that much larger.
#ifdef VQ_TIMING
#define VQ_STAMP(i)                                               \
  if (threadIdx.x == 0) {                                         \
    long long *t_ = reinterpret_cast<long long *>(                \
                        scratch +                                 \
                        (size_t)gridDim.x * (k * d + padded_codes(k))) + \
                    16 * blockIdx.x;                              \
    t_[i] = clock64();                                            \
    if ((i) == 0 || (i) == 6) {                                   \
      unsigned long long g_;                                      \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g_));      \
      t_[(i) == 0 ? 10 : 11] = (long long)g_;                     \
    }                                                             \
  }
#else
#define VQ_STAMP(i)
#endif

// One step of the reduction by halving: the lanes whose `off` bit is clear
// keep the lower H of their 2H values, the others the upper H, and each
// adds what its partner held of the kept half.
template <int H>
__device__ __forceinline__ void halve(float (&p)[kGroup], int off, bool upper) {
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = upper ? p[i] : p[i + H];
    const float keep = upper ? p[i + H] : p[i];
    p[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
  }
}

__global__ void __launch_bounds__(kThreads)
    vq_fused(const float *__restrict__ x, const float *__restrict__ cb,
             const float *__restrict__ rowmask, const float *__restrict__ sel,
             const float *hcs, const float *hdw,
             const float *__restrict__ counter, int *__restrict__ indices,
             float *__restrict__ quantized, float *__restrict__ counts_out,
             float *new_hcs, float *new_hdw, float *__restrict__ update,
             float *scratch, int n, int d, int k, float decay,
             float one_m_decay, float epsilon) {
  extern __shared__ __align__(16) float smem[];
  const int kp = padded_codes(k);
  const int ds = d + kRowPad;
  float *s_cbT = smem;
  float *s_dw = s_cbT + k * ds;
  float *s_cbsq = s_dw + kWarps * k * d;
  float *s_sel = s_cbsq + kp;
  float *s_cnt = s_sel + kp;

  float *partial_dw = scratch;  // [blocks, K, D]
  float *partial_counts = partial_dw + (size_t)gridDim.x * k * d;  // [., KP]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  VQ_STAMP(0)
  // read before the barrier: the caller may pass the state in place, and
  // block 0 writes the new cluster sizes behind it
  const float hcs_old = tid < k ? hcs[tid] : 0.0f;
  const float counter_now = counter[0];

  // this lane's two groups of four columns, and its warp's first kRows
  // rows, asked for before the set-up so that they arrive behind it
  const int col_a = 4 * lane, col_b = 128 + 4 * lane;
  const bool has_a = col_a < d, has_b = col_b < d;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  const int sweep = gridDim.x * kWarps * kRows;
  int first = (blockIdx.x * kWarps + warp) * kRows;
  float4 xa[kRows], xb[kRows];
  float w[kRows];
  auto load_rows = [&](int at, float4 (&a)[kRows], float4 (&b)[kRows],
                       float (&weight)[kRows]) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      a[r] = b[r] = zero4;
      weight[r] = 0.0f;
      if (at + r < n) {
        const float *xr = x + (size_t)(at + r) * d;
        if (has_a) a[r] = __ldg(reinterpret_cast<const float4 *>(xr + col_a));
        if (has_b) b[r] = __ldg(reinterpret_cast<const float4 *>(xr + col_b));
        weight[r] = __ldg(rowmask + at + r);
      }
    }
  };
  load_rows(first, xa, xb, w);

  // the codebook, transposed, kBatch loads in flight a thread; the first
  // batch flies while the per-warp sums are zeroed
  auto load_cb = [&](int base, float (&v)[kBatch]) {
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = base + j * kThreads;
      v[j] = i < d * k ? __ldg(cb + i) : 0.0f;
    }
  };
  auto store_cb = [&](int base, const float (&v)[kBatch]) {
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = base + j * kThreads;
      if (i < d * k) {
        const int dd = i / k, kk = i - dd * k;
        s_cbT[kk * ds + dd] = v[j];
      }
    }
  };
  float cbv[kBatch];
  load_cb(tid, cbv);
  for (int i = tid; i < kWarps * k * d / 4; i += kThreads)
    reinterpret_cast<float4 *>(s_dw)[i] = zero4;
  store_cb(tid, cbv);
  for (int base = tid + kBatch * kThreads; base < d * k;
       base += kBatch * kThreads) {
    load_cb(base, cbv);
    store_cb(base, cbv);
  }
  for (int i = tid; i < kWarps * kp; i += kThreads) s_cnt[i] = 0.0f;
  for (int i = tid; i < kp; i += kThreads) s_sel[i] = i < k ? sel[i] : 0.0f;
  __syncthreads();
  for (int kk = warp; kk < kp; kk += kWarps) {
    float s = 0.0f;
    if (kk < k)
      for (int dd = lane; dd < d; dd += 32) {
        const float c = s_cbT[kk * ds + dd];
        s += c * c;
      }
    s = warp_sum(s);
    if (lane == 0) s_cbsq[kk] = s;
  }
  __syncthreads();
  VQ_STAMP(1)

  float *my_dw = s_dw + warp * k * d;
  float *my_cnt = s_cnt + warp * kp;
  for (; first < n; first += sweep) {
    float4 next_a[kRows], next_b[kRows];
    float next_w[kRows];
    load_rows(first + sweep, next_a, next_b, next_w);
    float x_sq[kRows], best[kRows];
    int best_k[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      x_sq[r] = warp_sum(dot4(xa[r], xa[r]) + dot4(xb[r], xb[r]));
      best[r] = kNever;
      best_k[r] = 0;
    }
    for (int g = 0; g < k; g += kGroup) {
      float p[kRows][kGroup];
#pragma unroll
      for (int c = 0; c < kGroup; ++c) {
        float4 ca = zero4, cb4 = zero4;  // a code past K gives 0
        if (g + c < k) {
          const float *cr = s_cbT + (g + c) * ds;
          if (has_a) ca = *reinterpret_cast<const float4 *>(cr + col_a);
          if (has_b) cb4 = *reinterpret_cast<const float4 *>(cr + col_b);
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          p[r][c] = dot4(xa[r], ca) + dot4(xb[r], cb4);
      }
      const int code = g + ((lane >> 1) & (kGroup - 1));
      const bool usable = code < k && s_sel[code] > 0.0f;
      const float cb_sq = code < k ? s_cbsq[code] : 0.0f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        halve<8>(p[r], 16, lane & 16);
        halve<4>(p[r], 8, lane & 8);
        halve<2>(p[r], 4, lane & 4);
        halve<1>(p[r], 2, lane & 2);
        const float cross = p[r][0] + __shfl_xor_sync(0xffffffffu, p[r][0], 1);
        const float dist = code >= k ? kNever
                           : usable  ? x_sq[r] - 2.0f * cross + cb_sq
                                     : kBig;
        if (dist < best[r]) {  // strict: the lower group wins a tie
          best[r] = dist;
          best_k[r] = code;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float other = __shfl_xor_sync(0xffffffffu, best[r], off);
        const int other_k = __shfl_xor_sync(0xffffffffu, best_k[r], off);
        if (other < best[r] || (other == best[r] && other_k < best_k[r])) {
          best[r] = other;
          best_k[r] = other_k;
        }
      }
    }

    // the rows into the warp's sums, in row order
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = first + r;
      if (row < n) {
        float *qr = quantized + (size_t)row * d;
        const float *cr = s_cbT + best_k[r] * ds;
        float *dr = my_dw + best_k[r] * d;
        if (has_a) {
          *reinterpret_cast<float4 *>(qr + col_a) =
              *reinterpret_cast<const float4 *>(cr + col_a);
          float4 acc = *reinterpret_cast<float4 *>(dr + col_a);
          acc.x += xa[r].x * w[r], acc.y += xa[r].y * w[r];
          acc.z += xa[r].z * w[r], acc.w += xa[r].w * w[r];
          *reinterpret_cast<float4 *>(dr + col_a) = acc;
        }
        if (has_b) {
          *reinterpret_cast<float4 *>(qr + col_b) =
              *reinterpret_cast<const float4 *>(cr + col_b);
          float4 acc = *reinterpret_cast<float4 *>(dr + col_b);
          acc.x += xb[r].x * w[r], acc.y += xb[r].y * w[r];
          acc.z += xb[r].z * w[r], acc.w += xb[r].w * w[r];
          *reinterpret_cast<float4 *>(dr + col_b) = acc;
        }
        if (lane == 0) {
          indices[row] = best_k[r];
          my_cnt[best_k[r]] += w[r];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      xa[r] = next_a[r], xb[r] = next_b[r], w[r] = next_w[r];
  }
  __syncthreads();
  VQ_STAMP(2)

  // the block's sums, its warps in order, to its slot of the scratch
  float4 *out_dw =
      reinterpret_cast<float4 *>(partial_dw + (size_t)blockIdx.x * k * d);
  for (int i = tid; i < k * d / 4; i += kThreads) {
    float4 acc = reinterpret_cast<const float4 *>(s_dw)[i];
#pragma unroll
    for (int wp = 1; wp < kWarps; ++wp) {
      const float4 v = reinterpret_cast<const float4 *>(s_dw + wp * k * d)[i];
      acc.x += v.x, acc.y += v.y, acc.z += v.z, acc.w += v.w;
    }
    out_dw[i] = acc;
  }
  if (tid < k) {
    float c = s_cnt[tid];
#pragma unroll
    for (int wp = 1; wp < kWarps; ++wp) c += s_cnt[wp * kp + tid];
    partial_counts[blockIdx.x * kp + tid] = c;
  }
  VQ_STAMP(3)

  // Every block's sums are written; behind the grid's barrier all blocks
  // share the rest: float4 slot i of the [K, D] sums belongs to thread
  // (i / blocks) of block (i % blocks).
  cg::this_grid().sync();
  VQ_STAMP(4)
  const int n_blocks = gridDim.x;
  const int n4 = k * d / 4;
  if (blockIdx.x >= n4) return;

  // the blocks' counts, all loaded at once into the shared memory that the
  // per-warp sums have left free, then added in block order
  float *s_pc = s_dw;  // [blocks, KP] while that fits
  float *s_counts = s_cbsq, *s_smoothed = s_sel;
  const int pc_fit = kWarps * k * d / kp;
  for (int i = tid; i < min(n_blocks, pc_fit) * kp; i += kThreads)
    s_pc[i] = __ldcg(partial_counts + i);
  __syncthreads();
  const float debias = 1.0f - expf(counter_now * logf(decay));
  if (tid < k) {
    float c = 0.0f;
    const int in_smem = min(n_blocks, pc_fit);
#pragma unroll 16
    for (int b = 0; b < in_smem; ++b) c += s_pc[b * kp + tid];
    for (int b = in_smem; b < n_blocks; ++b)
      c += __ldcg(partial_counts + b * kp + tid);
    s_counts[tid] = c;
    const float h = hcs_old - (hcs_old - c) * one_m_decay;
    s_smoothed[tid] = h / debias;  // ema_cs until the smoothing below
    if (blockIdx.x == 0) {
      counts_out[tid] = c;
      new_hcs[tid] = h;
    }
  }
  __syncthreads();
  float n_total = 0.0f;  // every thread sums the K sizes, in code order
  for (int kk = 0; kk < k; ++kk) n_total += s_smoothed[kk];
  __syncthreads();
  if (tid < k)
    s_smoothed[tid] =
        (s_smoothed[tid] + epsilon) / (n_total + k * epsilon) * n_total;
  __syncthreads();
  VQ_STAMP(5)

  // this block's slots: the blocks' sums in block order, kAhead in flight,
  // then the EMA of the slot's four elements. Element e of hidden_dw is
  // read and written by this one thread, so the new state may be written
  // over the old.
  constexpr int kAhead = 32;
  for (int i = blockIdx.x + n_blocks * tid; i < n4; i += n_blocks * kThreads) {
    const int e = 4 * i, kk = e / d, dd = e - kk * d;
    float old[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) old[j] = hdw[(dd + j) * k + kk];
    float4 acc = zero4;
    for (int b0 = 0; b0 < n_blocks; b0 += kAhead) {
      float4 v[kAhead];
#pragma unroll
      for (int a = 0; a < kAhead; ++a)
        v[a] = b0 + a < n_blocks
                   ? __ldcg(reinterpret_cast<const float4 *>(
                                partial_dw + (size_t)(b0 + a) * k * d) +
                            i)
                   : zero4;
#pragma unroll
      for (int a = 0; a < kAhead; ++a)
        acc.x += v[a].x, acc.y += v[a].y, acc.z += v[a].z, acc.w += v[a].w;
    }
    const float dw[4] = {acc.x, acc.y, acc.z, acc.w};
    const float used = s_counts[kk] > 0.0f ? 1.0f : 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float h = old[j] - (old[j] - dw[j]) * one_m_decay;
      new_hdw[(dd + j) * k + kk] = h;
      update[(dd + j) * k + kk] = (h / debias) / s_smoothed[kk] * used +
                                  s_cbT[kk * ds + dd + j] * (1.0f - used);
    }
  }
  VQ_STAMP(6)
}

}  // namespace

// Dynamic shared memory of a block in bytes; kernels/vq.py computes the
// same number and keeps it within 232,448.
extern "C" int vq_fused_train_smem(int d, int k) {
  return static_cast<int>(sizeof(float) * smem_floats(d, k));
}

// One cooperative launch of `blocks` blocks on `stream` of `device`;
// returns the CUDA error (0 on success; the launch is refused where the
// card cannot hold `blocks` blocks at once, one an SM). Pointers are device
// pointers to contiguous arrays: x, quantized [n, d], 16-byte aligned; cb,
// hdw, new_hdw, update [d, k]; rowmask [n]; sel, hcs, counts, new_hcs [k];
// counter [1] (fp32, already incremented); indices [n] int32; scratch:
// blocks (k d + 16 ceil(k / 16)) floats, 16-byte aligned, any contents.
// d <= 256 and a multiple of 4; k <= 256. decay comes as a double so that
// 1 - decay is rounded to fp32 once, as the plain version rounds it: 1.0f -
// 0.999f is off by 1.3e-5 of its value, which a count of 35,000 rows turns
// into 4e-4.
extern "C" int vq_fused_train_launch(
    const float *x, const float *cb, const float *rowmask, const float *sel,
    const float *hcs, const float *hdw, const float *counter, int *indices,
    float *quantized, float *counts, float *new_hcs, float *new_hdw,
    float *update, float *scratch, int n, int d, int k, int blocks,
    double decay, double epsilon, int device, void *stream) {
  const size_t smem = sizeof(float) * smem_floats(d, k);
  if (device < 0 || n < 0 || d < 4 || d > kMaxDim || d % 4 != 0 || k < 1 ||
      k > kThreads || blocks < 1 || smem > kMaxSmem ||
      reinterpret_cast<size_t>(x) % 16 != 0 ||
      reinterpret_cast<size_t>(quantized) % 16 != 0 ||
      reinterpret_cast<size_t>(scratch) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int previous = 0;
  cudaError_t err = cudaGetDevice(&previous);
  if (err == cudaSuccess && previous != device) err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        vq_fused, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess) {
    float decay_f = static_cast<float>(decay);
    float one_m_decay = static_cast<float>(1.0 - decay);
    float epsilon_f = static_cast<float>(epsilon);
    void *args[] = {&x,      &cb,        &rowmask, &sel,     &hcs,
                    &hdw,    &counter,   &indices, &quantized, &counts,
                    &new_hcs, &new_hdw,  &update,  &scratch, &n,
                    &d,      &k,         &decay_f, &one_m_decay, &epsilon_f};
    err = cudaLaunchCooperativeKernel(
        reinterpret_cast<void *>(vq_fused), dim3(blocks), dim3(kThreads), args,
        smem, static_cast<cudaStream_t>(stream));
    if (err == cudaSuccess) err = cudaGetLastError();
  }
  if (previous != device) cudaSetDevice(previous);
  return static_cast<int>(err);
}
