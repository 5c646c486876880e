// Fused SDF MLP for Hopper (sm_90a): forward, and forward with the spatial
// gradient carried as three forward-mode tangent channels.
//
// Replaces the two Pallas TPU kernels of
// vqnerf_release_tpu/ops/pallas/sdf_kernel.py:
//   sdf_fwd_pallas      (_make_fwd_kernel)  -> sdf_mlp_kernel<1>
//   sdf_fwdgrad_pallas  (_make_kernel)      -> sdf_mlp_kernel<4>
// For points pts [N, 3] it computes x = pts * scale, the positional encoding
// [x, sin(2^0 x), cos(2^0 x), ...] (3-channel blocks), then the dense layers
// with the weight norm already folded into W: softplus(beta 100) between the
// layers, and before a layer l in skip_in the concat [h, embed] / sqrt(2).
// Output: sdf = h[:, 0] / scale [N]. The gradient kernel carries, beside the
// value, the tangents d/dx, d/dy, d/dz: the encoding's analytic derivatives,
// dpre = dh @ W, dh = dpre * sigmoid(100 pre); it writes grad [N, 3] =
// dh[:, 0] (the input scaling and the output's 1/scale cancel). All fp32,
// sinf/cosf/expf/log1pf in full precision. Forward only, as the TPU kernels.
//
// What bounds it on an H100: operations. The default net (39 -> 256 x 8 ->
// column 0 of the last layer) is 2 x 459,008 = 918,016 fp32 operations a
// point and row; the gradient kernel runs four rows a point. At 67 TFLOP/s
// that is 7.2 ms for 524,288 points forward and 57.5 ms for 1,048,576 points
// with the gradient, against 8 and 17 MB of points and outputs (microseconds
// at 3.35 TB/s). Only column 0 of the last layer is computed, since nothing
// else is returned.
//
// Design. The TPU kernels keep all weights in VMEM (2.1 MB for the default
// net) and work on blocks of 256 points. A CUDA block has 227 KB of shared
// memory, so here:
//   * a block of 256 threads owns TILE_M = 64 rows: 64 points forward, or 16
//     points x (value, d/dx, d/dy, d/dz) with the gradient, row = point * C
//     + channel. The tangent rows multiply the same W as the value row, so
//     the four channels are simply a taller matrix product;
//   * the block's activations stay in shared memory from the encoding to the
//     output, transposed ([feature][row], 64 KB), so that a thread reads its
//     8 rows of one feature as two float4;
//   * each layer's weights stream from global memory (they stay in the 50 MB
//     L2) through two shared tiles of 16 x 256, the next tile prefetched
//     into registers while the current one is multiplied;
//   * warp w owns rows 8w..8w+7 and lane l the columns 4l..4l+3 and
//     128+4l..128+4l+3: an 8 x 8 register tile a thread, 64 FMAs for four
//     16-byte shared loads. Rows are read and written by their own warp
//     only, so a layer updates the activations in place;
//   * hidden weights are packed [in][256] with zero columns past the layer's
//     width, so every tile load is an aligned float4; the last layer is
//     packed as its column 0 alone and computed as a dot product per row;
//   * the ragged tail is masked: rows past N read a zero point and store
//     nothing. Every sum has a fixed order: the same bits from run to run.
// About 106 KB of shared memory a block (two blocks an SM), set with
// cudaFuncSetAttribute since it is above the 48 KB default.

#include <cuda_runtime.h>
#include <math.h>

#define SDF_MAX_LAYERS 16
#define TILE_M 64
#define TILE_N 256
#define TILE_K 16
#define THREADS 256
#define MAX_EMBED 64

struct SdfNet {
    int n_layers;  // dense layers, the last one included
    int n_freqs;
    int d_embed;  // 3 + 6 n_freqs
    int in_dim[SDF_MAX_LAYERS];
    int out_dim[SDF_MAX_LAYERS];
    int w_off[SDF_MAX_LAYERS];  // offsets into the packed buffer, in floats
    int b_off[SDF_MAX_LAYERS];
    int skip[SDF_MAX_LAYERS];  // 1: the layer's input is [h, embed] / sqrt2
    float scale;
};

__device__ __forceinline__ void load_tile(const float* __restrict__ w, int in,
                                          int k0, int tid, float4 (&reg)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int j = tid + THREADS * i;  // float4 index in the tile
        const int row = k0 + (j >> 6);
        reg[i] = row < in
            ? *reinterpret_cast<const float4*>(w + (size_t)row * TILE_N
                                               + 4 * (j & 63))
            : make_float4(0.f, 0.f, 0.f, 0.f);
    }
}

__device__ __forceinline__ void store_tile(float* tile, int tid,
                                           const float4 (&reg)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
        reinterpret_cast<float4*>(tile)[tid + THREADS * i] = reg[i];
}

template <int C>
__global__ void __launch_bounds__(THREADS, 2)
sdf_mlp_kernel(const float* __restrict__ pts, const float* __restrict__ wbuf,
               const SdfNet net, const int n, float* __restrict__ out_sdf,
               float* __restrict__ out_grad) {
    extern __shared__ __align__(16) float smem[];
    float* act = smem;                           // [TILE_N][TILE_M]
    float* wt = act + TILE_N * TILE_M;           // [2][TILE_K][TILE_N]
    float* emb = wt + 2 * TILE_K * TILE_N;       // [d_embed][TILE_M]
    constexpr int P = TILE_M / C;                // points of a block
    const float inv_sqrt2 = 0.70710678118654752f;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const long long p0 = (long long)blockIdx.x * P;

    // ---- positional encoding, and its derivatives in the tangent rows ----
    for (int idx = tid; idx < P * 3; idx += THREADS) {
        const int p = idx / 3, a = idx - 3 * p;
        const long long gp = p0 + p;
        const float x = gp < n ? pts[gp * 3 + a] * net.scale : 0.f;
        const int row = p * C;
        emb[a * TILE_M + row] = x;
        if (C == 4) {
#pragma unroll
            for (int c = 1; c < 4; ++c)
                emb[a * TILE_M + row + c] = (c - 1 == a) ? 1.f : 0.f;
        }
        float freq = 1.f;
        for (int i = 0; i < net.n_freqs; ++i, freq *= 2.f) {
            const float s = sinf(x * freq), co = cosf(x * freq);
            const int ks = 3 + 6 * i + a, kc = ks + 3;
            emb[ks * TILE_M + row] = s;
            emb[kc * TILE_M + row] = co;
            if (C == 4) {
#pragma unroll
                for (int c = 1; c < 4; ++c) {
                    const bool on = (c - 1 == a);
                    emb[ks * TILE_M + row + c] = on ? co * freq : 0.f;
                    emb[kc * TILE_M + row + c] = on ? -s * freq : 0.f;
                }
            }
        }
    }
    __syncthreads();

    // ---- hidden layers ---------------------------------------------------
    const int last = net.n_layers - 1;
    for (int l = 0; l < last; ++l) {
        const int in = net.in_dim[l], out = net.out_dim[l];
        const float* A = (l == 0) ? emb : act;
        const float* W = wbuf + net.w_off[l];
        float acc[8][8];
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;

        const int n_tiles = (in + TILE_K - 1) / TILE_K;
        float4 reg[4];
        load_tile(W, in, 0, tid, reg);
        store_tile(wt, tid, reg);
        __syncthreads();
        for (int t = 0; t < n_tiles; ++t) {
            if (t + 1 < n_tiles) load_tile(W, in, (t + 1) * TILE_K, tid, reg);
            const float* B = wt + (t & 1) * TILE_K * TILE_N + 4 * lane;
            const float* At = A + t * TILE_K * TILE_M + 8 * warp;
            const int kt = min(TILE_K, in - t * TILE_K);
#pragma unroll 4
            for (int kk = 0; kk < kt; ++kk) {
                const float4 a0 =
                    *reinterpret_cast<const float4*>(At + kk * TILE_M);
                const float4 a1 =
                    *reinterpret_cast<const float4*>(At + kk * TILE_M + 4);
                const float4 b0 =
                    *reinterpret_cast<const float4*>(B + kk * TILE_N);
                const float4 b1 =
                    *reinterpret_cast<const float4*>(B + kk * TILE_N + 128);
                const float a[8] = {a0.x, a0.y, a0.z, a0.w,
                                    a1.x, a1.y, a1.z, a1.w};
                const float b[8] = {b0.x, b0.y, b0.z, b0.w,
                                    b1.x, b1.y, b1.z, b1.w};
#pragma unroll
                for (int r = 0; r < 8; ++r)
#pragma unroll
                    for (int j = 0; j < 8; ++j)
                        acc[r][j] = fmaf(a[r], b[j], acc[r][j]);
            }
            if (t + 1 < n_tiles)
                store_tile(wt + ((t + 1) & 1) * TILE_K * TILE_N, tid, reg);
            __syncthreads();
        }

        // bias, softplus on the value rows, the sigmoid gate on the tangent
        // rows, and the 1/sqrt2 of a skip concat that follows
        const float* bias = wbuf + net.b_off[l];
        const bool to_skip = net.skip[l + 1] != 0;
        const float post = to_skip ? inv_sqrt2 : 1.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int col = (j < 4) ? 4 * lane + j : 128 + 4 * lane + (j - 4);
            if (col < out) {
                const float bv = bias[col];
                float o[8];
                if (C == 1) {
#pragma unroll
                    for (int r = 0; r < 8; ++r) {
                        const float x = acc[r][j] + bv;
                        const float e = expf(-fabsf(100.f * x));
                        o[r] = (fmaxf(x, 0.f) + log1pf(e) / 100.f) * post;
                    }
                } else {
#pragma unroll
                    for (int q = 0; q < 8; q += 4) {
                        const float x = acc[q][j] + bv;
                        const float e = expf(-fabsf(100.f * x));
                        const float gate = (x >= 0.f ? 1.f : e) / (1.f + e);
                        o[q] = (fmaxf(x, 0.f) + log1pf(e) / 100.f) * post;
#pragma unroll
                        for (int c = 1; c < 4; ++c)
                            o[q + c] = acc[q + c][j] * gate * post;
                    }
                }
                float4* dst = reinterpret_cast<float4*>(
                    act + col * TILE_M + 8 * warp);
                dst[0] = make_float4(o[0], o[1], o[2], o[3]);
                dst[1] = make_float4(o[4], o[5], o[6], o[7]);
            }
        }
        if (to_skip) {
            for (int idx = lane; idx < net.d_embed * 8; idx += 32) {
                const int k = idx >> 3, r = 8 * warp + (idx & 7);
                act[(out + k) * TILE_M + r] = emb[k * TILE_M + r] * inv_sqrt2;
            }
        }
        __syncwarp();
    }
    __syncthreads();

    // ---- last layer: column 0 only, a dot product per row ----------------
    {
        const int in = net.in_dim[last];
        const float* A = (last == 0) ? emb : act;
        const float* wl = wbuf + net.w_off[last];
        const int row = tid & (TILE_M - 1), part = tid >> 6;
        const int chunk = (in + 3) / 4;
        const int k_end = min(in, (part + 1) * chunk);
        float s = 0.f;
        for (int k = part * chunk; k < k_end; ++k)
            s = fmaf(A[k * TILE_M + row], wl[k], s);
        wt[part * TILE_M + row] = s;
        __syncthreads();
        if (tid < TILE_M) {
            const float v = (wt[row] + wt[TILE_M + row])
                + (wt[2 * TILE_M + row] + wt[3 * TILE_M + row]);
            const int p = row / C, c = row - p * C;
            const long long gp = p0 + p;
            if (gp < n) {
                if (c == 0)
                    out_sdf[gp] = (v + wbuf[net.b_off[last]]) / net.scale;
                else
                    out_grad[gp * 3 + (c - 1)] = v;
            }
        }
    }
}

// Dynamic shared memory of a block, in bytes.
static int sdf_smem_bytes(int d_embed) {
    return (TILE_N * TILE_M + 2 * TILE_K * TILE_N + d_embed * TILE_M)
        * (int)sizeof(float);
}

extern "C" {

// Launch the forward (grad == null) or the forward with gradient on
// ``stream``. The per-layer tables are host arrays of n_layers ints.
// Returns the CUDA error of the launch (0 = success), or
// cudaErrorInvalidValue for a net this kernel does not take.
int sdf_mlp_launch(const float* pts, const float* wbuf, int n, int n_layers,
                   int n_freqs, const int* in_dim, const int* out_dim,
                   const int* w_off, const int* b_off, const int* skip,
                   double scale, float* sdf, float* grad, void* stream) {
    if (n_layers < 2 || n_layers > SDF_MAX_LAYERS) return cudaErrorInvalidValue;
    SdfNet net;
    net.n_layers = n_layers;
    net.n_freqs = n_freqs;
    net.d_embed = 3 + 6 * n_freqs;
    net.scale = (float)scale;
    if (net.d_embed > MAX_EMBED || in_dim[0] != net.d_embed || skip[0])
        return cudaErrorInvalidValue;
    for (int l = 0; l < SDF_MAX_LAYERS; ++l) {
        const bool on = l < n_layers;
        net.in_dim[l] = on ? in_dim[l] : 0;
        net.out_dim[l] = on ? out_dim[l] : 0;
        net.w_off[l] = on ? w_off[l] : 0;
        net.b_off[l] = on ? b_off[l] : 0;
        net.skip[l] = on ? skip[l] : 0;
        if (!on) continue;
        if (in_dim[l] < 1 || in_dim[l] > TILE_N || (w_off[l] & 3))
            return cudaErrorInvalidValue;
        if (l < n_layers - 1 && (out_dim[l] < 1 || out_dim[l] > TILE_N))
            return cudaErrorInvalidValue;
        if (l > 0 && in_dim[l] != out_dim[l - 1] + (skip[l] ? net.d_embed : 0))
            return cudaErrorInvalidValue;
    }
    if (n <= 0) return 0;
    const int smem = sdf_smem_bytes(net.d_embed);
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err;
    if (grad == nullptr) {
        err = cudaFuncSetAttribute(sdf_mlp_kernel<1>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem);
        if (err != cudaSuccess) return (int)err;
        const int blocks = (n + TILE_M - 1) / TILE_M;
        sdf_mlp_kernel<1><<<blocks, THREADS, smem, s>>>(pts, wbuf, net, n, sdf,
                                                        nullptr);
    } else {
        err = cudaFuncSetAttribute(sdf_mlp_kernel<4>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem);
        if (err != cudaSuccess) return (int)err;
        const int p = TILE_M / 4;
        const int blocks = (n + p - 1) / p;
        sdf_mlp_kernel<4><<<blocks, THREADS, smem, s>>>(pts, wbuf, net, n, sdf,
                                                        grad);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
