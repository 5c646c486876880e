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
// dh[:, 0] (the input scaling and the output's 1/scale cancel). Forward
// only, as the TPU kernels.
//
// What bounds it on an H100: operations, on the tensor cores. The default
// net (39 -> 256 x 8 -> column 0 of the last layer) is 2 x 459,008 = 918,016
// operations a point and row; the gradient kernel runs four rows a point.
// Single TF32 keeps three decimal digits, too few for an SDF that goes
// through inv_s of several hundred (measured: 1.2e-3 on sdf against 3.0e-5),
// so every product is split in three TF32 products, a_lo b_hi + a_hi b_lo +
// a_hi b_hi, where x_hi = tf32(x) (cvt.rna) and x_lo = tf32(x - x_hi): a
// third of the TF32 rate, 495 / 3 = 165 TFLOP/s, against 67 TFLOP/s on the
// CUDA cores. That bound is 2.9 ms for 524,288 points forward and 23.3 ms
// for 1,048,576 points with the gradient; points and outputs are 8 and 17
// MB (microseconds at 3.35 TB/s). The split inputs are exact to 2^-21, but
// the tensor core's fp32 accumulator truncates where an FMA rounds to
// nearest (tests/test_torch_cuda.py::test_tensor_core_accumulator_rounding),
// once an instruction. With the three products in one accumulator that was
// 96 truncations a layer at the magnitude of the whole sum, and the error
// against the plain versions grew with the weights: 1.9e-5 on the
// geometric init, 5.2e-5 on the gradient of a trained net, past rtol 1e-4 /
// atol 1e-5 on one component in millions. So the two small products go
// into an accumulator of their own, whose truncations are 2^-11 smaller,
// and the chain at full magnitude is the 32 hi x hi products of a layer; a
// single rounded add joins the two. Only column 0 of the last layer is
// computed, on the CUDA cores, since nothing else is returned.
//
// Design.
//   * A block owns TILE_M = 128 rows: two consumer warpgroups of 64 rows
//     each, and a producer warpgroup of which one lane works; setmaxnreg
//     moves its registers to the consumers (40 and 232 a thread). Rows are
//     points forward, and point * 4 + (value, d/dx, d/dy, d/dz) with the
//     gradient: the tangent rows multiply the same W as the value row, so
//     the four channels are simply a taller matrix product.
//   * Products: wgmma m64n128k8 (TF32, fp32 accumulators of 64 registers a
//     thread), A from registers, B from shared memory through a matrix
//     descriptor. Two accumulators of the full 256 columns would take 256
//     registers a thread, more than a thread may hold, so a layer runs in
//     two passes of 128 output columns, each over the whole depth, each
//     with its two accumulators (big: hi x hi; small: lo x hi + hi x lo).
//     The first pass's sums wait in a shared-memory stash (64 KB, each
//     thread its own slots) for the epilogue, which runs once both passes
//     have read the layer's input. The activations stay in shared memory
//     in fp32, [row][feature] with a row stride of 260 floats (no bank
//     conflicts on the fragment loads); a thread loads its four A values of
//     a depth-8 step, splits them into hi and lo in registers and starts the
//     three products. A warp reads and writes only its own 16 rows, so a
//     layer updates the activations in place behind a __syncwarp.
//   * Weights are split into hi and lo and tiled once, at pack time
//     (kernels/sdf.py::pack_sdf): for each hidden layer and each depth-8
//     step one contiguous tile of 16 KB, [hi, lo][k / 4][n 256][k % 4].
//     A pass copies its 128 columns of a tile, four pieces of 2 KB, into a
//     stage of 8 KB laid out [hi, lo][k / 4][n 128][k % 4], which is
//     wgmma's K-major layout without swizzle (8 x 16-byte core matrices 128
//     bytes apart along n, 2 KB apart along k). Rows past the layer's width
//     and depth past its input are zero; a pass whose columns all lie past
//     the layer's width is not run.
//   * The producer streams the stages (3.75 MB a block for the default net;
//     they stay in the 50 MB L2) into a ring of STAGES = 4 stages, four
//     cp.async.bulk a stage; consumers wait on a stage's "full" mbarrier
//     and, when the wgmma group that read it has completed, arrive on its
//     "empty" one. Both warpgroups share every stage, so a block reads the
//     weights once for 128 rows. Shared memory holds 32 KB of ring, the 64
//     KB stash and 130 KB of activations: 231,488 of the 232,448 bytes a
//     block may have.
//   * Epilogue in fp32 on the CUDA cores from the accumulator registers:
//     bias, softplus (expf, log1pf in full precision), the sigmoid gate on
//     the tangent rows, 1/sqrt2 before a skip. In the accumulator layout a
//     thread holds rows g and g + 8 of its warp's 16 (g = lane / 4); rows
//     are ordered point * 4 + channel, so the four lanes (lane & ~12) + 0,
//     4, 8, 12 hold the four channels of two points and only the first
//     one's elements need expf and log1pf: each of the four lanes takes one
//     of them (4 shuffles), and the four sigmoid gates go back by 4
//     shuffles. With every lane running expf and log1pf for the value
//     rows' sake the gradient kernel took 78 ms in place of 42 ms.
//   * The encoding is written into the activations by each warp for its own
//     rows, and computed again at a skip layer (shared memory has no room
//     to keep it).
//   * The last layer is a dot product per row with column 0, the 32 lanes
//     of a warp over the features, reduced by shuffles in a fixed order.
//   * The ragged tail is masked: rows past N read a zero point and store
//     nothing. Every sum has a fixed order: the same bits from run to run.
//
// Four compile-time switches serve the card-only studies of
// tests/test_torch_cuda.py and chip_smoke.py; the port builds the default
// of each.
// -DSDF_TF32_PASSES=1: the single-product variant (hi x hi only, into the
// big accumulator).
// -DSDF_ONE_ACCUMULATOR: the three products into one accumulator, in the
// order of the design before this one, which gives its sums bit for bit.
// -DSDF_STAGES=n: another depth of the weight ring.
// -DSDF_SKIP_ACTIVATION: the epilogue's expf, log1pf, gate and shuffles
// compiled out, to time the products alone; its results are wrong.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef SDF_TF32_PASSES
#define SDF_TF32_PASSES 3
#endif

#define SDF_MAX_LAYERS 16
#define TILE_N 256                     // widest layer; columns of a packed tile
#define PASS_N 128                     // output columns of one pass
#define N_PASSES (TILE_N / PASS_N)
#define ACC_REGS (PASS_N / 2)          // an m64n128 accumulator, a thread
#define TILE_K 8
#define N_WG 2                         // consumer warpgroups
#define TILE_M (64 * N_WG)             // rows of a block
#define THREADS (128 * (N_WG + 1))     // consumers, and the producer's group
#define ACT_STRIDE 260                 // floats; 260 % 32 == 4
#ifndef SDF_STAGES
#define SDF_STAGES 4
#endif
#define STAGES SDF_STAGES
#define PACKED_TILE_FLOATS (2 * TILE_N * TILE_K)  // pack_sdf's tile, 16 KB
#define PIECE_BYTES (PASS_N * 4 * 4)   // a pass's part of one k / 4 row: 2 KB
#define HALF_BYTES (2 * PIECE_BYTES)   // one of hi / lo in a stage: 4 KB
#define STAGE_BYTES (2 * HALF_BYTES)
#define COPY_PIECES (SDF_TF32_PASSES == 3 ? 4 : 2)
#define STASH_FLOATS (TILE_M * PASS_N)  // the first pass's sums: 64 KB
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

// ---- mbarrier, bulk copy and wgmma, in PTX ---------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

// Wait until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n"
            "}\n"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    } while (!done);
}

// Global -> shared copy of `bytes` (a multiple of 16, both 16-byte aligned)
// that reports to the mbarrier `bar` when it has landed.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
    return r;
}

// Matrix descriptor of a [128 n][8 k] TF32 stage half stored
// [k / 4][n][k % 4]: K-major, no swizzle; the 8 x 16-byte core matrices lie
// 128 bytes apart along n (stride byte offset) and 2048 bytes apart along k
// (leading byte offset). Fields are in 16-byte units.
__device__ __forceinline__ uint64_t b_descriptor(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFF) >> 4)
        | ((uint64_t)(PIECE_BYTES >> 4) << 16)
        | ((uint64_t)(128 >> 4) << 32);
}

// d[64 x 128] += a[64 x 8] b[8 x 128]: a from registers (the m16n8k8 TF32
// fragment of each warp's 16 rows), b from shared memory.
__device__ __forceinline__ void wgmma_tf32(float (&d)[ACC_REGS],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// The four A values of a thread for one depth-8 step, split into hi and lo.
__device__ __forceinline__ void load_frag(const float* a0, const float* a1,
                                          int k0, uint32_t (&hi)[4],
                                          uint32_t (&lo)[4]) {
    const float v[4] = {a0[k0], a1[k0], a0[k0 + 4], a1[k0 + 4]};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        hi[i] = to_tf32(v[i]);
        lo[i] = to_tf32(v[i] - __uint_as_float(hi[i]));
    }
}

// The ring of weight stages as one consumer sees it.
struct Ring {
    uint32_t base, full, empty;  // shared addresses: stages, barriers
    int stage, prev;
    uint32_t phase;
};

// One depth-8 step: wait for the stage, start its products as one wgmma
// group (the two small ones into `small`, hi x hi into `big`), and, unless
// it is a pass's first step, wait for the group before it and hand that
// group's stage back to the producer.
__device__ __forceinline__ void k_step(float (&big)[ACC_REGS],
                                       float (&small)[ACC_REGS],
                                       const uint32_t (&hi)[4],
                                       const uint32_t (&lo)[4], Ring& ring,
                                       bool first, int lane) {
    mbar_wait(ring.full + 8 * ring.stage, ring.phase);
    wgmma_fence();
    const uint64_t d_hi = b_descriptor(ring.base + ring.stage * STAGE_BYTES);
#if SDF_TF32_PASSES == 3
#ifdef SDF_ONE_ACCUMULATOR
    wgmma_tf32(big, lo, d_hi);
    wgmma_tf32(big, hi, d_hi + (HALF_BYTES >> 4));
#else
    wgmma_tf32(small, lo, d_hi);
    wgmma_tf32(small, hi, d_hi + (HALF_BYTES >> 4));
#endif
#endif
    wgmma_tf32(big, hi, d_hi);
    wgmma_commit();
    if (!first) {
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(ring.empty + 8 * ring.prev);
    }
    ring.prev = ring.stage;
    if (++ring.stage == STAGES) {
        ring.stage = 0;
        ring.phase ^= 1;
    }
}

// The positional encoding of a warp's 16 rows (and its derivatives in the
// tangent rows), times `mul`, into columns col0 .. col0 + d_embed - 1 of the
// activations, and zeros up to the next multiple of 8.
template <int C>
__device__ __forceinline__ void write_embed(float* act_warp,
                                            const float* __restrict__ pts,
                                            long long first_point, int n,
                                            const SdfNet& net, int col0,
                                            float mul, int lane) {
    constexpr int P = 16 / C;  // points of a warp
    for (int idx = lane; idx < P * 3; idx += 32) {
        const int p = idx / 3, a = idx - 3 * p;
        const long long gp = first_point + p;
        const float x = gp < n ? pts[gp * 3 + a] * net.scale : 0.f;
        float* dst = act_warp + p * C * ACT_STRIDE + col0;
        dst[a] = x * mul;
        if (C == 4) {
#pragma unroll
            for (int c = 1; c < 4; ++c)
                dst[c * ACT_STRIDE + a] = (c - 1 == a) ? mul : 0.f;
        }
        float freq = 1.f;
        for (int i = 0; i < net.n_freqs; ++i, freq *= 2.f) {
            const float s = sinf(x * freq), co = cosf(x * freq);
            const int ks = 3 + 6 * i + a, kc = ks + 3;
            dst[ks] = s * mul;
            dst[kc] = co * mul;
            if (C == 4) {
#pragma unroll
                for (int c = 1; c < 4; ++c) {
                    const bool on = (c - 1 == a);
                    dst[c * ACT_STRIDE + ks] = on ? (co * freq) * mul : 0.f;
                    dst[c * ACT_STRIDE + kc] = on ? (-s * freq) * mul : 0.f;
                }
            }
        }
    }
    const int end = col0 + net.d_embed;
    const int pad = ((end + TILE_K - 1) & ~(TILE_K - 1)) - end;
    for (int idx = lane; idx < 16 * pad; idx += 32)
        act_warp[(idx / pad) * ACT_STRIDE + end + idx % pad] = 0.f;
}

template <int C>
__global__ void __launch_bounds__(THREADS, 1)
sdf_mlp_kernel(const float* __restrict__ pts, const float* __restrict__ wbuf,
               const SdfNet net, const int n, float* __restrict__ out_sdf,
               float* __restrict__ out_grad) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    float* stash = reinterpret_cast<float*>(smem_raw + STAGES * STAGE_BYTES);
    float* act = stash + STASH_FLOATS;
    uint64_t* bars = reinterpret_cast<uint64_t*>(act + TILE_M * ACT_STRIDE);
    const uint32_t ring_base = smem_addr(smem_raw);
    const uint32_t full = smem_addr(bars), empty = full + 8 * STAGES;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int last = net.n_layers - 1;

    if (tid == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full + 8 * s, 1);           // the producer's expect_tx
            mbar_init(empty + 8 * s, 4 * N_WG);   // each consumer warp's lane 0
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (warp >= 4 * N_WG) {
        // ---- producer: one lane streams every hidden layer's tiles; its
        // warpgroup hands its registers to the consumers ---------------------
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
        if (warp == 4 * N_WG && lane == 0) {
            int stage = 0;
            uint32_t phase = 1;  // a fresh barrier's preceding phase: free
            for (int l = 0; l < last; ++l) {
                const int nt = (net.in_dim[l] + TILE_K - 1) / TILE_K;
                const int passes = (net.out_dim[l] + PASS_N - 1) / PASS_N;
                for (int h = 0; h < passes; ++h) {
                    // the pass's columns of each tile: piece (hi | lo, k / 4)
                    // is PASS_N x 4 floats at n = PASS_N h
                    const float* src = wbuf + net.w_off[l] + h * PASS_N * 4;
                    for (int kt = 0; kt < nt; ++kt) {
                        mbar_wait(empty + 8 * stage, phase);
                        mbar_expect_tx(full + 8 * stage,
                                       COPY_PIECES * PIECE_BYTES);
                        for (int p = 0; p < COPY_PIECES; ++p)
                            bulk_copy(ring_base + stage * STAGE_BYTES
                                          + p * PIECE_BYTES,
                                      src + (size_t)kt * PACKED_TILE_FLOATS
                                          + p * TILE_N * 4,
                                      PIECE_BYTES, full + 8 * stage);
                        if (++stage == STAGES) {
                            stage = 0;
                            phase ^= 1;
                        }
                    }
                }
            }
        }
        return;
    }

    // ---- consumers: warp w of the block owns rows 16 w .. 16 w + 15 ------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const float inv_sqrt2 = 0.70710678118654752f;
    const int g = lane >> 2, t = lane & 3;
    float* act_warp = act + 16 * warp * ACT_STRIDE;
    float* row0 = act_warp + g * ACT_STRIDE;   // the thread's accumulator rows
    float* row1 = row0 + 8 * ACT_STRIDE;
    const long long first_row = (long long)blockIdx.x * TILE_M + 16 * warp;
    const long long first_point = first_row / C;
    // with the gradient: the thread's channel, the lane that holds its
    // point's value rows, and where element `ch` of those rows is stored
    // (element j: row g + 8 (j / 2), column col + j % 2)
    const int ch = g & 3, vlane = lane & ~12;
    float* vrow =
        act_warp + ((g & ~3) + 8 * (ch >> 1)) * ACT_STRIDE + (ch & 1);

    write_embed<C>(act_warp, pts, first_point, n, net, 0, 1.f, lane);
    __syncwarp();

    // the thread's slots of the stash: element i at my_stash[32 i]
    float* my_stash = stash + warp * (ACC_REGS * 32) + lane;
    Ring ring = {ring_base, full, empty, 0, 0, 0u};
    for (int l = 0; l < last; ++l) {
        const int in = net.in_dim[l], out = net.out_dim[l];
        const int nt = (in + TILE_K - 1) / TILE_K;
        const int passes = (out + PASS_N - 1) / PASS_N;
        float big[ACC_REGS], small[ACC_REGS];
#pragma unroll
        for (int h = 0; h < N_PASSES; ++h) {
            if (h >= passes) continue;
#pragma unroll
            for (int i = 0; i < ACC_REGS; ++i) big[i] = small[i] = 0.f;

            // two sets of A fragments: one feeds the products in flight
            // while the other is loaded for the next step
            uint32_t hi_a[4], lo_a[4], hi_b[4], lo_b[4];
            load_frag(row0 + t, row1 + t, 0, hi_a, lo_a);
            for (int kt = 0; kt < nt; kt += 2) {
                k_step(big, small, hi_a, lo_a, ring, kt == 0, lane);
                if (kt + 1 < nt) {
                    load_frag(row0 + t, row1 + t, (kt + 1) * TILE_K, hi_b,
                              lo_b);
                    k_step(big, small, hi_b, lo_b, ring, false, lane);
                    if (kt + 2 < nt)
                        load_frag(row0 + t, row1 + t, (kt + 2) * TILE_K,
                                  hi_a, lo_a);
                }
            }
            wgmma_wait<0>();
            if (lane == 0) mbar_arrive(ring.empty + 8 * ring.prev);
#pragma unroll
            for (int i = 0; i < ACC_REGS; ++i)
                asm volatile("" : "+f"(big[i]), "+f"(small[i]) :: "memory");
            if (h == 0) {
#pragma unroll
                for (int i = 0; i < ACC_REGS; ++i)
                    my_stash[32 * i] = big[i] + small[i];
            }
        }

        // bias, softplus on the value rows, the sigmoid gate on the tangent
        // rows, and the 1/sqrt2 of a skip concat that follows; columns past
        // the layer's width become the zeros the next layer's depth needs
        const float* bias = wbuf + net.b_off[l];
        const bool to_skip = net.skip[l + 1] != 0;
        const float post = to_skip ? inv_sqrt2 : 1.f;
        const int next_k =
            (net.in_dim[l + 1] + TILE_K - 1) & ~(TILE_K - 1);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            if (8 * i >= next_k) continue;
            const int col = 8 * i + 2 * t;
            // the thread's four elements: (row g | g + 8) x (col | col + 1)
            float o[4] = {0.f, 0.f, 0.f, 0.f};
            bool store_own = true;
            if (8 * i < out) {
                // the four sums: the first pass's from the stash, the
                // second's from the accumulators
                float acc[4];
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    acc[j] = i < PASS_N / 8
                        ? my_stash[32 * (4 * i + j)]
                        : big[4 * (i - PASS_N / 8) + j]
                            + small[4 * (i - PASS_N / 8) + j];
                const bool on0 = col < out, on1 = col + 1 < out;
                const float b0 = on0 ? __ldg(bias + col) : 0.f;
                const float b1 = on1 ? __ldg(bias + col + 1) : 0.f;
#ifdef SDF_SKIP_ACTIVATION
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    o[j] = (acc[j] + ((j & 1) ? b1 : b0)) * post;
                    if (!((j & 1) ? on1 : on0)) o[j] = 0.f;
                }
#else
                if (C == 1) {
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const float pre = acc[j] + ((j & 1) ? b1 : b0);
                        const float e = expf(-fabsf(100.f * pre));
                        o[j] = (fmaxf(pre, 0.f) + log1pf(e) * 0.01f) * post;
                        if (!((j & 1) ? on1 : on0)) o[j] = 0.f;
                    }
                } else {
                    // The lanes vlane + 0, 4, 8, 12 hold the four channels
                    // of two points. Only the value lane's four elements
                    // need expf and log1pf: each lane of the group takes
                    // one of them (element ch), stores its softplus into
                    // the value row itself, and the four gates go back by
                    // shuffle.
                    float x = 0.f;
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const float pre = acc[j] + ((j & 1) ? b1 : b0);
                        const float v = __shfl_sync(0xffffffffu, pre, vlane);
                        if (j == ch) x = v;
                    }
                    const float e = expf(-fabsf(100.f * x));
                    const float gate = __fdividef(x >= 0.f ? 1.f : e, 1.f + e);
                    float sp = (fmaxf(x, 0.f) + log1pf(e) * 0.01f) * post;
                    if (!((ch & 1) ? on1 : on0)) sp = 0.f;
                    vrow[col] = sp;
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const float gj =
                            __shfl_sync(0xffffffffu, gate, vlane + 4 * j);
                        o[j] = acc[j] * gj * post;
                        if (!((j & 1) ? on1 : on0)) o[j] = 0.f;
                    }
                    store_own = ch != 0;  // the value rows are stored above
                }
#endif
            }
            if (store_own) {
                *reinterpret_cast<float2*>(row0 + col) =
                    make_float2(o[0], o[1]);
                *reinterpret_cast<float2*>(row1 + col) =
                    make_float2(o[2], o[3]);
            }
        }
        __syncwarp();
        if (to_skip) {
            write_embed<C>(act_warp, pts, first_point, n, net, out, inv_sqrt2,
                           lane);
            __syncwarp();
        }
    }

    // ---- last layer: column 0 only, a dot product per row ----------------
    {
        const int in = net.in_dim[last];
        const float* wl = wbuf + net.w_off[last];
        float mine = 0.f;
        for (int r = 0; r < 16; ++r) {
            const float* a = act_warp + r * ACT_STRIDE;
            float s = 0.f;
            for (int k = lane; k < in; k += 32)
                s = fmaf(a[k], __ldg(wl + k), s);
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                s += __shfl_xor_sync(0xffffffffu, s, off);
            if (lane == r) mine = s;
        }
        if (lane < 16) {
            const long long row = first_row + lane;
            const long long gp = row / C;
            const int c = (int)(row - gp * C);
            if (gp < n) {
                if (c == 0)
                    out_sdf[gp] =
                        (mine + __ldg(wbuf + net.b_off[last])) / net.scale;
                else
                    out_grad[gp * 3 + (c - 1)] = mine;
            }
        }
    }
}

// Dynamic shared memory of a block, in bytes: the ring, the stash, the
// activations and the 2 x STAGES mbarriers.
static int sdf_smem_bytes() {
    return STAGES * STAGE_BYTES
        + (STASH_FLOATS + TILE_M * ACT_STRIDE) * (int)sizeof(float)
        + 2 * STAGES * 8;
}

template <int C>
static int launch(const float* pts, const float* wbuf, const SdfNet& net,
                  int n, float* sdf, float* grad, cudaStream_t s) {
    const int smem = sdf_smem_bytes();
    cudaError_t err = cudaFuncSetAttribute(
        sdf_mlp_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const long long blocks = ((long long)n * C + TILE_M - 1) / TILE_M;
    sdf_mlp_kernel<C><<<(unsigned)blocks, THREADS, smem, s>>>(pts, wbuf, net,
                                                              n, sdf, grad);
    return (int)cudaGetLastError();
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
    if ((uintptr_t)wbuf & 15) return cudaErrorInvalidValue;
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
    cudaStream_t s = (cudaStream_t)stream;
    return grad == nullptr ? launch<1>(pts, wbuf, net, n, sdf, nullptr, s)
                           : launch<4>(pts, wbuf, net, n, sdf, grad, s);
}

}  // extern "C"
