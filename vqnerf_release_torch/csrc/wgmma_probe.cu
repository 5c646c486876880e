// A probe of the tensor-core path of sdf_kernel.cu, for the card-only tests.
//
// One warpgroup multiplies A [64, 8 steps] by `steps` weight tiles exactly
// as the SDF kernel does a layer: two passes of 128 columns, each copying
// its columns of every tile into a stage of the kernel's layout, the same
// descriptor, the same register fragments of A, the same accumulator
// layout, one wgmma a step into one accumulator (the hi halves only; the
// inputs are exact in TF32). The tiles come from kernels/sdf.py's packing,
// so the test that calls this holds the packed layout, the stage layout,
// the descriptor and the fragment layouts to a plain matrix product, and
// reads how the accumulator rounds.

#include "sdf_kernel.cu"

__global__ void __launch_bounds__(128, 1)
wgmma_probe_kernel(const float* __restrict__ a,
                   const float* __restrict__ tiles, float* __restrict__ d,
                   int steps) {
    __shared__ __align__(128) float bt[HALF_BYTES / 4];
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int row = 16 * warp + g, lda = TILE_K * steps;
    for (int h = 0; h < N_PASSES; ++h) {
        float acc[ACC_REGS];
#pragma unroll
        for (int i = 0; i < ACC_REGS; ++i) acc[i] = 0.f;
        for (int s = 0; s < steps; ++s) {
            __syncthreads();
            // the hi pieces (k / 4 = 0, 1) of the pass's columns
            for (int i = tid; i < HALF_BYTES / 4; i += 128) {
                const int p = i / (PIECE_BYTES / 4), r = i % (PIECE_BYTES / 4);
                bt[i] = tiles[(size_t)s * PACKED_TILE_FLOATS + p * TILE_N * 4
                              + h * PASS_N * 4 + r];
            }
            // generic-proxy stores, read next by the async proxy
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            __syncthreads();
            const float* a0 = a + row * lda + s * TILE_K + t;
            const float* a1 = a0 + 8 * lda;
            const uint32_t frag[4] = {to_tf32(a0[0]), to_tf32(a1[0]),
                                      to_tf32(a0[4]), to_tf32(a1[4])};
            wgmma_fence();
            wgmma_tf32(acc, frag, b_descriptor(smem_addr(bt)));
            wgmma_commit();
            wgmma_wait<0>();
#pragma unroll
            for (int i = 0; i < ACC_REGS; ++i)
                asm volatile("" : "+f"(acc[i]) :: "memory");
        }
#pragma unroll
        for (int i = 0; i < PASS_N / 8; ++i) {
            float* d0 = d + row * TILE_N + h * PASS_N + 8 * i + 2 * t;
            d0[0] = acc[4 * i];
            d0[1] = acc[4 * i + 1];
            d0[8 * TILE_N] = acc[4 * i + 2];
            d0[8 * TILE_N + 1] = acc[4 * i + 3];
        }
    }
}

extern "C" {

// d [64, 256] = a [64, 8 steps] times the hi halves of `steps` packed
// tiles, on ``stream``. Returns the CUDA error of the launch.
int wgmma_probe(const float* a, const float* tiles, float* d, int steps,
                void* stream) {
    wgmma_probe_kernel<<<1, 128, 0, (cudaStream_t)stream>>>(a, tiles, d,
                                                            steps);
    return (int)cudaGetLastError();
}

}  // extern "C"
