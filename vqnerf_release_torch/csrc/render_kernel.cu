// Fused microfacet-BRDF + render-equation kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// vqnerf_release_tpu/ops/pallas/render_kernel.py::fused_brdf_render
// (body _render_block_kernel). For every ray and each of L lights it forms
// the unit surface->light and half vectors, GGX D, Smith G, per-channel
// Schlick F and Lambert albedo/pi, weights the light by
// front-lit mask * lvis * cos * solid angle * light rgb, and sums over L.
// Output: pre-gamma rgb [N, 3]; the caller applies gamma and the clip.
//
// What bounds it on an H100: per ray-light pair the kernel reads one lvis
// float (4 bytes, 2 KB per ray at L = 512) and does about 60 fp32
// operations, among them two rsqrt, one sqrt and three divides. 4 bytes
// against ~60 operations sits near the card's fp32 ridge (~67 TFLOP/s
// over 3.35 TB/s, about 20 operations per byte), so the kernel is bound by
// lvis bandwidth and issue rate together; nothing else is read per pair.
//
// What the design does about it:
//   * one warp per ray; the 32 lanes stride over L, so a warp's lvis reads
//     of a ray's row are contiguous and coalesced, and each lvis byte is
//     read once;
//   * the packed [8, L] light table (lxyz, rgb, area, pad; 16 KB at
//     L = 512) lives in shared memory, loaded once per block, and the
//     blocks loop over rays (grid-stride) so the table load is amortised;
//   * the per-ray terms (normalised n and v, alpha^2, G(v)) are computed
//     once per lane, outside the light loop;
//   * each lane keeps three fp32 partial sums; a __shfl_down_sync tree
//     combines them and lane 0 writes the ray's rgb;
//   * the ragged tail is masked (no padding of N), and a null lvis pointer
//     means "front-lit mask only", so no all-ones [N, L] array is read.
//
// The math follows _render_block_kernel term by term: the same
// rsqrt(max(sum, 1e-6)) normalisation, the same where(den == 0) guards and
// the same clips. It is built with -fmad=false and evaluates each
// expression in the plain twin's order, so that every operation rounds as
// the twin's does: at low roughness the GGX D term near its peak,
// alpha^2 / (pi (cos_nh^2 (alpha^2 - 1) + 1)^2), turns a last-bit
// difference in cos_nh into a relative error of ~1e-2 (rough 0.05), and
// FMA contraction alone gave such differences. Forward only.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kInvPi = 0.318309886183790671538f;  // float(1 / pi)

__device__ __forceinline__ void safe_norm3(float &x, float &y, float &z) {
  const float inv = rsqrtf(fmaxf(x * x + y * y + z * z, 1e-6f));
  x *= inv;
  y *= inv;
  z *= inv;
}

__device__ __forceinline__ float gsub(float cos_t, float alpha2) {
  cos_t = fminf(fmaxf(cos_t, 0.0f), 1.0f);
  const float den =
      cos_t + sqrtf(fabsf(alpha2 + (1.0f - alpha2) * cos_t * cos_t));
  return den == 0.0f ? 0.0f : 2.0f * cos_t / den;
}

__global__ void __launch_bounds__(kThreads)
    render_kernel(const float *__restrict__ xyz, const float *__restrict__ normal,
                  const float *__restrict__ surf2c,
                  const float *__restrict__ albedo,
                  const float *__restrict__ rough, const float *__restrict__ f0,
                  const float *__restrict__ lvis,
                  const float *__restrict__ lights, float *__restrict__ out,
                  int n, int l) {
  extern __shared__ float s_lights[];  // [8, L]
  for (int i = threadIdx.x; i < 8 * l; i += blockDim.x) s_lights[i] = lights[i];
  __syncthreads();

  const float *s_lx = s_lights;
  const float *s_ly = s_lights + l;
  const float *s_lz = s_lights + 2 * l;
  const float *s_lr = s_lights + 3 * l;
  const float *s_lg = s_lights + 4 * l;
  const float *s_lb = s_lights + 5 * l;
  const float *s_area = s_lights + 6 * l;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int stride = gridDim.x * kWarpsPerBlock;

  for (int ray = blockIdx.x * kWarpsPerBlock + warp; ray < n; ray += stride) {
    const float x = xyz[3 * ray], y = xyz[3 * ray + 1], z = xyz[3 * ray + 2];
    float nx = normal[3 * ray], ny = normal[3 * ray + 1], nz = normal[3 * ray + 2];
    float vx = surf2c[3 * ray], vy = surf2c[3 * ray + 1], vz = surf2c[3 * ray + 2];
    safe_norm3(nx, ny, nz);
    safe_norm3(vx, vy, vz);
    const float r = rough[ray];
    const float alpha2 = (r * r) * (r * r);
    const float a0 = albedo[3 * ray] * kInvPi;
    const float a1 = albedo[3 * ray + 1] * kInvPi;
    const float a2 = albedo[3 * ray + 2] * kInvPi;
    const float f00 = f0[3 * ray], f01 = f0[3 * ray + 1], f02 = f0[3 * ray + 2];
    const float cos_vn = nx * vx + ny * vy + nz * vz;
    const float g_v = gsub(cos_vn, alpha2);
    const float abs_cos_vn4 = 4.0f * fabsf(cos_vn);
    const float *lvis_row = lvis == nullptr ? nullptr : lvis + (size_t)ray * l;

    float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f;
    for (int j = lane; j < l; j += 32) {
      float sx = s_lx[j] - x, sy = s_ly[j] - y, sz = s_lz[j] - z;
      safe_norm3(sx, sy, sz);
      float hx = sx + vx, hy = sy + vy, hz = sz + vz;
      safe_norm3(hx, hy, hz);

      const float cos_vh = fminf(fmaxf(hx * vx + hy * vy + hz * vz, 0.0f), 1.0f);
      const float cos_nh = fminf(fmaxf(hx * nx + hy * ny + hz * nz, 0.0f), 1.0f);
      const float cos_ln = sx * nx + sy * ny + sz * nz;

      const float t = cos_nh * cos_nh * (alpha2 - 1.0f) + 1.0f;
      const float den_d = kPi * (t * t);
      const float d = den_d == 0.0f ? 0.0f : alpha2 / den_d;
      const float g = gsub(cos_ln, alpha2) * g_v;
      const float den_spec = fabsf(cos_ln) * abs_cos_vn4;
      const float gd = den_spec == 0.0f ? 0.0f : (g * d) / den_spec;

      float lv = cos_ln > 0.0f ? 1.0f : 0.0f;
      if (lvis_row != nullptr) lv *= lvis_row[j];
      const float weight = lv * cos_ln * s_area[j];
      const float u = 1.0f - cos_vh;
      const float u2 = u * u;
      const float u5 = u2 * u2 * u;

      acc0 += ((f00 + (1.0f - f00) * u5) * gd + a0) * weight * s_lr[j];
      acc1 += ((f01 + (1.0f - f01) * u5) * gd + a1) * weight * s_lg[j];
      acc2 += ((f02 + (1.0f - f02) * u5) * gd + a2) * weight * s_lb[j];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc0 += __shfl_down_sync(0xffffffffu, acc0, off);
      acc1 += __shfl_down_sync(0xffffffffu, acc1, off);
      acc2 += __shfl_down_sync(0xffffffffu, acc2, off);
    }
    if (lane == 0) {
      out[3 * ray] = acc0;
      out[3 * ray + 1] = acc1;
      out[3 * ray + 2] = acc2;
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success). Pointers
// are device pointers to contiguous fp32 arrays: xyz, normal, surf2c,
// albedo, f0 [n, 3]; rough [n, 1]; lvis [n, l] or null; lights [8, l];
// out [n, 3]. The caller keeps 8 * l floats within the default 48 KB of
// dynamic shared memory.
extern "C" int fused_brdf_render_launch(const float *xyz, const float *normal,
                                        const float *surf2c,
                                        const float *albedo, const float *rough,
                                        const float *f0, const float *lvis,
                                        const float *lights, float *out, int n,
                                        int l, void *stream) {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int blocks_needed = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int max_blocks = sms > 0 ? sms * 8 : blocks_needed;
  const int blocks = blocks_needed < max_blocks ? blocks_needed : max_blocks;
  const size_t smem = sizeof(float) * 8 * (size_t)l;
  render_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xyz, normal, surf2c, albedo, rough, f0, lvis, lights, out, n, l);
  return static_cast<int>(cudaGetLastError());
}
