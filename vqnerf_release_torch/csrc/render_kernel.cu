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
// What bounds it on an H100. Per ray-light pair the kernel must read one
// lvis float (4 bytes; 100.7 MB a chunk of 49,152 rays x 512 lights, 0.031
// ms at 3.35 TB/s) and does about 60 fp32 operations (0.023 ms at 67
// TFLOP/s). Neither is the floor in practice: measured on the card, the
// first design (one light a lane a step, 4-byte loads) took 0.25 ms with
// lvis and 0.23 ms without, so its loads were covered and instruction
// issue held it. The chain into the GGX term has to round as the plain
// version's does (see the last paragraph), so the file is built without FMA
// contraction, and IEEE divides, an IEEE square root and rsqrtf's handling
// of subnormals made a pair 196 instructions: 786,432 warp-passes a chunk
// over 132 SMs x 4 schedulers are then 0.147 ms at 1,980 MHz, five times
// the bytes bound. This design takes 104.6 instructions a pair (floor 0.079
// ms) and 0.108 ms, 0.105 ms without lvis. chip_smoke.py counts the loop's
// instructions in the built library and prints that floor beside the bytes
// bound.
//
// What the design does about it:
//   * one warp per ray, and a lane owns kLights neighbouring lights a step:
//     light (32 s + lane) kLights + i. In the vector instance (kLights = 4)
//     a lane reads its four lvis values with ONE 16-byte streaming load
//     (ld.global.cs: each lvis byte is used once and should not push what
//     later kernels want out of L2), 512 bytes a warp an instruction, and
//     its four columns of the light table with seven 16-byte shared loads;
//   * the loads of kSteps steps (a whole ray at L = 512) are issued before
//     the first step's arithmetic, so a lane has 64 bytes of lvis in flight
//     where the first design had 4, and the four lights of a step are four
//     independent chains, which covers the latency of MUFU and of shared
//     memory without needing other warps;
//   * lanes 0-15 each fetch one of the NEXT ray's 16 floats while this ray
//     is shaded, and 16 shuffles spread them at the top of the next pass;
//   * the packed [8, L] light table (lxyz, rgb, area, pad; 16 KB at
//     L = 512) lives in shared memory, loaded once per block; a block loops
//     over rays (grid-stride) and the grid is what fits the card at once;
//   * the same source gives a scalar instance (kLights = 1, 4-byte loads,
//     still kSteps of them in flight) for any L that is no multiple of four
//     and for an lvis whose base is not 16-byte aligned; the launcher
//     chooses from L and the pointer. lvis is never copied or padded. A
//     null lvis ("front-lit mask only") is a template parameter, so the
//     loop of the lvis instances holds no branch on it;
//   * each lane keeps three fp32 partial sums; a __shfl_down_sync tree
//     combines them and lane 0 writes the ray's rgb. The ragged tail of N
//     and of L is masked.
//
// The math follows _render_block_kernel: the same rsqrt(max(sum, 1e-6))
// normalisation, the same where(den == 0) guards and the same clips. The
// file is built with -fmad=false: at low roughness the GGX D term near its
// peak, alpha^2 / (pi (cos_nh^2 (alpha^2 - 1) + 1)^2), turns a last-bit
// difference in cos_nh into a relative error of ~1e-2 (rough 0.05), and FMA
// contraction alone gave such differences. That chain (s, h, cos_nh, t)
// rounds exactly as the plain version's; what follows it is well
// conditioned and need not. With RENDER_REGROUP (the
// default) three well-conditioned places use an explicit fmaf (the Schlick
// term, the sum of non-negatives under Smith's square root, the three
// accumulations), and Smith's divide for the light and D's divide are one
// divide of the product of their numerators by the product of their
// denominators, each == 0 guard kept as its own select; the denominators'
// product is at least pi rough^10 and cannot underflow where D's own
// denominator, pi rough^8, does not. With RENDER_APPROX (the default) that
// divide, the divide by 4 |cos_ln| |cos_vn| and Smith's square root for the
// light are the card's approximate ones (2 ulp), in place of IEEE sequences
// of about ten instructions each. kernels/render.py evaluates the
// regrouped arithmetic in plain PyTorch (fused_brdf_render_regrouped),
// with the approximate operations as 2-ulp perturbations, and the CPU
// tests hold it to the plain version. Forward only.

#include <cuda_runtime.h>

#ifndef RENDER_LIGHTS
#define RENDER_LIGHTS 4  // lights a lane a step in the vector instance
#endif
#ifndef RENDER_MIN_BLOCKS
#define RENDER_MIN_BLOCKS 2  // blocks an SM that ptxas sizes registers for
#endif
#ifndef RENDER_REGROUP
#define RENDER_REGROUP 1
#endif
#ifndef RENDER_APPROX
#define RENDER_APPROX 1
#endif

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kSteps = 4;  // steps whose lvis loads are in flight together
constexpr float kPi = 3.14159265358979323846f;
constexpr float kInvPi = 0.318309886183790671538f;  // float(1 / pi)

template <int W> struct Vec;
template <> struct Vec<1> { using type = float; };
template <> struct Vec<2> { using type = float2; };
template <> struct Vec<4> { using type = float4; };

// W floats from global memory, read once: one streaming load.
template <int W>
__device__ __forceinline__ void load_streaming(const float *p, float (&v)[W]) {
  using T = typename Vec<W>::type;
  const T t = __ldcs(reinterpret_cast<const T *>(p));
  const float *f = reinterpret_cast<const float *>(&t);
#pragma unroll
  for (int i = 0; i < W; ++i) v[i] = f[i];
}

// W floats from shared memory in one load.
template <int W>
__device__ __forceinline__ void load_shared(const float *p, float (&v)[W]) {
  using T = typename Vec<W>::type;
  const T t = *reinterpret_cast<const T *>(p);
  const float *f = reinterpret_cast<const float *>(&t);
#pragma unroll
  for (int i = 0; i < W; ++i) v[i] = f[i];
}

// rsqrtf's result for any argument above fp32's subnormals, which
// max(sum, 1e-6) always is, without rsqrtf's scaling of subnormal ones.
__device__ __forceinline__ float rsqrt_normal(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The divide and the square root of the well-conditioned terms: within 2
// ulp with RENDER_APPROX (one MUFU and a multiply), IEEE without it.
__device__ __forceinline__ float divide(float a, float b) {
#if RENDER_APPROX
  return __fdividef(a, b);
#else
  return a / b;
#endif
}

__device__ __forceinline__ float square_root(float x) {
#if RENDER_APPROX
  float y;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
#else
  return sqrtf(x);
#endif
}

__device__ __forceinline__ void safe_norm3(float &x, float &y, float &z) {
  const float inv = rsqrt_normal(fmaxf(x * x + y * y + z * z, 1e-6f));
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

// What a ray's lights share.
struct Ray {
  float x, y, z, nx, ny, nz, vx, vy, vz;
  float alpha2, one_m_alpha2, g_v, abs_cos_vn4;
  float a0, a1, a2, f00, f01, f02, omf00, omf01, omf02;
};

// One ray-light pair, added into the lane's three sums.
template <bool HAS_LVIS>
__device__ __forceinline__ void shade(const Ray &r, float lx, float ly,
                                      float lz, float lr, float lg, float lb,
                                      float area, float lvis, float &acc0,
                                      float &acc1, float &acc2) {
  float sx = lx - r.x, sy = ly - r.y, sz = lz - r.z;
  safe_norm3(sx, sy, sz);
  float hx = sx + r.vx, hy = sy + r.vy, hz = sz + r.vz;
  safe_norm3(hx, hy, hz);

  const float cos_vh =
      fminf(fmaxf(hx * r.vx + hy * r.vy + hz * r.vz, 0.0f), 1.0f);
  const float cos_nh =
      fminf(fmaxf(hx * r.nx + hy * r.ny + hz * r.nz, 0.0f), 1.0f);
  const float cos_ln = sx * r.nx + sy * r.ny + sz * r.nz;

  const float t = cos_nh * cos_nh * (r.alpha2 - 1.0f) + 1.0f;
  const float den_d = kPi * (t * t);
#if RENDER_REGROUP
  const float c = fminf(fmaxf(cos_ln, 0.0f), 1.0f);
  const float den_g =
      c + square_root(fabsf(fmaf(r.one_m_alpha2, c * c, r.alpha2)));
  const float q = divide((2.0f * c) * r.alpha2, den_g * den_d);
  const float gd_num = (den_g == 0.0f || den_d == 0.0f) ? 0.0f : q * r.g_v;
#else
  const float d = den_d == 0.0f ? 0.0f : r.alpha2 / den_d;
  const float gd_num = (gsub(cos_ln, r.alpha2) * r.g_v) * d;
#endif
  const float den_spec = fabsf(cos_ln) * r.abs_cos_vn4;
  const float gd = den_spec == 0.0f ? 0.0f : divide(gd_num, den_spec);

  float lv = cos_ln > 0.0f ? 1.0f : 0.0f;
  if (HAS_LVIS) lv *= lvis;
  const float weight = lv * cos_ln * area;
  const float u = 1.0f - cos_vh;
  const float u2 = u * u;
  const float u5 = u2 * u2 * u;

#if RENDER_REGROUP
  acc0 = fmaf((fmaf(r.omf00, u5, r.f00) * gd + r.a0) * weight, lr, acc0);
  acc1 = fmaf((fmaf(r.omf01, u5, r.f01) * gd + r.a1) * weight, lg, acc1);
  acc2 = fmaf((fmaf(r.omf02, u5, r.f02) * gd + r.a2) * weight, lb, acc2);
#else
  acc0 += ((r.f00 + (1.0f - r.f00) * u5) * gd + r.a0) * weight * lr;
  acc1 += ((r.f01 + (1.0f - r.f01) * u5) * gd + r.a1) * weight * lg;
  acc2 += ((r.f02 + (1.0f - r.f02) * u5) * gd + r.a2) * weight * lb;
#endif
}

// kLights: lights a lane a step; l must be a multiple of it, and lvis
// aligned to 4 kLights bytes.
template <int kLights, bool HAS_LVIS>
__global__ void __launch_bounds__(kThreads, RENDER_MIN_BLOCKS)
    render_kernel(const float *__restrict__ xyz, const float *__restrict__ normal,
                  const float *__restrict__ surf2c,
                  const float *__restrict__ albedo,
                  const float *__restrict__ rough, const float *__restrict__ f0,
                  const float *__restrict__ lvis,
                  const float *__restrict__ lights, float *__restrict__ out,
                  int n, int l) {
  extern __shared__ __align__(16) float s_lights[];  // [8, L]
  for (int i = threadIdx.x; i < 8 * l; i += blockDim.x) s_lights[i] = lights[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int stride = gridDim.x * kWarpsPerBlock;

  // The ray's 16 floats: lane 3 g + c takes component c of array g (xyz,
  // normal, surf2c, albedo, f0), lane 15 takes rough.
  const int group = lane / 3;
  const float *my_array =
      group == 0 ? xyz : group == 1 ? normal : group == 2 ? surf2c
      : group == 3 ? albedo : group == 4 ? f0 : rough;
  if (lane < 15) my_array += lane % 3;
  const int my_stride = lane < 15 ? 3 : 1;
  auto fetch = [&](int ray) {
    return (lane < 16 && ray < n) ? __ldg(my_array + (size_t)ray * my_stride)
                                  : 0.0f;
  };

  int ray = blockIdx.x * kWarpsPerBlock + warp;
  float fetched = fetch(ray);
  for (; ray < n; ray += stride) {
    const float mine = fetched;
    fetched = fetch(ray + stride);
    auto get = [&](int src) { return __shfl_sync(0xffffffffu, mine, src); };
    Ray r;
    r.x = get(0), r.y = get(1), r.z = get(2);
    r.nx = get(3), r.ny = get(4), r.nz = get(5);
    r.vx = get(6), r.vy = get(7), r.vz = get(8);
    safe_norm3(r.nx, r.ny, r.nz);
    safe_norm3(r.vx, r.vy, r.vz);
    r.a0 = get(9) * kInvPi, r.a1 = get(10) * kInvPi, r.a2 = get(11) * kInvPi;
    r.f00 = get(12), r.f01 = get(13), r.f02 = get(14);
    r.omf00 = 1.0f - r.f00, r.omf01 = 1.0f - r.f01, r.omf02 = 1.0f - r.f02;
    const float ro = get(15);
    r.alpha2 = (ro * ro) * (ro * ro);
    r.one_m_alpha2 = 1.0f - r.alpha2;
    const float cos_vn = r.nx * r.vx + r.ny * r.vy + r.nz * r.vz;
    r.g_v = gsub(cos_vn, r.alpha2);
    r.abs_cos_vn4 = 4.0f * fabsf(cos_vn);
    const float *lvis_row = HAS_LVIS ? lvis + (size_t)ray * l : nullptr;

    float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f;
    for (int base = 0; base < l; base += kSteps * 32 * kLights) {
      float lv[kSteps][kLights];
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        const int j = base + (s * 32 + lane) * kLights;
        if (HAS_LVIS && j < l) load_streaming<kLights>(lvis_row + j, lv[s]);
      }
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        const int j = base + (s * 32 + lane) * kLights;
        if (j < l) {
          float t[7][kLights];  // lx, ly, lz, r, g, b, area
#pragma unroll
          for (int row = 0; row < 7; ++row)
            load_shared<kLights>(s_lights + row * l + j, t[row]);
#pragma unroll
          for (int i = 0; i < kLights; ++i)
            shade<HAS_LVIS>(r, t[0][i], t[1][i], t[2][i], t[3][i], t[4][i],
                            t[5][i], t[6][i], HAS_LVIS ? lv[s][i] : 1.0f,
                            acc0, acc1, acc2);
        }
      }
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

// A grid that fits the card at once (the kernel's own occupancy times the
// SMs of `device`), or fewer blocks when n needs fewer.
template <int kLights, bool HAS_LVIS>
int launch(const float *xyz, const float *normal, const float *surf2c,
           const float *albedo, const float *rough, const float *f0,
           const float *lvis, const float *lights, float *out, int n, int l,
           int device, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 8 * (size_t)l;
  int sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, render_kernel<kLights, HAS_LVIS>, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (sms < 1 || per_sm < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int fit = sms * per_sm;
  const int needed = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  render_kernel<kLights, HAS_LVIS>
      <<<needed < fit ? needed : fit, kThreads, smem, stream>>>(
          xyz, normal, surf2c, albedo, rough, f0, lvis, lights, out, n, l);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` of `device`; returns the CUDA error (0 on success).
// Pointers are device pointers to contiguous fp32 arrays: xyz, normal,
// surf2c, albedo, f0 [n, 3]; rough [n, 1]; lvis [n, l] or null; lights
// [8, l]; out [n, 3]; n >= 1. The caller keeps 8 * l floats within the
// default 48 KB of dynamic shared memory. *lights_per_lane receives the
// instance that ran: RENDER_LIGHTS (the vector instance) when l is a
// multiple of it and lvis, if given, is aligned to as many floats; else 1.
extern "C" int fused_brdf_render_launch(const float *xyz, const float *normal,
                                        const float *surf2c,
                                        const float *albedo, const float *rough,
                                        const float *f0, const float *lvis,
                                        const float *lights, float *out, int n,
                                        int l, int device, void *stream,
                                        int *lights_per_lane) {
  if (device < 0 || n < 1 || l < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int previous = 0;
  cudaError_t err = cudaGetDevice(&previous);
  if (err == cudaSuccess && previous != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec =
      RENDER_LIGHTS > 1 && l % RENDER_LIGHTS == 0 &&
      reinterpret_cast<size_t>(lvis) % (sizeof(float) * RENDER_LIGHTS) == 0;
  *lights_per_lane = vec ? RENDER_LIGHTS : 1;
  int rc;
  if (vec && lvis)
    rc = launch<RENDER_LIGHTS, true>(xyz, normal, surf2c, albedo, rough, f0,
                                     lvis, lights, out, n, l, device, s);
  else if (vec)
    rc = launch<RENDER_LIGHTS, false>(xyz, normal, surf2c, albedo, rough, f0,
                                      lvis, lights, out, n, l, device, s);
  else if (lvis)
    rc = launch<1, true>(xyz, normal, surf2c, albedo, rough, f0, lvis, lights,
                         out, n, l, device, s);
  else
    rc = launch<1, false>(xyz, normal, surf2c, albedo, rough, f0, lvis, lights,
                          out, n, l, device, s);
  if (previous != device) cudaSetDevice(previous);
  return rc;
}
