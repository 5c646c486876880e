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
//
// The multi-map kernel (render_maps_kernel, fused_brdf_render_maps_launch)
// replaces no TPU kernel: the JAX package relights through its plain path,
// [N, L, 3] BRDF tensors contracted with each stack of maps. It renders E
// light maps at once (a relight request's learned light, probes and OLATs)
// and returns pre-gamma rgb [N, E, 3]. Per pair it evaluates the BRDF and
// weight once with kernel 1's arithmetic (pair_terms, the same build), and
// adds the three terms, each times map e's light value, into 3 E sums
// (accumulate, in kernel 1's order). Its chain into the GGX term rounds as
// the plain relight path it replaces (microfacet_brdf over calc_ldir, on
// the card) does, and not as kernel 1's: the light direction normalised
// twice, and the norms and dot products in PyTorch's orders (AS_TORCH).
// With kernel 1's chain the GGX peak at roughness 0.2 put 2.2e-4 between
// its sRGB renders and the plain path's, which the relight benchmark
// allows 2e-4; with this one every cos_nh of a relight chunk has the plain
// path's bits (against einsum on the card).
//
// What bounds it: per pair one lvis float, as kernel 1, and about 60 + 3 E
// fp32 operations (225 at E = 21: 30.2 GFLOP a 512x512 view, 0.45 ms at 67
// TFLOP/s, against 620 MB of lvis and outputs, 0.185 ms at 3.35 TB/s), so
// instruction issue: kernel 1's chain, and per map 3 FMAs and 3/kLights
// shared loads. The 24-map loop takes 228
// instructions a pair (72 FFMA, 19 LDS), an issue floor of 0.17 ms a chunk
// of 49,152 rays at 1,980 MHz; the card takes 0.41 ms, with 8 warps an SM.
// What the design does about it:
//   * kernel 1's mapping, loads and step order, with 3 kMaps sums a lane in
//     registers (kMaps 8 or 24, a template parameter, so every sum has a
//     fixed register); for a light a lane loads each map's channel from
//     shared memory as one 16-byte load of its four lights and issues four
//     FMAs;
//   * the table of a pass ([4 + 3 kMaps, L]: lxyz, area, the maps' rows;
//     152 KB at kMaps = 24, L = 512) in shared memory, above the default
//     48 KB by cudaFuncSetAttribute; one block of 8 warps an SM at that
//     size. 8 warps keep every sum in registers (254 of them in the 24-map
//     lvis instance); 12 ran a chunk in 0.33 ms, but ptxas then spilled
//     64-104 bytes a thread, and 4 took 0.64 ms;
//   * the 24-map instance while its table fits a block (L up to 764; E =
//     21: one pass, three rows of zeros; fewer maps pad with more), else
//     the 8-map one (L up to 2,075). Past kMaps maps, passes of kMaps maps,
//     one launch each: each pair's BRDF is evaluated ceil(E / kMaps) times,
//     once for the relight pass's 21 maps;
//   * the 3 kMaps sums a lane are reduced over the warp by halving
//     exchanges (LaneSum: 36 + 18 + 9 + 9 + 9 shuffles for 72 sums, where
//     kernel 1's tree would take 360), the same tree pair for pair, and 8
//     lanes write a ray's 3 E values.

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

// A norm and a dot product of 3-vectors. AS_TORCH rounds them as
// PyTorch's operations on the card do: torch.sum over a last dimension of 3
// adds (x^2 + z^2) + y^2, and einsum's contraction over 3 (cuBLAS gemv)
// gives z b_z + fma(y, b_y, x b_x) (both read off the card against every
// pair of a relight chunk, under PyTorch 2.11.0+cu128 and cuBLAS 12.9.2).
// The multi-map kernel's chain into the GGX term takes them so that it
// rounds as the plain relight path's does. No API promises these orders:
// tests/test_torch_cuda.py::test_torch_keeps_the_orders_the_maps_kernel_copies
// holds them at the relight pass's chunks (49,152 and 16,384 rows); at
// 1,000 rows cuBLAS already takes another order for the dot products.
template <bool AS_TORCH = false>
__device__ __forceinline__ void safe_norm3(float &x, float &y, float &z) {
  float ss;
  if constexpr (AS_TORCH)
    ss = (x * x + z * z) + y * y;
  else
    ss = x * x + y * y + z * z;
  const float inv = rsqrt_normal(fmaxf(ss, 1e-6f));
  x *= inv;
  y *= inv;
  z *= inv;
}

template <bool AS_TORCH = false>
__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  if constexpr (AS_TORCH)
    return az * bz + fmaf(ay, by, ax * bx);
  else
    return ax * bx + ay * by + az * bz;
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

// A warp reads a ray's 16 floats with one load a lane: lane 3 g + c takes
// component c of array g (xyz, normal, surf2c, albedo, f0), lane 15 takes
// rough, lanes 16-31 nothing.
struct RayFetch {
  const float *p;
  int stride, n;
  bool reads;
  __device__ RayFetch(const float *xyz, const float *normal,
                      const float *surf2c, const float *albedo,
                      const float *rough, const float *f0, int n, int lane)
      : n(n), reads(lane < 16) {
    const int group = lane / 3;
    p = group == 0 ? xyz : group == 1 ? normal : group == 2 ? surf2c
        : group == 3 ? albedo : group == 4 ? f0 : rough;
    if (lane < 15) p += lane % 3;
    stride = lane < 15 ? 3 : 1;
  }
  __device__ float operator()(int ray) const {
    return (reads && ray < n) ? __ldg(p + (size_t)ray * stride) : 0.0f;
  }
};

// The ray that RayFetch spread over the warp's lanes (``mine``), gathered
// by 16 shuffles, with what its lights share worked out; AS_TORCH: its
// normal and view direction normalised as the plain path does.
template <bool AS_TORCH>
__device__ __forceinline__ Ray unpack_ray(float mine) {
  auto get = [&](int src) { return __shfl_sync(0xffffffffu, mine, src); };
  Ray r;
  r.x = get(0), r.y = get(1), r.z = get(2);
  r.nx = get(3), r.ny = get(4), r.nz = get(5);
  r.vx = get(6), r.vy = get(7), r.vz = get(8);
  safe_norm3<AS_TORCH>(r.nx, r.ny, r.nz);
  safe_norm3<AS_TORCH>(r.vx, r.vy, r.vz);
  r.a0 = get(9) * kInvPi, r.a1 = get(10) * kInvPi, r.a2 = get(11) * kInvPi;
  r.f00 = get(12), r.f01 = get(13), r.f02 = get(14);
  r.omf00 = 1.0f - r.f00, r.omf01 = 1.0f - r.f01, r.omf02 = 1.0f - r.f02;
  const float ro = get(15);
  r.alpha2 = (ro * ro) * (ro * ro);
  r.one_m_alpha2 = 1.0f - r.alpha2;
  const float cos_vn = r.nx * r.vx + r.ny * r.vy + r.nz * r.vz;
  r.g_v = gsub(cos_vn, r.alpha2);
  r.abs_cos_vn4 = 4.0f * fabsf(cos_vn);
  return r;
}

// One ray-light pair's per-channel term (F_c gd + albedo_c / pi) weight,
// which a light's rgb then scales: what the pair adds to a map. AS_TORCH
// (the multi-map kernel): the light direction normalised twice, as the
// plain path's calc_ldir and microfacet_brdf do, and the norms and dot
// products rounded as theirs.
template <bool HAS_LVIS, bool AS_TORCH = false>
__device__ __forceinline__ void pair_terms(const Ray &r, float lx, float ly,
                                           float lz, float area, float lvis,
                                           float &t0, float &t1, float &t2) {
  float sx = lx - r.x, sy = ly - r.y, sz = lz - r.z;
  safe_norm3<AS_TORCH>(sx, sy, sz);
  if constexpr (AS_TORCH) safe_norm3<true>(sx, sy, sz);
  float hx = sx + r.vx, hy = sy + r.vy, hz = sz + r.vz;
  safe_norm3<AS_TORCH>(hx, hy, hz);

  const float cos_vh =
      fminf(fmaxf(dot3<AS_TORCH>(hx, hy, hz, r.vx, r.vy, r.vz), 0.0f), 1.0f);
  const float cos_nh =
      fminf(fmaxf(dot3<AS_TORCH>(hx, hy, hz, r.nx, r.ny, r.nz), 0.0f), 1.0f);
  const float cos_ln = dot3<AS_TORCH>(sx, sy, sz, r.nx, r.ny, r.nz);

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
  t0 = (fmaf(r.omf00, u5, r.f00) * gd + r.a0) * weight;
  t1 = (fmaf(r.omf01, u5, r.f01) * gd + r.a1) * weight;
  t2 = (fmaf(r.omf02, u5, r.f02) * gd + r.a2) * weight;
#else
  t0 = ((r.f00 + (1.0f - r.f00) * u5) * gd + r.a0) * weight;
  t1 = ((r.f01 + (1.0f - r.f01) * u5) * gd + r.a1) * weight;
  t2 = ((r.f02 + (1.0f - r.f02) * u5) * gd + r.a2) * weight;
#endif
}

// A pair's term scaled by one light value, added into a sum.
__device__ __forceinline__ void accumulate(float term, float light,
                                           float &acc) {
#if RENDER_REGROUP
  acc = fmaf(term, light, acc);
#else
  acc += term * light;
#endif
}

// One ray-light pair, added into the lane's three sums.
template <bool HAS_LVIS>
__device__ __forceinline__ void shade(const Ray &r, float lx, float ly,
                                      float lz, float lr, float lg, float lb,
                                      float area, float lvis, float &acc0,
                                      float &acc1, float &acc2) {
  float t0, t1, t2;
  pair_terms<HAS_LVIS>(r, lx, ly, lz, area, lvis, t0, t1, t2);
  accumulate(t0, lr, acc0);
  accumulate(t1, lg, acc1);
  accumulate(t2, lb, acc2);
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
  const RayFetch fetch(xyz, normal, surf2c, albedo, rough, f0, n, lane);

  int ray = blockIdx.x * kWarpsPerBlock + warp;
  float fetched = fetch(ray);
  for (; ray < n; ray += stride) {
    const float mine = fetched;
    fetched = fetch(ray + stride);
    const Ray r = unpack_ray<false>(mine);
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

// ---- the multi-map kernel ------------------------------------------------

constexpr int kMapsWarpsPerBlock = 8;
constexpr int kMapsThreads = kMapsWarpsPerBlock * 32;
constexpr int kTableRows = 4;   // lx, ly, lz, area ahead of the maps' rows
constexpr int kFewMaps = 8;     // maps a pass of the small instance
constexpr int kManyMaps = 24;   // maps a pass of the large instance

// Sums each of a lane's N values over the warp's 32 lanes. At each offset
// O (16, 8, .., 1) a lane and its partner lane ^ O add their values: while
// N is even, each keeps one half of them (the lane with bit O set the upper
// half) and sends the other, so a level costs N / 2 shuffles; once N is
// odd, both keep all N. Every sum is the tree of kernel 1's
// __shfl_down_sync reduction, pair for pair (an addition gives the same
// bits in either order). ``first`` receives the index of this lane's
// first sum; v[0 .. kOut) hold its sums, and the lanes that differ only in
// the bits of kSame hold the same ones.
template <int N, int O>
struct LaneSum {
  static constexpr bool kHalve = N % 2 == 0;
  static constexpr int kNext = kHalve ? N / 2 : N;
  using Rest = LaneSum<kNext, O / 2>;
  static constexpr int kOut = Rest::kOut;
  static constexpr int kSame = (kHalve ? 0 : O) | Rest::kSame;
  template <int V>
  static __device__ __forceinline__ void run(float (&v)[V], int lane,
                                             int &first) {
    const bool up = (lane & O) != 0;
    if constexpr (kHalve) {
#pragma unroll
      for (int k = 0; k < kNext; ++k) {
        const float lo = v[k], hi = v[k + kNext];
        const float got = __shfl_xor_sync(0xffffffffu, up ? lo : hi, O);
        v[k] = (up ? hi : lo) + got;
      }
      if (up) first += kNext;
    } else {
#pragma unroll
      for (int k = 0; k < N; ++k)
        v[k] += __shfl_xor_sync(0xffffffffu, v[k], O);
    }
    Rest::run(v, lane, first);
  }
};

template <int N>
struct LaneSum<N, 0> {
  static constexpr int kOut = N;
  static constexpr int kSame = 0;
  template <int V>
  static __device__ __forceinline__ void run(float (&)[V], int, int &) {}
};

// Maps first .. first + kMaps - 1 of ``maps`` for every ray: the pair's
// terms once, then 3 kMaps sums a lane in registers. table: [4 + 3 maps, L]
// (lxyz, area, then map e's rgb in rows 4 + 3 e + c); the pass's rows, with
// zero rows for maps past the last, live in shared memory.
template <int kLights, bool HAS_LVIS, int kMaps>
__global__ void __launch_bounds__(kMapsThreads, 1)
    render_maps_kernel(const float *__restrict__ xyz,
                       const float *__restrict__ normal,
                       const float *__restrict__ surf2c,
                       const float *__restrict__ albedo,
                       const float *__restrict__ rough,
                       const float *__restrict__ f0,
                       const float *__restrict__ lvis,
                       const float *__restrict__ table,
                       float *__restrict__ out, int n, int l, int maps,
                       int first) {
  constexpr int kSums = 3 * kMaps;
  extern __shared__ __align__(16) float s_table[];  // [4 + 3 kMaps, L]
  const int rows = kTableRows + 3 * min(kMaps, maps - first);
  const size_t skip = (size_t)3 * first * l;  // the earlier passes' rows
  for (int i = threadIdx.x; i < (kTableRows + kSums) * l; i += blockDim.x) {
    const int row = i / l;
    s_table[i] = row >= rows ? 0.0f
                 : table[row < kTableRows ? (size_t)i : i + skip];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int stride = gridDim.x * kMapsWarpsPerBlock;
  const RayFetch fetch(xyz, normal, surf2c, albedo, rough, f0, n, lane);
  using Sum = LaneSum<kSums, 16>;
  const int sums_left = 3 * (maps - first);

  int ray = blockIdx.x * kMapsWarpsPerBlock + warp;
  float fetched = fetch(ray);
  for (; ray < n; ray += stride) {
    const float mine = fetched;
    fetched = fetch(ray + stride);
    const Ray r = unpack_ray<true>(mine);
    const float *lvis_row = HAS_LVIS ? lvis + (size_t)ray * l : nullptr;

    float acc[kSums];
#pragma unroll
    for (int k = 0; k < kSums; ++k) acc[k] = 0.0f;
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
          float g[kTableRows][kLights];  // lx, ly, lz, area
#pragma unroll
          for (int row = 0; row < kTableRows; ++row)
            load_shared<kLights>(s_table + row * l + j, g[row]);
          float t[3][kLights];
#pragma unroll
          for (int i = 0; i < kLights; ++i)
            pair_terms<HAS_LVIS, true>(r, g[0][i], g[1][i], g[2][i], g[3][i],
                                 HAS_LVIS ? lv[s][i] : 1.0f, t[0][i], t[1][i],
                                 t[2][i]);
#pragma unroll
          for (int k = 0; k < kSums; ++k) {
            float w[kLights];
            load_shared<kLights>(s_table + (kTableRows + k) * l + j, w);
#pragma unroll
            for (int i = 0; i < kLights; ++i)
              accumulate(t[k % 3][i], w[i], acc[k]);
          }
        }
      }
    }
    int mine_first = 0;
    Sum::run(acc, lane, mine_first);
    if ((lane & Sum::kSame) == 0) {
      float *o = out + ((size_t)ray * maps + first) * 3;
#pragma unroll
      for (int k = 0; k < Sum::kOut; ++k)
        if (mine_first + k < sums_left) o[mine_first + k] = acc[k];
    }
  }
}

// Every pass of kMaps maps, each a launch of a grid that fits the card at
// once; the table's shared memory above the default 48 KB is asked for.
template <int kLights, bool HAS_LVIS, int kMaps>
int launch_maps(const float *xyz, const float *normal, const float *surf2c,
                const float *albedo, const float *rough, const float *f0,
                const float *lvis, const float *table, float *out, int n,
                int l, int maps, int device, cudaStream_t stream) {
  auto kernel = render_maps_kernel<kLights, HAS_LVIS, kMaps>;
  const size_t smem = sizeof(float) * (kTableRows + 3 * kMaps) * (size_t)l;
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kMapsThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (sms < 1 || per_sm < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int fit = sms * per_sm;
  const int needed = (n + kMapsWarpsPerBlock - 1) / kMapsWarpsPerBlock;
  for (int first = 0; first < maps; first += kMaps) {
    kernel<<<needed < fit ? needed : fit, kMapsThreads, smem, stream>>>(
        xyz, normal, surf2c, albedo, rough, f0, lvis, table, out, n, l, maps,
        first);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

template <int kMaps>
int launch_maps_instance(bool vec, const float *xyz, const float *normal,
                         const float *surf2c, const float *albedo,
                         const float *rough, const float *f0,
                         const float *lvis, const float *table, float *out,
                         int n, int l, int maps, int device,
                         cudaStream_t s) {
  if (vec && lvis)
    return launch_maps<RENDER_LIGHTS, true, kMaps>(
        xyz, normal, surf2c, albedo, rough, f0, lvis, table, out, n, l, maps,
        device, s);
  if (vec)
    return launch_maps<RENDER_LIGHTS, false, kMaps>(
        xyz, normal, surf2c, albedo, rough, f0, lvis, table, out, n, l, maps,
        device, s);
  if (lvis)
    return launch_maps<1, true, kMaps>(xyz, normal, surf2c, albedo, rough, f0,
                                       lvis, table, out, n, l, maps, device,
                                       s);
  return launch_maps<1, false, kMaps>(xyz, normal, surf2c, albedo, rough, f0,
                                      lvis, table, out, n, l, maps, device, s);
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

// Launch on `stream` of `device`; returns the CUDA error (0 on success).
// Pointers as fused_brdf_render_launch's, but table [4 + 3 maps, l] (lxyz,
// area, then map e's rgb in rows 4 + 3 e + c) and out [n, maps, 3]; n >= 1,
// maps >= 1. The pass takes 24 maps where the table's rows of 24 maps fit
// a block's shared memory, else 8; maps past a pass are the next pass, one
// launch each. *lights_per_lane receives the
// instance as fused_brdf_render_launch's does, *maps_per_pass the pass.
extern "C" int fused_brdf_render_maps_launch(
    const float *xyz, const float *normal, const float *surf2c,
    const float *albedo, const float *rough, const float *f0,
    const float *lvis, const float *table, float *out, int n, int l, int maps,
    int device, void *stream, int *lights_per_lane, int *maps_per_pass) {
  if (device < 0 || n < 1 || l < 1 || maps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int previous = 0;
  cudaError_t err = cudaGetDevice(&previous);
  if (err == cudaSuccess && previous != device) err = cudaSetDevice(device);
  int optin = 0;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto fits = [&](int k) {
    return sizeof(float) * (kTableRows + 3 * k) * (size_t)l <= (size_t)optin;
  };
  const int k = fits(kManyMaps) ? kManyMaps : kFewMaps;
  int rc = static_cast<int>(cudaErrorInvalidValue);
  if (fits(k)) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool vec =
        RENDER_LIGHTS > 1 && l % RENDER_LIGHTS == 0 &&
        reinterpret_cast<size_t>(lvis) % (sizeof(float) * RENDER_LIGHTS) == 0;
    *lights_per_lane = vec ? RENDER_LIGHTS : 1;
    *maps_per_pass = k;
    rc = k == kManyMaps
             ? launch_maps_instance<kManyMaps>(vec, xyz, normal, surf2c,
                                               albedo, rough, f0, lvis, table,
                                               out, n, l, maps, device, s)
             : launch_maps_instance<kFewMaps>(vec, xyz, normal, surf2c,
                                              albedo, rough, f0, lvis, table,
                                              out, n, l, maps, device, s);
  }
  if (previous != device) cudaSetDevice(previous);
  return rc;
}
