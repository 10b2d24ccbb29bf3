// Pyramidal inverse-compositional Lucas-Kanade, the whole pyramid in one
// launch, for NVIDIA Hopper (sm_90a).  Built with nvcc into the port's
// shared library with a plain C interface and loaded through ctypes
// (plviwo_tpu_torch/ops/cuda_lib.py builds it at first use).
//
// Replaces: the Pallas TPU kernel plviwo_tpu/ops/lk_kernel.py::_lk_kernel
// (pallas_call in lk_level_kernel, driven level by level by
// _lk_level_pallas / pyramidal_lk_pallas), together with the patch
// extraction that stays outside it on the TPU (ops/klt.py::_extract_patches).
// Same arithmetic per feature and level (ops/klt.py::_lk_level_conv):
//   integer patch origins: floor, offset, clip to [0, dim - PS]
//     (template from uv_prev / 2^l, target from the level's initial guess)
//   extended (W+2)^2 template from triangle taps at the subpixel offset,
//   central-difference gradients, the 2x2 normal matrix (a, b, c, det),
//   `iters` Gauss-Newton steps resampling the W x W target window,
//   mean |I - T|, the drift-budget in_patch and image-bounds tests;
//   uv and ok carried coarse to fine, drift D = `drift` at the coarsest
//   level and `drift_fine` below.
// Sampling keeps the meaning of the JAX KS-tap sum, not its cost: only the
// two taps floor(u) and floor(u) + 1 of tri(u - k) can be nonzero, and each
// counts only when it lies in [0, KS), which equals the full sum for every
// u, also one that strays outside the patch.  The products and sums of a
// sample are rounded one by one (__fmul_rn / __fadd_rn, never contracted to
// FMA), so a sampled value equals the plain PyTorch version's bit for bit;
// only the block reductions sum in another order.  Masked or degenerate
// steps select (bad = det < 1e-8 gives dx = dy = 0), never multiply.
//
// What bounds it on this card: at B = 64 sequences, N = 128 features and
// 640 x 480 the kernel reads two patches per feature and level (29^2 and
// 2 x 23^2 pixels), at most ~124 MB, and does ~0.6 GFLOP of FP32 work:
// bound by memory, tens of microseconds.  The design:
//   one block per (feature, sequence), grid (N, B): all sequences in one
//   launch, no vmap rule needed; 256 threads, one per window pixel
//   (W^2 = 225); both patches read once per level straight from the
//   pyramid level images into shared memory (no (PS, PS, N) tensor in
//   device memory); the template and its gradients stay in registers for
//   all iterations; each step is one block reduction of (bx, by).
// Not done yet: several features per block to fill the idle 31 threads
// and overlap one feature's loads with another's iterations.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // >= W^2 (one thread per window pixel)
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLevels = 4;

struct Levels {
  const float* prev[kMaxLevels];  // (B, H_l, W_l) each, contiguous
  const float* next[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide sums of x, y, z; every thread gets the same totals.
__device__ __forceinline__ void block_sum3(float& x, float& y, float& z, float* red) {
  x = warp_sum(x);
  y = warp_sum(y);
  z = warp_sum(z);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // the previous reduction's reads of red are done
  if (lane == 0) {
    red[warp] = x;
    red[kWarps + warp] = y;
    red[2 * kWarps + warp] = z;
  }
  __syncthreads();
  x = 0.f;
  y = 0.f;
  z = 0.f;
  for (int i = 0; i < kWarps; ++i) {
    x += red[i];
    y += red[kWarps + i];
    z += red[2 * kWarps + i];
  }
}

// The two taps of tri(u - k) that can be nonzero, k0 = floor(u) and
// k1 = k0 + 1, each counted only when it lies in [0, KS).  A tap that is
// not counted gets weight 0 and index 0 (always inside the patch).
struct Tap {
  int k0, k1;
  float w0, w1;
};

__device__ __forceinline__ Tap make_tap(float u, int KS) {
  const float f0 = floorf(u);
  const float fr = __fsub_rn(u, f0);
  const bool in0 = f0 >= 0.f && f0 <= (float)(KS - 1);
  const bool in1 = f0 >= -1.f && f0 <= (float)(KS - 2);
  Tap t;
  t.w0 = in0 ? __fsub_rn(1.f, fr) : 0.f;
  t.w1 = in1 ? fr : 0.f;
  t.k0 = in0 ? (int)f0 : 0;
  t.k1 = in1 ? (int)f0 + 1 : 0;
  return t;
}

// Window sample at (row r, col c) of a PS-wide patch: rows first, then
// columns, as the separable JAX sum takes them.
__device__ __forceinline__ float sample(const float* P, int PS, const Tap& ty,
                                        const Tap& tx, int r, int c) {
  const float* p0 = P + (r + ty.k0) * PS + c;
  const float* p1 = P + (r + ty.k1) * PS + c;
  const float a0 = __fadd_rn(__fmul_rn(p0[tx.k0], ty.w0), __fmul_rn(p1[tx.k0], ty.w1));
  const float a1 = __fadd_rn(__fmul_rn(p0[tx.k1], ty.w0), __fmul_rn(p1[tx.k1], ty.w1));
  return __fadd_rn(__fmul_rn(a0, tx.w0), __fmul_rn(a1, tx.w1));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(kThreads) lk_pyramid_kernel(
    Levels lv, int levels, const float* __restrict__ uv_prev,
    const unsigned char* __restrict__ valid, int N, int half, int iters,
    int drift, int drift_fine, float max_err, float* __restrict__ uv_out,
    unsigned char* __restrict__ ok_out, float* __restrict__ err_out,
    float* __restrict__ det_out) {
  extern __shared__ float smem[];
  __shared__ float red[3 * kWarps];
  const int f = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int W = 2 * half + 1, W2 = W + 2, npx = W * W;
  const int ps_max = W + 2 * (drift > drift_fine ? drift : drift_fine) + 4;
  float* Pp = smem;                 // template patch, PS x PS
  float* Pn = Pp + ps_max * ps_max;  // target patch
  float* Text = Pn + ps_max * ps_max;  // extended template, W2 x W2

  const size_t feat = (size_t)b * N + f;
  const float upx = uv_prev[2 * feat], upy = uv_prev[2 * feat + 1];
  bool ok = valid[feat] != 0;
  // coarsest-level guess uv_prev / 2^(levels-1) (exact: a power of two)
  float ux = ldexpf(upx, -(levels - 1)), uy = ldexpf(upy, -(levels - 1));
  const int r = tid / W, c = tid % W;
  const bool pix = tid < npx;
  float err = 0.f, det = 0.f;

  for (int l = levels - 1; l >= 0; --l) {
    const int D = l == levels - 1 ? drift : drift_fine;
    const int KS = 2 * D + 3, PS = W + 2 * D + 4;
    const int H = lv.h[l], Wd = lv.w[l];
    const float* ip = lv.prev[l] + (size_t)b * H * Wd;
    const float* in = lv.next[l] + (size_t)b * H * Wd;
    const float px = ldexpf(upx, -l), py = ldexpf(upy, -l);
    const int oxp = clampi((int)floorf(px) - (half + 1) - (D + 1), 0, Wd - PS);
    const int oyp = clampi((int)floorf(py) - (half + 1) - (D + 1), 0, H - PS);
    const int oxg = clampi((int)floorf(ux) - half - (D + 1), 0, Wd - PS);
    const int oyg = clampi((int)floorf(uy) - half - (D + 1), 0, H - PS);

    __syncthreads();  // the previous level is done with the patches
    for (int i = tid; i < PS * PS; i += kThreads) {
      const int pr = i / PS, pc = i % PS;
      Pp[i] = ip[(size_t)(oyp + pr) * Wd + oxp + pc];
      Pn[i] = in[(size_t)(oyg + pr) * Wd + oxg + pc];
    }
    __syncthreads();

    // extended template at uv_prev - (half + 1)
    const Tap tty = make_tap(__fsub_rn(__fsub_rn(py, (float)oyp), (float)(half + 1)), KS);
    const Tap ttx = make_tap(__fsub_rn(__fsub_rn(px, (float)oxp), (float)(half + 1)), KS);
    for (int i = tid; i < W2 * W2; i += kThreads) Text[i] = sample(Pp, PS, tty, ttx, i / W2, i % W2);
    __syncthreads();

    float T = 0.f, Gx = 0.f, Gy = 0.f;
    if (pix) {
      T = Text[(r + 1) * W2 + c + 1];
      Gx = __fmul_rn(0.5f, __fsub_rn(Text[(r + 1) * W2 + c + 2], Text[(r + 1) * W2 + c]));
      Gy = __fmul_rn(0.5f, __fsub_rn(Text[(r + 2) * W2 + c + 1], Text[r * W2 + c + 1]));
    }
    float a = __fmul_rn(Gx, Gx), bb = __fmul_rn(Gx, Gy), cc = __fmul_rn(Gy, Gy);
    block_sum3(a, bb, cc, red);
    det = __fsub_rn(__fmul_rn(a, cc), __fmul_rn(bb, bb));
    const bool bad = det < 1e-8f;
    const float det_s = bad ? 1.f : det;
    const float ogx = (float)oxg, ogy = (float)oyg, fh = (float)half;

    for (int it = 0; it < iters; ++it) {
      const Tap ty = make_tap(__fsub_rn(__fsub_rn(uy, ogy), fh), KS);
      const Tap tx = make_tap(__fsub_rn(__fsub_rn(ux, ogx), fh), KS);
      const float e = pix ? __fsub_rn(sample(Pn, PS, ty, tx, r, c), T) : 0.f;
      float bx = __fmul_rn(Gx, e), by = __fmul_rn(Gy, e), unused = 0.f;
      block_sum3(bx, by, unused, red);
      const float dx = bad ? 0.f
          : __fdiv_rn(__fsub_rn(__fmul_rn(cc, bx), __fmul_rn(bb, by)), det_s);
      const float dy = bad ? 0.f
          : __fdiv_rn(__fadd_rn(__fmul_rn(-bb, bx), __fmul_rn(a, by)), det_s);
      ux = __fsub_rn(ux, dx);
      uy = __fsub_rn(uy, dy);
    }

    const float wy = __fsub_rn(__fsub_rn(uy, ogy), fh);
    const float wx = __fsub_rn(__fsub_rn(ux, ogx), fh);
    const float lim = (float)(PS - W - 1);
    const bool in_patch = wx >= 0.f && wx <= lim && wy >= 0.f && wy <= lim;
    const Tap ty = make_tap(wy, KS), tx = make_tap(wx, KS);
    float s = pix ? fabsf(__fsub_rn(sample(Pn, PS, ty, tx, r, c), T)) : 0.f, u0 = 0.f, u1 = 0.f;
    block_sum3(s, u0, u1, red);
    err = __fdiv_rn(s, (float)npx);
    const bool inb = ux > fh && ux < (float)(Wd - half - 1) && uy > fh &&
                     uy < (float)(H - half - 1) && in_patch;
    // a degenerate template at a coarse level leaves the estimate as it
    // is; only the finest level's conditioning kills the track
    ok = ok && inb && (l > 0 || det > 1e-6f);
    if (l > 0) {
      ux = __fmul_rn(ux, 2.f);
      uy = __fmul_rn(uy, 2.f);
    }
  }

  if (tid == 0) {
    uv_out[2 * feat] = ux;
    uv_out[2 * feat + 1] = uy;
    ok_out[feat] = (ok && err < max_err) ? 1 : 0;
    err_out[feat] = err;
    det_out[feat] = det;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block: both patches at the larger drift
// budget and the extended template.
size_t lk_pyramid_smem_bytes(int half, int drift, int drift_fine) {
  const int W = 2 * half + 1;
  const int ps = W + 2 * (drift > drift_fine ? drift : drift_fine) + 4;
  return sizeof(float) * (2 * (size_t)ps * ps + (size_t)(W + 2) * (W + 2));
}

const char* lk_pyramid_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// prev / next: host arrays of `levels` device pointers, level 0 first;
// heights / widths: host arrays of the level sizes.  Launches on `stream`
// and returns 0 or the cudaError_t of a refused launch.
int lk_pyramid(const float* const* prev, const float* const* next,
               const int* heights, const int* widths, int levels,
               const float* uv_prev, const unsigned char* valid, int B, int N,
               int half, int iters, int drift, int drift_fine, float max_err,
               float* uv, unsigned char* ok, float* err, float* det, void* stream) {
  if (levels < 1 || levels > kMaxLevels || (2 * half + 1) * (2 * half + 1) > kThreads ||
      B < 1 || N < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  Levels lv = {};
  for (int l = 0; l < levels; ++l) {
    lv.prev[l] = prev[l];
    lv.next[l] = next[l];
    lv.h[l] = heights[l];
    lv.w[l] = widths[l];
  }
  const size_t smem = lk_pyramid_smem_bytes(half, drift, drift_fine);
  lk_pyramid_kernel<<<dim3(N, B), kThreads, smem, (cudaStream_t)stream>>>(
      lv, levels, uv_prev, valid, N, half, iters, drift, drift_fine, max_err, uv, ok,
      err, det);
  return (int)cudaGetLastError();
}

}  // extern "C"
