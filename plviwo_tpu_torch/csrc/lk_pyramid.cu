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
// u, also one that strays outside the patch.  A tap that does not count
// gets weight 0 at an index clipped to [-1, KS], so the two taps are always
// neighbours and stay inside the warp's buffers.  The products and sums of
// a sample are rounded one by one (__fmul_rn / __fadd_rn, never contracted
// to FMA), so a sampled value equals the plain PyTorch version's bit for
// bit; only the warp reductions sum in another order.  Masked or
// degenerate steps select (bad = det < 1e-8 gives dx = dy = 0), never
// multiply.
//
// What bounds it on this card: at B = 64 sequences, N = 128 features and
// 640 x 480 the pixels it must read, the union of the template tap regions
// and target patches over the levels, are ~53 MB (~16 us at 3.35 TB/s); the
// FP32 work is ~26 kFLOP per feature and level, ~0.64 GFLOP, and with each
// product and sum rounded alone it issues at half the FMA rate (~19 us).
// The first version (one 256-thread block per feature) ran 0.39 ms, held
// back by latency: ~57 block barriers in one dependent chain per feature,
// 31 idle threads of 256, 8 features resident per SM.  The design:
//   one warp per (sequence, feature), kFeatures warps per block, a 1-D grid
//   over B * N features; no block barrier anywhere, only __syncwarp and
//   shuffles, so warps of one block never wait on each other;
//   lane l owns window column l % 16 and the kRows rows from kRows * (l / 16)
//   (W <= 16) and walks down its column, so each sample reuses the previous
//   row's two patch reads (18 shared loads for 8 samples, not 32); the patch
//   row stride (= 2 mod 4) puts the two half-warps 16 banks apart;
//   T, Gx and Gy of the lane's pixels stay in registers for all iterations
//   of a level; each sum is per lane first, then a shuffle butterfly that
//   leaves the same total in every lane (no shared reduction array);
//   per level one round of loads: the target patch and, of the template
//   patch, only the (W+3)^2 region its taps read (324 of 841 or 529 px),
//   every row of both issued by cp.async before one wait (staged through
//   registers 8 rows at a time, the loads were most of the kernel's time:
//   PERF.md);
//   ~6.3 KB of shared memory and <= 64 registers a thread (__launch_bounds__),
//   so 32 warps (features) are resident per SM, not 8: other warps' work
//   hides each warp's loads and shuffle latency.
// Still left: features that are invalid, or failed at a coarse level, run
// every level anyway (their outputs stay comparable with the plain
// version's); the sweeps' unfused roundings and 18 shared loads per 8
// samples are the floor of the iterations.

#include <cuda_runtime.h>

namespace {

constexpr int kFeatures = 4;             // warps (features) per block
constexpr int kThreads = 32 * kFeatures;
constexpr int kMinBlocks = 32 / kFeatures;  // 32 resident warps: <= 64 registers
constexpr int kRows = 8;                 // window rows per lane
constexpr int kMaxW = 2 * kRows;         // window side: 16 columns x 2 half-warps of rows
constexpr int kTile = kMaxW + 2;         // row stride of the (W+3)^2 tiles, = 2 mod 4
constexpr int kTileFloats = kTile * kTile;
constexpr int kMaxLevels = 4;

struct Levels {
  const float* prev[kMaxLevels];  // (B, H_l, W_l) each, contiguous
  const float* next[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
};

// Row stride of a warp's patch buffer at the larger drift budget: room for
// the window's 16 rows and columns plus KS + 1 taps, rounded to 2 mod 4 so
// that 8 rows apart (the two half-warps) are 16 banks apart.
__host__ __device__ inline int patch_stride(int drift, int drift_fine) {
  const int s = 2 * (drift > drift_fine ? drift : drift_fine) + kMaxW + 4;
  return s % 4 == 2 ? s : s + 2;
}

// Floats of one warp's shared memory: a zero row and element in front of
// the target patch (taps at index -1), the S x S target patch, the
// extended template, the template's tap region.
__host__ __device__ inline int warp_floats(int S) { return S + 1 + S * S + 2 * kTileFloats; }

// a[l] for a level l known only at run time, by selects: indexing the
// kernel's parameter struct would copy it to local memory.
template <class T>
__device__ __forceinline__ T pick(const T (&a)[kMaxLevels], int l) {
  T v = a[0];
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i)
    if (l == i) v = a[i];
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The two taps of tri(u - k) that can be nonzero, at k and k + 1 with
// k = floor(u) clipped to [-1, KS - 1], each weighted only when it lies in
// [0, KS).
struct Tap {
  int k;
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
  t.k = (int)fminf(fmaxf(f0, -1.f), (float)(KS - 1));
  return t;
}

// One sample from the taps' four patch values: rows first, then columns,
// as the separable JAX sum takes them.
__device__ __forceinline__ float combine(float p00, float p01, float p10, float p11,
                                         const Tap& ty, const Tap& tx) {
  const float a0 = __fadd_rn(__fmul_rn(p00, ty.w0), __fmul_rn(p10, ty.w1));
  const float a1 = __fadd_rn(__fmul_rn(p01, ty.w0), __fmul_rn(p11, ty.w1));
  return __fadd_rn(__fmul_rn(a0, tx.w0), __fmul_rn(a1, tx.w1));
}

// The lane's kRows window samples, rows r0 .. r0 + kRows - 1 of column c
// of an S-wide patch, walking down the column: f(j, sample of row r0 + j).
template <class F>
__device__ __forceinline__ void sweep(const float* P, int S, const Tap& ty, const Tap& tx,
                                      int r0, int c, F&& f) {
  const float* q = P + (r0 + ty.k) * S + c + tx.k;
  float x0 = q[0], x1 = q[1];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    q += S;
    const float y0 = q[0], y1 = q[1];
    f(j, combine(x0, x1, y0, y1, ty, tx));
    x0 = y0;
    x1 = y1;
  }
}

// x / 2^l (0 <= l < 127) as a product with the power of two: exact, as the
// plain version's division, and without ldexpf's special cases.
__device__ __forceinline__ float scale_down(float x, int l) {
  return __fmul_rn(x, __int_as_float((127 - l) << 23));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// A 4-byte copy from device to shared memory that does not wait (cp.async,
// through L1): a lane issues a whole patch column before it waits once.
__device__ __forceinline__ void copy_async(unsigned dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

// One level's loads, all in flight at once, lanes on consecutive columns:
// the target patch, PS x PS at (oyg, oxg) of `next`, into P (row stride S);
// and of the template patch at (oyp, oxp) of `prev` only the NR x NR region
// at its taps (ky, kx) that the extended template reads, into R (row stride
// kTile).  A region row or column outside the patch (a tap at -1 or PS,
// weighted 0) reads the patch's edge instead.  Returns when the lane's
// copies have landed; the caller's __syncwarp shares them.
__device__ __forceinline__ void load_level(float* P, int S, float* R,
                                           const float* __restrict__ next,
                                           const float* __restrict__ prev, int Wd, int oyg,
                                           int oxg, int oyp, int oxp, int ky, int kx, int PS,
                                           int NR, int lane) {
  for (int c = lane; c < PS; c += 32) {  // NR < PS: the region lies in the first 32 columns
    const float* src = next + (size_t)oyg * Wd + oxg + c;
    unsigned dst = (unsigned)__cvta_generic_to_shared(P + c);
#pragma unroll 4
    for (int r = 0; r < PS; ++r, src += Wd, dst += 4 * S) copy_async(dst, src);
    if (c < NR) {
      src = prev + (size_t)oyp * Wd + oxp + clampi(kx + c, 0, PS - 1);
      dst = (unsigned)__cvta_generic_to_shared(R + c);
#pragma unroll 4
      for (int r = 0; r < NR; ++r, dst += 4 * kTile)
        copy_async(dst, src + (size_t)clampi(ky + r, 0, PS - 1) * Wd);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads, kMinBlocks) lk_pyramid_kernel(
    Levels lv, int levels, const float* __restrict__ uv_prev,
    const unsigned char* __restrict__ valid, int n_feat, int N, int half, int iters,
    int drift, int drift_fine, int S, float max_err, float* __restrict__ uv_out,
    unsigned char* __restrict__ ok_out, float* __restrict__ err_out,
    float* __restrict__ det_out) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int feat = blockIdx.x * kFeatures + warp;
  if (feat >= n_feat) return;  // a whole warp: no block barrier follows
  const int b = feat / N;
  float* const mine = smem + warp * warp_floats(S);
  for (int i = lane; i < warp_floats(S); i += 32) mine[i] = 0.f;
  float* const P = mine + S + 1;  // P[-S - 1 .. -1] stay 0
  float* const Text = P + S * S;
  float* const R = Text + kTileFloats;

  const int W = 2 * half + 1, W2 = W + 2, npx = W * W;
  const int r0 = kRows * (lane >> 4), c = lane & 15;
  unsigned live = 0;  // bit j: the lane's pixel (r0 + j, c) lies in the window
#pragma unroll
  for (int j = 0; j < kRows; ++j)
    if (r0 + j < W && c < W) live |= 1u << j;

  const float upx = uv_prev[2 * feat], upy = uv_prev[2 * feat + 1];
  bool ok = valid[feat] != 0;
  // coarsest-level guess uv_prev / 2^(levels-1) (exact: a power of two)
  float ux = scale_down(upx, levels - 1), uy = scale_down(upy, levels - 1);
  float err = 0.f, det = 0.f;

  for (int l = levels - 1; l >= 0; --l) {
    const int D = l == levels - 1 ? drift : drift_fine;
    const int KS = 2 * D + 3, PS = W + 2 * D + 4;
    const int H = pick(lv.h, l), Wd = pick(lv.w, l);
    const float px = scale_down(upx, l), py = scale_down(upy, l);
    const int oxp = clampi((int)floorf(px) - (half + 1) - (D + 1), 0, Wd - PS);
    const int oyp = clampi((int)floorf(py) - (half + 1) - (D + 1), 0, H - PS);
    const int oxg = clampi((int)floorf(ux) - half - (D + 1), 0, Wd - PS);
    const int oyg = clampi((int)floorf(uy) - half - (D + 1), 0, H - PS);

    // extended template at uv_prev - (half + 1): its taps
    const Tap tty = make_tap(__fsub_rn(__fsub_rn(py, (float)oyp), (float)(half + 1)), KS);
    const Tap ttx = make_tap(__fsub_rn(__fsub_rn(px, (float)oxp), (float)(half + 1)), KS);
    __syncwarp();  // the previous level is done with the buffers
    const size_t img = (size_t)b * H * Wd;
    load_level(P, S, R, pick(lv.next, l) + img, pick(lv.prev, l) + img, Wd, oyg, oxg, oyp, oxp,
               tty.k, ttx.k, PS, W2 + 1, lane);
    __syncwarp();
    for (int i = lane; i < W2 * W2; i += 32) {
      const int tr = i / W2, tc = i - tr * W2;
      const float* p = R + tr * kTile + tc;
      Text[tr * kTile + tc] = combine(p[0], p[1], p[kTile], p[kTile + 1], tty, ttx);
    }
    __syncwarp();  // Text is built

    float T[kRows], Gx[kRows], Gy[kRows];
    float a = 0.f, bb = 0.f, cc = 0.f;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const float* t = Text + (r0 + j + 1) * kTile + c + 1;
      const bool on = (live >> j) & 1u;
      T[j] = on ? t[0] : 0.f;
      Gx[j] = on ? __fmul_rn(0.5f, __fsub_rn(t[1], t[-1])) : 0.f;
      Gy[j] = on ? __fmul_rn(0.5f, __fsub_rn(t[kTile], t[-kTile])) : 0.f;
      a = __fadd_rn(a, __fmul_rn(Gx[j], Gx[j]));
      bb = __fadd_rn(bb, __fmul_rn(Gx[j], Gy[j]));
      cc = __fadd_rn(cc, __fmul_rn(Gy[j], Gy[j]));
    }
    a = warp_sum(a);
    bb = warp_sum(bb);
    cc = warp_sum(cc);
    det = __fsub_rn(__fmul_rn(a, cc), __fmul_rn(bb, bb));
    const bool bad = det < 1e-8f;
    const float det_s = bad ? 1.f : det;
    const float ogx = (float)oxg, ogy = (float)oyg, fh = (float)half;

    for (int it = 0; it < iters; ++it) {
      const Tap ty = make_tap(__fsub_rn(__fsub_rn(uy, ogy), fh), KS);
      const Tap tx = make_tap(__fsub_rn(__fsub_rn(ux, ogx), fh), KS);
      float bx = 0.f, by = 0.f;
      sweep(P, S, ty, tx, r0, c, [&](int j, float s) {
        const float e = __fsub_rn(s, T[j]);
        bx = __fadd_rn(bx, __fmul_rn(Gx[j], e));
        by = __fadd_rn(by, __fmul_rn(Gy[j], e));
      });
      bx = warp_sum(bx);
      by = warp_sum(by);
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
    float s = 0.f;
    sweep(P, S, make_tap(wy, KS), make_tap(wx, KS), r0, c, [&](int j, float v) {
      s = __fadd_rn(s, ((live >> j) & 1u) ? fabsf(__fsub_rn(v, T[j])) : 0.f);
    });
    err = __fdiv_rn(warp_sum(s), (float)npx);
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

  if (lane == 0) {
    uv_out[2 * feat] = ux;
    uv_out[2 * feat + 1] = uy;
    ok_out[feat] = (ok && err < max_err) ? 1 : 0;
    err_out[feat] = err;
    det_out[feat] = det;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block: kFeatures warps, each with its patch
// buffer (at the larger drift budget, sized for the largest window) and
// extended template; 0 for sizes the kernel does not take (W > 16).
size_t lk_pyramid_smem_bytes(int half, int drift, int drift_fine) {
  if (half < 0 || 2 * half + 1 > kMaxW || drift < 0 || drift_fine < 0) return 0;
  return sizeof(float) * (size_t)kFeatures * warp_floats(patch_stride(drift, drift_fine));
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
  const size_t smem = lk_pyramid_smem_bytes(half, drift, drift_fine);
  if (levels < 1 || levels > kMaxLevels || smem == 0 || B < 1 || N < 1 ||
      (long long)B * N > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Levels lv = {};
  for (int l = 0; l < levels; ++l) {
    lv.prev[l] = prev[l];
    lv.next[l] = next[l];
    lv.h[l] = heights[l];
    lv.w[l] = widths[l];
  }
  if (smem > 48 * 1024) {  // large drift budgets only
    const cudaError_t e = cudaFuncSetAttribute(
        lk_pyramid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int n_feat = B * N;
  lk_pyramid_kernel<<<(n_feat + kFeatures - 1) / kFeatures, kThreads, smem,
                      (cudaStream_t)stream>>>(
      lv, levels, uv_prev, valid, n_feat, N, half, iters, drift, drift_fine,
      patch_stride(drift, drift_fine), max_err, uv, ok, err, det);
  return (int)cudaGetLastError();
}

}  // extern "C"
