// Run-length reaches of the line detector, for NVIDIA Hopper (sm_90a).
// Built with nvcc into the port's shared library with a plain C interface
// and loaded through ctypes (plviwo_tpu_torch/ops/cuda_lib.py builds it at
// first use; plviwo_tpu_torch/ops/line_kernel.py is the wrapper).
//
// Replaces no TPU kernel: the JAX detector (plviwo_tpu/ops/line_detect.py::
// detect_segments_runlen) is XLA operations.  It replaces the plain version,
// ops/line_detect.py::runlen_reaches, which runs ~1.6k full-image int16
// passes a call (pads, slices, maxima, compares, selects, adds) and reads 192
// anchors of the result.  Same arithmetic, bit for bit:
//   support of direction k at p: |dlx ux_k + dly uy_k| > cos_tol and
//     mag > mag_thresh, each product and the sum rounded alone (__fmul_rn,
//     __fadd_rn: nothing contracted to an FMA), the constants the float32
//     values ATen rounds the Python scalars to; dilated 3 x 3 over the
//     pixels inside the image (the plain version's zero-filled shifts);
//   round m (step s = 2^m): r'(p) = r(p) + [r(p) >= s] cont(p), where
//     cont(p) = max of r over the lateral window of half-width h_m around
//     q = p + s d (fore) or p - s d (aft), over the window's pixels inside
//     the image, and 0 where q is outside it (the plain version dilates,
//     then shifts with a zero fill).  h_m is what `_lat_dilate`'s doubling
//     covers, 2^j - 1 for the j offsets 1, 2, 4, ... up to the round's
//     drift: the wrapper passes them (1, 1, 1, 3, 7, 15, 15).
// Runs are at most 2^rounds <= 128 steps, so the fields are uint8; the
// reaches leave as int16.
//
// What bounds it on this card: at B = 64 and 280 x 640 the inputs (dlx,
// dly, mag) are 138 MB and the outputs a few hundred KB: 0.04 ms at 3.35
// TB/s.  The algorithm's own traffic is larger: 16 uint8 fields (8
// directions, fore and aft) of 11.5 MB, each read and written once in each
// of the 6 full-field rounds, ~2.2 GB (~0.66 ms).  The design:
//   one support pass for all 8 directions: a block reads its tile of the
//   three float fields with a 1-px halo, forms the 8 support bits of each
//   pixel in shared memory and writes their 3 x 3 OR as one byte a pixel;
//   one launch per full-field round (rounds 1 to rounds - 1) covers the 16
//   fields of all B images (grid z); a thread owns a column of 4-pixel words
//   (the byte-wise SIMD intrinsics compare, max and add 4 pixels at once,
//   and no byte carries into the next: every value stays <= 2 step);
//   a block copies the source region of its 128 x 64 tile (the tile moved
//   by +-s d, widened by h along the lateral axis) into shared memory as
//   whole aligned words by cp.async, without waiting, while its threads load
//   their own words; a window element is then one funnel of two words
//   (__byte_perm).  Rows are padded to whole words, the padding held 0, so
//   that no copied word needs a mask: every byte outside the image reads 0;
//   round 1 reads the support bits directly;
//   the last round is read only at the anchors, so it runs only there: one
//   thread per (anchor, direction, fore/aft) reads its 2 h + 2 bytes.
// Measured on an H100 (PERF.md): ~2.1 ms at B = 64, the rounds ~0.3-0.4 ms each
// whatever their window; the first byte-per-thread version took 4.2 ms, and
// neither taller tiles nor issuing every load before its use moved them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDirs = 8;
constexpr int kFields = 2 * kDirs;     // fore and aft of each direction
constexpr int kMaxRounds = 7;          // runs of at most 2^7 = 128 steps fit uint8
constexpr int kMaxHalf = 15;           // the widest lateral half-width a round may take
constexpr int kThreadsX = 32, kThreadsY = 8;
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kTileWords = kThreadsX;  // 4-pixel words across a round block's tile
constexpr int kRowsPerThread = 8;
constexpr int kTileY = kThreadsY * kRowsPerThread;  // rows of a round block's tile
constexpr int kSupTileX = 64, kSupTileY = 32;       // pixels of a support block's tile
constexpr int kAnchorThreads = 256;
// a round block's source region: kTileY + 2 h rows of kTileWords + 1 words
// (lateral axis y), or kTileY rows of up to kTileWords + (3 + 2 h) / 4 + 1
// words (x)
constexpr int kRegionWords = (kTileY + 2 * kMaxHalf) * (kTileWords + 1);
static_assert(kTileY * (kTileWords + (3 + 2 * kMaxHalf) / 4 + 1) <= kRegionWords, "region");

// direction k's step (dx, dy): the angle bucket k pi / 8 (mod pi)
__constant__ int kDx[kDirs] = {1, 2, 1, 1, 0, -1, -1, -2};
__constant__ int kDy[kDirs] = {0, 1, 1, 2, 1, 2, 1, 1};

struct Units {
  float ux[kDirs];
  float uy[kDirs];
};

// the lateral (drift) axis of direction k is x where |dx| <= |dy|, else y
__device__ __forceinline__ bool lateral_x(int k) { return abs(kDx[k]) <= abs(kDy[k]); }

// the row pitch of the support and the fields: whole 4-pixel words
__host__ __device__ __forceinline__ int pitch(int W) { return (W + 3) & ~3; }

// the 4 bytes from byte `a` (0-3) of lo on, continuing into hi
__device__ __forceinline__ uint32_t bytes_from(uint32_t lo, uint32_t hi, int a) {
  return __byte_perm(lo, hi, 0x3210 + 0x1111 * a);
}

// the bytes of a word whose first pixel is column c that lie in [0, W)
__device__ __forceinline__ uint32_t inside_mask(int c, int W) {
  uint32_t m = 0xffffffffu;
  if (c < 0) m = c > -4 ? m << (8 * -c) : 0u;
  if (c + 4 > W) m = c < W ? m & (0xffffffffu >> (8 * (c + 4 - W))) : 0u;
  return m;
}

__global__ void __launch_bounds__(kThreads)
support_kernel(const float* __restrict__ dlx, const float* __restrict__ dly,
               const float* __restrict__ mag, int H, int W, Units u, float cos_tol,
               float mag_thresh, uint8_t* __restrict__ sup) {
  constexpr int kCols = kSupTileX + 2, kRows = kSupTileY + 2;
  __shared__ uint8_t bits[kRows * kCols];
  const int P = pitch(W);
  const size_t img = (size_t)blockIdx.z * H * W;
  const int x0 = blockIdx.x * kSupTileX, y0 = blockIdx.y * kSupTileY;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  for (int i = tid; i < kRows * kCols; i += kThreads) {
    const int y = y0 - 1 + i / kCols, x = x0 - 1 + i % kCols;
    uint8_t v = 0;
    if (y >= 0 && y < H && x >= 0 && x < W) {
      const size_t p = img + (size_t)y * W + x;
      const float dx = dlx[p], dy = dly[p];
      if (mag[p] > mag_thresh) {
#pragma unroll
        for (int k = 0; k < kDirs; ++k) {
          const float c = __fadd_rn(__fmul_rn(dx, u.ux[k]), __fmul_rn(dy, u.uy[k]));
          v |= (fabsf(c) > cos_tol ? 1 : 0) << k;
        }
      }
    }
    bits[i] = v;
  }
  __syncthreads();
  static_assert(kSupTileX * (kThreads / kSupTileX) == kThreads, "support tile");
  const int x = x0 + tid % kSupTileX;
  if (x >= P) return;
  uint8_t* dst = sup + (size_t)blockIdx.z * H * P;
  for (int j = tid / kSupTileX; j < kSupTileY && y0 + j < H; j += kThreads / kSupTileX) {
    const uint8_t* b = bits + j * kCols + tid % kSupTileX;
    dst[(size_t)(y0 + j) * P + x] =
        x < W ? b[0] | b[1] | b[2] | b[kCols] | b[kCols + 1] | b[kCols + 2] | b[2 * kCols] |
                    b[2 * kCols + 1] | b[2 * kCols + 2]
              : 0;
  }
}

// 4 pixels of field (k, aft) from a word of the source: bit k of each
// support byte (kPacked, round 1), or the field's 4 bytes
template <bool kPacked>
__device__ __forceinline__ uint32_t field_bits(uint32_t w, int k) {
  return kPacked ? (w >> k) & 0x01010101u : w;
}

// a 4-byte copy from device to shared memory that does not wait (cp.async)
__device__ __forceinline__ void copy4(uint32_t* smem, const uint8_t* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

// One full-field round for the 16 fields of B images.  Field f = 2 k + aft
// of image b is plane f * B + b of `in` / `out` (16, B, H, P); with kPacked
// `in` is the support (B, H, P) and every field starts from its bit.  The
// bytes of a row from column W to P are 0 in `in` and are written 0.
template <bool kPacked>
__global__ void __launch_bounds__(kThreads)
round_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int B, int H, int W,
             int step, int half) {
  __shared__ uint32_t region[kRegionWords];
  const int P = pitch(W);
  const int plane = blockIdx.z;
  const int f = plane / B, b = plane % B;
  const int k = f >> 1, sgn = (f & 1) ? -1 : 1;
  const bool lat_x = lateral_x(k);
  const int hx = lat_x ? half : 0, hy = lat_x ? 0 : half;
  const int ox = sgn * step * kDx[k], oy = sgn * step * kDy[k];
  const size_t hp = (size_t)H * P;
  const uint8_t* src = in + (kPacked ? (size_t)b : (size_t)plane) * hp;
  const int x0 = blockIdx.x * 4 * kTileWords, y0 = blockIdx.y * kTileY;
  const int xw = x0 + 4 * threadIdx.x;  // this thread's word: columns xw .. xw + 3
  // the source region, the tile moved by (ox, oy) and widened by the
  // window, starts at (rx0, ry0): a bytes into the aligned word at c00
  const int rx0 = x0 + ox - hx, ry0 = y0 + oy - hy;
  const int a = rx0 & 3, c00 = rx0 - a;
  const int words = kTileWords + ((a + 2 * hx) >> 2) + 1;
  const int rows = kTileY + 2 * hy;
  // the region as aligned words of the source, copied without waiting; a
  // word outside the image's rows or [0, P) is 0
  for (int ry = threadIdx.y; ry < rows; ry += kThreadsY) {
    const int y = ry0 + ry;
    for (int w = threadIdx.x; w < words; w += kThreadsX) {
      const int c = c00 + 4 * w;
      uint32_t* d = region + ry * words + w;
      if (y >= 0 && y < H && c >= 0 && c < P) copy4(d, src + (size_t)y * P + c);
      else *d = 0u;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  // meanwhile the thread's own words, rows threadIdx.y + kThreadsY i
  const uint32_t own = inside_mask(xw, W);
  uint32_t mine[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int y = y0 + threadIdx.y + kThreadsY * i;
    mine[i] = xw < W && y < H ?
        field_bits<kPacked>(*reinterpret_cast<const uint32_t*>(src + (size_t)y * P + xw), k) & own
        : 0u;
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  if (xw >= W) return;
  const uint32_t q_in = inside_mask(xw + ox, W);  // the bytes whose q column is in the image
  const uint32_t steps = 0x01010101u * (uint32_t)step;
  uint8_t* dst = out + (size_t)plane * hp;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int j = threadIdx.y + kThreadsY * i, y = y0 + j;
    if (y >= H) break;
    const size_t p = (size_t)y * P + xw;
    const uint32_t r = mine[i];
    uint32_t add = __vcmpgeu4(r, steps) & q_in;  // r >= step, q inside
    if (y + oy < 0 || y + oy >= H) add = 0;
    if (add) {
      // the windows around q of the 4 pixels: element t is the word at byte
      // a + 4 threadIdx.x + t of region row j (x), or at byte a +
      // 4 threadIdx.x of row j + t (y)
      const uint32_t* base = region + j * words + threadIdx.x;
      uint32_t cont = 0;
      if (lat_x) {
        for (int t = 0; t <= 2 * half; ++t) {
          const int o = a + t;
          cont = __vmaxu4(cont, field_bits<kPacked>(
              bytes_from(base[o >> 2], base[(o >> 2) + 1], o & 3), k));
        }
      } else {
        for (int t = 0; t <= 2 * half; ++t) {
          const uint32_t* rw = base + t * words;
          cont = __vmaxu4(cont, field_bits<kPacked>(bytes_from(rw[0], rw[1], a), k));
        }
      }
      add &= cont;
    }
    // every byte stays <= 2 step <= 64: no carry crosses into the next
    *reinterpret_cast<uint32_t*>(dst + p) = r + add;
  }
}

// The last round at the anchors only: one thread per (anchor, field), from
// the previous round's fields `r` (16, B, H, P).  An anchor outside the
// image reads 0.
__global__ void __launch_bounds__(kAnchorThreads)
anchor_round_kernel(const uint8_t* __restrict__ r, const long long* __restrict__ at, int B,
                    int H, int W, int A, int step, int half, int16_t* __restrict__ reach_f,
                    int16_t* __restrict__ reach_b) {
  const long long i = (long long)blockIdx.x * kAnchorThreads + threadIdx.x;
  if (i >= (long long)B * A * kFields) return;
  const int f = (int)(i % kFields);
  const long long ba = i / kFields;  // b * A + anchor
  const int b = (int)(ba / A);
  const int k = f >> 1, sgn = (f & 1) ? -1 : 1;
  const int P = pitch(W);
  const long long p = at[ba];
  int v = 0;
  if (p >= 0 && p < (long long)H * W) {
    const uint8_t* src = r + ((size_t)f * B + b) * H * P;
    const int y = (int)(p / W), x = (int)(p % W);
    v = src[(size_t)y * P + x];
    const int qx = x + sgn * step * kDx[k], qy = y + sgn * step * kDy[k];
    if (v >= step && qx >= 0 && qx < W && qy >= 0 && qy < H) {
      const bool lat_x = lateral_x(k);
      int cont = 0;
      for (int t = -half; t <= half; ++t) {
        const int wx = lat_x ? qx + t : qx, wy = lat_x ? qy : qy + t;
        if (wx >= 0 && wx < W && wy >= 0 && wy < H) cont = max(cont, (int)src[(size_t)wy * P + wx]);
      }
      v += cont;
    }
  }
  (f & 1 ? reach_b : reach_f)[ba * kDirs + k] = (int16_t)v;
}

}  // namespace

extern "C" {

const char* line_runlen_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Bytes of scratch one call takes: the support (B, H, P) and two sets of
// the 16 fields (16, B, H, P), P = W rounded up to whole 4-pixel words.
size_t line_runlen_scratch_bytes(int B, int H, int W) {
  return (size_t)(1 + 2 * kFields) * B * H * pitch(W);
}

// dlx, dly, mag: (B, H, W) float32; at: (B, A) int64 flat pixel indices;
// units: host array of the 8 directions' ux then their uy (float32);
// rounds: doubling rounds (2 to 7), halves: host array of each round's
// lateral half-width (<= 15); scratch: line_runlen_scratch_bytes(B, H, W)
// bytes, 4-byte aligned; reach_f, reach_b: (B, A, 8) int16 out.  Launches
// on `stream` and returns 0 or the cudaError_t of a refused launch.
int line_runlen(const float* dlx, const float* dly, const float* mag, const long long* at,
                int B, int H, int W, int A, const float* units, float cos_tol, float mag_thresh,
                int rounds, const int* halves, uint8_t* scratch, int16_t* reach_f,
                int16_t* reach_b, void* stream) {
  if (B < 1 || H < 1 || W < 1 || A < 1 || rounds < 2 || rounds > kMaxRounds ||
      (long long)kFields * B > 65535 || (H + kSupTileY - 1) / kSupTileY > 65535 ||
      ((uintptr_t)scratch & 3) != 0)
    return (int)cudaErrorInvalidValue;
  for (int m = 0; m < rounds; ++m)
    if (halves[m] < 0 || halves[m] > kMaxHalf) return (int)cudaErrorInvalidValue;
  Units u;
  for (int k = 0; k < kDirs; ++k) {
    u.ux[k] = units[k];
    u.uy[k] = units[kDirs + k];
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int P = pitch(W);
  support_kernel<<<dim3((P + kSupTileX - 1) / kSupTileX, (H + kSupTileY - 1) / kSupTileY, B),
                   dim3(kThreadsX, kThreadsY), 0, s>>>(dlx, dly, mag, H, W, u, cos_tol,
                                                       mag_thresh, scratch);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t field_set = (size_t)kFields * B * H * P;
  uint8_t* buf[2] = {scratch + (size_t)B * H * P, scratch + (size_t)B * H * P + field_set};
  const dim3 grid((P + 4 * kTileWords - 1) / (4 * kTileWords), (H + kTileY - 1) / kTileY,
                  kFields * B);
  const dim3 block(kThreadsX, kThreadsY);
  for (int m = 0; m + 1 < rounds; ++m) {
    if (m == 0)
      round_kernel<true><<<grid, block, 0, s>>>(scratch, buf[0], B, H, W, 1, halves[0]);
    else
      round_kernel<false><<<grid, block, 0, s>>>(buf[(m - 1) & 1], buf[m & 1], B, H, W, 1 << m,
                                                 halves[m]);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const long long n = (long long)B * A * kFields;
  anchor_round_kernel<<<(unsigned)((n + kAnchorThreads - 1) / kAnchorThreads), kAnchorThreads, 0,
                        s>>>(buf[(rounds - 2) & 1], at, B, H, W, A, 1 << (rounds - 1),
                             halves[rounds - 1], reach_f, reach_b);
  return (int)cudaGetLastError();
}

}  // extern "C"
