// Fused per-feature MSCKF nullspace projection + chi2 gate + gated Gram,
// for NVIDIA Hopper (sm_90a).  Built with nvcc into a shared library with a
// plain C interface and loaded through ctypes
// (plviwo_tpu_torch/ops/msckf_kernel.py builds it at first use).
//
// Replaces: the Pallas TPU kernel plviwo_tpu/ops/msckf_kernel.py::_kernel
// (pallas_call in gram_gate_fused).  Same arithmetic per feature:
//   whiten + mask rows (select, never multiply, so masked NaN rows vanish)
//   k Householder reflectors against Hf (left nullspace, k = 3 or 4)
//   S = Hv cov Hv^T + I, Cholesky + forward solve -> chi2 = |L^-1 rv|^2
//   ok = chi2 < gate[dof] && n_rows >= k+2 && max|r| < cap
//   G = sum_ok Hv^T Hv,  c = sum_ok Hv^T rv
//
// What bounds it on this card: per feature the work is a serial chain (k
// reflector sweeps, the (M-k) x D x D product Hv cov, S, an (M-k)-step
// Cholesky) over 15-60 KB of rows; 0.4-2 MFLOP per feature, 3.3 GFLOP per
// images-in call (B = 64, F = 128, M = 16, D = 124), 10.5 at the filter
// bench's k = 3 shape (B = 128, F = 40, M = 40, D = 162): 0.05-0.16 ms of
// FP32 at peak.  The first CUDA design (one 256-thread block per feature)
// spent its time in ~20 block barriers on that chain, with half the block
// idle in Hv cov and 16-way bank conflicts in S.  The design now:
//   pass 1: ONE WARP PER FEATURE (two features of one sequence per block;
//     no block barrier).  The chain runs inside the warp with __syncwarp
//     and shuffles:
//       - a feature with at most k valid rows has nothing left after the
//         projection: its warp writes ok = 0 and chi2 = 0 and stops (most
//         features of a real images-in frame);
//       - rows arrive by cp.async (masked rows are written as zeros, never
//         read) and are whitened in place;
//       - reflectors column-parallel, every column of a lane swept in one
//         pass over the rows;
//       - T = Hv cov by tiles of 19 (D > 128) or 13 rows: each lane owns NE
//         covariance columns and streams their rows through L2 in a ring
//         of three cp.async stages of four rows that only it writes and
//         reads.  Hv entries are warp broadcasts;
//       - S_raw = T Hv^T per tile in 4 x 4 register tiles, then S =
//         (S_raw + S_raw^T) / 2 + I;
//       - Cholesky with the folded forward solve: one row per lane (two
//         for M - k > 32), each column of L divided once, the right-hand
//         side in registers and a shuffle per column;
//       - the gate; an accepted feature writes its projected rows
//         [Hv | rv] to a scratch buffer (B, F, M-k, D+1); the rows of the
//         others are left unwritten.
//     A and T rows are 16-byte vectors at a stride whose quarter is odd,
//     and S rows have an odd stride, so the lanes of a warp that read one
//     column of different rows hit different banks.  What bounds it now:
//     the latency of each warp's chain at 4-8 resident warps per SM, set
//     by its registers and shared rows.  Staging the sequence's covariance
//     in shared memory instead was measured and not kept (PERF.md): equal
//     on a real frame's inputs, 11% faster only on synthetic systems.
//   pass 2: the Gram of each sequence's accepted rows, one block per
//     64 x 64 output tile on or above the diagonal (4 x 4 outputs per
//     thread), looping over the rows of the accepted features in feature
//     order and selecting zeros for the rows of the others: deterministic,
//     no atomics, exactly symmetric.  Column D is c.
// Not done yet: tensor-core products (TF32 alone is too coarse for the
// gate; 3xTF32 split products would be needed), and compaction of the
// valid rows inside a feature (masked rows still take their share of T).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxM = 64;        // rows per feature: at most two per lane
constexpr int kFeatures = 2;     // pass-1 features (warps) per block
constexpr int kRing = 3;         // stages of 4 covariance rows per warp: two in flight
constexpr int kTile = 64;        // pass-2 output tile edge
constexpr int kSub = 4;          // pass-2 outputs per thread, per dimension
constexpr int kSpan = kTile / kSub;          // 16
constexpr int kGramThreads = kSpan * kSpan;  // 256
constexpr int kRows = 16;        // pass-2 rows staged per iteration

// Covariance columns per lane in T = Hv cov (D <= 32 NE), as instantiated.
__host__ __device__ inline int lane_cols(int D) {
  const int ne = (D + 31) / 32;
  return ne <= 2 ? 2 : ne <= 4 ? 4 : ne <= 6 ? 6 : ne <= 8 ? 8 : 0;
}

// Rows of T per register tile: 19 at NE = 6 (the filter shapes' M - k = 36,
// 37 take two tiles), else 13 (the images-in frame's M - k = 13 takes one).
__host__ __device__ constexpr int row_chunk(int NE) { return NE == 6 ? 19 : 13; }

// A row stride: a multiple of 4 (16-byte rows) whose quarter is odd, so
// that lanes reading 16 bytes each from different rows spread over the banks.
__host__ __device__ inline int quad_stride(int n) {
  n = (n + 3) & ~3;
  return ((n >> 2) & 1) ? n : n + 4;
}

// Shared layout (floats) per warp: A (M x lda) holds the rows as [Hx | 0 pad
// to d4 = D rounded up to 4 | r | Hf | 0 pad]: Hv starts every row 16-byte
// aligned and is zero-padded to d4 columns.  Then one tile of T (row_chunk
// x ldt, zero-padded to d4), S (R x lds), the reflector v (M) and the ring
// of covariance rows (kRing x 4 x 32 NE).
struct Layout {
  int d4, lda, ldt, lds, per;
};

__host__ __device__ inline Layout layout(int M, int D, int k) {
  Layout l;
  const int R = M - k, ne = lane_cols(D);
  l.d4 = (D + 3) & ~3;
  l.lda = quad_stride(l.d4 + 1 + k);
  l.ldt = quad_stride(l.d4);
  l.lds = R | 1;
  l.per = (M * l.lda + row_chunk(ne) * l.ldt + R * l.lds + M + kRing * 4 * 32 * ne + 3) & ~3;
  return l;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async8(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

// n floats from src to the 16-byte aligned dst by `nt` threads (this one is
// `t`), W floats per copy (src W * 4-byte aligned), the tail 4 bytes at a
// time.
template <int W>
__device__ __forceinline__ void copy_span(float* dst, const float* src, int n, int t, int nt) {
  const int nw = n - n % W;
  for (int c = W * t; c < nw; c += nt * W) {
    if (W == 4) cp_async16(dst + c, src + c);
    else if (W == 2) cp_async8(dst + c, src + c);
    else cp_async4(dst + c, src + c);
  }
  for (int c = nw + t; c < n; c += nt) cp_async4(dst + c, src + c);
}

// copy_span with the widest copy src's alignment allows.
__device__ __forceinline__ void copy_aligned(float* dst, const float* src, int n, int t, int nt) {
  const uintptr_t al = reinterpret_cast<uintptr_t>(src);
  if ((al & 15) == 0) copy_span<4>(dst, src, n, t, nt);
  else if ((al & 7) == 0) copy_span<2>(dst, src, n, t, nt);
  else copy_span<1>(dst, src, n, t, nt);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Value of row i (0 <= i < 64) held by lane i % 32 in x0 (i < 32) or x1.
__device__ __forceinline__ float row_bcast(float x0, float x1, int i) {
  return __shfl_sync(kFull, i < 32 ? x0 : x1, i & 31);
}

// One warp per feature; NE covariance columns per lane (D <= 32 NE).
template <int NE>
__global__ void __launch_bounds__(kFeatures * 32) gate_project_kernel(
    const float* __restrict__ Hx, const float* __restrict__ Hf,
    const float* __restrict__ r, const unsigned char* __restrict__ mask,
    const float* __restrict__ w, const float* __restrict__ cov,
    const float* __restrict__ gate, float cap, int F, int M, int D, int k,
    float* __restrict__ P, unsigned char* __restrict__ ok_out,
    float* __restrict__ chi_out) {
  constexpr int RC = row_chunk(NE);
  constexpr int NC = NE + 1;  // columns of A per lane: lda <= 32 NE + 12
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y, f = blockIdx.x * kFeatures + warp;
  if (f >= F) return;
  const Layout L = layout(M, D, k);
  const int R = M - k, E = D + 1, d4 = L.d4, rc = d4;  // rc: the r column
  const int ncol = d4 + 1 + k;                         // columns the reflectors sweep
  const float* cv = cov + (size_t)b * D * D;
  float* A = smem + warp * L.per;
  float* Tc = A + M * L.lda;
  float* S = Tc + RC * L.ldt;
  float* v = S + R * L.lds;
  float* ring = v + M + lane;  // this lane's covariance columns, 32 apart

  const size_t feat = (size_t)b * F + f;
  const unsigned char* mk = mask + feat * M;
  const float* ww = w + feat * M;
  bool m0 = false, m1 = false;
  float w0 = 0.0f, w1 = 0.0f;
  if (lane < M) { m0 = mk[lane] != 0; w0 = ww[lane]; }
  if (lane + 32 < M) { m1 = mk[lane + 32] != 0; w1 = ww[lane + 32]; }
  const int n_rows = __popc(__ballot_sync(kFull, m0)) + __popc(__ballot_sync(kFull, m1));
  // at most k rows: nothing is left after the projection: rejected
  if (n_rows <= k) {
    if (lane == 0) { ok_out[feat] = 0; chi_out[feat] = 0.0f; }
    return;
  }

  // --- the feature's rows by cp.async (16 or 8 bytes a copy where the row
  // allows); masked rows and the pads are zeros ---
  {
    const float* hx = Hx + feat * M * D;
    const float* hf = Hf + feat * M * k;
    const float* rr = r + feat * M;
    for (int i = 0; i < M; ++i) {
      const bool mi = __shfl_sync(kFull, i < 32 ? (int)m0 : (int)m1, i & 31) != 0;
      float* Ai = A + i * L.lda;
      if (!mi) {
        for (int c = lane; c < L.lda; c += 32) Ai[c] = 0.0f;
        continue;
      }
      copy_aligned(Ai, hx + i * D, D, lane, 32);
      for (int c = D + lane; c < L.lda; c += 32) {
        if (c == rc) cp_async4(Ai + c, rr + i);
        else if (c > rc && c <= rc + k) cp_async4(Ai + c, hf + i * k + (c - rc - 1));
        else Ai[c] = 0.0f;
      }
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();
  // --- whiten in place ---
  for (int i = 0; i < M; ++i) {
    const bool mi = __shfl_sync(kFull, i < 32 ? (int)m0 : (int)m1, i & 31) != 0;
    const float wi = row_bcast(w0, w1, i);
    if (mi) {
      float* Ai = A + i * L.lda;
#pragma unroll
      for (int q = 0; q < NC; ++q)
        if (lane + 32 * q < ncol) Ai[lane + 32 * q] = Ai[lane + 32 * q] * wi;
    }
  }
  __syncwarp();
  const float mx = warp_max(fmaxf(lane < M ? fabsf(A[lane * L.lda + rc]) : 0.0f,
                                  lane + 32 < M ? fabsf(A[(lane + 32) * L.lda + rc]) : 0.0f));

  // --- k Householder reflectors against the Hf columns; lane owns columns
  // lane + 32 q, all of them swept together ---
  {
    int cq[NC];
#pragma unroll
    for (int q = 0; q < NC; ++q) cq[q] = min(lane + 32 * q, ncol - 1);
    for (int j = 0; j < k; ++j) {
      const int pc = rc + 1 + j;  // the pivot column, Hf column j
      const float x0 = (lane >= j && lane < M) ? A[lane * L.lda + pc] : 0.0f;
      const float x1 = (lane + 32 < M) ? A[(lane + 32) * L.lda + pc] : 0.0f;
      const float nx = sqrtf(warp_sum(x0 * x0 + x1 * x1));
      const float xj = A[j * L.lda + pc];
      // never a zero sign: a zero pivot entry must still give alpha = -|x|
      const float alpha = -(xj >= 0.0f ? 1.0f : -1.0f) * nx;
      const float v0 = lane == j ? x0 - alpha : x0;
      const float nv = sqrtf(warp_sum(v0 * v0 + x1 * x1));
      const bool tiny = nv < 1e-12f;
      const float den = tiny ? 1.0f : nv;
      if (lane < M) v[lane] = v0 / den;
      if (lane + 32 < M) v[lane + 32] = x1 / den;
      const float scale = tiny ? 0.0f : 2.0f;
      __syncwarp();
      float dot[NC];
#pragma unroll
      for (int q = 0; q < NC; ++q) dot[q] = 0.0f;
#pragma unroll 2
      for (int i = j; i < M; ++i) {
        const float vi = v[i];
        const float* Ai = A + i * L.lda;
#pragma unroll
        for (int q = 0; q < NC; ++q) dot[q] += vi * Ai[cq[q]];
      }
      for (int i = j; i < M; i += 2) {  // two rows: all loads before the stores
        const bool two = i + 1 < M;
        float* A0 = A + i * L.lda;
        float* A1 = A0 + (two ? L.lda : 0);
        const float s0 = scale * v[i], s1 = scale * v[two ? i + 1 : i];
        float y0[NC], y1[NC];
#pragma unroll
        for (int q = 0; q < NC; ++q) { y0[q] = A0[cq[q]]; y1[q] = A1[cq[q]]; }
#pragma unroll
        for (int q = 0; q < NC; ++q) {
          if (lane + 32 * q < ncol) {
            A0[cq[q]] = y0[q] - s0 * dot[q];
            if (two) A1[cq[q]] = y1[q] - s1 * dot[q];
          }
        }
      }
      __syncwarp();
    }
  }

  // --- S = Hv cov Hv^T by tiles of RC rows of T = Hv cov.  T: lane owns
  // covariance columns e = lane + 32 q, whose rows it streams 4 at a time
  // through a ring of kRing cp.async stages that only this lane writes and
  // reads; Hv entries are 16-byte warp broadcasts.  Then S_raw[i][j] =
  // T_i . Hv_j for the tile's rows i and every j, in 4 x 4 register tiles
  // from 16-byte loads. ---
  int ec[NE];
#pragma unroll
  for (int q = 0; q < NE; ++q) ec[q] = min(lane + 32 * q, D - 1);
  const int n4 = d4 / 4;
  for (int i0 = 0; i0 < R; i0 += RC) {
    const int nr = min(RC, R - i0);
    // rows t >= nr of the last tile read past A, inside this warp's area;
    // their sums are never stored
    const float* hrow = A + (k + i0) * L.lda;
    float acc[RC][NE];
#pragma unroll
    for (int t = 0; t < RC; ++t)
#pragma unroll
      for (int q = 0; q < NE; ++q) acc[t][q] = 0.0f;
    // rows 4g .. 4g + 3 of the covariance into stage g % kRing (zeros past D)
    auto fetch = [&](int g) {
      float* dst = ring + (g % kRing) * 4 * 32 * NE;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int d = 4 * g + u;
#pragma unroll
        for (int q = 0; q < NE; ++q) {
          if (d < D) cp_async4(dst + (u * NE + q) * 32, cv + (size_t)d * D + ec[q]);
          else dst[(u * NE + q) * 32] = 0.0f;
        }
      }
    };
#pragma unroll
    for (int g = 0; g < kRing - 1; ++g) {
      if (g < n4) fetch(g);
      cp_async_commit();
    }
    for (int g = 0; g < n4; ++g) {
      if (g + kRing - 1 < n4) fetch(g + kRing - 1);
      cp_async_commit();
      cp_async_wait<kRing - 1>();  // rows 4g .. 4g + 3 have landed
      float cd[4][NE];
      const float* cr = ring + (g % kRing) * 4 * 32 * NE;
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int q = 0; q < NE; ++q) cd[u][q] = cr[(u * NE + q) * 32];
#pragma unroll
      for (int t = 0; t < RC; ++t) {
        const float4 h = *reinterpret_cast<const float4*>(hrow + t * L.lda + 4 * g);
#pragma unroll
        for (int q = 0; q < NE; ++q) {
          acc[t][q] = fmaf(h.x, cd[0][q], acc[t][q]);
          acc[t][q] = fmaf(h.y, cd[1][q], acc[t][q]);
          acc[t][q] = fmaf(h.z, cd[2][q], acc[t][q]);
          acc[t][q] = fmaf(h.w, cd[3][q], acc[t][q]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < RC; ++t) {
      if (t < nr) {
#pragma unroll
        for (int q = 0; q < NE; ++q) {
          const int e = lane + 32 * q;
          if (e < d4) Tc[t * L.ldt + e] = e < D ? acc[t][q] : 0.0f;
        }
      }
    }
    __syncwarp();
    const int tr = (nr + 3) / 4, tc = (R + 3) / 4;
    for (int p = lane; p < tr * tc; p += 32) {
      const int I = p / tc, J = p - I * tc;
      int ta[4], hb[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        ta[u] = min(4 * I + u, nr - 1) * L.ldt;
        hb[u] = (k + min(4 * J + u, R - 1)) * L.lda;
      }
      float s4[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int x = 0; x < 4; ++x) s4[u][x] = 0.0f;
      for (int e = 0; e < d4; e += 4) {
        float4 tv[4], hv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          tv[u] = *reinterpret_cast<const float4*>(Tc + ta[u] + e);
          hv[u] = *reinterpret_cast<const float4*>(A + hb[u] + e);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            s4[u][x] = fmaf(tv[u].x, hv[x].x, s4[u][x]);
            s4[u][x] = fmaf(tv[u].y, hv[x].y, s4[u][x]);
            s4[u][x] = fmaf(tv[u].z, hv[x].z, s4[u][x]);
            s4[u][x] = fmaf(tv[u].w, hv[x].w, s4[u][x]);
          }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          if (4 * I + u < nr && 4 * J + x < R) S[(i0 + 4 * I + u) * L.lds + 4 * J + x] = s4[u][x];
    }
    __syncwarp();
  }

  // --- right-looking Cholesky of S = (S_raw + S_raw^T) / 2 + I with the
  // forward solve folded in.  Lane owns rows a0 = lane and a1 = lane + 32
  // of the lower triangle and their right-hand side.  Step j: each row
  // divides its own L[a][j] = S[a][j] / d_j once, the column moves between
  // lanes by shuffles, and every lane updates its own rows right of j. ---
  const int a0 = lane, a1 = lane + 32;
  const int r0 = min(a0, R - 1), r1 = min(a1, R - 1);  // rows a lane may load
  for (int c = 0; c < R; c += 2) {  // symmetrize the own rows, + I
    float u0[2], u1[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int cc = min(c + x, R - 1);
      u0[x] = 0.5f * (S[r0 * L.lds + cc] + S[cc * L.lds + r0]) + (cc == r0 ? 1.0f : 0.0f);
      u1[x] = 0.5f * (S[r1 * L.lds + cc] + S[cc * L.lds + r1]) + (cc == r1 ? 1.0f : 0.0f);
    }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int cc = c + x;
      if (cc < R && cc <= a0 && a0 < R) S[a0 * L.lds + cc] = u0[x];
      if (cc < R && cc <= a1 && a1 < R) S[a1 * L.lds + cc] = u1[x];
    }
  }
  __syncwarp();
  float rhs0 = a0 < R ? A[(k + a0) * L.lda + rc] : 0.0f;
  float rhs1 = a1 < R ? A[(k + a1) * L.lda + rc] : 0.0f;
  float chi = 0.0f;
  for (int j = 0; j < R; ++j) {
    const float dj = sqrtf(fmaxf(S[j * L.lds + j], 1e-12f));
    const float yj = row_bcast(rhs0, rhs1, j) / dj;
    chi += yj * yj;
    float l0 = 0.0f, l1 = 0.0f;
    if (a0 > j && a0 < R) {
      l0 = S[a0 * L.lds + j] / dj;
      rhs0 -= yj * l0;
    }
    if (a1 > j && a1 < R) {
      l1 = S[a1 * L.lds + j] / dj;
      rhs1 -= yj * l1;
    }
    // S[a][c] -= L[a][j] L[c][j] for j < c <= a, four columns at a time
    for (int c = j + 1; c < R; c += 4) {
      float lc[4], s0[4], s1[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int cc = min(c + x, R - 1);
        lc[x] = row_bcast(l0, l1, cc);
        s0[x] = S[r0 * L.lds + cc];
        s1[x] = S[r1 * L.lds + cc];
      }
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int cc = c + x;
        if (cc < R && cc <= a0 && a0 < R) S[a0 * L.lds + cc] = s0[x] - l0 * lc[x];
        if (cc < R && cc <= a1 && a1 < R) S[a1 * L.lds + cc] = s1[x] - l1 * lc[x];
      }
    }
    __syncwarp();
  }

  // --- gate ---
  const int dof = max(n_rows - k, 1);
  const float g = (dof <= M) ? __ldg(gate + dof) : 0.0f;
  const bool okb = (chi < g) && (n_rows >= k + 2) && (mx < cap);
  if (lane == 0) {
    ok_out[feat] = okb ? 1 : 0;
    chi_out[feat] = chi;
  }

  // --- the accepted feature's projected rows [Hv | rv] ---
  if (okb) {
    float* pout = P + feat * (size_t)R * E;
    for (int i = 0; i < R; ++i) {
      const float* src = A + (k + i) * L.lda;
#pragma unroll
      for (int q = 0; q < NC; ++q) {
        const int c = lane + 32 * q;
        if (c < E) pout[i * E + c] = src[c < D ? c : rc];
      }
    }
  }
}

// G_b = X_b^T X_b over each sequence's N = F R gated rows X_b (N x (D+1)),
// the rows of features that were not accepted selected as zeros (pass 1
// leaves them unwritten): one block per kTile x kTile output tile on or
// above the diagonal (mirrored below it), kSub x kSub outputs per thread.
// A chunk of kRows rows none of which belongs to an accepted feature is
// skipped: its products would add +-0 to sums that are never -0, so the
// result is bit for bit the full sum.
__global__ void __launch_bounds__(kGramThreads) gram_kernel(
    const float* __restrict__ P, const unsigned char* __restrict__ ok, int F, int R, int D,
    float* __restrict__ G, float* __restrict__ c) {
  if (blockIdx.x < blockIdx.y) return;
  __shared__ float Xa[kRows][kTile];
  __shared__ float Xb[kRows][kTile];
  __shared__ bool keep[2][kRows];  // row n0 + rr accepted, by chunk parity
  const int E = D + 1, N = F * R;
  const int b = blockIdx.z;
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;
  const int t = threadIdx.x, tx = t % kSpan, ty = t / kSpan;
  const float* X = P + (size_t)b * N * E;
  const unsigned char* okb = ok + (size_t)b * F;
  float acc[kSub][kSub];
#pragma unroll
  for (int u = 0; u < kSub; ++u)
#pragma unroll
    for (int v = 0; v < kSub; ++v) acc[u][v] = 0.0f;
  // thread t < kRows tells whether row n0 + t belongs to an accepted feature
  auto accepted = [&](int n0) { return t < kRows && n0 + t < N && okb[(n0 + t) / R] != 0; };
  bool next = accepted(0);
  if (t < kRows) keep[0][t] = next;
  for (int n0 = 0, it = 0; n0 < N; n0 += kRows, ++it) {
    // also the barrier after the previous chunk's products and after
    // keep[it & 1] was written; keep[(it + 1) & 1] was last read before it
    const bool any = __syncthreads_or(next);
    next = accepted(n0 + kRows);
    if (t < kRows) keep[(it + 1) & 1][t] = next;
    if (!any) continue;
    // the loads do not wait for keep: a row that is not kept (unwritten,
    // or past N: row N - 1 again) is read and selected away
#pragma unroll
    for (int idx = t; idx < kRows * kTile; idx += kGramThreads) {
      const int rr = idx / kTile, cc = idx - rr * kTile;
      const float* x = X + (size_t)min(n0 + rr, N - 1) * E;
      const float xa = row0 + cc < E ? x[row0 + cc] : 0.0f;
      const float xb = col0 + cc < E ? x[col0 + cc] : 0.0f;
      const bool kr = keep[it & 1][rr];
      Xa[rr][cc] = kr ? xa : 0.0f;
      Xb[rr][cc] = kr ? xb : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int rr = 0; rr < kRows; ++rr) {
      float a[kSub], bb[kSub];
#pragma unroll
      for (int u = 0; u < kSub; ++u) {
        a[u] = Xa[rr][ty + kSpan * u];
        bb[u] = Xb[rr][tx + kSpan * u];
      }
#pragma unroll
      for (int u = 0; u < kSub; ++u)
#pragma unroll
        for (int v = 0; v < kSub; ++v) acc[u][v] += a[u] * bb[v];
    }
  }
  const bool diag = blockIdx.x == blockIdx.y;
#pragma unroll
  for (int u = 0; u < kSub; ++u) {
#pragma unroll
    for (int v = 0; v < kSub; ++v) {
      const int i = row0 + ty + kSpan * u, j = col0 + tx + kSpan * v;
      if (i < D && j < D) {
        G[(size_t)b * D * D + (size_t)i * D + j] = acc[u][v];
        if (!diag) G[(size_t)b * D * D + (size_t)j * D + i] = acc[u][v];
      } else if (i < D && j == D) {
        c[(size_t)b * D + i] = acc[u][v];
      }
    }
  }
}

constexpr size_t kSmemLimit = 232448;  // bytes one block may use on Hopper

// Shared memory of one pass-1 block (kFeatures warps).
size_t smem_bytes(int M, int D, int k) {
  return sizeof(float) * kFeatures * (size_t)layout(M, D, k).per;
}

bool supported(int M, int D, int k) {
  return k >= 1 && k < M && M <= kMaxM && D >= 1 && lane_cols(D) > 0 &&
         smem_bytes(M, D, k) <= kSmemLimit;
}

using Pass1 = void (*)(const float*, const float*, const float*, const unsigned char*,
                       const float*, const float*, const float*, float, int, int, int, int,
                       float*, unsigned char*, float*);

Pass1 pass1_for(int D) {
  switch (lane_cols(D)) {
    case 2: return gate_project_kernel<2>;
    case 4: return gate_project_kernel<4>;
    case 6: return gate_project_kernel<6>;
    default: return gate_project_kernel<8>;
  }
}

}  // namespace

extern "C" {

// Shared memory of one pass-1 block at (M, D, k); 0 where the kernel does
// not take these sizes.
size_t msckf_gram_gate_smem_bytes(int M, int D, int k) {
  return supported(M, D, k) ? smem_bytes(M, D, k) : 0;
}

const char* msckf_gram_gate_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Both passes on `stream`.  Returns 0 or the cudaError_t of a refused launch.
int msckf_gram_gate(const float* Hx, const float* Hf, const float* r,
                    const unsigned char* mask, const float* w, const float* cov,
                    const float* gate, float cap, int B, int F, int M, int D,
                    int k, float* P, unsigned char* ok, float* chi, float* G,
                    float* c, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!supported(M, D, k)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(M, D, k);
  const Pass1 kern = pass1_for(D);
  // all of the SM's shared memory: the warps' rows bound occupancy
  cudaError_t e = cudaFuncSetAttribute(reinterpret_cast<const void*>(kern),
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(reinterpret_cast<const void*>(kern),
                             cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3((F + kFeatures - 1) / kFeatures, B), 32 * kFeatures, smem, s>>>(
      Hx, Hf, r, mask, w, cov, gate, cap, F, M, D, k, P, ok, chi);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int E = D + 1, nt = (E + kTile - 1) / kTile;
  gram_kernel<<<dim3(nt, nt, B), kGramThreads, 0, s>>>(P, ok, F, M - k, D, G, c);
  return (int)cudaGetLastError();
}

}  // extern "C"
