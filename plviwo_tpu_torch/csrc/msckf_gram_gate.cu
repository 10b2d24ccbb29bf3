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
// What bounds it on this card: per feature the work is a serial chain
// (k reflector sweeps, then an M-step Cholesky) over ~60 KB of data, plus
// the (M-k) x D x D product Hv cov, about 1 MFLOP per feature and 5 GFLOP
// per frame at B = 128, F = 40, M = 40, D = 162; the covariance (105 KB per
// sequence) is re-read by every feature of its sequence.  The design:
//   pass 1: one thread block per (sequence, feature).  The feature's rows
//     live in shared memory for the whole chain; reflectors run
//     column-parallel, the Cholesky element-parallel with one barrier per
//     column; the covariance streams through L2 (each work item reads one
//     covariance column, four loads in flight, against 13 rows of Hv held
//     in registers).  The block writes ok, chi2 and the GATED projected
//     rows [ok*Hv | ok*rv] to a scratch buffer (B, F, M-k, D+1).
//   pass 2: the Gram of each sequence's gated rows, one block per 64 x 64
//     output tile on or above the diagonal (4 x 4 outputs per thread),
//     looping over the rows in a fixed order: deterministic, no atomics,
//     and exactly symmetric (each off-diagonal entry is computed once and
//     mirrored).  Column D of the Gram is c.
// Not done yet: tensor-core products (TF32 alone is too coarse for the
// gate), a persistent block per sequence holding cov in shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // pass-1 block size (multiple of 32)
constexpr int kRowChunk = 13;   // rows of Hv per pass-1 work item
constexpr int kTile = 64;       // pass-2 output tile edge
constexpr int kSub = 4;         // pass-2 outputs per thread, per dimension
constexpr int kSpan = kTile / kSub;          // 16
constexpr int kGramThreads = kSpan * kSpan;  // 256
constexpr int kRows = 16;       // pass-2 rows staged per iteration

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void __launch_bounds__(kThreads) gate_project_kernel(
    const float* __restrict__ Hx, const float* __restrict__ Hf,
    const float* __restrict__ r, const unsigned char* __restrict__ mask,
    const float* __restrict__ w, const float* __restrict__ cov,
    const float* __restrict__ gate, float cap, int F, int M, int D, int k,
    float* __restrict__ P, unsigned char* __restrict__ ok_out,
    float* __restrict__ chi_out) {
  extern __shared__ float smem[];
  const int f = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ncol = k + D + 1;  // [Hf | Hx | r]
  const int R = M - k;         // projected rows
  float* A = smem;             // M x ncol
  float* T = A + M * ncol;     // M x D, rows k.. hold Hv cov
  float* S = T + M * D;        // M x M
  float* v = S + M * M;        // reflector
  float* rhs = v + M;          // forward-solve right-hand side
  float* scal = rhs + M;       // 0 raw max, 1 rows, 2 scale, 3 chi2, 6 ok

  const size_t feat = (size_t)b * F + f;
  const float* hx = Hx + feat * M * D;
  const float* hf = Hf + feat * M * k;
  const float* rr = r + feat * M;
  const unsigned char* mk = mask + feat * M;
  const float* ww = w + feat * M;
  const float* cv = cov + (size_t)b * D * D;

  // --- whiten + mask (select) ---
  for (int idx = tid; idx < M * ncol; idx += blockDim.x) {
    const int i = idx / ncol, c = idx - i * ncol;
    float x;
    if (c < k) x = hf[i * k + c];
    else if (c < k + D) x = hx[i * D + (c - k)];
    else x = rr[i];
    A[idx] = mk[i] ? x * ww[i] : 0.0f;
  }
  __syncthreads();
  if (warp == 0) {
    float mx = 0.0f, cnt = 0.0f;
    for (int i = lane; i < M; i += 32) {
      mx = fmaxf(mx, fabsf(A[i * ncol + k + D]));
      cnt += mk[i] ? 1.0f : 0.0f;
    }
    mx = warp_max(mx);
    cnt = warp_sum(cnt);
    if (lane == 0) { scal[0] = mx; scal[1] = cnt; }
  }

  // --- k Householder reflectors against the Hf columns ---
  for (int j = 0; j < k; ++j) {
    if (warp == 0) {
      float s = 0.0f;
      for (int i = j + lane; i < M; i += 32) { const float x = A[i * ncol + j]; s += x * x; }
      const float nx = sqrtf(warp_sum(s));
      const float xj = A[j * ncol + j];
      // never a zero sign: a zero pivot entry must still give alpha = -|x|
      const float alpha = -(xj >= 0.0f ? 1.0f : -1.0f) * nx;
      float s2 = 0.0f;
      for (int i = lane; i < M; i += 32) {
        float vi = (i >= j) ? A[i * ncol + j] : 0.0f;
        if (i == j) vi -= alpha;
        v[i] = vi;
        s2 += vi * vi;
      }
      const float nv = sqrtf(warp_sum(s2));
      const bool tiny = nv < 1e-12f;
      for (int i = lane; i < M; i += 32) v[i] = v[i] / (tiny ? 1.0f : nv);
      if (lane == 0) scal[2] = tiny ? 0.0f : 2.0f;
    }
    __syncthreads();
    const float scale = scal[2];
    for (int c = tid; c < ncol; c += blockDim.x) {
      float dot = 0.0f;
      for (int i = 0; i < M; ++i) dot += v[i] * A[i * ncol + c];
      for (int i = 0; i < M; ++i) A[i * ncol + c] -= (scale * v[i]) * dot;
    }
    __syncthreads();
  }

  // --- T = Hv cov (rows k..M-1): one work item per (covariance column,
  // chunk of kRowChunk rows), the column's loads issued four at a time ---
  const int nchunk = (R + kRowChunk - 1) / kRowChunk;
  for (int wi = tid; wi < D * nchunk; wi += blockDim.x) {
    const int e = wi % D, i0 = (wi / D) * kRowChunk;
    const int nr = min(kRowChunk, R - i0);
    const float* hv = A + (k + i0) * ncol + k;
    const float* ce = cv + e;
    float acc[kRowChunk];
#pragma unroll
    for (int t = 0; t < kRowChunk; ++t) acc[t] = 0.0f;
    int d = 0;
    for (; d + 4 <= D; d += 4) {
      const float c0 = __ldg(ce + (size_t)d * D), c1 = __ldg(ce + (size_t)(d + 1) * D);
      const float c2 = __ldg(ce + (size_t)(d + 2) * D), c3 = __ldg(ce + (size_t)(d + 3) * D);
#pragma unroll
      for (int t = 0; t < kRowChunk; ++t) {
        if (t < nr) {
          const float* h = hv + t * ncol + d;
          acc[t] += h[0] * c0;
          acc[t] += h[1] * c1;
          acc[t] += h[2] * c2;
          acc[t] += h[3] * c3;
        }
      }
    }
    for (; d < D; ++d) {
      const float cde = __ldg(ce + (size_t)d * D);
#pragma unroll
      for (int t = 0; t < kRowChunk; ++t)
        if (t < nr) acc[t] += hv[t * ncol + d] * cde;
    }
#pragma unroll
    for (int t = 0; t < kRowChunk; ++t)
      if (t < nr) T[(k + i0 + t) * D + e] = acc[t];
  }
  __syncthreads();

  // --- S = T Hv^T, symmetrized, + I ---
  for (int idx = tid; idx < M * M; idx += blockDim.x) {
    const int i = idx / M, j = idx - i * M;
    float s = 0.0f;
    if (i >= k && j >= k) {
      const float* ti = T + i * D;
      const float* hj = A + j * ncol + k;
      for (int e = 0; e < D; ++e) s += ti[e] * hj[e];
    }
    S[idx] = s;
  }
  __syncthreads();
  for (int idx = tid; idx < M * M; idx += blockDim.x) {
    const int i = idx / M, j = idx - i * M;
    if (i < j) {
      const float a = 0.5f * (S[i * M + j] + S[j * M + i]);
      S[i * M + j] = a;
      S[j * M + i] = a;
    } else if (i == j) {
      S[idx] += 1.0f;
    }
  }
  for (int i = tid; i < M; i += blockDim.x) rhs[i] = (i >= k) ? A[i * ncol + k + D] : 0.0f;
  __syncthreads();

  // --- right-looking Cholesky with the forward solve folded in.  Rows < k
  // of S are identity with a zero right-hand side, so they add nothing and
  // the sweep starts at k.  One barrier per column: every thread derives
  // the pivot itself, and step j writes only the lower triangle below and
  // right of j and rhs beyond j, while it reads column j and rhs[j]. ---
  float chi = 0.0f;
  for (int j = k; j < M; ++j) {
    const float d = sqrtf(fmaxf(S[j * M + j], 1e-12f));
    const float yj = rhs[j] / d;
    chi += yj * yj;
    const int n = M - j - 1, ntri = n * (n + 1) / 2;
    for (int idx = tid; idx < ntri + n; idx += blockDim.x) {
      if (idx < ntri) {
        int r = (int)((sqrtf(8.0f * idx + 1.0f) - 1.0f) * 0.5f);
        if ((r + 1) * (r + 2) / 2 <= idx) ++r;
        if (r * (r + 1) / 2 > idx) --r;
        const int a = j + 1 + r, c = j + 1 + (idx - r * (r + 1) / 2);
        S[a * M + c] -= (S[a * M + j] / d) * (S[c * M + j] / d);
      } else {
        const int i = j + 1 + (idx - ntri);
        rhs[i] -= yj * (S[i * M + j] / d);
      }
    }
    __syncthreads();
  }
  if (tid == 0) scal[3] = chi;

  // --- gate ---
  if (tid == 0) {
    const int n_rows = (int)scal[1];
    const int dof = max(n_rows - k, 1);
    const float g = (dof <= M) ? gate[dof] : 0.0f;
    const float chi = scal[3];
    const bool okb = (chi < g) && (n_rows >= k + 2) && (scal[0] < cap);
    ok_out[feat] = okb ? 1 : 0;
    chi_out[feat] = chi;
    scal[6] = okb ? 1.0f : 0.0f;
  }
  __syncthreads();
  const bool okb = scal[6] != 0.0f;

  // --- gated projected rows [ok*Hv | ok*rv] ---
  float* pout = P + feat * (size_t)R * (D + 1);
  for (int idx = tid; idx < R * (D + 1); idx += blockDim.x) {
    const int i = idx / (D + 1), c = idx - i * (D + 1);
    pout[idx] = okb ? A[(k + i) * ncol + k + c] : 0.0f;
  }
}

// G_b = X_b^T X_b over each sequence's N gated rows X_b (N x (D+1)): one
// block per kTile x kTile output tile on or above the diagonal (mirrored
// below it), kSub x kSub outputs per thread.
__global__ void __launch_bounds__(kGramThreads) gram_kernel(
    const float* __restrict__ P, int N, int D, float* __restrict__ G,
    float* __restrict__ c) {
  if (blockIdx.x < blockIdx.y) return;
  __shared__ float Xa[kRows][kTile];
  __shared__ float Xb[kRows][kTile];
  const int E = D + 1;
  const int b = blockIdx.z;
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;
  const int t = threadIdx.x, tx = t % kSpan, ty = t / kSpan;
  const float* X = P + (size_t)b * N * E;
  float acc[kSub][kSub];
#pragma unroll
  for (int u = 0; u < kSub; ++u)
#pragma unroll
    for (int v = 0; v < kSub; ++v) acc[u][v] = 0.0f;
  for (int n0 = 0; n0 < N; n0 += kRows) {
    for (int idx = t; idx < kRows * kTile; idx += kGramThreads) {
      const int rr = idx / kTile, cc = idx - rr * kTile;
      const int n = n0 + rr;
      Xa[rr][cc] = (n < N && row0 + cc < E) ? X[(size_t)n * E + row0 + cc] : 0.0f;
      Xb[rr][cc] = (n < N && col0 + cc < E) ? X[(size_t)n * E + col0 + cc] : 0.0f;
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
    __syncthreads();
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

}  // namespace

extern "C" {

// Shared memory pass 1 needs for one (sequence, feature) block.
size_t msckf_gram_gate_smem_bytes(int M, int D, int k) {
  return sizeof(float) * ((size_t)M * (k + D + 1) + (size_t)M * D + (size_t)M * M +
                          2 * (size_t)M + 8);
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
  const size_t smem = msckf_gram_gate_smem_bytes(M, D, k);
  cudaError_t e = cudaFuncSetAttribute(
      gate_project_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  gate_project_kernel<<<dim3(F, B), kThreads, smem, s>>>(
      Hx, Hf, r, mask, w, cov, gate, cap, F, M, D, k, P, ok, chi);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int E = D + 1, nt = (E + kTile - 1) / kTile;
  gram_kernel<<<dim3(nt, nt, B), kGramThreads, 0, s>>>(P, F * (M - k), D, G, c);
  return (int)cudaGetLastError();
}

}  // extern "C"
