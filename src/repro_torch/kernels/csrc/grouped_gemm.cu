// Grouped GEMM with a fused router permute, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/grouped_gemm.py::grouped_gemm_pallas (the
// dense f32/bf16 path with row_index / out_index; not the int8/int4 paths).
//
// Computes out[out_index[r]] = lhs[row_index[r]] @ rhs[group(r)] for GEMM
// rows r sorted by group (group g owns rows [offsets[g], offsets[g+1])),
// accumulating in float32. Without row_index row r reads lhs[r]; without
// out_index it lands in out[r]. The caller zero-fills `out`, so rows no GEMM
// row targets, and rows past sum(group_sizes), stay 0. Empty groups are
// allowed.
//
// What bounds it on an H100: at decode the rows are few (8 sequences x top-8
// = 64 rows over 32 experts, about 2 per expert) and the work is reading the
// visited experts' weights: a granite MoE layer holds ~100 MB of expert
// weights, far below the ~295 FLOP/byte the card needs before the tensor
// cores limit. So the kernel is bound by weight bytes.
//
// What the design does about it: one block per (expert, 64-column N-tile)
// reads its expert's offsets on the device (no host sync) and returns before
// touching weights when the expert got no rows, so only visited experts'
// weights move. The block then walks its rows in 16-row tiles; at decode all
// rows of an expert fit one tile, so each visited weight tile is read from
// memory once, with 16-byte vector loads. Products are plain float32 FMAs
// (no wgmma / TMA yet): at 2 rows per expert the tensor cores would idle.
// The gather and the scatter ride in the row loads and the epilogue stores,
// so neither the sorted token copy nor the unpermuted output is
// materialised. Fused and unfused calls run the same arithmetic in the same
// order, so in float32 they are bit-identical.
#include "common.cuh"

namespace {

constexpr int TM = 16;        // rows per row tile
constexpr int TN = 64;        // output columns per block
constexpr int TK = 64;        // reduction depth per shared-memory stage
constexpr int THREADS = 256;  // 16 column groups of 4 x 16 rows

template <typename T>
__global__ void __launch_bounds__(THREADS)
grouped_gemm_kernel(const T* __restrict__ lhs, const T* __restrict__ rhs,
                    const int* __restrict__ offsets,
                    const int* __restrict__ row_index,
                    const int* __restrict__ out_index, T* __restrict__ out,
                    int m, int k_dim, int n_dim, int lhs_rows, int out_rows) {
  const int g = blockIdx.x;
  const int n0 = blockIdx.y * TN;
  const int lo = min(offsets[g], m);
  const int hi = min(offsets[g + 1], m);
  if (lo >= hi) return;  // empty expert: no weight bytes move

  __shared__ float a_s[TK][TM];
  __shared__ __align__(16) float b_s[TK][TN];
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // owns columns n0 + 4*tx .. +3
  const int ty = tid / 16;  // owns row r0 + ty
  const T* w = rhs + (size_t)g * k_dim * n_dim;

  for (int r0 = lo; r0 < hi; r0 += TM) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < k_dim; k0 += TK) {
      for (int i = tid; i < TM * TK; i += THREADS) {
        const int rr = i / TK, kk = i % TK;
        const int r = r0 + rr, k = k0 + kk;
        float a = 0.f;
        if (r < hi && k < k_dim) {
          const int src = row_index ? row_index[r] : r;
          if (src >= 0 && src < lhs_rows) a = to_f32(lhs[(size_t)src * k_dim + k]);
        }
        a_s[kk][rr] = a;
      }
      for (int i = tid; i < TK * (TN / 8); i += THREADS) {
        const int kk = i / (TN / 8), c8 = (i % (TN / 8)) * 8;
        const int k = k0 + kk, n = n0 + c8;
        float v[8];
        if (k < k_dim && n < n_dim) {
          load8(w + (size_t)k * n_dim + n, v);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) b_s[kk][c8 + j] = v[j];
      }
      __syncthreads();
#pragma unroll 16
      for (int kk = 0; kk < TK; ++kk) {
        const float a = a_s[kk][ty];
        const float4 b = *reinterpret_cast<const float4*>(&b_s[kk][tx * 4]);
        acc[0] = fmaf(a, b.x, acc[0]);
        acc[1] = fmaf(a, b.y, acc[1]);
        acc[2] = fmaf(a, b.z, acc[2]);
        acc[3] = fmaf(a, b.w, acc[3]);
      }
      __syncthreads();
    }
    const int r = r0 + ty;
    if (r < hi) {
      const int dst = out_index ? out_index[r] : r;
      if (dst >= 0 && dst < out_rows) {
        T* o = out + (size_t)dst * n_dim;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + tx * 4 + j;
          if (n < n_dim) o[n] = from_f32<T>(acc[j]);
        }
      }
    }
  }
}

template <typename T>
void launch(const void* lhs, const void* rhs, const int* offsets,
            const int* row_index, const int* out_index, void* out, int m,
            int k_dim, int n_dim, int groups, int lhs_rows, int out_rows,
            cudaStream_t stream) {
  const dim3 grid(groups, (n_dim + TN - 1) / TN);
  grouped_gemm_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(lhs), static_cast<const T*>(rhs), offsets,
      row_index, out_index, static_cast<T*>(out), m, k_dim, n_dim, lhs_rows,
      out_rows);
}

}  // namespace

// offsets: (groups + 1,) int32 exclusive cumsum of the group sizes, on the
// device. row_index / out_index: (m,) int32 or NULL. Returns the CUDA error
// code of the launch (0 = success).
extern "C" int rt_grouped_gemm(const void* lhs, const void* rhs,
                               const int* offsets, const int* row_index,
                               const int* out_index, void* out, int m,
                               int k_dim, int n_dim, int groups, int lhs_rows,
                               int out_rows, int dtype, void* stream) {
  if (m > 0 && groups > 0 && n_dim > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == RT_DTYPE_BF16) {
      launch<__nv_bfloat16>(lhs, rhs, offsets, row_index, out_index, out, m,
                            k_dim, n_dim, groups, lhs_rows, out_rows, s);
    } else {
      launch<float>(lhs, rhs, offsets, row_index, out_index, out, m, k_dim,
                    n_dim, groups, lhs_rows, out_rows, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
