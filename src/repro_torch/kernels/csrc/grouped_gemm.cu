// Grouped GEMM with a fused router permute, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/grouped_gemm.py::grouped_gemm_pallas, all
// three weight modes, with row_index / out_index.
//
// Computes out[out_index[r]] = lhs[row_index[r]] @ rhs[group(r)] for GEMM
// rows r sorted by group (group g owns rows [offsets[g], offsets[g+1])),
// accumulating in float32. Without row_index row r reads lhs[r]; without
// out_index it lands in out[r]. The caller zero-fills `out`, so rows no GEMM
// row targets, and rows past sum(group_sizes), stay 0. Empty groups are
// allowed.
//
// Weight modes (template parameter W): dense, rhs (G, K, N) of lhs's type;
// int8, rhs (G, K, N) codes with one float32 scale per expert; int4, rhs
// (G, K/2, N) bytes whose low nibble holds row 2p and high nibble row 2p+1,
// sign-extended by ((x & 0xF) ^ 8) - 8, with one float32 scale per (expert,
// block of block_n columns). A quantized tile is dequantised as it is
// staged in shared memory, as the TPU kernel does in VMEM: the product is
// to_f32(x) * (float(code) * scale) in float32. Only the weight-tile load
// differs between modes; int8 moves 1 and int4 0.5 weight bytes per
// parameter against 2 (bf16) or 4 (f32).
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

// weight modes, shared with the Python wrapper
constexpr int W_DENSE = 0;
constexpr int W_INT8 = 1;
constexpr int W_INT4 = 2;

// 16 consecutive int8 codes (one 16-byte load), sign-extended to int.
__device__ __forceinline__ void load16_codes(const int8_t* p, int* o) {
  const int4 u = *reinterpret_cast<const int4*>(p);
  const int8_t* b = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int j = 0; j < 16; ++j) o[j] = b[j];
}

template <typename T, int W>
__global__ void __launch_bounds__(THREADS)
grouped_gemm_kernel(const T* __restrict__ lhs, const void* __restrict__ rhs,
                    const float* __restrict__ scales,
                    const int* __restrict__ offsets,
                    const int* __restrict__ row_index,
                    const int* __restrict__ out_index, T* __restrict__ out,
                    int m, int k_dim, int n_dim, int lhs_rows, int out_rows,
                    int block_n) {
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
  // expert g's weights: k_dim rows (dense, int8) or k_dim / 2 packed rows
  const size_t w_rows = W == W_INT4 ? k_dim / 2 : k_dim;
  const T* w = static_cast<const T*>(rhs) + (size_t)g * w_rows * n_dim;
  const int8_t* wq = static_cast<const int8_t*>(rhs) + (size_t)g * w_rows * n_dim;
  const int n_blocks = W == W_INT4 ? n_dim / block_n : 1;

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
      if constexpr (W == W_DENSE) {
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
      } else if constexpr (W == W_INT8) {
        // 16 codes per 16-byte load, each times the expert's scale
        const float sc = scales[g];
        for (int i = tid; i < TK * (TN / 16); i += THREADS) {
          const int kk = i / (TN / 16), c16 = (i % (TN / 16)) * 16;
          const int k = k0 + kk, n = n0 + c16;
          int c[16];
          if (k < k_dim && n < n_dim) {
            load16_codes(wq + (size_t)k * n_dim + n, c);
          } else {
#pragma unroll
            for (int j = 0; j < 16; ++j) c[j] = 0;
          }
#pragma unroll
          for (int j = 0; j < 16; ++j) b_s[kk][c16 + j] = (float)c[j] * sc;
        }
      } else {
        // packed row p of the tile holds K rows k0 + 2p (low nibble) and
        // k0 + 2p + 1 (high nibble); K is even, so both or neither exist
        for (int i = tid; i < (TK / 2) * (TN / 16); i += THREADS) {
          const int p = i / (TN / 16), c16 = (i % (TN / 16)) * 16;
          const int k = k0 + 2 * p, n = n0 + c16;
          int c[16];
          if (k < k_dim && n < n_dim) {
            load16_codes(wq + (size_t)(k / 2) * n_dim + n, c);
          } else {
#pragma unroll
            for (int j = 0; j < 16; ++j) c[j] = 0;
          }
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int x = c[j] & 0xFF;
            const float sc = n < n_dim
                ? scales[(size_t)g * n_blocks + (n + j) / block_n] : 0.f;
            b_s[2 * p][c16 + j] = (float)(((x & 0xF) ^ 8) - 8) * sc;
            b_s[2 * p + 1][c16 + j] = (float)((((x >> 4) & 0xF) ^ 8) - 8) * sc;
          }
        }
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

template <typename T, int W>
void launch(const void* lhs, const void* rhs, const float* scales,
            const int* offsets, const int* row_index, const int* out_index,
            void* out, int m, int k_dim, int n_dim, int groups, int lhs_rows,
            int out_rows, int block_n, cudaStream_t stream) {
  const dim3 grid(groups, (n_dim + TN - 1) / TN);
  grouped_gemm_kernel<T, W><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(lhs), rhs, scales, offsets, row_index, out_index,
      static_cast<T*>(out), m, k_dim, n_dim, lhs_rows, out_rows, block_n);
}

template <typename T>
int launch_w(int wmode, const void* lhs, const void* rhs, const float* scales,
             const int* offsets, const int* row_index, const int* out_index,
             void* out, int m, int k_dim, int n_dim, int groups, int lhs_rows,
             int out_rows, int block_n, cudaStream_t s) {
  switch (wmode) {
    case W_DENSE: launch<T, W_DENSE>(lhs, rhs, scales, offsets, row_index, out_index, out, m, k_dim, n_dim, groups, lhs_rows, out_rows, block_n, s); break;
    case W_INT8: launch<T, W_INT8>(lhs, rhs, scales, offsets, row_index, out_index, out, m, k_dim, n_dim, groups, lhs_rows, out_rows, block_n, s); break;
    case W_INT4: launch<T, W_INT4>(lhs, rhs, scales, offsets, row_index, out_index, out, m, k_dim, n_dim, groups, lhs_rows, out_rows, block_n, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

// rhs: dense (groups, k_dim, n_dim) of lhs's dtype, or int8 codes
// (groups, k_dim, n_dim) with scales (groups,) (wmode 1), or packed int4
// (groups, k_dim / 2, n_dim) with scales (groups, n_dim / block_n) (wmode 2);
// scales may be NULL for dense. Quantized modes need n_dim % 16 == 0.
// offsets: (groups + 1,) int32 exclusive cumsum of the group sizes, on the
// device. row_index / out_index: (m,) int32 or NULL. Returns the CUDA error
// code of the launch (0 = success).
extern "C" int rt_grouped_gemm(const void* lhs, const void* rhs,
                               const float* scales, const int* offsets,
                               const int* row_index, const int* out_index,
                               void* out, int m, int k_dim, int n_dim,
                               int groups, int lhs_rows, int out_rows,
                               int dtype, int wmode, int block_n,
                               void* stream) {
  if (m > 0 && groups > 0 && n_dim > 0) {
    if (wmode != W_DENSE && (scales == nullptr || n_dim % 16 != 0))
      return static_cast<int>(cudaErrorInvalidValue);
    if (wmode == W_INT4 && (k_dim % 2 != 0 || block_n <= 0 || n_dim % block_n != 0))
      return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int err = dtype == RT_DTYPE_BF16
        ? launch_w<__nv_bfloat16>(wmode, lhs, rhs, scales, offsets, row_index, out_index, out, m, k_dim, n_dim, groups, lhs_rows, out_rows, block_n, s)
        : launch_w<float>(wmode, lhs, rhs, scales, offsets, row_index, out_index, out, m, k_dim, n_dim, groups, lhs_rows, out_rows, block_n, s);
    if (err) return err;
  }
  return static_cast<int>(cudaGetLastError());
}
