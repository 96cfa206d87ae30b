// Grouped GEMM with a fused router permute, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/grouped_gemm.py::grouped_gemm_pallas, all
// three weight modes, with row_index / out_index.
//
// Computes out[out_index[r]] = lhs[row_index[r]] @ rhs[group(r)] for GEMM
// rows r sorted by group (group g owns rows [sum(gs[:g]), sum(gs[:g+1]))),
// accumulating in float32; the output has lhs's type. Without row_index row
// r reads lhs[r]; without out_index it lands in out[r]; destinations are
// distinct. Each block reads its group's row range from group_sizes on the
// device (a prefix sum of at most G int32 values), so the wrapper launches
// no offsets kernel. The kernel zeroes the destinations of the rows past
// sum(group_sizes); so where the destinations cover every row of out (no
// out_index, or out_index a permutation of the M rows) out needs no
// zero-fill, and otherwise the caller zero-fills it. Empty groups are
// allowed and move no weight bytes. Indices are int32 or int64.
//
// Weight modes (template parameter W): dense, rhs (G, K, N) of lhs's type;
// int8, rhs (G, K, N) codes with one float32 scale per expert; int4, rhs
// (G, K/2, N) bytes whose low nibble holds row 2p and high nibble row 2p+1,
// sign-extended by ((x & 0xF) ^ 8) - 8, with one float32 scale per (expert,
// block of block_n columns).
//
// What bounds it on an H100: at decode the rows are few (8 sequences x top-8
// = 64 rows over 32 experts, about 2 per expert) and at prefill a 64-token
// chunk gives ~16 rows per expert: either way the work is reading the
// visited experts' weights (2 FLOP per weight byte at decode, ~30 at
// prefill, against the ~295 FLOP/byte the card needs before its tensor
// cores limit). So the kernel is bound by weight bytes, and by how many of
// them it keeps in flight.
//
// What the design does about it (bf16 activations, every weight mode):
// one block of 4 warps per (expert, 64-column N tile), so all ~416 decode
// blocks are resident in one wave, and an empty expert's blocks exit before
// touching weights. The block stages its rows' source and destination
// indices in shared memory once per pass, then streams K in 32-deep steps
// through a 4-stage ring of cp.async 16-byte copies: each stage holds the
// gathered A tile (only the m16 sub-tiles that hold rows) and the weight
// tile, and the copies of steps i+1..i+3 are in flight while step i
// multiplies. One pass takes up to 64 rows (four m16 sub-tiles, the empty
// ones skipped by a warp-uniform branch), so each weight tile is read once
// per expert up to 64 rows; more rows loop over further passes. Products
// run on the tensor cores: mma.sync m16n8k16 bf16 -> f32, A fragments by
// ldmatrix, dense weight fragments by ldmatrix.trans from the (K, N) tile.
// int8 / int4 copy the codes (1/2 or 1/4 of the bf16 bytes) and turn them
// into bf16 fragments between shared memory and the mma (every int8 and
// int4 code is exact in bf16); the scale depends only on (expert, column),
// so it is applied in the epilogue: scale * sum(x * code). The gather and
// the scatter only change addresses, so fused and unfused calls run the
// same arithmetic in the same order and are bit-identical.
//
// float32 activations keep the CUDA-core body (16-row tiles, float32 FMAs
// on tiles staged in shared memory, quantized weights dequantised as they
// are staged: to_f32(x) * (float(code) * scale)): TF32 would not meet the
// float32 tolerance, and that path is not on the serve.
#include "common.cuh"

#include <limits.h>

namespace {

// weight modes, shared with the Python wrapper
constexpr int W_DENSE = 0;
constexpr int W_INT8 = 1;
constexpr int W_INT4 = 2;

__device__ __forceinline__ int read_index(const void* p, int i, bool wide) {
  if (!wide) return static_cast<const int*>(p)[i];
  const long long v = static_cast<const long long*>(p)[i];
  return v < 0 || v > INT_MAX ? -1 : static_cast<int>(v);
}

// Block-wide: *lo = sum(gs[0:g]), *total = sum(gs[0:groups]).
template <int THREADS>
__device__ __forceinline__ void expert_range(const int* gs, int g, int groups,
                                             int* lo, int* total) {
  __shared__ int part[2][THREADS / 32];
  int a = 0, b = 0;
  for (int i = threadIdx.x; i < groups; i += THREADS) {
    const int s = gs[i];
    b += s;
    if (i < g) a += s;
  }
  a = warp_sum_int(a);
  b = warp_sum_int(b);
  if ((threadIdx.x & 31) == 0) {
    part[0][threadIdx.x / 32] = a;
    part[1][threadIdx.x / 32] = b;
  }
  __syncthreads();
  a = 0;
  b = 0;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) {
    a += part[0][w];
    b += part[1][w];
  }
  *lo = a;
  *total = b;
}

// Zero the destinations of GEMM rows [r_lo, r_hi) (rows past
// sum(group_sizes)) in columns [n0, n0 + width).
template <typename T, int THREADS>
__device__ __forceinline__ void zero_surplus(T* out, const void* out_index,
                                             bool wide, int r_lo, int r_hi,
                                             int out_rows, int n0, int width,
                                             int n_dim) {
  for (int i = threadIdx.x; i < (r_hi - r_lo) * width; i += THREADS) {
    const int r = r_lo + i / width, n = n0 + i % width;
    const int dst = out_index ? read_index(out_index, r, wide) : r;
    if (n < n_dim && dst >= 0 && dst < out_rows)
      out[(size_t)dst * n_dim + n] = from_f32<T>(0.f);
  }
}

// ---------------------------------------------------------------------------
// bf16 activations: tensor cores
// ---------------------------------------------------------------------------

// The tilings the bf16 kernel is built for, (BM, BN, BK): rows per pass,
// output columns per block, reduction depth per stage. The first is the
// default. Every tiling cuts only rows and columns: each output element
// sums K in the same m16n8k16 steps in the same order, so all tilings give
// the same bits. Shared with the Python wrapper (rt_grouped_gemm_tilings).
#define GG_TILINGS(X) \
  X(64, 64, 32)       \
  X(16, 64, 64)       \
  X(32, 64, 32)       \
  X(16, 32, 64)       \
  X(64, 32, 32)       \
  X(128, 128, 32)

// Static shared memory stays under the 48 KB a block gets without opting
// in: the ring takes as many stages (2 to 4) as fit in RING_BYTES.
constexpr int RING_BYTES = 45056;

template <int BM_, int BN_, int BK_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_;
  static_assert(BM % 16 == 0 && BN % 16 == 0 && BK % 16 == 0, "mma tiles");
  static constexpr int THREADS = BN / 16 * 32;  // one warp per 16 columns
  static constexpr int SUB = BM / 16;           // m16 sub-tiles per pass
  static constexpr int A_PITCH = BK + 8;  // bf16 per A row (odd 16 B units:
  static constexpr int B_PITCH = BN + 8;  // ldmatrix conflict-free)
  static constexpr int Q_PITCH = BN + 16;  // bytes per code row
  __host__ __device__ static constexpr int b_stage_bytes(int w) {
    return w == W_DENSE ? BK * B_PITCH * 2 : w == W_INT8 ? BK * Q_PITCH
                                                         : (BK / 2) * Q_PITCH;
  }
  static constexpr int stage_bytes = BM * A_PITCH * 2 + BK * B_PITCH * 2;
  static constexpr int STAGES = RING_BYTES / stage_bytes >= 4   ? 4
                                : RING_BYTES / stage_bytes >= 3 ? 3
                                                                : 2;
  static_assert(STAGES * stage_bytes <= RING_BYTES, "ring exceeds 48 KB");
};

// The warp's weight fragments for k rows kk..kk+15 of the stage and its 16
// columns wn..wn+15: b[0], b[1] for columns wn..wn+7, b[2], b[3] for
// wn+8..wn+15.
template <int W, typename T>
__device__ __forceinline__ void load_b(uint32_t* b, const unsigned char* st,
                                       int kk, int wn, int lane) {
  if constexpr (W == W_DENSE) {
    const __nv_bfloat16* w = reinterpret_cast<const __nv_bfloat16*>(st);
    ldmatrix_x4_trans(b, w + (kk + (lane & 15)) * T::B_PITCH + wn + (lane >> 4) * 8);
  } else {
    constexpr int QP = T::Q_PITCH;
    const signed char* q = reinterpret_cast<const signed char*>(st);
    const int t = lane & 3;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = wn + j * 8 + (lane >> 2);
      if constexpr (W == W_INT8) {
        b[2 * j] = pack_bf16((float)q[(kk + 2 * t) * QP + n],
                             (float)q[(kk + 2 * t + 1) * QP + n]);
        b[2 * j + 1] = pack_bf16((float)q[(kk + 2 * t + 8) * QP + n],
                                 (float)q[(kk + 2 * t + 9) * QP + n]);
      } else {
        // packed row p holds k = 2p (low nibble) and 2p + 1 (high nibble)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int x = q[(kk / 2 + t + 4 * h) * QP + n];
          b[2 * j + h] = pack_bf16((float)(((x & 0xF) ^ 8) - 8),
                                   (float)((((x >> 4) & 0xF) ^ 8) - 8));
        }
      }
    }
  }
}

// (512 threads per SM at the register cap: ptxas may use up to 128
// registers a thread in every tiling)
template <int W, typename T>
__global__ void __launch_bounds__(T::THREADS, 512 / T::THREADS)
grouped_gemm_mma_kernel(const __nv_bfloat16* __restrict__ lhs,
                        const void* __restrict__ rhs,
                        const float* __restrict__ scales,
                        const int* __restrict__ group_sizes,
                        const void* __restrict__ row_index,
                        const void* __restrict__ out_index, int idx64,
                        __nv_bfloat16* __restrict__ out, int m, int k_dim,
                        int n_dim, int groups, int lhs_rows, int out_rows,
                        int block_n, int a_vec) {
  constexpr int BM = T::BM, BN = T::BN, BK = T::BK, STAGES = T::STAGES;
  constexpr int THREADS = T::THREADS, SUB = T::SUB;
  __shared__ __align__(128) __nv_bfloat16 a_s[STAGES][BM][T::A_PITCH];
  __shared__ __align__(128) unsigned char b_s[STAGES][T::b_stage_bytes(W)];
  __shared__ int src_s[BM], dst_s[BM];

  const int g = blockIdx.x, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  int lo, total;
  expert_range<THREADS>(group_sizes, g, groups, &lo, &total);
  if (g == 0 && total < m)
    zero_surplus<__nv_bfloat16, THREADS>(out, out_index, idx64 & 2,
                                         max(total, 0), m, out_rows, n0, BN,
                                         n_dim);
  const int hi = min(lo + group_sizes[g], m);
  lo = min(lo, m);
  if (lo >= hi) return;  // empty expert: no weight bytes move

  const size_t w_bytes = W == W_DENSE ? 2 : 1;
  const size_t w_rows = W == W_INT4 ? k_dim / 2 : k_dim;
  const unsigned char* w =
      static_cast<const unsigned char*>(rhs) + (size_t)g * w_rows * n_dim * w_bytes;
  const int steps = (k_dim + BK - 1) / BK;
  const int wn = warp * 16;

  for (int p0 = lo; p0 < hi; p0 += BM) {
    const int cnt = min(BM, hi - p0);
    const int nsub = (cnt + 15) / 16;
    __syncthreads();  // the previous pass no longer reads src_s / dst_s
    for (int i = tid; i < BM; i += THREADS) {
      int s = -1, d = -1;
      if (i < cnt) {
        const int r = p0 + i;
        s = row_index ? read_index(row_index, r, idx64 & 1) : r;
        d = out_index ? read_index(out_index, r, idx64 & 2) : r;
      }
      src_s[i] = s >= 0 && s < lhs_rows ? s : -1;
      dst_s[i] = d >= 0 && d < out_rows ? d : -1;
    }
    __syncthreads();

    // Copies of K step `step` into stage step % STAGES: the A rows of the
    // live sub-tiles (rows without a source are zero-filled) and the
    // weight tile (zero past K and N).
    auto issue = [&](int step) {
      const int st = step % STAGES, k0 = step * BK;
      for (int c = tid; c < nsub * 16 * (BK / 8); c += THREADS) {
        const int row = c / (BK / 8), kc = (c % (BK / 8)) * 8, k = k0 + kc;
        const int src = src_s[row];
        __nv_bfloat16* dst = &a_s[st][row][kc];
        if (a_vec) {
          const bool ok = src >= 0 && k < k_dim;
          cp_async16(dst, ok ? lhs + (size_t)src * k_dim + k : lhs, ok);
        } else {  // K % 8 != 0 or lhs not 16-byte aligned: plain loads
#pragma unroll
          for (int j = 0; j < 8; ++j)
            dst[j] = src >= 0 && k + j < k_dim ? lhs[(size_t)src * k_dim + k + j]
                                               : __float2bfloat16(0.f);
        }
      }
      if constexpr (W == W_DENSE) {
        for (int c = tid; c < BK * (BN / 8); c += THREADS) {
          const int kk = c / (BN / 8), nc = (c % (BN / 8)) * 8;
          const int k = k0 + kk, n = n0 + nc;
          const bool ok = k < k_dim && n < n_dim;
          cp_async16(b_s[st] + (kk * T::B_PITCH + nc) * 2,
                     ok ? w + ((size_t)k * n_dim + n) * 2 : w, ok);
        }
      } else {
        constexpr int ROWS = W == W_INT8 ? BK : BK / 2;
        const int r0 = W == W_INT8 ? k0 : k0 / 2;
        for (int c = tid; c < ROWS * (BN / 16); c += THREADS) {
          const int rr = c / (BN / 16), nc = (c % (BN / 16)) * 16;
          const int r = r0 + rr, n = n0 + nc;
          const bool ok = r < (int)w_rows && n < n_dim;
          cp_async16(b_s[st] + rr * T::Q_PITCH + nc,
                     ok ? w + (size_t)r * n_dim + n : w, ok);
        }
      }
    };

    float acc[SUB][2][4];
#pragma unroll
    for (int s = 0; s < SUB; ++s)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[s][j][e] = 0.f;

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < steps) issue(s);
      cp_async_commit();  // one group per step, empty past the end
    }
    for (int step = 0; step < steps; ++step) {
      cp_async_wait<STAGES - 2>();  // this thread's copies of `step` landed
      __syncthreads();              // everyone's, and stage step-1 is free
      if (step + STAGES - 1 < steps) issue(step + STAGES - 1);
      cp_async_commit();
      const int st = step % STAGES;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t b[4];
        load_b<W, T>(b, b_s[st], kk, wn, lane);
#pragma unroll
        for (int s = 0; s < SUB; ++s) {
          if (s < nsub) {  // uniform across the block
            uint32_t a[4];
            ldmatrix_x4(a, &a_s[st][s * 16 + (lane & 15)][kk + (lane >> 4) * 8]);
            mma_bf16_16816(acc[s][0], a, b[0], b[1]);
            mma_bf16_16816(acc[s][1], a, b[2], b[3]);
          }
        }
      }
    }
    cp_async_wait<0>();

    // epilogue: scale per column (quantized modes), bf16x2 stores to the
    // destination rows
    const int n_blocks = W == W_INT4 ? n_dim / block_n : 1;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + wn + j * 8 + 2 * (lane & 3);
      if (n >= n_dim) continue;
      float s0 = 1.f, s1 = 1.f;
      if constexpr (W == W_INT8) {
        s0 = s1 = scales[g];
      } else if constexpr (W == W_INT4) {
        s0 = scales[(size_t)g * n_blocks + n / block_n];
        s1 = scales[(size_t)g * n_blocks + (n + 1) / block_n];
      }
#pragma unroll
      for (int s = 0; s < SUB; ++s) {
        if (s >= nsub) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = s * 16 + (lane >> 2) + 8 * h;
          const int dst = row < cnt ? dst_s[row] : -1;
          if (dst < 0) continue;
          float c0 = acc[s][j][2 * h], c1 = acc[s][j][2 * h + 1];
          if constexpr (W != W_DENSE) {
            c0 *= s0;
            c1 *= s1;
          }
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)dst * n_dim + n) =
              __floats2bfloat162_rn(c0, c1);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32 activations: CUDA cores
// ---------------------------------------------------------------------------

constexpr int TM = 16;        // rows per row tile
constexpr int TN = 64;        // output columns per block
constexpr int TK = 64;        // reduction depth per shared-memory stage
constexpr int THREADS = 256;  // 16 column groups of 4 x 16 rows

// 16 consecutive int8 codes (one 16-byte load), sign-extended to int.
__device__ __forceinline__ void load16_codes(const int8_t* p, int* o) {
  const int4 u = *reinterpret_cast<const int4*>(p);
  const int8_t* b = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int j = 0; j < 16; ++j) o[j] = b[j];
}

template <int W>
__global__ void __launch_bounds__(THREADS)
grouped_gemm_fma_kernel(const float* __restrict__ lhs,
                        const void* __restrict__ rhs,
                        const float* __restrict__ scales,
                        const int* __restrict__ group_sizes,
                        const void* __restrict__ row_index,
                        const void* __restrict__ out_index, int idx64,
                        float* __restrict__ out, int m, int k_dim, int n_dim,
                        int groups, int lhs_rows, int out_rows, int block_n) {
  const int g = blockIdx.x;
  const int n0 = blockIdx.y * TN;
  int lo, total;
  expert_range<THREADS>(group_sizes, g, groups, &lo, &total);
  if (g == 0 && total < m)
    zero_surplus<float, THREADS>(out, out_index, idx64 & 2, max(total, 0), m,
                                 out_rows, n0, TN, n_dim);
  const int hi = min(lo + group_sizes[g], m);
  lo = min(lo, m);
  if (lo >= hi) return;  // empty expert: no weight bytes move

  __shared__ float a_s[TK][TM];
  __shared__ __align__(16) float b_s[TK][TN];
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // owns columns n0 + 4*tx .. +3
  const int ty = tid / 16;  // owns row r0 + ty
  // expert g's weights: k_dim rows (dense, int8) or k_dim / 2 packed rows
  const size_t w_rows = W == W_INT4 ? k_dim / 2 : k_dim;
  const float* w = static_cast<const float*>(rhs) + (size_t)g * w_rows * n_dim;
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
          const int src = row_index ? read_index(row_index, r, idx64 & 1) : r;
          if (src >= 0 && src < lhs_rows) a = lhs[(size_t)src * k_dim + k];
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
      const int dst = out_index ? read_index(out_index, r, idx64 & 2) : r;
      if (dst >= 0 && dst < out_rows) {
        float* o = out + (size_t)dst * n_dim;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + tx * 4 + j;
          if (n < n_dim) o[n] = acc[j];
        }
      }
    }
  }
}

struct Args {
  const void* lhs;
  const void* rhs;
  const float* scales;
  const int* group_sizes;
  const void* row_index;
  const void* out_index;
  int idx64;
  void* out;
  int m, k_dim, n_dim, groups, lhs_rows, out_rows, block_n;
};

template <int W, typename T>
void launch_mma(const Args& a, cudaStream_t s) {
  const int a_vec = a.k_dim % 8 == 0 &&
                    reinterpret_cast<uintptr_t>(a.lhs) % 16 == 0;
  const dim3 grid(a.groups, (a.n_dim + T::BN - 1) / T::BN);
  grouped_gemm_mma_kernel<W, T><<<grid, T::THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(a.lhs), a.rhs, a.scales,
      a.group_sizes, a.row_index, a.out_index, a.idx64,
      static_cast<__nv_bfloat16*>(a.out), a.m, a.k_dim, a.n_dim, a.groups,
      a.lhs_rows, a.out_rows, a.block_n, a_vec);
}

bool known_tiling(int tm, int tn, int tk) {
#define GG_KNOWN(bm, bn, bk) \
  if (tm == bm && tn == bn && tk == bk) return true;
  GG_TILINGS(GG_KNOWN)
#undef GG_KNOWN
  return false;
}

// bf16 activations: the tensor-core kernel of tiling (tm, tn, tk); float32:
// the CUDA-core kernel, whose tiling is fixed.
template <int W>
void launch(const Args& a, bool bf16, int tm, int tn, int tk, cudaStream_t s) {
  if (bf16) {
#define GG_LAUNCH(bm, bn, bk)                          \
  if (tm == bm && tn == bn && tk == bk) {              \
    launch_mma<W, Tile<bm, bn, bk>>(a, s);             \
    return;                                            \
  }
    GG_TILINGS(GG_LAUNCH)
#undef GG_LAUNCH
  } else {
    const dim3 grid(a.groups, (a.n_dim + TN - 1) / TN);
    grouped_gemm_fma_kernel<W><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(a.lhs), a.rhs, a.scales, a.group_sizes,
        a.row_index, a.out_index, a.idx64, static_cast<float*>(a.out), a.m,
        a.k_dim, a.n_dim, a.groups, a.lhs_rows, a.out_rows, a.block_n);
  }
}

}  // namespace

// The tilings (tile_m, tile_n, tile_k) the bf16 kernel is built for, the
// default first: writes up to `cap` triples to `out` and returns how many
// there are.
extern "C" int rt_grouped_gemm_tilings(int* out, int cap) {
  int n = 0;
#define GG_LIST(bm, bn, bk)  \
  if (n < cap) {             \
    out[3 * n] = bm;         \
    out[3 * n + 1] = bn;     \
    out[3 * n + 2] = bk;     \
  }                          \
  ++n;
  GG_TILINGS(GG_LIST)
#undef GG_LIST
  return n;
}

// rhs: dense (groups, k_dim, n_dim) of lhs's dtype, or int8 codes
// (groups, k_dim, n_dim) with scales (groups,) (wmode 1), or packed int4
// (groups, k_dim / 2, n_dim) with scales (groups, n_dim / block_n) (wmode 2);
// scales may be NULL for dense; rhs 16-byte aligned, n_dim % 8 == 0 (dense)
// or % 16 == 0 (quantized). group_sizes: (groups,) int32 on the device.
// row_index / out_index: (m,) int32, or int64 where bit 0 / bit 1 of idx64
// is set, or NULL; destinations distinct. The destinations of rows past
// sum(group_sizes) get 0; rows of out that no row targets are left as they
// are (the caller zero-fills out unless the destinations cover it).
// (tile_m, tile_n, tile_k) must be one of GG_TILINGS, in every dtype (the
// float32 kernel ignores it); any other is cudaErrorInvalidValue.
// Returns the CUDA error code of the launch (0 = success).
extern "C" int rt_grouped_gemm(const void* lhs, const void* rhs,
                               const float* scales, const int* group_sizes,
                               const void* row_index, const void* out_index,
                               int idx64, void* out, int m, int k_dim,
                               int n_dim, int groups, int lhs_rows,
                               int out_rows, int dtype, int wmode, int block_n,
                               int tile_m, int tile_n, int tile_k,
                               void* stream) {
  if (!known_tiling(tile_m, tile_n, tile_k))
    return static_cast<int>(cudaErrorInvalidValue);
  if (m > 0 && groups > 0 && n_dim > 0) {
    if (wmode != W_DENSE && (scales == nullptr || n_dim % 16 != 0))
      return static_cast<int>(cudaErrorInvalidValue);
    if (wmode == W_INT4 && (k_dim % 2 != 0 || block_n <= 0 || n_dim % block_n != 0))
      return static_cast<int>(cudaErrorInvalidValue);
    const Args a{lhs, rhs, scales, group_sizes, row_index, out_index, idx64,
                 out, m, k_dim, n_dim, groups, lhs_rows, out_rows, block_n};
    const bool bf16 = dtype == RT_DTYPE_BF16;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (wmode) {
      case W_DENSE: launch<W_DENSE>(a, bf16, tile_m, tile_n, tile_k, s); break;
      case W_INT8: launch<W_INT8>(a, bf16, tile_m, tile_n, tile_k, s); break;
      case W_INT4: launch<W_INT4>(a, bf16, tile_m, tile_n, tile_k, s); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
