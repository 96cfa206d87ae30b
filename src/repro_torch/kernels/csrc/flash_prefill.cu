// Flash-attention prefill (chunk against a live KV cache), for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/flash_prefill.py::flash_prefill_pallas.
//
// Computes out (B, S, Hq, d) = softmax(q k^T / sqrt(d) + mask) v for
// q (B, S, Hq, d) and k, v (B, T, Hkv, d); q-head h reads kv-head
// h / (Hq / Hkv). Query row j sits at absolute position q_offset + j. A key
// column c is live when c < t_valid, and c <= q_offset + j when causal, and
// q_offset + j - c < window when a window is given. Scores and the online
// softmax are float32; the output is acc / l. A row with no live key
// (l == 0) gives the mean of v over all T cache slots, as the dense form
// does (every score there is the same -1e30, so softmax is uniform over
// T); such a row takes its own short pass over T. (The TPU kernel averages
// over its padded tile range instead.)
//
// What bounds it on an H100: in chunked prefill a 64-row chunk reads the
// live cache prefix of each kv head and does 4 * S * t_valid * d operations
// per q head: with S = 64 and two q heads per kv head that is ~128
// operations per cache byte, below the card's ~295, so cache bytes bound it
// in principle. At the main path's size (one sequence, 8 kv heads, 512 live
// keys) the bytes are ~1 MB, so in practice the time is latency: how many
// rows share one pass over K/V, and how soon the next K/V tile is in flight.
//
// What the design does about it (bf16; FlashAttention-2 on mma.sync): a
// block owns one (batch, kv head, 64-row tile of M), where M packs the
// chunk's rows x the Hq / Hkv q heads of that kv head, so each K/V tile is
// read once for every q head that uses it. Each of the 4 warps owns 16 M
// rows and keeps their Q fragments in registers across the KV loop. Per
// 64-key tile, S = Q K^T runs on mma.sync m16n8k16 in float32; the online
// softmax works on the accumulator fragments (row max and sum over the
// quad of lanes that share a row), P becomes bf16 in registers and is the
// A operand of O += P V directly, with V's fragments from ldmatrix.trans.
// K and V tiles stream through a 4-stage ring of cp.async 16-byte copies:
// the copies of tiles i+1..i+3 are in flight while tile i computes. (With
// two stages the main path's 16 blocks waited out one memory round trip per
// 64-key tile: the grid is too small for other blocks to hide it.) The loop
// visits only live keys: from the window's first key to min(t_valid, last
// row's position + 1), and a warp skips the tiles none of its rows can see.
//
// float32 keeps the CUDA-core body (one block per 16 query rows and q
// head, one key per lane, float32 FMAs): that path is not on the serve,
// and its tolerance is tighter than bf16 tensor-core products allow.
//
// Head dims 16, 32, 64, 112 (Kimi K2) and 128. Every loop of the bf16 body
// steps over d in k16 slices (D / 16 of them) or n8 tiles (D / 8), so d
// only has to be a multiple of 16: at d = 112 a shared row is P = 120 bf16
// (240 B, an odd number of 16-byte units, so the 8 rows an ldmatrix reads
// fall on 8 different bank groups), QK^T takes 7 k16 steps and P V 7
// ldmatrix.x4.trans pairs. The float32 body rounds d up to whole lanes
// (DPL) and masks the lanes past d.
#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int FA_WARPS = 4;
constexpr int FA_BM = 16 * FA_WARPS;  // M rows per block
constexpr int FA_BK = 64;             // keys per tile
constexpr int FA_STAGES = 4;          // K/V tiles in the ring
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
__host__ __device__ constexpr int fa_smem_bytes() {
  return (FA_BM + 2 * FA_STAGES * FA_BK) * (D + 8) * 2;  // Q, K and V rings
}

template <int D>
__global__ void __launch_bounds__(FA_WARPS * 32)
flash_prefill_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ out, int s_len,
                         int t_len, int hq, int hkv, int causal, int window,
                         int q_offset, int t_valid, float scale_log2) {
  constexpr int P = D + 8;     // bf16 per shared row (ldmatrix conflict-free)
  constexpr int CH = D / 8;    // 16-byte chunks per row
  constexpr int NT = FA_BK / 8;  // key n8 tiles per KV tile
  extern __shared__ __align__(128) unsigned char fa_smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(fa_smem);
  __nv_bfloat16* k_s = q_s + FA_BM * P;  // [FA_STAGES][FA_BK][P]
  __nv_bfloat16* v_s = k_s + FA_STAGES * FA_BK * P;

  const int grp = hq / hkv;
  const int b = blockIdx.z, kvh = blockIdx.y, m0 = blockIdx.x * FA_BM;
  const int m_total = s_len * grp;  // M row m: query row m / grp, head m % grp
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  for (int c = tid; c < FA_BM * CH; c += FA_WARPS * 32) {
    const int r = c / CH, dc = (c % CH) * 8, mm = m0 + r;
    const bool ok = mm < m_total;
    const int s = ok ? mm / grp : 0, h = kvh * grp + (ok ? mm % grp : 0);
    cp_async16(q_s + r * P + dc, q + (((size_t)b * s_len + s) * hq + h) * D + dc, ok);
  }
  cp_async_commit();

  // keys any row of the block can see
  const int last = q_offset + (min(m0 + FA_BM, m_total) - 1) / grp;
  int kv_end = t_valid;
  if (causal) kv_end = min(kv_end, last + 1);
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, q_offset + m0 / grp - window + 1);
  kv_begin = (kv_begin / FA_BK) * FA_BK;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + FA_BK - 1) / FA_BK : 0;

  // K and V of tile i into stage i % FA_STAGES (zero past the live keys)
  auto load_tile = [&](int i) {
    const int t0 = kv_begin + i * FA_BK, off = (i % FA_STAGES) * FA_BK * P;
    for (int c = tid; c < FA_BK * CH; c += FA_WARPS * 32) {
      const int j = c / CH, dc = (c % CH) * 8, t = t0 + j;
      const bool ok = t < kv_end;
      const size_t src = (((size_t)b * t_len + (ok ? t : 0)) * hkv + kvh) * D + dc;
      cp_async16(k_s + off + j * P + dc, k + src, ok);
      cp_async16(v_s + off + j * P + dc, v + src, ok);
    }
  };
#pragma unroll
  for (int i = 0; i < FA_STAGES - 1; ++i) {
    if (i < n_tiles) load_tile(i);
    cp_async_commit();  // one group per tile, empty past the end
  }

  // this thread's two rows (g and g + 8 of the warp's 16) and the warp's
  // position range
  const int mw = m0 + warp * 16;
  int pos[2];
  bool row_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int mm = mw + (lane >> 2) + 8 * h;
    row_ok[h] = mm < m_total;
    pos[h] = q_offset + (row_ok[h] ? mm : m_total - 1) / grp;
  }
  const bool warp_ok = mw < m_total;
  const int first_pos = q_offset + min(mw, m_total - 1) / grp;
  const int last_pos = q_offset + min(mw + 15, m_total - 1) / grp;

  cp_async_wait<FA_STAGES - 1>();  // Q landed (K/V tiles may be in flight)
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int dk = 0; dk < D / 16; ++dk)
    ldmatrix_x4(qf[dk], q_s + (warp * 16 + (lane & 15)) * P + dk * 16 + (lane >> 4) * 8);

  float o[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
  float m_r[2] = {RT_MASK_VALUE, RT_MASK_VALUE}, l_r[2] = {0.f, 0.f};

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<FA_STAGES - 2>();  // tile i landed (later ones may not)
    __syncthreads();  // everyone's copies; and tile i-1's stage is free
    if (i + FA_STAGES - 1 < n_tiles) load_tile(i + FA_STAGES - 1);
    cp_async_commit();
    const int t0 = kv_begin + i * FA_BK;
    const __nv_bfloat16* kt = k_s + (i % FA_STAGES) * FA_BK * P;
    const __nv_bfloat16* vt = v_s + (i % FA_STAGES) * FA_BK * P;
    // uniform across the warp: does any of its rows see a key of the tile?
    const bool active = warp_ok && (!causal || t0 <= last_pos) &&
                        (window <= 0 || t0 + FA_BK - 1 > first_pos - window);
    if (!active) continue;
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int tn = 0; tn < FA_BK / 16; ++tn) {
#pragma unroll
      for (int dk = 0; dk < D / 16; ++dk) {
        uint32_t kb[4];
        ldmatrix_x4(kb, kt + (tn * 16 + (lane & 7) + ((lane >> 4) << 3)) * P +
                            dk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16_16816(s[2 * tn], qf[dk], kb[0], kb[1]);
        mma_bf16_16816(s[2 * tn + 1], qf[dk], kb[2], kb[3]);
      }
    }
    // mask, then the online softmax of rows g (e = 0, 1) and g+8 (e = 2, 3)
    float mx[2] = {RT_MASK_VALUE, RT_MASK_VALUE};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, key = t0 + nt * 8 + 2 * (lane & 3) + (e & 1);
        const bool live = row_ok[h] && key < t_valid &&
                          (!causal || key <= pos[h]) &&
                          (window <= 0 || pos[h] - key < window);
        s[nt][e] = live ? s[nt][e] * scale_log2 : RT_MASK_VALUE;
        mx[h] = fmaxf(mx[h], s[nt][e]);
      }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_r[h], mx[h]);
      corr[h] = exp2f(m_r[h] - m_new);
      m_r[h] = m_new;
      l_r[h] *= corr[h];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float p = s[nt][e] > RT_MASK_VALUE ? exp2f(s[nt][e] - m_r[h]) : 0.f;
        s[nt][e] = p;
        l_r[h] += p;  // this lane's part of the row sum
      }
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      o[dn][0] *= corr[0];
      o[dn][1] *= corr[0];
      o[dn][2] *= corr[1];
      o[dn][3] *= corr[1];
    }
    // P as the A operand of P V: keys 16kt..16kt+15 are n8 tiles 2kt, 2kt+1
#pragma unroll
    for (int kt2 = 0; kt2 < FA_BK / 16; ++kt2) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kt2][0], s[2 * kt2][1]);
      pa[1] = pack_bf16(s[2 * kt2][2], s[2 * kt2][3]);
      pa[2] = pack_bf16(s[2 * kt2 + 1][0], s[2 * kt2 + 1][1]);
      pa[3] = pack_bf16(s[2 * kt2 + 1][2], s[2 * kt2 + 1][3]);
#pragma unroll
      for (int dn2 = 0; dn2 < D / 16; ++dn2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vt + (kt2 * 16 + (lane & 15)) * P + dn2 * 16 + (lane >> 4) * 8);
        mma_bf16_16816(o[2 * dn2], pa, vb[0], vb[1]);
        mma_bf16_16816(o[2 * dn2 + 1], pa, vb[2], vb[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_r[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (!row_ok[h]) continue;
    const int mm = mw + (lane >> 2) + 8 * h;
    const int s = mm / grp, hh = kvh * grp + mm % grp;
    __nv_bfloat16* op = out + (((size_t)b * s_len + s) * hq + hh) * D;
    if (l > 0.f) {
      const float inv = 1.f / l;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn)
        *reinterpret_cast<__nv_bfloat162*>(op + dn * 8 + 2 * (lane & 3)) =
            __floats2bfloat162_rn(o[dn][2 * h] * inv, o[dn][2 * h + 1] * inv);
    } else {
      // no live key (l is the same on the 4 lanes of the row): the mean of
      // v over all T slots
      for (int dn = 0; dn < D / 8; ++dn) {
        const int dd = dn * 8 + 2 * (lane & 3);
        float s0 = 0.f, s1 = 0.f;
        for (int t = 0; t < t_len; ++t) {
          const __nv_bfloat16* vp = v + (((size_t)b * t_len + t) * hkv + kvh) * D + dd;
          s0 += __bfloat162float(vp[0]);
          s1 += __bfloat162float(vp[1]);
        }
        *reinterpret_cast<__nv_bfloat162*>(op + dd) =
            __floats2bfloat162_rn(s0 / (float)t_len, s1 / (float)t_len);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int BQ = 16;       // query rows per block
constexpr int BK = 32;       // keys per tile (one per lane)
constexpr int WARPS = 4;
constexpr int RPW = BQ / WARPS;  // query rows per warp

template <int D>
__global__ void __launch_bounds__(WARPS * 32)
flash_prefill_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ out,
                         int s_len, int t_len, int hq, int hkv, int causal,
                         int window, int q_offset, int t_valid, float scale) {
  constexpr int DPL = (D + 31) / 32;  // output dims per lane
  __shared__ float q_s[BQ][D];
  __shared__ float k_s[BK][D + 1];
  __shared__ float v_s[BK][D];

  const int b = blockIdx.z, h = blockIdx.y, s0 = blockIdx.x * BQ;
  const int kvh = h / (hq / hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  for (int i = tid; i < BQ * D; i += WARPS * 32) {
    const int r = i / D, dd = i % D, s = s0 + r;
    q_s[r][dd] = s < s_len ? q[(((size_t)b * s_len + s) * hq + h) * D + dd] : 0.f;
  }

  const int last = min(s0 + BQ, s_len) - 1 + q_offset;  // last row position
  int kv_end = t_valid;
  if (causal) kv_end = min(kv_end, last + 1);
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, q_offset + s0 - window + 1);
  kv_begin = (kv_begin / BK) * BK;

  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = RT_MASK_VALUE;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  for (int t0 = kv_begin; t0 < kv_end; t0 += BK) {
    __syncthreads();  // previous tile fully consumed (and q_s visible)
    for (int i = tid; i < BK * D; i += WARPS * 32) {
      const int j = i / D, dd = i % D, t = t0 + j;
      const size_t off = (((size_t)b * t_len + t) * hkv + kvh) * D + dd;
      k_s[j][dd] = t < t_len ? k[off] : 0.f;
      v_s[j][dd] = t < t_len ? v[off] : 0.f;
    }
    __syncthreads();
    const int t = t0 + lane;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int row = warp * RPW + r;
      if (s0 + row >= s_len) continue;  // uniform across the warp
      const int pos = q_offset + s0 + row;
      float dot = 0.f;
#pragma unroll 16
      for (int dd = 0; dd < D; ++dd) dot = fmaf(q_s[row][dd], k_s[lane][dd], dot);
      const float sc = dot * scale;
      const bool live = t < t_valid && (!causal || t <= pos) &&
                        (window <= 0 || pos - t < window);
      const float m_new = fmaxf(m[r], warp_max(live ? sc : RT_MASK_VALUE));
      const float p = live ? expf(sc - m_new) : 0.f;
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p);
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= corr;
#pragma unroll 8
      for (int j = 0; j < BK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int dd = lane + 32 * i;
          if (dd < D) acc[r][i] = fmaf(pj, v_s[j][dd], acc[r][i]);
        }
      }
      m[r] = m_new;
    }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int s = s0 + warp * RPW + r;
    if (s >= s_len) continue;
    float* o = out + (((size_t)b * s_len + s) * hq + h) * D;
    if (l[r] > 0.f) {
      const float inv = 1.f / l[r];
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int dd = lane + 32 * i;
        if (dd < D) o[dd] = acc[r][i] * inv;
      }
    } else {
      // no live key (l is warp-uniform): the mean of v over all T slots
      for (int i = 0; i < DPL; ++i) {
        const int dd = lane + 32 * i;
        if (dd >= D) continue;
        float sum = 0.f;
        for (int t = 0; t < t_len; ++t)
          sum += v[(((size_t)b * t_len + t) * hkv + kvh) * D + dd];
        o[dd] = sum / (float)t_len;
      }
    }
  }
}

struct Args {
  const void *q, *k, *v;
  void* out;
  int b, s_len, t_len, hq, hkv, causal, window, q_offset, t_valid;
  float scale;
};

template <int D>
int launch(const Args& a, bool bf16, cudaStream_t stream) {
  if (bf16) {
    constexpr int bytes = fa_smem_bytes<D>();
    if (bytes > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          flash_prefill_mma_kernel<D>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    const int m_total = a.s_len * (a.hq / a.hkv);
    const dim3 grid((m_total + FA_BM - 1) / FA_BM, a.hkv, a.b);
    flash_prefill_mma_kernel<D><<<grid, FA_WARPS * 32, bytes, stream>>>(
        static_cast<const __nv_bfloat16*>(a.q),
        static_cast<const __nv_bfloat16*>(a.k),
        static_cast<const __nv_bfloat16*>(a.v),
        static_cast<__nv_bfloat16*>(a.out), a.s_len, a.t_len, a.hq, a.hkv,
        a.causal, a.window, a.q_offset, a.t_valid, a.scale * LOG2E);
  } else {
    const dim3 grid((a.s_len + BQ - 1) / BQ, a.hq, a.b);
    flash_prefill_fma_kernel<D><<<grid, WARPS * 32, 0, stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<float*>(a.out), a.s_len,
        a.t_len, a.hq, a.hkv, a.causal, a.window, a.q_offset, a.t_valid,
        a.scale);
  }
  return 0;
}

}  // namespace

// q: (b, s_len, hq, d); k, v: (b, t_len, hkv, d); out: (b, s_len, hq, d),
// all contiguous (bf16: 16-byte aligned). window <= 0 means no window.
// Returns the CUDA error code.
extern "C" int rt_flash_prefill(const void* q, const void* k, const void* v,
                                void* out, int b, int s_len, int t_len, int hq,
                                int hkv, int d, int causal, int window,
                                int q_offset, int t_valid, float scale,
                                int dtype, void* stream) {
  if (b > 0 && s_len > 0) {
    const Args a{q, k, v, out, b, s_len, t_len, hq, hkv, causal, window,
                 q_offset, t_valid, scale};
    const bool bf16 = dtype == RT_DTYPE_BF16;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    int err;
    switch (d) {
      case 16: err = launch<16>(a, bf16, s); break;
      case 32: err = launch<32>(a, bf16, s); break;
      case 64: err = launch<64>(a, bf16, s); break;
      case 112: err = launch<112>(a, bf16, s); break;
      case 128: err = launch<128>(a, bf16, s); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
    if (err) return err;
  }
  return static_cast<int>(cudaGetLastError());
}
