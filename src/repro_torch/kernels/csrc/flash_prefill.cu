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
// whole live cache prefix of its kv head once per q head, and does
// 4 * S * t_valid * d operations per head: with S = 64 that is about 64
// operations per cache byte, below the card's ~295, so cache bytes bound it.
//
// What the design does about it: one block per (q tile of 16 rows, q head,
// batch) stages 32-key tiles of K and V in shared memory (K padded against
// bank conflicts) and loops only over the tiles that hold live keys for its
// rows: the loop ends at min(t_valid, last row's position + 1) and starts at
// the window's first key. Each warp owns 4 query rows; a lane scores one
// key of the tile, the warp reduces max and sum with shuffles, and each lane
// accumulates d/32 output dimensions in registers. No tensor cores yet.
#include "common.cuh"

namespace {

constexpr int BQ = 16;       // query rows per block
constexpr int BK = 32;       // keys per tile (one per lane)
constexpr int WARPS = 4;
constexpr int RPW = BQ / WARPS;  // query rows per warp

template <typename T, int D>
__global__ void __launch_bounds__(WARPS * 32)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int s_len,
                     int t_len, int hq, int hkv, int causal, int window,
                     int q_offset, int t_valid, float scale) {
  constexpr int DPL = (D + 31) / 32;  // output dims per lane
  __shared__ float q_s[BQ][D];
  __shared__ float k_s[BK][D + 1];
  __shared__ float v_s[BK][D];

  const int b = blockIdx.z, h = blockIdx.y, s0 = blockIdx.x * BQ;
  const int kvh = h / (hq / hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  for (int i = tid; i < BQ * D; i += WARPS * 32) {
    const int r = i / D, dd = i % D, s = s0 + r;
    q_s[r][dd] = s < s_len ? to_f32(q[(((size_t)b * s_len + s) * hq + h) * D + dd]) : 0.f;
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
      k_s[j][dd] = t < t_len ? to_f32(k[off]) : 0.f;
      v_s[j][dd] = t < t_len ? to_f32(v[off]) : 0.f;
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
    T* o = out + (((size_t)b * s_len + s) * hq + h) * D;
    if (l[r] > 0.f) {
      const float inv = 1.f / l[r];
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int dd = lane + 32 * i;
        if (dd < D) o[dd] = from_f32<T>(acc[r][i] * inv);
      }
    } else {
      // no live key (l is warp-uniform): the mean of v over all T slots
      for (int i = 0; i < DPL; ++i) {
        const int dd = lane + 32 * i;
        if (dd >= D) continue;
        float sum = 0.f;
        for (int t = 0; t < t_len; ++t)
          sum += to_f32(v[(((size_t)b * t_len + t) * hkv + kvh) * D + dd]);
        o[dd] = from_f32<T>(sum / (float)t_len);
      }
    }
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, void* out, int b,
            int s_len, int t_len, int hq, int hkv, int causal, int window,
            int q_offset, int t_valid, float scale, cudaStream_t stream) {
  const dim3 grid((s_len + BQ - 1) / BQ, hq, b);
  flash_prefill_kernel<T, D><<<grid, WARPS * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), s_len, t_len, hq, hkv,
      causal, window, q_offset, t_valid, scale);
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v, void* out,
             int b, int s_len, int t_len, int hq, int hkv, int causal,
             int window, int q_offset, int t_valid, float scale,
             cudaStream_t stream) {
  switch (d) {
    case 16: launch<T, 16>(q, k, v, out, b, s_len, t_len, hq, hkv, causal, window, q_offset, t_valid, scale, stream); break;
    case 32: launch<T, 32>(q, k, v, out, b, s_len, t_len, hq, hkv, causal, window, q_offset, t_valid, scale, stream); break;
    case 64: launch<T, 64>(q, k, v, out, b, s_len, t_len, hq, hkv, causal, window, q_offset, t_valid, scale, stream); break;
    case 128: launch<T, 128>(q, k, v, out, b, s_len, t_len, hq, hkv, causal, window, q_offset, t_valid, scale, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

// q: (b, s_len, hq, d); k, v: (b, t_len, hkv, d); out: (b, s_len, hq, d),
// all contiguous. window <= 0 means no window. Returns the CUDA error code.
extern "C" int rt_flash_prefill(const void* q, const void* k, const void* v,
                                void* out, int b, int s_len, int t_len, int hq,
                                int hkv, int d, int causal, int window,
                                int q_offset, int t_valid, float scale,
                                int dtype, void* stream) {
  if (b > 0 && s_len > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int err = dtype == RT_DTYPE_BF16
        ? launch_d<__nv_bfloat16>(d, q, k, v, out, b, s_len, t_len, hq, hkv, causal, window, q_offset, t_valid, scale, s)
        : launch_d<float>(d, q, k, v, out, b, s_len, t_len, hq, hkv, causal, window, q_offset, t_valid, scale, s);
    if (err) return err;
  }
  return static_cast<int>(cudaGetLastError());
}
