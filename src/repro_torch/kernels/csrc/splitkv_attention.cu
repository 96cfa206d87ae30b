// Split-KV (flash-decoding) one-token GQA attention, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/splitkv_attention.py::splitkv_attention_pallas.
//
// Computes out (B, Hq, d) = softmax(q k^T / sqrt(d)) v over the valid prefix
// [0, lengths[b]) of a (B, T, Hkv, d) cache, and optionally the (B, Hq)
// float32 log-sum-exp. The group = Hq / Hkv query heads that share a kv head
// are scored together. float32 scores and softmax.
//
// What bounds it on an H100: each decode step reads every live K and V row
// once and does ~4 * group operations per cached element: about 4 FLOP per
// byte at group 2, so cache bytes bound it. With 8 sequences and 8 kv heads
// there are only 64 (sequence, kv head) streams, far fewer than the card
// needs to keep its memory busy.
//
// What the design does about it: the T axis is split. Pass 1 runs one warp
// per 64-key part of the live prefix (four warps to a block, grid over
// parts x kv heads x batch); each lane scores one key for all group heads
// with 16-byte K row loads, the warp forms a partial (m, l, acc) with an
// online softmax and writes it to a float32 workspace. Parts past
// lengths[b] (read on the device) exit at once, so only live bytes move.
// Pass 2 combines the parts of each (batch, q head) with LSE weights and
// writes the output and, if asked, the LSE. A sequence with lengths[b] <= 0
// has no live key: as in the dense form (every score -1e30, softmax uniform
// over T) its output is the mean of v over all T slots, and its LSE is
// -1e30 (log-sum-exp of T equal values -1e30 rounds back to -1e30 in
// float32).
#include "common.cuh"

namespace {

constexpr int PART = 64;  // keys per warp part
constexpr int WARPS = 4;  // parts per block
constexpr int MAXG = 8;   // largest query group

template <typename T, int D>
__global__ void __launch_bounds__(WARPS * 32)
splitkv_parts_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ lengths,
                     float* __restrict__ part_acc, float* __restrict__ part_ml,
                     int t_len, int hq, int hkv, int n_parts, float scale) {
  constexpr int DPL = (D + 31) / 32;
  const int group = hq / hkv;
  __shared__ float q_s[MAXG][D];
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int i = tid; i < group * D; i += WARPS * 32) {
    const int gh = i / D, dd = i % D;
    q_s[gh][dd] = to_f32(q[((size_t)b * hq + kvh * group + gh) * D + dd]);
  }
  __syncthreads();

  const int len = min(max(lengths[b], 0), t_len);
  const int part = blockIdx.x * WARPS + warp;
  const int start = part * PART;
  if (start >= len) return;
  const int end = min(start + PART, len);

  float m[MAXG], l[MAXG], acc[MAXG][DPL];
#pragma unroll
  for (int gh = 0; gh < MAXG; ++gh) {
    m[gh] = RT_MASK_VALUE;
    l[gh] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[gh][i] = 0.f;
  }

  const size_t row_stride = (size_t)hkv * D;
  const T* k_base = k + ((size_t)b * t_len * hkv + kvh) * D;
  const T* v_base = v + ((size_t)b * t_len * hkv + kvh) * D;
  for (int t0 = start; t0 < end; t0 += 32) {
    const int t = t0 + lane;
    const bool live = t < end;
    float s[MAXG];
#pragma unroll
    for (int gh = 0; gh < MAXG; ++gh) s[gh] = 0.f;
    if (live) {
      const T* kr = k_base + (size_t)t * row_stride;
#pragma unroll
      for (int c = 0; c < D; c += 8) {
        float kv8[8];
        load8(kr + c, kv8);
#pragma unroll
        for (int gh = 0; gh < MAXG; ++gh) {
          if (gh < group) {
#pragma unroll
            for (int j = 0; j < 8; ++j) s[gh] = fmaf(kv8[j], q_s[gh][c + j], s[gh]);
          }
        }
      }
    }
    float p[MAXG];
#pragma unroll
    for (int gh = 0; gh < MAXG; ++gh) {
      if (gh >= group) continue;
      const float sc = s[gh] * scale;
      const float m_new = fmaxf(m[gh], warp_max(live ? sc : RT_MASK_VALUE));
      p[gh] = live ? expf(sc - m_new) : 0.f;
      const float corr = expf(m[gh] - m_new);
      l[gh] = l[gh] * corr + warp_sum(p[gh]);
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[gh][i] *= corr;
      m[gh] = m_new;
    }
    const int n_live = min(32, end - t0);
    for (int j = 0; j < n_live; ++j) {
      const T* vr = v_base + (size_t)(t0 + j) * row_stride;
      float vv[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int dd = lane + 32 * i;
        vv[i] = dd < D ? to_f32(vr[dd]) : 0.f;
      }
#pragma unroll
      for (int gh = 0; gh < MAXG; ++gh) {
        if (gh >= group) continue;
        const float pj = __shfl_sync(0xffffffffu, p[gh], j);
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[gh][i] = fmaf(pj, vv[i], acc[gh][i]);
      }
    }
  }

  const size_t base = ((size_t)b * hkv + kvh) * n_parts + part;
#pragma unroll
  for (int gh = 0; gh < MAXG; ++gh) {
    if (gh >= group) continue;
    float* pa = part_acc + (base * group + gh) * D;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int dd = lane + 32 * i;
      if (dd < D) pa[dd] = acc[gh][i];
    }
    if (lane == 0) {
      part_ml[(base * group + gh) * 2] = m[gh];
      part_ml[(base * group + gh) * 2 + 1] = l[gh];
    }
  }
}

template <typename T>
__global__ void splitkv_combine_kernel(const float* __restrict__ part_acc,
                                       const float* __restrict__ part_ml,
                                       const int* __restrict__ lengths,
                                       const T* __restrict__ v,
                                       T* __restrict__ out,
                                       float* __restrict__ lse, int t_len,
                                       int hq, int hkv, int d, int n_parts) {
  const int b = blockIdx.y, h = blockIdx.x;
  const int group = hq / hkv, kvh = h / group, gh = h % group;
  const int len = min(max(lengths[b], 0), t_len);
  if (len == 0) {
    for (int dd = threadIdx.x; dd < d; dd += blockDim.x) {
      float sum = 0.f;
      for (int t = 0; t < t_len; ++t)
        sum += to_f32(v[(((size_t)b * t_len + t) * hkv + kvh) * d + dd]);
      out[((size_t)b * hq + h) * d + dd] = from_f32<T>(sum / (float)t_len);
    }
    if (lse != nullptr && threadIdx.x == 0)
      lse[(size_t)b * hq + h] = RT_MASK_VALUE;
    return;
  }
  const int used = (len + PART - 1) / PART;
  const size_t base = ((size_t)b * hkv + kvh) * n_parts;
  float m_all = RT_MASK_VALUE;
  for (int p = 0; p < used; ++p)
    m_all = fmaxf(m_all, part_ml[((base + p) * group + gh) * 2]);
  float l_all = 0.f;
  for (int p = 0; p < used; ++p) {
    const size_t i = ((base + p) * group + gh) * 2;
    l_all += part_ml[i + 1] * expf(part_ml[i] - m_all);
  }
  for (int dd = threadIdx.x; dd < d; dd += blockDim.x) {
    float a = 0.f;
    for (int p = 0; p < used; ++p) {
      const size_t i = (base + p) * group + gh;
      a += part_acc[i * d + dd] * expf(part_ml[i * 2] - m_all);
    }
    out[((size_t)b * hq + h) * d + dd] = from_f32<T>(a / l_all);
  }
  if (lse != nullptr && threadIdx.x == 0)
    lse[(size_t)b * hq + h] = m_all + logf(l_all);
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, const int* lengths,
            float* part_acc, float* part_ml, void* out, float* lse, int b,
            int t_len, int hq, int hkv, int n_parts, float scale,
            cudaStream_t stream) {
  const dim3 grid1((n_parts + WARPS - 1) / WARPS, hkv, b);
  splitkv_parts_kernel<T, D><<<grid1, WARPS * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, part_acc, part_ml, t_len, hq, hkv,
      n_parts, scale);
  splitkv_combine_kernel<T><<<dim3(hq, b), 128, 0, stream>>>(
      part_acc, part_ml, lengths, static_cast<const T*>(v),
      static_cast<T*>(out), lse, t_len, hq, hkv, D, n_parts);
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v,
             const int* lengths, float* part_acc, float* part_ml, void* out,
             float* lse, int b, int t_len, int hq, int hkv, int n_parts,
             float scale, cudaStream_t stream) {
  switch (d) {
    case 16: launch<T, 16>(q, k, v, lengths, part_acc, part_ml, out, lse, b, t_len, hq, hkv, n_parts, scale, stream); break;
    case 32: launch<T, 32>(q, k, v, lengths, part_acc, part_ml, out, lse, b, t_len, hq, hkv, n_parts, scale, stream); break;
    case 64: launch<T, 64>(q, k, v, lengths, part_acc, part_ml, out, lse, b, t_len, hq, hkv, n_parts, scale, stream); break;
    case 128: launch<T, 128>(q, k, v, lengths, part_acc, part_ml, out, lse, b, t_len, hq, hkv, n_parts, scale, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

// q: (b, hq, d); k, v: (b, t_len, hkv, d); lengths: (b,) int32; out:
// (b, hq, d); lse: (b, hq) float32 or NULL; part_acc: (b, hkv, n_parts,
// group, d) and part_ml: (b, hkv, n_parts, group, 2) float32 workspace with
// n_parts = ceil(t_len / 64). Returns the CUDA error code.
extern "C" int rt_splitkv_attention(const void* q, const void* k,
                                    const void* v, const int* lengths,
                                    float* part_acc, float* part_ml, void* out,
                                    float* lse, int b, int t_len, int hq,
                                    int hkv, int d, int n_parts, float scale,
                                    int dtype, void* stream) {
  if (b > 0 && hq > 0 && n_parts > 0) {
    if (hq % hkv != 0 || hq / hkv > MAXG) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int err = dtype == RT_DTYPE_BF16
        ? launch_d<__nv_bfloat16>(d, q, k, v, lengths, part_acc, part_ml, out, lse, b, t_len, hq, hkv, n_parts, scale, s)
        : launch_d<float>(d, q, k, v, lengths, part_acc, part_ml, out, lse, b, t_len, hq, hkv, n_parts, scale, s);
    if (err) return err;
  }
  return static_cast<int>(cudaGetLastError());
}
