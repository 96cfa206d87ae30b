// Split-KV (flash-decoding) one-token GQA attention, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/splitkv_attention.py::splitkv_attention_pallas.
//
// Computes out (B, Hq, d) = softmax(q k^T / sqrt(d)) v over the valid prefix
// [0, lengths[b]) of a (B, T, Hkv, d) cache, and optionally the (B, Hq)
// float32 log-sum-exp. The group = Hq / Hkv query heads that share a kv head
// are scored together. float32 scores, softmax and accumulation.
//
// What bounds it on an H100: a decode step reads every live K and V row once
// and does about `group` FLOP per byte read (2 at granite-moe's group of 2,
// 8 at Kimi K2's). The CUDA cores' float32 FMA rate is about 20 FLOP per
// byte of the card's bandwidth, so bytes bound the operator: 0.0014 ms for
// the main path's 4.8 MB of live K and V (8 sequences, 2,341 live keys) at
// 3.35 TB/s. Tensor cores would pad 2 live rows to 16 and buy nothing, so
// both dtypes run on the CUDA cores. Measured (chip_smoke.py phase 3, NVIDIA
// H100 80GB HBM3, 700 W; PERF.md), latency and not bytes sets the
// time at that size: the earlier design (a warp per 64-key part, a serial V
// loop of dependent loads and shuffles, a second launch for the combine)
// took 0.051 ms; this one takes 0.015 ms, of which 0.006 ms is the timer's
// floor for any one-kernel call, and it does not move with the split size
// (32 to 128 keys); the same call with every prefix cut to one split (no
// combine) takes 0.011 ms. What is left is a chain of dependent steps:
// lengths, K/V copies, scores, P.V, the partial's write and fence, the
// arrival counter and the combine's reads.
//
// What the design does about it:
// * One block per (split, kv head, sequence); a split is a fixed range of
//   `split` keys chosen by the host (splitkv_attention.plan_splits) so that
//   the whole cache makes several waves of blocks on the card. Blocks whose
//   split starts at or past lengths[b] (read on the device, int32 or int64)
//   exit at once.
// * A live block issues every 16-byte cp.async copy of its K tile, then of
//   its V tile, into shared memory up front (neighbouring threads copy
//   neighbouring bytes of a row), so the whole live prefix is requested in
//   one wave; it scores K while V lands.
// * Scores: a team of d/8 (bf16) or d/4 (f32) lanes holds q in registers,
//   reads one key's row from shared memory 16 bytes a lane, and reduces the
//   group's dot products with shfl_xor inside the team. Softmax max and sum
//   per head are taken once per split, one warp per head.
// * P.V: each thread owns a (head, 8-column) slice of the accumulator and a
//   stride of the split's keys, runs over them from shared memory with the
//   loop unrolled, and the strides' partials are summed through shared
//   memory.
// * One launch: a sequence whose live prefix fits one split is written
//   directly. Otherwise each block writes its partial (m, l, acc), and the
//   last block of a (sequence, kv head) to arrive (__threadfence + atomicAdd
//   on a per-(b, kvh) counter, which it resets to 0) combines them with
//   weights exp(m_p - m_all), computed once per part and head.
// * A sequence with lengths[b] <= 0 has no live key: as in the dense form
//   (every score -1e30, softmax uniform over T) its output is the mean of v
//   over all T slots, and its LSE is -1e30 (log-sum-exp of T equal values
//   -1e30 rounds back to -1e30 in float32). Split 0's block writes it.
// * Templated on the group (1, 2, 4, 8) and the head dim (16, 32, 64, 112,
//   128), so every register array is sized exactly.
#include "common.cuh"

namespace {

constexpr int NT = 128;                   // threads per block
constexpr int SPLIT_CAP = 256;            // most keys per split
constexpr int KV_TILE_BYTES = 64 * 1024;  // K + V tiles of one split, at most
constexpr int PCH = 32;                   // parts per combine step

__host__ __device__ constexpr int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p *= 2;
  return p;
}

// The longest split a variant takes: its K and V tiles fit KV_TILE_BYTES
// (kernels/splitkv_attention.py::max_split computes the same).
template <typename T, int D>
constexpr int max_split() {
  const int s = KV_TILE_BYTES / (2 * D * static_cast<int>(sizeof(T))) / 16 * 16;
  return s < SPLIT_CAP ? s : SPLIT_CAP;
}

template <typename T, int G, int D>
struct Cfg {
  static constexpr int VEC = 16 / sizeof(T);               // elements per 16 B
  static constexpr int CHUNKS = D / VEC;                   // 16 B chunks per row
  static constexpr int TEAM = pow2_at_least(CHUNKS);       // lanes per key
  static constexpr int TEAMS = NT / TEAM;                  // keys scored at once
  static constexpr int SL = D / 8;                         // 8-column slices
  static constexpr int SLP = pow2_at_least(SL);
  static constexpr int KS = NT / (G * SLP);                // key strides of P.V
  static constexpr int EPT = (G * D + NT - 1) / NT;        // combine elements
  static_assert(TEAM <= 32 && KS >= 1, "variant does not fit a block");
};

template <typename T, int G, int D>
size_t smem_bytes(int split) {
  // K and V tiles; q, p, the P.V partials, the combine weights, (m, l); flag
  return 2 * static_cast<size_t>(split) * D * sizeof(T) +
         sizeof(float) * (G * D + G * split + NT * 8 + G * PCH + 2 * G) + 16;
}

__device__ __forceinline__ void load16(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* o) {
  load8(p, o);
}

// The mean of v over all T slots for every head of a (sequence, kv head)
// with no live key, and LSE -1e30.
template <typename T, int G, int D>
__device__ void no_live_key(const T* __restrict__ v, T* out_bh, float* lse_bh,
                            int b, int kvh, int t_len, int hkv) {
  for (int col = threadIdx.x; col < D; col += NT) {
    float sum = 0.f;
    for (int t = 0; t < t_len; ++t)
      sum += to_f32(v[(((size_t)b * t_len + t) * hkv + kvh) * D + col]);
    const T o = from_f32<T>(sum / (float)t_len);
#pragma unroll
    for (int gh = 0; gh < G; ++gh) out_bh[gh * D + col] = o;
  }
  if (lse_bh != nullptr && threadIdx.x < G) lse_bh[threadIdx.x] = RT_MASK_VALUE;
}

template <typename T, int G, int D>
__global__ void __launch_bounds__(NT, 4)
splitkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const void* __restrict__ lengths,
               int len64, float* __restrict__ part_acc,
               float* __restrict__ part_ml, int* __restrict__ counters,
               T* __restrict__ out, float* __restrict__ lse, int t_len, int hkv,
               int split, int n_splits, float scale) {
  using C = Cfg<T, G, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int sp = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long raw = len64 ? static_cast<const long long*>(lengths)[b]
                              : static_cast<const int*>(lengths)[b];
  const int len = static_cast<int>(min(max(raw, 0LL), (long long)t_len));
  const size_t bh = (size_t)b * hkv + kvh;
  T* out_bh = out + bh * G * D;
  float* lse_bh = lse != nullptr ? lse + bh * G : nullptr;
  if (len == 0) {
    if (sp == 0) no_live_key<T, G, D>(v, out_bh, lse_bh, b, kvh, t_len, hkv);
    return;
  }
  const int start = sp * split;
  if (start >= len) return;
  const int n = min(split, len - start);
  const int n_live = (len + split - 1) / split;

  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + (size_t)split * D;
  float* q_s = reinterpret_cast<float*>(v_s + (size_t)split * D);
  float* p_s = q_s + G * D;         // (G, split) scores, then probabilities
  float* red_s = p_s + G * split;   // (NT, 8) P.V partials
  float* w_s = red_s + NT * 8;      // (G, PCH) combine weights
  float* ml_s = w_s + G * PCH;      // m[G], l[G]
  int* last_s = reinterpret_cast<int*>(ml_s + 2 * G);

  // every copy of the split's K tile, then of its V tile, in flight at once
  const size_t row = (size_t)hkv * D;
  const size_t base = ((size_t)b * t_len + start) * row + (size_t)kvh * D;
  for (int i = tid; i < n * C::CHUNKS; i += NT) {
    const int r = i / C::CHUNKS, c = i % C::CHUNKS;
    cp_async16(k_s + r * D + c * C::VEC, k + base + r * row + c * C::VEC, true);
  }
  cp_async_commit();
  for (int i = tid; i < n * C::CHUNKS; i += NT) {
    const int r = i / C::CHUNKS, c = i % C::CHUNKS;
    cp_async16(v_s + r * D + c * C::VEC, v + base + r * row + c * C::VEC, true);
  }
  cp_async_commit();
  for (int i = tid; i < G * D; i += NT) q_s[i] = to_f32(q[bh * G * D + i]);
  cp_async_wait<1>();
  __syncthreads();

  // scores: a team of lanes per key, 16 bytes of the row each
  {
    const int team = tid / C::TEAM, tl = tid % C::TEAM;
    const bool lane_live = tl < C::CHUNKS;
    float qr[G][C::VEC];
#pragma unroll
    for (int gh = 0; gh < G; ++gh)
#pragma unroll
      for (int e = 0; e < C::VEC; ++e)
        qr[gh][e] = lane_live ? q_s[gh * D + tl * C::VEC + e] : 0.f;
    for (int j0 = 0; j0 < n; j0 += C::TEAMS) {
      const int j = j0 + team;
      float kf[C::VEC];
      if (lane_live && j < n) {
        load16(k_s + j * D + tl * C::VEC, kf);
      } else {
#pragma unroll
        for (int e = 0; e < C::VEC; ++e) kf[e] = 0.f;
      }
      float s[G];
#pragma unroll
      for (int gh = 0; gh < G; ++gh) {
        s[gh] = 0.f;
#pragma unroll
        for (int e = 0; e < C::VEC; ++e) s[gh] = fmaf(qr[gh][e], kf[e], s[gh]);
      }
#pragma unroll
      for (int o = C::TEAM / 2; o > 0; o >>= 1)
#pragma unroll
        for (int gh = 0; gh < G; ++gh)
          s[gh] += __shfl_xor_sync(0xffffffffu, s[gh], o);
      if (j < n) {
#pragma unroll
        for (int gh = 0; gh < G; ++gh)
          if (gh % C::TEAM == tl) p_s[gh * split + j] = s[gh] * scale;
      }
    }
  }
  __syncthreads();

  // softmax statistics of the split, one warp per head
  for (int gh = warp; gh < G; gh += NT / 32) {
    float* ps = p_s + gh * split;
    float m = RT_MASK_VALUE;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, ps[j]);
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = expf(ps[j] - m);
      ps[j] = p;
      l += p;
    }
    l = warp_sum(l);
    if (lane == 0) {
      ml_s[gh] = m;
      ml_s[G + gh] = l;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // P.V: a (head, 8-column slice) per thread over a stride of the keys
  {
    const int slice = tid % C::SLP, gh = (tid / C::SLP) % G;
    const int ks = tid / (C::SLP * G);
    float acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.f;
    if (slice < C::SL) {
      const float* ps = p_s + gh * split;
      const T* vs = v_s + slice * 8;
#pragma unroll 4
      for (int j = ks; j < n; j += C::KS) {
        float vf[8];
        load8(vs + j * D, vf);
        const float p = ps[j];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = fmaf(p, vf[i], acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) red_s[tid * 8 + i] = acc[i];
  }
  __syncthreads();

  // the split's accumulator, element e = (head, column)
  float a[C::EPT];
#pragma unroll
  for (int x = 0; x < C::EPT; ++x) {
    const int e = tid + x * NT;
    a[x] = 0.f;
    if (e < G * D) {
      const int gh = e / D, col = e % D;
      const int idx = (gh * C::SLP + col / 8) * 8 + col % 8;
#pragma unroll
      for (int s = 0; s < C::KS; ++s) a[x] += red_s[s * G * C::SLP * 8 + idx];
    }
  }

  if (n_live == 1) {  // the whole live prefix is this split: final output
#pragma unroll
    for (int x = 0; x < C::EPT; ++x) {
      const int e = tid + x * NT;
      if (e < G * D) out_bh[e] = from_f32<T>(a[x] / ml_s[G + e / D]);
    }
    if (lse_bh != nullptr && tid < G)
      lse_bh[tid] = ml_s[tid] + logf(ml_s[G + tid]);
    return;
  }

  float* pa0 = part_acc + bh * n_splits * G * D;
  float* pml0 = part_ml + bh * n_splits * G * 2;
#pragma unroll
  for (int x = 0; x < C::EPT; ++x) {
    const int e = tid + x * NT;
    if (e < G * D) pa0[(size_t)sp * G * D + e] = a[x];
  }
  if (tid < G) {
    pml0[(sp * G + tid) * 2] = ml_s[tid];
    pml0[(sp * G + tid) * 2 + 1] = ml_s[G + tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) *last_s = atomicAdd(counters + bh, 1) == n_live - 1;
  __syncthreads();
  if (!*last_s) return;
  __threadfence();

  // last block of this (sequence, kv head): combine the n_live partials
  for (int gh = warp; gh < G; gh += NT / 32) {
    float m = RT_MASK_VALUE;
    for (int p = lane; p < n_live; p += 32)
      m = fmaxf(m, __ldcg(pml0 + (p * G + gh) * 2));
    m = warp_max(m);
    if (lane == 0) ml_s[gh] = m;
  }
  __syncthreads();
#pragma unroll
  for (int x = 0; x < C::EPT; ++x) a[x] = 0.f;
  float l_all = 0.f;
  for (int p0 = 0; p0 < n_live; p0 += PCH) {
    const int np = min(PCH, n_live - p0);
    for (int i = tid; i < G * np; i += NT) {
      const int gh = i / np, pp = i % np;
      w_s[gh * PCH + pp] =
          expf(__ldcg(pml0 + ((p0 + pp) * G + gh) * 2) - ml_s[gh]);
    }
    __syncthreads();
    if (tid < G)
      for (int pp = 0; pp < np; ++pp)
        l_all += __ldcg(pml0 + ((p0 + pp) * G + tid) * 2 + 1) * w_s[tid * PCH + pp];
#pragma unroll
    for (int x = 0; x < C::EPT; ++x) {
      const int e = tid + x * NT;
      if (e < G * D) {
        const float* w = w_s + (e / D) * PCH;
        const float* pa = pa0 + (size_t)p0 * G * D + e;
#pragma unroll 4
        for (int pp = 0; pp < np; ++pp)
          a[x] = fmaf(__ldcg(pa + (size_t)pp * G * D), w[pp], a[x]);
      }
    }
    __syncthreads();
  }
  if (tid < G) ml_s[G + tid] = l_all;
  __syncthreads();
#pragma unroll
  for (int x = 0; x < C::EPT; ++x) {
    const int e = tid + x * NT;
    if (e < G * D) out_bh[e] = from_f32<T>(a[x] / ml_s[G + e / D]);
  }
  if (lse_bh != nullptr && tid < G)
    lse_bh[tid] = ml_s[tid] + logf(ml_s[G + tid]);
  if (tid == 0) counters[bh] = 0;
}

struct Args {
  const void *q, *k, *v, *lengths;
  int len64;
  float *part_acc, *part_ml;
  int* counters;
  void* out;
  float* lse;
  int b, t_len, hkv, split, n_splits;
  float scale;
};

template <typename T, int G, int D>
int launch(const Args& a, cudaStream_t stream) {
  if (a.split < 16 || a.split % 16 || a.split > max_split<T, D>())
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_bytes<T, G, D>(a.split);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        splitkv_kernel<T, G, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(a.n_splits, a.hkv, a.b);
  splitkv_kernel<T, G, D><<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.lengths, a.len64, a.part_acc, a.part_ml,
      a.counters, static_cast<T*>(a.out), a.lse, a.t_len, a.hkv, a.split,
      a.n_splits, a.scale);
  return 0;
}

template <typename T, int G>
int launch_d(int d, const Args& a, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, G, 16>(a, s);
    case 32: return launch<T, G, 32>(a, s);
    case 64: return launch<T, G, 64>(a, s);
    case 112: return launch<T, G, 112>(a, s);
    case 128: return launch<T, G, 128>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_g(int group, int d, const Args& a, cudaStream_t s) {
  switch (group) {
    case 1: return launch_d<T, 1>(d, a, s);
    case 2: return launch_d<T, 2>(d, a, s);
    case 4: return launch_d<T, 4>(d, a, s);
    case 8: return launch_d<T, 8>(d, a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: (b, hq, d); k, v: (b, t_len, hkv, d), 16-byte aligned; lengths: (b,)
// int32, or int64 when len64; out: (b, hq, d); lse: (b, hq) float32 or NULL.
// Workspace: part_acc (b, hkv, n_splits, group, d) and part_ml (b, hkv,
// n_splits, group, 2) float32, no initial value; counters (b * hkv,) int32,
// all 0 before the call and left 0 after it. split: keys per block, a
// multiple of 16; n_splits = ceil(t_len / split). Returns the CUDA error code.
extern "C" int rt_splitkv_attention(const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    int len64, float* part_acc, float* part_ml,
                                    int* counters, void* out, float* lse,
                                    int b, int t_len, int hq, int hkv, int d,
                                    int split, int n_splits, float scale,
                                    int dtype, void* stream) {
  if (b > 0 && hq > 0 && t_len > 0) {
    if (hkv <= 0 || hq % hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
    const Args a{q, k, v, lengths, len64, part_acc, part_ml, counters, out,
                 lse, b, t_len, hkv, split, n_splits, scale};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int err = dtype == RT_DTYPE_BF16
        ? launch_g<__nv_bfloat16>(hq / hkv, d, a, s)
        : launch_g<float>(hq / hkv, d, a, s);
    if (err) return err;
  }
  return static_cast<int>(cudaGetLastError());
}
