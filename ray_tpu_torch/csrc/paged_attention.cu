// Paged decode attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: ray_tpu/ops/paged_attention_kernel.py:paged_attention_kernel
// (Pallas body `_kernel`). Same contract as
// ray_tpu_torch/ops/attention.py:paged_attention: for each row b and query
// head h, attend q[b, s, h] over the cache slots of row b, read through its
// block table bt[b, :] from the pool pages [NB, T, KV, D], with the mask
// `slot <= q_slots[b, s] && slot < kv_valid_len`, an online softmax in f32,
// masked probabilities zeroed explicitly, and a fully-masked row written as
// 0. int8 / fp8-e4m3 pages are dequantized on load with the per-(block,
// kv-head) f32 scales [NB, KV].
//
// What bounds it on this card: memory. Decode reads every live K and V
// slot once per kv head and does 4*D flops per slot per query head, far
// below the ~295 flop/byte the H100 needs before its tensor cores become
// the limit. The least bytes are the K+V pages of the live slots, plus q,
// out, the block-table entries and scales those slots touch.
//
// Design (simple and right first):
// - One thread block per (kv head, row): it serves the g = H/KV query heads
//   x S queries of that group, so each page is read from device memory
//   once per group, not once per query head (GQA reuse).
// - A loop over the row's block-table entries inside the block stands in
//   for the TPU kernel's sequential grid axis. Blocks whose first slot lies
//   past every query's slot or past kv_valid_len are not visited: under the
//   explicit-zero rule they add exactly 0.
// - Per block: the K and V page slices [T, D] are widened to f32 (times the
//   scale for a quantized pool) into shared memory; one warp per (query,
//   slot) pair forms the score; one warp per query runs the online-softmax
//   update and P.V with its lanes over D. m, l and acc stay f32 in shared
//   memory.
// Left for later: 16-byte vector loads, cp.async/TMA double buffering of
// the next page, wgmma for the score and P.V products, and split-KV
// (flash-decoding) so a small batch fills all 132 SMs: at B=8, KV=8 this
// grid has 64 blocks, so half the SMs idle.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's mask fill
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Shared memory floats for R = g*S query rows: q and acc [R, D], the K and
// V page [T, D] each, scores [R, T], m and l [R], plus R int slots.
__host__ __device__ inline size_t smem_bytes(int R, int D, int T) {
  return sizeof(float) * (2 * (size_t)R * D + 2 * (size_t)T * D +
                          (size_t)R * T + 2 * (size_t)R) +
         sizeof(int) * (size_t)R;
}

template <typename QT, typename PT, int D>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const QT* __restrict__ q,
                        const PT* __restrict__ k_pages,
                        const PT* __restrict__ v_pages,
                        const int32_t* __restrict__ block_tables,
                        const int32_t* __restrict__ q_slots,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        QT* __restrict__ out, int S, int H, int KV, int T,
                        int MB, int kv_valid_len, float scale) {
  const int kv = blockIdx.x;
  const int b = blockIdx.y;
  const int g = H / KV;
  const int R = g * S;  // query row r <-> (s = r / g, head kv*g + r % g)
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ float smem[];
  float* q_s = smem;            // [R, D]
  float* acc = q_s + R * D;     // [R, D]
  float* k_s = acc + R * D;     // [T, D]
  float* v_s = k_s + T * D;     // [T, D]
  float* p_s = v_s + T * D;     // [R, T] scores, then probabilities
  float* m_s = p_s + R * T;     // [R]
  float* l_s = m_s + R;         // [R]
  int* slot_s = reinterpret_cast<int*>(l_s + R);  // [R]

  for (int i = tid; i < R * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int s = r / g, h = kv * g + r % g;
    q_s[i] = to_f32(q[(((size_t)b * S + s) * H + h) * D + d]);
    acc[i] = 0.f;
  }
  for (int r = tid; r < R; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
    slot_s[r] = q_slots[b * S + r / g];
  }
  // Slots at or past `live` are masked for every query of this row.
  int live = 0;
  for (int s = 0; s < S; ++s) live = max(live, q_slots[b * S + s] + 1);
  live = min(live, kv_valid_len);
  const int n_blocks = live > 0 ? min(MB, (live + T - 1) / T) : 0;
  __syncthreads();

  for (int j = 0; j < n_blocks; ++j) {
    const int phys = block_tables[b * MB + j];
    const float ks = k_scale != nullptr ? k_scale[phys * KV + kv] : 1.f;
    const float vs = v_scale != nullptr ? v_scale[phys * KV + kv] : 1.f;
    for (int i = tid; i < T * D; i += kThreads) {
      const int t = i / D, d = i % D;
      const size_t off = (((size_t)phys * T + t) * KV + kv) * D + d;
      k_s[i] = to_f32(k_pages[off]) * ks;
      v_s[i] = to_f32(v_pages[off]) * vs;
    }
    __syncthreads();

    // Scores: one warp per (row, slot) pair, lanes across D.
    for (int pr = warp; pr < R * T; pr += kWarps) {
      const int r = pr / T, t = pr % T;
      float dot = 0.f;
      for (int d = lane; d < D; d += 32) dot += q_s[r * D + d] * k_s[t * D + d];
      dot = warp_sum(dot);
      if (lane == 0) {
        const int slot = j * T + t;
        const bool ok = slot <= slot_s[r] && slot < kv_valid_len;
        p_s[pr] = ok ? dot * scale : kNegInf;
      }
    }
    __syncthreads();

    // Online softmax + P.V: one warp per row, lanes across slots then D.
    for (int r = warp; r < R; r += kWarps) {
      float mx = kNegInf;
      for (int t = lane; t < T; t += 32) mx = fmaxf(mx, p_s[r * T + t]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float psum = 0.f;
      for (int t = lane; t < T; t += 32) {
        const int slot = j * T + t;
        const bool ok = slot <= slot_s[r] && slot < kv_valid_len;
        // explicit zero: with m still at -1e30 a masked score would
        // otherwise give exp(0) == 1
        const float p = ok ? expf(p_s[r * T + t] - m_new) : 0.f;
        p_s[r * T + t] = p;
        psum += p;
      }
      psum = warp_sum(psum);
      const float alpha = expf(m_prev - m_new);
      __syncwarp();
      for (int d = lane; d < D; d += 32) {
        float a = acc[r * D + d] * alpha;
        for (int t = 0; t < T; ++t) a += p_s[r * T + t] * v_s[t * D + d];
        acc[r * D + d] = a;
      }
      if (lane == 0) {
        l_s[r] = l_s[r] * alpha + psum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < R * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int s = r / g, h = kv * g + r % g;
    const float l = l_s[r] == 0.f ? 1.f : l_s[r];
    const bool row_live = m_s[r] > kNegInf * 0.5f;
    store(&out[(((size_t)b * S + s) * H + h) * D + d],
          row_live ? acc[i] / l : 0.f);
  }
}

template <typename QT, typename PT, int D>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* block_tables, const void* q_slots,
                   const void* k_scale, const void* v_scale, void* out, int B,
                   int S, int H, int KV, int T, int MB, int kv_valid_len,
                   float scale, cudaStream_t stream) {
  auto kernel = paged_decode_kernel<QT, PT, D>;
  const size_t smem = smem_bytes((H / KV) * S, D, T);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(KV, B), kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const PT*>(k_pages),
      static_cast<const PT*>(v_pages),
      static_cast<const int32_t*>(block_tables),
      static_cast<const int32_t*>(q_slots),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<QT*>(out), S, H, KV, T, MB, kv_valid_len, scale);
  return cudaGetLastError();
}

template <typename QT, typename PT>
cudaError_t launch_d(int D, const void* q, const void* k_pages,
                     const void* v_pages, const void* block_tables,
                     const void* q_slots, const void* k_scale,
                     const void* v_scale, void* out, int B, int S, int H,
                     int KV, int T, int MB, int kv_valid_len, float scale,
                     cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<QT, PT, 64>(q, k_pages, v_pages, block_tables, q_slots,
                                k_scale, v_scale, out, B, S, H, KV, T, MB,
                                kv_valid_len, scale, stream);
    case 128:
      return launch<QT, PT, 128>(q, k_pages, v_pages, block_tables, q_slots,
                                 k_scale, v_scale, out, B, S, H, KV, T, MB,
                                 kv_valid_len, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename QT>
cudaError_t launch_p(int page_dtype, int D, const void* q,
                     const void* k_pages, const void* v_pages,
                     const void* block_tables, const void* q_slots,
                     const void* k_scale, const void* v_scale, void* out,
                     int B, int S, int H, int KV, int T, int MB,
                     int kv_valid_len, float scale, cudaStream_t stream) {
  switch (page_dtype) {
    case 0:
      return launch_d<QT, float>(D, q, k_pages, v_pages, block_tables,
                                 q_slots, k_scale, v_scale, out, B, S, H, KV,
                                 T, MB, kv_valid_len, scale, stream);
    case 1:
      return launch_d<QT, __nv_bfloat16>(D, q, k_pages, v_pages,
                                         block_tables, q_slots, k_scale,
                                         v_scale, out, B, S, H, KV, T, MB,
                                         kv_valid_len, scale, stream);
    case 2:
      return launch_d<QT, int8_t>(D, q, k_pages, v_pages, block_tables,
                                  q_slots, k_scale, v_scale, out, B, S, H,
                                  KV, T, MB, kv_valid_len, scale, stream);
    case 3:
      return launch_d<QT, __nv_fp8_e4m3>(D, q, k_pages, v_pages,
                                         block_tables, q_slots, k_scale,
                                         v_scale, out, B, S, H, KV, T, MB,
                                         kv_valid_len, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype codes: 0 float32, 1 bfloat16, 2 int8, 3 float8_e4m3fn. q and out
// share q_dtype (0 or 1). k_scale / v_scale may be null for a float pool.
// Returns the cudaError_t of the launch (0 on success); the kernel
// allocates nothing and does not synchronise.
int ray_tpu_torch_paged_attention(const void* q, const void* k_pages,
                                  const void* v_pages,
                                  const void* block_tables,
                                  const void* q_slots, const void* k_scale,
                                  const void* v_scale, void* out, int q_dtype,
                                  int page_dtype, int B, int S, int H, int KV,
                                  int D, int T, int MB, int kv_valid_len,
                                  float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case 0:
      return launch_p<float>(page_dtype, D, q, k_pages, v_pages, block_tables,
                             q_slots, k_scale, v_scale, out, B, S, H, KV, T,
                             MB, kv_valid_len, scale, st);
    case 1:
      return launch_p<__nv_bfloat16>(page_dtype, D, q, k_pages, v_pages,
                                     block_tables, q_slots, k_scale, v_scale,
                                     out, B, S, H, KV, T, MB, kv_valid_len,
                                     scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

size_t ray_tpu_torch_paged_attention_smem(int R, int D, int T) {
  return smem_bytes(R, D, T);
}

const char* ray_tpu_torch_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
