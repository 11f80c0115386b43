// Flash attention for Hopper (sm_90a), bf16 inputs: the forward (with the
// row logsumexp) and both backward kernels, built on wgmma fed by a ring
// of TMA loads. Plain C interface for ctypes.
//
// Replaces, in ray_tpu/ops/flash_attention.py, for bf16 q/k/v:
//   flash_fwd_sm90_kernel     <- _flash_fwd (Pallas bodies _fwd_kernel and
//                                _fwd_kernel_lse)                     [B1]
//   flash_bwd_dq_sm90_kernel  <- _flash_bwd's dq call (_bwd_dq_kernel) [B3a]
//   flash_bwd_dkv_sm90_kernel <- _flash_bwd's dk/dv call (_bwd_dkv_kernel)
//                                plus the GQA group sum after it      [B3b]
// f32 inputs stay in flash_attention.cu (exact f32 FMAs).
//
// Contract (the Pallas kernels' and ops/flash_attention.py's plain
// versions'): q [B,H,Sq,D], k/v [B,Hkv,Sk,D] (q head h reads kv head
// h/(H/Hkv)); causal mask `q_offset + qi >= ki` with q_offset = Sk - Sq,
// masking by global index with -1e30 fills; m, l and every accumulator in
// f32; p rounded to bf16 before p.v and before p^T.dO, ds rounded to bf16
// before ds^T.q (a register conversion, the Pallas rounding points); a
// fully masked row gives o exactly 0 and lse <= -5e29, and the backward
// takes p = 0 where lse <= -5e29; ds rounded to bf16 before ds.k; dq in
// bf16 or f32, dk/dv summed over the GQA group, in bf16 or f32. D is 32,
// 64 or 128; Sq and Sk are any length.
//
// What bounds them on this card: operations. At the flagship training
// shape (B=8, H=12, S=2048, D=128, causal) the forward does 2 products of
// ~51.5 GFLOP over ~200 MB (~500 flop per byte, above the ~295 flop/byte
// where the bf16 tensor cores, not the memory, are the limit): 0.104 ms at
// 989 TFLOP/s. The dq kernel does 3 products (0.156 ms), dk/dv 4 (0.209
// ms).
//
// Design, and what it does about each fault of the first port
// (flash_attention.cu, mma.sync on synchronously staged tiles):
// - One block = two consumer warpgroups (wgmma's M is 64 rows) and one
//   producer warp. The producer's lane 0 issues TMA loads
//   (cp.async.bulk.tensor) into a ring of shared-memory stages; each stage
//   completes on a "full" mbarrier and is handed back on an "empty" one.
//   In dk/dv the producer's 32 lanes also copy each q tile's lse and delta
//   into its stage (a TMA box of the flat [B*H*Sq] vectors cannot start at
//   an arbitrary float). Loads run ahead of the products, so no thread
//   waits on a synchronous staging pass (fault 1: synchronous loads
//   between __syncthreads).
// - Tiles land in the 128-byte swizzled layout wgmma reads, as 64-column
//   boxes (a 128-byte row is TMA's limit under that swizzle), so a D=128
//   row is two boxes. Every product reads its operands straight from that
//   layout: K-major (q, k rows) or MN-major (v as p.v's B, q and dO as the
//   B of p^T.dO and ds^T.q) through wgmma's transpose flag. No tile is
//   staged twice (fault 2: transposed copies with scalar stores).
// - wgmma reads shared memory through descriptors; nothing is loaded into
//   registers one word at a time, and q stays in shared memory for the
//   whole forward as the A operand of every s product (fault 3).
// - p and ds stay in registers for the products: wgmma's f32 accumulator
//   layout is its A-register layout, so an accumulator converts to bf16
//   pairs in place and feeds the next product (fault 4: round trips
//   through shared memory with a __syncwarp each).
// - Forward: a 128-row q tile (64 rows per warpgroup) against 64-row k/v
//   tiles in 4 stages; s = q.k^T and o += p.v on wgmma m64n64k16 and
//   m64nDk16. dk/dv: a 64-row kv tile (k, v resident) against 64-row q/dO
//   tiles in 4 stages, both warpgroups on the same kv rows: warpgroup 0
//   forms p^T from s^T = k.q^T and accumulates dv += p^T.dO, warpgroup 1
//   forms dp^T = v.dO^T, takes p^T (f32) from warpgroup 0 through a
//   double-buffered shared tile (named barriers), and accumulates
//   dk += ds^T.q. Two products each per step, and one 64 x D f32
//   accumulator per thread: the block gets 168 registers a thread, and
//   ptxas spilled dk and dv kept together (it does not size the registers
//   after setmaxnreg).
// - dq: B1's structure. A 128-row q tile (64 rows per warpgroup) with q
//   and dO resident, loaded once by TMA; 64-row k and v tiles in 4 stages
//   up to the causal limit. Per step s = q.k^T and dp = dO.v^T go out as
//   one commit group (m64n64k16, K-major), p = exp2(s * scale * log2 e -
//   lse * log2 e) and ds = p (dp - delta) scale in registers, ds converted
//   to bf16 A fragments in place, and dq += ds.k on m64nDk16 with k read
//   MN-major. Each thread reads its two rows' lse and delta once with
//   plain loads. Live per thread: s, dp (32 f32 each) and dq (D/2 f32).
//   Every product is wgmma, the only path to the card's full tensor-core
//   rate (fault 5: mma.sync on 64-row tiles and 32-row dk/dv steps).
// - TMA fills rows past Sq / Sk with zeros; the mask, by global index, is
//   evaluated only on tiles that cross the causal diagonal or an edge. The
//   online softmax works in the log2 domain (exp2 with scale * log2 e
//   folded in; the fill is -1e30 * log2 e so lse = (m2 + log2 l) * ln 2
//   keeps the natural-log contract, -1e30 for a dead row).
// - D = 32 (ViT's head dim) runs the D = 64 layout: a 32-column row is 64
//   bytes, and the tensor map keeps the 64-column, 128-byte swizzled box
//   over the 32-column tensor, so TMA fills columns 32..63 of every tile
//   with zeros (no copy on the host). The s products run over the real
//   depth (2 k-steps of 16), the p.v, p^T.dO, ds^T.q and ds.k products
//   at N = 64, whose columns past 32 come out zero and are never stored;
//   stores and row strides use the real D. sm_scale is the caller's.
// - A mbarrier wait that spins for seconds traps, so a lost phase is a
//   launch error and not a hung card.
// Left for later: overlapping one warpgroup's softmax with the other's
// products explicitly (ping-pong), intra-warpgroup pipelining of s and
// p.v, 128-row kv tiles in dk/dv once the registers allow, TMA stores of
// o, persistent blocks.

#include <cuda.h>  // CUtensorMap; the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;  // the Pallas kernels' mask fill
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegInf2 = kNegInf * kLog2e;  // the fill in log2 units

constexpr int kConsumers = 256;            // two warpgroups
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kBox = 64;        // bf16 columns in one 128-byte swizzled row
constexpr int kRowBytes = 128;  // bytes of one such row

// The columns a tile of head dim D holds in shared memory: a D = 32 tile
// fills one 64-column box, its columns past D zero (TMA's fill).
__host__ __device__ constexpr int padded(int D) {
  return D < kBox ? kBox : D;
}

// Tiles (rows). The s products are m64n64: kFwdKV and kBwdQ stay 64.
constexpr int kFwdQ = 128, kFwdKV = 64, kFwdStages = 4;
constexpr int kBwdKV = 64, kBwdQ = 64, kBwdStages = 4;
constexpr int kDqQ = 128, kDqKV = 64, kDqStages = 4;

// ------------------------------------------------------------ primitives

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Waits for the phase of parity `parity` of barrier `bar` to complete. A
// wait that spins for ~2^33 cycles (seconds) traps.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    if (clock64() - start > (1ll << 33)) __trap();
  }
}

// One box of a [heads][S][D] bf16 tensor (3-d map) into shared memory.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// Named hardware barrier `id` (1..15; 0 is __syncthreads) over `count`
// threads: arrive without waiting, or arrive and wait. Either orders the
// thread's earlier shared-memory accesses before the barrier completes.
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pins register values in place across the asynchronous products: the
// compiler may not move a read or write of `d` across this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
  }
}

// wgmma shared-memory descriptor of a 128-byte swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout type 1
// (128-byte swizzle). Every tile starts on a 1024-byte boundary (one
// swizzle atom: 8 rows of 128 bytes), so the base offset is 0.
//   K-major (rows of the operand's K extent): stride = 1024 between groups
//     of 8 rows; the leading offset is unused; a k-step of 16 columns
//     advances the start by 32 bytes inside the swizzled row, and columns
//     64.. live in the next box (the tile's second half).
//   MN-major (B stored [K][N], N contiguous): stride = 1024 between groups
//     of 8 K rows; leading = the distance between 64-column boxes along N.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lead,
                                              uint32_t stride) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lead >> 4) << 16) |
         (static_cast<uint64_t>(stride >> 4) << 32) | (1ull << 62);
}

// K-major descriptor of k-step kk (16 columns) for the 64-row slice at
// `row0` of a tile of `rows` rows stored as D/64 boxes.
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int rows, int row0,
                                           int kk) {
  return make_desc(tile + (kk / 4) * rows * kRowBytes + row0 * kRowBytes +
                       (kk % 4) * 32,
                   16, 1024);
}

// MN-major descriptor of k-step kk (16 rows of K) of a tile of `rows`
// rows stored as D/64 boxes.
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int rows, int kk) {
  return make_desc(tile + kk * 16 * kRowBytes, rows * kRowBytes, 1024);
}

// The wgmma instructions (accumulator layout, thread t = 32 w + 4 g + c of
// the warpgroup: d[4 n + 2 i + j] is row 16 w + g + 8 i, column 8 n + 2 c
// + j; the A-register layout is the same for a 64 x 16 slice).

// d[32] (+)= A[64x16] . B[16x64], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[32] += A[64x16] . B[16x64], A in registers (bf16 pairs), B MN-major in
// shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64] += A[64x16] . B[16x128], A in registers (bf16 pairs), B MN-major
// in shared memory.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, "
      "1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[32] = A . B^T over depth D, A = the 64 rows of a_tile at a_row0, B =
// the 64 rows of b_tile (both K-major).
template <int D>
__device__ __forceinline__ void product_ss(float (&d)[32], uint32_t a_tile,
                                           int a_rows, int a_row0,
                                           uint32_t b_tile, int b_rows) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64(d, kmajor(a_tile, a_rows, a_row0, kk),
                 kmajor(b_tile, b_rows, 0, kk), kk > 0);
}

// d[D/2] += A[64 x 16 KS] . B[16 KS x D]: A from registers (KS k-steps of
// bf16 pairs), B an MN-major tile in shared memory.
template <int D, int KS>
__device__ __forceinline__ void product_rs(float (&d)[D / 2],
                                           const uint32_t (&a)[KS][4],
                                           uint32_t b_tile, int b_rows) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    if constexpr (D == 128)
      wgmma_rs_n128(d, a[kk], mnmajor(b_tile, b_rows, kk));
    else
      wgmma_rs_n64(d, a[kk], mnmajor(b_tile, b_rows, kk));
  }
}

// 2^x on the special-function unit (relative error ~2^-22, far inside the
// bf16 rounding of p; exp2f's full-range path is several instructions).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// This thread's warp index, broadcast from lane 0 so that the compiler
// treats every branch on it (or on the warpgroup index) as warp-uniform:
// a wgmma under a branch it cannot prove uniform gets serialized.
__device__ __forceinline__ int warp_index() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 32), 0);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A-register fragments of the KS k-steps of a 64 x 16 KS f32
// accumulator, rounded to bf16 (the accumulator layout is the A-register
// layout).
template <int KS>
__device__ __forceinline__ void to_a(uint32_t (&a)[KS][4],
                                     const float (&d)[8 * KS]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
  }
}

// Max / sum over the 4 lanes of a quad (the lanes that share a row).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Number of kv tiles of `tile` columns that rows up to `last_row` reach:
// all of them, or up to the causal limit (_block_contributes).
__device__ __forceinline__ int kv_tiles(int last_row, int q_offset, int Sk,
                                        int tile, bool causal) {
  int n = (Sk + tile - 1) / tile;
  if (causal) {
    const int lim = q_offset + last_row;
    n = lim < 0 ? 0 : min(n, lim / tile + 1);
  }
  return n;
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// ---------------------------------------------------------------- forward

template <int D>
struct FwdSmem {
  static constexpr int kQBytes = kFwdQ * padded(D) * 2;    // the q tile
  static constexpr int kKVBytes = kFwdKV * padded(D) * 2;  // one k or v
  static constexpr int kBars = kQBytes + kFwdStages * 2 * kKVBytes;
  static constexpr size_t bytes = kBars + 8 * (1 + 2 * kFwdStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          bf16* __restrict__ o, float* __restrict__ lse,
                          int H, int Hkv, int Sq, int Sk, float scale,
                          int causal) {
  using Sm = FwdSmem<D>;
  // Heaviest causal tiles (the last q rows) start first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kFwdQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int qh = b * H + h, kh = b * Hkv + h / (H / Hkv);
  const int q_offset = Sk - Sq;
  const bool is_causal = causal != 0;
  const int n_kv = kv_tiles(min(q0 + kFwdQ, Sq) - 1, q_offset, Sk, kFwdKV,
                            is_causal);

  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t bar_q = base + Sm::kBars;
  auto k_s = [&](int s) { return base + Sm::kQBytes + s * 2 * Sm::kKVBytes; };
  auto v_s = [&](int s) { return k_s(s) + Sm::kKVBytes; };
  auto full = [&](int s) { return bar_q + 8 * (1 + s); };
  auto empty = [&](int s) { return bar_q + 8 * (1 + kFwdStages + s); };

  const int warp = warp_index(), lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers / 32);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // producer
    if (lane == 0 && n_kv > 0) {
      mbar_expect_tx(bar_q, Sm::kQBytes);
      for (int hf = 0; hf < padded(D) / kBox; ++hf)
        tma_load_3d(q_s + hf * kFwdQ * kRowBytes, &tm_q, bar_q, hf * kBox,
                    q0, qh);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % kFwdStages;
        if (j >= kFwdStages) mbar_wait(empty(s), (j / kFwdStages - 1) & 1);
        mbar_expect_tx(full(s), 2 * Sm::kKVBytes);
        for (int hf = 0; hf < padded(D) / kBox; ++hf) {
          tma_load_3d(k_s(s) + hf * kFwdKV * kRowBytes, &tm_k, full(s),
                      hf * kBox, j * kFwdKV, kh);
          tma_load_3d(v_s(s) + hf * kFwdKV * kRowBytes, &tm_v, full(s),
                      hf * kBox, j * kFwdKV, kh);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns q rows [r0, r0 + 64).
  const int wg = warp / 4, w = warp % 4, g = lane >> 2, t = lane & 3;
  const int r0 = q0 + 64 * wg;
  const int n_mine = r0 >= Sq ? 0
                              : kv_tiles(min(r0 + 64, Sq) - 1, q_offset, Sk,
                                         kFwdKV, is_causal);
  const float scale2 = scale * kLog2e;
  constexpr int DP = padded(D);
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf2, kNegInf2}, l[2] = {0.f, 0.f};

  if (n_kv > 0) mbar_wait(bar_q, 0);
  for (int j = 0; j < n_kv; ++j) {
    const int s = j % kFwdStages;
    mbar_wait(full(s), (j / kFwdStages) & 1);
    if (j < n_mine) {
      float sc[kFwdKV / 2];
#pragma unroll
      for (int i = 0; i < kFwdKV / 2; ++i) sc[i] = 0.f;
      fence_regs(sc);
      wgmma_fence();
      product_ss<D>(sc, q_s, kFwdQ, 64 * wg, k_s(s), kFwdKV);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      const int c0 = j * kFwdKV;
      const bool edge = c0 + kFwdKV > Sk ||
                        (is_causal && c0 + kFwdKV - 1 > q_offset + r0);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < kFwdKV / 2; ++i) {
        float x = sc[i] * scale2;
        if (edge) {
          const int row = r0 + 16 * w + g + 8 * ((i >> 1) & 1);
          const int col = c0 + 8 * (i >> 2) + 2 * t + (i & 1);
          const bool ok = col < Sk && (!is_causal || q_offset + row >= col);
          x = ok ? x : kNegInf2;
        }
        sc[i] = x;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
      }
      float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = quad_max(mx[r]);
        alpha[r] = fast_exp2(m[r] - mx[r]);
        m[r] = mx[r];
      }
#pragma unroll
      for (int i = 0; i < kFwdKV / 2; ++i) {
        const float p = fast_exp2(sc[i] - mx[(i >> 1) & 1]);
        psum[(i >> 1) & 1] += p;
        sc[i] = p;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(psum[r]);
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

      uint32_t pa[kFwdKV / 16][4];
      to_a(pa, sc);  // p rounded to v's type (bf16) before p.v
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
      product_rs<DP, kFwdKV / 16>(acc, pa, v_s(s), kFwdKV);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 16 * w + g + 8 * r;
    if (row >= Sq) continue;
    const float lr = l[r] == 0.f ? 1.f : l[r];
    const bool live = m[r] > kNegInf2 * 0.5f;
    bf16* orow = o + ((size_t)qh * Sq + row) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store2(orow + 8 * n + 2 * t, live ? acc[4 * n + 2 * r] / lr : 0.f,
             live ? acc[4 * n + 2 * r + 1] / lr : 0.f);
    if (lse != nullptr && t == 0)
      lse[(size_t)qh * Sq + row] = (m[r] + log2f(lr)) * kLn2;
  }
}

// ------------------------------------------------------------------ dk/dv

template <int D>
struct DkvSmem {
  static constexpr int kKVBytes = kBwdKV * padded(D) * 2;  // k or v
  static constexpr int kQBytes = kBwdQ * padded(D) * 2;    // q or dO tile
  static constexpr int kVecBytes = kBwdQ * 4;      // lse or delta of a tile
  static constexpr int kPBytes = kBwdKV * kBwdQ * 4;  // one f32 p tile
  static constexpr int kStages = 2 * kKVBytes;     // q/dO stages start here
  static constexpr int kP = kStages + kBwdStages * 2 * kQBytes;
  static constexpr int kVecs = kP + 2 * kPBytes;
  static constexpr int kBars = kVecs + kBwdStages * 2 * kVecBytes;
  static constexpr size_t bytes = kBars + 8 * (1 + 2 * kBwdStages) + 1024;
};

// Named barriers of the p^T hand-off between the dk/dv warpgroups, per
// buffer i: "full" (warpgroup 0 wrote it) and "empty" (warpgroup 1 read
// it).
__device__ __forceinline__ int p_full_id(int i) { return 1 + i; }
__device__ __forceinline__ int p_empty_id(int i) { return 3 + i; }

template <int D, typename OT>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_do,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              OT* __restrict__ dk_out,
                              OT* __restrict__ dv_out, int H, int Hkv,
                              int Sq, int Sk, float scale, int causal) {
  using Sm = DkvSmem<D>;
  const int k0 = blockIdx.x * kBwdKV, hk = blockIdx.y, b = blockIdx.z;
  const int grp = H / Hkv;
  const int kh = b * Hkv + hk;
  const int q_offset = Sk - Sq;
  const bool is_causal = causal != 0;
  // First q tile that reaches this kv tile: the one holding q row
  // k0 - q_offset (earlier rows see only earlier columns). Every tile
  // from there on holds a live (q, kv) pair.
  const int nq = (Sq + kBwdQ - 1) / kBwdQ;
  const int i0 = is_causal ? min(nq, max(0, k0 - q_offset) / kBwdQ) : 0;
  const int per_head = nq - i0;
  const int n_steps = grp * per_head;  // (q head, q tile) pairs

  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t k_s = base, v_s = base + Sm::kKVBytes;
  const uint32_t bar_kv = base + Sm::kBars;
  auto q_s = [&](int s) { return base + Sm::kStages + s * 2 * Sm::kQBytes; };
  auto do_s = [&](int s) { return q_s(s) + Sm::kQBytes; };
  auto p_s = [&](int i) { return base + Sm::kP + i * Sm::kPBytes; };
  auto lse_s = [&](int s) { return base + Sm::kVecs + s * 2 * Sm::kVecBytes; };
  auto delta_s = [&](int s) { return lse_s(s) + Sm::kVecBytes; };
  auto full = [&](int s) { return bar_kv + 8 * (1 + s); };
  auto empty = [&](int s) { return bar_kv + 8 * (1 + kBwdStages + s); };

  const int warp = warp_index(), lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kBwdStages; ++s) {
      // lane 0's expect_tx, then one arrival per producer lane once its
      // lse/delta values are in place
      mbar_init(full(s), 1 + 32);
      mbar_init(empty(s), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // producer
    if (lane == 0) {
      mbar_expect_tx(bar_kv, 2 * Sm::kKVBytes);
      for (int hf = 0; hf < padded(D) / kBox; ++hf) {
        tma_load_3d(k_s + hf * kBwdKV * kRowBytes, &tm_k, bar_kv, hf * kBox,
                    k0, kh);
        tma_load_3d(v_s + hf * kBwdKV * kRowBytes, &tm_v, bar_kv, hf * kBox,
                    k0, kh);
      }
    }
    // lse and delta of the tile's rows by plain loads (a TMA box may not
    // start at an arbitrary float of the flat [B*H*Sq] vectors), fetched
    // one step ahead into registers; rows past Sq are masked by the
    // consumers.
    constexpr int kPer = kBwdQ / 32;
    float lse_v[kPer], delta_v[kPer];
    auto fetch = [&](int it) {
      const int qh = b * H + hk * grp + it / per_head;
      const int q0 = (i0 + it % per_head) * kBwdQ;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int c = lane + 32 * k;
        const bool in = q0 + c < Sq;
        const size_t row = (size_t)qh * Sq + q0 + c;
        lse_v[k] = in ? lse[row] : kNegInf;
        delta_v[k] = in ? delta[row] : 0.f;
      }
    };
    if (n_steps > 0) fetch(0);
    for (int it = 0; it < n_steps; ++it) {
      const int s = it % kBwdStages;
      const int qh = b * H + hk * grp + it / per_head;
      const int q0 = (i0 + it % per_head) * kBwdQ;
      if (it >= kBwdStages) mbar_wait(empty(s), (it / kBwdStages - 1) & 1);
      if (lane == 0) {
        mbar_expect_tx(full(s), 2 * Sm::kQBytes);
        for (int hf = 0; hf < padded(D) / kBox; ++hf) {
          tma_load_3d(q_s(s) + hf * kBwdQ * kRowBytes, &tm_q, full(s),
                      hf * kBox, q0, qh);
          tma_load_3d(do_s(s) + hf * kBwdQ * kRowBytes, &tm_do, full(s),
                      hf * kBox, q0, qh);
        }
      }
      float* lse_t = static_cast<float*>(__cvta_shared_to_generic(lse_s(s)));
      float* delta_t =
          static_cast<float*>(__cvta_shared_to_generic(delta_s(s)));
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        lse_t[lane + 32 * k] = lse_v[k];
        delta_t[lane + 32 * k] = delta_v[k];
      }
      mbar_arrive(full(s));
      if (it + 1 < n_steps) fetch(it + 1);
    }
    return;
  }

  // Consumers. Both warpgroups own the kv rows [k0, k0 + 64): warpgroup 0
  // forms p^T (s^T = k . q^T) and accumulates dv += p^T . dO; warpgroup 1
  // forms dp^T = v . dO^T, takes p^T from warpgroup 0 through a
  // double-buffered shared tile (f32, in the accumulator's thread layout),
  // and accumulates dk += ds^T . q. Each keeps one 64 x D accumulator.
  const int wg = warp / 4, w = warp % 4, g = lane >> 2, t = lane & 3;
  const int tid = threadIdx.x & 127;
  const float scale2 = scale * kLog2e;
  constexpr int DP = padded(D);
  float acc[DP / 2];  // dv (warpgroup 0) or dk (warpgroup 1)
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

  mbar_wait(bar_kv, 0);
  for (int it = 0; it < n_steps; ++it) {
    const int s = it % kBwdStages, pb = it & 1;
    const int qs = (i0 + it % per_head) * kBwdQ;
    mbar_wait(full(s), (it / kBwdStages) & 1);
    const float* lse_t =
        static_cast<const float*>(__cvta_shared_to_generic(lse_s(s)));
    const float* delta_t =
        static_cast<const float*>(__cvta_shared_to_generic(delta_s(s)));
    // thread tid's 8 float4 of the p tile, at [j][tid] (conflict-free)
    float4* p_t = static_cast<float4*>(__cvta_shared_to_generic(p_s(pb)));
    float x[kBwdQ / 2];  // s^T then p^T (wg 0), dp^T then ds^T (wg 1)
#pragma unroll
    for (int i = 0; i < kBwdQ / 2; ++i) x[i] = 0.f;
    fence_regs(x);
    wgmma_fence();
    product_ss<D>(x, wg == 0 ? k_s : v_s, kBwdKV, 0,
                  wg == 0 ? q_s(s) : do_s(s), kBwdQ);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(x);

    if (wg == 0) {
      const bool edge = k0 + kBwdKV > Sk || qs + kBwdQ > Sq ||
                        (is_causal && k0 + kBwdKV - 1 > q_offset + qs);
#pragma unroll
      for (int n = 0; n < kBwdQ / 8; ++n) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * n + 2 * t + c;
          const float row_lse = lse_t[col];
          const bool live = row_lse > kNegInf * 0.5f;
          const float lse2 = row_lse * kLog2e;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = 4 * n + 2 * r + c;
            bool ok = live;
            if (edge) {
              const int kv = k0 + 16 * w + g + 8 * r, q = qs + col;
              ok = ok && kv < Sk && q < Sq &&
                   (!is_causal || q_offset + q >= kv);
            }
            x[i] = ok ? fast_exp2(x[i] * scale2 - lse2) : 0.f;
          }
        }
      }
      // hand p^T to warpgroup 1 (the buffer's last reader was step it - 2)
      if (it >= 2) named_sync(p_empty_id(pb), kConsumers);
#pragma unroll
      for (int j = 0; j < kBwdQ / 8; ++j)
        p_t[j * 128 + tid] =
            make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
      named_arrive(p_full_id(pb), kConsumers);
    } else {
      named_sync(p_full_id(pb), kConsumers);
#pragma unroll
      for (int j = 0; j < kBwdQ / 8; ++j) {
        const float4 p = p_t[j * 128 + tid];
        const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          const float row_delta = delta_t[8 * j + 2 * t + (e & 1)];
          x[i] = pv[e] * (x[i] - row_delta) * scale;
        }
      }
      // warpgroup 0 waits for this buffer again at step it + 2
      if (it + 2 < n_steps) named_arrive(p_empty_id(pb), kConsumers);
    }

    // p^T rounded to dO's type before p^T.dO; ds^T rounded to q's type
    // before ds^T.q
    uint32_t a[kBwdQ / 16][4];
    to_a(a, x);
    fence_regs(acc);
    fence_regs(a);
    wgmma_fence();
    product_rs<DP, kBwdQ / 16>(acc, a, wg == 0 ? do_s(s) : q_s(s), kBwdQ);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  }

  OT* out = wg == 0 ? dv_out : dk_out;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kv = k0 + 16 * w + g + 8 * r;
    if (kv >= Sk) continue;
    OT* row = out + ((size_t)kh * Sk + kv) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store2(row + 8 * n + 2 * t, acc[4 * n + 2 * r], acc[4 * n + 2 * r + 1]);
  }
}

// --------------------------------------------------------------------- dq

template <int D>
struct DqSmem {
  static constexpr int kQBytes = kDqQ * padded(D) * 2;    // q or dO
  static constexpr int kKVBytes = kDqKV * padded(D) * 2;  // one k or v
  static constexpr int kStages = 2 * kQBytes;     // k/v stages start here
  static constexpr int kBars = kStages + kDqStages * 2 * kKVBytes;
  static constexpr size_t bytes = kBars + 8 * (1 + 2 * kDqStages) + 1024;
};

template <int D, typename OT>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ CUtensorMap tm_do,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             OT* __restrict__ dq, int H, int Hkv, int Sq,
                             int Sk, float scale, int causal) {
  using Sm = DqSmem<D>;
  // Heaviest causal tiles (the last q rows) start first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kDqQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int qh = b * H + h, kh = b * Hkv + h / (H / Hkv);
  const int q_offset = Sk - Sq;
  const bool is_causal = causal != 0;
  const int n_kv =
      kv_tiles(min(q0 + kDqQ, Sq) - 1, q_offset, Sk, kDqKV, is_causal);

  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base, do_s = base + Sm::kQBytes;
  const uint32_t bar_q = base + Sm::kBars;
  auto k_s = [&](int s) { return base + Sm::kStages + s * 2 * Sm::kKVBytes; };
  auto v_s = [&](int s) { return k_s(s) + Sm::kKVBytes; };
  auto full = [&](int s) { return bar_q + 8 * (1 + s); };
  auto empty = [&](int s) { return bar_q + 8 * (1 + kDqStages + s); };

  const int warp = warp_index(), lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers / 32);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // producer
    if (lane == 0 && n_kv > 0) {
      mbar_expect_tx(bar_q, 2 * Sm::kQBytes);
      for (int hf = 0; hf < padded(D) / kBox; ++hf) {
        tma_load_3d(q_s + hf * kDqQ * kRowBytes, &tm_q, bar_q, hf * kBox, q0,
                    qh);
        tma_load_3d(do_s + hf * kDqQ * kRowBytes, &tm_do, bar_q, hf * kBox,
                    q0, qh);
      }
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % kDqStages;
        if (j >= kDqStages) mbar_wait(empty(s), (j / kDqStages - 1) & 1);
        mbar_expect_tx(full(s), 2 * Sm::kKVBytes);
        for (int hf = 0; hf < padded(D) / kBox; ++hf) {
          tma_load_3d(k_s(s) + hf * kDqKV * kRowBytes, &tm_k, full(s),
                      hf * kBox, j * kDqKV, kh);
          tma_load_3d(v_s(s) + hf * kDqKV * kRowBytes, &tm_v, full(s),
                      hf * kBox, j * kDqKV, kh);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns q rows [r0, r0 + 64); this thread's two
  // rows are r0 + 16 w + g and 8 below it. Their lse and delta are read
  // once, by plain loads (a TMA box of the flat vectors may not start at
  // an arbitrary float); rows past Sq or fully masked take p = 0.
  const int wg = warp / 4, w = warp % 4, g = lane >> 2, t = lane & 3;
  const int r0 = q0 + 64 * wg;
  const int n_mine = r0 >= Sq ? 0
                              : kv_tiles(min(r0 + 64, Sq) - 1, q_offset, Sk,
                                         kDqKV, is_causal);
  const float scale2 = scale * kLog2e;
  float lse2[2], row_delta[2];
  bool live[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 16 * w + g + 8 * r;
    const float row_lse = row < Sq ? lse[(size_t)qh * Sq + row] : kNegInf;
    live[r] = row_lse > kNegInf * 0.5f;
    lse2[r] = row_lse * kLog2e;
    row_delta[r] = row < Sq ? delta[(size_t)qh * Sq + row] : 0.f;
  }
  constexpr int DP = padded(D);
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

  if (n_kv > 0) mbar_wait(bar_q, 0);
  for (int j = 0; j < n_kv; ++j) {
    const int s = j % kDqStages;
    mbar_wait(full(s), (j / kDqStages) & 1);
    if (j < n_mine) {
      // s = q . k^T and dp = dO . v^T, both K-major from shared memory,
      // in one commit group
      float sc[kDqKV / 2], dp[kDqKV / 2];
#pragma unroll
      for (int i = 0; i < kDqKV / 2; ++i) sc[i] = dp[i] = 0.f;
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
      product_ss<D>(sc, q_s, kDqQ, 64 * wg, k_s(s), kDqKV);
      product_ss<D>(dp, do_s, kDqQ, 64 * wg, v_s(s), kDqKV);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);

      const int c0 = j * kDqKV;
      const bool edge = c0 + kDqKV > Sk ||
                        (is_causal && c0 + kDqKV - 1 > q_offset + r0);
#pragma unroll
      for (int i = 0; i < kDqKV / 2; ++i) {
        const int r = (i >> 1) & 1;
        bool ok = live[r];
        if (edge) {
          const int row = r0 + 16 * w + g + 8 * r;
          const int col = c0 + 8 * (i >> 2) + 2 * t + (i & 1);
          ok = ok && col < Sk && (!is_causal || q_offset + row >= col);
        }
        const float p = ok ? fast_exp2(sc[i] * scale2 - lse2[r]) : 0.f;
        sc[i] = p * (dp[i] - row_delta[r]) * scale;  // ds
      }

      // ds rounded to k's type (bf16) before ds . k; k read MN-major
      uint32_t da[kDqKV / 16][4];
      to_a(da, sc);
      fence_regs(acc);
      fence_regs(da);
      wgmma_fence();
      product_rs<DP, kDqKV / 16>(acc, da, k_s(s), kDqKV);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 16 * w + g + 8 * r;
    if (row >= Sq) continue;
    OT* drow = dq + ((size_t)qh * Sq + row) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store2(drow + 8 * n + 2 * t, acc[4 * n + 2 * r], acc[4 * n + 2 * r + 1]);
  }
}

// ---------------------------------------------------------------- launch

// Error codes above the CUDA runtime's.
constexpr int kErrNoEncoder = 1000;  // cuTensorMapEncodeTiled not found
constexpr int kErrEncode = 1001;     // cuTensorMapEncodeTiled refused a map

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up in the libcuda.so.1 the process
// already loaded (so the library needs no link against libcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr)
      fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// Map of a [heads][S][D] bf16 tensor read in boxes of 64 columns x `rows`
// rows x 1 head, 128-byte swizzled; rows past S, and columns past D (D =
// 32: the box is wider than the row), read as zeros.
int map_rows(CUtensorMap* map, const void* ptr, int heads, int S, int D,
             int rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kBox, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0
             : kErrEncode;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int D>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse,
        int B, int H, int Hkv, int Sq, int Sk, float scale, int causal,
        cudaStream_t st) {
  CUtensorMap tq, tk, tv;
  int err = map_rows(&tq, q, B * H, Sq, D, kFwdQ);
  // With Sk == 0 no kv tile is read: map q in k's and v's place.
  if (err == 0)
    err = Sk > 0 ? map_rows(&tk, k, B * Hkv, Sk, D, kFwdKV)
                 : map_rows(&tk, q, B * H, Sq, D, kFwdKV);
  if (err == 0)
    err = Sk > 0 ? map_rows(&tv, v, B * Hkv, Sk, D, kFwdKV)
                 : map_rows(&tv, q, B * H, Sq, D, kFwdKV);
  if (err != 0) return err;
  auto kernel = flash_fwd_sm90_kernel<D>;
  const size_t smem = FwdSmem<D>::bytes;
  cudaError_t cerr = allow_smem(kernel, smem);
  if (cerr != cudaSuccess) return cerr;
  kernel<<<dim3((Sq + kFwdQ - 1) / kFwdQ, H, B), kThreads, smem, st>>>(
      tq, tk, tv, static_cast<bf16*>(o), lse, H, Hkv, Sq, Sk, scale, causal);
  return cudaGetLastError();
}

template <int D, typename OT>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const float* lse, const float* delta, void* dk, void* dv, int B,
            int H, int Hkv, int Sq, int Sk, float scale, int causal,
            cudaStream_t st) {
  const size_t out_bytes = (size_t)B * Hkv * Sk * D * sizeof(OT);
  if (Sq == 0) {  // no q row: the gradients are zero
    cudaError_t cerr = cudaMemsetAsync(dk, 0, out_bytes, st);
    if (cerr == cudaSuccess) cerr = cudaMemsetAsync(dv, 0, out_bytes, st);
    return cerr;
  }
  CUtensorMap tq, tk, tv, tdo;
  int err = map_rows(&tq, q, B * H, Sq, D, kBwdQ);
  if (err == 0) err = map_rows(&tk, k, B * Hkv, Sk, D, kBwdKV);
  if (err == 0) err = map_rows(&tv, v, B * Hkv, Sk, D, kBwdKV);
  if (err == 0) err = map_rows(&tdo, dout, B * H, Sq, D, kBwdQ);
  if (err != 0) return err;
  auto kernel = flash_bwd_dkv_sm90_kernel<D, OT>;
  const size_t smem = DkvSmem<D>::bytes;
  cudaError_t cerr = allow_smem(kernel, smem);
  if (cerr != cudaSuccess) return cerr;
  const dim3 grid((Sk + kBwdKV - 1) / kBwdKV, Hkv, B);
  kernel<<<grid, kThreads, smem, st>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<OT*>(dk),
      static_cast<OT*>(dv), H, Hkv, Sq, Sk, scale, causal);
  return cudaGetLastError();
}

template <int D, typename OT>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, int B, int H,
           int Hkv, int Sq, int Sk, float scale, int causal,
           cudaStream_t st) {
  if (Sk == 0)  // no kv column: the gradient is zero
    return cudaMemsetAsync(dq, 0, (size_t)B * H * Sq * D * sizeof(OT), st);
  CUtensorMap tq, tk, tv, tdo;
  int err = map_rows(&tq, q, B * H, Sq, D, kDqQ);
  if (err == 0) err = map_rows(&tk, k, B * Hkv, Sk, D, kDqKV);
  if (err == 0) err = map_rows(&tv, v, B * Hkv, Sk, D, kDqKV);
  if (err == 0) err = map_rows(&tdo, dout, B * H, Sq, D, kDqQ);
  if (err != 0) return err;
  auto kernel = flash_bwd_dq_sm90_kernel<D, OT>;
  const size_t smem = DqSmem<D>::bytes;
  cudaError_t cerr = allow_smem(kernel, smem);
  if (cerr != cudaSuccess) return cerr;
  kernel<<<dim3((Sq + kDqQ - 1) / kDqQ, H, B), kThreads, smem, st>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<OT*>(dq), H, Hkv, Sq, Sk,
      scale, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 inputs only (f32 inputs go to flash_attention.cu). Every pointer is
// a contiguous, 16-byte aligned device buffer: q, dout [B,H,Sq,D]; k, v
// [B,Hkv,Sk,D]; lse, delta [B,H,Sq] float32; o like q; dk, dv like k in
// bf16 (out_dtype 1) or float32 (out_dtype 0). `lse` may be null in the
// forward. Each function returns 0, the cudaError_t of its launch, or one
// of the codes above; the kernels allocate nothing and do not synchronise.
int ray_tpu_torch_flash_sm90_fwd(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int B, int H, int Hkv,
                                 int Sq, int Sk, int D, float scale,
                                 int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (D == 32) return fwd<32>(q, k, v, o, l, B, H, Hkv, Sq, Sk, scale,
                              causal, st);
  if (D == 64) return fwd<64>(q, k, v, o, l, B, H, Hkv, Sq, Sk, scale,
                              causal, st);
  if (D == 128) return fwd<128>(q, k, v, o, l, B, H, Hkv, Sq, Sk, scale,
                                causal, st);
  return cudaErrorInvalidValue;
}

int ray_tpu_torch_flash_sm90_bwd_dkv(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dk, void* dv, int out_dtype, int B,
                                     int H, int Hkv, int Sq, int Sk, int D,
                                     float scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
#define RTT_DKV(D_, OT_)                                                    \
  return bwd_dkv<D_, OT_>(q, k, v, dout, l, dl, dk, dv, B, H, Hkv, Sq, Sk, \
                          scale, causal, st)
  if (D == 32 && out_dtype == 1) RTT_DKV(32, bf16);
  if (D == 32 && out_dtype == 0) RTT_DKV(32, float);
  if (D == 64 && out_dtype == 1) RTT_DKV(64, bf16);
  if (D == 64 && out_dtype == 0) RTT_DKV(64, float);
  if (D == 128 && out_dtype == 1) RTT_DKV(128, bf16);
  if (D == 128 && out_dtype == 0) RTT_DKV(128, float);
#undef RTT_DKV
  return cudaErrorInvalidValue;
}

int ray_tpu_torch_flash_sm90_bwd_dq(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dq, int out_dtype, int B, int H,
                                    int Hkv, int Sq, int Sk, int D,
                                    float scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
#define RTT_DQ(D_, OT_)                                                    \
  return bwd_dq<D_, OT_>(q, k, v, dout, l, dl, dq, B, H, Hkv, Sq, Sk,     \
                         scale, causal, st)
  if (D == 32 && out_dtype == 1) RTT_DQ(32, bf16);
  if (D == 32 && out_dtype == 0) RTT_DQ(32, float);
  if (D == 64 && out_dtype == 1) RTT_DQ(64, bf16);
  if (D == 64 && out_dtype == 0) RTT_DQ(64, float);
  if (D == 128 && out_dtype == 1) RTT_DQ(128, bf16);
  if (D == 128 && out_dtype == 0) RTT_DQ(128, float);
#undef RTT_DQ
  return cudaErrorInvalidValue;
}

const char* ray_tpu_torch_flash_sm90_error_string(int err) {
  if (err == kErrNoEncoder)
    return "cuTensorMapEncodeTiled not found in libcuda.so.1";
  if (err == kErrEncode) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
