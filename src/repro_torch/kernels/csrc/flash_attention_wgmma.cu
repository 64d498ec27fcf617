// Flash attention at head width 256 in bf16 for Hopper (sm_90a), on wgmma and
// TMA: O = softmax(Q·Kᵀ·scale + mask)·V with an online softmax, for q
// [B, Sq, H, 256] and k, v [B, Sk, Hkv, 256] bf16 (GQA when Hkv < H),
// optionally causal and/or windowed, queries aligned at Sk − Sq. The same
// function as flash_attention.cu, which runs every other (D, dtype); this
// file runs bf16 at D 256 (recurrentgemma-2b's local layers).
//
// Replaces
//   src/repro/kernels/flash_attention.py:flash_attention (the pl.pallas_call at
//   :122, body _attn_kernel at :28), which walks the kv blocks as the
//   sequential innermost grid dimension and carries the running max m, sum l
//   and accumulator acc in VMEM scratch from one grid step to the next.
//
// Design (the FlashAttention-3 shape, without its intra-warpgroup overlap)
//   A block owns 128 query rows of one (batch, head) and loops over the kv
//   tiles itself, heaviest causal tiles first. It has two warpgroups of 64
//   query rows each (256 threads, up to 255 registers a thread), and the
//   first thread also issues every copy. Two layouts with a producer beside
//   them compiled to 168 registers a thread (CUDA 12.9's ptxas): a producer
//   warpgroup that hands its registers to the consumers with setmaxnreg,
//   and a producer warp (288 threads) without it; both spilled and
//   serialized the wgmma (ptxas C7512) and ran slower. With 256 threads S's
//   k-step descriptors, S (32), P (16) and O (128) fit in registers.
//   - Q (64 KB) and each K and V tile (64 keys, 32 KB each) arrive by TMA:
//     4-D tensor maps over [B, S, heads, 256], boxes of 64 rows × 64 columns
//     (128 bytes, the 128-byte swizzle's width), so a 256-wide row is four
//     swizzled 8 KB slabs. A box never spans two batches or two heads; rows
//     past Sq or Sk are filled with zeros by the TMA unit. K and V go through
//     a 2-stage ring of 64 KB stages: a `full` mbarrier per stage that the
//     copies complete (expect_tx of 64 KB) and an `empty` mbarrier that each
//     warp arrives at when its products have read the stage. Tile j + 1 is
//     copied while tile j computes: at the top of iteration j the first
//     thread waits until every warp has released tile j − 1's stage and
//     refills it, so one warpgroup may run up to a tile ahead of the other
//     (the one's softmax overlaps the other's products).
//     Shared memory: Q 64 KB + 2 × 64 KB = 192 KB of the 227 KB.
//   - S = Q·Kᵀ: wgmma.m64n64k16 with A (this warpgroup's 64 × 256 Q) and B
//     (the 64 × 256 K tile) K-major in shared memory, 16 k-steps over D; the
//     descriptor of slab c, k-step kk starts at slab + 32·kk bytes (the
//     swizzle is a function of the address bits, so a k-step inside a
//     1024-byte-aligned swizzle atom is a plain offset).
//   - O += P·V: wgmma.m64n256k16 with P in registers (S's accumulator layout,
//     rounded to bf16 pairs, is the A-fragment layout: no shuffle) and V
//     MN-major in shared memory (the transposed B, which bf16 wgmma takes):
//     leading byte offset 8 KB between 64-column slabs, stride byte offset
//     1 KB between 8-key groups; 4 k-steps of 16 keys.
//   - O stays in registers (64 × 256 f32 over 128 threads: 128 a thread),
//     beside S (32) and P (16). The softmax runs in log2 units (scores times
//     scale·log2 e, then exp2) on the accumulator layout, the row max and sum
//     reducing over the 4 lanes of a quad with xor shuffles in a fixed order;
//     every product sums in a fixed order, so repeated calls are bit-equal.
//   - The loop bounds (kv_lo, kv_hi) take the place of the Pallas kernel's
//     pl.when block skip; inside them a warpgroup skips a tile none of its
//     rows sees, and a warp evaluates the element mask (k < Sk, causal
//     k <= q, window k > q − W; the finite -1e30) only on a tile that an
//     edge cuts for its rows. l is clamped at 1e-30. The Sq edge is masked
//     at the store.
//   Each warpgroup waits for its S product before its softmax and for its PV
//   product before releasing the stage: the two warpgroups overlap each
//   other's softmax with their products, but not their own. FlashAttention-3's
//   intra-warpgroup overlap (tile j's S product and softmax beside tile
//   j − 1's P·V) was tried with separate K and V rings: ptxas serialized its
//   wgmma (C7513, C7518) and it ran slower.
//
// Bound at recurrentgemma-2b's prefill shape (B 4, S 2048, H 10, Hkv 1, D 256,
// causal, window 2048: 83,927,040 visible pairs × 4·D = 85.9 GFLOP)
//   tensor cores: 85.9 GFLOP / 989 TFLOP/s bf16 = 0.087 ms; HBM: q, k, v and
//   o are 92 MB in bf16, 0.028 ms. The kernel is bound by its arithmetic.

#include <cuda.h>  // CUtensorMap and cuTensorMapEncodeTiled's types; no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;         // the Pallas kernel's NEG_INF
constexpr int kD = 256;                   // head width
constexpr int kBQ = 128;                  // query rows a block: 2 warpgroups × 64
constexpr int kBK = 64;                   // keys a tile
constexpr int kStages = 2;                // tiles in the K/V ring
constexpr int kThreads = 256;             // 2 warpgroups of 64 query rows
constexpr int kSlab = 64 * 64 * 2;        // one TMA box: 64 rows × 128 bytes
constexpr int kQWG = 4 * kSlab;           // one warpgroup's Q: 64 rows × 256
constexpr int kTileBytes = 4 * kSlab;     // K or V: 64 keys × 256
constexpr int kStageBytes = 2 * kTileBytes;
constexpr int kQBytes = 2 * kQWG;  // both warpgroups' Q
constexpr int kBarOff = kQBytes + kStages * kStageBytes;
constexpr int kSmem = kBarOff + 64 + 1024;  // + 5 mbarriers, + slack to align to 1 KB

// V's descriptor offsets (bytes): between 64-column slabs, between 8-key groups
constexpr uint32_t kVLbo = kBK * 128, kVSbo = 1024;

// S[64 × 64] = A·Bᵀ (accumulate 0) or S += A·Bᵀ, A and B K-major bf16 in shared memory
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t da, uint64_t db,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// O[64 × 256] += P·V: P bf16 in registers (per warp the m16n8k16 A
// layout), V MN-major in shared memory (the transposed B)
__device__ __forceinline__ void wgmma_rs_m64n256k16(float (&d)[128], const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
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
// keep the compiler from moving reads or writes of an accumulator across the
// asynchronous product (the registers are the product's until its wait)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// a shared-memory matrix descriptor: 128-byte swizzle, offsets in bytes
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// wait until the barrier's phase of this parity has completed; a wait of
// over 2^36 cycles (about 35 s) can only be a fault, and traps: the launch
// then fails instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long start = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1ll << 36)) __trap();
  } while (!done);
}
// one box of a 4-D tensor map (coordinates innermost first) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__global__ void __launch_bounds__(kThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap,
                             __nv_bfloat16* __restrict__ o, int sq, int sk, int h, int hkv,
                             int causal, int window, float scale) {
  extern __shared__ unsigned char smem_raw[];
  // the swizzle atoms (8 rows × 128 bytes) must start on 1024-byte boundaries
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) & ~1023u;
  const uint32_t q_s = base, ring_s = base + kQBytes, bar_s = base + kBarOff;
  auto full = [&](int st) { return bar_s + 8u * st; };
  auto empty = [&](int st) { return bar_s + 8u * (kStages + st); };
  const uint32_t q_bar = bar_s + 8u * 2 * kStages;

  const int tid = threadIdx.x, wg = tid / 128;  // this thread's warpgroup
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int b = blockIdx.y / h, hq = blockIdx.y % h;
  const int hk = hq / (h / hkv);
  const int q0 = qt * kBQ, off = sk - sq;
  // keys visible to some query of the block
  const int q_first = q0 + off, q_last = min(q0 + kBQ, sq) - 1 + off;
  const int kv_lo = window > 0 ? max(0, q_first - window + 1) : 0;
  const int kv_hi = causal ? min(sk, q_last + 1) : sk;
  const int n_tiles = kv_hi > kv_lo ? (kv_hi - kv_lo + kBK - 1) / kBK : 0;

  // the K and V tile j into its stage (by the first thread)
  auto load_tile = [&](int j) {
    const int st = j % kStages, k0 = kv_lo + j * kBK;
    const uint32_t ks = ring_s + st * kStageBytes, vs = ks + kTileBytes;
    mbar_expect_tx(full(st), kStageBytes);
    for (int c = 0; c < 4; ++c) {
      tma_load(ks + c * kSlab, &kmap, full(st), 64 * c, hk, k0, b);
      tma_load(vs + c * kSlab, &vmap, full(st), 64 * c, hk, k0, b);
    }
  };
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 8);  // every warp
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(q_bar, kQBytes);
    for (int w = 0; w < 2; ++w)
      for (int c = 0; c < 4; ++c)
        tma_load(q_s + w * kQWG + c * kSlab, &qmap, q_bar, 64 * c, hq, q0 + 64 * w, b);
    if (n_tiles > 0) load_tile(0);
  }
  __syncthreads();

  {
    // ---- 64 query rows a warpgroup, 16 a warp
    const int warp = (tid & 127) >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int wq0 = q0 + 64 * wg;  // this warpgroup's first query row
    const bool live = wq0 < sq;
    const int wg_first = wq0 + off, wg_last = min(wq0 + 63, sq - 1) + off;
    const int r0 = wq0 + 16 * warp + g, r1 = r0 + 8;  // this lane's two query rows
    const int wp_first = wq0 + 16 * warp + off;
    const int wp_last = min(wq0 + 16 * warp + 15, sq - 1) + off;
    const uint32_t qa = q_s + wg * kQWG;
    const float scale_log2 = scale * 1.4426950408889634f;

    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    mbar_wait(q_bar, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % kStages;
      const int k0 = kv_lo + j * kBK;
      if (tid == 0 && j + 1 < n_tiles) {  // refill tile j − 1's stage with tile j + 1
        if (j >= 1) mbar_wait(empty((j + 1) % kStages), ((j - 1) / kStages) & 1);
        load_tile(j + 1);
      }
      mbar_wait(full(st), (j / kStages) & 1);
      const bool skip = !live || (causal && k0 > wg_last) ||
                        (window > 0 && k0 + kBK - 1 <= wg_first - window);
      if (!skip) {  // uniform over the warpgroup, as wgmma needs
        const uint32_t ks = ring_s + st * kStageBytes, vs = ks + kTileBytes;
        // ---- S = Q·Kᵀ: 64 rows × 64 keys, 16 k-steps over D
        float s[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = 0.f;  // the first k-step overwrites them
        fence_regs(s);
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss_m64n64k16(s, desc_sw128(qa + c * kSlab + 32 * kk, 16, 1024),
                               desc_sw128(ks + c * kSlab + 32 * kk, 16, 1024), c + kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);

        // ---- online softmax on the accumulator layout: s[4n + e] is row
        // g + 8·(e / 2), key 8n + 2t + e % 2 of the tile
        const bool masked = k0 + kBK > sk || (causal && k0 + kBK - 1 > wp_first) ||
                            (window > 0 && k0 <= wp_last - window);
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          float x = s[i] * scale_log2;
          if (masked) {
            const int kpos = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
            const int qpos = ((i & 2) ? r1 : r0) + off;
            bool ok = kpos < sk;
            if (causal) ok = ok && kpos <= qpos;
            if (window > 0) ok = ok && kpos > qpos - window;
            x = ok ? x : kNegInf;
          }
          s[i] = x;
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
        }
        float corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m[r], mx[r]);
          corr[r] = exp2f(m[r] - m_new);
          m[r] = m_new;
        }
        float rs[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const float p = exp2f(s[i] - m[(i >> 1) & 1]);
          s[i] = p;
          rs[(i >> 1) & 1] += p;
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = corr[r] * l[r] + rs[r];
#pragma unroll
        for (int i = 0; i < 128; ++i) acc[i] *= corr[(i >> 1) & 1];
        // P as the A fragments of 4 k-steps of 16 keys
        uint32_t pa[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
          pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
          pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
          pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
        }

        // ---- O += P·V: 64 rows × 256 columns, 4 k-steps of 16 keys
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs_m64n256k16(acc, pa[kk], desc_sw128(vs + 2048 * kk, kVLbo, kVSbo));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));  // this warp is done with the stage
    }

    if (live) {
      const long long q_row = (long long)h * kD;
      __nv_bfloat16* ob = o + (long long)b * sq * q_row + (long long)hq * kD;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float lt = l[r];
        lt += __shfl_xor_sync(0xffffffffu, lt, 1);
        lt += __shfl_xor_sync(0xffffffffu, lt, 2);
        lt = fmaxf(lt, 1e-30f);
        const int qi = r == 0 ? r0 : r1;
        if (qi >= sq) continue;
#pragma unroll
        for (int n = 0; n < 32; ++n) {
          __nv_bfloat16* dst = ob + qi * q_row + 8 * n + 2 * t;
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(acc[4 * n + 2 * r] / lt, acc[4 * n + 2 * r + 1] / lt);
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver call: reached through the runtime's
// entry-point query, so the library needs no -lcuda
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a 4-D map over a contiguous bf16 [batch, seq, heads, 256], in boxes of
// 64 columns × 1 head × 64 rows × 1 batch, 128-byte swizzled, zeros past the edges
int make_map(CUtensorMap* map, const void* ptr, int batch, int seq, int heads) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t row = (cuuint64_t)kD * 2;
  cuuint64_t dims[4] = {(cuuint64_t)kD, (cuuint64_t)heads, (cuuint64_t)seq, (cuuint64_t)batch};
  cuuint64_t strides[3] = {row, row * heads, row * heads * seq};
  cuuint32_t box[4] = {64, 1, 64, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                   strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : cudaErrorInvalidValue;
}

}  // namespace

// Dynamic shared memory of one block.
extern "C" int awb_flash_attention_wgmma_smem() { return kSmem; }

// q, o: contiguous [b, sq, h, 256]; k, v: contiguous [b, sk, hkv, 256]; all
// bfloat16, each 16-byte aligned (TMA). window <= 0 means no window. Returns
// the cudaError_t of the tensor maps' encoding and the launch.
extern "C" int awb_flash_attention_wgmma(const void* q, const void* k, const void* v,
                                         void* o, int b, int sq, int sk, int h, int hkv,
                                         int d, int causal, int window, float scale,
                                         void* stream) {
  if (d != kD || b <= 0 || sq <= 0 || sk <= 0 || h <= 0 || hkv <= 0 || h % hkv != 0)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16 != 0)
    return cudaErrorMisalignedAddress;
  CUtensorMap qmap, kmap, vmap;
  int err = make_map(&qmap, q, b, sq, h);
  if (!err) err = make_map(&kmap, k, b, sk, hkv);
  if (!err) err = make_map(&vmap, v, b, sk, hkv);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(flash_attention_wgmma_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return e;
  dim3 grid((sq + kBQ - 1) / kBQ, b * h);
  flash_attention_wgmma_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(o), sq, sk, h, hkv, causal, window, scale);
  return cudaGetLastError();
}
