// Flash attention for Hopper (sm_90a): O = softmax(Q·Kᵀ·scale + mask)·V with an
// online softmax, for q [B, Sq, H, D] and k, v [B, Sk, Hkv, D] (GQA when
// Hkv < H), optionally causal and/or windowed, queries aligned at Sk − Sq.
//
// Replaces
//   src/repro/kernels/flash_attention.py:flash_attention (the pl.pallas_call at
//   :122, body _attn_kernel at :28), which walks the kv blocks as the
//   sequential innermost grid dimension and carries the running max m, sum l
//   and accumulator acc in VMEM scratch from one grid step to the next.
//
// Design (the FlashAttention-2 scheme on mma.sync tensor-core tiles)
//   One block of 4 warps owns a (batch·head, 64-query tile) and loops over
//   the kv tiles itself, heaviest causal tiles first. Each warp owns 16 query
//   rows. Its running m, l and O live in registers in the mma accumulator
//   layout: lane (g = lane/4, t = lane%4) holds rows g and g+8, columns 2t and
//   2t+1 of every 8-wide block. Row max and row sum reduce over the 4 lanes
//   of a quad with xor shuffles in a fixed order, and every output element is
//   summed in a fixed order, so repeated calls are bit-equal.
//
//   The loop bounds (kv_lo, kv_hi) take the place of the Pallas kernel's
//   pl.when block skip. Inside them a warp skips a tile that none of its rows
//   sees, and evaluates the element mask (k < Sk, causal k <= q, window
//   k > q − W; the Pallas kernel's finite -1e30) only on a tile that the Sk
//   edge, the causal diagonal or the window edge cuts for its rows. l is
//   clamped at 1e-30 as in the Pallas kernel.
//
//   f32 runs 3xTF32 on mma.sync.m16n8k8.tf32: every operand x is split into
//   hi = tf32(x) and lo = tf32(x − hi), rounded as cvt.rna.tf32.f32 rounds
//   (ties away; done with an integer add and mask, the same bits in fewer
//   instructions; a NaN passes into hi as it is), and each product is
//   lo·hi + hi·lo + hi·hi with f32 accumulation, as accurate as a plain f32
//   product (the dropped lo·lo is below 2^-22 of it). Each tile's P·V sums
//   from zero in its own accumulator and joins O with one rounded f32 add,
//   since the tensor core's own accumulation is not round-to-nearest and its
//   error would otherwise grow with the number of tiles. Q is split once
//   into registers at D 16/32/64; at D 128 its hi and lo fragments alone
//   would take 128 registers a thread, so Q stays in shared memory and each
//   k-step's fragment is read and split there. K and V are split once per
//   block: each thread splits the 16-byte chunks it copied itself, writing
//   hi in place and lo beside it. bf16 runs
//   mma.sync.m16n8k16.bf16 with f32 accumulation on the same skeleton, with
//   P rounded to bf16 for the PV product. The softmax runs in log2 units
//   (scores times scale·log2 e, then exp2).
//
//   P stays in registers. In bf16 the m16n8k16 accumulator layout of S is the
//   A-fragment layout of PV, so P is only packed to bf16 pairs. In tf32
//   (m16n8k8) it is not: a lane holds S columns 2t and 2t+1, and the A
//   fragment wants k indices t and t+4. Since PV sums over keys, the kernel
//   reads V's rows in the same permuted order instead (k index t is key 2t,
//   k index t+4 is key 2t+1 of each 8-key group): no shuffle, no data moved.
//   QKᵀ sums over columns, so Q and K take the same permutation of each
//   8-column group, and a lane's two K values are one 64-bit read.
//
//   K and V tiles go through a 2-stage ring in shared memory, filled with
//   16-byte cp.async.cg: tile j+1 is copied while tile j computes (a third
//   stage measured no faster). One barrier a tile publishes tile j and frees
//   the stage that tile j+1 refills. The ragged last tile is
//   zero-filled through cp.async's src-size operand and masked. K/V are read
//   in place at row stride Hkv·D (no padded or transposed copy, no GQA
//   replication: query head h reads kv head h / (H/Hkv)). Rows of 16-byte
//   chunks are XOR-swizzled (see Geo::at), so that the fragment reads of a
//   warp — 64-bit K and Q reads of 4 rows a half-warp, 32-bit tf32 V reads of
//   rows 2t or 2t+1, 32-bit bf16 K reads of 8 rows, and ldmatrix.trans of 8
//   rows for bf16 V — hit distinct banks (at D 16 f32, whose rows are 4
//   chunks wide, some reads keep a 2-way conflict).
//
// Tiles, shared memory and registers (64 queries × BK keys a tile; ptxas's
// counts, which chip_smoke.py prints as `flash_registers`)
//   f32  BK 64 at D 16/32, 32 at D 64/128. Shared memory: 2 stages of K and V
//        hi and lo (16·BK·D bytes a stage), plus Q (32 KB) at D 128: 32, 64,
//        64 and 160 KB at D 16/32/64/128. At D 64 a thread holds Q hi/lo (64
//        registers), O and the tile's P·V (32 each) and S (16); ptxas gives
//        it over 240 registers, so 2 blocks (8 warps) run on an SM.
//   bf16 BK 64 at every D: 2 stages of K and V (256·D bytes a stage: 8 to
//        64 KB). At D 64: Q 16, O 32, S 32 registers; ptxas gives it about
//        160, so 3 blocks run on an SM.
//   D 256, f32 only (recurrentgemma's local layers; bf16 at D 256 runs the
//        wgmma kernel of flash_attention_wgmma.cu): one warp cannot hold a
//        16-row O of 256 columns beside its P·V tile (256 f32 registers a
//        thread), nor can 32-key f32 stages fit (two of 128 KB, plus Q's 64
//        KB). So each 16 query rows get a pair of warps (8 warps, 256 threads
//        a block), each owning half of O's columns for P·V. Each warp of the
//        pair computes S's partial over its half of D (128 columns); the two
//        partials meet in a small shared buffer behind a named barrier for
//        the pair's 64 threads (bar.sync 1 + row group, 64), and each warp
//        adds the other's partial to its own: f32 addition commutes, so both
//        hold the same bits of S, and m and l stay equal. Q·Kᵀ is done once
//        per pair (computing all of S in both warps costs 1.5× the
//        arithmetic of one warp a row group). BK 16, Q in shared memory as at D 128; 2 stages of 64
//        KB plus Q's 64 KB plus the 8 KB exchange = 200 KB, and a thread holds
//        O and the tile's P·V (64 registers each) as at D 128. One block (8
//        warps) runs on an SM. wgmma's tf32 (the route the bf16 kernel takes)
//        would need V K-major, so a transposed copy of every V tile, and its
//        3xTF32 hi/lo operands twice the bytes of a tile: two stages of that
//        beside a 64 KB Q do not fit in 227 KB, so f32 stays on mma.sync.
//   __launch_bounds__ asks for 1 block per SM: left to itself ptxas caps the
//   registers lower, which measured slower in bf16 and at D 128.
//
// Bounds at the main path's prefill shape (B 4, S 2048, H 14, Hkv 2, D 64,
// causal: 117,497,856 visible pairs × 4·D = 30.08 GFLOP; q, k, v and o are
// 67 MB in f32)
//   CUDA-core f32: 30.08 GFLOP / 67 TFLOP/s = 0.449 ms;
//   tensor cores, the arithmetic issued: 3 × 30.08 GFLOP / 495 TFLOP/s TF32
//   = 0.182 ms in f32 (3xTF32), 30.08 GFLOP / 989 TFLOP/s = 0.030 ms in bf16;
//   softmax exponentials: 1.175e8 ex2 at 16 per SM per clock, 0.028 ms at
//   1.98 GHz, which ties with the bf16 bound; HBM: 0.020 ms in f32. mma.sync
//   reaches about half of the tensor-core rate on Hopper, and the split,
//   softmax and copies overlap it only in part (PERF.md has the times);
//   wgmma and TMA with an mbarrier ring are the route to the full bf16 rate,
//   not taken here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;  // the Pallas kernel's NEG_INF
constexpr int kBQ = 64;            // query rows per block: 4 row groups of 16

// x rounded to tf32, 10 mantissa bits with ties away from zero: the bits
// cvt.rna.tf32.f32 gives for x that is not NaN, with an integer add and mask
// (ptxas lowers the cvt to a longer sequence)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// hi = tf32(x), lo = tf32(x - hi). A NaN passes into hi as it is: the add
// would carry the mantissa of the card's canonical NaN 0x7fffffff into the
// sign bit and make it -0, and a NaN in q, k, v or P must reach the output,
// as in the plain version. Every product with a NaN hi is NaN, so lo needs
// no such care.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = isnan(x) ? __float_as_uint(x) : tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}
__device__ __forceinline__ float4 split4(float4 x, float4& lo) {
  uint32_t h[4], l[4];
  split(x.x, h[0], l[0]);
  split(x.y, h[1], l[1]);
  split(x.z, h[2], l[2]);
  split(x.w, h[3], l[3]);
  lo = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]),
                   __uint_as_float(l[3]));
  return make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                     __uint_as_float(h[3]));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// c[n] += a·b[n] for n < N in 3xTF32: the small terms first, then hi·hi,
// pass by pass, so that consecutive mma write different accumulators
template <int N>
__device__ __forceinline__ void mma_3xtf32(float (*c)[4], const uint32_t ah[4],
                                           const uint32_t al[4], uint32_t (*bh)[2],
                                           uint32_t (*bl)[2]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[n], al, bh[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[n], ah, bl[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[n], ah, bh[n]);
}
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b0, const uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16 bytes global -> shared; src_bytes 0 fills the chunk with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's newest copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T, int D>
struct Geo {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kSplit = D > 128 ? 2 : 1;          // warps a row group
  static constexpr int kThreads = 128 * kSplit;           // 4 row groups
  static constexpr int kBK = kF32 && D > 128 ? 16 : kF32 && D >= 64 ? 32 : 64;  // keys a tile
  static constexpr int kStages = 2;                       // tiles in the K/V ring
  static constexpr int kEPC = 16 / sizeof(T);             // elements a 16-byte chunk
  static constexpr int kR = D / kEPC;                     // chunks a row
  static constexpr int kRPL = kR >= 8 ? 1 : 8 / kR;       // rows a 128-byte line
  static constexpr int kMask = (kR >= 8 ? 8 : kR) - 1;
  static constexpr bool kQSmem = kF32 && D > 64;          // Q from shared, split per use
  // a stage: K (hi, lo) then V (hi, lo) in f32; K then V in bf16
  static constexpr int kTile = kBK * D;
  static constexpr int kVOff = (kF32 ? 2 : 1) * kTile;
  static constexpr int kStage = 2 * kVOff;
  static constexpr size_t kQBytes = kQSmem ? kBQ * D * sizeof(float) : 0;
  static constexpr size_t kRingBytes = kStages * kStage * sizeof(T);
  // a pair's exchange of S partials: each warp's 16 × BK floats
  static constexpr size_t kXBytes = kSplit > 1 ? kThreads / 32 * 16 * kBK * sizeof(float) : 0;
  static constexpr size_t kSmem = kQBytes + kRingBytes + kXBytes;
  static constexpr int kChunks = kBK * kR / kThreads;    // K (and V) chunks a thread copies
  static_assert(kBK * kR % kThreads == 0, "a tile splits evenly over the threads");

  // element offset of (row, col) in a swizzled [rows][D] tile: chunk c of
  // line-row r moves to c ^ r in bf16, and to c ^ 2·h(r) in f32, where h is
  // one-to-one on every 4 consecutive rows and on every 4 rows of one parity
  // (the rows that 64-bit K reads and tf32 V reads touch together)
  __device__ static __forceinline__ int at(int row, int col) {
    const int r = row / kRPL;
    const int f = kF32 ? 2 * ((r & 3) ^ ((r >> 2) & 1)) : r;
    const int chunk = (col / kEPC) ^ (f & kMask);
    return row * D + chunk * kEPC + col % kEPC;
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(Geo<T, D>::kThreads, 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int sq, int sk,
                       int h, int hkv, int causal, int window, float scale) {
  using G = Geo<T, D>;
  static_assert(G::kF32 || G::kSplit == 1, "bf16 at D 256 runs flash_attention_wgmma.cu");
  constexpr bool kF32 = G::kF32;
  constexpr int BK = G::kBK, NB = BK / 8, ND = D / 8;
  constexpr int kThreads = G::kThreads;
  constexpr int NDW = ND / G::kSplit;  // 8-column blocks of O this warp owns
  extern __shared__ __align__(16) unsigned char smem[];
  float* qsm = reinterpret_cast<float*>(smem);  // [kBQ][D] Q (D 128 f32)
  T* ring = reinterpret_cast<T*>(smem + G::kQBytes);
  float* xbuf = reinterpret_cast<float*>(smem + G::kQBytes + G::kRingBytes);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = warp / G::kSplit;         // this warp's row group
  const int c0 = warp % G::kSplit * NDW;   // its first 8-column block of O
  // the columns of Q·Kᵀ it sums over start at column kc: a whole number of
  // 8-chunk lines, so (as for V below) the offset adds to a swizzled index
  constexpr int NDS = ND / G::kSplit;
  const int kc = warp % G::kSplit * (D / G::kSplit);
  const int g = lane >> 2, t = lane & 3;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int b = blockIdx.y / h, hq = blockIdx.y % h;
  const int hk = hq / (h / hkv);
  const int q0 = qt * kBQ;
  const int off = sk - sq;

  const long long q_row = (long long)h * D, kv_row = (long long)hkv * D;
  const T* qb = q + (long long)b * sq * q_row + (long long)hq * D;
  const T* kb = k + (long long)b * sk * kv_row + (long long)hk * D;
  const T* vb = v + (long long)b * sk * kv_row + (long long)hk * D;
  T* ob = o + (long long)b * sq * q_row + (long long)hq * D;

  const int wq0 = q0 + 16 * rg;  // this warp's first query row
  const bool warp_live = wq0 < sq;
  const int wp_first = wq0 + off, wp_last = min(wq0 + 15, sq - 1) + off;
  const int r0 = wq0 + g, r1 = r0 + 8;  // this lane's two query rows

  // ---- Q: A fragments in registers, or the raw tile in shared memory (f32, D > 64)
  constexpr int kQFrags = G::kQSmem ? 1 : (kF32 ? ND : D / 16);
  uint32_t qh[kQFrags][4], ql[kF32 ? kQFrags : 1][4];
  if constexpr (G::kQSmem) {
    for (int c = tid; c < kBQ * G::kR; c += kThreads) {
      const int r = c / G::kR, col = (c % G::kR) * 4, qi = q0 + r;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (qi < sq) x = *reinterpret_cast<const float4*>(qb + qi * q_row + col);
      *reinterpret_cast<float4*>(qsm + G::at(r, col)) = x;
    }
  } else if constexpr (kF32) {
#pragma unroll
    for (int ks = 0; ks < ND; ++ks) {
      // k index t is column 2t of the 8-column group and t+4 is 2t+1, for Q
      // and K alike (QKᵀ sums over columns), so K's pair is one 64-bit read
      const int col = 8 * ks + 2 * t;
      const float2 zero = make_float2(0.f, 0.f);
      const float2 x0 = r0 < sq ? *reinterpret_cast<const float2*>(qb + r0 * q_row + col) : zero;
      const float2 x1 = r1 < sq ? *reinterpret_cast<const float2*>(qb + r1 * q_row + col) : zero;
      split(x0.x, qh[ks][0], ql[ks][0]);
      split(x1.x, qh[ks][1], ql[ks][1]);
      split(x0.y, qh[ks][2], ql[ks][2]);
      split(x1.y, qh[ks][3], ql[ks][3]);
    }
  } else {
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const int rows[4] = {r0, r1, r0, r1}, cols[4] = {16 * ks + 2 * t, 16 * ks + 2 * t,
                                                       16 * ks + 8 + 2 * t,
                                                       16 * ks + 8 + 2 * t};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        qh[ks][e] = rows[e] < sq ? *reinterpret_cast<const uint32_t*>(
                                       qb + rows[e] * q_row + cols[e])
                                 : 0u;
    }
  }

  // keys visible to some query of the tile
  const int q_first = q0 + off;
  const int q_last = min(q0 + kBQ, sq) - 1 + off;
  const int kv_lo = window > 0 ? max(0, q_first - window + 1) : 0;
  const int kv_hi = causal ? min(sk, q_last + 1) : sk;
  const int n_tiles = kv_hi > kv_lo ? (kv_hi - kv_lo + BK - 1) / BK : 0;

  auto stage = [&](int tile) { return ring + tile % G::kStages * G::kStage; };
  // copy the K and V tile starting at key k0 into a stage; rows past Sk are zeros
  auto load_tile = [&](int k0, T* st) {
#pragma unroll
    for (int n = 0; n < G::kChunks; ++n) {
      const int c = tid + n * kThreads;
      const int r = c / G::kR, col = (c % G::kR) * G::kEPC, kj = k0 + r;
      const long long src = (long long)(kj < sk ? kj : 0) * kv_row + col;
      const int bytes = kj < sk ? 16 : 0;
      cp_async16(st + G::at(r, col), kb + src, bytes);
      cp_async16(st + G::kVOff + G::at(r, col), vb + src, bytes);
    }
  };
  // split the chunks this thread copied into a stage: hi in place, lo beside
  auto split_tile = [&](T* st) {
    if constexpr (kF32) {
#pragma unroll
      for (int n = 0; n < G::kChunks; ++n) {
        const int c = tid + n * kThreads;
        const int i = G::at(c / G::kR, (c % G::kR) * 4);
#pragma unroll
        for (int part = 0; part < 2; ++part) {
          float* hi = st + part * G::kVOff + i;
          float4 lo;
          *reinterpret_cast<float4*>(hi) = split4(*reinterpret_cast<float4*>(hi), lo);
          *reinterpret_cast<float4*>(hi + G::kTile) = lo;
        }
      }
    }
  };

  const float scale_log2 = scale * 1.4426950408889634f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, acc[NDW][4];
#pragma unroll
  for (int nd = 0; nd < NDW; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

  // tile j+1 is copied while tile j computes
  if (n_tiles > 0) load_tile(kv_lo, stage(0));
  cp_async_commit();
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = kv_lo + j * BK;
    T* st = stage(j);
    cp_async_wait<0>();  // this thread's copies of tile j have landed
    split_tile(st);
    __syncthreads();  // tile j is ready, and every warp is done with tile j-1
    if (j + 1 < n_tiles) load_tile(k0 + BK, stage(j + 1));
    cp_async_commit();
    if (!warp_live) continue;
    if ((causal && k0 > wp_last) || (window > 0 && k0 + BK - 1 <= wp_first - window))
      continue;  // no row of this warp sees a key of the tile
    const bool masked = k0 + BK > sk || (causal && k0 + BK - 1 > wp_first) ||
                        (window > 0 && k0 <= wp_last - window);

    // ---- S = Q·Kᵀ for the warp's 16 rows × BK keys
    float s[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
    if constexpr (kF32) {
      const float* kh = st + kc;
      const float* kl = st + G::kTile + kc;
#pragma unroll
      for (int ks = 0; ks < NDS; ++ks) {
        uint32_t ah[4], al[4];
        if constexpr (G::kQSmem) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {  // rows g and g+8
            const int i = G::at(16 * rg + g + 8 * half, 8 * ks + 2 * t) + kc;
            const float2 x = *reinterpret_cast<const float2*>(qsm + i);
            split(x.x, ah[half], al[half]);
            split(x.y, ah[half + 2], al[half + 2]);
          }
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ah[e] = qh[ks][e];
            al[e] = ql[ks][e];
          }
        }
        uint32_t bh[NB][2], bl[NB][2];
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          const int i = G::at(8 * nb + g, 8 * ks + 2 * t);
          const float2 h2 = *reinterpret_cast<const float2*>(kh + i);
          const float2 l2 = *reinterpret_cast<const float2*>(kl + i);
          bh[nb][0] = __float_as_uint(h2.x);
          bh[nb][1] = __float_as_uint(h2.y);
          bl[nb][0] = __float_as_uint(l2.x);
          bl[nb][1] = __float_as_uint(l2.y);
        }
        mma_3xtf32<NB>(s, ah, al, bh, bl);
      }
      if constexpr (G::kSplit > 1) {
        // the pair's partials over its two halves of D: each warp publishes
        // its own, waits for its partner's and adds it (own + other in one
        // warp, other + own in the other: the same bits)
        float4* mine = reinterpret_cast<float4*>(xbuf) + warp * NB * 32 + lane;
        const float4* other = reinterpret_cast<const float4*>(xbuf) +
                              (warp ^ 1) * NB * 32 + lane;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          mine[nb * 32] = make_float4(s[nb][0], s[nb][1], s[nb][2], s[nb][3]);
        asm volatile("bar.sync %0, 64;\n" ::"r"(1 + rg) : "memory");
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          const float4 x = other[nb * 32];
          s[nb][0] += x.x;
          s[nb][1] += x.y;
          s[nb][2] += x.z;
          s[nb][3] += x.w;
        }
      }
    } else {
      const T* ks_ = st;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          const int row = 8 * nb + g;
          mma_bf16(s[nb], qh[ks],
                   *reinterpret_cast<const uint32_t*>(ks_ + G::at(row, 16 * ks + 2 * t)),
                   *reinterpret_cast<const uint32_t*>(ks_ + G::at(row, 16 * ks + 8 + 2 * t)));
        }
    }

    // ---- online softmax on the accumulator layout (rows g and g+8), in
    // log2 units: exp(x) = exp2(x·log2 e), one multiply before each ex2
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nb][e] * scale_log2;
        if (masked) {
          const int kpos = k0 + 8 * nb + 2 * t + (e & 1);
          const int qpos = (e < 2 ? r0 : r1) + off;
          bool ok = kpos < sk;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && kpos > qpos - window;
          x = ok ? x : kNegInf;
        }
        s[nb][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nb][e] - m[e >> 1]);
        s[nb][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = corr[i] * l[i] + rs[i];
#pragma unroll
    for (int nd = 0; nd < NDW; ++nd) {
      acc[nd][0] *= corr[0];
      acc[nd][1] *= corr[0];
      acc[nd][2] *= corr[1];
      acc[nd][3] *= corr[1];
    }

    // ---- O += P·V with P in registers
    // this warp's columns of V start 8·c0 elements into each row: the
    // swizzle permutes only the low 3 bits of a row's chunk index, and 8·c0
    // is a whole number of 8-chunk lines, so the offset is additive and the
    // fragment offsets below stay compile-time functions of (nd, g, t)
    if constexpr (kF32) {
      const float* vh = st + G::kVOff + 8 * c0;
      const float* vl = vh + G::kTile;
      // the tile's P·V sums from zero and joins O in one rounded f32 add:
      // the tensor core's own accumulation is not round-to-nearest, and
      // summed over every tile of a 2048-key row its error grows with the
      // number of tiles
      float pv[NDW][4] = {};
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        // k index t is key 2t of the group and t+4 is key 2t+1: the
        // accumulator's own columns, with V's rows read in the same order
        const float pa[4] = {s[nb][0], s[nb][2], s[nb][1], s[nb][3]};
        uint32_t ph[4], pl[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split(pa[e], ph[e], pl[e]);
        const int ra = 8 * nb + 2 * t;
        constexpr int NG = NDW < 4 ? NDW : 4;  // output blocks a group of mma
#pragma unroll
        for (int nd0 = 0; nd0 < NDW; nd0 += NG) {
          uint32_t bh[NG][2], bl[NG][2];
#pragma unroll
          for (int n = 0; n < NG; ++n) {
            const int i0 = G::at(ra, 8 * (nd0 + n) + g), i1 = G::at(ra + 1, 8 * (nd0 + n) + g);
            bh[n][0] = __float_as_uint(vh[i0]);
            bh[n][1] = __float_as_uint(vh[i1]);
            bl[n][0] = __float_as_uint(vl[i0]);
            bl[n][1] = __float_as_uint(vl[i1]);
          }
          mma_3xtf32<NG>(pv + nd0, ph, pl, bh, bl);
        }
      }
#pragma unroll
      for (int nd = 0; nd < NDW; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nd][e] += pv[nd][e];
    } else {
      const T* vs = st + G::kVOff + 8 * c0;
      const int mat = lane >> 3;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t pa[4] = {
            pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const int row = 16 * kk + (mat & 1) * 8 + (lane & 7);
#pragma unroll
        for (int nd = 0; nd < NDW; nd += 2) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vs + G::at(row, (nd + (mat >> 1)) * 8));
          mma_bf16(acc[nd], pa, bv[0], bv[1]);
          mma_bf16(acc[nd + 1], pa, bv[2], bv[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  if (!warp_live) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float lt = l[i];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    lt = fmaxf(lt, 1e-30f);
    const int qi = i == 0 ? r0 : r1;
    if (qi >= sq) continue;
#pragma unroll
    for (int nd = 0; nd < NDW; ++nd) {
      const float x = acc[nd][2 * i] / lt, y = acc[nd][2 * i + 1] / lt;
      T* dst = ob + qi * q_row + 8 * (c0 + nd) + 2 * t;
      if constexpr (kF32)
        *reinterpret_cast<float2*>(dst) = make_float2(x, y);
      else
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x, y);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b, int sq,
           int sk, int h, int hkv, int causal, int window, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = Geo<T, D>::kSmem;
  auto kern = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + kBQ - 1) / kBQ, b * h);
  kern<<<grid, Geo<T, D>::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), sq, sk, h, hkv, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int b, int sq,
             int sk, int h, int hkv, int d, int causal, int window, float scale,
             cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, b, sq, sk, h, hkv, causal, window, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, b, sq, sk, h, hkv, causal, window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, b, sq, sk, h, hkv, causal, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, b, sq, sk, h, hkv, causal, window, scale, stream);
    case 256:  // bf16 at D 256 is flash_attention_wgmma.cu's
      if constexpr (std::is_same<T, float>::value)
        return launch<T, 256>(q, k, v, o, b, sq, sk, h, hkv, causal, window, scale, stream);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int smem_bytes(int d) {
  switch (d) {
    case 16: return (int)Geo<T, 16>::kSmem;
    case 32: return (int)Geo<T, 32>::kSmem;
    case 64: return (int)Geo<T, 64>::kSmem;
    case 128: return (int)Geo<T, 128>::kSmem;
    case 256: return std::is_same<T, float>::value ? (int)Geo<float, 256>::kSmem : -1;
    default: return -1;
  }
}

}  // namespace

// Dynamic shared memory of one block at head width d, or -1.
extern "C" int awb_flash_attention_smem(int d, int bf16) {
  return bf16 ? smem_bytes<__nv_bfloat16>(d) : smem_bytes<float>(d);
}

// q, o: contiguous [b, sq, h, d]; k, v: contiguous [b, sk, hkv, d]; all float32
// (bf16 == 0) or all bfloat16, each 16-byte aligned (cp.async and vector
// loads). window <= 0 means no window. Returns the cudaError_t of the launch.
extern "C" int awb_flash_attention(const void* q, const void* k, const void* v,
                                   void* o, int b, int sq, int sk, int h, int hkv,
                                   int d, int causal, int window, float scale,
                                   int bf16, void* stream) {
  if (b <= 0 || sq <= 0 || h <= 0 || hkv <= 0 || h % hkv != 0) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16 != 0)
    return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, b, sq, sk, h, hkv, d, causal, window, scale, s);
  return dispatch<float>(q, k, v, o, b, sq, sk, h, hkv, d, causal, window, scale, s);
}
