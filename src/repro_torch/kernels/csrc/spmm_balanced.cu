// AWB-balanced SpMM for Hopper (sm_90a): C = A @ B through a converged
// schedule (repro_torch.core.schedule.Schedule).
//
// Replaces
//   * src/repro/kernels/spmm_pallas.py:_kernel (the pl.pallas_call at :112),
//     which walks the schedule's steps in order on one TPU core and carries
//     each output window's accumulator in VMEM from step to step;
//   * src/repro/core/schedule.py:scatter_epilogue, the XLA scatter-add that
//     folds the permuted window output back into matrix rows and merges the
//     chunks of evil rows (the paper's adder tree).
//
// The schedule on a real graph
//   With the default geometry (K = 256 slots a step, R = 64 rows a window,
//   window_nnz = K, one column block) every regular window holds exactly one
//   step, and every evil-row chunk is one step writing its own output slot.
//   On reddit (232,965 rows, 22.94 M non-zeros): 111,513 steps, 85,702
//   one-step regular windows of 2.6 rows on average, 404 evil windows of 64
//   one-chunk steps (25,811 steps, 23 % of the work), and 19.6 % of the
//   28.55 M issued slots are padding (val == 0, always a step's tail).
//   Within a step, slots are sorted by (row, column): 2.24 row runs a step.
//
// Design: the work unit is the step
//   The schedule cuts the work into steps of K slots, the GPU analogue of
//   the paper's PE rounds, so `awb_spmm_window` gives each step to a group of
//   gw lanes (32, 16 or 8: a warp or part of one) and lets the hardware hand
//   out the groups: the AWB equal-work rule applied to SMs. No step waits for
//   another, and the evil chunks spread over the whole card.
//   * Metadata once per step and panel. `kernel_plan` packs each live slot
//     into one 8-byte record at upload: the global B row min(cblk*CB + lcol,
//     n-1), bit 31 set where a run of one output row starts, and val's
//     bits. Lane i of a group loads record j0+i (coalesced, streaming cache
//     hint, the next tile's loaded a tile ahead); shuffles broadcast it.
//   * Padding is skipped: only live slots are packed, so no B row is
//     gathered for a padding slot.
//   * 16-byte gathers. A lane gathers VEC = 4 floats or 8 bf16 at once when
//     kdim and B allow it (else 1) and owns NC such vectors of a column
//     panel of gw*NC*VEC columns; panels = grid.y, each a pass over all
//     steps (launched panel-major). U slots are in flight per lane: 4 when
//     NC == 1 or VEC == 1, else 1.
//   * Row runs in registers. A lane adds val*B into NC*VEC f32 registers in
//     slot order and writes the sum once, when a run ends, as one row of the
//     partial output `part` (streaming stores). No shared memory.
//   * Lane mapping (`spmm_cuda.lane_mapping`, from kdim, dtype and B's
//     rows). When B is larger than L2 (50 MB) and its rows are whole 128-byte
//     lines, a panel is one line: 8 lanes of 16 bytes, NC 1, so a panel's
//     slice of B (30 MB at 32 f32 columns on reddit) stays in L2 while every
//     step gathers from it. Otherwise one pass, fewest idle lanes. On reddit:
//     kdim 512 and 128 run 16 and 4 line panels, 0 % idle lanes; kdim 164
//     (656-byte rows) runs one pass of 41 float4 over gw 16, NC 3: 14.6 %
//     idle; kdim 41 the same mapping with scalar gathers: 14.6 % idle.
//   Why: chip_smoke.py phase 3 times the kernel under other lane mappings
//   beside this one (PERF.md §6): at kdim 512, one full-width pass is
//   slower than line panels, which keep each gather's slice of B in L2.
//   U stays small so a step kernel needs at most 68 registers in f32
//   (89 in bf16) and no spills: at 64 (the f32 line-panel kernel) four
//   256-thread blocks fit an SM, and many steps in flight hide the
//   gathers' latency.
//   Each partial is the sum of one run of one step, so partial p belongs to
//   the output slot row_map[win*R + lrow] of its run. `kernel_plan` numbers
//   the partials (part_ptr: the first partial of each step) and builds the
//   epilogue's CSR from output row to its partials. On the default geometry
//   a row has one partial, and an evil row one per chunk. Where a slot takes
//   sums from several steps (column blocking, window_nnz > K, naive
//   schedules), it simply has several partials.
//
//   `awb_spmm_epilogue` gives one thread to each (output row, vector of 4
//   columns, or one column when kdim % 4 != 0 or part or out is not 16-byte
//   aligned): it sums the row's partials in ascending partial order from 0,
//   casts to B's dtype and writes the row, optionally through the row
//   un-permutation of a reordered schedule.
//   Every output element is summed by one thread in a fixed order in both
//   kernels, so the result is bit-deterministic (index_add_'s float atomics
//   are not). The Pallas kernel adds each step into an output block of B's
//   dtype; here runs and the epilogue accumulate in f32 and round once.
//
// bf16 accumulation (`acc_bf16 = 1`)
//   The variant of the executor's `bf16_accumulate` option, which the
//   Pallas kernel lacks: src/repro/core/executor.py:_gather_impl with a
//   bf16 accumulator (:666-690) rounds B to bf16 before any gather
//   (`b.astype(acc)`) and the slot values, and rounds each product and each
//   running sum after every add. Its kernels are templates of their own
//   (`spmm_step_kernel_bf16acc`, `epilogue_kernel_bf16acc`), redesigned
//   around bf16 data:
//   * B is gathered in bf16. The wrapper rounds an f32 B once, in a plain
//     elementwise cast before the launch (`spmm_cuda.window_operand`), so
//     a gather moves 2 bytes an element, 8 to a 16-byte vector.
//   * Packed arithmetic. A lane keeps its sums as bf16 pairs in 32-bit
//     registers and does, per slot and pair, acc = add.rn.bf16x2(acc,
//     mul.rn.bf16x2(v2, x2)), v2 the slot value rounded once (per tile of
//     gw slots, by the lane that loads its record) in both halves: one
//     instruction per element where the f32 kernel issues one FFMA, and no
//     conversion per slot. The explicit .rn keeps ptxas from contracting
//     the pair into one fused op, which would round once instead of twice;
//     ptxas issues each as HMUL2/HADD2.BF16_V2 or as HFMA2.BF16_V2 with a
//     -0 addend or a factor of 1, which round the same. Odd kdim and an
//     unaligned B take scalar gathers into the low half of a pair.
//   * bf16 partials: a run's sums are written as one bf16 row, and the
//     epilogue reads them back 8 columns to a 16-byte load (scalars when
//     kdim % 8 or alignment forbid) and sums them in ascending order with
//     add.rn.bf16x2, writing f32 (each sum widened exactly) or bf16.
//   * Lanes. Under bf16 accumulation a panel is two lines (`spmm_cuda.
//     BF16ACC_PANEL_LINES`) where B outgrows L2: 8 lanes of 2 vectors, U 1
//     (the f32 kernel's rule at NC > 1). On reddit at the sweep winner's
//     schedule (K 256, R 32), chip_smoke.py phase 6b times it beside 1-line
//     panels and one wider pass (PERF.md §6): kdim 128 (B 59.6 MB in bf16)
//     then runs one 2-line pass, kdim 512 four panels, each the fastest of
//     those mappings; trial builds with U 2 and U 4 at 2 lines, and 3- and
//     4-line panels, were slower (their script was not kept).
//   Why the results do not change: rounding a p-bit result to q bits
//   through p' bits first is harmless for + and x when p' >= 2q + 2
//   (Figueroa), and f32 (24) to bf16 (8) meets it. So add.rn.bf16x2 equals
//   rb(__fadd_rn(a, b)) and mul.rn.bf16x2 equals rb(__fmul_rn(a, b)) on
//   bf16 inputs, rb = __float2bfloat16_rn: the plain versions' sequence. At
//   the edges (subnormals, signed zeros, overflow, NaN) the card settles
//   it: `awb_bf16_rounding_check` compares both ops with the f32 sequence
//   on all 2^32 pairs of bf16 patterns, and finds 0 mismatches (NaN equal
//   to NaN). Both kernels sum in the plain versions' order, so they stay
//   bit-equal to them (torch.equal) and deterministic.
//   Bound: per panel each live slot's 8-byte record, B once in bf16 (the
//   cast reads it once in f32 and writes it in bf16), the bf16 partials
//   written and read back by the epilogue; a bf16 multiply and add per
//   non-zero and column. What bounds it is the gathers: each slot fetches
//   its panel's slice of a B row from L2, live_slots * kdim * 2 bytes in
//   all (23.5 GB at kdim 512 on reddit), at about the rate the f32
//   kernel's gathers reach (PERF.md §6): half the bytes, half the time.
//
// Bound
//   Memory. Per call the window kernel must read 8 bytes for each live slot
//   (22.94 M on reddit), 8 per step, and B once, and write n_parts rows of
//   f32; each further panel reads the records again. The epilogue reads the
//   partials back and writes m*kdim elements. When no gather hits in L2 (B
//   is 477 MB at kdim 512), B traffic is live_slots*kdim elements (14.2 ms
//   at 3.35 TB/s for kdim 512). The product needs 2*nnz*kdim flops, at kdim
//   512 as long at 67 TFLOP/s as the compulsory bytes at 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// One lane's gather of VEC consecutive elements of a B row, as f32.
template <typename T, int VEC>
struct Gather;

template <>
struct Gather<float, 4> {
  using Raw = float4;
  __device__ static Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ static float at(const Raw& r, int e) {
    return e == 0 ? r.x : e == 1 ? r.y : e == 2 ? r.z : r.w;
  }
};

template <>
struct Gather<float, 1> {
  using Raw = float;
  __device__ static Raw load(const float* p) { return __ldg(p); }
  __device__ static float at(const Raw& r, int) { return r; }
};

template <>
struct Gather<__nv_bfloat16, 8> {
  using Raw = uint4;
  __device__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ static float at(const Raw& r, int e) {
    const unsigned w = e < 2 ? r.x : e < 4 ? r.y : e < 6 ? r.z : r.w;
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};

template <>
struct Gather<__nv_bfloat16, 1> {
  using Raw = unsigned short;
  __device__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  __device__ static float at(const Raw& r, int) {
    return __uint_as_float(static_cast<unsigned>(r) << 16);
  }
};

// Slots in flight per lane: 4 when a lane gathers one vector (or scalars),
// else 1. Deeper unrolling costs registers, and the kernel is bound by how
// many steps an SM keeps in flight (measured: chip_smoke.py phase 3).
template <int VEC, int NC>
__host__ __device__ constexpr int unroll() {
  return (NC == 1 || VEC == 1) ? 4 : 1;
}

template <int VEC>
__device__ __forceinline__ void store_run(float* q, const float (&a)[VEC]) {
  if constexpr (VEC == 1) {
    __stcs(q, a[0]);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; e += 4)
      __stcs(reinterpret_cast<float4*>(q + e),
             make_float4(a[e], a[e + 1], a[e + 2], a[e + 3]));
  }
}

// slots[i] = {B row | (1 << 31) where a run starts, val's bits}, the live
// slots of step s at [slot_ptr[s], slot_ptr[s+1]); its runs are partials
// part_ptr[s], part_ptr[s] + 1, ...
template <typename T, int VEC, int NC>
__global__ void __launch_bounds__(kThreads)
    spmm_step_kernel(const int2* __restrict__ slots,
                     const int* __restrict__ slot_ptr,
                     const int* __restrict__ part_ptr,
                     const T* __restrict__ b, int n_steps, int kdim, int gw,
                     float* __restrict__ part) {
  using G = Gather<T, VEC>;
  constexpr int U = unroll<VEC, NC>();
  const int64_t group =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / gw;
  if (group >= n_steps) return;  // the whole group leaves together
  const int step = static_cast<int>(group);
  const int beg = __ldg(slot_ptr + step);
  const int len = __ldg(slot_ptr + step + 1) - beg;
  if (len == 0) return;

  const int lane = threadIdx.x & (gw - 1);
  const unsigned gmask =
      gw == 32 ? 0xffffffffu
               : ((1u << gw) - 1u) << ((threadIdx.x & 31) & ~(gw - 1));
  const int nv = kdim / VEC;
  bool act[NC];
  int col[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int v = (blockIdx.y * NC + c) * gw + lane;
    act[c] = v < nv;
    col[c] = act[c] ? v * VEC : 0;
  }

  const int64_t p0 = __ldg(part_ptr + step);
  int64_t p = p0 - 1;  // the first slot starts run p0
  float acc[NC][VEC];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[c][e] = 0.f;

  auto flush = [&]() {
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (act[c]) store_run<VEC>(part + p * kdim + col[c], acc[c]);
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[c][e] = 0.f;
  };

  // lane i holds slot j0 + i; the next tile's records load a tile ahead
  int2 next = lane < len ? __ldcs(slots + beg + lane) : int2{0, 0};
  for (int j0 = 0; j0 < len; j0 += gw) {
    const int2 mine = next;
    if (j0 + gw + lane < len) next = __ldcs(slots + beg + j0 + gw + lane);
    const int cnt = min(gw, len - j0);
    for (int u0 = 0; u0 < cnt; u0 += U) {
      int g[U];
      float v[U];
      typename G::Raw x[U][NC];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        g[u] = __shfl_sync(gmask, mine.x, u0 + u, gw);
        v[u] = __int_as_float(__shfl_sync(gmask, mine.y, u0 + u, gw));
        const T* row = b + static_cast<int64_t>(g[u] & 0x7fffffff) * kdim;
#pragma unroll
        for (int c = 0; c < NC; ++c)
          x[u][c] = (u0 + u < cnt && act[c]) ? G::load(row + col[c])
                                             : typename G::Raw{};
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u0 + u < cnt) {
          if (g[u] < 0) {  // a run starts: write the one before it
            if (p >= p0) flush();
            ++p;
          }
#pragma unroll
          for (int c = 0; c < NC; ++c)
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[c][e] = fmaf(v[u], G::at(x[u][c], e), acc[c][e]);
        }
      }
    }
  }
  flush();
}

__device__ __forceinline__ void store_out(float* q, const float (&a)[4]) {
  *reinterpret_cast<float4*>(q) = make_float4(a[0], a[1], a[2], a[3]);
}
__device__ __forceinline__ void store_out(__nv_bfloat16* q,
                                          const float (&a)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a[0], a[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(a[2], a[3]);
  uint2 w;
  w.x = *reinterpret_cast<unsigned*>(&lo);
  w.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(q) = w;
}
__device__ __forceinline__ void store_out(float* q, const float (&a)[1]) {
  *q = a[0];
}
__device__ __forceinline__ void store_out(__nv_bfloat16* q,
                                          const float (&a)[1]) {
  *q = __float2bfloat16(a[0]);
}

template <typename T, int VEC>
__global__ void epilogue_kernel(const float* __restrict__ part,
                                const int* __restrict__ epi_ptr,
                                const int* __restrict__ epi_part,
                                const int* __restrict__ unperm, int m,
                                int kdim, T* __restrict__ out) {
  const int nv = kdim / VEC;
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<int64_t>(m) * nv) return;
  const int row = static_cast<int>(idx / nv);
  const int col = static_cast<int>(idx % nv) * VEC;
  const int src = unperm != nullptr ? __ldg(unperm + row) : row;
  float sum[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) sum[e] = 0.f;
  const int end = __ldg(epi_ptr + src + 1);
  for (int q = __ldg(epi_ptr + src); q < end; ++q) {
    const float* x =
        part + static_cast<int64_t>(__ldg(epi_part + q)) * kdim + col;
    if constexpr (VEC == 4) {
      const float4 y = __ldcs(reinterpret_cast<const float4*>(x));
      sum[0] += y.x;
      sum[1] += y.y;
      sum[2] += y.z;
      sum[3] += y.w;
    } else {
      sum[0] += __ldcs(x);
    }
  }
  store_out(out + static_cast<int64_t>(row) * kdim + col, sum);
}

// ---------------------------------------------------------------------------
// The bf16-accumulate variant: bf16 B, packed bf16x2 arithmetic, bf16
// partials (header note, "bf16 accumulation"). bf16 values travel as their
// 16-bit patterns (unsigned short), two to a 32-bit word, low half first.
// ---------------------------------------------------------------------------

// a * b and a + b on two bf16 pairs, each rounded once to nearest even
// (sm_90's mul/add.rn.bf16x2, subnormals kept). The explicit .rn keeps
// ptxas from contracting a multiply and an add into one fused op, which
// would round once where the executor's bf16 path rounds twice.
__device__ __forceinline__ unsigned mul_bf16x2(unsigned a, unsigned b) {
  unsigned d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ unsigned add_bf16x2(unsigned a, unsigned b) {
  unsigned d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
// v rounded to bf16 (nearest even), in both halves of a word
__device__ __forceinline__ unsigned bf16x2_splat(float v) {
  unsigned d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %1;" : "=r"(d) : "f"(v));
  return d;
}

// One lane's gather of VEC bf16 columns as W packed words: 8 columns (16
// bytes, 4 words) or one column in the low half of a word (its high half
// computes on zeros and is never stored).
template <int VEC>
struct Packed;

template <>
struct Packed<8> {
  static constexpr int W = 4;
  using Raw = uint4;
  __device__ static Raw load(const unsigned short* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ static unsigned word(const Raw& r, int i) {
    return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
  }
  __device__ static void store_run(unsigned short* q, const unsigned (&a)[W]) {
    __stcs(reinterpret_cast<uint4*>(q), make_uint4(a[0], a[1], a[2], a[3]));
  }
};

template <>
struct Packed<1> {
  static constexpr int W = 1;
  using Raw = unsigned short;
  __device__ static Raw load(const unsigned short* p) { return __ldg(p); }
  __device__ static unsigned word(const Raw& r, int) { return r; }
  __device__ static void store_run(unsigned short* q, const unsigned (&a)[W]) {
    __stcs(q, static_cast<unsigned short>(a[0]));
  }
};

// The window kernel's work unit with the executor's bf16 rounding: per
// slot acc = add.rn(acc, mul.rn(v, x)) on packed pairs, v the slot value
// rounded once (per tile, by the lane that loads its record) and x the
// gathered bf16 columns; each run's sum is written as one bf16 partial row.
template <int VEC, int NC>
__global__ void __launch_bounds__(kThreads)
    spmm_step_kernel_bf16acc(const int2* __restrict__ slots,
                             const int* __restrict__ slot_ptr,
                             const int* __restrict__ part_ptr,
                             const unsigned short* __restrict__ b,
                             int n_steps, int kdim, int gw,
                             unsigned short* __restrict__ part) {
  using P = Packed<VEC>;
  constexpr int W = P::W;
  constexpr int U = unroll<VEC, NC>();
  const int64_t group =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / gw;
  if (group >= n_steps) return;  // the whole group leaves together
  const int step = static_cast<int>(group);
  const int beg = __ldg(slot_ptr + step);
  const int len = __ldg(slot_ptr + step + 1) - beg;
  if (len == 0) return;

  const int lane = threadIdx.x & (gw - 1);
  const unsigned gmask =
      gw == 32 ? 0xffffffffu
               : ((1u << gw) - 1u) << ((threadIdx.x & 31) & ~(gw - 1));
  const int nv = kdim / VEC;
  bool act[NC];
  int col[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int v = (blockIdx.y * NC + c) * gw + lane;
    act[c] = v < nv;
    col[c] = act[c] ? v * VEC : 0;
  }

  const int64_t p0 = __ldg(part_ptr + step);
  int64_t p = p0 - 1;  // the first slot starts run p0
  unsigned acc[NC][W];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int w = 0; w < W; ++w) acc[c][w] = 0u;

  auto flush = [&]() {
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (act[c]) P::store_run(part + p * kdim + col[c], acc[c]);
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int w = 0; w < W; ++w) acc[c][w] = 0u;
  };

  // lane i holds slot j0 + i and its rounded value; the next tile's
  // records load a tile ahead
  int2 next = lane < len ? __ldcs(slots + beg + lane) : int2{0, 0};
  for (int j0 = 0; j0 < len; j0 += gw) {
    const int mine_g = next.x;
    const unsigned mine_v = bf16x2_splat(__int_as_float(next.y));
    if (j0 + gw + lane < len) next = __ldcs(slots + beg + j0 + gw + lane);
    const int cnt = min(gw, len - j0);
    for (int u0 = 0; u0 < cnt; u0 += U) {
      int g[U];
      unsigned v[U];
      typename P::Raw x[U][NC];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        g[u] = __shfl_sync(gmask, mine_g, u0 + u, gw);
        v[u] = __shfl_sync(gmask, mine_v, u0 + u, gw);
        const unsigned short* row =
            b + static_cast<int64_t>(g[u] & 0x7fffffff) * kdim;
#pragma unroll
        for (int c = 0; c < NC; ++c)
          x[u][c] = (u0 + u < cnt && act[c]) ? P::load(row + col[c])
                                             : typename P::Raw{};
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u0 + u < cnt) {
          if (g[u] < 0) {  // a run starts: write the one before it
            if (p >= p0) flush();
            ++p;
          }
#pragma unroll
          for (int c = 0; c < NC; ++c)
#pragma unroll
            for (int w = 0; w < W; ++w)
              acc[c][w] = add_bf16x2(acc[c][w],
                                     mul_bf16x2(v[u], P::word(x[u][c], w)));
        }
      }
    }
  }
  flush();
}

// A row's packed bf16 sums, written as f32 (each half widened exactly) or
// as bf16 (the bits)
__device__ __forceinline__ float lo_f32(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_f32(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ void store_packed(float* q, const unsigned (&a)[4]) {
  reinterpret_cast<float4*>(q)[0] =
      make_float4(lo_f32(a[0]), hi_f32(a[0]), lo_f32(a[1]), hi_f32(a[1]));
  reinterpret_cast<float4*>(q)[1] =
      make_float4(lo_f32(a[2]), hi_f32(a[2]), lo_f32(a[3]), hi_f32(a[3]));
}
__device__ __forceinline__ void store_packed(unsigned short* q,
                                             const unsigned (&a)[4]) {
  *reinterpret_cast<uint4*>(q) = make_uint4(a[0], a[1], a[2], a[3]);
}
__device__ __forceinline__ void store_packed(float* q, const unsigned (&a)[1]) {
  *q = lo_f32(a[0]);
}
__device__ __forceinline__ void store_packed(unsigned short* q,
                                             const unsigned (&a)[1]) {
  *q = static_cast<unsigned short>(a[0]);
}

// out[row, col:col+VEC] = the row's bf16 partials summed in ascending order,
// add.rn.bf16x2 after each; T is float or unsigned short (bf16 bits)
template <typename T, int VEC>
__global__ void epilogue_kernel_bf16acc(const unsigned short* __restrict__ part,
                                        const int* __restrict__ epi_ptr,
                                        const int* __restrict__ epi_part,
                                        const int* __restrict__ unperm, int m,
                                        int kdim, T* __restrict__ out) {
  constexpr int W = Packed<VEC>::W;
  const int nv = kdim / VEC;
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<int64_t>(m) * nv) return;
  const int row = static_cast<int>(idx / nv);
  const int col = static_cast<int>(idx % nv) * VEC;
  const int src = unperm != nullptr ? __ldg(unperm + row) : row;
  unsigned sum[W];
#pragma unroll
  for (int w = 0; w < W; ++w) sum[w] = 0u;
  const int end = __ldg(epi_ptr + src + 1);
  for (int q = __ldg(epi_ptr + src); q < end; ++q) {
    const unsigned short* x =
        part + static_cast<int64_t>(__ldg(epi_part + q)) * kdim + col;
    if constexpr (VEC == 8) {
      const uint4 y = __ldcs(reinterpret_cast<const uint4*>(x));
      sum[0] = add_bf16x2(sum[0], y.x);
      sum[1] = add_bf16x2(sum[1], y.y);
      sum[2] = add_bf16x2(sum[2], y.z);
      sum[3] = add_bf16x2(sum[3], y.w);
    } else {
      sum[0] = add_bf16x2(sum[0], __ldcs(x));
    }
  }
  store_packed(out + static_cast<int64_t>(row) * kdim + col, sum);
}

// Every pair (a, b) of bf16 bit patterns, 2^32 in all: mul.rn.bf16x2 and
// add.rn.bf16x2 against the written-out f32 sequence they replace in the
// bf16-accumulate kernels, rb(__fmul_rn(a, b)) and rb(__fadd_rn(a, b)) with
// rb = __float2bfloat16_rn (no FTZ: this file's flags). Block a takes a
// against every b, two b to a packed word; a NaN equals any NaN.
__device__ __forceinline__ unsigned rb_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
__device__ __forceinline__ bool same_bf16(unsigned x, unsigned y) {
  return x == y || ((x & 0x7fffu) > 0x7f80u && (y & 0x7fffu) > 0x7f80u);
}

__global__ void __launch_bounds__(kThreads)
    bf16_rounding_check_kernel(unsigned long long* __restrict__ mismatches) {
  const unsigned a = blockIdx.x;
  const unsigned a2 = a << 16 | a;
  const float fa = __uint_as_float(a << 16);
  unsigned n_mul = 0, n_add = 0;
  for (unsigned b = 2 * threadIdx.x; b < 65536u; b += 2 * kThreads) {
    const unsigned b2 = (b + 1) << 16 | b;
    const unsigned prod = mul_bf16x2(a2, b2);
    const unsigned sum = add_bf16x2(a2, b2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float fb = __uint_as_float((b + h) << 16);
      const int shift = 16 * h;
      n_mul += !same_bf16((prod >> shift) & 0xffffu, rb_bits(__fmul_rn(fa, fb)));
      n_add += !same_bf16((sum >> shift) & 0xffffu, rb_bits(__fadd_rn(fa, fb)));
    }
  }
  n_mul = __reduce_add_sync(0xffffffffu, n_mul);
  n_add = __reduce_add_sync(0xffffffffu, n_add);
  if ((threadIdx.x & 31) == 0 && (n_mul | n_add)) {
    atomicAdd(mismatches, static_cast<unsigned long long>(n_mul));
    atomicAdd(mismatches + 1, static_cast<unsigned long long>(n_add));
  }
}

// The step kernels' grid: one group of gw lanes a step (blocks of
// kThreads), column panels of gw * NC vectors on y; false if it is too large
template <int VEC, int NC>
bool step_grid(int n_steps, int kdim, int gw, dim3* grid) {
  const int64_t threads = static_cast<int64_t>(n_steps) * gw;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  const int panel = gw * NC;
  const int panels = (kdim / VEC + panel - 1) / panel;
  if (blocks > 0x7fffffff || panels > 65535) return false;
  *grid = dim3(static_cast<unsigned>(blocks), panels);
  return true;
}

template <typename T, int VEC, int NC>
int launch_steps(const int2* slots, const int* slot_ptr, const int* part_ptr,
                 int n_steps, const void* b, int kdim, int gw, float* part,
                 cudaStream_t stream) {
  dim3 grid;
  if (!step_grid<VEC, NC>(n_steps, kdim, gw, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  spmm_step_kernel<T, VEC, NC><<<grid, kThreads, 0, stream>>>(
      slots, slot_ptr, part_ptr, static_cast<const T*>(b), n_steps, kdim, gw,
      part);
  return static_cast<int>(cudaGetLastError());
}

template <int VEC, int NC>
int launch_steps_bf16acc(const int2* slots, const int* slot_ptr,
                         const int* part_ptr, int n_steps, const void* b,
                         int kdim, int gw, void* part, cudaStream_t stream) {
  dim3 grid;
  if (!step_grid<VEC, NC>(n_steps, kdim, gw, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  spmm_step_kernel_bf16acc<VEC, NC><<<grid, kThreads, 0, stream>>>(
      slots, slot_ptr, part_ptr, static_cast<const unsigned short*>(b),
      n_steps, kdim, gw, static_cast<unsigned short*>(part));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int launch_steps_nc(int nc, const int2* slots, const int* slot_ptr,
                    const int* part_ptr, int n_steps, const void* b, int kdim,
                    int gw, float* part, cudaStream_t st) {
  switch (nc) {
    case 1:
      return launch_steps<T, VEC, 1>(slots, slot_ptr, part_ptr, n_steps, b,
                                     kdim, gw, part, st);
    case 2:
      return launch_steps<T, VEC, 2>(slots, slot_ptr, part_ptr, n_steps, b,
                                     kdim, gw, part, st);
    case 3:
      return launch_steps<T, VEC, 3>(slots, slot_ptr, part_ptr, n_steps, b,
                                     kdim, gw, part, st);
    case 4:
      return launch_steps<T, VEC, 4>(slots, slot_ptr, part_ptr, n_steps, b,
                                     kdim, gw, part, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int VEC>
int launch_steps_bf16acc_nc(int nc, const int2* slots, const int* slot_ptr,
                            const int* part_ptr, int n_steps, const void* b,
                            int kdim, int gw, void* part, cudaStream_t st) {
  switch (nc) {
    case 1:
      return launch_steps_bf16acc<VEC, 1>(slots, slot_ptr, part_ptr, n_steps,
                                          b, kdim, gw, part, st);
    case 2:
      return launch_steps_bf16acc<VEC, 2>(slots, slot_ptr, part_ptr, n_steps,
                                          b, kdim, gw, part, st);
    case 3:
      return launch_steps_bf16acc<VEC, 3>(slots, slot_ptr, part_ptr, n_steps,
                                          b, kdim, gw, part, st);
    case 4:
      return launch_steps_bf16acc<VEC, 4>(slots, slot_ptr, part_ptr, n_steps,
                                          b, kdim, gw, part, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The epilogue kernels' blocks: one thread per output row and vector
unsigned epilogue_blocks(int m, int kdim, int vec) {
  const int64_t total = static_cast<int64_t>(m) * (kdim / vec);
  return static_cast<unsigned>((total + kThreads - 1) / kThreads);
}

template <typename T, int VEC>
int launch_epilogue(const float* part, const int* epi_ptr,
                    const int* epi_part, const int* unperm, int m, int kdim,
                    void* out, cudaStream_t stream) {
  epilogue_kernel<T, VEC>
      <<<epilogue_blocks(m, kdim, VEC), kThreads, 0, stream>>>(
          part, epi_ptr, epi_part, unperm, m, kdim, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int launch_epilogue_bf16acc(const void* part, const int* epi_ptr,
                            const int* epi_part, const int* unperm, int m,
                            int kdim, void* out, cudaStream_t stream) {
  epilogue_kernel_bf16acc<T, VEC>
      <<<epilogue_blocks(m, kdim, VEC), kThreads, 0, stream>>>(
          static_cast<const unsigned short*>(part), epi_ptr, epi_part, unperm,
          m, kdim, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

int window_f32(int b_bf16, int vec, int nc, const int2* s2, const int* slot_ptr,
               const int* part_ptr, int n_steps, const void* b, int kdim,
               int gw, float* part, cudaStream_t st) {
  if (b_bf16) {
    if (vec == 8)
      return launch_steps_nc<__nv_bfloat16, 8>(nc, s2, slot_ptr, part_ptr,
                                               n_steps, b, kdim, gw, part, st);
    if (vec == 1)
      return launch_steps_nc<__nv_bfloat16, 1>(nc, s2, slot_ptr, part_ptr,
                                               n_steps, b, kdim, gw, part, st);
  } else {
    if (vec == 4)
      return launch_steps_nc<float, 4>(nc, s2, slot_ptr, part_ptr, n_steps, b,
                                       kdim, gw, part, st);
    if (vec == 1)
      return launch_steps_nc<float, 1>(nc, s2, slot_ptr, part_ptr, n_steps, b,
                                       kdim, gw, part, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int window_bf16acc(int vec, int nc, const int2* s2, const int* slot_ptr,
                   const int* part_ptr, int n_steps, const void* b, int kdim,
                   int gw, void* part, cudaStream_t st) {
  if (vec == 8)
    return launch_steps_bf16acc_nc<8>(nc, s2, slot_ptr, part_ptr, n_steps, b,
                                      kdim, gw, part, st);
  if (vec == 1)
    return launch_steps_bf16acc_nc<1>(nc, s2, slot_ptr, part_ptr, n_steps, b,
                                      kdim, gw, part, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int epilogue_f32(const float* part, const int* epi_ptr, const int* epi_part,
                 const int* unperm, int m, int kdim, void* out, int out_bf16,
                 cudaStream_t st) {
  // 16-byte loads of part need its rows on 16-byte boundaries
  if (kdim % 4 == 0 && aligned16(part) && aligned16(out)) {
    if (out_bf16)
      return launch_epilogue<__nv_bfloat16, 4>(part, epi_ptr, epi_part, unperm,
                                               m, kdim, out, st);
    return launch_epilogue<float, 4>(part, epi_ptr, epi_part, unperm, m, kdim,
                                     out, st);
  }
  if (out_bf16)
    return launch_epilogue<__nv_bfloat16, 1>(part, epi_ptr, epi_part, unperm,
                                             m, kdim, out, st);
  return launch_epilogue<float, 1>(part, epi_ptr, epi_part, unperm, m, kdim,
                                   out, st);
}

int epilogue_bf16acc(const void* part, const int* epi_ptr, const int* epi_part,
                     const int* unperm, int m, int kdim, void* out,
                     int out_bf16, cudaStream_t st) {
  // 16-byte loads of 8 bf16 partial columns
  if (kdim % 8 == 0 && aligned16(part) && aligned16(out)) {
    if (out_bf16)
      return launch_epilogue_bf16acc<unsigned short, 8>(
          part, epi_ptr, epi_part, unperm, m, kdim, out, st);
    return launch_epilogue_bf16acc<float, 8>(part, epi_ptr, epi_part, unperm,
                                             m, kdim, out, st);
  }
  if (out_bf16)
    return launch_epilogue_bf16acc<unsigned short, 1>(
        part, epi_ptr, epi_part, unperm, m, kdim, out, st);
  return launch_epilogue_bf16acc<float, 1>(part, epi_ptr, epi_part, unperm, m,
                                           kdim, out, st);
}

}  // namespace

extern "C" {

// Partial output: part[p, :] for every run p of every step (a step's live
// slots are slots[slot_ptr[s] .. slot_ptr[s+1]), its runs part_ptr[s] ..).
// b is [n, kdim], f32 (b_bf16 == 0) or bf16. Lane mapping: vec 4 (f32) or
// 8 (bf16) for 16-byte gathers, which needs kdim % vec == 0 and b 16-byte
// aligned, else 1; gw lanes a step (8, 16 or 32); nc vectors a lane (1-4);
// ceil(kdim / (vec * gw * nc)) column panels. part is f32; with
// acc_bf16 != 0 (the executor's bf16 path) b must be bf16 and part is bf16.
// Returns cudaError_t.
int awb_spmm_window(const int* slots, const int* slot_ptr,
                    const int* part_ptr, int n_steps, const void* b,
                    int b_bf16, int acc_bf16, int kdim, int vec, int gw,
                    int nc, void* part, void* stream) {
  if (n_steps == 0 || kdim == 0) return 0;
  if ((gw != 8 && gw != 16 && gw != 32) || kdim % vec != 0 ||
      (acc_bf16 && !b_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int2* s2 = reinterpret_cast<const int2*>(slots);
  if (acc_bf16)
    return window_bf16acc(vec, nc, s2, slot_ptr, part_ptr, n_steps, b, kdim,
                          gw, part, st);
  return window_f32(b_bf16, vec, nc, s2, slot_ptr, part_ptr, n_steps, b, kdim,
                    gw, static_cast<float*>(part), st);
}

// out[row, :] = sum of part[epi_part[q], :] for q in the CSR segment of row
// unperm[row] (or row itself when unperm is null), in ascending q, cast to
// out's dtype (f32 when out_bf16 == 0, else bf16). part is f32, or bf16
// with acc_bf16 != 0, which rounds the running sum to bf16 after each add.
// Returns cudaError_t.
int awb_spmm_epilogue(const void* part, const int* epi_ptr,
                      const int* epi_part, const int* unperm, int m, int kdim,
                      void* out, int out_bf16, int acc_bf16, void* stream) {
  if (m == 0 || kdim == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (acc_bf16)
    return epilogue_bf16acc(part, epi_ptr, epi_part, unperm, m, kdim, out,
                            out_bf16, st);
  return epilogue_f32(static_cast<const float*>(part), epi_ptr, epi_part,
                      unperm, m, kdim, out, out_bf16, st);
}

// mismatches[0], [1] += the pairs of bf16 patterns on which mul.rn.bf16x2,
// add.rn.bf16x2 differ from the written-out f32 sequence (a NaN equals any
// NaN), over all 2^32 pairs. mismatches is two zeroed 64-bit counters on
// the device. Returns cudaError_t.
int awb_bf16_rounding_check(unsigned long long* mismatches, void* stream) {
  bf16_rounding_check_kernel<<<65536, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(mismatches);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
