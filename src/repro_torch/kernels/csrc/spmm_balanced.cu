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
// bf16 accumulation (BF16ACC, `acc_bf16 = 1`)
//   The variant of the executor's `bf16_accumulate` option, which the
//   Pallas kernel lacks: src/repro/core/executor.py:_gather_impl with a
//   bf16 accumulator (:666-690) rounds B and the slot values to bf16,
//   rounds each product and each running sum after every add. Here the
//   same work unit runs with each rounding written out (`Acc<true>`): the
//   slot value and the gathered element are rounded to bf16, the product
//   (exact in f32 for two bf16 values) and every sum of a run are rounded
//   to bf16, and the epilogue rounds after adding each partial in ascending
//   order. Partials stay f32 rows that hold bf16 values, so both kernels
//   share one layout and the variant stays bit-deterministic. Its bound is
//   the f32 kernel's: the same bytes and multiply-adds; the conversions are
//   extra instructions on a kernel bound by its gathers.
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

// The accumulation of one product or partial: f32 (fused multiply-add), or
// bf16 with each rounding of the executor's bf16 path written out.
template <bool BF16ACC>
struct Acc;

template <>
struct Acc<false> {
  __device__ static float value(float v) { return v; }
  __device__ static float madd(float acc, float v, float x) {
    return fmaf(v, x, acc);
  }
  __device__ static float add(float s, float x) { return s + x; }
};

template <>
struct Acc<true> {
  __device__ static float rb(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  // the slot value, rounded once per slot
  __device__ static float value(float v) { return rb(v); }
  __device__ static float madd(float acc, float v, float x) {
    return rb(__fadd_rn(acc, rb(__fmul_rn(v, rb(x)))));
  }
  __device__ static float add(float s, float x) { return rb(__fadd_rn(s, x)); }
};

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
template <typename T, int VEC, int NC, bool BF16ACC>
__global__ void __launch_bounds__(kThreads)
    spmm_step_kernel(const int2* __restrict__ slots,
                     const int* __restrict__ slot_ptr,
                     const int* __restrict__ part_ptr,
                     const T* __restrict__ b, int n_steps, int kdim, int gw,
                     float* __restrict__ part) {
  using G = Gather<T, VEC>;
  using A = Acc<BF16ACC>;
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
        v[u] = A::value(
            __int_as_float(__shfl_sync(gmask, mine.y, u0 + u, gw)));
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
              acc[c][e] = A::madd(acc[c][e], v[u], G::at(x[u][c], e));
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

template <typename T, int VEC, bool BF16ACC>
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
  using A = Acc<BF16ACC>;
  float sum[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) sum[e] = 0.f;
  const int end = __ldg(epi_ptr + src + 1);
  for (int q = __ldg(epi_ptr + src); q < end; ++q) {
    const float* x =
        part + static_cast<int64_t>(__ldg(epi_part + q)) * kdim + col;
    if constexpr (VEC == 4) {
      const float4 y = __ldcs(reinterpret_cast<const float4*>(x));
      sum[0] = A::add(sum[0], y.x);
      sum[1] = A::add(sum[1], y.y);
      sum[2] = A::add(sum[2], y.z);
      sum[3] = A::add(sum[3], y.w);
    } else {
      sum[0] = A::add(sum[0], __ldcs(x));
    }
  }
  store_out(out + static_cast<int64_t>(row) * kdim + col, sum);
}

template <typename T, int VEC, int NC, bool BF16ACC>
int launch_steps(const int2* slots, const int* slot_ptr, const int* part_ptr,
                 int n_steps, const void* b, int kdim, int gw, float* part,
                 cudaStream_t stream) {
  const int64_t threads = static_cast<int64_t>(n_steps) * gw;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  const int panel = gw * NC;
  const int panels = (kdim / VEC + panel - 1) / panel;
  if (blocks > 0x7fffffff || panels > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), panels);
  spmm_step_kernel<T, VEC, NC, BF16ACC><<<grid, kThreads, 0, stream>>>(
      slots, slot_ptr, part_ptr, static_cast<const T*>(b), n_steps, kdim, gw,
      part);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC, bool BF16ACC>
int launch_steps_nc(int nc, const int2* slots, const int* slot_ptr,
                    const int* part_ptr, int n_steps, const void* b, int kdim,
                    int gw, float* part, cudaStream_t st) {
  switch (nc) {
    case 1:
      return launch_steps<T, VEC, 1, BF16ACC>(slots, slot_ptr, part_ptr, n_steps, b,
                                     kdim, gw, part, st);
    case 2:
      return launch_steps<T, VEC, 2, BF16ACC>(slots, slot_ptr, part_ptr, n_steps, b,
                                     kdim, gw, part, st);
    case 3:
      return launch_steps<T, VEC, 3, BF16ACC>(slots, slot_ptr, part_ptr, n_steps, b,
                                     kdim, gw, part, st);
    case 4:
      return launch_steps<T, VEC, 4, BF16ACC>(slots, slot_ptr, part_ptr, n_steps, b,
                                     kdim, gw, part, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int VEC, bool BF16ACC>
int launch_epilogue(const float* part, const int* epi_ptr,
                    const int* epi_part, const int* unperm, int m, int kdim,
                    void* out, cudaStream_t stream) {
  const int64_t total = static_cast<int64_t>(m) * (kdim / VEC);
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  epilogue_kernel<T, VEC, BF16ACC>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          part, epi_ptr, epi_part, unperm, m, kdim, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <bool BF16ACC>
int window(int b_bf16, int vec, int nc, const int2* s2, const int* slot_ptr,
           const int* part_ptr, int n_steps, const void* b, int kdim, int gw,
           float* part, cudaStream_t st) {
  if (b_bf16) {
    if (vec == 8)
      return launch_steps_nc<__nv_bfloat16, 8, BF16ACC>(
          nc, s2, slot_ptr, part_ptr, n_steps, b, kdim, gw, part, st);
    if (vec == 1)
      return launch_steps_nc<__nv_bfloat16, 1, BF16ACC>(
          nc, s2, slot_ptr, part_ptr, n_steps, b, kdim, gw, part, st);
  } else {
    if (vec == 4)
      return launch_steps_nc<float, 4, BF16ACC>(nc, s2, slot_ptr, part_ptr,
                                                n_steps, b, kdim, gw, part, st);
    if (vec == 1)
      return launch_steps_nc<float, 1, BF16ACC>(nc, s2, slot_ptr, part_ptr,
                                                n_steps, b, kdim, gw, part, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool BF16ACC>
int epilogue(const float* part, const int* epi_ptr, const int* epi_part,
             const int* unperm, int m, int kdim, void* out, int out_bf16,
             cudaStream_t st) {
  // 16-byte loads of part need its rows on 16-byte boundaries
  if (kdim % 4 == 0 && reinterpret_cast<uintptr_t>(part) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(out) % 16 == 0) {
    if (out_bf16)
      return launch_epilogue<__nv_bfloat16, 4, BF16ACC>(
          part, epi_ptr, epi_part, unperm, m, kdim, out, st);
    return launch_epilogue<float, 4, BF16ACC>(part, epi_ptr, epi_part, unperm,
                                              m, kdim, out, st);
  }
  if (out_bf16)
    return launch_epilogue<__nv_bfloat16, 1, BF16ACC>(
        part, epi_ptr, epi_part, unperm, m, kdim, out, st);
  return launch_epilogue<float, 1, BF16ACC>(part, epi_ptr, epi_part, unperm, m,
                                            kdim, out, st);
}

}  // namespace

extern "C" {

// Partial output: part[p, :] for every run p of every step (a step's live
// slots are slots[slot_ptr[s] .. slot_ptr[s+1]), its runs part_ptr[s] ..).
// b is [n, kdim], f32 (b_bf16 == 0) or bf16. Lane mapping: vec 4 (f32) or
// 8 (bf16) for 16-byte gathers, which needs kdim % vec == 0 and b 16-byte
// aligned, else 1; gw lanes a step (8, 16 or 32); nc vectors a lane (1-4);
// ceil(kdim / (vec * gw * nc)) column panels. acc_bf16 != 0 accumulates as
// the executor's bf16 path (Acc<true>): part then holds bf16 values.
// Returns cudaError_t.
int awb_spmm_window(const int* slots, const int* slot_ptr,
                    const int* part_ptr, int n_steps, const void* b,
                    int b_bf16, int acc_bf16, int kdim, int vec, int gw,
                    int nc, float* part, void* stream) {
  if (n_steps == 0 || kdim == 0) return 0;
  if ((gw != 8 && gw != 16 && gw != 32) || kdim % vec != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int2* s2 = reinterpret_cast<const int2*>(slots);
  if (acc_bf16)
    return window<true>(b_bf16, vec, nc, s2, slot_ptr, part_ptr, n_steps, b,
                        kdim, gw, part, st);
  return window<false>(b_bf16, vec, nc, s2, slot_ptr, part_ptr, n_steps, b,
                       kdim, gw, part, st);
}

// out[row, :] = sum of part[epi_part[q], :] for q in the CSR segment of row
// unperm[row] (or row itself when unperm is null), in ascending q, cast to
// out's dtype (f32 when out_bf16 == 0, else bf16); acc_bf16 != 0 rounds the
// running sum to bf16 after each add. Returns cudaError_t.
int awb_spmm_epilogue(const float* part, const int* epi_ptr,
                      const int* epi_part, const int* unperm, int m, int kdim,
                      void* out, int out_bf16, int acc_bf16, void* stream) {
  if (m == 0 || kdim == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (acc_bf16)
    return epilogue<true>(part, epi_ptr, epi_part, unperm, m, kdim, out,
                          out_bf16, st);
  return epilogue<false>(part, epi_ptr, epi_part, unperm, m, kdim, out,
                         out_bf16, st);
}

}  // extern "C"
