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
// Design
//   Hopper runs thread blocks in no order, so nothing can be carried from
//   one step to the next across blocks. The schedule makes each window's
//   steps contiguous and sorted, so `awb_spmm_window` gives one block to each
//   (window, column tile) and loops over the window's step range
//   [win_ptr[w], win_ptr[w+1]). Thread t of the block owns column t of the
//   tile: for every slot, in slot order, it gathers B[gcol, col] (gcol =
//   min(cblk*CB + lcol, n-1)) and adds val*B into acc[lrow][t] in shared
//   memory, in f32. Neighbouring threads read neighbouring columns of one B
//   row, and every thread reads the same slot metadata (a broadcast). Each
//   accumulator element is summed by one thread in slot order, so the result
//   is deterministic. Padding slots have val == 0 and add nothing. With the
//   default geometry CB = n, so B cannot be staged in shared memory: rows
//   come from device memory through L2.
//
//   The block writes only the live slots of its window (row_map >= 0) to the
//   f32 permuted output. On real graphs a window holds a few rows of its R
//   slots, so most of the permuted output is dead and is neither written nor
//   read. `awb_spmm_epilogue` then gives one thread to each (output row,
//   column): it sums the row's live slots in ascending slot order (a CSR
//   built from row_map at upload), casts to B's dtype and writes the row,
//   optionally through the row un-permutation of a reordered schedule.
//   Unlike index_add_, whose float atomics sum in an order that changes from
//   run to run, the epilogue is deterministic.
//
//   The Pallas kernel adds each step into an output block of B's dtype; here
//   the whole window and the epilogue accumulate in f32 and round once.
//
// Bound
//   Memory. Per call the window kernel reads S = n_steps*K slots of 12 bytes
//   of metadata and S gathered B rows of kdim elements, and writes the live
//   slots of the permuted output in f32; the epilogue reads those back and
//   writes m*kdim elements. Compulsory traffic counts B once; when no gather
//   hits in cache, B traffic is S*kdim elements. The product needs 2*nnz*kdim
//   flops (padding slots are multiplied by 0 as well), far below the card's
//   f32 rate for these bytes.
//
// Known weakness: one block per window serializes a long window (up to a few
// hundred steps on reddit) on one SM, which brings back some of the
// imbalance the schedule removes; splitting long windows is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUnroll = 8;

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__global__ void spmm_window_kernel(const float* __restrict__ val,
                                   const int* __restrict__ lrow,
                                   const int* __restrict__ lcol,
                                   const int* __restrict__ cblk,
                                   const int* __restrict__ win_ptr,
                                   const int* __restrict__ row_map,
                                   const T* __restrict__ b, int n, int kdim,
                                   int k, int r, int cb,
                                   float* __restrict__ out_perm) {
  extern __shared__ float acc[];  // [r][blockDim.x]; thread t owns column t
  const int w = blockIdx.x;
  const int kt = blockDim.x;
  const int t = threadIdx.x;
  const int col = blockIdx.y * kt + t;
  const bool active = col < kdim;
  const int bcol = active ? col : 0;

  for (int i = 0; i < r; ++i) acc[i * kt + t] = 0.f;

  const int step_end = win_ptr[w + 1];
  for (int step = win_ptr[w]; step < step_end; ++step) {
    const int base = __ldg(cblk + step) * cb;
    const int64_t s0 = static_cast<int64_t>(step) * k;
    int j = 0;
    for (; j + kUnroll <= k; j += kUnroll) {
      float v[kUnroll], bv[kUnroll];
      int rr[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t s = s0 + j + u;
        v[u] = __ldg(val + s);
        rr[u] = __ldg(lrow + s);
        const int g = min(base + __ldg(lcol + s), n - 1);
        bv[u] = load_f32(b + static_cast<int64_t>(g) * kdim + bcol);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) acc[rr[u] * kt + t] += v[u] * bv[u];
    }
    for (; j < k; ++j) {
      const int64_t s = s0 + j;
      const int g = min(base + __ldg(lcol + s), n - 1);
      const float bv = load_f32(b + static_cast<int64_t>(g) * kdim + bcol);
      acc[__ldg(lrow + s) * kt + t] += __ldg(val + s) * bv;
    }
  }

  if (!active) return;
  const int64_t slot0 = static_cast<int64_t>(w) * r;
  for (int i = 0; i < r; ++i) {
    if (__ldg(row_map + slot0 + i) >= 0)
      out_perm[(slot0 + i) * kdim + col] = acc[i * kt + t];
  }
}

template <typename T>
__global__ void epilogue_kernel(const float* __restrict__ out_perm,
                                const int* __restrict__ epi_ptr,
                                const int* __restrict__ epi_slot,
                                const int* __restrict__ unperm, int m,
                                int kdim, T* __restrict__ out) {
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<int64_t>(m) * kdim) return;
  const int row = static_cast<int>(idx / kdim);
  const int col = static_cast<int>(idx % kdim);
  const int src = unperm != nullptr ? __ldg(unperm + row) : row;
  float sum = 0.f;
  const int end = __ldg(epi_ptr + src + 1);
  for (int p = __ldg(epi_ptr + src); p < end; ++p)
    sum += __ldg(out_perm + static_cast<int64_t>(__ldg(epi_slot + p)) * kdim +
                 col);
  store_from_f32(out + idx, sum);
}

template <typename T>
int launch_window(const float* val, const int* lrow, const int* lcol,
                  const int* cblk, const int* win_ptr, const int* row_map,
                  int n_windows, int k, int r, int cb, int n, const void* b,
                  int kdim, int kt, float* out_perm, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(r) * kt * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        spmm_window_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(n_windows, (kdim + kt - 1) / kt);
  spmm_window_kernel<T><<<grid, kt, smem, stream>>>(
      val, lrow, lcol, cblk, win_ptr, row_map, static_cast<const T*>(b), n,
      kdim, k, r, cb, out_perm);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_epilogue(const float* out_perm, const int* epi_ptr,
                    const int* epi_slot, const int* unperm, int m, int kdim,
                    void* out, cudaStream_t stream) {
  constexpr int kThreads = 256;
  const int64_t total = static_cast<int64_t>(m) * kdim;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  epilogue_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      out_perm, epi_ptr, epi_slot, unperm, m, kdim, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Permuted window output: out_perm[w*r + i, :] for every live slot (row_map
// >= 0) of every window w. b is [n, kdim], f32 (b_bf16 == 0) or bf16;
// kt threads per block, one per column of the tile. Returns cudaError_t.
int awb_spmm_window(const float* val, const int* lrow, const int* lcol,
                    const int* cblk, const int* win_ptr, const int* row_map,
                    int n_windows, int k, int r, int cb, int n, const void* b,
                    int b_bf16, int kdim, int kt, float* out_perm,
                    void* stream) {
  if (n_windows == 0 || kdim == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b_bf16)
    return launch_window<__nv_bfloat16>(val, lrow, lcol, cblk, win_ptr,
                                        row_map, n_windows, k, r, cb, n, b,
                                        kdim, kt, out_perm, st);
  return launch_window<float>(val, lrow, lcol, cblk, win_ptr, row_map,
                              n_windows, k, r, cb, n, b, kdim, kt, out_perm,
                              st);
}

// out[row, :] = sum of out_perm[epi_slot[p], :] for p in the CSR segment of
// row unperm[row] (or row itself when unperm is null), cast to out's dtype
// (f32 when out_bf16 == 0, else bf16). Returns cudaError_t.
int awb_spmm_epilogue(const float* out_perm, const int* epi_ptr,
                      const int* epi_slot, const int* unperm, int m, int kdim,
                      void* out, int out_bf16, void* stream) {
  if (m == 0 || kdim == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    return launch_epilogue<__nv_bfloat16>(out_perm, epi_ptr, epi_slot, unperm,
                                          m, kdim, out, st);
  return launch_epilogue<float>(out_perm, epi_ptr, epi_slot, unperm, m, kdim,
                                out, st);
}

}  // extern "C"
