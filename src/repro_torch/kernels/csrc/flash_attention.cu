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
// Design
//   Hopper runs thread blocks in no order, so one block owns a (batch·head,
//   64-query tile) and loops over the kv tiles itself. The loop bounds take
//   the place of the Pallas kernel's pl.when block skip: the loop starts at
//   the first key inside the window of the tile's first query and stops after
//   the last key the causal mask shows its last query. Per element the masks
//   are the Pallas kernel's (k < Sk, causal k <= q, window k > q - W), with the
//   same finite -1e30 and the same clamp of l at 1e-30, so rows match it.
//
//   Q, K and V are read in their [B, S, H, D] layout (row stride H·D or
//   Hkv·D): no padded or transposed copy is made, and the ragged edge of the
//   last tile is loaded as zeros and masked. Query head h reads kv head
//   h / (H/Hkv), taken from blockIdx, so kv heads are never replicated.
//
//   128 threads = 16 row groups × 8 lanes. Thread (g, j) owns query rows
//   4g..4g+3; it computes the scores of those rows against kv columns
//   j, j+8, …, and output columns j, j+8, … of those rows. The Q tile stays in
//   shared memory for the whole loop; each K and V tile is staged there, in
//   f32 with rows padded by one word, so the column reads of a warp hit
//   distinct banks or broadcast. A row's max is combined over its 8 lanes
//   with xor shuffles; each lane keeps a partial l, summed the same way once
//   at the end. P goes through shared memory (the 8 lanes of a row group sit
//   in one warp, so __syncwarp orders it) and the PV product adds keys in kv
//   order. Every output element is summed by one thread in a fixed order, so
//   repeated calls are bit-equal. All arithmetic is f32 on CUDA cores; the
//   output is cast to q's dtype.
//
// Bound
//   Operations at the main path's shapes: 4·D flops per visible (query, key)
//   pair against reading q, k, v and writing o once. At B 4, S 2048, H 14,
//   D 64, causal, that is 30 GFLOP against 18 MB: 0.45 ms at 67 TFLOP/s f32
//   (non-tensor) against 5 µs of HBM traffic. This kernel stays on CUDA
//   cores, and each thread loads 12 words from shared memory for every 32 FMAs,
//   so shared-memory bandwidth, not the FMA rate, limits it; tensor cores
//   (mma.sync / wgmma on bf16 tiles) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the Pallas kernel's NEG_INF
constexpr int kBQ = 64;            // query rows per block
constexpr int kThreads = 128;      // 16 row groups x 8 lanes
constexpr int kRows = kBQ / 16;    // query rows per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D, int BK>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * (D + 1) + 2 * BK * (D + 1) + kBQ * (BK + 1));
}

template <typename T, int D, int BK>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int sq, int sk,
                       int h, int hkv, int causal, int window, float scale) {
  constexpr int DP = D + 1;  // padded row strides
  constexpr int BKP = BK + 1;
  constexpr int kCols = BK / 8;   // score columns per thread
  constexpr int kDCols = D / 8;   // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;            // [kBQ][DP]
  float* ks = qs + kBQ * DP;   // [BK][DP]
  float* vs = ks + BK * DP;    // [BK][DP]
  float* ps = vs + BK * DP;    // [kBQ][BKP]

  const int tid = threadIdx.x;
  const int row0 = (tid >> 3) * kRows;  // first query row of this thread in the tile
  const int lane8 = tid & 7;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int b = blockIdx.y / h, hi = blockIdx.y % h;
  const int hk = hi / (h / hkv);
  const int q0 = qt * kBQ;
  const int off = sk - sq;

  const long long q_row = (long long)h * D, kv_row = (long long)hkv * D;
  const T* qb = q + (long long)b * sq * q_row + (long long)hi * D;
  const T* kb = k + (long long)b * sk * kv_row + (long long)hk * D;
  const T* vb = v + (long long)b * sk * kv_row + (long long)hk * D;
  T* ob = o + (long long)b * sq * q_row + (long long)hi * D;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D, qi = q0 + r;
    qs[r * DP + c] = qi < sq ? to_f32(qb[qi * q_row + c]) : 0.f;
  }

  // keys visible to some query of the tile
  const int q_first = q0 + off;
  const int q_last = min(q0 + kBQ, sq) - 1 + off;
  const int kv_lo = window > 0 ? max(0, q_first - window + 1) : 0;
  const int kv_hi = causal ? min(sk, q_last + 1) : sk;

  float m[kRows], l[kRows], acc[kRows][kDCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jd = 0; jd < kDCols; ++jd) acc[i][jd] = 0.f;
  }

  for (int k0 = kv_lo; k0 < kv_hi; k0 += BK) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
    for (int idx = tid; idx < BK * D; idx += kThreads) {
      const int r = idx / D, c = idx % D, kj = k0 + r;
      const bool in = kj < sk;
      ks[r * DP + c] = in ? to_f32(kb[kj * kv_row + c]) : 0.f;
      vs[r * DP + c] = in ? to_f32(vb[kj * kv_row + c]) : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(row0 + i) * DP + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = ks[(lane8 + 8 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + row0 + i + off;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + lane8 + 8 * j;
        bool ok = kpos < sk;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(row0 + i) * BKP + lane8 + 8 * j] = p;
        rs += p;
      }
      l[i] = corr * l[i] + rs;
#pragma unroll
      for (int jd = 0; jd < kDCols; ++jd) acc[i][jd] *= corr;
      m[i] = m_new;
    }
    __syncwarp();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float vv[kDCols];
#pragma unroll
      for (int jd = 0; jd < kDCols; ++jd) vv[jd] = vs[c * DP + lane8 + 8 * jd];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = ps[(row0 + i) * BKP + c];
#pragma unroll
        for (int jd = 0; jd < kDCols; ++jd) acc[i][jd] = fmaf(p, vv[jd], acc[i][jd]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    float lt = l[i];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    lt += __shfl_xor_sync(0xffffffffu, lt, 4);
    lt = fmaxf(lt, 1e-30f);
    const int qi = q0 + row0 + i;
    if (qi < sq) {
#pragma unroll
      for (int jd = 0; jd < kDCols; ++jd)
        store_from_f32(&ob[qi * q_row + lane8 + 8 * jd], acc[i][jd] / lt);
    }
  }
}

template <typename T, int D, int BK>
int launch(const void* q, const void* k, const void* v, void* o, int b, int sq,
           int sk, int h, int hkv, int causal, int window, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, BK>();
  auto kern = flash_attention_kernel<T, D, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + kBQ - 1) / kBQ, b * h);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), sq, sk, h, hkv, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int b, int sq,
             int sk, int h, int hkv, int d, int causal, int window, float scale,
             cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16, 64>(q, k, v, o, b, sq, sk, h, hkv, causal, window, scale, stream);
    case 32: return launch<T, 32, 64>(q, k, v, o, b, sq, sk, h, hkv, causal, window, scale, stream);
    case 64: return launch<T, 64, 64>(q, k, v, o, b, sq, sk, h, hkv, causal, window, scale, stream);
    case 128: return launch<T, 128, 32>(q, k, v, o, b, sq, sk, h, hkv, causal, window, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: contiguous [b, sq, h, d]; k, v: contiguous [b, sk, hkv, d]; all float32
// (bf16 == 0) or all bfloat16. window <= 0 means no window. Returns the
// cudaError_t of the launch.
extern "C" int awb_flash_attention(const void* q, const void* k, const void* v,
                                   void* o, int b, int sq, int sk, int h, int hkv,
                                   int d, int causal, int window, float scale,
                                   int bf16, void* stream) {
  if (b <= 0 || sq <= 0 || h <= 0 || hkv <= 0 || h % hkv != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, b, sq, sk, h, hkv, d, causal, window, scale, s);
  return dispatch<float>(q, k, v, o, b, sq, sk, h, hkv, d, causal, window, scale, s);
}
