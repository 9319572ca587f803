// Length-aware tree-verify / decode attention over the preallocated KV cache,
// for Hopper (sm_90a).  Built by vispec_tpu_torch/ops/verify_attention.py with
// nvcc into a shared library with a plain C interface, loaded with ctypes.
//
// Replaces the Pallas TPU kernel vispec_tpu/ops/pallas_attention.py::_kernel
// (built by _build_call, entered through verify_attention) in all three of
// its forms: a single request over bf16/f32 caches (table row 1a), over int8
// caches with per-row f32 scales (``quantized=True``, row 1b), and the
// batched grid (``batched=True``, the custom_vmap rule, row 1c), in which
// every slot of a batch carries its own cache, region mask, tree_start and
// layer index.  Same contract, per slot:
//   q [H, S, D]; cache [L?, Hkv, max_len, D]; tree_start and layer_idx read
//   from device memory; region mask [S, T_reg] (bool bytes).  Query row s of
//   head h sees every column < tree_start and region column tree_start + t
//   where mask[s, t]; nothing at or past tree_start + T_reg is read.  Head h
//   uses kv-head h / groups, rows group-major (row = g * S + s).  Scale
//   D^-0.5, f32 scores, online softmax and accumulator, output in q's dtype.
//   An int8 cache carries scales [L?, Hkv, max_len]: the key scale multiplies
//   its score column after q.k, the value scale multiplies p (f32, not
//   rounded) before P.V; no dequantized copy of the cache is built.
//
// Bound on an H100 SXM: the work is a few flops per cache byte, so it is
// bound by the KV bytes it reads, 2 * (tree_start + T_reg) * Hkv * D * elem
// bytes (+ 8 scale bytes per row when int8) over 3.35 TB/s (at 7B, a 331-row
// verify: 5.4 MB, 1.8 us in bf16; 2.7 MB + 85 KB, about 1 us in int8), summed
// over the slots of a batch.
//
// Design: the TPU grid has one program per KV head (32 programs at 7B), which
// would fill 32 of the 132 SMs at batch 1.  Here the cache is split along
// its length (flash-decoding): one block per (kv head, 64-row chunk, group of
// 16 query rows) stages the chunk's K and V in shared memory, computes the
// chunk's partial (max, sum, P.V) for its rows, and writes them to scratch;
// a second kernel merges the partials per row.  Splitting the rows as well
// keeps GQA (groups x S rows per head) from serialising in one block.  The
// grid is sized from max_len, so the host never needs the live length:
// blocks whose chunk starts at or past tree_start + T_reg exit at once.
// Staging uses 16-byte loads, all in flight at once (8 bf16, 4 f32 or 16
// int8 values each), widened to f32 in registers; an int8 chunk's scale rows
// are staged in shared memory beside its tiles.  Plain CUDA cores, no tensor
// cores or TMA yet.
//
// Batched grid (row 1c): the slot is folded into grid.x (slot * Hkv + kv
// head, heads fastest), so one launch pair serves the whole batch and the
// grid grows with B, where the TPU grid is (B, Hkv).  q, the output and the
// partials are [B * Hkv, ...] and need no slot stride; the cache, its scales
// and the mask are offset by the slot strides the caller gives, and each
// block reads its slot's tree_start and layer index from device memory.  A
// single request is the batch of one with zero slot strides.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int TILE = 64;      // KV rows per block (one split-KV chunk)
constexpr int ROWS = 16;      // query rows per block
constexpr int THREADS = 128;
constexpr int RSTEP = THREADS / TILE;  // query rows a column-thread steps by
constexpr int WARPS = THREADS / 32;
static_assert(TILE == 64, "the row statistics give each lane two columns");
static_assert(THREADS == 2 * TILE, "one thread stages each key and value scale");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16-byte vectors of the input dtype, widened to float
template <typename T> __device__ __forceinline__ void unpack(const uint4& u, float* out);
template <> __device__ __forceinline__ void unpack<float>(const uint4& u, float* out) {
  out[0] = __uint_as_float(u.x);
  out[1] = __uint_as_float(u.y);
  out[2] = __uint_as_float(u.z);
  out[3] = __uint_as_float(u.w);
}
template <> __device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& u, float* out) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // little-endian: element 2i is the low half
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
template <> __device__ __forceinline__ void unpack<int8_t>(const uint4& u, float* out) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int b = 0; b < 4; ++b)  // element 4i + b is byte b of word i
      out[4 * i + b] = (float)(int8_t)((w[i] >> (8 * b)) & 0xffu);
}

// Copy NROWS rows of D elements (the first ``valid`` of them real, the rest
// zero) from device memory into float shared memory rows of ``dst_stride``,
// times ``scale``.  All of a thread's 16-byte loads are issued before any is
// used, so their latencies overlap.
template <typename T, int D, int NROWS>
__device__ __forceinline__ void stage(const T* __restrict__ src, int valid,
                                      float* __restrict__ dst, int dst_stride,
                                      float scale) {
  constexpr int PER = 16 / sizeof(T);
  constexpr int VPR = D / PER;  // vectors per row
  constexpr int TOTAL = NROWS * VPR;
  constexpr int ITER = (TOTAL + THREADS - 1) / THREADS;
  static_assert(D % PER == 0, "a row is a whole number of 16-byte vectors");
  uint4 buf[ITER];
#pragma unroll
  for (int it = 0; it < ITER; ++it) {
    const int v = threadIdx.x + it * THREADS;
    buf[it] = (v < TOTAL && v / VPR < valid)
                  ? __ldg(reinterpret_cast<const uint4*>(src + (size_t)(v / VPR) * D) + v % VPR)
                  : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int it = 0; it < ITER; ++it) {
    const int v = threadIdx.x + it * THREADS;
    if (v < TOTAL) {
      float f[PER];
      unpack<T>(buf[it], f);
      float* row = dst + (v / VPR) * dst_stride + (v % VPR) * PER;
#pragma unroll
      for (int e = 0; e < PER; ++e) row[e] = f[e] * scale;
    }
  }
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (TILE * (D + 1) + TILE * D + ROWS * D + ROWS * TILE + 2 * TILE);
}

// One block per (kv head, chunk, group of ROWS query rows).  Heads vary
// fastest, so the live chunks at the front of the cache are scheduled first
// and the blocks past the live rows come last.  T is q's and the output's
// type, TC the cache's (T, or int8_t with per-row scales).
template <typename T, typename TC, int D>
__global__ void __launch_bounds__(THREADS) partial_kernel(
    const T* __restrict__ q,            // [B * Hkv, GS, D]
    const TC* __restrict__ k,           // per slot [L?, Hkv, max_len, D]
    const TC* __restrict__ v,
    const float* __restrict__ k_scale,  // per slot [L?, Hkv, max_len] (int8 only)
    const float* __restrict__ v_scale,
    const uint8_t* __restrict__ mask,   // per slot [S, T_reg]
    const int* __restrict__ start_ptr,  // [B] committed prefix lengths
    const int* __restrict__ layer_ptr,  // [B] layer indices, or null (no layer dim)
    float* __restrict__ part_m,         // [B * Hkv, NC, GS] chunk row max
    float* __restrict__ part_l,         // [B * Hkv, NC, GS] chunk row sum
    float* __restrict__ part_acc,       // [B * Hkv, NC, GS, D] chunk P.V
    int hkv, int gs, int s_len, int t_reg, int max_len, long long layer_stride,
    long long scale_layer_stride, long long slot_stride,
    long long scale_slot_stride, long long mask_slot_stride, float scale) {
  constexpr bool QUANT = std::is_same<TC, int8_t>::value;
  const int bh = blockIdx.x;  // slot * hkv + kv head
  const int slot = bh / hkv;
  const int hk = bh % hkv;
  const int chunk = blockIdx.y;
  const int nc = gridDim.y;
  const int r0 = blockIdx.z * ROWS;
  const int nr = min(ROWS, gs - r0);
  const int start = start_ptr[slot];
  const int total = min(start + t_reg, max_len);
  const int col0 = chunk * TILE;
  if (col0 >= total) return;  // past the live rows: nothing to read
  const int ncols = min(TILE, total - col0);
  const long long layer = layer_ptr ? layer_ptr[slot] : 0;
  mask += slot * mask_slot_stride;

  extern __shared__ float smem[];
  float* ks = smem;                 // [TILE][D + 1] (padded: column reads)
  float* vs = ks + TILE * (D + 1);  // [TILE][D]
  float* qs = vs + TILE * D;        // [ROWS][D], pre-scaled
  float* ps = qs + ROWS * D;        // [ROWS][TILE] scores, then probabilities
  float* ksc = ps + ROWS * TILE;    // [TILE] key row scales (int8 cache)
  float* vsc = ksc + TILE;          // [TILE] value row scales

  const int tid = threadIdx.x;
  const size_t base = (size_t)(slot * slot_stride + layer * layer_stride) +
                      ((size_t)hk * max_len + col0) * D;
  stage<TC, D, TILE>(k + base, ncols, ks, D + 1, 1.f);
  stage<TC, D, TILE>(v + base, ncols, vs, D, 1.f);
  stage<T, D, ROWS>(q + ((size_t)bh * gs + r0) * D, nr, qs, D, scale);
  if constexpr (QUANT) {
    const size_t sbase = (size_t)(slot * scale_slot_stride + layer * scale_layer_stride) +
                         (size_t)hk * max_len + col0;
    const int c = tid % TILE;
    const float* src = tid < TILE ? k_scale : v_scale;
    (tid < TILE ? ksc : vsc)[c] = c < ncols ? src[sbase + c] : 0.f;
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  const size_t part_row0 = ((size_t)bh * nc + chunk) * gs + r0;

  // scores: this thread owns column c for rows rr, rr + RSTEP, ...
  {
    const int c = tid % TILE;
    const int rr = tid / TILE;
    float acc[ROWS / RSTEP];
#pragma unroll
    for (int j = 0; j < ROWS / RSTEP; ++j) acc[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float kd = ks[c * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < ROWS / RSTEP; ++j) acc[j] += qs[(rr + j * RSTEP) * D + d] * kd;
    }
    const int col = col0 + c;
#pragma unroll
    for (int j = 0; j < ROWS / RSTEP; ++j) {
      const int r = rr + j * RSTEP;
      bool ok = false;
      if (r < nr && c < ncols) {
        if (col < start) {
          ok = true;
        } else {
          const int s = (r0 + r) % s_len;
          ok = mask[(size_t)s * t_reg + (col - start)] != 0;
        }
      }
      // int8: the key scale is constant over the contracted D axis
      ps[r * TILE + c] = ok ? (QUANT ? acc[j] * ksc[c] : acc[j]) : -INFINITY;
    }
  }
  __syncthreads();

  // chunk softmax statistics: one warp per row, two columns per lane
  for (int r = warp; r < nr; r += WARPS) {
    const float a = ps[r * TILE + lane], b = ps[r * TILE + lane + 32];
    float m = fmaxf(a, b);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    // masked columns contribute exactly 0 (also when the whole row is masked)
    const float pa = a == -INFINITY ? 0.f : expf(a - m);
    const float pb = b == -INFINITY ? 0.f : expf(b - m);
    float l = pa + pb;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if constexpr (QUANT) {
      // the value row scales fold into p (f32), constant over P.V's rows
      ps[r * TILE + lane] = pa * vsc[lane];
      ps[r * TILE + lane + 32] = pb * vsc[lane + 32];
    } else {
      // p is rounded to the value dtype before P.V, as in the plain version
      ps[r * TILE + lane] = to_f(from_f<T>(pa));
      ps[r * TILE + lane + 32] = to_f(from_f<T>(pb));
    }
    if (lane == 0) {
      part_m[part_row0 + r] = m;
      part_l[part_row0 + r] = l;
    }
  }
  __syncthreads();

  for (int i = tid; i < nr * D; i += THREADS) {
    const int r = i / D, d = i % D;
    float a = 0.f;
#pragma unroll 8
    for (int c = 0; c < ncols; ++c) a += ps[r * TILE + c] * vs[c * D + d];
    part_acc[(part_row0 + r) * D + d] = a;
  }
}

// One block per (slot, kv head, query row), one thread per head-dim element.
template <typename T, int D>
__global__ void __launch_bounds__(D) combine_kernel(
    const float* __restrict__ part_m, const float* __restrict__ part_l,
    const float* __restrict__ part_acc, T* __restrict__ out,  // [B * Hkv, GS, D]
    const int* __restrict__ start_ptr, int hkv, int gs, int t_reg, int max_len,
    int nc) {
  const int row = blockIdx.x;  // (slot * hkv + hk) * gs + r
  const int hk = row / gs, r = row % gs;  // hk counts over slots and heads
  const int d = threadIdx.x;
  const int total = min(start_ptr[hk / hkv] + t_reg, max_len);
  const int live = min(nc, (total + TILE - 1) / TILE);
  float m_max = -INFINITY;
  for (int c = 0; c < live; ++c) m_max = fmaxf(m_max, part_m[((size_t)hk * nc + c) * gs + r]);
  float l = 0.f, acc = 0.f;
  if (m_max != -INFINITY) {
    for (int c = 0; c < live; ++c) {
      const size_t idx = ((size_t)hk * nc + c) * gs + r;
      const float m = part_m[idx];
      if (m == -INFINITY) continue;
      const float w = expf(m - m_max);
      l += part_l[idx] * w;
      acc += part_acc[idx * D + d] * w;
    }
  }
  out[(size_t)row * D + d] = from_f<T>(acc / fmaxf(l, 1e-20f));
}

template <typename T, typename TC, int D>
int launch(const void* q, const void* k, const void* v, const void* k_scale,
           const void* v_scale, const void* mask, const void* start,
           const void* layer, void* part_m, void* part_l, void* part_acc,
           void* out, int nslots, int hkv, int gs, int s_len, int t_reg,
           int max_len, long long layer_stride, long long scale_layer_stride,
           long long slot_stride, long long scale_slot_stride,
           long long mask_slot_stride, cudaStream_t stream) {
  const int nc = (max_len + TILE - 1) / TILE;
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      partial_kernel<T, TC, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  partial_kernel<T, TC, D>
      <<<dim3(nslots * hkv, nc, (gs + ROWS - 1) / ROWS), THREADS, smem, stream>>>(
          (const T*)q, (const TC*)k, (const TC*)v, (const float*)k_scale,
          (const float*)v_scale, (const uint8_t*)mask, (const int*)start,
          (const int*)layer, (float*)part_m, (float*)part_l, (float*)part_acc,
          hkv, gs, s_len, t_reg, max_len, layer_stride, scale_layer_stride,
          slot_stride, scale_slot_stride, mask_slot_stride,
          1.0f / sqrtf((float)D));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  combine_kernel<T, D><<<nslots * hkv * gs, D, 0, stream>>>(
      (const float*)part_m, (const float*)part_l, (const float*)part_acc,
      (T*)out, (const int*)start, hkv, gs, t_reg, max_len, nc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Chunk length of the split; the caller sizes the scratch from it.
int vispec_verify_attention_tile() { return TILE; }

// Returns a cudaError_t code (0 on success), or -1 for an unsupported
// head_dim / dtype pair.  q and the output are bf16 (is_bf16) or f32; the
// cache is q's type, or int8 (cache_int8) with scales k_scale / v_scale
// (null otherwise).  ``nslots`` requests at once: start and layer hold one
// int32 per slot, and slot b's cache, scales and mask begin ``b *
// *_slot_stride`` elements after the given pointers (all strides 0 for a
// single request).  Launches on ``stream``; does not synchronise.
int vispec_verify_attention(const void* q, const void* k, const void* v,
                            const void* k_scale, const void* v_scale,
                            const void* mask, const void* start,
                            const void* layer, void* part_m, void* part_l,
                            void* part_acc, void* out, int nslots, int hkv,
                            int gs, int s_len, int t_reg, int max_len,
                            long long layer_stride,
                            long long scale_layer_stride,
                            long long slot_stride, long long scale_slot_stride,
                            long long mask_slot_stride, int head_dim,
                            int is_bf16, int cache_int8, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define VISPEC_LAUNCH(T, TC, D)                                                 \
  return launch<T, TC, D>(q, k, v, k_scale, v_scale, mask, start, layer,       \
                          part_m, part_l, part_acc, out, nslots, hkv, gs,      \
                          s_len, t_reg, max_len, layer_stride,                 \
                          scale_layer_stride, slot_stride, scale_slot_stride,  \
                          mask_slot_stride, st)
#define VISPEC_HEAD_DIMS(T, TC)                \
  if (head_dim == 16) VISPEC_LAUNCH(T, TC, 16); \
  if (head_dim == 128) VISPEC_LAUNCH(T, TC, 128);
  if (is_bf16) {
    if (cache_int8) {
      VISPEC_HEAD_DIMS(__nv_bfloat16, int8_t)
    } else {
      VISPEC_HEAD_DIMS(__nv_bfloat16, __nv_bfloat16)
    }
  } else {
    if (cache_int8) {
      VISPEC_HEAD_DIMS(float, int8_t)
    } else {
      VISPEC_HEAD_DIMS(float, float)
    }
  }
#undef VISPEC_HEAD_DIMS
#undef VISPEC_LAUNCH
  return -1;
}

}  // extern "C"
