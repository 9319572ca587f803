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
//   its score column after q.k, the value scale multiplies p (f32) before
//   P.V, after the row sum; no dequantized copy of the cache is built.
//
// Bound on an H100 SXM: the work is a few flops per cache byte, so it is
// bound by the KV bytes it reads, 2 * (tree_start + T_reg) * Hkv * D * elem
// bytes (+ 8 scale bytes per row when int8) over 3.35 TB/s (at 7B, a 331-row
// verify: 5.4 MB, 1.8 us in bf16; 2.7 MB + 85 KB, about 1 us in int8), summed
// over the slots of a batch.
//
// Design: the TPU grid has one program per KV head (32 programs at 7B), which
// would fill 32 of the 132 SMs at batch 1.  Here the cache is split along
// its length (flash-decoding): a partial kernel computes, per (kv head,
// 64-row chunk), the chunk's (row max, row sum, unnormalised P.V) for every
// query row and writes them to scratch; combine_kernel merges the partials
// per row.  The grid is sized from max_len, so the host never needs the live
// length: blocks whose chunk starts at or past tree_start + T_reg exit at
// once.  Two partial kernels write the same scratch layout:
//
//   partial_kernel_mma  <bf16 q, bf16 or int8 cache, D = 128>: the 7B path
//     (rows 1a and 1c over bf16 caches, 1b and 1c over the int8 cache of the
//     quantized mode).  Tensor cores.  One block per (kv head, chunk) reads
//     the chunk's K and V from device memory once, with 16-byte cp.async
//     into shared rows padded to D + 8 (the eight rows of an ldmatrix fall in
//     eight different bank groups; V's copy overlaps q.k).  Each of the 4
//     warps owns a tile of 16 query rows per pass (gs <= 64: one pass; GQA
//     with gs = 120: two): S = q.k with mma.sync.m16n8k16 (q and K fragments
//     by ldmatrix.x4, K's [n][k] rows are already the "col" operand), f32
//     scores times D^-0.5 after the product, mask and row max / sum in the
//     accumulator registers (quad shuffles), p repacked in registers as the
//     A operand of P.V (two 8-wide score tiles are one 16-wide k-step), V
//     fragments by ldmatrix.x4.trans, 64 f32 accumulators a thread.
//     bf16 cache: p rounded to bf16, as the plain version rounds it to the
//     value dtype.  int8 cache: the rows land raw in the V tile's shared
//     memory (free until P.V) and are converted to bf16 tiles there (exact:
//     |x| <= 127; V in place, after a barrier), beside the chunk's scale
//     rows; the key scale multiplies each score column with D^-0.5; the row
//     max and sum use p before the value scale, as JAX does; then p *
//     v_scale (f32) is split into bf16 hi + lo and P.V runs twice (hi.V +
//     lo.V), so p keeps about 16 bits where the plain version keeps f32 and
//     one bf16 rounding would keep 8.  P.V takes D in two halves there, so
//     both instantiations fit 128 registers and 52 KB: four blocks an SM.
//   partial_kernel  every other instantiation (f32 q, D = 16): CUDA cores.
//     One block per (kv head, chunk, group of 16 query rows) stages the
//     chunk's K and V widened to f32 (16-byte loads, all in flight at once;
//     an int8 chunk's scale rows beside its tiles) and runs scalar dot
//     products from shared memory.  Splitting the rows as well keeps GQA
//     (groups x S rows per head) from serialising in one block.
//
// No TMA or wgmma: a head has 30 query rows at the verify and wgmma's tile
// has 64; m16n8k16 fits them in two tiles.
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
constexpr int ROWS = 16;      // query rows per block (partial_kernel)
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

// ---- tensor-core partial kernel (bf16 q; bf16 or int8 cache; D = 128) ----

constexpr int QTILE = 16 * WARPS;  // query rows per pass: one 16-row tile a warp
constexpr int PAD = 8;             // bf16 of padding per shared row (16 bytes)

// bf16 K, V and q tiles; an int8 cache adds the chunk's two scale rows (its
// raw rows land in the V tile, which is free until P.V)
template <typename TC, int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (2 * TILE + QTILE) * (D + PAD) +
         (std::is_same<TC, int8_t>::value ? 2 * TILE * sizeof(float) : 0);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {  // all but the newest N groups landed
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix l / 8
// and receives elements (l / 4, 2 * (l % 4) + {0, 1}) of each (.trans: of each
// one's transpose).
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
// c[16x8] += a[16x16] . b[16x8], bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x = lo: the low half
  return *reinterpret_cast<const unsigned*>(&h);
}
// the two halves of a bf16 pair, widened to float
__device__ __forceinline__ float bf16_lo(unsigned h) { return __uint_as_float(h << 16); }
__device__ __forceinline__ float bf16_hi(unsigned h) { return __uint_as_float(h & 0xffff0000u); }

// Four int8 (byte b of w is element b) as two bf16 pairs, exactly: each byte
// with its sign bit flipped is x + 128, which byte_perm drops into the low
// mantissa byte of 2^23; one subtraction of 2^23 + 128 leaves x as a float.
__device__ __forceinline__ void i8x4_to_bf16(unsigned w, unsigned& lo, unsigned& hi) {
  constexpr unsigned TWO23 = 0x4b000000u;  // 2^23 as a float
  constexpr float BIAS = 8388736.f;        // 2^23 + 128
  const unsigned u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, TWO23, 0x7540)) - BIAS;
  const float f1 = __uint_as_float(__byte_perm(u, TWO23, 0x7541)) - BIAS;
  const float f2 = __uint_as_float(__byte_perm(u, TWO23, 0x7542)) - BIAS;
  const float f3 = __uint_as_float(__byte_perm(u, TWO23, 0x7543)) - BIAS;
  lo = pack_bf16(f0, f1);
  hi = pack_bf16(f2, f3);
}

// Copy NROWS rows of D elements (the first ``valid`` of them real) from
// device memory into shared rows of ``dst_stride`` elements, 16 bytes a
// cp.async.  bf16 rows past ``valid`` are zeroed here; int8 rows past it are
// left as they are (convert_i8 zeroes them).  The caller commits the group
// and waits for it.
template <typename T, int D, int NROWS>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src, int valid,
                                           T* __restrict__ dst, int dst_stride) {
  constexpr int PER = 16 / sizeof(T);
  constexpr int VPR = D / PER;  // 16-byte vectors per row
#pragma unroll
  for (int i = threadIdx.x; i < NROWS * VPR; i += THREADS) {
    const int row = i / VPR, vec = i % VPR;
    T* d = dst + row * dst_stride + vec * PER;
    if (row < valid) {
      cp_async16(d, src + (size_t)row * D + vec * PER);
    } else if constexpr (!std::is_same<T, int8_t>::value) {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// Convert TILE raw int8 rows of D (the first ``valid`` real, the rest zero)
// to bf16 rows of D + PAD.  Every thread reads its 16-byte vectors first and
// then writes them widened, 32 bytes each; IN_PLACE (the raw rows lie inside
// the destination tile): with a barrier between the reads and the writes.
template <int D, bool IN_PLACE>
__device__ __forceinline__ void convert_i8(const int8_t* src, int valid, __nv_bfloat16* dst) {
  constexpr int VPR = D / 16;
  constexpr int ITER = TILE * VPR / THREADS;
  static_assert(TILE * VPR % THREADS == 0, "whole vectors a thread");
  uint4 w[ITER];
#pragma unroll
  for (int it = 0; it < ITER; ++it) {
    const int i = threadIdx.x + it * THREADS;
    w[it] = i / VPR < valid ? *reinterpret_cast<const uint4*>(src + i * 16)
                            : make_uint4(0u, 0u, 0u, 0u);
  }
  if constexpr (IN_PLACE) __syncthreads();
#pragma unroll
  for (int it = 0; it < ITER; ++it) {
    const int i = threadIdx.x + it * THREADS;
    uint4 out[2];
    i8x4_to_bf16(w[it].x, out[0].x, out[0].y);
    i8x4_to_bf16(w[it].y, out[0].z, out[0].w);
    i8x4_to_bf16(w[it].z, out[1].x, out[1].y);
    i8x4_to_bf16(w[it].w, out[1].z, out[1].w);
    uint4* d = reinterpret_cast<uint4*>(dst + (i / VPR) * (D + PAD) + (i % VPR) * 16);
    d[0] = out[0];
    d[1] = out[1];
  }
}

// One block per (slot x kv head, chunk); the block walks over all query-row
// tiles of its head, one 16-row tile per warp per pass.  Heads vary fastest
// in the grid, as in partial_kernel.  Writes the same partials.  TC is the
// cache's type: bf16, or int8_t with per-row scales.
template <typename TC, int D>
__global__ void __launch_bounds__(THREADS) partial_kernel_mma(
    const __nv_bfloat16* __restrict__ q,  // [B * Hkv, GS, D]
    const TC* __restrict__ k,             // per slot [L?, Hkv, max_len, D]
    const TC* __restrict__ v,
    const float* __restrict__ k_scale,    // per slot [L?, Hkv, max_len] (int8 only)
    const float* __restrict__ v_scale,
    const uint8_t* __restrict__ mask,     // per slot [S, T_reg]
    const int* __restrict__ start_ptr,    // [B] committed prefix lengths
    const int* __restrict__ layer_ptr,    // [B] layer indices, or null (no layer dim)
    float* __restrict__ part_m,           // [B * Hkv, NC, GS] chunk row max
    float* __restrict__ part_l,           // [B * Hkv, NC, GS] chunk row sum
    float* __restrict__ part_acc,         // [B * Hkv, NC, GS, D] chunk P.V
    int hkv, int gs, int s_len, int t_reg, int max_len, long long layer_stride,
    long long scale_layer_stride, long long slot_stride, long long scale_slot_stride,
    long long mask_slot_stride, float scale) {
  static_assert(D % 16 == 0 && TILE % 16 == 0, "whole m16n8k16 steps");
  constexpr bool QUANT = std::is_same<TC, int8_t>::value;
  static_assert(QUANT || std::is_same<TC, __nv_bfloat16>::value, "bf16 or int8 cache");
  constexpr int LDS = D + PAD;
  const int bh = blockIdx.x;  // slot * hkv + kv head
  const int slot = bh / hkv;
  const int hk = bh % hkv;
  const int chunk = blockIdx.y;
  const int nc = gridDim.y;
  const int start = start_ptr[slot];
  const int total = min(start + t_reg, max_len);
  const int col0 = chunk * TILE;
  if (col0 >= total) return;  // past the live rows: nothing to read
  const int ncols = min(TILE, total - col0);
  const long long layer = layer_ptr ? layer_ptr[slot] : 0;
  mask += slot * mask_slot_stride;

  extern __shared__ __align__(16) unsigned char smem_mma[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_mma);  // [TILE][LDS]
  __nv_bfloat16* vs = ks + TILE * LDS;                             // [TILE][LDS]
  __nv_bfloat16* qs = vs + TILE * LDS;                             // [QTILE][LDS]
  // int8 cache only: the raw K and V rows in the V tile's space, and after
  // the q tile the key scales times D^-0.5 and the value scales (both zero
  // past ncols)
  static_assert(2 * TILE * D <= TILE * LDS * sizeof(__nv_bfloat16), "raw rows fit");
  int8_t* kraw = reinterpret_cast<int8_t*>(vs);                // [TILE][D]
  int8_t* vraw = kraw + TILE * D;                              // [TILE][D]
  float* ksc = reinterpret_cast<float*>(qs + QTILE * LDS);     // [TILE]
  float* vsc = ksc + TILE;                                     // [TILE]

  const size_t base = (size_t)(slot * slot_stride + layer * layer_stride) +
                      ((size_t)hk * max_len + col0) * D;
  const __nv_bfloat16* qh = q + (size_t)bh * gs * D;
  if constexpr (QUANT) {
    stage_rows<int8_t, D, TILE>(k + base, ncols, kraw, D);
    stage_rows<__nv_bfloat16, D, QTILE>(qh, min(QTILE, gs), qs, LDS);
    cp_async_commit();
    stage_rows<int8_t, D, TILE>(v + base, ncols, vraw, D);  // lands while q.k runs
    cp_async_commit();
    const size_t sbase = (size_t)(slot * scale_slot_stride + layer * scale_layer_stride) +
                         (size_t)hk * max_len + col0;
    const int c = threadIdx.x % TILE;  // one thread a key or value scale
    if (threadIdx.x < TILE) {
      ksc[c] = c < ncols ? k_scale[sbase + c] * scale : 0.f;
    } else {
      vsc[c] = c < ncols ? v_scale[sbase + c] : 0.f;
    }
  } else {
    stage_rows<__nv_bfloat16, D, TILE>(k + base, ncols, ks, LDS);
    stage_rows<__nv_bfloat16, D, QTILE>(qh, min(QTILE, gs), qs, LDS);
    cp_async_commit();
    stage_rows<__nv_bfloat16, D, TILE>(v + base, ncols, vs, LDS);  // lands while q.k runs
    cp_async_commit();
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // accumulator rows g, g + 8; columns 2t, 2t + 1
  const bool all_visible = col0 + TILE <= start;  // the whole chunk is committed prefix
  const size_t part_head = ((size_t)bh * nc + chunk) * gs;

  for (int p0 = 0; p0 < gs; p0 += QTILE) {
    if (p0 > 0) {
      __syncthreads();  // every warp has read the previous pass's q
      stage_rows<__nv_bfloat16, D, QTILE>(qh + (size_t)p0 * D, min(QTILE, gs - p0), qs, LDS);
      cp_async_commit();
      cp_async_wait<0>();
    } else {
      cp_async_wait<1>();  // K and q; V may still be in flight
      if constexpr (QUANT) {
        __syncthreads();
        convert_i8<D, false>(kraw, ncols, ks);
      }
    }
    __syncthreads();

    const int r0 = p0 + warp * 16;  // this warp's tile of query rows
    const bool active = r0 < gs;
    const int ra = r0 + g, rb = ra + 8;
    // p as bf16 A fragments, one per 16-column k-step; int8: p * v_scale
    // in two parts, pf (rounded to bf16) + pl (the rest, rounded to bf16)
    unsigned pf[TILE / 16][4];
    [[maybe_unused]] unsigned pl[TILE / 16][4];
    float m[2], l[2];
    if (active) {
      float sc[TILE / 8][4];
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        unsigned a[4];  // rows 0-7 / 8-15 at k 0-7, then at k 8-15
        ldmatrix_x4(a, qs + (warp * 16 + lane % 16) * LDS + kk * 16 + (lane / 16) * 8);
#pragma unroll
        for (int jp = 0; jp < TILE / 16; ++jp) {
          unsigned b[4];  // key rows 0-7 at k 0-7, k 8-15; key rows 8-15 likewise
          ldmatrix_x4(b, ks + (jp * 16 + lane % 8 + (lane / 16) * 8) * LDS + kk * 16 +
                             ((lane / 8) % 2) * 8);
          mma_bf16(sc[2 * jp], a, b[0], b[1]);
          mma_bf16(sc[2 * jp + 1], a, b[2], b[3]);
        }
      }

      // scale after the product, as the plain version (int8: times the key
      // scale of each column); then the visibility rule
      float csc[TILE / 8][2];  // the factor of columns j * 8 + 2t + {0, 1}
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j) {
        if constexpr (QUANT) {
          const float2 f = *reinterpret_cast<const float2*>(ksc + j * 8 + 2 * t);
          csc[j][0] = f.x;
          csc[j][1] = f.y;
        } else {
          csc[j][0] = csc[j][1] = scale;
        }
      }
      if (all_visible) {
#pragma unroll
        for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] *= csc[j][e % 2];
      } else {
        const uint8_t* mrow[2] = {mask + (size_t)(ra % s_len) * t_reg,
                                  mask + (size_t)(rb % s_len) * t_reg};
#pragma unroll
        for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = j * 8 + 2 * t + e % 2;
            const int col = col0 + c;
            const bool ok = (e < 2 ? ra : rb) < gs && c < ncols &&
                            (col < start || mrow[e / 2][col - start] != 0);
            sc[j][e] = ok ? sc[j][e] * csc[j][e % 2] : -INFINITY;
          }
      }

      // row max and sum over the quad's 4 x 16 columns
      m[0] = m[1] = -INFINITY;
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j) {
        m[0] = fmaxf(m[0], fmaxf(sc[j][0], sc[j][1]));
        m[1] = fmaxf(m[1], fmaxf(sc[j][2], sc[j][3]));
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
        m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 2));
      }
      l[0] = l[1] = 0.f;
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)  // a masked column contributes exactly 0,
          // also when the whole row is masked in this chunk (m = -inf)
          p[e] = sc[j][e] == -INFINITY ? 0.f : expf(sc[j][e] - m[e / 2]);
        l[0] += p[0] + p[1];  // before the value scale, as JAX sums p
        l[1] += p[2] + p[3];
        if constexpr (QUANT) {
          // the value row scales fold into p in f32, then hi + lo in bf16
          const float2 f = *reinterpret_cast<const float2*>(vsc + j * 8 + 2 * t);
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // rows g, then g + 8
            const float x0 = p[2 * h] * f.x, x1 = p[2 * h + 1] * f.y;
            const unsigned hi = pack_bf16(x0, x1);
            pf[j / 2][(j % 2) * 2 + h] = hi;
            pl[j / 2][(j % 2) * 2 + h] = pack_bf16(x0 - bf16_lo(hi), x1 - bf16_hi(hi));
          }
        } else {
          // p is rounded to the value dtype before P.V, as in the plain version
          pf[j / 2][(j % 2) * 2] = pack_bf16(p[0], p[1]);      // rows g
          pf[j / 2][(j % 2) * 2 + 1] = pack_bf16(p[2], p[3]);  // rows g + 8
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      }
    }

    if (p0 == 0) {
      cp_async_wait<0>();  // V
      __syncthreads();
      if constexpr (QUANT) {
        convert_i8<D, true>(vraw, ncols, vs);
        __syncthreads();
      }
    }

    if (active) {
      // int8: D in two halves, so pf, pl and one half's accumulators fit
      // in 128 registers (four blocks an SM, as the bf16 instantiation)
      constexpr int DH = QUANT ? D / 2 : D;
#pragma unroll
      for (int h0 = 0; h0 < D; h0 += DH) {
        float o[DH / 8][4];
#pragma unroll
        for (int j = 0; j < DH / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < TILE / 16; ++kk) {
#pragma unroll
          for (int jp = 0; jp < DH / 16; ++jp) {
            unsigned b[4];  // transposed: value rows (k) 0-7, 8-15 at d 0-7; then at d 8-15
            ldmatrix_x4_trans(b, vs + (kk * 16 + lane % 16) * LDS + h0 + jp * 16 +
                                     (lane / 16) * 8);
            mma_bf16(o[2 * jp], pf[kk], b[0], b[1]);
            mma_bf16(o[2 * jp + 1], pf[kk], b[2], b[3]);
            if constexpr (QUANT) {
              mma_bf16(o[2 * jp], pl[kk], b[0], b[1]);
              mma_bf16(o[2 * jp + 1], pl[kk], b[2], b[3]);
            }
          }
        }
        if (ra < gs) {
          if (t == 0 && h0 == 0) {
            part_m[part_head + ra] = m[0];
            part_l[part_head + ra] = l[0];
          }
          float2* dst = reinterpret_cast<float2*>(part_acc + (part_head + ra) * D + h0 + 2 * t);
#pragma unroll
          for (int j = 0; j < DH / 8; ++j) dst[j * 4] = make_float2(o[j][0], o[j][1]);
        }
        if (rb < gs) {
          if (t == 0 && h0 == 0) {
            part_m[part_head + rb] = m[1];
            part_l[part_head + rb] = l[1];
          }
          float2* dst = reinterpret_cast<float2*>(part_acc + (part_head + rb) * D + h0 + 2 * t);
#pragma unroll
          for (int j = 0; j < DH / 8; ++j) dst[j * 4] = make_float2(o[j][2], o[j][3]);
        }
      }
    }
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
  const float scale = 1.0f / sqrtf((float)D);
  // the attribute is set once per instantiation, not on every call
  if constexpr (std::is_same<T, __nv_bfloat16>::value && D == 128) {
    constexpr size_t smem = mma_smem_bytes<TC, D>();
    static const cudaError_t attr = cudaFuncSetAttribute(
        partial_kernel_mma<TC, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return (int)attr;
    partial_kernel_mma<TC, D><<<dim3(nslots * hkv, nc, 1), THREADS, smem, stream>>>(
        (const __nv_bfloat16*)q, (const TC*)k, (const TC*)v, (const float*)k_scale,
        (const float*)v_scale, (const uint8_t*)mask, (const int*)start, (const int*)layer,
        (float*)part_m, (float*)part_l, (float*)part_acc, hkv, gs, s_len, t_reg, max_len,
        layer_stride, scale_layer_stride, slot_stride, scale_slot_stride, mask_slot_stride,
        scale);
  } else {
    constexpr size_t smem = smem_bytes<D>();
    static const cudaError_t attr = cudaFuncSetAttribute(
        partial_kernel<T, TC, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return (int)attr;
    partial_kernel<T, TC, D>
        <<<dim3(nslots * hkv, nc, (gs + ROWS - 1) / ROWS), THREADS, smem, stream>>>(
            (const T*)q, (const TC*)k, (const TC*)v, (const float*)k_scale,
            (const float*)v_scale, (const uint8_t*)mask, (const int*)start,
            (const int*)layer, (float*)part_m, (float*)part_l, (float*)part_acc,
            hkv, gs, s_len, t_reg, max_len, layer_stride, scale_layer_stride,
            slot_stride, scale_slot_stride, mask_slot_stride, scale);
  }
  cudaError_t err = cudaGetLastError();
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
