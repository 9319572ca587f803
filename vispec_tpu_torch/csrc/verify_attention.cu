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
// verify: 5.4 MB, 1.8 us in bf16, 3.5 us in f32; 2.7 MB + 85 KB, about 1 us
// in int8), summed over the slots of a batch.
//
// Design: the TPU grid has one program per KV head (32 programs at 7B), which
// would fill 32 of the 132 SMs at batch 1.  Here the cache is also split
// along its length into 64-row chunks (flash-decoding), and the split is
// reduced inside the one launch:
//
//   partial_kernel_mma  <T = bf16 or float q, TC = T or int8 cache, D = 128>:
//     every model the port serves (Vicuna, LLaVA, Qwen2.5-VL and Mixtral all
//     have head dim 128), rows 1a, 1b and 1c.  Tensor cores.
//   - Grid and reduction.  One thread-block cluster per (slot x kv head, 64
//     query rows), CLUSTER = 8 blocks (the portable size; 16 was measured
//     slower) along grid.y.  Block r walks the live chunks r, r + 8, ...
//     (the live end read from tree_start on the device: the host never reads
//     it, and a block with no live chunk does no loads), keeping an online
//     softmax (row max, row sum, unnormalised P.V) for its query rows in
//     registers.  Then each block leaves its rows' (m, l, acc) in its own
//     shared memory, the cluster syncs, and block r reduces its share of the rows over the cluster's
//     blocks in rank order through distributed shared memory and writes the
//     output in q's dtype.  No atomics and no partials in device memory: a
//     run is reproducible bit for bit, and a slot of a batch equals the same
//     request alone.
//   - Staging.  The chunk's K and V rows go by 16-byte cp.async into a K and
//     a V tile, each a cp.async group: the next chunk's K lands while this
//     chunk's P.V runs, its V while the next q.k runs.  Rows are padded
//     against bank conflicts (bf16 D + 8, f32 D + 4, int8 read in place D +
//     16 bytes); rows past the live end are never read (bf16 and f32 tiles
//     zeroed there).  Each of the 4 warps owns a tile of 16 query rows; a
//     head with more than 64 rows (GQA: gs = 120, Qwen's 210) has a cluster
//     for each 64 of them (grid.z), which reads the chunks again, mostly from
//     L2.
//   - bf16 q: S = q.k with mma.sync.m16n8k16 (q and K fragments by
//     ldmatrix.x4), f32 scores times D^-0.5 after the product, p repacked in
//     registers as the A operand of P.V (two 8-wide score tiles are one
//     16-wide k-step), V by ldmatrix.x4.trans.  bf16 cache: p rounded to
//     bf16, as the plain version rounds it to the value dtype.  int8 cache:
//     the raw rows converted to a bf16 tile in shared memory (exact: |x| <=
//     127), the key scale multiplying each score column with D^-0.5, the row
//     sum taken before the value scale, as JAX does, and p * v_scale (f32)
//     split into bf16 hi + lo, P.V run twice (hi.V + lo.V).
//   - float32 q: mma.sync.m16n8k8 in tf32, 3xTF32: each operand x split into
//     hi = tf32(x) and lo = tf32(x - hi), hi.hi + hi.lo + lo.hi summed in f32,
//     which keeps float32's accuracy (one tf32 product keeps about three
//     digits).  An int8 row is exact in tf32, so over an int8 cache only q and
//     p carry a lo term (two products) and the raw rows are read in place.
//     The score fragment (columns 2t, 2t + 1) is P.V's A fragment when the
//     mma's k index t stands for column 2t and t + 4 for 2t + 1, so p goes
//     from registers to the tensor cores and V's rows are read in that order.
//     The two f32 tiles and the q tile take 99 KB: two blocks an SM.  (The
//     kernel it replaced, on CUDA cores, staged the chunk again for every 16
//     query rows.)
//   partial_kernel + combine_kernel  head dim 16 (toy widths only): CUDA
//     cores.  One block per (kv head, chunk, group of 16 query rows) stages
//     the chunk's K and V widened to f32 and writes the chunk's (row max,
//     row sum, P.V) to float32 scratch; combine_kernel merges them per row.
//
// No TMA or wgmma: a head has 30 query rows at the verify and wgmma's tile
// has 64; m16n8k16 fits them in two tiles.
//
// Batched grid (row 1c): the slot is folded into grid.x (slot * Hkv + kv
// head), so one launch serves the whole batch and the grid grows with B,
// where the TPU grid is (B, Hkv).  q and the output are [B * Hkv, ...] and
// need no slot stride; the cache, its scales and the mask are offset by the
// slot strides the caller gives, and each block reads its slot's tree_start
// and layer index from device memory.  A single request is the batch of one
// with zero slot strides.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

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

// ---- tensor-core kernel (D = 128): bf16 or f32 q over its own or an int8 cache ----

constexpr int QTILE = 16 * WARPS;  // query rows a block: one 16-row tile a warp
constexpr int PAD = 8;             // bf16 of padding per shared bf16 row (16 bytes)
constexpr int CLUSTER = 8;         // blocks of a cluster along the chunks (portable size)

// Shared memory of partial_kernel_mma<T, TC, D>, in bytes: a K tile and a V
// tile of the cache as staged (bf16 rows of D + 8, f32 rows of D + 4, raw
// int8 rows of D (bf16 q: converted into a bf16 tile) or D + 16 bytes (f32 q:
// read in place)), the bf16 conversion tile (bf16 q over int8 only), the q
// tile, and an int8 cache's key and value scales of the chunk.  After a
// pass's chunks the same bytes hold the block's (acc, m, l) of every query
// row for the cluster's reduction.
template <typename T, typename TC, int D>
struct MmaLayout {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr bool QUANT = std::is_same<TC, int8_t>::value;
  static constexpr int LDQ = F32 ? D + 4 : D + PAD;                       // T a q row
  static constexpr int LDC = QUANT ? (F32 ? D + 16 : D) : (F32 ? D + 4 : D + PAD);  // TC
  static constexpr int LDA = D + 8;                                       // f32 an acc row
  static constexpr size_t TILE_BYTES = (size_t)TILE * LDC * sizeof(TC);
  static constexpr size_t CONV = 2 * TILE_BYTES;
  static constexpr size_t CONV_BYTES = QUANT && !F32 ? TILE * (D + PAD) * 2 : 0;
  static constexpr size_t Q = CONV + CONV_BYTES;
  static constexpr size_t SCALES = Q + (size_t)QTILE * LDQ * sizeof(T);
  static constexpr size_t STAGED = SCALES + (QUANT ? 2 * TILE * sizeof(float) : 0);
  static constexpr size_t PARTIAL = (size_t)(QTILE * LDA + 2 * QTILE) * sizeof(float);
  static constexpr size_t BYTES = STAGED > PARTIAL ? STAGED : PARTIAL;
  // blocks an SM the registers must allow: three for bf16 q over a bf16
  // cache (168 registers, no spill); one otherwise, so that ptxas keeps the
  // accumulators, scores and split fragments in registers (capped at 168,
  // the int8 instantiation spills and the f32 one stops at 168 by itself
  // and spills)
  static constexpr int MIN_BLOCKS = F32 ? 1 : (QUANT ? 1 : 3);
  static_assert(TILE_BYTES % 16 == 0 && CONV_BYTES % 16 == 0 && SCALES % 16 == 0,
                "16-byte aligned tiles");
};

__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
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
// c[16x8] += a[16x8] . b[8x8], tf32 operands, f32 accumulators.  Fragments:
// a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); b0 (k t, n g),
// b1 (k t + 4, n g); c as m16n8k16's (rows g, g + 8, columns 2t, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// x = hi + lo, each a tf32 (3xTF32: hi.hi + hi.lo + lo.hi keeps float32's
// accuracy where one tf32 product keeps about three digits)
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
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
// cp.async.  bf16 and f32 rows past ``valid`` are zeroed here (the rows past
// the live end are never read, and 0 * p must stay 0); int8 rows past it
// keep whatever they held (finite; their scores are masked and their p is 0).
// The caller commits the group and waits for it.
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
// then writes them widened, 32 bytes each.
template <int D>
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

// Four outputs of a row, converted to T and stored at once.
__device__ __forceinline__ void store4(float* dst, float4 x) {
  *reinterpret_cast<float4*>(dst) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 x) {
  *reinterpret_cast<uint2*>(dst) = make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
}

// One cluster of blocks per (slot x kv head, tile of 64 query rows) along
// the chunk axis (grid.y = CLUSTER, grid.z = the row tiles); block r
// walks the live chunks r, r + CLUSTER, ...  with an online softmax in
// registers, then the cluster reduces the blocks' rows in rank order through
// distributed shared memory and writes the output.  Each warp owns a tile
// of 16 query rows.  T is q's and the output's type (bf16 or float), TC the
// cache's (T, or int8_t with per-row scales).
template <typename T, typename TC, int D>
__global__ void __cluster_dims__(1, CLUSTER, 1)
__launch_bounds__(THREADS, (MmaLayout<T, TC, D>::MIN_BLOCKS)) partial_kernel_mma(
    const T* __restrict__ q,              // [B * Hkv, GS, D]
    const TC* __restrict__ k,             // per slot [L?, Hkv, max_len, D]
    const TC* __restrict__ v,
    const float* __restrict__ k_scale,    // per slot [L?, Hkv, max_len] (int8 only)
    const float* __restrict__ v_scale,
    const uint8_t* __restrict__ mask,     // per slot [S, T_reg]
    const int* __restrict__ start_ptr,    // [B] committed prefix lengths
    const int* __restrict__ layer_ptr,    // [B] layer indices, or null (no layer dim)
    T* __restrict__ out,                  // [B * Hkv, GS, D]
    int hkv, int gs, int s_len, int t_reg, int max_len, long long layer_stride,
    long long scale_layer_stride, long long slot_stride, long long scale_slot_stride,
    long long mask_slot_stride, float scale) {
  using L = MmaLayout<T, TC, D>;
  constexpr bool F32 = L::F32, QUANT = L::QUANT;
  static_assert(std::is_same<T, __nv_bfloat16>::value || F32, "bf16 or f32 q");
  static_assert(QUANT || std::is_same<TC, T>::value, "the cache is q's type or int8");
  static_assert(D % 16 == 0 && TILE == 64, "whole mma steps; 8 score tiles a chunk");
  constexpr int LDQ = L::LDQ, LDC = L::LDC, LDA = L::LDA;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int bh = blockIdx.x;  // slot * hkv + kv head
  const int slot = bh / hkv;
  const int hk = bh % hkv;
  const int p0 = blockIdx.z * QTILE;  // this block's query rows
  const int prow = min(QTILE, gs - p0);
  const int start = start_ptr[slot];
  const int total = min(start + t_reg, max_len);
  const int nlive = (total + TILE - 1) / TILE;  // chunks past these are never read
  const long long layer = layer_ptr ? layer_ptr[slot] : 0;
  mask += slot * mask_slot_stride;
  const size_t head = (size_t)(slot * slot_stride + layer * layer_stride) + (size_t)hk * max_len * D;
  const size_t shead = (size_t)(slot * scale_slot_stride + layer * scale_layer_stride) +
                       (size_t)hk * max_len;

  extern __shared__ __align__(16) unsigned char smem_mma[];
  TC* kt = reinterpret_cast<TC*>(smem_mma);                        // [TILE][LDC]
  TC* vt = reinterpret_cast<TC*>(smem_mma + L::TILE_BYTES);        // [TILE][LDC]
  __nv_bfloat16* conv = reinterpret_cast<__nv_bfloat16*>(smem_mma + L::CONV);  // [TILE][D + PAD]
  T* qs = reinterpret_cast<T*>(smem_mma + L::Q);                   // [QTILE][LDQ]
  float* ksc = reinterpret_cast<float*>(smem_mma + L::SCALES);     // [TILE] (int8)
  float* vsc = ksc + TILE;                                         // [TILE] (int8)
  // after the chunks: the block's unnormalised P.V, row max and row sum
  float* part_acc = reinterpret_cast<float*>(smem_mma);            // [QTILE][LDA]
  float* part_m = part_acc + QTILE * LDA;                          // [QTILE]
  float* part_l = part_m + QTILE;                                  // [QTILE]

  // the K (or V) rows of a chunk and, int8, their scales (zero past the live
  // end), as one cp.async group
  auto stage_chunk = [&](const TC* src, const float* sc, TC* dst, float* dsc, int chunk) {
    const int col0 = chunk * TILE, ncols = min(TILE, total - col0);
    stage_rows<TC, D, TILE>(src + head + (size_t)col0 * D, ncols, dst, LDC);
    if constexpr (QUANT) {
      if (threadIdx.x < TILE) {
        if (threadIdx.x < ncols) {
          cp_async4(dsc + threadIdx.x, sc + shead + col0 + threadIdx.x);
        } else {
          dsc[threadIdx.x] = 0.f;
        }
      }
    }
    cp_async_commit();
  };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // accumulator rows g, g + 8; columns 2t, 2t + 1
  const bool active = warp * 16 < prow;        // the warp has a live query row
  const int ra = p0 + warp * 16 + g, rb = ra + 8;  // this thread's two query rows

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  if (rank < nlive) {
    stage_rows<T, D, QTILE>(q + ((size_t)bh * gs + p0) * D, prow, qs, LDQ);
    stage_chunk(k, k_scale, kt, ksc, rank);  // q joins the K group
    stage_chunk(v, v_scale, vt, vsc, rank);
  }
  for (int chunk = rank; chunk < nlive; chunk += CLUSTER) {
    const bool more = chunk + CLUSTER < nlive;
    const int col0 = chunk * TILE, ncols = min(TILE, total - col0);
    cp_async_wait<1>();  // K (and q); V may still be in flight
    __syncthreads();
    if constexpr (QUANT && !F32) {
      convert_i8<D>(reinterpret_cast<const int8_t*>(kt), ncols, conv);
      __syncthreads();
    }

    // scores of the warp's 16 rows over the chunk's 64 columns
    float sc[TILE / 8][4];
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    if (active) {
      if constexpr (F32) {
        // 3xTF32: q and (f32 cache) K split into tf32 hi + lo; an int8 row
        // is exact in tf32 (|x| <= 127), so only q carries a lo term there
#pragma unroll 2
        for (int kk = 0; kk < D / 8; ++kk) {
          const float* qa = qs + (warp * 16 + g) * LDQ + kk * 8 + t;
          unsigned ah[4], al[4];
          split_tf32(qa[0], ah[0], al[0]);
          split_tf32(qa[8 * LDQ], ah[1], al[1]);
          split_tf32(qa[4], ah[2], al[2]);
          split_tf32(qa[8 * LDQ + 4], ah[3], al[3]);
#pragma unroll
          for (int j = 0; j < TILE / 8; ++j) {
            const TC* kb = kt + (j * 8 + g) * LDC + kk * 8 + t;
            if constexpr (QUANT) {
              const unsigned b0 = __float_as_uint(to_f(kb[0])), b1 = __float_as_uint(to_f(kb[4]));
              mma_tf32(sc[j], al, b0, b1);
              mma_tf32(sc[j], ah, b0, b1);
            } else {
              unsigned bh0, bl0, bh1, bl1;
              split_tf32(to_f(kb[0]), bh0, bl0);
              split_tf32(to_f(kb[4]), bh1, bl1);
              mma_tf32(sc[j], al, bh0, bh1);
              mma_tf32(sc[j], ah, bl0, bl1);
              mma_tf32(sc[j], ah, bh0, bh1);
            }
          }
        }
      } else {
        const __nv_bfloat16* kb16 =
            QUANT ? conv : reinterpret_cast<const __nv_bfloat16*>(kt);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          unsigned a[4];  // rows 0-7 / 8-15 at k 0-7, then at k 8-15
          ldmatrix_x4(a, reinterpret_cast<const __nv_bfloat16*>(qs) +
                             (warp * 16 + lane % 16) * LDQ + kk * 16 + (lane / 16) * 8);
#pragma unroll
          for (int jp = 0; jp < TILE / 16; ++jp) {
            unsigned b[4];  // key rows 0-7 at k 0-7, k 8-15; key rows 8-15 likewise
            ldmatrix_x4(b, kb16 + (jp * 16 + lane % 8 + (lane / 16) * 8) * (D + PAD) +
                               kk * 16 + ((lane / 8) % 2) * 8);
            mma_bf16(sc[2 * jp], a, b[0], b[1]);
            mma_bf16(sc[2 * jp + 1], a, b[2], b[3]);
          }
        }
      }

      // scale after the product, as the plain version (int8: times the key
      // scale of each column, read as its tile comes); then the visibility
      // rule
      const bool all_visible = col0 + TILE <= start;  // the whole chunk is committed prefix
      const uint8_t* mrow[2] = {mask + (size_t)(ra % s_len) * t_reg,
                                mask + (size_t)(rb % s_len) * t_reg};
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j) {
        float csc[2] = {scale, scale};  // the factor of columns j * 8 + 2t + {0, 1}
        if constexpr (QUANT) {
          const float2 f = *reinterpret_cast<const float2*>(ksc + j * 8 + 2 * t);
          csc[0] = f.x * scale;
          csc[1] = f.y * scale;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + 2 * t + e % 2;
          const int col = col0 + c;
          const bool ok = all_visible || ((e < 2 ? ra : rb) < gs && c < ncols &&
                                          (col < start || mrow[e / 2][col - start] != 0));
          sc[j][e] = ok ? sc[j][e] * csc[e % 2] : -INFINITY;
        }
      }

      // online softmax: the row max over the quad's 4 x 16 columns and the rows'
      // running max; the running sum and P.V rescaled to it
      float mc[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j) {
        mc[0] = fmaxf(mc[0], fmaxf(sc[j][0], sc[j][1]));
        mc[1] = fmaxf(mc[1], fmaxf(sc[j][2], sc[j][3]));
      }
      float base[2], lc[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mc[h] = fmaxf(mc[h], __shfl_xor_sync(0xffffffffu, mc[h], 1));
        mc[h] = fmaxf(mc[h], __shfl_xor_sync(0xffffffffu, mc[h], 2));
        const float mn = fmaxf(m[h], mc[h]);
        base[h] = mn == -INFINITY ? 0.f : mn;  // a row that has seen nothing yet
        const float alpha = expf(m[h] - base[h]);  // 0 while m is -inf
        m[h] = mn;
        l[h] *= alpha;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[j][2 * h] *= alpha;
          o[j][2 * h + 1] *= alpha;
        }
      }
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // a masked column contributes exactly 0
          sc[j][e] = sc[j][e] == -INFINITY ? 0.f : expf(sc[j][e] - base[e / 2]);
          lc[e / 2] += sc[j][e];  // before the value scale, as JAX sums p
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        lc[h] += __shfl_xor_sync(0xffffffffu, lc[h], 1);
        lc[h] += __shfl_xor_sync(0xffffffffu, lc[h], 2);
        l[h] += lc[h];
      }
    }
    __syncthreads();  // every warp is done with the K tile
    if (more) {
      stage_chunk(k, k_scale, kt, ksc, chunk + CLUSTER);  // lands while P.V runs
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // V landed
    if constexpr (QUANT && !F32) {
      convert_i8<D>(reinterpret_cast<const int8_t*>(vt), ncols, conv);
      __syncthreads();
    }

    if (active) {
      if constexpr (F32) {
        // p (f32; int8: times the value scale) as the A operand straight
        // from the score registers: the mma's k index t stands for the
        // chunk's column 2t and t + 4 for 2t + 1, so V's rows are read in
        // that order
#pragma unroll
        for (int kk = 0; kk < TILE / 8; ++kk) {
          float pa[4] = {sc[kk][0], sc[kk][2], sc[kk][1], sc[kk][3]};
          if constexpr (QUANT) {
            const float2 f = *reinterpret_cast<const float2*>(vsc + kk * 8 + 2 * t);
            pa[0] *= f.x, pa[1] *= f.x, pa[2] *= f.y, pa[3] *= f.y;
          }
          unsigned ph[4], pl[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(pa[e], ph[e], pl[e]);
          const TC* vb = vt + (kk * 8 + 2 * t) * LDC + g;
#pragma unroll
          for (int jn = 0; jn < D / 8; ++jn) {
            if constexpr (QUANT) {
              const unsigned b0 = __float_as_uint(to_f(vb[jn * 8]));
              const unsigned b1 = __float_as_uint(to_f(vb[LDC + jn * 8]));
              mma_tf32(o[jn], pl, b0, b1);
              mma_tf32(o[jn], ph, b0, b1);
            } else {
              unsigned bh0, bl0, bh1, bl1;
              split_tf32(to_f(vb[jn * 8]), bh0, bl0);
              split_tf32(to_f(vb[LDC + jn * 8]), bh1, bl1);
              mma_tf32(o[jn], pl, bh0, bh1);
              mma_tf32(o[jn], ph, bl0, bl1);
              mma_tf32(o[jn], ph, bh0, bh1);
            }
          }
        }
      } else {
        // p as bf16 A fragments, one per 16-column k-step (two 8-wide score
        // tiles), packed as the step comes; bf16 cache: p rounded to bf16,
        // as the plain version rounds it to the value dtype; int8: p *
        // v_scale in two parts, pf (rounded to bf16) + pl (the rest, rounded
        // to bf16)
        const __nv_bfloat16* vb16 =
            QUANT ? conv : reinterpret_cast<const __nv_bfloat16*>(vt);
#pragma unroll
        for (int kk = 0; kk < TILE / 16; ++kk) {
          unsigned pf[4];
          [[maybe_unused]] unsigned pl[4];
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int j = 2 * kk + jj;
            if constexpr (QUANT) {
              const float2 f = *reinterpret_cast<const float2*>(vsc + j * 8 + 2 * t);
#pragma unroll
              for (int h = 0; h < 2; ++h) {  // rows g, then g + 8
                const float x0 = sc[j][2 * h] * f.x, x1 = sc[j][2 * h + 1] * f.y;
                const unsigned hi = pack_bf16(x0, x1);
                pf[jj * 2 + h] = hi;
                pl[jj * 2 + h] = pack_bf16(x0 - bf16_lo(hi), x1 - bf16_hi(hi));
              }
            } else {
              pf[jj * 2] = pack_bf16(sc[j][0], sc[j][1]);      // rows g
              pf[jj * 2 + 1] = pack_bf16(sc[j][2], sc[j][3]);  // rows g + 8
            }
          }
#pragma unroll
          for (int jp = 0; jp < D / 16; ++jp) {
            unsigned b[4];  // transposed: value rows (k) 0-7, 8-15 at d 0-7; then at d 8-15
            ldmatrix_x4_trans(b, vb16 + (kk * 16 + lane % 16) * (D + PAD) + jp * 16 +
                                     (lane / 16) * 8);
            mma_bf16(o[2 * jp], pf, b[0], b[1]);
            mma_bf16(o[2 * jp + 1], pf, b[2], b[3]);
            if constexpr (QUANT) {
              mma_bf16(o[2 * jp], pl, b[0], b[1]);
              mma_bf16(o[2 * jp + 1], pl, b[2], b[3]);
            }
          }
        }
      }
    }
    __syncthreads();  // every warp is done with the V tile
    if (more) stage_chunk(v, v_scale, vt, vsc, chunk + CLUSTER);  // lands while the next q.k runs
  }

  // this block's rows (a block with no live chunk: m = -inf, l = 0)
  if (active) {
    const int a = warp * 16 + g, b = a + 8;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<float2*>(part_acc + a * LDA + j * 8 + 2 * t) =
          make_float2(o[j][0], o[j][1]);
      *reinterpret_cast<float2*>(part_acc + b * LDA + j * 8 + 2 * t) =
          make_float2(o[j][2], o[j][3]);
    }
    if (t == 0) {
      part_m[a] = m[0], part_l[a] = l[0];
      part_m[b] = m[1], part_l[b] = l[1];
    }
  }
  cluster.sync();
  // the cluster's sum in rank order, block r over its share of the rows x
  // D / 4 columns, read from every block's shared memory (all of a row's
  // loads in flight before any is used)
  for (int i = rank * THREADS + tid; i < prow * (D / 4); i += CLUSTER * THREADS) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    float mb[CLUSTER];
    float mmax = -INFINITY;
#pragma unroll
    for (int b = 0; b < CLUSTER; ++b) {
      mb[b] = *cluster.map_shared_rank(part_m + r, b);
      mmax = fmaxf(mmax, mb[b]);
    }
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    float lsum = 0.f;
#pragma unroll
    for (int b = 0; b < CLUSTER; ++b) {  // a block that saw nothing of this row weighs 0
      const float w = mb[b] == -INFINITY ? 0.f : expf(mb[b] - mmax);
      lsum += *cluster.map_shared_rank(part_l + r, b) * w;
      const float4 x =
          *reinterpret_cast<const float4*>(cluster.map_shared_rank(part_acc + r * LDA + c, b));
      acc.x += x.x * w, acc.y += x.y * w, acc.z += x.z * w, acc.w += x.w * w;
    }
    const float inv = 1.f / fmaxf(lsum, 1e-20f);
    store4(out + ((size_t)bh * gs + p0 + r) * D + c,
           make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv));
  }
  cluster.sync();  // no block leaves while its peers read its shared memory
}

// One block per (slot, kv head, query row), one thread per head-dim element
// (partial_kernel's reduction).
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

// D = 128: partial_kernel_mma, one launch, a cluster of CLUSTER blocks per
// (slot x kv head).  The shared-memory attribute is set once per
// instantiation.
template <typename T, typename TC, int D>
int launch_mma(const void* q, const void* k, const void* v, const void* k_scale,
               const void* v_scale, const void* mask, const void* start, const void* layer,
               void* out, int nslots, int hkv, int gs, int s_len, int t_reg, int max_len,
               long long layer_stride, long long scale_layer_stride, long long slot_stride,
               long long scale_slot_stride, long long mask_slot_stride,
               cudaStream_t stream) {
  using L = MmaLayout<T, TC, D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      partial_kernel_mma<T, TC, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::BYTES);
  if (attr != cudaSuccess) return (int)attr;
  partial_kernel_mma<T, TC, D>
      <<<dim3(nslots * hkv, CLUSTER, (gs + QTILE - 1) / QTILE), THREADS, L::BYTES, stream>>>(
          (const T*)q, (const TC*)k, (const TC*)v, (const float*)k_scale,
          (const float*)v_scale, (const uint8_t*)mask, (const int*)start, (const int*)layer,
          (T*)out, hkv, gs, s_len, t_reg, max_len, layer_stride, scale_layer_stride,
          slot_stride, scale_slot_stride, mask_slot_stride, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

// D = 16: partial_kernel into the scratch partials, then combine_kernel.
template <typename T, typename TC, int D>
int launch_split(const void* q, const void* k, const void* v, const void* k_scale,
                 const void* v_scale, const void* mask, const void* start, const void* layer,
                 void* part_m, void* part_l, void* part_acc, void* out, int nslots, int hkv,
                 int gs, int s_len, int t_reg, int max_len, long long layer_stride,
                 long long scale_layer_stride, long long slot_stride,
                 long long scale_slot_stride, long long mask_slot_stride,
                 cudaStream_t stream) {
  if (!part_m || !part_l || !part_acc) return -1;
  const int nc = (max_len + TILE - 1) / TILE;
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
          slot_stride, scale_slot_stride, mask_slot_stride, 1.0f / sqrtf((float)D));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  combine_kernel<T, D><<<nslots * hkv * gs, D, 0, stream>>>(
      (const float*)part_m, (const float*)part_l, (const float*)part_acc,
      (T*)out, (const int*)start, hkv, gs, t_reg, max_len, nc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Chunk length of the split; the caller sizes head_dim 16's scratch from it.
int vispec_verify_attention_tile() { return TILE; }

// Returns a cudaError_t code (0 on success), or -1 for an unsupported
// head_dim / dtype pair or a missing scratch.  q and the output are bf16
// (is_bf16) or f32; the cache is q's type, or int8 (cache_int8) with scales
// k_scale / v_scale (null otherwise).  ``nslots`` requests at once: start and
// layer hold one int32 per slot, and slot b's cache, scales and mask begin
// ``b * *_slot_stride`` elements after the given pointers (all strides 0 for
// a single request).  head_dim 128 is one launch of partial_kernel_mma with
// a cluster of CLUSTER blocks per (slot x kv head) and takes no scratch
// (part_m, part_l, part_acc may be null); head_dim 16 writes the partials
// [nslots * hkv, ceil(max_len / TILE), gs (, D)] to the scratch.  Launches
// on ``stream``; does not synchronise.
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
#define VISPEC_LAUNCH(T, TC)                                                         \
  if (head_dim == 128)                                                               \
    return launch_mma<T, TC, 128>(q, k, v, k_scale, v_scale, mask, start, layer, out, \
                                  nslots, hkv, gs, s_len, t_reg, max_len,             \
                                  layer_stride, scale_layer_stride, slot_stride,      \
                                  scale_slot_stride, mask_slot_stride, st);  \
  if (head_dim == 16)                                                                \
    return launch_split<T, TC, 16>(q, k, v, k_scale, v_scale, mask, start, layer,     \
                                   part_m, part_l, part_acc, out, nslots, hkv, gs,    \
                                   s_len, t_reg, max_len, layer_stride,               \
                                   scale_layer_stride, slot_stride,                   \
                                   scale_slot_stride, mask_slot_stride, st);
  if (is_bf16) {
    if (cache_int8) {
      VISPEC_LAUNCH(__nv_bfloat16, int8_t)
    } else {
      VISPEC_LAUNCH(__nv_bfloat16, __nv_bfloat16)
    }
  } else {
    if (cache_int8) {
      VISPEC_LAUNCH(float, int8_t)
    } else {
      VISPEC_LAUNCH(float, float)
    }
  }
#undef VISPEC_LAUNCH
  return -1;
}

}  // extern "C"
