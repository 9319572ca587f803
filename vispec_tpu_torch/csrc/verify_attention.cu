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
//   - Grid and reduction.  The live 64-row chunks of a (slot x kv head, 64
//     query rows) are split over VRANKS = 8 virtual ranks: rank v walks
//     chunks v, v + 8, ... (the live end read from tree_start on the device:
//     the host never reads it) with an online softmax (row max, row sum,
//     unnormalised P.V) in registers, and leaves its rows' (acc, m, l) in a
//     slot of shared memory.  A thread-block cluster of C = 8, 4, 2 or 1
//     blocks along grid.y runs the 8 ranks, block b the ranks b, b + C, ...,
//     W at a time: a block of W = 2 walkers (bf16 q over a bf16 cache, at
//     most 32 query rows a kv head: two warps each, with a K and a V tile,
//     cp.async groups and a named barrier of their own) runs ranks b + w * C, b + (w + 2) * C, ...
//     in walker w, where with one walker the warps without a live row only
//     helped stage; within a walker the prefetch runs on from one rank's
//     last chunk to the next rank's first (each rank after a walker's first:
//     a slot of rows x (D + 10) x 4 bytes more shared memory).  Then block b
//     merges its share of the rows over the 8 ranks in rank order through
//     distributed shared memory (a rank with no live chunk would weigh
//     exactly 0 and is left out) and writes the output in q's dtype.  A
//     rank's arithmetic and the merge are the same whatever (C, W), so every
//     (C, W) gives the same bits; no atomics and no partials in device
//     memory: a run is reproducible bit for bit, and a slot of a batch
//     equals the same request alone.  The host picks (C, W) from the call's
//     shapes and the clusters of each shape the card holds at once
//     (ops/verify_attention.pick_cluster): (8, 1) for one request, where a
//     wave of clusters of 8 holds the grid; (4, 2) for the B = 4 bf16 rounds
//     (128 clusters: 3 waves of (8, 1), 2 of (4, 2), every rank of a block at
//     once); (8, 1) for B = 4 over int8 or in float32, where smaller
//     clusters' slots cost blocks an SM, (4, 1) for the B = 4 step over
//     int8; (1, 1) for getkacc's 16 one-row slots.  Over int8 two walkers
//     (with a conversion tile and scales each) held two blocks an SM and
//     gained nothing at the shapes the host runs, so they are not built.
//   - Slot order.  The hardware starts a grid's clusters in block-column
//     order, so on a grid of several waves the slots a batch gives last
//     would start last whatever their length.  A batched launch's blocks
//     place their columns on the slots longest first (place_longest_first:
//     descending live chunks, ties to the lower index, from the starts in
//     device memory), so the long slots' clusters start in the first wave;
//     a slot's bits do not depend on where it runs.  A single request runs
//     an instantiation without that code (ORDER): its presence alone cost a
//     single request about 0.5 us a launch.
//   - Staging.  The chunk's K and V rows go by 16-byte cp.async into a K and
//     a V tile, each a cp.async group: the next chunk's K lands while this
//     chunk's P.V runs, its V while the next q.k runs.  Rows are padded
//     against bank conflicts (bf16 D + 8, f32 D + 4, int8 read in place D +
//     16 bytes), but for the two walkers' bf16 K tiles, whose 16-byte chunks
//     are XOR-swizzled by the row instead (swz): the 2 KB a block saves let
//     three blocks of two walkers fit an SM (76,304 bytes); rows past the
//     live end are never read (bf16 and f32 tiles zeroed there).  Each warp
//     of a walker owns a tile of 16 query rows; a head with more rows than a
//     walker's warps hold (64 with one walker: GQA's gs = 120, Qwen's 210)
//     has a cluster for each such tile (grid.z), which reads the chunks
//     again, mostly from L2.
//   - bf16 q: S = q.k with mma.sync.m16n8k16 (q and K fragments by
//     ldmatrix.x4), f32 scores times D^-0.5 after the product, p repacked in
//     registers as the A operand of P.V (two 8-wide score tiles are one
//     16-wide k-step), V by ldmatrix.x4.trans.  bf16 cache: p rounded to
//     bf16, as the plain version rounds it to the value dtype.  int8 cache:
//     the raw rows converted to a bf16 tile in shared memory (exact: |x| <=
//     127), the key scale multiplying each score column with D^-0.5, the row
//     sum taken before the value scale, as JAX does, and p * v_scale (f32)
//     split into bf16 hi + lo, P.V run twice (hi.V + lo.V).  Two builds
//     (PT): with the P tiles the value scales land with K, and hi and lo go
//     to the warp's two P tiles in shared memory right after the softmax
//     and come back by ldmatrix.x4 for P.V: no score or p register is live
//     while V is converted, the int8 k-steps are not unrolled, and the
//     build fits three blocks an SM (168 registers, no spill).  The
//     register build packs hi and lo inside P.V as each k-step comes, where
//     the packing overlaps the tensor cores, in 180-200 registers and two
//     blocks an SM.  The host takes the register build, at a cluster of 8,
//     where one wave of it holds the grid (a block then has its SM to
//     itself and the P tiles' separate pack only lengthens each chunk), and
//     the P tiles everywhere else.  Both round x = p * v_scale to f32
//     first (__fmul_rn) and run the same products in the same order, so
//     they give the same bits.
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
// No TMA or wgmma: a kv head has 30 query rows at the verify (1 at an AR
// step, 1 a slot in getkacc) where wgmma's tile has 64, and m16n8k16 fits
// them in two tiles; the time is set by each block's chain of chunk loads
// (one chunk of cp.async ahead), by a fixed cost a launch (one live chunk:
// about 11 us for one request, 18-20 for B = 4 at (4, 1) or (4, 2)) and, on
// batched grids, by waves of clusters, not by the tensor cores' rate.  Two
// walkers of two warps stage a chunk with half the threads of one walker of
// four, which costs them about what their second rank gains on one request
// (the host keeps one walker there).  TMA would take the 16-byte copies off
// the threads; it is untried.
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
// Virtual ranks of a (slot x kv head, query tile): rank v walks the live
// chunks v, v + VRANKS, ... and the ranks are merged in rank order, whatever
// the cluster that runs them
constexpr int VRANKS = 8;

// Shared memory of partial_kernel_mma<T, TC, D, C, PT, W>, in bytes: each of
// the W walkers' K tile and V tile of the cache as staged (bf16 rows of D +
// 8 (two walkers: K rows of D, their 16-byte chunks swizzled (swz)), f32
// rows of D + 4, raw int8 rows of D (bf16 q: converted into a bf16 tile) or
// D + 16 bytes (f32 q: read in place)) and its bf16 conversion tile (bf16 q
// over int8 only), the q tile (the QTILE / W query rows a walker takes), the
// key and value scales of the chunk (int8 cache), and (bf16 q over int8 with
// PT) each warp's p * v_scale as a bf16 hi tile and lo tile.  A virtual rank leaves its (acc, m, l) of the block's query rows in
// a slot: a walker's last rank in its own tiles once its chunks are done
// (one walker: in all the staged bytes), each earlier one (VRANKS / C - W of
// them) in a slot of its own after them.
template <typename T, typename TC, int D, bool PT, int W>
struct MmaLayout {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr bool QUANT = std::is_same<TC, int8_t>::value;
  // bf16 q over int8: p * v_scale through the warps' P tiles (PT), or packed
  // in registers inside P.V
  static constexpr bool PTILES = QUANT && !F32 && PT;
  static constexpr int QT = QTILE / W;  // query rows of a cluster's tile
  static constexpr int LDQ = F32 ? D + 4 : D + PAD;                       // T a q row
  static constexpr int LDC = QUANT ? (F32 ? D + 16 : D) : (F32 ? D + 4 : D + PAD);  // TC
  // two walkers: the K tile's rows unpadded, their 16-byte chunks swizzled
  // (swz), so that three blocks fit an SM
  static constexpr bool SWZ_K = W > 1;
  static constexpr int LDA = D + 8;                                       // f32 an acc row
  static constexpr size_t TILE_BYTES = (size_t)TILE * LDC * sizeof(TC);
  static constexpr size_t K_BYTES = SWZ_K ? (size_t)TILE * D * sizeof(TC) : TILE_BYTES;
  static constexpr size_t CONV = K_BYTES + TILE_BYTES;  // within a walker's tiles
  static constexpr size_t CONV_BYTES = QUANT && !F32 ? TILE * (D + PAD) * 2 : 0;
  static constexpr size_t WALKER = CONV + CONV_BYTES;  // a walker's tiles
  static constexpr size_t Q = W * WALKER;
  static constexpr size_t SCALES = Q + (size_t)QT * LDQ * sizeof(T);
  static constexpr size_t SCALE_BYTES = QUANT ? 2 * TILE * sizeof(float) : 0;
  static constexpr int LDP = TILE + PAD;  // bf16 a row of a warp's P tile
  static constexpr size_t PTILE = SCALES + SCALE_BYTES;
  static constexpr size_t BYTES = PTILE + (PTILES ? (size_t)WARPS * 2 * 16 * LDP * 2 : 0);
  // a virtual rank's slot for ``rows`` query rows: acc [rows][LDA], then the
  // row maxima [rows] and row sums [rows]
  static __host__ __device__ constexpr size_t slot_bytes(int rows) {
    return ((size_t)rows * (LDA + 2) * sizeof(float) + 15) / 16 * 16;
  }
  static constexpr size_t bytes(int cluster, int rows) {
    return BYTES + (size_t)(VRANKS / cluster - W) * slot_bytes(rows);
  }
  // blocks an SM the registers must allow.  One walker: three for bf16 q
  // over a bf16 cache and over an int8 one through the P tiles (168
  // registers, no spill); one for bf16 q over int8 packing p * v_scale in
  // registers (its hi and lo live through V's conversion: 180-200 registers,
  // two blocks an SM; capped at 168 it spills) and for float32 q, so that
  // ptxas keeps the accumulators, scores and split fragments in registers
  // (185-187, 244-246 over int8; capped at 168 it spills).  Two walkers'
  // tiles fit three blocks an SM (168 registers).
  static constexpr int MIN_BLOCKS = F32 || (QUANT && !PTILES) ? 1 : 3;
  static_assert(TILE_BYTES % 16 == 0 && K_BYTES % 16 == 0 && CONV_BYTES % 16 == 0 &&
                    SCALES % 16 == 0,
                "16-byte aligned tiles");
  static_assert(W == 1 || (W == 2 && !F32 && !QUANT), "two walkers: bf16 q over a bf16 cache");
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

// Element offset of (row, col) in a bf16 tile of D-element rows whose
// 16-byte chunks are XOR-swizzled by the row (col a multiple of 8): the 8
// rows an ldmatrix phase reads land in 8 different bank groups without the
// padding a plain layout needs (1 KB a tile).
template <int D>
__device__ __forceinline__ int swz(int row, int col) {
  return row * D + (((col >> 3) ^ (row & 7)) << 3);
}

// Copy NROWS rows of D elements (the first ``valid`` of them real) from
// device memory into shared rows of ``dst_stride`` elements (SWZ: bf16 rows
// of D, chunks swizzled), 16 bytes a cp.async, by NT threads (``i0`` this
// thread's index among them).  bf16 and f32 rows past ``valid`` are zeroed
// here (the rows past the live end are never read, and 0 * p must stay 0);
// int8 rows past it keep whatever they held (finite; their scores are
// masked and their p is 0).  The caller commits the group and waits for it.
template <typename T, int D, int NROWS, int NT, bool SWZ = false>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src, int valid,
                                           T* __restrict__ dst, int dst_stride, int i0) {
  constexpr int PER = 16 / sizeof(T);
  constexpr int VPR = D / PER;  // 16-byte vectors per row
  static_assert(!SWZ || PER == 8, "swizzled tiles hold bf16");
  auto copy = [&](int i) {
    const int row = i / VPR, vec = i % VPR;
    T* d = dst + (SWZ ? swz<D>(row, vec * PER) : row * dst_stride + vec * PER);
    if (row < valid) {
      cp_async16(d, src + (size_t)row * D + vec * PER);
    } else if constexpr (!std::is_same<T, int8_t>::value) {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  };
  if constexpr (NT == THREADS) {
#pragma unroll
    for (int i = i0; i < NROWS * VPR; i += NT) copy(i);
  } else {  // a walker's threads: kept rolled, so the copies hold few registers
#pragma unroll 2
    for (int i = i0; i < NROWS * VPR; i += NT) copy(i);
  }
}

// Convert TILE raw int8 rows of D (the first ``valid`` real, the rest zero)
// to bf16 rows of D + PAD.  Every thread reads STEP of its 16-byte vectors,
// then writes them widened, 32 bytes each, and so on (a small STEP holds
// few registers while the P.V state is live).
template <int D, int STEP>
__device__ __forceinline__ void convert_i8(const int8_t* src, int valid, __nv_bfloat16* dst) {
  constexpr int VPR = D / 16;
  constexpr int ITER = TILE * VPR / THREADS;
  static_assert(TILE * VPR % THREADS == 0 && ITER % STEP == 0, "whole vectors a thread");
#pragma unroll
  for (int it0 = 0; it0 < ITER; it0 += STEP) {
    uint4 w[STEP];
#pragma unroll
    for (int u = 0; u < STEP; ++u) {
      const int i = threadIdx.x + (it0 + u) * THREADS;
      w[u] = i / VPR < valid ? *reinterpret_cast<const uint4*>(src + i * 16)
                             : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < STEP; ++u) {
      const int i = threadIdx.x + (it0 + u) * THREADS;
      uint4 out[2];
      i8x4_to_bf16(w[u].x, out[0].x, out[0].y);
      i8x4_to_bf16(w[u].y, out[0].z, out[0].w);
      i8x4_to_bf16(w[u].z, out[1].x, out[1].y);
      i8x4_to_bf16(w[u].w, out[1].z, out[1].w);
      uint4* d = reinterpret_cast<uint4*>(dst + (i / VPR) * (D + PAD) + (i % VPR) * 16);
      d[0] = out[0];
      d[1] = out[1];
    }
  }
}

// The NT threads of walker ``walker`` wait for each other (NT = THREADS:
// the whole block, as __syncthreads; else a named barrier of their own,
// 1 + walker, so the other walkers go on)
template <int NT>
__device__ __forceinline__ void walker_sync(int walker) {
  if constexpr (NT == THREADS) {
    __syncthreads();
  } else {
    if (walker == 0) {  // immediate barrier ids: ptxas reserves only these
      asm volatile("bar.sync 1, %0;\n" ::"n"(NT) : "memory");
    } else {
      asm volatile("bar.sync 2, %0;\n" ::"n"(NT) : "memory");
    }
  }
}

// A batched grid's block columns serve its slots longest first: the slots
// in descending order of live chunks, ties to the lower index, each slot's
// kv heads in order.  Thread i places slot i at its position (the starts
// come from device memory: the host never reads them), and the block's slot,
// the one at block column ``x``'s position, lands in placed[0] with its
// start and layer index (0 without a layer dim) in placed[1] and placed[2].
// Every thread of the block calls it.
__device__ __forceinline__ void place_longest_first(int* placed, int x, int hkv,
                                                    const int* __restrict__ start_ptr,
                                                    const int* __restrict__ layer_ptr, int t_reg,
                                                    int max_len) {
  const int nslots = gridDim.x / hkv, pos = x / hkv;
  auto live = [&](int start) { return (min(start + t_reg, max_len) + TILE - 1) / TILE; };
  for (int i = threadIdx.x; i < nslots; i += blockDim.x) {
    const int start = start_ptr[i], layer = layer_ptr ? layer_ptr[i] : 0;
    const int ni = live(start);
    int ahead = 0;
    for (int j = 0; j < nslots; ++j) {
      const int nj = live(start_ptr[j]);
      ahead += nj > ni || (nj == ni && j < i);
    }
    if (ahead == pos) placed[0] = i, placed[1] = start, placed[2] = layer;
  }
  __syncthreads();
}

// Four outputs of a row, converted to T and stored at once.
__device__ __forceinline__ void store4(float* dst, float4 x) {
  *reinterpret_cast<float4*>(dst) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 x) {
  *reinterpret_cast<uint2*>(dst) = make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
}

// One cluster of C blocks per (slot x kv head, tile of QTILE / W query rows)
// along the chunk axis (grid.y = C, grid.z = the row tiles).  Block b runs
// the virtual ranks b, b + C, ..., W at a time: its W walkers (each THREADS /
// W threads, with its own K and V tiles, cp.async groups and named barrier)
// take ranks b + w * C, b + (w + W) * C, ... in turn; rank v walks the live
// chunks v, v + VRANKS, ... with an online softmax in registers and leaves
// its rows in a slot of shared memory; then the cluster merges the VRANKS
// ranks in rank order through distributed shared memory and writes the
// output.  A rank's arithmetic and the merge do not depend on C or W, so the
// output is the same bits for every (C, W).  Each warp of a walker owns a
// tile of 16 query rows.  With ORDER the block columns of a batch serve its
// slots longest first (place_longest_first); a slot's bits do not depend on
// where it runs.  T is q's and the output's type (bf16 or
// float), TC the cache's (T, or int8_t with per-row scales); PT (bf16 q over
// int8 only): p * v_scale through the warps' P tiles rather than packed in
// registers inside P.V; ORDER: the placement is compiled in (a single
// request runs an instantiation without it: its code alone costs a single
// request's launch about half a microsecond).
template <typename T, typename TC, int D, int C, bool PT, int W, bool ORDER>
__global__ void __launch_bounds__(THREADS, (MmaLayout<T, TC, D, PT, W>::MIN_BLOCKS))
partial_kernel_mma(
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
  using L = MmaLayout<T, TC, D, PT, W>;
  constexpr bool F32 = L::F32, QUANT = L::QUANT, PTILES = L::PTILES;
  static_assert(std::is_same<T, __nv_bfloat16>::value || F32, "bf16 or f32 q");
  static_assert(QUANT || std::is_same<TC, T>::value, "the cache is q's type or int8");
  static_assert(D % 16 == 0 && TILE == 64, "whole mma steps; 8 score tiles a chunk");
  static_assert(VRANKS % (C * W) == 0, "a walker runs a whole number of virtual ranks");
  static_assert(L::slot_bytes(L::QT) <= (W == 1 ? L::BYTES : L::WALKER),
                "a walker's last virtual rank's slot fits its tiles");
  constexpr int LDQ = L::LDQ, LDC = L::LDC, LDA = L::LDA, QT = L::QT;
  constexpr int NV = VRANKS / C;     // virtual ranks a block runs
  constexpr int NT = THREADS / W;    // threads of a walker
  const int rank = blockIdx.y;       // the block's rank in its cluster (grid.y = C)
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // the walker, the thread in its walker and the warp in its walker (one
  // walker: the block, its thread and its warp)
  const int walker = W == 1 ? 0 : warp / (WARPS / W);
  const int wt = W == 1 ? tid : tid % NT;
  const int wwarp = W == 1 ? warp : warp % (WARPS / W);
  // the block's slot: block column x's, or with the slots longest first
  // the placed one, kept in shared memory (read again where the output is
  // written, so no register holds it through the walk)
  __shared__ int placed[3];  // slot, start, layer
  const bool place = ORDER && gridDim.x > hkv;
  if constexpr (ORDER) {
    if (place) {
      place_longest_first(placed, blockIdx.x, hkv, start_ptr, layer_ptr, t_reg, max_len);
    } else if (tid == 0) {
      placed[0] = blockIdx.x / hkv;  // read after the walk's barriers
    }
  }
  // slot * hkv + kv head
  const int bh = place ? placed[0] * hkv + (int)blockIdx.x % hkv : (int)blockIdx.x;
  const int slot = bh / hkv;
  const int hk = bh % hkv;
  const int p0 = blockIdx.z * QT;  // this block's query rows
  const int prow = min(QT, gs - p0);
  const int pm = min(QT, gs);  // query rows a virtual rank's slot holds
  const int start = place ? placed[1] : start_ptr[slot];
  const int total = min(start + t_reg, max_len);
  const int nlive = (total + TILE - 1) / TILE;  // chunks past these are never read
  const long long layer = place ? placed[2] : layer_ptr ? layer_ptr[slot] : 0;
  mask += slot * mask_slot_stride;
  const size_t head = (size_t)(slot * slot_stride + layer * layer_stride) + (size_t)hk * max_len * D;
  const size_t shead = (size_t)(slot * scale_slot_stride + layer * scale_layer_stride) +
                       (size_t)hk * max_len;

  extern __shared__ __align__(16) unsigned char smem_mma[];
  unsigned char* tiles = smem_mma + walker * L::WALKER;             // this walker's
  TC* kt = reinterpret_cast<TC*>(tiles);                            // [TILE][LDC] (or swz)
  TC* vt = reinterpret_cast<TC*>(tiles + L::K_BYTES);               // [TILE][LDC]
  __nv_bfloat16* conv = reinterpret_cast<__nv_bfloat16*>(tiles + L::CONV);  // [TILE][D + PAD]
  T* qs = reinterpret_cast<T*>(smem_mma + L::Q);                    // [QT][LDQ]
  float* ksc = reinterpret_cast<float*>(smem_mma + L::SCALES);      // [TILE] (int8)
  float* vsc = ksc + TILE;                                          // [TILE] (int8)
  // bf16 q over int8 with PT: this warp's p * v_scale, hi [16][LDP] then lo [16][LDP]
  __nv_bfloat16* pt = reinterpret_cast<__nv_bfloat16*>(smem_mma + L::PTILE) +
                      warp * 2 * 16 * L::LDP;
  // the slot of the block's j-th virtual rank (rank + j * C): its
  // unnormalised P.V [pm][LDA], then row maxima [pm] and row sums [pm]; a
  // walker's last in its tiles (one walker: from the start of the staged
  // bytes), written once its chunks are done
  auto part_of = [&](int j) {
    return reinterpret_cast<float*>(j >= NV - W ? smem_mma + (j % W) * L::WALKER
                                                : smem_mma + L::BYTES + j * L::slot_bytes(pm));
  };

  // an int8 cache's scales of a chunk's rows, zero past the live end
  auto stage_scales = [&](const float* src, float* dst, int col0, int ncols, int i) {
    if (i < ncols) {
      cp_async4(dst + i, src + shead + col0 + i);
    } else {
      dst[i] = 0.f;
    }
  };
  // with the P tiles the value scales land with K (p * v_scale is packed
  // right after the softmax); otherwise P.V reads them, so they land with V
  constexpr bool VSC_WITH_K = PTILES;
  // the K (or V) rows of a chunk and, int8 (one walker), their scales, a
  // thread a scale, as one cp.async group of the walker's threads
  auto stage_k = [&](int chunk) {
    const int col0 = chunk * TILE, ncols = min(TILE, total - col0);
    stage_rows<TC, D, TILE, NT, L::SWZ_K>(k + head + (size_t)col0 * D, ncols, kt, LDC, wt);
    if constexpr (QUANT) {
      const int i = tid % TILE;
      if (tid < TILE) {
        stage_scales(k_scale, ksc, col0, ncols, i);
      } else if (VSC_WITH_K) {
        stage_scales(v_scale, vsc, col0, ncols, i);
      }
    }
    cp_async_commit();
  };
  auto stage_v = [&](int chunk) {
    const int col0 = chunk * TILE, ncols = min(TILE, total - col0);
    stage_rows<TC, D, TILE, NT>(v + head + (size_t)col0 * D, ncols, vt, LDC, wt);
    if constexpr (QUANT && !VSC_WITH_K) {
      if (tid < TILE) stage_scales(v_scale, vsc, col0, ncols, tid);
    }
    cp_async_commit();
  };

  const int g = lane / 4, t = lane % 4;  // accumulator rows g, g + 8; columns 2t, 2t + 1
  const bool active = wwarp * 16 < prow;        // the warp has a live query row
  const int ra = p0 + wwarp * 16 + g, rb = ra + 8;  // this thread's two query rows

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  // the walker's chunks in turn: those of virtual rank ``first``, then of
  // first + W * C, ...; rank v's first chunk is v, so a block whose first rank
  // has no live chunk has none at all, and so has a walker whose first rank
  // has none.  The whole block stages the q tile, which joins each walker's
  // first K group.
  const int first = rank + walker * C;
  if (rank < nlive) {
    stage_rows<T, D, QT, THREADS>(q + ((size_t)bh * gs + p0) * D, prow, qs, LDQ, tid);
    if (first < nlive) {
      stage_k(first);
      stage_v(first);
    } else {  // the q group, and an empty one in V's place
      cp_async_commit();
      cp_async_commit();
    }
    if constexpr (W > 1) {  // every walker's q rows landed
      cp_async_wait<1>();
      __syncthreads();
    }
  }
  for (int chunk = first; chunk < nlive;) {
    const int vr = chunk % VRANKS;
    // the next chunk of this virtual rank, else the first of the walker's
    // next one (nlive: none)
    const bool last = chunk + VRANKS >= nlive;  // the virtual rank's last chunk
    const int next = !last                                          ? chunk + VRANKS
                     : vr + W * C < VRANKS && vr + W * C < nlive ? vr + W * C
                                                                  : nlive;
    const bool more = next < nlive;
    const int col0 = chunk * TILE, ncols = min(TILE, total - col0);
    cp_async_wait<1>();  // K (and q); V may still be in flight
    walker_sync<NT>(walker);
    if constexpr (QUANT && !F32) {
      convert_i8<D, PTILES ? 2 : 4>(reinterpret_cast<const int8_t*>(kt), ncols, conv);
      walker_sync<NT>(walker);
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
          const float* qa = qs + (wwarp * 16 + g) * LDQ + kk * 8 + t;
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
        // (walkers over a bf16 cache: four k-steps at a time, the most that
        // their swizzled K addresses leave room for in 168 registers)
#pragma unroll(PTILES ? 1 : L::SWZ_K ? 4 : D / 16)
        for (int kk = 0; kk < D / 16; ++kk) {
          unsigned a[4];  // rows 0-7 / 8-15 at k 0-7, then at k 8-15
          ldmatrix_x4(a, reinterpret_cast<const __nv_bfloat16*>(qs) +
                             (wwarp * 16 + lane % 16) * LDQ + kk * 16 + (lane / 16) * 8);
#pragma unroll
          for (int jp = 0; jp < TILE / 16; ++jp) {
            unsigned b[4];  // key rows 0-7 at k 0-7, k 8-15; key rows 8-15 likewise
            const int row = jp * 16 + lane % 8 + (lane / 16) * 8;
            const int col = kk * 16 + ((lane / 8) % 2) * 8;
            ldmatrix_x4(b, kb16 + (L::SWZ_K ? swz<D>(row, col) : row * (D + PAD) + col));
            mma_bf16(sc[2 * jp], a, b[0], b[1]);
            mma_bf16(sc[2 * jp + 1], a, b[2], b[3]);
          }
        }
      }

      // scale after the product, as the plain version (int8: times the key
      // scale of each column, read as its tile comes); then the visibility
      // rule
      const bool all_visible = col0 + TILE <= start;  // the whole chunk is committed prefix
      // the mask rows of the thread's two query rows, as offsets from the
      // region's first column (32-bit: fewer registers than two pointers)
      const int mrow[2] = {(ra % s_len) * t_reg - start, (rb % s_len) * t_reg - start};
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
                                          (col < start || mask[mrow[e / 2] + col] != 0));
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
      if constexpr (PTILES) {
        // p * v_scale (f32) split into bf16 hi + lo, into the warp's P tiles
        // now (the value scales landed with K): no score or p register is
        // live while V is converted and P.V runs
#pragma unroll
        for (int j = 0; j < TILE / 8; ++j) {
          const float2 f = *reinterpret_cast<const float2*>(vsc + j * 8 + 2 * t);
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // rows g, then g + 8
            const float x0 = __fmul_rn(sc[j][2 * h], f.x);
            const float x1 = __fmul_rn(sc[j][2 * h + 1], f.y);
            const unsigned hi = pack_bf16(x0, x1);
            const int at = (g + 8 * h) * L::LDP + j * 8 + 2 * t;
            *reinterpret_cast<unsigned*>(pt + at) = hi;
            *reinterpret_cast<unsigned*>(pt + 16 * L::LDP + at) =
                pack_bf16(x0 - bf16_lo(hi), x1 - bf16_hi(hi));
          }
        }
      }
    }
    walker_sync<NT>(walker);  // every warp is done with the K tile (and its scales)
    if (more) {
      stage_k(next);  // lands while P.V runs
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    walker_sync<NT>(walker);  // V landed
    if constexpr (QUANT && !F32) {
      convert_i8<D, PTILES ? 2 : 4>(reinterpret_cast<const int8_t*>(vt), ncols, conv);
      walker_sync<NT>(walker);
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
        // tiles); bf16 cache: p rounded to bf16, as the plain version rounds
        // it to the value dtype, packed as the step comes; int8: p * v_scale
        // in two parts, pf (rounded to bf16) + pl (the rest, rounded to
        // bf16), from the warp's P tiles or packed as the step comes (the
        // same bits: x = p * v_scale is rounded to f32 first in both)
        const __nv_bfloat16* vb16 =
            QUANT ? conv : reinterpret_cast<const __nv_bfloat16*>(vt);
#pragma unroll(PTILES ? 1 : TILE / 16)
        for (int kk = 0; kk < TILE / 16; ++kk) {
          unsigned pf[4];
          [[maybe_unused]] unsigned pl[4];
          if constexpr (PTILES) {  // rows 0-7 / 8-15 at k 0-7, then at k 8-15
            const __nv_bfloat16* pa = pt + (lane % 16) * L::LDP + kk * 16 + (lane / 16) * 8;
            ldmatrix_x4(pf, pa);
            ldmatrix_x4(pl, pa + 16 * L::LDP);
          } else if constexpr (QUANT) {
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              const int j = 2 * kk + jj;
              const float2 f = *reinterpret_cast<const float2*>(vsc + j * 8 + 2 * t);
#pragma unroll
              for (int h = 0; h < 2; ++h) {  // rows g, then g + 8
                const float x0 = __fmul_rn(sc[j][2 * h], f.x);
                const float x1 = __fmul_rn(sc[j][2 * h + 1], f.y);
                const unsigned hi = pack_bf16(x0, x1);
                pf[jj * 2 + h] = hi;
                pl[jj * 2 + h] = pack_bf16(x0 - bf16_lo(hi), x1 - bf16_hi(hi));
              }
            }
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) {  // rows g (e even), g + 8 (e odd) of tile 2 kk + e / 2
              const int j = 2 * kk + e / 2, h = e % 2;
              pf[e] = pack_bf16(sc[j][2 * h], sc[j][2 * h + 1]);
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
    walker_sync<NT>(walker);  // every warp is done with the V tile
    if (last) {
      // the virtual rank's rows below prow to its slot (the last slot
      // overlays the tiles, which no warp reads any more), and a fresh state
      // for the next rank
      if (active) {
        float* part = part_of(vr / C);
        float* part_m = part + pm * LDA;
        const int a = wwarp * 16 + g, b = a + 8;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          if (a < prow)
            *reinterpret_cast<float2*>(part + a * LDA + j * 8 + 2 * t) =
                make_float2(o[j][0], o[j][1]);
          if (b < prow)
            *reinterpret_cast<float2*>(part + b * LDA + j * 8 + 2 * t) =
                make_float2(o[j][2], o[j][3]);
          o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
        }
        if (t == 0 && a < prow) part_m[a] = m[0], part_m[pm + a] = l[0];
        if (t == 0 && b < prow) part_m[b] = m[1], part_m[pm + b] = l[1];
        m[0] = m[1] = -INFINITY;
        l[0] = l[1] = 0.f;
      }
    }
    if (more) stage_v(next);  // lands while the next q.k runs
    chunk = next;
  }

  cg::cluster_group cluster = cg::this_cluster();
  if constexpr (C > 1) {
    cluster.sync();
  } else {
    __syncthreads();
  }
  // virtual rank v's slot: slot v / C of the cluster's block v % C
  auto peer = [&](float* p, int v) {
    if constexpr (C > 1) {
      return cluster.map_shared_rank(p, v % C);
    } else {
      return p;
    }
  };
  // the merge over the virtual ranks in rank order, block b over its share of
  // the rows x D / 4 columns (all of a row's loads in flight before any is
  // used); a rank with no live chunk (v >= nlive) would weigh exactly 0 and
  // is left out
  for (int i = rank * THREADS + tid; i < prow * (D / 4); i += C * THREADS) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    float mb[VRANKS];
    float mmax = -INFINITY;
#pragma unroll
    for (int v = 0; v < VRANKS; ++v) {
      if (v < nlive) {
        mb[v] = peer(part_of(v / C), v)[pm * LDA + r];
        mmax = fmaxf(mmax, mb[v]);
      }
    }
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    float lsum = 0.f;
#pragma unroll
    for (int v = 0; v < VRANKS; ++v) {  // a rank that saw nothing of this row weighs 0
      if (v < nlive) {
        const float* part = peer(part_of(v / C), v);
        const float w = mb[v] == -INFINITY ? 0.f : expf(mb[v] - mmax);
        lsum += part[pm * LDA + pm + r] * w;
        const float4 x = *reinterpret_cast<const float4*>(part + r * LDA + c);
        acc.x += x.x * w, acc.y += x.y * w, acc.z += x.z * w, acc.w += x.w * w;
      }
    }
    const float inv = 1.f / fmaxf(lsum, 1e-20f);
    const int row = ORDER ? placed[0] * hkv + (int)blockIdx.x % hkv : bh;  // slot * hkv + kv head
    store4(out + ((size_t)row * gs + p0 + r) * D + c,
           make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv));
  }
  if constexpr (C > 1) cluster.sync();  // no block leaves while its peers read its slots
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

// D = 128: partial_kernel_mma, one launch, a cluster of C blocks per (slot x
// kv head, query tile) along grid.y.  Shared memory grows by a slot for each
// virtual rank a block runs after its walkers' first; the attribute is set
// once per instantiation, to what its largest query tile needs (at most the
// card's opt-in limit less its static shared memory).
constexpr size_t SMEM_OPTIN = 232448;  // a block's shared memory on sm_90, opt-in

// The dynamic shared memory a block may take: the opt-in limit less the
// instantiation's static shared memory (the block's placed slot).
template <typename T, typename TC, int D, int C, bool PT, int W, bool ORDER>
size_t dynamic_limit_mma() {
  static const size_t limit = [] {
    cudaFuncAttributes fa = {};
    return cudaFuncGetAttributes(&fa, partial_kernel_mma<T, TC, D, C, PT, W, ORDER>) ==
                   cudaSuccess
               ? SMEM_OPTIN - fa.sharedSizeBytes
               : 0;
  }();
  return limit;
}

template <typename T, typename TC, int D, int C, bool PT, int W, bool ORDER>
cudaError_t prepare_mma() {
  using L = MmaLayout<T, TC, D, PT, W>;
  constexpr size_t most = L::bytes(C, L::QT);
  const size_t limit = dynamic_limit_mma<T, TC, D, C, PT, W, ORDER>();
  static const cudaError_t attr =
      cudaFuncSetAttribute(partial_kernel_mma<T, TC, D, C, PT, W, ORDER>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)(most < limit ? most : limit));
  return attr;
}

template <typename T, typename TC, int D, int C, bool PT, int W>
cudaLaunchConfig_t config_mma(cudaLaunchAttribute* cluster, int pairs, int gs,
                              cudaStream_t stream) {
  using L = MmaLayout<T, TC, D, PT, W>;
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = C;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pairs, C, (gs + L::QT - 1) / L::QT);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = L::bytes(C, gs < L::QT ? gs : L::QT);
  cfg.stream = stream;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of C blocks of W walkers the card holds at once at ``gs`` query
// rows a kv head (0: the shared memory does not fit; negative: an error), of
// the batched grid's instantiation (a single request's holds at least as
// many).
template <typename T, typename TC, int D, int C, bool PT, int W>
int max_clusters_mma(int gs) {
  const cudaError_t attr = prepare_mma<T, TC, D, C, PT, W, true>();
  if (attr != cudaSuccess) return -(int)attr;
  cudaLaunchAttribute cluster[1];
  const cudaLaunchConfig_t cfg = config_mma<T, TC, D, C, PT, W>(cluster, 1, gs, 0);
  if (cfg.dynamicSmemBytes > dynamic_limit_mma<T, TC, D, C, PT, W, true>()) return 0;
  int count = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(
      &count, partial_kernel_mma<T, TC, D, C, PT, W, true>, &cfg);
  return err == cudaSuccess ? count : -(int)err;
}

// The call's operands as launch_mma takes them.
struct MmaArgs {
  const void *q, *k, *v, *k_scale, *v_scale, *mask, *start, *layer;
  void* out;
  int nslots, hkv, gs, s_len, t_reg, max_len;
  long long layer_stride, scale_layer_stride, slot_stride, scale_slot_stride, mask_slot_stride;
  cudaStream_t stream;
};

template <typename T, typename TC, int D, int C, bool PT, int W, bool ORDER>
int launch_mma_order(const MmaArgs& a) {
  const cudaError_t attr = prepare_mma<T, TC, D, C, PT, W, ORDER>();
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchAttribute cluster[1];
  const cudaLaunchConfig_t cfg =
      config_mma<T, TC, D, C, PT, W>(cluster, a.nslots * a.hkv, a.gs, a.stream);
  if (cfg.dynamicSmemBytes > dynamic_limit_mma<T, TC, D, C, PT, W, ORDER>()) return -1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, partial_kernel_mma<T, TC, D, C, PT, W, ORDER>, (const T*)a.q, (const TC*)a.k,
      (const TC*)a.v, (const float*)a.k_scale, (const float*)a.v_scale,
      (const uint8_t*)a.mask, (const int*)a.start, (const int*)a.layer, (T*)a.out, a.hkv,
      a.gs, a.s_len, a.t_reg, a.max_len, a.layer_stride, a.scale_layer_stride,
      a.slot_stride, a.scale_slot_stride, a.mask_slot_stride, 1.0f / sqrtf((float)D));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// A single request at (8, 1), the shape the host picks for every single
// request, runs the instantiation without the placement; every other call
// the one with it.
template <typename T, typename TC, int D, int C, bool PT, int W>
int launch_mma(const MmaArgs& a) {
  if constexpr (C == VRANKS && W == 1) {
    if (a.nslots == 1) return launch_mma_order<T, TC, D, C, PT, W, false>(a);
  }
  return launch_mma_order<T, TC, D, C, PT, W, true>(a);
}

// The (cluster, walkers) shapes built for a dtype pair and build: clusters
// of 8, 4, 2 and 1 with one walker; bf16 q over a bf16 cache also (4, 2);
// bf16 q over int8 in its register build (8, 1) only.  at_shape calls f(Shape<C, W>{}) at the
// shape asked for; -1 for one not built.
template <int C_, int W_>
struct Shape {
  static constexpr int C = C_, W = W_;
};

template <typename T, typename TC, bool PT, typename F>
int at_shape(int cluster, int walkers, F&& f) {
  if constexpr (std::is_same<TC, int8_t>::value && std::is_same<T, __nv_bfloat16>::value &&
                !PT) {
    return cluster == 8 && walkers == 1 ? f(Shape<8, 1>{}) : -1;
  } else {
    if (walkers == 1) {
      switch (cluster) {
        case 8: return f(Shape<8, 1>{});
        case 4: return f(Shape<4, 1>{});
        case 2: return f(Shape<2, 1>{});
        case 1: return f(Shape<1, 1>{});
        default: return -1;
      }
    }
    if constexpr (std::is_same<TC, __nv_bfloat16>::value) {
      if (walkers == 2 && cluster == 4) return f(Shape<4, 2>{});
    }
    return -1;
  }
}

template <typename T, typename TC, bool PT>
struct Pair {
  using Q = T;
  using Cache = TC;
  static constexpr bool P_TILES = PT;
};

// at_shape for the dtype pair and build the flags name (p_tiles: bf16 q
// over int8 only): f(Pair<T, TC, PT>{}, Shape<C, W>{}).
template <typename F>
int at_pair(int is_bf16, int cache_int8, int p_tiles, int cluster, int walkers, F&& f) {
  auto with = [&](auto pair) {
    using P = decltype(pair);
    return at_shape<typename P::Q, typename P::Cache, P::P_TILES>(
        cluster, walkers, [&](auto shape) { return f(pair, shape); });
  };
  if (p_tiles && !(is_bf16 && cache_int8)) return -1;
  if (is_bf16 && cache_int8) {
    return p_tiles ? with(Pair<__nv_bfloat16, int8_t, true>{})
                   : with(Pair<__nv_bfloat16, int8_t, false>{});
  }
  if (is_bf16) return with(Pair<__nv_bfloat16, __nv_bfloat16, false>{});
  if (cache_int8) return with(Pair<float, int8_t, false>{});
  return with(Pair<float, float, false>{});
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

// Clusters of ``cluster`` blocks of ``walkers`` walkers (see at_shape) of
// the head_dim-128 kernel for this dtype pair that the card holds at once at
// ``gs`` query rows a kv head: 0 when the blocks' shared memory does not
// fit, negative a cudaError_t, -1 for a build that does not exist.
// ``p_tiles`` selects, for bf16 q over int8, the build with the P tiles or
// the one packing p * v_scale in registers (clusters of 8, one walker); the
// other pairs have one build (p_tiles 0).
int vispec_verify_attention_max_clusters(int is_bf16, int cache_int8, int cluster, int walkers,
                                         int p_tiles, int gs) {
  return at_pair(is_bf16, cache_int8, p_tiles, cluster, walkers, [&](auto pair, auto shape) {
    using P = decltype(pair);
    using S = decltype(shape);
    return max_clusters_mma<typename P::Q, typename P::Cache, 128, S::C, P::P_TILES, S::W>(gs);
  });
}

// Returns a cudaError_t code (0 on success), or -1 for an unsupported
// head_dim / dtype pair / build / shape, a missing scratch or a shared
// memory that does not fit.  q and the output are bf16 (is_bf16) or f32;
// the cache is q's type, or int8 (cache_int8) with scales k_scale / v_scale
// (null otherwise).  ``nslots`` requests at once: start and layer hold one
// int32 per slot, and slot b's cache, scales and mask begin ``b *
// *_slot_stride`` elements after the given pointers (all strides 0 for a
// single request).  head_dim 128 is one launch of partial_kernel_mma with a
// cluster of ``cluster`` blocks of ``walkers`` walkers per (slot x kv head,
// 64 / walkers query rows), in the build ``p_tiles`` names (see
// vispec_verify_attention_max_clusters), its block columns serving the
// slots of a batch longest first; it takes no scratch (part_m, part_l,
// part_acc may be null), and the output does not depend on the shape, the
// build or the order.  head_dim 16 ignores them and writes the
// partials [nslots * hkv, ceil(max_len / TILE), gs (, D)] to the scratch.
// Launches on ``stream``; does not synchronise.
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
                            int is_bf16, int cache_int8, int cluster, int walkers,
                            int p_tiles, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (head_dim == 128) {
    const MmaArgs a = {q, k, v, k_scale, v_scale, mask, start, layer, out, nslots, hkv, gs,
                       s_len, t_reg, max_len, layer_stride, scale_layer_stride, slot_stride,
                       scale_slot_stride, mask_slot_stride, st};
    return at_pair(is_bf16, cache_int8, p_tiles, cluster, walkers,
                   [&](auto pair, auto shape) {
                     using P = decltype(pair);
                     using S = decltype(shape);
                     return launch_mma<typename P::Q, typename P::Cache, 128, S::C,
                                       P::P_TILES, S::W>(a);
                   });
  }
  if (head_dim != 16) return -1;
#define VISPEC_SPLIT(T, TC)                                                            \
  return launch_split<T, TC, 16>(q, k, v, k_scale, v_scale, mask, start, layer, part_m, \
                                 part_l, part_acc, out, nslots, hkv, gs, s_len, t_reg,  \
                                 max_len, layer_stride, scale_layer_stride, slot_stride, \
                                 scale_slot_stride, mask_slot_stride, st);
  if (is_bf16) {
    if (cache_int8) VISPEC_SPLIT(__nv_bfloat16, int8_t)
    VISPEC_SPLIT(__nv_bfloat16, __nv_bfloat16)
  }
  if (cache_int8) VISPEC_SPLIT(float, int8_t)
  VISPEC_SPLIT(float, float)
#undef VISPEC_SPLIT
}

}  // extern "C"
