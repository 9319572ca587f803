// int4 weight-only matrix product for decode shapes, for Hopper (sm_90a), on
// tensor cores.  Built by vispec_tpu_torch/ops/cuda_build.py with nvcc into a
// shared library with a plain C interface, loaded with ctypes by ops/quant.py
// (q4_matmul).
//
// Replaces the Pallas TPU kernel vispec_tpu/ops/quant.py::_q4_kernel
// (launched by _q4_matmul, gated by _q4_supports_pallas, entered through
// qdot4).  Same contract:
//   x bf16 [M <= 64, K]; packed uint8 [K/2, N], row r in the low nibble and
//   row r + K/2 in the high nibble, each sign-extended as ((p & 0xF) ^ 8) - 8;
//   scales f32 [G, N], group g covering rows [g*gs, (g+1)*gs).  Each group's
//   partial product is scaled on the output, y_g = (x_g @ q_g) * s[g]: the low
//   half's group g uses s[g], the high half's s[G/2 + g].  Output f32 [M, N].
//
// Bound on an H100 SXM: bytes.  The weight stream, K/2 * N packed bytes plus
// 4 * G * N scale bytes, over 3.35 TB/s ([4096, 4096] 2.7 us, [4096, 11008]
// and [11008, 4096] 7.1 us, [4096, 32000] 20.8 us).  The products, 2 * M * K
// * N operations at 989 TFLOP/s in bf16, stay below that up to M = 64
// ([4096, 32000] M = 64: 17.0 us).
//
// Design: one kernel, q4_mma_kernel<MT>, for every M in 1..64.
// - The weight is read from device memory once, whatever M is.  A block owns
//   a tile of 128 columns and a range of whole quantization groups (the K
//   split) and carries all of x's rows as MT 16-row tiles (MT = ceil(M / 16),
//   the template argument); the grid has no dimension over M.
// - Tensor cores: mma.sync.m16n8k16, bf16 operands, f32 accumulators.  Four
//   warps each own 32 columns (four 8-column mma tiles), so each A fragment
//   of x, loaded by ldmatrix.x4 from shared memory, feeds four products.  The
//   B fragments are made in registers from the packed bytes: one 32-bit
//   shared load gives a thread its byte of one packed row in each of its
//   four mma tiles (the mma's column j of tile i is the warp's column 4j + i,
//   so a thread's bytes sit side by side); a byte_perm pairs two rows'
//   bytes, one lop3 makes ((nibble ^ 8) | 0x4300), the bf16 128 + (nibble ^
//   8), and one bf16x2 subtraction of 136 leaves the signed value, exact.
// - Each packed byte feeds two products: its low nibble against x[:, r], its
//   high nibble against x[:, K/2 + r].  The halves take their own scales, so
//   their sums stay apart until a scale multiplies them into the output
//   fragment.  MT = 1 and 2 keep one set of accumulators per half and flush
//   both at each group's end, with the group's scales prefetched into
//   registers when it starts.  At MT = 3 and 4 two sets would not fit in the
//   registers (192 f32 a thread at MT = 4), so a chunk is taken in two
//   passes, the low nibbles and then the high ones, into one set, flushed
//   wherever a group or the chunk ends, with the scales of the groups the
//   chunk touches staged beside it.  (Narrowing a warp to 16 columns instead
//   kept two sets in registers but made every warp load all of x's
//   fragments for half as many products: at M = 64 that measured slower.)
//   A group of 8 or 24 rows ends halfway through a k16 step: that step runs
//   as two m16n8k8 products with the flush between them.
// - Loads in flight: a ring of 4 shared-memory stages (3 at MT = 4) of 64
//   packed rows each, holding the packed tile and the matching slices of
//   both halves of x, filled by 16-byte cp.async.  Packed rows are padded to
//   144 bytes and x rows to 72 bf16, so neither the byte loads nor the
//   ldmatrix rows meet a bank conflict.  Ragged M rows and N columns are
//   never read from device memory: they are zero in shared memory.
// - The K split is reduced in one launch, in a fixed order and with no
//   atomics (runs are reproducible): the splits of a column tile form one
//   thread-block cluster (at most 8), each block leaves its f32 partial in
//   its own shared memory, and block r of the cluster adds the partials of
//   ranks 0, 1, ... in order over its share of the tile's outputs, reading
//   its peers' shared memory (distributed shared memory).  No partial goes
//   through device memory: M = 8 moves at most 28 KB of partials a tile
//   between SMs (8 splits), M = 64 224 KB; the host picks the split from the
//   clusters the card holds at once.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TILE_N = 128;       // columns per block
constexpr int WARPS = 4;          // each owns 32 columns
constexpr int THREADS = WARPS * 32;
constexpr int NT = 4;             // 8-column mma tiles a warp
constexpr int KC = 64;            // packed rows per pipeline stage
constexpr int LDP = TILE_N + 16;  // bytes per shared packed row
constexpr int LDX = KC + 8;       // bf16 per shared row of x
constexpr int MAX_SPLITS = 8;     // the portable cluster size
constexpr int SCALE_GROUP_BYTES = 2 * TILE_N * 4;  // a group's scales, both halves

// MT <= 2 takes a chunk in one pass with a set of accumulators for each
// half; MT >= 3 in two passes with one set (see the note above).
template <int MT>
__host__ __device__ constexpr bool two_pass() {
  return MT >= 3;
}
template <int MT>
__host__ __device__ constexpr int stages() {
  return MT == 4 ? 3 : 4;
}
// A stage: the packed tile, x's two halves, then ``sg`` groups' scales.
template <int MT>
__host__ __device__ constexpr int stage_base() {
  return KC * LDP + 2 * MT * 16 * LDX * (int)sizeof(__nv_bfloat16);
}
template <int MT>
__host__ __device__ constexpr int smem_bytes(int sg) {
  return stages<MT>() * (stage_base<MT>() + sg * SCALE_GROUP_BYTES);
}
// Groups a chunk of KC rows can touch (it may start anywhere in a group),
// whose scales the two-pass instantiations stage with the chunk.
template <int MT>
__host__ __device__ constexpr int scale_groups(int gs) {
  return two_pass<MT>() ? (KC - 1) / gs + 2 : 0;
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
// and receives elements (l / 4, 2 * (l % 4) + {0, 1}) of each.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
// c[16x8] += a[16x16] . b[16x8], bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_k16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                        unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// c[16x8] += a[16x8] . b[8x8]: a0 rows 0-7, a1 rows 8-15
__device__ __forceinline__ void mma_k8(float (&c)[4], unsigned a0, unsigned a1, unsigned b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b));
}

// The bf16 pair (signed nibble of byte i of ``a``, same of ``b``) of the low
// (shift 0) or high (shift 4) nibbles: the B register of rows k, k + 1.
// ``mask`` and ``bias`` are 0x000F000F and 0x43084308, passed in registers so
// that one lop3 computes (v & mask) ^ bias.
__device__ __forceinline__ unsigned nibble_pair(unsigned a, unsigned b, int i, int shift,
                                                unsigned mask, unsigned bias) {
  const unsigned r = __byte_perm(a, b, i | ((4 + i) << 8)) >> shift;  // bytes 0, 2: a's, b's byte i
  unsigned v;  // 128 + (nibble ^ 8) in each bf16 half
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;\n" : "=r"(v) : "r"(r), "r"(mask), "r"(bias));
  const __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                                   __float2bfloat162_rn(136.f));
  return *reinterpret_cast<const unsigned*>(&d);
}

// This thread's 2 * NT scales in a row of ``scales`` (zero past N).
__device__ __forceinline__ void load_scales(float (&s)[2 * NT], const float* __restrict__ row,
                                            bool ok) {
#pragma unroll
  for (int v = 0; v < 2 * NT / 4; ++v) {
    const float4 f = ok ? __ldg(reinterpret_cast<const float4*>(row) + v)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    s[4 * v] = f.x, s[4 * v + 1] = f.y, s[4 * v + 2] = f.z, s[4 * v + 3] = f.w;
  }
}

// One pass: group ``gcur`` ends.  out += lo * s_lo + hi * s_hi per column,
// the accumulators restart, and the next group's scales are prefetched.
template <int MT>
__device__ __forceinline__ void next_group(float (&out)[MT][NT][4], float (&lo)[MT][NT][4],
                                           float (&hi)[MT][NT][4], float (&slo)[2 * NT],
                                           float (&shi)[2 * NT], int& gcur, int g1, int gh,
                                           const float* __restrict__ scales, int n, int col,
                                           bool col_ok) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = (e & 1) * NT + i;  // the mma column 2t + (e & 1) of tile i
        out[mt][i][e] += lo[mt][i][e] * slo[c] + hi[mt][i][e] * shi[c];
        lo[mt][i][e] = 0.f;
        hi[mt][i][e] = 0.f;
      }
  if (++gcur < g1) {
    load_scales(slo, scales + (size_t)gcur * n + col, col_ok);
    load_scales(shi, scales + (size_t)(gh + gcur) * n + col, col_ok);
  }
}

// Two passes: out += acc * (this thread's 2 * NT scales staged at ``s``);
// the accumulators restart.
template <int MT>
__device__ __forceinline__ void flush(float (&out)[MT][NT][4], float (&acc)[MT][NT][4],
                                      const float* s) {
  float sc[2 * NT];
#pragma unroll
  for (int v = 0; v < 2 * NT / 4; ++v) {
    const float4 f = reinterpret_cast<const float4*>(s)[v];
    sc[4 * v] = f.x, sc[4 * v + 1] = f.y, sc[4 * v + 2] = f.z, sc[4 * v + 3] = f.w;
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        out[mt][i][e] = fmaf(acc[mt][i][e], sc[(e & 1) * NT + i], out[mt][i][e]);
        acc[mt][i][e] = 0.f;
      }
}

// One block per (128-column tile, range of whole groups); the ranges of a
// tile form a cluster along grid.y that reduces them.
template <int MT>
__global__ void __launch_bounds__(THREADS) q4_mma_kernel(
    const __nv_bfloat16* __restrict__ x,  // [M, K]
    const uint8_t* __restrict__ packed,   // [Kh, N]
    const float* __restrict__ scales,     // [G, N]
    float* __restrict__ out,              // [M, N]
    int m, int kh, int n, int gs, int groups_per_split, int sg) {
  constexpr int STAGES = stages<MT>();
  constexpr int MR = MT * 16;      // rows of x carried (the ragged ones zero)
  constexpr int XV = KC / 8;       // 16-byte vectors in a stage's row of x
  constexpr int PV = TILE_N / 16;  // 16-byte vectors in a packed row
  constexpr int SV = TILE_N / 4;   // 16-byte vectors in a group-half's scales
  const int tile = blockIdx.x;
  const int gh = kh / gs;  // groups per half
  const int g0 = blockIdx.y * groups_per_split;
  const int g1 = min(gh, g0 + groups_per_split);
  const int row0 = g0 * gs;               // this block's first packed row
  const int rows = max(0, g1 - g0) * gs;  // and its count (a multiple of 8)
  const int nchunks = (rows + KC - 1) / KC;
  const int col0 = tile * TILE_N;
  const int ncols = min(TILE_N, n - col0);  // a multiple of 16
  const int k = 2 * kh;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // accumulator rows g, g + 8; mma columns 2t, 2t + 1
  const int wc = warp * 8 * NT;          // the warp's first column in the tile
  const int sc = wc + 2 * NT * t;        // this thread's 2 * NT output columns start here
  const int stage_bytes = stage_base<MT>() + sg * SCALE_GROUP_BYTES;

  extern __shared__ __align__(16) unsigned char smem[];
  auto packed_s = [&](int s) { return smem + s * stage_bytes; };  // [KC][LDP]
  auto x_s = [&](int s) {  // [2 halves][MR][LDX]
    return reinterpret_cast<__nv_bfloat16*>(smem + s * stage_bytes + KC * LDP);
  };
  auto scale_s = [&](int s) {  // [sg groups][2 halves][TILE_N]
    return reinterpret_cast<float*>(smem + s * stage_bytes + stage_base<MT>());
  };

  // Staging slots: thread tid copies the same 16-byte vectors of every
  // chunk, PSLOTS of the packed tile and XSLOTS of x (both halves), fixed for
  // the block; ragged M rows and N columns are zeroed once and never copied.
  constexpr int PSLOTS = KC * PV / THREADS, PROWS = THREADS / PV;
  constexpr int XSLOTS = 2 * MR * XV / THREADS, XROWS = THREADS / XV;
  static_assert(PSLOTS * THREADS == KC * PV && XSLOTS * THREADS == 2 * MR * XV, "slots");
  const int pr = tid / PV, pv = tid % PV;  // packed row pr + j * PROWS, vector pv
  const bool p_ok = pv * 16 < ncols;
  const uint8_t* p_src = packed + (size_t)(row0 + pr) * n + col0 + pv * 16;
  const int xv = tid % XV;  // x vector xv of row (tid / XV + j * XROWS) % MR, half .../ MR
  int x_src[XSLOTS], x_dst[XSLOTS];  // x_src < 0: a ragged row
#pragma unroll
  for (int j = 0; j < XSLOTS; ++j) {
    const int hr = tid / XV + j * XROWS, h = hr / MR, r = hr % MR;
    x_dst[j] = (h * MR + r) * LDX + xv * 8;
    x_src[j] = r < m ? r * k + h * kh + row0 + xv * 8 : -1;
  }
  for (int s = 0; s < STAGES; ++s) {
    if (!p_ok)
#pragma unroll
      for (int j = 0; j < PSLOTS; ++j)
        *reinterpret_cast<uint4*>(packed_s(s) + (pr + j * PROWS) * LDP + pv * 16) =
            make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int j = 0; j < XSLOTS; ++j)
      if (x_src[j] < 0) *reinterpret_cast<uint4*>(x_s(s) + x_dst[j]) = make_uint4(0u, 0u, 0u, 0u);
  }

  // chunk c (packed rows [row0 + c * KC, + KC) of this block) into its stage,
  // with the scales of the groups it touches (slot q: group c * KC / gs + q)
  auto stage = [&](int c) {
    const int s = c % STAGES, nr = rows - c * KC;  // rows past nr (the last chunk's) stay
    unsigned char* ps = packed_s(s);
    if (p_ok)
#pragma unroll
      for (int j = 0; j < PSLOTS; ++j)
        if (pr + j * PROWS < nr)
          cp_async16(ps + (pr + j * PROWS) * LDP + pv * 16,
                     p_src + (size_t)(c * KC + j * PROWS) * n);
    __nv_bfloat16* xs = x_s(s);
#pragma unroll
    for (int j = 0; j < XSLOTS; ++j)
      if (x_src[j] >= 0 && xv * 8 < nr) cp_async16(xs + x_dst[j], x + x_src[j] + c * KC);
    if constexpr (!two_pass<MT>()) return;
    const int gl = (c * KC) / gs, nq = (c * KC + min(nr, KC) - 1) / gs - gl + 1;
    float* ss = scale_s(s);
    for (int i = tid; i < nq * 2 * SV; i += THREADS) {
      const int q = i / (2 * SV), h = (i / SV) % 2, v = i % SV;
      if (v * 4 < ncols)
        cp_async16(ss + (q * 2 + h) * TILE_N + v * 4,
                   scales + (size_t)(h * gh + g0 + gl + q) * n + col0 + v * 4);
    }
  };

  float acc[2][MT][NT][4], acc_out[MT][NT][4];  // one pass: [0] the low half, [1] the high
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[0][mt][i][e] = acc[1][mt][i][e] = acc_out[mt][i][e] = 0.f;
  const unsigned mask = 0x000F000Fu, bias = 0x43084308u;
  const bool col_ok = col0 + sc < n;
  float s_lo[2 * NT], s_hi[2 * NT];  // one pass: the current group's scales
  int gcur = g0;
  if (!two_pass<MT>() && gcur < g1) {
    load_scales(s_lo, scales + (size_t)gcur * n + col0 + sc, col_ok);
    load_scales(s_hi, scales + (size_t)(gh + gcur) * n + col0 + sc, col_ok);
  }

#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < nchunks) stage(c);
    cp_async_commit();
  }
  int grem = gs;  // rows left in the current group (two passes: at the chunk's start)
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<STAGES - 2>();  // chunk c landed
    __syncthreads();              // ... for every thread; chunk c - 1's stage is free
    if (c + STAGES - 1 < nchunks) stage(c + STAGES - 1);
    cp_async_commit();

    const unsigned char* ps = packed_s(c % STAGES) + wc + NT * g + 2 * t * LDP;
    const __nv_bfloat16* xs = x_s(c % STAGES);
    const int nr = min(KC, rows - c * KC);
    // rows 16j + 2t, + 1 (b0) and 16j + 2t + 8, + 9 (b1) of the chunk, NT
    // bytes each (rows past nr are stale and never used)
    unsigned w[KC / 16][4];
#pragma unroll
    for (int j = 0; j < KC / 16; ++j) {
      const unsigned char* p = ps + 16 * j * LDP;
      w[j][0] = *reinterpret_cast<const unsigned*>(p);
      w[j][1] = *reinterpret_cast<const unsigned*>(p + LDP);
      w[j][2] = *reinterpret_cast<const unsigned*>(p + 8 * LDP);
      w[j][3] = *reinterpret_cast<const unsigned*>(p + 9 * LDP);
    }
    if constexpr (!two_pass<MT>()) {
#pragma unroll
      for (int j = 0; j < KC / 16; ++j) {
        if (16 * j >= nr) break;
        unsigned b[2][NT][2];  // [half][tile][b0, b1]
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i = 0; i < NT; ++i) {
            b[h][i][0] = nibble_pair(w[j][0], w[j][1], i, 4 * h, mask, bias);
            b[h][i][1] = nibble_pair(w[j][2], w[j][3], i, 4 * h, mask, bias);
          }
        unsigned a[2][MT][4];  // [half][tile]: rows 0-7 / 8-15 at k 0-7, then at k 8-15
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            ldmatrix_x4(a[h][mt],
                        xs + (h * MR + mt * 16 + lane % 16) * LDX + 16 * j + (lane / 16) * 8);
        if (grem == 8) {  // the group ends halfway through this step
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int i = 0; i < NT; ++i)
                mma_k8(acc[h][mt][i], a[h][mt][0], a[h][mt][1], b[h][i][0]);
          next_group<MT>(acc_out, acc[0], acc[1], s_lo, s_hi, gcur, g1, gh, scales, n,
                         col0 + sc, col_ok);
          grem = gs;
          if (16 * j + 8 < nr) {  // rows past the block's last group are not read
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int i = 0; i < NT; ++i)
                  mma_k8(acc[h][mt][i], a[h][mt][2], a[h][mt][3], b[h][i][1]);
            grem -= 8;
          }
        } else {
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int i = 0; i < NT; ++i)
                mma_k16(acc[h][mt][i], a[h][mt], b[h][i][0], b[h][i][1]);
          grem -= 16;
        }
        if (grem == 0) {
          next_group<MT>(acc_out, acc[0], acc[1], s_lo, s_hi, gcur, g1, gh, scales, n,
                         col0 + sc, col_ok);
          grem = gs;
        }
      }
    } else {
      const float* ss = scale_s(c % STAGES) + sc;
      int rem = grem;
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // the low nibbles against x[:, r], the high against x[:, Kh + r]
        rem = grem;
        int q = 0;  // the scale slot of the current group
#pragma unroll
        for (int j = 0; j < KC / 16; ++j) {
          if (16 * j >= nr) break;
          unsigned b[NT][2];
#pragma unroll
          for (int i = 0; i < NT; ++i) {
            b[i][0] = nibble_pair(w[j][0], w[j][1], i, 4 * h, mask, bias);
            b[i][1] = nibble_pair(w[j][2], w[j][3], i, 4 * h, mask, bias);
          }
          unsigned a[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            ldmatrix_x4(a[mt], xs + (h * MR + mt * 16 + lane % 16) * LDX + 16 * j + (lane / 16) * 8);
          if (rem == 8) {  // the group ends halfway through this step
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int i = 0; i < NT; ++i) mma_k8(acc[0][mt][i], a[mt][0], a[mt][1], b[i][0]);
            flush<MT>(acc_out, acc[0], ss + (q * 2 + h) * TILE_N);
            ++q;
            rem = gs;
            if (16 * j + 8 < nr) {  // rows past the block's last group are not read
#pragma unroll
              for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int i = 0; i < NT; ++i) mma_k8(acc[0][mt][i], a[mt][2], a[mt][3], b[i][1]);
              rem -= 8;
            }
          } else {
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int i = 0; i < NT; ++i) mma_k16(acc[0][mt][i], a[mt], b[i][0], b[i][1]);
            rem -= 16;
          }
          if (rem == 0) {
            flush<MT>(acc_out, acc[0], ss + (q * 2 + h) * TILE_N);
            ++q;
            rem = gs;
          }
        }
        if (rem != gs) flush<MT>(acc_out, acc[0], ss + (q * 2 + h) * TILE_N);  // ends mid-group
      }
      grem = rem;
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the stages are free: they hold the partial from here on

  // this block's partial [MR][TILE_N] f32, then the cluster's fixed-order sum
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        part[(mt * 16 + g + (e / 2) * 8) * TILE_N + sc + (e & 1) * NT + i] = acc_out[mt][i][e];
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int nsplit = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  for (int i = rank * THREADS + tid; i < m * (TILE_N / 4); i += nsplit * THREADS) {
    const int r = i / (TILE_N / 4), c = (i % (TILE_N / 4)) * 4;
    if (c >= ncols) continue;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < nsplit; ++q) {
      const float4 p = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(part + r * TILE_N + c, q));
      s.x += p.x, s.y += p.y, s.z += p.z, s.w += p.w;
    }
    *reinterpret_cast<float4*>(out + (size_t)r * n + col0 + c) = s;
  }
  cluster.sync();  // no block leaves while its peers read its partial
}

// The dynamic shared-memory attribute, set once per instantiation (to the
// most any group size needs: groups of 8 rows).
template <int MT>
cudaError_t prepare() {
  static const cudaError_t attr =
      cudaFuncSetAttribute(q4_mma_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bytes<MT>(scale_groups<MT>(8)));
  return attr;
}

template <int MT>
cudaLaunchConfig_t config(cudaLaunchAttribute* cluster, int n, int splits, int sg,
                          cudaStream_t stream) {
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = splits;  // the K splits of one column tile
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + TILE_N - 1) / TILE_N, splits, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes<MT>(sg);
  cfg.stream = stream;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of ``splits`` blocks the card holds at once (negative: an error).
template <int MT>
int max_clusters(int n, int gs, int splits) {
  const cudaError_t attr = prepare<MT>();
  if (attr != cudaSuccess) return -(int)attr;
  cudaLaunchAttribute cluster[1];
  const cudaLaunchConfig_t cfg = config<MT>(cluster, n, splits, scale_groups<MT>(gs), 0);
  int count = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&count, q4_mma_kernel<MT>, &cfg);
  return err == cudaSuccess ? count : -(int)err;
}

template <int MT>
int launch(const void* x, const void* packed, const void* scales, void* out, int m, int kh,
           int n, int gs, int splits, int per, cudaStream_t stream) {
  const cudaError_t attr = prepare<MT>();
  if (attr != cudaSuccess) return (int)attr;
  const int sg = scale_groups<MT>(gs);
  cudaLaunchAttribute cluster[1];
  const cudaLaunchConfig_t cfg = config<MT>(cluster, n, splits, sg, stream);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, q4_mma_kernel<MT>, (const __nv_bfloat16*)x, (const uint8_t*)packed,
      (const float*)scales, (float*)out, m, kh, n, gs, per, sg);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

bool takes(int m, int kh, int n, int gs) {
  return m >= 1 && m <= 64 && n % 16 == 0 && gs % 8 == 0 && gs > 0 && kh % gs == 0;
}

}  // namespace

extern "C" {

// Columns per block and the largest K split; the caller sizes the split.
int vispec_q4_matmul_tile_n() { return TILE_N; }
int vispec_q4_matmul_max_splits() { return MAX_SPLITS; }

// Clusters of ``splits`` blocks (one column tile's K split) that the card
// holds at once for this shape; negative: a cudaError_t, or -1 for a shape
// the kernel does not take.
int vispec_q4_matmul_max_clusters(int m, int kh, int n, int group_size, int splits) {
  if (!takes(m, kh, n, group_size) || splits < 1 || splits > MAX_SPLITS) return -1;
  if (m <= 16) return max_clusters<1>(n, group_size, splits);
  if (m <= 32) return max_clusters<2>(n, group_size, splits);
  if (m <= 48) return max_clusters<3>(n, group_size, splits);
  return max_clusters<4>(n, group_size, splits);
}

// Returns a cudaError_t code (0 on success), or -1 for a shape the kernel
// does not take.  Launches on ``stream``; does not synchronise.
int vispec_q4_matmul(const void* x, const void* packed, const void* scales, void* out, int m,
                     int kh, int n, int group_size, int splits, int groups_per_split,
                     void* stream) {
  if (!takes(m, kh, n, group_size) || splits < 1 || splits > MAX_SPLITS ||
      groups_per_split < 1 || (splits - 1) * groups_per_split >= kh / group_size)
    return -1;
  cudaStream_t st = (cudaStream_t)stream;
  if (m <= 16) return launch<1>(x, packed, scales, out, m, kh, n, group_size, splits,
                                groups_per_split, st);
  if (m <= 32) return launch<2>(x, packed, scales, out, m, kh, n, group_size, splits,
                                groups_per_split, st);
  if (m <= 48) return launch<3>(x, packed, scales, out, m, kh, n, group_size, splits,
                                groups_per_split, st);
  return launch<4>(x, packed, scales, out, m, kh, n, group_size, splits, groups_per_split, st);
}

}  // extern "C"
