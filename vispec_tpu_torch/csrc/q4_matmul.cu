// int4 weight-only matrix product for decode shapes, for Hopper (sm_90a).
// Built by vispec_tpu_torch/ops/cuda_build.py with nvcc into a shared library
// with a plain C interface, loaded with ctypes by ops/quant.py (q4_matmul).
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
// Bound on an H100 SXM: the weight stream, K/2 * N packed bytes plus G * N * 4
// scale bytes over 3.35 TB/s (at 7B: [4096, 4096] 2.7 us, [4096, 11008] and
// [11008, 4096] 7.1 us, [4096, 32000] 20.8 us); a few operations per byte.
//
// Design: the TPU grid has one program per N tile (8 at [4096, 4096], 16 at
// [11008, 4096]), which would fill an eighth of the 132 SMs or less.  Here a
// block owns a 256-column tile and a range of whole quantization groups (the
// K split), and a third grid dim takes x's rows in chunks of 1, 2, 4 or 8 (one
// instantiation each); the host picks the split for about two blocks per SM.
// Lanes 2j and 2j+1 of a warp read the same 16 bytes (16 columns) of a packed
// row with one 16-byte load, and take its low and its high nibble; the four
// warps of a block take every fourth row of the group.  x's rows for the
// current chunk are staged in shared memory as f32.  At a group's end each
// lane scales its f32 sums by its half's scales, the lane pair adds its
// halves, and the block adds its warps in a fixed order into per-thread
// outputs.  A second kernel adds the K splits' partials in a fixed order (no
// atomics: runs are reproducible).  Plain CUDA cores, no tensor cores yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TILE_N = 256;  // 16 lane pairs x 16 columns
constexpr int XCH = 64;      // packed rows of x staged per step
constexpr int XPAD = XCH + 1;

// The 16 nibbles of one half (0: low, 1: high) of 16 packed bytes, as exact
// floats in [-8, 7].  Byte j of the vector is column j.  (v ^ 8) lands in a
// float's mantissa under the exponent of 2^23, so one subtraction yields
// (v ^ 8) - 8.
__device__ __forceinline__ void unpack_nibbles(const uint4& p, int half, float* w) {
  const unsigned words[4] = {p.x, p.y, p.z, p.w};
  const int sh = 4 * half;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned t = ((words[i] >> sh) & 0x0F0F0F0Fu) ^ 0x08080808u;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      w[4 * i + b] = __uint_as_float(__byte_perm(t, 0x4B000000u, 0x7440u + b)) - 8388616.f;
  }
}

// One block per (256-column tile, range of groups, MT rows of x).
template <int MT>
__global__ void __launch_bounds__(THREADS) q4_partial_kernel(
    const __nv_bfloat16* __restrict__ x,  // [M, K]
    const uint8_t* __restrict__ packed,   // [Kh, N]
    const float* __restrict__ scales,     // [G, N]
    float* __restrict__ part,             // [splits, M, N]
    int m, int kh, int n, int gs, int groups_per_split) {
  const int tile = blockIdx.x;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * MT;
  const int gh = kh / gs;  // groups per half
  const int g0 = split * groups_per_split;
  const int g1 = min(gh, g0 + groups_per_split);
  const int k = 2 * kh;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int half = lane & 1;
  const int cl = (lane >> 1) * 16;  // this lane's first column in the tile
  const int col = tile * TILE_N + cl;
  const bool col_ok = col < n;  // n % 16 == 0: all 16 columns or none

  __shared__ float xs[2][MT][XPAD];  // x[m0 + i, half * Kh + row]
  __shared__ __align__(16) float red[WARPS][MT][TILE_N];  // per-warp scaled group sums (float4 stores)

  float out[2 * MT];  // outputs tid + THREADS * j of the block's [MT][TILE_N]
#pragma unroll
  for (int j = 0; j < 2 * MT; ++j) out[j] = 0.f;

  for (int g = g0; g < g1; ++g) {
    float acc[MT][16];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int c = 0; c < 16; ++c) acc[i][c] = 0.f;

    for (int r0 = g * gs; r0 < (g + 1) * gs; r0 += XCH) {
      const int nr = min(XCH, (g + 1) * gs - r0);
      __syncthreads();  // the previous chunk's (and group's) readers are done
      for (int i = tid; i < 2 * MT * XCH; i += THREADS) {
        const int h = i / (MT * XCH), mm = (i / XCH) % MT, r = i % XCH;
        float v = 0.f;
        if (m0 + mm < m && r < nr)
          v = __bfloat162float(x[(size_t)(m0 + mm) * k + (size_t)h * kh + r0 + r]);
        xs[h][mm][r] = v;
      }
      __syncthreads();
      if (col_ok) {
#pragma unroll 4
        for (int r = warp; r < nr; r += WARPS) {
          const uint4 p = __ldg(reinterpret_cast<const uint4*>(
              packed + (size_t)(r0 + r) * n + col));
          float w[16];
          unpack_nibbles(p, half, w);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            const float xv = xs[half][i][r];
#pragma unroll
            for (int c = 0; c < 16; ++c) acc[i][c] = fmaf(xv, w[c], acc[i][c]);
          }
        }
      }
    }

    // scale on the output: the low half by s[g], the high half by s[gh + g]
    if (col_ok) {
      const float4* sp = reinterpret_cast<const float4*>(
          scales + (size_t)(g + half * gh) * n + col);
      float sc[16];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const float4 f = __ldg(sp + v);
        sc[4 * v] = f.x, sc[4 * v + 1] = f.y, sc[4 * v + 2] = f.z, sc[4 * v + 3] = f.w;
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int c = 0; c < 16; ++c) acc[i][c] *= sc[c];
    }
    // lane pairs hold the same columns: low half + high half
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int c = 0; c < 16; ++c)
        acc[i][c] += __shfl_xor_sync(0xffffffffu, acc[i][c], 1);
    if (half == 0) {
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        float4* dst = reinterpret_cast<float4*>(&red[warp][i][cl]);
#pragma unroll
        for (int v = 0; v < 4; ++v)
          dst[v] = make_float4(acc[i][4 * v], acc[i][4 * v + 1], acc[i][4 * v + 2],
                               acc[i][4 * v + 3]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 2 * MT; ++j) {
      const int idx = tid + THREADS * j;
      const int i = idx / TILE_N, c = idx % TILE_N;
      float s = red[0][i][c];
#pragma unroll
      for (int wp = 1; wp < WARPS; ++wp) s += red[wp][i][c];
      out[j] += s;
    }
  }

#pragma unroll
  for (int j = 0; j < 2 * MT; ++j) {
    const int idx = tid + THREADS * j;
    const int i = idx / TILE_N, c = tile * TILE_N + idx % TILE_N;
    if (m0 + i < m && c < n) part[((size_t)split * m + m0 + i) * n + c] = out[j];
  }
}

// out[i] = sum over the K splits of part[split, i], in split order.
__global__ void q4_combine_kernel(const float* __restrict__ part, float* __restrict__ out,
                                  int count, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += part[(size_t)p * count + i];
  out[i] = s;
}

template <int MT>
int launch(const void* x, const void* packed, const void* scales, void* part, void* out,
           int m, int kh, int n, int gs, int splits, int per, cudaStream_t stream) {
  const dim3 grid((n + TILE_N - 1) / TILE_N, splits, (m + MT - 1) / MT);
  q4_partial_kernel<MT><<<grid, THREADS, 0, stream>>>(
      (const __nv_bfloat16*)x, (const uint8_t*)packed, (const float*)scales,
      (float*)part, m, kh, n, gs, per);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int count = m * n;
  q4_combine_kernel<<<(count + 255) / 256, 256, 0, stream>>>(
      (const float*)part, (float*)out, count, splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Columns per block; the caller sizes the K split from it.
int vispec_q4_matmul_tile_n() { return TILE_N; }

// Returns a cudaError_t code (0 on success), or -1 for a shape the kernel
// does not take.  With splits == 1 the partial kernel writes ``out`` itself
// (``part`` may then alias it).  Launches on ``stream``; does not synchronise.
int vispec_q4_matmul(const void* x, const void* packed, const void* scales, void* part,
                     void* out, int m, int kh, int n, int group_size, int splits,
                     int groups_per_split, void* stream) {
  if (m < 1 || m > 64 || n % 16 || group_size % 8 || kh % group_size ||
      splits < 1 || groups_per_split < 1 ||
      (splits - 1) * groups_per_split >= kh / group_size)
    return -1;
  cudaStream_t st = (cudaStream_t)stream;
  if (m == 1) return launch<1>(x, packed, scales, part, out, m, kh, n, group_size, splits,
                               groups_per_split, st);
  if (m == 2) return launch<2>(x, packed, scales, part, out, m, kh, n, group_size, splits,
                               groups_per_split, st);
  if (m <= 4) return launch<4>(x, packed, scales, part, out, m, kh, n, group_size, splits,
                               groups_per_split, st);
  return launch<8>(x, packed, scales, part, out, m, kh, n, group_size, splits,
                   groups_per_split, st);
}

}  // extern "C"
