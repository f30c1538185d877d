// Krum's two distance passes as hand-written CUDA kernels for Hopper
// (sm_90a), with a plain C interface bound from Python with ctypes
// (murmura_tpu_torch/ops/agg_kernels.py).
//
// pairwise_sq_distances replaces the Pallas TPU kernel
//   murmura_tpu/ops/pallas_agg.py: pairwise_sq_distances
//   (_pairwise_call / _pairwise_kernel)
// and computes D2[i, j] = |a_i|^2 + |b_j|^2 - 2 a_i . b_j over the P axis.
//
// circulant_sq_distances replaces the Pallas TPU kernel
//   murmura_tpu/ops/pallas_agg.py: circulant_sq_distances
//   (_circ_dist_call / _circ_dist_kernel)
// and computes D2[o, i] = |own_i - bcast[(i + offsets[o]) mod N]|^2.
//
// Bound on an H100: both are streamed reductions over P with a few
// multiply-adds per element read, so device-memory bytes bound them.  At
// the flagship shape (N = 16, P = 6,603,710, float32) a two-tensor call
// must read 845.2 MB, 0.252 ms at 3.35 TB/s; a same-tensor call 422.6 MB,
// 0.126 ms.  The float32 work is under 4 GFLOP per call (< 0.06 ms at
// 67 TFLOP/s), so the design goal is to read every input byte from device
// memory once and keep the arithmetic out of the way:
//
// - The TPU grid walks P in order and carries the sum in VMEM.  Blocks on
//   Hopper run in parallel, so both kernels split P into `splits` slices
//   (split-K), one slice per block (times the output tiles), enough blocks
//   to fill all SMs several times over.  Each block writes its partial sums
//   to a [splits, ...] buffer; a second small kernel adds the partials in
//   split order.  The reduction is deterministic (no float atomics): Krum
//   takes an argmin, and a run-to-run change of summation order could flip
//   a near-tie.
// - Pairwise: a block stages a 16-row tile of a and of b for 128 columns at
//   a time in shared memory with coalesced loads, then 16 groups of 16
//   threads each take every 16th column and accumulate a 4x4 register tile
//   of the 16x16 Gram block plus the squared norms, with float32 FMAs (no
//   TF32: the centered distances Krum ranks are small).  A same-tensor call
//   on a diagonal tile stages the rows once, so it reads half the bytes.
// - Circulant: every warp owns up to 8 (offset, row) pairs and strides its
//   slice 32 columns at a time, indexing row (i + o) mod N directly; nothing
//   is copied by a roll.  The block walks its slice in 256-column chunks
//   with a barrier between them, so the k re-reads of a row within a chunk
//   hit the L1 cache and device memory serves each byte once.
//
// Any N, M, P works: rows beyond N or M and the ragged tail of P are
// masked.  The circulant kernel reads any number k of offsets from its
// device array; the wrapper caps k at agg_kernels.MAX_OFFSETS.
// No wgmma or TMA yet: these are the first, simple versions.
//
// Every entry point launches on the given stream, does not synchronise,
// allocates nothing (the caller passes the output and the partial buffers)
// and returns cudaGetLastError() as an int.

#include <cuda_runtime.h>

namespace {

constexpr int PW_TILE = 16;     // rows of a (and of b) per output tile
constexpr int PW_CHUNK = 128;   // columns staged in shared memory per step
constexpr int PW_THREADS = 256;
constexpr int PW_GROUPS = PW_THREADS / 16;  // column groups of 16 threads

constexpr int CI_THREADS = 256;
constexpr int CI_WARPS = CI_THREADS / 32;
constexpr int CI_PAIRS_PER_WARP = 8;
constexpr int CI_PAIRS_PER_BLOCK = CI_WARPS * CI_PAIRS_PER_WARP;
constexpr int CI_CHUNK = 256;   // columns per block-wide step

constexpr int FIN_THREADS = 256;

__global__ void __launch_bounds__(PW_THREADS)
pairwise_partial_kernel(const float* __restrict__ a,
                        const float* __restrict__ b,
                        int n, int m, long long p, long long slice, int same,
                        float* __restrict__ part_g,
                        float* __restrict__ part_sa,
                        float* __restrict__ part_sb) {
  __shared__ float a_tile[PW_TILE][PW_CHUNK + 1];
  __shared__ float b_tile[PW_TILE][PW_CHUNK + 1];
  __shared__ float red[PW_GROUPS][PW_TILE * PW_TILE];
  __shared__ float red_a[PW_GROUPS][PW_TILE];
  __shared__ float red_b[PW_GROUPS][PW_TILE];

  const int ti = blockIdx.x;
  const int tj = blockIdx.y;
  const int split = blockIdx.z;
  const int i0 = ti * PW_TILE;
  const int j0 = tj * PW_TILE;
  const bool share = same && ti == tj;
  const long long c_begin = (long long)split * slice;
  const long long c_end = min(p, c_begin + slice);

  const int tid = threadIdx.x;
  const int group = tid / 16;
  const int lane = tid % 16;
  const int ri = (lane / 4) * 4;  // first of this thread's 4 rows of a
  const int rj = (lane % 4) * 4;  // first of this thread's 4 rows of b

  float acc[4][4];
  float na[4], nb[4];
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    na[x] = 0.f;
    nb[x] = 0.f;
#pragma unroll
    for (int y = 0; y < 4; ++y) acc[x][y] = 0.f;
  }
  float (*bt)[PW_CHUNK + 1] = share ? a_tile : b_tile;

  for (long long c0 = c_begin; c0 < c_end; c0 += PW_CHUNK) {
    for (int e = tid; e < PW_TILE * PW_CHUNK; e += PW_THREADS) {
      const int r = e / PW_CHUNK;
      const int c = e % PW_CHUNK;
      const long long col = c0 + c;
      const bool in_cols = col < c_end;
      a_tile[r][c] =
          (in_cols && i0 + r < n) ? a[(long long)(i0 + r) * p + col] : 0.f;
      if (!share) {
        b_tile[r][c] =
            (in_cols && j0 + r < m) ? b[(long long)(j0 + r) * p + col] : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = group; c < PW_CHUNK; c += PW_GROUPS) {
      float av[4], bv[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        av[x] = a_tile[ri + x][c];
        bv[x] = bt[rj + x][c];
      }
#pragma unroll
      for (int x = 0; x < 4; ++x) {
#pragma unroll
        for (int y = 0; y < 4; ++y) acc[x][y] = fmaf(av[x], bv[y], acc[x][y]);
      }
      if (rj == 0) {
#pragma unroll
        for (int x = 0; x < 4; ++x) na[x] = fmaf(av[x], av[x], na[x]);
      }
      if (ri == 0) {
#pragma unroll
        for (int y = 0; y < 4; ++y) nb[y] = fmaf(bv[y], bv[y], nb[y]);
      }
    }
    __syncthreads();
  }

  // Cross-group reduction in a fixed order.
#pragma unroll
  for (int x = 0; x < 4; ++x) {
#pragma unroll
    for (int y = 0; y < 4; ++y) red[group][(ri + x) * PW_TILE + rj + y] = acc[x][y];
  }
  if (rj == 0) {
#pragma unroll
    for (int x = 0; x < 4; ++x) red_a[group][ri + x] = na[x];
  }
  if (ri == 0) {
#pragma unroll
    for (int y = 0; y < 4; ++y) red_b[group][rj + y] = nb[y];
  }
  __syncthreads();

  {
    const int r = tid / PW_TILE;
    const int s = tid % PW_TILE;
    float g = 0.f;
    for (int q = 0; q < PW_GROUPS; ++q) g += red[q][tid];
    if (i0 + r < n && j0 + s < m) {
      part_g[((long long)split * n + i0 + r) * m + j0 + s] = g;
    }
  }
  // Row norms of a come from the tiles of the first column of tiles, row
  // norms of b from the first row of tiles, so each is written once.
  if (tid < PW_TILE && tj == 0 && i0 + tid < n) {
    float s = 0.f;
    for (int q = 0; q < PW_GROUPS; ++q) s += red_a[q][tid];
    part_sa[(long long)split * n + i0 + tid] = s;
  }
  if (tid >= PW_TILE && tid < 2 * PW_TILE && ti == 0 && j0 + tid - PW_TILE < m) {
    const int jj = tid - PW_TILE;
    float s = 0.f;
    for (int q = 0; q < PW_GROUPS; ++q) s += red_b[q][jj];
    part_sb[(long long)split * m + j0 + jj] = s;
  }
}

__global__ void __launch_bounds__(FIN_THREADS)
pairwise_finalize_kernel(const float* __restrict__ part_g,
                         const float* __restrict__ part_sa,
                         const float* __restrict__ part_sb, int n, int m,
                         int splits, float* __restrict__ out) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long cells = (long long)n * m;
  if (idx >= cells) return;
  const int i = (int)(idx / m);
  const int j = (int)(idx % m);
  float g = 0.f, sa = 0.f, sb = 0.f;
  for (int s = 0; s < splits; ++s) {
    g += part_g[(long long)s * cells + idx];
    sa += part_sa[(long long)s * n + i];
    sb += part_sb[(long long)s * m + j];
  }
  out[idx] = sa + sb - 2.0f * g;
}

__global__ void __launch_bounds__(CI_THREADS)
circulant_partial_kernel(const float* __restrict__ own,
                         const float* __restrict__ bcast,
                         const int* __restrict__ offsets, int k, int n,
                         long long p, long long slice,
                         float* __restrict__ part) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long total = (long long)k * n;
  const long long q0 =
      (long long)blockIdx.x * CI_PAIRS_PER_BLOCK + warp * CI_PAIRS_PER_WARP;
  const long long c_begin = (long long)blockIdx.y * slice;
  const long long c_end = min(p, c_begin + slice);

  const float* own_row[CI_PAIRS_PER_WARP];
  const float* b_row[CI_PAIRS_PER_WARP];
  bool valid[CI_PAIRS_PER_WARP];
  float acc[CI_PAIRS_PER_WARP];
#pragma unroll
  for (int u = 0; u < CI_PAIRS_PER_WARP; ++u) {
    const long long q = q0 + u;
    valid[u] = q < total;
    const long long qq = valid[u] ? q : 0;
    const int o = offsets[qq / n];
    const int i = (int)(qq % n);
    const int j = (int)(((long long)i + o) % n);
    own_row[u] = own + (long long)i * p;
    b_row[u] = bcast + (long long)j * p;
    acc[u] = 0.f;
  }

  for (long long c0 = c_begin; c0 < c_end; c0 += CI_CHUNK) {
    const long long c1 = min(c_end, c0 + CI_CHUNK);
    for (long long col = c0 + lane; col < c1; col += 32) {
#pragma unroll
      for (int u = 0; u < CI_PAIRS_PER_WARP; ++u) {
        if (valid[u]) {
          const float d = __ldg(own_row[u] + col) - __ldg(b_row[u] + col);
          acc[u] = fmaf(d, d, acc[u]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int u = 0; u < CI_PAIRS_PER_WARP; ++u) {
    float v = acc[u];
#pragma unroll
    for (int sh = 16; sh > 0; sh >>= 1) v += __shfl_xor_sync(0xffffffffu, v, sh);
    if (lane == 0 && valid[u]) part[(long long)blockIdx.y * total + q0 + u] = v;
  }
}

__global__ void __launch_bounds__(FIN_THREADS)
sum_splits_kernel(const float* __restrict__ part, long long cells, int splits,
                  float* __restrict__ out) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= cells) return;
  float s = 0.f;
  for (int t = 0; t < splits; ++t) s += part[(long long)t * cells + idx];
  out[idx] = s;
}

inline unsigned int blocks_for(long long items, int threads) {
  return (unsigned int)((items + threads - 1) / threads);
}

}  // namespace

extern "C" {

int agg_pw_tile() { return PW_TILE; }
int agg_pw_chunk() { return PW_CHUNK; }
int agg_ci_pairs_per_block() { return CI_PAIRS_PER_BLOCK; }
int agg_ci_chunk() { return CI_CHUNK; }

// out[n, m]; part_g[splits, n, m], part_sa[splits, n], part_sb[splits, m].
// Block z handles columns [z * slice, min(p, (z + 1) * slice)).  same != 0
// means b is a (the same tensor): diagonal tiles stage the rows once.
int agg_pairwise_sq_distances(const float* a, const float* b, float* out,
                              float* part_g, float* part_sa, float* part_sb,
                              int n, int m, long long p, long long slice,
                              int splits, int same, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + PW_TILE - 1) / PW_TILE, (m + PW_TILE - 1) / PW_TILE,
                  splits);
  pairwise_partial_kernel<<<grid, PW_THREADS, 0, st>>>(
      a, b, n, m, p, slice, same, part_g, part_sa, part_sb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pairwise_finalize_kernel<<<blocks_for((long long)n * m, FIN_THREADS),
                             FIN_THREADS, 0, st>>>(part_g, part_sa, part_sb, n,
                                                   m, splits, out);
  return (int)cudaGetLastError();
}

// out[k, n]; part[splits, k, n]; offsets[k] on the device, each in [0, n).
int agg_circulant_sq_distances(const float* own, const float* bcast,
                               const int* offsets, int k, float* out,
                               float* part, int n, long long p,
                               long long slice, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = (long long)k * n;
  const dim3 grid(blocks_for(total, CI_PAIRS_PER_BLOCK), splits);
  circulant_partial_kernel<<<grid, CI_THREADS, 0, st>>>(
      own, bcast, offsets, k, n, p, slice, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_splits_kernel<<<blocks_for(total, FIN_THREADS), FIN_THREADS, 0, st>>>(
      part, total, splits, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
