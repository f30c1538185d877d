// Krum's two distance passes as hand-written CUDA kernels for Hopper
// (sm_90a), with a plain C interface bound from Python with ctypes
// (murmura_tpu_torch/ops/agg_kernels.py, which also plans every launch:
// tile width, ring size, grid).
//
// circulant_sq_distances replaces the Pallas TPU kernel
//   murmura_tpu/ops/pallas_agg.py: circulant_sq_distances
//   (_circ_dist_call / _circ_dist_kernel)
// and computes D2[o, i] = sum_p (own[i, p] - bcast[(i + offsets[o]) mod N, p])^2
// as a direct difference-square sum, [k, N] float32 out.
//
// pairwise_sq_distances replaces the Pallas TPU kernel
//   murmura_tpu/ops/pallas_agg.py: pairwise_sq_distances
//   (_pairwise_call / _pairwise_kernel)
// and computes D2[i, j] = |a_i - c|^2 + |b_j - c|^2 - 2 (a_i - c) . (b_j - c)
// over the P axis, norms and Gram from the same pass, with an optional
// center row c [P] subtracted as the values are loaded (no centered copy
// of a or b is ever written).
//
// Bound on an H100: both read every input once and do a few operations per
// byte, so device-memory bytes bound them.  At the flagship shape (N = 16,
// P = 6,603,710, float32) a two-tensor call reads 845.2 MB (0.252 ms at
// 3.35 TB/s), a same-tensor call 422.6 MB (0.126 ms); the pairwise center
// row adds 26.4 MB.  What keeps a kernel from that bound is instruction
// issue and request count, not arithmetic, so the design:
//
// - Persistent grid, ring of asynchronous copies.  Each block walks the
//   P axis in tiles of TC columns (tile t, t + gridDim.x, ...) and stages
//   every row it needs for a tile in shared memory through a ring of
//   STAGES slots, with cp.async and commit/wait groups: the copies of tile
//   t + 2 are in flight while tile t is reduced, one barrier a tile.  A
//   warp copies whole rows (32 consecutive vectors a request), so a copy
//   costs a few instructions and no per-element index arithmetic.
// - Alignment.  P = 6,603,710 is 2 mod 4, so every odd row starts on an
//   8-byte boundary only: a 2-D TMA map (16-byte global stride) is refused
//   and 16-byte copies would fault.  The copies are 8 bytes (VEC = 2) when
//   P and every base pointer are even in floats, else 4 bytes (VEC = 1);
//   nothing is padded or copied in device memory.
// - Circulant: all N rows of own and of bcast (once when the two are the
//   same tensor) are staged, so the k re-reads of a row come from shared
//   memory.  A thread owns one own row i and a group of 4 offsets and
//   reads own[i] once and bcast[(i + o) mod N] once per offset for each of
//   its columns: 1.25 shared loads per (pair, column pair).  Groups of
//   pairs beyond one block's 256 threads go to blockIdx.y.  Staging all
//   rows caps N (the wrapper raises past the shared-memory limit).
// - Pairwise: the Gram product runs on the tensor cores as error-
//   compensated TF32 (3xTF32): each centered value x is split into
//   hi = x rounded to TF32 and lo = x - hi, and mma.sync m16n8k8 accumulates
//   hi.hi + hi.lo + lo.hi in float32, about float32 accuracy (plain TF32
//   keeps three decimal digits and would break the 1e-5 limit and Krum's
//   near-ties).  Each tile's mma chain starts from zero and is added to
//   float32 totals, so the tensor cores' accumulation never runs long.
//   mma.sync and not wgmma: wgmma takes 64-row tiles, and at N = 16 three
//   quarters of each would be padding; from N >= 64 wgmma becomes the tool.
//   The norms are float32 FMAs over the values a thread already holds.  A
//   block holds up to 8 warp tiles of 16x16 (64x32 of the output) and
//   stages each of its rows once; at N = 16 the single tile's parallelism
//   comes from the P tiles.  A same-tensor call stages the rows once, and a
//   diagonal warp tile takes B's fragments from A's registers.
// - Reduction.  Each block writes its partial sums to a [gridDim.x, ...]
//   buffer and a second small kernel adds them, one warp per output cell
//   in a fixed order: the result is deterministic (no float atomics; Krum
//   takes an argmin), and the few hundred partials of a cell are read 32
//   at a time rather than by one thread in a serial loop.
//
// Every entry point launches on the given stream, does not synchronise,
// allocates nothing (the caller passes the output and the partial buffer)
// and returns cudaGetLastError() as an int.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;        // threads a block, both kernels
constexpr int STAGES = 3;      // slots of the shared-memory ring
constexpr int CI_KT = 4;       // circulant offsets a thread (k-regular(4): all)
constexpr int PW_ROWS = 16;    // pairwise output tile: 16 rows of a x 16 of b
constexpr int PW_WARPS = NT / 32;
constexpr int PW_RED = PW_ROWS * PW_ROWS + 2 * PW_ROWS;  // Gram, |a|^2, |b|^2
constexpr int FIN_THREADS = 256;
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may take

template <int VEC> struct VecOf;
template <> struct VecOf<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.f; }
};
template <> struct VecOf<2> {
  using T = float2;
  static __device__ __forceinline__ T zero() { return make_float2(0.f, 0.f); }
};

__device__ __forceinline__ void acc_sq_diff(float& acc, float a, float b) {
  const float d = a - b;
  acc = fmaf(d, d, acc);
}
__device__ __forceinline__ void acc_sq_diff(float& acc, float2 a, float2 b) {
  const float dx = a.x - b.x;
  const float dy = a.y - b.y;
  acc = fmaf(dx, dx, acc);
  acc = fmaf(dy, dy, acc);
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src),
               "n"(BYTES)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// x = hi + lo: hi is x rounded to TF32's 10 mantissa bits (half up on the
// magnitude, two integer operations; cvt.rna.tf32.f32 adds an Inf/NaN guard
// on top), lo = x - hi is exact, and the tensor cores read only lo's top
// 19 bits.  Per product the terms dropped (lo.lo, lo's truncation) are
// below 1.3e-6 |x| |y|.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
// d += A (16x8, row) * B (8x8, col), TF32 in, float32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The tiles of the P axis a block walks: first, first + step, ... < tiles.
__device__ __forceinline__ long long tiles_of_block(long long tiles) {
  const long long first = blockIdx.x;
  return first < tiles ? (tiles - first + gridDim.x - 1) / gridDim.x : 0;
}

// The sum over `blocks` per-block partials part[0], part[stride], ...: lane l
// adds the blocks l, l + 32, ... in order, then the lanes' sums meet in a
// fixed butterfly, so lane 0's total is the same from run to run.
__device__ __forceinline__ float sum_over_blocks(const float* __restrict__ part,
                                                 long long stride, int blocks) {
  const int lane = threadIdx.x % 32;
  float s = 0.f;
  for (int b = lane; b < blocks; b += 32) s += part[(long long)b * stride];
#pragma unroll
  for (int sh = 16; sh > 0; sh >>= 1) s += __shfl_xor_sync(0xffffffffu, s, sh);
  return s;
}

// Stage columns [c0, c0 + tcv * VEC) of `rows` rows into a ring slot with
// asynchronous copies, one warp a row at a time, each lane every 32nd
// vector of it (so a warp's copies cover 32 consecutive vectors): row r
// lands at slot + r * rs floats.  row_ptr(r) gives row r's first value, or
// nullptr for a row that stays as it is.  Columns at or past p are
// written as zeros.
template <int VEC, typename RowPtr>
__device__ __forceinline__ void stage_tile(float* slot, int rows, int rs, int tcv,
                                           long long c0, long long p, RowPtr row_ptr) {
  using V = typename VecOf<VEC>::T;
  const int lane = threadIdx.x % 32;
  const bool full = c0 + (long long)tcv * VEC <= p;
  for (int r = threadIdx.x / 32; r < rows; r += NT / 32) {
    const float* src = row_ptr(r);
    if (src == nullptr) continue;
    src += c0;
    float* dst = slot + r * rs;
    if (full) {
      for (int v = lane; v < tcv; v += 32) cp_async<4 * VEC>(dst + v * VEC, src + v * VEC);
    } else {
      for (int v = lane; v < tcv; v += 32) {
        if (c0 + (long long)v * VEC < p) {
          cp_async<4 * VEC>(dst + v * VEC, src + v * VEC);
        } else {
          *reinterpret_cast<V*>(dst + v * VEC) = VecOf<VEC>::zero();
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// circulant
// ---------------------------------------------------------------------------

// Shared memory: STAGES slots of [rows][tcv + 1] vectors, rows = N (same)
// or 2N (own rows, then bcast rows); one vector of padding a row keeps the
// 16 rows a half-warp reads in distinct banks.  Block (x, y) walks the P
// tiles of x and owns the units [y * ub, (y + 1) * ub) of (offset group,
// own row); part[x, o, i] gets its sums.
template <int VEC>
__global__ void __launch_bounds__(NT)
circulant_kernel(const float* __restrict__ own, const float* __restrict__ bcast,
                 const int* __restrict__ offsets, int k, int n, long long p,
                 int same, int tc_log2, float* __restrict__ part) {
  using V = typename VecOf<VEC>::T;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int tid = threadIdx.x;
  const int tc = 1 << tc_log2;
  const int tcv = tc / VEC;
  const int rs = tcv + 1;  // row stride in vectors
  const int rows = same ? n : 2 * n;
  const int stage = rows * rs * VEC;  // floats a slot
  const long long tiles = (p + tc - 1) / tc;

  const int units = ((k + CI_KT - 1) / CI_KT) * n;
  const int ub = min(units, NT);
  const int ul = tid % ub;
  const int cg = tid / ub;
  const int cgs = NT / ub;
  const int unit = blockIdx.y * ub + ul;
  const bool active = cg < cgs && unit < units;
  const int i = active ? unit % n : 0;
  const int group = active ? unit / n : 0;
  const int nq = active ? min(CI_KT, k - group * CI_KT) : 0;
  const int arow = i * rs;
  int brow[CI_KT];
  float acc[CI_KT];
#pragma unroll
  for (int q = 0; q < CI_KT; ++q) {
    const int j = q < nq ? (i + offsets[group * CI_KT + q]) % n : 0;
    brow[q] = ((same ? 0 : n) + j) * rs;
    acc[q] = 0.f;
  }

  auto load = [&](long long t, int slot) {
    stage_tile<VEC>(smem + slot * stage, rows, rs * VEC, tcv, t * tc, p, [&](int r) {
      return r < n ? own + (long long)r * p : bcast + (long long)(r - n) * p;
    });
  };

  const long long count = tiles_of_block(tiles);
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < count) load(blockIdx.x + (long long)s * gridDim.x, s);
    cp_async_commit();
  }
  for (long long it = 0, slot = 0; it < count; ++it, slot = slot + 1 == STAGES ? 0 : slot + 1) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const long long next = it + STAGES - 1;
    if (next < count) load(blockIdx.x + next * gridDim.x, slot == 0 ? STAGES - 1 : slot - 1);
    cp_async_commit();
    const V* st = reinterpret_cast<const V*>(smem + slot * stage);
    if (active) {
      for (int v = cg; v < tcv; v += cgs) {
        const V x = st[arow + v];
#pragma unroll
        for (int q = 0; q < CI_KT; ++q) {
          if (q < nq) acc_sq_diff(acc[q], x, st[brow[q] + v]);
        }
      }
    }
  }

  // Sum the column phases of each unit in a fixed order.
  cp_async_wait<0>();
  __syncthreads();
  float* red = smem;  // [cgs][ub][CI_KT]
  if (active) {
#pragma unroll
    for (int q = 0; q < CI_KT; ++q) red[(cg * ub + ul) * CI_KT + q] = acc[q];
  }
  __syncthreads();
  for (int e = tid; e < ub * CI_KT; e += NT) {
    const int l = e / CI_KT;
    const int q = e % CI_KT;
    const int u = blockIdx.y * ub + l;
    if (u >= units) continue;
    const int o = (u / n) * CI_KT + q;
    if (o >= k) continue;
    float s = 0.f;
    for (int c = 0; c < cgs; ++c) s += red[(c * ub + l) * CI_KT + q];
    part[((long long)blockIdx.x * k + o) * n + u % n] = s;
  }
}

// One warp per output cell.
__global__ void __launch_bounds__(FIN_THREADS)
sum_blocks_kernel(const float* __restrict__ part, long long cells, int blocks,
                  float* __restrict__ out) {
  const long long idx = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  if (idx >= cells) return;
  const float s = sum_over_blocks(part + idx, cells, blocks);
  if (threadIdx.x % 32 == 0) out[idx] = s;
}

// ---------------------------------------------------------------------------
// pairwise
// ---------------------------------------------------------------------------

// One k-step of 8 columns at smem column kk (fragment columns t, t + 4 are
// smem columns kk, kk + 1): the thread's centered fragment values, their
// squares into the norms, and the three TF32 products into acc.
__device__ __forceinline__ void pw_kstep(const float* A, const float* B, const float* C,
                                         int rs, int g, int kk, bool share,
                                         float (&acc)[2][4], float (&na)[2],
                                         float (&nb)[2]) {
  const float2 c = ld2(C + kk);
  // A fragment: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4).
  const float2 a0 = ld2(A + g * rs + kk);
  const float2 a8 = ld2(A + (g + 8) * rs + kk);
  const float x[4] = {a0.x - c.x, a8.x - c.x, a0.y - c.y, a8.y - c.y};
  // B fragments: b row g (n-tile 0) and g + 8 (n-tile 1), columns t, t + 4.
  float y[4];
  if (share) {
    y[0] = x[0];
    y[1] = x[2];
    y[2] = x[1];
    y[3] = x[3];
  } else {
    const float2 b0 = ld2(B + g * rs + kk);
    const float2 b8 = ld2(B + (g + 8) * rs + kk);
    y[0] = b0.x - c.x;
    y[1] = b0.y - c.y;
    y[2] = b8.x - c.x;
    y[3] = b8.y - c.y;
  }
  na[0] = fmaf(x[2], x[2], fmaf(x[0], x[0], na[0]));
  na[1] = fmaf(x[3], x[3], fmaf(x[1], x[1], na[1]));
  nb[0] = fmaf(y[1], y[1], fmaf(y[0], y[0], nb[0]));
  nb[1] = fmaf(y[3], y[3], fmaf(y[2], y[2], nb[1]));
  uint32_t ah[4], al[4], bh[4], bl[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    split_tf32(x[u], ah[u], al[u]);
    split_tf32(y[u], bh[u], bl[u]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mma_tf32(acc[h], al, bh[2 * h], bh[2 * h + 1]);
    mma_tf32(acc[h], ah, bl[2 * h], bl[2 * h + 1]);
    mma_tf32(acc[h], ah, bh[2 * h], bh[2 * h + 1]);
  }
}

// A block computes a bm x bn output tile of tm x tn warp tiles of 16 x 16
// (tm * tn <= 8, a power of two): warp w takes warp tile w mod (tm * tn)
// and every (8 / (tm * tn))-th k-step of 8 columns, so at N = 16 all eight
// warps share the one tile, and at N >= 64 each has its own.  Shared
// memory: STAGES slots of bm rows of a, bn rows of b (each tc + 8 floats:
// the padding puts the 16 lanes of a half-warp's 8-byte fragment loads in
// distinct banks) and tc floats of the center row.  A same-tensor call
// whose a rows cover every b row (one block row) stages no b rows.  Rows
// beyond N or M and the absent center stay zero.  Within a k-step,
// fragment column t is smem column 2t and column t + 4 is 2t + 1, for A
// and B alike (a Gram sum does not depend on the order of its columns), so
// each lane reads a row's two values with one 8-byte load.
template <int VEC>
__global__ void __launch_bounds__(NT)
pairwise_kernel(const float* __restrict__ a, const float* __restrict__ b,
                const float* __restrict__ center, int n, int m, long long p,
                int same, int tc_log2, int tm, int tn, int blocks_m,
                float* __restrict__ part_g, float* __restrict__ part_sa,
                float* __restrict__ part_sb) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // fragment column
  const int tc = 1 << tc_log2;
  const int rs = tc + 8;
  const int bm = tm * PW_ROWS;
  const int bn = tn * PW_ROWS;
  const int i0 = (blockIdx.y / blocks_m) * bm;
  const int j0 = (blockIdx.y % blocks_m) * bn;
  const bool b_in_a = same && (int)gridDim.y == blocks_m;  // one block row: i0 = 0
  const int b_rows = b_in_a ? 0 : bn;
  const int stage = (bm + b_rows) * rs + tc;
  const bool centered = center != nullptr;
  const long long tiles = (p + tc - 1) / tc;

  const int tiles_w = tm * tn;  // warp tiles of the block
  const int phases = PW_WARPS / tiles_w;
  const int wt = warp % tiles_w;
  const int phase = warp / tiles_w;
  const int ia = i0 + (wt / tn) * PW_ROWS;  // first a row of this warp's tile
  const int jb = j0 + (wt % tn) * PW_ROWS;  // first b row
  const int a_off = (ia - i0) * rs;
  const int b_off = (b_in_a ? jb : bm + jb - j0) * rs;
  const bool share = same && ia == jb;

  for (int e = tid; e < STAGES * stage; e += NT) smem[e] = 0.f;
  __syncthreads();

  auto load = [&](long long tile, int slot) {
    stage_tile<VEC>(smem + slot * stage, bm + b_rows + 1, rs, tc / VEC, tile * tc, p,
                    [&](int r) -> const float* {
                      if (r < bm) return i0 + r < n ? a + (long long)(i0 + r) * p : nullptr;
                      if (r < bm + b_rows) {
                        const int j = j0 + r - bm;
                        return j < m ? b + (long long)j * p : nullptr;
                      }
                      return center;  // nullptr when there is none
                    });
  };

  float gram[2][4];  // float32 totals of the two 16x8 Gram fragments
  float na[2] = {0.f, 0.f};  // |a - c|^2 partials of rows g and g + 8
  float nb[2] = {0.f, 0.f};  // |b - c|^2 partials of rows g and g + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int r = 0; r < 4; ++r) gram[h][r] = 0.f;
  }

  const long long count = tiles_of_block(tiles);
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < count) load(blockIdx.x + (long long)s * gridDim.x, s);
    cp_async_commit();
  }
  for (long long it = 0, slot = 0; it < count; ++it, slot = slot + 1 == STAGES ? 0 : slot + 1) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const long long next = it + STAGES - 1;
    if (next < count) load(blockIdx.x + next * gridDim.x, slot == 0 ? STAGES - 1 : slot - 1);
    cp_async_commit();

    const float* S = smem + slot * stage;
    const float* C = S + (bm + b_rows) * rs;
    // Two independent accumulator sets (this warp's even and odd k-steps of
    // the tile), so that two chains of mma are in flight.
    float acc[2][2][4] = {};
    const int ksteps = tc >> 3;
    for (int ks = phase; ks < ksteps; ks += 2 * phases) {
      pw_kstep(S + a_off, S + b_off, C, rs, g, ks * 8 + 2 * t, share, acc[0], na, nb);
      if (ks + phases < ksteps) {
        pw_kstep(S + a_off, S + b_off, C, rs, g, (ks + phases) * 8 + 2 * t, share, acc[1],
                 na, nb);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int r = 0; r < 4; ++r) gram[h][r] += acc[0][h][r] + acc[1][h][r];
    }
  }

  // Norms: the 4 lanes of a row group, then the phases of a warp tile, in
  // a fixed order.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    na[h] += __shfl_xor_sync(0xffffffffu, na[h], 1);
    na[h] += __shfl_xor_sync(0xffffffffu, na[h], 2);
    nb[h] += __shfl_xor_sync(0xffffffffu, nb[h], 1);
    nb[h] += __shfl_xor_sync(0xffffffffu, nb[h], 2);
  }
  cp_async_wait<0>();
  __syncthreads();
  float* mine = smem + warp * PW_RED;  // [16 x 16 Gram | 16 |a|^2 | 16 |b|^2]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      // C fragment: rows g (r < 2) and g + 8, columns 2t and 2t + 1.
      const int row = g + (r >= 2 ? 8 : 0);
      const int col = h * 8 + 2 * t + (r & 1);
      mine[row * PW_ROWS + col] = gram[h][r];
    }
  }
  if (t == 0) {
    mine[PW_ROWS * PW_ROWS + g] = na[0];
    mine[PW_ROWS * PW_ROWS + g + 8] = na[1];
    mine[PW_ROWS * PW_ROWS + PW_ROWS + g] = nb[0];
    mine[PW_ROWS * PW_ROWS + PW_ROWS + g + 8] = nb[1];
  }
  __syncthreads();
  for (int e = tid; e < tiles_w * PW_RED; e += NT) {
    const int w = e / PW_RED;  // warp tile
    const int q = e % PW_RED;
    float s = 0.f;
    for (int ph = 0; ph < phases; ++ph) s += smem[(w + ph * tiles_w) * PW_RED + q];
    const int i = i0 + (w / tn) * PW_ROWS;
    const int j = j0 + (w % tn) * PW_ROWS;
    if (q < PW_ROWS * PW_ROWS) {
      const int r = q / PW_ROWS;
      const int c = q % PW_ROWS;
      if (i + r < n && j + c < m) {
        part_g[((long long)blockIdx.x * n + i + r) * m + j + c] = s;
      }
    } else if (q < PW_ROWS * PW_ROWS + PW_ROWS) {
      // |a|^2 from the warp tiles of the first column of the output, |b|^2
      // from those of the first row, so each is written once.
      const int r = q - PW_ROWS * PW_ROWS;
      if (j == 0 && i + r < n) part_sa[(long long)blockIdx.x * n + i + r] = s;
    } else {
      const int c = q - PW_ROWS * PW_ROWS - PW_ROWS;
      if (i == 0 && j + c < m) part_sb[(long long)blockIdx.x * m + j + c] = s;
    }
  }
}

// One warp per output cell.
__global__ void __launch_bounds__(FIN_THREADS)
pairwise_finalize_kernel(const float* __restrict__ part_g,
                         const float* __restrict__ part_sa,
                         const float* __restrict__ part_sb, int n, int m,
                         int blocks, float* __restrict__ out) {
  const long long idx = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const long long cells = (long long)n * m;
  if (idx >= cells) return;
  const int i = (int)(idx / m);
  const int j = (int)(idx % m);
  const float g = sum_over_blocks(part_g + idx, cells, blocks);
  const float sa = sum_over_blocks(part_sa + i, n, blocks);
  const float sb = sum_over_blocks(part_sb + j, m, blocks);
  if (threadIdx.x % 32 == 0) out[idx] = sa + sb - 2.0f * g;
}

inline unsigned int blocks_for(long long items, int threads) {
  return (unsigned int)((items + threads - 1) / threads);
}

// Lift the dynamic shared-memory cap of a kernel to SMEM_MAX, once.
template <typename K>
cudaError_t allow_smem(K kernel, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  done = err == cudaSuccess;
  return err;
}

template <int VEC>
cudaError_t launch_circulant(dim3 grid, int smem, cudaStream_t st, const float* own,
                             const float* bcast, const int* offsets, int k, int n,
                             long long p, int same, int tc_log2, float* part) {
  static bool done = false;
  const cudaError_t err = allow_smem(circulant_kernel<VEC>, done);
  if (err != cudaSuccess) return err;
  circulant_kernel<VEC><<<grid, NT, smem, st>>>(own, bcast, offsets, k, n, p,
                                                     same, tc_log2, part);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t launch_pairwise(dim3 grid, int smem, cudaStream_t st, const float* a,
                            const float* b, const float* center, int n, int m,
                            long long p, int same, int tc_log2, int tm, int tn,
                            int blocks_m, float* part_g, float* part_sa,
                            float* part_sb) {
  static bool done = false;
  const cudaError_t err = allow_smem(pairwise_kernel<VEC>, done);
  if (err != cudaSuccess) return err;
  pairwise_kernel<VEC><<<grid, NT, smem, st>>>(a, b, center, n, m, p, same, tc_log2, tm,
                                               tn, blocks_m, part_g, part_sa, part_sb);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The constants agg_kernels.py plans with: threads a block, ring slots,
// pairwise tile rows, shared-memory cap, circulant offsets a thread.
void agg_constants(int* out) {
  out[0] = NT;
  out[1] = STAGES;
  out[2] = PW_ROWS;
  out[3] = SMEM_MAX;
  out[4] = CI_KT;
}

// out[n, m]; part holds part_g[gx, n, m], part_sa[gx, n], part_sb[gx, m].
// center is a [p] row or NULL.  same != 0 means b is a.  Block tiles of
// tm x tn warp tiles; grid (gx, blocks of the output); vec, tc_log2 and
// smem as planned by the wrapper.
int agg_pairwise_sq_distances(const float* a, const float* b, const float* center,
                              float* out, float* part, int n, int m, long long p,
                              int same, int vec, int tc_log2, int tm, int tn, int gx,
                              int smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks_n = (n + tm * PW_ROWS - 1) / (tm * PW_ROWS);
  const int blocks_m = (m + tn * PW_ROWS - 1) / (tn * PW_ROWS);
  const dim3 grid(gx, blocks_n * blocks_m);
  float* part_g = part;
  float* part_sa = part_g + (long long)gx * n * m;
  float* part_sb = part_sa + (long long)gx * n;
  const cudaError_t err =
      vec == 2 ? launch_pairwise<2>(grid, smem, st, a, b, center, n, m, p, same, tc_log2,
                                    tm, tn, blocks_m, part_g, part_sa, part_sb)
               : launch_pairwise<1>(grid, smem, st, a, b, center, n, m, p, same, tc_log2,
                                    tm, tn, blocks_m, part_g, part_sa, part_sb);
  if (err != cudaSuccess) return (int)err;
  pairwise_finalize_kernel<<<blocks_for((long long)n * m * 32, FIN_THREADS), FIN_THREADS,
                             0, st>>>(part_g, part_sa, part_sb, n, m, gx, out);
  return (int)cudaGetLastError();
}

// out[k, n]; part[gx, k, n]; offsets[k] on the device, each in [0, n).
// Grid (gx, gy).
int agg_circulant_sq_distances(const float* own, const float* bcast,
                               const int* offsets, int k, float* out, float* part,
                               int n, long long p, int same, int vec, int tc_log2,
                               int gx, int gy, int smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(gx, gy);
  const cudaError_t err =
      vec == 2 ? launch_circulant<2>(grid, smem, st, own, bcast, offsets, k, n, p, same,
                                     tc_log2, part)
               : launch_circulant<1>(grid, smem, st, own, bcast, offsets, k, n, p, same,
                                     tc_log2, part);
  if (err != cudaSuccess) return (int)err;
  const long long cells = (long long)k * n;
  sum_blocks_kernel<<<blocks_for(cells * 32, FIN_THREADS), FIN_THREADS, 0, st>>>(
      part, cells, gx, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
