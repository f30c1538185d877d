// Fused candidate selection (the static circulant median and trimmed mean)
// as hand-written CUDA kernels for Hopper (sm_90a), with a plain C
// interface bound from Python with ctypes
// (murmura_tpu_torch/ops/candidate_kernels.py, which also plans every
// launch: path, tile width, copy and store widths, grid).
//
// Replaces the Pallas TPU kernel
//   murmura_tpu/ops/pallas_agg.py: fused_candidate_select
//   (_candidate_call / _candidate_kernel)
// and computes, per node i and coordinate p, over the m = k + 1 candidates
// {own[i, p]} and {bcast[(i + offsets[o]) mod N, p]}:
//   median:       0.5 * (r[(m - 1) / 2] + r[m / 2])
//   trimmed mean: (r[trim] + r[trim + 1] + ... + r[m - trim - 1]) * inv_keep
// where r is the candidates sorted ascending and inv_keep is
// float32(1 / (m - 2 trim)), handed in by the caller.  The math is float32
// whatever the storage type (float32 or bfloat16); the result is rounded to
// the storage type once, at the store.
//
// Exactness: the sort is a compare-exchange network whose sorted values are
// torch.sort's (NaN after every number); the window is summed in ascending
// order and multiplied by the reciprocal, with __fadd_rn/__fmul_rn so that
// nothing is contracted into an FMA or simplified (the median of an odd m
// is 0.5 * (r + r), which overflows to inf above 1.7e38 as the plain version
// and the JAX package do).  There is no reduction across threads, so the
// result is the same from run to run and equal to the plain version bit for
// bit (-0.0 and +0.0 may trade places, which torch.equal does not see).
//
// Bound on an H100: the kernel reads own and bcast once and writes the
// output once, 3 x N x P elements: at the flagship shape (N = 16,
// P = 6,603,710, m = 5) 1,267.8 MB in float32 (0.378 ms at 3.35 TB/s) and
// half that in bfloat16 (0.189 ms).  The sort is the other half of the
// cost: on an H100 the copies alone and the sort alone each take about as
// long as the bytes at bfloat16 [64, P], and they share the SM's
// load/store pipe (the ring's copies, the tile's reads), so they overlap
// only in part (PERF.md has the variants that time each).  The design:
//
// - Persistent grid over a cp.async ring (staged_kernel).  Each block walks
//   column tiles of TC columns (tile t, t + gridDim.x, ...) and stages all N
//   rows of own and of bcast for a tile in a ring of STAGES slots; the
//   copies of tile t + 2 are in flight while tile t is sorted, one barrier a
//   tile.  A warp copies whole rows (8-byte copies for float32 and 4-byte
//   for bfloat16 at the flagship: P = 6,603,710 is 2 mod 4, so odd rows
//   start on 8 bytes in float32 and on 4 in bfloat16; 16 bytes where every
//   row allows it; nothing is padded or copied in device memory).  The k
//   re-reads of each bcast value come from shared memory.
// - Four adjacent columns a thread (CPT), read from the tile as one 16-byte
//   (float32) or 8-byte (bfloat16) word per candidate row and stored to
//   out as wide as the output rows' alignment allows.  Lanes of a warp take
//   consecutive column groups of one row, so reads are conflict-free.
// - One instruction a comparison.  A compare-exchange puts min(a, b) low
//   and max.NaN(a, b) high: min returns the number when one operand is
//   NaN and max.NaN returns NaN, so NaN sorts after every number, which is
//   torch.sort's order, with no check and no second path.  bfloat16 is
//   sorted as it is stored, two columns an instruction (min.bf16x2,
//   max.NaN.bf16x2: the values are exact), and only the ranks the window
//   reads are widened to float32.
// - M, median and trim are template parameters for m = 3 and m = 5, the m
//   of the ring (k = 2) and of every k-regular config in the repo (k = 4):
//   the network (Knuth's merge exchange: 3 comparators for m = 3, 9 for
//   m = 5) and the window sum are static code, and the compiler drops the
//   comparators whose results the window does not read.  Any other m (up
//   to 257) takes a generic path: an insertion sort in local memory, one
//   column at a time.
// - Large N.  When 2N rows of the narrowest tile (MIN_TC columns) do not fit
//   in shared memory (N > 302 in float32, N > 605 in bfloat16), or when a
//   bfloat16 row starts on 2 bytes only (odd P), direct_kernel reads the
//   candidates from device memory instead, one column a thread, bcast
//   through the read-only cache, with the generic sort.
//
// Any N and P work: columns past P are zero in the tile and never stored.
// The offsets live in a small device array, each already reduced mod N by
// the caller.  Every entry point launches on the given stream, does not
// synchronise, allocates nothing and returns cudaGetLastError() as an int.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;           // threads a block
constexpr int STAGES = 3;         // slots of the shared-memory ring
constexpr int CPT = 4;            // adjacent columns a thread (staged path)
constexpr int MIN_TC = 32;        // narrowest column tile of the staged path
constexpr int MAX_M = 257;        // 1 + agg_kernels.MAX_OFFSETS
constexpr int STATIC_M = (1 << 3) | (1 << 5);  // bit m: m is a template parameter
constexpr int MEDIAN = -1;        // MODE of the median; MODE >= 0 is a trim
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may take

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

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Four adjacent values of a staged float32 row (16-byte aligned in shared
// memory).
__device__ __forceinline__ void load4(const float* s, float (&x)[CPT]) {
  const float4 q = *reinterpret_cast<const float4*>(s);
  x[0] = q.x;
  x[1] = q.y;
  x[2] = q.z;
  x[3] = q.w;
}
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // a in the low half
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Store the `valid` first of four results at dst, in words of `ov`
// elements (4, 2 or 1: what the output rows' alignment allows).
__device__ __forceinline__ void store4(float* dst, const float (&r)[CPT], int ov, int valid) {
  if (valid == CPT && ov == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(r[0], r[1], r[2], r[3]);
  } else if (valid == CPT && ov == 2) {
    reinterpret_cast<float2*>(dst)[0] = make_float2(r[0], r[1]);
    reinterpret_cast<float2*>(dst)[1] = make_float2(r[2], r[3]);
  } else {
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      if (c < valid) dst[c] = r[c];
    }
  }
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, const float (&r)[CPT], int ov,
                                       int valid) {
  if (valid == CPT && ov == 4) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(pack2(r[0], r[1]), pack2(r[2], r[3]));
  } else if (valid == CPT && ov == 2) {
    reinterpret_cast<uint32_t*>(dst)[0] = pack2(r[0], r[1]);
    reinterpret_cast<uint32_t*>(dst)[1] = pack2(r[2], r[3]);
  } else {
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      if (c < valid) store1(dst + c, r[c]);
    }
  }
}

// a sorts after b: a > b, or a is NaN and b is not (torch.sort's order).
__device__ __forceinline__ bool after(float a, float b) {
  return (a > b) || (a != a && b == b);
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// Compare-exchange in torch.sort's order (NaN last): see the notes above.
__device__ __forceinline__ void cmp_swap(float& a, float& b) {
  const float lo = fminf(a, b);
  const float hi = max_nan(a, b);
  a = lo;
  b = hi;
}
__device__ __forceinline__ void cmp_swap(__nv_bfloat162& a, __nv_bfloat162& b) {
  const __nv_bfloat162 lo = __hmin2(a, b);
  const __nv_bfloat162 hi = __hmax2_nan(a, b);
  a = lo;
  b = hi;
}

// Knuth's merge exchange (TAOCP 5.2.2, Algorithm M) on M keys, as a list of
// comparators (a[s], b[s]), s < n.
struct Network {
  int n = 0;
  int a[32] = {};
  int b[32] = {};
};
template <int M>
__host__ __device__ constexpr Network merge_exchange() {
  Network net{};
  int t = 0;
  while ((1 << t) < M) ++t;
  for (int p = 1 << (t - 1); p > 0; p >>= 1) {
    int q = 1 << (t - 1), r = 0, d = p;
    while (d > 0) {
      for (int i = 0; i + d < M; ++i) {
        if ((i & p) == r) {
          net.a[net.n] = i;
          net.b[net.n] = i + d;
          ++net.n;
        }
      }
      d = q - p;
      q >>= 1;
      r = p;
    }
  }
  return net;
}

// Sort v[0..M) ascending for each of the W words: comparator S onwards.
template <int M, int S = 0, int W, typename V>
__device__ __forceinline__ void sort_static(V (&v)[M][W]) {
  constexpr Network net = merge_exchange<M>();
  if constexpr (S < net.n) {
#pragma unroll
    for (int w = 0; w < W; ++w) cmp_swap(v[net.a[S]][w], v[net.b[S]][w]);
    sort_static<M, S + 1>(v);
  }
}

// The candidates of a column group as sortable words: float32 one column a
// word, bfloat16 two; and the words widened to the group's CPT floats.
template <typename T> struct Words;
template <> struct Words<float> {
  using W = float;
  static constexpr int N = CPT;
  static __device__ __forceinline__ void load(const float* s, float (&w)[N]) { load4(s, w); }
  static __device__ __forceinline__ void widen(const float (&w)[N], float (&x)[CPT]) {
#pragma unroll
    for (int c = 0; c < CPT; ++c) x[c] = w[c];
  }
};
template <> struct Words<__nv_bfloat16> {
  using W = __nv_bfloat162;
  static constexpr int N = CPT / 2;
  static __device__ __forceinline__ void load(const __nv_bfloat16* s, __nv_bfloat162 (&w)[N]) {
    const uint2 q = *reinterpret_cast<const uint2*>(s);
    w[0] = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
    w[1] = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
  }
  static __device__ __forceinline__ void widen(const __nv_bfloat162 (&w)[N], float (&x)[CPT]) {
#pragma unroll
    for (int h = 0; h < N; ++h) {
      const uint32_t u = *reinterpret_cast<const uint32_t*>(&w[h]);
      x[2 * h] = __uint_as_float(u << 16);  // element 2h is the low half
      x[2 * h + 1] = __uint_as_float(u & 0xffff0000u);
    }
  }
};

// The median (MODE == MEDIAN) or the trimmed mean of trim MODE over the
// sorted column c, with the window static.
template <int M, int MODE, int C>
__device__ __forceinline__ float window(const float (&v)[M][C], int c, float inv_keep) {
  if constexpr (MODE == MEDIAN) {
    return __fmul_rn(0.5f, __fadd_rn(v[(M - 1) / 2][c], v[M / 2][c]));
  } else {
    float acc = v[MODE][c];
#pragma unroll
    for (int j = MODE + 1; j < M - MODE; ++j) acc = __fadd_rn(acc, v[j][c]);
    return __fmul_rn(acc, inv_keep);
  }
}

// Generic m: insertion sort of v[0..m) in the NaN-last order, then the
// window.
__device__ __forceinline__ float select_generic(float* v, int m, int trim, int median,
                                                float inv_keep) {
  for (int a = 1; a < m; ++a) {
    const float x = v[a];
    int b = a - 1;
    while (b >= 0 && after(v[b], x)) {
      v[b + 1] = v[b];
      --b;
    }
    v[b + 1] = x;
  }
  if (median) return __fmul_rn(0.5f, __fadd_rn(v[(m - 1) / 2], v[m / 2]));
  float acc = v[trim];
  for (int j = trim + 1; j < m - trim; ++j) acc = __fadd_rn(acc, v[j]);
  return __fmul_rn(acc, inv_keep);
}

// Stage columns [c0, c0 + tc) of the n rows of own, then the n rows of
// bcast, into a ring slot ([2n][tc] elements), with cp.async copies of CB
// bytes: one warp a row at a time, each lane every 32nd word of it.  Every
// row is a whole number of CB-byte words from c0 (the wrapper picks CB so);
// words at or past p are written as zeros.
template <int CB, typename T>
__device__ __forceinline__ void stage_tile(T* slot, const T* __restrict__ own,
                                           const T* __restrict__ bcast, int n, long long p,
                                           int tc, long long c0) {
  const int lane = threadIdx.x % 32;
  const int row_bytes = tc * (int)sizeof(T);
  const long long left = (p - c0) * (long long)sizeof(T);
  const int valid = left < row_bytes ? (int)left : row_bytes;
  for (int r = threadIdx.x / 32; r < 2 * n; r += NT / 32) {
    const char* src =
        reinterpret_cast<const char*>((r < n ? own + (long long)r * p : bcast + (long long)(r - n) * p) + c0);
    char* dst = reinterpret_cast<char*>(slot + r * tc);
    for (int b = lane * CB; b < valid; b += 32 * CB) cp_async<CB>(dst + b, src + b);
    for (int b = valid + lane * 4; b < row_bytes; b += 32 * 4) {
      *reinterpret_cast<uint32_t*>(dst + b) = 0u;
    }
  }
}

template <typename T>
__device__ __forceinline__ void stage(T* slot, const T* own, const T* bcast, int n, long long p,
                                      int tc, long long c0, int cb) {
  if (cb == 16) stage_tile<16>(slot, own, bcast, n, p, tc, c0);
  else if (cb == 8) stage_tile<8>(slot, own, bcast, n, p, tc, c0);
  else stage_tile<4>(slot, own, bcast, n, p, tc, c0);
}

// The tiles of the P axis a block walks: first, first + step, ... < tiles.
__device__ __forceinline__ long long tiles_of_block(long long tiles) {
  const long long first = blockIdx.x;
  return first < tiles ? (tiles - first + gridDim.x - 1) / gridDim.x : 0;
}

// Shared memory: STAGES slots of [2n][tc] elements (own rows, then bcast
// rows).  Work item e of a tile is (row i = e / G, column group g = e % G)
// with G = tc / CPT; thread t takes items t, t + NT, ...  M == 0 is the
// generic path (runtime m = k + 1, m other than 3 and 5).  trim and median are read only by
// the generic path.
template <typename T, int M, int MODE>
__global__ void __launch_bounds__(NT, 2)
staged_kernel(const T* __restrict__ own, const T* __restrict__ bcast,
              const int* __restrict__ offsets, int k, T* __restrict__ out, int n,
              long long p, int tc_log2, int cb, int ov, int trim, int median,
              float inv_keep) {
  extern __shared__ float4 smem4[];
  T* smem = reinterpret_cast<T*>(smem4);
  const int tid = threadIdx.x;
  const int tc = 1 << tc_log2;
  const int g_log2 = tc_log2 - 2;  // CPT = 4 columns a group
  const int gmask = (1 << g_log2) - 1;
  const int stage_elems = 2 * n * tc;
  const long long tiles = (p + tc - 1) >> tc_log2;
  const int items = n << g_log2;

  constexpr int K = M > 0 ? M - 1 : 1;
  int off[K];
  if constexpr (M > 0) {
#pragma unroll
    for (int u = 0; u < K; ++u) off[u] = __ldg(offsets + u);
  }

  auto load = [&](long long it, int slot) {
    stage(smem + slot * stage_elems, own, bcast, n, p, tc,
          (blockIdx.x + it * gridDim.x) << tc_log2, cb);
  };

  const long long count = tiles_of_block(tiles);
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < count) load(s, s);
    cp_async_commit();
  }
  for (long long it = 0, slot = 0; it < count; ++it, slot = slot + 1 == STAGES ? 0 : slot + 1) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const long long next = it + STAGES - 1;
    if (next < count) load(next, slot == 0 ? STAGES - 1 : slot - 1);
    cp_async_commit();

    const T* so = smem + slot * stage_elems;
    const T* sb = so + n * tc;
    const long long c0 = (blockIdx.x + it * gridDim.x) << tc_log2;
    for (int e = tid; e < items; e += NT) {
      const int i = e >> g_log2;
      const int g = (e & gmask) * CPT;
      const long long c = c0 + g;
      const int valid = p - c >= CPT ? CPT : (int)(p - c);  // may be <= 0
      float r[CPT];
      if constexpr (M > 0) {
        using Wd = Words<T>;
        typename Wd::W v[M][Wd::N];
        Wd::load(so + i * tc + g, v[0]);
#pragma unroll
        for (int u = 0; u < K; ++u) {
          int j = i + off[u];
          j = j >= n ? j - n : j;
          Wd::load(sb + j * tc + g, v[u + 1]);
        }
        sort_static<M>(v);
        float x[M][CPT];  // the compiler keeps only the ranks the window reads
#pragma unroll
        for (int j = 0; j < M; ++j) Wd::widen(v[j], x[j]);
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) r[cc] = window<M, MODE, CPT>(x, cc, inv_keep);
      } else {
        float v[MAX_M];
        for (int cc = 0; cc < CPT; ++cc) {
          v[0] = to_f(so[i * tc + g + cc]);
          for (int u = 0; u < k; ++u) {
            int j = i + __ldg(offsets + u);
            j = j >= n ? j - n : j;
            v[u + 1] = to_f(sb[j * tc + g + cc]);
          }
          r[cc] = select_generic(v, k + 1, trim, median, inv_keep);
        }
      }
      if (valid > 0) store4(out + (long long)i * p + c, r, ov, valid);
    }
  }
  cp_async_wait<0>();
}

// The large-N path: one column a thread, every row of it; own read in
// place, bcast through the read-only cache; runtime m = k + 1, trim and
// median (the generic sort: no config reaches this path at a static m).
template <typename T>
__global__ void __launch_bounds__(NT)
direct_kernel(const T* __restrict__ own, const T* __restrict__ bcast,
              const int* __restrict__ offsets, int k, T* __restrict__ out, int n,
              long long p, int trim, int median, float inv_keep) {
  const long long c = (long long)blockIdx.x * NT + threadIdx.x;
  if (c >= p) return;  // no barrier below
  for (int i = 0; i < n; ++i) {
    float v[MAX_M];
    v[0] = to_f(own[(long long)i * p + c]);
    for (int u = 0; u < k; ++u) {
      int j = i + __ldg(offsets + u);
      j = j >= n ? j - n : j;
      v[u + 1] = to_f(__ldg(bcast + (long long)j * p + c));
    }
    store1(out + (long long)i * p + c, select_generic(v, k + 1, trim, median, inv_keep));
  }
}

struct Args {
  const void* own;
  const void* bcast;
  const int* offsets;
  int k;
  void* out;
  int n;
  long long p;
  int trim;
  int median;
  float inv_keep;
  int tc_log2;
  int cb;
  int ov;
  int grid;
  int smem;
  cudaStream_t st;
};

template <typename T>
int launch_direct(const Args& a) {
  const unsigned int blocks = (unsigned int)((a.p + NT - 1) / NT);
  direct_kernel<T><<<blocks, NT, 0, a.st>>>(
      static_cast<const T*>(a.own), static_cast<const T*>(a.bcast), a.offsets, a.k,
      static_cast<T*>(a.out), a.n, a.p, a.trim, a.median, a.inv_keep);
  return (int)cudaGetLastError();
}

template <typename T, int M, int MODE>
int launch_staged(const Args& a) {
  static bool done = false;
  if (!done) {
    const cudaError_t err = cudaFuncSetAttribute(
        staged_kernel<T, M, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    done = true;
  }
  staged_kernel<T, M, MODE><<<a.grid, NT, a.smem, a.st>>>(
      static_cast<const T*>(a.own), static_cast<const T*>(a.bcast), a.offsets, a.k,
      static_cast<T*>(a.out), a.n, a.p, a.tc_log2, a.cb, a.ov, a.trim, a.median, a.inv_keep);
  return (int)cudaGetLastError();
}

// The staged kernels of trim a.trim, found among the trims TR, TR - 1, ... 0.
template <typename T, int M, int TR>
int launch_trim(const Args& a) {
  if (a.trim == TR) return launch_staged<T, M, TR>(a);
  if constexpr (TR > 0) {
    return launch_trim<T, M, TR - 1>(a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

template <typename T, int M>
int launch_static(const Args& a) {
  if (a.median) return launch_staged<T, M, MEDIAN>(a);
  return launch_trim<T, M, (M - 1) / 2>(a);
}

template <typename T>
int select_typed(const Args& a) {
  if (a.grid == 0) return launch_direct<T>(a);
  switch (a.k + 1) {
    case 3: return launch_static<T, 3>(a);
    case 5: return launch_static<T, 5>(a);
    default: return launch_staged<T, 0, 0>(a);
  }
}

static_assert(STATIC_M == ((1 << 3) | (1 << 5)), "select_typed's cases are m = 3 and 5");

}  // namespace

extern "C" {

// The constants candidate_kernels.py plans with: threads a block, ring
// slots, columns a thread, narrowest tile, shared-memory cap, the static
// m (bit m set).
void cand_constants(int* out) {
  out[0] = NT;
  out[1] = STAGES;
  out[2] = CPT;
  out[3] = MIN_TC;
  out[4] = SMEM_MAX;
  out[5] = STATIC_M;
}

// own, bcast, out: [n, p] row-major, float32 (bf16 == 0) or bfloat16
// (bf16 != 0); offsets[k] on the device, each in [0, n).  median != 0 takes
// the median, else the mean of the sorted window [trim, k + 1 - trim).
// grid == 0: the direct path; else the staged path with grid blocks, tiles
// of 1 << tc_log2 columns, cb-byte copies, stores of ov elements and smem
// bytes of shared memory, as planned by the wrapper.
int cand_select(const void* own, const void* bcast, const int* offsets, int k, void* out,
                int n, long long p, int trim, int median, float inv_keep, int bf16,
                int tc_log2, int cb, int ov, int grid, int smem, void* stream) {
  const Args a{own, bcast, offsets, k, out, n, p, trim, median, inv_keep,
               tc_log2, cb, ov, grid, smem, static_cast<cudaStream_t>(stream)};
  if (k < 1 || k + 1 > MAX_M) return (int)cudaErrorInvalidValue;
  return bf16 ? select_typed<__nv_bfloat16>(a) : select_typed<float>(a);
}

}  // extern "C"
