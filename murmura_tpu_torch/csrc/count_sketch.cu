// Count-Sketch compression as hand-written CUDA kernels for Hopper
// (sm_90a), with a plain C interface bound from Python with ctypes
// (murmura_tpu_torch/ops/sketch_kernels.py, which also plans every launch:
// grid, buckets a thread, shared memory).
//
// Replaces the Pallas TPU kernel
//   murmura_tpu/ops/pallas_sketch.py: count_sketch_pallas (_sketch_kernel)
// and computes, for every row r of v[R, P],
//   out[r, s] = sum over p with hash[p] == s of sign[p] * v[r, p].
//
// The TPU kernel builds a one-hot matrix and multiplies, because a scatter
// with random indices is serialized on the TPU.  Here the scatter is turned
// around on the host instead, once per (model_dim, seed): the positions of
// every slice of L consecutive columns are sorted by bucket (a stable sort,
// so ascending within a bucket), and each entry of that order is stored as
// a 16-bit word, the position inside the slice in the low 15 bits and the
// sign in the top bit; starts[slice, s] .. starts[slice, s + 1] is bucket s's
// run of entries in slice `slice`, and the entries are padded to a whole
// number of slices (ops/sketch_kernels.sketch_layout).  L = 4096.
//
// Bound on an H100: the kernel reads v once (R x P float32), its 16-bit
// entries (slices x L x 2 bytes) and starts (slices x (S + 1) int32), and
// writes [R, S]; at the flagship shape (R = 16, P = 6,603,710, S = 1000,
// 1,613 slices) that is 442.4 MB, 0.1321 ms at 3.35 TB/s, against 0.2 GFLOP,
// so bytes bound it.  The design:
//
// - Persistent blocks over contiguous slice ranges.  Block (x, y, z) owns
//   the slices [x * slices / gx, (x + 1) * slices / gx), the row group y
//   (R_G = 4 rows) and the bucket chunk z (up to KB_MAX * NT buckets; one
//   chunk for S <= 4096).  One block fills an SM (the ring takes 216 KB), and
//   the wrapper sizes gx so that the grid is one wave.  A thread owns the
//   buckets b = tid, tid + NT, ... of its chunk (at most KB of them) and
//   keeps their sums for the R_G rows in registers across all the block's
//   slices; at the end they go to part[x, r, b], so the partial buffer is
//   gx x R x S floats (33 x 16 x 1000 at the flagship) instead of one row
//   of partials per slice.
// - A cp.async ring of STAGES slots.  A slot holds the R_G rows of one
//   slice side by side ([R_G][L] float32, 8-byte copies when P and the base
//   pointer are even in floats, else 4-byte; P = 6,603,710 is 2 mod 4, so
//   odd rows start on 8 bytes only: no TMA map, no 16-byte copies of v) and
//   the slice's entries (16-byte copies).  The copies of slice t + 2 are in
//   flight while slice t's buckets are walked, one barrier a slice.  The
//   thread's starts for the next slice are loaded into registers while it
//   walks the current one.
// - One walk of a bucket's run serves the R_G rows: each entry is decoded
//   once and feeds R_G independent add chains (four shared loads at the same
//   position in the four rows), so the walk has four-way instruction-level
//   parallelism instead of one chain of dependent loads and adds.  The walk
//   is bucket-parallel (a lane walks its own buckets' runs, two buckets as
//   one walk), which leaves lanes idle while the longest pair of runs of a
//   warp finishes.  Its cost is shared-memory wavefronts: random gathers
//   take about 2-3 a request, and they share the load/store pipe with the
//   ring's copies, so the walk and the copies overlap only in part
//   (`bench_torch_distances.py --sketch-variants` times each alone; PERF.md
//   has the numbers).  Tried and slower: the R_G rows interleaved so that
//   one 16-byte load fetches an entry's four values (random 16-byte gathers
//   cost more wavefronts than four 4-byte ones), 8 rows a walk, 4 ring
//   slots, two blocks an SM.  An entry-parallel walk
//   (a segmented warp reduction over 32 consecutive entries) would keep every
//   lane busy at the price of a shuffle chain per step; not tried.
// - sketch_sum_kernel adds the gx partials of every output cell, one warp a
//   cell: lane l adds blocks l, l + 32, ... in order, then the lanes' sums
//   meet in a fixed butterfly.
//
// No float atomics anywhere and every sum runs in a fixed order (within a
// block: each bucket's entries in layout order, slice after slice; across
// blocks: the sum pass), so the result is the same from run to run on a
// given card: Sketchguard compares sketch distances with a threshold.  Any
// R, P and S work.  Every entry point launches on the given stream, does
// not synchronise, allocates nothing (the caller passes the output and the
// partial buffer) and returns cudaGetLastError() as an int.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 512;           // threads a walk block
constexpr int STAGES = 3;         // slots of the shared-memory ring
constexpr int R_G = 4;            // rows a walk serves
constexpr int KB_MAX = 8;         // buckets a thread, at most
constexpr int SUM_THREADS = 256;
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

// Stage slice t into a ring slot: rows r0 .. r0 + nrows - 1 of v, columns
// [t L, t L + len), at slot + r * L; then the slice's L entries (16-byte
// copies; the layout pads the last slice to L) after the R_G rows.  Columns
// past P are left as they are: no entry points at them.
template <int VEC>
__device__ __forceinline__ void stage_slice(float* slot, const float* __restrict__ v,
                                            const unsigned short* __restrict__ entries,
                                            int r0, int nrows, long long p, int l,
                                            long long t) {
  const long long p0 = t * l;
  const int lenv = (int)min((long long)l, p - p0) / VEC;
  for (int r = 0; r < nrows; ++r) {
    const float* src = v + (long long)(r0 + r) * p + p0;
    float* dst = slot + r * l;
    for (int i = threadIdx.x; i < lenv; i += NT) cp_async<4 * VEC>(dst + i * VEC, src + i * VEC);
  }
  const unsigned short* esrc = entries + p0;
  unsigned short* edst = reinterpret_cast<unsigned short*>(slot + R_G * l);
  for (int i = threadIdx.x; i < l / 8; i += NT) cp_async<16>(edst + i * 8, esrc + i * 8);
}

// Each bucket's run of entries in slice t: [sb[k], se[k]) for the thread's
// buckets b = c0 + tid + k NT below c1 (empty runs past c1).
template <int KB>
__device__ __forceinline__ void load_runs(const int* __restrict__ starts, int s, long long t,
                                          int c0, int c1, int (&sb)[KB], int (&se)[KB]) {
  const int* st = starts + t * (s + 1);
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    const int b = c0 + threadIdx.x + k * NT;
    sb[k] = b < c1 ? __ldg(st + b) : 0;
    se[k] = b < c1 ? __ldg(st + b + 1) : 0;
  }
}

template <int KB, int VEC>
__global__ void __launch_bounds__(NT, 1)
sketch_walk_kernel(const float* __restrict__ v, const unsigned short* __restrict__ entries,
                   const int* __restrict__ starts, int rows, long long p, int s, int l,
                   float* __restrict__ part) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int stage = R_G * l + l / 2;  // floats a slot: R_G rows, then L 16-bit entries

  const long long slices = (p + l - 1) / l;
  const long long t0 = blockIdx.x * slices / gridDim.x;
  const long long count = (blockIdx.x + 1) * slices / gridDim.x - t0;
  const int r0 = blockIdx.y * R_G;
  const int nrows = min(R_G, rows - r0);
  const int c0 = blockIdx.z * KB * NT;
  const int c1 = min(s, c0 + KB * NT);

  auto load = [&](long long it, int slot) {
    stage_slice<VEC>(smem + slot * stage, v, entries, r0, nrows, p, l, t0 + it);
  };

  float acc[KB][R_G];
#pragma unroll
  for (int k = 0; k < KB; ++k) {
#pragma unroll
    for (int r = 0; r < R_G; ++r) acc[k][r] = 0.f;
  }
  int sb[KB] = {}, se[KB] = {};
  if (count > 0) load_runs<KB>(starts, s, t0, c0, c1, sb, se);

  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < count) load(i, i);
    cp_async_commit();
  }
  for (long long it = 0, slot = 0; it < count; ++it, slot = slot + 1 == STAGES ? 0 : slot + 1) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const long long next = it + STAGES - 1;
    if (next < count) load(next, slot == 0 ? STAGES - 1 : slot - 1);
    cp_async_commit();
    int nb[KB] = {}, ne[KB] = {};  // the next slice's runs, in flight during the walk
    if (it + 1 < count) load_runs<KB>(starts, s, t0 + it + 1, c0, c1, nb, ne);

    const float* x = smem + slot * stage;
    const unsigned short* ent = reinterpret_cast<const unsigned short*>(x + R_G * l);
    // Buckets k and k1 = k + 1 as one walk of n0 + n1 entries, so that a
    // warp waits for its longest pair of runs rather than its longest run
    // twice.
#pragma unroll
    for (int k = 0; k < KB; k += 2) {
      const int k1 = k + 1 < KB ? k + 1 : k;
      const int n0 = se[k] - sb[k];
      const int n = n0 + (k1 != k ? se[k1] - sb[k1] : 0);
      for (int j = 0; j < n; ++j) {
        const bool first = j < n0;
        const unsigned int e = ent[first ? sb[k] + j : sb[k1] + j - n0];
        const float* xp = x + (e & 0x7fffu);
        // +1 or -1 from the sign bit; sg * x is exact, so each fmaf rounds
        // once, as an add of the signed value would.
        const float sg = __uint_as_float(0x3f800000u | ((e & 0x8000u) << 16));
        if (first) {
#pragma unroll
          for (int r = 0; r < R_G; ++r) acc[k][r] = fmaf(sg, xp[r * l], acc[k][r]);
        } else {
#pragma unroll
          for (int r = 0; r < R_G; ++r) acc[k1][r] = fmaf(sg, xp[r * l], acc[k1][r]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      sb[k] = nb[k];
      se[k] = ne[k];
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int k = 0; k < KB; ++k) {
    const int b = c0 + threadIdx.x + k * NT;
    if (b >= c1) continue;
#pragma unroll
    for (int r = 0; r < R_G; ++r) {
      if (r < nrows) part[((long long)blockIdx.x * rows + r0 + r) * s + b] = acc[k][r];
    }
  }
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

// One warp per output cell.
__global__ void __launch_bounds__(SUM_THREADS)
sketch_sum_kernel(const float* __restrict__ part, long long cells, int blocks,
                  float* __restrict__ out) {
  const long long idx = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  if (idx >= cells) return;
  const float s = sum_over_blocks(part + idx, cells, blocks);
  if (threadIdx.x % 32 == 0) out[idx] = s;
}

template <int KB, int VEC>
cudaError_t launch_walk(dim3 grid, int smem, cudaStream_t st, const float* v,
                        const unsigned short* entries, const int* starts, int rows,
                        long long p, int s, int l, float* part) {
  static bool done = false;
  if (!done) {
    const cudaError_t err = cudaFuncSetAttribute(
        sketch_walk_kernel<KB, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return err;
    done = true;
  }
  sketch_walk_kernel<KB, VEC><<<grid, NT, smem, st>>>(v, entries, starts, rows, p, s, l, part);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t launch_kb(int kb, dim3 grid, int smem, cudaStream_t st, const float* v,
                      const unsigned short* entries, const int* starts, int rows,
                      long long p, int s, int l, float* part) {
  switch (kb) {
    case 1: return launch_walk<1, VEC>(grid, smem, st, v, entries, starts, rows, p, s, l, part);
    case 2: return launch_walk<2, VEC>(grid, smem, st, v, entries, starts, rows, p, s, l, part);
    case 4: return launch_walk<4, VEC>(grid, smem, st, v, entries, starts, rows, p, s, l, part);
    case 8: return launch_walk<8, VEC>(grid, smem, st, v, entries, starts, rows, p, s, l, part);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The constants sketch_kernels.py plans with: threads a walk block, ring
// slots, rows a walk serves, buckets a thread at most, shared-memory cap.
void sketch_constants(int* out) {
  out[0] = NT;
  out[1] = STAGES;
  out[2] = R_G;
  out[3] = KB_MAX;
  out[4] = SMEM_MAX;
}

// v[rows, p] float32; entries[slices * l] and starts[slices, s + 1] from the
// host layout with slices = ceil(p / l); part[gx, rows, s] scratch;
// out[rows, s].  Grid (gx, ceil(rows / R_G), chunks) with kb buckets a
// thread, vec-float copies and smem bytes, as planned by the wrapper.
int sketch_count(const float* v, const unsigned short* entries, const int* starts, int rows,
                 long long p, int s, int l, int vec, int kb, int gx, int chunks, int smem,
                 float* part, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(gx, (rows + R_G - 1) / R_G, chunks);
  const cudaError_t err =
      vec == 2 ? launch_kb<2>(kb, grid, smem, st, v, entries, starts, rows, p, s, l, part)
               : launch_kb<1>(kb, grid, smem, st, v, entries, starts, rows, p, s, l, part);
  if (err != cudaSuccess) return (int)err;
  const long long cells = (long long)rows * s;
  sketch_sum_kernel<<<(unsigned int)((cells * 32 + SUM_THREADS - 1) / SUM_THREADS),
                      SUM_THREADS, 0, st>>>(part, cells, gx, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
