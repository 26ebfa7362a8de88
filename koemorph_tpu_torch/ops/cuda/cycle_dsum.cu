// Cycle-restricted difference sums for per-glottal-cycle jitter.
//
// Replaces the TPU kernel koemorph_tpu/ops/pallas/cycle_dsum_kernel.py
// (cycle_dsum_lanes_pallas, body _kernel). For every row (one YIN analysis
// frame x of n samples) and every cycle slot k < K and search offset
// o < L = 2*half_lag + 1:
//
//     d(k, o) = sum_j m_k(j) * (x_j - x_{j + start + o})^2
//
// with the cycle mask  fl(off + k*tau) <= j < fl(off + (k+1)*tau)  and
// j <= n - 1 - 2*half_lag - start, over j < n - L + 1.
//
// What bounds it: operations. The frames overlap (a hop of 160 samples
// under 512- or 1024-sample frames), so the distinct input is the audio
// itself, a few MB; the masked samples need a subtract and an FMA for each
// of the L offsets, which at 13,624 rows takes longer than the bytes.
//
// Design:
// - Warps are independent persistent workers; they meet only at __syncwarp.
//   (Block-wide runs with a scan and several __syncthreads per run left the
//   SM idle between phases; warps out of phase hide each other's.)
// - Frames are read in place: the caller passes a (batches, T, n) view by
//   its batch and frame strides. A warp owns a run of R consecutive frames
//   of one batch and stages the union of their samples, (R-1)*frame_stride
//   + n floats, and the run's start, tau and off in its own shared memory
//   with cp.async (16-byte copies where the address allows, 4-byte copies at
//   the ends), double-buffered: the next run's data land while the current
//   run computes.
// - Parallel over samples: one lane per (row, k) pair computes the cycle's
//   integer sample range (ceil of the separately rounded bounds, so a
//   boundary sample falls in the same cycle as in the plain form), cut into
//   chunks of kChunk samples from the cycle's first; a warp scan numbers the
//   run's chunks in (row, k, j) order, and each lane takes an equal
//   contiguous range of them. A chunk is fully unrolled code that every lane
//   runs alike: a register window over x[j + start + o] slides one sample
//   per step (two shared-memory loads per sample), then a subtract and an
//   FMA per offset. A lane keeps a cycle's L sums in registers across its
//   chunks, in one loop over its chunks (a loop per cycle would serialize
//   lanes whose ranges cross cycles at different points).
// - Fixed order, no atomics: at a cycle's end a lane writes its L sums to
//   slot pair + lane, which no other (pair, lane) writes, and a pair's
//   slots are consecutive in lane order. One lane per (row, k, o) adds them
//   in order, its first four as independent loads, and the run's K*L
//   outputs per row are written contiguously. Two launches on the same
//   inputs give the same bits (the split into lanes, and so the rounding,
//   follows the run, so a view and its contiguous copy may differ in the
//   last bits).
// - R (with R*K <= 32 pairs), the warps per block and the grid are chosen
//   in km_cycle_dsum from the shapes, the kernel's registers, the shared
//   memory and the device's SM count: runs of several frames where the rows
//   fill the SMs (the decode), one frame per warp and one warp per block,
//   spread over the SMs, where they do not (the stream).

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kMaxWarps = 4;          // warps per block
constexpr int kChunk = 15;             // samples per chunk
constexpr int kMinWarpsPerSm = 12;     // the fewest that hid the phases
                                       // between chunks on an H100
constexpr int kMaxRunRows = 8;         // rows of a run: R*K <= 32 pairs

struct Args {
  const float* frames;
  const int* start;
  const float* tau;
  const float* off;
  float* out;
  int per_batch;       // frames per batch (T)
  long long batch_stride;
  int frame_stride;
  int n;
  int n_cycles;
  int run_rows;        // R
  int runs_per_batch;
  int runs;
  int stage_cap;       // floats per staging buffer: samples, then 3*R scalars
  int warp_words;      // shared memory per warp, in 4-byte words
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

struct Run {
  int b, t0, rows;
  long long row0;     // global index of the run's first row
  const float* src;   // first sample of the run's first frame
  int count;          // samples of the union
  int pad;            // where sample 0 lands in the staging buffer
};

__device__ __forceinline__ Run run_of(const Args& a, int run) {
  Run r;
  r.b = run / a.runs_per_batch;
  r.t0 = (run - r.b * a.runs_per_batch) * a.run_rows;
  r.rows = min(a.run_rows, a.per_batch - r.t0);
  r.row0 = static_cast<long long>(r.b) * a.per_batch + r.t0;
  r.src = a.frames + static_cast<long long>(r.b) * a.batch_stride
          + static_cast<long long>(r.t0) * a.frame_stride;
  r.count = (r.rows - 1) * a.frame_stride + a.n;
  // 16-byte global chunks land on 16-byte shared-memory chunks
  r.pad = static_cast<int>((reinterpret_cast<uintptr_t>(r.src) >> 2) & 3);
  return r;
}

// One warp issues the copies of a run's samples and scalars into `buf`
// (not waited for). The scalars go to the buffer's last 3*R words: start,
// tau, off.
__device__ __forceinline__ void stage(float* buf, const Args& a,
                                      const Run& r) {
  const int lane = threadIdx.x & 31;
  float* dst = buf + r.pad;
  const int head = min((4 - r.pad) & 3, r.count);
  const int n_vec = (r.count - head) >> 2;
  const int tail = head + 4 * n_vec;
  for (int i = lane; i < head; i += 32)
    cp_async4(dst + i, r.src + i);
  for (int v = lane; v < n_vec; v += 32)
    cp_async16(dst + head + 4 * v, r.src + head + 4 * v);
  for (int i = tail + lane; i < r.count; i += 32)
    cp_async4(dst + i, r.src + i);
  float* scalars = buf + a.stage_cap - 3 * a.run_rows;
  if (lane < r.rows) {
    cp_async4(scalars + lane, a.start + r.row0 + lane);
    cp_async4(scalars + a.run_rows + lane, a.tau + r.row0 + lane);
    cp_async4(scalars + 2 * a.run_rows + lane, a.off + r.row0 + lane);
  }
}

// Adds to acc the L sums of one chunk: cnt (<= kChunk) consecutive samples
// x[j] of one cycle against the window x[j + start + o], o < L. Fully
// unrolled, so the window slides by renaming registers.
template <int H>
__device__ __forceinline__ void chunk_sums(const float* __restrict__ xj,
                                           const float* __restrict__ zj,
                                           int cnt, float* acc) {
  constexpr int L = 2 * H + 1;
  float w[L];
#pragma unroll
  for (int o = 0; o < L - 1; ++o) w[o] = zj[o];
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    if (j >= cnt) break;
    w[L - 1] = zj[j + L - 1];
    const float x = xj[j];
#pragma unroll
    for (int o = 0; o < L; ++o) {
      const float e = x - w[o];
      acc[o] = fmaf(e, e, acc[o]);
    }
#pragma unroll
    for (int o = 0; o < L - 1; ++o) w[o] = w[o + 1];
  }
}

template <int H>
__global__ void __launch_bounds__(kMaxWarps * 32, 4)
    cycle_dsum_kernel(const Args a) {
  constexpr int L = 2 * H + 1;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int K = a.n_cycles;
  const int span = a.n - 2 * H;

  // this warp's region: two staging buffers, the lanes' sums per pair
  // ((32 + pairs) x L), the pair table
  float* region = smem + warp * a.warp_words;
  float* slot = region + 2 * a.stage_cap;
  // per pair: its first sample's and first window sample's offsets in
  // the staged run, its samples, chunks, first chunk, first and last lane
  int* pair_x = reinterpret_cast<int*>(slot + (32 + a.run_rows * K) * L);
  int* pair_z = pair_x + 32;
  int* pair_n = pair_z + 32;           // samples
  int* pair_c = pair_n + 32;
  int* pair_m = pair_c + 32;
  int* pair_t0 = pair_m + 32;
  int* pair_t1 = pair_t0 + 32;

  const int stride = gridDim.x * warps;
  int run = blockIdx.x * warps + warp;
  if (run < a.runs) stage(region, a, run_of(a, run));
  cp_async_commit();
  for (int it = 0; run < a.runs; run += stride, ++it) {
    const Run r = run_of(a, run);
    const int next = run + stride;
    if (next < a.runs)
      stage(region + ((it + 1) & 1) * a.stage_cap, a, run_of(a, next));
    cp_async_commit();
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");   // this run's
    __syncwarp();

    const float* buf = region + (it & 1) * a.stage_cap;
    const int* run_st = reinterpret_cast<const int*>(
        buf + a.stage_cap - 3 * a.run_rows);
    const float* run_tau = buf + a.stage_cap - 2 * a.run_rows;
    const float* run_off = buf + a.stage_cap - a.run_rows;
    const float* x_run = buf + r.pad;

    // ---- each (row, k) pair's sample range, one lane per pair ----
    const int pairs = r.rows * K;
    int jb = 0, len = 0, row = 0, st = 0;
    if (lane < pairs) {
      row = lane / K;
      const int k = lane - row * K;
      // start outside [0, n) is not a valid input; clamped so that every
      // read stays inside the row's frame
      st = min(max(run_st[row], -a.n), a.n);
      const float t = run_tau[row];
      const float of = run_off[row];
      // the bounds round like the plain form's separate multiply and add
      const float lo = __fadd_rn(of, __fmul_rn(static_cast<float>(k), t));
      const float hi =
          __fadd_rn(of, __fmul_rn(static_cast<float>(k + 1), t));
      // integers j with lo <= j < hi are ceil(lo) <= j < ceil(hi); the
      // compared sample j + start + o must lie in the frame for every o
      const float cl = ceilf(lo), ch = ceilf(hi);
      const float j_min = static_cast<float>(max(0, -st));
      const float j_end = static_cast<float>(span - max(st, 0));
      if (cl == cl && ch == ch) {              // NaN bounds select nothing
        jb = static_cast<int>(fminf(fmaxf(cl, j_min), j_end));
        const int je = static_cast<int>(fminf(fmaxf(ch, j_min), j_end));
        len = max(je - jb, 0);
      }
    }
    // chunks of kChunk samples from each cycle's first; an inclusive scan
    // over the pairs numbers them in (row, k, j) order
    const int n_chunks = (len + kChunk - 1) / kChunk;
    int v = n_chunks;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, v, d);
      if (lane >= d) v += y;
    }
    const int chunks = __shfl_sync(0xffffffffu, v, 31);
    // lane t < act takes chunks [t * chunks / act, (t + 1) * chunks / act),
    // at least one, so chunk c is lane ((c + 1) * act - 1) / chunks's
    const int act = min(32, chunks);
    if (lane < pairs) {
      const int first = v - n_chunks;
      pair_x[lane] = row * a.frame_stride + jb;
      pair_z[lane] = row * a.frame_stride + jb + st;
      pair_n[lane] = len;
      pair_c[lane] = first;
      pair_m[lane] = n_chunks;
      pair_t0[lane] = n_chunks > 0 ? ((first + 1) * act - 1) / chunks : 0;
      pair_t1[lane] = n_chunks > 0 ? ((first + n_chunks) * act - 1) / chunks
                                   : -1;
    }
    __syncwarp();

    // ---- this lane's chunks, summed per pair in registers; each pair's
    // sums to slot pair + lane, which no other (pair, lane) writes ----
    if (lane < act) {
      int c = lane * chunks / act;
      const int c_end = (lane + 1) * chunks / act;
      int p = 0;                   // the last pair whose chunks start <= c
#pragma unroll
      for (int step = 16; step > 0; step >>= 1)
        if (p + step < pairs && pair_c[p + step] <= c) p += step;
      float acc[L];
#pragma unroll
      for (int o = 0; o < L; ++o) acc[o] = 0.0f;
      // one loop over the lane's chunks, so every lane steps alike; only
      // the flush at a cycle's end is divergent
      for (; c < c_end; ++c) {
        if (c == pair_c[p] + pair_m[p]) {
#pragma unroll
          for (int o = 0; o < L; ++o) {
            slot[(p + lane) * L + o] = acc[o];
            acc[o] = 0.0f;
          }
          do ++p; while (pair_m[p] == 0);
        }
        const int i = (c - pair_c[p]) * kChunk;
        chunk_sums<H>(x_run + pair_x[p] + i, x_run + pair_z[p] + i,
                      min(kChunk, pair_n[p] - i), acc);
      }
#pragma unroll
      for (int o = 0; o < L; ++o) slot[(p + lane) * L + o] = acc[o];
    }
    __syncwarp();

    // ---- each pair's lanes added in order; the run's K*L outputs per
    // row written contiguously ----
    float* out = a.out + r.row0 * static_cast<long long>(K * L);
#pragma unroll 2
    for (int q = lane; q < pairs * L; q += 32) {
      const int p = q / L;
      const int lanes = pair_t1[p] - pair_t0[p] + 1;       // 0 if empty
      const float* src = slot + (p + pair_t0[p]) * L + (q - p * L);
      // the first four slots as independent loads (most cycles span
      // fewer lanes; adding +0.0f to a sum of squares changes nothing)
      float part[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) part[t] = t < lanes ? src[t * L] : 0.0f;
      float sum = ((part[0] + part[1]) + part[2]) + part[3];
      for (int t = 4; t < lanes; ++t) sum += src[t * L];
      out[q] = sum;
    }
    __syncwarp();            // the tables and this buffer are reused
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Shared memory of one warp with runs of `rows` frames, in 4-byte words;
// sets the staging buffer's size.
int warp_words(int rows, int frame_stride, int n, int n_cycles, int n_lag,
               int* stage_cap) {
  const long long count =
      static_cast<long long>(rows - 1) * frame_stride + n;
  // samples after an alignment pad of up to 3, then 3 scalars per row
  const long long cap = (count + 3 + 3 * rows + 3) / 4 * 4;
  *stage_cap = static_cast<int>(cap);
  const long long words =
      2 * cap + (static_cast<long long>(rows) * n_cycles + 32) * n_lag
      + 7 * 32;
  // a multiple of 4 keeps every warp's staging buffers 16-byte aligned
  return static_cast<int>(std::min<long long>((words + 3) / 4 * 4, 1 << 28));
}

template <int H>
int launch(Args a, int batches, cudaStream_t stream) {
  constexpr int L = 2 * H + 1;
  auto kernel = cycle_dsum_kernel<H>;
  int dev = 0, sms = 0, smem_block = 0, smem_sm = 0, reserved = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&smem_block, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  cudaDeviceGetAttribute(&smem_sm,
                         cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock,
                         dev);
  cudaFuncAttributes attr{};
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int regs_per_warp = (attr.numRegs + 7) / 8 * 8 * 32;

  // The largest run (R*K <= 32 pairs) whose warps, kMaxWarps to a block,
  // keep at least kMinWarpsPerSm warps on every SM and still fill the SMs;
  // one frame per warp otherwise. Few runs (the stream) go one warp to a
  // block, spread over the SMs.
  int rows = 1, warps = 1, words = 0, stage_cap = 0;
  for (int cand = kMaxRunRows; cand >= 1; --cand) {
    if (cand > 1 && (cand > a.per_batch || cand * a.n_cycles > 32)) continue;
    int cap = 0;
    const int w = warp_words(cand, a.frame_stride, a.n, a.n_cycles, L, &cap);
    const long long runs = static_cast<long long>(batches)
                           * ((a.per_batch + cand - 1) / cand);
    const int wpb = runs >= static_cast<long long>(kMaxWarps) * sms
                        ? kMaxWarps : 1;
    const long long smem = static_cast<long long>(wpb) * w * 4;
    const long long warps_sm =
        std::min<long long>(smem_sm / (smem + reserved),
                            65536 / (regs_per_warp * wpb)) * wpb;
    rows = cand, warps = wpb, words = w, stage_cap = cap;
    if (smem <= smem_block && warps_sm >= kMinWarpsPerSm
        && runs >= warps_sm * sms)
      break;
  }
  const size_t smem = static_cast<size_t>(warps) * words * 4;
  if (smem > static_cast<size_t>(smem_block))
    return static_cast<int>(cudaErrorInvalidValue);
  a.run_rows = rows;
  a.runs_per_batch = (a.per_batch + rows - 1) / rows;
  a.runs = batches * a.runs_per_batch;
  a.stage_cap = stage_cap;
  a.warp_words = words;

  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_block);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      warps * 32, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (a.runs + warps - 1) / warps;
  const long long slots = static_cast<long long>(std::max(per_sm, 1)) * sms;
  const int grid = static_cast<int>(std::min(blocks, slots));
  kernel<<<grid, warps * 32, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// frames: a (batches, per_batch, n) f32 view with unit sample stride, its
// batch and frame strides in elements; start (rows,) i32, tau and off
// (rows,) f32, out (rows, n_cycles, 2*half_lag+1) f32, rows =
// batches*per_batch, all on one device. half_lag must be 8 or 16, n at most
// 8192 and n_cycles at most 32. Launches on `stream` and returns the
// launch's cudaError_t.
extern "C" int km_cycle_dsum(const float* frames, const int* start,
                             const float* tau, const float* off, float* out,
                             int batches, int per_batch, int batch_stride,
                             int frame_stride, int n, int n_cycles,
                             int half_lag, void* stream) {
  if (batches <= 0 || per_batch <= 0) return 0;
  if (n > 8192 || n_cycles < 1 || n_cycles > 32 || frame_stride < 0 ||
      batch_stride < 0 || n <= 2 * half_lag)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.frames = frames;
  a.start = start;
  a.tau = tau;
  a.off = off;
  a.out = out;
  a.per_batch = per_batch;
  a.batch_stride = batch_stride;
  a.frame_stride = frame_stride;
  a.n = n;
  a.n_cycles = n_cycles;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (half_lag) {
    case 8:
      return launch<8>(a, batches, s);
    case 16:
      return launch<16>(a, batches, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
