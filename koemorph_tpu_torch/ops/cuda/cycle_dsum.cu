// Cycle-restricted difference sums for per-glottal-cycle jitter.
//
// Replaces the TPU kernel koemorph_tpu/ops/pallas/cycle_dsum_kernel.py
// (cycle_dsum_lanes_pallas, body _kernel). For every row (one YIN analysis
// frame x of n samples) and every cycle slot k < K and search offset
// o < L = 2*half_lag + 1:
//
//     d(k, o) = sum_j m_k(j) * (x_j - x_{j + start + o})^2,   x_i = 0 for i >= n
//
// with the cycle mask  fl(off + k*tau) <= j < fl(off + (k+1)*tau)  and
// j <= n - 1 - 2*half_lag - start, over j < n - L + 1.
//
// What bounds it: bytes. The inputs are one frame per row (2-4 KB) and the
// outputs K*L floats; the arithmetic the masks leave is ~3*L flops per
// frame sample, far below the fp32 rate. Design: one block per row stages
// the frame in shared memory once (no materialized shifted copy, which is
// what the TPU form gathered outside the kernel), and each thread owns one
// (k, o) output, summing over its cycle's few hundred samples. The cycle
// boundaries are computed with explicit round-to-nearest multiply and add
// (no FMA contraction; the file is also built with --fmad=false) so that a
// boundary sample falls in the same cycle as in the plain PyTorch form.

#include <cuda_runtime.h>

namespace {

__global__ void cycle_dsum_kernel(const float* __restrict__ frames,
                                  const int* __restrict__ start,
                                  const float* __restrict__ tau,
                                  const float* __restrict__ off,
                                  float* __restrict__ out,
                                  int n, int n_cycles, int half_lag) {
  extern __shared__ float x[];
  const int row = blockIdx.x;
  const float* fr = frames + static_cast<size_t>(row) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) x[i] = fr[i];
  __syncthreads();

  const int n_lag = 2 * half_lag + 1;
  const int span = n - n_lag + 1;
  const int st = start[row];
  const float t = tau[row];
  const float of = off[row];
  // the compared sample x[j + start + o] must be a real sample for every
  // offset o, so this bound does not depend on o
  const float lim = (static_cast<float>(n) - 1.0f)
                    - 2.0f * static_cast<float>(half_lag)
                    - static_cast<float>(st);
  const int total = n_cycles * n_lag;
  float* out_row = out + static_cast<size_t>(row) * total;

  for (int q = threadIdx.x; q < total; q += blockDim.x) {
    const int k = q / n_lag;
    const int o = q - k * n_lag;
    const float lo = __fadd_rn(of, __fmul_rn(static_cast<float>(k), t));
    const float hi = __fadd_rn(of, __fmul_rn(static_cast<float>(k + 1), t));
    // integer range that brackets [lo, hi), clamped to [0, span); the float
    // compares below decide membership exactly (NaN bounds select nothing)
    const int jb = static_cast<int>(
        fminf(fmaxf(floorf(lo), 0.0f), static_cast<float>(span)));
    const int je = static_cast<int>(
        fminf(fmaxf(ceilf(hi) + 1.0f, 0.0f), static_cast<float>(span)));
    const int shift = st + o;
    float acc = 0.0f;
    for (int j = jb; j < je; ++j) {
      const float jf = static_cast<float>(j);
      if (jf >= lo && jf < hi && jf <= lim) {
        const int src = j + shift;
        const float z = (src >= 0 && src < n) ? x[src] : 0.0f;
        const float e = __fsub_rn(x[j], z);
        acc = __fadd_rn(acc, __fmul_rn(e, e));
      }
    }
    out_row[q] = acc;
  }
}

}  // namespace

// frames (rows, n) f32, start (rows,) i32, tau and off (rows,) f32,
// out (rows, n_cycles, 2*half_lag+1) f32; all contiguous on one device.
// Launches on `stream` and returns the launch's cudaError_t.
extern "C" int km_cycle_dsum(const float* frames, const int* start,
                             const float* tau, const float* off, float* out,
                             int rows, int n, int n_cycles, int half_lag,
                             void* stream) {
  if (rows <= 0) return 0;
  const int total = n_cycles * (2 * half_lag + 1);
  int threads = ((total + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const size_t smem = static_cast<size_t>(n) * sizeof(float);
  cycle_dsum_kernel<<<rows, threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      frames, start, tau, off, out, n, n_cycles, half_lag);
  return static_cast<int>(cudaGetLastError());
}
