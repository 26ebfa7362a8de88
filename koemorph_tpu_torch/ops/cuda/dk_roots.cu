// Durand-Kerner roots of monic LPC polynomials.
//
// Replaces the TPU kernel koemorph_tpu/ops/pallas/dk_roots_kernel.py
// (poly_roots_dk_pallas, body _dk_kernel). For each polynomial
// P(x) = a_0 x^p + a_1 x^{p-1} + ... + a_p (a_0 == 1 for LPC) it runs
// `iters` simultaneous (Jacobi) Weierstrass updates
//
//     z_i <- z_i - P(z_i) / prod_{j != i} (z_i - z_j)
//
// from the start table z0 (0.9 * exp(2 pi i (k + 0.35) / p), rounded to
// complex64 on the host), skipping a root's step where |prod| < 1e-12.
//
// What bounds it: operations (~p (10(p+1) + 10p + 14) flops per polynomial
// and iteration on 11 input and 20 output floats), and at the streaming
// shape (30 rows) the latency of one iteration's dependent chain. Design:
// the update is simultaneous, so the p roots of a polynomial run on p
// lanes of a warp, 3 polynomials per warp (lanes 0-29 for p = 10). Each
// lane loads the coefficients once and keeps its own root in registers;
// each iteration it evaluates Horner at its root, gathers the other roots
// with warp shuffles (all issued before the product chain), and forms the
// product over j != i in ascending j. Each root's arithmetic is in the order
// of the plain form (ops/egemaps.py, poly_roots_plain). Small launches use
// one-warp blocks, so 30 rows spread over 10 SMs.

#include <cuda_runtime.h>

namespace {

template <int P>
__global__ void dk_roots_kernel(const float* __restrict__ a,
                                const float* __restrict__ z0,
                                float* __restrict__ out,
                                int rows, int iters) {
  constexpr int kPer = 32 / P;          // polynomials per warp
  const int lane = threadIdx.x % 32;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  // lanes past kPer * P duplicate the last root of the last polynomial and
  // write nothing; every lane takes part in the shuffles
  const int slot = min(lane / P, kPer - 1);
  const int i = min(lane - slot * P, P - 1);
  const int base = slot * P;
  const int r = warp * kPer + slot;
  const bool live = lane < kPer * P && r < rows;
  const int rr = min(r, rows - 1);

  float c[P + 1];
#pragma unroll
  for (int q = 0; q <= P; ++q) c[q] = a[static_cast<size_t>(rr) * (P + 1) + q];
  float zr = z0[2 * i], zi = z0[2 * i + 1];

  for (int it = 0; it < iters; ++it) {
    // the other roots of this polynomial, from the previous iterate
    float xr[P], xi[P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      xr[j] = __shfl_sync(0xffffffffu, zr, base + j);
      xi[j] = __shfl_sync(0xffffffffu, zi, base + j);
    }
    // Horner: P(z_i), starting at the leading coefficient
    float pr = c[0], pim = 0.0f;
#pragma unroll
    for (int q = 1; q <= P; ++q) {
      const float tr = pr * zr - pim * zi + c[q];
      const float ti = pr * zi + pim * zr;
      pr = tr;
      pim = ti;
    }
    // prod_{j != i} (z_i - z_j), ascending j; the factor j == i is
    // computed and not taken (a select, so the warp does not diverge)
    float dr = 1.0f, di = 0.0f;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const float ur = zr - xr[j];
      const float ui = zi - xi[j];
      const float tr = dr * ur - di * ui;
      const float ti = dr * ui + di * ur;
      dr = j == i ? dr : tr;
      di = j == i ? di : ti;
    }
    // P / prod, scaled by the larger part of the divisor (Smith's
    // algorithm, as PyTorch's complex division) so a diverging root does
    // not overflow dr^2 + di^2. Both of Smith's cases are formed and one
    // is selected, one division and one reciprocal either way, so the
    // lanes of a warp do not diverge.
    const bool real_major = fabsf(dr) >= fabsf(di);
    const float num = real_major ? di : dr;
    const float den = real_major ? dr : di;
    const float rat = num / den;
    const float scl = 1.0f / (den + num * rat);
    const float sr = real_major ? (pr + pim * rat) * scl
                                : (pr * rat + pim) * scl;
    const float si = real_major ? (pim - pr * rat) * scl
                                : (pim * rat - pr) * scl;
    // the step is skipped where |prod| < 1e-12; a NaN product steps, so a
    // diverging root turns NaN as in the plain form and the TPU kernel
    const bool step = !(hypotf(dr, di) < 1e-12f);
    zr = step ? zr - sr : zr;
    zi = step ? zi - si : zi;
    __syncwarp();
  }

  if (live) {
    float* o = out + (static_cast<size_t>(r) * P + i) * 2;
    o[0] = zr;
    o[1] = zi;
  }
}

}  // namespace

// a (rows, p+1) f32, z0 (p, 2) f32, out (rows, p, 2) f32 (interleaved
// re/im, i.e. complex64); all contiguous on one device. Only p == 10 (the
// eGeMAPS LPC order) is compiled; another p returns cudaErrorInvalidValue.
extern "C" int km_dk_roots(const float* a, const float* z0, float* out,
                           int rows, int p, int iters, void* stream) {
  if (p != 10) return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0) return 0;
  constexpr int kPer = 32 / 10;
  const int warps = (rows + kPer - 1) / kPer;
  // one warp per block while the warps do not fill the card's 132 SMs
  // twice; four beyond that
  const int per_block = warps <= 264 ? 1 : 4;
  const int blocks = (warps + per_block - 1) / per_block;
  dk_roots_kernel<10><<<blocks, 32 * per_block, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      a, z0, out, rows, iters);
  return static_cast<int>(cudaGetLastError());
}
