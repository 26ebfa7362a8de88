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
// What bounds it: operations, and at the streaming shape (30 rows) the
// launch itself. Each polynomial does ~p * (10(p+1) + 10p + 14) flops per
// iteration on 11 input and 20 output floats. Design: one thread per
// polynomial; the p roots live in registers as re/im float pairs through
// every iteration (the loops over roots are unrolled by the template on
// p), so nothing but the coefficients and the result touch memory.

#include <cuda_runtime.h>

namespace {

template <int P>
__global__ void dk_roots_kernel(const float* __restrict__ a,
                                const float* __restrict__ z0,
                                float* __restrict__ out,
                                int rows, int iters) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  float c[P + 1];
#pragma unroll
  for (int i = 0; i <= P; ++i) c[i] = a[static_cast<size_t>(r) * (P + 1) + i];
  float zr[P], zi[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    zr[i] = z0[2 * i];
    zi[i] = z0[2 * i + 1];
  }

  for (int it = 0; it < iters; ++it) {
    float nr[P], ni[P];
#pragma unroll
    for (int i = 0; i < P; ++i) {
      // Horner: P(z_i), starting at the leading coefficient
      float pr = c[0], pim = 0.0f;
#pragma unroll
      for (int q = 1; q <= P; ++q) {
        const float tr = pr * zr[i] - pim * zi[i] + c[q];
        const float ti = pr * zi[i] + pim * zr[i];
        pr = tr;
        pim = ti;
      }
      // prod_{j != i} (z_i - z_j)
      float dr = 1.0f, di = 0.0f;
#pragma unroll
      for (int j = 0; j < P; ++j) {
        if (j == i) continue;
        const float ur = zr[i] - zr[j];
        const float ui = zi[i] - zi[j];
        const float tr = dr * ur - di * ui;
        const float ti = dr * ui + di * ur;
        dr = tr;
        di = ti;
      }
      if (hypotf(dr, di) < 1e-12f) {
        nr[i] = zr[i];
        ni[i] = zi[i];
      } else {
        // P / prod, scaled by the larger part of the divisor (Smith's
        // algorithm, as PyTorch's complex division) so a diverging root
        // does not overflow dr^2 + di^2
        float sr, si;
        if (fabsf(dr) >= fabsf(di)) {
          const float rat = di / dr;
          const float scl = 1.0f / (dr + di * rat);
          sr = (pr + pim * rat) * scl;
          si = (pim - pr * rat) * scl;
        } else {
          const float rat = dr / di;
          const float scl = 1.0f / (di + dr * rat);
          sr = (pr * rat + pim) * scl;
          si = (pim * rat - pr) * scl;
        }
        nr[i] = zr[i] - sr;
        ni[i] = zi[i] - si;
      }
    }
#pragma unroll
    for (int i = 0; i < P; ++i) {
      zr[i] = nr[i];
      zi[i] = ni[i];
    }
  }

  float* o = out + static_cast<size_t>(r) * P * 2;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    o[2 * i] = zr[i];
    o[2 * i + 1] = zi[i];
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
  const int threads = 128;
  const int blocks = (rows + threads - 1) / threads;
  dk_roots_kernel<10><<<blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      a, z0, out, rows, iters);
  return static_cast<int>(cudaGetLastError());
}
