// Fused STFT -> mel -> dB of un-windowed frames.
//
// Replaces the TPU kernel koemorph_tpu/ops/pallas/frontend_kernel.py
// (fused_frames_to_logmel, body _kernel). For every frame f of n_fft
// samples, with the Hann window folded into the real-DFT bases Wc, Ws
// (bins-major, (n_bins, n_fft)) and the Slaney mel bank FB (n_bins, n_mels):
//
//     re_b = sum_k f_k Wc[b][k],   im_b = sum_k f_k Ws[b][k]
//     mel_m = sum_b (re_b^2 + im_b^2) FB[b][m]
//     out_m = 10 log10(max(mel_m, 1e-10))
//
// all in fp32 FMA (no tensor cores, no TF32; the mel frontend is full f32).
//
// What bounds it: operations for a batch of frames (2 n_fft n_bins 2 flops
// per frame against 4 n_fft bytes read: ~530 flops per frame byte), bytes
// for a single frame (the 4.2 MB of bases are read for one frame's work).
// Design: the bins are cut into groups, one block column per group, so a
// single frame still spreads over many SMs. Each block computes the power
// of its bins for a tile of frames and that group's share of the frames'
// mel sums, written to a scratch buffer (groups, T, n_mels); a second pass
// adds the groups in a fixed order and takes the log. No atomics: two runs
// give the same bits.
//
// - Batches (T > kSmallT): a 32-frame x 64-bin tile per block, the frames
//   and both bases staged in shared memory 32 samples at a time; each
//   thread accumulates 2 frames x 4 bins of re and im in registers.
// - Single frames (T <= kSmallT, the stream): one warp per bin, its lanes
//   striding the samples (coalesced reads of the basis rows), a fixed
//   shuffle tree for the sum; 8 bins per block, the frames in shared memory.
//
// The log is taken in double precision and rounded once, so all-zero frames
// give exactly -100 dB, as the plain PyTorch form does.

#include <cuda_runtime.h>

namespace {

constexpr int kTileT = 32;    // frames per block (batch path)
constexpr int kTileB = 64;    // bins per block (batch path)
constexpr int kTileK = 32;    // samples per shared-memory stage
constexpr int kThreads = 256;
constexpr int kSmallT = 8;    // frames up to which the warp-per-bin path runs
constexpr int kRowBins = kThreads / 32;   // bins per block (single frames)

__global__ void __launch_bounds__(kThreads)
logmel_tile_kernel(const float* __restrict__ frames,
                   const float* __restrict__ cos_t,
                   const float* __restrict__ sin_t,
                   const float* __restrict__ fb,
                   float* __restrict__ partial,
                   int T, int n_fft, int n_bins, int n_mels) {
  __shared__ float fs[kTileT][kTileK + 1];
  __shared__ float cs[kTileK][kTileB + 1];
  __shared__ float ss[kTileK][kTileB + 1];
  __shared__ float ps[kTileT][kTileB + 1];

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * kTileT;
  const int g = blockIdx.y;
  const int b0 = g * kTileB;
  const int ty = tid / 16;     // frames 2*ty, 2*ty+1
  const int tx = tid % 16;     // bins tx + 16*j, j < 4

  float re[2][4], im[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) re[i][j] = im[i][j] = 0.0f;

  for (int k0 = 0; k0 < n_fft; k0 += kTileK) {
    // frames tile: row r, sample c (lanes along c: coalesced)
#pragma unroll
    for (int i = 0; i < (kTileT * kTileK) / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / kTileK, c = idx % kTileK;
      const int t = t0 + r;
      fs[r][c] = t < T ? frames[static_cast<size_t>(t) * n_fft + k0 + c]
                       : 0.0f;
    }
    // basis tiles: bin j, sample c (lanes along c: coalesced)
#pragma unroll
    for (int i = 0; i < (kTileB * kTileK) / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int j = idx / kTileK, c = idx % kTileK;
      const int b = b0 + j;
      const size_t at = static_cast<size_t>(b) * n_fft + k0 + c;
      cs[c][j] = b < n_bins ? cos_t[at] : 0.0f;
      ss[c][j] = b < n_bins ? sin_t[at] : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < kTileK; ++c) {
      const float f0 = fs[2 * ty][c];
      const float f1 = fs[2 * ty + 1][c];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float wc = cs[c][tx + 16 * j];
        const float ws = ss[c][tx + 16 * j];
        re[0][j] = fmaf(f0, wc, re[0][j]);
        re[1][j] = fmaf(f1, wc, re[1][j]);
        im[0][j] = fmaf(f0, ws, im[0][j]);
        im[1][j] = fmaf(f1, ws, im[1][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int bl = tx + 16 * j;
      ps[2 * ty + i][bl] = (b0 + bl < n_bins)
          ? re[i][j] * re[i][j] + im[i][j] * im[i][j] : 0.0f;
    }
  __syncthreads();

  // this group's share of the tile's mel sums, bins in ascending order
  const int nb = min(kTileB, n_bins - b0);
  for (int idx = tid; idx < kTileT * n_mels; idx += kThreads) {
    const int r = idx / n_mels, m = idx % n_mels;
    const int t = t0 + r;
    if (t >= T) continue;
    float s = 0.0f;
    for (int j = 0; j < nb; ++j)
      s = fmaf(ps[r][j], __ldg(fb + static_cast<size_t>(b0 + j) * n_mels + m),
               s);
    partial[(static_cast<size_t>(g) * T + t) * n_mels + m] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
logmel_rows_kernel(const float* __restrict__ frames,
                   const float* __restrict__ cos_t,
                   const float* __restrict__ sin_t,
                   const float* __restrict__ fb,
                   float* __restrict__ partial,
                   int T, int n_fft, int n_bins, int n_mels) {
  extern __shared__ float smem[];
  float* fs = smem;                              // (T, n_fft)
  float* ps = smem + static_cast<size_t>(T) * n_fft;   // (T, kRowBins)
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = blockIdx.x;
  const int b0 = g * kRowBins;

  for (int i = tid; i < T * n_fft; i += kThreads) fs[i] = frames[i];
  __syncthreads();

  const int b = b0 + warp;
  float re[kSmallT], im[kSmallT];
#pragma unroll
  for (int t = 0; t < kSmallT; ++t) re[t] = im[t] = 0.0f;
  if (b < n_bins) {
    const float* wc = cos_t + static_cast<size_t>(b) * n_fft;
    const float* ws = sin_t + static_cast<size_t>(b) * n_fft;
    for (int k = lane; k < n_fft; k += 32) {
      const float c = __ldg(wc + k), s = __ldg(ws + k);
#pragma unroll
      for (int t = 0; t < kSmallT; ++t) {
        if (t < T) {
          const float f = fs[t * n_fft + k];
          re[t] = fmaf(f, c, re[t]);
          im[t] = fmaf(f, s, im[t]);
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < kSmallT; ++t) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      re[t] += __shfl_down_sync(0xffffffffu, re[t], off);
      im[t] += __shfl_down_sync(0xffffffffu, im[t], off);
    }
    if (lane == 0 && t < T)
      ps[t * kRowBins + warp] =
          b < n_bins ? re[t] * re[t] + im[t] * im[t] : 0.0f;
  }
  __syncthreads();

  const int nb = min(kRowBins, n_bins - b0);
  for (int idx = tid; idx < T * n_mels; idx += kThreads) {
    const int t = idx / n_mels, m = idx % n_mels;
    float s = 0.0f;
    for (int j = 0; j < nb; ++j)
      s = fmaf(ps[t * kRowBins + j],
               __ldg(fb + static_cast<size_t>(b0 + j) * n_mels + m), s);
    partial[(static_cast<size_t>(g) * T + t) * n_mels + m] = s;
  }
}

__global__ void logmel_reduce_kernel(const float* __restrict__ partial,
                                     float* __restrict__ out, int groups,
                                     int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.0f;
  for (int g = 0; g < groups; ++g) s += partial[static_cast<size_t>(g) * count + i];
  out[i] = static_cast<float>(10.0 * log10(static_cast<double>(fmaxf(s, 1e-10f))));
}

}  // namespace

// Number of bin groups, and so of (T, n_mels) slices of the scratch buffer,
// that km_logmel needs for T frames of n_bins bins.
extern "C" int km_logmel_groups(int T, int n_bins) {
  return T <= kSmallT ? (n_bins + kRowBins - 1) / kRowBins
                      : (n_bins + kTileB - 1) / kTileB;
}

// frames (T, n_fft) f32; cos_t and sin_t (n_bins, n_fft) f32, the Hann
// window folded in; fb (n_bins, n_mels) f32; partial
// (km_logmel_groups(T, n_bins), T, n_mels) f32 scratch; out (T, n_mels)
// f32; all contiguous on one device, n_fft a multiple of 32. Launches on
// `stream` and returns the first launch error (cudaError_t).
extern "C" int km_logmel(const float* frames, const float* cos_t,
                         const float* sin_t, const float* fb, float* partial,
                         float* out, int T, int n_fft, int n_bins, int n_mels,
                         void* stream) {
  if (T <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int groups = km_logmel_groups(T, n_bins);
  if (T <= kSmallT) {
    const size_t smem = (static_cast<size_t>(T) * n_fft + T * kRowBins)
                        * sizeof(float);
    logmel_rows_kernel<<<groups, kThreads, smem, st>>>(
        frames, cos_t, sin_t, fb, partial, T, n_fft, n_bins, n_mels);
  } else {
    dim3 grid((T + kTileT - 1) / kTileT, groups);
    logmel_tile_kernel<<<grid, kThreads, 0, st>>>(
        frames, cos_t, sin_t, fb, partial, T, n_fft, n_bins, n_mels);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int count = T * n_mels;
  logmel_reduce_kernel<<<(count + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      partial, out, groups, count);
  return static_cast<int>(cudaGetLastError());
}
