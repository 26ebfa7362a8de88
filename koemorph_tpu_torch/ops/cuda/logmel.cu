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
// Only the live bins [lo, hi), those with a nonzero filter weight, are
// computed (506 of 513 at n_fft 1024, 80 mels, 80-8000 Hz): every other bin
// adds exactly +0 to every mel sum of finite frames. The host hands over
// the live rows of the bases and of FB (ops/frontend.py,
// logmel_kernel_constants), zero-padded to groups of 64 bins.
//
// - Batches (T > kSmallT): operations bound them (2 n_fft bins 2 flops per
//   frame on 4 n_fft bytes). The two DFT products run on the tensor cores
//   in 3xTF32: each operand x is split into big = tf32(x) and small =
//   tf32(x - big), both rounded to nearest with ties away (cvt.rna), and
//   re/im accumulate big*big + big*small + small*big in fp32 (~22 bits,
//   near fp32; plain TF32 keeps ~10). The bases are split once on the host;
//   each frames tile is split in shared memory after it lands. A block
//   covers 64 bins x BN frames with two warpgroups, each issuing
//   wgmma.m64n(BN/2)k8 with both operands K-major in shared memory (128-byte
//   swizzle, rows of 32 samples), and holding the re and im accumulators of
//   the same tile, so the power re^2 + im^2 is formed in registers. A ring
//   of STAGES shared-memory stages is filled with cp.async (16-byte copies,
//   the swizzle applied by hand), the load of tile k+STAGES-1 overlapping
//   the products on tile k (a frame that starts off a 16-byte boundary is
//   copied 4 bytes at a time). The epilogue writes the power tile to shared
//   memory and computes the group's share of the mel sums on CUDA cores
//   (bins in ascending order) into a scratch buffer (groups, T, n_mels);
//   logmel_reduce_kernel adds the groups in a fixed order and takes the log.
// - Single frames (T <= kSmallT, the stream): bytes bound them (the 4 MB of
//   live bases are read for one frame's 2 MFLOP). A warp per bin, two per
//   block (253 blocks for 506 bins), each lane with all of its 16-byte
//   basis loads in flight at once; fp32 FMA and a fixed shuffle tree give
//   each bin's power; logmel_rows_mel_kernel then sums each mel over its
//   nonzero bins (a warp per mel, lanes in a fixed order, the spans passed
//   by value) and takes the log.
//
// Frames are read in place: frame r lies at (r / per_batch) * batch_stride
// + (r % per_batch) * frame_stride floats from `frames`, samples adjacent,
// at any 4-byte alignment (the server's frames are rows of its (S, L) audio
// rings, L odd; the decode's are `unfold` views at the hop).
//
// No atomics: two launches give the same bits. The log is taken in double
// precision and rounded once, so all-zero frames give exactly -100 dB, as
// the plain PyTorch form does.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTileB = 64;    // bins per block (batch path): the wgmma M
constexpr int kTileK = 32;    // samples per stage: one 128-byte smem row
constexpr int kSmallT = 8;    // frames up to which the single-frame path runs
constexpr int kRowBins = 2;   // single-frame path: bins per block
constexpr int kMelThreads = 128;
constexpr int kMaxMels = 256;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; `valid` false fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// 4-byte global -> shared copy (any 4-byte aligned source); `valid` false
// fills the 4 bytes with zeros
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// generic-proxy writes to shared memory made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of an accumulator
// register across the asynchronous products
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r) :: "memory");
}

// TF32 rounding to nearest, ties away from zero; the low 13 bits are
// cleared (the instruction leaves them unspecified), as the host split does
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r & 0xffffe000u);
}

// wgmma shared-memory descriptor of a K-major operand with the 128-byte
// swizzle: rows of 128 bytes (32 fp32), 8-row atoms of 1,024 bytes stacked
// along M or N (stride byte offset 1,024); the leading byte offset is
// unused for this layout (encoded 1). `saddr` is the shared-memory address
// of the operand's first row at the wanted K offset (a multiple of 32
// bytes inside a 1,024-byte aligned atom).
__device__ __forceinline__ uint64_t smem_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFFu) >> 4)
         | (static_cast<uint64_t>(1) << 16)
         | (static_cast<uint64_t>(1024 >> 4) << 32)
         | (static_cast<uint64_t>(1) << 62);
}

// D(64 x N) += A(64 x 8) B(8 x N), tf32 inputs, fp32 accumulators; thread t
// of the warpgroup holds D[16 (t/32) + (t%32)/4 + 8 ((i/2)%2)]
// [8 (i/4) + 2 (t%4) + i%2] in d[i]
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<16> {
  __device__ __forceinline__ static void mma(float (&d)[8], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(1));
  }
};

// where the frames lie: frame r at (r / per_batch) * batch_stride
// + (r % per_batch) * frame_stride floats from the base
struct FrameGeom {
  int per_batch, batch_stride, frame_stride;
};

__device__ __forceinline__ const float* frame_ptr(const float* frames,
                                                  int r, FrameGeom g) {
  return frames + static_cast<size_t>(r / g.per_batch) * g.batch_stride
         + static_cast<size_t>(r % g.per_batch) * g.frame_stride;
}

// byte offset of the 16-byte chunk c (of 8) of row r in a 128-byte-swizzled
// tile whose base is 1,024-byte aligned
__device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

template <int BN, int STAGES>
__global__ void __launch_bounds__(kThreads, 1)
logmel_wgmma_kernel(const float* __restrict__ frames,
                    const float* __restrict__ bases,
                    const float* __restrict__ fb,
                    float* __restrict__ partial,
                    int T, int n_fft, int rows, int n_mels, FrameGeom geom) {
  constexpr int WN = BN / 2;                 // frames per warpgroup
  constexpr int kAcc = WN / 2;               // accumulators per thread
  constexpr int kA = kTileB * kTileK * 4;    // one basis tile, bytes
  constexpr int kB = BN * kTileK * 4;        // one frames tile, bytes
  constexpr int kStage = 4 * kA + 2 * kB;    // 4 basis tiles, frames big/small
  constexpr int kPs = BN + 4;                // power tile row stride (floats)
  constexpr int FPT = BN / 16;               // epilogue: frames per thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int t0 = blockIdx.x * BN;
  const int g = blockIdx.y;
  const int b0 = g * kTileB;
  const int n_k = n_fft / kTileK;
  constexpr int kFrameChunks = (BN * 8) / kThreads;   // per thread per stage

  // the frame rows this thread copies, the same at every stage: where each
  // starts, and whether it is 16-byte aligned (then 16-byte copies, else
  // four 4-byte ones); rows past T are zero-filled
  const float* frow[kFrameChunks];
  bool fok[kFrameChunks], fal[kFrameChunks];
#pragma unroll
  for (int i = 0; i < kFrameChunks; ++i) {
    const int t = t0 + (tid + i * kThreads) / 8;
    fok[i] = t < T;
    frow[i] = frame_ptr(frames, fok[i] ? t : 0, geom);
    fal[i] = (reinterpret_cast<uintptr_t>(frow[i]) & 15) == 0;
  }

  auto load_stage = [&](int kt) {
    uint8_t* st = smem + (kt % STAGES) * kStage;
    const int k0 = kt * kTileK;
#pragma unroll
    for (int i = 0; i < (4 * kTileB * 8) / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int q = idx / (kTileB * 8);
      const int r = (idx / 8) % kTileB;
      const int c = idx % 8;
      const float* src = bases
          + (static_cast<size_t>(q) * rows + b0 + r) * n_fft + k0 + c * 4;
      cp_async16(smem_u32(st + q * kA + swz(r, c)), src, true);
    }
#pragma unroll
    for (int i = 0; i < kFrameChunks; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / 8, c = idx % 8;
      const float* src = frow[i] + k0 + c * 4;
      const uint32_t dst = smem_u32(st + 4 * kA + swz(r, c));
      if (fal[i]) {
        cp_async16(dst, src, fok[i]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) cp_async4(dst + 4 * j, src + j, fok[i]);
      }
    }
  };

  float re[kAcc], im[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) re[i] = im[i] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_k) load_stage(s);
    cp_async_commit();
  }

  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<STAGES - 2>();
    // stage kt has landed for every thread, and every warpgroup's products
    // on stage kt-1 are complete, so its buffer can be refilled
    __syncthreads();
    if (kt + STAGES - 1 < n_k) load_stage(kt + STAGES - 1);
    cp_async_commit();

    uint8_t* st = smem + (kt % STAGES) * kStage;
    // split the frames tile in place: big where it landed, small beside it
    float4* big4 = reinterpret_cast<float4*>(st + 4 * kA);
    float4* small4 = reinterpret_cast<float4*>(st + 4 * kA + kB);
#pragma unroll
    for (int i = 0; i < (BN * 8) / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const float4 v = big4[idx];
      float4 b, s;
      b.x = tf32_rna(v.x); s.x = tf32_rna(v.x - b.x);
      b.y = tf32_rna(v.y); s.y = tf32_rna(v.y - b.y);
      b.z = tf32_rna(v.z); s.z = tf32_rna(v.z - b.z);
      b.w = tf32_rna(v.w); s.w = tf32_rna(v.w - b.w);
      big4[idx] = b;
      small4[idx] = s;
    }
    fence_proxy_async();
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      fence_operand(re[i]);
      fence_operand(im[i]);
    }
    wgmma_fence();
    const uint32_t a0 = smem_u32(st);
    const uint32_t fbig = smem_u32(st + 4 * kA) + wg * WN * 128;
    const uint32_t fsmall = fbig + kB;
#pragma unroll
    for (int ks = 0; ks < kTileK / 8; ++ks) {
      const uint32_t off = ks * 32;          // 8 samples of a 128-byte row
      const uint64_t cb = smem_desc(a0 + off);
      const uint64_t cs = smem_desc(a0 + kA + off);
      const uint64_t sb = smem_desc(a0 + 2 * kA + off);
      const uint64_t ss = smem_desc(a0 + 3 * kA + off);
      const uint64_t xb = smem_desc(fbig + off);
      const uint64_t xs = smem_desc(fsmall + off);
      // the small cross terms first, then big x big
      Wgmma<WN>::mma(re, cs, xb);
      Wgmma<WN>::mma(re, cb, xs);
      Wgmma<WN>::mma(re, cb, xb);
      Wgmma<WN>::mma(im, ss, xb);
      Wgmma<WN>::mma(im, sb, xs);
      Wgmma<WN>::mma(im, sb, xb);
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      fence_operand(re[i]);
      fence_operand(im[i]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();            // every warpgroup is done with the stages

  // the power tile (bins x frames) and this group's FB rows, over the ring
  float* ps = reinterpret_cast<float*>(smem);
  float* fbs = ps + kTileB * kPs;
  {
    const int w = (tid % 128) / 32, l = tid % 32;
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int row = 16 * w + l / 4 + 8 * ((i / 2) % 2);
      const int col = wg * WN + 8 * (i / 4) + 2 * (l % 4) + (i % 2);
      ps[row * kPs + col] = re[i] * re[i] + im[i] * im[i];
    }
  }
  for (int i = tid; i < kTileB * n_mels; i += kThreads)
    fbs[i] = fb[static_cast<size_t>(b0) * n_mels + i];
  __syncthreads();

  // this group's share of the tile's mel sums, bins in ascending order;
  // thread (tf, tm) takes frames tf*FPT.. and mels m0 + tm + 16 q
  const int tf = tid / 16, tm = tid % 16;
  for (int m0 = 0; m0 < n_mels; m0 += 80) {
    float acc[FPT][5];
#pragma unroll
    for (int f = 0; f < FPT; ++f)
#pragma unroll
      for (int q = 0; q < 5; ++q) acc[f][q] = 0.0f;
    for (int j = 0; j < kTileB; ++j) {
      float pv[FPT], fv[5];
#pragma unroll
      for (int f = 0; f < FPT; ++f) pv[f] = ps[j * kPs + tf * FPT + f];
#pragma unroll
      for (int q = 0; q < 5; ++q) {
        const int m = m0 + tm + 16 * q;
        fv[q] = m < n_mels ? fbs[j * n_mels + m] : 0.0f;
      }
#pragma unroll
      for (int f = 0; f < FPT; ++f)
#pragma unroll
        for (int q = 0; q < 5; ++q) acc[f][q] = fmaf(pv[f], fv[q], acc[f][q]);
    }
#pragma unroll
    for (int f = 0; f < FPT; ++f) {
      const int t = t0 + tf * FPT + f;
      if (t >= T) continue;
#pragma unroll
      for (int q = 0; q < 5; ++q) {
        const int m = m0 + tm + 16 * q;
        if (m < n_mels)
          partial[(static_cast<size_t>(g) * T + t) * n_mels + m] = acc[f][q];
      }
    }
  }
}

__global__ void logmel_reduce_kernel(const float* __restrict__ partial,
                                     float* __restrict__ out, int groups,
                                     int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.0f;
  for (int g = 0; g < groups; ++g)
    s += partial[static_cast<size_t>(g) * count + i];
  out[i] = static_cast<float>(
      10.0 * log10(static_cast<double>(fmaxf(s, 1e-10f))));
}

// re[t], im[t] (t < T; 0 beyond) of live bin b (-1: none) over half h of
// each frame, summed over the warp by a fixed shuffle tree (lane 0 holds
// the sums). Each lane issues its 16-byte basis loads all at once; frames
// are read 4 bytes at a time, since a frame may start anywhere (the
// stream's frames are views into its audio rings).
__device__ __forceinline__ void half_power(const float* __restrict__ frames,
                                          FrameGeom geom,
                                          const float* __restrict__ wc,
                                          const float* __restrict__ ws,
                                          int b, int h, int lane, int T,
                                          int n_fft, float (&re)[kSmallT],
                                          float (&im)[kSmallT]) {
  const int n4h = n_fft / 8;                 // float4s in half a frame
#pragma unroll
  for (int t = 0; t < kSmallT; ++t) re[t] = im[t] = 0.0f;
  if (b >= 0) {
    const float4* c4 = reinterpret_cast<const float4*>(
        wc + static_cast<size_t>(b) * n_fft) + h * n4h;
    const float4* s4 = reinterpret_cast<const float4*>(
        ws + static_cast<size_t>(b) * n_fft) + h * n4h;
    float4 c[4], s[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = lane + 32 * i;
      const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      c[i] = q < n4h ? __ldg(c4 + q) : z;
      s[i] = q < n4h ? __ldg(s4 + q) : z;
    }
#pragma unroll
    for (int t = 0; t < kSmallT; ++t) {
      if (t >= T) break;
      const float* fr = frame_ptr(frames, t, geom) + h * (n_fft / 2);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = lane + 32 * i;
        if (q >= n4h) break;
        const float f0 = __ldg(fr + 4 * q), f1 = __ldg(fr + 4 * q + 1);
        const float f2 = __ldg(fr + 4 * q + 2), f3 = __ldg(fr + 4 * q + 3);
        re[t] = fmaf(f0, c[i].x, re[t]);
        re[t] = fmaf(f1, c[i].y, re[t]);
        re[t] = fmaf(f2, c[i].z, re[t]);
        re[t] = fmaf(f3, c[i].w, re[t]);
        im[t] = fmaf(f0, s[i].x, im[t]);
        im[t] = fmaf(f1, s[i].y, im[t]);
        im[t] = fmaf(f2, s[i].z, im[t]);
        im[t] = fmaf(f3, s[i].w, im[t]);
      }
    }
  }
#pragma unroll
  for (int t = 0; t < kSmallT; ++t) {
    if (t >= T) break;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      re[t] += __shfl_down_sync(0xffffffffu, re[t], off);
      im[t] += __shfl_down_sync(0xffffffffu, im[t], off);
    }
  }
}

// Single frames, pass 1: power (T, n_live). Block x covers live bins
// kRowBins x + j; warp 2 j + h takes bin kRowBins x + j over samples
// [h n_fft/2, (h+1) n_fft/2), each lane with all of its 16-byte basis loads
// in flight at once; a fixed shuffle tree adds the lanes and a fixed-order
// add the two halves.
__global__ void __launch_bounds__(64 * kRowBins)
logmel_rows_power_kernel(const float* __restrict__ frames,
                         const float* __restrict__ wc,
                         const float* __restrict__ ws,
                         float* __restrict__ power,
                         int T, int n_fft, int n_live, FrameGeom geom) {
  __shared__ float half_re[kRowBins][2][kSmallT];
  __shared__ float half_im[kRowBins][2][kSmallT];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int j = warp / 2, h = warp % 2;
  const int b = blockIdx.x * kRowBins + j;
  float re[kSmallT], im[kSmallT];
  half_power(frames, geom, wc, ws, b < n_live ? b : -1, h, lane, T, n_fft,
             re, im);
  if (lane == 0)
#pragma unroll
    for (int t = 0; t < kSmallT; ++t) {
      half_re[j][h][t] = re[t];
      half_im[j][h][t] = im[t];
    }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kRowBins * T; idx += 64 * kRowBins) {
    const int jj = idx / T, t = idx % T;
    const int bb = blockIdx.x * kRowBins + jj;
    if (bb >= n_live) continue;
    const float r = half_re[jj][0][t] + half_re[jj][1][t];
    const float i = half_im[jj][0][t] + half_im[jj][1][t];
    power[static_cast<size_t>(t) * n_live + bb] = r * r + i * i;
  }
}

// each mel's nonzero bins [lo, hi) and the offset of its weights in the
// packed weights, passed by value so no load waits on another
struct MelSpans {
  int lo[kMaxMels], hi[kMaxMels], off[kMaxMels];
};

// Single frames, pass 2: out (T, n_mels). Warp m takes mel m: lane l its
// nonzero bins lo + l, lo + l + 32, ... in order, then a fixed shuffle tree
// adds the lanes; the log in double.
__global__ void __launch_bounds__(kMelThreads)
logmel_rows_mel_kernel(const float* __restrict__ power,
                       const float* __restrict__ fb_nz,
                       const __grid_constant__ MelSpans spans,
                       float* __restrict__ out, int T, int n_live,
                       int n_mels) {
  const int m = (blockIdx.x * kMelThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (m >= n_mels) return;                   // whole warps leave together
  const int lo = spans.lo[m], hi = spans.hi[m];
  const float* w = fb_nz + spans.off[m] - lo;
  float acc[kSmallT];
#pragma unroll
  for (int t = 0; t < kSmallT; ++t) acc[t] = 0.0f;
  for (int b = lo + lane; b < hi; b += 32) {
    const float wb = __ldg(w + b);
#pragma unroll
    for (int t = 0; t < kSmallT; ++t) {
      if (t >= T) break;
      acc[t] = fmaf(__ldg(power + static_cast<size_t>(t) * n_live + b), wb,
                    acc[t]);
    }
  }
#pragma unroll
  for (int t = 0; t < kSmallT; ++t) {
    if (t >= T) break;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[t] += __shfl_down_sync(0xffffffffu, acc[t], off);
    if (lane == 0)
      out[static_cast<size_t>(t) * n_mels + m] = static_cast<float>(
          10.0 * log10(static_cast<double>(fmaxf(acc[t], 1e-10f))));
  }
}

template <int BN, int STAGES>
int launch_wgmma(const float* frames, const float* bases, const float* fb,
                 float* partial, int T, int n_fft, int groups, int n_mels,
                 FrameGeom geom, cudaStream_t st) {
  constexpr int kStage = 4 * kTileB * kTileK * 4 + 2 * BN * kTileK * 4;
  const size_t ring = static_cast<size_t>(STAGES) * kStage;
  const size_t tail = (static_cast<size_t>(kTileB) * (BN + 4)
                       + static_cast<size_t>(kTileB) * n_mels) * sizeof(float);
  const size_t smem = (ring > tail ? ring : tail) + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      logmel_wgmma_kernel<BN, STAGES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((T + BN - 1) / BN, groups);
  logmel_wgmma_kernel<BN, STAGES><<<grid, kThreads, smem, st>>>(
      frames, bases, fb, partial, T, n_fft, groups * kTileB, n_mels, geom);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Batch path. frames: T frames of n_fft f32 samples (adjacent), frame r at
// (r / per_batch) * batch_stride + (r % per_batch) * frame_stride floats
// from `frames`, any 4-byte alignment; bases (4, groups*64, n_fft) f32: the
// TF32 split (big, small) of Wc, then of Ws, live bins only, zero-padded
// rows; fb (groups*64, n_mels) f32; partial (groups, T, n_mels) f32
// scratch; out (T, n_mels) f32; all but the frames contiguous, on the
// current device; n_fft a multiple of 32, n_mels <= 256. Launches on
// `stream` and returns the first error (cudaError_t).
//
// Tile: 128 frames per block with 3 stages (one block per SM) where that
// fills the device's SMs at least twice, else 32 frames with 2 stages (two
// blocks per SM). On an H100 (132 SMs), 8 groups: 128 at T = 4,104, 32 at
// T = 1,040, the faster of the two at each.
extern "C" int km_logmel_batch(const float* frames, const float* bases,
                               const float* fb, float* partial, float* out,
                               int T, int n_fft, int groups, int n_mels,
                               int per_batch, int batch_stride,
                               int frame_stride, void* stream) {
  if (T <= 0) return 0;
  if (n_fft % kTileK != 0 || n_mels > kMaxMels || groups <= 0
      || per_batch <= 0 || batch_stride < 0 || frame_stride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const FrameGeom geom{per_batch, batch_stride, frame_stride};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0;
  cudaError_t q = cudaGetDevice(&dev);
  if (q == cudaSuccess)
    q = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (q != cudaSuccess) return static_cast<int>(q);
  const bool wide = static_cast<long long>((T + 127) / 128) * groups
                    >= 2LL * sms;
  const int err = wide ? launch_wgmma<128, 3>(frames, bases, fb, partial, T,
                                              n_fft, groups, n_mels, geom, st)
                       : launch_wgmma<32, 2>(frames, bases, fb, partial, T,
                                             n_fft, groups, n_mels, geom,
                                             st);
  if (err != 0) return err;
  const int count = T * n_mels;
  logmel_reduce_kernel<<<(count + kThreads - 1) / kThreads, kThreads, 0,
                         st>>>(partial, out, groups, count);
  return static_cast<int>(cudaGetLastError());
}

// Single-frame path, 1 <= T <= 8. frames as for the batch path; wc, ws
// (n_live, n_fft) f32, the live bins; fb_nz f32, each mel's nonzero
// weights in bin order, mel after mel; spans (n_mels, 3) int32 in host memory, each mel's
// nonzero bins [first, last+1) and the offset of its weights in fb_nz;
// power (T, n_live) f32 scratch; out (T, n_mels) f32; n_fft a multiple of
// 32, at most 1024; n_mels at most 256. Launches on `stream` and returns
// the first error.
extern "C" int km_logmel_rows(const float* frames, const float* wc,
                              const float* ws, const float* fb_nz,
                              const int* spans, float* power, float* out,
                              int T, int n_fft, int n_live, int n_mels,
                              int per_batch, int batch_stride,
                              int frame_stride, void* stream) {
  if (T <= 0) return 0;
  if (T > kSmallT || n_fft % 32 != 0 || n_fft > 1024 || n_live <= 0
      || n_mels > kMaxMels || per_batch <= 0 || batch_stride < 0
      || frame_stride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const FrameGeom geom{per_batch, batch_stride, frame_stride};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  logmel_rows_power_kernel<<<(n_live + kRowBins - 1) / kRowBins,
                             64 * kRowBins, 0, st>>>(frames, wc, ws, power,
                                                     T, n_fft, n_live, geom);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  MelSpans sp;
  for (int m = 0; m < n_mels; ++m) {
    sp.lo[m] = spans[3 * m];
    sp.hi[m] = spans[3 * m + 1];
    sp.off[m] = spans[3 * m + 2];
  }
  logmel_rows_mel_kernel<<<(32 * n_mels + kMelThreads - 1) / kMelThreads,
                           kMelThreads, 0, st>>>(power, fb_nz, sp, out, T,
                                                 n_live, n_mels);
  return static_cast<int>(cudaGetLastError());
}
