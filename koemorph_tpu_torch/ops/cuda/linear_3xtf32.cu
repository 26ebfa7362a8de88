// y = x W^T + b in float32-class precision on the tensor cores (3xTF32).
//
// Replaces no TPU kernel: the JAX package leaves the wav2vec2 encoder's
// linear projections (features/wav2vec2.py: the attention's q, k, v and
// out projections, the feed-forward's two, the feature projection) to
// XLA, which runs them on the TPU's matrix units. On the H100, PyTorch's
// float32 F.linear runs cuBLAS's SIMT SGEMMs on the CUDA cores (67 TFLOP/s
// at most), and these products are bound by operations, not bytes: at
// M = 1,029 rows against 1024 x 1024 to 1024 x 4096 weights each does
// ~170 to ~230 FLOP per byte it must move (the card's 3xTF32 ridge is
// ~49). The tensor cores' TF32 rate is
// 495 TFLOP/s; 3xTF32, which keeps float32 accuracy, does three TF32
// products per float32 product, so 165 TFLOP/s bounds this kernel. The
// port's precision rule allows float32 or 3xTF32 and never plain TF32.
//
// - 3xTF32: each operand value v is split into big = tf32(v) and small =
//   tf32(v - big), both rounded to nearest with ties away (as cvt.rna
//   rounds, done with integer operations), and
//   the products accumulate small*big + big*small + big*big in fp32
//   registers (~22 bits, as the logmel kernel's, logmel.cu). Nothing is
//   split ahead of the call: the weights are split on the fly, so a
//   weight loaded into the module after it was built is what is read.
// - Operands: x (M, K) and W (N, K) row-major, both K-major, as tf32
//   wgmma requires of both. The product is formed transposed, D = W x^T:
//   a block covers 128 output features (two warpgroups of 64, the wgmma
//   M) by BX rows of x (the wgmma N), so its row tile can be any multiple
//   of 8. The host picks BX from {72, 96, 128, 144} for each shape by a
//   cost model of one wave of blocks per SM (km_linear_tile below): at
//   M = 1,029 rows and 1024 features a tile of 72 rows gives 120 blocks
//   on the 132 SMs where 128 rows would give 72.
// - Stages: two shared-memory stages of 32 K-values, each holding big and
//   small of the weight tile and of the x tile (128-byte rows, 128-byte
//   swizzle). While the tensor cores run the asynchronous products of
//   stage k (12 wgmma.m64nBXk8 per warpgroup), each thread splits its
//   16-byte chunks of stage k+1, loaded into registers one stage earlier
//   by predicated global loads, stores both parts into the other buffer,
//   and issues the loads of stage k+2; so the split costs shared-memory
//   stores but no extra pass over shared memory.
// - Sums: the tensor cores' fp32 accumulation rounds toward zero, and over
//   the 384 products of K = 1,024 in one accumulator it drifts to ~8e-6
//   of the output (6-7x cuBLAS's float32 error, measured on the H100). So
//   each stage's products start a fresh partial sum, which the CUDA cores
//   add to the block's sum rounded to nearest once the stage is done.
// - Epilogue: the accumulator tile goes through shared memory (transposed
//   back to rows of x), then each row's features are written as float4
//   with the bias added and, if asked, the exact (erf) GELU applied.
// - Grouped products: up to three (W, b, y) sharing x (the attention's q,
//   k and v) in one launch, the groups' feature tiles along gridDim.y.
// - Edges: rows past M and features past N read zeros and are not
//   written; K and N must be multiples of 4 (16-byte chunks), so a chunk
//   is wholly inside or outside.
//
// No atomics: two launches give the same bits.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;                  // two warpgroups
constexpr int kTileN = 128;                    // output features per block
constexpr int kTileK = 32;                     // K per stage: a 128-byte row
constexpr int kMaxGroups = 3;
constexpr int kWBytes = kTileN * kTileK * 4;   // one weight tile, 16 KB
constexpr int kWChunks = kTileN * 8 / kThreads;  // its 16-byte chunks a thread
constexpr int kYs = kTileN + 4;                // epilogue row stride (floats)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of an accumulator
// register across the asynchronous products
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r) :: "memory");
}

// TF32 rounding to nearest, ties away from zero, the low 13 bits cleared:
// what cvt.rna.tf32.f32 gives for finite values, in two integer
// operations (with cvt.rna the kernel took 7-16% longer at three of the
// encoder's four shapes on the H100, 10% less at one; the bits are equal)
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

__device__ __forceinline__ void split4(const float4 v, float4& b, float4& s) {
  b.x = tf32_rna(v.x); s.x = tf32_rna(v.x - b.x);
  b.y = tf32_rna(v.y); s.y = tf32_rna(v.y - b.y);
  b.z = tf32_rna(v.z); s.z = tf32_rna(v.z - b.z);
  b.w = tf32_rna(v.w); s.w = tf32_rna(v.w - b.w);
}

// wgmma shared-memory descriptor of a K-major operand with the 128-byte
// swizzle: rows of 128 bytes (32 fp32), 8-row atoms of 1,024 bytes stacked
// along M or N (stride byte offset 1,024); the leading byte offset is
// unused for this layout (encoded 1). `saddr` is the address of the
// operand's first row at the wanted K offset (a multiple of 32 bytes
// inside a 1,024-byte aligned atom).
__device__ __forceinline__ uint64_t smem_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFFu) >> 4)
         | (static_cast<uint64_t>(1) << 16)
         | (static_cast<uint64_t>(1024 >> 4) << 32)
         | (static_cast<uint64_t>(1) << 62);
}

// byte offset of the 16-byte chunk c (of 8) of row r in a 128-byte-swizzled
// tile whose base is 1,024-byte aligned
__device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// 16-byte load through the read-only path, zeros where `valid` is false;
// predicated, so nothing waits for it before its registers are read (a
// select after the load would wait for it at once)
__device__ __forceinline__ float4 ldg16(const float* p, bool valid) {
  float4 v;
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %5, 0;\n"
      "mov.f32 %0, 0f00000000;\nmov.f32 %1, 0f00000000;\n"
      "mov.f32 %2, 0f00000000;\nmov.f32 %3, 0f00000000;\n"
      "@q ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];\n}\n"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p), "r"(static_cast<int>(valid)));
  return v;
}

// PyTorch's exact GELU, in its order of operations
__device__ __forceinline__ float gelu_erf(float v) {
  return v * 0.5f * (1.0f + erff(v * 0.70710678118654752f));
}

// D(64 x N) = A(64 x 8) B(8 x N) + (scale_d ? D : 0), tf32 inputs from
// shared memory, fp32 accumulators; thread t of the warpgroup holds
// D[16 (t/32) + (t%32)/4 + 8 ((i/2)%2)][8 (i/4) + 2 (t%4) + i%2] in d[i]
template <int N>
struct Wgmma;

template <>
struct Wgmma<72> {
  __device__ __forceinline__ static void mma(float (&d)[36], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n72k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35 "
        "}, %36, %37, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<96> {
  __device__ __forceinline__ static void mma(float (&d)[48], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47 "
        "}, %48, %49, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63 "
        "}, %64, %65, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<144> {
  __device__ __forceinline__ static void mma(float (&d)[72], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %74, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n144k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71 "
        "}, %72, %73, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

struct Groups {
  const float* w[kMaxGroups];
  const float* b[kMaxGroups];
  float* y[kMaxGroups];
};

template <typename T>
__device__ __forceinline__ T pick(int g, T a, T b, T c) {
  return g == 0 ? a : (g == 1 ? b : c);
}

template <int BX>
__global__ void __launch_bounds__(kThreads, 1)
linear_3xtf32_kernel(const float* __restrict__ x, const Groups grp, int M,
                     int N, int K, int tiles_n, int gelu) {
  constexpr int kAcc = BX / 2;                  // accumulators a thread
  constexpr int kXBytes = BX * kTileK * 4;      // one x tile
  constexpr int kStage = 2 * kWBytes + 2 * kXBytes;
  constexpr int kXChunks = (BX * 8 + kThreads - 1) / kThreads;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int m0 = blockIdx.x * BX;
  const int g = blockIdx.y / tiles_n;
  const int n0 = (blockIdx.y - g * tiles_n) * kTileN;
  const float* __restrict__ w = pick(g, grp.w[0], grp.w[1], grp.w[2]);
  const int n_k = (K + kTileK - 1) / kTileK;
  const int c = tid % 8;                        // this thread's chunk column
  const int r0 = tid / 8;                       // its first row; then +32

  float4 wr[kWChunks], xr[kXChunks];
  auto load = [&](int kt) {
    const int k = kt * kTileK + 4 * c;
#pragma unroll
    for (int i = 0; i < kWChunks; ++i) {
      const int n = n0 + r0 + 32 * i;
      const bool ok = k < K && n < N;
      wr[i] = ldg16(w + (ok ? static_cast<size_t>(n) * K + k : 0), ok);
    }
#pragma unroll
    for (int i = 0; i < kXChunks; ++i) {
      const int r = r0 + 32 * i;
      const int m = m0 + r;
      const bool ok = k < K && r < BX && m < M;
      xr[i] = ldg16(x + (ok ? static_cast<size_t>(m) * K + k : 0), ok);
    }
  };
  auto store = [&](int slot) {
    uint8_t* st = smem + slot * kStage;
    float4 b, s;
#pragma unroll
    for (int i = 0; i < kWChunks; ++i) {
      const int off = swz(r0 + 32 * i, c);
      split4(wr[i], b, s);
      *reinterpret_cast<float4*>(st + off) = b;
      *reinterpret_cast<float4*>(st + kWBytes + off) = s;
    }
#pragma unroll
    for (int i = 0; i < kXChunks; ++i) {
      const int r = r0 + 32 * i;
      if (r < BX) {
        const int off = 2 * kWBytes + swz(r, c);
        split4(xr[i], b, s);
        *reinterpret_cast<float4*>(st + off) = b;
        *reinterpret_cast<float4*>(st + kXBytes + off) = s;
      }
    }
  };

  // a stage's products start afresh in `part`; `acc` sums the parts
  float acc[kAcc], part[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = part[i] = 0.0f;

  load(0);
  store(0);
  if (n_k > 1) load(1);
  fence_proxy_async();
  __syncthreads();

  for (int kt = 0; kt < n_k; ++kt) {
    const uint32_t st = smem_u32(smem + (kt & 1) * kStage);
    const uint32_t wb = st + wg * 64 * 128;     // this warpgroup's features
    const uint32_t ws = wb + kWBytes;
    const uint32_t xb = st + 2 * kWBytes;
    const uint32_t xs = xb + kXBytes;
#pragma unroll
    for (int i = 0; i < kAcc; ++i) fence_operand(part[i]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kTileK / 8; ++ks) {
      const uint32_t off = ks * 32;             // 8 K-values of a row
      // the small cross terms first, then big x big; the stage's first
      // product (ks 0) starts the part afresh
      Wgmma<BX>::mma(part, smem_desc(ws + off), smem_desc(xb + off), ks);
      Wgmma<BX>::mma(part, smem_desc(wb + off), smem_desc(xs + off), 1);
      Wgmma<BX>::mma(part, smem_desc(wb + off), smem_desc(xb + off), 1);
    }
    wgmma_commit();
    // while the products run: the next stage into the other buffer (every
    // warpgroup's products on it were done before the last barrier), and
    // the loads of the one after. (A chunk-by-chunk form of these stores
    // and loads, interleaved with the issue of the products, made ptxas
    // inject warpgroup.arrive fences (C7519); it, and the same form after
    // the products, ran 1.7x slower on the H100.)
    if (kt + 1 < n_k) {
      store((kt + 1) & 1);
      if (kt + 2 < n_k) load(kt + 2);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      fence_operand(part[i]);
      acc[i] += part[i];
    }
    fence_proxy_async();
    __syncthreads();
  }

  // the tile back to rows of x: ys[m][n]
  float* ys = reinterpret_cast<float*>(smem);
  {
    const int wp = (tid % 128) / 32, l = tid % 32;
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int n = wg * 64 + 16 * wp + l / 4 + 8 * ((i / 2) % 2);
      const int m = 8 * (i / 4) + 2 * (l % 4) + (i % 2);
      ys[m * kYs + n] = acc[i];
    }
  }
  __syncthreads();
  const float* __restrict__ bias = pick(g, grp.b[0], grp.b[1], grp.b[2]);
  float* __restrict__ y = pick(g, grp.y[0], grp.y[1], grp.y[2]);
  for (int idx = tid; idx < BX * (kTileN / 4); idx += kThreads) {
    const int r = idx / (kTileN / 4), q = idx % (kTileN / 4);
    const int m = m0 + r, n = n0 + 4 * q;
    if (m >= M || n >= N) continue;
    float4 v = *reinterpret_cast<const float4*>(ys + r * kYs + 4 * q);
    if (bias != nullptr) {
      const float4 bb = __ldg(reinterpret_cast<const float4*>(bias + n));
      v.x += bb.x; v.y += bb.y; v.z += bb.z; v.w += bb.w;
    }
    if (gelu) {
      v.x = gelu_erf(v.x); v.y = gelu_erf(v.y);
      v.z = gelu_erf(v.z); v.w = gelu_erf(v.w);
    }
    *reinterpret_cast<float4*>(y + static_cast<size_t>(m) * N + n) = v;
  }
}

// the row tiles the kernel is compiled for
constexpr int kTiles[] = {72, 96, 128, 144};

// Modelled clocks of one stage of a 128 x BX block: the larger of its
// products on the tensor cores (24 wgmma.m64nBXk8 at 1,024 TF32
// multiply-adds a clock: 12 BX) and its shared-memory traffic at 128
// bytes a clock (the products read 24 x (2,048 + 32 BX) bytes, the split
// stores 2 x (128 + BX) x 128: 640 + 8 BX).
long long stage_clocks(int bx) {
  const long long mma = 12LL * bx, smem = 640LL + 8LL * bx;
  return mma > smem ? mma : smem;
}

// The row tile of least modelled time: waves of one block per SM, each
// wave the stages of one block plus two for its prologue and epilogue.
int pick_tile(int M, int N, int K, int groups, int sms) {
  const long long n_k = (K + kTileK - 1) / kTileK;
  const long long tiles_n = static_cast<long long>(groups)
                            * ((N + kTileN - 1) / kTileN);
  int best = kTiles[0];
  long long best_t = -1;
  for (int bx : kTiles) {
    const long long blocks = tiles_n * ((M + bx - 1LL) / bx);
    const long long waves = (blocks + sms - 1) / sms;
    const long long t = waves * (n_k + 2) * stage_clocks(bx);
    if (best_t < 0 || t < best_t) {
      best = bx;
      best_t = t;
    }
  }
  return best;
}

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t q = cudaGetDevice(&dev);
  if (q == cudaSuccess)
    q = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return static_cast<int>(q);
}

template <int BX>
int launch(const float* x, const Groups& grp, int M, int N, int K,
           int groups, int gelu, cudaStream_t st) {
  constexpr int kStage = 2 * kWBytes + 2 * BX * kTileK * 4;
  static_assert(BX % 8 == 0 && BX <= 256, "wgmma N");
  static_assert(BX * kYs * 4 <= 2 * kStage, "epilogue tile fits the stages");
  constexpr int kSmem = 2 * kStage + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      linear_3xtf32_kernel<BX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_n = (N + kTileN - 1) / kTileN;
  dim3 grid(static_cast<unsigned>((M + BX - 1LL) / BX), groups * tiles_n);
  linear_3xtf32_kernel<BX><<<grid, kThreads, kSmem, st>>>(
      x, grp, M, N, K, tiles_n, gelu);
  return static_cast<int>(cudaGetLastError());
}

bool valid(int M, int N, int K, int groups) {
  return M >= 0 && N > 0 && K > 0 && N % 4 == 0 && K % 4 == 0
         && groups >= 1 && groups <= kMaxGroups
         && static_cast<long long>(groups) * ((N + kTileN - 1) / kTileN)
                <= 65535;
}

}  // namespace

// The row tile km_linear_3xtf32 picks for this shape on the current
// device (72, 96, 128 or 144), or minus a cudaError_t.
extern "C" int km_linear_tile(int M, int N, int K, int groups,
                              void* stream) {
  (void)stream;
  if (!valid(M, N, K, groups))
    return -static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  const int q = sm_count(&sms);
  if (q != 0) return -q;
  return pick_tile(M, N, K, groups, sms);
}

// y_g = x W_g^T + b_g for g < groups (1 to 3), each optionally followed by
// the exact GELU. x (M, K), W_g (N, K), b_g (N,) or null, y_g (M, N): all
// float32, contiguous, 16-byte aligned, on the current device; N and K
// multiples of 4. The row tile is the cost model's (pick_tile). Launches
// on `stream` and returns the first error (cudaError_t).
extern "C" int km_linear_3xtf32(const float* x, const float* w0,
                                const float* b0, float* y0, const float* w1,
                                const float* b1, float* y1, const float* w2,
                                const float* b2, float* y2, int M, int N,
                                int K, int groups, int gelu,
                                void* stream) {
  if (!valid(M, N, K, groups))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  int sms = 0;
  const int q = sm_count(&sms);
  if (q != 0) return q;
  const int tile = pick_tile(M, N, K, groups, sms);
  const Groups grp{{w0, w1, w2}, {b0, b1, b2}, {y0, y1, y2}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 72: return launch<72>(x, grp, M, N, K, groups, gelu, st);
    case 96: return launch<96>(x, grp, M, N, K, groups, gelu, st);
    case 128: return launch<128>(x, grp, M, N, K, groups, gelu, st);
    case 144: return launch<144>(x, grp, M, N, K, groups, gelu, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
