// VoxelPose's front_res head for Hopper (sm_90a): one kernel,
// front_res3d_kernel, with a plain C interface, loaded with ctypes by
// faster_voxelpose_tpu_torch/ops/front_res3d_kernels.py, which also holds
// its plain PyTorch version, the weights' packing and its launch counter.
//
//   fvp_front_res3d  x (N, 16, X, Y, Z) bf16, its 16 channels contiguous
//                    and each voxel on 16 bytes (front3d's output) ->
//                    h = relu(conv3d(x, W1) + b1), 3x3x3, zero padding 1,
//                    and s = conv3d(x, Ws) + bs, 1x1x1, 32 channels each:
//                    float32 sums of the bf16 products, the bias added in
//                    float32, one rounding to bf16 -> h and s (N, 32, X, Y,
//                    Z) bf16 through their strides, 32 channels contiguous
//                    (the wrapper allocates channels-last-3d).
//
// It replaces no Pallas kernel: the JAX package has no V2VNet.  On the card
// the head of the folded `ResBlock(16, 32)` that follows each of VoxelPose's
// 7x7x7 fronts (models/blocks.py, `UNetFront.front_res` at rank 3) ran as
// two cuDNN launches on its sm80 "indexed" implicit GEMM, which gathers
// the 16-channel rows tap by tap: the 3x3x3 conv1 with bias and ReLU and
// the 1x1x1 skip with its bias, 2.34 ms a request over the PRN's ten 64^3
// cubes and the CPN's 80x80x20 space.  The block's conv2 (32 -> 32, the
// skip as its shortcut) stays on cuDNN and reads h and s as it read them.
//
// Bound on an H100: bytes.  A voxel reads 16 bf16 channels and writes 2 x
// 32, 160 bytes, so 439.9 MB a request (2,749,440 voxels), 0.131 ms at
// 3.35 TB/s; its 2 * 32 * 16 * 28 = 28,672 operations are 78.8 GFLOP,
// 0.080 ms at 989 TFLOP/s (and 0.127 ms at mma.sync's ~620 TFLOP/s).
//
// Design.  An implicit GEMM per tap, M = output voxels, N = 32 output
// channels, K = the 16 channels, on mma.sync m16n8k16 (bf16 in, float32
// sums) fed by ldmatrix:
// - A tile of outputs is 4 x 8 x 16 (x, y, z), a warp one x: 8 rows of 16
//   z voxels.  Its input footprint (6 x 10 x 18 voxels) is copied into
//   shared memory by cp.async, 16 bytes a copy (zero-filled outside the
//   cube), as two 8-channel planes: a voxel is 16 bytes of a plane, so 8
//   consecutive z voxels are one 128-byte 8x8 matrix that ldmatrix reads
//   without bank conflicts from any start z.  Every staged voxel serves up
//   to 27 taps.
// - Persistent blocks, two an SM: block b runs tiles [b T / G, (b + 1) T
//   / G) of the T tiles in x-fastest order (neighbours share their
//   footprints in L2).  Two footprint buffers: the next tile's copies are
//   issued before this tile's products and land behind them.
// - The 27 taps' weights and the skip's (28 x 16 x 32 bf16, 28 KB),
//   packed at fold time (front_res3d_kernels.pack_weight) as 8x8 matrices
//   that one ldmatrix.x4 at lane * 16 bytes turns into B fragments, are
//   copied once a block and stay resident.  For each (dx, dz) a warp holds
//   the 3 dy taps' B fragments and walks the 10 staged y rows: the A
//   fragment of input row y' (16 z voxels x 16 channels, one ldmatrix.x4)
//   serves output row y' - dy for each of the 3 dy and 4 n8 tiles, 96 mma
//   a step against 16 ldmatrix.  (wgmma with A from shared memory would
//   read A again for every tap, 2 KB a 64 x 32 x 16 product, and bind on
//   shared memory near mma.sync's rate.  Measured on an H100, this kernel
//   is bound by its mma.sync work at about two thirds of that rate; wgmma
//   with these same A fragments from registers is the step after it.)
// - The skip is the centre tap's A fragments against its own B fragments:
//   x is read from device memory once for both outputs.  It runs first,
//   a row at a time with 16 sums live, so that its stores leave while the
//   128 sums of h accumulate.
// - The output bytes (352 of the 440 MB) set the bound, so each row of 16
//   voxels x 32 channels goes out in 16-byte writes of whole 8-channel
//   groups: stmatrix puts the rounded fragments into a warp's 1 KB of
//   shared memory (16-byte groups XOR-swizzled by z against bank
//   conflicts), and each lane writes two 16-byte groups, a warp 512
//   contiguous bytes a write.
// - The cube's shape picks the orientation: where the tiles cover it with
//   x and z swapped in fewer voxels (the CPN's 80 x 80 x 20: no ragged z
//   tile, 250 tiles), the wrapper passes the strides and the weight packed
//   for that (front3d_kernels._orientation, the same tile).  Ragged x, y
//   and z tiles are masked at the stores.
// Each launch returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTX = kWarps, kTY = 8, kTZ = 16;    // output tile: a warp per x, 8 y rows of 16 z
constexpr int kSX = kTX + 2, kSY = kTY + 2, kSZ = kTZ + 2;  // footprint (padding 1)
constexpr int kRowBytes = kSZ * 16;               // one (x, y) row of a plane
constexpr int kXBytes = kSY * kRowBytes;          // one x slab of a plane
constexpr int kPlane = kSX * kXBytes + 64;        // an 8-channel plane; the pad moves banks
constexpr int kFoot = 2 * kPlane;                 // a footprint: both planes
constexpr int kChunks = kSX * kSY * kSZ * 2;      // its 16-byte copies
constexpr int kChunksPerThread = (kChunks + kThreads - 1) / kThreads;
constexpr int kTaps = 27;
constexpr int kTapBytes = 1024;                   // 16 x 32 bf16 of one tap
constexpr int kWeightBytes = (kTaps + 1) * kTapBytes;  // the 27 taps, then the skip
constexpr int kWeightChunks = kWeightBytes / 16;
constexpr int kStageBytes = kTZ * 64;             // a warp's output row: 16 voxels x 32 bf16
constexpr size_t kSmem = (size_t)2 * kFoot + kWeightBytes + kWarps * kStageBytes;
constexpr int kErrSharedMemory = -1;

// The problem in the kernel's axes (the wrapper may hand it the cube with
// x and z swapped, strides and weight to match): sizes, element strides of
// the bf16 input (its 16 channels contiguous) and of the two bf16 outputs
// (their 32 channels contiguous), and the tiles, x fastest.
struct Problem {
  const __nv_bfloat16* x;
  const uint4* w;
  const __nv_bfloat16* b1;
  const __nv_bfloat16* bs;
  __nv_bfloat16* h;
  __nv_bfloat16* s;
  int X, Y, Z, tiles_x, tiles_y, tiles_z;
  long long tiles;
  long long sN, sX, sY, sZ;
  long long oN, oX, oY, oZ;
};

struct Tile {
  int n, tx, ty, tz;
};

__device__ __forceinline__ Tile tile_at(const Problem& p, long long t) {
  Tile r;
  r.tx = (int)(t % p.tiles_x);
  t /= p.tiles_x;
  r.ty = (int)(t % p.tiles_y);
  t /= p.tiles_y;
  r.tz = (int)(t % p.tiles_z);
  r.n = (int)(t / p.tiles_z);
  return r;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes from global to shared memory, the last 16 - bytes of them zero
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void stsm_x4(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2,
                                        uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

__device__ __forceinline__ uint4 lds_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 operands, float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// byte offset of output voxel z's 8-channel group c in a warp's row buffer
__device__ __forceinline__ uint32_t stage_offset(int z, int c) {
  return z * 64 + ((c ^ ((z >> 1) & 3)) << 4);
}

// Copy tile t's footprint into the footprint buffer at `buf`: items (x
// slab, y row, z, plane) with the plane fastest, so that consecutive
// threads read consecutive 16 bytes of the cube; zeros outside it.
__device__ __forceinline__ void stage_tile(const Problem& p, const Tile& t, uint32_t buf) {
  const __nv_bfloat16* xn = p.x + t.n * p.sN;
  const int ox = t.tx * kTX - 1, oy = t.ty * kTY - 1, oz = t.tz * kTZ - 1;
#pragma unroll
  for (int u = 0; u < kChunksPerThread; ++u) {
    const int k = threadIdx.x + u * kThreads;
    if (k < kChunks) {
      const int row = k / (2 * kSZ), i = k - row * (2 * kSZ);
      const int z = i >> 1, plane = i & 1;
      const int sx = row / kSY, sy = row - sx * kSY;
      const int gx = ox + sx, gy = oy + sy, gz = oz + z;
      const bool in = (unsigned)gx < (unsigned)p.X && (unsigned)gy < (unsigned)p.Y &&
                      (unsigned)gz < (unsigned)p.Z;
      const __nv_bfloat16* src = in ? xn + gx * p.sX + gy * p.sY + gz * p.sZ + plane * 8 : p.x;
      cp_async16(buf + plane * kPlane + sx * kXBytes + sy * kRowBytes + z * 16, src, in ? 16 : 0);
    }
  }
}

// One row of 16 z voxels x 32 channels of a warp's sums out: the bias
// already in, ReLU where asked, one rounding to bf16, through the warp's
// row buffer (stmatrix, then 16-byte groups) to `out` at voxel (gx, gy,
// tz * 16 ...), masked at the cube's edges.
template <bool RELU>
__device__ __forceinline__ void store_row(const float (&acc)[4][4], uint32_t stage,
                                          uint32_t st0, uint32_t st1, __nv_bfloat16* row,
                                          bool live, int z0, int Z, long long oZ, int lane) {
  uint32_t v[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lo = acc[nt][2 * r], hi = acc[nt][2 * r + 1];
      if (RELU) {
        lo = fmaxf(lo, 0.0f);
        hi = fmaxf(hi, 0.0f);
      }
      v[nt][r] = pack_bf16(lo, hi);
    }
  stsm_x4(st0, v[0][0], v[0][1], v[1][0], v[1][1]);
  stsm_x4(st1, v[2][0], v[2][1], v[3][0], v[3][1]);
  __syncwarp();
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    const int idx = pass * 32 + lane, z = idx >> 2, c = idx & 3;
    const uint4 q = lds_v4(stage + stage_offset(z, c));
    if (live && z0 + z < Z) *reinterpret_cast<uint4*>(row + (z0 + z) * oZ + c * 8) = q;
  }
  __syncwarp();
}

// Persistent: block b takes tiles [b T / G, (b + 1) T / G) of the T
// tiles, G blocks, two an SM.
__global__ void __launch_bounds__(kThreads, 2) front_res3d_kernel(const Problem p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long first = blockIdx.x * p.tiles / gridDim.x;
  const long long last = (blockIdx.x + 1) * p.tiles / gridDim.x;
  if (first >= last) return;
  const uint32_t foot = smem_u32(smem);  // two footprint buffers
  const uint32_t wsm = foot + 2 * kFoot;  // the 28 taps' weights
  const uint32_t stage = wsm + kWeightBytes + warp * kStageBytes;  // this warp's output row

  for (int c = threadIdx.x; c < kWeightChunks; c += kThreads) cp_async16(wsm + c * 16, p.w + c, 16);
  Tile cur = tile_at(p, first);
  stage_tile(p, cur, foot);
  cp_async_commit();

  // ldmatrix rows of A: lanes 0-7 z rows 0-7 and 8-15 rows 8-15 of
  // channels 0-7, lanes 16-31 the same of channels 8-15 (the next plane)
  const uint32_t a_lane = ((lane & 7) + ((lane >> 3) & 1) * 8) * 16 + (lane >> 4) * kPlane;
  const uint32_t b_lane = wsm + lane * 16;
  // stmatrix rows: lane's matrix m = lane / 8 is (n8 tile 2j + m / 2, z
  // half m % 2) of store j, its row lane % 8
  const int m = lane >> 3, zr = (m & 1) * 8 + (lane & 7);
  const uint32_t st0 = stage + stage_offset(zr, m >> 1);
  const uint32_t st1 = stage + stage_offset(zr, 2 + (m >> 1));
  // thread (g, t4) of a fragment holds channels 8 nt + 2 t4, + 1
  const int t4 = lane & 3;

  for (long long t = first; t < last; ++t) {
    const uint32_t buf = foot + (uint32_t)((t - first) & 1) * kFoot;
    const bool more = t + 1 < last;
    Tile next = cur;
    if (more) {
      next = tile_at(p, t + 1);
      stage_tile(p, next, foot + (uint32_t)((t + 1 - first) & 1) * kFoot);
    }
    cp_async_commit();  // possibly empty: this tile's copies are then the older group
    cp_async_wait<1>();
    __syncthreads();

    const int gx = cur.tx * kTX + warp, y0 = cur.ty * kTY, z0 = cur.tz * kTZ;
    const bool xin = gx < p.X;
    const long long xo = cur.n * p.oN + gx * p.oX;
    const uint32_t a_warp = buf + a_lane + warp * kXBytes;  // slab warp + dx, dx = 0

    {  // the skip: the centre tap (slab warp + 1, row y + 1, z + 1)
      uint32_t bk[2][4];
      ldsm_x4(bk[0], b_lane + kTaps * kTapBytes);
      ldsm_x4(bk[1], b_lane + kTaps * kTapBytes + 512);
      float bias[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        bias[nt][0] = __bfloat162float(p.bs[nt * 8 + 2 * t4]);
        bias[nt][1] = __bfloat162float(p.bs[nt * 8 + 2 * t4 + 1]);
      }
#pragma unroll 1
      for (int y = 0; y < kTY; ++y) {
        uint32_t a[4];
        ldsm_x4(a, a_warp + kXBytes + (y + 1) * kRowBytes + 16);
        float acc[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[nt][i] = bias[nt][i & 1];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          mma_bf16(acc[2 * hf], a, bk[hf][0], bk[hf][1]);
          mma_bf16(acc[2 * hf + 1], a, bk[hf][2], bk[hf][3]);
        }
        store_row<false>(acc, stage, st0, st1, p.s + xo + (y0 + y) * p.oY,
                         xin && y0 + y < p.Y, z0, p.Z, p.oZ, lane);
      }
    }

    // h: 27 taps, as 9 (dx, dz) steps of 3 dy taps each
    float acc[kTY][4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const float b0 = __bfloat162float(p.b1[nt * 8 + 2 * t4]);
      const float b1 = __bfloat162float(p.b1[nt * 8 + 2 * t4 + 1]);
#pragma unroll
      for (int y = 0; y < kTY; ++y) {
        acc[y][nt][0] = acc[y][nt][2] = b0;
        acc[y][nt][1] = acc[y][nt][3] = b1;
      }
    }
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
      for (int dz = 0; dz < 3; ++dz) {
        uint32_t bf[3][2][4];
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const uint32_t tap = b_lane + ((dx * 3 + dz) * 3 + dy) * kTapBytes;
          ldsm_x4(bf[dy][0], tap);
          ldsm_x4(bf[dy][1], tap + 512);
        }
        const uint32_t a_step = a_warp + dx * kXBytes + dz * 16;
#pragma unroll
        for (int yi = 0; yi < kSY; ++yi) {
          uint32_t a[4];
          ldsm_x4(a, a_step + yi * kRowBytes);
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            const int y = yi - dy;  // output row y reads input row y + dy
            if (y >= 0 && y < kTY) {
#pragma unroll
              for (int hf = 0; hf < 2; ++hf) {
                mma_bf16(acc[y][2 * hf], a, bf[dy][hf][0], bf[dy][hf][1]);
                mma_bf16(acc[y][2 * hf + 1], a, bf[dy][hf][2], bf[dy][hf][3]);
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int y = 0; y < kTY; ++y)
      store_row<true>(acc[y], stage, st0, st1, p.h + xo + (y0 + y) * p.oY,
                      xin && y0 + y < p.Y, z0, p.Z, p.oZ, lane);

    // every warp is done with `buf` before the next step restages it
    __syncthreads();
    cur = next;
  }
  cp_async_wait<0>();
}

int launch(Problem p, int N, cudaStream_t stream) {
  int dev = 0, most = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (kSmem > (size_t)most) return kErrSharedMemory;
  e = cudaFuncSetAttribute(front_res3d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kSmem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, front_res3d_kernel, kThreads,
                                                      kSmem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return kErrSharedMemory;
  p.tiles_x = (p.X + kTX - 1) / kTX;
  p.tiles_y = (p.Y + kTY - 1) / kTY;
  p.tiles_z = (p.Z + kTZ - 1) / kTZ;
  p.tiles = (long long)N * p.tiles_x * p.tiles_y * p.tiles_z;
  const long long grid = p.tiles < (long long)per_sm * sms ? p.tiles : (long long)per_sm * sms;
  front_res3d_kernel<<<(unsigned)grid, kThreads, kSmem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (N, 16, X, Y, Z) bf16 at element strides sN, sX, sY, sZ, its 16
// channels contiguous, 16-byte aligned and every stride a multiple of 8
// (the wrapper copies any other layout into channels-last-3d); w the packed
// weights (28, 4, 2, 8, 8) bf16 of one orientation of
// front_res3d_kernels.pack_weight (tap, n8 tile, channel half, output,
// channel; taps (dx, dz, dy) of conv1, then the skip), 16-byte aligned; b1,
// bs (32,) bf16; h and s bf16 at element strides oN, oX, oY, oZ, their 32
// channels contiguous, 16-byte aligned.  X, Y, Z are the kernel's axes: the
// wrapper may swap the cube's x and z, and pass the strides and the
// weights' orientation to match.  Returns kErrSharedMemory (-1) when the
// device has too little shared memory per block, else the launch's CUDA
// error.  Safe to call while the stream is captured into a CUDA graph: the
// device queries, the occupancy query and cudaFuncSetAttribute are no
// stream work, and the kernel reads the weights and biases through their
// pointers, so a refold into the same buffers reaches a captured graph.
int fvp_front_res3d(const void* x, const void* w, const void* b1, const void* bs, void* h,
                    void* s, int N, int X, int Y, int Z, long long sN, long long sX,
                    long long sY, long long sZ, long long oN, long long oX, long long oY,
                    long long oZ, void* stream) {
  if (N <= 0 || X <= 0 || Y <= 0 || Z <= 0) return (int)cudaGetLastError();
  Problem p{static_cast<const __nv_bfloat16*>(x), static_cast<const uint4*>(w),
            static_cast<const __nv_bfloat16*>(b1), static_cast<const __nv_bfloat16*>(bs),
            static_cast<__nv_bfloat16*>(h), static_cast<__nv_bfloat16*>(s), X, Y, Z, 0, 0, 0, 0,
            sN, sX, sY, sZ, oN, oX, oY, oZ};
  return launch(p, N, (cudaStream_t)stream);
}

}  // extern "C"
