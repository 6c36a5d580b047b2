// VoxelPose's folded 7x7x7 front for Hopper (sm_90a): one kernel,
// front3d_kernel, with a plain C interface, loaded with ctypes by
// faster_voxelpose_tpu_torch/ops/front3d_kernels.py, which also holds its
// plain PyTorch version, the weight's packing and its launch counter.
//
//   fvp_front3d   x (N, C, X, Y, Z) float32, any strides, 1 <= C <= 32 ->
//                 relu(conv3d(bf16(x), w) + b) with a 7x7x7 kernel, zero
//                 padding 3, stride 1 and 16 output channels: float32 sums
//                 of the bf16 products, the bf16 bias added in float32,
//                 then ReLU and one rounding -> out (N, 16, X, Y, Z) bf16
//                 through its strides, 16 channels contiguous (the wrapper
//                 allocates channels-last-3d, (N, X, Y, Z, 16) in memory).
//
// It replaces no Pallas kernel: the JAX package has no V2VNet.  On the card
// the folded `ConvBNRelu` at the head of each of VoxelPose's V2VNets
// (models/blocks.py, rank 3, J = 15 joints in, 16 channels out) ran as
// three launches: the cast of the float32 cube to bf16, cuDNN's conv with
// its bias (sm80_xmma_fprop_implicit_gemm_indexed, 256x32x32 tiles: half of
// each 32-wide N tile idle at N = 16, its rows of 15 channels gathered tap
// by tap) and an in-place ReLU; the PRN's took 8.1 ms of a 17.5 ms PRN.
//
// Bound on an H100: operations.  16 * J * 343 multiply-adds a voxel, so
// 431.6 GFLOP on the PRN's ten 64^3 cubes and 21.1 on the CPN's 80x80x20
// space at J = 15, 0.458 ms a request at 989 TFLOP/s; the bytes (the
// float32 cubes in, the bf16 output) are 0.076 ms at 3.35 TB/s.
//
// Design.  An implicit GEMM per tap, M = output voxels, N = 16 output
// channels, K = the channels padded with zeros to 16 (or 32, two chunks),
// on mma.sync m16n8k16 (bf16 in, float32 sums) fed by ldmatrix:
// - A tile of outputs is 4 x 8 x 16 (x, y, z), a warp one x: 8 rows of 16
//   z voxels.  Its input footprint (10 x 14 x 22 voxels) is staged in
//   shared memory through the strides the cube arrives with, rounded to
//   bf16 on the way in, zero outside the cube and in the padded channels,
//   as 8-channel planes: a voxel is 16 bytes of a plane, so 8 consecutive
//   z voxels are one 128-byte 8x8 matrix that ldmatrix reads without bank
//   conflicts from any start z.  Every staged voxel serves up to 343 taps.
//   At KC = 1 a block takes 113,024 bytes and two blocks share an SM.
// - Persistent blocks, two an SM: block b runs tiles [b T / G, (b + 1) T
//   / G) of the T tiles in x-fastest order, so that the next tile along x
//   shares 6 of its 10 x slabs with this one.  The slabs live in 10 slots
//   in a ring; the next tile's 4 new slabs (10 at a change of row) are
//   loaded into registers at the start of a step and stored after its
//   products, a seventh of a slab a step, into slots this tile no longer
//   reads, so their loads wait behind the tensor work.  Only a block's
//   first tile, and the last 4 slabs at a change of row, are staged with
//   nothing to hide them.
// - The weight (343 taps x 16 x 16 bf16, 176 KB at KC = 1) streams through
//   a ring of 4 stages by cp.async, 3 stages ahead, one barrier a step: a
//   stage is the 7 taps (dy = 0..6) of one (dx, dz), packed at fold time
//   (front3d_kernels.pack_weight) as four 8x8 matrices a tap so that one
//   ldmatrix.x4 at lane * 16 bytes gives both 8-channel halves of B.
// - Reuse in registers.  For each (dx, dz) a warp holds the 7 taps' B
//   fragments and walks the 14 staged y rows: the A fragment of input row
//   y' (16 z voxels x 16 channels, one ldmatrix.x4) serves output row y' -
//   dy for each of the 7 dy, 112 mma a step against 21 ldmatrix.  (wgmma
//   would re-read B from shared memory on every 64 x 16 x 16 product, 512
//   bytes per 32 K flops, beside the A operand: at N = 16 its operand
//   traffic would reach shared memory's 128 bytes a clock before its tensor
//   rate.  mma.sync's own ceiling here is ~620 TFLOP/s, measured.)
// - The cube's shape picks the orientation: where the tiles cover it with
//   x and z swapped in fewer voxels (the CPN's 80 x 80 x 20: no ragged z
//   tile, 250 tiles for the 264 blocks of an H100), the wrapper passes the
//   strides and the weight packed for that (front3d_kernels._orientation).
// - Epilogue: the 8 x 16 x 16 float32 sums of a warp, plus the bias in
//   float32, ReLU, one rounding to bf16, stored as bf16 pairs through the
//   output's strides; ragged x, y and z tiles are masked.
// Each launch returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kKernel = 7, kPad = 3;
constexpr int kTX = kWarps, kTY = 8, kTZ = 16;  // output tile: a warp per x, 8 y rows of 16 z
constexpr int kSX = kTX + 2 * kPad, kSY = kTY + 2 * kPad, kSZ = kTZ + 2 * kPad;  // footprint
constexpr int kRowBytes = kSZ * 16;             // one (x, y) row of a plane
constexpr int kXBytes = kSY * kRowBytes;        // one x slab of a plane
constexpr int kPlane = kSX * kXBytes + 64;      // an 8-channel plane; the pad moves banks
constexpr int kSteps = kKernel * kKernel;       // (dx, dz) pairs, the weight ring's stages
constexpr int kStages = 4, kAhead = kStages - 1;
constexpr int kTapBytes = 512;                  // 16 x 16 bf16 of one tap and chunk
constexpr int kRowsPerPart = kSY / kKernel;     // a slab is staged in 7 parts of 2 y rows
constexpr int kMaxChannels = 32;
constexpr int kErrSharedMemory = -1;
static_assert(kRowsPerPart * kKernel == kSY, "a slab's y rows split into 7 parts");

template <int KC>
struct Plan {
  static constexpr int step_bytes = kKernel * KC * kTapBytes;  // the 7 dy taps of a (dx, dz)
  static constexpr int step_chunks = step_bytes / 16;          // its 16-byte copies
  static constexpr int chunks_per_thread = (step_chunks + kThreads - 1) / kThreads;
  static constexpr size_t smem = (size_t)2 * KC * kPlane + (size_t)kStages * step_bytes;
  static constexpr int pairs = 8 * KC;                         // channel pairs of a voxel
  static constexpr int row_items = kSZ * pairs;                // (z, pair) of one y row
  static constexpr int part_items = kRowsPerPart * row_items;  // a seventh of a slab
  static constexpr int per_part = (part_items + kThreads - 1) / kThreads;
};

// The problem in the kernel's axes (the wrapper may hand it the cube with
// x and z swapped, strides and weight to match): sizes, element strides of
// the float32 input and of the bf16 output (its 16 channels contiguous),
// and the tiles, x fastest, so that a block's consecutive tiles share slabs.
struct Problem {
  const float* x;
  const uint4* w;
  const __nv_bfloat16* bias;
  __nv_bfloat16* out;
  int C, X, Y, Z, tiles_x, tiles_y, tiles_z;
  long long tiles;
  long long sN, sC, sX, sY, sZ;
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

// a read-only load kept in program order with the asm around it, so that a
// load issued before a step's products is not sunk to its use after them
__device__ __forceinline__ float ldg_f32(const float* ptr) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];\n" : "=f"(v) : "l"(ptr));
  return v;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
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

// d += a (16 x 16, row) * b (16 x 8, col), bf16 operands, float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A thread's share of staging: a part (2 y rows) of one x slab of a tile's
// footprint, items (row, z, channel pair) with the pair fastest, the same
// per_part items a thread in every part.  What does not depend on the
// slab, the part or the tile's x and y is worked out once a tile.
template <int KC>
struct Stager {
  using P = Plan<KC>;
  const float* x;  // the tile's batch element
  int ox, oy;      // the footprint's origin in x and y
  uint32_t dst[P::per_part];
  int row[P::per_part];
  long long src[P::per_part];  // (z, channel) offset
  uint32_t live0, live1;       // bit u: item u's first / second channel is read

  __device__ __forceinline__ void setup(const Problem& p, const Tile& t) {
    x = p.x + t.n * p.sN;
    ox = t.tx * kTX - kPad;
    oy = t.ty * kTY - kPad;
    const int oz = t.tz * kTZ - kPad;
    live0 = live1 = 0;
#pragma unroll
    for (int u = 0; u < P::per_part; ++u) {
      const int k = threadIdx.x + u * kThreads;
      const int r = k / P::row_items, i = k - r * P::row_items;
      const int z = i / P::pairs, pair = i - z * P::pairs;
      const int gz = oz + z, c = 2 * pair;
      row[u] = r;
      // plane pair / 4 holds channels 8 (pair / 4) .. + 7; the pair sits at
      // bytes 4 (pair % 4) of the voxel's 16
      dst[u] = r * kRowBytes + z * 16 + (pair >> 2) * kPlane + (pair & 3) * 4;
      src[u] = gz * p.sZ + c * p.sC;
      const bool in = k < P::part_items && gz >= 0 && gz < p.Z;
      live0 |= (in && c < p.C) ? 1u << u : 0u;
      live1 |= (in && c + 1 < p.C) ? 1u << u : 0u;
    }
  }

  // load part `part` of footprint slab `slab` (x = ox + slab), bound for
  // slot `slot` of the planes: values into v, byte offsets into off
  __device__ __forceinline__ void load(const Problem& p, int slab, int slot, int part,
                                       float (&v)[P::per_part][2], uint32_t (&off)[P::per_part]) {
    const int gx = ox + slab;
    const bool xin = gx >= 0 && gx < p.X;
    const float* xs = x + gx * p.sX;
#pragma unroll
    for (int u = 0; u < P::per_part; ++u) {
      const int sy = part * kRowsPerPart + row[u], gy = oy + sy;
      const bool in = xin && gy >= 0 && gy < p.Y;
      const float* q = xs + gy * p.sY + src[u];
      v[u][0] = in && (live0 >> u & 1u) ? ldg_f32(q) : 0.0f;
      v[u][1] = in && (live1 >> u & 1u) ? ldg_f32(q + p.sC) : 0.0f;
      off[u] = slot * kXBytes + part * kRowsPerPart * kRowBytes + dst[u];
    }
  }

  // the loaded pairs rounded to bf16 into their planes (items past the
  // part's end are not stored)
  __device__ __forceinline__ void store(unsigned char* smem, const float (&v)[P::per_part][2],
                                        const uint32_t (&off)[P::per_part]) const {
#pragma unroll
    for (int u = 0; u < P::per_part; ++u)
      if (threadIdx.x + u * kThreads < P::part_items)
        *reinterpret_cast<__nv_bfloat162*>(smem + off[u]) = __floats2bfloat162_rn(v[u][0], v[u][1]);
  }

  // slabs [from, to) staged at once into slots (base + slab) % kSX
  __device__ __forceinline__ void slabs(const Problem& p, unsigned char* smem, int base, int from,
                                        int to) {
    for (int slab = from; slab < to; ++slab) {
      const int slot = (base + slab) % kSX;
      float v[kKernel][P::per_part][2];
      uint32_t off[kKernel][P::per_part];
#pragma unroll
      for (int part = 0; part < kKernel; ++part) load(p, slab, slot, part, v[part], off[part]);
#pragma unroll
      for (int part = 0; part < kKernel; ++part) store(smem, v[part], off[part]);
    }
  }
};

// KC: 16-channel chunks (1 for C <= 16, 2 for C <= 32).  Two blocks an SM
// at KC = 1, one at KC = 2 (the shared memory).  Persistent: block b takes
// tiles [b T / G, (b + 1) T / G) of the T tiles, G blocks.
template <int KC>
__global__ void __launch_bounds__(kThreads, KC == 1 ? 2 : 1) front3d_kernel(const Problem p) {
  using P = Plan<KC>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long first = blockIdx.x * p.tiles / gridDim.x;
  const long long last = (blockIdx.x + 1) * p.tiles / gridDim.x;
  if (first >= last) return;
  const uint32_t planes = smem_u32(smem);
  const uint32_t ring = planes + 2 * KC * kPlane;

  // The weight ring: step S of the block's run takes taps (S % 49) into
  // slot S % 4, this thread's chunks of it.
  uint32_t ring_dst[P::chunks_per_thread];
#pragma unroll
  for (int u = 0; u < P::chunks_per_thread; ++u) ring_dst[u] = (threadIdx.x + u * kThreads) * 16;
  auto ring_load = [&](int taps, int slot) {
    const uint4* src = p.w + (size_t)taps * P::step_chunks + threadIdx.x;
    const uint32_t dst = ring + slot * P::step_bytes;
#pragma unroll
    for (int u = 0; u < P::chunks_per_thread; ++u)
      if (threadIdx.x + u * kThreads < P::step_chunks)
        cp_async16(dst + ring_dst[u], src + u * kThreads);
  };
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    ring_load(s, s);
    cp_async_commit();
  }
  int ahead_taps = kAhead, ahead_slot = kAhead;  // the ring's next load
  int slot = 0;                                   // the ring's slot of this step

  // Footprint slab s of the current tile lives in slot (base + s) % kSX.
  Tile cur = tile_at(p, first);
  int base = 0;
  Stager<KC> st;
  st.setup(p, cur);
  st.slabs(p, smem, base, 0, kSX);

  // ldmatrix rows: lanes 0-7 rows 0-7 and 8-15 rows 8-15 of channels 0-7,
  // lanes 16-31 the same of channels 8-15 (the next plane); a row is the
  // z voxel z0 + row, shifted by the tap.
  const uint32_t a_lane = planes + ((lane & 7) + ((lane >> 3) & 1) * 8) * 16 + (lane >> 4) * kPlane;
  const int g = lane >> 2, t4 = lane & 3;
  float bv[2][2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    bv[h][0] = __bfloat162float(p.bias[h * 8 + 2 * t4]);
    bv[h][1] = __bfloat162float(p.bias[h * 8 + 2 * t4 + 1]);
  }

  for (long long t = first; t < last; ++t) {
    // The next tile: its footprint shares slabs 0-5 with this one's 4-9
    // when it is the next along x (`along`); its slabs not in place are
    // staged in this tile's steps, a slab a dx, into the slots freed.
    const bool more = t + 1 < last;
    Tile next = cur;
    bool along = false;
    if (more) {
      next = tile_at(p, t + 1);
      along = next.n == cur.n && next.ty == cur.ty && next.tz == cur.tz && next.tx == cur.tx + 1;
      st.setup(p, next);
      if (along) st.ox = cur.tx * kTX - kPad;  // slabs counted from this tile's origin
    }
    // dx = 1..4 (along: slabs 10-13 from this tile's origin, the next's
    // 6-9) or 1..6 (else: the next's slabs 0-5), into slot (base + dx - 1)
    const int stage_to = !more ? 0 : along ? 4 : 6;

    float acc[kTY][2][4];
#pragma unroll
    for (int y = 0; y < kTY; ++y)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[y][h][i] = 0.0f;

    for (int s = 0; s < kSteps; ++s) {
      cp_async_wait<kAhead - 1>();
      // this step's taps are in place, and so are the slabs its dx reads;
      // every warp is done with the slot the next load overwrites
      __syncthreads();
      ring_load(ahead_taps, ahead_slot);
      cp_async_commit();
      ahead_taps = ahead_taps + 1 == kSteps ? 0 : ahead_taps + 1;
      ahead_slot = ahead_slot + 1 == kStages ? 0 : ahead_slot + 1;
      const int dx = s / kKernel, dz = s - dx * kKernel;

      const bool staging = dx >= 1 && dx <= stage_to;
      float v[P::per_part][2];
      uint32_t off[P::per_part];
      if (staging) {
        const int slab = along ? dx + kSX - 1 : dx - 1;
        int dst = base + dx - 1;
        dst = dst >= kSX ? dst - kSX : dst;
        st.load(p, slab, dst, dz, v, off);
      }

      const uint32_t wslot = ring + slot * P::step_bytes + lane * 16;
      slot = slot + 1 == kStages ? 0 : slot + 1;
      uint32_t bf[kKernel][KC][4];
#pragma unroll
      for (int dy = 0; dy < kKernel; ++dy)
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) ldsm_x4(bf[dy][kc], wslot + (dy * KC + kc) * kTapBytes);
      int src_slot = base + warp + dx;  // this warp reads slab warp + dx
      src_slot = src_slot >= kSX ? src_slot - kSX : src_slot;
      const uint32_t a_step = a_lane + src_slot * kXBytes + dz * 16;
#pragma unroll
      for (int yi = 0; yi < kSY; ++yi) {
        uint32_t a[KC][4];
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) ldsm_x4(a[kc], a_step + yi * kRowBytes + kc * 2 * kPlane);
#pragma unroll
        for (int dy = 0; dy < kKernel; ++dy) {
          const int y = yi - dy;  // output row y reads input row y + dy
          if (y >= 0 && y < kTY) {
#pragma unroll
            for (int kc = 0; kc < KC; ++kc) {
              mma_bf16(acc[y][0], a[kc], bf[dy][kc][0], bf[dy][kc][1]);
              mma_bf16(acc[y][1], a[kc], bf[dy][kc][2], bf[dy][kc][3]);
            }
          }
        }
      }
      if (staging) st.store(smem, v, off);
    }

    // Epilogue: thread (g, t4) holds rows g and g + 8 (z), channels 2 t4,
    // 2 t4 + 1 of each 8-channel half: plus the bias, ReLU, one rounding.
    const int gx = cur.tx * kTX + warp;
    if (gx < p.X) {
      __nv_bfloat16* o = p.out + cur.n * p.oN + gx * p.oX;
#pragma unroll
      for (int y = 0; y < kTY; ++y) {
        const int gy = cur.ty * kTY + y;
        if (gy >= p.Y) continue;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int gz = cur.tz * kTZ + g + 8 * r;
          if (gz >= p.Z) continue;
          __nv_bfloat162* ov = reinterpret_cast<__nv_bfloat162*>(o + gy * p.oY + gz * p.oZ);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            ov[h * 4 + t4] = __floats2bfloat162_rn(fmaxf(acc[y][h][2 * r] + bv[h][0], 0.0f),
                                                   fmaxf(acc[y][h][2 * r + 1] + bv[h][1], 0.0f));
        }
      }
    }
    if (!more) break;
    if (along) {
      base = base + kTX >= kSX ? base + kTX - kSX : base + kTX;
    } else {
      // the next footprint's slabs 6-9 go where this tile's were read up
      // to its last step
      __syncthreads();
      st.slabs(p, smem, base, 6, kSX);
    }
    cur = next;
  }
  cp_async_wait<0>();
}

template <int KC>
int launch(Problem p, int N, cudaStream_t stream) {
  const size_t smem = Plan<KC>::smem;
  int dev = 0, most = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (smem > (size_t)most) return kErrSharedMemory;
  e = cudaFuncSetAttribute(front3d_kernel<KC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, front3d_kernel<KC>, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return kErrSharedMemory;
  p.tiles_x = (p.X + kTX - 1) / kTX;
  p.tiles_y = (p.Y + kTY - 1) / kTY;
  p.tiles_z = (p.Z + kTZ - 1) / kTZ;
  p.tiles = (long long)N * p.tiles_x * p.tiles_y * p.tiles_z;
  const long long grid = p.tiles < (long long)per_sm * sms ? p.tiles : (long long)per_sm * sms;
  front3d_kernel<KC><<<(unsigned)grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (N, C, X, Y, Z) float32 at element strides sN, sC, sX, sY, sZ; w the
// packed weight (7, 7, 7, KC, 2, 2, 8, 8) bf16 of one orientation of
// front3d_kernels.pack_weight (dx, dz, dy, chunk, output half, channel
// half, output, channel), 16-byte aligned; b (16,) bf16; out bf16 at
// element strides oN, oX, oY, oZ with its 16 channels contiguous, 4-byte
// aligned.  X, Y, Z are the kernel's axes: the wrapper may swap the cube's
// x and z, and pass the strides and the weight's orientation to match.
// 1 <= C <= 32 (KC = 1 up to 16 channels, else 2; the wrapper checks the
// packing against C).  Returns kErrSharedMemory (-1) when the device has
// too little shared memory per block, else the launch's CUDA error.  Safe
// to call while the stream is captured into a CUDA graph: the device
// queries, the occupancy query and cudaFuncSetAttribute are no stream work,
// and the kernel reads the weight and bias through their pointers, so a
// refold into the same buffers reaches a captured graph.
int fvp_front3d(const float* x, const void* w, const void* b, void* out, int N, int C, int X,
                int Y, int Z, long long sN, long long sC, long long sX, long long sY,
                long long sZ, long long oN, long long oX, long long oY, long long oZ,
                void* stream) {
  if (N <= 0 || X <= 0 || Y <= 0 || Z <= 0 || C <= 0 || C > kMaxChannels)
    return (int)cudaGetLastError();
  Problem p{x, static_cast<const uint4*>(w), static_cast<const __nv_bfloat16*>(b),
            static_cast<__nv_bfloat16*>(out), C, X, Y, Z, 0, 0, 0, 0, sN, sC, sX, sY, sZ,
            oN, oX, oY, oZ};
  const cudaStream_t st = (cudaStream_t)stream;
  return C <= 16 ? launch<1>(p, N, st) : launch<2>(p, N, st);
}

}  // extern "C"
