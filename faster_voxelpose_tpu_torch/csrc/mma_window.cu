// Tensor-core cost of a windowed contraction, for Hopper (sm_90a): wgmma on
// tiles staged by TMA, in a persistent, warp-specialised kernel.
//
// One kernel template with a plain C interface, loaded with ctypes by
// faster_voxelpose_tpu_torch/ops/window_kernels.py, which also holds its
// plain PyTorch version, its launch counter and its launch plan
// (`mma_plan`: A stages, shared memory, grid), which it passes here.
//
//   fvp_mma_window  replaces the matrix-unit microbenchmark body of
//                   scripts/microbench_matmul.py:31 (called at :65): for
//                   each of B steps, a (K, M) window of a (128, M) bf16
//                   buffer at row 0 or at oy[b] (a multiple of 16) is
//                   contracted nmat times against rhs[b, :K] (K, N) bf16
//                   into a float32 (M, N) sum, of which the first 8 rows,
//                   times 1 / nmat, are written as bf16.
//
// Bound on an H100: operations, 2 * M * K * N * nmat * B against the bf16
// tensor cores' 989 TFLOP/s: at M = 640, N = 2048, B = 512, nmat = 5 that
// is 0.8685 ms at K = 128, 0.4343 at K = 64, 0.2171 at K = 32.  rhs, which
// is read once, is 268 MB at K = 128 (0.08 ms of device memory); lhs is
// 160 KB and lives in L2.
//
// Design.  The product of step b is D = A B with A = window^T (M x K, M
// contiguous in lhs: M-major) and B = rhs[b, :K] (K x N, N-major); wgmma
// takes both transposed forms for bf16 from shared memory.
// - Tiles of 128 rows x 256 columns.  A block has three warpgroups: thread
//   0 of warpgroup 0 issues every TMA load (the other producer warps only
//   give their registers back), warpgroups 1 and 2 each own 64 rows of the
//   tile and issue wgmma.mma_async m64n256k16 bf16 -> f32 on the staged
//   tiles, nmat * K / 16 of them per tile in one commit group.  The nmat
//   products are all issued on the same staged operands; none is replaced
//   by a multiply.
// - Operands come by TMA (cp.async.bulk.tensor) in boxes of 64 elements x K
//   rows, 128-byte swizzle: lhs through a 2-D map, rhs through a 3-D map
//   (N, 128, B).  A box's rows are the K rows of one 64-wide column block,
//   128 bytes each, so both operands are in the MN-major canonical layout of
//   wgmma: the descriptor's stride byte offset is 1024 (8 K rows), its
//   leading byte offset the size of one box (the next 64 columns), and one
//   k16 step moves its start by 2048 bytes.  The dynamic origin is the row
//   coordinate of the A boxes: a multiple of 16 starts on a whole 8-row
//   swizzle atom.  Ragged M and N: a box that reaches past the edge is
//   zero-filled by TMA; a box wholly past it is not loaded, its columns or
//   rows are never stored, and a warpgroup whose 64 rows lie wholly past M
//   issues no wgmma for that tile.
// - A ring of A stages and a ring of B stages on mbarriers (a full barrier
//   completed by the TMA's transaction bytes, an empty barrier by one
//   arrival of each of the 8 consumer warps after their wgmma.wait_group).
//   B takes two stages (kBStages), A as many as the device's shared memory
//   leaves (`mma_plan`): on an H100 3 at K = 128 (229,376 bytes of tiles),
//   8 at K = 64 and K = 32.  The stage buffers start on 1024 bytes.
// - Persistent blocks: one per SM (a block's 384 threads hold 168 registers
//   each under __launch_bounds__(384, 1); setmaxnreg moves them from the
//   producer, 40, to the consumers, 232).  A static scheduler lists the
//   B * ceil(N / 256) * ceil(M / 128) tiles in (step, column tile, row
//   tile) order and gives block i the run from i T / grid to
//   (i + 1) T / grid: 155 or 156 tiles of the tool's 20,480 on 132 blocks.
//   Within a run, a staged rhs tile (one unit: a step's 256 columns)
//   serves every row tile of its unit while lhs is re-read from L2; a unit
//   split between two blocks is loaded by both.  The producer runs ahead
//   through the rings across units.
//
// What bounded the warp-level (m16n16k16) kernel this one replaces, and
// what this one does instead: (1) only wgmma reaches the tensor cores' full
// rate on Hopper; (2) lhs no longer stays resident in shared memory (it
// took 166 KB, one block of 8 warps per SM): a stage holds a 128-row slice
// of the window and L2 serves the rest; (3) rhs is no longer loaded by
// every thread between two barriers: a producer thread keeps TMA loads of
// the next tiles in flight while the consumers compute; (4) no operand
// fragments are reloaded per 16-row tile and product: wgmma reads A and B
// from shared memory through descriptors; (5) one block per step gave
// 3.88 waves; the persistent grid splits the 20,480 tiles (at M = 640,
// N = 2048, B = 512) evenly over 132 blocks.
//
// Only 8 rows are stored; the other products stay computed because each
// wgmma is an asm volatile statement whose accumulators are read and
// written operands ("+f"), with scale-d a run-time predicate: the compiler
// cannot drop it, and the accumulator chain runs through every tile to the
// epilogue.  So no store under a never-set device flag is needed to keep
// them alive, as it was for the warp-level fragments.  The evidence that
// the work is done is kept by chip_smoke.py: time rises with K and with M,
// the rate stays under the bf16 peak, and the built library's SASS holds
// HGMMA instructions.
//
// Rows 0..7 of a tile with row 0 sit in warp 0 of the first consumer
// warpgroup: thread l holds row l / 4, columns 8 j + 2 (l % 4) + {0, 1} in
// accumulators 4 j and 4 j + 1 (the PTX ISA's m64nNk16 f32 fragment), so
// it writes one bf16 pair per j, each value __fmul_rn(sum, 1 / nmat).
// A dynamic origin that is not a multiple of 16 inside the buffer gives a
// step of NaN and loads nothing for it.
//
// The launch returns cudaGetLastError(), or the error of the shared-memory
// attribute call, or -1 for a K that is not instantiated, -2 for a plan
// whose A stages do not fit its shared memory, -3 when the CUDA driver has no
// cuTensorMapEncodeTiled, -4 when a tensor map cannot be encoded.  That
// entry point is taken through the CUDA runtime, so the library does not
// link libcuda.

#include <cuda.h>  // CUtensorMap and its enums; no CUDA driver call is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kRows = 128;     // rows of lhs and of one rhs step
constexpr int kTileM = 128;    // rows of a tile: two consumer warpgroups of 64
constexpr int kTileN = 256;    // columns of a tile: one m64n256k16 per k16 step
constexpr int kBox = 64;       // elements in a 128-byte swizzle row: a box is (64, K)
constexpr int kThreads = 384;  // warpgroup 0 loads, warpgroups 1 and 2 compute
constexpr int kConsumerWarps = 8;
constexpr int kAlign = 1024;   // a 128-byte swizzle atom: 8 rows of 128 bytes
constexpr int kMaxAStages = 8;
constexpr int kBStages = 2;    // one rhs tile in use, the next one loading

size_t smem_bytes(int K, int a_stages) {
  // slack to align the stage buffers, the stages, and two barriers per stage
  return kAlign + (size_t)a_stages * kTileM * K * 2 + (size_t)kBStages * kTileN * K * 2 +
         (size_t)16 * (a_stages + kBStages);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// spin until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred p;\n"
      "FVP_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@!p bra FVP_WAIT;\n\t}" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                       int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                       int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma descriptor of an MN-major operand in 128-byte swizzle: start
// address, leading byte offset `lbo` (to the next 64 columns: one box),
// stride byte offset 1024 (to the next 8 K rows), layout type 1 (128B).
__device__ __forceinline__ uint64_t mn_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous wgmma
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A B for a 64 x 256 tile, A and B MN-major (both transposed)
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <bool DYN>
__device__ __forceinline__ bool bad_origin(int origin, int K) {
  return DYN && (origin < 0 || origin > kRows - K || (origin & 15));
}

template <int K, bool DYN>
__global__ void __launch_bounds__(kThreads, 1)
mma_window_kernel(__grid_constant__ const CUtensorMap lhs_map,  // lhs (128, M), box (64, K)
                  __grid_constant__ const CUtensorMap rhs_map,  // rhs (B, 128, N), box (64, K, 1)
                  const int* __restrict__ oy,                   // (B,) multiples of 16
                  bf16* __restrict__ out,                       // (B, 8, N)
                  int B, int M, int N, int nmat, float inv_nmat, int a_stages) {
  constexpr uint32_t kBoxBytes = kBox * K * 2;
  constexpr uint32_t kABytes = kTileM * K * 2, kBBytes = kTileN * K * 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t a_base = (smem_u32(smem_raw) + kAlign - 1) & ~(uint32_t)(kAlign - 1);
  const uint32_t b_base = a_base + a_stages * kABytes;
  // barriers: a_full[a_stages], a_empty[a_stages], b_full[kBStages], b_empty[kBStages]
  const uint32_t a_full = b_base + kBStages * kBBytes, a_empty = a_full + 8 * a_stages;
  const uint32_t b_full = a_empty + 8 * a_stages, b_empty = b_full + 8 * kBStages;

  // block i takes tiles [i T / grid, (i + 1) T / grid) of the T tiles in
  // (step, column tile, row tile) order: a run of whole or partial units
  const int n_tiles = (N + kTileN - 1) / kTileN, m_tiles = (M + kTileM - 1) / kTileM;
  const long long total = (long long)B * n_tiles * m_tiles;
  const int first = (int)(total * blockIdx.x / gridDim.x);
  const int last = (int)(total * (blockIdx.x + 1) / gridDim.x);
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < a_stages; ++s) {
      mbar_init(a_full + 8 * s, 1);
      mbar_init(a_empty + 8 * s, kConsumerWarps);
    }
    for (int s = 0; s < kBStages; ++s) {
      mbar_init(b_full + 8 * s, 1);
      mbar_init(b_empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // producer warpgroup: thread 0 issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid != 0) return;
    int sa = 0, sb = 0;
    uint32_t pa = 1, pb = 1;  // a fresh empty barrier's previous phase counts as complete
    for (int t = first; t < last;) {
      const int u = t / m_tiles, mt0 = t % m_tiles, mt1 = min(m_tiles, mt0 + last - t);
      t += mt1 - mt0;
      const int b = u / n_tiles, n0 = (u % n_tiles) * kTileN;
      const int origin = DYN ? oy[b] : 0;
      if (bad_origin<DYN>(origin, K)) continue;
      const int nbox = min(kTileN, N - n0) / kBox;  // N is a multiple of 64
      mbar_wait(b_empty + 8 * sb, pb);
      mbar_expect_tx(b_full + 8 * sb, nbox * kBoxBytes);
      for (int i = 0; i < nbox; ++i)
        tma_3d(b_base + sb * kBBytes + i * kBoxBytes, &rhs_map, b_full + 8 * sb, n0 + i * kBox, 0, b);
      if (++sb == kBStages) sb = 0, pb ^= 1;
      for (int mt = mt0; mt < mt1; ++mt) {
        const int m0 = mt * kTileM;
        const int mbox = (min(kTileM, M - m0) + kBox - 1) / kBox;  // a partial box is zero-filled
        mbar_wait(a_empty + 8 * sa, pa);
        mbar_expect_tx(a_full + 8 * sa, mbox * kBoxBytes);
        for (int h = 0; h < mbox; ++h)
          tma_2d(a_base + sa * kABytes + h * kBoxBytes, &lhs_map, a_full + 8 * sa, m0 + h * kBox, origin);
        if (++sa == a_stages) sa = 0, pa ^= 1;
      }
    }
    return;
  }

  // consumer warpgroups 1 and 2: 64 rows of each tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int c = tid / 128 - 1, warp = (tid / 32) % 4, lane = tid % 32;
  float d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.0f;
  int sa = 0, sb = 0;
  uint32_t pa = 0, pb = 0;
  for (int t = first; t < last;) {
    const int u = t / m_tiles, mt0 = t % m_tiles, mt1 = min(m_tiles, mt0 + last - t);
    t += mt1 - mt0;
    const int b = u / n_tiles, n0 = (u % n_tiles) * kTileN;
    const int width = min(kTileN, N - n0);
    const int origin = DYN ? oy[b] : 0;
    if (bad_origin<DYN>(origin, K)) {
      // not a window of lhs: the block with row tile 0 writes the unit's rows as NaN
      if (c == 0 && mt0 == 0)
        for (int i = tid - 128; i < 8 * width; i += 128)
          out[((size_t)b * 8 + i / width) * N + n0 + i % width] = __float2bfloat16_rn(nanf(""));
      continue;
    }
    mbar_wait(b_full + 8 * sb, pb);
    const uint32_t b_tile = b_base + sb * kBBytes;
    for (int mt = mt0; mt < mt1; ++mt) {
      mbar_wait(a_full + 8 * sa, pa);
      if (mt * kTileM + c * 64 < M) {
        const uint32_t a_tile = a_base + sa * kABytes + c * kBoxBytes;
        fence_acc(d);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll 1
        for (int r = 0; r < nmat; ++r) {
#pragma unroll
          for (int kk = 0; kk < K / 16; ++kk)
            wgmma_m64n256k16(d, mn_desc(a_tile + kk * 2048, kBoxBytes),
                             mn_desc(b_tile + kk * 2048, kBoxBytes), r > 0 || kk > 0);
        }
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
        fence_acc(d);
        if (mt == 0 && c == 0 && warp == 0) {
          // rows 0..7 of the sum, times 1 / nmat, as bf16
          bf16* o = out + ((size_t)b * 8 + lane / 4) * N + n0 + 2 * (lane % 4);
#pragma unroll
          for (int j = 0; j < kTileN / 8; ++j)
            if (8 * j < width)
              *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) =
                  __halves2bfloat162(__float2bfloat16_rn(__fmul_rn(d[4 * j], inv_nmat)),
                                     __float2bfloat16_rn(__fmul_rn(d[4 * j + 1], inv_nmat)));
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(a_empty + 8 * sa);
      if (++sa == a_stages) sa = 0, pa ^= 1;
    }
    if (lane == 0) mbar_arrive(b_empty + 8 * sb);
    if (++sb == kBStages) sb = 0, pb ^= 1;
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a bf16 tensor map with boxes of 64 elements x `rows` (x 1), 128-byte swizzle
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
            const cuuint64_t* strides, int rows) {
  const cuuint32_t box[3] = {(cuuint32_t)kBox, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank, const_cast<void*>(ptr), dims,
            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int K, bool DYN>
int launch(const bf16* lhs, const bf16* rhs, const int* oy, bf16* out, int B, int M, int N,
           int nmat, float inv_nmat, int a_stages, int grid, int smem, cudaStream_t st) {
  if (a_stages < 1 || a_stages > kMaxAStages || grid < 1 || (size_t)smem < smem_bytes(K, a_stages))
    return -2;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -3;
  CUtensorMap lhs_map, rhs_map;
  const cuuint64_t lhs_dims[2] = {(cuuint64_t)M, (cuuint64_t)kRows};
  const cuuint64_t lhs_strides[1] = {(cuuint64_t)M * 2};
  const cuuint64_t rhs_dims[3] = {(cuuint64_t)N, (cuuint64_t)kRows, (cuuint64_t)B};
  const cuuint64_t rhs_strides[2] = {(cuuint64_t)N * 2, (cuuint64_t)kRows * N * 2};
  if (!encode(fn, &lhs_map, lhs, 2, lhs_dims, lhs_strides, K) ||
      !encode(fn, &rhs_map, rhs, 3, rhs_dims, rhs_strides, K))
    return -4;
  auto kern = mma_window_kernel<K, DYN>;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<(unsigned)grid, kThreads, smem, st>>>(lhs_map, rhs_map, oy, out, B, M, N, nmat, inv_nmat,
                                               a_stages);
  return (int)cudaGetLastError();
}

// blocks of mma_window_kernel<K, false> that fit one SM with `smem` bytes
// of dynamic shared memory, by the runtime's occupancy calculator (its
// registers and shared memory as built)
template <int K>
int occupancy(int smem, int* blocks) {
  auto kern = mma_window_kernel<K, false>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern, kThreads, smem);
  return (int)e;
}

}  // namespace

extern "C" {

// lhs (128, M) bf16, rhs (B, 128, N) bf16, both starting on 16 bytes, oy
// (B,) int32 (read when dyn), out (B, 8, N) bf16; M a multiple of 16, N of
// 64.  inv_nmat is float32 1 / nmat.  a_stages, grid and smem are the
// launch plan (window_kernels.mma_plan).
int fvp_mma_window(const void* lhs, const void* rhs, const int* oy, void* out, int B, int M, int N,
                   int K, int dyn, int nmat, float inv_nmat, int a_stages, int grid, int smem,
                   void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  const bf16* l = static_cast<const bf16*>(lhs);
  const bf16* r = static_cast<const bf16*>(rhs);
  bf16* o = static_cast<bf16*>(out);
#define FVP_MMA(k)                                                                           \
  if (K == k)                                                                                \
    return dyn ? launch<k, true>(l, r, oy, o, B, M, N, nmat, inv_nmat, a_stages, grid, smem, st) \
               : launch<k, false>(l, r, oy, o, B, M, N, nmat, inv_nmat, a_stages, grid, smem, st)
  FVP_MMA(128);
  FVP_MMA(64);
  FVP_MMA(32);
#undef FVP_MMA
  return -1;
}

// the kernel's own layout on the current device, for the plan to be held
// against: out = {tile rows, tile columns, threads, dynamic shared memory
// of these A stages, B stages, blocks per SM at that shared memory}.
// Returns -1 for a K that is not instantiated, or the occupancy query's error.
int fvp_mma_layout(int K, int a_stages, int* out) {
  out[0] = kTileM;
  out[1] = kTileN;
  out[2] = kThreads;
  out[3] = (int)smem_bytes(K, a_stages);
  out[4] = kBStages;
  if (K == 128) return occupancy<128>(out[3], &out[5]);
  if (K == 64) return occupancy<64>(out[3], &out[5]);
  if (K == 32) return occupancy<32>(out[3], &out[5]);
  return -1;
}

// the current device's SM count, shared memory per SM, and the most
// dynamic shared memory one block may opt in to
int fvp_mma_device(int* sm_count, int* smem_per_sm, int* smem_per_block) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(smem_per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(smem_per_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)e;
}

}  // extern "C"
