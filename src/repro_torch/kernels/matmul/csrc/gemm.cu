// Tiled GEMM for Hopper (sm_90a): C = op(A) @ B.  bfloat16 operands run on
// the tensor cores (mma.sync), float32 operands on the FMA units.
//
// Replaces the two Pallas TPU kernel bodies of the JAX package,
// src/repro/kernels/matmul/matmul.py::_mm_kernel_scratch and
// ::_mm_kernel_inplace, both built by make_matmul there.  The TPU kernels
// differ only in where the float32 sum lives (a scratch buffer or the
// output block, ACC_IN_OUTPUT); here it lives in registers either way, so
// one build serves both.
//
// One compiled library per configuration: the tunables arrive as -D
// defines (CLTune's model of recompiling the OpenCL source with new
// #defines), and the Python wrapper in ../matmul.py builds, loads and
// launches it.
//
//   BLOCK_M, BLOCK_N, BLOCK_K  output tile owned by one block; K step
//   GRID_NM        0: blockIdx.x walks N ('mn'); 1: blockIdx.x walks M ('nm')
//   INNER_STEPS    each BLOCK_K step is split into INNER_STEPS sub-dots
//   ACC_BF16       the running sum is rounded to bfloat16 after every sub-dot
//                  (the sub-dot's own result is rounded first), as the TPU
//                  kernel's bfloat16 accumulator does
//   TRANS_A        A arrives (K, M) and op(A) = A^T
//   IN_BF16        A, B and C are bfloat16 (else float32); products and
//                  sums are float32
//   PIPELINE_DEPTH shared-memory stages of A and B slices (default 2)
//   RAGGED         1: the block is not what the threads tile, or its slices
//                  are not whole 16-byte chunks (matmul.py::ragged); the
//                  build then names its tile:
//   TILE_M, TILE_N, TILE_K  the tile the threads cover (matmul.py::tile):
//                  the block rounded up to the micro-tile (float32) or to
//                  the mma tiles (bfloat16)
//   K_SEG, K_SUB   a K slice's tile columns come in segments of K_SEG, each
//                  holding K_SUB of the block's depth (matmul.py::k_segments:
//                  in bfloat16 a sub-dot that ends off an 8-deep mma step
//                  gets a zero-padded segment of its own)
//
// Ragged blocks (RAGGED): the grid keeps one block per config block (BLOCK_M
// rows, BLOCK_N columns, K steps of BLOCK_K); the threads cover the tile.
// Every element of a stage is copied on its own, zero outside the block:
// 4-byte cp.async with src-size 0 for the zeros in float32, plain loads and
// stores in bfloat16 (2-byte elements).  The tile past the block would hold
// the next block's rows, columns or depth, so it is never read from memory:
// zeros there add nothing to a sum, and their outputs are not stored (one
// element a store, inside the block).  Such builds are correct at any block
// (a prime dim takes blocks of 1) and slow; every other build is unchanged.
//
// Both builds stage their operands the same way: a ring of PIPELINE_DEPTH
// stages of A and B slices, filled with cp.async 16-byte copies.  The
// copies of slice t + PIPELINE_DEPTH - 1 are in flight while slice t is
// multiplied, and each K step has one __syncthreads.  Each slice is copied
// as it lies, with no transpose: B k-major (BLOCK_K rows of BLOCK_N), A
// m-major (BLOCK_M rows of BLOCK_K) when A is (M, K) and k-major when
// TRANS_A.  The blocks run in parallel in no order, so the K loop inside
// each block takes the place of the TPU grid's sequential K dimension.
//
// bfloat16 (IN_BF16): the tensor-core route, as the TPU kernel's bfloat16
// blocks go to the MXU (jnp.dot with preferred_element_type).  A
// bfloat16 x bfloat16 product is exact in the float32 accumulator, so the
// float32 tolerance argument against TF32 does not apply.  The work is
// 2*M*N*K operations at the H100's 989 TFLOP/s bfloat16 rate: ~0.017 ms at
// 2048^3, against ~0.008 ms for the bytes at 3.35 TB/s, so operations
// bound it.  Each warp owns a WM x WN warp tile of the block's output as
// float32 mma fragments (matmul.py::warp_tile: the largest of 64, 32 and
// 16 that divides half of BLOCK_M, and of BLOCK_N, where WN stops at 32
// under ACC_BF16, which keeps a second set of fragments for the sub-dot).
// Per 16-deep k step a warp loads its A rows with ldmatrix (.trans when A
// lies k-major) and its B columns with ldmatrix.trans, and issues
// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32; slices only 8 deep
// (BLOCK_K 8, or an 8-deep sub-dot) take m16n8k8.  The stages are stored
// unpadded, their 16-byte chunks XOR-swizzled by row (swz), so the 8 rows
// one ldmatrix reads fall on distinct banks.  A float32 sum does not
// depend on where the sub-dots end, so INNER_STEPS changes the build only
// under ACC_BF16, where each sub-dot goes into fresh fragments that are
// rounded to bfloat16, added to the running sum, and the sum rounded: the
// TPU kernel's rounding points.  A sub-dot narrower than 8 (BLOCK_K /
// INNER_STEPS of 1, 2 or 4) multiplies the 8-deep fragments with the
// lanes outside it zeroed.  No wgmma, no TMA, no warp specialisation yet.
//
// float32: the FMA route (no tensor cores, no TF32: TF32 keeps about three
// digits and fails the f32 tolerance).  At 2048^3 the work is ~0.26 ms at
// the H100's 67 TFLOP/s, while the bytes take ~0.015 ms at 3.35 TB/s, so
// FLOPs bound it.  The design keeps the FMA units fed from registers:
// each thread owns a TM x TN micro-tile of C in registers and reads its
// operands from shared memory 16 bytes at a time, doing TM*TN FMAs for
// (TM + TN)/4 loads a k; each C element is a sequential sum over k.  A
// k-major tile is read 16 bytes of m at one k.  An m-major tile is read
// 16 bytes of k at a time for each of the thread's TM rows, then used over
// those 4 k: the same loads per FMA, no transposing stores through
// registers (whose bank conflicts held the first kernel back), and the
// threads of a row group read one address (a broadcast).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#if !defined(BLOCK_M) || !defined(BLOCK_N) || !defined(BLOCK_K)
#error "BLOCK_M, BLOCK_N and BLOCK_K must be defined"
#endif
#ifndef GRID_NM
#define GRID_NM 0
#endif
#ifndef INNER_STEPS
#define INNER_STEPS 1
#endif
#ifndef ACC_BF16
#define ACC_BF16 0
#endif
#ifndef TRANS_A
#define TRANS_A 0
#endif
#ifndef IN_BF16
#define IN_BF16 0
#endif
#ifndef PIPELINE_DEPTH
#define PIPELINE_DEPTH 2
#endif

#ifndef RAGGED
#define RAGGED 0
#endif
#ifndef TILE_M
#define TILE_M BLOCK_M
#endif
#ifndef TILE_N
#define TILE_N BLOCK_N
#endif
#ifndef TILE_K
#define TILE_K BLOCK_K
#endif
#ifndef K_SEG
#define K_SEG TILE_K
#endif
#ifndef K_SUB
#define K_SUB BLOCK_K
#endif

// the block: the grid's step and the K loop's
constexpr int XM = BLOCK_M, XN = BLOCK_N, XK = BLOCK_K;
// the tile the threads cover (the block, unless RAGGED)
constexpr int BM = TILE_M, BN = TILE_N, BK = TILE_K;
constexpr int STAGES = PIPELINE_DEPTH;
constexpr int A_TILE = BM * BK, B_TILE = BK * BN;

static_assert(XK % INNER_STEPS == 0, "BLOCK_K divisible by INNER_STEPS");
static_assert(BM >= XM && BN >= XN && BK >= XK, "the tile covers the block");
static_assert(RAGGED || (BM == XM && BN == XN && BK == XK),
              "only a ragged build has a tile larger than its block");
static_assert(STAGES >= 2, "at least two stages");

__device__ __forceinline__ float round_bf16(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

#if RAGGED
// the block's depth of tile K column (or row) j of a slice, or -1 past its
// segment's depth
__device__ __forceinline__ int k_of(int j) {
    const int w = j % K_SEG;
    return w < K_SUB ? (j / K_SEG) * K_SUB + w : -1;
}
#endif

#if IN_BF16
// ---------------------------------------------------------------------------
// bfloat16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 elem_t;

// Warp geometry, derived from the block shape (matmul.py::warp_tile): the
// largest of 64, 32 and 16 that divides half the block side, else 16 (32
// at most for WN under ACC_BF16).  Two warps along each side of 32 or more
// keep four warps in a block of 64 x 64: one warp of 64 x 64 fragments
// there spills at the 255-register cap.
constexpr int WM = BM % 128 == 0 ? 64 : (BM % 64 == 0 ? 32 : 16);
constexpr int WN = (BN % 128 == 0 && !ACC_BF16) ? 64
                   : (BN % 64 == 0 ? 32 : 16);
constexpr int WARPS_M = BM / WM, WARPS_N = BN / WN;
constexpr int NTHREADS = 32 * WARPS_M * WARPS_N;
constexpr int MT = WM / 16;                   // m16 tiles of a warp
constexpr int NP = WN / 16;                   // pairs of n8 tiles of a warp
constexpr int NT = 2 * NP;                    // n8 tiles of a warp
// the k extent of one rounded sum: a sub-dot under ACC_BF16, else the slice
constexpr int SUB = ACC_BF16 ? BK / INNER_STEPS : BK;
constexpr int KD = SUB % 16 == 0 ? 16 : 8;    // mma depth
constexpr int A_ROW = TRANS_A ? BM : BK;      // elements in a row of A's tile
constexpr int SMEM_BYTES = STAGES * (A_TILE + B_TILE) * 2;

static_assert(BM % 16 == 0 && BN % 16 == 0 && BM % WM == 0 && BN % WN == 0,
              "BLOCK_M/BLOCK_N must be multiples of 16 (m16 x n16 tiles)");
static_assert(BK % 8 == 0, "BLOCK_K must be a multiple of 8");
static_assert(NTHREADS <= 1024, "at most 1024 threads per block");

// Element offset of 16-byte chunk c of row r in a tile of ROW-element rows.
// The chunk index is XORed with bits of the row, so the 8 consecutive rows
// one ldmatrix reads at one logical chunk land on 8 distinct 16-byte bank
// groups: with 8 or more chunks a row, the row's low 3 bits; with fewer,
// the bits of the row above those that pick its place in a 128-byte line.
//
// The XOR stays inside the row where the chunks of a row are a multiple of
// 8 or a power of two; other rows (48 or 112 elements, say) are stored as
// they are.
template <int ROW>
__device__ __forceinline__ int swz(int r, int c) {
    constexpr int CPR = ROW / 8;
    int x;
    if constexpr (CPR % 8 == 0)
        x = r & 7;
    else if constexpr ((CPR & (CPR - 1)) == 0)
        x = (r / (8 / CPR)) & (CPR - 1);
    else
        x = 0;
    return r * ROW + ((c ^ x) << 3);
}

// the 16-byte copies i = tid, tid + NTHREADS, ... < COPIES, each with
// copy(i): a loop of a fixed number of steps
template <int COPIES, typename F>
__device__ __forceinline__ void each_copy(int tid, F copy) {
#pragma unroll
    for (int j = 0; j < (COPIES + NTHREADS - 1) / NTHREADS; ++j) {
        const int i = tid + j * NTHREADS;
        if (COPIES % NTHREADS == 0 || i < COPIES) copy(i);
    }
}

#if RAGGED
// one K step's slices of A and B into one stage, element by element: the
// block's elements, zeros in the rest of the tile (the loops stay rolled,
// four loads in flight, so the loaded values do not crowd the fragments)
__device__ __forceinline__ void load_stage(
        elem_t* As, elem_t* Bs, const elem_t* __restrict__ A,
        const elem_t* __restrict__ B, int m0, int n0, int k0, int M, int N,
        int K, int tid) {
    const elem_t zero = __float2bfloat16_rn(0.f);
#if TRANS_A
#pragma unroll 4
    for (int i = tid; i < BK * BM; i += NTHREADS) {  // A (K, M): BK rows of BM
        const int r = i / BM, c = i % BM, k = k_of(r);
        As[swz<BM>(r, c >> 3) + (c & 7)] =
            k >= 0 && c < XM ? A[(size_t)(k0 + k) * M + m0 + c] : zero;
    }
#else
#pragma unroll 4
    for (int i = tid; i < BM * BK; i += NTHREADS) {  // A (M, K): BM rows of BK
        const int r = i / BK, c = i % BK, k = k_of(c);
        As[swz<BK>(r, c >> 3) + (c & 7)] =
            k >= 0 && r < XM ? A[(size_t)(m0 + r) * K + k0 + k] : zero;
    }
#endif
#pragma unroll 4
    for (int i = tid; i < BK * BN; i += NTHREADS) {  // B (K, N): BK rows of BN
        const int r = i / BN, c = i % BN, k = k_of(r);
        Bs[swz<BN>(r, c >> 3) + (c & 7)] =
            k >= 0 && c < XN ? B[(size_t)(k0 + k) * N + n0 + c] : zero;
    }
}
#else
// cp.async of one K step's slices of A and B into one stage
__device__ __forceinline__ void load_stage(
        elem_t* As, elem_t* Bs, const elem_t* __restrict__ A,
        const elem_t* __restrict__ B, int m0, int n0, int k0, int M, int N,
        int K, int tid) {
#if TRANS_A
    constexpr int A_CPR = BM / 8;             // A (K, M): BK rows of BM
    each_copy<BK * A_CPR>(tid, [&](int i) {
        const int r = i / A_CPR, c = i % A_CPR;
        cp_async16(As + swz<BM>(r, c), A + (size_t)(k0 + r) * M + m0 + c * 8);
    });
#else
    constexpr int A_CPR = BK / 8;             // A (M, K): BM rows of BK
    each_copy<BM * A_CPR>(tid, [&](int i) {
        const int r = i / A_CPR, c = i % A_CPR;
        cp_async16(As + swz<BK>(r, c), A + (size_t)(m0 + r) * K + k0 + c * 8);
    });
#endif
    constexpr int B_CPR = BN / 8;             // B (K, N): BK rows of BN
    each_copy<BK * B_CPR>(tid, [&](int i) {
        const int r = i / B_CPR, c = i % B_CPR;
        cp_async16(Bs + swz<BN>(r, c), B + (size_t)(k0 + r) * N + n0 + c * 8);
    });
}
#endif  // RAGGED

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const elem_t* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
                 "{%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const elem_t* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
                 "{%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2(unsigned (&r)[2], const elem_t* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_t(unsigned (&r)[2], const elem_t* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 "
                 "{%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)));
}

// d += a (16 x 16, row) * b (16 x 8, col), float32 accumulator
__device__ __forceinline__ void mma_k16(float (&d)[4], const unsigned (&a)[4],
                                        unsigned b0, unsigned b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16 x 8, row) * b (8 x 8, col), float32 accumulator
__device__ __forceinline__ void mma_k8(float (&d)[4], unsigned a0,
                                       unsigned a1, unsigned b0) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a0), "r"(a1), "r"(b0));
}

// A fragments of the warp's MT m16 tiles at k offset kk of the slice:
// 16 deep (a[.][0..3]) or 8 deep (a[.][0..1])
template <int D>
__device__ __forceinline__ void load_a(unsigned (&a)[MT][4], const elem_t* At,
                                       int wm0, int kk, int lane) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
        const int m = wm0 + mt * 16;
#if TRANS_A
        // k-major: rows k, chunks of 8 m; transposed on the way in
        const int kr = kk + (D == 16 ? (lane >> 4) * 8 : 0) + (lane & 7);
        const int mc = (m >> 3) + ((lane >> 3) & 1);
        if constexpr (D == 16) {
            ldsm_x4_t(a[mt], At + swz<A_ROW>(kr, mc));
        } else {
            unsigned r[2];
            ldsm_x2_t(r, At + swz<A_ROW>(kr, mc));
            a[mt][0] = r[0]; a[mt][1] = r[1];
        }
#else
        // m-major: rows m, chunks of 8 k
        const int mr = m + (lane & 15);
        const int kc = (kk >> 3) + (D == 16 ? (lane >> 4) : 0);
        if constexpr (D == 16) {
            ldsm_x4(a[mt], At + swz<A_ROW>(mr, kc));
        } else {
            unsigned r[2];
            ldsm_x2(r, At + swz<A_ROW>(mr, kc));
            a[mt][0] = r[0]; a[mt][1] = r[1];
        }
#endif
    }
}

// B fragments of the warp's NT n8 tiles at k offset kk: b[.][0..1] for 16
// deep, b[.][0] for 8 deep
template <int D>
__device__ __forceinline__ void load_b(unsigned (&b)[NT][2], const elem_t* Bt,
                                       int wn0, int kk, int lane) {
#pragma unroll
    for (int np = 0; np < NP; ++np) {
        const int n = wn0 + np * 16;
        if constexpr (D == 16) {
            const int kr = kk + ((lane >> 3) & 1) * 8 + (lane & 7);
            const int nc = (n >> 3) + (lane >> 4);
            unsigned r[4];
            ldsm_x4_t(r, Bt + swz<BN>(kr, nc));
            b[2 * np][0] = r[0]; b[2 * np][1] = r[1];
            b[2 * np + 1][0] = r[2]; b[2 * np + 1][1] = r[3];
        } else {
            const int kr = kk + (lane & 7);
            const int nc = (n >> 3) + ((lane >> 3) & 1);
            unsigned r[2];
            ldsm_x2_t(r, Bt + swz<BN>(kr, nc));
            b[2 * np][0] = r[0]; b[2 * np + 1][0] = r[1];
        }
    }
}

typedef float frag_t[MT][NT][4];

__device__ __forceinline__ void zero(frag_t& d) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) d[i][j][e] = 0.f;
}

// d += the product of the slice's k range [kk, kk + D)
template <int D>
__device__ __forceinline__ void mma_step(frag_t& d, const elem_t* At,
                                         const elem_t* Bt, int wm0, int wn0,
                                         int kk, int lane) {
    unsigned a[MT][4], b[NT][2];
    load_a<D>(a, At, wm0, kk, lane);
    load_b<D>(b, Bt, wn0, kk, lane);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            if constexpr (D == 16)
                mma_k16(d[i][j], a[i], b[j][0], b[j][1]);
            else
                mma_k8(d[i][j], a[i][0], a[i][1], b[j][0]);
        }
}

#if ACC_BF16
// acc = round(acc + round(part)), the TPU kernel's rounding points
__device__ __forceinline__ void add_rounded(frag_t& acc, const frag_t& part) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                acc[i][j][e] = round_bf16(acc[i][j][e]
                                          + round_bf16(part[i][j][e]));
}
#endif

__global__ void __launch_bounds__(NTHREADS)
gemm_kernel(const elem_t* __restrict__ A, const elem_t* __restrict__ B,
            elem_t* __restrict__ C, int M, int N, int K) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    elem_t* As = reinterpret_cast<elem_t*>(smem_raw);  // [STAGES][A_TILE]
    elem_t* Bs = As + STAGES * A_TILE;                  // [STAGES][BK][BN]

#if GRID_NM
    const int m0 = blockIdx.x * XM, n0 = blockIdx.y * XN;
#else
    const int n0 = blockIdx.x * XN, m0 = blockIdx.y * XM;
#endif
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int wm0 = (warp / WARPS_N) * WM, wn0 = (warp % WARPS_N) * WN;
    const int nk = K / XK;

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < nk)
            load_stage(As + s * A_TILE, Bs + s * B_TILE, A, B, m0, n0,
                       s * XK, M, N, K, tid);
        cp_async_commit();
    }

    frag_t acc;
    zero(acc);

    for (int t = 0; t < nk; ++t) {
        cp_async_wait<STAGES - 2>();          // slice t has landed
        __syncthreads();                      // ... for all; stage t-1 is free
        {
            const int nt = t + STAGES - 1;
            if (nt < nk)
                load_stage(As + (nt % STAGES) * A_TILE,
                           Bs + (nt % STAGES) * B_TILE, A, B, m0, n0,
                           nt * XK, M, N, K, tid);
            cp_async_commit();
        }
        const elem_t* At = As + (t % STAGES) * A_TILE;
        const elem_t* Bt = Bs + (t % STAGES) * B_TILE;
#if !ACC_BF16
#pragma unroll
        for (int kk = 0; kk < BK; kk += KD)
            mma_step<KD>(acc, At, Bt, wm0, wn0, kk, lane);
#else
        if constexpr (SUB >= 8) {
#pragma unroll
            for (int s = 0; s < BK / SUB; ++s) {
                frag_t part;
                zero(part);
#pragma unroll
                for (int kk = s * SUB; kk < (s + 1) * SUB; kk += KD)
                    mma_step<KD>(part, At, Bt, wm0, wn0, kk, lane);
                add_rounded(acc, part);
            }
        } else {
            // sub-dots narrower than the mma: each 8-deep chunk's fragments
            // are loaded once and multiplied 8 / SUB times, each time with
            // the k lanes outside one sub-dot zeroed.  A thread's 32-bit
            // fragment registers hold k = 2 * (lane % 4) (low half) and
            // that + 1 (high half).
#pragma unroll
            for (int kk = 0; kk < BK; kk += 8) {
                unsigned a[MT][4], b[NT][2];
                load_a<8>(a, At, wm0, kk, lane);
                load_b<8>(b, Bt, wn0, kk, lane);
                const int k_lo = 2 * (lane & 3);
#pragma unroll
                for (int off = 0; off < 8; off += SUB) {
                    const unsigned keep =
                        ((k_lo >= off && k_lo < off + SUB) ? 0x0000ffffu : 0u)
                        | ((k_lo + 1 >= off && k_lo + 1 < off + SUB)
                           ? 0xffff0000u : 0u);
                    frag_t part;
                    zero(part);
#pragma unroll
                    for (int i = 0; i < MT; ++i)
#pragma unroll
                        for (int j = 0; j < NT; ++j)
                            mma_k8(part[i][j], a[i][0] & keep,
                                   a[i][1] & keep, b[j][0] & keep);
                    add_rounded(acc, part);
                }
            }
        }
#endif
    }

    // the fragments' rows lane / 4 and lane / 4 + 8, columns 2 (lane % 4)
    // and the next: one bfloat16 pair a store (RAGGED: one element a
    // store, inside the block)
#pragma unroll
    for (int i = 0; i < MT; ++i) {
        const int row = m0 + wm0 + i * 16 + (lane >> 2);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            const int col = n0 + wn0 + j * 8 + 2 * (lane & 3);
#if RAGGED
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int r = row + 8 * (e >> 1), c = col + (e & 1);
                if (r - m0 < XM && c - n0 < XN)
                    C[(size_t)r * N + c] = __float2bfloat16_rn(acc[i][j][e]);
            }
#else
            *reinterpret_cast<__nv_bfloat162*>(C + (size_t)row * N + col) =
                __floats2bfloat162_rn(acc[i][j][0], acc[i][j][1]);
            *reinterpret_cast<__nv_bfloat162*>(C + (size_t)(row + 8) * N
                                               + col) =
                __floats2bfloat162_rn(acc[i][j][2], acc[i][j][3]);
#endif
        }
    }
}

#else
// ---------------------------------------------------------------------------
// float32: register micro-tiles on the FMA units
// ---------------------------------------------------------------------------

typedef float elem_t;

// Thread geometry, derived from the block shape (matmul.py::micro_tile): a
// TM x TN micro-tile per thread, held as TM/4 x TN/4 groups of 4 x 4.  Group
// g of a thread's rows starts at g * (BLOCK_M / (TM/4)) + 4 * ty, so the
// 16-byte shared-memory reads of neighbouring threads fall on neighbouring
// addresses.
constexpr int TM = XM >= 64 ? 8 : 4;
constexpr int TN = XN >= 64 ? 8 : 4;
constexpr int THREADS_M = BM / TM;
constexpr int THREADS_N = BN / TN;
constexpr int NTHREADS = THREADS_M * THREADS_N;
constexpr int GROUP_M = BM / (TM / 4);
constexpr int GROUP_N = BN / (TN / 4);
constexpr int SUB_K = BK / INNER_STEPS;
// k values an m-major A row is read in at once (4 unless a sub-dot is
// shorter)
constexpr int VK = SUB_K % 4 == 0 ? 4 : (SUB_K % 2 == 0 ? 2 : 1);
constexpr int VEC = 4;                        // elements in one 16-byte copy
constexpr int SMEM_BYTES = STAGES * (A_TILE + B_TILE) * 4;

static_assert(BM % TM == 0 && BN % TN == 0,
              "BLOCK_M/BLOCK_N must be multiples of the micro-tile");
static_assert(NTHREADS <= 1024, "at most 1024 threads per block");
static_assert(RAGGED || (BN % VEC == 0 && (TRANS_A ? BM : BK) % VEC == 0),
              "tile rows are whole 16-byte copies");

// W consecutive floats of shared memory: one 4-, 8- or 16-byte load
template <int W>
__device__ __forceinline__ void load_n(const float* p, float* out) {
    if constexpr (W == 4) {
        const float4 v = *reinterpret_cast<const float4*>(p);
        out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
    } else if constexpr (W == 2) {
        const float2 v = *reinterpret_cast<const float2*>(p);
        out[0] = v.x; out[1] = v.y;
    } else {
        out[0] = p[0];
    }
}

#if RAGGED
// 4 bytes, or zeros (src-size 0, nothing read) where `in` is false
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(s), "l"(src), "r"(in ? 4 : 0));
}

// cp.async of one K step's slices of A and B into one stage, element by
// element: the block's elements, zeros in the rest of the tile (the float32
// tile's depth is the block's)
__device__ __forceinline__ void load_stage(
        float* As, float* Bs, const float* __restrict__ A,
        const float* __restrict__ B, int m0, int n0, int k0, int M, int N,
        int K, int tid) {
#if TRANS_A
    for (int i = tid; i < BK * BM; i += NTHREADS) {  // A (K, M): BK rows of BM
        const int r = i / BM, c = i % BM;
        const bool in = c < XM;
        cp_async4(As + i, in ? A + (size_t)(k0 + r) * M + m0 + c : A, in);
    }
#else
    for (int i = tid; i < BM * BK; i += NTHREADS) {  // A (M, K): BM rows of BK
        const int r = i / BK, c = i % BK;
        const bool in = r < XM;
        cp_async4(As + i, in ? A + (size_t)(m0 + r) * K + k0 + c : A, in);
    }
#endif
    for (int i = tid; i < BK * BN; i += NTHREADS) {  // B (K, N): BK rows of BN
        const int r = i / BN, c = i % BN;
        const bool in = c < XN;
        cp_async4(Bs + i, in ? B + (size_t)(k0 + r) * N + n0 + c : B, in);
    }
}
#else
// cp.async of one K step's slices of A and B into one stage
__device__ __forceinline__ void load_stage(
        float* As, float* Bs, const float* __restrict__ A,
        const float* __restrict__ B, int m0, int n0, int k0, int M, int N,
        int K, int tid) {
#if TRANS_A
    constexpr int A_CPR = BM / VEC;           // A (K, M): BK rows of BM
    for (int i = tid; i < BK * A_CPR; i += NTHREADS) {
        const int r = i / A_CPR, c = i % A_CPR;
        cp_async16(As + r * BM + c * VEC,
                   A + (size_t)(k0 + r) * M + m0 + c * VEC);
    }
#else
    constexpr int A_CPR = BK / VEC;           // A (M, K): BM rows of BK
    for (int i = tid; i < BM * A_CPR; i += NTHREADS) {
        const int r = i / A_CPR, c = i % A_CPR;
        cp_async16(As + r * BK + c * VEC,
                   A + (size_t)(m0 + r) * K + k0 + c * VEC);
    }
#endif
    constexpr int B_CPR = BN / VEC;           // B (K, N): BK rows of BN
    for (int i = tid; i < BK * B_CPR; i += NTHREADS) {
        const int r = i / B_CPR, c = i % B_CPR;
        cp_async16(Bs + r * BN + c * VEC,
                   B + (size_t)(k0 + r) * N + n0 + c * VEC);
    }
}
#endif  // RAGGED

// two blocks of up to 256 threads on an SM: at most 128 registers each
// (a bfloat16 accumulator keeps a second tile, and a ragged build the
// element copies' addresses: they are left one block)
constexpr int MIN_BLOCKS = (NTHREADS <= 256 && !ACC_BF16 && !RAGGED) ? 2 : 1;

__global__ void __launch_bounds__(NTHREADS, MIN_BLOCKS)
gemm_kernel(const float* __restrict__ A, const float* __restrict__ B,
            float* __restrict__ C, int M, int N, int K) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* As = reinterpret_cast<float*>(smem_raw);    // [STAGES][A_TILE]
    float* Bs = As + STAGES * A_TILE;                  // [STAGES][BK][BN]

#if GRID_NM
    const int m0 = blockIdx.x * XM, n0 = blockIdx.y * XN;
#else
    const int n0 = blockIdx.x * XN, m0 = blockIdx.y * XM;
#endif
    const int tid = threadIdx.x;
    const int tx = tid % THREADS_N, ty = tid / THREADS_N;
    const int nk = K / XK;

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < nk)
            load_stage(As + s * A_TILE, Bs + s * B_TILE, A, B, m0, n0,
                       s * XK, M, N, K, tid);
        cp_async_commit();
    }

    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
#if ACC_BF16
    float part[TM][TN];
#endif

    for (int t = 0; t < nk; ++t) {
        cp_async_wait<STAGES - 2>();          // slice t has landed
        __syncthreads();                      // ... for all; stage t-1 is free
        {
            const int nt = t + STAGES - 1;
            if (nt < nk)
                load_stage(As + (nt % STAGES) * A_TILE,
                           Bs + (nt % STAGES) * B_TILE, A, B, m0, n0,
                           nt * XK, M, N, K, tid);
            cp_async_commit();
        }
        const float* At = As + (t % STAGES) * A_TILE;
        const float* Bt = Bs + (t % STAGES) * B_TILE;

#pragma unroll
        for (int s = 0; s < INNER_STEPS; ++s) {
#if ACC_BF16
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j) part[i][j] = 0.f;
#define SUM part
#else
#define SUM acc
#endif
#if TRANS_A
#pragma unroll 4
            for (int kk = s * SUB_K; kk < (s + 1) * SUB_K; ++kk) {
                float a[TM], b[TN];
#pragma unroll
                for (int g = 0; g < TM / 4; ++g)
                    load_n<4>(At + kk * BM + g * GROUP_M + 4 * ty, a + 4 * g);
#pragma unroll
                for (int g = 0; g < TN / 4; ++g)
                    load_n<4>(Bt + kk * BN + g * GROUP_N + 4 * tx, b + 4 * g);
#pragma unroll
                for (int i = 0; i < TM; ++i)
#pragma unroll
                    for (int j = 0; j < TN; ++j)
                        SUM[i][j] = fmaf(a[i], b[j], SUM[i][j]);
            }
#else
#pragma unroll
            for (int kk0 = s * SUB_K; kk0 < (s + 1) * SUB_K; kk0 += VK) {
                float a[TM][VK];
#pragma unroll
                for (int i = 0; i < TM; ++i)
                    load_n<VK>(At + ((i / 4) * GROUP_M + 4 * ty + i % 4) * BK
                               + kk0, a[i]);
#pragma unroll
                for (int e = 0; e < VK; ++e) {
                    float b[TN];
#pragma unroll
                    for (int g = 0; g < TN / 4; ++g)
                        load_n<4>(Bt + (kk0 + e) * BN + g * GROUP_N + 4 * tx,
                                  b + 4 * g);
#pragma unroll
                    for (int i = 0; i < TM; ++i)
#pragma unroll
                        for (int j = 0; j < TN; ++j)
                            SUM[i][j] = fmaf(a[i][e], b[j], SUM[i][j]);
                }
            }
#endif
#undef SUM
#if ACC_BF16
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j)
                    acc[i][j] = round_bf16(acc[i][j] + round_bf16(part[i][j]));
#endif
        }
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int row = m0 + (i / 4) * GROUP_M + 4 * ty + (i % 4);
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int col = n0 + (j / 4) * GROUP_N + 4 * tx + (j % 4);
#if RAGGED
            if (row - m0 < XM && col - n0 < XN)
#endif
            C[(size_t)row * N + col] = acc[i][j];
        }
    }
}
#endif  // IN_BF16

extern "C" {

// Launch on `stream` (a cudaStream_t) of CUDA device `device`; does not
// synchronise.  Returns a cudaError_t: 0 when the launch was accepted.
// The caller guarantees BLOCK_M | M, BLOCK_N | N, BLOCK_K | K (any block
// that divides its dim: matmul.py::ragged picks the build that masks its
// tile) and contiguous row-major operands on `device`, each starting on a
// 16-byte boundary; a ragged build reads rows at any alignment.
int gemm_launch(const void* a, const void* b, void* c, int M, int N, int K,
                int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(gemm_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
#if GRID_NM
    const dim3 grid(M / XM, N / XN);
#else
    const dim3 grid(N / XN, M / XM);
#endif
    gemm_kernel<<<grid, NTHREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
        (const elem_t*)a, (const elem_t*)b, (elem_t*)c, M, N, K);
    return (int)cudaGetLastError();
}

const char* gemm_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

int gemm_smem_bytes(void) { return SMEM_BYTES; }

int gemm_threads(void) { return NTHREADS; }

}  // extern "C"
