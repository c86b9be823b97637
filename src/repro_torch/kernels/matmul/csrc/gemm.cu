// Tiled GEMM for Hopper (sm_90a): C = op(A) @ B in float32 FMA units.
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
//   IN_BF16        A, B and C are bfloat16 (else float32), staged in shared
//                  memory as they arrive; products and sums are float32
//   PIPELINE_DEPTH shared-memory stages of A and B slices (default 2)
//
// What bounds it: the work is 2*M*N*K float32 FLOPs on the FMA units (no
// tensor cores, no TF32: TF32 keeps about three digits and fails the f32
// tolerance).  At 2048^3 that is ~0.26 ms at the H100's 67 TFLOP/s, while
// the bytes (each input read once, the output written once) take ~0.015 ms
// at 3.35 TB/s, so FLOPs bound it.  The design keeps the FMA units fed from
// registers: each thread owns a TM x TN micro-tile of C in registers and
// reads its operands from shared memory 16 bytes at a time, doing TM*TN
// FMAs for (TM + TN)/4 loads a k (float32).  The blocks run in parallel in
// no order, so the K loop inside each block takes the place of the TPU
// grid's sequential K dimension; each C element is a sequential sum over k.
//
// Staging: a ring of PIPELINE_DEPTH stages of A and B slices, filled with
// cp.async 16-byte copies.  The copies of slice t + PIPELINE_DEPTH - 1 are
// in flight while the FMAs of slice t run, and each K step has one
// __syncthreads.  B is n-contiguous and is copied as it lies.  A is copied
// as it lies too, with no transpose: m-major (BLOCK_M rows of BLOCK_K) when
// A is (M, K), k-major when TRANS_A.  A k-major tile is read as before,
// 16 bytes of m at one k.  An m-major tile is read 16 bytes of k at a time
// for each of the thread's TM rows, then used over those 4 k: the same
// loads per FMA, no transposing stores through registers (whose bank
// conflicts held the first kernel back), and the threads of a row group
// read one address (a broadcast).  No wgmma, no TMA yet.

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

#if IN_BF16
typedef __nv_bfloat16 elem_t;
__device__ __forceinline__ float to_f32(elem_t x) { return __bfloat162float(x); }
__device__ __forceinline__ elem_t from_f32(float x) { return __float2bfloat16_rn(x); }
#else
typedef float elem_t;
__device__ __forceinline__ float to_f32(elem_t x) { return x; }
__device__ __forceinline__ elem_t from_f32(float x) { return x; }
#endif

// Thread geometry, derived from the block shape (matmul.py::micro_tile): a
// TM x TN micro-tile per thread, held as TM/4 x TN/4 groups of 4 x 4.  Group
// g of a thread's rows starts at g * (BLOCK_M / (TM/4)) + 4 * ty, so the
// 16-byte shared-memory reads of neighbouring threads fall on neighbouring
// addresses.
constexpr int BM = BLOCK_M, BN = BLOCK_N, BK = BLOCK_K;
constexpr int STAGES = PIPELINE_DEPTH;
constexpr int TM = BM >= 64 ? 8 : 4;
constexpr int TN = BN >= 64 ? 8 : 4;
constexpr int THREADS_M = BM / TM;
constexpr int THREADS_N = BN / TN;
constexpr int NTHREADS = THREADS_M * THREADS_N;
constexpr int GROUP_M = BM / (TM / 4);
constexpr int GROUP_N = BN / (TN / 4);
constexpr int SUB_K = BK / INNER_STEPS;
// k values an m-major A row is read in at once (4 unless a sub-dot is
// shorter)
constexpr int VK = SUB_K % 4 == 0 ? 4 : (SUB_K % 2 == 0 ? 2 : 1);
constexpr int ESZ = (int)sizeof(elem_t);
constexpr int VEC = 16 / ESZ;                 // elements in one 16-byte copy
constexpr int A_TILE = BM * BK, B_TILE = BK * BN;
constexpr int SMEM_BYTES = STAGES * (A_TILE + B_TILE) * ESZ;

static_assert(BM % TM == 0 && BN % TN == 0,
              "BLOCK_M/BLOCK_N must be multiples of the micro-tile");
static_assert(NTHREADS <= 1024, "at most 1024 threads per block");
static_assert(BK % INNER_STEPS == 0, "BLOCK_K divisible by INNER_STEPS");
static_assert(STAGES >= 2, "at least two stages");
static_assert(BN % VEC == 0 && (TRANS_A ? BM : BK) % VEC == 0,
              "tile rows are whole 16-byte copies");

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

// W consecutive elements of shared memory as float32: one 4-, 8- or
// 16-byte load
template <int W>
__device__ __forceinline__ void load_n(const elem_t* p, float* out) {
#if IN_BF16
    if constexpr (W == 4) {
        const uint2 raw = *reinterpret_cast<const uint2*>(p);
        out[0] = __uint_as_float(raw.x << 16);
        out[1] = __uint_as_float(raw.x & 0xffff0000u);
        out[2] = __uint_as_float(raw.y << 16);
        out[3] = __uint_as_float(raw.y & 0xffff0000u);
    } else if constexpr (W == 2) {
        const unsigned raw = *reinterpret_cast<const unsigned*>(p);
        out[0] = __uint_as_float(raw << 16);
        out[1] = __uint_as_float(raw & 0xffff0000u);
    } else {
        out[0] = to_f32(p[0]);
    }
#else
    if constexpr (W == 4) {
        const float4 v = *reinterpret_cast<const float4*>(p);
        out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
    } else if constexpr (W == 2) {
        const float2 v = *reinterpret_cast<const float2*>(p);
        out[0] = v.x; out[1] = v.y;
    } else {
        out[0] = p[0];
    }
#endif
}

// cp.async of one K step's slices of A and B into one stage
__device__ __forceinline__ void load_stage(
        elem_t* As, elem_t* Bs, const elem_t* __restrict__ A,
        const elem_t* __restrict__ B, int m0, int n0, int k0, int M, int N,
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

// two blocks of up to 256 threads on an SM: at most 128 registers each
// (a bfloat16 accumulator keeps a second tile and is left one block)
constexpr int MIN_BLOCKS = (NTHREADS <= 256 && !ACC_BF16) ? 2 : 1;

__global__ void __launch_bounds__(NTHREADS, MIN_BLOCKS)
gemm_kernel(const elem_t* __restrict__ A, const elem_t* __restrict__ B,
            elem_t* __restrict__ C, int M, int N, int K) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    elem_t* As = reinterpret_cast<elem_t*>(smem_raw);  // [STAGES][A_TILE]
    elem_t* Bs = As + STAGES * A_TILE;                  // [STAGES][BK][BN]

#if GRID_NM
    const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
#else
    const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
#endif
    const int tid = threadIdx.x;
    const int tx = tid % THREADS_N, ty = tid / THREADS_N;
    const int nk = K / BK;

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < nk)
            load_stage(As + s * A_TILE, Bs + s * B_TILE, A, B, m0, n0,
                       s * BK, M, N, K, tid);
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
                           nt * BK, M, N, K, tid);
            cp_async_commit();
        }
        const elem_t* At = As + (t % STAGES) * A_TILE;
        const elem_t* Bt = Bs + (t % STAGES) * B_TILE;

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
            C[(size_t)row * N + col] = from_f32(acc[i][j]);
        }
    }
}

extern "C" {

// Launch on `stream` (a cudaStream_t) of CUDA device `device`; does not
// synchronise.  Returns a cudaError_t: 0 when the launch was accepted.
// The caller guarantees BLOCK_M | M, BLOCK_N | N, BLOCK_K | K and
// contiguous, 16-byte aligned row-major operands on `device`.
int gemm_launch(const void* a, const void* b, void* c, int M, int N, int K,
                int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(gemm_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
#if GRID_NM
    const dim3 grid(M / BM, N / BN);
#else
    const dim3 grid(N / BN, M / BM);
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
