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
//   IN_BF16        A, B and C are bfloat16 (else float32); products and sums
//                  are float32 either way
//
// What bounds it: the work is 2*M*N*K float32 FLOPs on the FMA units (no
// tensor cores, no TF32: TF32 keeps about three digits and fails the f32
// tolerance).  At 2048^3 that is ~0.26 ms at the H100's 67 TFLOP/s, while
// the bytes (each input read once, the output written once) take ~0.015 ms
// at 3.35 TB/s, so FLOPs bound it.  The design keeps the FMA units fed from
// registers: each thread owns a TM x TN micro-tile of C in registers and,
// for every k, reads TM values of A and TN of B from shared memory with
// 16-byte loads, doing TM*TN FMAs for TM+TN loads.  A block stages one
// BLOCK_K slice of A and B in shared memory per step; the blocks run in
// parallel in no order, so the K loop inside each block takes the place of
// the TPU grid's sequential K dimension.  No double buffering, no wgmma, no
// TMA yet: a right, simple kernel first.

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

// Thread geometry, derived from the block shape: a TM x TN micro-tile per
// thread, held as TM/4 x TN/4 groups of 4 x 4.  Group g of a thread's rows
// starts at g * (BLOCK_M / (TM/4)) + 4 * ty, so the 16-byte shared-memory
// reads of neighbouring threads fall on neighbouring addresses.
#define TM (BLOCK_M >= 64 ? 8 : 4)
#define TN (BLOCK_N >= 64 ? 8 : 4)
#define THREADS_M (BLOCK_M / TM)
#define THREADS_N (BLOCK_N / TN)
#define NTHREADS (THREADS_M * THREADS_N)
#define GROUP_M (BLOCK_M / (TM / 4))
#define GROUP_N (BLOCK_N / (TN / 4))
#define SUB_K (BLOCK_K / INNER_STEPS)
// A's tile is stored k-major, each row padded by 4 floats to spread the
// transposing stores over the banks while keeping 16-byte alignment
#define A_STRIDE (BLOCK_M + 4)
#define SMEM_FLOATS (BLOCK_K * A_STRIDE + BLOCK_K * BLOCK_N)

static_assert(BLOCK_M % TM == 0 && BLOCK_N % TN == 0,
              "BLOCK_M/BLOCK_N must be multiples of the micro-tile");
static_assert(NTHREADS <= 1024, "at most 1024 threads per block");
static_assert(BLOCK_K % INNER_STEPS == 0, "BLOCK_K divisible by INNER_STEPS");

#if IN_BF16
typedef __nv_bfloat16 elem_t;
__device__ __forceinline__ float to_f32(elem_t x) { return __bfloat162float(x); }
__device__ __forceinline__ elem_t from_f32(float x) { return __float2bfloat16_rn(x); }
#else
typedef float elem_t;
__device__ __forceinline__ float to_f32(elem_t x) { return x; }
__device__ __forceinline__ elem_t from_f32(float x) { return x; }
#endif

__device__ __forceinline__ float round_bf16(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

__global__ void __launch_bounds__(NTHREADS)
gemm_kernel(const elem_t* __restrict__ A, const elem_t* __restrict__ B,
            elem_t* __restrict__ C, int M, int N, int K) {
    extern __shared__ __align__(16) float smem[];
    float* As = smem;                        // [BLOCK_K][A_STRIDE]
    float* Bs = smem + BLOCK_K * A_STRIDE;   // [BLOCK_K][BLOCK_N]

#if GRID_NM
    const int m0 = blockIdx.x * BLOCK_M, n0 = blockIdx.y * BLOCK_N;
#else
    const int n0 = blockIdx.x * BLOCK_N, m0 = blockIdx.y * BLOCK_M;
#endif
    const int tid = threadIdx.x;
    const int tx = tid % THREADS_N, ty = tid / THREADS_N;

    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
#if ACC_BF16
    float part[TM][TN];
#endif

    for (int k0 = 0; k0 < K; k0 += BLOCK_K) {
        // stage this K step's slices; neighbouring threads read neighbouring
        // addresses of device memory
        for (int i = tid; i < BLOCK_M * BLOCK_K; i += NTHREADS) {
#if TRANS_A
            const int kk = i / BLOCK_M, mm = i % BLOCK_M;
            As[kk * A_STRIDE + mm] = to_f32(A[(size_t)(k0 + kk) * M + m0 + mm]);
#else
            const int mm = i / BLOCK_K, kk = i % BLOCK_K;
            As[kk * A_STRIDE + mm] = to_f32(A[(size_t)(m0 + mm) * K + k0 + kk]);
#endif
        }
        for (int i = tid; i < BLOCK_K * BLOCK_N; i += NTHREADS) {
            const int kk = i / BLOCK_N, nn = i % BLOCK_N;
            Bs[kk * BLOCK_N + nn] = to_f32(B[(size_t)(k0 + kk) * N + n0 + nn]);
        }
        __syncthreads();

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
#pragma unroll 4
            for (int kk = s * SUB_K; kk < (s + 1) * SUB_K; ++kk) {
                float a[TM], b[TN];
#pragma unroll
                for (int g = 0; g < TM / 4; ++g) {
                    const float4 v = *reinterpret_cast<const float4*>(
                        &As[kk * A_STRIDE + g * GROUP_M + 4 * ty]);
                    a[4 * g] = v.x; a[4 * g + 1] = v.y;
                    a[4 * g + 2] = v.z; a[4 * g + 3] = v.w;
                }
#pragma unroll
                for (int g = 0; g < TN / 4; ++g) {
                    const float4 v = *reinterpret_cast<const float4*>(
                        &Bs[kk * BLOCK_N + g * GROUP_N + 4 * tx]);
                    b[4 * g] = v.x; b[4 * g + 1] = v.y;
                    b[4 * g + 2] = v.z; b[4 * g + 3] = v.w;
                }
#pragma unroll
                for (int i = 0; i < TM; ++i)
#pragma unroll
                    for (int j = 0; j < TN; ++j)
                        SUM[i][j] = fmaf(a[i], b[j], SUM[i][j]);
            }
#undef SUM
#if ACC_BF16
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j)
                    acc[i][j] = round_bf16(acc[i][j] + round_bf16(part[i][j]));
#endif
        }
        __syncthreads();
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
// contiguous row-major operands on `device`.
int gemm_launch(const void* a, const void* b, void* c, int M, int N, int K,
                int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const int smem = SMEM_FLOATS * (int)sizeof(float);
    err = cudaFuncSetAttribute(gemm_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
#if GRID_NM
    const dim3 grid(M / BLOCK_M, N / BLOCK_N);
#else
    const dim3 grid(N / BLOCK_N, M / BLOCK_M);
#endif
    gemm_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
        (const elem_t*)a, (const elem_t*)b, (elem_t*)c, M, N, K);
    return (int)cudaGetLastError();
}

const char* gemm_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

int gemm_smem_bytes(void) { return SMEM_FLOATS * (int)sizeof(float); }

int gemm_threads(void) { return NTHREADS; }

}  // extern "C"
