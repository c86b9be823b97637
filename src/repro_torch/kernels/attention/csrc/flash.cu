// Flash attention for Hopper (sm_90a): single-head attention with an
// online softmax over blocks of keys, for a batch of heads.
//
// Replaces the Pallas TPU kernel body of the JAX package,
// src/repro/kernels/attention/flash.py::_flash_kernel, built by
// make_flash_attention there.  The TPU kernel carries the running max m,
// normaliser l and accumulator acc in scratch across the sequential KV grid
// dimension.  Blocks on the card run in parallel in no order, so each block
// loops over the KV blocks itself and keeps m, l and acc in registers; the
// JAX package's vmap over leading dims (batch x heads) becomes the grid's y
// dimension.
//
// One compiled library per configuration: the tunables and the head width
// arrive as -D defines, and the Python wrapper in ../flash.py builds, loads
// and launches it.
//
//   BLOCK_Q   query rows of one block (grid x: Sq / BLOCK_Q)
//   BLOCK_K   keys per step of the loop over Sk
//   D         head width
//   IN_BF16   q, k, v and the output are bfloat16 (else float32); scores,
//             softmax and sums are float32 either way
//
// Thread geometry: TPR = 4 threads per query row, 4 * BLOCK_Q threads a
// block.  The four threads of a row are neighbouring lanes of one warp: they
// reduce the row's max and sum with shuffles, and each owns D / 4 of the
// row's accumulators (columns lane4, lane4 + 4, ...).
//
// Each step over BLOCK_K keys: stage K and V (as float32) in shared memory;
// every thread computes scores s = (q . k) * scale as float32 FMAs (no
// tensor cores, no TF32) into a shared BLOCK_Q x BLOCK_K tile; the causal
// mask q_pos + (Sk - Sq) >= k_pos writes -1e30 exactly as the TPU body does,
// so a row with every key masked returns the mean of v; then each row's
// threads update m, l, rescale acc and add p @ v.  Every KV block is visited,
// above the causal diagonal too: skipping them would change the answer of
// fully masked rows when Sk < Sq.  expf, not __expf, and no fast-math.
//
// What bounds it: 4*Sq*Sk*D FLOPs on the FMA units against (2*Sq + 2*Sk)*D
// elements of traffic a head, so FLOPs bound it at any useful length.  This
// first kernel reads both operands of every score FMA from shared memory
// (K rows padded by one float to spread the banks), and does the causal
// blocks' masked work too, so it runs well under the float32 FMA peak.
// wgmma on bf16, TMA and diagonal skipping belong to later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#if !defined(BLOCK_Q) || !defined(BLOCK_K) || !defined(D)
#error "BLOCK_Q, BLOCK_K and D must be defined"
#endif
#ifndef IN_BF16
#define IN_BF16 0
#endif

#define TPR 4
#define NTHREADS (TPR * BLOCK_Q)
#define ACC_N (D / TPR)
#define K_STRIDE (D + 1)
#define S_STRIDE (BLOCK_K + 1)
#define SMEM_FLOATS (BLOCK_Q * D + BLOCK_K * K_STRIDE + BLOCK_K * D \
                     + BLOCK_Q * S_STRIDE)
#define NEG (-1e30f)

static_assert(D % TPR == 0, "D divisible by 4");
static_assert(NTHREADS % 32 == 0, "BLOCK_Q a multiple of 8");
static_assert(NTHREADS <= 1024, "at most 1024 threads per block");

#if IN_BF16
typedef __nv_bfloat16 elem_t;
__device__ __forceinline__ float to_f32(elem_t x) { return __bfloat162float(x); }
__device__ __forceinline__ elem_t from_f32(float x) { return __float2bfloat16_rn(x); }
#else
typedef float elem_t;
__device__ __forceinline__ float to_f32(elem_t x) { return x; }
__device__ __forceinline__ elem_t from_f32(float x) { return x; }
#endif

__global__ void __launch_bounds__(NTHREADS)
flash_kernel(const elem_t* __restrict__ q, const elem_t* __restrict__ k,
             const elem_t* __restrict__ v, elem_t* __restrict__ o,
             int Sq, int Sk, int causal, float scale) {
    extern __shared__ float smem[];
    float* Qs = smem;                         // [BLOCK_Q][D]
    float* Ks = Qs + BLOCK_Q * D;             // [BLOCK_K][K_STRIDE]
    float* Vs = Ks + BLOCK_K * K_STRIDE;      // [BLOCK_K][D]
    float* Ss = Vs + BLOCK_K * D;             // [BLOCK_Q][S_STRIDE]

    const int q0 = blockIdx.x * BLOCK_Q;
    const size_t head = blockIdx.y;
    q += (head * Sq + q0) * D;
    o += (head * Sq + q0) * D;
    k += head * Sk * D;
    v += head * Sk * D;

    const int tid = threadIdx.x;
    const int row = tid / TPR, lane4 = tid % TPR;
    const int shift = Sk - Sq;               // query ends align with KV end

    for (int idx = tid; idx < BLOCK_Q * D; idx += NTHREADS)
        Qs[idx] = to_f32(q[idx]);

    float m = NEG, l = 0.f;
    float acc[ACC_N];
#pragma unroll
    for (int i = 0; i < ACC_N; ++i) acc[i] = 0.f;

    for (int k0 = 0; k0 < Sk; k0 += BLOCK_K) {
        __syncthreads();                      // last step's readers are done
        for (int idx = tid; idx < BLOCK_K * D; idx += NTHREADS) {
            const size_t g = (size_t)k0 * D + idx;
            Ks[(idx / D) * K_STRIDE + idx % D] = to_f32(k[g]);
            Vs[idx] = to_f32(v[g]);
        }
        __syncthreads();

        for (int idx = tid; idx < BLOCK_Q * BLOCK_K; idx += NTHREADS) {
            const int r = idx / BLOCK_K, c = idx % BLOCK_K;
            const float* qr = Qs + r * D;
            const float* kc = Ks + c * K_STRIDE;
            float s = 0.f;
#pragma unroll 8
            for (int d = 0; d < D; ++d) s = fmaf(qr[d], kc[d], s);
            s *= scale;
            if (causal && q0 + r + shift < k0 + c) s = NEG;
            Ss[r * S_STRIDE + c] = s;
        }
        __syncthreads();

        float* sr = Ss + row * S_STRIDE;
        float mc = -INFINITY;
        for (int c = lane4; c < BLOCK_K; c += TPR) mc = fmaxf(mc, sr[c]);
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
        const float m_new = fmaxf(m, mc);
        const float alpha = expf(m - m_new);
        float ps = 0.f;
        for (int c = lane4; c < BLOCK_K; c += TPR) {
            const float p = expf(sr[c] - m_new);
            sr[c] = p;
            ps += p;
        }
        ps += __shfl_xor_sync(0xffffffffu, ps, 1);
        ps += __shfl_xor_sync(0xffffffffu, ps, 2);
        l = l * alpha + ps;
        m = m_new;
        __syncwarp();                         // the row's p is written

#pragma unroll
        for (int i = 0; i < ACC_N; ++i) acc[i] *= alpha;
#pragma unroll 2
        for (int c = 0; c < BLOCK_K; ++c) {
            const float p = sr[c];
            const float* vc = Vs + c * D + lane4;
#pragma unroll
            for (int i = 0; i < ACC_N; ++i)
                acc[i] = fmaf(p, vc[TPR * i], acc[i]);
        }
    }

    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < ACC_N; ++i)
        o[row * D + lane4 + TPR * i] = from_f32(acc[i] / denom);
}

extern "C" {

// Launch on `stream` (a cudaStream_t) of CUDA device `device`; does not
// synchronise.  Returns a cudaError_t: 0 when the launch was accepted.
// q and o are (heads, Sq, D), k and v (heads, Sk, D), contiguous, on
// `device`; the caller guarantees BLOCK_Q | Sq and BLOCK_K | Sk.
int flash_launch(const void* q, const void* k, const void* v, void* o,
                 int heads, int Sq, int Sk, int causal, float scale,
                 int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const int smem = SMEM_FLOATS * (int)sizeof(float);
    err = cudaFuncSetAttribute(flash_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(Sq / BLOCK_Q, heads);
    flash_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
        (const elem_t*)q, (const elem_t*)k, (const elem_t*)v, (elem_t*)o,
        Sq, Sk, causal, scale);
    return (int)cudaGetLastError();
}

const char* flash_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

int flash_smem_bytes(void) { return SMEM_FLOATS * (int)sizeof(float); }

int flash_threads(void) { return NTHREADS; }

}  // extern "C"
