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
// dimension, one launch for all heads.
//
// One compiled library per configuration: the tunables and the head width
// arrive as -D defines, and the Python wrapper in ../flash.py builds, loads
// and launches it.
//
//   BLOCK_Q         query rows of one block (grid x: Sq / BLOCK_Q)
//   BLOCK_K         keys per step of the loop over Sk
//   PIPELINE_DEPTH  K/V stages in shared memory (cp.async ring)
//   D               head width
//   IN_BF16         q, k, v and the output are bfloat16 (else float32); they
//                   are staged in shared memory as they arrive and converted
//                   to float32 when read into registers; scores, softmax and
//                   sums are float32 either way
//
// What bounds it: 4*Sq*Sk*D FLOPs (half that when causal) on the float32
// FMA units against (2*Sq + 2*Sk)*D elements of traffic a head, so FLOPs
// bound it at any useful length.  The design keeps the FMA units fed from
// registers, as the GEMM does:
//
// * Thread geometry (flash.py::geometry predicts it): TK threads share a
//   group of TM query rows, TK = min(BLOCK_K/4, 32, D/4), TM = 8 when
//   BLOCK_Q >= 128 else 4.  A thread computes a TM x TN tile of the scores
//   S = Q K^T (TN = BLOCK_K/TK keys: tx, tx + TK, ...) and owns a TM x TD
//   tile of the output (TD = D/TK dims, in groups of 4).  A row group's TK
//   threads are neighbouring lanes of one warp: they reduce each row's max
//   and sum with shuffles.
// * Q and K are staged row-major with 16 bytes of pad a row, so a thread
//   reads 16 bytes of one row for 16 bytes of d: per 16 bytes of d it does
//   TM + TN loads for TM*TN*(16/elem) FMAs, and the eight lanes of a
//   quarter-warp fall on eight different bank groups.  Each score is a
//   sequential sum over d, scaled afterwards.
// * The scores stay in registers for the max and the exponentials; P is
//   written once to shared memory, read back by the same warp (a __syncwarp,
//   no block barrier) 16 bytes at a time, and O += P V accumulates in
//   registers, a sequential sum over keys, with 16-byte reads of V.
// * K and V arrive through a ring of PIPELINE_DEPTH stages filled with
//   cp.async 16-byte copies: the copy of step t + PIPELINE_DEPTH - 1 is in
//   flight while step t computes, and each step has one __syncthreads.
//
// The causal mask q_pos + (Sk - Sq) >= k_pos writes -1e30 exactly as the
// TPU body does, so a row with every key masked returns the mean of v.
// Exact causal skipping (flash.py::kv_end holds the same rule): a query
// block whose first row sees key 0 (q0 + Sk - Sq >= 0) stops after the KV
// block that holds its last row's last visible key,
// k_end = min(Sk, roundup(q0 + BLOCK_Q + Sk - Sq, BLOCK_K)).  The skipped
// blocks are fully masked and follow a real score, so each would add
// exp(-1e30 - m) = 0 with alpha = 1: skipping them leaves the float32 result
// bit for bit the same.  A block with rows that see no key visits every KV
// block, which keeps their mean-of-v answer.  The mask is applied only in
// KV blocks that cross the diagonal, and the longest query blocks are
// launched first (blockIdx.x reversed).  expf, not __expf, and no fast-math.
//
// No tensor cores: TF32 keeps about three digits, and a split-TF32
// (3xTF32) design on mma/wgmma is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#if !defined(BLOCK_Q) || !defined(BLOCK_K) || !defined(D)
#error "BLOCK_Q, BLOCK_K and D must be defined"
#endif
#ifndef IN_BF16
#define IN_BF16 0
#endif
#ifndef PIPELINE_DEPTH
#define PIPELINE_DEPTH 2
#endif

#if IN_BF16
typedef __nv_bfloat16 elem_t;
__device__ __forceinline__ elem_t from_f32(float x) { return __float2bfloat16_rn(x); }
#else
typedef float elem_t;
__device__ __forceinline__ elem_t from_f32(float x) { return x; }
#endif

constexpr int cmin(int a, int b) { return a < b ? a : b; }

constexpr int BQ = BLOCK_Q;
constexpr int BK = BLOCK_K;
constexpr int STAGES = PIPELINE_DEPTH;
constexpr int TM = BQ >= 128 ? 8 : 4;            // query rows a thread
constexpr int TK = cmin(cmin(BK / 4, 32), D / 4); // threads sharing the rows
constexpr int TN = BK / TK;                       // keys a thread
constexpr int TD = D / TK;                        // output dims a thread
constexpr int GROUPS = BQ / TM;
constexpr int NTHREADS = GROUPS * TK;
constexpr int ESZ = (int)sizeof(elem_t);
constexpr int VEC = 16 / ESZ;                     // elements in 16 bytes
constexpr int QK_STRIDE = D + VEC;                // Q and K rows: 16 B pad
constexpr int P_STRIDE = BK + 4;                  // P rows (float32)
constexpr int SMEM_BYTES = BQ * P_STRIDE * 4
    + (BQ * QK_STRIDE + STAGES * BK * (QK_STRIDE + D)) * ESZ;
constexpr float NEG = -1e30f;

static_assert(STAGES >= 2, "at least two K/V stages");
static_assert(TK >= 1 && 32 % TK == 0, "a row group lies in one warp");
static_assert(BQ % TM == 0 && BK % TK == 0, "blocks divide the tiles");
static_assert(TD % 4 == 0 && D % VEC == 0, "D a multiple of 4 * TK");
static_assert(NTHREADS % 32 == 0, "whole warps");
static_assert(NTHREADS <= 512, "at most 512 threads per block");

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

// VEC elements (16 bytes) of shared memory as float32
__device__ __forceinline__ void load_vec(const elem_t* p, float (&out)[VEC]) {
#if IN_BF16
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        out[2 * i] = __uint_as_float(w[i] << 16);
        out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
#else
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
#endif
}

// 4 elements (16 or 8 bytes) of shared memory as float32
__device__ __forceinline__ void load4(const elem_t* p, float* out) {
#if IN_BF16
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    out[0] = __uint_as_float(raw.x << 16);
    out[1] = __uint_as_float(raw.x & 0xffff0000u);
    out[2] = __uint_as_float(raw.y << 16);
    out[3] = __uint_as_float(raw.y & 0xffff0000u);
#else
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
#endif
}

// cp.async of ROWS rows of D elements into shared rows of STRIDE elements
template <int ROWS, int STRIDE>
__device__ __forceinline__ void copy_rows(elem_t* dst, const elem_t* src,
                                          int tid) {
    constexpr int CPR = D / VEC;                  // 16-byte chunks a row
    for (int i = tid; i < ROWS * CPR; i += NTHREADS) {
        const int r = i / CPR, c = i % CPR;
        cp_async16(dst + r * STRIDE + c * VEC, src + (size_t)r * D + c * VEC);
    }
}

// ask ptxas for two resident blocks where their shared memory fits the
// SM's 228 KB (1 KB of it reserved per block)
constexpr int MIN_BLOCKS =
    (NTHREADS <= 256 && 2 * (SMEM_BYTES + 1024) <= 233472) ? 2 : 1;

__global__ void __launch_bounds__(NTHREADS, MIN_BLOCKS)
flash_kernel(const elem_t* __restrict__ q, const elem_t* __restrict__ k,
             const elem_t* __restrict__ v, elem_t* __restrict__ o,
             int Sq, int Sk, int causal, float scale) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* Ps = reinterpret_cast<float*>(smem_raw);            // [BQ][P_STRIDE]
    elem_t* Qs = reinterpret_cast<elem_t*>(Ps + BQ * P_STRIDE); // [BQ][QK_STRIDE]
    elem_t* Ks = Qs + BQ * QK_STRIDE;           // [STAGES][BK][QK_STRIDE]
    elem_t* Vs = Ks + STAGES * BK * QK_STRIDE;  // [STAGES][BK][D]

    // the longest query blocks (the last ones, when causal) start first
    const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
    const size_t head = blockIdx.y;
    q += (head * Sq + q0) * D;
    o += (head * Sq + q0) * D;
    k += head * Sk * D;
    v += head * Sk * D;

    const int tid = threadIdx.x;
    const int ty = tid / TK, tx = tid % TK;
    const int shift = Sk - Sq;               // query ends align with KV end
    int k_end = Sk;                          // the rule of flash.py::kv_end
    if (causal && q0 + shift >= 0)
        k_end = min(Sk, (q0 + BQ + shift + BK - 1) / BK * BK);
    const int nkv = k_end / BK;

    copy_rows<BQ, QK_STRIDE>(Qs, q, tid);
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < nkv) {
            copy_rows<BK, QK_STRIDE>(Ks + s * BK * QK_STRIDE,
                                     k + (size_t)s * BK * D, tid);
            copy_rows<BK, D>(Vs + s * BK * D, v + (size_t)s * BK * D, tid);
        }
        cp_async_commit();
    }

    float m[TM], l[TM], acc[TM][TD];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        m[i] = NEG;
        l[i] = 0.f;
#pragma unroll
        for (int e = 0; e < TD; ++e) acc[i][e] = 0.f;
    }
    const elem_t* qrow = Qs + ty * TM * QK_STRIDE;
    float* prow = Ps + ty * TM * P_STRIDE;

    for (int t = 0; t < nkv; ++t) {
        cp_async_wait<STAGES - 2>();         // step t's K and V have landed
        __syncthreads();                     // ... for all; stage t-1 is free
        {
            const int nt = t + STAGES - 1;
            if (nt < nkv) {
                const int b = nt % STAGES;
                copy_rows<BK, QK_STRIDE>(Ks + b * BK * QK_STRIDE,
                                         k + (size_t)nt * BK * D, tid);
                copy_rows<BK, D>(Vs + b * BK * D, v + (size_t)nt * BK * D,
                                 tid);
            }
            cp_async_commit();
        }
        const elem_t* Kt = Ks + (t % STAGES) * BK * QK_STRIDE;
        const elem_t* Vt = Vs + (t % STAGES) * BK * D;
        const int k0 = t * BK;

        // S = Q K^T for rows ty*TM + i, keys tx + j*TK
        float s[TM][TN];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
#pragma unroll 4
        for (int d0 = 0; d0 < D; d0 += VEC) {
            float kf[TN][VEC];
#pragma unroll
            for (int j = 0; j < TN; ++j)
                load_vec(Kt + (tx + j * TK) * QK_STRIDE + d0, kf[j]);
#pragma unroll
            for (int i = 0; i < TM; ++i) {
                float qf[VEC];
                load_vec(qrow + i * QK_STRIDE + d0, qf);
#pragma unroll
                for (int dd = 0; dd < VEC; ++dd)
#pragma unroll
                    for (int j = 0; j < TN; ++j)
                        s[i][j] = fmaf(qf[dd], kf[j][dd], s[i][j]);
            }
        }

        // mask only where the KV block crosses the diagonal
        const bool masked = causal && k0 + BK - 1 > q0 + shift;
#pragma unroll
        for (int i = 0; i < TM; ++i) {
            const int qpos = q0 + ty * TM + i + shift;
            float mc = -INFINITY;
#pragma unroll
            for (int j = 0; j < TN; ++j) {
                float x = s[i][j] * scale;
                if (masked && qpos < k0 + tx + j * TK) x = NEG;
                s[i][j] = x;
                mc = fmaxf(mc, x);
            }
#pragma unroll
            for (int off = 1; off < TK; off <<= 1)
                mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, off));
            const float m_new = fmaxf(m[i], mc);
            const float alpha = expf(m[i] - m_new);
            float ps = 0.f;
#pragma unroll
            for (int j = 0; j < TN; ++j) {
                const float p = expf(s[i][j] - m_new);
                prow[i * P_STRIDE + tx + j * TK] = p;
                ps += p;
            }
#pragma unroll
            for (int off = 1; off < TK; off <<= 1)
                ps += __shfl_xor_sync(0xffffffffu, ps, off);
            l[i] = l[i] * alpha + ps;
            m[i] = m_new;
#pragma unroll
            for (int e = 0; e < TD; ++e) acc[i][e] *= alpha;
        }
        __syncwarp();                        // the row group's P is written

        // O += P V for dims g*4*TK + 4*tx + (0..3)
#pragma unroll 4
        for (int c0 = 0; c0 < BK; c0 += 4) {
            float p4[TM][4];
#pragma unroll
            for (int i = 0; i < TM; ++i) {
                const float4 pv = *reinterpret_cast<const float4*>(
                    prow + i * P_STRIDE + c0);
                p4[i][0] = pv.x; p4[i][1] = pv.y;
                p4[i][2] = pv.z; p4[i][3] = pv.w;
            }
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) {
                float vf[TD];
#pragma unroll
                for (int g = 0; g < TD / 4; ++g)
                    load4(Vt + (c0 + cc) * D + g * 4 * TK + 4 * tx,
                          vf + 4 * g);
#pragma unroll
                for (int i = 0; i < TM; ++i)
#pragma unroll
                    for (int e = 0; e < TD; ++e)
                        acc[i][e] = fmaf(p4[i][cc], vf[e], acc[i][e]);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const float denom = fmaxf(l[i], 1e-30f);
        elem_t* orow = o + (size_t)(ty * TM + i) * D + 4 * tx;
#pragma unroll
        for (int g = 0; g < TD / 4; ++g)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                orow[g * 4 * TK + e] = from_f32(acc[i][4 * g + e] / denom);
    }
}

extern "C" {

// Launch on `stream` (a cudaStream_t) of CUDA device `device`; does not
// synchronise.  Returns a cudaError_t: 0 when the launch was accepted.
// q and o are (heads, Sq, D), k and v (heads, Sk, D), contiguous and
// 16-byte aligned, on `device`; the caller guarantees BLOCK_Q | Sq and
// BLOCK_K | Sk.
int flash_launch(const void* q, const void* k, const void* v, void* o,
                 int heads, int Sq, int Sk, int causal, float scale,
                 int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(flash_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(Sq / BQ, heads);
    flash_kernel<<<grid, NTHREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
        (const elem_t*)q, (const elem_t*)k, (const elem_t*)v, (elem_t*)o,
        Sq, Sk, causal, scale);
    return (int)cudaGetLastError();
}

const char* flash_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

int flash_smem_bytes(void) { return SMEM_BYTES; }

int flash_threads(void) { return NTHREADS; }

}  // extern "C"
