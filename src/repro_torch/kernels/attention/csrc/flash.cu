// Flash attention for Hopper (sm_90a): single-head attention with an
// online softmax over blocks of keys, for a batch of heads.  bfloat16
// operands run on the tensor cores (mma.sync), float32 operands on the FMA
// units.
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
//   IN_BF16         q, k, v and the output are bfloat16 (else float32);
//                   scores, softmax and sums are float32 either way
//   RAGGED          1: the blocks or D are not what the threads tile
//                   (flash.py::ragged); the build then names its tile:
//   TILE_Q, TILE_K, TILE_D  the query rows, keys and head width the threads
//                   cover (flash.py::tile), and in float32 THREADS_K (TK)
//
// Ragged blocks (RAGGED): the grid keeps one block per BLOCK_Q rows and the
// loop steps BLOCK_K keys; D stays the rows' length in memory and the
// scale's.  The tile past the block holds the next KV block's keys, so it
// is never read from memory: Q, K and V rows and dims past the block and D
// are zeros in shared memory (cp.async src-size 0 where rows are whole
// 16-byte chunks, element by element where not), a key past BLOCK_K scores
// -inf before the softmax, so its P is exactly 0 and l and the sums are
// those of flash_plain's BLOCK_K walk, and rows past BLOCK_Q and dims past
// D are not stored (one element a store).  Every other build is unchanged.
//
// Both builds stage K and V through a ring of PIPELINE_DEPTH stages filled
// with cp.async 16-byte copies: the copy of step t + PIPELINE_DEPTH - 1 is
// in flight while step t computes, and each step has one __syncthreads.
//
// The causal mask q_pos + (Sk - Sq) >= k_pos writes -1e30 exactly as the
// TPU body does, so a row with every key masked returns the mean of v.
// Exact causal skipping (flash.py::kv_end holds the same rule): a query
// block whose first row sees key 0 (q0 + Sk - Sq >= 0) stops after the KV
// block that holds its last row's last visible key,
// k_end = min(Sk, roundup(q0 + BLOCK_Q + Sk - Sq, BLOCK_K)).  The skipped
// blocks are fully masked and follow a real score, so each would add
// exp(-1e30 - m) = 0 with alpha = 1: skipping them leaves the result bit
// for bit the same.  A block with rows that see no key visits every KV
// block, which keeps their mean-of-v answer.  The mask is applied only in
// KV blocks that cross the diagonal, and the longest query blocks are
// launched first (blockIdx.x reversed).  No fast-math.
//
// bfloat16 (IN_BF16): FlashAttention-2 on mma.sync, the tensor-core route
// of the GEMM's bfloat16 build.  The work is 4*Sq*Sk*D operations (half
// when causal) at the H100's 989 TFLOP/s bfloat16 rate against
// (2*Sq + 2*Sk)*D*2 bytes a head, so operations bound it.
//
// * Warps own rows (flash.py::geometry): each of the BLOCK_Q / 16 warps
//   owns 16 query rows.  Per 16 dims of d it loads its Q rows with ldmatrix
//   (reloaded every KV step, which keeps registers for the scores) and the
//   block's K rows with ldmatrix: stored [key][d], K is already the .col
//   operand.  S = Q K^T comes out of
//   mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 as float32 fragments,
//   BLOCK_K / 8 tiles of 16 x 8 a warp.
// * The softmax works on those fragments.  A lane holds two rows (lane / 4
//   and lane / 4 + 8) and two adjacent keys of each n8 tile; each row's
//   max is reduced over its quad with two shuffles, its sum kept a lane
//   and reduced the same way once, at the end.  Scores are
//   scaled by scale * log2(e) and exponentiated with exp2f, so m is kept in
//   base 2; m, l and alpha are float32.
// * P stays in registers: the float32 score fragments of two adjacent n8
//   tiles, rounded to bfloat16 in pairs, are the A operand of the next
//   mma (a C fragment's layout is an A fragment's).  O += P V reads V,
//   stored [key][d], with ldmatrix.trans; O accumulates in float32
//   fragments, 16 x D a warp.  l sums the float32 weights.
// * Q, K and V rows are padded by 16 bytes, so the 8 rows one ldmatrix
//   reads fall on 8 distinct 16-byte bank groups (D a multiple of 16).
//   There is no P buffer.
// * Not yet: wgmma, TMA, warp specialisation.
//
// The one numerical difference from the TPU body (and from the float32
// build): P is rounded to bfloat16 before P V, as SDPA's bfloat16 route
// and FlashAttention do, where the JAX kernel keeps p in float32.  Each
// weight moves by at most 2^-9 relative, so the output moves by at most
// 2^-9 * max|v|, the size of the bfloat16 output's own rounding.
// flash.py::flash_plain rounds P at the same point for bfloat16 inputs.
//
// float32: the FMA route.  4*Sq*Sk*D FLOPs (half that when causal) on the
// float32 FMA units against (2*Sq + 2*Sk)*D elements of traffic a head, so
// FLOPs bound it at any useful length.  The design keeps the FMA units fed
// from registers, as the GEMM does:
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
//   TM + TN loads for TM*TN*4 FMAs, and the eight lanes of a quarter-warp
//   fall on eight different bank groups.  Each score is a sequential sum
//   over d, scaled afterwards.
// * The scores stay in registers for the max and the exponentials; P is
//   written once to shared memory, read back by the same warp (a __syncwarp,
//   no block barrier) 16 bytes at a time, and O += P V accumulates in
//   registers, a sequential sum over keys, with 16-byte reads of V.
// * expf, not __expf.  No tensor cores: TF32 keeps about three digits,
//   and a split-TF32 (3xTF32) design on mma/wgmma is later work.

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

constexpr int cmin(int a, int b) { return a < b ? a : b; }

#ifndef RAGGED
#define RAGGED 0
#endif
#ifndef TILE_Q
#define TILE_Q BLOCK_Q
#endif
#ifndef TILE_K
#define TILE_K BLOCK_K
#endif
#ifndef TILE_D
#define TILE_D D
#endif

// the block: the grid's step and the KV loop's
constexpr int XQ = BLOCK_Q, XK = BLOCK_K;
// the tile the threads cover (the block and D, unless RAGGED)
constexpr int BQ = TILE_Q;
constexpr int BK = TILE_K;
constexpr int DP = TILE_D;
constexpr int STAGES = PIPELINE_DEPTH;
constexpr float NEG = -1e30f;

static_assert(STAGES >= 2, "at least two K/V stages");
static_assert(BQ >= XQ && BK >= XK && DP >= D, "the tile covers the block");
static_assert(RAGGED || (BQ == XQ && BK == XK && DP == D),
              "only a ragged build has a tile larger than its block");

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
// 16 bytes, or zeros (src-size 0, nothing read) where `in` is false
__device__ __forceinline__ void cp_async16z(void* dst, const void* src,
                                            bool in) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ float zero_of(float) { return 0.f; }
__device__ __forceinline__ __nv_bfloat16 zero_of(__nv_bfloat16) {
    return __float2bfloat16_rn(0.f);
}

// ROWS tile rows of DP elements into shared rows of STRIDE elements from
// rows of D elements in memory: the first `valid` rows and D dims, zeros
// in the rest.  16-byte copies where rows are whole 16-byte chunks, else
// element by element (elem: float or __nv_bfloat16)
template <int ROWS, int STRIDE, typename T>
__device__ __forceinline__ void copy_rows_masked(T* dst, const T* src,
                                                 int valid, int tid,
                                                 int nthreads) {
    constexpr int VEC = 16 / (int)sizeof(T);
    if constexpr (D % VEC == 0) {
        constexpr int CPR = DP / VEC;
        for (int i = tid; i < ROWS * CPR; i += nthreads) {
            const int r = i / CPR, c = i % CPR;
            const bool in = r < valid && c * VEC < D;
            cp_async16z(dst + r * STRIDE + c * VEC,
                        in ? src + (size_t)r * D + c * VEC : src, in);
        }
    } else {
        for (int i = tid; i < ROWS * DP; i += nthreads) {
            const int r = i / DP, c = i % DP;
            dst[r * STRIDE + c] = r < valid && c < D
                                      ? src[(size_t)r * D + c]
                                      : zero_of(T());
        }
    }
}
#endif

#if IN_BF16
// ---------------------------------------------------------------------------
// bfloat16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 elem_t;

constexpr int WARPS = BQ / 16;                    // 16 query rows a warp
constexpr int NTHREADS = 32 * WARPS;
constexpr int VEC = 8;                            // elements in 16 bytes
constexpr int STRIDE = DP + VEC;                  // Q, K, V rows: 16 B pad
constexpr int NT = BK / 8;                        // n8 tiles of scores
constexpr int DT = DP / 8;                        // n8 tiles of the output
constexpr int SMEM_BYTES = (BQ + 2 * STAGES * BK) * STRIDE * 2;
constexpr float LOG2E = 1.4426950408889634f;

static_assert(BQ % 16 == 0 && BK % 16 == 0 && DP % 16 == 0,
              "the tile's rows, keys and D must be multiples of 16 (mma "
              "tiles)");
static_assert(NTHREADS <= 512, "at most 512 threads per block");

// cp.async of ROWS rows of D elements into shared rows of STRIDE elements
// (RAGGED: the first `valid` rows and D dims, zeros in the rest of the tile)
template <int ROWS>
__device__ __forceinline__ void copy_rows(elem_t* dst, const elem_t* src,
                                          int tid, int valid) {
#if RAGGED
    copy_rows_masked<ROWS, STRIDE>(dst, src, valid, tid, NTHREADS);
#else
    constexpr int CPR = D / VEC;                  // 16-byte chunks a row
    for (int i = tid; i < ROWS * CPR; i += NTHREADS) {
        const int r = i / CPR, c = i % CPR;
        cp_async16(dst + r * STRIDE + c * VEC, src + (size_t)r * D + c * VEC);
    }
#endif
}

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

// d += a (16 x 16, row) * b (16 x 8, col), float32 accumulator
__device__ __forceinline__ void mma_k16(float (&d)[4], const unsigned (&a)[4],
                                        unsigned b0, unsigned b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two float32 values as one bfloat16 pair, lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&h);
}

__global__ void __launch_bounds__(NTHREADS)
flash_kernel(const elem_t* __restrict__ q, const elem_t* __restrict__ k,
             const elem_t* __restrict__ v, elem_t* __restrict__ o,
             int Sq, int Sk, int causal, float scale) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    elem_t* Qs = reinterpret_cast<elem_t*>(smem_raw);  // [BQ][STRIDE]
    elem_t* Ks = Qs + BQ * STRIDE;              // [STAGES][BK][STRIDE]
    elem_t* Vs = Ks + STAGES * BK * STRIDE;     // [STAGES][BK][STRIDE]

    // the longest query blocks (the last ones, when causal) start first
    const int q0 = (gridDim.x - 1 - blockIdx.x) * XQ;
    const size_t head = blockIdx.y;
    q += (head * Sq + q0) * D;
    o += (head * Sq + q0) * D;
    k += head * Sk * D;
    v += head * Sk * D;

    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int shift = Sk - Sq;               // query ends align with KV end
    int k_end = Sk;                          // the rule of flash.py::kv_end
    if (causal && q0 + shift >= 0)
        k_end = min(Sk, (q0 + XQ + shift + XK - 1) / XK * XK);
    const int nkv = k_end / XK;

    copy_rows<BQ>(Qs, q, tid, XQ);
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < nkv) {
            copy_rows<BK>(Ks + s * BK * STRIDE, k + (size_t)s * XK * D, tid,
                          XK);
            copy_rows<BK>(Vs + s * BK * STRIDE, v + (size_t)s * XK * D, tid,
                          XK);
        }
        cp_async_commit();
    }

    // this lane's rows of the warp's 16 (g and g + 8) and its two columns
    // of each n8 tile (c2 and c2 + 1)
    const int r0 = warp * 16, g = lane >> 2, c2 = 2 * (lane & 3);
    const int qpos = q0 + r0 + g + shift;
    const float scale2 = scale * LOG2E;
    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
    float acc[DT][4];
#pragma unroll
    for (int j = 0; j < DT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    // ldmatrix row addresses: Q's A fragment (rows lane % 16, d chunk
    // lane / 16), K's B fragments (keys (lane / 16) * 8 + lane % 8, d chunk
    // (lane / 8) % 2), V's transposed B fragments (keys ((lane / 8) % 2) * 8
    // + lane % 8, d chunk lane / 16)
    const elem_t* qa = Qs + (r0 + (lane & 15)) * STRIDE + (lane >> 4) * 8;
    const int k_off = (((lane >> 4) << 3) + (lane & 7)) * STRIDE
                      + ((lane >> 3) & 1) * 8;
    const int v_off = ((((lane >> 3) & 1) << 3) + (lane & 7)) * STRIDE
                      + (lane >> 4) * 8;

    for (int t = 0; t < nkv; ++t) {
        cp_async_wait<STAGES - 2>();         // step t's K and V have landed
        __syncthreads();                     // ... for all; stage t-1 is free
        {
            const int nt = t + STAGES - 1;
            if (nt < nkv) {
                const int b = nt % STAGES;
                copy_rows<BK>(Ks + b * BK * STRIDE, k + (size_t)nt * XK * D,
                              tid, XK);
                copy_rows<BK>(Vs + b * BK * STRIDE, v + (size_t)nt * XK * D,
                              tid, XK);
            }
            cp_async_commit();
        }
        const elem_t* Kt = Ks + (t % STAGES) * BK * STRIDE;
        const elem_t* Vt = Vs + (t % STAGES) * BK * STRIDE;
        const int k0 = t * XK;

        // S = Q K^T: the warp's 16 rows x BK keys
        float s[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < DP; kk += 16) {
            unsigned a[4];
            ldsm_x4(a, qa + kk);
#pragma unroll
            for (int np = 0; np < NT / 2; ++np) {
                unsigned b[4];
                ldsm_x4(b, Kt + np * 16 * STRIDE + k_off + kk);
                mma_k16(s[2 * np], a, b[0], b[1]);
                mma_k16(s[2 * np + 1], a, b[2], b[3]);
            }
        }

        // mask only where the KV block crosses the diagonal; element e of
        // tile j is row g + 8 (e / 2), key k0 + 8 j + c2 + e % 2 (RAGGED:
        // keys past the block score -inf)
        const bool masked = causal && k0 + XK - 1 > q0 + shift;
        float mc[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float x = s[j][e] * scale2;
                if (masked && qpos + 8 * (e >> 1) < k0 + 8 * j + c2 + (e & 1))
                    x = NEG;
#if RAGGED
                if (8 * j + c2 + (e & 1) >= XK) x = -INFINITY;
#endif
                s[j][e] = x;
                mc[e >> 1] = fmaxf(mc[e >> 1], x);
            }
        float alpha[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            mc[h] = fmaxf(mc[h], __shfl_xor_sync(0xffffffffu, mc[h], 1));
            mc[h] = fmaxf(mc[h], __shfl_xor_sync(0xffffffffu, mc[h], 2));
            const float m_new = fmaxf(m[h], mc[h]);
            alpha[h] = exp2f(m[h] - m_new);
            m[h] = m_new;
            l[h] *= alpha[h];
        }
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float p = exp2f(s[j][e] - m[e >> 1]);
                s[j][e] = p;
                l[e >> 1] += p;
            }
#pragma unroll
        for (int j = 0; j < DT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];

        // O += P V: P's A fragment for keys 16 kt .. 16 kt + 15 is the
        // score tiles 2 kt and 2 kt + 1, rounded to bfloat16
#pragma unroll
        for (int kt = 0; kt < BK / 16; ++kt) {
            const unsigned a[4] = {
                pack_bf16(s[2 * kt][0], s[2 * kt][1]),
                pack_bf16(s[2 * kt][2], s[2 * kt][3]),
                pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]),
                pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3])};
#pragma unroll
            for (int dp = 0; dp < DP / 16; ++dp) {
                unsigned b[4];
                ldsm_x4_t(b, Vt + kt * 16 * STRIDE + v_off + dp * 16);
                mma_k16(acc[2 * dp], a, b[0], b[1]);
                mma_k16(acc[2 * dp + 1], a, b[2], b[3]);
            }
        }
    }

    // each row's sum over its quad, then one bfloat16 pair a store
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
        l[h] = fmaxf(l[h], 1e-30f);
    }
#pragma unroll
    for (int j = 0; j < DT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#if RAGGED
            const int row = r0 + g + 8 * h;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int col = 8 * j + c2 + e;
                if (row < XQ && col < D)
                    o[(size_t)row * D + col] =
                        __float2bfloat16_rn(acc[j][2 * h + e] / l[h]);
            }
#else
            *reinterpret_cast<__nv_bfloat162*>(
                o + (size_t)(r0 + g + 8 * h) * D + 8 * j + c2) =
                __floats2bfloat162_rn(acc[j][2 * h] / l[h],
                                      acc[j][2 * h + 1] / l[h]);
#endif
        }
}

#else
// ---------------------------------------------------------------------------
// float32: register tiles on the FMA units
// ---------------------------------------------------------------------------

typedef float elem_t;
__device__ __forceinline__ elem_t from_f32(float x) { return x; }

constexpr int TM = XQ >= 128 ? 8 : 4;            // query rows a thread
#ifdef THREADS_K
constexpr int TK = THREADS_K;                     // flash.py::_threads_k
#else
constexpr int TK = cmin(cmin(BK / 4, 32), D / 4); // threads sharing the rows
#endif
constexpr int TN = BK / TK;                       // keys a thread
constexpr int TD = DP / TK;                       // output dims a thread
constexpr int GROUPS = BQ / TM;
constexpr int NTHREADS = GROUPS * TK;
constexpr int ESZ = (int)sizeof(elem_t);
constexpr int VEC = 16 / ESZ;                     // elements in 16 bytes
constexpr int QK_STRIDE = DP + VEC;               // Q and K rows: 16 B pad
constexpr int P_STRIDE = BK + 4;                  // P rows (float32)
constexpr int SMEM_BYTES = BQ * P_STRIDE * 4
    + (BQ * QK_STRIDE + STAGES * BK * (QK_STRIDE + DP)) * ESZ;

static_assert(TK >= 1 && 32 % TK == 0, "a row group lies in one warp");
static_assert(BQ % TM == 0 && BK % TK == 0 && BK % 4 == 0,
              "the tile divides into the threads' tiles");
static_assert(TD % 4 == 0 && DP % VEC == 0, "D a multiple of 4 * TK");
static_assert(NTHREADS % 32 == 0, "whole warps");
static_assert(NTHREADS <= 512, "at most 512 threads per block");

// VEC elements (16 bytes) of shared memory
__device__ __forceinline__ void load_vec(const elem_t* p, float (&out)[VEC]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

// 4 elements (16 bytes) of shared memory
__device__ __forceinline__ void load4(const elem_t* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

// cp.async of ROWS rows of D elements into shared rows of STRIDE elements
// (RAGGED: the first `valid` rows and D dims, zeros in the rest of the tile)
template <int ROWS, int STRIDE>
__device__ __forceinline__ void copy_rows(elem_t* dst, const elem_t* src,
                                          int tid, int valid) {
#if RAGGED
    copy_rows_masked<ROWS, STRIDE>(dst, src, valid, tid, NTHREADS);
#else
    constexpr int CPR = D / VEC;                  // 16-byte chunks a row
    for (int i = tid; i < ROWS * CPR; i += NTHREADS) {
        const int r = i / CPR, c = i % CPR;
        cp_async16(dst + r * STRIDE + c * VEC, src + (size_t)r * D + c * VEC);
    }
#endif
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
    const int q0 = (gridDim.x - 1 - blockIdx.x) * XQ;
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
        k_end = min(Sk, (q0 + XQ + shift + XK - 1) / XK * XK);
    const int nkv = k_end / XK;

    copy_rows<BQ, QK_STRIDE>(Qs, q, tid, XQ);
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < nkv) {
            copy_rows<BK, QK_STRIDE>(Ks + s * BK * QK_STRIDE,
                                     k + (size_t)s * XK * D, tid, XK);
            copy_rows<BK, DP>(Vs + s * BK * DP, v + (size_t)s * XK * D, tid,
                              XK);
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
                                         k + (size_t)nt * XK * D, tid, XK);
                copy_rows<BK, DP>(Vs + b * BK * DP, v + (size_t)nt * XK * D,
                                  tid, XK);
            }
            cp_async_commit();
        }
        const elem_t* Kt = Ks + (t % STAGES) * BK * QK_STRIDE;
        const elem_t* Vt = Vs + (t % STAGES) * BK * DP;
        const int k0 = t * XK;

        // S = Q K^T for rows ty*TM + i, keys tx + j*TK
        float s[TM][TN];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
#pragma unroll 4
        for (int d0 = 0; d0 < DP; d0 += VEC) {
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

        // mask only where the KV block crosses the diagonal (RAGGED: keys
        // past the block score -inf)
        const bool masked = causal && k0 + XK - 1 > q0 + shift;
#pragma unroll
        for (int i = 0; i < TM; ++i) {
            const int qpos = q0 + ty * TM + i + shift;
            float mc = -INFINITY;
#pragma unroll
            for (int j = 0; j < TN; ++j) {
                float x = s[i][j] * scale;
                if (masked && qpos < k0 + tx + j * TK) x = NEG;
#if RAGGED
                if (tx + j * TK >= XK) x = -INFINITY;
#endif
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
                    load4(Vt + (c0 + cc) * DP + g * 4 * TK + 4 * tx,
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
            for (int e = 0; e < 4; ++e) {
#if RAGGED
                if (ty * TM + i >= XQ || 4 * tx + g * 4 * TK + e >= D)
                    continue;
#endif
                orow[g * 4 * TK + e] = from_f32(acc[i][4 * g + e] / denom);
            }
    }
}
#endif

extern "C" {

// Launch on `stream` (a cudaStream_t) of CUDA device `device`; does not
// synchronise.  Returns a cudaError_t: 0 when the launch was accepted.
// q and o are (heads, Sq, D), k and v (heads, Sk, D), contiguous and
// starting on 16-byte boundaries, on `device`; the caller guarantees
// BLOCK_Q | Sq and BLOCK_K | Sk (any blocks that divide them, at any D:
// flash.py::ragged picks the build that masks its tile).
int flash_launch(const void* q, const void* k, const void* v, void* o,
                 int heads, int Sq, int Sk, int causal, float scale,
                 int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(flash_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(Sq / XQ, heads);
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
