// AdamW's step for Hopper (sm_90a) in two passes over each leaf: the
// gradient's sum of squares (for the global norm and its clip scale), then
// the update of the parameter and both moments in one read and one write.
//
// Replaces no TPU kernel: the JAX package leaves the optimizer to XLA,
// which fuses it.  The port's eager leafwise step (../adamw.py::_leaf) runs
// ~20 PyTorch elementwise kernels a leaf, each writing a float32 temporary
// the size of the leaf, so it moves ~10x the bytes the step needs.  Bytes
// bound the step on this card: per parameter 22 of them for the update
// (bf16 p and g, float32 m and v: read 2 + 2 + 4 + 4, write 2 + 4 + 4) and
// 2 to read the gradient for the norm, against a handful of operations.
// So each pass reads and writes every element once, 16 bytes a load or
// store where the addresses allow, and keeps all arithmetic in float32
// registers.  The Python wrapper is ../fused.py.
//
// Norm pass (adamw_norm_leaf, adamw_norm_finish): block b of a leaf sums
// the squares of a fixed run of NORM_BLOCK_UNITS vector units into
// partials[b] (block 0 adds the scalar head and tail too, and writes the
// leaf's block count); one block of a second launch then walks the leaves
// in the tree's order, sums each leaf's partials and adds the leaf's sum to
// the total.  The order of every sum is fixed by the sizes alone and no
// float atomic is used, so two runs give the same bits.  All sums are
// float32, as global_norm's; the wrapper takes the square root, after the
// sum over a mesh's ranks where the leaves are shards.

// Update pass (adamw_update): _leaf's operations in its order, each
// rounded where PyTorch rounds it (the intrinsics keep nvcc from
// contracting a multiply and an add into an FMA); the Python scalars
// arrive as floats rounded from their doubles, as PyTorch rounds a
// scalar operand, and the clip scale, learning rate and bias corrections
// are read from device memory, so nothing waits for the host.  Results are
// cast back with round-to-nearest-even.  Given the same scalars, p, m and v
// are _leaf's bit for bit.
//
// Vector layout (fused.py::vector_layout): elements [head, head + 8 nvec)
// go as units of VEC = 8 (16 bytes of bfloat16, 32 of float32), whose
// addresses are 16-byte aligned in every array; the rest, the head before
// and the tail after, one element at a time.  Arrays whose alignments no
// common head reconciles go element by element (head = n).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;
// bytes every array's vector units are aligned to (a 16-byte load or store)
constexpr int ALIGN = 16;
// vector units a thread sums in one norm block, and a norm block's share
constexpr int NORM_UNITS = 4;
constexpr long long NORM_BLOCK_UNITS = (long long)THREADS * NORM_UNITS;
constexpr int FINISH_THREADS = 1024;
// blocks of an update launch: a grid-stride loop over the units beyond it
constexpr long long UPDATE_BLOCKS = 132 * 16;

enum Dtype { F32 = 0, BF16 = 1 };
typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) {
    return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
    return x;
}
template <> __device__ __forceinline__ bf16 from_float<bf16>(float x) {
    return __float2bfloat16_rn(x);
}

__device__ __forceinline__ void load8(const float* p, float (&x)[VEC]) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const bf16* p, float (&x)[VEC]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        x[2 * i] = f.x;
        x[2 * i + 1] = f.y;
    }
}

__device__ __forceinline__ void store8(float* p, const float (&x)[VEC]) {
    reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void store8(bf16* p, const float (&x)[VEC]) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i)
        h[i] = __halves2bfloat162(__float2bfloat16_rn(x[2 * i]),
                                  __float2bfloat16_rn(x[2 * i + 1]));
    *reinterpret_cast<uint4*>(p) = u;
}

// The element a scalar unit s stands for: the head, then the tail.
__device__ __forceinline__ long long scalar_index(long long s, long long head,
                                                  long long nvec) {
    return s < head ? s : s + nvec * VEC;
}

// The sum of x over the block's NT threads, in a fixed order; thread 0
// holds it.  Every thread of the block calls it.
template <int NT>
__device__ __forceinline__ float block_sum(float x) {
    __shared__ float warp_sums[NT / 32];
    __syncthreads();    // the previous call's warp 0 has read warp_sums
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (lane == 0) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
        x = lane < NT / 32 ? warp_sums[lane] : 0.f;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
            x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
    }
    return x;
}

template <typename G>
__global__ void __launch_bounds__(THREADS)
norm_kernel(const G* __restrict__ g, long long n, long long head,
            long long nvec, float* __restrict__ partials,
            int* __restrict__ count) {
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
    const long long u0 = blockIdx.x * NORM_BLOCK_UNITS + threadIdx.x;
#pragma unroll
    for (int k = 0; k < NORM_UNITS; ++k) {
        const long long u = u0 + (long long)k * THREADS;
        if (u < nvec) {
            float x[VEC];
            load8(g + head + u * VEC, x);
#pragma unroll
            for (int j = 0; j < VEC; ++j)
                acc[j] = __fadd_rn(acc[j], __fmul_rn(x[j], x[j]));
        }
    }
    if (blockIdx.x == 0) {
        for (long long s = threadIdx.x; s < n - nvec * VEC; s += THREADS) {
            const float x = to_float(g[scalar_index(s, head, nvec)]);
            acc[0] = __fadd_rn(acc[0], __fmul_rn(x, x));
        }
    }
    const float t = __fadd_rn(
        __fadd_rn(__fadd_rn(acc[0], acc[1]), __fadd_rn(acc[2], acc[3])),
        __fadd_rn(__fadd_rn(acc[4], acc[5]), __fadd_rn(acc[6], acc[7])));
    const float sum = block_sum<THREADS>(t);
    if (threadIdx.x == 0) {
        partials[blockIdx.x] = sum;
        if (blockIdx.x == 0) *count = (int)gridDim.x;
    }
}

// The sum of squares of `leaves` leaves into out[0]: leaf i's partials are
// counts[i] floats, laid one leaf after the other from `partials`.
__global__ void __launch_bounds__(FINISH_THREADS)
finish_kernel(const float* __restrict__ partials,
              const int* __restrict__ counts, int leaves,
              float* __restrict__ out) {
    float total = 0.f;
    for (int i = 0; i < leaves; ++i) {
        float t = 0.f;
        for (int j = threadIdx.x; j < counts[i]; j += FINISH_THREADS)
            t = __fadd_rn(t, partials[j]);
        const float sum = block_sum<FINISH_THREADS>(t);
        total = __fadd_rn(total, sum);
        partials += counts[i];
    }
    if (threadIdx.x == 0) *out = total;
}

struct Consts {
    float b1, one_minus_b1, b2, one_minus_b2, eps, weight_decay;
};

// _leaf on one element, in its order of operations.
__device__ __forceinline__ void step(float& p, float g, float& m, float& v,
                                     float scale, float lr, float c1,
                                     float c2, const Consts& k) {
    g = __fmul_rn(g, scale);
    m = __fadd_rn(__fmul_rn(k.b1, m), __fmul_rn(k.one_minus_b1, g));
    v = __fadd_rn(__fmul_rn(k.b2, v),
                  __fmul_rn(__fmul_rn(k.one_minus_b2, g), g));
    const float upd = __fdiv_rn(
        __fdiv_rn(m, c1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c2)), k.eps));
    p = __fsub_rn(p, __fmul_rn(lr, __fadd_rn(upd,
                                             __fmul_rn(k.weight_decay, p))));
}

template <typename P, typename G, typename M>
__global__ void __launch_bounds__(THREADS)
update_kernel(P* __restrict__ p, const G* __restrict__ g, M* __restrict__ m,
              M* __restrict__ v, long long n, long long head, long long nvec,
              const float* __restrict__ scale_p, const float* __restrict__ lr_p,
              const float* __restrict__ c1_p, const float* __restrict__ c2_p,
              Consts k) {
    const float scale = *scale_p, lr = *lr_p, c1 = *c1_p, c2 = *c2_p;
    const long long units = n - nvec * (VEC - 1);  // vector + scalar units
    const long long stride = (long long)gridDim.x * THREADS;
    for (long long u = blockIdx.x * (long long)THREADS + threadIdx.x;
         u < units; u += stride) {
        if (u < nvec) {
            const long long i = head + u * VEC;
            float pp[VEC], gg[VEC], mm[VEC], vv[VEC];
            load8(p + i, pp);
            load8(g + i, gg);
            load8(m + i, mm);
            load8(v + i, vv);
#pragma unroll
            for (int j = 0; j < VEC; ++j)
                step(pp[j], gg[j], mm[j], vv[j], scale, lr, c1, c2, k);
            store8(p + i, pp);
            store8(m + i, mm);
            store8(v + i, vv);
        } else {
            const long long i = scalar_index(u - nvec, head, nvec);
            float pp = to_float(p[i]), mm = to_float(m[i]),
                  vv = to_float(v[i]);
            step(pp, to_float(g[i]), mm, vv, scale, lr, c1, c2, k);
            p[i] = from_float<P>(pp);
            m[i] = from_float<M>(mm);
            v[i] = from_float<M>(vv);
        }
    }
}

struct UpdateArgs {
    void* p;
    const void* g;
    void* m;
    void* v;
    long long n, head, nvec;
    const float *scale, *lr, *c1, *c2;
    Consts k;
    cudaStream_t stream;
};

template <typename P, typename G, typename M>
int launch_update(const UpdateArgs& a) {
    const long long units = a.n - a.nvec * (VEC - 1);
    long long blocks = (units + THREADS - 1) / THREADS;
    if (blocks > UPDATE_BLOCKS) blocks = UPDATE_BLOCKS;
    update_kernel<P, G, M><<<(unsigned)blocks, THREADS, 0, a.stream>>>(
        (P*)a.p, (const G*)a.g, (M*)a.m, (M*)a.v, a.n, a.head, a.nvec,
        a.scale, a.lr, a.c1, a.c2, a.k);
    return (int)cudaGetLastError();
}

template <typename P, typename G>
int update_for_moments(int m_dtype, const UpdateArgs& a) {
    return m_dtype == BF16 ? launch_update<P, G, bf16>(a)
                           : launch_update<P, G, float>(a);
}

template <typename P>
int update_for_grads(int g_dtype, int m_dtype, const UpdateArgs& a) {
    return g_dtype == BF16 ? update_for_moments<P, bf16>(m_dtype, a)
                           : update_for_moments<P, float>(m_dtype, a);
}

}  // namespace

extern "C" {

// Sums of squares of one leaf's gradient g (n elements of dtype g_dtype,
// 0 float32, 1 bfloat16) into partials[0, norm_blocks), one a block of
// NORM_BLOCK_UNITS vector units (fused.py::norm_blocks), and their number
// into *count (an int in device memory).  n > 0.  Launches on `stream` of
// `device`; does not synchronise.  Returns a cudaError_t.
int adamw_norm_leaf(int g_dtype, const void* g, long long n, long long head,
                    long long nvec, void* partials, void* count, int device,
                    void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const long long full = (nvec + NORM_BLOCK_UNITS - 1) / NORM_BLOCK_UNITS;
    const unsigned blocks = (unsigned)(full > 0 ? full : 1);
    cudaStream_t s = (cudaStream_t)stream;
    if (g_dtype == BF16)
        norm_kernel<bf16><<<blocks, THREADS, 0, s>>>(
            (const bf16*)g, n, head, nvec, (float*)partials, (int*)count);
    else
        norm_kernel<float><<<blocks, THREADS, 0, s>>>(
            (const float*)g, n, head, nvec, (float*)partials, (int*)count);
    return (int)cudaGetLastError();
}

// The sum of squares of the leaves whose partials adamw_norm_leaf wrote
// one leaf after the other from `partials`, their counts at `counts` (ints
// in device memory, in the same order), into out[0]; 0 for no leaf.
int adamw_norm_finish(const void* partials, const void* counts, int leaves,
                      void* out, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    finish_kernel<<<1, FINISH_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)partials, (const int*)counts, leaves, (float*)out);
    return (int)cudaGetLastError();
}

// One leaf's step: p (p_dtype), g (g_dtype), m and v (m_dtype), n > 0
// elements laid out as (head, nvec) says; scale, lr, c1 and c2 are float32
// scalars in device memory; the rest are the Python constants rounded to
// float.  Launches on `stream` of `device`; does not synchronise.
int adamw_update(int p_dtype, int g_dtype, int m_dtype, void* p,
                 const void* g, void* m, void* v, long long n, long long head,
                 long long nvec, const void* scale, const void* lr,
                 const void* c1, const void* c2, float b1, float one_minus_b1,
                 float b2, float one_minus_b2, float eps, float weight_decay,
                 int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const UpdateArgs a{p, g, m, v, n, head, nvec,
                       (const float*)scale, (const float*)lr,
                       (const float*)c1, (const float*)c2,
                       Consts{b1, one_minus_b1, b2, one_minus_b2, eps,
                              weight_decay},
                       (cudaStream_t)stream};
    return p_dtype == BF16 ? update_for_grads<bf16>(g_dtype, m_dtype, a)
                           : update_for_grads<float>(g_dtype, m_dtype, a);
}

const char* adamw_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// The passes' geometry, for the wrapper's layout (fused.py).
int adamw_vec(void) { return VEC; }

int adamw_align(void) { return ALIGN; }

long long adamw_norm_block_units(void) { return NORM_BLOCK_UNITS; }

}  // extern "C"
