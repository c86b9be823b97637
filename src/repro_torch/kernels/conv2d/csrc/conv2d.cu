// Single-channel same-size 2D cross-correlation for Hopper (sm_90a):
//   out[r, c] = weight * sum_{i<FH, j<FW} filt[i, j] * img[r + i - FH/2, c + j - FW/2]
// with zeros outside the image, summed in float32.  The image, the filter
// and the output are float32, or bfloat16 with IN_BF16.
//
// Replaces the Pallas TPU kernel body of the JAX package,
// src/repro/kernels/conv2d/conv2d.py::_conv_kernel, built by make_conv2d
// there with HALO_MODE="materialize".  The TPU kernel cannot overlap its
// BlockSpecs, so the JAX package stages overlapping halo tiles through
// HBM first (_materialise_tiles).  Here each block loads its own halo into
// shared memory: the paper's explicit local-memory caching (L$).
//
// One compiled library per configuration: the tunables arrive as -D
// defines, and the Python wrapper in ../conv2d.py builds, loads and
// launches it.
//
//   BLOCK_H, BLOCK_W  output tile owned by one block
//   SUB_H             output rows each thread sums at a time (the paper's
//                     work per thread)
//   UNROLL            1: every loop over the taps is unrolled at compile
//                     time; 0: the loop over filter rows is rolled
//                     (#pragma unroll 1), the taps of one row and the
//                     register window stay unrolled (a window held in
//                     registers cannot be indexed at run time)
//   PAD_W             16-byte quads of padding at the end of each
//                     shared-memory row (the paper's PAD)
//   FH, FW            the filter's shape
//   IN_BF16           1: the image, the filter and the output are bfloat16
//                     (else float32); the halo tile and the filter are
//                     staged in shared memory as float32 and every sum is
//                     float32, rounded once to bfloat16 on the store
//
// Thread geometry (conv2d.py::block_threads, ::micro_tile): TY = BLOCK_H /
// SUB_H row groups, TX = min(BLOCK_W, max(32, 256 / TY)) threads along a
// row, TX * TY threads a block.  Thread (tx, ty) owns rows ty*SUB_H ..
// ty*SUB_H + SUB_H - 1 and COLS = ceil(BLOCK_W / TX) columns, taken as
// GROUPS column groups of CG adjacent columns: group g covers tile columns
// g*CG*TX + tx*CG .. + CG - 1, so the TX threads of a row cover CG*TX
// adjacent columns and the groups cover the tile (columns at or past
// BLOCK_W are summed and not stored).  CG is the widest divisor of COLS,
// at most 8, whose register estimate (below) fits 64 registers; the
// groups are a rolled loop.
//
// What bounds it: 2*FH*FW FLOPs per output against 8 bytes of device
// traffic (read the image once, write the output once).  At 3x3 that is
// 2.25 FLOP a byte, far under the H100's 20 FLOP a byte of float32 FMA, so
// bytes bound it; at 11x11 (30 FLOP a byte) the FMAs do.  An SM retires
// 128 float32 FMAs a clock but its shared memory delivers 32 words a
// clock, so a kernel that reads an operand from shared memory for each FMA
// runs at a quarter of the FMA peak or less.  The design therefore keeps
// operands in registers: for each filter row i a thread loads the row's FW
// weights (FW rounded up to a quad, broadcast 16-byte loads), and for each
// of its SUB_H rows the CG + FW - 1 image values of input row row + s + i
// (a sliding window, 16-, 8- or 4-byte loads as CG allows), then does
// FW * CG FMAs from registers.  At 11x11 with CG = 8 that is 4.5 quad
// loads of image and 3 of weights for 88 FMAs (two shared loads for each
// FMA before).  Adjacent lanes own windows 8 floats apart, so a
// quarter-warp's 16-byte loads would hit each bank twice: with CG = 8 the
// tile's quads are stored swizzled (quad q at q ^ ((q >> 3) & 1)), which
// makes them conflict-free.  Each output's taps still go into one fmaf
// chain from 0 in (i, j) order, then are multiplied by weight: the sum of
// the TPU body and of the oracle, bit for bit.
//
// The weights stay in shared memory, read per filter row.  A __constant__
// copy made per launch would race when two streams launch one library with
// different filters, and ptxas fed the fully unrolled FMAs from uniform
// registers and spilled.
//
// Staging: warp w copies tile rows w, w + NWARPS, ... with 4-byte cp.async
// (src_size 0 writes the zeros outside the image), lane l columns l + 32m,
// so every copy of a thread is in flight at once and no register holds a
// value; the row and column checks are per row and per block.  Image
// columns are 16-byte aligned where the windows' shared-memory columns are
// not (they differ by FW/2), so the copies are 4 bytes.  A single-row
// thread (SUB_H = 1) whose register estimate fits 40 registers asks for
// 1536 resident threads an SM (__launch_bounds__), others for 1024 (64
// registers): while one block stages its halo, others compute.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#if !defined(BLOCK_H) || !defined(BLOCK_W) || !defined(FH) || !defined(FW)
#error "BLOCK_H, BLOCK_W, FH and FW must be defined"
#endif
#ifndef SUB_H
#define SUB_H 1
#endif
#ifndef UNROLL
#define UNROLL 1
#endif
#ifndef PAD_W
#define PAD_W 0
#endif
#ifndef IN_BF16
#define IN_BF16 0
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

namespace {

constexpr int TY = BLOCK_H / SUB_H;
constexpr int TX_WANT = 256 / TY > 32 ? 256 / TY : 32;
constexpr int TX = BLOCK_W < TX_WANT ? BLOCK_W : TX_WANT;
constexpr int NTHREADS = TX * TY;
constexpr int COLS = (BLOCK_W + TX - 1) / TX;  // columns a thread owns

// registers a thread needs, estimated as its sums, the windows of its
// SUB_H rows for one filter row (ptxas issues those loads together) and
// REG_OVERHEAD for addresses, weights in flight and loop state; calibrated
// on ptxas's counts.  conv2d.py::register_estimate holds the same model.
constexpr int REG_OVERHEAD = 8;
constexpr int REGISTERS = 64;        // 65536 an SM over 1024 threads
constexpr int REGISTERS_SMALL = 40;  // ... over 1536 threads, rounded down
constexpr int MAX_CG = 8;
constexpr int FWP = (FW + 3) / 4 * 4;           // a filter row, in quads

constexpr int vec_of(int cg) { return cg % 4 == 0 ? 4 : cg % 2 == 0 ? 2 : 1; }
constexpr int window_of(int cg) {
    return (cg + FW - 1 + vec_of(cg) - 1) / vec_of(cg) * vec_of(cg);
}
constexpr int regs_of(int cg) {
    return SUB_H * (cg + window_of(cg)) + REG_OVERHEAD;
}
constexpr int pick_cg() {
    for (int cg = COLS < MAX_CG ? COLS : MAX_CG; cg > 1; --cg)
        if (COLS % cg == 0 && regs_of(cg) <= REGISTERS) return cg;
    return 1;
}

constexpr int CG = pick_cg();                   // columns of one group
constexpr int GROUPS = COLS / CG;
constexpr int V = vec_of(CG);                   // floats a window load
constexpr int NV = window_of(CG) / V;           // loads a window
constexpr bool SWIZZLE = CG == 8;

constexpr int RESIDENT =
    SUB_H == 1 && regs_of(CG) <= REGISTERS_SMALL ? 1536 : 1024;
constexpr int MIN_BLOCKS_WANT =
    RESIDENT / NTHREADS > 0 ? RESIDENT / NTHREADS : 1;
constexpr int MIN_BLOCKS = MIN_BLOCKS_WANT < 32 ? MIN_BLOCKS_WANT : 32;

constexpr int TILE_H = BLOCK_H + FH - 1;
constexpr int TILE_W = BLOCK_W + FW - 1;  // columns staged from the image
// the columns the windows read, rounded up to whole quad pairs (the swizzle
// permutes quads within a pair)
constexpr int ROW = (COLS * TX + FW - 1 + 7) / 8 * 8;
constexpr int STRIDE = ROW + 4 * PAD_W;
constexpr int SMEM_FLOATS = TILE_H * STRIDE + FH * FWP;

static_assert(BLOCK_H % SUB_H == 0, "BLOCK_H divisible by SUB_H");
static_assert(NTHREADS <= 1024, "at most 1024 threads per block");

// where logical tile column c lies in a shared-memory row
__device__ __forceinline__ int phys(int c) {
    return SWIZZLE ? c ^ (((c >> 5) & 1) << 2) : c;
}

template <int N>
__device__ __forceinline__ void load_vec(float* dst, const float* src) {
    if constexpr (N == 4) {
        const float4 x = *reinterpret_cast<const float4*>(src);
        dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
    } else if constexpr (N == 2) {
        const float2 x = *reinterpret_cast<const float2*>(src);
        dst[0] = x.x; dst[1] = x.y;
    } else {
        dst[0] = *src;
    }
}

template <int N>
__device__ __forceinline__ void store_vec(float* dst, const float* src) {
    if constexpr (N == 4) {
        *reinterpret_cast<float4*>(dst) = make_float4(src[0], src[1], src[2],
                                                      src[3]);
    } else if constexpr (N == 2) {
        *reinterpret_cast<float2*>(dst) = make_float2(src[0], src[1]);
    } else {
        *dst = *src;
    }
}

// the FW * CG FMAs of one filter row for one output row: taps in j order
__device__ __forceinline__ void row_taps(float (&acc)[CG], const float* row,
                                         const int (&off)[NV],
                                         const float (&w)[FWP]) {
    float win[NV * V];
#pragma unroll
    for (int v = 0; v < NV; ++v) load_vec<V>(win + v * V, row + off[v]);
#pragma unroll
    for (int j = 0; j < FW; ++j)
#pragma unroll
        for (int k = 0; k < CG; ++k) acc[k] = fmaf(w[j], win[k + j], acc[k]);
}

// filter row i: its weights once, then each of the thread's rows
__device__ __forceinline__ void filter_row(float (&acc)[SUB_H][CG],
                                           const float* rows, const float* fi,
                                           const int (&off)[NV]) {
    float w[FWP];
#pragma unroll
    for (int q = 0; q < FWP / 4; ++q) load_vec<4>(w + 4 * q, fi + 4 * q);
#pragma unroll
    for (int s = 0; s < SUB_H; ++s)
        row_taps(acc[s], rows + s * STRIDE, off, w);
}

__device__ __forceinline__ void cp_async4(unsigned dst, const float* src,
                                          bool in) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(dst), "l"(src), "r"(in ? 4 : 0) : "memory");
}

// stage the halo tile: zeros outside the image and past TILE_W
__device__ __forceinline__ void stage_tile(float* tile,
                                           const elem_t* __restrict__ img,
                                           int H, int W, int r0, int c0,
                                           int tid) {
    constexpr int LANES = NTHREADS < 32 ? NTHREADS : 32;
    constexpr int NWARPS = NTHREADS / LANES;
    constexpr int M = (ROW + LANES - 1) / LANES;
    const int lane = tid % LANES, warp = tid / LANES;
    const int gr0 = r0 - FH / 2, gc0 = c0 - FW / 2;
    const bool cols_in = gc0 >= 0 && gc0 + TILE_W <= W;
#if !IN_BF16
    const unsigned base = (unsigned)__cvta_generic_to_shared(tile);
#endif
    if (warp < NWARPS) {
#pragma unroll 1
        for (int r = warp; r < TILE_H; r += NWARPS) {
            const int gr = gr0 + r;
            const bool row_in = gr >= 0 && gr < H;
            const elem_t* src =
                img + (size_t)(row_in ? gr : 0) * W + gc0 + lane;
#if !IN_BF16
            const unsigned dst = base + 4u * (unsigned)(r * STRIDE);
#endif
#pragma unroll
            for (int m = 0; m < M; ++m) {
                const int c = lane + LANES * m;
                if (c < ROW) {
                    const bool in = row_in && c < TILE_W &&
                                    (cols_in || (gc0 + c >= 0 && gc0 + c < W));
#if IN_BF16
                    tile[r * STRIDE + phys(c)] =
                        in ? to_f32(src[LANES * m]) : 0.f;
#else
                    cp_async4(dst + 4u * (unsigned)phys(c),
                              in ? src + LANES * m : img, in);
#endif
                }
            }
        }
    }
#if !IN_BF16
    asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

}  // namespace

__global__ void __launch_bounds__(NTHREADS, MIN_BLOCKS)
conv2d_kernel(const elem_t* __restrict__ img, const elem_t* __restrict__ filt,
              elem_t* __restrict__ out, int H, int W, float weight) {
    extern __shared__ __align__(16) float smem[];
    float* tile = smem;                      // [TILE_H][STRIDE], swizzled
    float* f = smem + TILE_H * STRIDE;       // [FH][FWP], zero padded

    const int r0 = blockIdx.y * BLOCK_H, c0 = blockIdx.x * BLOCK_W;
    const int tid = threadIdx.x;
    const int tx = tid % TX, ty = tid / TX;

    for (int idx = tid; idx < FH * FWP; idx += NTHREADS) {
        const int i = idx / FWP, j = idx % FWP;
        f[idx] = j < FW ? to_f32(filt[i * FW + j]) : 0.f;
    }
    stage_tile(tile, img, H, W, r0, c0, tid);
    __syncthreads();

    const int row0 = ty * SUB_H;
    const int lim = min(W, c0 + BLOCK_W);    // columns this block stores
#pragma unroll 1
    for (int g = 0; g < GROUPS; ++g) {
        const int cs = g * CG * TX + tx * CG;    // first tile column
        int off[NV];
#pragma unroll
        for (int v = 0; v < NV; ++v) off[v] = phys(cs + v * V);
        float acc[SUB_H][CG];
#pragma unroll
        for (int s = 0; s < SUB_H; ++s)
#pragma unroll
            for (int k = 0; k < CG; ++k) acc[s][k] = 0.f;
        // taps in (i, j) order into each float32 sum, as the TPU body adds
#if UNROLL
#pragma unroll
#else
#pragma unroll 1
#endif
        for (int i = 0; i < FH; ++i)
            filter_row(acc, tile + (row0 + i) * STRIDE, f + i * FWP, off);

        const int gc = c0 + cs;
#if !IN_BF16
        const bool whole = BLOCK_W % V == 0 && W % V == 0 && gc + CG <= lim;
#endif
#pragma unroll
        for (int s = 0; s < SUB_H; ++s) {
            const int gr = r0 + row0 + s;
            if (gr >= H) break;
            float o[CG];
#pragma unroll
            for (int k = 0; k < CG; ++k) o[k] = weight * acc[s][k];
            elem_t* dst = out + (size_t)gr * W + gc;
#if IN_BF16
#pragma unroll
            for (int k = 0; k < CG; ++k)
                if (gc + k < lim) dst[k] = from_f32(o[k]);
#else
            if (whole) {
#pragma unroll
                for (int v = 0; v < CG / V; ++v)
                    store_vec<V>(dst + v * V, o + v * V);
            } else {
#pragma unroll
                for (int k = 0; k < CG; ++k)
                    if (gc + k < lim) dst[k] = o[k];
            }
#endif
        }
    }
}

extern "C" {

// Launch on `stream` (a cudaStream_t) of CUDA device `device`; does not
// synchronise.  Returns a cudaError_t: 0 when the launch was accepted.
// The caller guarantees contiguous row-major img (H, W), filt (FH, FW) and
// out (H, W) on `device`, float32 (bfloat16 with IN_BF16), out 16-byte
// aligned.
int conv2d_launch(const void* img, const void* filt, void* out, int H, int W,
                  float weight, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const int smem = SMEM_FLOATS * (int)sizeof(float);
    err = cudaFuncSetAttribute(conv2d_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((W + BLOCK_W - 1) / BLOCK_W, (H + BLOCK_H - 1) / BLOCK_H);
    conv2d_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
        (const elem_t*)img, (const elem_t*)filt, (elem_t*)out, H, W, weight);
    return (int)cudaGetLastError();
}

const char* conv2d_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

int conv2d_smem_bytes(void) { return SMEM_FLOATS * (int)sizeof(float); }

int conv2d_threads(void) { return NTHREADS; }

// rows, columns and column groups of one thread's register tile
void conv2d_micro_tile(int* tile) {
    tile[0] = SUB_H;
    tile[1] = CG;
    tile[2] = GROUPS;
}

}  // extern "C"
