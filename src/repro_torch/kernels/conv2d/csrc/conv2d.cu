// Single-channel same-size 2D cross-correlation for Hopper (sm_90a):
//   out[r, c] = weight * sum_{i<FH, j<FW} filt[i, j] * img[r + i - FH/2, c + j - FW/2]
// with zeros outside the image, float32 throughout.
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
//                     work per thread): SUB_H float32 accumulators
//   UNROLL            1: the FH x FW taps are unrolled at compile time;
//                     0: one rolled loop over the taps (#pragma unroll 1)
//   PAD_W             floats of padding at the end of each shared-memory
//                     row (the paper's PAD)
//   FH, FW            the filter's shape
//
// Thread geometry: TY = BLOCK_H / SUB_H row groups, TX = min(BLOCK_W,
// max(32, 256 / TY)) threads along a row; a block has TX * TY threads,
// and thread (tx, ty) sums rows ty*SUB_H .. ty*SUB_H + SUB_H - 1 of the
// tile at columns tx, tx + TX, ... < BLOCK_W.  Neighbouring threads take
// neighbouring columns, so their loads and stores are coalesced.
//
// What bounds it: 2*FH*FW FLOPs per output against 8 bytes of device
// traffic (read the image once, write the output once).  At 3x3 that is
// 2.25 FLOP a byte, far under the H100's 20 FLOP a byte of float32 FMA, so
// bytes bound it; at 11x11 (30 FLOP a byte) the FMAs do.  The design reads
// each image element from device memory about once per block (the halo
// overlap adds (FH-1)/BLOCK_H + (FW-1)/BLOCK_W), keeps every tap's operand
// in shared memory and the filter in shared memory, read as a broadcast.
// No double buffering, no TMA yet: a right, simple kernel first.

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

#define TY (BLOCK_H / SUB_H)
#define TX_WANT (256 / TY > 32 ? 256 / TY : 32)
#define TX (BLOCK_W < TX_WANT ? BLOCK_W : TX_WANT)
#define NTHREADS (TX * TY)
#define TILE_H (BLOCK_H + FH - 1)
#define TILE_W (BLOCK_W + FW - 1)
#define STRIDE (TILE_W + PAD_W)
#define SMEM_FLOATS (TILE_H * STRIDE + FH * FW)

static_assert(BLOCK_H % SUB_H == 0, "BLOCK_H divisible by SUB_H");
static_assert(NTHREADS <= 1024, "at most 1024 threads per block");

__global__ void __launch_bounds__(NTHREADS)
conv2d_kernel(const float* __restrict__ img, const float* __restrict__ filt,
              float* __restrict__ out, int H, int W, float weight) {
    extern __shared__ float smem[];
    float* tile = smem;                      // [TILE_H][STRIDE]
    float* f = smem + TILE_H * STRIDE;       // [FH][FW]

    const int r0 = blockIdx.y * BLOCK_H, c0 = blockIdx.x * BLOCK_W;
    const int tid = threadIdx.x;
    const int tx = tid % TX, ty = tid / TX;

    // stage the halo tile, zeros outside the image
    for (int idx = tid; idx < TILE_H * TILE_W; idx += NTHREADS) {
        const int r = idx / TILE_W, c = idx % TILE_W;
        const int gr = r0 - FH / 2 + r, gc = c0 - FW / 2 + c;
        tile[r * STRIDE + c] = (gr >= 0 && gr < H && gc >= 0 && gc < W)
                                   ? img[(size_t)gr * W + gc] : 0.f;
    }
    for (int idx = tid; idx < FH * FW; idx += NTHREADS) f[idx] = filt[idx];
    __syncthreads();

    const int row = ty * SUB_H;
    for (int c = tx; c < BLOCK_W; c += TX) {
        float acc[SUB_H];
#pragma unroll
        for (int s = 0; s < SUB_H; ++s) acc[s] = 0.f;
        // taps in (i, j) order into each float32 sum, as the TPU body adds
#if UNROLL
#pragma unroll
        for (int i = 0; i < FH; ++i)
#pragma unroll
            for (int j = 0; j < FW; ++j) {
                const float w = f[i * FW + j];
#pragma unroll
                for (int s = 0; s < SUB_H; ++s)
                    acc[s] = fmaf(w, tile[(row + s + i) * STRIDE + c + j],
                                  acc[s]);
            }
#else
#pragma unroll 1
        for (int t = 0; t < FH * FW; ++t) {
            const int i = t / FW, j = t % FW;
            const float w = f[t];
#pragma unroll
            for (int s = 0; s < SUB_H; ++s)
                acc[s] = fmaf(w, tile[(row + s + i) * STRIDE + c + j], acc[s]);
        }
#endif
        const int gc = c0 + c;
#pragma unroll
        for (int s = 0; s < SUB_H; ++s) {
            const int gr = r0 + row + s;
            if (gr < H && gc < W) out[(size_t)gr * W + gc] = weight * acc[s];
        }
    }
}

extern "C" {

// Launch on `stream` (a cudaStream_t) of CUDA device `device`; does not
// synchronise.  Returns a cudaError_t: 0 when the launch was accepted.
// The caller guarantees contiguous row-major float32 img (H, W), filt
// (FH, FW) and out (H, W) on `device`.
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
        (const float*)img, (const float*)filt, (float*)out, H, W, weight);
    return (int)cudaGetLastError();
}

const char* conv2d_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

int conv2d_smem_bytes(void) { return SMEM_FLOATS * (int)sizeof(float); }

int conv2d_threads(void) { return NTHREADS; }

}  // extern "C"
