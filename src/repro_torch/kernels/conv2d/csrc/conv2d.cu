// Single-channel same-size 2D cross-correlation for Hopper (sm_90a):
//   out[r, c] = weight * sum_{i<FH, j<FW} filt[i, j] * img[r + i - FH/2, c + j - FW/2]
// with zeros outside the image, summed in float32.  The image, the filter
// and the output are float32 (the FMA route), or bfloat16 with IN_BF16 (the
// tensor-core route, mma.sync).
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
//   SUB_H             float32: output rows each thread sums at a time (the
//                     paper's work per thread); bfloat16: row groups of 8
//                     each warp sums at a time, at most 4 (below)
//   UNROLL            1: every loop over the taps is unrolled at compile
//                     time; 0: the loop over filter rows is rolled
//                     (#pragma unroll 1), the taps of one row and the
//                     register window stay unrolled (a window held in
//                     registers cannot be indexed at run time)
//   PAD_W             float32: 16-byte quads of padding at the end of each
//                     shared-memory row (the paper's PAD); bfloat16: pairs
//                     of 16-byte chunks, so a row keeps its odd count
//   FH, FW            the filter's shape
//   IN_BF16           1: the image, the filter and the output are bfloat16
//                     (else float32); every product is exact in float32,
//                     every sum float32, rounded once to bfloat16 on the
//                     store
//
// bfloat16 (IN_BF16): a banded ("Toeplitz") product on mma.sync.
// m16n8k16.row.col.f32.bf16.bf16.f32.  2*FH*FW operations an output
// against 4 bytes (read the image once, write the output once): at the
// H100's 989 TFLOP/s bfloat16 rate and 3.35 TB/s, bytes bound every
// filter up to ~25x25, and the FMA units' 67 TFLOP/s would not (their
// floor at 11x11 is three times the byte time).  So the products go to
// the tensor cores, which take only matrix products:
//
// * For filter row i, 16 adjacent output columns c0 + 16t .. + 15 of 8
//   output rows are one m16n8 tile C = T_i X: X (K x 8, k the input
//   column, n the output row) is the staged image rows r + i - FH/2 over
//   K = 16*KS input columns starting at the staging origin plus 16t, and
//   T_i (16 x K) is the band T_i[m, k] = f[i, k - m - OFF] inside
//   0 <= k - m - OFF < FW, 0 elsewhere.  The staging origin is the column
//   at or below c0 - FW/2 that lies as c0 does against 8 columns (16-byte
//   aligned when BLOCK_W is a multiple of 8), so OFF = (-(FW/2)) mod 8 is
//   one constant of the build and every ldmatrix row address stays 16-byte
//   aligned in shared memory; the band absorbs it.  A block sums CB =
//   ceil(BLOCK_W / 16) column blocks; columns past BLOCK_W are summed and
//   not stored.
//   KS = ceil((OFF + FW + 15) / 16) k-steps: 2 for every odd filter up to
//   17 wide, so any filter the float32 build takes still builds.
// * Orientation: M = 16 output columns, A = the band, N = 8 output rows,
//   B = image fragments.  ldmatrix takes one address a lane, so a filter
//   row's shift of the image rows is free and the band has one phase (the
//   other orientation, the band as B, needs a phase for even and odd n8
//   column blocks).  The image fragment of columns 16p .. 16p + 15 is
//   k-step s of column block p - s: a warp walking NB adjacent column
//   blocks loads NB + KS - 1 image fragments a row group and filter row for
//   NB * KS products.  The C fragment comes out transposed against the
//   image (a lane holds two rows of one column), so the output goes back
//   through shared memory for 16-byte row stores.
// * Useful products are FW / (16 * KS) of those issued (9 % at 3x3, 22 %
//   at 7x7, 34 % at 11x11): the band's zeros.  At 11x11 that is still
//   ~340 TFLOP/s of effective peak against the FMA units' 67.
// * Warps own tiles (conv2d.py::warp_tile): RG = min(SUB_H, 4,
//   ceil(BLOCK_H / 8)) row groups of 8 rows by NB column blocks of 16, NB
//   the widest divisor of CB with RG * NB <= 8 (32 float32 sums
//   a lane).  Eight row groups of one column block (SUB_H 8) spilled at
//   512 threads: ptxas kept the next filter row's image fragments of
//   every group live beside the sums, so a warp takes at most four.
//   Rows past BLOCK_H (BLOCK_H below 8 * RG) are summed over staged rows
//   and not stored.  A warp loads its filter row's KS band fragments once
//   (ldmatrix.x4) for its RG * NB tiles, and two image fragments a
//   ldmatrix.x4.
// * Staging: the halo tile, ROWS + FH - 1 rows of 16 * (CB +
//   KS - 1) columns, is staged as bfloat16 by 16-byte cp.async (src-size 0
//   writes the zeros outside the image); every column the products read is
//   staged, since a zero of the band times garbage could be NaN (and a
//   non-finite input reaches outputs up to K columns away).  Where W or
//   BLOCK_W is no multiple of 8, or an operand is not 16-byte aligned, an
//   element path in the kernel stages and stores instead.  Rows are padded
//   to an odd number of 16-byte chunks, so the 8 rows one ldmatrix reads
//   fall on 8 bank groups.  The band is built once a block in shared
//   memory while the tile is in flight: the filter rows zero padded first,
//   then 16-byte chunks of the band from them (FH * 16 * K bfloat16, 11 KB
//   at 11x11).
// * What bounds it: at 3x3 and 7x7 bytes; at 11x11 the mma issue (22
//   products for 128 outputs over the 11 filter rows, each fed by ~1.6
//   shared-memory wavefronts at NB = 8).  Blocks stage and compute in
//   turns; several blocks an SM overlap one's staging with another's
//   products.  At 3x3 a block's fixed work (the band, four barriers, the
//   output's round trip through shared memory) is what the design leaves
//   in the way of the byte bound.
// * The sums: each product is exact in float32 and summed in float32 by the
//   tensor core, the band's zeros adding nothing, in filter-row order; only
//   the order of the float32 sum differs from conv2d_plain's, which
//   rounds the same float32 sum once to bfloat16 after weight.  Not yet:
//   wgmma, TMA.
//
// float32: the FMA route.
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
// ---------------------------------------------------------------------------
// bfloat16: the banded product on mma.sync (the tensor cores)
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 elem_t;

namespace {

constexpr int OFF = (8 - (FW / 2) % 8) % 8;      // conv2d.py::band_offset
constexpr int KS = (OFF + FW + 15 + 15) / 16;    // k-steps of 16 (::k_steps)
constexpr int KW = 16 * KS;                      // the band's width
constexpr int ROWS8 = (BLOCK_H + 7) / 8;         // row groups of the block
constexpr int MAX_RG = 4;                        // ... one warp sums at most
constexpr int RG_WANT = SUB_H < MAX_RG ? SUB_H : MAX_RG;
constexpr int RG = RG_WANT < ROWS8 ? RG_WANT : ROWS8;    // ... of one warp
constexpr int WARPS_Y = (ROWS8 + RG - 1) / RG;
constexpr int ROWS = 8 * RG * WARPS_Y;           // rows summed (>= BLOCK_H)
constexpr int CB = (BLOCK_W + 15) / 16;          // column blocks of 16
constexpr int MAX_TILES = 8;                     // m16n8 tiles a warp holds
constexpr int pick_nb() {
    for (int nb = MAX_TILES / RG; nb > 1; --nb)
        if (CB % nb == 0) return nb;
    return 1;
}
constexpr int NB = pick_nb();                    // column blocks of a warp
constexpr int WARPS_X = CB / NB;
constexpr int NTHREADS = 32 * WARPS_X * WARPS_Y;
constexpr int NCH = NB + KS - 1;                 // image fragments a row group
constexpr int TILE_H = ROWS + FH - 1;
constexpr int SPAN = 16 * (CB + KS - 1);         // columns staged
constexpr int CHUNKS = SPAN / 8;                 // 16-byte chunks of a row
constexpr int STRIDE = 8 * (CHUNKS + 1 + 2 * PAD_W);  // an odd chunk count
constexpr int BSTRIDE = KW + 8;                  // band rows: odd chunks too
constexpr int ZW = KW + 16;                      // a zero-padded filter row
constexpr int OSTRIDE = 16 * CB + 8;             // the output stage's rows
constexpr int TILE_ELEMS = TILE_H * STRIDE;
constexpr int BAND_ELEMS = FH * 16 * BSTRIDE;

// what the build exports (conv2d_smem_bytes, conv2d_micro_tile)
constexpr int SMEM_BYTES = 2 * (TILE_ELEMS + BAND_ELEMS + FH * ZW);
constexpr int TILE0 = RG, TILE1 = NB, TILE2 = KS;

static_assert(BLOCK_H % SUB_H == 0, "BLOCK_H divisible by SUB_H");
static_assert(NTHREADS <= 1024, "at most 1024 threads per block");
static_assert(ROWS * OSTRIDE <= TILE_ELEMS, "the output stage fits the tile");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool in) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(in ? 16 : 0) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const elem_t* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
                 "{%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2(unsigned (&r)[4], const elem_t* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
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

// stage image rows r0 - FH/2 .. and columns s0 .. s0 + SPAN - 1, zeros
// outside the image: 16-byte cp.async when `vec` (every chunk then lies
// wholly inside or wholly outside the image), else element by element
__device__ __forceinline__ void stage_tile(elem_t* tile,
                                           const elem_t* __restrict__ img,
                                           int H, int W, int r0, int s0,
                                           int tid, bool vec) {
    const int gr0 = r0 - FH / 2;
    if (vec) {
        const unsigned base = smem_addr(tile);
        for (int idx = tid; idx < TILE_H * CHUNKS; idx += NTHREADS) {
            const int r = idx / CHUNKS, q = idx % CHUNKS;
            const int gr = gr0 + r, gc = s0 + 8 * q;
            const bool in = gr >= 0 && gr < H && gc >= 0 && gc < W;
            cp_async16(base + 2u * (unsigned)(r * STRIDE + 8 * q),
                       in ? img + (size_t)gr * W + gc : img, in);
        }
    } else {
        for (int idx = tid; idx < TILE_H * SPAN; idx += NTHREADS) {
            const int r = idx / SPAN, c = idx % SPAN;
            const int gr = gr0 + r, gc = s0 + c;
            tile[r * STRIDE + c] = gr >= 0 && gr < H && gc >= 0 && gc < W
                                       ? img[(size_t)gr * W + gc]
                                       : __ushort_as_bfloat16(0);
        }
    }
}

// the band of every filter row, band[i][m][k] = f[i, k - m - OFF] (zero
// outside the filter), 16-byte chunks built from the zero-padded filter
// rows z[i][x] = f[i, x - 15 - OFF]
__device__ __forceinline__ void build_band(elem_t* band, elem_t* z,
                                           const elem_t* __restrict__ filt,
                                           int tid) {
    for (int idx = tid; idx < FH * ZW; idx += NTHREADS) {
        const int i = idx / ZW, j = idx % ZW - 15 - OFF;
        z[idx] = j >= 0 && j < FW ? filt[i * FW + j] : __ushort_as_bfloat16(0);
    }
    __syncthreads();
    const unsigned short* zs = reinterpret_cast<const unsigned short*>(z);
    constexpr int QW = KW / 8;                   // chunks of a band row
    for (int idx = tid; idx < FH * 16 * QW; idx += NTHREADS) {
        const int q = idx % QW, m = (idx / QW) % 16, i = idx / (16 * QW);
        const unsigned short* src = zs + i * ZW + 8 * q - m + 15;
        unsigned w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
            w[e] = (unsigned)src[2 * e] | ((unsigned)src[2 * e + 1] << 16);
        *reinterpret_cast<uint4*>(band + (i * 16 + m) * BSTRIDE + 8 * q) =
            make_uint4(w[0], w[1], w[2], w[3]);
    }
}

}  // namespace

__global__ void __launch_bounds__(NTHREADS)
conv2d_kernel(const elem_t* __restrict__ img, const elem_t* __restrict__ filt,
              elem_t* __restrict__ out, int H, int W, float weight) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    elem_t* tile = reinterpret_cast<elem_t*>(smem_raw);  // [TILE_H][STRIDE]
    elem_t* band = tile + TILE_ELEMS;                     // [FH][16][BSTRIDE]
    elem_t* z = band + BAND_ELEMS;                        // [FH][ZW]

    const int r0 = blockIdx.y * BLOCK_H, c0 = blockIdx.x * BLOCK_W;
    const int tid = threadIdx.x;
    // 16-byte copies need whole chunks in a row, blocks that start on a
    // chunk, and aligned operands
    const bool vec = BLOCK_W % 8 == 0 && W % 8 == 0
                     && (reinterpret_cast<size_t>(img) & 15) == 0
                     && (reinterpret_cast<size_t>(out) & 15) == 0;

    // the staging origin: the column at or below c0 - FW/2 that lies as c0
    // does against 8 columns
    stage_tile(tile, img, H, W, r0, c0 - FW / 2 - OFF, tid, vec);
    build_band(band, z, filt, tid);              // while the tile lands
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();

    const int lane = tid & 31, warp = tid >> 5;
    const int y0 = (warp / WARPS_X) * RG * 8;    // the warp's first row
    const int t0 = (warp % WARPS_X) * NB;        // ... and column block
    float acc[RG][NB][4];
#pragma unroll
    for (int g = 0; g < RG; ++g)
#pragma unroll
        for (int t = 0; t < NB; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[g][t][e] = 0.f;

    // ldmatrix row addresses: the band's A fragment (row lane % 16, k chunk
    // lane / 16); two image fragments a .x4 (image row lane % 8, k chunk
    // (lane / 8) % 2, the next fragment for lanes 16-31)
    const elem_t* ba = band + (lane & 15) * BSTRIDE + (lane >> 4) * 8;
    const elem_t* xa = tile + (y0 + (lane & 7)) * STRIDE + 16 * t0
                       + ((lane >> 3) & 1) * 8 + (lane >> 4) * 16;
#if UNROLL
#pragma unroll
#else
#pragma unroll 1
#endif
    for (int i = 0; i < FH; ++i) {
        unsigned a[KS][4];
#pragma unroll
        for (int s = 0; s < KS; ++s)
            ldsm_x4(a[s], ba + i * 16 * BSTRIDE + 16 * s);
#pragma unroll
        for (int g = 0; g < RG; ++g) {
            const elem_t* xr = xa + (i + 8 * g) * STRIDE;
#pragma unroll
            for (int p = 0; p < NCH; p += 2) {
                unsigned b[4];
                if (p + 1 < NCH) ldsm_x4(b, xr + 16 * p);
                else ldsm_x2(b, xr + 16 * p);
                // fragment p + h is k-step s of column block p + h - s
#pragma unroll
                for (int h = 0; h < 2; ++h)
#pragma unroll
                    for (int s = 0; s < KS; ++s) {
                        const int t = p + h - s;
                        if (p + h < NCH && t >= 0 && t < NB)
                            mma_k16(acc[g][t], a[s], b[2 * h], b[2 * h + 1]);
                    }
            }
        }
    }

    // the C fragments through shared memory (lane: rows c2, c2 + 1 of
    // columns g, g + 8 of each tile), then 16-byte row stores
    __syncthreads();                             // every warp is done reading
    elem_t* ost = tile;                          // [ROWS][OSTRIDE]
    const int gq = lane >> 2, c2 = 2 * (lane & 3);
#pragma unroll
    for (int g = 0; g < RG; ++g)
#pragma unroll
        for (int t = 0; t < NB; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                ost[(y0 + 8 * g + c2 + (e & 1)) * OSTRIDE + 16 * (t0 + t) + gq
                    + 8 * (e >> 1)] = __float2bfloat16_rn(weight * acc[g][t][e]);
    __syncthreads();
    constexpr int OQ = (BLOCK_W + 7) / 8;        // 16-byte chunks of a row
    for (int idx = tid; idx < BLOCK_H * OQ; idx += NTHREADS) {
        const int y = idx / OQ, q = idx % OQ;
        const int gr = r0 + y, gc = c0 + 8 * q;
        if (gr >= H || gc >= W) continue;
        const elem_t* src = ost + y * OSTRIDE + 8 * q;
        elem_t* dst = out + (size_t)gr * W + gc;
        if (vec) {
            *reinterpret_cast<uint4*>(dst) =
                *reinterpret_cast<const uint4*>(src);
        } else {
            for (int e = 0; e < 8 && gc + e < W
                            && (BLOCK_W % 8 == 0 || 8 * q + e < BLOCK_W); ++e)
                dst[e] = src[e];
        }
    }
}

#else
// ---------------------------------------------------------------------------
// float32: the FMA route
// ---------------------------------------------------------------------------

typedef float elem_t;
__device__ __forceinline__ float to_f32(elem_t x) { return x; }
__device__ __forceinline__ elem_t from_f32(float x) { return x; }

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

// what the build exports (conv2d_smem_bytes, conv2d_micro_tile)
constexpr int SMEM_BYTES = SMEM_FLOATS * (int)sizeof(float);
constexpr int TILE0 = SUB_H, TILE1 = CG, TILE2 = GROUPS;

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
    const unsigned base = (unsigned)__cvta_generic_to_shared(tile);
    if (warp < NWARPS) {
#pragma unroll 1
        for (int r = warp; r < TILE_H; r += NWARPS) {
            const int gr = gr0 + r;
            const bool row_in = gr >= 0 && gr < H;
            const elem_t* src =
                img + (size_t)(row_in ? gr : 0) * W + gc0 + lane;
            const unsigned dst = base + 4u * (unsigned)(r * STRIDE);
#pragma unroll
            for (int m = 0; m < M; ++m) {
                const int c = lane + LANES * m;
                if (c < ROW) {
                    const bool in = row_in && c < TILE_W &&
                                    (cols_in || (gc0 + c >= 0 && gc0 + c < W));
                    cp_async4(dst + 4u * (unsigned)phys(c),
                              in ? src + LANES * m : img, in);
                }
            }
        }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
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
        const bool whole = BLOCK_W % V == 0 && W % V == 0 && gc + CG <= lim;
#pragma unroll
        for (int s = 0; s < SUB_H; ++s) {
            const int gr = r0 + row0 + s;
            if (gr >= H) break;
            float o[CG];
#pragma unroll
            for (int k = 0; k < CG; ++k) o[k] = weight * acc[s][k];
            elem_t* dst = out + (size_t)gr * W + gc;
            if (whole) {
#pragma unroll
                for (int v = 0; v < CG / V; ++v)
                    store_vec<V>(dst + v * V, o + v * V);
            } else {
#pragma unroll
                for (int k = 0; k < CG; ++k)
                    if (gc + k < lim) dst[k] = o[k];
            }
        }
    }
}

#endif  // IN_BF16

extern "C" {

// Launch on `stream` (a cudaStream_t) of CUDA device `device`; does not
// synchronise.  Returns a cudaError_t: 0 when the launch was accepted.
// The caller guarantees contiguous row-major img (H, W), filt (FH, FW) and
// out (H, W) on `device`, float32 (bfloat16 with IN_BF16), out 16-byte
// aligned in float32.
int conv2d_launch(const void* img, const void* filt, void* out, int H, int W,
                  float weight, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const int smem = SMEM_BYTES;
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

int conv2d_smem_bytes(void) { return SMEM_BYTES; }

int conv2d_threads(void) { return NTHREADS; }

// float32: rows, columns and column groups of one thread's register tile;
// bfloat16: row groups, column blocks and k-steps of one warp's tile
void conv2d_micro_tile(int* tile) {
    tile[0] = TILE0;
    tile[1] = TILE1;
    tile[2] = TILE2;
}

}  // extern "C"
