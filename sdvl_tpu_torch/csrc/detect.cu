// Fused FAST-9/16 + Shi-Tomasi detection with per-cell selection, for all
// detection levels of a frame in one launch (sm_90a).
//
// Replaces the Pallas kernel sdvl_tpu/ops/pallas/detect.py::fast_shi_tomasi_map
// (both of its call sites: the row-tiled kernel and the single-block one) and
// the per-cell selection that consumes its output (_grid_best in
// sdvl_tpu/ops/fast.py), under either of the reference's two border rules.
// For each level l of up to MAX_LEVELS it writes
//
//   map_l[y][x]  "pallas" rule (the Pallas kernel's): the Shi-Tomasi
//                min-eigenvalue score where the pixel passes the FAST segment
//                test, lies at least 4 px inside the image and scores above
//                st_threshold; -inf everywhere else.
//                "plain" rule (the reference's plain route, fast_corner_mask +
//                shi_tomasi): the score where the pixel passes the FAST test,
//                whatever the score, -inf elsewhere; no border is cut. FAST
//                reads edge-replicated pixels (clamped coordinates), the Sobel
//                derivatives wrap at the image edge in both axes (the
//                reference's roll), and the 4x4 box sums count zero outside
//                the image (its zero padding);
//   key_l[g]     for each cell g of the cropped (H / cell) x (W / cell) grid,
//                the largest key of its pixels (see cell_key): the highest
//                score wins, the smallest in-cell index cy * cell + cx breaks
//                ties, and a cell whose pixels are all -inf holds index 0.
//                Under the plain rule that is the best FAST corner whatever
//                its score; the caller applies the threshold.
//
// Bound: memory. The function must read each level once, write its map once
// and write 8 bytes per cell: 3.23 MB at the 480x640 / 240x320 / 120x160
// levels, 0.96 us at 3.35 TB/s; its ~77 float operations per pixel take about
// half that at the float32 peak. What it cannot hide is fixed cost: one launch
// costs more than the whole transfer, and a block's chain of dependent steps
// is long. The design:
//
// - One launch per frame. The level table goes by value in the kernel's
//   parameters; the grid is the sum of the levels' 32x32 tiles (300 + 80 + 20
//   = 400 blocks at the preset, about three per SM, one wave) and a block
//   finds its level from the levels' first-block offsets.
// - 32x32 output tiles, 256 threads, 4 pixels per thread (rows ty, ty + 8,
//   ty + 16, ty + 24; a warp is one 32-pixel row, so map stores coalesce).
//   A block stages its 40x40 halo tile once (1.56 x read amplification); its
//   barriers buy 1024 pixels.
// - Asynchronous 16-byte staging: cp.async.cg of 16 B chunks, then
//   cp.async.wait_all and a barrier, where the level's row pitch and base are
//   16-byte aligned (W % 4 == 0, the wrapper checks the pointer). Under the
//   pallas rule a chunk's start is clamped into the image; its contents then
//   only reach the 4-px border, which is written -inf (the stencil reaches 3
//   px), so any in-image value is right there. Under the plain rule the halo
//   holds the WRAPPED rows and columns, which the Sobel derivatives read:
//   with W % 4 == 0 a 16-byte chunk lies wholly inside or wholly outside the
//   image, so its wrapped start is aligned and its 4 pixels contiguous. FAST
//   reads the clamped in-image pixel instead, which lies within 3 px of the
//   pixel and so inside the staged tile. Other levels take 4-byte loads at
//   clamped (pallas) or wrapped (plain) coordinates. Not TMA: a 2D tensor map
//   per level per call would cost host time of the order of the whole
//   wrapper.
// - The structure tensor in shared memory, each value computed once per
//   block: the three products of the Sobel derivatives over the 35x35 region
//   the 4x4 box window reaches, then their vertical 4-sums, then per pixel
//   the horizontal 4-sum of those. That is the reference's own order (its box
//   sum runs down the columns first, each sum started from 0 and taken in
//   full, no sliding window), so the scores round exactly as the plain
//   version's; per pixel it is 12 shared loads and 12 adds instead of the
//   4x4 window's 32 loads, 48 products and 48 adds.
// - Cell selection in the epilogue: each pixel makes a 64-bit key (high 32
//   bits the order-preserving bits of its score, low 32 bits the complement
//   of its in-cell index). A warp whose 4 x 32 pixels fall in one cell
//   reduces in registers and shuffles first. Keys meet per (block, cell) in
//   shared memory in two passes of 32-bit atomicMax (the high words, then
//   the low words of the keys whose high word won), which measured faster
//   than one 64-bit atomicMax on shared memory.
//   Where the cell size divides the tile (32 % cell == 0, the preset's 32
//   among them) every cell lies in one block, which stores its key: no
//   zeroing, no global atomic. Otherwise a block may overlap several cells
//   and a cell span several blocks: one global atomicMax per overlapped cell
//   into a buffer the entry point zeroes on the same stream (0 is below every
//   real key). The maximum is order-independent, so the result is
//   deterministic despite the atomics.
//
// The float operation order follows the reference (0.25*(a + 2*b + c), box
// sums down the columns first, 0.5*(tr - sqrt(max(., 0)))/16); built with
// -fmad=false the maps are bit-identical to the plain version.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int MAX_LEVELS = 4;
constexpr int TILE = 32;                   // output tile: TILE x TILE pixels
constexpr int ROWS = 8;                    // thread rows of a block
constexpr int THREADS = TILE * ROWS;       // 256
constexpr int PX = TILE / ROWS;            // pixels per thread: 4
constexpr int HALO = 4;                    // FAST radius 3 < Sobel 1 + box 2 + 1
constexpr int SM_W = TILE + 2 * HALO;      // 40: staged rows and columns
constexpr int CHUNKS = SM_W / 4;           // 16-byte chunks per staged row
constexpr int D_LO = 2;                    // box window spans offsets -2..+1
constexpr int D_W = TILE + 3;              // 35: derivative rows and columns
constexpr int BORDER = 4;
constexpr int MAX_BLOCK_CELLS = TILE * TILE;   // cell = 1
constexpr unsigned FULL = 0xFFFFFFFFu;

struct Level {
    const float* img;
    float* out;
    unsigned long long* keys;   // this level's first cell
    int H, W, gh, gw;           // gh = H / cell, gw = W / cell (0 without cells)
    int tiles_x;
    int block0;                 // first block of this level
    int vec;                    // 1: 16-byte cp.async staging
};

struct Levels {
    Level lv[MAX_LEVELS];
    int n, cell;
    int owned;                  // 1: TILE % cell == 0, each cell in one block
    float fast_threshold, st_threshold;
    unsigned long long* launches;   // block 0 adds 1 per launch (or null)
};

// Bresenham circle of radius 3, the order of the reference's _CIRCLE.
__constant__ int c_circle_dx[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                                    0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int c_circle_dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3,
                                    3, 3, 2, 1, 0, -1, -2, -3};

__device__ __forceinline__ unsigned rot16(unsigned m, int k) {
    return ((m >> k) | (m << (16 - k))) & 0xFFFFu;
}

// True when the 16-bit circular mask holds a run of at least 9 set bits.
__device__ __forceinline__ bool has_arc9(unsigned m) {
    unsigned r = m & rot16(m, 1);   // runs of 2
    r = r & rot16(r, 2);            // runs of 4
    r = r & rot16(r, 4);            // runs of 8
    r = r & rot16(m, 8);            // runs of 9
    return r != 0u;
}

// Shi-Tomasi score of the pixel at tile row ry, column tx. s_v holds the
// vertical 4-sums of the three structure-tensor products: row ry, column
// tx + j for offset j - 2. The horizontal 4-sum of those in the reference's
// order, then the smaller eigenvalue, normalised as each rule's reference
// writes it (the same value: every factor is a power of two).
__device__ __forceinline__ float st_score(float (*s_v)[TILE][D_W], int ry,
                                          int tx, bool plain) {
    float dxx = 0.0f, dyy = 0.0f, dxy = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        dxx = dxx + s_v[0][ry][tx + j];
        dyy = dyy + s_v[1][ry][tx + j];
        dxy = dxy + s_v[2][ry][tx + j];
    }
    const float tr = dxx + dyy;
    const float diff = dxx - dyy;
    const float det_term = sqrtf(fmaxf(diff * diff + 4.0f * dxy * dxy, 0.0f));
    return plain ? ((0.5f * (tr - det_term)) * 0.03125f) * 2.0f
                 : 0.5f * (tr - det_term) / 16.0f;
}

// FAST-9/16 segment test of the image pixel (y, x), whose tile row and column
// are ry, tx. ``clamp``: the circle's samples at clamped image coordinates
// (edge replication; each lies within 3 px of the pixel, inside the staged
// tile), else straight from the staged halo.
__device__ __forceinline__ bool fast_corner(float (*s_img)[SM_W], int ry, int tx,
                                            int y, int x, int H, int W,
                                            bool clamp, float fast_threshold) {
    const float c = s_img[ry + HALO][tx + HALO];
    const float hi = c + fast_threshold;
    const float lo = c - fast_threshold;
    unsigned bright = 0u, dark = 0u;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
        int dy = c_circle_dy[k], dx = c_circle_dx[k];
        if (clamp) {
            dy = min(max(y + dy, 0), H - 1) - y;
            dx = min(max(x + dx, 0), W - 1) - x;
        }
        const float nb = s_img[ry + HALO + dy][tx + HALO + dx];
        bright |= (nb > hi ? 1u : 0u) << k;
        dark |= (nb < lo ? 1u : 0u) << k;
    }
    return has_arc9(bright) || has_arc9(dark);
}

// ((v mod n) + n) mod n: the reference's roll.
__device__ __forceinline__ int wrap(int v, int n) {
    v %= n;
    return v < 0 ? v + n : v;
}

// 64-bit cell key: the order-preserving bits of the score (-0.0 made +0.0;
// sign clear: bits | 0x80000000, sign set: ~bits) above the complement of
// the in-cell index, so the unsigned maximum is the highest score and, among
// equal scores, the smallest index. -inf keys are above 0.
__device__ __forceinline__ unsigned long long cell_key(float s, int idx) {
    unsigned b = __float_as_uint(s == 0.0f ? 0.0f : s);
    b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
    return (static_cast<unsigned long long>(b) << 32) | static_cast<unsigned>(~idx);
}

// PLAIN: the reference's plain border rule, else the Pallas kernel's (one
// instantiation each, so neither pays for the other's branches).
template <bool PLAIN>
__global__ void __launch_bounds__(THREADS)
detect_levels_kernel(const Levels P) {
    __shared__ __align__(16) float s_img[SM_W][SM_W];
    __shared__ float s_p[3][D_W][D_W];       // dx*dx, dy*dy, dx*dy
    __shared__ float s_v[3][TILE][D_W];      // their vertical 4-sums
    __shared__ unsigned s_hi[MAX_BLOCK_CELLS];
    __shared__ unsigned s_lo[MAX_BLOCK_CELLS];

    // This block's level: the last one whose first block is not after it.
    // (Static indices only, so the table stays in the parameter space.)
    Level L = P.lv[0];
#pragma unroll
    for (int i = 1; i < MAX_LEVELS; ++i)
        if (i < P.n && static_cast<int>(blockIdx.x) >= P.lv[i].block0) L = P.lv[i];

    const int tid = threadIdx.x;
    // the launch counts itself: a replayed graph runs no host code
    if (blockIdx.x == 0 && tid == 0 && P.launches != nullptr)
        atomicAdd(P.launches, 1ull);
    const int tx = tid & (TILE - 1), ty = tid / TILE;
    const int local = blockIdx.x - L.block0;
    const int by = local / L.tiles_x;
    const int x0 = (local - by * L.tiles_x) * TILE, y0 = by * TILE;
    const int H = L.H, W = L.W, cell = P.cell;
    constexpr bool plain = PLAIN;

    // The cells of the cropped grid this block overlaps.
    const int xe = min(x0 + TILE, L.gw * cell);
    const int ye = min(y0 + TILE, L.gh * cell);
    int cx_lo = 0, cy_lo = 0, ncx = 0, ncy = 0;
    if (xe > x0 && ye > y0) {
        cx_lo = x0 / cell;
        cy_lo = y0 / cell;
        ncx = (xe - 1) / cell - cx_lo + 1;
        ncy = (ye - 1) / cell - cy_lo + 1;
    }
    const int nc = ncx * ncy;
    for (int i = tid; i < nc; i += THREADS) s_hi[i] = s_lo[i] = 0u;

    // Stage 1: the tile plus its halo, chunk or pixel starts clamped (pallas)
    // or wrapped (plain).
    if (L.vec) {
        for (int i = tid; i < SM_W * CHUNKS; i += THREADS) {
            const int sy = i / CHUNKS, c = i - sy * CHUNKS;
            const int gy = plain ? wrap(y0 + sy - HALO, H)
                                 : min(max(y0 + sy - HALO, 0), H - 1);
            const int gx = plain ? wrap(x0 - HALO + 4 * c, W)
                                 : min(max(x0 - HALO + 4 * c, 0), W - 4);
            const float* src = L.img + static_cast<size_t>(gy) * W + gx;
            const unsigned dst = static_cast<unsigned>(
                __cvta_generic_to_shared(&s_img[sy][4 * c]));
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                         :: "r"(dst), "l"(src) : "memory");
        }
        asm volatile("cp.async.wait_all;\n" ::: "memory");
    } else {
        for (int sy = ty; sy < SM_W; sy += ROWS) {
            const int gy = plain ? wrap(y0 + sy - HALO, H)
                                 : min(max(y0 + sy - HALO, 0), H - 1);
            const float* row = L.img + static_cast<size_t>(gy) * W;
            for (int sx = tx; sx < SM_W; sx += TILE)
                s_img[sy][sx] = row[plain ? wrap(x0 + sx - HALO, W)
                                          : min(max(x0 + sx - HALO, 0), W - 1)];
        }
    }
    __syncthreads();

    // Stage 2: Sobel-smoothed central differences on the tile plus the ring
    // the 4x4 box window reaches (rows y0-2 .. y0+TILE, cols x0-2 ..
    // x0+TILE), and their three products; under the plain rule zero outside
    // the image (the box sums' zero padding; under the pallas rule only the
    // -inf border reads them).
    for (int i = tid; i < D_W * D_W; i += THREADS) {
        const int dyi = i / D_W, dxi = i - dyi * D_W;
        const int py = y0 + dyi - D_LO, px = x0 + dxi - D_LO;
        if (plain && (py < 0 || py >= H || px < 0 || px >= W)) {
            s_p[0][dyi][dxi] = s_p[1][dyi][dxi] = s_p[2][dyi][dxi] = 0.0f;
            continue;
        }
        const int sy = dyi - D_LO + HALO, sx = dxi - D_LO + HALO;
        // fx(y, x) = f(y, x+1) - f(y, x-1);  fy(y, x) = f(y+1, x) - f(y-1, x)
        const float fx_m = s_img[sy - 1][sx + 1] - s_img[sy - 1][sx - 1];
        const float fx_0 = s_img[sy][sx + 1] - s_img[sy][sx - 1];
        const float fx_p = s_img[sy + 1][sx + 1] - s_img[sy + 1][sx - 1];
        const float fy_m = s_img[sy + 1][sx - 1] - s_img[sy - 1][sx - 1];
        const float fy_0 = s_img[sy + 1][sx] - s_img[sy - 1][sx];
        const float fy_p = s_img[sy + 1][sx + 1] - s_img[sy - 1][sx + 1];
        const float gx = 0.25f * ((fx_m + 2.0f * fx_0) + fx_p);
        const float gy = 0.25f * ((fy_m + 2.0f * fy_0) + fy_p);
        s_p[0][dyi][dxi] = gx * gx;
        s_p[1][dyi][dxi] = gy * gy;
        s_p[2][dyi][dxi] = gx * gy;
    }
    __syncthreads();

    // Stage 2b: vertical 4-sums (offsets -2..+1) for every output row.
    for (int i = tid; i < TILE * D_W; i += THREADS) {
        const int r = i / D_W, c = i - r * D_W;
#pragma unroll
        for (int q = 0; q < 3; ++q) {
            float v = 0.0f;
#pragma unroll
            for (int k = 0; k < 4; ++k) v = v + s_p[q][r + k][c];
            s_v[q][r][c] = v;
        }
    }
    __syncthreads();

    // Stage 3: four pixels per thread; map store, then the cell keys.
    const int x = x0 + tx;
    const bool x_inner = x >= BORDER && x < W - BORDER;
    const bool x_cell = x < xe;
    int lcx = 0, icx = 0;
    if (x_cell) {
        lcx = x / cell - cx_lo;
        icx = x - (lcx + cx_lo) * cell;
    }
    unsigned long long key[PX];
    int slot[PX];
#pragma unroll
    for (int k = 0; k < PX; ++k) {
        const int ry = ty + ROWS * k;
        const int y = y0 + ry;
        float v = -CUDART_INF_F;
        if (x < W && y < H) {
            if constexpr (plain) {
                const bool edge = x < 3 || x >= W - 3 || y < 3 || y >= H - 3;
                if (fast_corner(s_img, ry, tx, y, x, H, W, edge,
                                P.fast_threshold))
                    v = st_score(s_v, ry, tx, true);
            } else if (x_inner && y >= BORDER && y < H - BORDER) {
                const float s = st_score(s_v, ry, tx, false);
                if (s > P.st_threshold
                    && fast_corner(s_img, ry, tx, y, x, H, W, false,
                                   P.fast_threshold))
                    v = s;
            }
            L.out[static_cast<size_t>(y) * W + x] = v;
        }
        slot[k] = -1;
        key[k] = 0ull;
        if (x_cell && y < ye) {
            const int gy = y / cell;
            slot[k] = (gy - cy_lo) * ncx + lcx;
            key[k] = cell_key(v, (y - gy * cell) * cell + icx);
        }
    }

    // Where the warp's 4 x 32 pixels are one cell: one contribution per
    // warp, reduced in registers and shuffles; else one per pixel.
    bool same = true;
#pragma unroll
    for (int k = 1; k < PX; ++k) same = same && slot[k] == slot[0];
    const int slot0 = __shfl_sync(FULL, slot[0], 0);
    if (__all_sync(FULL, same && slot[0] == slot0)) {
#pragma unroll
        for (int k = 1; k < PX; ++k) {
            key[0] = key[k] > key[0] ? key[k] : key[0];
            slot[k] = -1;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const unsigned long long other = __shfl_xor_sync(FULL, key[0], off);
            key[0] = other > key[0] ? other : key[0];
        }
        if (tx != 0) slot[0] = -1;
    }
    // The (block, cell) maximum: high words first, then the low words of
    // the keys whose high word won.
#pragma unroll
    for (int k = 0; k < PX; ++k)
        if (slot[k] >= 0)
            atomicMax(&s_hi[slot[k]], static_cast<unsigned>(key[k] >> 32));
    __syncthreads();
#pragma unroll
    for (int k = 0; k < PX; ++k)
        if (slot[k] >= 0 && s_hi[slot[k]] == static_cast<unsigned>(key[k] >> 32))
            atomicMax(&s_lo[slot[k]], static_cast<unsigned>(key[k]));
    __syncthreads();

    // Stage 4: each overlapped cell's key, stored where the block owns the
    // cell, else one global atomicMax.
    for (int i = tid; i < nc; i += THREADS) {
        const int ly = i / ncx, lx = i - ly * ncx;
        unsigned long long* dst =
            &L.keys[static_cast<size_t>(cy_lo + ly) * L.gw + cx_lo + lx];
        const unsigned long long k64 =
            (static_cast<unsigned long long>(s_hi[i]) << 32) | s_lo[i];
        if (P.owned)
            *dst = k64;
        else
            atomicMax(dst, k64);
    }
}

}  // namespace

// Plain C entry point. ``imgs``/``outs`` hold ``n`` (1..4) device pointers to
// contiguous (H, W) float32 arrays; ``dims`` holds H, W and the 16-byte
// staging flag of each level; ``plain`` picks the border rule (1: the
// reference's plain route, 0: its Pallas kernel's); ``keys`` is a device
// buffer of
// sum_l (H_l / cell) * (W_l / cell) uint64 words (``cell`` = 0: maps only, no
// keys), zeroed here on ``stream`` before the launch unless each cell lies in
// one block. ``launches``, where not null, is a device uint64 that the
// kernel adds 1 to each time it runs (a launch replayed from a CUDA graph
// included). Launches without synchronising and returns a cudaError_t as an
// int (0 = success).
extern "C" int sdvl_detect_levels(const void* const* imgs, void* const* outs,
                                  const int* dims, int n, int cell, int plain,
                                  float fast_threshold, float st_threshold,
                                  void* keys, void* launches,
                                  void* stream) {
    if (n < 1 || n > MAX_LEVELS || cell < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    Levels P{};
    P.n = n;
    P.cell = cell;
    P.owned = cell > 0 && TILE % cell == 0;
    P.fast_threshold = fast_threshold;
    P.st_threshold = st_threshold;
    P.launches = static_cast<unsigned long long*>(launches);
    int blocks = 0;
    size_t n_cells = 0;
    for (int l = 0; l < n; ++l) {
        Level& L = P.lv[l];
        L.img = static_cast<const float*>(imgs[l]);
        L.out = static_cast<float*>(outs[l]);
        L.keys = static_cast<unsigned long long*>(keys) + n_cells;
        L.H = dims[3 * l];
        L.W = dims[3 * l + 1];
        L.vec = dims[3 * l + 2];
        L.gh = cell > 0 ? L.H / cell : 0;
        L.gw = cell > 0 ? L.W / cell : 0;
        L.tiles_x = (L.W + TILE - 1) / TILE;
        L.block0 = blocks;
        blocks += L.tiles_x * ((L.H + TILE - 1) / TILE);
        n_cells += static_cast<size_t>(L.gh) * L.gw;
    }
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n_cells > 0 && !P.owned) {
        const cudaError_t err = cudaMemsetAsync(keys, 0, n_cells * 8, s);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    if (plain)
        detect_levels_kernel<true><<<blocks, THREADS, 0, s>>>(P);
    else
        detect_levels_kernel<false><<<blocks, THREADS, 0, s>>>(P);
    return static_cast<int>(cudaGetLastError());
}
