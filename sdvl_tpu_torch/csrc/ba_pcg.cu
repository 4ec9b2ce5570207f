// The whole-map BA's CG iteration (solvers/ba.py::_schur_solve_cg) as three
// kernels that read W and W V^-1 where they lie.
//
// What they replace: no Pallas kernel. The reference applies the reduced
// camera system S p with two einsums (sdvl_tpu/solvers/ba.py:_schur_solve_cg,
// `matvec`) that XLA fuses on the TPU. In eager PyTorch on the card each
// einsum first copies its (P, K, 6, 3) operand into a transposed layout and
// then runs one GEMV on the copy: at the Zurich map's shape (P 4096, K 1000)
// that is 590 MB written and read again every CG iteration, before the 590
// MB the products need.
//
// What bounds them: bytes. A CG iteration has to read Wm and WVinv once
// each, P * K * 72 bytes apiece (295 MB at the Zurich shape: 0.088 ms at
// 3.35 TB/s); their operations (4 per element) are worth microseconds.
// The vectors are K * 6 floats (24 KB), and the tail's work is a few
// hundred kilobytes.
//
// The design:
//   wt_x     t_p = sum_{k,i} Wm[p,k,i,:] (mask * x)[k,i], (P, 3). A warp
//            streams one point's row (K * 18 contiguous floats) with
//            16-byte loads, neighbouring lanes on neighbouring addresses,
//            four loads in flight a lane; element e of a row takes x[e / 3]
//            and goes to sum e mod 3. The block stages the masked x in
//            shared memory once for its eight warps, which walk the points
//            (the wrapper launches four blocks an SM).
//   wvinv_t  s_k = sum_p WVinv[p,k,:,:] t_p, (K, 6). A block takes a tile
//            of 64 consecutive slots (4608 contiguous bytes a point, one
//            16-byte load a thread) by a chunk of 128 points, keeps four
//            sums a thread in registers and writes its tile's (64, 6)
//            partial sums to the chunk's row of a scratch buffer. The last
//            block of a tile to finish (an integer ticket, no float
//            atomics) sums the tile's partials in chunk order into s and
//            sets the ticket back to 0 for the next launch: the same bits
//            on every replay, whichever block comes last.
//   cg_tail  the rest of one CG iteration in one block of 1024 threads, a
//            thread per slot: Ap = free (U_d (free p) - s) + (1 - free)
//            (free p), p.Ap, alpha, x, r, z = Dinv r, r.z, beta, p, rz and
//            the iteration count, in place, with solvers/ba.py's frozen
//            lane (a carry whose condition is false is left as it is) and
//            its clamps. Sums over the block are warp butterflies and then
//            the warps' sums in warp order.
// Float32 loads and sums on the CUDA cores (the library is built with no
// multiply-add contraction); no atomics on floats anywhere.
//
// Each launch adds 1 to its kernel's counter (three uint64 at `counter`:
// wt_x, wvinv_t, cg_tail), from block 0. Each function returns the launch's
// cudaError_t as an int (0 = success) and never synchronises.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                   // wt_x: warps (points) a block
constexpr int kTileSlots = 64;              // wvinv_t: slots a tile
constexpr int kTileFloats = kTileSlots * 18;
constexpr int kTileThreads = kTileFloats / 4;   // 288: a float4 each
constexpr int kChunkPoints = 128;           // wvinv_t: points a chunk
constexpr int kTailThreads = 1024;
constexpr int kUnroll = 4;                  // loads in flight a thread

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;   // the same bits in every lane (each add is commutative)
}

// Sum of v over the block, the same in every thread; `red` holds a float
// for each warp.
__device__ __forceinline__ float block_sum(float v, float* red) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    v = warp_sum(v);
    if (lane == 0) red[warp] = v;
    __syncthreads();
    float total = 0.0f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += red[w];
    __syncthreads();
    return total;
}

// torch.clamp_min(v, lo): NaN stays NaN (fmaxf would give lo).
__device__ __forceinline__ float clamp_min(float v, float lo) {
    return v < lo ? lo : v;
}

// Adds the four products of elements 4q..4q+3 of a row to the sums by
// element mod 3; r = q mod 3 is the first element's, xb and xb1 the x of
// elements at e / 3 = 4q / 3 and 4q / 3 + 1.
__device__ __forceinline__ void fold4(float4 w, int r, float xb, float xb1,
                                      float& a0, float& a1, float& a2) {
    // r = 0: x b b b b+1, sums 0 1 2 0; r = 1: b b b+1 b+1, 1 2 0 1;
    // r = 2: b b+1 b+1 b+1, 2 0 1 2
    const float v0 = w.x * xb;
    const float v1 = w.y * (r == 2 ? xb1 : xb);
    const float v2 = w.z * (r == 0 ? xb : xb1);
    const float v3 = w.w * xb1;
    const float first = v0 + v3;   // elements 0 and 3 share a sum
    a0 += r == 0 ? first : (r == 1 ? v2 : v1);
    a1 += r == 1 ? first : (r == 2 ? v2 : v1);
    a2 += r == 2 ? first : (r == 0 ? v2 : v1);
}

template <bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
wt_x_kernel(const float* __restrict__ wm, const float* __restrict__ x,
            const float* __restrict__ mask, float* __restrict__ t, int P,
            int K, unsigned long long* counter) {
    extern __shared__ float xs[];   // the masked x, K * 6
    const int n6 = K * 6;
    for (int e = threadIdx.x; e < n6; e += blockDim.x)
        xs[e] = mask ? x[e] * mask[e / 6] : x[e];
    if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(counter, 1ull);
    __syncthreads();
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long n = (long long)K * 18;
    for (int p = blockIdx.x * kWarps + warp; p < P;
         p += gridDim.x * kWarps) {
        float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
        if (kVec) {   // K even: every row starts on 16 bytes
            const float4* row =
                reinterpret_cast<const float4*>(wm + (long long)p * n);
            const int nq = (int)(n / 4);
            int q = lane;
            for (; q + 32 * (kUnroll - 1) < nq; q += 32 * kUnroll) {
                float4 w[kUnroll];
#pragma unroll
                for (int u = 0; u < kUnroll; ++u)
                    w[u] = __ldcs(row + q + 32 * u);
#pragma unroll
                for (int u = 0; u < kUnroll; ++u) {
                    // b + 1 = (4qu + 3) / 3 is the last element's: within x
                    const int qu = q + 32 * u, b = (4 * qu) / 3;
                    fold4(w[u], qu % 3, xs[b], xs[b + 1], a0, a1, a2);
                }
            }
            for (; q < nq; q += 32) {
                // b + 1 = (4q + 3) / 3 is the last element's: within x
                const int b = (4 * q) / 3;
                fold4(__ldcs(row + q), q % 3, xs[b], xs[b + 1], a0, a1, a2);
            }
        } else {
            const float* row = wm + (long long)p * n;
            for (int e = lane; e < (int)n; e += 32) {
                const float v = __ldcs(row + e) * xs[e / 3];
                const int j = e % 3;
                a0 += j == 0 ? v : 0.0f;
                a1 += j == 1 ? v : 0.0f;
                a2 += j == 2 ? v : 0.0f;
            }
        }
        a0 = warp_sum(a0);
        a1 = warp_sum(a1);
        a2 = warp_sum(a2);
        if (lane == 0) {
            t[3 * p] = a0;
            t[3 * p + 1] = a1;
            t[3 * p + 2] = a2;
        }
    }
}

template <bool kVec>
__global__ void __launch_bounds__(kTileThreads)
wvinv_t_kernel(const float* __restrict__ wv, const float* __restrict__ t,
               float* __restrict__ partial, unsigned int* tickets,
               float* __restrict__ s, int P, int K,
               unsigned long long* counter) {
    __shared__ float ts[kChunkPoints * 3];
    __shared__ float acc[kTileFloats];
    __shared__ bool last;
    const int tile = blockIdx.x, chunk = blockIdx.y, tid = threadIdx.x;
    const int p0 = chunk * kChunkPoints;
    const int np = min(kChunkPoints, P - p0);
    for (int i = tid; i < np * 3; i += blockDim.x) ts[i] = t[3 * p0 + i];
    if (tile == 0 && chunk == 0 && tid == 0) atomicAdd(counter, 1ull);
    __syncthreads();

    const long long n = (long long)K * 18;
    // this thread's elements: e0 .. e0 + 3 of each point's row, e0 a
    // multiple of 4; the tile starts on a multiple of 18, so element
    // e0 + c takes t[(r + c) mod 3], r = e0 mod 3 = tid mod 3
    const long long e0 = (long long)tile * kTileFloats + 4 * tid;
    const int r = tid % 3, j1 = (r + 1) % 3, j2 = (r + 2) % 3;
    float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, c3 = 0.0f;
    const float* base = wv + (long long)p0 * n + e0;
    if (kVec) {   // K even: a float4 is all in the row or all out
        if (e0 < n) {
            int p = 0;
            for (; p + kUnroll <= np; p += kUnroll) {
                float4 w[kUnroll];
#pragma unroll
                for (int u = 0; u < kUnroll; ++u)
                    w[u] = __ldcs(reinterpret_cast<const float4*>(
                        base + (long long)(p + u) * n));
#pragma unroll
                for (int u = 0; u < kUnroll; ++u) {
                    const float* tp = ts + 3 * (p + u);
                    c0 += w[u].x * tp[r];
                    c1 += w[u].y * tp[j1];
                    c2 += w[u].z * tp[j2];
                    c3 += w[u].w * tp[r];
                }
            }
            for (; p < np; ++p) {
                const float4 w = __ldcs(reinterpret_cast<const float4*>(
                    base + (long long)p * n));
                const float* tp = ts + 3 * p;
                c0 += w.x * tp[r];
                c1 += w.y * tp[j1];
                c2 += w.z * tp[j2];
                c3 += w.w * tp[r];
            }
        }
    } else {
        for (int p = 0; p < np; ++p) {
            const float* row = base + (long long)p * n;
            const float* tp = ts + 3 * p;
            if (e0 < n) c0 += __ldcs(row) * tp[r];
            if (e0 + 1 < n) c1 += __ldcs(row + 1) * tp[j1];
            if (e0 + 2 < n) c2 += __ldcs(row + 2) * tp[j2];
            if (e0 + 3 < n) c3 += __ldcs(row + 3) * tp[r];
        }
    }
    acc[4 * tid] = c0;
    acc[4 * tid + 1] = c1;
    acc[4 * tid + 2] = c2;
    acc[4 * tid + 3] = c3;
    __syncthreads();

    // the tile's (64, 6) sums of this chunk, slots past K left out
    const int k0 = tile * kTileSlots;
    const int outs = min(kTileSlots, K - k0) * 6;
    float* mine = partial + (long long)chunk * K * 6 + k0 * 6;
    for (int o = tid; o < outs; o += blockDim.x)
        mine[o] = acc[3 * o] + acc[3 * o + 1] + acc[3 * o + 2];
    __threadfence();
    __syncthreads();
    if (tid == 0)
        last = atomicAdd(tickets + tile, 1u) == gridDim.y - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    const int n_chunks = gridDim.y;
    for (int o = tid; o < outs; o += blockDim.x) {
        const float* col = partial + k0 * 6 + o;
        float v = 0.0f;
#pragma unroll 8
        for (int c = 0; c < n_chunks; ++c)
            v += __ldcg(col + (long long)c * K * 6);
        s[k0 * 6 + o] = v;
    }
    if (tid == 0) tickets[tile] = 0u;
}

__global__ void __launch_bounds__(kTailThreads)
cg_tail_kernel(const float* __restrict__ s, const float* __restrict__ ud,
               const float* __restrict__ dinv, const float* __restrict__ fr,
               float* __restrict__ x, float* __restrict__ r,
               float* __restrict__ p, float* rz, int* it, const int* max_it,
               const float* tol, int K, unsigned long long* counter) {
    extern __shared__ float buf[];   // Ap, then z, K * 6
    __shared__ float red[kTailThreads / 32];
    if (threadIdx.x == 0) atomicAdd(counter, 1ull);
    const float rz0 = *rz;
    const int i0 = *it;
    const bool active = (i0 < *max_it) && (rz0 > *tol);

    // Ap = free (U_d (free p) - s) + (1 - free) (free p), and p . Ap
    float pap = 0.0f;
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
        const float f = fr[k];
        float pm[6];
#pragma unroll
        for (int i = 0; i < 6; ++i) pm[i] = p[6 * k + i] * f;
        const float* u = ud + 36 * k;
#pragma unroll
        for (int i = 0; i < 6; ++i) {
            float y = 0.0f;
#pragma unroll
            for (int j = 0; j < 6; ++j) y += u[6 * i + j] * pm[j];
            y = y - s[6 * k + i];
            const float ap = y * f + pm[i] * (1.0f - f);
            buf[6 * k + i] = ap;
            pap += p[6 * k + i] * ap;
        }
    }
    pap = block_sum(pap, red);
    float alpha = rz0 / clamp_min(pap, 1e-30f);
    alpha = active ? alpha : 0.0f;

    // x += alpha p, r -= alpha Ap, z = Dinv r, and r . z
    float rzl = 0.0f;
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
        float rk[6];
#pragma unroll
        for (int i = 0; i < 6; ++i) {
            x[6 * k + i] = x[6 * k + i] + alpha * p[6 * k + i];
            rk[i] = r[6 * k + i] - alpha * buf[6 * k + i];
            r[6 * k + i] = rk[i];
        }
        const float* d = dinv + 36 * k;
#pragma unroll
        for (int i = 0; i < 6; ++i) {
            float z = 0.0f;
#pragma unroll
            for (int j = 0; j < 6; ++j) z += d[6 * i + j] * rk[j];
            buf[6 * k + i] = z;
            rzl += rk[i] * z;
        }
    }
    const float rz_new = block_sum(rzl, red);
    const float beta = rz_new / clamp_min(rz0, 1e-30f);

    if (active)
        for (int k = threadIdx.x; k < K; k += blockDim.x)
#pragma unroll
            for (int i = 0; i < 6; ++i)
                p[6 * k + i] = buf[6 * k + i] + beta * p[6 * k + i];
    // every thread read rz and it before block_sum's barriers
    if (threadIdx.x == 0) {
        if (active) *rz = rz_new;
        *it = i0 + (active ? 1 : 0);
    }
}

// Dynamic shared memory above 48 KB needs the kernel's attribute raised.
// A refusal is returned and cleared, so that it is not reported again by
// the next launch's cudaGetLastError.
template <typename F>
cudaError_t allow_shared(F kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) cudaGetLastError();
    return err;
}

}  // namespace

extern "C" int sdvl_ba_wt_x(const void* wm, const void* x, const void* mask,
                            void* t, int P, int K, int blocks, int vec,
                            void* counter, void* stream) {
    const size_t smem = (size_t)K * 6 * sizeof(float);
    auto kernel = vec ? &wt_x_kernel<true> : &wt_x_kernel<false>;
    cudaError_t err = allow_shared(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<blocks, kWarps * 32, smem, (cudaStream_t)stream>>>(
        (const float*)wm, (const float*)x, (const float*)mask, (float*)t, P,
        K, (unsigned long long*)counter);
    return (int)cudaGetLastError();
}

extern "C" int sdvl_ba_wvinv_t(const void* wv, const void* t, void* partial,
                               void* tickets, void* s, int P, int K, int vec,
                               void* counter, void* stream) {
    const dim3 grid((K + kTileSlots - 1) / kTileSlots,
                    (P + kChunkPoints - 1) / kChunkPoints);
    auto kernel = vec ? &wvinv_t_kernel<true> : &wvinv_t_kernel<false>;
    kernel<<<grid, kTileThreads, 0, (cudaStream_t)stream>>>(
        (const float*)wv, (const float*)t, (float*)partial,
        (unsigned int*)tickets, (float*)s, P, K,
        (unsigned long long*)counter);
    return (int)cudaGetLastError();
}

extern "C" int sdvl_ba_cg_tail(const void* s, const void* ud,
                               const void* dinv, const void* fr, void* x,
                               void* r, void* p, void* rz, void* it,
                               const void* max_it, const void* tol, int K,
                               void* counter, void* stream) {
    const size_t smem = (size_t)K * 6 * sizeof(float);
    cudaError_t err = allow_shared(&cg_tail_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    cg_tail_kernel<<<1, kTailThreads, smem, (cudaStream_t)stream>>>(
        (const float*)s, (const float*)ud, (const float*)dinv,
        (const float*)fr, (float*)x, (float*)r, (float*)p, (float*)rz,
        (int*)it, (const int*)max_it, (const float*)tol, K,
        (unsigned long long*)counter);
    return (int)cudaGetLastError();
}
