// Batched small symmetric eigensolver (one warp per matrix) and 3x3 SVD
// (one thread per matrix, in registers).
//
// The two-view bootstrap solves three small dense problems: the smallest
// eigenvector of the 9x9 A^T A of each homography hypothesis (a batch of
// 128) and of each weighted refit, the SVD of the chosen 3x3 homography
// (the Faugeras decomposition), and the smallest eigenvector of the 3x3
// covariance of the ground plane's inliers. torch.linalg.eigh and svd on
// CUDA read cuSOLVER's `info` back to the host, which a CUDA graph capture
// refuses; these kernels read nothing back.
//
//   sdvl_eigh(A, w, V, batch, n, rounds, counter, stream)
//     A (batch, n, n) float32 symmetric (the lower triangle is read), n <= 9;
//     w (batch, n) eigenvalues ascending, V (batch, n, n) the eigenvectors
//     as columns (V[b, :, k] belongs to w[b, k]), as torch.linalg.eigh
//     gives them. Parallel (round-robin) Jacobi in float64. `rounds` is a
//     host array of int8, the pairing schedule of ops/cuda/small_eig.py
//     `jacobi_rounds(n)`: m - 1 rounds of m / 2 disjoint pairs (p, q),
//     p < q < m, m = n rounded up to even; a pair with q = n (odd n) is the
//     padding and does nothing. It travels by value in the kernel's
//     parameters, so a captured launch holds its own copy. A pair rotates
//     unless |a_pq| <= 1e-15 (|a_pp| + |a_qq|); sweeps (m - 1 rounds each)
//     stop after one in which no pair rotated, at most MAX_SWEEPS.
//   sdvl_svd3(A, U, S, Vh, batch, counter, stream)
//     A (batch, 3, 3) float32; U (batch, 3, 3), S (batch, 3) descending
//     (ties in index order, as eigh orders them), Vh (batch, 3, 3) with
//     A = U diag(S) Vh, as torch.linalg.svd gives them. One-sided
//     (Hestenes) Jacobi in float64: each sweep rotates the column pairs
//     (0,1), (0,2), (1,2) of B = A V in turn, a pair unless
//     (b_p . b_q)^2 <= 1e-30 |b_p|^2 |b_q|^2, and the sweeps stop after one
//     in which no pair rotated, at most MAX_SWEEPS; S are B's column norms,
//     U their directions; a column whose norm vanishes takes the unit
//     vector that completes U to a right-handed orthonormal basis.
//
// What bounds eigh_kernel on an H100, and its design. A 9x9 matrix is 324
// bytes in and 360 out; its time is the latency of a dependent chain of
// about 50-90 Jacobi rounds (6-8 sweeps of 9 rounds for the DLT's A^T A),
// each a float64 division-sqrt-division-sqrt-division chain followed by two
// passes over shared memory. So what counts is parallelism across SMs (one
// one-warp block per matrix: the RANSAC batch of 128 takes 128 SMs, not one
// block of one), parallelism inside a matrix (the m / 2 rotations of a
// round are disjoint and run at once, their row and column updates spread
// over the 32 lanes) and short latencies (A and V in shared memory, lanes
// synchronised by __syncwarp only; no per-thread array indexed at run time,
// so nothing goes to local memory). Lane k computes pair k's rotation and
// the lanes that update the pair's rows and columns take it by shuffle:
// the warp runs one division-sqrt chain per round (where each lane
// computed the rotations of its own two items, the lanes with a second one
// ran a second chain after the first). wgmma, TMA and asynchronous copies
// have nothing to carry at these sizes (a matrix is 324 bytes, and a
// rotation is not a product of tensor-core shape); they are not used.
//
// Simultaneous rotations: an entry a[p][r] with p and r in two rotated
// pairs is changed by both. The row pass (A <- J^T A) finishes, behind a
// __syncwarp, before the column pass (A <- A J, V <- V J) reads, and the
// column pass finishes before the next round reads.
//
// Signs of eigen- and singular vectors are the kernel's own, as LAPACK's
// and cuSOLVER's differ from each other; the callers do not depend on them.
// Each launch adds 1 to the uint64 *counter (block 0, thread 0), so a launch
// replayed from a CUDA graph counts too. Each function returns a cudaError_t
// as an int (0 = success). Nothing here synchronises or allocates.
//
// The port's own kernel: it replaces no Pallas kernel of the reference,
// whose eigh/svd are XLA's (sdvl_tpu/solvers/homography.py:39,100,
// sdvl_tpu/core/geometry.py:217).

#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

#define MAX_N 9
#define MAX_M 10              // MAX_N rounded up to even
#define MAX_SWEEPS 30
#define THREADS 128           // svd3_kernel: threads per block
#define WARP 32
#define STRIDE 11             // row stride of A and V in shared memory, in
                              // doubles: odd, so lanes walking a column of
                              // A or V fall on distinct banks
#define EIGH_BLOCKS 528       // at most 4 one-warp blocks per SM of an
                              // H100's 132; a larger batch loops
#define ROUND_BYTES ((MAX_M - 1) * (MAX_M / 2) * 2)

__device__ static void count_launch(unsigned long long* counter) {
    if (counter != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
        atomicAdd(counter, 1ull);
}

// the pairing schedule, by value: round r's pair k is (pq[2 (r m/2 + k)],
// pq[2 (r m/2 + k) + 1])
struct Rounds {
    signed char pq[ROUND_BYTES];
};

// The rotation that zeroes a_pq, as the serial cyclic Jacobi computes it;
// false where the pair is skipped (or is the padding).
__device__ static bool jacobi_rotation(const double* a, int p, int q, int n,
                                       double* c, double* s) {
    if (q >= n) return false;
    const double apq = a[p * STRIDE + q];
    const double app = a[p * STRIDE + p], aqq = a[q * STRIDE + q];
    if (apq == 0.0 || fabs(apq) <= 1e-15 * (fabs(app) + fabs(aqq)))
        return false;
    const double theta = (aqq - app) / (2.0 * apq);
    const double t = (theta >= 0.0 ? 1.0 : -1.0)
        / (fabs(theta) + sqrt(theta * theta + 1.0));
    *c = 1.0 / sqrt(t * t + 1.0);
    *s = t * *c;
    return true;
}

// One warp per matrix (blockDim.x == WARP), blocks striding over the batch.
// A round's work items are (pair k, index x), k < m / 2, x < n, item
// e = k n + x; lane l takes items l and l + 32 (m / 2 * n <= 45), with the
// rotation of their pairs from the lanes that computed it.
__global__ void __launch_bounds__(WARP)
eigh_kernel(const float* __restrict__ A, float* __restrict__ w,
            float* __restrict__ V, int batch, int n,
            const __grid_constant__ Rounds rounds,
            unsigned long long* counter) {
    __shared__ double a[MAX_N * STRIDE], v[MAX_N * STRIDE];
    __shared__ signed char pq[ROUND_BYTES];
    count_launch(counter);
    const unsigned full = 0xffffffffu;
    const int lane = threadIdx.x;
    const int half = (n + (n & 1)) / 2, n_rounds = 2 * half - 1;
    const int items = half * n;
    // this lane's pair (whose rotation it computes) and its two items
    // (pair k0, index x0) and (k1, x1), the same in every round
    const int own = lane % half;
    const int k0 = lane / n < half ? lane / n : 0;
    const int k1 = (lane + WARP) / n < half ? (lane + WARP) / n : 0;
    const int x0 = lane - k0 * n, x1 = lane + WARP - k1 * n;
    const bool item0 = lane < items, item1 = lane + WARP < items;
    for (int i = lane; i < 2 * half * n_rounds; i += WARP)
        pq[i] = rounds.pq[i];
    for (int b = blockIdx.x; b < batch; b += gridDim.x) {
        const float* a_in = A + static_cast<size_t>(b) * n * n;
        for (int e = lane; e < n * n; e += WARP) {
            const int i = e / n, j = e - i * n;
            if (i >= j) {       // the lower triangle, mirrored
                const double x = static_cast<double>(a_in[e]);
                a[i * STRIDE + j] = x;
                a[j * STRIDE + i] = x;
            }
            v[i * STRIDE + j] = i == j ? 1.0 : 0.0;
        }
        __syncwarp();
        for (int sweep = 0; sweep < MAX_SWEEPS; ++sweep) {
            bool rotated = false;
            for (int r = 0; r < n_rounds; ++r) {
                // lane k < m / 2 computes the rotation of pair k from the
                // round's A (the other lanes repeat pair k mod m / 2 in
                // step with it, so the warp runs one chain, not several)
                const int o = 2 * (r * half + own);
                double c = 1.0, s = 0.0;
                const bool rot = jacobi_rotation(a, pq[o], pq[o + 1], n, &c,
                                                 &s) && lane < half;
                rotated = rotated || rot;
                const unsigned mask = __ballot_sync(full, rot);
                if (mask == 0) continue;        // no pair of the round rotates
                const bool rot0 = item0 && (mask >> k0 & 1u);
                const bool rot1 = item1 && (mask >> k1 & 1u);
                const int p0 = pq[2 * (r * half + k0)];
                const int q0 = pq[2 * (r * half + k0) + 1];
                const int p1 = pq[2 * (r * half + k1)];
                const int q1 = pq[2 * (r * half + k1) + 1];
                const double c0 = __shfl_sync(full, c, k0);
                const double s0 = __shfl_sync(full, s, k0);
                const double c1 = __shfl_sync(full, c, k1);
                const double s1 = __shfl_sync(full, s, k1);
                // an item that does not rotate reads a[0][0] and writes
                // nothing; all four reads of a pass issue before its writes
                // (the two items touch different entries)
                const int rp0 = rot0 ? p0 * STRIDE + x0 : 0;
                const int rq0 = rot0 ? q0 * STRIDE + x0 : 0;
                const int rp1 = rot1 ? p1 * STRIDE + x1 : 0;
                const int rq1 = rot1 ? q1 * STRIDE + x1 : 0;
                const int cp0 = rot0 ? x0 * STRIDE + p0 : 0;
                const int cq0 = rot0 ? x0 * STRIDE + q0 : 0;
                const int cp1 = rot1 ? x1 * STRIDE + p1 : 0;
                const int cq1 = rot1 ? x1 * STRIDE + q1 : 0;
                __syncwarp();
                {   // row pass, A <- J^T A: rows p and q at column x
                    const double ap0 = a[rp0], aq0 = a[rq0];
                    const double ap1 = a[rp1], aq1 = a[rq1];
                    if (rot0) {
                        a[rp0] = c0 * ap0 - s0 * aq0;
                        a[rq0] = s0 * ap0 + c0 * aq0;
                    }
                    if (rot1) {
                        a[rp1] = c1 * ap1 - s1 * aq1;
                        a[rq1] = s1 * ap1 + c1 * aq1;
                    }
                }
                __syncwarp();
                {   // column pass, A <- A J and V <- V J: columns p and q at
                    // row x; a_pq and a_qp are set to 0
                    const double ap0 = a[cp0], aq0 = a[cq0];
                    const double ap1 = a[cp1], aq1 = a[cq1];
                    const double vp0 = v[cp0], vq0 = v[cq0];
                    const double vp1 = v[cp1], vq1 = v[cq1];
                    if (rot0) {
                        a[cp0] = x0 == q0 ? 0.0 : c0 * ap0 - s0 * aq0;
                        a[cq0] = x0 == p0 ? 0.0 : s0 * ap0 + c0 * aq0;
                        v[cp0] = c0 * vp0 - s0 * vq0;
                        v[cq0] = s0 * vp0 + c0 * vq0;
                    }
                    if (rot1) {
                        a[cp1] = x1 == q1 ? 0.0 : c1 * ap1 - s1 * aq1;
                        a[cq1] = x1 == p1 ? 0.0 : s1 * ap1 + c1 * aq1;
                        v[cp1] = c1 * vp1 - s1 * vq1;
                        v[cq1] = s1 * vp1 + c1 * vq1;
                    }
                }
                __syncwarp();
            }
            if (!__any_sync(full, rotated)) break;
        }
        // eigenvalues ascending, ties in index order: lane k < n writes
        // a_kk at its rank, and the lanes write column k of V at k's rank
        int rank = 0;
        double wk = 0.0;
        if (lane < n) {
            wk = a[lane * STRIDE + lane];
            for (int j = 0; j < n; ++j) {
                const double wj = a[j * STRIDE + j];
                rank += wj < wk || (wj == wk && j < lane);
            }
            w[static_cast<size_t>(b) * n + rank] = static_cast<float>(wk);
        }
        float* v_out = V + static_cast<size_t>(b) * n * n;
        for (int base = 0; base < n * n; base += WARP) {
            const int e = base + lane;
            const int i = e / n, k = e - i * n;
            const int rank_k = __shfl_sync(full, rank, k);
            if (e < n * n)
                v_out[i * n + rank_k] = static_cast<float>(v[i * STRIDE + k]);
        }
        __syncwarp();       // the next matrix overwrites a and v
    }
}

// svd3_kernel. A 3x3 is 36 bytes in and 84 out, and its SVD a chain of
// dependent float64 rotations, so one matrix takes a kernel node's latency
// whatever the kernel does (the bootstrap calls it on one matrix). What the
// design avoids is extra latency: every array of the sweep is a set of
// scalars named at compile time (the pairs (0,1), (0,2), (1,2) unrolled, the
// order a three-comparison network), so nothing lives in local memory; a
// block stages its matrices in shared memory with coalesced loads and
// stores, so a batch costs its bytes once.

struct Col {                // a column of B = A V or of V
    double x, y, z;
};

__device__ __forceinline__ double dot3(const Col& a, const Col& b) {
    return a.x * b.x + a.y * b.y + a.z * b.z;
}

__device__ __forceinline__ Col scaled(const Col& a, double d) {
    return Col{a.x / d, a.y / d, a.z / d};
}

__device__ __forceinline__ Col cross3(const Col& a, const Col& b) {
    return Col{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
               a.x * b.y - a.y * b.x};
}

// (p, q) <- (c p - s q, s p + c q)
__device__ __forceinline__ void rotate_pair(Col& p, Col& q, double c,
                                            double s) {
    const Col a = p, b = q;
    p = Col{c * a.x - s * b.x, c * a.y - s * b.y, c * a.z - s * b.z};
    q = Col{s * a.x + c * b.x, s * a.y + c * b.y, s * a.z + c * b.z};
}

// One-sided Jacobi: the rotation that makes columns p and q of B orthogonal,
// applied to B and V; false where they are already.
__device__ __forceinline__ bool orthogonalise(Col& bp, Col& bq, Col& vp,
                                              Col& vq) {
    const double alpha = dot3(bp, bp), beta = dot3(bq, bq);
    const double gamma = dot3(bp, bq);
    // |gamma| <= 1e-15 sqrt(alpha beta), squared: no sqrt on the chain
    // (float32 inputs keep every square far inside float64's range)
    if (gamma == 0.0 || gamma * gamma <= 1e-30 * (alpha * beta))
        return false;
    // t = sign(zeta) / (|zeta| + sqrt(1 + zeta^2)), zeta = d / (2 gamma),
    // with both sides times 2 |gamma|: one division on the chain, not two
    const double d = beta - alpha;
    const double t = (d >= 0.0 ? 2.0 * gamma : -2.0 * gamma)
        / (fabs(d) + sqrt(d * d + 4.0 * (gamma * gamma)));
    const double c = 1.0 / sqrt(1.0 + t * t);
    const double s = c * t;
    rotate_pair(bp, bq, c, s);
    rotate_pair(vp, vq, c, s);
    return true;
}

struct Singular {           // a singular value, its column of B and of V
    double s;
    Col b, v;
};

// hi before lo unless lo's value is larger: with the network (0,1), (1,2),
// (0,1) the values come out descending, ties in index order, always a
// permutation (a NaN swaps nothing)
__device__ __forceinline__ void order_pair(Singular& hi, Singular& lo) {
    if (lo.s > hi.s) {
        const Singular t = hi;
        hi = lo;
        lo = t;
    }
}

// One thread per matrix, THREADS matrices per block, staged through shared
// memory: a thread's 9 inputs and 21 outputs lie at a stride of 9 (or 3)
// floats, odd, so a warp's accesses fall on distinct banks.
__global__ void __launch_bounds__(THREADS)
svd3_kernel(const float* __restrict__ A, float* __restrict__ U,
            float* __restrict__ S, float* __restrict__ Vh, int batch,
            unsigned long long* counter) {
    __shared__ float a_in[THREADS * 9], u_out[THREADS * 9],
        vh_out[THREADS * 9], s_out[THREADS * 3];
    count_launch(counter);
    const size_t first = static_cast<size_t>(blockIdx.x) * THREADS;
    const int count = min(THREADS, batch - static_cast<int>(first));
    const int t = threadIdx.x;
    for (int e = t; e < count * 9; e += THREADS) a_in[e] = A[first * 9 + e];
    __syncthreads();
    if (t < count) {
        const float* a = a_in + t * 9;
        // columns of B = A V (V = I to start), and of V
        Col b0{a[0], a[3], a[6]}, b1{a[1], a[4], a[7]}, b2{a[2], a[5], a[8]};
        Col v0{1.0, 0.0, 0.0}, v1{0.0, 1.0, 0.0}, v2{0.0, 0.0, 1.0};
        for (int sweep = 0; sweep < MAX_SWEEPS; ++sweep) {
            const bool r01 = orthogonalise(b0, b1, v0, v1);
            const bool r02 = orthogonalise(b0, b2, v0, v2);
            const bool r12 = orthogonalise(b1, b2, v1, v2);
            if (!(r01 || r02 || r12)) break;
        }
        Singular x0{sqrt(dot3(b0, b0)), b0, v0};
        Singular x1{sqrt(dot3(b1, b1)), b1, v1};
        Singular x2{sqrt(dot3(b2, b2)), b2, v2};
        order_pair(x0, x1);
        order_pair(x1, x2);
        order_pair(x0, x1);
        // U's columns: B's, normalised; where a value vanishes, the unit
        // vector that completes a right-handed orthonormal basis
        const double tiny = 1e-30 + 1e-13 * x0.s;
        const Col u0 = x0.s > tiny ? scaled(x0.b, x0.s)
                                   : Col{1.0, 0.0, 0.0};     // A = 0
        Col u1;
        if (x1.s > tiny) {
            u1 = scaled(x1.b, x1.s);
        } else {            // rank 1: normal to u0 and to its least axis
            const double ax = fabs(u0.x), ay = fabs(u0.y), az = fabs(u0.z);
            const int least = az < (ay < ax ? ay : ax) ? 2 : (ay < ax ? 1 : 0);
            const Col e{least == 0 ? 1.0 : 0.0, least == 1 ? 1.0 : 0.0,
                        least == 2 ? 1.0 : 0.0};
            const Col w = cross3(u0, e);
            u1 = scaled(w, sqrt(dot3(w, w)));
        }
        const Col u2 = x2.s > tiny ? scaled(x2.b, x2.s)
                                   : cross3(u0, u1);          // rank 2
        float* u = u_out + t * 9;
        float* vh = vh_out + t * 9;
        u[0] = static_cast<float>(u0.x);
        u[1] = static_cast<float>(u1.x);
        u[2] = static_cast<float>(u2.x);
        u[3] = static_cast<float>(u0.y);
        u[4] = static_cast<float>(u1.y);
        u[5] = static_cast<float>(u2.y);
        u[6] = static_cast<float>(u0.z);
        u[7] = static_cast<float>(u1.z);
        u[8] = static_cast<float>(u2.z);
        s_out[t * 3] = static_cast<float>(x0.s);
        s_out[t * 3 + 1] = static_cast<float>(x1.s);
        s_out[t * 3 + 2] = static_cast<float>(x2.s);
        vh[0] = static_cast<float>(x0.v.x);
        vh[1] = static_cast<float>(x0.v.y);
        vh[2] = static_cast<float>(x0.v.z);
        vh[3] = static_cast<float>(x1.v.x);
        vh[4] = static_cast<float>(x1.v.y);
        vh[5] = static_cast<float>(x1.v.z);
        vh[6] = static_cast<float>(x2.v.x);
        vh[7] = static_cast<float>(x2.v.y);
        vh[8] = static_cast<float>(x2.v.z);
    }
    __syncthreads();
    for (int e = t; e < count * 9; e += THREADS) {
        U[first * 9 + e] = u_out[e];
        Vh[first * 9 + e] = vh_out[e];
    }
    for (int e = t; e < count * 3; e += THREADS) S[first * 3 + e] = s_out[e];
}

static int blocks_for(int batch) { return (batch + THREADS - 1) / THREADS; }

extern "C" int sdvl_eigh(const void* A, void* w, void* V, int batch, int n,
                         const void* rounds, void* counter, void* stream) {
    if (n < 1 || n > MAX_N || batch < 0 || rounds == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
    const int m = n + (n & 1), size = (m - 1) * m;
    Rounds r;
    memset(&r, 0, sizeof(r));
    memcpy(r.pq, rounds, size);
    for (int i = 0; i < size; i += 2)    // 0 <= p < q < m
        if (r.pq[i] < 0 || r.pq[i] >= r.pq[i + 1] || r.pq[i + 1] >= m)
            return static_cast<int>(cudaErrorInvalidValue);
    if (batch == 0) return 0;
    const int blocks = batch < EIGH_BLOCKS ? batch : EIGH_BLOCKS;
    eigh_kernel<<<blocks, WARP, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(A), static_cast<float*>(w),
        static_cast<float*>(V), batch, n, r,
        static_cast<unsigned long long*>(counter));
    return static_cast<int>(cudaGetLastError());
}

extern "C" int sdvl_svd3(const void* A, void* U, void* S, void* Vh, int batch,
                         void* counter, void* stream) {
    if (batch < 0) return static_cast<int>(cudaErrorInvalidValue);
    if (batch == 0) return 0;
    svd3_kernel<<<blocks_for(batch), THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(A), static_cast<float*>(U),
        static_cast<float*>(S), static_cast<float*>(Vh), batch,
        static_cast<unsigned long long*>(counter));
    return static_cast<int>(cudaGetLastError());
}
