// Batched small symmetric eigensolver (one warp per matrix) and 3x3 SVD
// (one thread per matrix).
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
//     A (batch, 3, 3) float32; U (batch, 3, 3), S (batch, 3) descending,
//     Vh (batch, 3, 3) with A = U diag(S) Vh, as torch.linalg.svd gives
//     them. One-sided (Hestenes) Jacobi in float64: column pairs of A V are
//     rotated until orthogonal; S are their norms, U their directions; a
//     column whose norm vanishes takes the unit vector that completes U to a
//     right-handed orthonormal basis.
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

__device__ static void cross3(const double* x, const double* y, double* out) {
    out[0] = x[1] * y[2] - x[2] * y[1];
    out[1] = x[2] * y[0] - x[0] * y[2];
    out[2] = x[0] * y[1] - x[1] * y[0];
}

__device__ static double norm3(const double* x) {
    return sqrt(x[0] * x[0] + x[1] * x[1] + x[2] * x[2]);
}

__global__ void svd3_kernel(const float* __restrict__ A, float* __restrict__ U,
                            float* __restrict__ S, float* __restrict__ Vh,
                            int batch, unsigned long long* counter) {
    count_launch(counter);
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= batch) return;
    const float* a_in = A + static_cast<size_t>(b) * 9;
    // columns of B = A V, and of V
    double bc[3][3], vc[3][3];
    for (int j = 0; j < 3; ++j)
        for (int i = 0; i < 3; ++i) {
            bc[j][i] = static_cast<double>(a_in[i * 3 + j]);
            vc[j][i] = i == j ? 1.0 : 0.0;
        }
    const int pairs[3][2] = {{0, 1}, {0, 2}, {1, 2}};
    for (int sweep = 0; sweep < MAX_SWEEPS; ++sweep) {
        bool rotated = false;
        for (int k = 0; k < 3; ++k) {
            const int p = pairs[k][0], q = pairs[k][1];
            double alpha = 0.0, beta = 0.0, gamma = 0.0;
            for (int i = 0; i < 3; ++i) {
                alpha += bc[p][i] * bc[p][i];
                beta += bc[q][i] * bc[q][i];
                gamma += bc[p][i] * bc[q][i];
            }
            if (gamma == 0.0 || fabs(gamma) <= 1e-15 * sqrt(alpha * beta))
                continue;
            rotated = true;
            const double zeta = (beta - alpha) / (2.0 * gamma);
            const double t = (zeta >= 0.0 ? 1.0 : -1.0)
                / (fabs(zeta) + sqrt(1.0 + zeta * zeta));
            const double c = 1.0 / sqrt(1.0 + t * t);
            const double s = c * t;
            for (int i = 0; i < 3; ++i) {
                const double bp = bc[p][i], bq = bc[q][i];
                bc[p][i] = c * bp - s * bq;
                bc[q][i] = s * bp + c * bq;
                const double vp = vc[p][i], vq = vc[q][i];
                vc[p][i] = c * vp - s * vq;
                vc[q][i] = s * vp + c * vq;
            }
        }
        if (!rotated) break;
    }
    double sv[3];
    int order[3] = {0, 1, 2};
    for (int j = 0; j < 3; ++j) sv[j] = norm3(bc[j]);
    // descending, stable
    for (int i = 0; i < 3; ++i) {
        int best = i;
        for (int j = i + 1; j < 3; ++j)
            if (sv[order[j]] > sv[order[best]]) best = j;
        const int tmp = order[i];
        order[i] = order[best];
        order[best] = tmp;
    }
    double u[3][3];
    const double tiny = 1e-30 + 1e-13 * sv[order[0]];
    for (int k = 0; k < 3; ++k) {
        const int j = order[k];
        if (sv[j] > tiny) {
            for (int i = 0; i < 3; ++i) u[k][i] = bc[j][i] / sv[j];
        } else if (k == 0) {            // A = 0: any basis
            u[0][0] = 1.0;
            u[0][1] = u[0][2] = 0.0;
        } else if (k == 1) {            // rank 1: a unit vector normal to u0
            double e[3] = {0.0, 0.0, 0.0};
            int least = 0;
            for (int i = 1; i < 3; ++i)
                if (fabs(u[0][i]) < fabs(u[0][least])) least = i;
            e[least] = 1.0;
            cross3(u[0], e, u[1]);
            const double nn = norm3(u[1]);
            for (int i = 0; i < 3; ++i) u[1][i] /= nn;
        } else {                        // rank 2: complete the basis
            cross3(u[0], u[1], u[2]);
        }
    }
    float* u_out = U + static_cast<size_t>(b) * 9;
    float* s_out = S + static_cast<size_t>(b) * 3;
    float* vh_out = Vh + static_cast<size_t>(b) * 9;
    for (int k = 0; k < 3; ++k) {
        const int j = order[k];
        s_out[k] = static_cast<float>(sv[j]);
        for (int i = 0; i < 3; ++i) {
            u_out[i * 3 + k] = static_cast<float>(u[k][i]);
            vh_out[k * 3 + i] = static_cast<float>(vc[j][i]);
        }
    }
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
