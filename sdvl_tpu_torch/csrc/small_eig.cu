// Batched small symmetric eigensolver and 3x3 SVD, one thread per matrix.
//
// The two-view bootstrap solves three small dense problems: the smallest
// eigenvector of the 9x9 A^T A of each homography hypothesis (a batch of
// 128) and of each weighted refit, the SVD of the chosen 3x3 homography
// (the Faugeras decomposition), and the smallest eigenvector of the 3x3
// covariance of the ground plane's inliers. torch.linalg.eigh and svd on
// CUDA read cuSOLVER's `info` back to the host, which a CUDA graph capture
// refuses; these kernels read nothing back.
//
//   sdvl_eigh(A, w, V, batch, n, counter, stream)
//     A (batch, n, n) float32 symmetric (the lower triangle is read), n <= 9;
//     w (batch, n) eigenvalues ascending, V (batch, n, n) the eigenvectors
//     as columns (V[b, :, k] belongs to w[b, k]), as torch.linalg.eigh
//     gives them. Cyclic Jacobi in float64: each rotation zeroes one
//     off-diagonal pair; sweeps stop once no off-diagonal entry is above
//     1e-15 of its diagonal pair's scale (at most MAX_SWEEPS).
//   sdvl_svd3(A, U, S, Vh, batch, counter, stream)
//     A (batch, 3, 3) float32; U (batch, 3, 3), S (batch, 3) descending,
//     Vh (batch, 3, 3) with A = U diag(S) Vh, as torch.linalg.svd gives
//     them. One-sided (Hestenes) Jacobi in float64: column pairs of A V are
//     rotated until orthogonal; S are their norms, U their directions; a
//     column whose norm vanishes takes the unit vector that completes U to a
//     right-handed orthonormal basis.
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

#define MAX_N 9
#define MAX_SWEEPS 30
#define THREADS 128

__device__ static void count_launch(unsigned long long* counter) {
    if (counter != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
        atomicAdd(counter, 1ull);
}

__global__ void eigh_kernel(const float* __restrict__ A, float* __restrict__ w,
                            float* __restrict__ V, int batch, int n,
                            unsigned long long* counter) {
    count_launch(counter);
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= batch) return;
    const float* a_in = A + static_cast<size_t>(b) * n * n;
    double a[MAX_N][MAX_N], v[MAX_N][MAX_N];
    for (int i = 0; i < n; ++i)
        for (int j = 0; j < n; ++j) {
            // the lower triangle, mirrored
            a[i][j] = static_cast<double>(i >= j ? a_in[i * n + j]
                                                 : a_in[j * n + i]);
            v[i][j] = i == j ? 1.0 : 0.0;
        }
    for (int sweep = 0; sweep < MAX_SWEEPS; ++sweep) {
        bool rotated = false;
        for (int p = 0; p < n - 1; ++p) {
            for (int q = p + 1; q < n; ++q) {
                const double apq = a[p][q];
                const double scale = fabs(a[p][p]) + fabs(a[q][q]);
                if (apq == 0.0 || fabs(apq) <= 1e-15 * scale) continue;
                rotated = true;
                const double theta = (a[q][q] - a[p][p]) / (2.0 * apq);
                const double t = (theta >= 0.0 ? 1.0 : -1.0)
                    / (fabs(theta) + sqrt(theta * theta + 1.0));
                const double c = 1.0 / sqrt(t * t + 1.0);
                const double s = t * c;
                // A <- J^T A J with J the rotation in the (p, q) plane
                for (int k = 0; k < n; ++k) {
                    const double akp = a[k][p], akq = a[k][q];
                    a[k][p] = c * akp - s * akq;
                    a[k][q] = s * akp + c * akq;
                }
                for (int k = 0; k < n; ++k) {
                    const double apk = a[p][k], aqk = a[q][k];
                    a[p][k] = c * apk - s * aqk;
                    a[q][k] = s * apk + c * aqk;
                }
                a[p][q] = a[q][p] = 0.0;
                for (int k = 0; k < n; ++k) {
                    const double vkp = v[k][p], vkq = v[k][q];
                    v[k][p] = c * vkp - s * vkq;
                    v[k][q] = s * vkp + c * vkq;
                }
            }
        }
        if (!rotated) break;
    }
    // eigenvalues ascending (a stable selection order), vectors with them
    int order[MAX_N];
    for (int i = 0; i < n; ++i) order[i] = i;
    for (int i = 0; i < n; ++i) {
        int best = i;
        for (int j = i + 1; j < n; ++j)
            if (a[order[j]][order[j]] < a[order[best]][order[best]]) best = j;
        const int tmp = order[i];
        order[i] = order[best];
        order[best] = tmp;
    }
    float* w_out = w + static_cast<size_t>(b) * n;
    float* v_out = V + static_cast<size_t>(b) * n * n;
    for (int k = 0; k < n; ++k) {
        const int src = order[k];
        w_out[k] = static_cast<float>(a[src][src]);
        for (int i = 0; i < n; ++i)
            v_out[i * n + k] = static_cast<float>(v[i][src]);
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
                         void* counter, void* stream) {
    if (n < 1 || n > MAX_N || batch < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    if (batch == 0) return 0;
    eigh_kernel<<<blocks_for(batch), THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(A), static_cast<float*>(w),
        static_cast<float*>(V), batch, n,
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
