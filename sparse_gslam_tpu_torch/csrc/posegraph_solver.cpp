// Sequential C++ pose-graph Gauss-Newton solver: the float64 oracle
// of the port's pose-graph solvers and the CPU baseline beside their
// times on the GPU.
//
// Implements the same math as sparse_gslam_tpu_torch.ops.solvers.
// optimize_pose_graph (g2o Gauss-Newton semantics with a DCS robust
// kernel on closures, reference src/graphs.cpp:17-23,
// submap_loop_closer.cpp:283-288) with a direct method for the
// chain+closures structure: block-tridiagonal LDL^T factorization of
// the odometry chain + Woodbury correction for loop-closure edges.
// A copy of native/posegraph_solver.cpp, so the port builds it from
// its own sources.
//
// Dependency-free (no Eigen); built as a shared library at first use
// into sparse_gslam_tpu_torch/_build/ and called through ctypes
// (sparse_gslam_tpu_torch/io/native.py).
//
// Build: g++ -O3 -march=native -std=c++17 -shared -fPIC \
//            -o libposegraph.so posegraph_solver.cpp
#include <cmath>
#include <cstring>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

inline double wrap(double a) {
    return a - 2.0 * kPi * std::floor((a + kPi) / (2.0 * kPi));
}

struct M3 {
    double m[9];  // row major
    static M3 zero() { M3 r; std::memset(r.m, 0, sizeof r.m); return r; }
    static M3 ident() {
        M3 r = zero();
        r.m[0] = r.m[4] = r.m[8] = 1.0;
        return r;
    }
};

inline M3 mul(const M3& a, const M3& b) {
    M3 r = M3::zero();
    for (int i = 0; i < 3; i++)
        for (int k = 0; k < 3; k++) {
            double aik = a.m[i * 3 + k];
            for (int j = 0; j < 3; j++)
                r.m[i * 3 + j] += aik * b.m[k * 3 + j];
        }
    return r;
}

inline M3 mulT1(const M3& a, const M3& b) {  // a^T * b
    M3 r = M3::zero();
    for (int i = 0; i < 3; i++)
        for (int k = 0; k < 3; k++) {
            double aki = a.m[k * 3 + i];
            for (int j = 0; j < 3; j++)
                r.m[i * 3 + j] += aki * b.m[k * 3 + j];
        }
    return r;
}

inline M3 add(const M3& a, const M3& b) {
    M3 r;
    for (int i = 0; i < 9; i++) r.m[i] = a.m[i] + b.m[i];
    return r;
}

inline M3 transpose(const M3& a) {
    M3 r;
    for (int i = 0; i < 3; i++)
        for (int j = 0; j < 3; j++) r.m[i * 3 + j] = a.m[j * 3 + i];
    return r;
}

inline M3 inv3(const M3& a) {
    const double* m = a.m;
    double c00 = m[4] * m[8] - m[5] * m[7];
    double c01 = m[5] * m[6] - m[3] * m[8];
    double c02 = m[3] * m[7] - m[4] * m[6];
    double det = m[0] * c00 + m[1] * c01 + m[2] * c02;
    double id = 1.0 / det;
    M3 r;
    r.m[0] = c00 * id;
    r.m[1] = (m[2] * m[7] - m[1] * m[8]) * id;
    r.m[2] = (m[1] * m[5] - m[2] * m[4]) * id;
    r.m[3] = c01 * id;
    r.m[4] = (m[0] * m[8] - m[2] * m[6]) * id;
    r.m[5] = (m[2] * m[3] - m[0] * m[5]) * id;
    r.m[6] = c02 * id;
    r.m[7] = (m[1] * m[6] - m[0] * m[7]) * id;
    r.m[8] = (m[0] * m[4] - m[1] * m[3]) * id;
    return r;
}

inline void matvec(const M3& a, const double* x, double* y) {
    for (int i = 0; i < 3; i++)
        y[i] = a.m[i * 3] * x[0] + a.m[i * 3 + 1] * x[1] +
               a.m[i * 3 + 2] * x[2];
}

inline void matTvec(const M3& a, const double* x, double* y) {
    for (int i = 0; i < 3; i++)
        y[i] = a.m[i] * x[0] + a.m[3 + i] * x[1] + a.m[6 + i] * x[2];
}

// e = t2v(Z^-1 (Xi^-1 Xj)); Ji, Jj closed form (matches
// ops/solvers.py se2_edge_residual / se2_edge_jacobians)
void edge_terms(const double* xi, const double* xj, const double* z,
                double* e, M3* Ji, M3* Jj) {
    double ci = std::cos(xi[2]), si = std::sin(xi[2]);
    double cz = std::cos(z[2]), sz = std::sin(z[2]);
    double dx = xj[0] - xi[0], dy = xj[1] - xi[1];
    double d0 = ci * dx + si * dy;
    double d1 = -si * dx + ci * dy;
    e[0] = cz * (d0 - z[0]) + sz * (d1 - z[1]);
    e[1] = -sz * (d0 - z[0]) + cz * (d1 - z[1]);
    e[2] = wrap(xj[2] - xi[2] - z[2]);

    double m00 = cz * ci - sz * si;
    double m01 = cz * si + sz * ci;
    double m10 = -sz * ci - cz * si;
    double m11 = -sz * si + cz * ci;
    double g0 = -si * dx + ci * dy;
    double g1 = -ci * dx - si * dy;
    double e0ti = cz * g0 + sz * g1;
    double e1ti = -sz * g0 + cz * g1;
    *Ji = M3::zero();
    Ji->m[0] = -m00; Ji->m[1] = -m01; Ji->m[2] = e0ti;
    Ji->m[3] = -m10; Ji->m[4] = -m11; Ji->m[5] = e1ti;
    Ji->m[8] = -1.0;
    *Jj = M3::zero();
    Jj->m[0] = m00; Jj->m[1] = m01;
    Jj->m[3] = m10; Jj->m[4] = m11;
    Jj->m[8] = 1.0;
}

// Block-tridiagonal LDL^T: factor in place.
struct TridiagFactor {
    std::vector<M3> Dinv;   // (N) inverted pivot blocks
    std::vector<M3> L;      // (N) sub-diagonal factors L[i] (i>=1)
};

void factor_tridiag(const std::vector<M3>& D, const std::vector<M3>& O,
                    TridiagFactor& f) {
    int n = (int)D.size();
    f.Dinv.resize(n);
    f.L.resize(n);
    M3 S = D[0];
    f.Dinv[0] = inv3(S);
    for (int i = 1; i < n; i++) {
        // L[i] = O[i]^T * Dinv[i-1]  (O[i] couples (i-1, i): block
        // H[i-1, i] = O[i])
        f.L[i] = mulT1(O[i], f.Dinv[i - 1]);
        // S_i = D[i] - L[i] * O[i]
        M3 LO = mul(f.L[i], O[i]);
        M3 Si = D[i];
        for (int k = 0; k < 9; k++) Si.m[k] -= LO.m[k];
        f.Dinv[i] = inv3(Si);
    }
}

// solve T x = b for nrhs right-hand sides (b: nrhs x 3N, row major)
void solve_tridiag(const TridiagFactor& f, const std::vector<M3>& O,
                   double* b, int n, int nrhs) {
    for (int r = 0; r < nrhs; r++) {
        double* x = b + (size_t)r * 3 * n;
        // forward: y_i = b_i - L_i y_{i-1}
        for (int i = 1; i < n; i++) {
            double t[3];
            matvec(f.L[i], x + 3 * (i - 1), t);
            x[3 * i] -= t[0];
            x[3 * i + 1] -= t[1];
            x[3 * i + 2] -= t[2];
        }
        // diagonal + backward: x_i = Dinv_i y_i - Dinv_i O_{i+1} x_{i+1}
        double t[3];
        matvec(f.Dinv[n - 1], x + 3 * (n - 1), t);
        std::memcpy(x + 3 * (n - 1), t, sizeof t);
        for (int i = n - 2; i >= 0; i--) {
            double u[3];
            matvec(O[i + 1], x + 3 * (i + 1), u);
            double v[3] = {x[3 * i] , x[3 * i + 1], x[3 * i + 2]};
            // x_i = Dinv_i (y_i) - Dinv_i O_{i+1} x_{i+1}
            double w[3];
            matvec(f.Dinv[i], v, w);
            double w2[3];
            matvec(f.Dinv[i], u, w2);
            x[3 * i] = w[0] - w2[0];
            x[3 * i + 1] = w[1] - w2[1];
            x[3 * i + 2] = w[2] - w2[2];
        }
    }
}

// dense Cholesky solve (in place), n x n, one rhs
bool chol_solve(std::vector<double>& A, double* b, int n) {
    for (int j = 0; j < n; j++) {
        double d = A[(size_t)j * n + j];
        for (int k = 0; k < j; k++) d -= A[(size_t)j * n + k] * A[(size_t)j * n + k];
        if (d <= 0.0) return false;
        d = std::sqrt(d);
        A[(size_t)j * n + j] = d;
        for (int i = j + 1; i < n; i++) {
            double s = A[(size_t)i * n + j];
            for (int k = 0; k < j; k++)
                s -= A[(size_t)i * n + k] * A[(size_t)j * n + k];
            A[(size_t)i * n + j] = s / d;
        }
    }
    for (int i = 0; i < n; i++) {
        double s = b[i];
        for (int k = 0; k < i; k++) s -= A[(size_t)i * n + k] * b[k];
        b[i] = s / A[(size_t)i * n + i];
    }
    for (int i = n - 1; i >= 0; i--) {
        double s = b[i];
        for (int k = i + 1; k < n; k++) s -= A[(size_t)k * n + i] * b[k];
        b[i] = s / A[(size_t)i * n + i];
    }
    return true;
}

}  // namespace

extern "C" {

// One full GN optimization: `iters` iterations, DCS on closures.
// poses: (n,3) updated in place. chain edge i couples (i-1, i); edge 0
// ignored. fixed: (n) 0/1. Returns 0 on success.
int posegraph_gn_optimize(
    int n, double* poses, const double* chain_meas,
    const double* chain_info, const unsigned char* chain_valid,
    const unsigned char* fixed_mask, int n_clo, const int* clo_i,
    const int* clo_j, const double* clo_meas, const double* clo_info,
    const unsigned char* clo_valid, double phi, int iters) {
    std::vector<M3> D(n), O(n);
    std::vector<double> b((size_t)3 * n);
    int C = n_clo;
    int cdim = 3 * C;
    // B (3N x 3C) stored column major by closure: cols[c] = 3 columns
    std::vector<double> TB;   // T^-1 [b | Bcols]
    std::vector<double> Bcols((size_t)9 * C * n, 0.0);

    for (int it = 0; it < iters; it++) {
        for (int i = 0; i < n; i++) {
            D[i] = M3::zero();
            O[i] = M3::zero();
        }
        std::fill(b.begin(), b.end(), 0.0);
        std::fill(Bcols.begin(), Bcols.end(), 0.0);

        // chain edges
        for (int i = 1; i < n; i++) {
            if (!chain_valid[i]) continue;
            double e[3];
            M3 Ji, Jj;
            edge_terms(poses + 3 * (i - 1), poses + 3 * i,
                       chain_meas + 3 * i, e, &Ji, &Jj);
            if (fixed_mask[i - 1]) Ji = M3::zero();
            if (fixed_mask[i]) Jj = M3::zero();
            M3 Om;
            std::memcpy(Om.m, chain_info + 9 * i, sizeof Om.m);
            M3 OJi = mul(Om, Ji), OJj = mul(Om, Jj);
            D[i - 1] = add(D[i - 1], mulT1(Ji, OJi));
            D[i] = add(D[i], mulT1(Jj, OJj));
            O[i] = add(O[i], mulT1(Ji, OJj));  // block H[i-1, i]
            double t[3];
            double Oe[3];
            matvec(Om, e, Oe);
            matTvec(Ji, Oe, t);
            for (int k = 0; k < 3; k++) b[3 * (i - 1) + k] -= t[k];
            matTvec(Jj, Oe, t);
            for (int k = 0; k < 3; k++) b[3 * i + k] -= t[k];
        }
        // anchor fixed / untouched rows
        for (int i = 0; i < n; i++) {
            if (fixed_mask[i]) D[i] = M3::ident();
            else {
                // regularize empty rows
                double tr = D[i].m[0] + D[i].m[4] + D[i].m[8];
                if (tr == 0.0) D[i] = M3::ident();
            }
        }

        // closures -> low-rank factor B D' B^T via scaled Jacobians:
        // column group c gets L_c = J^T * chol(w * Omega). We use
        // B = J^T * (w*Omega)^(1/2)? Simpler: keep Woodbury in the
        // form (D'^-1 + B^T T^-1 B): store raw J blocks; D' = w*Omega.
        std::vector<M3> cJi(C), cJj(C);
        std::vector<double> ce((size_t)3 * C);
        std::vector<double> cw(C, 0.0);
        for (int c = 0; c < C; c++) {
            if (!clo_valid[c]) continue;
            int a = clo_i[c], d2 = clo_j[c];
            double e[3];
            M3 Ji, Jj;
            edge_terms(poses + 3 * a, poses + 3 * d2, clo_meas + 3 * c,
                       e, &Ji, &Jj);
            if (fixed_mask[a]) Ji = M3::zero();
            if (fixed_mask[d2]) Jj = M3::zero();
            M3 Om;
            std::memcpy(Om.m, clo_info + 9 * c, sizeof Om.m);
            double Oe[3];
            matvec(Om, e, Oe);
            double chi2 = e[0] * Oe[0] + e[1] * Oe[1] + e[2] * Oe[2];
            double s = 2.0 * phi / (phi + chi2);
            double w = s >= 1.0 ? 1.0 : s * s;
            cw[c] = w;
            cJi[c] = Ji;
            cJj[c] = Jj;
            std::memcpy(&ce[3 * c], e, sizeof e);
            // b -= w * J^T Omega e
            double t[3];
            matTvec(Ji, Oe, t);
            for (int k = 0; k < 3; k++) b[3 * a + k] -= w * t[k];
            matTvec(Jj, Oe, t);
            for (int k = 0; k < 3; k++) b[3 * d2 + k] -= w * t[k];
            // B columns: rows at a and d2; B[:, c3+k] = J^T e_k
            for (int k = 0; k < 3; k++) {
                double* col = &Bcols[((size_t)3 * c + k) * 3 * n];
                for (int r = 0; r < 3; r++) {
                    col[3 * a + r] += Ji.m[k * 3 + r];   // (J^T)[r,k]
                    col[3 * d2 + r] += Jj.m[k * 3 + r];
                }
            }
        }

        TridiagFactor f;
        factor_tridiag(D, O, f);

        // X = T^-1 [b | B]  : (1 + 3C) rhs
        TB.assign((size_t)(1 + cdim) * 3 * n, 0.0);
        std::memcpy(TB.data(), b.data(), sizeof(double) * 3 * n);
        std::memcpy(TB.data() + (size_t)3 * n, Bcols.data(),
                    sizeof(double) * 3 * n * cdim);
        solve_tridiag(f, O, TB.data(), n, 1 + cdim);

        double* Tb = TB.data();
        double* TBc = TB.data() + (size_t)3 * n;

        if (cdim > 0) {
            // M = blockdiag((w_c Omega_c)^-1) + B^T T^-1 B, exploiting
            // that column group c of B is nonzero only at pose rows
            // clo_i[c] and clo_j[c] (6 entries per column)
            std::vector<double> M((size_t)cdim * cdim, 0.0);
            for (int c = 0; c < C; c++) {
                M3 Om;
                std::memcpy(Om.m, clo_info + 9 * c, sizeof Om.m);
                M3 Oinv;
                if (clo_valid[c] && cw[c] > 0.0) {
                    M3 scaled = Om;
                    for (int k = 0; k < 9; k++) scaled.m[k] *= cw[c];
                    Oinv = inv3(scaled);
                } else {
                    // disabled closure: make the correction vanish by
                    // a huge D'^-1 (=> (D'^-1 + ...)^-1 ~ 0)
                    Oinv = M3::zero();
                    Oinv.m[0] = Oinv.m[4] = Oinv.m[8] = 1e18;
                }
                for (int a2 = 0; a2 < 3; a2++)
                    for (int b2 = 0; b2 < 3; b2++)
                        M[(size_t)(3 * c + a2) * cdim + (3 * c + b2)] +=
                            Oinv.m[a2 * 3 + b2];
            }
            for (int pc = 0; pc < C; pc++) {
                int ra = clo_i[pc], rb = clo_j[pc];
                for (int k = 0; k < 3; k++) {
                    int p = 3 * pc + k;
                    const double* Bp = &Bcols[(size_t)p * 3 * n];
                    for (int q = 0; q < cdim; q++) {
                        const double* TBq = &TBc[(size_t)q * 3 * n];
                        double s = 0.0;
                        for (int r = 0; r < 3; r++) {
                            s += Bp[3 * ra + r] * TBq[3 * ra + r];
                            s += Bp[3 * rb + r] * TBq[3 * rb + r];
                        }
                        M[(size_t)p * cdim + q] += s;
                    }
                }
            }
            // rhs2 = B^T T^-1 b
            std::vector<double> rhs2(cdim, 0.0);
            for (int pc = 0; pc < C; pc++) {
                int ra = clo_i[pc], rb = clo_j[pc];
                for (int k = 0; k < 3; k++) {
                    int p = 3 * pc + k;
                    const double* Bp = &Bcols[(size_t)p * 3 * n];
                    double s = 0.0;
                    for (int r = 0; r < 3; r++) {
                        s += Bp[3 * ra + r] * Tb[3 * ra + r];
                        s += Bp[3 * rb + r] * Tb[3 * rb + r];
                    }
                    rhs2[p] = s;
                }
            }
            if (!chol_solve(M, rhs2.data(), cdim)) return 1;
            // delta = Tb - T^-1 B rhs2
            for (int p = 0; p < cdim; p++) {
                const double* TBp = &TBc[(size_t)p * 3 * n];
                double alpha = rhs2[p];
                for (int r = 0; r < 3 * n; r++) Tb[r] -= alpha * TBp[r];
            }
        }

        for (int i = 0; i < n; i++) {
            if (fixed_mask[i]) continue;
            poses[3 * i] += Tb[3 * i];
            poses[3 * i + 1] += Tb[3 * i + 1];
            poses[3 * i + 2] = wrap(poses[3 * i + 2] + Tb[3 * i + 2]);
        }
    }
    return 0;
}

}  // extern "C"
