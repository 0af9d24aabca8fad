// Speed-representative C++/OpenMP implementations of the reference's five
// Numba kernels, used ONLY by the baseline-measurement harness
// (tools/reference_baseline/measure_reference.py). numba is not installable
// in this environment (BASELINE.md), so the reference's @jit kernels cannot
// compile; these reimplement the same algorithms (cited per function) with
// the parallelism numba's prange would give, letting the reference's own
// Python layer run at a speed representative of its numba-compiled form.
//
// NOT part of the framework: the engine never calls this library.
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC ref_kernels.cpp -o libref_kernels.so

#include <cmath>
#include <cstdint>

extern "C" {

// assign_bins_jit (reference backend.py:31-50): serial scatter of agent
// indices into dense (bx,by,bz,cap) bins with overflow counting.
void assign_bins(int64_t n, const int64_t* bin_loc, int64_t* bins,
                 int64_t* bins_help, int64_t max_agents,
                 int64_t bx, int64_t by, int64_t bz, int64_t cap) {
    for (int64_t i = 0; i < n; ++i) {
        // per-axis wraparound for coordinates outside the padded bin box
        // (numba negative-index semantics — see wrap_idx below)
        int64_t x = bin_loc[3 * i] % bx, y = bin_loc[3 * i + 1] % by,
                z = bin_loc[3 * i + 2] % bz;
        if (x < 0) x += bx;
        if (y < 0) y += by;
        if (z < 0) z += bz;
        int64_t h = (x * by + y) * bz + z;
        int64_t place = bins_help[h];
        if (place < max_agents) bins[h * cap + place] = i;
        bins_help[h] += 1;
    }
}

// numba nopython-mode indexing wraps negative indices per axis (the
// reference kernel reads bins_help[x-1][...] when a division-displaced
// daughter lands just outside the box and bins to coordinate 0); raw
// pointer arithmetic must emulate that wrap or it reads out of bounds.
// Wrapped reads land in far-away bins whose agents the distance test then
// rejects (box side >> search radius), matching the numba behavior.
static inline int64_t wrap_idx(int64_t v, int64_t dim) {
    if (v < 0) v += dim;
    else if (v >= dim) v -= dim;
    return v;
}

// get_neighbors_cpu (reference backend.py:114-160): parallel-over-agents
// 27-bin candidate scan, dedup by index < current, adaptive max_neighbors.
void get_neighbors(int64_t n, const double* loc, const int64_t* bin_loc,
                   const int64_t* bins, const int64_t* bins_help,
                   double distance, int64_t* edges, uint8_t* if_edge,
                   int64_t* edge_count, int64_t max_neighbors,
                   int64_t bx, int64_t by, int64_t bz, int64_t cap) {
    double d2 = distance * distance;
#pragma omp parallel for schedule(static)
    for (int64_t index = 0; index < n; ++index) {
        int64_t start = index * max_neighbors;
        int64_t cnt = 0;
        int64_t x = bin_loc[3 * index], y = bin_loc[3 * index + 1],
                z = bin_loc[3 * index + 2];
        double lx = loc[3 * index], ly = loc[3 * index + 1], lz = loc[3 * index + 2];
        for (int64_t i = -1; i <= 1; ++i)
            for (int64_t j = -1; j <= 1; ++j)
                for (int64_t k = -1; k <= 1; ++k) {
                    int64_t h = (wrap_idx(x + i, bx) * by + wrap_idx(y + j, by))
                                * bz + wrap_idx(z + k, bz);
                    int64_t bc = bins_help[h];
                    if (bc > cap) bc = cap;
                    for (int64_t l = 0; l < bc; ++l) {
                        int64_t cur = bins[h * cap + l];
                        double dx = loc[3 * cur] - lx, dy = loc[3 * cur + 1] - ly,
                               dz = loc[3 * cur + 2] - lz;
                        if (dx * dx + dy * dy + dz * dz <= d2 && index < cur) {
                            if (cnt < max_neighbors) {
                                edges[2 * (start + cnt)] = index;
                                edges[2 * (start + cnt) + 1] = cur;
                                if_edge[start + cnt] = 1;
                            }
                            ++cnt;
                        }
                    }
                }
        edge_count[index] = cnt;
    }
}

// jkr_forces_cpu (reference cell_backend.py:66-115): parallel-over-edges JKR
// pair law with += accumulation (the reference accepts the prange data race;
// atomics here make it defined without changing the measured regime).
void jkr_forces(int64_t m, const int64_t* edges, uint8_t* delete_edges,
                const double* loc, const double* radii, double* jkr,
                double poisson, double youngs, double adhesion) {
    double e_hat = 1.0 / (2.0 * (1.0 - poisson * poisson) / youngs);
#pragma omp parallel for schedule(static)
    for (int64_t e = 0; e < m; ++e) {
        int64_t c1 = edges[2 * e], c2 = edges[2 * e + 1];
        double vx = loc[3 * c1] - loc[3 * c2];
        double vy = loc[3 * c1 + 1] - loc[3 * c2 + 1];
        double vz = loc[3 * c1 + 2] - loc[3 * c2 + 2];
        double mag = std::sqrt(vx * vx + vy * vy + vz * vz);
        double overlap = (radii[c1] + radii[c2] - mag) / 1e6;
        double r_hat = 1.0 / (1e6 * (1.0 / radii[c1] + 1.0 / radii[c2]));
        double overlap_ = std::pow(M_PI * adhesion / e_hat, 2.0 / 3.0) *
                          std::cbrt(r_hat);
        double d = overlap / overlap_;
        if (d > -0.360562) {
            double f = ((-0.0204 * d + 0.4942) * d + 1.0801) * d - 1.324;
            double jf = f * M_PI * adhesion * r_hat;
            double nx = 0, ny = 0, nz = 0;
            if (mag != 0) { nx = vx / mag; ny = vy / mag; nz = vz / mag; }
#pragma omp atomic
            jkr[3 * c1] += jf * nx;
#pragma omp atomic
            jkr[3 * c1 + 1] += jf * ny;
#pragma omp atomic
            jkr[3 * c1 + 2] += jf * nz;
#pragma omp atomic
            jkr[3 * c2] -= jf * nx;
#pragma omp atomic
            jkr[3 * c2 + 1] -= jf * ny;
#pragma omp atomic
            jkr[3 * c2 + 2] -= jf * nz;
        } else {
            delete_edges[e] = 1;
        }
    }
}

// apply_forces_cpu (reference cell_backend.py:148-172): Stokes overdamped
// Euler + box clamp, parallel elementwise.
void apply_forces(int64_t n, const double* jkr, const double* mot, double* loc,
                  const double* radii, double stokes, const double* size,
                  double move_dt) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        double fric = 6.0 * M_PI * stokes * (radii[i] / 1e6);
        for (int d = 0; d < 3; ++d) {
            double v = (mot[3 * i + d] + jkr[3 * i + d]) / fric;
            double nl = loc[3 * i + d] + move_dt * (v * 1e6);
            if (nl > size[d]) nl = size[d];
            else if (nl < 0) nl = 0;
            loc[3 * i + d] = nl;
        }
    }
}

// update_diffusion_jit (reference cell_backend.py:175-204): subcycled FTCS
// 5-point stencil with reflecting edge copy, serial.
void update_diffusion(double* base, int64_t nx, int64_t ny, int64_t steps,
                      double dt, double last_dt, double diffuse,
                      double spat_res2) {
    double a = dt * diffuse / spat_res2;
    double b = 1.0 - 4.0 * a;
    double* tmp = new double[(nx - 2) * (ny - 2)];
    for (int64_t s = 0; s < steps; ++s) {
        if (s == steps - 1) { a = last_dt * diffuse / spat_res2; b = 1.0 - 4.0 * a; }
        for (int64_t i = 0; i < nx; ++i) {
            base[i * ny] = base[i * ny + 1];
            base[i * ny + ny - 1] = base[i * ny + ny - 2];
        }
        for (int64_t j = 0; j < ny; ++j) {
            base[j] = base[ny + j];
            base[(nx - 1) * ny + j] = base[(nx - 2) * ny + j];
        }
        for (int64_t i = 1; i < nx - 1; ++i)
            for (int64_t j = 1; j < ny - 1; ++j)
                tmp[(i - 1) * (ny - 2) + (j - 1)] =
                    a * (base[(i + 1) * ny + j] + base[(i - 1) * ny + j] +
                         base[i * ny + j + 1] + base[i * ny + j - 1]);
        for (int64_t i = 1; i < nx - 1; ++i)
            for (int64_t j = 1; j < ny - 1; ++j)
                base[i * ny + j] = base[i * ny + j] * b +
                                   tmp[(i - 1) * (ny - 2) + (j - 1)];
    }
    delete[] tmp;
}

}  // extern "C"
