// Gaussian grid-mapping kernel: k[p, g] = exp(-|p - g|) over a structured
// (axis-aligned) grid, the graph->grid featurization hot spot
// (utils/grid.py _kernel_gaussian, whose plain version is _kernel_gaussian_ref; reference grid.py:164-187 computes the
// same full-grid gaussian one point at a time).
//
// Compiled with -ffast-math (see ops/_build.py:HOST_SOURCES) so gcc vectorizes the
// exp/sqrt through libmvec (_ZGVeN16v_expf) — ~4x numpy's exp on this
// target. The structured grid lets d^2 decompose per axis, so no [P, G]
// distance matmul is materialized.

#include <cmath>

extern "C" {

// out: [n_points, nx*ny*nz] float32, row-major in (i, j, k) = (x, y, z)
// (numpy meshgrid indexing="ij" raveled). truncate <= 0 disables truncation;
// otherwise entries with d >= truncate are zeroed (FAST_GAUSSIAN semantics).
void gaussian_kernel_grid(const double* points, int n_points,
                          const double* xs, int nx,
                          const double* ys, int ny,
                          const double* zs, int nz,
                          double truncate, float* out) {
    const float t2 = truncate > 0 ? static_cast<float>(truncate * truncate) : -1.0f;
    float* dz2 = new float[nz];
    for (int p = 0; p < n_points; ++p) {
        const double px = points[3 * p], py = points[3 * p + 1], pz = points[3 * p + 2];
        for (int k = 0; k < nz; ++k) {
            const double dz = pz - zs[k];
            dz2[k] = static_cast<float>(dz * dz);
        }
        float* plane = out + static_cast<long>(p) * nx * ny * nz;
        for (int i = 0; i < nx; ++i) {
            const double dx = px - xs[i];
            const float dx2 = static_cast<float>(dx * dx);
            for (int j = 0; j < ny; ++j) {
                const double dy = py - ys[j];
                const float dxy2 = dx2 + static_cast<float>(dy * dy);
                float* row = plane + (static_cast<long>(i) * ny + j) * nz;
                for (int k = 0; k < nz; ++k) {
                    const float d2 = dxy2 + dz2[k];
                    const float v = expf(-sqrtf(d2));
                    row[k] = (t2 > 0.0f && d2 >= t2) ? 0.0f : v;
                }
            }
        }
    }
    delete[] dz2;
}

}  // extern "C"
