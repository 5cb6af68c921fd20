// Shrake-Rupley solvent-accessible surface area with cell-list neighbor search.
//
// Native kernel behind utils/sasa.py (the featurization hot spot;
// the reference stack used the freesasa C library here). Exposed through a C ABI
// for ctypes; built by ops/_build.py:build_host.
//
// Semantics match the numpy plain version (shrake_rupley_ref) exactly: per-atom test spheres of
// radius (r_i + probe); a test point is buried when inside any neighbor's
// solvent-extended sphere; area_i = 4*pi*(r_i+probe)^2 * exposed_fraction.

#include <cmath>
#include <cstdint>
#include <algorithm>
#include <utility>
#include <vector>

namespace {

struct CellList {
    double origin[3];
    double cell;     // cell edge length
    int dims[3];     // number of cells per axis
    std::vector<std::vector<int>> cells;

    int cell_index(const double* p) const {
        int c[3];
        for (int d = 0; d < 3; ++d) {
            int v = static_cast<int>((p[d] - origin[d]) / cell);
            if (v < 0) v = 0;
            if (v >= dims[d]) v = dims[d] - 1;
            c[d] = v;
        }
        return (c[0] * dims[1] + c[1]) * dims[2] + c[2];
    }
};

CellList build_cells(const double* pos, const double* rad, int n, double cell_size) {
    CellList cl;
    double lo[3] = {1e30, 1e30, 1e30}, hi[3] = {-1e30, -1e30, -1e30};
    for (int i = 0; i < n; ++i) {
        if (rad[i] <= 0) continue;
        for (int d = 0; d < 3; ++d) {
            double v = pos[3 * i + d];
            if (v < lo[d]) lo[d] = v;
            if (v > hi[d]) hi[d] = v;
        }
    }
    cl.cell = cell_size;
    for (int d = 0; d < 3; ++d) {
        cl.origin[d] = lo[d];
        cl.dims[d] = std::max(1, static_cast<int>((hi[d] - lo[d]) / cell_size) + 1);
    }
    cl.cells.resize(static_cast<size_t>(cl.dims[0]) * cl.dims[1] * cl.dims[2]);
    for (int i = 0; i < n; ++i) {
        if (rad[i] <= 0) continue;
        cl.cells[cl.cell_index(pos + 3 * i)].push_back(i);
    }
    return cl;
}

}  // namespace

extern "C" {

// areas_out: [n_atoms]; if points_out != nullptr it receives exposed surface
// points (up to n_atoms*n_points*3 doubles) and *n_points_out their count.
// compute_mask (nullable, [n_atoms] uint8): when given, areas are computed
// only for flagged atoms — every atom still occludes, so flagged atoms'
// values are identical to a full run (featurization only reads the graph's
// atom subset; skipping the rest drops most of the point-loop work).
void sasa_compute(const double* positions, const double* radii, int n_atoms,
                  const double* sphere, int n_points, double probe,
                  double* areas_out, double* points_out, int64_t* n_points_out,
                  const unsigned char* compute_mask) {
    double max_r = 0.0;
    for (int i = 0; i < n_atoms; ++i) {
        areas_out[i] = 0.0;
        double r = radii[i];
        if (r > 0 && r + probe > max_r) max_r = r + probe;
    }
    if (max_r == 0.0) {
        if (n_points_out) *n_points_out = 0;
        return;
    }

    const double cell_size = 2.0 * max_r;
    CellList cl = build_cells(positions, radii, n_atoms, cell_size);

    std::vector<int> neigh;
    std::vector<std::pair<double, int>> keep;
    std::vector<double> npx, npy, npz, nr2;
    int64_t out_count = 0;

    for (int i = 0; i < n_atoms; ++i) {
        if (radii[i] <= 0) continue;
        if (compute_mask && !compute_mask[i]) continue;
        const double ri = radii[i] + probe;
        const double xi = positions[3 * i], yi = positions[3 * i + 1], zi = positions[3 * i + 2];

        // gather neighbors from the 27 surrounding cells
        neigh.clear();
        int ci[3];
        for (int d = 0; d < 3; ++d) {
            int v = static_cast<int>((positions[3 * i + d] - cl.origin[d]) / cl.cell);
            if (v < 0) v = 0;
            if (v >= cl.dims[d]) v = cl.dims[d] - 1;
            ci[d] = v;
        }
        for (int dx = -1; dx <= 1; ++dx)
            for (int dy = -1; dy <= 1; ++dy)
                for (int dz = -1; dz <= 1; ++dz) {
                    int cx = ci[0] + dx, cy = ci[1] + dy, cz = ci[2] + dz;
                    if (cx < 0 || cy < 0 || cz < 0 || cx >= cl.dims[0] || cy >= cl.dims[1] || cz >= cl.dims[2]) continue;
                    const auto& bucket = cl.cells[(static_cast<size_t>(cx) * cl.dims[1] + cy) * cl.dims[2] + cz];
                    for (int j : bucket)
                        if (j != i) neigh.push_back(j);
                }

        // prune neighbors that cannot occlude any test point, then order them
        // closest-first: a buried test point is usually buried by a near
        // neighbor, so the early-break in the point loop hits sooner
        keep.clear();
        for (int j : neigh) {
            const double rj = radii[j] + probe;
            const double dx = positions[3 * j] - xi, dy = positions[3 * j + 1] - yi, dz = positions[3 * j + 2] - zi;
            const double d2 = dx * dx + dy * dy + dz * dz;
            const double reach = ri + rj;
            if (d2 < reach * reach) keep.push_back({d2, j});
        }
        std::sort(keep.begin(), keep.end());
        npx.clear(); npy.clear(); npz.clear(); nr2.clear();
        for (const auto& [d2, j] : keep) {
            const double rj = radii[j] + probe;
            npx.push_back(positions[3 * j]);
            npy.push_back(positions[3 * j + 1]);
            npz.push_back(positions[3 * j + 2]);
            nr2.push_back(rj * rj);
        }

        int exposed = 0;
        const size_t m = npx.size();
        for (int p = 0; p < n_points; ++p) {
            const double tx = xi + ri * sphere[3 * p];
            const double ty = yi + ri * sphere[3 * p + 1];
            const double tz = zi + ri * sphere[3 * p + 2];
            bool buried = false;
            for (size_t k = 0; k < m; ++k) {
                const double dx = tx - npx[k], dy = ty - npy[k], dz = tz - npz[k];
                if (dx * dx + dy * dy + dz * dz < nr2[k]) { buried = true; break; }
            }
            if (!buried) {
                ++exposed;
                if (points_out) {
                    points_out[3 * out_count] = tx;
                    points_out[3 * out_count + 1] = ty;
                    points_out[3 * out_count + 2] = tz;
                    ++out_count;
                }
            }
        }
        areas_out[i] = 4.0 * M_PI * ri * ri * (static_cast<double>(exposed) / n_points);
    }
    if (n_points_out) *n_points_out = out_count;
}

}  // extern "C"
