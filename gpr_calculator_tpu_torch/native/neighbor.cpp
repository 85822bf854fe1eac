// Native neighbour-pair builder (host runtime component).
//
// Replaces the reference's per-step use of ase.neighborlist.NeighborList
// (gpr_calc/SO3.py:348-407) with a C++ brute-force O(natoms^2 x images) builder (a cell list is the natural upgrade at >10^3 atoms) so the
// host side of the per-NEB-step path is not Python-bound.
//
// Semantics match the reference: pairs (i, j, image) with
// 0 < |r_j + S*cell - r_i| < rcut, both directions, self-images included,
// (i, i, 0) excluded.
//
// API (C, ctypes-friendly):
//   n = neighbor_build(natoms, positions, cell, pbc, rcut,
//                      cap, out_i, out_j, out_rij)
// returns the number of pairs found; if it exceeds `cap`, nothing is
// written beyond cap and the required capacity is returned (caller retries).

#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

long long neighbor_build(long long natoms,
                         const double* positions,   // (natoms, 3)
                         const double* cell,        // (3, 3) row-major
                         const int* pbc,            // (3,)
                         double rcut,
                         long long cap,
                         long long* out_i,
                         long long* out_j,
                         double* out_rij) {         // (cap, 3)
    // image ranges from perpendicular cell heights
    int nimg[3] = {0, 0, 0};
    double vol = cell[0] * (cell[4] * cell[8] - cell[5] * cell[7])
               - cell[1] * (cell[3] * cell[8] - cell[5] * cell[6])
               + cell[2] * (cell[3] * cell[7] - cell[4] * cell[6]);
    vol = std::fabs(vol);
    for (int k = 0; k < 3; ++k) {
        if (!pbc[k]) continue;
        const double* b = cell + 3 * ((k + 1) % 3);
        const double* c = cell + 3 * ((k + 2) % 3);
        double cx = b[1] * c[2] - b[2] * c[1];
        double cy = b[2] * c[0] - b[0] * c[2];
        double cz = b[0] * c[1] - b[1] * c[0];
        double area = std::sqrt(cx * cx + cy * cy + cz * cz);
        double height = (area > 0 && vol > 0) ? vol / area : 0.0;
        nimg[k] = (height > 0) ? (int)std::ceil(rcut / height) : 0;
    }

    const double rcut2 = rcut * rcut;
    long long count = 0;
    for (int sa = -nimg[0]; sa <= nimg[0]; ++sa)
    for (int sb = -nimg[1]; sb <= nimg[1]; ++sb)
    for (int sc = -nimg[2]; sc <= nimg[2]; ++sc) {
        const double ox = sa * cell[0] + sb * cell[3] + sc * cell[6];
        const double oy = sa * cell[1] + sb * cell[4] + sc * cell[7];
        const double oz = sa * cell[2] + sb * cell[5] + sc * cell[8];
        const bool zero_image = (sa == 0 && sb == 0 && sc == 0);
        for (long long i = 0; i < natoms; ++i) {
            const double xi = positions[3 * i];
            const double yi = positions[3 * i + 1];
            const double zi = positions[3 * i + 2];
            for (long long j = 0; j < natoms; ++j) {
                if (zero_image && i == j) continue;
                const double dx = positions[3 * j] + ox - xi;
                const double dy = positions[3 * j + 1] + oy - yi;
                const double dz = positions[3 * j + 2] + oz - zi;
                const double d2 = dx * dx + dy * dy + dz * dz;
                if (d2 < rcut2 && d2 > 1e-20) {
                    if (count < cap) {
                        out_i[count] = i;
                        out_j[count] = j;
                        out_rij[3 * count] = dx;
                        out_rij[3 * count + 1] = dy;
                        out_rij[3 * count + 2] = dz;
                    }
                    ++count;
                }
            }
        }
    }
    return count;
}

}  // extern "C"
