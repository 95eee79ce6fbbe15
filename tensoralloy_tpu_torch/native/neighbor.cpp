// Native neighbor-list + triple-list kernels.
//
// The reference framework's dominant inference cost is host-side
// featurization in Python (SURVEY §6: 26.6 s neighbor list for 128k
// atoms). This C++ cell-list implementation replaces both the scipy
// cKDTree path and the per-atom Python triple loop.
//
// Algorithm: ghost-image expansion (periodic shifts whose images can
// fall within `cutoff` of the home cell) followed by a uniform-grid
// cell list with bin size >= cutoff; each home atom scans its 27
// neighboring bins. Output is the full directed pair list with
// integer lattice shifts, matching ase.neighborlist semantics.
//
// Exposed via a C ABI for ctypes.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>
#include <algorithm>
#include <cstdio>
#include <chrono>
#include <thread>

namespace {

struct Vec3 {
    double x, y, z;
};

inline double dot(const double *a, const double *b) {
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// heights between opposite faces of the cell (rows are lattice vectors)
void cell_heights(const double *cell, double *heights) {
    // h_i = V / |a_j x a_k|
    const double *a0 = cell, *a1 = cell + 3, *a2 = cell + 6;
    double c01[3] = {a0[1] * a1[2] - a0[2] * a1[1],
                     a0[2] * a1[0] - a0[0] * a1[2],
                     a0[0] * a1[1] - a0[1] * a1[0]};
    double vol = std::fabs(dot(c01, a2));
    double crosses[3][3];
    // a1 x a2
    crosses[0][0] = a1[1] * a2[2] - a1[2] * a2[1];
    crosses[0][1] = a1[2] * a2[0] - a1[0] * a2[2];
    crosses[0][2] = a1[0] * a2[1] - a1[1] * a2[0];
    // a2 x a0
    crosses[1][0] = a2[1] * a0[2] - a2[2] * a0[1];
    crosses[1][1] = a2[2] * a0[0] - a2[0] * a0[2];
    crosses[1][2] = a2[0] * a0[1] - a2[1] * a0[0];
    // a0 x a1
    crosses[2][0] = c01[0];
    crosses[2][1] = c01[1];
    crosses[2][2] = c01[2];
    for (int i = 0; i < 3; ++i) {
        double area = std::sqrt(dot(crosses[i], crosses[i]));
        heights[i] = area > 1e-300 ? vol / area : 1e30;
    }
}

}  // namespace

extern "C" {

// Returns the number of pairs found, or -(needed) if `cap` was too
// small (caller retries with a bigger buffer). Outputs:
//   out_i, out_j      int32 [cap]
//   out_shift         int32 [cap, 3]
//   out_dist          double [cap]
//   out_vec           double [cap, 3]
long long ta_neighbor_list(
    long long natoms, const double *positions, const double *cell,
    const unsigned char *pbc, double cutoff, long long cap,
    int32_t *out_i, int32_t *out_j, int32_t *out_shift,
    double *out_dist, double *out_vec) {

    double heights[3];
    cell_heights(cell, heights);
    int reps[3];
    for (int d = 0; d < 3; ++d) {
        reps[d] = pbc[d] ? static_cast<int>(
            std::ceil(cutoff / heights[d])) : 0;
    }

    // Home-cell bounding box; ghost images are only kept inside a
    // cutoff-thick shell around it (a huge reduction vs naive
    // (2r+1)^3 expansion for multi-image cells).
    double hlo[3] = {1e300, 1e300, 1e300};
    double hhi[3] = {-1e300, -1e300, -1e300};
    for (long long a = 0; a < natoms; ++a) {
        for (int d = 0; d < 3; ++d) {
            hlo[d] = std::min(hlo[d], positions[3 * a + d]);
            hhi[d] = std::max(hhi[d], positions[3 * a + d]);
        }
    }
    const double margin = cutoff * 1.000001;

    std::vector<double> gx, gy, gz;
    std::vector<int32_t> gatom;
    std::vector<int32_t> gshift;
    const long long est = natoms * 2;
    gx.reserve(est); gy.reserve(est); gz.reserve(est);
    gatom.reserve(est); gshift.reserve(est * 3);

    for (int sx = -reps[0]; sx <= reps[0]; ++sx)
        for (int sy = -reps[1]; sy <= reps[1]; ++sy)
            for (int sz = -reps[2]; sz <= reps[2]; ++sz) {
                const double ox = sx * cell[0] + sy * cell[3] + sz * cell[6];
                const double oy = sx * cell[1] + sy * cell[4] + sz * cell[7];
                const double oz = sx * cell[2] + sy * cell[5] + sz * cell[8];
                for (long long a = 0; a < natoms; ++a) {
                    const double x = positions[3 * a] + ox;
                    const double y = positions[3 * a + 1] + oy;
                    const double z = positions[3 * a + 2] + oz;
                    if (x < hlo[0] - margin || x > hhi[0] + margin ||
                        y < hlo[1] - margin || y > hhi[1] + margin ||
                        z < hlo[2] - margin || z > hhi[2] + margin)
                        continue;
                    gx.push_back(x);
                    gy.push_back(y);
                    gz.push_back(z);
                    gatom.push_back(static_cast<int32_t>(a));
                    gshift.push_back(sx);
                    gshift.push_back(sy);
                    gshift.push_back(sz);
                }
            }
    const long long nimages = static_cast<long long>(gx.size());
    auto t_ghost = std::chrono::steady_clock::now();

    double lo[3] = {hlo[0] - margin, hlo[1] - margin, hlo[2] - margin};
    double hi[3] = {hhi[0] + margin, hhi[1] + margin, hhi[2] + margin};
    const double bin = std::max(cutoff, 1e-3);
    long long nb[3];
    for (int d = 0; d < 3; ++d) {
        nb[d] = std::max<long long>(
            1, static_cast<long long>((hi[d] - lo[d]) / bin) + 1);
    }

    auto bin_of = [&](double x, double y, double z) -> long long {
        long long bxi = std::min<long long>(
            nb[0] - 1, std::max<long long>(0, (long long)((x - lo[0]) / bin)));
        long long byi = std::min<long long>(
            nb[1] - 1, std::max<long long>(0, (long long)((y - lo[1]) / bin)));
        long long bzi = std::min<long long>(
            nb[2] - 1, std::max<long long>(0, (long long)((z - lo[2]) / bin)));
        return (bxi * nb[1] + byi) * nb[2] + bzi;
    };

    // counting sort of images into bins, then a physical gather so the
    // per-bin scan below walks contiguous memory
    const long long nbins = nb[0] * nb[1] * nb[2];
    std::vector<long long> counts(nbins + 1, 0);
    std::vector<long long> binidx(nimages);
    for (long long k = 0; k < nimages; ++k) {
        binidx[k] = bin_of(gx[k], gy[k], gz[k]);
        counts[binidx[k] + 1]++;
    }
    for (long long b = 0; b < nbins; ++b) counts[b + 1] += counts[b];
    std::vector<double> sx_(nimages), sy_(nimages), sz_(nimages);
    std::vector<int32_t> satom(nimages), sshift(nimages * 3);
    {
        std::vector<long long> cursor(counts.begin(), counts.end() - 1);
        for (long long k = 0; k < nimages; ++k) {
            const long long p = cursor[binidx[k]]++;
            sx_[p] = gx[k];
            sy_[p] = gy[k];
            sz_[p] = gz[k];
            satom[p] = gatom[k];
            sshift[3 * p] = gshift[3 * k];
            sshift[3 * p + 1] = gshift[3 * k + 1];
            sshift[3 * p + 2] = gshift[3 * k + 2];
        }
    }

    auto t_sort = std::chrono::steady_clock::now();
    const double cut2 = cutoff * cutoff;

    // Parallel pair scan: home atoms are partitioned into contiguous
    // ranges; pass 1 counts each atom's pairs, an exclusive prefix sum
    // assigns offsets, pass 2 writes — output is bit-identical to the
    // serial scan (ordered by center atom) for any thread count.
    // Thread count: TA_NEIGH_THREADS or hardware_concurrency (on a
    // single-core host this collapses to the serial loop).
    long long nthreads = 1;
    if (const char *env = std::getenv("TA_NEIGH_THREADS")) {
        nthreads = std::max(1LL, std::min(256LL, atoll(env)));
    } else {
        nthreads = std::max(1u, std::thread::hardware_concurrency());
    }
    nthreads = std::max(1LL, std::min(nthreads, natoms / 512));

    std::vector<long long> atom_count(natoms + 1, 0);

    auto count_range = [&](long long a0, long long a1) {
        for (long long i = a0; i < a1; ++i) {
            const double xi = positions[3 * i], yi = positions[3 * i + 1],
                         zi = positions[3 * i + 2];
            const long long bx = (long long)((xi - lo[0]) / bin);
            const long long by = (long long)((yi - lo[1]) / bin);
            const long long bz = (long long)((zi - lo[2]) / bin);
            long long c = 0;
            for (long long dx = bx - 1; dx <= bx + 1; ++dx) {
                if (dx < 0 || dx >= nb[0]) continue;
                for (long long dy = by - 1; dy <= by + 1; ++dy) {
                    if (dy < 0 || dy >= nb[1]) continue;
                    for (long long dz = bz - 1; dz <= bz + 1; ++dz) {
                        if (dz < 0 || dz >= nb[2]) continue;
                        const long long b = (dx * nb[1] + dy) * nb[2] + dz;
                        for (long long k = counts[b]; k < counts[b + 1];
                             ++k) {
                            const double rx = sx_[k] - xi;
                            const double ry = sy_[k] - yi;
                            const double rz = sz_[k] - zi;
                            const double d2 = rx * rx + ry * ry + rz * rz;
                            if (d2 >= cut2 || d2 < 1e-20) continue;
                            ++c;
                        }
                    }
                }
            }
            atom_count[i + 1] = c;
        }
    };

    auto write_range = [&](long long a0, long long a1) {
        for (long long i = a0; i < a1; ++i) {
            const double xi = positions[3 * i], yi = positions[3 * i + 1],
                         zi = positions[3 * i + 2];
            const long long bx = (long long)((xi - lo[0]) / bin);
            const long long by = (long long)((yi - lo[1]) / bin);
            const long long bz = (long long)((zi - lo[2]) / bin);
            long long w = atom_count[i];
            for (long long dx = bx - 1; dx <= bx + 1; ++dx) {
                if (dx < 0 || dx >= nb[0]) continue;
                for (long long dy = by - 1; dy <= by + 1; ++dy) {
                    if (dy < 0 || dy >= nb[1]) continue;
                    for (long long dz = bz - 1; dz <= bz + 1; ++dz) {
                        if (dz < 0 || dz >= nb[2]) continue;
                        const long long b = (dx * nb[1] + dy) * nb[2] + dz;
                        for (long long k = counts[b]; k < counts[b + 1];
                             ++k) {
                            const double rx = sx_[k] - xi;
                            const double ry = sy_[k] - yi;
                            const double rz = sz_[k] - zi;
                            const double d2 = rx * rx + ry * ry + rz * rz;
                            if (d2 >= cut2 || d2 < 1e-20) continue;
                            out_i[w] = static_cast<int32_t>(i);
                            out_j[w] = satom[k];
                            out_shift[3 * w] = sshift[3 * k];
                            out_shift[3 * w + 1] = sshift[3 * k + 1];
                            out_shift[3 * w + 2] = sshift[3 * k + 2];
                            out_dist[w] = std::sqrt(d2);
                            out_vec[3 * w] = rx;
                            out_vec[3 * w + 1] = ry;
                            out_vec[3 * w + 2] = rz;
                            ++w;
                        }
                    }
                }
            }
        }
    };

    auto run_parallel = [&](auto &&fn) {
        if (nthreads <= 1) {
            fn(0, natoms);
            return;
        }
        std::vector<std::thread> pool;
        pool.reserve(nthreads);
        const long long per = (natoms + nthreads - 1) / nthreads;
        for (long long t = 0; t < nthreads; ++t) {
            const long long a0 = t * per;
            const long long a1 = std::min(natoms, a0 + per);
            if (a0 >= a1) break;
            pool.emplace_back(fn, a0, a1);
        }
        for (auto &th : pool) th.join();
    };

    run_parallel(count_range);
    for (long long i = 0; i < natoms; ++i)
        atom_count[i + 1] += atom_count[i];
    const long long found = atom_count[natoms];
    if (found <= cap) run_parallel(write_range);
    auto t_scan = std::chrono::steady_clock::now();
    if (getenv("TA_NEIGH_DEBUG")) {
        fprintf(stderr, "[ta] images=%lld sort=%.3f scan=%.3f\n",
                nimages,
                std::chrono::duration<double>(t_sort - t_ghost).count(),
                std::chrono::duration<double>(t_scan - t_sort).count());
    }
    if (found > cap) return -found;
    return found;
}

// Build symmetric j<k triples from a pair list sorted by center atom.
// In: pair arrays (i sorted ascending), natoms. Out: triple index
// pairs (p, q) into the pair arrays. Returns count or -(needed).
long long ta_triple_list(
    long long npairs, const int32_t *ilist, long long natoms,
    long long cap, int32_t *out_p, int32_t *out_q) {
    long long found = 0;
    long long start = 0;
    while (start < npairs) {
        long long end = start;
        const int32_t center = ilist[start];
        while (end < npairs && ilist[end] == center) ++end;
        for (long long p = start; p < end; ++p) {
            for (long long q = p + 1; q < end; ++q) {
                if (found < cap) {
                    out_p[found] = static_cast<int32_t>(p);
                    out_q[found] = static_cast<int32_t>(q);
                }
                ++found;
            }
        }
        start = end;
    }
    if (found > cap) return -found;
    return found;
}

}  // extern "C"
