// Native host-side polygon booleans for subzero_tpu_torch (the package's own
// copy of subzero_tpu/native/clip.cpp; framework-neutral host C++).
//
// C++ implementation of the crossing-graph Weiler-Atherton booleans in
// geometry/host_clip.py (the host-side stand-in for the Julia model's
// GeometryOps.jl layer, floe_utils.jl:55-80).  The
// algorithm, branch structure, epsilons, and degeneracy-retry schedule
// mirror the Python implementation exactly so both produce the same rings
// on the same inputs; the C++ path exists because the host life-cycle
// passes (welding / smoothing / ridge-raft piece handling) call these
// booleans inside O(N^2)-ish host loops, where the pure-Python inner
// O(V^2) crossing sweep dominates at large floe counts.
//
// Exposed via a minimal C ABI (ctypes-friendly), no Python.h dependency:
//   sz_poly_boolean(op, S, nS, C, nC, out_pts, ring_lens, max_rings,
//                   max_pts_total) -> n_rings (or -1 on unresolvable
//                   degeneracy, -2 on output overflow)
// op: 0 = intersection, 1 = union, 2 = difference.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Pt {
    double x, y;
};

using Ring = std::vector<Pt>;

double poly_area(const Ring &c) {
    const size_t n = c.size();
    double s = 0.0;
    for (size_t i = 0; i < n; ++i) {
        const Pt &a = c[i];
        const Pt &b = c[(i + 1) % n];
        s += a.x * b.y - b.x * a.y;
    }
    return 0.5 * s;
}

Pt poly_centroid(const Ring &c) {
    const size_t n = c.size();
    double A = 0.0, cx = 0.0, cy = 0.0;
    for (size_t i = 0; i < n; ++i) {
        const Pt &a = c[i];
        const Pt &b = c[(i + 1) % n];
        const double cr = a.x * b.y - b.x * a.y;
        A += cr;
        cx += (a.x + b.x) * cr;
        cy += (a.y + b.y) * cr;
    }
    A *= 0.5;
    return Pt{cx / (6.0 * A), cy / (6.0 * A)};
}

// numpy allclose semantics (rtol=1e-5, atol=1e-8), per coordinate
bool close_pt(const Pt &a, const Pt &b) {
    const double rtol = 1e-5, atol = 1e-8;
    return std::fabs(a.x - b.x) <= atol + rtol * std::fabs(b.x) &&
           std::fabs(a.y - b.y) <= atol + rtol * std::fabs(b.y);
}

// host_clip._clean_ring: open CCW ring
Ring clean_ring(const Ring &in) {
    Ring c = in;
    if (c.size() > 1 && close_pt(c.front(), c.back())) c.pop_back();
    Ring out;
    for (size_t i = 0; i < c.size(); ++i) {
        if (out.empty() || !close_pt(c[i], out.back())) out.push_back(c[i]);
    }
    if (poly_area(out) < 0.0) {
        Ring rev(out.rbegin(), out.rend());
        out.swap(rev);
    }
    return out;
}

bool point_in(const Pt &p, const Ring &ring) {
    const size_t n = ring.size();
    bool inside = false;
    for (size_t i = 0; i < n; ++i) {
        const Pt &a = ring[i];
        const Pt &b = ring[(i + 1) % n];
        if ((a.y > p.y) != (b.y > p.y)) {
            const double xin = a.x + (p.y - a.y) / (b.y - a.y) * (b.x - a.x);
            if (p.x < xin) inside = !inside;
        }
    }
    return inside;
}

struct Crossing {
    Pt pt;
    int ei;
    double t;
    int ej;
    double u;
    double d;  // sign of cross(r, s)
};

struct Degenerate {};

// host_clip._crossings (eps = 1e-12)
std::vector<Crossing> crossings(const Ring &S, const Ring &C) {
    const double eps = 1e-12;
    std::vector<Crossing> out;
    const size_t nS = S.size(), nC = C.size();
    for (size_t i = 0; i < nS; ++i) {
        const Pt a0 = S[i], a1 = S[(i + 1) % nS];
        const Pt r{a1.x - a0.x, a1.y - a0.y};
        for (size_t j = 0; j < nC; ++j) {
            const Pt b0 = C[j], b1 = C[(j + 1) % nC];
            const Pt s{b1.x - b0.x, b1.y - b0.y};
            const double den = r.x * s.y - r.y * s.x;
            const Pt d0{b0.x - a0.x, b0.y - a0.y};
            if (den == 0.0) {
                const double rmax =
                    std::max(1.0, std::max(std::fabs(r.x), std::fabs(r.y)));
                const double dmax =
                    std::max(1.0, std::max(std::fabs(d0.x), std::fabs(d0.y)));
                if (std::fabs(d0.x * r.y - d0.y * r.x) < eps * rmax * dmax) {
                    const double L2 = r.x * r.x + r.y * r.y;
                    const double t0 = (d0.x * r.x + d0.y * r.y) / L2;
                    const Pt d1{b1.x - a0.x, b1.y - a0.y};
                    const double t1 = (d1.x * r.x + d1.y * r.y) / L2;
                    const double lo = std::min(t0, t1), hi = std::max(t0, t1);
                    if (hi > eps && lo < 1.0 - eps) throw Degenerate{};
                }
                continue;
            }
            const double t = (d0.x * s.y - d0.y * s.x) / den;
            const double u = (d0.x * r.y - d0.y * r.x) / den;
            const bool t_end = (-eps < t && t < eps) ||
                               (1.0 - eps < t && t < 1.0 + eps);
            const bool u_end = (-eps < u && u < eps) ||
                               (1.0 - eps < u && u < 1.0 + eps);
            if (t_end || u_end) {
                if (-eps < t && t < 1.0 + eps && -eps < u && u < 1.0 + eps)
                    throw Degenerate{};
                continue;
            }
            if (eps < t && t < 1.0 - eps && eps < u && u < 1.0 - eps) {
                out.push_back(Crossing{
                    Pt{a0.x + t * r.x, a0.y + t * r.y},
                    (int)i, t, (int)j, u, den > 0 ? 1.0 : -1.0});
            }
        }
    }
    return out;
}

// host_clip._arc_points
void arc_points(const Ring &ring, int e0, double t0, int e1, double t1,
                bool forward, Ring &out) {
    const int n = (int)ring.size();
    if (forward) {
        if (e0 == e1 && t1 > t0) return;
        int e = (e0 + 1) % n;
        while (true) {
            out.push_back(ring[e]);
            if (e == e1) break;
            e = (e + 1) % n;
        }
    } else {
        if (e0 == e1 && t1 < t0) return;
        int e = e0;
        const int stop = (e1 + 1) % n;
        while (true) {
            out.push_back(ring[e]);
            if (e == stop) break;
            e = (e - 1 + n) % n;
        }
    }
}

std::vector<Ring> boolean_op(const Ring &Sc, const Ring &Cc, int op);
std::vector<Ring> with_retries(const Ring &S0, const Ring &C0, int op,
                               bool &failed);

// host_clip._boolean_halfplane: diff when C is strictly inside S.
// Sub-operations use the retried entry point (as the Python version does);
// an exhausted inner retry surfaces as Degenerate to the outer loop.
std::vector<Ring> boolean_halfplane(const Ring &S, const Pt &hc, const Ring &C) {
    double xmin = S[0].x, xmax = S[0].x, ymin = S[0].y, ymax = S[0].y;
    for (const Pt &p : S) {
        xmin = std::min(xmin, p.x);
        xmax = std::max(xmax, p.x);
        ymin = std::min(ymin, p.y);
        ymax = std::max(ymax, p.y);
    }
    xmin -= 1.0;
    xmax += 1.0;
    ymin -= 1.0;
    ymax += 1.0;
    const Ring top{{xmin, hc.y}, {xmax, hc.y}, {xmax, ymax}, {xmin, ymax}};
    const Ring bot{{xmin, ymin}, {xmax, ymin}, {xmax, hc.y}, {xmin, hc.y}};
    std::vector<Ring> out;
    for (const Ring *half : {&top, &bot}) {
        bool f1 = false;
        for (const Ring &piece : with_retries(S, *half, 0, f1)) {
            bool f2 = false;
            for (Ring &r : with_retries(piece, C, 2, f2))
                out.push_back(std::move(r));
            if (f2) throw Degenerate{};
        }
        if (f1) throw Degenerate{};
    }
    return out;
}

// host_clip._boolean (op: 0=and, 1=or, 2=diff); throws Degenerate
std::vector<Ring> boolean_op(const Ring &Sc, const Ring &Cc, int op) {
    const Ring S = clean_ring(Sc);
    const Ring C = clean_ring(Cc);
    std::vector<Crossing> xs = crossings(S, C);
    std::vector<Ring> regions;
    if (xs.empty()) {
        const bool s_in_c = point_in(S[0], C);
        const bool c_in_s = point_in(C[0], S);
        if (op == 0) {
            if (s_in_c) regions.push_back(S);
            else if (c_in_s) regions.push_back(C);
        } else if (op == 1) {
            if (s_in_c) regions.push_back(C);
            else if (c_in_s) regions.push_back(S);
            else {
                regions.push_back(S);
                regions.push_back(C);
            }
        } else {
            if (s_in_c) {
                // empty
            } else if (c_in_s) {
                return boolean_halfplane(S, poly_centroid(C), C);
            } else {
                regions.push_back(S);
            }
        }
        return regions;
    }

    const int K = (int)xs.size();
    std::vector<int> orderS(K), orderC(K);
    for (int k = 0; k < K; ++k) orderS[k] = orderC[k] = k;
    auto keyS = [&](int k) { return xs[k].ei + xs[k].t; };
    auto keyC = [&](int k) { return xs[k].ej + xs[k].u; };
    std::sort(orderS.begin(), orderS.end(), [&](int a, int b) {
        return xs[a].ei != xs[b].ei ? xs[a].ei < xs[b].ei : xs[a].t < xs[b].t;
    });
    std::sort(orderC.begin(), orderC.end(), [&](int a, int b) {
        return xs[a].ej != xs[b].ej ? xs[a].ej < xs[b].ej : xs[a].u < xs[b].u;
    });
    (void)keyS;
    (void)keyC;
    std::vector<int> posS(K), posC(K);
    for (int m = 0; m < K; ++m) {
        posS[orderS[m]] = m;
        posC[orderC[m]] = m;
    }
    auto nxtS = [&](int k) { return orderS[(posS[k] + 1) % K]; };
    auto nxtC = [&](int k) { return orderC[(posC[k] + 1) % K]; };
    auto prvC = [&](int k) { return orderC[(posC[k] - 1 + K) % K]; };

    // odd crossing parity = unresolved tangency: successor permutation is
    // ill-formed (host_clip._boolean raises the same)
    if (K % 2 == 1) throw Degenerate{};

    std::vector<bool> visited(K, false);
    for (int start = 0; start < K; ++start) {
        if (visited[start]) continue;
        Ring pts;
        int k = start;
        bool closed = false;
        for (int guard = 0; guard < 2 * K + 4; ++guard) {
            if (visited[k] && k == start && !pts.empty()) { closed = true; break; }
            // walking into a previously traced cycle would emit a
            // self-overlapping open chain; flag for perturbation retry
            if (visited[k]) throw Degenerate{};
            visited[k] = true;
            const Crossing &x = xs[k];
            pts.push_back(x.pt);
            bool followS;
            if (op == 0) followS = x.d < 0;
            else followS = x.d > 0;  // or / diff
            int k2;
            if (followS) {
                k2 = nxtS(k);
                arc_points(S, x.ei, x.t, xs[k2].ei, xs[k2].t, true, pts);
            } else if (op == 2) {
                k2 = prvC(k);
                arc_points(C, x.ej, x.u, xs[k2].ej, xs[k2].u, false, pts);
            } else {
                k2 = nxtC(k);
                arc_points(C, x.ej, x.u, xs[k2].ej, xs[k2].u, true, pts);
            }
            k = k2;
            if (k == start) { closed = true; break; }
        }
        if (!closed) throw Degenerate{};
        if (pts.size() >= 3) {
            Ring ring = clean_ring(pts);
            if (ring.size() >= 3 && poly_area(ring) > 1e-12) {
                // mis-paired successor walks can close into a
                // self-intersecting ring; flag for perturbation retry
                // (host_clip._is_simple_ring)
                const int n = (int)ring.size();
                double rscale = 1.0;
                for (const Pt &p : ring)
                    rscale = std::max(rscale,
                                      std::max(std::fabs(p.x), std::fabs(p.y)));
                for (int i = 0; i < n; ++i)
                    for (int j = i + 1; j < n; ++j)
                        if (std::fabs(ring[i].x - ring[j].x) <= 1e-12 * rscale &&
                            std::fabs(ring[i].y - ring[j].y) <= 1e-12 * rscale)
                            throw Degenerate{};
                for (int i = 0; i < n; ++i) {
                    const Pt &ai = ring[i], &bi = ring[(i + 1) % n];
                    const double dix = bi.x - ai.x, diy = bi.y - ai.y;
                    for (int j = i + 2; j < n; ++j) {
                        if (i == 0 && j == n - 1) continue;
                        const Pt &aj = ring[j], &bj = ring[(j + 1) % n];
                        const double djx = bj.x - aj.x, djy = bj.y - aj.y;
                        const double den = dix * djy - diy * djx;
                        if (den == 0.0) continue;
                        const double wx = aj.x - ai.x, wy = aj.y - ai.y;
                        const double t = (wx * djy - wy * djx) / den;
                        const double u = (wx * diy - wy * dix) / den;
                        if (t > 1e-12 && t < 1.0 - 1e-12 &&
                            u > 1e-12 && u < 1.0 - 1e-12)
                            throw Degenerate{};
                    }
                }
                regions.push_back(std::move(ring));
            }
        }
    }
    return regions;
}

// host_clip._with_retries
std::vector<Ring> with_retries(const Ring &S0, const Ring &C0, int op,
                               bool &failed) {
    double scale = 1.0;
    for (const Pt &p : S0)
        scale = std::max(scale, std::max(std::fabs(p.x), std::fabs(p.y)));
    for (const Pt &p : C0)
        scale = std::max(scale, std::max(std::fabs(p.x), std::fabs(p.y)));
    failed = false;
    for (int attempt = 0; attempt < 8; ++attempt) {
        try {
            if (attempt == 0) return boolean_op(S0, C0, op);
            const double delta = scale * 1e-9 * std::pow(3.0, attempt - 1);
            Ring C = C0;
            const double ox = 0.6180339887 * delta, oy = 1.0 * delta;
            for (Pt &p : C) {
                p.x += ox;
                p.y += oy;
            }
            return boolean_op(S0, C, op);
        } catch (const Degenerate &) {
            continue;
        }
    }
    failed = true;
    return {};
}

}  // namespace

extern "C" {

// Returns the number of output rings written, -1 on unresolvable
// degeneracy (8 perturbation retries exhausted), -2 if the output buffers
// are too small.  out_pts receives ring vertices back-to-back (x, y
// interleaved); ring_lens[i] = vertex count of ring i.
int sz_poly_boolean(int op, const double *Sp, int nS, const double *Cp,
                    int nC, double *out_pts, int *ring_lens, int max_rings,
                    int max_pts_total) {
    Ring S(nS), C(nC);
    for (int i = 0; i < nS; ++i) S[i] = Pt{Sp[2 * i], Sp[2 * i + 1]};
    for (int i = 0; i < nC; ++i) C[i] = Pt{Cp[2 * i], Cp[2 * i + 1]};
    bool failed = false;
    std::vector<Ring> regions = with_retries(S, C, op, failed);
    if (failed) return -1;
    if ((int)regions.size() > max_rings) return -2;
    int total = 0;
    for (size_t r = 0; r < regions.size(); ++r) {
        const Ring &ring = regions[r];
        if (total + (int)ring.size() > max_pts_total) return -2;
        ring_lens[r] = (int)ring.size();
        for (const Pt &p : ring) {
            out_pts[2 * total] = p.x;
            out_pts[2 * total + 1] = p.y;
            ++total;
        }
    }
    return (int)regions.size();
}

// Batched pairwise intersection AREAS: for each of n_pairs (ia, ib) index
// pairs into a vertex pool (verts: [n_polys][max_v][2] row-major, nverts
// per poly), writes the total intersection area.  Used by the host
// welding/smoothing neighbor sweeps, where the Python-loop boolean calls
// dominate at large N.
void sz_pairwise_intersect_area(const double *verts, const int *nverts,
                                int max_v, const int *ia, const int *ib,
                                int n_pairs, double *area_out) {
    for (int k = 0; k < n_pairs; ++k) {
        const int a = ia[k], b = ib[k];
        Ring S(nverts[a]), C(nverts[b]);
        for (int i = 0; i < nverts[a]; ++i)
            S[i] = Pt{verts[(size_t)a * max_v * 2 + 2 * i],
                      verts[(size_t)a * max_v * 2 + 2 * i + 1]};
        for (int i = 0; i < nverts[b]; ++i)
            C[i] = Pt{verts[(size_t)b * max_v * 2 + 2 * i],
                      verts[(size_t)b * max_v * 2 + 2 * i + 1]};
        bool failed = false;
        std::vector<Ring> regions = with_retries(S, C, 0, failed);
        double total = 0.0;
        if (!failed)
            for (const Ring &r : regions) total += poly_area(r);
        area_out[k] = failed ? -1.0 : total;
    }
}

}  // extern "C"
