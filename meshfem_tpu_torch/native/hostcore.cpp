// hostcore — native host-side preprocessing for meshfem_tpu.
//
// The TPU compute path is JAX/XLA; this C++ module is the native runtime
// around it (the role the reference's C++ mesh/connectivity layer plays):
// connectivity construction, FEM edge-node numbering, and scatter-plan
// building over multi-million-element meshes, exposed through a plain C ABI
// loaded with ctypes.  Everything is O(R log R) sort-based and allocation-
// light; Python keeps vectorized numpy fallbacks.
//
// Build: g++ -O3 -march=native -shared -fPIC hostcore.cpp -o libhostcore.so

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Face matching (TriMesh/TetMesh mate construction).
// face_verts: [H, k] vertex ids per half-entity.  Writes opp[H] with the
// paired half-entity index or -1 for boundary.  Returns 0 on success,
// 1 if a face is shared by more than two elements (non-manifold).
// ---------------------------------------------------------------------------
int match_faces(const int64_t* face_verts, int64_t H, int32_t k,
                int64_t* opp) {
    std::vector<std::array<int64_t, 4>> keys(H);
    for (int64_t h = 0; h < H; ++h) {
        std::array<int64_t, 4> key{{0, 0, 0, 0}};
        for (int32_t j = 0; j < k; ++j) key[j] = face_verts[h * k + j];
        std::sort(key.begin(), key.begin() + k);
        key[3] = h;  // carry the index in the last slot (k <= 3)
        keys[h] = key;
    }
    std::sort(keys.begin(), keys.end(),
              [](const std::array<int64_t, 4>& a,
                 const std::array<int64_t, 4>& b) {
                  if (a[0] != b[0]) return a[0] < b[0];
                  if (a[1] != b[1]) return a[1] < b[1];
                  return a[2] < b[2];
              });
    for (int64_t h = 0; h < H; ++h) opp[h] = -1;
    auto same = [&](int64_t i, int64_t j) {
        return keys[i][0] == keys[j][0] && keys[i][1] == keys[j][1] &&
               keys[i][2] == keys[j][2];
    };
    for (int64_t i = 0; i + 1 < H;) {
        if (same(i, i + 1)) {
            if (i + 2 < H && same(i, i + 2)) return 1;  // non-manifold
            opp[keys[i][3]] = keys[i + 1][3];
            opp[keys[i + 1][3]] = keys[i][3];
            i += 2;
        } else {
            ++i;
        }
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Unique-edge numbering (P2 node construction, FEMMesh.inl's std::map
// replacement).  pairs: [M, 2] vertex ids.  Writes edge_id[M] (0-based ids
// of the unique sorted-pair set) and unique_pairs[2 * n_unique] (sorted
// lexicographically).  Returns n_unique.
// ---------------------------------------------------------------------------
int64_t unique_edges(const int64_t* pairs, int64_t M, int64_t* edge_id,
                     int64_t* unique_pairs /* capacity 2*M */) {
    std::vector<std::array<int64_t, 3>> keys(M);
    for (int64_t m = 0; m < M; ++m) {
        int64_t a = pairs[2 * m], b = pairs[2 * m + 1];
        if (a > b) std::swap(a, b);
        keys[m] = {{a, b, m}};
    }
    std::sort(keys.begin(), keys.end());
    int64_t nu = -1;
    int64_t pa = -1, pb = -1;
    for (int64_t i = 0; i < M; ++i) {
        if (keys[i][0] != pa || keys[i][1] != pb) {
            ++nu;
            pa = keys[i][0];
            pb = keys[i][1];
            unique_pairs[2 * nu] = pa;
            unique_pairs[2 * nu + 1] = pb;
        }
        edge_id[keys[i][2]] = nu;
    }
    return nu + 1;
}

// ---------------------------------------------------------------------------
// Gather-pyramid scatter-plan construction (sparse/scatter.py ScatterPlan).
// ids: [R] segment ids in [0, N).  Outputs:
//   gidx1 [P1]   (P1 = sum over segments of ceil(count/g1)*g1; dummy = R)
//   gidx2 [N*g2] (g2 = max groups per segment; dummy = NG)
// Two-call protocol: first call with gidx1 == nullptr fills sizes[3] =
// {P1, g2, NG}; second call fills the arrays.
// ---------------------------------------------------------------------------
void build_scatter_plan(const int64_t* ids, int64_t R, int64_t N,
                        int64_t g1, int64_t* sizes, int32_t* gidx1,
                        int32_t* gidx2) {
    std::vector<int64_t> counts(N, 0);
    for (int64_t r = 0; r < R; ++r) counts[ids[r]]++;
    std::vector<int64_t> padded(N), ngroups(N);
    int64_t P1 = 0, NG = 0, g2 = 1;
    for (int64_t v = 0; v < N; ++v) {
        padded[v] = (counts[v] + g1 - 1) / g1 * g1;
        ngroups[v] = padded[v] / g1;
        P1 += padded[v];
        NG += ngroups[v];
        if (ngroups[v] > g2) g2 = ngroups[v];
    }
    sizes[0] = P1;
    sizes[1] = g2;
    sizes[2] = NG;
    if (gidx1 == nullptr) return;

    std::vector<int64_t> offs_p(N + 1, 0), goffs(N + 1, 0);
    for (int64_t v = 0; v < N; ++v) {
        offs_p[v + 1] = offs_p[v] + padded[v];
        goffs[v + 1] = goffs[v] + ngroups[v];
    }
    for (int64_t i = 0; i < P1; ++i) gidx1[i] = (int32_t)R;  // dummy row
    std::vector<int64_t> cursor(offs_p.begin(), offs_p.end() - 1);
    for (int64_t r = 0; r < R; ++r) {
        gidx1[cursor[ids[r]]++] = (int32_t)r;
    }
    for (int64_t i = 0; i < N * g2; ++i) gidx2[i] = (int32_t)NG;  // dummy
    for (int64_t v = 0; v < N; ++v)
        for (int64_t g = 0; g < ngroups[v]; ++g)
            gidx2[v * g2 + g] = (int32_t)(goffs[v] + g);
}

// ---------------------------------------------------------------------------
// Morton codes (mesh/reorder.py) for [n, d] quantized coordinates.
// ---------------------------------------------------------------------------
void morton_codes(const uint64_t* q, int64_t n, int32_t d, int32_t bits,
                  uint64_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        uint64_t code = 0;
        for (int32_t b = 0; b < bits; ++b)
            for (int32_t ax = 0; ax < d; ++ax)
                code |= (((q[i * d + ax] >> b) & 1ull) << (b * d + ax));
        out[i] = code;
    }
}

// ---------------------------------------------------------------------------
// Quality constrained Delaunay triangulation (Ruppert refinement) — the
// native replacement for Triangle's triangulatePSLG quality/area modes
// (reference Triangulate.h:83).  Bowyer-Watson incremental Delaunay with
// segment splitting on encroachment and circumcenter insertion for bad
// triangles; holes/outside removed by centroid-in-polygon tests against
// the input PSLG.
// ---------------------------------------------------------------------------
}  // extern "C"

#include <array>
#include <cmath>
#include <cstdint>
#include <deque>
#include <map>
#include <queue>
#include <set>
#include <tuple>
#include <unordered_map>
#include <vector>

// ---------------------------------------------------------------------------
// Robust geometric predicates (Shewchuk-style): a floating-point filter
// with a conservative forward error bound, falling back to EXACT sign
// evaluation via nonoverlapping floating-point expansions (two_sum /
// two_prod / scale / merge — Shewchuk 1997).  The expansion path only
// fires on (near-)degenerate inputs, e.g. exactly cocircular grid
// points, which corrupted the f.p.-only CDT before.
// ---------------------------------------------------------------------------
namespace robust {

// Expansions live in caller-provided stack buffers (double*, int len) —
// the exact path fires on EVERY insertion of a regular refinement
// pattern (cocircular configurations are generic there), so per-call
// heap allocation dominated the first vector-based implementation.

static inline void two_sum(double a, double b, double& x, double& y) {
    x = a + b;
    double bv = x - a;
    y = (a - (x - bv)) + (b - bv);
}

static inline void two_diff(double a, double b, double& x, double& y) {
    x = a - b;
    double bv = a - x;
    y = (a - (x + bv)) + (bv - b);
}

static inline void two_prod(double a, double b, double& x, double& y) {
    x = a * b;
    y = std::fma(a, b, -x);
}

// h = e + b (grow_expansion_zeroelim); h may NOT alias e
static inline int grow(const double* e, int elen, double b, double* h) {
    int n = 0;
    double q = b;
    for (int i = 0; i < elen; ++i) {
        double qn, r;
        two_sum(q, e[i], qn, r);
        if (r != 0.0) h[n++] = r;
        q = qn;
    }
    if (q != 0.0 || n == 0) h[n++] = q;
    return n;
}

// h = e + f; h may NOT alias e or f; scratch must hold elen + flen
static inline int add(const double* e, int elen, const double* f, int flen,
                      double* h, double* scratch) {
    // ping-pong between h and scratch, growing one f component at a time
    const double* cur = e;
    int clen = elen;
    double* a = scratch;
    double* b = h;
    for (int i = 0; i < flen; ++i) {
        int n = grow(cur, clen, f[i], a);
        cur = a;
        clen = n;
        std::swap(a, b);
    }
    if (cur != h) std::memcpy(h, cur, clen * sizeof(double));
    return clen;
}

// h = e * b (scale_expansion_zeroelim); h may NOT alias e
static inline int scale(const double* e, int elen, double b, double* h) {
    if (elen == 0) return 0;
    int n = 0;
    double q, hh;
    two_prod(e[0], b, q, hh);
    if (hh != 0.0) h[n++] = hh;
    for (int i = 1; i < elen; ++i) {
        double t1, t0;
        two_prod(e[i], b, t1, t0);
        double q2, r;
        two_sum(q, t0, q2, r);
        if (r != 0.0) h[n++] = r;
        double q3;
        two_sum(t1, q2, q3, r);
        if (r != 0.0) h[n++] = r;
        q = q3;
    }
    if (q != 0.0 || n == 0) h[n++] = q;
    return n;
}

// h = e * f; needs scratch of >= 2 * cap each
template <int CAP>
static inline int mul(const double* e, int elen, const double* f, int flen,
                      double* h) {
    double term[2 * CAP], acc[CAP], scratch[CAP];
    int alen = 0;
    for (int i = 0; i < flen; ++i) {
        double sc[CAP];
        int slen = scale(e, elen, f[i], sc);
        alen = add(acc, alen, sc, slen, term, scratch);
        std::memcpy(acc, term, alen * sizeof(double));
    }
    std::memcpy(h, acc, alen * sizeof(double));
    return alen;
}

static inline int esign(const double* e, int n) {
    for (int i = n; i-- > 0;) {
        if (e[i] > 0.0) return 1;
        if (e[i] < 0.0) return -1;
    }
    return 0;
}

static inline int from_diff(double a, double b, double* e) {
    double x, y;
    two_diff(a, b, x, y);
    int n = 0;
    if (y != 0.0) e[n++] = y;
    e[n++] = x;
    return n;
}

static const double EPS = 1.1102230246251565e-16;  // 2^-53

static inline int orient2d_sign(double ax, double ay, double bx, double by,
                                double cx, double cy) {
    double l = (bx - ax) * (cy - ay);
    double r = (by - ay) * (cx - ax);
    double det = l - r;
    double detsum = std::fabs(l) + std::fabs(r);
    if (std::fabs(det) > 8.0 * EPS * detsum)
        return det > 0 ? 1 : -1;
    // exact: products of 2-term diffs are <= 8 terms, sum <= 16
    double e1[2], e2[2], e3[2], e4[2], p1[8], p2[8], d[16], s[16];
    int n1 = from_diff(bx, ax, e1), n2 = from_diff(cy, ay, e2);
    int n3 = from_diff(by, ay, e3), n4 = from_diff(cx, ax, e4);
    int m1 = mul<8>(e1, n1, e2, n2, p1);
    int m2 = mul<8>(e3, n3, e4, n4, p2);
    for (int i = 0; i < m2; ++i) p2[i] = -p2[i];
    int dn = add(p1, m1, p2, m2, d, s);
    return esign(d, dn);
}

static inline int incircle_sign(double ax, double ay, double bx, double by,
                                double cx, double cy, double dx, double dy) {
    double adx = ax - dx, ady = ay - dy;
    double bdx = bx - dx, bdy = by - dy;
    double cdx = cx - dx, cdy = cy - dy;
    double alift = adx * adx + ady * ady;
    double blift = bdx * bdx + bdy * bdy;
    double clift = cdx * cdx + cdy * cdy;
    double bc = bdx * cdy - bdy * cdx;
    double ca = cdx * ady - cdy * adx;
    double ab = adx * bdy - ady * bdx;
    double det = alift * bc + blift * ca + clift * ab;
    double permanent =
        alift * (std::fabs(bdx * cdy) + std::fabs(bdy * cdx))
        + blift * (std::fabs(cdx * ady) + std::fabs(cdy * adx))
        + clift * (std::fabs(adx * bdy) + std::fabs(ady * bdx));
    if (std::fabs(det) > 32.0 * EPS * permanent)
        return det > 0 ? 1 : -1;
    // exact via expansions (entries are exact 2-term differences):
    // lifts and 2x2 minors are <= 16 terms, lift*minor <= 512, total
    // <= 1536 — all on the stack
    double eadx[2], eady[2], ebdx[2], ebdy[2], ecdx[2], ecdy[2];
    int nadx = from_diff(ax, dx, eadx), nady = from_diff(ay, dy, eady);
    int nbdx = from_diff(bx, dx, ebdx), nbdy = from_diff(by, dy, ebdy);
    int ncdx = from_diff(cx, dx, ecdx), ncdy = from_diff(cy, dy, ecdy);

    double t1[8], t2[8], sc16[16];
    double ea[16], eb[16], ec[16], ebc[16], eca[16], eab[16];
    int n1, n2;

    n1 = mul<8>(eadx, nadx, eadx, nadx, t1);
    n2 = mul<8>(eady, nady, eady, nady, t2);
    int nea = add(t1, n1, t2, n2, ea, sc16);
    n1 = mul<8>(ebdx, nbdx, ebdx, nbdx, t1);
    n2 = mul<8>(ebdy, nbdy, ebdy, nbdy, t2);
    int neb = add(t1, n1, t2, n2, eb, sc16);
    n1 = mul<8>(ecdx, ncdx, ecdx, ncdx, t1);
    n2 = mul<8>(ecdy, ncdy, ecdy, ncdy, t2);
    int nec = add(t1, n1, t2, n2, ec, sc16);

    n1 = mul<8>(ebdx, nbdx, ecdy, ncdy, t1);
    n2 = mul<8>(ebdy, nbdy, ecdx, ncdx, t2);
    for (int i = 0; i < n2; ++i) t2[i] = -t2[i];
    int nbc = add(t1, n1, t2, n2, ebc, sc16);
    n1 = mul<8>(ecdx, ncdx, eady, nady, t1);
    n2 = mul<8>(ecdy, ncdy, eadx, nadx, t2);
    for (int i = 0; i < n2; ++i) t2[i] = -t2[i];
    int nca = add(t1, n1, t2, n2, eca, sc16);
    n1 = mul<8>(eadx, nadx, ebdy, nbdy, t1);
    n2 = mul<8>(eady, nady, ebdx, nbdx, t2);
    for (int i = 0; i < n2; ++i) t2[i] = -t2[i];
    int nab = add(t1, n1, t2, n2, eab, sc16);

    // lift*minor <= 512 terms each; pairwise sums <= 1024 / 1536
    static thread_local std::vector<double> big(3 * 600 + 3 * 1600);
    double* pa = big.data();
    double* pb = big.data() + 600;
    double* pc = big.data() + 1200;
    double* s1 = big.data() + 1800;
    double* s2 = big.data() + 3400;
    double* sc = big.data() + 5000;
    int na = mul<600>(ea, nea, ebc, nbc, pa);
    int nb = mul<600>(eb, neb, eca, nca, pb);
    int nc = mul<600>(ec, nec, eab, nab, pc);
    int ns = add(pa, na, pb, nb, s1, sc);
    int nd = add(s1, ns, pc, nc, s2, sc);
    return esign(s2, nd);
}

}  // namespace robust

namespace ruppert {

struct P2 { double x, y; };

static inline double orient(const P2& a, const P2& b, const P2& c) {
    return (b.x - a.x) * (c.y - a.y) - (b.y - a.y) * (c.x - a.x);
}

static inline int orient_sign(const P2& a, const P2& b, const P2& c) {
    return robust::orient2d_sign(a.x, a.y, b.x, b.y, c.x, c.y);
}

static inline bool in_circle(const P2& a, const P2& b, const P2& c,
                             const P2& d) {
    // positive when d is STRICTLY inside the circumcircle of ccw (a, b, c);
    // exact on degenerate (cocircular) inputs
    return robust::incircle_sign(a.x, a.y, b.x, b.y, c.x, c.y,
                                 d.x, d.y) > 0;
}

struct Tri {
    int64_t v[3];
    int64_t adj[3];   // neighbor opposite v[i]; -1 = none
    bool alive;
};

struct CDT {
    std::vector<P2> pts;
    std::vector<Tri> tris;
    std::set<std::pair<int64_t, int64_t>> constrained;
    int64_t last_tri = 0;
    int64_t last_t0 = -1;    // first cavity triangle of the last insert

    static std::pair<int64_t, int64_t> key(int64_t a, int64_t b) {
        return a < b ? std::make_pair(a, b) : std::make_pair(b, a);
    }

    int64_t locate(const P2& p, int64_t hint = -1) const {
        // walk from the hint (or last_tri); fall back to scan
        int64_t t = (hint >= 0 && hint < (int64_t)tris.size()
                     && tris[hint].alive) ? hint : last_tri;
        for (int steps = 0; steps < (int)tris.size() + 8; ++steps) {
            if (t < 0 || !tris[t].alive) break;
            const Tri& T = tris[t];
            int64_t next = -1;
            for (int i = 0; i < 3; ++i) {
                const P2& a = pts[T.v[(i + 1) % 3]];
                const P2& b = pts[T.v[(i + 2) % 3]];
                if (orient_sign(a, b, p) < 0) { next = T.adj[i]; break; }
            }
            if (next < 0) return t;
            t = next;
        }
        for (int64_t i = 0; i < (int64_t)tris.size(); ++i) {
            if (!tris[i].alive) continue;
            const Tri& T = tris[i];
            bool ok = true;
            for (int k = 0; k < 3; ++k)
                if (orient_sign(pts[T.v[(k + 1) % 3]],
                                pts[T.v[(k + 2) % 3]], p) < 0)
                    ok = false;
            if (ok) return i;
        }
        return -1;
    }

    // Insert p; returns new vertex id or -1 (duplicate / lost).
    int64_t insert(const P2& p, int64_t hint = -1) {
        int64_t t0 = locate(p, hint);
        last_t0 = t0;
        if (t0 < 0) return -1;
        for (int k = 0; k < 3; ++k) {
            const P2& q = pts[tris[t0].v[k]];
            double dx = q.x - p.x, dy = q.y - p.y;
            if (dx * dx + dy * dy < 1e-24) return tris[t0].v[k];
        }
        int64_t vp = (int64_t)pts.size();
        pts.push_back(p);
        // cavity = BFS of triangles whose circumcircle contains p, but never
        // crossing a constrained edge (constrained Delaunay)
        std::vector<int64_t> cav;
        std::set<int64_t> in_cav;
        std::queue<int64_t> q;
        q.push(t0);
        in_cav.insert(t0);
        while (!q.empty()) {
            int64_t t = q.front(); q.pop();
            cav.push_back(t);
            for (int i = 0; i < 3; ++i) {
                int64_t n = tris[t].adj[i];
                if (n < 0 || in_cav.count(n)) continue;
                int64_t ea = tris[t].v[(i + 1) % 3];
                int64_t eb = tris[t].v[(i + 2) % 3];
                if (constrained.count(key(ea, eb))) continue;
                const Tri& N = tris[n];
                P2 a = pts[N.v[0]], b = pts[N.v[1]], c = pts[N.v[2]];
                if (orient_sign(a, b, c) <= 0) std::swap(b, c);
                if (in_circle(a, b, c, p)) {
                    in_cav.insert(n);
                    q.push(n);
                }
            }
        }
        // boundary edges of the cavity (edge, outside neighbor)
        struct BEdge { int64_t a, b, outside; };
        std::vector<BEdge> bnd;
        for (int64_t t : cav) {
            for (int i = 0; i < 3; ++i) {
                int64_t n = tris[t].adj[i];
                if (n >= 0 && in_cav.count(n)) continue;
                bnd.push_back({tris[t].v[(i + 1) % 3],
                               tris[t].v[(i + 2) % 3], n});
            }
            tris[t].alive = false;
        }
        // fan: one new triangle per boundary edge
        std::map<int64_t, int64_t> tri_of_first;  // boundary edge a -> tri
        int64_t first_new = (int64_t)tris.size();
        for (const BEdge& e : bnd) {
            Tri nt;
            nt.v[0] = vp; nt.v[1] = e.a; nt.v[2] = e.b;
            if (orient_sign(pts[nt.v[0]], pts[nt.v[1]], pts[nt.v[2]]) < 0)
                std::swap(nt.v[1], nt.v[2]);
            nt.adj[0] = e.outside;   // opposite vp = the old outside tri
            nt.adj[1] = nt.adj[2] = -1;
            nt.alive = true;
            tris.push_back(nt);
        }
        // fix adjacency: outside tris point back; new tris link via edges
        std::map<std::pair<int64_t, int64_t>, int64_t> edge_tri;
        for (int64_t t = first_new; t < (int64_t)tris.size(); ++t) {
            Tri& T = tris[t];
            // link to outside
            int64_t out = T.adj[0];
            if (out >= 0) {
                for (int i = 0; i < 3; ++i) {
                    int64_t na = tris[out].v[(i + 1) % 3];
                    int64_t nb = tris[out].v[(i + 2) % 3];
                    if (key(na, nb) == key(T.v[1], T.v[2]))
                        tris[out].adj[i] = t;
                }
            }
            // edges (vp, a) and (vp, b)
            for (int i = 1; i < 3; ++i) {
                auto ek = key(vp, T.v[i]);
                auto it = edge_tri.find(ek);
                if (it == edge_tri.end()) edge_tri[ek] = t;
                else {
                    int64_t o = it->second;
                    // adjacency slots: opposite the vertex NOT on the edge
                    for (int s = 0; s < 3; ++s) {
                        auto sk = key(tris[t].v[(s + 1) % 3],
                                      tris[t].v[(s + 2) % 3]);
                        if (sk == ek) tris[t].adj[s] = o;
                        auto ok2 = key(tris[o].v[(s + 1) % 3],
                                       tris[o].v[(s + 2) % 3]);
                        if (ok2 == ek) tris[o].adj[s] = t;
                    }
                }
            }
        }
        last_tri = first_new;
        return vp;
    }
};

}  // namespace ruppert

extern "C" {

// Quality CDT.  Returns 0 on success.  Buffers are caller-allocated with
// capacities cap_pts / cap_tris; required sizes written to n_out_*.
int triangulate_ruppert(const double* pts_in, int64_t n_pts,
                        const int64_t* segs_in, int64_t n_segs,
                        const double* holes_in, int64_t n_holes,
                        double min_angle_deg, double max_area,
                        double* out_pts, int64_t cap_pts, int64_t* n_out_pts,
                        int64_t* out_tris, int64_t cap_tris,
                        int64_t* n_out_tris) {
    using namespace ruppert;
    CDT cdt;
    // bounding super-triangle
    double lo[2] = {1e300, 1e300}, hi[2] = {-1e300, -1e300};
    for (int64_t i = 0; i < n_pts; ++i) {
        lo[0] = std::min(lo[0], pts_in[2 * i]);
        lo[1] = std::min(lo[1], pts_in[2 * i + 1]);
        hi[0] = std::max(hi[0], pts_in[2 * i]);
        hi[1] = std::max(hi[1], pts_in[2 * i + 1]);
    }
    double cx = 0.5 * (lo[0] + hi[0]), cy = 0.5 * (lo[1] + hi[1]);
    double R = 4.0 * std::max(hi[0] - lo[0], hi[1] - lo[1]) + 1.0;
    cdt.pts.push_back({cx - 2.0 * R, cy - R});
    cdt.pts.push_back({cx + 2.0 * R, cy - R});
    cdt.pts.push_back({cx, cy + 2.0 * R});
    Tri t0; t0.v[0] = 0; t0.v[1] = 1; t0.v[2] = 2;
    t0.adj[0] = t0.adj[1] = t0.adj[2] = -1;
    t0.alive = true;
    cdt.tris.push_back(t0);

    std::vector<int64_t> vid(n_pts);
    for (int64_t i = 0; i < n_pts; ++i)
        vid[i] = cdt.insert({pts_in[2 * i], pts_in[2 * i + 1]});

    // constrained segment worklist (by current endpoint ids)
    std::vector<std::pair<int64_t, int64_t>> segs;
    std::vector<std::pair<int64_t, int64_t>> input_segs;
    for (int64_t i = 0; i < n_segs; ++i) {
        segs.push_back({vid[segs_in[2 * i]], vid[segs_in[2 * i + 1]]});
        input_segs.push_back(segs.back());
        cdt.constrained.insert(CDT::key(segs.back().first,
                                        segs.back().second));
    }

    // ---- scalable refinement driver ----------------------------------
    // All per-step costs are O(local): an edge -> live-triangle hash map
    // kept current by overwriting the entries of every new fan triangle
    // (an entry can only go stale when BOTH triangles of an edge die,
    // i.e. when the edge itself is gone); apex-based O(1) encroachment
    // (in a CDT, if any vertex encroaches a segment, one of the two
    // apexes of its edge does); a lazy priority queue of bad triangles;
    // and region flags maintained through insertions instead of
    // O(#segments) point-in-polygon parity tests per triangle.
    auto ekey = [](int64_t a, int64_t b) -> uint64_t {
        if (a > b) std::swap(a, b);
        return ((uint64_t)a << 32) | (uint64_t)(uint32_t)b;
    };
    std::unordered_map<uint64_t, int64_t> edge_map;   // edge -> a live tri
    std::unordered_map<uint64_t, size_t> seg_of_edge;
    std::vector<char> inside;            // region flag per triangle id
    char regions_active = 0;
    auto edge_tri = [&](int64_t a, int64_t b) -> int64_t {
        auto it = edge_map.find(ekey(a, b));
        if (it == edge_map.end()) return -1;
        int64_t t = it->second;
        if (t < 0 || !cdt.tris[t].alive) return -1;
        const Tri& T = cdt.tris[t];
        bool ha = false, hb = false;
        for (int i = 0; i < 3; ++i) {
            ha |= T.v[i] == a;
            hb |= T.v[i] == b;
        }
        return (ha && hb) ? t : -1;
    };
    auto diametral = [&](int64_t a, int64_t b, const P2& p) -> bool {
        const P2& A = cdt.pts[a];
        const P2& B = cdt.pts[b];
        double mx = 0.5 * (A.x + B.x), my = 0.5 * (A.y + B.y);
        double r2 = 0.25 * ((A.x - B.x) * (A.x - B.x)
                            + (A.y - B.y) * (A.y - B.y));
        double dx = p.x - mx, dy = p.y - my;
        return dx * dx + dy * dy < r2 * (1.0 - 1e-9);
    };
    auto apex_of = [&](int64_t t, int64_t a, int64_t b) -> int64_t {
        for (int i = 0; i < 3; ++i) {
            int64_t v = cdt.tris[t].v[i];
            if (v != a && v != b) return v;
        }
        return -1;
    };
    auto encroached = [&](int64_t a, int64_t b) -> bool {
        int64_t t = edge_tri(a, b);
        if (t < 0) return false;          // missing edge handled separately
        int64_t ap = apex_of(t, a, b);
        if (ap >= 3 && diametral(a, b, cdt.pts[ap])) return true;
        // opposite side: neighbor across the edge
        for (int i = 0; i < 3; ++i) {
            if (cdt.tris[t].v[i] != a && cdt.tris[t].v[i] != b) {
                int64_t n = cdt.tris[t].adj[i];
                if (n >= 0) {
                    int64_t ap2 = apex_of(n, a, b);
                    if (ap2 >= 3 && diametral(a, b, cdt.pts[ap2]))
                        return true;
                }
            }
        }
        return false;
    };

    std::deque<size_t> seg_q;
    std::vector<char> frozen;   // segments that can no longer be split
    const double min_angle = min_angle_deg * 3.14159265358979323846 / 180.0;
    const double cot2 = 1.0 / (4.0 * std::sin(min_angle)
                               * std::sin(min_angle));
    const int64_t MAX_V = 20000000;

    auto tri_score = [&](int64_t t) -> double {
        const Tri& T = cdt.tris[t];
        if (T.v[0] < 3 || T.v[1] < 3 || T.v[2] < 3) return 0.0;
        const P2& A = cdt.pts[T.v[0]];
        const P2& B = cdt.pts[T.v[1]];
        const P2& C = cdt.pts[T.v[2]];
        double area = 0.5 * std::fabs(orient(A, B, C));
        if (area < 1e-22) return 0.0;
        double l2[3] = {
            (B.x - C.x) * (B.x - C.x) + (B.y - C.y) * (B.y - C.y),
            (A.x - C.x) * (A.x - C.x) + (A.y - C.y) * (A.y - C.y),
            (A.x - B.x) * (A.x - B.x) + (A.y - B.y) * (A.y - B.y)};
        double lmin = std::min(l2[0], std::min(l2[1], l2[2]));
        double r2 = l2[0] * l2[1] * l2[2] / (16.0 * area * area);
        double q = r2 / lmin;   // (r / lmin)^2; bad when > cot2
        double score = 0;
        if (q > cot2) score = q / cot2;
        if (max_area > 0 && area > max_area)
            score = std::max(score, area / max_area);
        return score;
    };
    // (score, tri, v0, v1, v2) — verts detect stale entries
    using QEnt = std::tuple<double, int64_t, int64_t, int64_t, int64_t>;
    std::priority_queue<QEnt> bad_q;
    auto push_if_bad = [&](int64_t t) {
        if (!regions_active || !inside[t]) return;
        double s = tri_score(t);
        if (s > 1.0 + 1e-12)
            bad_q.push({s, t, cdt.tris[t].v[0], cdt.tris[t].v[1],
                        cdt.tris[t].v[2]});
    };

    // wrapped insertion: registers new fan edges, maintains region flags,
    // requeues segments whose apexes changed and new bad triangles.
    // split_edge >= 0: p is a midpoint of segment (sa, sb) — fan regions
    // assigned per side; otherwise the cavity is region-uniform.
    auto do_insert = [&](const P2& p, int64_t hint, int64_t sa, int64_t sb,
                         char r_pos, char r_neg) -> int64_t {
        int64_t t_before = (int64_t)cdt.tris.size();
        int64_t v = cdt.insert(p, hint);
        int64_t t_after = (int64_t)cdt.tris.size();
        char r_uniform = 0;
        if (regions_active && sa < 0 && cdt.last_t0 >= 0)
            r_uniform = inside[cdt.last_t0];
        inside.resize(t_after, 0);
        for (int64_t t = t_before; t < t_after; ++t) {
            const Tri& T = cdt.tris[t];
            if (!T.alive) continue;
            for (int i = 0; i < 3; ++i) {
                int64_t ea = T.v[(i + 1) % 3], eb = T.v[(i + 2) % 3];
                edge_map[ekey(ea, eb)] = t;
                if (cdt.constrained.count(CDT::key(ea, eb))) {
                    auto it = seg_of_edge.find(ekey(ea, eb));
                    if (it != seg_of_edge.end()) seg_q.push_back(it->second);
                }
            }
            if (regions_active) {
                if (sa >= 0) {
                    const P2& A = cdt.pts[sa];
                    const P2& B = cdt.pts[sb];
                    P2 cen{(cdt.pts[T.v[0]].x + cdt.pts[T.v[1]].x
                            + cdt.pts[T.v[2]].x) / 3,
                           (cdt.pts[T.v[0]].y + cdt.pts[T.v[1]].y
                            + cdt.pts[T.v[2]].y) / 3};
                    inside[t] = orient_sign(A, B, cen) > 0 ? r_pos
                                                           : r_neg;
                } else {
                    inside[t] = r_uniform;
                }
                push_if_bad(t);
            }
        }
        return v;
    };

    auto split_seg = [&](size_t si) {
        int64_t a = segs[si].first, b = segs[si].second;
        P2 m{0.5 * (cdt.pts[a].x + cdt.pts[b].x),
             0.5 * (cdt.pts[a].y + cdt.pts[b].y)};
        int64_t hint = edge_tri(a, b);
        // region of each side of the segment (before the edge vanishes)
        char r_pos = 0, r_neg = 0;
        if (regions_active && hint >= 0) {
            int64_t ap = apex_of(hint, a, b);
            char rh = inside[hint];
            char ro = rh;
            for (int i = 0; i < 3; ++i) {
                if (cdt.tris[hint].v[i] == ap) {
                    int64_t n = cdt.tris[hint].adj[i];
                    if (n >= 0) ro = inside[n];
                }
            }
            if (orient_sign(cdt.pts[a], cdt.pts[b], cdt.pts[ap]) > 0) {
                r_pos = rh; r_neg = ro;
            } else {
                r_pos = ro; r_neg = rh;
            }
        }
        // un-constrain BEFORE inserting: the cavity search must be able to
        // cross the edge its midpoint lands on
        cdt.constrained.erase(CDT::key(a, b));
        int64_t vm = do_insert(m, hint, regions_active ? a : -1, b,
                               r_pos, r_neg);
        if (vm < 0 || vm == a || vm == b) {
            cdt.constrained.insert(CDT::key(a, b));
            // midpoint coincides with an existing vertex or location
            // failed: the segment is at the resolution floor — freeze it
            // (re-splitting forever would blow up the triangulation).
            frozen[si] = 1;
            return;
        }
        seg_of_edge.erase(ekey(a, b));
        segs[si] = {a, vm};
        segs.push_back({vm, b});
        frozen.push_back(0);
        cdt.constrained.insert(CDT::key(a, vm));
        cdt.constrained.insert(CDT::key(vm, b));
        seg_of_edge[ekey(a, vm)] = si;
        seg_of_edge[ekey(vm, b)] = segs.size() - 1;
        seg_q.push_back(si);
        seg_q.push_back(segs.size() - 1);
    };

    // initial registration
    for (int64_t t = 0; t < (int64_t)cdt.tris.size(); ++t) {
        if (!cdt.tris[t].alive) continue;
        for (int i = 0; i < 3; ++i)
            edge_map[ekey(cdt.tris[t].v[(i + 1) % 3],
                          cdt.tris[t].v[(i + 2) % 3])] = t;
    }
    for (size_t si = 0; si < segs.size(); ++si)
        seg_of_edge[ekey(segs[si].first, segs[si].second)] = si;
    frozen.assign(segs.size(), 0);
    inside.assign(cdt.tris.size(), 0);

    // phase 1: conforming, non-encroached segments (region flags off)
    auto drain_segments = [&]() {
        int64_t guard = 0;
        while (!seg_q.empty()) {
            if ((int64_t)cdt.pts.size() > MAX_V) break;
            if (++guard > (int64_t)(40 * segs.size()) + 4000000) break;
            size_t si = seg_q.front();
            seg_q.pop_front();
            if (frozen[si]) continue;
            int64_t a = segs[si].first, b = segs[si].second;
            if (edge_tri(a, b) < 0 || encroached(a, b)) split_seg(si);
        }
    };
    for (size_t si = 0; si < segs.size(); ++si) seg_q.push_back(si);
    drain_segments();

    // phase 2: region classification by flood fill from the super
    // triangle and the hole seeds, crossing only unconstrained edges
    {
        inside.assign(cdt.tris.size(), 1);
        std::deque<int64_t> bfs;
        for (int64_t t = 0; t < (int64_t)cdt.tris.size(); ++t) {
            if (!cdt.tris[t].alive) continue;
            if (cdt.tris[t].v[0] < 3 || cdt.tris[t].v[1] < 3
                || cdt.tris[t].v[2] < 3) {
                if (inside[t]) { inside[t] = 0; bfs.push_back(t); }
            }
        }
        for (int64_t h = 0; h < n_holes; ++h) {
            int64_t t = cdt.locate({holes_in[2 * h], holes_in[2 * h + 1]});
            if (t >= 0 && inside[t]) { inside[t] = 0; bfs.push_back(t); }
        }
        while (!bfs.empty()) {
            int64_t t = bfs.front();
            bfs.pop_front();
            for (int i = 0; i < 3; ++i) {
                int64_t n = cdt.tris[t].adj[i];
                if (n < 0 || !inside[n]) continue;
                int64_t ea = cdt.tris[t].v[(i + 1) % 3];
                int64_t eb = cdt.tris[t].v[(i + 2) % 3];
                if (cdt.constrained.count(CDT::key(ea, eb))) continue;
                inside[n] = 0;
                bfs.push_back(n);
            }
        }
        for (int64_t t = 0; t < (int64_t)cdt.tris.size(); ++t)
            if (!cdt.tris[t].alive) inside[t] = 0;
        regions_active = 1;
    }

    // probe the WOULD-BE cavity of p read-only; collect encroached
    // constrained boundary edges (Shewchuk-style rejection test)
    std::vector<std::pair<int64_t, int64_t>> enc_edges;
    auto probe_encroached = [&](const P2& p, int64_t hint) -> bool {
        enc_edges.clear();
        int64_t t0 = cdt.locate(p, hint);
        if (t0 < 0) return false;
        std::set<int64_t> in_cav;
        std::deque<int64_t> q2;
        q2.push_back(t0);
        in_cav.insert(t0);
        while (!q2.empty()) {
            int64_t t = q2.front();
            q2.pop_front();
            for (int i = 0; i < 3; ++i) {
                int64_t n = cdt.tris[t].adj[i];
                if (n >= 0 && in_cav.count(n)) continue;
                int64_t ea = cdt.tris[t].v[(i + 1) % 3];
                int64_t eb = cdt.tris[t].v[(i + 2) % 3];
                if (cdt.constrained.count(CDT::key(ea, eb))) {
                    if (diametral(ea, eb, p))
                        enc_edges.push_back({ea, eb});
                    continue;
                }
                if (n < 0) continue;
                const Tri& N = cdt.tris[n];
                P2 a = cdt.pts[N.v[0]], b = cdt.pts[N.v[1]],
                   c = cdt.pts[N.v[2]];
                if (orient_sign(a, b, c) <= 0) std::swap(b, c);
                if (in_circle(a, b, c, p)) {
                    in_cav.insert(n);
                    q2.push_back(n);
                }
            }
        }
        return !enc_edges.empty();
    };

    // phase 3: quality refinement off the lazy priority queue
    for (int64_t t = 0; t < (int64_t)cdt.tris.size(); ++t)
        if (cdt.tris[t].alive) push_if_bad(t);
    int64_t guard = 0;
    while (!bad_q.empty() || !seg_q.empty()) {
        if ((int64_t)cdt.pts.size() > MAX_V) break;
        if (++guard > 40000000) break;
        if (!seg_q.empty()) { drain_segments(); continue; }
        auto [score, t, v0, v1, v2] = bad_q.top();
        bad_q.pop();
        const Tri& T = cdt.tris[t];
        if (!T.alive || T.v[0] != v0 || T.v[1] != v1 || T.v[2] != v2)
            continue;                      // stale
        if (!inside[t]) continue;
        const P2& A = cdt.pts[v0];
        const P2& B = cdt.pts[v1];
        const P2& C = cdt.pts[v2];
        double d = 2.0 * (A.x * (B.y - C.y) + B.x * (C.y - A.y)
                          + C.x * (A.y - B.y));
        if (d == 0.0) continue;
        P2 cc{((A.x * A.x + A.y * A.y) * (B.y - C.y)
               + (B.x * B.x + B.y * B.y) * (C.y - A.y)
               + (C.x * C.x + C.y * C.y) * (A.y - B.y)) / d,
              ((A.x * A.x + A.y * A.y) * (C.x - B.x)
               + (B.x * B.x + B.y * B.y) * (A.x - C.x)
               + (C.x * C.x + C.y * C.y) * (B.x - A.x)) / d};
        // if cc encroaches constrained segments, split those instead
        if (probe_encroached(cc, t)) {
            bool any = false;
            for (auto& e : enc_edges) {
                auto it = seg_of_edge.find(ekey(e.first, e.second));
                if (it == seg_of_edge.end() || frozen[it->second]) continue;
                split_seg(it->second);
                any = true;
            }
            if (any) {
                // the triangle may still be bad; requeue for a re-check
                if (cdt.tris[t].alive) push_if_bad(t);
                continue;
            }
            continue;  // all encroached segments frozen: skip this tri
        }
        do_insert(cc, t, -1, -1, 0, 0);
    }

    // classify + compact output: keep triangles whose centroid is inside
    // the PSLG and outside every hole polygon region (holes are seed
    // points: a triangle is dropped when its centroid is connected... we
    // use parity against input segments, which already excludes holes
    // bounded by segments; explicit hole seeds flip regions containing them)
    // output selection: the flood-fill region flags maintained through
    // refinement (exterior = reachable from the super triangle or a hole
    // seed without crossing a constrained edge)
    std::vector<int64_t> vmap(cdt.pts.size(), -1);
    std::vector<std::array<int64_t, 3>> out;
    for (int64_t t = 0; t < (int64_t)cdt.tris.size(); ++t) {
        const Tri& T = cdt.tris[t];
        if (!T.alive || !inside[t]) continue;
        if (T.v[0] < 3 || T.v[1] < 3 || T.v[2] < 3) continue;
        const P2& A = cdt.pts[T.v[0]];
        const P2& B = cdt.pts[T.v[1]];
        const P2& C = cdt.pts[T.v[2]];
        std::array<int64_t, 3> tv;
        for (int i = 0; i < 3; ++i) tv[i] = T.v[i];
        if (orient_sign(A, B, C) < 0) std::swap(tv[1], tv[2]);
        out.push_back(tv);
    }
    // compact vertices
    int64_t nv = 0;
    for (auto& t : out)
        for (int i = 0; i < 3; ++i)
            if (vmap[t[i]] < 0) vmap[t[i]] = nv++;
    *n_out_pts = nv;
    *n_out_tris = (int64_t)out.size();
    if (nv > cap_pts || (int64_t)out.size() > cap_tris) return 1;
    for (int64_t v = 0; v < (int64_t)cdt.pts.size(); ++v) {
        if (vmap[v] >= 0) {
            out_pts[2 * vmap[v]] = cdt.pts[v].x;
            out_pts[2 * vmap[v] + 1] = cdt.pts[v].y;
        }
    }
    for (size_t t = 0; t < out.size(); ++t)
        for (int i = 0; i < 3; ++i)
            out_tris[3 * t + i] = vmap[out[t][i]];
    return 0;
}

}  // extern "C" (ruppert)

