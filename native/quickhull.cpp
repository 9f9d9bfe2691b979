// Native 3-D QuickHull: convex-hull preprocessing for gjkepa.
//
// Role: the reference imports a convex-hull builder (GCLIB_QuickHull) and a
// face-soup deduplicator (GCLIB_DeHull) from its private library
// (/root/reference/src/GCLIB_GJKEPA.f90:13-15); neither ships with the repo
// (SURVEY.md §2.3).  In this engine the *query* hot path never rebuilds
// hulls (incremental EPA), so hull construction is a host-side
// preprocessing capability: point cloud -> extreme vertices + triangle
// faces, used to build padded vertex buffers and fixtures.  This is the
// framework's native (C++) component; gjkepa.utils.hull wraps it via
// ctypes with a scipy fallback.
//
// Algorithm: classic QuickHull with face outside-sets; visibility by full
// scan (hull preprocessing is far off the hot path); horizon = undirected
// edges with exactly one visible adjacent face; robust eps scaled to the
// input extent.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <array>
#include <algorithm>
#include <unordered_map>

namespace {

struct V3 {
    double x, y, z;
    V3 operator-(const V3& o) const { return {x - o.x, y - o.y, z - o.z}; }
    V3 operator+(const V3& o) const { return {x + o.x, y + o.y, z + o.z}; }
    V3 operator*(double s) const { return {x * s, y * s, z * s}; }
};
static inline double dot(const V3& a, const V3& b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
static inline V3 cross(const V3& a, const V3& b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
static inline double norm(const V3& a) { return std::sqrt(dot(a, a)); }

struct Face {
    int v[3];
    V3 n;        // outward unit-ish normal
    double d;    // plane offset: dot(n, x) = d
    bool alive = true;
    std::vector<int> outside;
};

struct Hull {
    const V3* pts;
    int n;
    double eps;
    std::vector<Face> faces;

    void make_face(int a, int b, int c, const V3& interior) {
        Face f;
        f.v[0] = a; f.v[1] = b; f.v[2] = c;
        f.n = cross(pts[b] - pts[a], pts[c] - pts[a]);
        double ln = norm(f.n);
        if (ln > 0) f.n = f.n * (1.0 / ln);
        f.d = dot(f.n, pts[a]);
        if (dot(f.n, interior) > f.d) {  // flip outward
            std::swap(f.v[1], f.v[2]);
            f.n = f.n * -1.0;
            f.d = -f.d;
        }
        faces.push_back(std::move(f));
    }

    bool build() {
        // --- initial extreme tetrahedron -----------------------------------
        int i0 = 0, i1 = 0;
        for (int i = 1; i < n; ++i) {
            if (pts[i].x < pts[i0].x) i0 = i;
            if (pts[i].x > pts[i1].x) i1 = i;
        }
        if (i0 == i1) return false;
        // farthest from the line (i0, i1)
        V3 d01 = pts[i1] - pts[i0];
        int i2 = -1; double best = eps;
        for (int i = 0; i < n; ++i) {
            V3 w = pts[i] - pts[i0];
            double dist = norm(cross(d01, w)) / std::max(norm(d01), 1e-300);
            if (dist > best) { best = dist; i2 = i; }
        }
        if (i2 < 0) return false;
        // farthest from the plane (i0, i1, i2)
        V3 nrm = cross(pts[i1] - pts[i0], pts[i2] - pts[i0]);
        double ln = norm(nrm);
        if (ln <= 0) return false;
        nrm = nrm * (1.0 / ln);
        int i3 = -1; best = eps;
        for (int i = 0; i < n; ++i) {
            double dist = std::fabs(dot(nrm, pts[i] - pts[i0]));
            if (dist > best) { best = dist; i3 = i; }
        }
        if (i3 < 0) return false;  // coplanar input

        V3 interior = (pts[i0] + pts[i1] + pts[i2] + pts[i3]) * 0.25;
        make_face(i0, i1, i2, interior);
        make_face(i0, i1, i3, interior);
        make_face(i0, i2, i3, interior);
        make_face(i1, i2, i3, interior);

        // --- assign outside sets -------------------------------------------
        for (int i = 0; i < n; ++i) {
            if (i == i0 || i == i1 || i == i2 || i == i3) continue;
            for (auto& f : faces) {
                if (dot(f.n, pts[i]) > f.d + eps) { f.outside.push_back(i); break; }
            }
        }

        // --- expansion loop --------------------------------------------------
        for (;;) {
            int fi = -1;
            for (int k = 0; k < (int)faces.size(); ++k)
                if (faces[k].alive && !faces[k].outside.empty()) { fi = k; break; }
            if (fi < 0) break;

            // farthest outside point of this face
            Face& f = faces[fi];
            int p = f.outside[0]; double bd = -1e300;
            for (int idx : f.outside) {
                double dd = dot(f.n, pts[idx]) - f.d;
                if (dd > bd) { bd = dd; p = idx; }
            }

            // visible faces
            std::vector<int> visible;
            for (int k = 0; k < (int)faces.size(); ++k) {
                if (!faces[k].alive) continue;
                if (dot(faces[k].n, pts[p]) > faces[k].d + eps) visible.push_back(k);
            }
            if (visible.empty()) { f.outside.clear(); continue; }

            // horizon: undirected edges with exactly one visible face
            std::unordered_map<int64_t, int> edge_count;
            auto key = [this](int a, int b) {
                return (int64_t)std::min(a, b) * (int64_t)n + std::max(a, b);
            };
            for (int k : visible)
                for (int e = 0; e < 3; ++e)
                    edge_count[key(faces[k].v[e], faces[k].v[(e + 1) % 3])]++;

            // collect orphaned outside points, kill visible faces
            std::vector<int> orphans;
            for (int k : visible) {
                for (int idx : faces[k].outside)
                    if (idx != p) orphans.push_back(idx);
                faces[k].alive = false;
                faces[k].outside.clear();
            }

            // interior reference for orientation: centroid of alive verts + p
            V3 interior{0, 0, 0}; int cnt = 0;
            for (auto& g : faces) if (g.alive) {
                for (int e = 0; e < 3; ++e) { interior = interior + pts[g.v[e]]; ++cnt; }
            }
            interior = (cnt > 0) ? interior * (1.0 / cnt) : pts[p];

            // stitch new faces over the horizon
            size_t first_new = faces.size();
            for (int k : visible) {
                // visible faces are dead but we kept their vertex triples
                for (int e = 0; e < 3; ++e) {
                    int a = faces[k].v[e], b = faces[k].v[(e + 1) % 3];
                    if (edge_count[key(a, b)] == 1) make_face(a, b, p, interior);
                }
            }

            // reassign orphans to new faces
            std::sort(orphans.begin(), orphans.end());
            orphans.erase(std::unique(orphans.begin(), orphans.end()), orphans.end());
            for (int idx : orphans) {
                for (size_t k = first_new; k < faces.size(); ++k) {
                    if (!faces[k].alive) continue;
                    if (dot(faces[k].n, pts[idx]) > faces[k].d + eps) {
                        faces[k].outside.push_back(idx);
                        break;
                    }
                }
            }
        }
        return true;
    }
};

}  // namespace

extern "C" {

// Convex hull of n points (xyz doubles).  Writes up to max_faces triangle
// faces (vertex indices into the input) and up to max_verts unique hull
// vertex indices.  Returns 0 on success, 1 on degenerate input, 2 on
// capacity overflow.
int qh_convex_hull(const double* pts_xyz, int n,
                   int32_t* out_faces, int max_faces, int32_t* n_faces,
                   int32_t* out_verts, int max_verts, int32_t* n_verts) {
    *n_faces = 0;
    *n_verts = 0;
    if (n < 4) return 1;
    const V3* pts = reinterpret_cast<const V3*>(pts_xyz);

    double extent = 0;
    for (int i = 0; i < n; ++i)
        extent = std::max({extent, std::fabs(pts[i].x), std::fabs(pts[i].y),
                           std::fabs(pts[i].z)});
    Hull h{pts, n, std::max(1e-12, 1e-10 * extent), {}};
    if (!h.build()) return 1;

    std::vector<char> used(n, 0);
    int nf = 0;
    for (auto& f : h.faces) {
        if (!f.alive) continue;
        if (nf >= max_faces) return 2;
        for (int e = 0; e < 3; ++e) {
            out_faces[nf * 3 + e] = f.v[e];
            used[f.v[e]] = 1;
        }
        ++nf;
    }
    *n_faces = nf;
    int nv = 0;
    for (int i = 0; i < n; ++i) {
        if (!used[i]) continue;
        if (nv >= max_verts) return 2;
        out_verts[nv++] = i;
    }
    *n_verts = nv;
    return 0;
}

// Batch form: B clouds of n points each (contiguous).  Outputs are padded
// per cloud; per-cloud face/vert counts land in n_faces/n_verts arrays.
// Returns the number of clouds that failed (degenerate/overflow).
int qh_convex_hull_batch(const double* pts_xyz, int b, int n,
                         int32_t* out_faces, int max_faces, int32_t* n_faces,
                         int32_t* out_verts, int max_verts, int32_t* n_verts) {
    int failures = 0;
    for (int i = 0; i < b; ++i) {
        int rc = qh_convex_hull(pts_xyz + (size_t)i * n * 3, n,
                                out_faces + (size_t)i * max_faces * 3, max_faces,
                                n_faces + i,
                                out_verts + (size_t)i * max_verts, max_verts,
                                n_verts + i);
        if (rc != 0) ++failures;
    }
    return failures;
}

}  // extern "C"
