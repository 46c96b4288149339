/*
 * Native host kernels for mve_tpu_torch — the CPU-bound graph/topology
 * work that stays on the host next to the device compute path (the role
 * the reference's C++ libs play for its OpenMP pipeline). A copy of
 * mve_tpu's native/mve_native.cpp, built by mve_tpu_torch/native:
 *
 *  - mesh vertex classification (reference: libs/mve/mesh_info.cc)
 *  - union-find connected components over faces
 *  - edge-collapse batches for needle/cap cleanup
 *    (reference: libs/fssr/mesh_clean.cc)
 *  - boundary-ring confidence expansion
 *    (reference: libs/mve/depthmap.cc:495-545)
 *
 * Exposed as a plain C ABI consumed via ctypes (no pybind11 in the
 * image). All buffers are caller-allocated numpy arrays.
 */

#include <cstdint>
#include <cstring>
#include <vector>
#include <unordered_map>
#include <algorithm>
#include <cmath>

extern "C" {

/* Vertex classes (mesh_info.h). */
enum { VCLASS_SIMPLE = 0, VCLASS_COMPLEX = 1, VCLASS_BORDER = 2, VCLASS_UNREF = 3 };

/*
 * Classify every vertex from the face list. faces: (n_faces, 3) int32.
 * out_class: (n_verts,) int8.
 */
void mesh_classify_vertices(int64_t n_verts, int64_t n_faces,
                            const int32_t* faces, int8_t* out_class)
{
    /* CSR vertex->face adjacency. */
    std::vector<int64_t> count(n_verts + 1, 0);
    for (int64_t i = 0; i < n_faces * 3; ++i)
        count[faces[i] + 1] += 1;
    for (int64_t v = 0; v < n_verts; ++v)
        count[v + 1] += count[v];
    std::vector<int64_t> adj(n_faces * 3);
    {
        std::vector<int64_t> cursor(count.begin(), count.end() - 1);
        for (int64_t f = 0; f < n_faces; ++f)
            for (int j = 0; j < 3; ++j)
                adj[cursor[faces[f * 3 + j]]++] = f;
    }

    std::vector<std::pair<int32_t, int32_t>> edges;
    std::unordered_map<int32_t, int32_t> starts;
    for (int64_t v = 0; v < n_verts; ++v)
    {
        int64_t lo = count[v], hi = count[v + 1];
        if (lo == hi) { out_class[v] = VCLASS_UNREF; continue; }

        /* Opposite edge (a, b) per incident face. */
        edges.clear();
        for (int64_t k = lo; k < hi; ++k)
        {
            const int32_t* f = faces + adj[k] * 3;
            int i = (f[0] == (int32_t)v) ? 0 : (f[1] == (int32_t)v ? 1 : 2);
            edges.emplace_back(f[(i + 1) % 3], f[(i + 2) % 3]);
        }
        starts.clear();
        bool dup = false;
        for (auto& e : edges)
            if (!starts.emplace(e.first, e.second).second) { dup = true; break; }
        if (dup) { out_class[v] = VCLASS_COMPLEX; continue; }

        /* Find chain starts: 'a' values that are not any 'b'. */
        int n_chain_starts = 0;
        int32_t chain_start = -1;
        for (auto& e : edges)
        {
            bool incoming = false;
            for (auto& e2 : edges)
                if (e2.second == e.first) { incoming = true; break; }
            if (!incoming) { n_chain_starts += 1; chain_start = e.first; }
        }
        if (n_chain_starts == 0)
        {
            /* Closed fan(s): simple iff one cycle covers all edges. */
            int32_t a0 = edges[0].first;
            int64_t seen = 1;
            int32_t cur = starts[a0];
            while (cur != a0 && seen <= (int64_t)edges.size())
            {
                auto it = starts.find(cur);
                if (it == starts.end()) break;
                cur = it->second;
                seen += 1;
            }
            out_class[v] = (seen == (int64_t)edges.size() && cur == a0)
                ? VCLASS_SIMPLE : VCLASS_COMPLEX;
        }
        else if (n_chain_starts == 1)
        {
            int64_t seen = 0;
            int32_t cur = chain_start;
            auto it = starts.find(cur);
            while (it != starts.end() && seen <= (int64_t)edges.size())
            {
                cur = it->second;
                seen += 1;
                it = starts.find(cur);
            }
            out_class[v] = (seen == (int64_t)edges.size())
                ? VCLASS_BORDER : VCLASS_COMPLEX;
        }
        else
            out_class[v] = VCLASS_COMPLEX;
    }
}

/* Union-find with path halving. */
static int64_t uf_find(std::vector<int64_t>& p, int64_t x)
{
    while (p[x] != x) { p[x] = p[p[x]]; x = p[x]; }
    return x;
}

/*
 * Connected components over face edges. out_label: (n_verts,) int64,
 * root vertex id per component.
 */
void mesh_components(int64_t n_verts, int64_t n_faces,
                     const int32_t* faces, int64_t* out_label)
{
    std::vector<int64_t> parent(n_verts);
    for (int64_t i = 0; i < n_verts; ++i) parent[i] = i;
    for (int64_t f = 0; f < n_faces; ++f)
    {
        int64_t a = uf_find(parent, faces[f * 3 + 0]);
        int64_t b = uf_find(parent, faces[f * 3 + 1]);
        int64_t c = uf_find(parent, faces[f * 3 + 2]);
        parent[b] = a;
        parent[uf_find(parent, c)] = uf_find(parent, a);
    }
    for (int64_t i = 0; i < n_verts; ++i)
        out_label[i] = uf_find(parent, i);
}

/*
 * Apply a batch of edge collapses (b -> a). verts: (n_verts, 3) float32
 * updated in place with midpoints. out_target: (n_verts,) int64 final
 * remap. Returns number of collapses applied. Collapses touching an
 * already-collapsed vertex this batch are skipped (mesh_clean.cc
 * semantics of one pass).
 */
int64_t mesh_collapse_edges(int64_t n_verts, int64_t n_edges,
                            const int64_t* edges, float* verts,
                            int64_t* out_target)
{
    std::vector<int64_t> parent(n_verts);
    for (int64_t i = 0; i < n_verts; ++i) parent[i] = i;
    std::vector<uint8_t> touched(n_verts, 0);
    int64_t count = 0;
    for (int64_t e = 0; e < n_edges; ++e)
    {
        int64_t a = uf_find(parent, edges[e * 2 + 0]);
        int64_t b = uf_find(parent, edges[e * 2 + 1]);
        if (a == b || touched[a] || touched[b])
            continue;
        parent[b] = a;
        for (int j = 0; j < 3; ++j)
            verts[a * 3 + j] = 0.5f * (verts[a * 3 + j] + verts[b * 3 + j]);
        touched[a] = 1;
        count += 1;
    }
    for (int64_t i = 0; i < n_verts; ++i)
        out_target[i] = uf_find(parent, i);
    return count;
}

/*
 * Boundary confidence rings (depthmap.cc:495-545): starting from border
 * vertices (vclass == BORDER), assign conf = ring/iterations expanding
 * over vertex adjacency. confs must be pre-filled with 1.0.
 */
void mesh_boundary_confidences(int64_t n_verts, int64_t n_faces,
                               const int32_t* faces, const int8_t* vclass,
                               int32_t iterations, float* confs)
{
    /* Vertex adjacency CSR from faces. */
    std::vector<int64_t> count(n_verts + 1, 0);
    for (int64_t f = 0; f < n_faces; ++f)
        for (int j = 0; j < 3; ++j)
            count[faces[f * 3 + j] + 1] += 2;
    for (int64_t v = 0; v < n_verts; ++v)
        count[v + 1] += count[v];
    std::vector<int32_t> adj(count[n_verts]);
    {
        std::vector<int64_t> cursor(count.begin(), count.end() - 1);
        for (int64_t f = 0; f < n_faces; ++f)
        {
            const int32_t* t = faces + f * 3;
            for (int j = 0; j < 3; ++j)
            {
                adj[cursor[t[j]]++] = t[(j + 1) % 3];
                adj[cursor[t[j]]++] = t[(j + 2) % 3];
            }
        }
    }

    std::vector<int64_t> ring, next;
    for (int64_t v = 0; v < n_verts; ++v)
        if (vclass[v] == VCLASS_BORDER)
            ring.push_back(v);

    for (int32_t it = 0; it < iterations; ++it)
    {
        float conf = (float)it / (float)iterations;
        for (int64_t v : ring)
            confs[v] = conf;
        next.clear();
        for (int64_t v : ring)
            for (int64_t k = count[v]; k < count[v + 1]; ++k)
            {
                int32_t w = adj[k];
                if (confs[w] == 1.0f)
                {
                    confs[w] = -2.0f; /* mark */
                    next.push_back(w);
                }
            }
        for (int64_t v : next)
            confs[v] = 1.0f;
        std::swap(ring, next);
    }
}

/*
 * FSSR influence pairing (reference: octree.cc influence_query): emit all
 * (voxel, sample) pairs with |voxel - sample| < 3 * sample_scale.
 * Samples are bucketed by scale octave; each bucket builds a hash grid
 * with cell size equal to the bucket's max influence radius so 27
 * neighbor cells cover every candidate.
 *
 * Two-pass API for caller-allocated outputs:
 *   pass out=nullptr -> returns required pair count;
 *   pass buffers     -> fills them, returns count written.
 */
static int64_t fssr_pairs_impl(
    int64_t n_voxels, const double* vox,        /* (V, 3) */
    int64_t n_samples, const double* pos,       /* (N, 3) */
    const double* scale,                        /* (N,) */
    int64_t* out_v, int64_t* out_s, int64_t max_out)
{
    /* Bucket samples by scale octave. */
    std::vector<int> level(n_samples);
    int lmin = 1 << 30, lmax = -(1 << 30);
    for (int64_t i = 0; i < n_samples; ++i)
    {
        int l = (int)std::floor(std::log2(std::max(scale[i], 1e-30)));
        level[i] = l;
        lmin = std::min(lmin, l);
        lmax = std::max(lmax, l);
    }

    int64_t count = 0;
    std::vector<int64_t> bucket;
    for (int l = lmin; l <= lmax; ++l)
    {
        bucket.clear();
        double max_r = 0.0;
        for (int64_t i = 0; i < n_samples; ++i)
            if (level[i] == l)
            {
                bucket.push_back(i);
                max_r = std::max(max_r, 3.0 * scale[i]);
            }
        if (bucket.empty())
            continue;
        double cell = max_r;

        /* Hash grid of bucket samples. */
        std::unordered_map<int64_t, std::vector<int64_t>> grid;
        grid.reserve(bucket.size() * 2);
        auto key_of = [cell](double x, double y, double z) -> int64_t {
            int64_t ix = (int64_t)std::floor(x / cell);
            int64_t iy = (int64_t)std::floor(y / cell);
            int64_t iz = (int64_t)std::floor(z / cell);
            /* 21 bits per axis with offset. */
            return ((ix + 1048576) << 42) | ((iy + 1048576) << 21)
                 | (iz + 1048576);
        };
        for (int64_t i : bucket)
            grid[key_of(pos[i * 3], pos[i * 3 + 1], pos[i * 3 + 2])].push_back(i);

        for (int64_t v = 0; v < n_voxels; ++v)
        {
            double vx = vox[v * 3], vy = vox[v * 3 + 1], vz = vox[v * 3 + 2];
            int64_t cx = (int64_t)std::floor(vx / cell);
            int64_t cy = (int64_t)std::floor(vy / cell);
            int64_t cz = (int64_t)std::floor(vz / cell);
            for (int dz = -1; dz <= 1; ++dz)
                for (int dy = -1; dy <= 1; ++dy)
                    for (int dx = -1; dx <= 1; ++dx)
                    {
                        int64_t key = (((cx + dx) + 1048576) << 42)
                                    | (((cy + dy) + 1048576) << 21)
                                    | ((cz + dz) + 1048576);
                        auto it = grid.find(key);
                        if (it == grid.end())
                            continue;
                        for (int64_t s : it->second)
                        {
                            double ddx = vx - pos[s * 3];
                            double ddy = vy - pos[s * 3 + 1];
                            double ddz = vz - pos[s * 3 + 2];
                            double r = 3.0 * scale[s];
                            if (ddx * ddx + ddy * ddy + ddz * ddz < r * r)
                            {
                                if (out_v != nullptr)
                                {
                                    if (count >= max_out)
                                        return -1;
                                    out_v[count] = v;
                                    out_s[count] = s;
                                }
                                count += 1;
                            }
                        }
                    }
        }
    }
    return count;
}

extern "C" int64_t fssr_influence_pairs(
    int64_t n_voxels, const double* vox,
    int64_t n_samples, const double* pos, const double* scale,
    int64_t* out_v, int64_t* out_s, int64_t max_out)
{
    return fssr_pairs_impl(n_voxels, vox, n_samples, pos, scale,
                           out_v, out_s, max_out);
}

/*
 * Per-voxel scale filter (iso_octree.cc:104-112): for each voxel's
 * influence set, drop pairs whose sample scale exceeds 2x the
 * 10th-percentile scale. Pairs are given grouped arbitrarily; returns
 * the kept count with pairs compacted in place.
 */
extern "C" int64_t fssr_scale_filter(
    int64_t n_pairs, int64_t* pair_v, int64_t* pair_s,
    const double* scale, int64_t n_voxels)
{
    /* Group pair indices by voxel via counting sort. */
    std::vector<int64_t> cnt(n_voxels + 1, 0);
    for (int64_t i = 0; i < n_pairs; ++i)
        cnt[pair_v[i] + 1] += 1;
    for (int64_t v = 0; v < n_voxels; ++v)
        cnt[v + 1] += cnt[v];
    std::vector<int64_t> order(n_pairs);
    {
        std::vector<int64_t> cursor(cnt.begin(), cnt.end() - 1);
        for (int64_t i = 0; i < n_pairs; ++i)
            order[cursor[pair_v[i]]++] = i;
    }

    std::vector<double> scales;
    std::vector<int64_t> keep;
    keep.reserve(n_pairs);
    for (int64_t v = 0; v < n_voxels; ++v)
    {
        int64_t lo = cnt[v], hi = cnt[v + 1];
        if (lo == hi)
            continue;
        scales.clear();
        for (int64_t k = lo; k < hi; ++k)
            scales.push_back(scale[pair_s[order[k]]]);
        int64_t nth = (hi - lo) / 10;
        std::nth_element(scales.begin(), scales.begin() + nth, scales.end());
        double thresh = scales[nth] * 2.0;
        for (int64_t k = lo; k < hi; ++k)
            if (scale[pair_s[order[k]]] <= thresh)
                keep.push_back(order[k]);
    }
    /* Compact in place (keep holds original indices in voxel order). */
    std::vector<int64_t> nv(keep.size()), ns(keep.size());
    for (size_t i = 0; i < keep.size(); ++i)
    {
        nv[i] = pair_v[keep[i]];
        ns[i] = pair_s[keep[i]];
    }
    std::memcpy(pair_v, nv.data(), nv.size() * sizeof(int64_t));
    std::memcpy(pair_s, ns.data(), ns.size() * sizeof(int64_t));
    return (int64_t)keep.size();
}

}  /* extern "C" */
