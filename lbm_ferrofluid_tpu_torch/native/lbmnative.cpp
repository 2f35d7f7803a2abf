// Native host-side kernels for lbm_ferrofluid_tpu_torch: the port's own copy
// of the JAX package's native/lbmnative.cpp.
//
// The reference delegates its host-bound mesh extraction to PyMCubes (C++);
// this library plays that role for the framework:
//   * marching tetrahedra isosurface extraction (same 6-tet decomposition
//     and case logic as render/mesh.py, bit-identical vertex ordering),
//   * fast Tecplot ASCII dumps (utils/io.py's python loops are O(N^3) string
//     formatting — orders of magnitude slower than this).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 dependency).
// Built at first use by lbm_ferrofluid_tpu_torch/native/__init__.py (g++).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

// cube corners as (di, dj, dk), index = di*4 + dj*2 + dk
const int CORNERS[8][3] = {{0, 0, 0}, {0, 0, 1}, {0, 1, 0}, {0, 1, 1},
                           {1, 0, 0}, {1, 0, 1}, {1, 1, 0}, {1, 1, 1}};

// 6 tetrahedra sharing the main diagonal corner0 -> corner7
const int TETS[6][4] = {{0, 1, 3, 7}, {0, 3, 2, 7}, {0, 2, 6, 7},
                        {0, 6, 4, 7}, {0, 4, 5, 7}, {0, 5, 1, 7}};

struct CaseTri {
  int n_tris;
  int edges[2][3][2];  // up to 2 triangles, each 3 edges of (corner, corner)
};

// triangle emission per 4-bit inside pattern, matching render/mesh.py
CaseTri case_table(int c) {
  int inside[4], outside[4], ni = 0, no = 0;
  for (int i = 0; i < 4; i++) {
    if (c >> i & 1)
      inside[ni++] = i;
    else
      outside[no++] = i;
  }
  CaseTri out{};
  if (ni == 1) {
    int a = inside[0];
    out.n_tris = 1;
    int tri[3][2] = {{a, outside[0]}, {a, outside[1]}, {a, outside[2]}};
    memcpy(out.edges[0], tri, sizeof(tri));
  } else if (ni == 3) {
    int a = outside[0];
    out.n_tris = 1;
    int tri[3][2] = {{a, inside[0]}, {a, inside[2]}, {a, inside[1]}};
    memcpy(out.edges[0], tri, sizeof(tri));
  } else if (ni == 2) {
    int a = inside[0], b = inside[1], cc = outside[0], d = outside[1];
    out.n_tris = 2;
    int t0[3][2] = {{a, cc}, {a, d}, {b, d}};
    int t1[3][2] = {{a, cc}, {b, d}, {b, cc}};
    memcpy(out.edges[0], t0, sizeof(t0));
    memcpy(out.edges[1], t1, sizeof(t1));
  }
  return out;
}

}  // namespace

extern "C" {

// Marching tetrahedra over volume [D, H, W] (C order).  Returns counts via
// out params; caller then calls mtetra_fill with buffers of that size.
// Two-phase API keeps the C side allocation-free from Python's perspective.
struct MTState {
  std::vector<float> verts;
  std::vector<int64_t> faces;
};

void* mtetra_run(const float* vol, int64_t D, int64_t H, int64_t W,
                 float level, int64_t* n_verts, int64_t* n_faces) {
  auto* st = new MTState();
  std::unordered_map<uint64_t, int64_t> edge_to_vid;
  edge_to_vid.reserve(1 << 16);

  CaseTri table[16];
  for (int c = 0; c < 16; c++) table[c] = case_table(c);

  auto node_val = [&](int64_t i, int64_t j, int64_t k) {
    return vol[(i * H + j) * W + k];
  };
  auto node_id = [&](int64_t i, int64_t j, int64_t k) {
    return (i * H + j) * W + k;
  };

  auto vertex_on_edge = [&](int64_t na, int64_t nb) -> int64_t {
    uint64_t lo = (uint64_t)(na < nb ? na : nb);
    uint64_t hi = (uint64_t)(na < nb ? nb : na);
    uint64_t key = lo * (uint64_t)(D * H * W) + hi;
    auto it = edge_to_vid.find(key);
    if (it != edge_to_vid.end()) return it->second;
    // interpolate on the canonical (lo, hi) edge, as the numpy version
    double va = vol[lo], vb = vol[hi];
    double t = (vb == va) ? 0.0 : (level - va) / (vb - va);
    if (t < 0) t = 0;
    if (t > 1) t = 1;
    double pa[3] = {(double)(lo / (W * H)), (double)((lo / W) % H),
                    (double)(lo % W)};
    double pb[3] = {(double)(hi / (W * H)), (double)((hi / W) % H),
                    (double)(hi % W)};
    int64_t vid = (int64_t)st->verts.size() / 3;
    for (int d = 0; d < 3; d++)
      st->verts.push_back((float)(pa[d] + t * (pb[d] - pa[d])));
    edge_to_vid.emplace(key, vid);
    return vid;
  };

  for (int64_t i = 0; i + 1 < D; i++)
    for (int64_t j = 0; j + 1 < H; j++)
      for (int64_t k = 0; k + 1 < W; k++) {
        float vals[8];
        int64_t ids[8];
        float lo = 1e30f, hi = -1e30f;
        for (int c = 0; c < 8; c++) {
          vals[c] = node_val(i + CORNERS[c][0], j + CORNERS[c][1],
                             k + CORNERS[c][2]);
          ids[c] = node_id(i + CORNERS[c][0], j + CORNERS[c][1],
                           k + CORNERS[c][2]);
          if (vals[c] < lo) lo = vals[c];
          if (vals[c] > hi) hi = vals[c];
        }
        if (!(lo < level && hi >= level)) continue;
        for (int t = 0; t < 6; t++) {
          int cse = 0;
          for (int v = 0; v < 4; v++)
            if (vals[TETS[t][v]] < level) cse |= 1 << v;
          const CaseTri& ct = table[cse];
          for (int tri = 0; tri < ct.n_tris; tri++) {
            int64_t vids[3];
            for (int e = 0; e < 3; e++) {
              int ca = TETS[t][ct.edges[tri][e][0]];
              int cb = TETS[t][ct.edges[tri][e][1]];
              vids[e] = vertex_on_edge(ids[ca], ids[cb]);
            }
            if (vids[0] == vids[1] || vids[1] == vids[2] ||
                vids[0] == vids[2])
              continue;  // degenerate
            st->faces.push_back(vids[0]);
            st->faces.push_back(vids[1]);
            st->faces.push_back(vids[2]);
          }
        }
      }

  *n_verts = (int64_t)st->verts.size() / 3;
  *n_faces = (int64_t)st->faces.size() / 3;
  return st;
}

void mtetra_fill(void* handle, float* verts_out, int64_t* faces_out) {
  auto* st = (MTState*)handle;
  memcpy(verts_out, st->verts.data(), st->verts.size() * sizeof(float));
  memcpy(faces_out, st->faces.data(), st->faces.size() * sizeof(int64_t));
  delete st;
}

// Fast Tecplot POINT-format writers (drop-in for utils/io.py:107-152).
int dump_2d_plt(const char* filename, const float* density, const float* u,
                const float* v, int64_t H, int64_t W) {
  FILE* fo = fopen(filename, "w");
  if (!fo) return -1;
  fputs("TITLE =\"Magnetic internal force\"\n", fo);
  fputs("VARIABLES = \"X\" \"Y\" \"RHO\" \"U\" \"V\" \n", fo);
  fprintf(fo, "ZONE I=%lld, J=%lld\n", (long long)W, (long long)H);
  fputs("F=POINT\n", fo);
  for (int64_t j = 0; j < H; j++)
    for (int64_t i = 0; i < W; i++)
      fprintf(fo, "%lld %lld %g %g %g\n", (long long)i, (long long)j,
              density[j * W + i], u[j * W + i], v[j * W + i]);
  fclose(fo);
  return 0;
}

int dump_3d_plt(const char* filename, const float* density, const float* u,
                const float* v, const float* w, int64_t D, int64_t H,
                int64_t W) {
  FILE* fo = fopen(filename, "w");
  if (!fo) return -1;
  fputs("TITLE =\"Magnetic internal force\"\n", fo);
  fputs("VARIABLES = \"X\" \"Y\" \"Z\" \"RHO\" \"U\" \"V\" \"W\" \n", fo);
  fprintf(fo, "ZONE I=%lld, J=%lld, K=%lld\n", (long long)W, (long long)H,
          (long long)D);
  fputs("F=POINT\n", fo);
  for (int64_t k = 0; k < D; k++)
    for (int64_t j = 0; j < H; j++)
      for (int64_t i = 0; i < W; i++) {
        int64_t idx = (k * H + j) * W + i;
        fprintf(fo, "%lld %lld %lld %g %g %g %g\n", (long long)i, (long long)j,
                (long long)k, density[idx], u[idx], v[idx], w[idx]);
      }
  fclose(fo);
  return 0;
}

}  // extern "C"
