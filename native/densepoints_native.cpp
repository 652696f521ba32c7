// densepoints native runtime: host-side hot paths that are integer /
// IO bound rather than array math — the pieces that belong in C++ rather
// than XLA. Compiled to a shared library, bound via ctypes (no pybind11).
//
// Contents:
//   dp_union_matches : union-find over (view, keypoint) nodes from pairwise
//                      match tables (the track-assembly hot path; the
//                      reference's equivalent is the O(kp x pairs) scan in
//                      Matcher::TriangulateMatches, matcher.cpp:374-473).
//   dp_compress_roots: path-compressed root extraction for all nodes.
//   dp_write_ply     : binary little-endian PLY writer for multi-million
//                      point clouds (position + normal + color).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {

// Find with full path compression (iterative).
static int64_t dp_find(int64_t *parent, int64_t i) {
  int64_t root = i;
  while (parent[root] != root) root = parent[root];
  while (parent[i] != root) {
    int64_t next = parent[i];
    parent[i] = root;
    i = next;
  }
  return root;
}

// Build the union-find parent array for num_views * n_kp nodes.
// pairs: (n_pairs, 2) int32 view indices; matches: (n_pairs, n_kp) int32
// keypoint index in the second view or -1. parent: out, length V*N.
void dp_union_matches(int32_t num_views, int32_t n_kp, int32_t n_pairs,
                      const int32_t *pairs, const int32_t *matches,
                      int64_t *parent) {
  const int64_t n_nodes = (int64_t)num_views * n_kp;
  for (int64_t i = 0; i < n_nodes; ++i) parent[i] = i;
  for (int32_t p = 0; p < n_pairs; ++p) {
    const int64_t va = pairs[2 * p];
    const int64_t vb = pairs[2 * p + 1];
    const int32_t *row = matches + (int64_t)p * n_kp;
    for (int32_t i = 0; i < n_kp; ++i) {
      const int32_t j = row[i];
      if (j < 0) continue;
      int64_t ra = dp_find(parent, va * n_kp + i);
      int64_t rb = dp_find(parent, vb * n_kp + j);
      if (ra != rb) {
        if (rb < ra) { int64_t t = ra; ra = rb; rb = t; }
        parent[rb] = ra;  // deterministic: smaller root wins
      }
    }
  }
}

// Resolve every node to its root (with compression), writing roots[i].
void dp_compress_roots(int64_t n_nodes, int64_t *parent, int64_t *roots) {
  for (int64_t i = 0; i < n_nodes; ++i) roots[i] = dp_find(parent, i);
}

// Binary little-endian PLY with x,y,z[,nx,ny,nz][,r,g,b].
// Returns 0 on success.
int dp_write_ply(const char *path, int64_t n, const float *pos,
                 const float *normals, const uint8_t *colors) {
  FILE *f = fopen(path, "wb");
  if (!f) return 1;
  char header[512];
  int len = snprintf(header, sizeof(header),
                     "ply\nformat binary_little_endian 1.0\n"
                     "comment densepoints native\n"
                     "element vertex %lld\n"
                     "property float x\nproperty float y\nproperty float z\n",
                     (long long)n);
  fwrite(header, 1, len, f);
  if (normals) {
    const char *s =
        "property float nx\nproperty float ny\nproperty float nz\n";
    fwrite(s, 1, strlen(s), f);
  }
  if (colors) {
    const char *s =
        "property uchar red\nproperty uchar green\nproperty uchar blue\n";
    fwrite(s, 1, strlen(s), f);
  }
  const char *end = "end_header\n";
  fwrite(end, 1, strlen(end), f);

  // Row-interleave through a buffer for write throughput.
  const size_t row = 12 + (normals ? 12 : 0) + (colors ? 3 : 0);
  std::vector<uint8_t> buf(row * 65536);
  int64_t i = 0;
  while (i < n) {
    int64_t chunk = n - i < 65536 ? n - i : 65536;
    uint8_t *out = buf.data();
    for (int64_t k = 0; k < chunk; ++k) {
      memcpy(out, pos + 3 * (i + k), 12);
      out += 12;
      if (normals) { memcpy(out, normals + 3 * (i + k), 12); out += 12; }
      if (colors) { memcpy(out, colors + 3 * (i + k), 3); out += 3; }
    }
    fwrite(buf.data(), 1, row * chunk, f);
    i += chunk;
  }
  fclose(f);
  return 0;
}

}  // extern "C"
