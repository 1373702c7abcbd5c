// Native SAH kd-tree builder with ropes (C ABI, loaded via ctypes).
//
// A copy of clpathtracer_tpu/accel/native/sah_native.cpp, kept in the port
// so that the port builds and loads its own library (accel/native/
// __init__.py) and never touches the JAX package. The code is unchanged:
// both packages build the same trees from the same triangles.
//
// Re-implements the same algorithm as clpathtracer_tpu/accel/sah.py (which
// itself re-designs the reference's scalar C builder, src/kd_tree.c:94-200):
//   * 25 uniform candidate planes per axis, area-augmented SAH cost
//     (cost = NL*SL + NR*SR with triangle areas added to the child box
//     surface terms — the reference's nonstandard variant, kd_tree.c:138-145)
//   * straddling triangles duplicated into both children (kd_tree.c:166-183)
//   * leaves at <= leaf_size tris / depth exhaustion / degenerate split
//   * post-pass rope construction (kd_tree.c:43-83)
//   * leaf triangle lists padded to tri_block=4 ("quad rows")
//
// Output is the device layout directly: the [M, 24] packed node table of
// ops/traverse_fast.py plus the padded tri_indices array. The JAX
// package's Python builder remains as the readable reference; this one
// exists because a Python recursion over ~10^5..10^6 nodes is
// interpreter-bound.
//
// All SAH arithmetic is double precision in the same evaluation order as
// the numpy builder so both produce the same trees in practice.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <array>
#include <cmath>
#include <vector>

namespace {

constexpr int NBINS = 25;
constexpr double EPS = 1e-9;
constexpr int QBLOCK = 4;

struct BuildCtx {
  // per-triangle precompute
  std::vector<double> vmin;  // [F*3]
  std::vector<double> vmax;  // [F*3]
  std::vector<double> area;  // [F]
  int leaf_size = 4;
  int tri_block = QBLOCK;

  // output SoA (plain columns; packed at the end)
  std::vector<float> node_min, node_max, split_value;
  std::vector<uint8_t> is_leaf;
  std::vector<int32_t> split_axis, child_lo, child_hi, leaf_start,
      leaf_count;
  std::vector<int32_t> tri_indices;
  std::vector<std::array<int32_t, 6>> ropes;
};

int add_leaf(BuildCtx& b, const std::vector<int64_t>& ids, const double lo[3],
             const double hi[3]) {
  int idx = static_cast<int>(b.is_leaf.size());
  for (int a = 0; a < 3; ++a) {
    b.node_min.push_back(static_cast<float>(lo[a]));
    b.node_max.push_back(static_cast<float>(hi[a]));
  }
  b.is_leaf.push_back(1);
  b.split_axis.push_back(0);
  b.split_value.push_back(0.0f);
  b.child_lo.push_back(-1);
  b.child_hi.push_back(-1);
  b.leaf_start.push_back(static_cast<int32_t>(b.tri_indices.size()));
  b.leaf_count.push_back(static_cast<int32_t>(ids.size()));
  for (int64_t t : ids) b.tri_indices.push_back(static_cast<int32_t>(t));
  // pad to tri_block with -1 sentinels (quad rows)
  int pad = (b.tri_block - static_cast<int>(ids.size()) % b.tri_block)
            % b.tri_block;
  for (int k = 0; k < pad; ++k) b.tri_indices.push_back(-1);
  return idx;
}

int add_split(BuildCtx& b, const double lo[3], const double hi[3],
              double value, int axis) {
  int idx = static_cast<int>(b.is_leaf.size());
  for (int a = 0; a < 3; ++a) {
    b.node_min.push_back(static_cast<float>(lo[a]));
    b.node_max.push_back(static_cast<float>(hi[a]));
  }
  b.is_leaf.push_back(0);
  b.split_axis.push_back(axis);
  b.split_value.push_back(static_cast<float>(value));
  b.child_lo.push_back(-1);
  b.child_hi.push_back(-1);
  b.leaf_start.push_back(0);
  b.leaf_count.push_back(0);
  return idx;
}

// Best SAH plane over 3 axes x NBINS uniform planes; returns axis or -1.
int best_plane(const BuildCtx& b, const std::vector<int64_t>& ids,
               const double lo[3], const double hi[3], double* out_value) {
  double best_cost = 0.0;
  int best_axis = -1;
  double best_val = 0.0;
  const size_t n = ids.size();
  for (int axis = 0; axis < 3; ++axis) {
    const double e = hi[axis] - lo[axis];
    if (e < EPS) continue;
    const int a1 = (axis + 1) % 3, a2 = (axis + 2) % 3;
    const double base = (hi[a1] - lo[a1]) * (hi[a2] - lo[a2]);
    const double perim = (hi[a1] - lo[a1]) + (hi[a2] - lo[a2]);

    // bin triangles: for a plane at fraction d_k = (k+1)/(B+1),
    // is_left(i,k)  = vmin_i <= v_k  (true for k >= kmin_i)
    // is_right(i,k) = vmax_i >= v_k  (true for k <= kmax_i)
    // accumulate counts/areas per k via difference arrays.
    double nl_d[NBINS + 1] = {0}, nr_d[NBINS + 1] = {0};
    double sl_d[NBINS + 1] = {0}, sr_d[NBINS + 1] = {0};
    double planes[NBINS];
    for (int k = 0; k < NBINS; ++k)
      planes[k] = lo[axis] + (static_cast<double>(k) + 1.0) / (NBINS + 1.0) * e;
    for (size_t i = 0; i < n; ++i) {
      const int64_t t = ids[i];
      const double tvmin = b.vmin[t * 3 + axis];
      const double tvmax = b.vmax[t * 3 + axis];
      const double sa = b.area[t];
      // first k with planes[k] >= tvmin  (exact float compare via scan is
      // O(B); use branchless lower_bound on the monotone plane array)
      int kmin = static_cast<int>(
          std::lower_bound(planes, planes + NBINS, tvmin) - planes);
      // last k with planes[k] <= tvmax → count = upper_bound
      int kcnt = static_cast<int>(
          std::upper_bound(planes, planes + NBINS, tvmax) - planes);
      if (kmin < NBINS) { nl_d[kmin] += 1.0; sl_d[kmin] += sa; }
      if (kcnt > 0) {
        nr_d[0] += 1.0; sr_d[0] += sa;
        nr_d[kcnt] -= 1.0; sr_d[kcnt] -= sa;
      }
    }
    double nl = 0, sl = 0, nr = 0, sr = 0;
    // prefix sums: nl/sl accumulate forward; nr/sr start at total and
    // subtract
    double cost_k;
    for (int k = 0; k < NBINS; ++k) {
      nl += nl_d[k]; sl += sl_d[k];
      nr += nr_d[k]; sr += sr_d[k];
      const double d = (static_cast<double>(k) + 1.0) / (NBINS + 1.0);
      const double sl_box = 2.0 * (base + e * d * perim);
      const double sr_box = 2.0 * (base + e * (1.0 - d) * perim);
      cost_k = nl * (sl_box + sl) + nr * (sr_box + sr);
      if (best_axis < 0 || cost_k < best_cost) {
        best_cost = cost_k;
        best_axis = axis;
        best_val = planes[k];
      }
    }
  }
  if (best_axis < 0) return -1;
  // degenerate-split guard (reference src/kd_tree.c:158)
  if (best_val <= lo[best_axis] || hi[best_axis] <= best_val) return -1;
  // leaf-cost termination (NOT in the reference, which splits to depth
  // exhaustion and so duplicates straddlers ~5x on big scenes): stop when
  // the best split is no cheaper than keeping the node a leaf, in the
  // same area-augmented cost family: C_leaf = N * (S_box + sum areas).
  {
    const double ex = hi[0] - lo[0], ey = hi[1] - lo[1], ez = hi[2] - lo[2];
    double s_box = 2.0 * (ex * ey + ey * ez + ez * ex);
    double s_tris = 0.0;
    for (int64_t t : ids) s_tris += b.area[t];
    const double leaf_cost = static_cast<double>(n) * (s_box + s_tris);
    if (best_cost >= leaf_cost) return -1;
  }
  *out_value = best_val;
  return best_axis;
}

int build_recursive(BuildCtx& b, std::vector<int64_t>& ids, double lo[3],
                    double hi[3], int depth) {
  if (static_cast<int>(ids.size()) <= b.leaf_size || depth == 0)
    return add_leaf(b, ids, lo, hi);
  double value;
  int axis = best_plane(b, ids, lo, hi, &value);
  if (axis < 0) return add_leaf(b, ids, lo, hi);

  std::vector<int64_t> l_ids, r_ids;
  l_ids.reserve(ids.size());
  r_ids.reserve(ids.size());
  for (int64_t t : ids) {
    if (b.vmin[t * 3 + axis] <= value + EPS) l_ids.push_back(t);
    if (b.vmax[t * 3 + axis] >= value - EPS) r_ids.push_back(t);
  }
  if (l_ids.size() == ids.size() && r_ids.size() == ids.size())
    return add_leaf(b, ids, lo, hi);  // split separates nothing

  int idx = add_split(b, lo, hi, value, axis);
  { std::vector<int64_t>().swap(ids); }  // release before recursing

  double l_hi[3] = {hi[0], hi[1], hi[2]};
  l_hi[axis] = value;
  double r_lo[3] = {lo[0], lo[1], lo[2]};
  r_lo[axis] = value;
  int l_index = build_recursive(b, l_ids, lo, l_hi, depth - 1);
  { std::vector<int64_t>().swap(l_ids); }
  int r_index = build_recursive(b, r_ids, r_lo, hi, depth - 1);
  b.child_lo[idx] = l_index;
  b.child_hi[idx] = r_index;
  return idx;
}

int32_t optimize_rope(const BuildCtx& b, int32_t rope, const float* nlo,
                      const float* nhi, int face) {
  // push a rope down its subtree while it provably can't straddle the
  // face (reference optimize_rope, src/kd_tree.c:43-62)
  while (rope != -1 && !b.is_leaf[rope]) {
    const int ax = b.split_axis[rope];
    if (face / 2 == ax) break;
    const float value = b.split_value[rope];
    if (value >= nhi[ax]) rope = b.child_lo[rope];
    else if (value <= nlo[ax]) rope = b.child_hi[rope];
    else break;
  }
  return rope;
}

void add_ropes(BuildCtx& b) {
  const size_t m = b.is_leaf.size();
  b.ropes.assign(m, {-1, -1, -1, -1, -1, -1});
  struct Item { int32_t index; std::array<int32_t, 6> ropes; };
  std::vector<Item> stack;
  stack.push_back({0, {-1, -1, -1, -1, -1, -1}});
  while (!stack.empty()) {
    Item it = stack.back();
    stack.pop_back();
    if (b.is_leaf[it.index]) {
      b.ropes[it.index] = it.ropes;
      continue;
    }
    std::array<int32_t, 6> opt;
    for (int f = 0; f < 6; ++f)
      opt[f] = optimize_rope(b, it.ropes[f], &b.node_min[it.index * 3],
                             &b.node_max[it.index * 3], f);
    const int ax = b.split_axis[it.index];
    std::array<int32_t, 6> r0 = opt, r1 = opt;
    r0[2 * ax + 1] = b.child_hi[it.index];  // left child's +axis face
    r1[2 * ax] = b.child_lo[it.index];      // right child's -axis face
    stack.push_back({b.child_hi[it.index], r1});
    stack.push_back({b.child_lo[it.index], r0});
  }
}

}  // namespace

extern "C" {

struct KdHandle {
  BuildCtx b;
};

// Build from [F, 3, 3] f32 corner positions. Returns an opaque handle.
void* kd_build(const float* tri_verts, int64_t n_tris, int32_t max_depth,
               int32_t leaf_size, int32_t tri_block) {
  auto* h = new KdHandle();
  BuildCtx& b = h->b;
  b.leaf_size = leaf_size < 1 ? 1 : leaf_size;
  b.tri_block = tri_block < 1 ? 1 : tri_block;
  b.vmin.resize(n_tris * 3);
  b.vmax.resize(n_tris * 3);
  b.area.resize(n_tris);
  double lo[3] = {1e300, 1e300, 1e300};
  double hi[3] = {-1e300, -1e300, -1e300};
  for (int64_t i = 0; i < n_tris; ++i) {
    const float* t = tri_verts + i * 9;
    double e1[3], e2[3];
    for (int a = 0; a < 3; ++a) {
      const double v0 = t[a], v1 = t[3 + a], v2 = t[6 + a];
      b.vmin[i * 3 + a] = std::min(v0, std::min(v1, v2));
      b.vmax[i * 3 + a] = std::max(v0, std::max(v1, v2));
      lo[a] = std::min(lo[a], b.vmin[i * 3 + a]);
      hi[a] = std::max(hi[a], b.vmax[i * 3 + a]);
      e1[a] = v1 - v0;
      e2[a] = v2 - v0;
    }
    const double cx = e1[1] * e2[2] - e1[2] * e2[1];
    const double cy = e1[2] * e2[0] - e1[0] * e2[2];
    const double cz = e1[0] * e2[1] - e1[1] * e2[0];
    b.area[i] = 0.5 * std::sqrt(cx * cx + cy * cy + cz * cz);
  }
  std::vector<int64_t> ids(n_tris);
  for (int64_t i = 0; i < n_tris; ++i) ids[i] = i;
  build_recursive(b, ids, lo, hi, max_depth);
  add_ropes(b);
  return h;
}

int64_t kd_num_nodes(void* hp) {
  return static_cast<int64_t>(static_cast<KdHandle*>(hp)->b.is_leaf.size());
}

int64_t kd_num_tri_indices(void* hp) {
  return static_cast<int64_t>(
      static_cast<KdHandle*>(hp)->b.tri_indices.size());
}

// Copy out the [M, 24] packed node table (ops/traverse_fast.py layout) and
// the padded tri_indices.
void kd_export(void* hp, float* node_table24, int32_t* tri_indices) {
  const BuildCtx& b = static_cast<KdHandle*>(hp)->b;
  const size_t m = b.is_leaf.size();
  for (size_t i = 0; i < m; ++i) {
    float* row = node_table24 + i * 24;
    std::memset(row, 0, 24 * sizeof(float));
    for (int a = 0; a < 3; ++a) {
      row[a] = b.node_min[i * 3 + a];
      row[3 + a] = b.node_max[i * 3 + a];
    }
    row[6] = b.split_value[i];
    row[7] = static_cast<float>(b.split_axis[i] + 4 * (b.is_leaf[i] ? 1 : 0));
    row[8] = static_cast<float>(b.child_lo[i]);
    row[9] = static_cast<float>(b.child_hi[i]);
    row[10] = static_cast<float>(b.leaf_start[i] / QBLOCK);
    row[11] = static_cast<float>(b.leaf_count[i]);
    for (int f = 0; f < 6; ++f)
      row[12 + f] = static_cast<float>(b.ropes[i][f]);
  }
  std::memcpy(tri_indices, b.tri_indices.data(),
              b.tri_indices.size() * sizeof(int32_t));
}

void kd_free(void* hp) { delete static_cast<KdHandle*>(hp); }

}  // extern "C"
