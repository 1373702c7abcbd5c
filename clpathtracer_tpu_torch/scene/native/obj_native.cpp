// Fast Wavefront OBJ scanner (plain C ABI, loaded via ctypes): the port's
// copy of clpathtracer_tpu/scene/native/obj_native.cpp.
//
// The native analogue of the reference's vendored tinyobj_loader_c
// (include/tinyobj_loader_c.h:1208 — the reference parses OBJ in C too);
// covers exactly the subset clpathtracer_tpu_torch/scene/objparser.py::
// parse_obj handles: v / vn / vt records, f faces in the v, v/vt, v//vn,
// v/vt/vn forms with fan triangulation and negative (relative) indices,
// usemtl (per-triangle material ids) and mtllib (names exported for the
// Python side to resolve: file IO and Kd/Ke assignment stay in Python).
//
// Built with g++ -O3 -fPIC -shared -std=c++17 at first use into
// clpathtracer_tpu_torch/_build/<hash>/ by scene/native/__init__.py, as
// accel/native builds the kd-tree builder.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Obj {
  std::vector<float> v, vn, vt;
  std::vector<int32_t> faces;    // F*9 ints: 3 corners x (v, vn, vt)
  std::vector<int32_t> tri_mat;  // F ints: material id or -1
  std::vector<std::string> mats;     // unique material names, first-use order
  std::vector<std::string> mtllibs;  // mtllib file names, in order
  std::string err;
};

inline const char* skip_ws(const char* p, const char* e) {
  while (p < e && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

inline const char* find_eol(const char* p, const char* e) {
  while (p < e && *p != '\n') ++p;
  return p;
}

inline bool token_end(char c) {
  return c == ' ' || c == '\t' || c == '\r' || c == '\n';
}

// parse up to `want` floats from the line; returns how many parsed
int parse_floats(const char* p, const char* lend, float* out, int want) {
  int n = 0;
  while (n < want) {
    p = skip_ws(p, lend);
    if (p >= lend) break;
    char* endp = nullptr;
    float f = strtof(p, &endp);
    if (endp == p) break;
    out[n++] = f;
    p = endp;
  }
  return n;
}

int64_t resolve(long idx, size_t count, Obj* o) {
  if (idx > 0) return idx - 1;
  if (idx < 0) return static_cast<int64_t>(count) + idx;
  o->err = "OBJ index 0 is invalid";
  return -2;
}

}  // namespace

extern "C" {

void* obj_parse(const char* text, int64_t len) {
  Obj* o = new Obj();
  const char* p = text;
  const char* e = text + len;
  int cur_mat = -1;

  while (p < e) {
    const char* lend = find_eol(p, e);
    const char* q = skip_ws(p, lend);
    if (q >= lend || *q == '#') { p = lend + 1; continue; }

    if (*q == 'v' && q + 1 < lend && token_end(q[1])) {
      float f[3];
      if (parse_floats(q + 1, lend, f, 3) < 3) {
        o->err = "short vertex record";
        return o;
      }
      o->v.insert(o->v.end(), f, f + 3);
    } else if (*q == 'v' && q + 1 < lend && q[1] == 'n'
               && q + 2 < lend && token_end(q[2])) {
      float f[3];
      if (parse_floats(q + 2, lend, f, 3) < 3) {
        o->err = "short normal record";
        return o;
      }
      o->vn.insert(o->vn.end(), f, f + 3);
    } else if (*q == 'v' && q + 1 < lend && q[1] == 't'
               && q + 2 < lend && token_end(q[2])) {
      float f[2];
      if (parse_floats(q + 2, lend, f, 2) < 2) {
        o->err = "short texcoord record";
        return o;
      }
      o->vt.insert(o->vt.end(), f, f + 2);
    } else if (*q == 'f' && q + 1 < lend && token_end(q[1])) {
      // corners: v[/vt][/vn]
      int32_t corner[64][3];  // (v, vn, vt) — OBJ polygons cap at 64 here
      int nc = 0;
      const char* c = q + 1;
      while (true) {
        c = skip_ws(c, lend);
        if (c >= lend) break;
        char* endp = nullptr;
        long vi = strtol(c, &endp, 10);
        if (endp == c) { o->err = "malformed face corner"; return o; }
        int64_t v = resolve(vi, o->v.size() / 3, o);
        if (v == -2) return o;
        int64_t vt = -1, vn = -1;
        c = endp;
        if (c < lend && *c == '/') {
          ++c;
          if (c < lend && *c != '/') {
            long ti = strtol(c, &endp, 10);
            if (endp == c) { o->err = "malformed face corner"; return o; }
            vt = resolve(ti, o->vt.size() / 2, o);
            if (vt == -2) return o;
            c = endp;
          }
          if (c < lend && *c == '/') {
            ++c;
            long ni = strtol(c, &endp, 10);
            if (endp == c) { o->err = "malformed face corner"; return o; }
            vn = resolve(ni, o->vn.size() / 3, o);
            if (vn == -2) return o;
            c = endp;
          }
        }
        if (nc >= 64) { o->err = "face with >64 corners"; return o; }
        corner[nc][0] = static_cast<int32_t>(v);
        corner[nc][1] = static_cast<int32_t>(vn);
        corner[nc][2] = static_cast<int32_t>(vt);
        ++nc;
      }
      if (nc < 3) { o->err = "face with <3 corners"; return o; }
      for (int k = 1; k < nc - 1; ++k) {  // fan triangulation
        o->faces.insert(o->faces.end(), corner[0], corner[0] + 3);
        o->faces.insert(o->faces.end(), corner[k], corner[k] + 3);
        o->faces.insert(o->faces.end(), corner[k + 1], corner[k + 1] + 3);
        o->tri_mat.push_back(cur_mat);
      }
    } else if (lend - q >= 7 && memcmp(q, "usemtl", 6) == 0
               && token_end(q[6])) {
      const char* n0 = skip_ws(q + 6, lend);
      const char* n1 = n0;
      while (n1 < lend && !token_end(*n1)) ++n1;
      if (n1 > n0) {
        std::string name(n0, n1 - n0);
        cur_mat = -1;
        for (size_t i = 0; i < o->mats.size(); ++i)
          if (o->mats[i] == name) { cur_mat = static_cast<int>(i); break; }
        if (cur_mat < 0) {
          cur_mat = static_cast<int>(o->mats.size());
          o->mats.push_back(name);
        }
      } else {
        cur_mat = -1;
      }
    } else if (lend - q >= 7 && memcmp(q, "mtllib", 6) == 0
               && token_end(q[6])) {
      const char* c = q + 6;
      while (true) {  // mtllib may list several files
        c = skip_ws(c, lend);
        if (c >= lend) break;
        const char* n1 = c;
        while (n1 < lend && !token_end(*n1)) ++n1;
        o->mtllibs.emplace_back(c, n1 - c);
        c = n1;
      }
    }
    // o / g / s / l / p — ignored, like the Python parser
    p = lend + 1;
  }
  return o;
}

const char* obj_error(void* h) {
  return static_cast<Obj*>(h)->err.c_str();
}

void obj_counts(void* h, int64_t* out) {
  Obj* o = static_cast<Obj*>(h);
  size_t mat_len = 0;
  for (auto& m : o->mats) mat_len += m.size() + 1;
  size_t lib_len = 0;
  for (auto& m : o->mtllibs) lib_len += m.size() + 1;
  out[0] = static_cast<int64_t>(o->v.size() / 3);
  out[1] = static_cast<int64_t>(o->vn.size() / 3);
  out[2] = static_cast<int64_t>(o->vt.size() / 2);
  out[3] = static_cast<int64_t>(o->tri_mat.size());
  out[4] = static_cast<int64_t>(mat_len);
  out[5] = static_cast<int64_t>(lib_len);
}

void obj_export(void* h, float* v, float* vn, float* vt, int32_t* faces,
                int32_t* tri_mat, char* matnames, char* mtllibs) {
  Obj* o = static_cast<Obj*>(h);
  memcpy(v, o->v.data(), o->v.size() * sizeof(float));
  memcpy(vn, o->vn.data(), o->vn.size() * sizeof(float));
  memcpy(vt, o->vt.data(), o->vt.size() * sizeof(float));
  memcpy(faces, o->faces.data(), o->faces.size() * sizeof(int32_t));
  memcpy(tri_mat, o->tri_mat.data(), o->tri_mat.size() * sizeof(int32_t));
  char* m = matnames;
  for (auto& s : o->mats) {
    memcpy(m, s.data(), s.size());
    m += s.size();
    *m++ = '\n';
  }
  char* l = mtllibs;
  for (auto& s : o->mtllibs) {
    memcpy(l, s.data(), s.size());
    l += s.size();
    *l++ = '\n';
  }
}

void obj_free(void* h) { delete static_cast<Obj*>(h); }

}  // extern "C"
