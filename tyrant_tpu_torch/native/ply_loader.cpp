// Native PLY mesh loader (ascii + binary_little_endian), fan-triangulating.
//
// C++ fast path for tyrant_tpu_torch/scene/ply.py (same semantics:
// vertex positions + triangulated faces).  Returns malloc'd buffers
// released with tyrant_free.  A copy of the JAX package's loader, built
// with g++ into build/tyrant_tpu_torch/ at first use (native/__init__.py).

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Prop {
  std::string name;
  int size = 0;        // bytes of scalar type
  bool is_float = false;
  bool is_list = false;
  int count_size = 0;  // list count type size
};

struct Elem {
  std::string name;
  long count = 0;
  std::vector<Prop> props;
};

int type_size(const std::string& t, bool* is_float) {
  *is_float = (t == "float" || t == "float32" || t == "double" ||
               t == "float64");
  if (t == "char" || t == "int8" || t == "uchar" || t == "uint8") return 1;
  if (t == "short" || t == "int16" || t == "ushort" || t == "uint16") return 2;
  if (t == "int" || t == "int32" || t == "uint" || t == "uint32" ||
      t == "float" || t == "float32")
    return 4;
  if (t == "double" || t == "float64") return 8;
  return 0;
}

double read_scalar(const uint8_t* p, int size, bool is_float) {
  if (is_float) {
    if (size == 4) {
      float f;
      std::memcpy(&f, p, 4);
      return f;
    }
    double d;
    std::memcpy(&d, p, 8);
    return d;
  }
  // integer types in PLY faces are non-negative in practice; handle signed
  switch (size) {
    case 1: return *p;
    case 2: {
      uint16_t v;
      std::memcpy(&v, p, 2);
      return v;
    }
    case 4: {
      int32_t v;
      std::memcpy(&v, p, 4);
      return v;
    }
  }
  return 0;
}

// strip {comment} and trailing whitespace
void strip_line(std::string& s) {
  size_t b = s.find('{');
  if (b != std::string::npos) s.erase(b);
  while (!s.empty() && std::isspace(static_cast<unsigned char>(s.back())))
    s.pop_back();
}

}  // namespace

extern "C" {

void tyrant_free(void* p) { std::free(p); }

// Returns 0 on success.  *verts: n_verts*3 floats; *faces: n_faces*3 int32.
int tyrant_ply_load(const char* path, float** verts_out, int* n_verts_out,
                    int32_t** faces_out, int* n_faces_out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long fsize = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<char> data(fsize);
  if (std::fread(data.data(), 1, fsize, f) != static_cast<size_t>(fsize)) {
    std::fclose(f);
    return -2;
  }
  std::fclose(f);

  // --- header ---
  const char* end_tag = "end_header";
  char* hdr_end = nullptr;
  for (long i = 0; i + 10 < fsize; ++i) {
    if (std::memcmp(data.data() + i, end_tag, 10) == 0) {
      hdr_end = data.data() + i;
      break;
    }
  }
  if (!hdr_end) return -3;
  char* body = static_cast<char*>(std::memchr(hdr_end, '\n', 64));
  if (!body) return -3;
  body += 1;

  std::string header(data.data(), hdr_end);
  bool binary = false, ascii = false;
  std::vector<Elem> elems;
  {
    size_t pos = 0;
    while (pos < header.size()) {
      size_t nl = header.find('\n', pos);
      if (nl == std::string::npos) nl = header.size();
      std::string line = header.substr(pos, nl - pos);
      pos = nl + 1;
      strip_line(line);
      if (line.empty()) continue;
      char tok0[64] = {0}, tok1[64] = {0}, tok2[64] = {0}, tok3[64] = {0},
           tok4[64] = {0};
      int nt = std::sscanf(line.c_str(), "%63s %63s %63s %63s %63s", tok0,
                           tok1, tok2, tok3, tok4);
      if (nt < 1) continue;
      if (!std::strcmp(tok0, "format")) {
        binary = !std::strcmp(tok1, "binary_little_endian");
        ascii = !std::strcmp(tok1, "ascii");
      } else if (!std::strcmp(tok0, "element") && nt >= 3) {
        elems.push_back({tok1, std::atol(tok2), {}});
      } else if (!std::strcmp(tok0, "property") && !elems.empty()) {
        Prop p;
        if (!std::strcmp(tok1, "list") && nt >= 5) {
          p.is_list = true;
          bool dummy;
          p.count_size = type_size(tok2, &dummy);
          p.size = type_size(tok3, &p.is_float);
          p.name = tok4;
        } else if (nt >= 3) {
          p.size = type_size(tok1, &p.is_float);
          p.name = tok2;
        }
        if (p.size == 0) return -4;
        elems.back().props.push_back(p);
      }
    }
  }
  if (!binary && !ascii) return -5;

  std::vector<float> verts;
  std::vector<int32_t> faces;

  if (ascii) {
    // tokenize body (strip {comments} per-line first)
    std::string b(body, data.data() + fsize);
    std::vector<double> tokens;
    tokens.reserve(1 << 20);
    {
      size_t pos = 0;
      while (pos < b.size()) {
        size_t nl = b.find('\n', pos);
        if (nl == std::string::npos) nl = b.size();
        size_t brace = b.find('{', pos);
        size_t lim = (brace != std::string::npos && brace < nl) ? brace : nl;
        const char* s = b.c_str() + pos;
        const char* e = b.c_str() + lim;
        char* endp;
        while (s < e) {
          double v = std::strtod(s, &endp);
          if (endp == s) {
            ++s;
            continue;
          }
          tokens.push_back(v);
          s = endp;
        }
        pos = nl + 1;
      }
    }
    size_t tp = 0;
    for (const Elem& el : elems) {
      if (el.name == "vertex") {
        int xi = -1, yi = -1, zi = -1, w = el.props.size();
        for (int i = 0; i < w; ++i) {
          if (el.props[i].name == "x") xi = i;
          if (el.props[i].name == "y") yi = i;
          if (el.props[i].name == "z") zi = i;
        }
        if (xi < 0 || yi < 0 || zi < 0) return -6;
        verts.reserve(el.count * 3);
        for (long i = 0; i < el.count; ++i) {
          if (tp + w > tokens.size()) return -7;
          verts.push_back(static_cast<float>(tokens[tp + xi]));
          verts.push_back(static_cast<float>(tokens[tp + yi]));
          verts.push_back(static_cast<float>(tokens[tp + zi]));
          tp += w;
        }
      } else if (el.name == "face") {
        for (long i = 0; i < el.count; ++i) {
          if (tp >= tokens.size()) return -7;
          int n = static_cast<int>(tokens[tp++]);
          if (tp + n > tokens.size()) return -7;
          for (int k = 1; k + 1 <= n - 1; ++k) {
            faces.push_back(static_cast<int32_t>(tokens[tp]));
            faces.push_back(static_cast<int32_t>(tokens[tp + k]));
            faces.push_back(static_cast<int32_t>(tokens[tp + k + 1]));
          }
          tp += n;
        }
      } else {
        // skip scalar rows; ascii lists in unknown elements unsupported
        for (const Prop& p : el.props)
          if (p.is_list) return -8;
        tp += el.count * el.props.size();
      }
    }
  } else {
    const uint8_t* p = reinterpret_cast<const uint8_t*>(body);
    const uint8_t* pe = reinterpret_cast<const uint8_t*>(data.data()) + fsize;
    for (const Elem& el : elems) {
      bool has_list = false;
      int row = 0;
      for (const Prop& pr : el.props) {
        has_list |= pr.is_list;
        row += pr.size;
      }
      if (el.name == "vertex" && !has_list) {
        int xo = -1, yo = -1, zo = -1, off = 0;
        bool xf = false, yf = false, zf = false;
        int xs = 0, ys = 0, zs = 0;
        for (const Prop& pr : el.props) {
          if (pr.name == "x") { xo = off; xf = pr.is_float; xs = pr.size; }
          if (pr.name == "y") { yo = off; yf = pr.is_float; ys = pr.size; }
          if (pr.name == "z") { zo = off; zf = pr.is_float; zs = pr.size; }
          off += pr.size;
        }
        if (xo < 0) return -6;
        verts.reserve(el.count * 3);
        for (long i = 0; i < el.count; ++i) {
          if (p + row > pe) return -7;
          verts.push_back(static_cast<float>(read_scalar(p + xo, xs, xf)));
          verts.push_back(static_cast<float>(read_scalar(p + yo, ys, yf)));
          verts.push_back(static_cast<float>(read_scalar(p + zo, zs, zf)));
          p += row;
        }
      } else if (el.name == "face") {
        const Prop* lp = nullptr;
        for (const Prop& pr : el.props)
          if (pr.is_list) lp = &pr;
        if (!lp) return -6;
        for (long i = 0; i < el.count; ++i) {
          for (const Prop& pr : el.props) {
            if (!pr.is_list) {
              p += pr.size;
              continue;
            }
            if (p + pr.count_size > pe) return -7;
            int n = static_cast<int>(read_scalar(p, pr.count_size, false));
            p += pr.count_size;
            if (p + static_cast<long>(n) * pr.size > pe) return -7;
            if (&pr == lp) {
              std::vector<int32_t> idx(n);
              for (int k = 0; k < n; ++k)
                idx[k] = static_cast<int32_t>(
                    read_scalar(p + k * pr.size, pr.size, pr.is_float));
              for (int k = 1; k + 1 <= n - 1; ++k) {
                faces.push_back(idx[0]);
                faces.push_back(idx[k]);
                faces.push_back(idx[k + 1]);
              }
            }
            p += static_cast<long>(n) * pr.size;
          }
        }
      } else {
        // generic skip
        for (long i = 0; i < el.count; ++i) {
          for (const Prop& pr : el.props) {
            if (pr.is_list) {
              int n = static_cast<int>(read_scalar(p, pr.count_size, false));
              p += pr.count_size + static_cast<long>(n) * pr.size;
            } else {
              p += pr.size;
            }
            if (p > pe) return -7;
          }
        }
      }
    }
  }

  *n_verts_out = static_cast<int>(verts.size() / 3);
  *n_faces_out = static_cast<int>(faces.size() / 3);
  *verts_out = static_cast<float*>(std::malloc(verts.size() * sizeof(float)));
  *faces_out =
      static_cast<int32_t*>(std::malloc(faces.size() * sizeof(int32_t)));
  std::memcpy(*verts_out, verts.data(), verts.size() * sizeof(float));
  std::memcpy(*faces_out, faces.data(), faces.size() * sizeof(int32_t));
  return 0;
}

}  // extern "C"
