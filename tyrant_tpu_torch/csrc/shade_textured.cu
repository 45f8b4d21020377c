// The shade stage of the render step (render.py:_shade) on the textured
// feature set, in two launches: albedo maps with their cutout alpha,
// tangent-space normal maps, roughness and metalness maps (the metal pick
// on its side stream), cutout and stochastic-blend pass-throughs (the blend
// coin on its side stream) and the GGX conductor (its NEE estimator and its
// VNDF bounce), under "nearest" or "bilinear" filtering, on the rest of the
// base feature set of csrc/shade.cu.  Every other configuration takes the
// plain PyTorch body (render.py:_shade_plain).
//
// Replaces: no TPU kernel.  The JAX package leaves shade to XLA's fusion
// (tyrant_tpu/render.py::_shade); the port's plain body is some hundreds of
// elementwise, gather and reduce launches over the whole queue: a row gather
// of tex_data a bilinear tap (12 on a mapped triangle hit), each result
// written to device memory for the next launch to read back.
//
// What bounds it on an H100: memory bandwidth, in latency-bound random
// loads.  A slot reads the base kernel's 54 bytes and writes its 95; a
// triangle hit adds a 32-byte tri_shade row, 96 of its 128-byte tri_attr
// row and up to 12 bilinear taps of a 16-byte atlas row (albedo with its
// cutout alpha, the normal map, roughness and metalness), each a random
// 32-byte sector; the 32-byte surface record between the launches is
// written once and read once.  About 460 bytes a slot on the textured
// queue, 0.29 ms at 2,097,152 slots and 3.35 TB/s.
//
// What the design does about it: one thread a slot in each launch.  The
// surface kernel (surface_kernel) reads the hit's rows, computes the
// barycentrics, uv and wrap modes, then issues every tap of the slot's maps
// before it uses any, so that up to 12 independent loads are in flight a
// thread through the read-only path; it keeps few values live, for many
// warps a multiprocessor, and writes one record a slot: the shading normal,
// the roughness, the colour and the material with the metal and blend picks
// and the pass-through resolved.  The shade kernel (shade_textured_kernel)
// reads the record and the ray and runs the base kernel's body
// (shade_tail of shade_common.cuh) with the pass-through, GGX NEE and the
// GGX bounce compiled in; it keeps every intermediate in registers and
// writes straight into the tensors connect and sort read.
// The split keeps the gathers apart from the shading's registers, and lets
// the tracer's fetch_end marker fall between the two.
//
// Exactness: the arithmetic repeats the plain body's float32 operations in
// its order, by the rules of csrc/shade.cu's header (IEEE division and
// square root, no contraction, PyTorch's three-term dot, a Python scalar's
// float32 rounding), and the side streams are the plain body's keys.  The
// bilinear weights are float32, as the plain body's; no hardware filtering
// (its 8-bit fixed-point weights round differently).  The outputs equal the
// plain body's on every slot the step reads: every output of a hit (the
// shadow colour where the ray is valid; an invalid one's is 0), and a
// miss's colour, survive flag and next direction, throughput, bounces and
// last_specular.  A miss does no gathers: its surface is zero, so its next
// origin and shadow origin are its own origin (the plain body takes them,
// and the shadow direction and range, from triangle 0's maps; no stage
// reads them).
#include "shade_common.cuh"

// The textured gates and sizes the surface kernel reads
// (ops/kernels/shade.py builds the same layout).
struct SurfaceConsts {
  int n_attr_rows, n_tex_rows, gates, bilinear;
};

namespace {

// SurfaceConsts.gates: the scene's flags of render.SHADE_TEXTURED_SCENE,
// and the traversal's hit normals on a default-material scene
constexpr int G_ALBEDO = 1, G_NORMAL = 2, G_ROUGH = 4, G_METAL = 8,
              G_ALPHA = 16, G_BLEND = 32, G_GGX = 64, G_KN = 128;
constexpr int G_MAPS = G_ALBEDO | G_NORMAL | G_ROUGH;
// the record's material word: the material in the low byte, and this bit
// on a triangle hit that taps an albedo map (the tracer's tex_hits)
constexpr int TEX_HIT = 1 << 8;
// the surface's side streams' keys (render.py)
constexpr uint32_t KEY_METAL = 0x4E7A1u, KEY_BLEND = 0xB1E2Du;
// Python scalars as PyTorch rounds them: double to float32
constexpr float ROUGH_MIN = (float)0.03;
constexpr float BLEND_LO = (float)1e-6, BLEND_HI = (float)(1.0 - 1e-6);

// one texture's tex_meta entry: atlas offset, height, width, wrap modes
struct Tex {
  int off, h, w, ws, wt;
};

__device__ __forceinline__ Tex tex_entry(const int* __restrict__ meta,
                                         int k) {
  const int* m = meta + 5 * k;
  return Tex{__ldg(m), __ldg(m + 1), __ldg(m + 2), __ldg(m + 3),
             __ldg(m + 4)};
}

// render.py:_sample_texture's wrap: 0 repeat, 1 clamp to edge, 2 mirrored
// repeat
__device__ __forceinline__ float wrap_coord(float c, int mode) {
  if (mode == 1) return clamp(c, 0.0f, 1.0f);
  if (mode == 2) {
    const float t2 = c - 2.0f * floorf(c * 0.5f);
    return t2 > 1.0f ? 2.0f - t2 : t2;
  }
  return c - floorf(c);
}

// torch.remainder on int32: the result takes the divisor's sign
__device__ __forceinline__ int py_mod(int a, int b) {
  int r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

__device__ __forceinline__ int texel_row(const Tex& m, int x, int y,
                                         int n_rows) {
  return min(max(m.off + (m.h - 1 - y) * m.w + x, 0), n_rows - 1);
}

// The atlas rows of texture m's taps at (u, v) (v = 0 at the image's
// bottom): one under "nearest", four under "bilinear" with the weights
// (ax, ay), in _sample_texture's order (x0 y0, x1 y0, x0 y1, x1 y1); a
// non-repeat border clamps the neighbour texel
__device__ __forceinline__ void tap_rows(const Tex& m, float u, float v,
                                         bool bilinear, int n_rows,
                                         int* row, float& ax, float& ay) {
  u = wrap_coord(u, m.ws);
  v = wrap_coord(v, m.wt);
  if (!bilinear) {
    const int x = min((int)(u * (float)m.w), m.w - 1);
    const int y = min((int)(v * (float)m.h), m.h - 1);
    row[0] = texel_row(m, x, y, n_rows);
    return;
  }
  const float fx = u * (float)m.w - 0.5f;
  const float fy = v * (float)m.h - 0.5f;
  const float x0f = floorf(fx), y0f = floorf(fy);
  ax = fx - x0f;
  ay = fy - y0f;
  const int xi = (int)x0f, yi = (int)y0f;
  int x0 = py_mod(xi, m.w), y0 = py_mod(yi, m.h);
  int x1 = py_mod(x0 + 1, m.w), y1 = py_mod(y0 + 1, m.h);
  if (m.ws != 0) {
    x0 = min(max(xi, 0), m.w - 1);
    x1 = min(x0 + 1, m.w - 1);
  }
  if (m.wt != 0) {
    y0 = min(max(yi, 0), m.h - 1);
    y1 = min(y0 + 1, m.h - 1);
  }
  row[0] = texel_row(m, x0, y0, n_rows);
  row[1] = texel_row(m, x1, y0, n_rows);
  row[2] = texel_row(m, x0, y1, n_rows);
  row[3] = texel_row(m, x1, y1, n_rows);
}

__device__ __forceinline__ float lerp4(float t00, float t10, float t01,
                                       float t11, float ax, float ay) {
  const float bx = 1.0f - ax, by = 1.0f - ay;
  return (((t00 * bx) * by + (t10 * ax) * by) + (t01 * bx) * ay) +
         (t11 * ax) * ay;
}

// the filtered texel from the taps t[] (t[0] alone under "nearest")
__device__ __forceinline__ float4 filtered(const float4* t, bool bilinear,
                                           float ax, float ay) {
  if (!bilinear) return t[0];
  return make_float4(lerp4(t[0].x, t[1].x, t[2].x, t[3].x, ax, ay),
                     lerp4(t[0].y, t[1].y, t[2].y, t[3].y, ax, ay),
                     lerp4(t[0].z, t[1].z, t[2].z, t[3].z, ax, ay),
                     lerp4(t[0].w, t[1].w, t[2].w, t[3].w, ax, ay));
}

__device__ __forceinline__ void fetch_taps(const float4* __restrict__ tex,
                                           const int* row, int k,
                                           float4* t) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < k) t[j] = __ldg(tex + row[j]);
}

__global__ void __launch_bounds__(BLOCK)
surface_kernel(const float* __restrict__ origin,
               const float* __restrict__ direction,
               const int* __restrict__ pixel, const float* __restrict__ tt,
               const int* __restrict__ ident,
               const uint8_t* __restrict__ is_tri_in,
               const float* __restrict__ tri_normal,
               const float* __restrict__ tri_shade,
               const float* __restrict__ tri_attr,
               const float* __restrict__ spheres,
               const long long* __restrict__ frame,
               const float* __restrict__ tex_data,
               const int* __restrict__ tex_meta, const ShadeConsts c,
               const SurfaceConsts s, float4* __restrict__ record) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= c.n) return;
  const float t = __ldg(tt + i);
  const int id = __ldg(ident + i);
  const bool hit = t < c.very_far;
  const bool is_tri = __ldg(is_tri_in + i) != 0;
  // a miss: no surface, DIFF (the plain body's material for a miss)
  V3 normal = v3(0.0f, 0.0f, 0.0f), color = v3(0.0f, 0.0f, 0.0f);
  float rough = 0.0f;
  int word = DIFF;
  if (hit) {
    const V3 d = ld3(direction, i);
    const V3 o = ld3(origin, i) + d * t;
    if (!is_tri) {
      const int sid = min(max(id, 0), c.n_sphere_rows - 1);
      normal = (o - v3(srow(spheres, sid, 0), srow(spheres, sid, 1),
                       srow(spheres, sid, 2))) /
               srow(spheres, sid, 3);
      color = v3(srow(spheres, sid, 4), srow(spheres, sid, 5),
                 srow(spheres, sid, 6));
      rough = srow(spheres, sid, 11);
      word = (int)srow(spheres, sid, 10);
    } else if (s.gates & G_KN) {
      // a default-material triangle from the traversal's hit normal
      const V3 tn = ld3(tri_normal, i);
      const float nlen = sqrtf(clamp_min(dot(tn, tn), 1e-30f));
      normal = tn / clamp_min(nlen, 1e-30f);
      color = v3(1.0f, 1.0f, 1.0f);
      rough = (float)0.3;
    } else {
      const int tid = min(max(id, 0), c.n_tri_rows - 1);
      const float4* trow = reinterpret_cast<const float4*>(tri_shade) +
                           2 * (size_t)tid;
      const float4 r0 = __ldg(trow), r1 = __ldg(trow + 1);
      normal = v3(r0.x, r0.y, r0.z);
      int refl = (int)r0.w;
      color = v3(r1.x, r1.y, r1.z);
      rough = r1.w;
      // the flags the refl lane carries: metal +32, blend +16
      const bool metal = (s.gates & G_METAL) && refl >= 32;
      if (metal) refl -= 32;
      const bool blend = (s.gates & G_BLEND) && refl >= 16;
      if (blend) refl -= 16;
      float alpha = 1.0f;
      float4 rm = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      int rtexid = -1;
      if (s.gates & G_MAPS) {
        const int aid = min(tid, s.n_attr_rows - 1);
        const float4* arow = reinterpret_cast<const float4*>(tri_attr) +
                             8 * (size_t)aid;
        // lanes 0-15: v0, the dual basis s1 and s2, uv0, duv1, duv2, the
        // albedo id; 24-31: the normal-map id, the uv tangent, its
        // handedness, the rough-map id
        const float4 a0 = __ldg(arow), a1 = __ldg(arow + 1),
                     a2 = __ldg(arow + 2), a3 = __ldg(arow + 3),
                     a6 = __ldg(arow + 6), a7 = __ldg(arow + 7);
        const V3 p_rel = o - v3(a0.x, a0.y, a0.z);
        const float bu = dot(p_rel, v3(a0.w, a1.x, a1.y));
        const float bv = dot(p_rel, v3(a1.z, a1.w, a2.x));
        const float u = (a2.y + bu * a2.w) + bv * a3.y;
        const float v = (a2.z + bu * a3.x) + bv * a3.z;
        const int texid = (s.gates & G_ALBEDO) ? (int)a3.w : -1;
        const int ntexid = (s.gates & G_NORMAL) ? (int)a6.z : -1;
        rtexid = (s.gates & G_ROUGH) ? (int)a7.w : -1;
        // every tap's row first, then every load, then the filters
        const bool bil = s.bilinear != 0;
        const int k = bil ? 4 : 1;
        int ra[4], rn[4], rr[4];
        float axa = 0.0f, aya = 0.0f, axn = 0.0f, ayn = 0.0f, axr = 0.0f,
              ayr = 0.0f;
        if (texid >= 0)
          tap_rows(tex_entry(tex_meta, texid), u, v, bil, s.n_tex_rows, ra,
                   axa, aya);
        if (ntexid >= 0)
          tap_rows(tex_entry(tex_meta, ntexid), u, v, bil, s.n_tex_rows, rn,
                   axn, ayn);
        if (rtexid >= 0)
          tap_rows(tex_entry(tex_meta, rtexid), u, v, bil, s.n_tex_rows, rr,
                   axr, ayr);
        const float4* tex = reinterpret_cast<const float4*>(tex_data);
        float4 ta[4], tn[4], tr[4];
        if (texid >= 0) fetch_taps(tex, ra, k, ta);
        if (ntexid >= 0) fetch_taps(tex, rn, k, tn);
        if (rtexid >= 0) fetch_taps(tex, rr, k, tr);
        if (texid >= 0) {
          const float4 al = filtered(ta, bil, axa, aya);
          color = color * v3(al.x, al.y, al.z);
          alpha = al.w;
          word |= TEX_HIT;
        }
        if (ntexid >= 0) {
          // the tangent-space normal map: T orthonormalised against the
          // normal, B = cross(N, T) times the handedness
          const float4 nm = filtered(tn, bil, axn, ayn);
          const V3 n_ts = v3(nm.x * 2.0f - 1.0f, nm.y * 2.0f - 1.0f,
                             nm.z * 2.0f - 1.0f);
          const V3 tang = v3(a6.w, a7.x, a7.y);
          V3 t_o = tang - normal * dot(normal, tang);
          const float t_len = sqrtf(clamp_min(dot(t_o, t_o), 1e-20f));
          t_o = t_o / t_len;
          const V3 b_o = cross(normal, t_o) * a7.z;
          V3 n_p = (t_o * n_ts.x + b_o * n_ts.y) +
                   normal * clamp_min(n_ts.z, 0.0f);
          n_p = n_p / sqrtf(clamp_min(dot(n_p, n_p), 1e-20f));
          if (t_len > 1e-6f) normal = n_p;
        }
        if (rtexid >= 0) {
          rm = filtered(tr, bil, axr, ayr);
          rough = clamp(rm.x, ROUGH_MIN, 1.0f);
        }
      }
      uint32_t pre = 0u;
      if ((s.gates & (G_METAL | G_BLEND)) != 0)
        pre = stream_prefix(frame, __ldg(pixel + i), i, c.row_offset);
      if ((s.gates & G_ROUGH) && metal) {
        // metalness: the GGX conductor with that probability, else DIFF
        uint32_t ms = side_stream(pre, KEY_METAL);
        const float u_m = random_float(ms);
        refl = u_m < (rtexid >= 0 ? rm.y : 1.0f) ? GGX : DIFF;
      }
      if (s.gates & G_ALPHA) {
        // the cutout: a pass-through below 0.5, or below a uniform on a
        // blend triangle
        float thresh = 0.5f;
        if (blend) {
          uint32_t bs = side_stream(pre, KEY_BLEND);
          thresh = clamp(random_float(bs), BLEND_LO, BLEND_HI);
        }
        if (alpha < thresh) refl = PASS;
      }
      word |= refl;
    }
  }
  float4* rec = record + 2 * (size_t)i;
  rec[0] = make_float4(normal.x, normal.y, normal.z, rough);
  rec[1] = make_float4(color.x, color.y, color.z, __int_as_float(word));
}

__global__ void __launch_bounds__(BLOCK)
shade_textured_kernel(
    const float* __restrict__ origin, const float* __restrict__ direction,
    const float* __restrict__ direct_in, const int* __restrict__ pixel,
    const int* __restrict__ bounces, const uint8_t* __restrict__ last_spec,
    const float* __restrict__ tt, const int* __restrict__ ident,
    const float4* __restrict__ record, const float* __restrict__ spheres,
    const float* __restrict__ sun_dir, const float* __restrict__ total_mie,
    const long long* __restrict__ frame, const ShadeConsts c, const int gates,
    float* __restrict__ color_out, uint8_t* __restrict__ survive_out,
    float* __restrict__ n_origin, float* __restrict__ n_dir,
    float* __restrict__ n_direct, int* __restrict__ n_bounces,
    uint8_t* __restrict__ n_last_spec, float* __restrict__ s_origin,
    float* __restrict__ s_dir, float* __restrict__ s_color,
    float* __restrict__ s_maxd, uint8_t* __restrict__ s_valid) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= c.n) return;
  const V3 d = ld3(direction, i);
  const V3 dir_in = ld3(direct_in, i);
  const int pix = __ldg(pixel + i), bnc = __ldg(bounces + i);
  const bool ls = __ldg(last_spec + i) != 0;
  const float t = __ldg(tt + i);
  const bool hit = t < c.very_far;
  const float t_safe = hit ? t : 0.0f;
  V3 o = ld3(origin, i) + d * t_safe;

  // the surface kernel's record: normal, roughness, colour, material
  const float4 q0 = __ldg(record + 2 * (size_t)i);
  const float4 q1 = __ldg(record + 2 * (size_t)i + 1);
  V3 normal = v3(q0.x, q0.y, q0.z);
  const float ggx_a = q0.w * q0.w;
  const V3 obj_color = v3(q1.x, q1.y, q1.z);
  const int refl = __float_as_int(q1.w) & 0xFF;
  const bool is_pass = hit && refl == PASS;
  const bool is_ggx = (gates & G_GGX) && hit && refl == GGX;
  const bool mul_mask = hit && refl != REFR && refl != LIGHT && !is_pass &&
                        !is_ggx;
  V3 direct = mul_mask ? dir_in * obj_color : dir_in;
  const bool outside = dot(normal, d) < 0.0f;
  if (!outside) normal = -normal;
  o = o + normal * c.eps;

  // emitter hits, no MIS: collected on specular-born paths
  const bool is_light = hit && refl == LIGHT;
  V3 color = v3(0.0f, 0.0f, 0.0f);
  if (is_light) {
    const int sid = min(max(__ldg(ident + i), 0), c.n_sphere_rows - 1);
    if (ls)
      color = direct * v3(srow(spheres, sid, 7), srow(spheres, sid, 8),
                          srow(spheres, sid, 9));
    else
      direct = v3(0.0f, 0.0f, 0.0f);
  }

  shade_tail<true>(c, i, spheres, sun_dir, total_mie, frame, d, dir_in, pix,
                   bnc, ls, hit, t_safe, o, normal, outside, refl, obj_color,
                   direct, color, is_ggx, is_pass, ggx_a, color_out,
                   survive_out, n_origin, n_dir, n_direct, n_bounces,
                   n_last_spec, s_origin, s_dir, s_color, s_maxd, s_valid);
}

}  // namespace

// The textured variant's first launch: the surface record [n, 8] f32 of
// every queue slot (normal, roughness; colour, the material word) from the
// inputs as render.py:_shade takes them (bool tensors as bytes; the pixels
// and the frame, int64, key the side streams), tri_normal [n, 3] under the
// kernel normals gate (else null), the tri_shade, tri_attr and sphere rows,
// and the atlas tex_data [rows, 4] with tex_meta [K, 5] i32 (offset,
// height, width, wrap_s, wrap_t), null without textures.  Launches on
// `stream`; returns cudaGetLastError().
extern "C" int tyrant_shade_surface(
    const float* origin, const float* direction, const int* pixel,
    const float* t, const int* ident, const uint8_t* is_tri,
    const float* tri_normal, const float* tri_shade, const float* tri_attr,
    const float* spheres, const long long* frame, const float* tex_data,
    const int* tex_meta, const ShadeConsts* consts,
    const SurfaceConsts* surf, float* record, void* stream) {
  const ShadeConsts c = *consts;
  if (c.n <= 0) return 0;
  const int grid = (c.n + BLOCK - 1) / BLOCK;
  surface_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      origin, direction, pixel, t, ident, is_tri, tri_normal, tri_shade,
      tri_attr, spheres, frame, tex_data, tex_meta, c, *surf,
      reinterpret_cast<float4*>(record));
  return (int)cudaGetLastError();
}

// The textured variant's second launch: shade n queue slots from the ray,
// the hit and the surface record, into the output buffers of tyrant_shade
// (csrc/shade.cu), with `gates` the SurfaceConsts flags.  Launches on
// `stream`; returns cudaGetLastError().
extern "C" int tyrant_shade_textured(
    const float* origin, const float* direction, const float* direct,
    const int* pixel, const int* bounces, const uint8_t* last_spec,
    const float* t, const int* ident, const float* record,
    const float* spheres, const float* sun_dir, const float* total_mie,
    const long long* frame, const ShadeConsts* consts, int gates,
    float* color, uint8_t* survive, float* n_origin, float* n_dir,
    float* n_direct, int* n_bounces, uint8_t* n_last_spec, float* s_origin,
    float* s_dir, float* s_color, float* s_maxd, uint8_t* s_valid,
    void* stream) {
  const ShadeConsts c = *consts;
  if (c.n <= 0) return 0;
  const int grid = (c.n + BLOCK - 1) / BLOCK;
  shade_textured_kernel<<<grid, BLOCK, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      origin, direction, direct, pixel, bounces, last_spec, t, ident,
      reinterpret_cast<const float4*>(record), spheres, sun_dir, total_mie,
      frame, c, gates, color, survive, n_origin, n_dir, n_direct, n_bounces,
      n_last_spec, s_origin, s_dir, s_color, s_maxd, s_valid);
  return (int)cudaGetLastError();
}
