// Device code shared by the shade kernels (csrc/shade.cu, the base
// feature set, and csrc/shade_textured.cu, the textured one): the config's
// and the sky's scalars, float32 vectors with PyTorch's rounding, the
// xorshift streams of ops/rng.py, the atmosphere of sky.py, the GGX
// helpers of sampling.py, and shade_tail, the body both kernels run once
// the hit surface is known.  The arithmetic rules are those of
// csrc/shade.cu's header.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

// The config's and the sky's scalars, float32 as PyTorch rounds them
// (ops/kernels/shade.py builds the same layout).
struct ShadeConsts {
  int n, max_bounces, row_offset, light, has_light, n_tri_rows,
      n_sphere_rows;
  float eps, neg2eps, very_far, sun_extent, cos_sun;
  float sun_intensity, cutoff, inv_steep, rzl, mzl;
  float ray0, ray1, ray2;
  float g2x, gg, one_m_gg, sky_k, inv_disc;
};

namespace {

constexpr int BLOCK = 256;
constexpr double PI_D = 3.1415926535897932;
constexpr double INV_PI_D = 1.0 / PI_D;
constexpr float PI_F = (float)PI_D;
constexpr float TWO_PI_F = (float)(2.0 * PI_D);
constexpr float FOUR_PI_F = (float)(4.0 * PI_D);
constexpr float INV_PI_F = (float)INV_PI_D;
constexpr float PHONG_E = 40.0f;
constexpr float PHONG_NORM_F = (float)((40.0 + 2.0) * 0.5 * INV_PI_D);
constexpr float PHONG_INV_E1 = (float)(1.0 / (40.0 + 1.0));
constexpr float RAYLEIGH_PHASE_F = (float)(3.0 / (16.0 * PI_D));
constexpr float HG_NORM_F = (float)(1.0 / (4.0 * PI_D));
constexpr float INV_2_32 = 2.3283064365387e-10f;
constexpr float INV_65535 = 1.0f / 65535.0f;
constexpr float ETA = 1.2f;
constexpr uint32_t GOLDEN = 0x9E3779B9u;
constexpr int DIFF = 0, SPEC = 1, REFR = 2, PHONG = 3, LIGHT = 4, GGX = 5,
              PASS = 7;
// the GGX bounce's side stream (render.py)
constexpr uint32_t KEY_GGX = 0x66C5u;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) {
  return V3{x, y, z};
}
__device__ __forceinline__ V3 operator+(V3 a, V3 b) {
  return v3(a.x + b.x, a.y + b.y, a.z + b.z);
}
__device__ __forceinline__ V3 operator-(V3 a, V3 b) {
  return v3(a.x - b.x, a.y - b.y, a.z - b.z);
}
__device__ __forceinline__ V3 operator-(V3 a) { return v3(-a.x, -a.y, -a.z); }
__device__ __forceinline__ V3 operator*(V3 a, V3 b) {
  return v3(a.x * b.x, a.y * b.y, a.z * b.z);
}
__device__ __forceinline__ V3 operator*(V3 a, float s) {
  return v3(a.x * s, a.y * s, a.z * s);
}
__device__ __forceinline__ V3 operator/(V3 a, V3 b) {
  return v3(a.x / b.x, a.y / b.y, a.z / b.z);
}
__device__ __forceinline__ V3 operator/(V3 a, float s) {
  return v3(a.x / s, a.y / s, a.z / s);
}

// PyTorch's sum over a last dimension of 3 (two lanes, the first taking
// elements 0 and 2, each accumulator starting at 0)
__device__ __forceinline__ float dot(V3 a, V3 b) {
  const float p0 = a.x * b.x, p1 = a.y * b.y, p2 = a.z * b.z;
  return ((0.0f + p0) + (0.0f + p2)) + (0.0f + p1);
}

// torch.linalg.cross's component a*b - c*d: one FMA of the first product
// with the second, rounded, subtracted
__device__ __forceinline__ float cross_term(float a, float b, float c,
                                            float d) {
  return __fmaf_rn(a, b, -(c * d));
}

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return v3(cross_term(a.y, b.z, a.z, b.y), cross_term(a.z, b.x, a.x, b.z),
            cross_term(a.x, b.y, a.y, b.x));
}

// torch.clamp: NaN passes through
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max(float v, float hi) {
  return v != v ? v : fminf(v, hi);
}
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ V3 normalize(V3 v) {
  return v / sqrtf(clamp_min(dot(v, v), 1e-20f));
}

// d - 2 dot(d, n) n
__device__ __forceinline__ V3 reflect(V3 d, V3 n) {
  return d - n * (2.0f * dot(d, n));
}

// ops/sampling.py:orthonormal_basis
__device__ __forceinline__ void onb(V3 w, V3& u, V3& v) {
  const V3 a = fabsf(w.x) > 0.9f ? v3(0.0f, 1.0f, 0.0f) : v3(1.0f, 0.0f, 0.0f);
  u = normalize(cross(a, w));
  v = cross(w, u);
}

// ops/rng.py: one component into the hash state, the xorshift step and
// the two uniforms
__device__ __forceinline__ uint32_t fold(uint32_t h, uint32_t p) {
  h = (p + GOLDEN + (h << 6) + (h >> 2)) ^ h;
  h = (h ^ 61u) ^ (h >> 16);
  h *= 9u;
  h ^= h >> 4;
  h *= 0x27D4EB2Du;
  h ^= h >> 15;
  return h;
}
__device__ __forceinline__ uint32_t nudge(uint32_t h) {
  return h == 0u ? 0x1337C0DEu : h;
}
__device__ __forceinline__ uint32_t xorshift(uint32_t s) {
  s ^= s << 13;
  s ^= s >> 17;
  s ^= s << 5;
  return s;
}
__device__ __forceinline__ float random_float(uint32_t& s) {
  s = xorshift(s);
  return (float)s * INV_2_32;
}
__device__ __forceinline__ float random_float2(uint32_t& s) {
  s = xorshift(s);
  return (float)(s >> 16) * INV_65535;
}

// the streams' common prefix (frame, pixel, slot, row offset), and the
// stream of key `key` after it
__device__ __forceinline__ uint32_t stream_prefix(const long long* frame,
                                                  int pix, int i,
                                                  int row_offset) {
  const uint32_t fr = (uint32_t)(*frame & 0xFFFFFFFFll);
  return fold(fold(fold(fold(GOLDEN, fr), (uint32_t)pix), (uint32_t)i),
              (uint32_t)row_offset);
}
__device__ __forceinline__ uint32_t side_stream(uint32_t pre, uint32_t key) {
  return nudge(fold(pre, key));
}

// sky.py:_atmosphere_common for view v: the sun's intensity, the
// extinction fex and cos(view, sun); with `term` also the sky term
struct Atmos {
  float sun_e, cvs;
  V3 fex, sky;
};

__device__ Atmos atmosphere(const ShadeConsts& c, V3 v, V3 sun, V3 mie,
                            bool term) {
  const V3 up = v3(0.0f, 0.0f, 1.0f);
  Atmos a;
  a.cvs = dot(v, sun);
  const float csu = dot(sun, up);
  const float cuv = dot(up, v);
  a.sun_e = (1.0f - expf(-((c.cutoff - acosf(clamp(csu, -1.0f, 1.0f))) *
                           c.inv_steep)));
  a.sun_e = clamp_min(a.sun_e, 0.0f) * c.sun_intensity;
  const float rinv = 1.0f / clamp_min(cuv, 0.0f);
  const float rl = rinv * c.rzl, ml = rinv * c.mzl;
  const V3 ray = v3(c.ray0, c.ray1, c.ray2);
  a.fex = v3(expf(-(ray.x * rl + mie.x * ml)), expf(-(ray.y * rl + mie.y * ml)),
             expf(-(ray.z * rl + mie.z * ml)));
  if (!term) return a;
  const float rp = (1.0f + a.cvs * a.cvs) * RAYLEIGH_PHASE_F;
  const float hg =
      ((1.0f / powf((1.0f - c.g2x * a.cvs) + c.gg, 1.5f)) * c.one_m_gg) *
      HG_NORM_F;
  const V3 lf = (ray * rp + mie * hg) / (ray + mie);  // per component
  const V3 something = lf * a.sun_e;
  V3 sky = something * (v3(1.0f, 1.0f, 1.0f) - a.fex);
  const float mix_t = clamp(powf(1.0f - dot(up, sun), 5.0f), 0.0f, 1.0f);
  const V3 sf = something * a.fex;
  const V3 low = v3(sqrtf(clamp_min(sf.x, 0.0f)), sqrtf(clamp_min(sf.y, 0.0f)),
                    sqrtf(clamp_min(sf.z, 0.0f)));
  const float one_m = 1.0f - mix_t;
  a.sky = sky * v3(one_m + mix_t * low.x, one_m + mix_t * low.y,
                   one_m + mix_t * low.z);
  return a;
}

__device__ __forceinline__ V3 ld3(const float* __restrict__ p, int i) {
  const float* q = p + 3 * (size_t)i;
  return v3(__ldg(q), __ldg(q + 1), __ldg(q + 2));
}
__device__ __forceinline__ void st3(float* __restrict__ p, int i, V3 v) {
  float* q = p + 3 * (size_t)i;
  q[0] = v.x;
  q[1] = v.y;
  q[2] = v.z;
}

// a sphere_table row's float at lane k
__device__ __forceinline__ float srow(const float* __restrict__ st, int s,
                                     int k) {
  return __ldg(st + 12 * s + k);
}

// sampling.py:ggx_g1, Smith's masking term for one direction
__device__ __forceinline__ float ggx_g1(float n_dot_x, float a) {
  const float a2 = a * a;
  const float nx = clamp_min(n_dot_x, 0.0f);
  return (2.0f * nx) /
         clamp_min(nx + sqrtf(a2 + ((1.0f - a2) * nx) * nx), 1e-12f);
}

// Schlick's Fresnel of reflectance f0 at cosine hv
__device__ __forceinline__ V3 schlick(V3 f0, float hv) {
  const float w = powf(1.0f - hv, 5.0f);
  return v3(f0.x + (1.0f - f0.x) * w, f0.y + (1.0f - f0.y) * w,
            f0.z + (1.0f - f0.z) * w);
}

// render.py:_ggx_eval, the GGX BRDF toward l (view and l point away)
__device__ V3 ggx_eval(V3 normal, V3 view, V3 l, float a, V3 f0) {
  const V3 h = normalize(view + l);
  const float nv = dot(normal, view);
  const float nl = dot(normal, l);
  const float hv = clamp_min(dot(h, view), 0.0f);
  // sampling.py:ggx_d_vec: sin^2 from the cross product
  const V3 cr = cross(normal, h);
  const float sin2 = dot(cr, cr);
  const float a2 = a * a;
  const float cc = sin2 + a2 * clamp_min(1.0f - sin2, 0.0f);
  const float d_term = a2 / clamp_min((cc * PI_F) * cc, 1e-12f);
  const float g_term = ggx_g1(nv, a) * ggx_g1(nl, a);
  const float denom = clamp_min(
      (4.0f * clamp_min(nv, 0.0f)) * clamp_min(nl, 0.0f), 1e-8f);
  return schlick(f0, hv) * ((d_term * g_term) / denom);
}

// sampling.py:ggx_vndf_sample_from_uniforms: a half-vector from the
// distribution of visible normals
__device__ V3 ggx_vndf(V3 view, V3 normal, float a, float u1, float u2) {
  V3 tu, tv;
  onb(normal, tu, tv);
  const V3 h = normalize(
      v3(a * dot(view, tu), a * dot(view, tv), dot(view, normal)));
  const float lensq = h.x * h.x + h.y * h.y;
  const float inv_len = 1.0f / sqrtf(clamp_min(lensq, 1e-20f));
  const V3 t1 = lensq > 1e-16f ? v3(-h.y * inv_len, h.x * inv_len, 0.0f)
                               : v3(1.0f, 0.0f, 0.0f);
  const V3 t2 = cross(h, t1);
  const float r = sqrtf(clamp_min(u1, 0.0f));
  const float phi = TWO_PI_F * u2;
  const float p1 = r * cosf(phi);
  const float s = 0.5f * (1.0f + h.z);
  const float p2 = (1.0f - s) * sqrtf(clamp_min(1.0f - p1 * p1, 0.0f)) +
                   s * (r * sinf(phi));
  const float pz = sqrtf(clamp_min((1.0f - p1 * p1) - p2 * p2, 0.0f));
  const V3 nh = (t1 * p1 + t2 * p2) + h * pz;
  const V3 m = normalize(v3(a * nh.x, a * nh.y, clamp_min(nh.z, 0.0f)));
  return (tu * m.x + tv * m.y) + normal * m.z;
}

// The shade body from the streams on, once slot i's hit surface is known
// (the view d, the throughput dir_in as it came and `direct` after the
// colour multiply and the emitter, the hit point o already offset along
// the face-forward normal, the material refl, the colour, the emitter's
// radiance so far in `color`): NEE by the sun cone or the sphere light as
// the coin picks, the shadow ray; the bounce (cosine hemisphere, mirror,
// glass, the PHONG lobe); Russian roulette; a miss's sky; every output of
// the slot.  TEX adds the textured feature set's GGX estimator and VNDF
// bounce (is_ggx, of roughness^2 ggx_a and reflectance obj_color) and the
// pass-through (is_pass: the ray goes on along d, behind the surface, with
// its last_specular).
template <bool TEX>
__device__ __forceinline__ void shade_tail(
    const ShadeConsts& c, int i, const float* __restrict__ spheres,
    const float* __restrict__ sun_dir, const float* __restrict__ total_mie,
    const long long* __restrict__ frame, V3 d, V3 dir_in, int pix, int bnc,
    bool ls, bool hit, float t_safe, V3 o, V3 normal, bool outside,
    int refl, V3 obj_color, V3 direct, V3 color, bool is_ggx, bool is_pass,
    float ggx_a, float* __restrict__ color_out,
    uint8_t* __restrict__ survive_out, float* __restrict__ n_origin,
    float* __restrict__ n_dir, float* __restrict__ n_direct,
    int* __restrict__ n_bounces, uint8_t* __restrict__ n_last_spec,
    float* __restrict__ s_origin, float* __restrict__ s_dir,
    float* __restrict__ s_color, float* __restrict__ s_maxd,
    uint8_t* __restrict__ s_valid) {
  // the streams: shade's main one and the strategy coin's side one
  const uint32_t pre = stream_prefix(frame, pix, i, c.row_offset);
  uint32_t seed = side_stream(pre, 0x5ADEu);
  uint32_t coin = side_stream(pre, 0xC0F1u);

  // NEE: the sun-cone sample, the coin, the sphere light's surface point
  const V3 sun = v3(__ldg(sun_dir), __ldg(sun_dir + 1), __ldg(sun_dir + 2));
  V3 sun_sample;
  {
    const float rx = random_float2(seed);
    const float ry = random_float2(seed);
    const V3 sd = normalize(sun);
    const V3 o1 = normalize(fabsf(sd.x) > fabsf(sd.z) ? v3(-sd.y, sd.x, 0.0f)
                                                      : v3(0.0f, -sd.z, sd.y));
    const V3 o2 = normalize(cross(sd, o1));
    const float phi = (rx * 2.0f) * PI_F;
    const float z = 1.0f - ry * c.sun_extent;
    const float om = sqrtf(clamp_min(1.0f - z * z, 0.0f));
    sun_sample = (o1 * (cosf(phi) * om) + o2 * (sinf(phi) * om)) + sd * z;
  }
  const float sun_cos = dot(normal, sun_sample);
  const bool choose_sun = random_float(coin) < 0.5f;
  const V3 l_ctr = v3(srow(spheres, c.light, 0), srow(spheres, c.light, 1),
                      srow(spheres, c.light, 2));
  const float l_r = srow(spheres, c.light, 3);
  V3 lp;
  {
    const float u = random_float(seed);
    const float v = random_float(seed);
    const float cos_phi = 2.0f * u - 1.0f;
    const float sin_phi = sqrtf(clamp_min(1.0f - cos_phi * cos_phi, 0.0f));
    const float theta = TWO_PI_F * v;
    lp = l_ctr +
         v3(sin_phi * sinf(theta), cos_phi, sin_phi * cosf(theta)) * l_r;
  }
  const V3 n_l = normalize(lp - l_ctr);
  const float area = (FOUR_PI_F * l_r) * l_r;
  const V3 lvec = lp - o;
  const float ldist2 = dot(lvec, lvec);
  const float ldist = sqrtf(clamp_min(ldist2, 1e-20f));
  const V3 ldir = lvec / ldist;
  const float cos_surf = dot(normal, ldir);
  const float cos_light = dot(n_l, -ldir);
  const float solid_angle = (cos_light * area) / clamp_min(ldist2, 1e-20f);
  const bool has_light = c.has_light != 0;

  // the DIFF, PHONG (and GGX) estimators of the strategy the coin chose
  const bool is_diff = hit && refl == DIFF;
  const bool is_phong = hit && refl == PHONG;
  const bool ggx = TEX && is_ggx;
  V3 w_refl = v3(0.0f, 0.0f, 0.0f);
  if (is_phong) w_refl = normalize(d - normal * (2.0f * dot(normal, d)));
  bool shadow_ok = false;
  V3 shadow_color = v3(0.0f, 0.0f, 0.0f);
  const V3 mie = v3(__ldg(total_mie), __ldg(total_mie + 1),
                    __ldg(total_mie + 2));
  if (is_diff || is_phong || ggx) {
    if (choose_sun) {
      const float pcs = is_phong ? dot(sun_sample, w_refl) : 0.0f;
      shadow_ok = sun_cos > 0.0f && (is_diff || ggx || pcs > c.eps);
      if (shadow_ok) {
        const Atmos a = atmosphere(c, sun_sample, sun, mie, false);
        const float disk = a.cvs >= c.cos_sun ? 1.0f : 0.0f;
        const V3 sun_rad = ((a.fex * (a.sun_e * 19000.0f)) * 0.01f) * disk;
        if (is_diff)
          shadow_color = ((direct * 2.0f) * sun_rad) * (sun_cos * 1e-5f);
        else if (!ggx)
          shadow_color = (((direct * 2.0f) * PHONG_NORM_F) * sun_rad) *
                         ((sun_cos * powf(clamp_min(pcs, 0.0f), PHONG_E)) *
                          1e-5f);
        else
          shadow_color =
              (((direct * 2.0f) * sun_rad) *
               ggx_eval(normal, -d, sun_sample, ggx_a, obj_color)) *
              (sun_cos * 1e-5f);
      }
    } else {
      const float pcl = is_phong ? dot(ldir, w_refl) : 0.0f;
      shadow_ok = cos_surf > 0.0f && cos_light > 0.0f && has_light &&
                  (is_diff || ggx || pcl > c.eps);
      if (shadow_ok) {
        const V3 le2 = v3(srow(spheres, c.light, 7), srow(spheres, c.light, 8),
                          srow(spheres, c.light, 9)) *
                       2.0f;
        if (is_diff)
          shadow_color =
              (le2 * direct) * ((solid_angle * INV_PI_F) * cos_surf);
        else if (!ggx)
          shadow_color =
              (le2 * direct) *
              (((((solid_angle * 42.0f) * 0.5f) * INV_PI_F) *
                powf(clamp_min(pcl, 0.0f), PHONG_E)) *
               cos_surf);
        else
          shadow_color = ((le2 * direct) *
                          ggx_eval(normal, -d, ldir, ggx_a, obj_color)) *
                         (solid_angle * cos_surf);
      }
    }
  }
  const V3 shadow_dir = choose_sun ? sun_sample : ldir;
  st3(s_origin, i, o);
  st3(s_dir, i, shadow_dir);
  st3(s_color, i, shadow_color);
  s_maxd[i] = choose_sun ? c.very_far : ldist;
  s_valid[i] = shadow_ok;

  // the bounce: cosine hemisphere, mirror, glass, the PHONG lobe (and the
  // GGX lobe); a pass-through goes on along d
  V3 new_dir = d;
  {
    const float r1u = random_float(seed);
    const float r2 = random_float(seed);
    if (is_diff && bnc < c.max_bounces) {
      const float r1 = TWO_PI_F * r1u;
      const float r2s = sqrtf(r2);
      V3 u, v;
      onb(normal, u, v);
      new_dir = normalize((u * (cosf(r1) * r2s) + v * (sinf(r1) * r2s)) +
                          normal * sqrtf(clamp_min(1.0f - r2, 0.0f)));
    }
  }
  const bool is_spec = hit && refl == SPEC;
  if (is_spec) new_dir = reflect(d, normal);
  const float fr_u = random_float(seed);
  const bool is_refr = hit && refl == REFR;
  bool refr_reflects = false;
  if (is_refr) {
    const float n1 = outside ? ETA : 1.0f;
    const float n2 = outside ? 1.0f : ETA;
    const float q = (n1 - n2) / (n1 + n2);
    const float r0 = q * q;
    const float cos_i = -dot(normal, d);
    const float nr = n2 / n1;
    const float sin_t2 = (nr * nr) * (1.0f - cos_i * cos_i);
    const float fresnel =
        sin_t2 > 1.0f
            ? 1.0f
            : r0 + (1.0f - r0) * powf(clamp_min(1.0f - cos_i, 0.0f), 5.0f);
    refr_reflects = fr_u < fresnel;
    if (refr_reflects) {
      new_dir = reflect(d, normal);
    } else {
      const float cos_t = sqrtf(clamp_min(1.0f - sin_t2, 0.0f));
      new_dir = d * nr + normal * (nr * cos_i - cos_t);
    }
    if (!outside)
      direct = direct * v3(expf(-obj_color.x * t_safe),
                           expf(-obj_color.y * t_safe),
                           expf(-obj_color.z * t_safe));
  }
  // PHONG: the lobe sample, 8 retries below the surface, then the mirror;
  // every slot draws all 18 uniforms
  bool ok = !is_phong;
  V3 cur = w_refl;
  V3 pu = w_refl, pv = w_refl;
  if (is_phong) onb(w_refl, pu, pv);
#pragma unroll 1
  for (int k = 0; k < 9; ++k) {
    const float phi_u = random_float(seed);
    const float r2 = random_float(seed);
    if (ok) continue;
    const float phi = TWO_PI_F * phi_u;
    const float ct = powf(clamp_min(1.0f - r2, 0.0f), PHONG_INV_E1);
    const float st = sqrtf(clamp_min(1.0f - ct * ct, 0.0f));
    const V3 cand = normalize((pu * (cosf(phi) * st) + pv * (sinf(phi) * st)) +
                              w_refl * ct);
    if (dot(cand, normal) > c.eps) {
      cur = cand;
      ok = true;
    }
  }
  if (is_phong) new_dir = cur;
  if (ggx) {
    // the VNDF half-vector from its side stream; the reflected direction
    // weighs F(h.v) G1(n.l), 0 at or below the horizon
    uint32_t gs = side_stream(pre, KEY_GGX);
    const float gu1 = random_float(gs);
    const float gu2 = random_float(gs);
    const V3 view = -d;
    const V3 h = ggx_vndf(view, normal, ggx_a, gu1, gu2);
    new_dir = reflect(d, h);
    const float g_nl = dot(normal, new_dir);
    const V3 g_f = schlick(obj_color, clamp_min(dot(h, view), 0.0f));
    direct = direct * (g_nl > c.eps ? g_f * ggx_g1(g_nl, ggx_a)
                                    : v3(0.0f, 0.0f, 0.0f));
  }
  const bool pass = TEX && is_pass;
  const bool new_ls = pass ? ls : (is_spec || (is_refr && refr_reflects));
  const V3 zero = v3(0.0f, 0.0f, 0.0f);
  V3 origin_out =
      (o + (is_refr && !refr_reflects ? normal * c.neg2eps : zero)) +
      (is_phong ? w_refl * c.eps : zero);
  if (TEX) origin_out = origin_out + (pass ? normal * c.neg2eps : zero);

  // Russian roulette
  const float p =
      clamp_max(fmaxf(fmaxf(direct.x, direct.y), direct.z), 1.0f);
  const float rr = random_float(seed);
  const bool survive =
      hit && bnc < c.max_bounces && p > c.eps && rr <= p;
  const V3 direct_out = survive ? direct / clamp_min(p, 1e-20f) : direct;

  // a miss: the sky, with the sun disc on specular-born paths
  if (!hit) {
    const Atmos a = atmosphere(c, d, sun, mie, true);
    V3 miss;
    if (ls) {
      const float tq = clamp((a.cvs - c.cos_sun) * c.inv_disc, 0.0f, 1.0f);
      const float disk = (tq * tq) * (3.0f - 2.0f * tq);
      const V3 disc = ((a.fex * (a.sun_e * 19000.0f)) * disk) * 1e-5f;
      miss = (disc + a.sky) * 0.01f;
    } else {
      miss = a.sky * c.sky_k;
    }
    color = color + dir_in * miss;
  }

  st3(color_out, i, color);
  survive_out[i] = survive;
  st3(n_origin, i, origin_out);
  st3(n_dir, i, new_dir);
  st3(n_direct, i, direct_out);
  n_bounces[i] = bnc + 1;
  n_last_spec[i] = new_ls;
}

}  // namespace
