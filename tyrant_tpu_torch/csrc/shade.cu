// The shade stage of the render step (render.py:_shade) in one launch, on
// the base feature set: sphere materials DIFF, SPEC, REFR, PHONG and LIGHT,
// triangles from the tri_shade rows or, on a scene of default-material
// triangles, from the traversal's hit normals; at most one emissive sphere
// plus the sun, the analytic sky, the xorshift streams, no MIS.  The
// textured feature set takes csrc/shade_textured.cu; every other
// configuration takes the plain PyTorch body (render.py:_shade_plain).  The
// body both run once the hit surface is known (shade_tail) and its helpers
// are in shade_common.cuh.
//
// Replaces: no TPU kernel.  The JAX package leaves shade to XLA's fusion
// (tyrant_tpu/render.py::_shade); the port's plain body is a chain of some
// hundreds of elementwise, gather and reduce launches over the whole queue,
// each writing its result to device memory for the next to read back.
//
// What bounds it on an H100: memory bandwidth.  A slot reads about 54 bytes
// (origin, direction, throughput, pixel, bounces, last_specular, t, id, the
// triangle flag) plus a 32-byte tri_shade row on a triangle hit or a miss
// (12 bytes of hit normal instead in the normals variant) and writes about
// 95 (colour, survive, the next ray's origin, direction, throughput,
// bounces and last_specular, the shadow ray's origin, direction, colour,
// max distance and valid flag).  The arithmetic, a few hundred to about
// 1,500 float operations a slot (sky and sun, the NEE samples, the BSDF
// bounce with PHONG's rejection loop, the xorshift hashes), is far below
// the card's float32 rate.
//
// What the design does about it: one thread a queue slot; every
// intermediate stays in registers, so each input is read once and each
// output written once, straight into the tensors connect and sort read.
// The sphere table (a few 48-byte rows), the sun direction, the Mie
// coefficients and the frame counter are read through the read-only path
// (the sun and the frame change between replays of a captured graph, so
// they are read from device memory, not passed by value); the sky's and
// the config's scalars come by value.
//
// Exactness: the arithmetic repeats the plain body's float32 operations in
// its order: IEEE division and square root, the same library functions
// (expf, powf, sinf, cosf, acosf), no contraction (--fmad=false).  Where a
// PyTorch CUDA op rounds its own way this follows it: a three-term dot is
// PyTorch's reduction, ((0 + p0) + (0 + p2)) + (0 + p1); a division by a
// Python scalar is a multiply by the scalar's float32 reciprocal; a Python
// scalar over a tensor is the tensor's reciprocal times the scalar; and
// torch.linalg.cross contracts each component into one FMA.
// The xorshift streams are uint32 in registers: the same hash (fold, the
// Wang rounds, the 0x1337C0DE nudge) and the same steps in the same order
// as ops/rng.py, so every draw is bit-equal.  The outputs equal the plain
// body's on every slot the step reads: colour, survive and the next ray
// everywhere, the shadow ray where it is valid; an invalid shadow ray's
// colour is 0 (the plain body's is never read).
#include "shade_common.cuh"

namespace {

template <bool KN>
__global__ void __launch_bounds__(BLOCK)
shade_kernel(const float* __restrict__ origin,
             const float* __restrict__ direction,
             const float* __restrict__ direct_in,
             const int* __restrict__ pixel, const int* __restrict__ bounces,
             const uint8_t* __restrict__ last_spec,
             const float* __restrict__ tt, const int* __restrict__ ident,
             const uint8_t* __restrict__ is_tri_in,
             const float* __restrict__ tri_normal,
             const float* __restrict__ tri_shade,
             const float* __restrict__ spheres,
             const float* __restrict__ sun_dir,
             const float* __restrict__ total_mie,
             const long long* __restrict__ frame, const ShadeConsts c,
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
  const int id = __ldg(ident + i);
  const bool is_tri = __ldg(is_tri_in + i) != 0;
  const bool hit = t < c.very_far;
  const float t_safe = hit ? t : 0.0f;
  V3 o = ld3(origin, i) + d * t_safe;

  // the hit surface: the sphere row, the triangle's normal and material
  const int sid = min(max(id, 0), c.n_sphere_rows - 1);
  const bool is_sphere = hit && !is_tri;
  const V3 s_ctr = v3(srow(spheres, sid, 0), srow(spheres, sid, 1),
                      srow(spheres, sid, 2));
  V3 normal;
  int refl;
  V3 obj_color;
  if (is_sphere) {
    normal = (o - s_ctr) / srow(spheres, sid, 3);
    refl = (int)srow(spheres, sid, 10);
    obj_color = v3(srow(spheres, sid, 4), srow(spheres, sid, 5),
                   srow(spheres, sid, 6));
  } else if (KN) {
    const V3 tn = ld3(tri_normal, i);
    const float nlen = sqrtf(clamp_min(dot(tn, tn), 1e-30f));
    normal = tn / clamp_min(nlen, 1e-30f);
    refl = DIFF;
    obj_color = v3(1.0f, 1.0f, 1.0f);
  } else {
    const int tid = min(max(id, 0), c.n_tri_rows - 1);
    const float4* row = reinterpret_cast<const float4*>(tri_shade) + 2 * tid;
    const float4 r0 = __ldg(row), r1 = __ldg(row + 1);
    normal = v3(r0.x, r0.y, r0.z);
    refl = (int)r0.w;
    obj_color = v3(r1.x, r1.y, r1.z);
  }
  if (!hit) refl = DIFF;
  const bool mul_mask = hit && refl != REFR && refl != LIGHT;
  V3 direct = mul_mask ? dir_in * obj_color : dir_in;
  const bool outside = dot(normal, d) < 0.0f;
  if (!outside) normal = -normal;
  o = o + normal * c.eps;

  // emitter hits, no MIS: collected on specular-born paths
  const bool is_light = hit && refl == LIGHT;
  V3 color = v3(0.0f, 0.0f, 0.0f);
  if (is_light && ls)
    color = direct * v3(srow(spheres, sid, 7), srow(spheres, sid, 8),
                        srow(spheres, sid, 9));
  if (is_light && !ls) direct = v3(0.0f, 0.0f, 0.0f);

  shade_tail<false>(c, i, spheres, sun_dir, total_mie, frame, d, dir_in, pix,
                    bnc, ls, hit, t_safe, o, normal, outside, refl, obj_color,
                    direct, color, false, false, 0.0f, color_out, survive_out,
                    n_origin, n_dir, n_direct, n_bounces, n_last_spec,
                    s_origin, s_dir, s_color, s_maxd, s_valid);
}

}  // namespace

// Shade n queue slots: the inputs as render.py:_shade takes them (bool
// tensors as bytes), tri_normal [n, 3] for the normals variant (else null,
// and tri_shade's rows are read), sun_dir [3] and total_mie [3] f32 and
// frame (int64) on the device; the outputs' buffers as the plain body
// returns them.  Launches on `stream`; returns cudaGetLastError().
extern "C" int tyrant_shade(
    const float* origin, const float* direction, const float* direct,
    const int* pixel, const int* bounces, const uint8_t* last_spec,
    const float* t, const int* ident, const uint8_t* is_tri,
    const float* tri_normal, const float* tri_shade, const float* spheres,
    const float* sun_dir, const float* total_mie, const long long* frame,
    const ShadeConsts* consts, float* color, uint8_t* survive,
    float* n_origin, float* n_dir, float* n_direct, int* n_bounces,
    uint8_t* n_last_spec, float* s_origin, float* s_dir, float* s_color,
    float* s_maxd, uint8_t* s_valid, void* stream) {
  const ShadeConsts c = *consts;
  if (c.n <= 0) return 0;
  const int grid = (c.n + BLOCK - 1) / BLOCK;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tri_normal)
    shade_kernel<true><<<grid, BLOCK, 0, s>>>(
        origin, direction, direct, pixel, bounces, last_spec, t, ident, is_tri,
        tri_normal, tri_shade, spheres, sun_dir, total_mie, frame, c, color,
        survive, n_origin, n_dir, n_direct, n_bounces, n_last_spec, s_origin,
        s_dir, s_color, s_maxd, s_valid);
  else
    shade_kernel<false><<<grid, BLOCK, 0, s>>>(
        origin, direction, direct, pixel, bounces, last_spec, t, ident, is_tri,
        tri_normal, tri_shade, spheres, sun_dir, total_mie, frame, c, color,
        survive, n_origin, n_dir, n_direct, n_bounces, n_last_spec, s_origin,
        s_dir, s_color, s_maxd, s_valid);
  return (int)cudaGetLastError();
}
