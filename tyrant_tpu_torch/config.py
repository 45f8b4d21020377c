"""Render configuration: constants and the three config dataclasses.

The port's own copy of the JAX package's configuration.  Field names,
order, defaults and the validation in ``RenderConfig.__post_init__`` are
the same, so one set of settings means the same render in both packages.
The port implements every field; the JAX package's TPU kernel selectors
(``use_packet_kernel``, ``use_accum_kernel``, ``adaptive_connect``,
``adaptive_connect_frac``) are accepted and have no effect.
"""

from __future__ import annotations

import dataclasses
import math

PI = 3.1415926535897932
INV_PI = 1.0 / PI

EPSILON = 1e-3    # ray offset and hit-accept margin
VERY_FAR = 1e20   # "no hit" distance


@dataclasses.dataclass(frozen=True)
class SkyConfig:
    """Atmosphere tunables of the analytic sun/sky model."""

    sun_size_degrees: float = 1.5
    cutoff_angle: float = PI / 1.95
    steepness: float = 1.5
    sky_factor: float = 1.0
    turbidity: float = 1.0
    mie_coefficient: float = 0.005
    mie_directional_g: float = 0.80
    v: float = 4.0                         # Junge exponent
    rayleigh_zenith_length: float = 8.4e3
    mie_zenith_length: float = 1.25e3
    sun_intensity: float = 1000.0
    primary_wavelengths: tuple = (680e-9, 550e-9, 450e-9)


@dataclasses.dataclass(frozen=True)
class BVHConfig:
    """Binned-SAH builder knobs.  Six primitives a leaf fill the fat rows
    of the traversal table (2 children x 6 triangles x 9 floats + tags =
    125 of 128 lanes)."""

    bucket_number: int = 14
    max_prims_per_leaf: int = 6
    traversal_cost: float = 4.0
    intersection_cost: float = 1.0


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Top-level render settings (the JAX package's fields, in its
    order)."""

    width: int = 1920
    height: int = 1080
    # path segments processed per wavefront step (the ray queue size)
    num_rays: int = 2 * 1_048_576
    max_bounces: int = 5
    epsilon: float = EPSILON
    sky: SkyConfig = dataclasses.field(default_factory=SkyConfig)
    bvh: BVHConfig = dataclasses.field(default_factory=BVHConfig)
    # scale of the focal-distance slider
    focal_distance_scale: float = 3.0
    # pixel-visit order for raygen: "scan" or "tiled8" (8x8 screen tiles,
    # so consecutive rays form coherent packets)
    raygen_order: str = "tiled8"
    # kernel selectors of the JAX package; on the port CUDA tensors always
    # take the kernels and CPU tensors the plain versions
    use_packet_kernel: str = "auto"
    use_accum_kernel: str = "auto"
    # traversal-kernel generation: "mono" (one ray per thread), "wave"
    # (32-ray warp packets with one shared stack; "wave-unsafe" is its
    # deprecated spelling) or "auto" (mono on every stage in the port)
    packet_kernel_mode: str = "auto"
    adaptive_connect: str = "off"
    adaptive_connect_frac: float = 0.45
    use_kernel_normals: str = "off"
    fuse_step_chains: str = "auto"
    # adaptive sampling: raygen budget follows per-pixel variance
    adaptive_sampling: str = "off"
    adaptive_interval: int = 16
    adaptive_gamma: float = 1.0
    # tone map of the display resolve: "reinhard" or "aces"; exposure
    # scales radiance before the curve
    tonemap: str = "reinhard"
    exposure: float = 1.0
    # display-only bloom: bright pass above bloom_threshold, separable
    # gaussian of pixel radius bloom_radius, added back x strength (0 = off)
    bloom_strength: float = 0.0
    bloom_threshold: float = 1.0
    bloom_radius: int = 12
    # crop window (x0, y0, w, h); None = full frame
    crop: tuple | None = None
    # edge-aware à-trous denoiser on the displayed image, guided by one
    # noise-free AOV pass per pose; the accumulation buffer is untouched
    denoise: str = "off"
    denoise_iterations: int = 4
    texture_filter: str = "bilinear"
    # per-contribution radiance clamp (0 = off)
    radiance_clamp: float = 0.0
    # multiple importance sampling between NEE and BSDF sampling
    mis: str = "off"
    sampler: str = "xorshift"
    light_sampling: str = "uniform"
    # run decorrelation seed (0 = the fixed streams)
    seed: int = 0
    track_variance: str = "off"
    # volumetric fog slab
    fog: str = "off"
    fog_sigma_s: float = 0.02
    projection: str = "perspective"
    fisheye_fov_degrees: float = 180.0
    ortho_height: float = 10.0
    motion_blur: float = 0.0
    fog_sigma_a: float = 0.0
    fog_g: float = 0.0
    fog_z_min: float = -1e8
    fog_z_max: float = 1e8
    bokeh_blades: int = 0
    bokeh_rotation: float = 0.0
    dispersion: float = 0.0
    fog_falloff: float = 0.0

    def __post_init__(self):
        if self.packet_kernel_mode not in ("auto", "mono", "wave",
                                           "wave-unsafe"):
            raise ValueError(
                f"unknown packet_kernel_mode {self.packet_kernel_mode!r}; "
                f"expected 'auto', 'mono' or 'wave'")
        if not (0.0 <= self.adaptive_connect_frac <= 1.0):
            raise ValueError(
                f"adaptive_connect_frac={self.adaptive_connect_frac} "
                "must be a carried FRACTION in [0, 1] (e.g. 0.45) — "
                "values above 1 silently disarm the adaptive pick")
        for field, allowed in (
                ("use_packet_kernel", ("auto", "on", "off")),
                ("use_accum_kernel", ("auto", "on", "off")),
                ("use_kernel_normals", ("on", "off")),
                ("fuse_step_chains", ("auto", "on", "off")),
                ("texture_filter", ("bilinear", "nearest", "trilinear")),
                ("tonemap", ("reinhard", "aces")),
                ("denoise", ("on", "off")),
                ("adaptive_sampling", ("on", "off")),
                ("adaptive_connect", ("auto", "off")),
                ("mis", ("on", "off")),
                ("sampler", ("xorshift", "sobol")),
                ("light_sampling", ("uniform", "power")),
                ("track_variance", ("on", "off")),
                ("projection", ("perspective", "fisheye", "equirect",
                                "ortho")),
                ("fog", ("on", "off"))):
            v = getattr(self, field)
            if v not in allowed:
                raise ValueError(f"unknown {field} {v!r}; expected one of "
                                 f"{allowed}")
        if self.sampler == "sobol" and self.adaptive_sampling == "on":
            raise ValueError(
                "sampler='sobol' requires adaptive_sampling='off': the "
                "low-discrepancy sample index assumes round-robin pixel "
                "visits, which the adaptive priority permutation repeats")
        if not 0 <= int(self.seed) < (1 << 31):
            raise ValueError("seed must be a non-negative 31-bit int")
        if self.fog_sigma_s < 0.0 or self.fog_sigma_a < 0.0:
            raise ValueError("fog coefficients must be >= 0")
        if not -0.999 <= self.fog_g <= 0.999:
            raise ValueError("fog_g must be in [-0.999, 0.999]")
        if self.fog_z_min >= self.fog_z_max:
            raise ValueError("fog_z_min must be < fog_z_max")
        if not math.isfinite(self.fog_falloff):
            raise ValueError("fog_falloff must be finite")
        # the exponential height fog clamps its density exponent to +-60
        # (the f32 edge of exp), so the dense end of the slab must stay
        # inside that range
        if self.fog == "on" and self.fog_falloff > 0 \
                and self.fog_falloff * max(0.0, -self.fog_z_min) > 60.0:
            raise ValueError(
                f"fog_falloff * |fog_z_min| = "
                f"{self.fog_falloff * -self.fog_z_min:.0f} exceeds the "
                f"exponent clamp (60): density exp(-falloff*z) at the slab "
                f"floor is outside f32 range and the closed-form optical "
                f"depth would silently saturate — raise fog_z_min (e.g. "
                f"ground level) or lower fog_falloff")
        if self.fog == "on" and self.fog_falloff < 0 \
                and -self.fog_falloff * max(0.0, self.fog_z_max) > 60.0:
            raise ValueError(
                f"|fog_falloff| * fog_z_max = "
                f"{-self.fog_falloff * self.fog_z_max:.0f} exceeds the "
                f"exponent clamp (60): density at the slab ceiling is "
                f"outside f32 range — lower fog_z_max or |fog_falloff|")
        if self.bokeh_blades != 0 and self.bokeh_blades < 3:
            raise ValueError("bokeh_blades must be 0 (disk) or >= 3")
        if not 0.0 <= self.dispersion <= 0.5:
            raise ValueError("dispersion must be in [0, 0.5] (fractional "
                             "per-channel IOR spread)")
        if not 0.0 < self.fisheye_fov_degrees <= 360.0:
            raise ValueError("fisheye_fov_degrees must be in (0, 360]")
        if self.ortho_height <= 0.0:
            raise ValueError("ortho_height must be > 0")
        if not 0.0 <= self.motion_blur <= 1.0:
            raise ValueError("motion_blur must be in [0, 1]")
        if self.adaptive_interval < 1:
            raise ValueError("adaptive_interval must be >= 1")
        if self.adaptive_gamma < 0.0:
            raise ValueError("adaptive_gamma must be >= 0.0 "
                             "(0 = uniform allocation)")

    @property
    def num_pixels(self) -> int:
        return self.width * self.height


def small_config(width: int = 512, height: int = 512, num_rays: int = 1 << 16,
                 max_bounces: int = 5, **kw) -> RenderConfig:
    """A test-sized config.  Extra keyword arguments pass through to
    :class:`RenderConfig`."""
    return RenderConfig(width=width, height=height, num_rays=num_rays,
                        max_bounces=max_bounces, **kw)


def interactive_config(width: int = 1920, height: int = 1080,
                       num_rays: int = 1 << 17, **kw) -> RenderConfig:
    """The interactive fly-through preset of the JAX package: a 128k ray
    queue (the camera moves every frame, so each frame is fresh coherent
    primaries) with its kernel selectors.  Extra keyword arguments pass
    through to :class:`RenderConfig`."""
    kw.setdefault("use_kernel_normals", "on")
    kw.setdefault("use_packet_kernel", "on")
    kw.setdefault("fuse_step_chains", "auto")
    kw.setdefault("max_bounces", 5)
    return RenderConfig(width=width, height=height, num_rays=num_rays,
                        **kw)
