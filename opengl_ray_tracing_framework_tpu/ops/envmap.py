"""HDR environment map sampling and evaluation.

jnp reimplementation of the reference's environment lighting
(src/shaders/fragment_shader_ray_tracing.glsl):

- direction -> equirectangular uv with envAngle rotation  (glsl:625-631)
- inverse-CDF cache lookup for light sampling             (glsl:635-646)
- radiance lookup                                          (glsl:1165-1169)
- pdf with solid-angle Jacobian                            (glsl:1173-1186)
- gradient "default sky"                                   (glsl:1190-1193)

The importance-sampling cache itself is precomputed on the host
(models.hdr.build_hdr_cache, the analogue of Utility.h:33-131): an (H, W, 3)
array whose R,G channels hold the inverse-CDF sample position for stratified
(xi_1, xi_2) and whose B channel holds the discrete pdf.
"""

from __future__ import annotations

import jax.numpy as jnp

from .microfacet import PI, TWO_PI


def bilinear_lookup(tex, u, v):
    """GL-style bilinear texture fetch: wrap in u, clamp in v.

    tex: (H, W, C); u, v: (...,) in [0, 1) texture coords (v=0 is row 0).
    Texel centers sit at (i + 0.5) / size, matching GL_LINEAR.
    """
    h, w = tex.shape[0], tex.shape[1]
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0 = x0.astype(jnp.int32)
    y0 = y0.astype(jnp.int32)
    x1 = x0 + 1
    y1 = y0 + 1
    x0 = jnp.mod(x0, w)
    x1 = jnp.mod(x1, w)
    y0 = jnp.clip(y0, 0, h - 1)
    y1 = jnp.clip(y1, 0, h - 1)
    t00 = tex[y0, x0]
    t01 = tex[y0, x1]
    t10 = tex[y1, x0]
    t11 = tex[y1, x1]
    top = t00 + fx * (t01 - t00)
    bot = t10 + fx * (t11 - t10)
    return top + fy * (bot - top)


def to_spherical_uv(v, env_angle):
    """Direction -> equirect uv, rotated by env_angle in u (glsl:625-631).

    v must be normalized; returns u (possibly > 1, callers wrap) and
    v in [0, 1] with v=0 at +y (the reference flips y).
    """
    u = jnp.arctan2(v[..., 2], v[..., 0]) / TWO_PI + 0.5 + env_angle
    vv = 1.0 - (jnp.arcsin(jnp.clip(v[..., 1], -1.0, 1.0)) / PI + 0.5)
    return u, vv


def hdr_color(hdr_map, direction, env_angle):
    """Environment radiance along `direction` (glsl:1165-1169)."""
    u, v = to_spherical_uv(direction, env_angle)
    return bilinear_lookup(hdr_map, jnp.mod(u, 1.0), v)


def sample_hdr_direction(hdr_cache, xi_1, xi_2):
    """Draw a light direction from the precomputed inverse-CDF cache
    (SampleHdr, glsl:635-646). Returns unit world direction."""
    xy = bilinear_lookup(hdr_cache, xi_1, xi_2)
    x = xy[..., 0]
    y = 1.0 - xy[..., 1]
    phi = TWO_PI * (x - 0.5)
    theta = PI * (y - 0.5)
    cos_t = jnp.cos(theta)
    return jnp.stack(
        [cos_t * jnp.cos(phi), jnp.sin(theta), cos_t * jnp.sin(phi)], axis=-1)


def hdr_pdf(hdr_cache, direction, env_angle, hdr_width, hdr_height):
    """Solid-angle pdf of the cache sampler along `direction`
    (hdrPdf, glsl:1173-1186).

    The reference computes the image->solid-angle conversion as
    hdrResolution^2 / 2 which equals width * height only for 2:1
    equirectangular maps; we use width * height (identical for the
    reference's assets, correct for any aspect).
    """
    u, v = to_spherical_uv(direction, env_angle)
    pdf_img = bilinear_lookup(hdr_cache, jnp.mod(u, 1.0), v)[..., 2]
    theta = PI * v
    sin_theta = jnp.maximum(jnp.sin(theta), 1e-10)
    p_convert = (hdr_width * hdr_height) / (TWO_PI * PI * sin_theta)
    return pdf_img * p_convert


# ---------------------------------------------------------------------------
# Fused nearest-texel fetch paths for the wavefront hot loop.
#
# The in-loop environment accesses are restructured as ONE row gather per
# site from the fused (H*W, 16) table SceneData.env_fetch (columns:
# models.hdr.build_env_fetch) with nearest filtering. The texel index is
# the major axis, so each fetch reads one contiguous row. NEE needs a
# single gather: the sample row carries position, pdf AND radiance
# (the reference samples with GL bilinear; nearest is a documented deviation
# worth ~3x fewer fetched elements, invisible at 1k+ HDR resolutions).
# ---------------------------------------------------------------------------


def _texel_index(u, v, h, w):
    x = jnp.clip((jnp.mod(u, 1.0) * w).astype(jnp.int32), 0, w - 1)
    y = jnp.clip((v * h).astype(jnp.int32), 0, h - 1)
    return y * w + x


def env_sample_nearest(env_fetch, h, w, xi_1, xi_2, env_angle):
    """NEE light sample from the inverse-CDF cache: ONE row gather.

    Returns (direction, pdf_solid_angle, radiance). Columns 6-9 are the
    pdf and radiance of the *sampled* texel (precomputed at build time,
    hdr.build_env_fetch), so sample, pdf and radiance always belong to the
    same pixel — the reference fetches them with three texture lookups
    (SampleHdr + hdrPdf + hdrColor, glsl:1382-1390). The returned
    direction is rotated by env_angle so the sampling distribution tracks
    the rotated radiance lookup (hdr_color/env_radiance_nearest add
    env_angle in u; the reference instead rotates only the pdf lookup — a
    documented inconsistency we do not reproduce)."""
    idx = _texel_index(xi_1, xi_2, h, w)
    g = env_fetch[idx]                            # (R, 16) row gather
    x, y, pdf_img = g[..., 4], g[..., 5], g[..., 6]
    yy = 1.0 - y
    # radiance lookups add env_angle to u, so emitting the direction whose
    # u_dir = x - env_angle makes lookups land on the sampled texel
    phi = TWO_PI * (x - env_angle - 0.5)
    theta = PI * (yy - 0.5)
    cos_t = jnp.cos(theta)
    direction = jnp.stack(
        [cos_t * jnp.cos(phi), jnp.sin(theta), cos_t * jnp.sin(phi)],
        axis=-1)
    sin_col = jnp.maximum(jnp.sin(PI * y), 1e-10)
    pdf = pdf_img * (w * h) / (TWO_PI * PI * sin_col)
    return direction, pdf, g[..., 7:10]


def env_radiance_nearest(env_fetch, h, w, direction, env_angle):
    """Environment radiance along `direction`: one 3-row gather."""
    u, v = to_spherical_uv(direction, env_angle)
    idx = _texel_index(u, v, h, w)
    return env_fetch[idx][..., 0:3]               # (R, 16) row gather


def env_radiance_pdf_nearest(env_fetch, h, w, direction, env_angle):
    """Radiance + solid-angle pdf along `direction` (the bounce-miss MIS
    site, glsl:1483-1506): one 4-row gather."""
    u, v = to_spherical_uv(direction, env_angle)
    idx = _texel_index(u, v, h, w)
    g = env_fetch[idx]                            # (R, 16) row gather
    rgb = g[..., 0:3]
    sin_theta = jnp.maximum(jnp.sin(PI * v), 1e-10)
    pdf = g[..., 3] * (w * h) / (TWO_PI * PI * sin_theta)
    return rgb, pdf


def default_sky_color(dir_y):
    """White-to-blue gradient fallback sky (glsl:1190-1193)."""
    t = 0.5 * (dir_y + 1.0)
    white = jnp.array([1.0, 1.0, 1.0], jnp.float32)
    blue = jnp.array([0.5, 0.7, 1.0], jnp.float32)
    return (1.0 - t)[..., None] * white + t[..., None] * blue
