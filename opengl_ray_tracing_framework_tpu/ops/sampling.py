"""Random number generation and importance-sampling primitives.

Redesign of the reference's RNG/QMC stack
(src/shaders/fragment_shader_ray_tracing.glsl):

- The reference seeds a *stateful* per-pixel Wang-hash chain from a per-frame
  CPU random uniform (glsl:573-586, 1520) and draws a per-frame Sobol point
  from an 8x32 direction-number table with per-pixel Cranley-Patterson
  rotation (glsl:590-620, 772-785). Stateful chains don't vectorize or
  checkpoint cleanly, so here every uniform is *counter-based*: a stateless
  mix of (pixel_id, frame, salt). Deterministic per pixel x sample x call
  site, order-independent, resume-safe.
- Sobol direction numbers are computed from Joe-Kuo primitive-polynomial
  data for 8 dimensions (the table the reference embeds is the same standard
  data); dimensions (2b, 2b+1) drive bounce b. For b >= 4 the reference
  indexes out of its 8-dim table (undefined in GLSL); we instead *pad*: reuse
  dims (2b mod 8, 2b+1 mod 8), which stays unbiased because every bounce gets
  an independent per-pixel Cranley-Patterson shift (standard padded-QMC).
- Direction samplers: cosine hemisphere (glsl:650-685), uniform sphere
  (glsl:687-693), GTR1/GTR2 half-vector sampling (glsl:697-749), Heitz VNDF
  GGX (glsl:751-769), Henyey-Greenstein (glsl:1195-1222).
"""

from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp

from .microfacet import PI, TWO_PI, INV_4_PI, safe_sqrt, sqr

# ---------------------------------------------------------------------------
# Counter-based uniforms
# ---------------------------------------------------------------------------

_U32 = np.uint32
_INV_U32 = np.float32(1.0 / 4294967296.0)


def mix32(x):
    """Low-bias 32-bit integer mixer (splitmix32 finalizer). x: uint32."""
    x = jnp.asarray(x, jnp.uint32)
    x = x ^ (x >> 16)
    x = x * _U32(0x7FEB352D)
    x = x ^ (x >> 15)
    x = x * _U32(0x846CA68B)
    x = x ^ (x >> 16)
    return x


def rand01(pixel_id, frame, salt):
    """Stateless uniform in [0, 1) for (pixel, frame, call-site) triples.

    Replaces the reference's per-pixel Wang-hash chain (glsl:577-586): same
    statistical role, but counter-based so the whole image is one vectorized
    expression and any pixel/sample can be recomputed independently.
    """
    pixel_id = jnp.asarray(pixel_id, jnp.uint32)
    frame = jnp.asarray(frame, jnp.uint32)
    salt = jnp.asarray(salt, jnp.uint32)
    h = mix32(pixel_id + mix32(frame + mix32(salt + _U32(0x9E3779B9))))
    return h.astype(jnp.float32) * _INV_U32


# ---------------------------------------------------------------------------
# Sobol sequence (computed Joe-Kuo direction numbers, 8 dimensions)
# ---------------------------------------------------------------------------

# (s, a, [m_1..m_s]) for dimensions 2..8 of the standard Joe-Kuo table
# (dimension 1 is the van der Corput sequence). Dimensions 0-4 and 6 of the
# resulting table match the constants the reference embeds (glsl:590-592)
# bit-for-bit; the reference's rows 5 and 7 do not satisfy the Sobol
# direction-number recurrence for any primitive polynomial (nonstandard /
# likely corrupted upstream values), so for those two dimensions we keep the
# genuine Joe-Kuo numbers, which are valid Sobol dimensions with the intended
# equidistribution.
_JOE_KUO = [
    (1, 0, [1]),
    (2, 1, [1, 3]),
    (3, 1, [1, 3, 1]),
    (3, 2, [1, 1, 1]),
    (4, 1, [1, 1, 3, 3]),
    (4, 4, [1, 3, 5, 13]),
    (5, 2, [1, 1, 5, 5, 17]),
]

N_SOBOL_DIMS = 8
_SOBOL_BITS = 32


def _compute_sobol_table() -> np.ndarray:
    """(8, 32) uint32 direction numbers v_j = m_j << (32 - j)."""
    table = np.zeros((N_SOBOL_DIMS, _SOBOL_BITS), dtype=np.uint64)
    # Dimension 0: van der Corput, m_j = 1 for all j.
    for j in range(_SOBOL_BITS):
        table[0, j] = np.uint64(1) << np.uint64(31 - j)
    for d, (s, a, m_init) in enumerate(_JOE_KUO, start=1):
        m = list(m_init)
        for j in range(s, _SOBOL_BITS):
            # m_j = 2 a_1 m_{j-1} ^ ... ^ 2^{s-1} a_{s-1} m_{j-s+1}
            #       ^ 2^s m_{j-s} ^ m_{j-s}
            new = m[j - s] ^ (m[j - s] << s)
            for k in range(1, s):
                a_k = (a >> (s - 1 - k)) & 1
                if a_k:
                    new ^= m[j - k] << k
            m.append(new)
        for j in range(_SOBOL_BITS):
            table[d, j] = np.uint64(m[j]) << np.uint64(31 - j)
    return table.astype(np.uint32)


SOBOL_TABLE = _compute_sobol_table()


def _sobol_table_j():
    # Lazy device constant: a module-level jnp.asarray would initialize the
    # XLA backend at import time, which breaks jax.distributed.initialize
    # (it must run before any backend init — tests/distributed_worker.py).
    return jnp.asarray(SOBOL_TABLE)


def gray_code(i):
    """i ^ (i >> 1) (glsl:598)."""
    i = jnp.asarray(i, jnp.uint32)
    return i ^ (i >> 1)


def sobol_all_dims(index):
    """All 8 Sobol dimensions for integer sample `index` (Gray-code order).

    Returns (8,) float32 in [0, 1). `index` is typically the progressive
    frame counter, shared by all pixels (glsl:604-620) — per-pixel
    decorrelation comes from Cranley-Patterson rotation.
    """
    g = gray_code(index)
    bits = [(g >> _U32(j)) & _U32(1) for j in range(_SOBOL_BITS)]
    acc = jnp.zeros((N_SOBOL_DIMS,), jnp.uint32)
    for j in range(_SOBOL_BITS):
        acc = acc ^ jnp.where(bits[j] != 0, _sobol_table_j()[:, j], _U32(0))
    return acc.astype(jnp.float32) * _INV_U32


def sobol_bounce_uv(sobol_point, bounce):
    """(u, v) for bounce b from a precomputed 8-dim Sobol point.

    Dimensions (2b, 2b+1) like the reference (glsl:616-620); padded mod 8
    for b >= 4 (see module docstring).
    """
    d0 = (2 * bounce) % N_SOBOL_DIMS
    d1 = (2 * bounce + 1) % N_SOBOL_DIMS
    return sobol_point[d0], sobol_point[d1]


def cranley_patterson(u, shift):
    """Toroidal shift keeping u in [0, 1) (glsl:772-785)."""
    v = u + shift
    return v - jnp.floor(v)


# ---------------------------------------------------------------------------
# Orthonormal bases
# ---------------------------------------------------------------------------


def onb(n):
    """Tangent frame used by the BSDF path (getTangent, glsl:396-407).

    helper = (1,0,0) unless |N.x| > 0.999 then (0,0,1);
    B = normalize(N x helper); T = normalize(N x B).
    n: (..., 3) -> (tangent, bitangent).
    """
    cond = (jnp.abs(n[..., 0]) > 0.999)[..., None]
    helper = jnp.where(cond,
                       jnp.array([0.0, 0.0, 1.0], n.dtype),
                       jnp.array([1.0, 0.0, 0.0], n.dtype))
    b = _normalize(jnp.cross(n, helper))
    t = _normalize(jnp.cross(n, b))
    return t, b


def onb_hemi(n):
    """Frame used by toNormalHemisphere in the BRDF path (glsl:663-669):
    T = normalize(N x helper); B = normalize(N x T)."""
    cond = (jnp.abs(n[..., 0]) > 0.999)[..., None]
    helper = jnp.where(cond,
                       jnp.array([0.0, 0.0, 1.0], n.dtype),
                       jnp.array([1.0, 0.0, 0.0], n.dtype))
    t = _normalize(jnp.cross(n, helper))
    b = _normalize(jnp.cross(n, t))
    return t, b


def to_world(t, b, n, v):
    """Local (x=t, y=b, z=n) -> world (glsl:508-511)."""
    return v[..., 0:1] * t + v[..., 1:2] * b + v[..., 2:3] * n


def to_local(t, b, n, v):
    """World -> local (glsl:513-516)."""
    return jnp.stack([_dot(v, t), _dot(v, b), _dot(v, n)], axis=-1)


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def _normalize(v, eps=1e-12):
    return v * jax_rsqrt(jnp.maximum(_dot(v, v), eps))[..., None]


def jax_rsqrt(x):
    return 1.0 / jnp.sqrt(x)


# ---------------------------------------------------------------------------
# Direction samplers (all return local-frame vectors unless noted)
# ---------------------------------------------------------------------------


def cosine_sample_hemisphere(r1, r2):
    """Cosine-weighted hemisphere in local frame (glsl:650-659)."""
    r = safe_sqrt(r1)
    phi = TWO_PI * r2
    x = r * jnp.cos(phi)
    y = r * jnp.sin(phi)
    z = safe_sqrt(1.0 - x * x - y * y)
    return jnp.stack([x, y, z], axis=-1)


def sample_cosine_hemisphere_world(r1, r2, n):
    """Cosine hemisphere about world normal n (glsl:673-685)."""
    local = cosine_sample_hemisphere(r1, r2)
    t, b = onb_hemi(n)
    return to_world(t, b, n, local)


def uniform_sample_sphere(r1, r2):
    """Uniform sphere (glsl:687-693)."""
    z = 1.0 - 2.0 * r1
    r = safe_sqrt(1.0 - z * z)
    phi = TWO_PI * r2
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def sample_gtr1(roughness, r1, r2):
    """GTR1 half-vector in local frame.

    The reference's in-use overload (glsl:716-729) reuses r1 for both phi and
    cos_theta, which correlates the two angles; we use (r1 -> phi, r2 ->
    cos_theta) so the pdf the evaluator assumes (D * H.z / (4 V.H)) actually
    matches the sampler. Behavior-compatible fix, documented deviation.
    """
    a = jnp.maximum(0.001, roughness)
    a2 = a * a
    phi = r1 * TWO_PI
    cos_t = jnp.sqrt((1.0 - jnp.power(a2, 1.0 - r2)) / jnp.maximum(1.0 - a2, 1e-12))
    sin_t = jnp.clip(safe_sqrt(1.0 - cos_t * cos_t), 0.0, 1.0)
    return jnp.stack([sin_t * jnp.cos(phi), sin_t * jnp.sin(phi), cos_t], axis=-1)


def sample_gtr2_world(r1, r2, v, n, alpha):
    """GTR2 reflection direction about world normal (glsl:732-749).

    Samples half-vector H from the GGX NDF, projects to n's hemisphere and
    reflects v. Used by the legacy BRDF-mode sampler.
    """
    phi = TWO_PI * r1
    cos_t = jnp.sqrt((1.0 - r2) / (1.0 + (sqr(alpha) - 1.0) * r2))
    sin_t = safe_sqrt(1.0 - cos_t * cos_t)
    h_local = jnp.stack([sin_t * jnp.cos(phi), sin_t * jnp.sin(phi), cos_t], axis=-1)
    t, b = onb_hemi(n)
    h = to_world(t, b, n, h_local)
    return reflect(-v, h)


def sample_gtr1_world(r1, r2, v, n, alpha):
    """GTR1 reflection direction about world normal (glsl:697-714)."""
    phi = TWO_PI * r1
    a2 = sqr(alpha)
    cos_t = jnp.sqrt((1.0 - jnp.power(a2, 1.0 - r2)) / jnp.maximum(1.0 - a2, 1e-12))
    sin_t = safe_sqrt(1.0 - cos_t * cos_t)
    h_local = jnp.stack([sin_t * jnp.cos(phi), sin_t * jnp.sin(phi), cos_t], axis=-1)
    t, b = onb_hemi(n)
    h = to_world(t, b, n, h_local)
    return reflect(-v, h)


def sample_ggx_vndf(v_local, ax, ay, r1, r2):
    """Heitz visible-NDF GGX sampling in local frame (glsl:751-769)."""
    vx = ax * v_local[..., 0]
    vy = ay * v_local[..., 1]
    vz = v_local[..., 2]
    vh = jnp.stack([vx, vy, vz], axis=-1)
    vh = _normalize(vh)

    lensq = sqr(vh[..., 0]) + sqr(vh[..., 1])
    inv_len = jax_rsqrt(jnp.maximum(lensq, 1e-12))
    t1 = jnp.where(
        (lensq > 0.0)[..., None],
        jnp.stack([-vh[..., 1], vh[..., 0], jnp.zeros_like(vz)], axis=-1) * inv_len[..., None],
        jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0], vh.dtype), vh.shape),
    )
    t2 = jnp.cross(vh, t1)

    r = safe_sqrt(r1)
    phi = TWO_PI * r2
    p1 = r * jnp.cos(phi)
    p2 = r * jnp.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * safe_sqrt(1.0 - p1 * p1) + s * p2

    nh = (p1[..., None] * t1 + p2[..., None] * t2
          + safe_sqrt(1.0 - p1 * p1 - p2 * p2)[..., None] * vh)
    h = jnp.stack(
        [ax * nh[..., 0], ay * nh[..., 1], jnp.maximum(0.0, nh[..., 2])], axis=-1)
    return _normalize(h)


def sample_hg(v, g, r1, r2):
    """Henyey-Greenstein phase direction about world vector v (glsl:1195-1216)."""
    iso = jnp.abs(g) < 0.001
    g_safe = jnp.where(iso, 0.5, g)
    sqr_term = (1.0 - g_safe * g_safe) / (1.0 + g_safe - 2.0 * g_safe * r2)
    cos_aniso = -(1.0 + g_safe * g_safe - sqr_term * sqr_term) / (2.0 * g_safe)
    cos_t = jnp.where(iso, 1.0 - 2.0 * r2, cos_aniso)

    phi = r1 * TWO_PI
    sin_t = jnp.clip(safe_sqrt(1.0 - cos_t * cos_t), 0.0, 1.0)
    t, b = onb(v)
    return (sin_t[..., None] * jnp.cos(phi)[..., None] * t
            + sin_t[..., None] * jnp.sin(phi)[..., None] * b
            + cos_t[..., None] * v)


def phase_hg(cos_theta, g):
    """Henyey-Greenstein phase function (glsl:1218-1222)."""
    denom = 1.0 + g * g + 2.0 * g * cos_theta
    return INV_4_PI * (1.0 - g * g) / (denom * safe_sqrt(denom))


def reflect(incident, n):
    """GLSL reflect: i - 2 dot(n, i) n."""
    return incident - 2.0 * _dot(n, incident)[..., None] * n


def refract(incident, n, eta):
    """GLSL refract; returns zero vector on total internal reflection."""
    cos_i = -_dot(incident, n)
    k = 1.0 - sqr(eta) * (1.0 - sqr(cos_i))
    tir = k < 0.0
    refr = eta[..., None] * incident + (eta * cos_i - safe_sqrt(k))[..., None] * n
    return jnp.where(tir[..., None], 0.0, refr)
