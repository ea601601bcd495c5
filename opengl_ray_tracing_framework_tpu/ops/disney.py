"""Disney-principled BSDF: evaluation and sampling.

Branchless, batched jnp reimplementation of the reference's shading core
(src/shaders/fragment_shader_ray_tracing.glsl):

- lobe weights                    CalculateBSDFLobePdfs   glsl:537-550
- diffuse + sheen + subsurface    EvalDiffuse             glsl:925-948
- specular reflection (aniso GGX) EvalSpecReflection      glsl:950-964
- specular refraction             EvalSpecRefraction      glsl:966-984
- clearcoat (GTR1)                EvalClearcoat           glsl:986-1000
- combined eval                   DisneyEval              glsl:1002-1067
- combined sample                 DisneySample            glsl:1070-1161
- legacy 3-lobe BRDF mode         BRDF_Evaluate/SampleBRDF glsl:789-921

The SIMT kernel branches per fragment on the chosen lobe; the batched
integrator evaluates every lobe for every ray and selects — ~3x the FLOPs
of one lobe, but one fused elementwise program with no divergence.
All selects use safe denominators so unselected lanes carry no NaN/Inf
(this keeps reverse-mode gradients clean through jnp.where).

Documented deviations from the reference (defects not reproduced):
- DisneySample's reflect/refract Fresnel uses dot(L,H) with L *uninitialized*
  in GLSL (glsl:1137); we use dot(V,H) (== dot(L,H) for the reflect case),
  the evident intent.
- The clearcoat half-vector sampler reuses r1 for both phi and cos_theta
  (glsl:716-729); ops.sampling.sample_gtr1 decorrelates them.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .microfacet import (
    INV_PI,
    disney_fresnel,
    dielectric_fresnel,
    gtr1,
    gtr2,
    gtr2_aniso,
    luminance,
    mix,
    safe_sqrt,
    schlick_fresnel,
    smith_g_ggx,
    smith_g_ggx_aniso,
    spec_and_sheen_color,
    sqr,
    calculate_tint,
)
from .sampling import (
    cosine_sample_hemisphere,
    onb,
    onb_hemi,
    reflect,
    refract,
    sample_ggx_vndf,
    sample_gtr1,
    sample_gtr1_world,
    sample_gtr2_world,
    sample_cosine_hemisphere_world,
    to_local,
    to_world,
    _dot,
    _normalize,
)

_EPS = 1e-10

# Grazing-angle cutoff (cosine) and half-vector-Jacobian cutoff below which a
# lobe is treated as zero. The reference kernel evaluates these singular
# configurations raw and eats the resulting fireflies per-pixel (glsl:950-984);
# under reverse-mode AD the same lanes produce cotangents ~1/eps^2 that
# overflow f32 and poison every material gradient (round-3 repro: NaN at
# 256x256x8). Cutting the measure-zero sliver |cos| < 1e-4 is invisible in the
# image and keeps both primal and cotangents bounded.
_COS_EPS = 1e-4
_DENOM_EPS = 1e-3


def _mask1(ok, x, sub=1.0):
    """Substitute `sub` on masked-off lanes BEFORE x enters a division.

    jnp.where AFTER a division only fixes the primal: the unselected branch
    still contributes `0 * inf = NaN` partials in reverse mode. Substituting
    the *input* keeps every intermediate (and its cotangent) finite."""
    return jnp.where(ok, x, sub)


class BsdfSample(NamedTuple):
    f: jnp.ndarray            # bsdf * |cos| (..., 3)
    direction: jnp.ndarray    # world-space sampled direction (..., 3)
    pdf: jnp.ndarray          # (...,)
    is_refract: jnp.ndarray   # bool (...,)


def lobe_weights(mat, eta, spec_col, approx_fresnel):
    """Radiance-based lobe selection weights (glsl:537-550)."""
    lum_base = luminance(mat.base_color)
    one_m_metal = 1.0 - mat.metallic
    r_diffuse = one_m_metal * (1.0 - mat.transmission) * lum_base
    r_specular = luminance(
        spec_col + approx_fresnel[..., None] * (1.0 - spec_col))
    r_clearcoat = one_m_metal * 0.25 * mat.clearcoat
    r_refract = one_m_metal * mat.transmission * lum_base * (1.0 - approx_fresnel)
    inv_sum = 1.0 / jnp.maximum(
        r_diffuse + r_specular + r_clearcoat + r_refract, _EPS)
    return (r_diffuse * inv_sum, r_specular * inv_sum,
            r_refract * inv_sum, r_clearcoat * inv_sum)


def eval_diffuse(mat, sheen_col, v, l, h):
    """Burley diffuse + fake subsurface + sheen, local frame (glsl:925-948).

    Returns (f, pdf); both zero where l.z <= 0.
    """
    lz = l[..., 2]
    vz = v[..., 2]
    valid = lz > _COS_EPS

    lz = _mask1(valid, lz)
    ldoth = _dot(l, h)
    fl = schlick_fresnel(lz)
    fv = schlick_fresnel(vz)
    fh = schlick_fresnel(ldoth)
    fd90 = 0.5 + 2.0 * sqr(ldoth) * mat.roughness
    fd = mix(1.0, fd90, fl) * mix(1.0, fd90, fv)

    fss90 = sqr(ldoth) * mat.roughness
    fss = mix(1.0, fss90, fl) * mix(1.0, fss90, fv)
    ss = 1.25 * (fss * (1.0 / jnp.maximum(lz + vz, _COS_EPS) - 0.5) + 0.5)

    f_sheen = fh[..., None] * mat.sheen[..., None] * sheen_col
    scale = (1.0 - mat.metallic) * (1.0 - mat.transmission)
    f = scale[..., None] * (
        INV_PI * mix(fd, ss, mat.subsurface)[..., None] * mat.base_color
        + f_sheen)
    pdf = lz * INV_PI
    return (jnp.where(valid[..., None], f, 0.0), jnp.where(valid, pdf, 0.0))


def eval_spec_reflection(mat, eta, spec_col, v, l, h):
    """Anisotropic GGX reflection with VNDF pdf, local frame (glsl:950-964)."""
    lz = l[..., 2]
    vz = v[..., 2]
    valid = (lz > _COS_EPS) & (vz > _COS_EPS)

    lz = _mask1(valid, lz)
    vz = _mask1(valid, vz)
    ax, ay = mat.alpha_xy()
    fm = disney_fresnel(mat.metallic, eta, _dot(l, h), _dot(v, h))
    f_col = spec_col + fm[..., None] * (1.0 - spec_col)
    d = gtr2_aniso(h[..., 2], h[..., 0], h[..., 1], ax, ay)
    g1 = smith_g_ggx_aniso(vz, v[..., 0], v[..., 1], ax, ay)
    g2 = g1 * smith_g_ggx_aniso(lz, l[..., 0], l[..., 1], ax, ay)

    pdf = g1 * d / (4.0 * vz)
    f = f_col * (d * g2 / (4.0 * lz * vz))[..., None]
    return (jnp.where(valid[..., None], f, 0.0), jnp.where(valid, pdf, 0.0))


def eval_spec_refraction(mat, eta, v, l, h):
    """Rough dielectric transmission, local frame (glsl:966-984).

    Valid only for l.z < 0 (transmitted hemisphere); the reference returns a
    debug red with pdf=0 otherwise — we return zeros.
    """
    lz = l[..., 2]
    vz = v[..., 2]
    vdoth = _dot(v, h)
    ldoth = _dot(l, h)
    denom_raw = ldoth + vdoth * eta
    valid = ((lz < -_COS_EPS) & (vz > _COS_EPS)
             & (jnp.abs(denom_raw) > _DENOM_EPS))

    lz = _mask1(valid, lz, -1.0)
    vz = _mask1(valid, vz)
    denom = sqr(_mask1(valid, denom_raw))
    ax, ay = mat.alpha_xy()
    fr = dielectric_fresnel(jnp.abs(vdoth), eta)
    d = gtr2_aniso(h[..., 2], h[..., 0], h[..., 1], ax, ay)
    g1 = smith_g_ggx_aniso(jnp.abs(vz), v[..., 0], v[..., 1], ax, ay)
    g2 = g1 * smith_g_ggx_aniso(jnp.abs(lz), l[..., 0], l[..., 1], ax, ay)
    jacobian = jnp.abs(ldoth) / denom

    pdf = g1 * jnp.maximum(0.0, vdoth) * d * jacobian / vz
    scale = ((1.0 - mat.metallic) * mat.transmission * (1.0 - fr) * d * g2
             * jnp.abs(vdoth) * jacobian * sqr(eta)
             / jnp.abs(lz * vz))
    f = safe_sqrt(mat.base_color) * scale[..., None]
    return (jnp.where(valid[..., None], f, 0.0), jnp.where(valid, pdf, 0.0))


def eval_clearcoat(mat, v, l, h):
    """GTR1 clearcoat lobe, local frame (glsl:986-1000)."""
    lz = l[..., 2]
    vz = v[..., 2]
    vdoth = _dot(v, h)
    valid = (lz > _COS_EPS) & (vz > _COS_EPS) & (jnp.abs(vdoth) > _COS_EPS)

    lz = _mask1(valid, lz)
    vz = _mask1(valid, vz)
    vdoth = _mask1(valid, vdoth)
    fh = dielectric_fresnel(vdoth, 1.0 / 1.5)
    f_c = mix(0.04, 1.0, fh)
    d = gtr1(h[..., 2], mat.clearcoat_gloss)
    g = smith_g_ggx(lz, 0.25) * smith_g_ggx(vz, 0.25)
    jacobian = 1.0 / (4.0 * vdoth)

    pdf = d * h[..., 2] * jacobian
    f = (0.25 * mat.clearcoat * f_c * d * g
         / (4.0 * lz * vz))[..., None] * jnp.ones(3, jnp.float32)
    return (jnp.where(valid[..., None], f, 0.0), jnp.where(valid, pdf, 0.0))


def _eta_of(mat, v_world, n):
    """Relative IOR. The shading normal is always flipped toward the viewer
    (hitTriangle, glsl:256-259, 295), so this evaluates to 1/IOR in
    practice; kept general like glsl:1010."""
    return jnp.where(_dot(v_world, n) > 0.0, 1.0 / mat.ior, mat.ior)


def disney_eval(mat, v_world, n, l_world):
    """Full BSDF evaluation (DisneyEval, glsl:1002-1067).

    v_world: unit vector toward the viewer; n: shading normal (already
    oriented toward the viewer); l_world: sampled direction.
    Returns (f * |cos|, pdf).
    """
    eta = _eta_of(mat, v_world, n)
    t, b = onb(n)
    v = to_local(t, b, n, v_world)
    l = to_local(t, b, n, l_world)

    lz = l[..., 2]
    h_refl = l + v
    h_refr = l + v * eta[..., None]
    h = _normalize(jnp.where((lz > 0.0)[..., None], h_refl, h_refr))
    h = jnp.where((h[..., 2] < 0.0)[..., None], -h, h)

    spec_col, sheen_col = spec_and_sheen_color(
        mat.base_color, mat.specular_tint, mat.sheen_tint, mat.metallic, eta)
    fresnel = disney_fresnel(mat.metallic, eta, _dot(l, h), _dot(v, h))
    w_diff, w_refl, w_refr, w_coat = lobe_weights(mat, eta, spec_col, fresnel)

    f = jnp.zeros_like(mat.base_color)
    pdf = jnp.zeros_like(lz)

    fd, pd = eval_diffuse(mat, sheen_col, v, l, h)
    g = (w_diff > 0.0) & (lz > 0.0)
    f = f + jnp.where(g[..., None], fd, 0.0)
    pdf = pdf + jnp.where(g, pd * w_diff, 0.0)

    fs, ps = eval_spec_reflection(mat, eta, spec_col, v, l, h)
    g = (w_refl > 0.0) & (lz > 0.0) & (v[..., 2] > 0.0)
    f = f + jnp.where(g[..., None], fs, 0.0)
    pdf = pdf + jnp.where(g, ps * w_refl, 0.0)

    ft, pt = eval_spec_refraction(mat, eta, v, l, h)
    g = (w_refr > 0.0) & (lz < 0.0)
    f = f + jnp.where(g[..., None], ft, 0.0)
    pdf = pdf + jnp.where(g, pt * w_refr, 0.0)

    fc, pc = eval_clearcoat(mat, v, l, h)
    g = (w_coat > 0.0) & (lz > 0.0) & (v[..., 2] > 0.0)
    f = f + jnp.where(g[..., None], fc, 0.0)
    pdf = pdf + jnp.where(g, pc * w_coat, 0.0)

    return f * jnp.abs(lz)[..., None], pdf


def disney_sample(mat, v_world, n, r1, r2, r3):
    """Importance-sample the BSDF (DisneySample, glsl:1070-1161).

    Returns BsdfSample(f*|cos|, world direction, single-lobe pdf weighted by
    its selection probability, is_refract). Evaluates all lobes densely and
    selects by the lobe CDF, matching the reference's per-lobe estimator
    (the integrator performs MIS with disney_eval separately).
    """
    eta = _eta_of(mat, v_world, n)
    t, b = onb(n)
    v = to_local(t, b, n, v_world)

    spec_col, sheen_col = spec_and_sheen_color(
        mat.base_color, mat.specular_tint, mat.sheen_tint, mat.metallic, eta)
    approx_fresnel = disney_fresnel(mat.metallic, eta, v[..., 2], v[..., 2])
    w_diff, w_refl, w_refr, w_coat = lobe_weights(
        mat, eta, spec_col, approx_fresnel)

    cdf0 = w_diff
    cdf1 = cdf0 + w_coat
    # remaining mass = w_refl + w_refr

    # The stretch of r1 back to [0,1) within the picked lobe's CDF span is a
    # reparameterization of the RNG; differentiating through it adds nothing
    # but 1/span^2 cotangents that overflow when a lobe's span is tiny (the
    # pdf factors below keep their full gradients). Detach it — the standard
    # detached-sampling estimator (same choice geometry_grad documents).
    cdf0_d = jax.lax.stop_gradient(cdf0)
    cdf1_d = jax.lax.stop_gradient(cdf1)

    # --- diffuse lobe -----------------------------------------------------
    r1_d = r1 / jnp.maximum(cdf0_d, 1e-6)
    l_d = cosine_sample_hemisphere(jnp.clip(r1_d, 0.0, 1.0), r2)
    h_d = _normalize(l_d + v)
    f_d, pdf_d = eval_diffuse(mat, sheen_col, v, l_d, h_d)
    pdf_d = pdf_d * w_diff

    # --- clearcoat lobe ---------------------------------------------------
    r1_c = (r1 - cdf0_d) / jnp.maximum(cdf1_d - cdf0_d, 1e-6)
    h_c = sample_gtr1(mat.clearcoat_gloss, jnp.clip(r1_c, 0.0, 1.0), r2)
    h_c = jnp.where((h_c[..., 2] < 0.0)[..., None], -h_c, h_c)
    l_c = _normalize(reflect(-v, h_c))
    f_c, pdf_c = eval_clearcoat(mat, v, l_c, h_c)
    pdf_c = pdf_c * w_coat

    # --- specular reflect / refract lobes ---------------------------------
    r1_s = (r1 - cdf1_d) / jnp.maximum(1.0 - cdf1_d, 1e-6)
    ax, ay = mat.alpha_xy()
    h_s = sample_ggx_vndf(v, ax, ay, jnp.clip(r1_s, 0.0, 1.0), r2)
    h_s = jnp.where((h_s[..., 2] < 0.0)[..., None], -h_s, h_s)

    vdoth = _dot(v, h_s)
    fresnel_s = disney_fresnel(mat.metallic, eta, vdoth, vdoth)
    f_pick = 1.0 - ((1.0 - fresnel_s) * mat.transmission * (1.0 - mat.metallic))

    l_r = _normalize(reflect(-v, h_s))
    f_r, pdf_r = eval_spec_reflection(mat, eta, spec_col, v, l_r, h_s)
    pdf_r = pdf_r * f_pick

    l_t = _normalize(refract(-v, h_s, eta))
    f_t, pdf_t = eval_spec_refraction(mat, eta, v, l_t, h_s)
    pdf_t = pdf_t * (1.0 - f_pick)

    spec_mass = w_refl + w_refr
    pdf_r = pdf_r * spec_mass
    pdf_t = pdf_t * spec_mass

    # --- select -----------------------------------------------------------
    pick_diff = r1 < cdf0
    pick_coat = (~pick_diff) & (r1 < cdf1)
    pick_spec = (~pick_diff) & (~pick_coat)
    pick_refr = pick_spec & (r3 >= f_pick)
    pick_refl = pick_spec & (r3 < f_pick)

    def sel(mask, x, y):
        return jnp.where(mask[..., None] if x.ndim > mask.ndim else mask, x, y)

    l_local = sel(pick_diff, l_d,
                  sel(pick_coat, l_c, sel(pick_refl, l_r, l_t)))
    f = sel(pick_diff, f_d, sel(pick_coat, f_c, sel(pick_refl, f_r, f_t)))
    pdf = jnp.where(pick_diff, pdf_d,
                    jnp.where(pick_coat, pdf_c,
                              jnp.where(pick_refl, pdf_r, pdf_t)))

    l_world = to_world(t, b, n, l_local)
    fcos = f * jnp.abs(l_local[..., 2])[..., None]
    return BsdfSample(f=fcos, direction=l_world, pdf=pdf, is_refract=pick_refr)


# ---------------------------------------------------------------------------
# Legacy BRDF mode (enableBSDF = false): 3-lobe Disney BRDF
# ---------------------------------------------------------------------------


def brdf_lobe_pdfs(mat):
    """Diffuse/specular/clearcoat selection probabilities (glsl:520-533)."""
    r_diffuse = 1.0 - mat.metallic
    r_specular = jnp.ones_like(mat.metallic)
    r_clearcoat = (1.0 - mat.metallic) * 0.25 * mat.clearcoat
    inv = 1.0 / jnp.maximum(r_diffuse + r_specular + r_clearcoat, _EPS)
    return r_diffuse * inv, r_specular * inv, r_clearcoat * inv


def brdf_evaluate(mat, v, n, l, x, y):
    """Disney BRDF (world frame, tangents x/y) + mixture pdf
    (BRDF_Evaluate, glsl:836-921). Returns (f, pdf); f does NOT include the
    |cos| factor (the BRDF-mode integrator multiplies it explicitly)."""
    ndotl = _dot(n, l)
    ndotv = _dot(n, v)
    h = _normalize(l + v)
    ndoth = _dot(n, h)
    # degenerate l.h folded into `valid` so those lanes return (0, _EPS)
    # like every other masked configuration instead of a wrong finite
    # specular term evaluated at the substituted ldoth=1
    valid = (ndotl >= _COS_EPS) & (ndotv >= _COS_EPS) \
        & (jnp.abs(_dot(l, h)) > _COS_EPS)

    ndotl = _mask1(valid, ndotl)
    ndotv = _mask1(valid, ndotv)
    ldoth = _mask1(valid, _dot(l, h))

    cdlin = mat.base_color
    ctint = calculate_tint(cdlin)
    cspec = mat.specular[..., None] * mix(
        jnp.ones_like(ctint), ctint, mat.specular_tint[..., None])
    cspec0 = mix(0.08 * cspec, cdlin, mat.metallic[..., None])
    csheen = mix(jnp.ones_like(ctint), ctint, mat.sheen_tint[..., None])

    fd90 = 0.5 + 2.0 * sqr(ldoth) * mat.roughness
    fl = schlick_fresnel(ndotl)
    fv = schlick_fresnel(ndotv)
    fd = mix(1.0, fd90, fl) * mix(1.0, fd90, fv)

    fss90 = sqr(ldoth) * mat.roughness
    fss = mix(1.0, fss90, fl) * mix(1.0, fss90, fv)
    ss = 1.25 * (fss * (1.0 / jnp.maximum(ndotl + ndotv, _COS_EPS) - 0.5) + 0.5)

    fh = schlick_fresnel(ldoth)
    alpha = jnp.maximum(0.001, sqr(mat.roughness))
    ds_iso = gtr2(ndoth, alpha)
    gs_iso = smith_g_ggx(ndotl, mat.roughness) * smith_g_ggx(ndotv, mat.roughness)

    ax, ay = mat.alpha_xy()
    ds_aniso = gtr2_aniso(ndoth, _dot(h, x), _dot(h, y), ax, ay)
    gs_aniso = (smith_g_ggx_aniso(ndotl, _dot(l, x), _dot(l, y), ax, ay)
                * smith_g_ggx_aniso(ndotv, _dot(v, x), _dot(v, y), ax, ay))
    aniso = mat.anisotropic > 0.0
    ds = jnp.where(aniso, ds_aniso, ds_iso)
    gs = jnp.where(aniso, gs_aniso, gs_iso)
    fs = mix(cspec0, jnp.ones_like(cspec0), fh[..., None])

    dr = gtr1(ndoth, mix(0.1, 0.001, 1.0 - mat.clearcoat_gloss))
    fr = mix(0.04, 1.0, fh)
    gr = smith_g_ggx(ndotl, 0.25) * smith_g_ggx(ndotv, 0.25)

    f_sheen = fh[..., None] * mat.sheen[..., None] * csheen

    diffuse = (INV_PI * mix(fd, ss, mat.subsurface)[..., None] * cdlin
               + f_sheen)
    denom = 1.0 / (4.0 * ndotv * ndotl)
    specular = gs[..., None] * fs * ds[..., None] * denom[..., None]
    clearcoat = (0.25 * gr * fr * dr * mat.clearcoat * denom)[..., None] \
        * jnp.ones(3, jnp.float32)

    p_diff, p_spec, p_coat = brdf_lobe_pdfs(mat)
    pdf_diffuse = ndotl * INV_PI
    pdf_specular = ds * ndoth / (4.0 * ldoth)
    pdf_clearcoat = dr * ndoth / (4.0 * ldoth)
    pdf = p_diff * pdf_diffuse + p_spec * pdf_specular + p_coat * pdf_clearcoat
    pdf = jnp.maximum(pdf, _EPS)

    f = ((1.0 - mat.metallic)[..., None] * diffuse + specular + clearcoat)
    f = jnp.where(valid[..., None], f, 0.0)
    pdf = jnp.where(valid, pdf, _EPS)
    return f, pdf


def sample_brdf(mat, v, n, r1, r2, r3):
    """Sample the 3-lobe BRDF mixture (SampleBRDF, glsl:789-833).

    Returns a world-space direction (pdf comes from brdf_evaluate)."""
    p_diff, p_spec, p_coat = brdf_lobe_pdfs(mat)
    alpha_gtr1 = mix(0.1, 0.001, mat.clearcoat_gloss)
    alpha_gtr2 = jnp.maximum(0.001, sqr(mat.roughness))

    cdf0 = p_diff
    cdf1 = cdf0 + p_coat

    l_diff = sample_cosine_hemisphere_world(r1, r2, n)
    l_coat = sample_gtr1_world(r1, r2, v, n, alpha_gtr1)
    l_spec = sample_gtr2_world(r1, r2, v, n, alpha_gtr2)

    pick_diff = r3 <= cdf0
    pick_coat = (~pick_diff) & (r3 <= cdf1)
    return jnp.where(pick_diff[..., None], l_diff,
                     jnp.where(pick_coat[..., None], l_coat, l_spec))
