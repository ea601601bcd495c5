"""Wavefront path-tracing integrators.

Batched jnp re-architecture of the reference's per-fragment integrators
(src/shaders/fragment_shader_ray_tracing.glsl):

- BSDF mode (default):   shadingImportanceSampling_BSDF  glsl:1369-1516
- legacy BRDF mode:      shadingImportanceSampling_BRDF  glsl:1290-1367
- kernel main (primary ray, env/sky miss, emissive pickup)  glsl:1518-1550

Per bounce (bounded by max_bounce, a rematerialized `lax.scan` with masked
lanes instead of the fragment shader's data-dependent break):
  1. next-event estimation toward the HDR environment with a shadow ray and
     power-heuristic MIS (glsl:1379-1406),
  2. Sobol-driven BSDF sampling with per-pixel Cranley-Patterson rotation
     (glsl:1408-1421),
  3. participating-media handling on refraction: Beer-Lambert ABSORB,
     EMISSIVE line integral, SCATTER with Henyey-Greenstein phase
     (glsl:1429-1458),
  4. bounce ray trace; on miss, MIS-weighted environment (or gradient sky)
     pickup; on hit, emissive pickup (glsl:1476-1513).

Documented deviations — the reference's estimator double-applies the BSDF:
`history` is multiplied by f/pdf *before* the emissive/environment pickup
lines, which multiply f/pdf again (glsl:1431 vs 1496/1510; same pattern in
BRDF mode 1338 vs 1352/1362), and refraction events skip the surface f/pdf
entirely (glsl:1429-1439). We implement the evident intent — the standard
single-application MIS estimator with throughput applied on every surface
interaction — and keep the reference's media heuristics (straight-line
in-medium march, incoming-segment distances). NEE is gated on
enable_env_map (the reference samples the HDR cache even with the
environment disabled, glsl:1379-1406).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.ad_checkpoint import checkpoint_name

from ..models.material import (
    MEDIUM_ABSORB,
    MEDIUM_EMISSIVE,
    MEDIUM_SCATTER,
)
from . import disney
from .envmap import (
    default_sky_color,
    env_radiance_pdf_nearest,
    env_sample_nearest,
    hdr_color,
    hdr_pdf,
    sample_hdr_direction,
)
from .intersect import Hit, INF, surface_attributes
from .sampling import (
    cranley_patterson,
    onb,
    phase_hg,
    rand01,
    sample_hg,
    sobol_all_dims,
    sobol_bounce_uv,
)
from .traverse import closest_hit, closest_hit_pair

_EPS_PDF = 1e-10


def mis_weight(a, b):
    """Power heuristic a^2 / (a^2 + b^2) (misMixWeight, glsl:1285-1288)."""
    t = a * a
    return t / jnp.maximum(t + b * b, 1e-20)


class PathState(NamedTuple):
    origin: jax.Array      # (R, 3) ray origin of the segment that produced hit
    direction: jax.Array   # (R, 3) incoming ray direction (the "viewDir")
    t: jax.Array           # (R,) hit distance
    tri: jax.Array         # (R,) int32 hit triangle
    inside: jax.Array      # (R,) bool backface hit
    history: jax.Array     # (R, 3) path throughput
    lo: jax.Array          # (R, 3) accumulated radiance
    alive: jax.Array       # (R,) bool


# (R, 3)-shaped PathState fields, flattened to (3R,) across the bounce-scan
# boundary: reverse-mode AD stacks the loop carry per bounce, and the
# flattened carry stacks as one dense (B, 3R) buffer.
_VEC_FIELDS = (0, 1, 5, 6)   # origin, direction, history, lo


def _flatten_state(state: PathState):
    return tuple(x.reshape(-1) if i in _VEC_FIELDS else x
                 for i, x in enumerate(state))


def _unflatten_state(flat) -> PathState:
    return PathState(*(x.reshape(-1, 3) if i in _VEC_FIELDS else x
                       for i, x in enumerate(flat)))


def _named_hit(hit, tag):
    """checkpoint_name the traversal outputs: with the save_only policy the
    bwd recompute of a bounce replays shading math but NOT the traversal
    kernels (their outputs are the saved residuals, all (R,)-shaped)."""
    return type(hit)(*(checkpoint_name(x, tag) for x in hit))


def _bounce_scan(body, state: PathState, n: int) -> PathState:
    """Run `body(b, state)` n times with per-bounce rematerialization.

    Forward-only jit sees plain sequential iteration (checkpoint is
    identity); under reverse-mode AD each bounce saves only its input
    carry (flattened) and the checkpoint_name'd traversal outputs, and
    recomputes the shading math in the backward sweep — O(R) residuals
    per bounce instead of O(R * live-intermediates)."""
    ckpt = jax.checkpoint(
        lambda flat, b: (_flatten_state(body(b, _unflatten_state(flat))),
                         None),
        policy=jax.checkpoint_policies.save_only_these_names("hit"),
        static_argnums=(),
    )
    flat, _ = jax.lax.scan(ckpt, _flatten_state(state),
                           jnp.arange(n, dtype=jnp.int32))
    return _unflatten_state(flat)


def _safe_rcp(x, eps=_EPS_PDF):
    return 1.0 / jnp.maximum(x, eps)


# ---------------------------------------------------------------------------
# Wavefront compaction between bounces
#
# The fragment shader retires a path with `break` and the GPU's SIMT
# scheduler refills the warp from other fragments (glsl:1518-1550). A dense
# wavefront batch has no scheduler — dead lanes would ride every per-bounce
# stage (NEE gather, shadow cast, BSDF sample, bounce cast) at full width.
# On glass scenes few paths survive the first bounces, so each bounce
# partitions the alive rays to a
# dense prefix and runs the whole bounce at the smallest bucketed static
# width that holds them (lax.switch keeps every shape static for XLA).
# Exact by construction: the partition uses bounce-start aliveness, dead
# lanes outside the prefix are not touched, and dead lanes inside the
# prefix contribute nothing (every contribution is masked by `alive`).
# ---------------------------------------------------------------------------


def _compact_perm(alive):
    """Stable-partition permutation: perm[:total] = alive lanes' source
    indices in original order, perm[total:] = dead lanes'. Returns
    (perm, total)."""
    r = alive.shape[0]
    a = alive.astype(jnp.int32)
    na = jnp.cumsum(a)
    total = na[-1]
    pos = jnp.where(alive, na - 1, total + jnp.cumsum(1 - a) - 1)
    perm = jnp.zeros((r,), jnp.int32).at[pos].set(
        jnp.arange(r, dtype=jnp.int32), unique_indices=True)
    return perm, total


_BUCKET_DIVISORS = (1, 2, 4, 8, 16, 64)


def _bucket_widths(r: int, n_buckets: int):
    """Static bounce widths r/1, r/2, r/4, r/8, r/16, r/64 (floor 512
    rays: below that the per-branch fixed costs exceed the trace work
    saved). Power-of-two divisors keep bucket round-up waste under 2x
    down to R/16."""
    widths = []
    for div in _BUCKET_DIVISORS[:max(n_buckets, 1)]:
        w = r // div
        if widths and (w < 512 or w == widths[-1]):
            break
        widths.append(w)
    return widths


def _compacted_bounce(body, b, state, pixel_id, n_buckets: int):
    """Run `body(b, state_sub, pid_sub)` at a bucketed alive-prefix width.

    body must preserve dead lanes' lo/history (it does: every accumulation
    is masked by `alive`), so lanes outside the prefix pass through
    untouched and the result equals full-width evaluation exactly.

    Every value crossing the lax.switch boundary is FLAT 1-D: switch
    operands/results (and, under AD, their cotangents and per-branch
    residuals) are materialized at conditional boundaries, so the
    (R,)-flattened carry crosses as dense 1-D buffers; (w, 3) views
    exist only inside a branch where XLA fuses them away. Vec-field
    gather/scatter uses interleaved flat indices (lane i -> 3i..3i+2), so
    results remain bitwise-identical to the unflattened form
    (tests/test_compaction.py)."""
    r = state.alive.shape[0]
    widths = _bucket_widths(r, n_buckets)
    if len(widths) == 1 and n_buckets <= 1:
        return body(b, state, pixel_id)

    perm, total = _compact_perm(state.alive)
    idx = jnp.int32(0)
    for j in range(1, len(widths)):
        idx = jnp.where(total <= widths[j], jnp.int32(j), idx)
    idx = jnp.where(total == 0, jnp.int32(len(widths)), idx)

    def full_branch(flat, pid, perm, b):
        return _flatten_state(body(b, _unflatten_state(flat), pid))

    def make_branch(w):
        def f(flat, pid, perm, b):
            sel = perm[:w]
            sel3 = (sel[:, None] * 3
                    + jnp.arange(3, dtype=sel.dtype)[None, :]).reshape(-1)
            sub = tuple(x[sel3] if i in _VEC_FIELDS else x[sel]
                        for i, x in enumerate(flat))
            out = _flatten_state(body(b, _unflatten_state(sub), pid[sel]))
            return tuple(
                x.at[sel3 if i in _VEC_FIELDS else sel].set(
                    o, unique_indices=True)
                for i, (x, o) in enumerate(zip(flat, out)))
        return f

    def skip(flat, pid, perm, b):
        return flat

    branches = [full_branch] + [make_branch(w) for w in widths[1:]] + [skip]
    out = jax.lax.switch(idx, branches, _flatten_state(state), pixel_id,
                         perm, b)
    return _unflatten_state(out)


# ---------------------------------------------------------------------------
# Cast-only compaction (compaction_mode="casts")
#
# _compacted_bounce puts the WHOLE bounce body behind a lax.switch; under
# reverse-mode AD every branch is replayed and transposed, and the
# boundary materializations add to the backward sweep. These helpers keep
# the bucketing where it matters — the traversal launches — while shading
# runs at full width: the traversal is detached
# (stop_gradient, traverse.closest_hit), so NOTHING inside this switch
# carries a cotangent, its transpose is empty, and with the returned hits
# checkpoint_name'd the remat replay drops the whole switch as dead code.
# Exact by the same argument as _compacted_bounce: the bucket prefix is
# chosen by bounce-start aliveness, and a lane outside the prefix gets the
# same Hit(INF, -1, False) a masked lane gets from the kernel.
# ---------------------------------------------------------------------------


def _miss_hits(vz):
    """Full-width miss defaults Hit(INF, -1, False). vz: an all-zero (R,)
    f32 derived from the switch inputs, so every branch's outputs carry
    the same varying type under shard_map (jax >= 0.8 vma typing: a
    plain jnp.full constant is mesh-invariant and makes lax.switch
    reject the branch set with "Revise branch..so output types match")."""
    return (INF + vz, vz.astype(jnp.int32) - 1, vz != 0.0)


def _cast_switch(alive, n_buckets, flat_vecs, masks, cast_at):
    """Run `cast_at(sel_or_None, vecs, masks)` at a bucketed alive-prefix
    width. flat_vecs: (3R,) detached ray arrays; masks: (R,) bools;
    cast_at returns a flat tuple of (R,)-shaped hit fields (already
    scattered to full width when sel is not None)."""
    r = alive.shape[0]
    widths = _bucket_widths(r, n_buckets)
    sg = jax.lax.stop_gradient
    flat_vecs = tuple(sg(x) for x in flat_vecs)
    # all-zero (R,) f32 carrying the inputs' varying type (see _miss_hits)
    vz = sum(x[:r] * 0.0 for x in flat_vecs) \
        + sum(m[:r] * 0.0 for m in masks)
    if len(widths) == 1:
        return cast_at(None, flat_vecs, masks, vz)

    perm, total = _compact_perm(alive)
    idx = jnp.int32(0)
    for j in range(1, len(widths)):
        idx = jnp.where(total <= widths[j], jnp.int32(j), idx)
    idx = jnp.where(total == 0, jnp.int32(len(widths)), idx)

    nv, nm = len(flat_vecs), len(masks)

    def full_branch(*ops):
        return cast_at(None, ops[:nv], ops[nv:nv + nm], ops[nv + nm + 1])

    def make_branch(w):
        def f(*ops):
            sel = ops[-2][:w]
            sel3 = (sel[:, None] * 3
                    + jnp.arange(3, dtype=sel.dtype)[None, :]).reshape(-1)
            vecs = tuple(x[sel3] for x in ops[:nv])
            ms = tuple(m[sel] for m in ops[nv:nv + nm])
            return cast_at(sel, vecs, ms, ops[nv + nm + 1])
        return f

    def skip(*ops):
        out = ()
        for _ in range(max(nm, 1)):
            out += _miss_hits(ops[nv + nm + 1])
        return out

    branches = [full_branch] + [make_branch(w) for w in widths[1:]] + [skip]
    return jax.lax.switch(idx, branches, *flat_vecs, *masks, perm, vz)


def _scatter_hit(h: Hit, sel, vz):
    if sel is None:
        return (h.t, h.tri, h.inside)
    t, tri, inside = _miss_hits(vz)
    return (t.at[sel].set(h.t, unique_indices=True),
            tri.at[sel].set(h.tri, unique_indices=True),
            inside.at[sel].set(h.inside, unique_indices=True))


def _compacted_cast_pair(scene, alive, o_any, d_any, m_any, o_cls, d_cls,
                         m_cls, config):
    """Bucketed merged shadow+bounce launch, full-width results."""

    def cast_at(sel, vecs, ms, vz):
        oa, da, oc, dc = (x.reshape(-1, 3) for x in vecs)
        ha, hc = closest_hit_pair(scene, oa, da, ms[0], oc, dc, ms[1],
                                  config)
        return _scatter_hit(ha, sel, vz) + _scatter_hit(hc, sel, vz)

    out = _cast_switch(
        alive, config.compaction_buckets,
        tuple(x.reshape(-1) for x in (o_any, d_any, o_cls, d_cls)),
        (m_any, m_cls), cast_at)
    return (Hit(t=out[0], tri=out[1], inside=out[2]),
            Hit(t=out[3], tri=out[4], inside=out[5]))


def _compacted_cast(scene, alive, origin, direction, mask, config):
    """Bucketed single secondary cast, full-width results."""

    def cast_at(sel, vecs, ms, vz):
        o, d = (x.reshape(-1, 3) for x in vecs)
        h = closest_hit(scene, o, d, config, mask=ms[0])
        return _scatter_hit(h, sel, vz)

    out = _cast_switch(
        alive, config.compaction_buckets,
        (origin.reshape(-1), direction.reshape(-1)), (mask,), cast_at)
    return Hit(t=out[0], tri=out[1], inside=out[2])


def _env_radiance(scene, direction, config):
    if config.enable_env_map:
        return hdr_color(scene.hdr_map, direction, scene.env_angle) \
            * scene.env_intensity
    return default_sky_color(direction[..., 1])


def _env_nee_sample(scene, config, hh, ww, xl1, xl2):
    """In-loop NEE light sample -> (direction, pdf, radiance).

    Default: ONE nearest-texel row gather from the fused table.
    config.env_bilinear: the reference's exact three GL_LINEAR fetches
    (SampleHdr glsl:635-646 + hdrPdf glsl:1173-1186 + hdrColor
    glsl:1165-1169), including its rotation semantics (only the
    pdf/radiance lookups add env_angle; the sampled direction itself is
    unrotated)."""
    if config.env_bilinear:
        l_dir = sample_hdr_direction(scene.hdr_cache, xl1, xl2)
        pdf = hdr_pdf(scene.hdr_cache, l_dir, scene.env_angle, ww, hh)
        fr = hdr_color(scene.hdr_map, l_dir, scene.env_angle)
        return l_dir, pdf, fr
    return env_sample_nearest(scene.env_fetch, hh, ww, xl1, xl2,
                              scene.env_angle)


def _env_miss_radiance_pdf(scene, config, hh, ww, direction):
    """Bounce-miss environment radiance + pdf (the MIS pickup site,
    glsl:1483-1506): one fused row gather, or GL_LINEAR when
    config.env_bilinear."""
    if config.env_bilinear:
        fr = hdr_color(scene.hdr_map, direction, scene.env_angle)
        pdf = hdr_pdf(scene.hdr_cache, direction, scene.env_angle, ww, hh)
        return fr, pdf
    return env_radiance_pdf_nearest(scene.env_fetch, hh, ww, direction,
                                    scene.env_angle)


def trace_radiance(scene, origin, direction, pixel_id, frame, config):
    """Path-traced radiance for a batch of primary rays (glsl main,
    1518-1550). pixel_id: (R,) uint32 per-pixel counter-RNG stream id;
    frame: scalar int32 1-based progressive sample index (camera.loopNum+1).
    Returns (R, 3) float32 linear radiance.
    """
    # name the primary hit like the per-bounce hits: when callers
    # checkpoint a whole tile (render._tile_traced), the recompute then
    # replays shading but not the primary traversal either
    hit0 = _named_hit(closest_hit(scene, origin, direction, config), "hit")
    miss_rgb = _env_radiance(scene, direction, config)

    if config.enable_bsdf:
        lo = _bounce_loop_bsdf(scene, origin, direction, hit0, pixel_id,
                               frame, config)
    else:
        lo = _bounce_loop_brdf(scene, origin, direction, hit0, pixel_id,
                               frame, config)

    le0 = scene.material_of(hit0.tri).emissive
    hit_rgb = le0 + lo
    return jnp.where(hit0.is_hit[..., None], hit_rgb, miss_rgb)


# ---------------------------------------------------------------------------
# BSDF integrator (default mode)
# ---------------------------------------------------------------------------


def _bounce_loop_bsdf(scene, origin, direction, hit0, pixel_id, frame,
                      config):
    # Derive fresh carries from the ray arrays AND the frame counter so
    # their varying type under shard_map matches the loop outputs (jax >=
    # 0.8 vma typing): rays vary over the pixel axis, the progressive frame
    # varies over the spp axis, and the loop body mixes both.
    vary = jnp.zeros_like(origin) + jnp.zeros_like(direction) \
        + (frame * 0).astype(origin.dtype)
    v0 = vary[:, 0]
    z_i = v0.astype(jnp.int32)
    z_b = z_i != 0
    state = PathState(
        origin=origin + vary,
        direction=direction + vary,
        t=hit0.t + v0,
        tri=hit0.tri + z_i,
        inside=hit0.inside | z_b,
        history=1.0 + vary,
        lo=vary,
        alive=hit0.is_hit | z_b,
    )
    sobol_point = sobol_all_dims(frame)

    def body(b, state, pid):
        hit_point, n, v, mat = surface_attributes(scene, state)

        hh, ww = scene.hdr_map.shape[0], scene.hdr_map.shape[1]

        # ---- 1. next-event estimation: draw the light sample ------------
        # (the shadow ray is traced together with the bounce ray below —
        # one merged launch per bounce, closest_hit_pair)
        lo = state.lo
        if config.enable_env_map:
            xl1 = rand01(pid, frame, 8 * b + 0)
            xl2 = rand01(pid, frame, 8 * b + 1)
            # ONE gather: sample direction, its pdf AND its radiance
            # (or the GL-faithful bilinear path, config.env_bilinear)
            l_dir, light_pdf, light_fr = _env_nee_sample(
                scene, config, hh, ww, xl1, xl2)
            light_fr = light_fr * scene.env_intensity
            facing = jnp.sum(n * l_dir, axis=-1) > 0.0

        # ---- 2. sample the BSDF -----------------------------------------
        u, vv = sobol_bounce_uv(sobol_point, b)
        cu = rand01(pid, frame, 8 * b + 2)
        cv = rand01(pid, frame, 8 * b + 3)
        xi1 = cranley_patterson(u, cu)
        xi2 = cranley_patterson(vv, cv)
        xi3 = rand01(pid, frame, 8 * b + 4)

        smp = disney.disney_sample(mat, v, n, xi1, xi2, xi3)
        pdf_ok = smp.pdf > _EPS_PDF
        alive = state.alive & pdf_ok

        # ---- 3. media on refraction (glsl:1429-1458) --------------------
        refract = alive & smp.is_refract
        med_absorb = refract & (mat.medium_type == MEDIUM_ABSORB)
        med_emissive = refract & (mat.medium_type == MEDIUM_EMISSIVE)
        med_scatter_t = refract & (mat.medium_type == MEDIUM_SCATTER)

        dens = mat.medium_density
        absorb_mult = jnp.exp(-(1.0 - mat.medium_color)
                              * state.t[..., None] * dens[..., None])
        lo = lo + jnp.where(
            med_emissive[..., None],
            mat.medium_color * (state.t * dens)[..., None] * state.history,
            0.0)

        scatter_dist = jnp.minimum(
            -jnp.log(jnp.maximum(xi3, 1e-12)) * _safe_rcp(dens, 1e-6),
            state.t)
        med_sampled = med_scatter_t & (scatter_dist < state.t)
        hg_dir = sample_hg(v, mat.medium_anisotropy, xi1, xi2)
        hg_pdf = phase_hg(jnp.sum(v * hg_dir, axis=-1), mat.medium_anisotropy)

        # ---- throughput & next ray --------------------------------------
        surf_mult = smp.f * _safe_rcp(smp.pdf)[..., None]
        surf_mult = jnp.where(med_absorb[..., None],
                              surf_mult * absorb_mult, surf_mult)
        scatter_mult = mat.medium_color * jnp.exp(-scatter_dist)[..., None]
        mult = jnp.where(med_sampled[..., None], scatter_mult, surf_mult)
        history = jnp.where(alive[..., None], state.history * mult,
                            state.history)

        new_dir = jnp.where(med_sampled[..., None], hg_dir, smp.direction)
        # glsl:1450 marches straight through the surface to the scatter point
        scatter_org = hit_point + state.direction * scatter_dist[..., None]
        new_org = jnp.where(med_sampled[..., None], scatter_org, hit_point)

        # mixture pdf of the sampled direction, for env MIS (glsl:1466-1474)
        _, pdf_eval_dir = disney.disney_eval(mat, v, n, new_dir)
        pdf_for_mis = jnp.where(med_sampled, hg_pdf, pdf_eval_dir)

        # ---- 4. trace shadow + bounce rays in ONE launch ----------------
        if config.enable_env_map:
            if config.compaction_mode == "casts":
                shadow, nxt = _compacted_cast_pair(
                    scene, state.alive, hit_point, l_dir,
                    state.alive & facing, new_org, new_dir, alive, config)
            else:
                shadow, nxt = closest_hit_pair(
                    scene, hit_point, l_dir, state.alive & facing,
                    new_org, new_dir, alive, config)
            shadow = _named_hit(shadow, "hit")
            nxt = _named_hit(nxt, "hit")
            # NEE contribution (glsl:1379-1406)
            vis = state.alive & facing & ~shadow.is_hit
            f_eval, pdf_eval = disney.disney_eval(mat, v, n, l_dir)
            w = mis_weight(light_pdf, pdf_eval)
            if not config.enable_mis:
                w = jnp.ones_like(w)
            contrib = (w * _safe_rcp(light_pdf))[..., None] \
                * state.history * light_fr * f_eval
            lo = lo + jnp.where(vis[..., None], contrib, 0.0)
        else:
            if config.compaction_mode == "casts":
                nxt = _compacted_cast(scene, state.alive, new_org, new_dir,
                                      alive, config)
            else:
                nxt = closest_hit(scene, new_org, new_dir, config,
                                  mask=alive)
            nxt = _named_hit(nxt, "hit")
        nxt_miss = alive & ~nxt.is_hit

        if config.enable_env_map:
            env_fr, light_pdf2 = _env_miss_radiance_pdf(
                scene, config, hh, ww, new_dir)
            env_fr = env_fr * scene.env_intensity
            w2 = mis_weight(pdf_for_mis, light_pdf2)
            if not config.enable_mis:
                w2 = jnp.ones_like(w2)
            # phase-sampled lanes have no competing NEE: full weight
            w2 = jnp.where(med_sampled, 1.0, w2)
            lo = lo + jnp.where(nxt_miss[..., None],
                                w2[..., None] * history * env_fr, 0.0)
        else:
            sky = default_sky_color(new_dir[..., 1])
            lo = lo + jnp.where(nxt_miss[..., None], history * sky, 0.0)

        le = scene.material_of(nxt.tri).emissive
        lo = lo + jnp.where((alive & nxt.is_hit)[..., None],
                            history * le, 0.0)

        return PathState(
            origin=new_org,
            direction=new_dir,
            t=nxt.t,
            tri=nxt.tri,
            inside=nxt.inside,
            history=history,
            lo=lo,
            alive=alive & nxt.is_hit,
        )

    if config.compaction_mode == "full":
        step = lambda b, st: _compacted_bounce(body, b, st, pixel_id,
                                               config.compaction_buckets)
    else:   # "casts": full-width shading, bucketed (detached) casts
        step = lambda b, st: body(b, st, pixel_id)
    final = _bounce_scan(step, state, config.max_bounce)
    return final.lo


# ---------------------------------------------------------------------------
# Legacy BRDF integrator (enableBSDF = false)
#
# Parity note: enable_mis is deliberately NOT consulted here — the
# reference's BRDF mode applies the power heuristic unconditionally in both
# the NEE (glsl:1310-1322) and the bounce-miss pickup (glsl:1345-1352); only
# the BSDF mode has the `!enableMultiImportantSample -> weight = 1` override
# (glsl:1400-1402, 1491-1493).
# ---------------------------------------------------------------------------


def _bounce_loop_brdf(scene, origin, direction, hit0, pixel_id, frame,
                      config):
    # Derive fresh carries from the ray arrays AND the frame counter so
    # their varying type under shard_map matches the loop outputs (jax >=
    # 0.8 vma typing): rays vary over the pixel axis, the progressive frame
    # varies over the spp axis, and the loop body mixes both.
    vary = jnp.zeros_like(origin) + jnp.zeros_like(direction) \
        + (frame * 0).astype(origin.dtype)
    v0 = vary[:, 0]
    z_i = v0.astype(jnp.int32)
    z_b = z_i != 0
    state = PathState(
        origin=origin + vary,
        direction=direction + vary,
        t=hit0.t + v0,
        tri=hit0.tri + z_i,
        inside=hit0.inside | z_b,
        history=1.0 + vary,
        lo=vary,
        alive=hit0.is_hit | z_b,
    )
    sobol_point = sobol_all_dims(frame)

    def body(b, state, pid):
        hit_point, n, v, mat = surface_attributes(scene, state)
        tangent, bitangent = onb(n)

        hh, ww = scene.hdr_map.shape[0], scene.hdr_map.shape[1]

        lo = state.lo
        if config.enable_env_map:
            xl1 = rand01(pid, frame, 8 * b + 0)
            xl2 = rand01(pid, frame, 8 * b + 1)
            # ONE gather: sample direction, its pdf AND its radiance
            # (or the GL-faithful bilinear path, config.env_bilinear)
            l_dir_nee, light_pdf, light_fr = _env_nee_sample(
                scene, config, hh, ww, xl1, xl2)
            light_fr = light_fr * scene.env_intensity
            facing = jnp.sum(n * l_dir_nee, axis=-1) > 0.0

        u, vv = sobol_bounce_uv(sobol_point, b)
        cu = rand01(pid, frame, 8 * b + 2)
        cv = rand01(pid, frame, 8 * b + 3)
        xi1 = cranley_patterson(u, cu)
        xi2 = cranley_patterson(vv, cv)
        xi3 = rand01(pid, frame, 8 * b + 4)

        l_dir = disney.sample_brdf(mat, v, n, xi1, xi2, xi3)
        f_r, pdf_brdf = disney.brdf_evaluate(
            mat, v, n, l_dir, tangent, bitangent)
        ndotl = jnp.abs(jnp.sum(n * l_dir, axis=-1))
        alive = state.alive & (pdf_brdf > _EPS_PDF)
        mult = f_r * (ndotl * _safe_rcp(pdf_brdf))[..., None]
        history = jnp.where(alive[..., None], state.history * mult,
                            state.history)

        # shadow + bounce rays in one merged launch (closest_hit_pair)
        if config.enable_env_map:
            if config.compaction_mode == "casts":
                shadow, nxt = _compacted_cast_pair(
                    scene, state.alive, hit_point, l_dir_nee,
                    state.alive & facing, hit_point, l_dir, alive, config)
            else:
                shadow, nxt = closest_hit_pair(
                    scene, hit_point, l_dir_nee, state.alive & facing,
                    hit_point, l_dir, alive, config)
            shadow = _named_hit(shadow, "hit")
            nxt = _named_hit(nxt, "hit")
            vis = state.alive & facing & ~shadow.is_hit
            f_eval, pdf_eval = disney.brdf_evaluate(
                mat, v, n, l_dir_nee, tangent, bitangent)
            ndotl_nee = jnp.abs(jnp.sum(n * l_dir_nee, axis=-1))
            w = mis_weight(light_pdf, pdf_eval)
            contrib = (w * ndotl_nee * _safe_rcp(light_pdf))[..., None] \
                * state.history * light_fr * f_eval
            lo = lo + jnp.where(vis[..., None], contrib, 0.0)
        else:
            if config.compaction_mode == "casts":
                nxt = _compacted_cast(scene, state.alive, hit_point, l_dir,
                                      alive, config)
            else:
                nxt = closest_hit(scene, hit_point, l_dir, config,
                                  mask=alive)
            nxt = _named_hit(nxt, "hit")
        nxt_miss = alive & ~nxt.is_hit

        if config.enable_env_map:
            env_fr, light_pdf2 = _env_miss_radiance_pdf(
                scene, config, hh, ww, l_dir)
            env_fr = env_fr * scene.env_intensity
            w2 = mis_weight(pdf_brdf, light_pdf2)
            lo = lo + jnp.where(nxt_miss[..., None],
                                w2[..., None] * history * env_fr, 0.0)
        else:
            sky = default_sky_color(l_dir[..., 1])
            lo = lo + jnp.where(nxt_miss[..., None], history * sky, 0.0)

        le = scene.material_of(nxt.tri).emissive
        lo = lo + jnp.where((alive & nxt.is_hit)[..., None],
                            history * le, 0.0)

        return PathState(
            origin=hit_point,
            direction=l_dir,
            t=nxt.t,
            tri=nxt.tri,
            inside=nxt.inside,
            history=history,
            lo=lo,
            alive=alive & nxt.is_hit,
        )

    if config.compaction_mode == "full":
        step = lambda b, st: _compacted_bounce(body, b, st, pixel_id,
                                               config.compaction_buckets)
    else:   # "casts": full-width shading, bucketed (detached) casts
        step = lambda b, st: body(b, st, pixel_id)
    final = _bounce_scan(step, state, config.max_bounce)
    return final.lo
