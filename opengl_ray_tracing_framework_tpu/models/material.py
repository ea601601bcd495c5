"""Disney-principled material model.

The parameter set of the reference (src/core/Material.h:25-50): emissive,
baseColor, subsurface, metallic, specular, specularTint, roughness,
anisotropic, sheen, sheenTint, clearcoat, clearcoatGloss, IOR, transmission,
plus a participating-medium description {type, color, density, anisotropy}
(MediumType, Material.h:17-23).

Redesign: instead of baking a material copy into every encoded
triangle (Triangle_encoded, src/core/Triangle.h:28-39) and re-uploading the
whole texture buffer on each edit (RefreshTriangleMaterial, Triangle.h:
133-151), materials live in a small `MaterialTable` pytree of (M, ...)
arrays indexed by a per-triangle int32 — the differentiable parameter
vector of the framework. Editing a material is a functional table update;
gradients w.r.t. every field come for free from reverse-mode AD.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

MEDIUM_NONE = 0
MEDIUM_ABSORB = 1
MEDIUM_SCATTER = 2
MEDIUM_EMISSIVE = 3


class Material(NamedTuple):
    """One material (or a batch: every field broadcasts over leading dims).

    Scalar fields are float32 arrays; colors are (..., 3).
    Defaults mirror Material.h:25-50 (note default IOR there is 1.0).
    """

    emissive: jax.Array
    base_color: jax.Array
    subsurface: jax.Array
    metallic: jax.Array
    specular: jax.Array
    specular_tint: jax.Array
    roughness: jax.Array
    anisotropic: jax.Array
    sheen: jax.Array
    sheen_tint: jax.Array
    clearcoat: jax.Array
    clearcoat_gloss: jax.Array
    ior: jax.Array
    transmission: jax.Array
    medium_color: jax.Array
    medium_type: jax.Array        # int32: MEDIUM_*
    medium_density: jax.Array
    medium_anisotropy: jax.Array

    @staticmethod
    def make(
        emissive=(0.0, 0.0, 0.0),
        base_color=(1.0, 1.0, 1.0),
        subsurface=0.0,
        metallic=0.0,
        specular=0.0,
        specular_tint=0.0,
        roughness=0.0,
        anisotropic=0.0,
        sheen=0.0,
        sheen_tint=0.0,
        clearcoat=0.0,
        clearcoat_gloss=0.0,
        ior=1.0,
        transmission=0.0,
        medium_color=(1.0, 1.0, 1.0),
        medium_type=MEDIUM_NONE,
        medium_density=0.0,
        medium_anisotropy=0.0,
    ) -> "Material":
        f = lambda x: jnp.asarray(x, jnp.float32)
        return Material(
            emissive=f(emissive),
            base_color=f(base_color),
            subsurface=f(subsurface),
            metallic=f(metallic),
            specular=f(specular),
            specular_tint=f(specular_tint),
            roughness=f(roughness),
            anisotropic=f(anisotropic),
            sheen=f(sheen),
            sheen_tint=f(sheen_tint),
            clearcoat=f(clearcoat),
            clearcoat_gloss=f(clearcoat_gloss),
            ior=f(ior),
            transmission=f(transmission),
            medium_color=f(medium_color),
            medium_type=jnp.asarray(medium_type, jnp.int32),
            medium_density=f(medium_density),
            medium_anisotropy=f(medium_anisotropy),
        )

    def alpha_xy(self):
        """Anisotropic GGX roughness (ax, ay), derived like glsl:205-207."""
        aspect = jnp.sqrt(1.0 - self.anisotropic * 0.9)
        r2 = jnp.square(self.roughness)
        ax = jnp.maximum(0.001, r2 / aspect)
        ay = jnp.maximum(0.001, r2 * aspect)
        return ax, ay


class MaterialTable(NamedTuple):
    """Stacked materials: a Material whose leaves have leading dim M."""

    mat: Material

    @staticmethod
    def stack(materials: list) -> "MaterialTable":
        stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *materials)
        return MaterialTable(mat=stacked)

    @property
    def count(self) -> int:
        return self.mat.emissive.shape[0]

    def gather(self, idx) -> Material:
        """Per-hit material fetch: idx int32 (...,) -> Material batch.

        One-hot contraction over the small table: trivially
        differentiable w.r.t. the table (the inverse-rendering parameter
        vector). HIGHEST precision keeps the f32 contraction exact on GPUs,
        whose default f32 matmul precision is TF32."""
        safe = jnp.clip(idx, 0, self.count - 1)
        onehot = (safe[..., None] ==
                  jnp.arange(self.count, dtype=idx.dtype)).astype(jnp.float32)

        def pick(a):
            if a.dtype != jnp.float32:
                # int/bool fields (medium_type): plain gather — exact for
                # any value, and id-like fields need no gradient anyway
                return a[safe]
            flat = a.reshape(self.count, -1)
            out = jnp.einsum("...m,mf->...f", onehot, flat,
                             precision=jax.lax.Precision.HIGHEST)
            return out.reshape(safe.shape + a.shape[1:])

        return jax.tree.map(pick, self.mat)

    def replace_material(self, slot: int, material: Material) -> "MaterialTable":
        """Functional material edit — the analogue of the reference's
        RefreshTriangleMaterial + full TBO re-upload (Triangle.h:133-151)."""
        new = jax.tree.map(lambda tab, m: tab.at[slot].set(m), self.mat, material)
        return MaterialTable(mat=new)


# ---------------------------------------------------------------------------
# Built-in material presets (Scene.h:53-109), reproduced 1:1.
# ---------------------------------------------------------------------------


def preset_materials() -> dict:
    return {
        "plane": Material.make(base_color=(0.73, 0.73, 0.73), specular=1.0,
                               ior=1.79, metallic=0.2),
        "white": Material.make(base_color=(0.73, 0.73, 0.73), roughness=0.5,
                               specular=0.5),
        "jade": Material.make(base_color=(0.55, 0.78, 0.55), specular=1.0,
                              ior=1.79, subsurface=1.0),
        "golden": Material.make(base_color=(0.75, 0.7, 0.15), roughness=0.05,
                                specular=1.0, metallic=1.0),
        "copper": Material.make(
            base_color=(238.0 / 255.0, 158.0 / 255.0, 137.0 / 255.0),
            roughness=0.2, specular=1.0, ior=1.21901, metallic=1.0),
        "glass": Material.make(base_color=(1.0, 1.0, 1.0), specular=1.0,
                               transmission=1.0, ior=1.5, roughness=0.02),
        "brown_glass": Material.make(
            base_color=(1.0, 1.0, 1.0), medium_type=MEDIUM_ABSORB,
            medium_color=(0.905, 0.63, 0.3), medium_density=1.0,
            specular=1.0, transmission=0.957, ior=1.45, roughness=0.1),
        "tear_glass": Material.make(
            base_color=(1.0, 1.0, 1.0), medium_color=(0.085, 0.917, 0.848),
            medium_density=1.0, medium_type=MEDIUM_ABSORB, specular=1.0,
            transmission=0.917, ior=1.45),
        "tear_glass_emissive": Material.make(
            base_color=(1.0, 1.0, 1.0), medium_color=(0.085, 0.917, 0.848),
            medium_density=0.25, medium_type=MEDIUM_EMISSIVE, specular=1.0,
            transmission=0.917, ior=1.45),
    }
