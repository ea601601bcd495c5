"""Scene assembly: meshes + materials + BVH + environment -> device arrays.

Replaces the reference's scene pipeline (src/core/Scene.h:35-257 and
src/core/GameObeject.h): instead of encoding each triangle with an inlined
material copy into 14 RGB32F texels (Triangle.h:28-39) and BVH nodes into 4
texels (BVH.h:17-21), the scene becomes a pytree of SoA device arrays:

- (N, 3) float32 vertex/normal arrays (leaf-ordered by the BVH permutation),
- (N,) int32 material indices into a MaterialTable (the differentiable
  parameter vector — a material edit is a table update, no re-upload),
- flat int32/float32 BVH node arrays,
- (H, W, 3) float32 environment radiance + importance cache.

Object identity survives as material-slot handles (the analogue of
GameObject.triangleIndex retargeting, GameObeject.h:8-14).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from . import mesh as mesh_lib
from .bvh import build_bvh, FlatBVH
from .hdr import (
    build_env_fetch,
    build_hdr_cache,
    load_hdr,
    make_gradient_hdr,
)
from .material import Material, MaterialTable, preset_materials

DEFAULT_ASSETS_DIR = os.environ.get("ORTF_ASSETS", "/root/reference/resources")


class SceneData(NamedTuple):
    """Device-resident scene (a pytree: shard/replicate/donate freely)."""

    p1: jax.Array
    p2: jax.Array
    p3: jax.Array
    n1: jax.Array
    n2: jax.Array
    n3: jax.Array
    mat_idx: jax.Array          # (N,) int32 -> materials
    materials: MaterialTable
    bvh_left: jax.Array         # (B,) int32
    bvh_right: jax.Array
    bvh_count: jax.Array
    bvh_first: jax.Array
    bvh_min: jax.Array          # (B, 3) float32
    bvh_max: jax.Array
    hdr_map: jax.Array          # (H, W, 3) float32
    env_intensity: jax.Array    # scalar float32 (RenderSettings.h:86)
    env_angle: jax.Array        # scalar float32 (RenderSettings.h:87)
    # Fused per-triangle table read by shading: one column per hit holds
    # the vertices, normals and material slot (ops.intersect.
    # surface_attributes); geometry gradients accumulate on it.
    tri_attr: jax.Array         # (20, N) f32 [p1 p2 p3 n1 n2 n3 mat_idx pad]
    env_fetch: jax.Array        # (H*W, 16) f32, layout: hdr.build_env_fetch
    # Full inverse-CDF cache (H, W, 3): only read by the GL-faithful
    # bilinear environment path (config.env_bilinear / the oracle parity
    # probes); the fast paths read the fused env_fetch table instead.
    hdr_cache: jax.Array        # (H, W, 3) f32, layout: hdr.build_hdr_cache

    @property
    def n_triangles(self) -> int:
        return self.p1.shape[0]

    @property
    def n_nodes(self) -> int:
        return self.bvh_left.shape[0]

    def triangle_vertices(self, tri_idx):
        """Gather (p1, p2, p3) for triangle ids (clamped; callers mask)."""
        safe = jnp.clip(tri_idx, 0, self.n_triangles - 1)
        return self.p1[safe], self.p2[safe], self.p3[safe]

    def triangle_normals(self, tri_idx):
        safe = jnp.clip(tri_idx, 0, self.n_triangles - 1)
        return self.n1[safe], self.n2[safe], self.n3[safe]

    def material_of(self, tri_idx) -> Material:
        safe = jnp.clip(tri_idx, 0, self.n_triangles - 1)
        # single-row fetch from the fused table (fast gather layout), then
        # a one-hot contraction over the small material table
        midx = self.tri_attr[18, safe].astype(jnp.int32)
        return self.materials.gather(midx)

    def with_materials(self, table: MaterialTable) -> "SceneData":
        return self._replace(materials=table)


class SceneObject(NamedTuple):
    name: str
    material_slot: int
    n_triangles: int


class Scene:
    """Host-side scene builder (the analogue of InitScene, Scene.h:35-51)."""

    def __init__(self):
        self._tris: list = []          # per-object (p1, p2, p3, n1, n2, n3)
        self._materials: list = []     # Material per slot
        self._mat_slots: list = []     # per-object slot
        self.objects: list[SceneObject] = []
        self._hdr: np.ndarray | None = None

    def add_material(self, material: Material) -> int:
        self._materials.append(material)
        return len(self._materials) - 1

    def add_object(self, mesh: mesh_lib.MeshData, material, transform=None,
                   smooth_normal: bool = False, normalize: bool = True,
                   name: str = "") -> SceneObject:
        """material: a Material (new slot) or an int slot (shared)."""
        if transform is None:
            transform = np.eye(4, dtype=np.float32)
        slot = material if isinstance(material, int) else self.add_material(material)
        tris = mesh_lib.mesh_to_triangles(
            mesh, transform, smooth_normal=smooth_normal, normalize=normalize)
        self._tris.append(tris)
        self._mat_slots.append(slot)
        obj = SceneObject(name=name or f"object{len(self.objects)}",
                          material_slot=slot, n_triangles=tris[0].shape[0])
        self.objects.append(obj)
        return obj

    def set_environment(self, hdr: np.ndarray) -> None:
        self._hdr = np.asarray(hdr, np.float32)

    def load_environment(self, path: str) -> None:
        self.set_environment(load_hdr(path))

    def build(self, leaf_size: int = 8, bvh_method: str = "sah",
              env_intensity: float = 1.0, env_angle: float = 0.0
              ) -> SceneData:
        if not self._tris:
            raise ValueError("scene has no objects")
        parts = [np.concatenate([t[k] for t in self._tris]) for k in range(6)]
        p1, p2, p3, n1, n2, n3 = parts
        mat_idx = np.concatenate([
            np.full(t[0].shape[0], slot, np.int32)
            for t, slot in zip(self._tris, self._mat_slots)])

        bvh: FlatBVH = build_bvh(p1, p2, p3, leaf_size=leaf_size,
                                 method=bvh_method)
        perm = bvh.perm
        p1, p2, p3 = p1[perm], p2[perm], p3[perm]
        n1, n2, n3 = n1[perm], n2[perm], n3[perm]
        mat_idx = mat_idx[perm]

        tri_attr = np.zeros((20, p1.shape[0]), np.float32)
        tri_attr[0:3] = p1.T
        tri_attr[3:6] = p2.T
        tri_attr[6:9] = p3.T
        tri_attr[9:12] = n1.T
        tri_attr[12:15] = n2.T
        tri_attr[15:18] = n3.T
        tri_attr[18] = mat_idx.astype(np.float32)

        hdr = self._hdr if self._hdr is not None else make_gradient_hdr()
        cache = build_hdr_cache(hdr)
        env_fetch = build_env_fetch(hdr, cache)

        table = MaterialTable.stack(self._materials)
        dev = jnp.asarray
        return SceneData(
            p1=dev(p1), p2=dev(p2), p3=dev(p3),
            n1=dev(n1), n2=dev(n2), n3=dev(n3),
            mat_idx=dev(mat_idx),
            materials=table,
            bvh_left=dev(bvh.left), bvh_right=dev(bvh.right),
            bvh_count=dev(bvh.count), bvh_first=dev(bvh.first),
            bvh_min=dev(bvh.aabb_min), bvh_max=dev(bvh.aabb_max),
            # NOTE: the host-built inverse-CDF cache is folded into env_fetch
            # (hdr.build_env_fetch) and not carried on device separately —
            # the fast paths read only the fused table.
            hdr_map=dev(hdr),
            env_intensity=jnp.asarray(env_intensity, jnp.float32),
            env_angle=jnp.asarray(env_angle, jnp.float32),
            tri_attr=dev(tri_attr),
            env_fetch=dev(env_fetch),
            hdr_cache=dev(cache),
        )


# ---------------------------------------------------------------------------
# Reference scene presets (InitMesh, Scene.h:111-162)
# ---------------------------------------------------------------------------

_OBJ_FILES = {
    "floor": "objects/floor.obj",
    "bunny": "objects/bunny_4000.obj",
    "sphere": "objects/sphere.obj",
    "loong": "objects/loong_100000.obj",
    "panther": "objects/panther_100000.obj",
}

# (rotate_deg, translate, scale, smooth) straight from Scene.h:113-158.
_OBJ_TRANSFORMS = {
    "floor": ((0, 0, 0), (2.2, -2.0, 3.0), (14.0, 7.0, 7.0), False),
    "bunny": ((0, 0, 0), (2.2, -2.5, 3.0), (2.0, 2.0, 2.0), False),
    "sphere": ((0, 90, 0), (1.8, -1.0, 3.0), (2.0, 2.0, 2.0), True),
    "loong": ((0, 0, 0), (2.0, -2.0, 3.0), (3.5, 3.5, 3.5), True),
    "panther": ((0, -30, 0), (0.8, -2.2, 5.0), (4.5, 4.5, 4.5), True),
}

DEFAULT_HDR = "textures/hdr/peppermint_powerplant_1k.hdr"


def build_reference_scene(objects=("floor", "loong"),
                          current_material: str = "tear_glass",
                          assets_dir: str = DEFAULT_ASSETS_DIR,
                          hdr_name: str = DEFAULT_HDR,
                          leaf_size: int = 8) -> tuple[Scene, SceneData]:
    """The reference's built-in scene: floor gets the `plane` preset, every
    other object shares the `current_material` slot (Scene.h:111-162)."""
    presets = preset_materials()
    scene = Scene()
    shared_slot = None
    for name in objects:
        path = os.path.join(assets_dir, _OBJ_FILES[name])
        if not os.path.exists(path):
            # The reference's Scene.h:146-158 references panther_100000.obj,
            # but the asset does not ship in its resources/ — fail loudly
            # instead of skipping. BASELINE config-4 physics
            # (brown glass ABSORB + refraction on 100k geometry) is covered
            # by the brown_loong golden (exp/make_goldens.py).
            raise FileNotFoundError(
                f"scene object '{name}': {path} does not exist"
                + (" (the reference repo does not ship this asset; use "
                   "loong with material='brown_glass' for the same physics)"
                   if name == "panther" else ""))
        mesh = mesh_lib.load_obj(path)
        rot, trans, scale, smooth = _OBJ_TRANSFORMS[name]
        tm = mesh_lib.transform_matrix(rot, trans, scale)
        if name == "floor":
            scene.add_object(mesh, presets["plane"], tm, smooth_normal=smooth,
                             name=name)
        else:
            if shared_slot is None:
                shared_slot = scene.add_material(presets[current_material])
            scene.add_object(mesh, shared_slot, tm, smooth_normal=smooth,
                             name=name)
    hdr_path = os.path.join(assets_dir, hdr_name)
    if os.path.exists(hdr_path):
        scene.load_environment(hdr_path)
    return scene, scene.build(leaf_size=leaf_size)


def build_test_scene(n_sphere_subdiv: int = 1,
                     material: Material | None = None,
                     env: np.ndarray | None = None) -> tuple[Scene, SceneData]:
    """Small procedural scene (floor quad + icosphere) for tests/demos; no
    external assets needed."""
    presets = preset_materials()
    scene = Scene()
    floor_tm = mesh_lib.transform_matrix((0, 0, 0), (0.0, -1.0, 3.0),
                                         (10.0, 1.0, 10.0))
    scene.add_object(mesh_lib.make_quad(), presets["white"], floor_tm,
                     smooth_normal=False, normalize=False, name="floor")
    sphere_tm = mesh_lib.transform_matrix((0, 0, 0), (0.0, 0.0, 3.0),
                                          (1.0, 1.0, 1.0))
    scene.add_object(mesh_lib.make_icosphere(n_sphere_subdiv),
                     material if material is not None else presets["white"],
                     sphere_tm, smooth_normal=True, normalize=False,
                     name="sphere")
    scene.set_environment(env if env is not None else make_gradient_hdr())
    return scene, scene.build()
