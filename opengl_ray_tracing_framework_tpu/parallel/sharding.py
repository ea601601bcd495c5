"""Multi-chip rendering: shard pixels over a device mesh.

The reference's only parallelism is fragment-shader SIMT on one GPU
(glsl:1518, one invocation per pixel). The multi-device mapping
(SURVEY.md §2.4):

- data-parallel axis = pixels: the image is split into row blocks across a
  1-D `jax.sharding.Mesh` axis ("tiles"); each device traces its rows,
- the scene (triangles, BVH, HDR maps, materials) is *replicated* into every
  device's memory — 100k triangles encode to a few MB,
- accumulation is local (each device owns its rows), so the hot loop needs
  **zero collectives**; only gradient reduction (parallel.autodiff) and
  whole-image gathers cross the interconnect.

Works identically on several GPUs (XLA hands collectives to NCCL) and on
the CPU-simulated mesh (XLA_FLAGS=--xla_force_host_platform_device_count=N)
used by tests.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.camera import Camera, pixel_uv
from ..ops.integrator import trace_radiance
from ..ops.sampling import rand01
from ..render import RenderState
from ..utils.config import RenderConfig, jit


def make_mesh(devices=None, axis_name: str = "tiles") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    import numpy as np
    return Mesh(np.asarray(devices), (axis_name,))


def make_mesh_2d(devices=None, n_tiles: int | None = None) -> Mesh:
    """2-D mesh ("tiles", "spp"): pixel rows x samples-per-pixel.

    The spp axis shards the *temporal* accumulation axis (SURVEY.md §2.4
    item 2): every spp-group renders the same pixels at different
    progressive frames and the running mean is psum-merged — the second
    way to scale a fixed-resolution render past the pixel count."""
    devices = devices if devices is not None else jax.devices()
    import numpy as np
    devices = np.asarray(devices)
    n = devices.size
    if n_tiles is None:
        n_tiles = n // 2 if n % 2 == 0 and n > 1 else n
    if n % n_tiles:
        raise ValueError(f"{n} devices not divisible into {n_tiles} tiles")
    return Mesh(devices.reshape(n_tiles, n // n_tiles), ("tiles", "spp"))


def replicate_scene(scene, mesh: Mesh):
    """Place every scene leaf fully replicated on the mesh."""
    sharding = NamedSharding(mesh, P())
    return jax.device_put(scene, sharding)


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> int:
    """Multi-host bring-up: jax.distributed.initialize from explicit args
    or the JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID
    environment (no-op single-host when neither is present). Returns the
    global device count. After this, the same mesh/shard_map code scales
    rows over every host's chips — the scene is replicated per chip and
    the hot loop stays collective-free, so DCN only carries startup and
    image gathers."""
    import os
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes
            or int(os.environ.get("JAX_NUM_PROCESSES", "1")),
            process_id=process_id
            or int(os.environ.get("JAX_PROCESS_ID", "0")),
        )
    return len(jax.devices())


def render_pass_sharded(scene, camera: Camera, state: RenderState,
                        config: RenderConfig, mesh: Mesh,
                        rays_per_tile: int = 65536) -> RenderState:
    """One (or spp_per_pass) progressive samples with pixels sharded over
    the mesh's "tiles" axis and, when the mesh has an "spp" axis, sample
    batches sharded over it (one psum-mean per pass is then the only
    collective). The accumulator stays sharded across passes; no other
    communication until the image is fetched."""
    n_tiles = dict(zip(mesh.axis_names, mesh.devices.shape))["tiles"]
    if config.height % n_tiles != 0:
        raise ValueError(
            f"height {config.height} not divisible by {n_tiles} tiles")
    row_sharding = NamedSharding(mesh, P("tiles", None, None))
    rep = NamedSharding(mesh, P())
    impl = _sharded_pass_impl_2d if "spp" in mesh.axis_names \
        else _sharded_pass_impl

    @jit(static_argnames=("config", "rays_per_tile"),
         in_shardings=(rep, rep,
                       RenderState(accum=row_sharding, n_samples=rep)),
         out_shardings=RenderState(accum=row_sharding, n_samples=rep))
    def step(scene, camera, state, config=config,
             rays_per_tile=rays_per_tile):
        return impl(scene, camera, state, config, mesh, rays_per_tile)

    return step(scene, camera, state)


def _sharded_pass_impl_2d(scene, camera, state, config, mesh, rays_per_tile):
    """("tiles", "spp") body: device (i, j) traces row block i at sample
    frames j*L..j*L+L-1; the spp groups psum-merge their means."""
    from jax import shard_map

    shape = dict(zip(mesh.axis_names, mesh.devices.shape))
    n_tiles, n_spp = shape["tiles"], shape["spp"]
    rows_per_dev = config.height // n_tiles
    if config.spp_per_pass % n_spp:
        raise ValueError(
            f"spp_per_pass {config.spp_per_pass} not divisible by the "
            f"spp axis ({n_spp})")
    local_spp = config.spp_per_pass // n_spp

    def device_block(scene, camera, accum_block, n_samples, tile_ids,
                     spp_ids):
        row0 = tile_ids[0] * rows_per_dev
        base = n_samples + spp_ids[0] * local_spp
        mean = jnp.zeros_like(accum_block)
        for s in range(local_spp):
            sample = _trace_rows(scene, camera, base + (s + 1), config,
                                 row0, rows_per_dev, rays_per_tile)
            mean = mean + (sample - mean) / (s + 1)
        mean = jax.lax.psum(mean, "spp") / n_spp
        spp = config.spp_per_pass
        cnt = (n_samples + spp).astype(jnp.float32)
        return accum_block + (mean - accum_block) * (spp / cnt)

    accum = shard_map(
        device_block,
        mesh=mesh,
        in_specs=(P(), P(), P("tiles", None, None), P(), P("tiles"),
                  P("spp")),
        out_specs=P("tiles", None, None),
        check_vma=False,   # Pallas kernel bodies carry no vma types
    )(scene, camera, state.accum, state.n_samples,
      jnp.arange(n_tiles, dtype=jnp.int32),
      jnp.arange(n_spp, dtype=jnp.int32))
    return RenderState(accum=accum,
                       n_samples=state.n_samples + config.spp_per_pass)


def _sharded_pass_impl(scene, camera, state, config, mesh, rays_per_tile):
    """shard_map body: each device traces its own block of rows."""
    from jax import shard_map

    n_dev = mesh.devices.size
    rows_per_dev = config.height // n_dev

    def device_block(scene, camera, accum_block, n_samples, dev_idx):
        dev = dev_idx[0]
        accum = accum_block
        n = n_samples
        for s in range(config.spp_per_pass):
            frame = n + (s + 1)
            sample = _trace_rows(scene, camera, frame, config,
                                 dev * rows_per_dev, rows_per_dev,
                                 rays_per_tile)
            cnt = (n + s + 1).astype(jnp.float32)
            accum = accum + (sample - accum) / cnt
        return accum

    dev_ids = jnp.arange(n_dev, dtype=jnp.int32)
    accum = shard_map(
        device_block,
        mesh=mesh,
        in_specs=(P(), P(), P("tiles", None, None), P(), P("tiles")),
        out_specs=P("tiles", None, None),
        check_vma=False,   # Pallas kernel bodies carry no vma types
    )(scene, camera, state.accum, state.n_samples, dev_ids)
    return RenderState(accum=accum,
                       n_samples=state.n_samples + config.spp_per_pass)


def _trace_rows(scene, camera, frame, config, row0, n_rows, rays_per_tile,
                flat: bool = False):
    """Trace rows [row0, row0 + n_rows) -> (n_rows, W, 3) radiance.

    flat=True returns the radiance 1-D (n_rows * W * 3,), row-major and
    xyz-interleaved: the differentiable loss path (parallel.autodiff)
    compares it with the flattened target, so the cotangent of the whole
    image is one dense 1-D vector."""
    w = config.width
    n_rays = n_rows * w
    pixel_id = (jnp.arange(n_rays, dtype=jnp.uint32)
                + jnp.uint32(w) * row0.astype(jnp.uint32))

    xs = (pixel_id % jnp.uint32(w)).astype(jnp.float32)
    ys = (pixel_id // jnp.uint32(w)).astype(jnp.float32)
    if config.pixel_jitter:
        ju = rand01(pixel_id, frame, 1001)
        jv = rand01(pixel_id, frame, 1002)
    else:
        ju = 0.5
        jv = 0.5
    u = (xs + ju) / w
    v = (ys + jv) / config.height

    origin, direction = camera.generate_rays(u, v)

    tile = min(rays_per_tile, n_rays)
    pad = (-n_rays) % tile
    if pad:
        origin = jnp.concatenate([origin, origin[:pad]])
        direction = jnp.concatenate([direction, direction[:pad]])
        pixel_id = jnp.concatenate([pixel_id, pixel_id[:pad]])
    n_tiles = origin.shape[0] // tile

    from ..render import tile_traced

    tile_fn = tile_traced(scene, frame, config)
    radiance = jax.lax.map(
        lambda args: tile_fn(*args),
        (origin.reshape(n_tiles, tile * 3),
         direction.reshape(n_tiles, tile * 3),
         pixel_id.reshape(n_tiles, tile)),
    ).reshape(-1, 3)[:n_rays]
    if flat:
        return radiance.reshape(-1)
    return radiance.reshape(n_rows, w, 3)
