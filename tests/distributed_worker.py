"""Worker for the 2-process jax.distributed smoke test (test_distributed).

Each process contributes one CPU device; the two form a 2-device "tiles"
mesh. The worker renders a tiny scene with render_pass_sharded and checks
its addressable row block equals the same rows of an unsharded local
render — executing the real multi-host code path (init_distributed ->
mesh over global devices -> shard_map trace) that several hosts would
run, with the network replaced by localhost gRPC.

Invoked by tests/test_distributed.py:
    python tests/distributed_worker.py <coordinator> <num_procs> <pid>
"""
import sys

import jax

# stay on the CPU backend even where a GPU is present, before any backend
# init
jax.config.update("jax_platforms", "cpu")

coordinator, num_procs, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from opengl_ray_tracing_framework_tpu.parallel.sharding import (  # noqa: E402
    init_distributed,
    make_mesh,
    render_pass_sharded,
    replicate_scene,
)

n_global = init_distributed(coordinator, num_procs, pid)
assert n_global == num_procs, f"expected {num_procs} devices, got {n_global}"
assert jax.process_count() == num_procs
assert len(jax.local_devices()) == 1

import numpy as np  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from opengl_ray_tracing_framework_tpu import RenderConfig  # noqa: E402
from opengl_ray_tracing_framework_tpu.models.camera import Camera  # noqa: E402
from opengl_ray_tracing_framework_tpu.models.scene import (  # noqa: E402
    build_test_scene,
)
from opengl_ray_tracing_framework_tpu.render import (  # noqa: E402
    init_render_state,
    render_pass,
)

_, scene = build_test_scene()
camera = Camera.make(position=(0.0, 0.5, -2.0), yaw=90.0, pitch=-8.0,
                     zoom=30.0, aspect=1.0)
config = RenderConfig(width=32, height=32, max_bounce=3, spp_per_pass=1,
                      tracer="whileloop")

mesh = make_mesh(jax.devices())
scene_r = replicate_scene(scene, mesh)
state = init_render_state(config)
state = jax.device_put(
    state, type(state)(accum=NamedSharding(mesh, P("tiles", None, None)),
                       n_samples=NamedSharding(mesh, P())))
state = render_pass_sharded(scene_r, camera, state, config, mesh,
                            rays_per_tile=1024)
jax.block_until_ready(state.accum)

# unsharded local reference on this process's own device
ref = render_pass(scene, camera, init_render_state(config), config,
                  rays_per_tile=1024)
ref_rows = np.asarray(ref.accum)

rows_per_dev = config.height // num_procs
for shard in state.accum.addressable_shards:
    r0 = shard.index[0].start or 0
    got = np.asarray(shard.data)
    want = ref_rows[r0:r0 + rows_per_dev]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

print(f"proc {pid}/{num_procs}: sharded rows match unsharded render "
      f"(mean {ref_rows.mean():.4f})")
