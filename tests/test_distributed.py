"""Two-process jax.distributed smoke test on CPU.

Executes the actual multi-host bring-up path (parallel/sharding.py
init_distributed -> global 2-device mesh -> render_pass_sharded) across
two OS processes connected by the distributed runtime, and checks each
process's row shard against an unsharded render. This is the committed
evidence that the multi-host code path runs, not just compiles.
"""

import os
import socket
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "distributed_worker.py")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_distributed_render():
    coordinator = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)          # one device per process
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, coordinator, "2", str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True)
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=420)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("distributed workers timed out:\n" + "\n".join(outs))
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"
        assert "sharded rows match unsharded render" in out
