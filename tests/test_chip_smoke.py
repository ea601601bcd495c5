"""chip_smoke.py refuses to run without a GPU, and prints no result."""

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "chip_smoke.py")


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _no_result(out):
    assert out.returncode != 0
    last = (out.stdout.strip().splitlines() or [""])[-1]
    assert '"ok"' not in last and '"ok"' not in out.stdout
    try:
        json.loads(last)
    except ValueError:
        return
    raise AssertionError(f"printed a JSON line: {last}")


def test_fails_on_cpu_only_jax(tmp_path):
    out = _run(REPO, SMOKE)
    _no_result(out)
    assert "no GPU backend" in out.stderr


def test_fails_without_the_repository(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(SMOKE, alone)
    _no_result(_run(tmp_path, str(alone)))
