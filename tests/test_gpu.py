"""GPU lane: the card-only checks of chip_smoke.py as tests.

    python -m pytest tests/ -m gpu -q              # parity, minutes
    python -m pytest tests/ -m "gpu and slow" -q   # flagship-shape pins

Each test runs one phase of chip_smoke.py against the plain reference on
the card: the compiled BVH kernel (no interpreter) on the 81,922-triangle
tear_glass scene. Off a GPU backend they skip.
"""

import pytest

import chip_smoke

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def scene():
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU backend")
    return chip_smoke.smoke_scene()


def test_hit_parity_vs_brute(scene):
    """65,536 camera + 65,536 random rays, compiled kernel vs brute force
    (utils/parity.py hit-level contract)."""
    chip_smoke.phase_hit_parity(scene)


def test_image_parity_vs_whileloop(scene):
    """256x128, 8 bounces, 2 spp through the kernel vs the while-loop
    tracer (utils/parity.py image-level contract)."""
    chip_smoke.phase_image_parity(scene)


@pytest.mark.slow
def test_flagship_render_passes(scene):
    """render_pass / render_passes at 1024x512x8 with 131072-ray tiles:
    finite, image mean > 0.01."""
    chip_smoke.phase_forward(scene, chip_smoke.CacheCounter())


@pytest.mark.slow
def test_flagship_material_grad(scene):
    """material_grad at 1024x512x8 with the 131072-ray backward tile:
    finite loss and gradients."""
    chip_smoke.phase_backward(scene, chip_smoke.CacheCounter())
