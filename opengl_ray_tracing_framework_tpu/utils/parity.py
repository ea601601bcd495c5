"""Tracer parity against the plain reference, as numbers.

The CPU tests, the GPU lane (tests/test_gpu.py) and chip_smoke.py all hold
a tracer to the same two contracts, and report the measured values beside
each limit:

- hit level (`hit_parity`): hit or miss agrees for every ray; t agrees to
  rtol = atol = 1e-4 where both hit; at least 99.5% of rays pick the same
  triangle (exact ties between coincident triangles are allowed); `inside`
  agrees wherever the triangle agrees;
- image level (`image_parity`): the same estimator with the same RNG, so
  only float ordering may differ: means within 1e-4 relative, and fewer
  than 0.1% of pixel channels outside atol = rtol = 1e-3.
"""

from __future__ import annotations

import numpy as np

HIT_T_TOL = 1e-4          # rtol = atol on t
HIT_TRI_AGREE = 0.995     # share of common hits with the same triangle
IMG_MEAN_REL = 1e-4       # relative difference of image means
IMG_TOL = 1e-3            # rtol = atol per pixel channel
IMG_OUTSIDE = 1e-3        # share of channels allowed outside IMG_TOL


def hit_parity(hit, ref) -> dict:
    """Measured hit-level agreement of `hit` with the reference `ref`."""
    tri, rtri = np.asarray(hit.tri), np.asarray(ref.tri)
    got, want = tri >= 0, rtri >= 0
    both = got & want
    t, rt = np.asarray(hit.t)[both], np.asarray(ref.t)[both]
    same = tri[both] == rtri[both]
    inside = np.asarray(hit.inside)[both][same]
    rinside = np.asarray(ref.inside)[both][same]
    return {
        "rays": int(tri.shape[0]),
        "hits": int(want.sum()),
        "hit_mismatch": int((got != want).sum()),
        "t_max_abs_err": float(np.abs(t - rt).max(initial=0.0)),
        # worst |dt| in units of the allowed atol + rtol*|t_ref|
        "t_err_over_tol": float((np.abs(t - rt)
                                 / (HIT_T_TOL + HIT_T_TOL * np.abs(rt))
                                 ).max(initial=0.0)),
        "tri_agree": float(same.mean()) if same.size else 1.0,
        "inside_mismatch": int((inside != rinside).sum()),
    }


def hit_parity_ok(m: dict) -> bool:
    return (m["hit_mismatch"] == 0 and m["t_err_over_tol"] <= 1.0
            and m["tri_agree"] >= HIT_TRI_AGREE
            and m["inside_mismatch"] == 0)


def image_parity(img, ref) -> dict:
    """Measured image-level agreement of `img` with the reference `ref`."""
    img = np.asarray(img, np.float64)
    ref = np.asarray(ref, np.float64)
    outside = ~np.isclose(img, ref, atol=IMG_TOL, rtol=IMG_TOL)
    return {
        "finite": bool(np.isfinite(img).all()),
        "mean": float(img.mean()),
        "ref_mean": float(ref.mean()),
        "mean_rel_err": float(abs(img.mean() - ref.mean())
                              / max(abs(ref.mean()), 1e-6)),
        "outside_frac": float(outside.mean()),
        "max_abs_err": float(np.abs(img - ref).max()),
    }


def image_parity_ok(m: dict) -> bool:
    return (m["finite"] and m["mean_rel_err"] <= IMG_MEAN_REL
            and m["outside_frac"] < IMG_OUTSIDE)
