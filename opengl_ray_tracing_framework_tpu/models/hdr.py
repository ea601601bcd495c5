"""Radiance (.hdr) decoding and the environment importance-sampling cache.

Host-side equivalents of:
- thirdparty/hdrloader (hdrloader.cpp:1-191): RGBE scanline decoding (both
  new-style RLE and flat scanlines) -> float32 RGB.
- calculateHdrCache (src/core/Utility.h:33-131): the inverse-CDF table used
  by the kernel's environment importance sampling (SampleHdr glsl:635-646,
  hdrPdf glsl:1173-1186).

Cache layout (identical to the reference texture): an (H, W, 3) float32
array where channel R,G at cache[i, j] hold the inverse-CDF image sample
position (x/W, y/H) for stratified uniforms (xi_1 = i/H, xi_2 = j/W), and
channel B at cache[i, j] holds the *image-space* discrete pdf of pixel
(i, j). R,G form a lookup table addressed by uniforms; B is addressed by
direction — two tables packed in one texture, exactly like the reference.
"""

from __future__ import annotations

import numpy as np


def load_hdr(path: str) -> np.ndarray:
    """Decode a Radiance RGBE file to (H, W, 3) float32."""
    with open(path, "rb") as fh:
        data = fh.read()

    # Header: lines until blank, then the resolution line.
    pos = 0

    def read_line():
        nonlocal pos
        end = data.index(b"\n", pos)
        line = data[pos:end]
        pos = end + 1
        return line

    magic = read_line()
    if not (magic.startswith(b"#?RADIANCE") or magic.startswith(b"#?RGBE")):
        raise ValueError(f"not a Radiance file: {magic[:20]!r}")
    while True:
        line = read_line()
        if line.strip() == b"":
            break
    res = read_line().split()
    if res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"unsupported orientation {res!r}")
    height = int(res[1])
    width = int(res[3])

    raw = np.frombuffer(data, np.uint8, offset=pos)
    out = np.zeros((height, width, 4), np.uint8)
    ptr = 0
    prev = np.zeros(4, np.uint8)   # last decoded pixel, for old-style runs

    def old_decrunch(y, x, ptr, prev):
        """Old-format RLE: (1,1,1,count) markers repeat the previous pixel,
        consecutive markers shift the count by 8 more bits each
        (hdrloader.cpp:160-190 oldDecrunch)."""
        rshift = 0
        while x < width:
            q = raw[ptr:ptr + 4]
            ptr += 4
            if q[0] == 1 and q[1] == 1 and q[2] == 1:
                count = min(int(q[3]) << rshift, width - x)
                out[y, x:x + count] = prev
                x += count
                rshift += 8
            else:
                out[y, x] = q
                prev = q
                x += 1
                rshift = 0
        return ptr, prev

    for y in range(height):
        # New-style detection follows decrunch (hdrloader.cpp:118-139):
        # anything that is not a (2, 2, hi, lo) header decodes old-style.
        if width < 8 or width > 0x7FFF or raw[ptr] != 2:
            ptr, prev = old_decrunch(y, 0, ptr, prev)
            continue
        if raw[ptr + 1] != 2 or (raw[ptr + 2] & 0x80):
            # first pixel is literal (2, g, b, e); rest is old-style
            out[y, 0] = raw[ptr:ptr + 4]
            prev = raw[ptr:ptr + 4]
            ptr, prev = old_decrunch(y, 1, ptr + 4, prev)
            continue
        scan_w = (int(raw[ptr + 2]) << 8) | int(raw[ptr + 3])
        if scan_w != width:
            raise ValueError("scanline width mismatch")
        ptr += 4
        for c in range(4):  # components stored planar, RLE per channel
            x = 0
            while x < width:
                code = int(raw[ptr]); ptr += 1
                if code > 128:  # run
                    out[y, x:x + code - 128, c] = raw[ptr]
                    ptr += 1
                    x += code - 128
                else:           # literal
                    out[y, x:x + code, c] = raw[ptr:ptr + code]
                    ptr += code
                    x += code
        prev = out[y, -1]

    rgbe = out.astype(np.float32)
    e = rgbe[..., 3]
    # convertComponent (hdrloader.cpp): f = c * 2^(e-128) / 256
    scale = np.where(e > 0.0, np.ldexp(1.0, (e - 136.0).astype(np.int32)), 0.0)
    return (rgbe[..., :3] * scale[..., None]).astype(np.float32)


def build_hdr_cache(hdr: np.ndarray) -> np.ndarray:
    """Importance-sampling cache (calculateHdrCache, Utility.h:33-131).

    hdr: (H, W, 3) float32 radiance. Returns (H, W, 3) float32 cache.
    """
    hdr = np.asarray(hdr, np.float64)
    height, width = hdr.shape[:2]

    # Luminance-proportional discrete pdf (Utility.h:40-54 uses .2/.7/.1).
    lum = 0.2 * hdr[..., 0] + 0.7 * hdr[..., 1] + 0.1 * hdr[..., 2]
    pdf = lum / max(lum.sum(), 1e-30)

    # Marginal over columns and its CDF (Utility.h:57-66).
    pdf_x = pdf.sum(axis=0)                       # (W,)
    cdf_x = np.cumsum(pdf_x)                      # (W,)

    # Conditional y | X=x CDF, stored per column (Utility.h:69-87).
    pdf_y_cond = pdf / np.maximum(pdf_x[None, :], 1e-30)   # (H, W)
    cdf_y_cond = np.cumsum(pdf_y_cond, axis=0)             # (H, W)

    # Inverse-CDF table for the stratified grid (Utility.h:90-115):
    # xi_1 = i/H picks column x via cdf_x; xi_2 = j/W picks row y via
    # cdf_y|x. lower_bound == searchsorted(side="left").
    xi_1 = np.arange(height, dtype=np.float64) / height
    xs = np.searchsorted(cdf_x, xi_1, side="left")         # (H,)
    xs = np.minimum(xs, width - 1)

    xi_2 = np.arange(width, dtype=np.float64) / width
    ys = np.empty((height, width), np.int64)
    for i in range(height):
        col = cdf_y_cond[:, xs[i]]
        ys[i] = np.searchsorted(col, xi_2, side="left")
    ys = np.minimum(ys, height - 1)

    cache = np.empty((height, width, 3), np.float32)
    cache[..., 0] = (xs[:, None] / width).astype(np.float32)
    cache[..., 1] = (ys / height).astype(np.float32)
    cache[..., 2] = pdf.astype(np.float32)
    return cache


def build_env_fetch(hdr: np.ndarray, cache: np.ndarray) -> np.ndarray:
    """Fused (H*W, 16) row-gather table for the in-loop env accesses.

    Columns: [map_r, map_g, map_b, pdf_img, cache_x, cache_y, pdf_sampled,
    sampled_r, sampled_g, sampled_b, 0...]. Texel index is the MAJOR axis,
    so one fetch reads one contiguous row. pdf_img is the image-space pdf
    addressed by *pixel position* (the reference's hdrPdf addressing,
    glsl:1173-1186); pdf_sampled and sampled_rgb are the pdf and radiance
    of the texel the inverse-CDF sampler lands on, addressed by the
    *uniforms* (xi_1, xi_2) like cache_x/cache_y — so NEE gets sample
    position, its true pdf AND its radiance in ONE fetch (the reference
    pays three texture lookups: SampleHdr + hdrColor + hdrPdf,
    glsl:1382-1390).
    """
    h, w = hdr.shape[:2]
    # cache stores xs/w and ys/h; recover the exact integer sample indices
    xs = np.clip(np.round(cache[..., 0].astype(np.float64) * w),
                 0, w - 1).astype(np.int64)
    ys = np.clip(np.round(cache[..., 1].astype(np.float64) * h),
                 0, h - 1).astype(np.int64)
    pdf_img = cache[..., 2]
    pdf_sampled = pdf_img[ys, xs]
    sampled_rgb = hdr[ys, xs]                    # (H, W, 3)
    flat = hdr.reshape(-1, 3)
    n = h * w
    z = np.zeros(n, np.float32)
    return np.stack([
        flat[:, 0], flat[:, 1], flat[:, 2],
        pdf_img.ravel(), cache[..., 0].ravel(), cache[..., 1].ravel(),
        pdf_sampled.ravel(),
        sampled_rgb[..., 0].ravel(), sampled_rgb[..., 1].ravel(),
        sampled_rgb[..., 2].ravel(), z, z, z, z, z, z,
    ], axis=-1).astype(np.float32)


def make_gradient_hdr(width: int = 64, height: int = 32,
                      bright_dir=(0.0, 1.0, 0.0)) -> np.ndarray:
    """Procedural test environment: smooth gradient with a bright pole.
    Keeps unit tests and demos independent of external .hdr assets."""
    us = (np.arange(width) + 0.5) / width
    vs = (np.arange(height) + 0.5) / height
    u, v = np.meshgrid(us, vs)
    phi = 2.0 * np.pi * (u - 0.5)
    theta = np.pi * (0.5 - v)          # v=0 -> +y pole
    d = np.stack([np.cos(theta) * np.cos(phi), np.sin(theta),
                  np.cos(theta) * np.sin(phi)], axis=-1)
    b = np.asarray(bright_dir, np.float64)
    b /= np.linalg.norm(b)
    align = np.clip((d @ b + 1.0) * 0.5, 0.0, 1.0)
    base = 0.2 + 2.0 * align ** 4
    color = np.stack([base, base * 0.9 + 0.05, base * 0.8 + 0.1], axis=-1)
    return color.astype(np.float32)
