"""Image IO + sampling utilities for the image-fitting demo/benchmark.

The reference samples the training image through a CUDA texture object with
linear filtering and normalized coordinates (samples/mlp_learning_an_image.cu)
- i.e. bilinear interpolation at pixel centers with edge clamping. `sample_image`
reproduces that convention in jnp (same math as the torch sample's
bilinear, samples/mlp_learning_an_image_pytorch.py:64-84).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def load_image(path: str) -> np.ndarray:
    """Load an image file -> float32 [H, W, 3] in [0, 1] (sRGB values)."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    return np.asarray(img, dtype=np.float32) / 255.0


def save_image(path: str, img) -> None:
    from PIL import Image

    arr = np.asarray(img)
    arr = np.clip(arr * 255.0, 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(path)


def synthetic_image(height: int = 512, width: int = 512) -> np.ndarray:
    """Deterministic multi-scale test pattern for benchmarks when no image
    file is available (smooth gradients + rings + high-frequency checker)."""
    y, x = np.mgrid[0:height, 0:width].astype(np.float32)
    u, v = x / width, y / height
    r = np.sqrt((u - 0.5) ** 2 + (v - 0.5) ** 2)
    red = 0.5 + 0.5 * np.sin(40.0 * r) * np.exp(-3 * r)
    green = 0.5 + 0.5 * np.sin(12 * u) * np.cos(9 * v)
    blue = ((np.floor(u * 32) + np.floor(v * 32)) % 2) * (0.3 + 0.7 * u)
    return np.stack([red, green, blue], -1).astype(np.float32)


def sample_image(image, xy):
    """Bilinear sample `image` [H, W, C] at normalized coords `xy` [B, 2]
    (x first, like the reference's tex2D(x, y)), edge-clamped, pixel-center
    convention: x=u maps to column u*W - 0.5."""
    image = jnp.asarray(image)
    h, w = image.shape[0], image.shape[1]
    fx = xy[:, 0] * w - 0.5
    fy = xy[:, 1] * h - 0.5
    x0 = jnp.floor(fx)
    y0 = jnp.floor(fy)
    tx = fx - x0
    ty = fy - y0
    x0 = x0.astype(jnp.int32)
    y0 = y0.astype(jnp.int32)

    def at(yi, xi):
        yi = jnp.clip(yi, 0, h - 1)
        xi = jnp.clip(xi, 0, w - 1)
        return image[yi, xi]

    c00 = at(y0, x0)
    c01 = at(y0, x0 + 1)
    c10 = at(y0 + 1, x0)
    c11 = at(y0 + 1, x0 + 1)
    tx = tx[:, None]
    ty = ty[:, None]
    top = c00 * (1 - tx) + c01 * tx
    bot = c10 * (1 - tx) + c11 * tx
    return top * (1 - ty) + bot * ty


def build_quad_table(image):
    """[H, W, C] -> [H*W, 4*C] where row (y*W + x) holds the 4 edge-clamped
    bilinear corner pixels (x,y), (x+1,y), (x,y+1), (x+1,y+1).

    One random gather per sample instead of four, at 4x the memory."""
    image = jnp.asarray(image)
    right = jnp.concatenate([image[:, 1:], image[:, -1:]], axis=1)
    down = jnp.concatenate([image[1:], image[-1:]], axis=0)
    downright = jnp.concatenate([down[:, 1:], down[:, -1:]], axis=1)
    q = jnp.concatenate([image, right, down, downright], axis=-1)
    return q.reshape(-1, 4 * image.shape[-1])


def build_quad_table_packed(image):
    """[H, W, 3] float (8-bit-quantized values, e.g. from `load_image`) ->
    [H*W, 3] uint32: row (y*W + x) holds the 4 edge-clamped bilinear corner
    pixels as 12 rgb888 bytes packed little-endian into 3 u32 words.

    A third of the bytes of the 12-fp32 `build_quad_table` row. Exactness: the
    reference trains against an 8-bit texture (uchar4 normalized - the
    cudaCreateTextureObject setup in samples/mlp_learning_an_image.cu), so
    u8 is the reference protocol, not an approximation; `load_image`
    outputs are already exact k/255 values and round-trip bit-identically
    through `sample_image_quad_packed`."""
    image = jnp.asarray(image)
    u8 = jnp.clip(
        jnp.round(image * 255.0), 0, 255
    ).astype(jnp.uint8)
    right = jnp.concatenate([u8[:, 1:], u8[:, -1:]], axis=1)
    down = jnp.concatenate([u8[1:], u8[-1:]], axis=0)
    downright = jnp.concatenate([down[:, 1:], down[:, -1:]], axis=1)
    q = jnp.concatenate([u8, right, down, downright], axis=-1)  # [H, W, 12]
    q = q.reshape(-1, 3, 4)  # 4 consecutive bytes per u32 word
    # little-endian byte packing (all supported devices and hosts are LE)
    w32 = q.astype(jnp.uint32)
    packed = (
        w32[..., 0]
        | (w32[..., 1] << 8)
        | (w32[..., 2] << 16)
        | (w32[..., 3] << 24)
    )
    return packed  # [H*W, 3] uint32


def sample_image_quad_packed(quad_u32, height: int, width: int, xy):
    """Bilinear sampling through a `build_quad_table_packed` table;
    identical results to `sample_image_quad` on 8-bit-quantized images
    (the unpacked k/255 corner values are exact f32)."""
    h, w = height, width
    fx = xy[:, 0] * w - 0.5
    fy = xy[:, 1] * h - 0.5
    x0 = jnp.floor(fx)
    y0 = jnp.floor(fy)
    tx = (fx - x0)[:, None]
    ty = (fy - y0)[:, None]
    tx = jnp.where(x0[:, None] < 0, 0.0, tx)
    ty = jnp.where(y0[:, None] < 0, 0.0, ty)
    x0 = jnp.clip(x0.astype(jnp.int32), 0, w - 1)
    y0 = jnp.clip(y0.astype(jnp.int32), 0, h - 1)
    rows = quad_u32[y0 * w + x0]  # [B, 3] u32 - the only gather
    # unpack 12 bytes -> [B, 12] f32 in [0, 1]
    b = []
    for word in range(3):
        wv = rows[:, word]
        for shift in (0, 8, 16, 24):
            b.append((wv >> shift) & jnp.uint32(0xFF))
    # true division (not reciprocal multiply): keeps the unpacked values
    # bit-identical to load_image's `u8 / 255.0`
    vals = jnp.stack(b, axis=-1).astype(jnp.float32) / 255.0
    c00, c01 = vals[:, 0:3], vals[:, 3:6]
    c10, c11 = vals[:, 6:9], vals[:, 9:12]
    top = c00 * (1 - tx) + c01 * tx
    bot = c10 * (1 - tx) + c11 * tx
    return top * (1 - ty) + bot * ty


def sample_image_quad(quad, height: int, width: int, xy):
    """Bilinear sampling through a `build_quad_table` table; identical
    results to `sample_image` (including edge clamping) with 1 gather."""
    h, w = height, width
    c = quad.shape[-1] // 4
    fx = xy[:, 0] * w - 0.5
    fy = xy[:, 1] * h - 0.5
    x0 = jnp.floor(fx)
    y0 = jnp.floor(fy)
    tx = (fx - x0)[:, None]
    ty = (fy - y0)[:, None]
    # left/top out-of-range: the reference clamps BOTH corners to the edge
    # pixel; with the quad row at (0, .) the right neighbor is pixel 1, so
    # zero the weight instead - same result.
    tx = jnp.where(x0[:, None] < 0, 0.0, tx)
    ty = jnp.where(y0[:, None] < 0, 0.0, ty)
    x0 = jnp.clip(x0.astype(jnp.int32), 0, w - 1)
    y0 = jnp.clip(y0.astype(jnp.int32), 0, h - 1)
    rows = quad[y0 * w + x0]  # [B, 4C]
    c00, c01 = rows[:, :c], rows[:, c : 2 * c]
    c10, c11 = rows[:, 2 * c : 3 * c], rows[:, 3 * c :]
    top = c00 * (1 - tx) + c01 * tx
    bot = c10 * (1 - tx) + c11 * tx
    return top * (1 - ty) + bot * ty


def pixel_center_coords(height: int, width: int) -> np.ndarray:
    """[(H*W), 2] normalized (x, y) at pixel centers - the evaluation lattice
    of the reference demo (mlp_learning_an_image.cu:176-189)."""
    y, x = np.mgrid[0:height, 0:width].astype(np.float32)
    u = (x + 0.5) / width
    v = (y + 0.5) / height
    return np.stack([u.ravel(), v.ravel()], -1)
