"""Raw YUV clips the port's encoder tests encode (numpy only, so that the
card tests, which run without JAX, share them with the CPU tests).

``make_hd720_s3`` is the recipe of hd720_s3, the encode clip of
chip_smoke.py phase 6 (the script carries its own copy;
tests/test_torch_encode.py holds the two equal).
"""
import numpy as np


def wavefront_clip(w=192, h=192, f=2):
    """The structured clip of tests/test_wavefront_rdo.py
    test_speed3_native_python_identical_and_conforming: a flat band,
    moving stripes, a noise band."""
    yy, xx = np.mgrid[0:h, 0:w]
    rng = np.random.RandomState(5)
    frames = []
    for t in range(f):
        y = np.zeros((h, w), np.int32)
        y[:64] = 210
        y[64:128] = 128 + 80 * (((xx[:64] + 4 * t) >> 3) & 1)
        y[128:] = 128 + rng.randint(-20, 21, (64, w))
        frames += [np.clip(y, 0, 255).astype(np.uint8).tobytes(),
                   np.full((h // 2, w // 2), 120, np.uint8).tobytes(),
                   np.full((h // 2, w // 2), 130, np.uint8).tobytes()]
    return b"".join(frames)


def txrd_clip(w, h, f, seed=3):
    """The clip of tests/test_txrd_prepass.py synthetic_yuv420."""
    rng = np.random.RandomState(seed)
    base = (128 + 60 * np.sin(np.arange(w)[None, :] / 9.0) *
            np.cos(np.arange(h)[:, None] / 7.0)).astype(np.uint8)
    out = []
    for i in range(f):
        y = np.roll(base, i * 2, axis=1).copy()
        y[h // 2:, :] = rng.randint(0, 256, (h - h // 2, w))
        u = np.full((h // 2, w // 2), 110 + i, np.uint8)
        v = np.full((h // 2, w // 2), 130 - i, np.uint8)
        out += [y.tobytes(), u.tobytes(), v.tobytes()]
    return b"".join(out)


# hd720_s3, the encode clip of chip_smoke.py phase 6
HD720_S3 = dict(width=1280, height=720, frames=4, qp=32, seed=20261017)


def make_hd720_s3(seed=HD720_S3["seed"]):
    """The raw 8-bit 4:2:0 bytes of hd720_s3: 1280x720, 4 pictures, from
    a numpy seed.  Luma quadrants: flat (top left, +2 a picture),
    diagonal stripes moving 4 samples a picture (top right), a noise
    texture moving by (2, 1) (bottom left), a ramp brightening by 3 a
    picture (bottom right), so that the split DP forces decisions both
    ways and the prepass has real choices; smooth chroma."""
    W, H, N = HD720_S3["width"], HD720_S3["height"], HD720_S3["frames"]
    rng = np.random.RandomState(seed)
    tex = rng.randint(-40, 41, (H // 2 + 8, W // 2 + 8))
    yy, xx = np.mgrid[0:H, 0:W]
    cy, cx = np.mgrid[0:H // 2, 0:W // 2]
    out = []
    for t in range(N):
        y = np.empty((H, W), np.int64)
        y[:H // 2, :W // 2] = 90 + 2 * t
        tr = (xx[:H // 2, W // 2:] + yy[:H // 2, W // 2:] // 2 + 4 * t) // 12
        y[:H // 2, W // 2:] = 60 + 130 * (tr & 1)
        y[H // 2:, :W // 2] = 128 + tex[t:t + H // 2, 2 * t:2 * t + W // 2]
        y[H // 2:, W // 2:] = ((xx[H // 2:, W // 2:] - W // 2) * 200 //
                               (W // 2) + (yy[H // 2:, W // 2:] - H // 2)
                               // 8 + 3 * t)
        u = 128 + (30 * np.sin(cx / 40.0 + t / 4.0)).astype(np.int64)
        v = 120 + (cy * 40) // (H // 2)
        out += [np.clip(p, 0, 255).astype(np.uint8).tobytes()
                for p in (y, u, v)]
    return b"".join(out)
