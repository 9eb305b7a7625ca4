"""The six camera JPEGs of `occnet_tpu_torch/data/fixtures/`: how they were
made, and the digests of their `tf.io.decode_jpeg` pixels.

`chip_smoke.py` builds its nuScenes-layout data root from these files (the
card's machine has no JPEG encoder) and checks the port's decoder against
`digests.json` there; `tests/test_torch_nuscenes.py` checks the digests and
the decoder against TensorFlow here.  Regenerate both (PIL and TensorFlow
needed) with

    python tests/torch_jpeg_fixtures.py
"""

import hashlib
import io
import json
import os

import numpy as np

FIXTURES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "occnet_tpu_torch", "data", "fixtures")
HW = (900, 1600)
NAMES = [f"cam{i}.jpg" for i in range(6)]


def fixture_pixels(i: int) -> np.ndarray:
    """Camera i's content: smooth gradients and waves under a faint
    texture, (900, 1600, 3) uint8 from seed i."""
    rng = np.random.RandomState(i)
    yy, xx = np.mgrid[0:HW[0], 0:HW[1]].astype(np.float64)
    chans = []
    for c in range(3):
        fx, fy = rng.uniform(20, 90, 2)
        ph = rng.uniform(0, 2 * np.pi, 2)
        v = (110 + 50 * np.sin(xx / fx + ph[0]) * np.cos(yy / fy + ph[1])
             + 40 * (yy / HW[0]) + 25 * np.sin((xx + yy) / (fx + fy)))
        chans.append(v)
    img = np.stack(chans, -1) + rng.randn(HW[0], HW[1], 3) * 1.5
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def pixel_digest(pixels: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(pixels).tobytes()).hexdigest()


def write_fixtures():
    from PIL import Image
    import tensorflow as tf
    digests = {}
    for i, name in enumerate(NAMES):
        bio = io.BytesIO()
        Image.fromarray(fixture_pixels(i)).save(bio, format="JPEG",
                                                quality=90, subsampling=2)
        with open(os.path.join(FIXTURES, name), "wb") as f:
            f.write(bio.getvalue())
        digests[name] = pixel_digest(
            tf.io.decode_jpeg(bio.getvalue(), channels=3).numpy())
    with open(os.path.join(FIXTURES, "digests.json"), "w") as f:
        json.dump({"decoder": "tf.io.decode_jpeg(data, channels=3)",
                   "sha256_of_rgb_uint8": digests}, f, indent=1)


if __name__ == "__main__":
    write_fixtures()
