"""Write the JPEG fixtures of tests/test_torch_jpeg.py with Pillow (its
bundled libjpeg-turbo): `python tests/data/jpeg/make_fixtures.py`. Each name
says what the file covers; the decoder is held to Pillow's decode of the
committed files, so rewriting them with another Pillow changes nothing the
tests assert."""

import os

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))

# name: (height, width, save options); subsampling 0/1/2 = 4:4:4/4:2:2/4:2:0;
# keep_rgb: RGB samples under an Adobe marker (no YCbCr transform)
FIXTURES = {
    "rgb444_q95_17x23.jpg": (17, 23, dict(quality=95, subsampling=0)),
    "rgb422_q50_33x9.jpg": (33, 9, dict(quality=50, subsampling=1)),
    "rgb420_q95_48x64.jpg": (48, 64, dict(quality=95, subsampling=2)),
    "rgb420_q50_17x23_optimize.jpg": (17, 23, dict(quality=50, subsampling=2, optimize=True)),
    "rgb420_q90_40x56_restart3.jpg": (40, 56, dict(quality=90, subsampling=2,
                                                   restart_marker_blocks=3)),
    "rgb422_q75_31x45_restart1.jpg": (31, 45, dict(quality=75, subsampling=1,
                                                   restart_marker_blocks=1)),
    "rgb420_q90_3x4_box.jpg": (3, 4, dict(quality=90, subsampling=2)),
    "rgb444_q90_19x27_adobe.jpg": (19, 27, dict(quality=90, subsampling=0, keep_rgb=True)),
    "gray_q95_33x9.jpg": (33, 9, dict(quality=95)),
    "gray_q50_17x23_optimize.jpg": (17, 23, dict(quality=50, optimize=True)),
    "progressive_q90_24x32.jpg": (24, 32, dict(quality=90, progressive=True)),
}


def image(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([xx * 255.0 / max(w - 1, 1), yy * 255.0 / max(h - 1, 1),
                     128 + 100 * np.sin(xx * 0.7 + yy * 0.4)], -1)
    return np.clip(base + rng.normal(0, 18, base.shape), 0, 255).astype(np.uint8)


if __name__ == "__main__":
    for i, (name, (h, w, opts)) in enumerate(FIXTURES.items()):
        img = Image.fromarray(image(h, w, i))
        if name.startswith("gray"):
            img = img.convert("L")
        img.save(os.path.join(HERE, name), **opts)
