"""Write the JPEG fixtures of tests/test_torch_jpeg.py and
tests/test_torch_jpeg_progressive.py with Pillow (its bundled
libjpeg-turbo): `python tests/data/jpeg/make_fixtures.py [name ...]` (every
fixture, or the named ones). Each name says what the file covers; the
decoder is held to Pillow's decode of the committed files, so rewriting them
with another Pillow changes nothing the tests assert. Pillow writes
progressive files with libjpeg's standard scan script
(jcparam.c jpeg_simple_progression) and optimised Huffman tables per scan."""

import os
import sys

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
    "progressive_gray_q90_21x19.jpg": (21, 19, dict(quality=90, progressive=True)),
    "progressive_rgb444_q95_17x23.jpg": (17, 23, dict(quality=95, subsampling=0,
                                                      progressive=True)),
    "progressive_rgb422_q75_31x45.jpg": (31, 45, dict(quality=75, subsampling=1,
                                                      progressive=True)),
    "progressive_rgb420_q85_37x41.jpg": (37, 41, dict(quality=85, subsampling=2,
                                                      progressive=True)),
    "progressive_rgb420_q90_3x4.jpg": (3, 4, dict(quality=90, subsampling=2,
                                                  progressive=True)),
    "progressive_rgb420_q90_40x56_restart3.jpg": (40, 56, dict(
        quality=90, subsampling=2, progressive=True, restart_marker_blocks=3)),
    "progressive_rgb422_q75_31x45_restart1.jpg": (31, 45, dict(
        quality=75, subsampling=1, progressive=True, restart_marker_blocks=1)),
}


def image(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([xx * 255.0 / max(w - 1, 1), yy * 255.0 / max(h - 1, 1),
                     128 + 100 * np.sin(xx * 0.7 + yy * 0.4)], -1)
    return np.clip(base + rng.normal(0, 18, base.shape), 0, 255).astype(np.uint8)


if __name__ == "__main__":
    for i, (name, (h, w, opts)) in enumerate(FIXTURES.items()):
        if sys.argv[1:] and name not in sys.argv[1:]:
            continue
        img = Image.fromarray(image(h, w, i))
        if "gray" in name:
            img = img.convert("L")
        img.save(os.path.join(HERE, name), **opts)
