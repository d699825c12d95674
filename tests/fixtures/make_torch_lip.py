"""Writes the JPEG fixtures of the port's LIP reader (``torch_lip/``).

    python tests/fixtures/make_torch_lip.py

Needs cv2 (to encode) and a C++ compiler (to build the port's host
library). The port has no encoder and does not import cv2, so the files
are committed, and ``chip_smoke.py`` builds its LIP tree from them on a
host without cv2. Eight person-like
images of 160-640 px, each with an 8-bit grey PNG of part labels (0-19),
cover the decoder's paths: 4:2:0, 4:4:4, 4:2:2, 4:4:0 and 4:1:1
sampling, restart intervals, optimised Huffman tables and one grey
image. ``fixtures.json`` records, per image, its size and the SHA-256 of
the port's decode, which must equal cv2's when it is written; another
compiler must give the same bytes, since every step of the decode is integer
arithmetic.
"""
import hashlib
import json
import os
import sys

import cv2
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from npp_tpu_torch.data import imgproc  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_lip")
S = {k: getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{k}")
     for k in ("444", "422", "420", "440", "411")}
# (name, height, width, quality, sampling or "grey", restart, optimise)
FIXTURES = (
    ("lip_a", 320, 240, 90, "420", 0, False),
    ("lip_b", 384, 256, 85, "444", 0, False),
    ("lip_c", 300, 400, 80, "422", 4, False),
    ("lip_d", 480, 360, 88, "420", 0, True),
    ("lip_e", 160, 200, 90, "grey", 0, False),
    ("lip_f", 640, 480, 75, "420", 8, True),
    ("lip_g", 500, 300, 90, "440", 0, False),
    ("lip_h", 320, 224, 85, "411", 2, True),
)


def person(rng, h: int, w: int):
    """A smooth background and a figure of coloured ellipses (head,
    torso, arms, legs) with light texture, and its part labels."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    bg = np.stack([90 + 60 * xx / w, 110 + 50 * yy / h,
                   140 - 40 * xx / w], -1)
    im = bg + rng.normal(0, 6, (h, w, 3))
    lab = np.zeros((h, w), np.uint8)
    cx, cy = w / 2 + rng.uniform(-w / 10, w / 10), h / 2
    parts = (  # (class, dx, dy, rx, ry) in units of the figure's height
        (2, 0, -0.38, 0.07, 0.08), (5, 0, -0.12, 0.13, 0.18),
        (14, -0.17, -0.12, 0.04, 0.16), (15, 0.17, -0.12, 0.04, 0.16),
        (9, 0, 0.1, 0.12, 0.08), (16, -0.06, 0.3, 0.05, 0.17),
        (17, 0.06, 0.3, 0.05, 0.17), (18, -0.07, 0.47, 0.05, 0.03),
        (19, 0.07, 0.47, 0.05, 0.03))
    fig = 0.9 * h
    for cls, dx, dy, rx, ry in parts:
        colour = rng.integers(20, 236, 3).astype(np.float32)
        mask = (((xx - cx - dx * fig) / (rx * fig)) ** 2
                + ((yy - cy - dy * fig) / (ry * fig)) ** 2) <= 1
        im[mask] = colour + rng.normal(0, 10, (int(mask.sum()), 3))
        lab[mask] = cls
    im = cv2.GaussianBlur(np.clip(im, 0, 255).astype(np.uint8), (3, 3), 0)
    return im, lab


def main() -> None:
    os.makedirs(OUT, exist_ok=True)
    rng = np.random.default_rng(2021)
    records = []
    for name, h, w, q, samp, rst, opt in FIXTURES:
        rgb, lab = person(rng, h, w)
        params = [cv2.IMWRITE_JPEG_QUALITY, q]
        if samp == "grey":
            pix = cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY)
        else:
            pix = rgb[..., ::-1]
            params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, S[samp]]
        if rst:
            params += [cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
        if opt:
            params += [cv2.IMWRITE_JPEG_OPTIMIZE, 1]
        path = os.path.join(OUT, f"{name}.jpg")
        assert cv2.imwrite(path, pix, params)
        assert cv2.imwrite(os.path.join(OUT, f"{name}.png"), lab)
        ours = imgproc.read_jpeg(path)
        ref = cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1]
        if not np.array_equal(ours, ref):
            raise SystemExit(f"{name}: the port's decode differs from cv2's")
        records.append({"image": f"{name}.jpg", "label": f"{name}.png",
                        "height": h, "width": w, "sampling": samp,
                        "restart": rst, "optimized": opt,
                        "sha256": hashlib.sha256(ours.tobytes()).hexdigest()})
    with open(os.path.join(OUT, "fixtures.json"), "w") as f:
        json.dump(records, f, indent=1)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(OUT, f)) for f in os.listdir(OUT))
    print(f"wrote {len(records)} JPEGs and labels to {OUT}: {total} bytes")


if __name__ == "__main__":
    main()
