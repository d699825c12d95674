"""Writes the grey part-label fixtures of the port's PPP reader
(``torch_ppp/``).

    python tests/fixtures/make_torch_ppp.py

Needs cv2 (to read and write the PNGs). The card machine has no PNG
encoder for grey labels, so the files are committed, and
``chip_smoke.py`` builds its Pascal-Person-Part tree from them and the
LIP fixtures' JPEGs (``torch_lip/``). Each label image is the LIP
fixture's labels (classes 0-19) mapped onto PPP's 7 parts: background 0,
head 1 (hair), torso 2 (upper clothes), upper arms 3 and lower arms 4
(each arm split at its middle row), upper legs 5 (pants and the upper
half of each leg) and lower legs 6 (the lower half and the shoes).
``fixtures.json`` records, per label image, the JPEG it pairs with, its
size, its classes and the SHA-256 of its pixels.
"""
import hashlib
import json
import os

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
LIP = os.path.join(HERE, "torch_lip")
OUT = os.path.join(HERE, "torch_ppp")
DIRECT = {0: 0, 2: 1, 5: 2, 9: 5, 18: 6, 19: 6}  # LIP class -> PPP part
SPLIT = {14: (3, 4), 15: (3, 4), 16: (5, 6), 17: (5, 6)}  # upper, lower


def to_ppp(lab: np.ndarray) -> np.ndarray:
    out = np.zeros_like(lab)
    for cls, part in DIRECT.items():
        out[lab == cls] = part
    for cls, (upper, lower) in SPLIT.items():
        rows = np.nonzero(lab == cls)[0]
        if not rows.size:
            continue
        mid = (rows.min() + rows.max()) / 2
        yy = np.arange(lab.shape[0])[:, None]
        out[(lab == cls) & (yy <= mid)] = upper
        out[(lab == cls) & (yy > mid)] = lower
    unmapped = set(np.unique(lab)) - set(DIRECT) - set(SPLIT)
    assert not unmapped, unmapped
    return out


def main() -> None:
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(LIP, "fixtures.json")) as f:
        lip = json.load(f)
    records = []
    for rec in lip:
        lab = cv2.imread(os.path.join(LIP, rec["label"]), cv2.IMREAD_UNCHANGED)
        ppp = to_ppp(lab)
        name = rec["label"].replace("lip_", "ppp_")
        path = os.path.join(OUT, name)
        assert cv2.imwrite(path, ppp)
        back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        assert back.dtype == np.uint8 and np.array_equal(back, ppp)
        records.append({"label": name, "image": rec["image"],
                        "height": rec["height"], "width": rec["width"],
                        "classes": sorted(int(c) for c in np.unique(ppp)),
                        "sha256": hashlib.sha256(ppp.tobytes()).hexdigest()})
    with open(os.path.join(OUT, "fixtures.json"), "w") as f:
        json.dump(records, f, indent=1)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(OUT, f)) for f in os.listdir(OUT))
    print(f"wrote {len(records)} label PNGs to {OUT}: {total} bytes")


if __name__ == "__main__":
    main()
