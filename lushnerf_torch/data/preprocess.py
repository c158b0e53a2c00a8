"""Low-light input preprocessing: CLAHE on the HSV V channel + inverse
gamma, cached to `<images_dir>_preprocess/` on first run.

A copy of lushnerf_tpu/data/preprocess.py, which matches
process_images_with_clahe (data_utils/load_llff.py:109-144):
  * cv2 CLAHE with clipLimit=`clahe_value`, tileGridSize=(1,1) applied to
    the V channel of the BGR->HSV image (skipped when clahe_value <= 0)
  * gamma curve (x/255)^gamma * 255, clipped, uint8
and the cache contract of _load_data_lush (:164-171): the output directory
is created once and reused verbatim on subsequent runs, so a scene whose
`_preprocess` directory exists needs no cv2.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from lushnerf_torch.data import need

IMG_EXTS = (".jpg", ".JPG", ".jpeg", ".png", ".PNG")


def enhance_image_bgr(image: np.ndarray, gamma: float, clahe_value: float) -> np.ndarray:
    """CLAHE(V of HSV) + inverse gamma on a uint8 BGR image."""
    cv2 = need("cv2")
    hsv = cv2.cvtColor(image, cv2.COLOR_BGR2HSV)
    h, s, v = cv2.split(hsv)
    if clahe_value > 0:
        clahe = cv2.createCLAHE(clipLimit=clahe_value, tileGridSize=(1, 1))
        v = clahe.apply(v)
    image = cv2.cvtColor(cv2.merge([h, s, v]), cv2.COLOR_HSV2BGR)
    arr = image.astype(np.float64)
    arr = np.power(arr / 255.0, gamma) * 255.0
    return np.clip(arr, 0, 255).astype(np.uint8)


def preprocess_image_dir(input_dir: str | Path, output_dir: str | Path, gamma: float, clahe_value: float) -> None:
    cv2 = need("cv2")
    input_dir, output_dir = Path(input_dir), Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    for name in sorted(os.listdir(input_dir)):
        if not name.endswith((".jpg", ".png")):
            continue
        image = cv2.imread(str(input_dir / name))
        if image is None:
            continue
        cv2.imwrite(str(output_dir / name), enhance_image_bgr(image, gamma, clahe_value))


def preprocessed_dir(images_dir: str | Path, gamma: float, clahe_value: float) -> Path:
    """Return the cached preprocess dir, creating it on first use
    (reference cache contract: existence of the dir means done)."""
    images_dir = Path(images_dir)
    out = images_dir.parent / (images_dir.name + "_preprocess")
    if not out.exists():
        need("cv2")  # before the directory exists, or a failed run leaves it empty
        out.mkdir(parents=True)
        preprocess_image_dir(images_dir, out, gamma, clahe_value)
    return out
