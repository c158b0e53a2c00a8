"""Data pipeline: the LLFF loader and its pose math, low-light
preprocessing, frequency masks and the ray dataset that lives on the
device.  Reading and preprocessing image files needs `imageio` and `cv2`,
imported only where a file is read or written; a scene given in memory
needs neither."""

import importlib


def need(module: str):
    """Import `module` (an image codec) where a file is read or written, or
    raise an ImportError that names the package it needs."""
    try:
        return importlib.import_module(module)
    except ImportError as e:
        pkg = {"cv2": "opencv-python (cv2)"}.get(module, module.split(".")[0])
        raise ImportError(
            f"lushnerf_torch: reading or preprocessing image files needs the package "
            f"{pkg}, which is not installed; pass the scene in memory (Trainer(cfg, data=...)) "
            f"or install it"
        ) from e
