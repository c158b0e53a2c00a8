"""Per-image DFT low-pass frequency masks that gate blur-kernel gradients.

The masks of lushnerf_tpu/data/freq_mask.py (the reference's
frequency_mask / get_masks_for_images, utils/run_lushnerf_helpers.py:
630-662) without cv2:
  grey (cv2's fixed-point RGB2GRAY for uint8) -> DFT -> square low-pass
  window of +-radius around the centred zero frequency -> inverse DFT
  magnitude -> min-max normalise to [0, 255] -> 1 where above 48.
The DFTs run in float64 through torch.fft, on any device; cv2's run in
float32, so a pixel's mask may differ from cv2's only where its
normalised magnitude lies within ~1e-3 of 48.
"""

from __future__ import annotations

import numpy as np
import torch

THRESHOLD = 48.0


def rgb_to_gray_u8(images: np.ndarray) -> np.ndarray:
    """uint8 RGB [..., 3] -> uint8 grey, as cv2.cvtColor(RGB2GRAY) rounds
    it: 16-bit coefficients that sum to 2^16 (0.299, 0.587, 0.114 rounded
    so), (19596 R + 38470 G + 7470 B + 2^15) >> 16.  Equal to OpenCV 5.0's
    output at every uint8 triple; the older 14-bit form (4899, 9617, 1868)
    differs from it at ~0.3% of them."""
    x = images.astype(np.int64)
    y = (19596 * x[..., 0] + 38470 * x[..., 1] + 7470 * x[..., 2] + 32768) >> 16
    return y.astype(np.uint8)


def lowpass_window(rows: int, cols: int, radius: int) -> np.ndarray:
    """The reference's window lp[c - radius : c + radius] (numpy slicing,
    so a radius past the centre wraps as it does there), moved from the
    centred spectrum to the DFT's own order."""
    lp = np.zeros((rows, cols), np.float64)
    crow, ccol = rows // 2, cols // 2
    lp[crow - radius : crow + radius, ccol - radius : ccol + radius] = 1.0
    return np.fft.ifftshift(lp)


def normalized_magnitude(gray: np.ndarray, radius: int, device: str | torch.device = "cpu") -> torch.Tensor:
    """uint8 grey [N, H, W] -> the low-passed magnitude of each image,
    min-max normalised to [0, 255] (float64, on `device`)."""
    g = torch.as_tensor(gray, device=device).to(torch.float64)
    win = torch.as_tensor(lowpass_window(*gray.shape[-2:], radius), device=device)
    mag = torch.fft.ifft2(torch.fft.fft2(g) * win).abs()
    lo = mag.amin(dim=(-2, -1), keepdim=True)
    hi = mag.amax(dim=(-2, -1), keepdim=True)
    return (mag - lo) / (hi - lo) * 255.0


def frequency_mask(image: np.ndarray, radius: int = 50) -> np.ndarray:
    """image: uint8 RGB [H, W, 3] -> binary float32 mask [H, W]."""
    norm = normalized_magnitude(rgb_to_gray_u8(image)[None], radius)[0]
    return (norm > THRESHOLD).numpy().astype(np.float32)


def get_masks_for_images(images: np.ndarray, radius: int = 50,
                         device: str | torch.device = "cpu") -> np.ndarray:
    """images: uint8 [N, H, W, 3] -> uint8 masks [N, H, W], the DFTs of all
    images at once on `device`."""
    norm = normalized_magnitude(rgb_to_gray_u8(images), radius, device)
    return (norm > THRESHOLD).to(torch.uint8).cpu().numpy()
