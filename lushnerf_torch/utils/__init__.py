"""Eval metrics (MSE, PSNR, SSIM, LPIPS), the extra losses, the TensorBoard
scalar writer and a PNG reader and writer, none of which needs a package
beyond torch, numpy and the standard library."""
