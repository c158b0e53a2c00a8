"""Eval metrics (MSE, PSNR, SSIM), the TensorBoard scalar writer and a PNG
writer, none of which needs a package beyond torch and the standard
library."""
