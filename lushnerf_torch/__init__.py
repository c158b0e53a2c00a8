"""LuSh-NeRF in PyTorch, for NVIDIA Hopper (H100).

A port of the JAX package `lushnerf_tpu` that keeps its module layout and
names: `ops/` (encoding, rays, sampling, compositing, SE(3) warp, the fused
NeRF-MLP kernels and their gradient), `models/` (NeRF MLP, RBK, renderer,
tone mapping, the composed LuSh-NeRF), `train/` (losses, the stage
schedule, one optimizer step), `config.py` (reference scene-config parser)
and `convert.py` (weights to and from the JAX params tree and reference
`.tar` checkpoints).

The port covers the forwards (`forward_naive`, `forward_kernel`), the
train step (`train.trainer.train_step`) and `render_image` (the eval /
render-only path).  Its entry points run on the GPU unless the caller asks
for the CPU (`device="cpu"`), which the tests do; with no card they raise.
"""
