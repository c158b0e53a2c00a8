"""LuSh-NeRF in PyTorch, for NVIDIA Hopper (H100).

A port of the JAX package `lushnerf_tpu` that keeps its module layout and
names: `ops/` (encoding, rays, sampling, compositing, SE(3) warp, the fused
NeRF-MLP kernels and their gradient), `models/` (NeRF MLP, RBK, renderer,
tone mapping, the composed LuSh-NeRF), `data/` (the LLFF loader, low-light
preprocessing, frequency masks, the ray dataset on the device), `train/`
(losses, the stage schedule, the train step, the `Trainer` loop with eval
and render-only, checkpoints, the CTE pass), `matcher/` (the CTE match
tables, the stub, ground-truth and precomputed matchers, and the DKMv3
dense matcher), `utils/` (metrics, TensorBoard and PNG
writers), `parallel/` (data-parallel training, one process per card, on
torch.distributed), `config.py` (reference scene-config parser),
`convert.py` (weights to and from the JAX params tree and reference `.tar`
checkpoints) and `run.py` (the command line).

LPIPS is not ported yet.  Its entry
points run on the GPU unless the caller asks for the CPU (`device="cpu"`),
which the tests do; with no card they raise.
"""
