"""Rendering ops: positional encoding, rays, sampling, compositing, SE(3)."""
