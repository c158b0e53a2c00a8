"""SE(3) screw-axis exponential map (Rodrigues), batched.

Matches the reference warp field (utils/rigid_warping.py:20-134):
    theta = |rot| + 1e-10; unit axis w = rot/theta; v = trans/theta
    R = I + sin(theta) W + (1-cos(theta)) W^2
    p = (theta I + (1-cos(theta)) W + (theta-sin(theta)) W^2) v
    warped = R @ pts + p
applied with cross products instead of [N, 4, 4] matrices.
"""

from __future__ import annotations

import torch


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def exp_so3(w, theta, pts):
    """R @ p = p + sin(t) (w x p) + (1-cos(t)) (w x (w x p))."""
    t = theta[..., None]
    wxp = _cross(w, pts)
    wxwxp = _cross(w, wxp)
    return pts + torch.sin(t) * wxp + (1.0 - torch.cos(t)) * wxwxp


def exp_se3(w, v, theta, pts):
    """R @ pts + theta v + (1-cos)(w x v) + (theta - sin)(w x (w x v))."""
    t = theta[..., None]
    rotated = exp_so3(w, theta, pts)
    wxv = _cross(w, v)
    wxwxv = _cross(w, wxv)
    p = t * v + (1.0 - torch.cos(t)) * wxv + (t - torch.sin(t)) * wxwxv
    return rotated + p


def se3_warp(pts, rot, trans, eps: float = 1.0e-10):
    """Warp points by the SE(3) exp of (rot, trans); eps is added to theta
    before normalising, as the reference does (rigid_warping.py:31-34)."""
    theta = torch.linalg.norm(rot, dim=-1) + eps
    w = rot / theta[..., None]
    v = trans / theta[..., None]
    return exp_se3(w, v, theta, pts)
