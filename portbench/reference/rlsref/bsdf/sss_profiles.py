"""BSSRDF diffusion profiles.

Counterpart of rlshaders_tpu/bsdf/sss_profiles.py (the reference's profile
layer, src/rlSss.h:26-97, src/rlSss.cpp:20-106):

* `NDProfile`: Burley/Christensen normalized diffusion
  R(r) = (e^{-r/d} + e^{-r/3d}) / (8 pi d r) per RGB channel, with exact
  inverse-CDF radius sampling of the two-exponential mixture and the disk
  pdf of the probe-ray MIS combine. Its `cubic` lanes (the `standard`
  shader's Ksss lobe) use Arnold 4's compact cubic falloff instead.
* `GaussianProfile`: the truncated-Gaussian alternative.

A profile is a NamedTuple of per-channel tensors; every function broadcasts
over leading batch dims. The clamps (1e-12, 1e-30, EPS) and the order of
the selects are the JAX package's: the degenerate lanes (d < EPS,
max_radius < EPS, r < EPS) are where two orders would part.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core.vecmath import linearstep

EPS = 1e-7
TWO_PI = 2.0 * math.pi


class NDProfile(NamedTuple):
    distance: torch.Tensor    # (..., 3) per-channel scatter distance d
    c1: torch.Tensor          # (..., 3) 1 - exp(-rmax/d)
    c2: torch.Tensor          # (..., 3) 1 - exp(-rmax/(3d))
    max_radius: torch.Tensor  # (...,)
    cubic: torch.Tensor       # (...,) bool: Arnold-4 cubic falloff lanes


def make_nd_profile(distance: torch.Tensor, cubic=None) -> NDProfile:
    """NDProfile::setDistance (rlSss.cpp:20-34) without its unused albedo
    fit. `cubic` lanes take Arnold 4's raytraced-SSS falloff
    R(r) = 10/(pi d^2) (1 - r/d)^3 with compact support d, which has unit
    mass over the disk (the Burley profile truncated at 3d has 0.7117)."""
    distance = distance.to(torch.float32)
    dmax = distance.amax(dim=-1)
    if cubic is None:
        cubic = torch.zeros_like(dmax, dtype=torch.bool)
    cubic = torch.broadcast_to(torch.as_tensor(cubic, device=dmax.device),
                               dmax.shape)
    max_radius = torch.where(cubic, dmax, dmax * 3.0)
    safe_d = torch.clamp_min(distance, 1e-12)
    rm = (dmax * 3.0)[..., None]
    c1 = 1.0 - torch.exp(-rm / safe_d)
    c2 = 1.0 - torch.exp(-rm / safe_d / 3.0)
    return NDProfile(distance=distance, c1=c1, c2=c2, max_radius=max_radius,
                     cubic=cubic)


def _cubic_inv_cdf(u: torch.Tensor) -> torch.Tensor:
    """Invert the cubic profile's radial CDF on x = r/d,
    CDF(x) = 10x^2 - 20x^3 + 15x^4 - 4x^5 (monotone on [0, 1]), by 24 steps
    of bisection (error 2^-24)."""
    lo = torch.zeros_like(u)
    hi = torch.ones_like(u)
    for _ in range(24):
        mid = 0.5 * (lo + hi)
        c = ((((-4.0 * mid + 15.0) * mid - 20.0) * mid + 10.0) * mid * mid)
        below = c < u
        lo = torch.where(below, mid, lo)
        hi = torch.where(below, hi, mid)
    return 0.5 * (lo + hi)


def _cubic_eval(p: NDProfile, r: torch.Tensor) -> torch.Tensor:
    """Per-channel cubic R(r) = 10/(pi d^2) (1 - r/d)^3 on r < d; (..., 3)."""
    d = torch.clamp_min(p.distance, 1e-12)
    x = torch.clamp(1.0 - r[..., None] / d, 0.0, 1.0)
    return 10.0 / (math.pi * d * d) * x * x * x


def select_dist_lobe(x: torch.Tensor):
    """Pick an RGB channel uniformly from one variate and remap the variate
    back to [0, 1) (NDProfile::selectDistLobe, rlSss.h:30-42): returns
    (channel index, remapped x)."""
    idx = torch.where(x < 0.3333, 0, torch.where(x > 0.6666, 2, 1))
    x0 = linearstep(0.0, 0.3333, x)
    x1 = linearstep(0.3333, 0.6666, x)
    x2 = linearstep(0.6666, 1.0, x)
    xr = torch.where(idx == 0, x0, torch.where(idx == 1, x1, x2))
    return idx, xr


def nd_sample_radius(p: NDProfile, rx: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF radius sample (NDProfile::getRadius, rlSss.cpp:36-66): a
    channel picked uniformly, then one of the two exponentials with weight
    w1/(w1 + 3 w2), then that exponential's truncated CDF inverted."""
    idx, rx = select_dist_lobe(rx)

    def take(a):
        a = torch.broadcast_to(a, idx.shape + (3,))
        return torch.gather(a, -1, idx[..., None])[..., 0]

    d = take(p.distance)
    w1 = take(p.c1)
    w2 = take(p.c2)
    w = w1 / torch.clamp_min(w1 + w2 * 3.0, 1e-12)

    use_far = rx > w
    rx_far = linearstep(w, 1.0, rx)
    rx_near = linearstep(0.0, w, rx)
    r_far = torch.log(torch.clamp_min(1.0 - rx_far * w2, 1e-30)) * (-d * 3.0)
    r_near = torch.log(torch.clamp_min(1.0 - rx_near * w1, 1e-30)) * (-d)
    r = torch.where(use_far, r_far, r_near)
    r = torch.where(p.cubic, d * _cubic_inv_cdf(rx), r)
    degenerate = (p.max_radius < EPS) | (d < EPS)
    return torch.where(degenerate, 0.0, r)


def nd_pdf(p: NDProfile, r: torch.Tensor) -> torch.Tensor:
    """Disk-domain pdf of the radius sampler (NDProfile::getPdf,
    rlSss.cpp:68-84), averaged over the 3 channels."""
    d = torch.clamp_min(p.distance, EPS)
    ru = r[..., None]
    p1 = torch.exp(-ru / d)
    p2 = torch.exp(-ru / d / 3.0)
    per_ch = (p1 + p2) / d / torch.clamp_min(p.c1 + p.c2 * 3.0, 1e-12)
    pdf = per_ch.sum(-1) / (TWO_PI * torch.clamp_min(r, 1e-12) * 3.0)
    # cubic lanes: the normalized profile is the disk pdf per channel
    pdf = torch.where(p.cubic, _cubic_eval(p, r).mean(-1), pdf)
    return torch.where(p.max_radius < EPS, 1.0, pdf)


def nd_eval(p: NDProfile, r: torch.Tensor) -> torch.Tensor:
    """R(r) per channel (NDProfile::evalProfile, rlSss.cpp:86-106); (..., 3)."""
    denom = 8.0 * math.pi * torch.clamp_min(r, 1e-12)[..., None]
    d = p.distance
    safe_d = torch.clamp_min(d, 1e-12)
    ru = r[..., None]
    val = (torch.exp(-ru / safe_d) + torch.exp(-ru / (3.0 * safe_d))) / (
        denom * safe_d)
    val = torch.where(p.cubic[..., None], _cubic_eval(p, r), val)
    val = torch.where(d < EPS, 1.0, val)
    val = torch.where(ru < EPS, 1.0, val)
    return torch.where(p.max_radius[..., None] < EPS, 0.0, val)


class GaussianProfile(NamedTuple):
    variance: torch.Tensor
    max_radius: torch.Tensor
    norm: torch.Tensor


def make_gaussian_profile(distance: torch.Tensor) -> GaussianProfile:
    """GaussianProfile::setDistance (rlSss.h:71-76): variance
    rmax^2 / 12.46, truncated at rmax (the x channel of the distance)."""
    distance = distance.to(torch.float32)
    max_radius = distance[..., 0]
    variance = max_radius * max_radius / 12.46
    norm = 1.0 - torch.exp(-max_radius * max_radius * 0.5
                           / torch.clamp_min(variance, 1e-20))
    return GaussianProfile(variance=variance, max_radius=max_radius,
                           norm=norm)


def gaussian_sample_radius(p: GaussianProfile,
                           rx: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(-2.0 * p.variance * torch.log(
        torch.clamp_min(1.0 - rx * p.norm, 1e-30)))


def gaussian_pdf(p: GaussianProfile, r: torch.Tensor) -> torch.Tensor:
    return gaussian_eval_scalar(p, r) / torch.clamp_min(p.norm, 1e-12)


def gaussian_eval_scalar(p: GaussianProfile, r: torch.Tensor) -> torch.Tensor:
    inv2pi = 1.0 / TWO_PI
    v = torch.clamp_min(p.variance, 1e-20)
    return inv2pi / v * torch.exp(-r * r * 0.5 / v)


def gaussian_eval(p: GaussianProfile, r: torch.Tensor) -> torch.Tensor:
    return gaussian_eval_scalar(p, r)[..., None] * torch.ones(
        3, dtype=torch.float32, device=r.device)
