"""The output check: the program's frames against the frozen reference.

A frame is judged at checked pixels drawn from the run's seed: `blocks`
squares of `block` x `block` pixels. The splat spreads a sample over its
3x3 pixel neighbourhood, so the reference renders the samples of every
pixel within one pixel of a checked one (the live pixels) and no other;
a checked pixel's value then comes from exactly the samples that make it
in the whole frame. The reference (`portbench/reference/rlsref`, plain
PyTorch and NumPy, a frozen copy of the renderer) builds the scene and its
tree itself from the same scene file and renders the whole tile with the
other pixels' rays dead, so each live sample draws what it draws in the
program's frame.

Three numbers are compared, each with its limit in the cell's file:
- `bad_share`: the share of checked values (every plane, every channel)
  that are not finite or where |program - reference| > atol + rtol *
  |reference|;
- `mean_gap`: the largest gap between the program's and the reference's
  sum of a plane's channel over the checked pixels (the program's finite
  values and the reference's beside them), over the sum of the
  reference's RGBA values a channel;
- `nonfinite`: how many checked values are NaN or infinite.
"""
from __future__ import annotations

import importlib
import random

import numpy as np
import torch


def blocks(seed: int, xres: int, yres: int, n_blocks: int, block: int):
    """(live, checked): bool masks over the frame's flat pixels."""
    r = random.Random(seed * 2654435761 % (1 << 61) + 17)
    live = torch.zeros((yres, xres), dtype=torch.bool)
    checked = torch.zeros((yres, xres), dtype=torch.bool)
    b = min(block, xres, yres)
    for _ in range(n_blocks):
        x = r.randrange(0, xres - b + 1)
        y = r.randrange(0, yres - b + 1)
        checked[y:y + b, x:x + b] = True
        live[max(y - 1, 0):y + b + 1, max(x - 1, 0):x + b + 1] = True
    return live.reshape(-1), checked.reshape(-1)


def gather(fb, idx: torch.Tensor) -> torch.Tensor:
    """A framebuffer's normalized channels at flat pixels idx: (P, C) on
    the framebuffer's device (RGB, then each AOV's three, by name)."""
    norm = torch.clamp_min(fb.wsum[idx], 1e-12)[:, None]
    return fb.image[idx] / norm


def planes(values: np.ndarray, names) -> dict:
    """{"RGBA": (P, 3), aov: (P, 3), ...} from gathered (P, C) values."""
    out = {"RGBA": values[:, 0:3]}
    for i, name in enumerate(names):
        out[name] = values[:, 3 * (i + 1):3 * (i + 2)]
    return out


def numbers(got: dict, want: dict, atol: float, rtol: float) -> dict:
    """The compared numbers of one frame's checked pixels. A value that is
    not finite counts as bad and is left out of the sums; a plane that one
    side lacks reads as a total failure."""
    if sorted(got) != sorted(want) or any(
            got[k].shape != want[k].shape for k in want):
        return {"bad_share": 1.0, "mean_gap": float("inf"),
                "nonfinite": float("inf")}
    bad = total = nonfinite = 0
    scale = float(np.abs(want["RGBA"].astype(np.float64)).sum(0).mean())
    gap = 0.0
    for name in want:
        g = got[name].astype(np.float64)
        w = want[name].astype(np.float64)
        fin = np.isfinite(g)
        nonfinite += int((~fin).sum())
        g = np.where(fin, g, 0.0)
        w0 = np.where(fin, w, 0.0)
        bad += int(((np.abs(g - w) > atol + rtol * np.abs(w)) | ~fin).sum())
        total += w.size
        gap = max(gap, float(np.abs(g.sum(0) - w0.sum(0)).max()))
    return {"bad_share": bad / max(total, 1),
            "mean_gap": gap / max(scale, 1e-12),
            "nonfinite": float(nonfinite)}


def worst(rows: list) -> dict:
    """The largest of each number over several frames."""
    return {k: max(r[k] for r in rows) for k in rows[0]}


class Reference:
    """A reference package's scene and tree on `device`, built from the
    scene file alone. The package (under portbench/reference/) is named by
    the configuration's file."""

    def __init__(self, scene_path: str, device: str, package: str):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.wavefront = importlib.import_module(
            f"{package}.integrator.wavefront")
        build = importlib.import_module(f"{package}.scene.build")
        trace = importlib.import_module(f"{package}.accel.trace")
        self.scene = build.build(scene_path, device=device)
        self.accel = trace.build(self.scene.geometry)

    def frame(self, seed: int, cell: dict, live: torch.Tensor,
              idx: torch.Tensor):
        """(values (P, C) numpy, names) at flat pixels idx of the frame
        rendered with `seed` at the cell's sizes, live pixels only."""
        dev = self.scene.device
        fb = self.wavefront.render_tiles(
            self.scene, self.accel, seed=seed,
            tile_pixels=cell["tile_pixels"], aa_samples=cell["aa"],
            xres=cell["xres"], yres=cell["yres"],
            rr_refr_start=cell.get("rr_refr_start", 99),
            live_pixels=live.to(dev))
        values = gather(fb, idx.to(dev)).cpu().numpy()
        return values, fb.names
