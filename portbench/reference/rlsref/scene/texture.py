"""Textures: outside this reference.

The reference decodes no image file: `load_image` raises, so a scene that
links a texture file is refused rather than rendered without it, and the
scene's texture table is always the empty `TextureStack`.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def load_image(path: str) -> np.ndarray:
    """Image textures are outside this reference."""
    raise NotImplementedError(f"{path}: the reference decodes no images")


class TextureStack(NamedTuple):
    """The empty texture table: one black texel."""

    data: torch.Tensor

    @staticmethod
    def build(images: list, device="cuda") -> "TextureStack":
        if images:
            raise NotImplementedError("the reference samples no textures")
        return TextureStack(data=torch.zeros((1, 3), device=device))
