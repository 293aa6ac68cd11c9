"""3D box corners (order of the reference's utils/box_util.py:get_3d_box_batch)."""
from __future__ import annotations

from typing import Optional

import torch

# Unit corner signs (8, 3): x = +-l/2, y = +-w/2, z = +-h/2.
_CORNER_SIGNS = (
    (1, 1, 1), (1, -1, 1), (-1, -1, 1), (-1, 1, 1),
    (1, 1, -1), (1, -1, -1), (-1, -1, -1), (-1, 1, -1),
)


def get_3d_box_batch(box_size: torch.Tensor, heading_angle: Optional[torch.Tensor],
                     center: torch.Tensor) -> torch.Tensor:
    """box_size (..., 3) [l, w, h]; heading (...,) or None; center (..., 3)
    -> corners (..., 8, 3)."""
    signs = torch.tensor(_CORNER_SIGNS, dtype=box_size.dtype, device=box_size.device)
    corners = (box_size * 0.5)[..., None, :] * signs
    if heading_angle is not None:
        c = torch.cos(heading_angle)[..., None]
        s = torch.sin(heading_angle)[..., None]
        x, y, z = corners.unbind(-1)
        corners = torch.stack([c * x + s * z, y, -s * x + c * z], dim=-1)
    return corners + center[..., None, :]
