"""3D box corners (order of the reference's utils/box_util.py:get_3d_box_batch)."""
from __future__ import annotations

from typing import Optional

import torch

# Unit corner signs (8, 3): x = +-l/2, y = +-w/2, z = +-h/2.
_CORNER_SIGNS = (
    (1, 1, 1), (1, -1, 1), (-1, -1, 1), (-1, 1, 1),
    (1, 1, -1), (1, -1, -1), (-1, -1, -1), (-1, 1, -1),
)


def corner_signs(dtype: torch.dtype, device) -> torch.Tensor:
    """``_CORNER_SIGNS`` made on ``device`` from an arange, not copied from
    the host: a captured eval step (``train/capture.py``) builds them too,
    and a capture refuses a copy from pageable host memory."""
    i = torch.arange(8, device=device)
    bits = torch.stack([(i // 2) % 2, ((i + 1) // 2) % 2, i // 4], dim=-1)
    return (1 - 2 * bits).to(dtype)


def get_3d_box_batch(box_size: torch.Tensor, heading_angle: Optional[torch.Tensor],
                     center: torch.Tensor) -> torch.Tensor:
    """box_size (..., 3) [l, w, h]; heading (...,) or None; center (..., 3)
    -> corners (..., 8, 3)."""
    signs = corner_signs(box_size.dtype, box_size.device)
    corners = (box_size * 0.5)[..., None, :] * signs
    if heading_angle is not None:
        c = torch.cos(heading_angle)[..., None]
        s = torch.sin(heading_angle)[..., None]
        x, y, z = corners.unbind(-1)
        corners = torch.stack([c * x + s * z, y, -s * x + c * z], dim=-1)
    return corners + center[..., None, :]
