"""A function cut into parts where the host decides between them: the
greedy decode's early exit, which the JAX package runs on the device as a
``lax.cond``. The eager eval and train steps run the parts with
``run_eager``; a captured one (``train/capture.py``) replays a CUDA graph
a part and takes the same decisions between them."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, ContextManager, Dict, List, Optional

import torch


@dataclasses.dataclass
class Segments:
    """A function as the parts it runs in order on a carry dict, whose
    ``"inputs"`` is the batch (and ``"gen"`` the dropout generator of a
    train step). Each part but the last returns a 0-dim bool test on the
    device, or None; the last returns the result. Where a test is true,
    ``skip(carry, k)`` (k: the part that returned it) runs and the last
    part follows. ``around_capture(carry)``, where given, is a context
    manager that a captured program enters around the capture of the parts,
    after the eager warm-up: the train step's puts the warm-up's gradients
    into the ``.grad`` tensors the capture allocates."""

    parts: List[Callable[[Dict], Any]]
    skip: Optional[Callable[[Dict, int], None]] = None
    around_capture: Optional[Callable[[Dict], ContextManager]] = None


def run_eager(segments: Segments, inputs: Dict[str, torch.Tensor], **carry) -> Any:
    """The function run op by op, its host tests between the parts;
    ``carry`` holds the carry's other entries."""
    carry = {"inputs": inputs, **carry}
    for k, part in enumerate(segments.parts[:-1]):
        test = part(carry)
        if test is not None and bool(test):
            segments.skip(carry, k)
            break
    return segments.parts[-1](carry)
