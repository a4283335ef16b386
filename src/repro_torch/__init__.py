"""PyTorch/CUDA port of the AccMPEG reproduction (``repro``).

The package mirrors ``repro``'s module names and public layouts (NHWC
frames, ``(T, H, W, C)`` chunks, ``(mb_h, mb_w)`` QP maps). Entry points
take an explicit ``device`` (default ``"cuda"``) and raise when CUDA is
missing unless the caller asks for ``device="cpu"``; the camera codec's
``pallas`` / ``fused`` / ``fused_exact`` backends launch the hand-written
kernels of :mod:`repro_torch.kernels.mbcodec` on CUDA tensors and their
plain PyTorch versions on CPU tensors.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`; refuses CUDA where there is
    none instead of running somewhere else."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is "
            "false; pass device='cpu' to run the plain PyTorch path")
    return dev


def synchronize(device: torch.device):
    """Wait for ``device``'s queued work (a no-op on the CPU), so that a
    host clock read after it measures the work and not its enqueue."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


#: the counting pass of ``repro_torch.launch.analysis`` that is running, if
#: any (it sets and clears this)
COUNTING: list = []


def loop(body, items, carry=None):
    """``body(item, carry) -> (out, carry)`` over ``items`` in order ->
    (the list of outs, the last carry): a Python loop whose passes all
    have the same shapes (a sequence's chunks, a scan's positions).
    Under a counting pass of ``repro_torch.launch.analysis`` (meta
    tensors) it runs three passes of a longer loop, one of them counted
    for all the passes between the first and the last, as the reference's
    analysis counts a loop body by its trip count; what it returns then
    stands for shapes only."""
    items = list(items)
    if COUNTING:
        return COUNTING[-1].repeated(body, items, carry)
    return _loop(body, items, carry)


def _loop(body, items, carry):
    outs = []
    for item in items:
        out, carry = body(item, carry)
        outs.append(out)
    return outs, carry
