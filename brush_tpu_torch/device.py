"""Device selection and float32 pinning shared by the port's modules."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device) -> torch.device:
    """torch.device for `device`; raises if CUDA is asked for and absent.

    The port never carries on quietly on the CPU when the caller asked for
    the card: a CPU run is a different measurement.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    return dev


@contextlib.contextmanager
def full_f32():
    """Disable TF32 for matmuls and cuDNN convolutions inside the block.

    The reference pins Precision.HIGHEST for its f32 matmuls and SSIM
    convolutions; TF32 keeps about three decimal digits, so the knn
    distances, projection and SSIM run with it off.
    """
    mm = torch.backends.cuda.matmul.allow_tf32
    cd = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd
