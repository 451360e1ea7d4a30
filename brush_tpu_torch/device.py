"""Device selection and float32 pinning shared by the port's modules."""

from __future__ import annotations

import contextlib
import threading

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


# Threads share the two flags: the viewer renders on its HTTP threads while
# its worker trains. The first of them to enter full_f32 saves and clears
# the flags, the last to leave restores them.
_f32_lock = threading.Lock()
_f32_users = 0
_f32_saved = (False, False)


@contextlib.contextmanager
def full_f32():
    """Disable TF32 for matmuls and cuDNN convolutions inside the block.

    The reference pins Precision.HIGHEST for its f32 matmuls and SSIM
    convolutions; TF32 keeps about three decimal digits, so the knn
    distances, projection and SSIM run with it off. The flags are global
    to the process, so they stay off while any thread is inside a block.
    """
    global _f32_users, _f32_saved
    with _f32_lock:
        if _f32_users == 0:
            _f32_saved = (torch.backends.cuda.matmul.allow_tf32,
                          torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        _f32_users += 1
    try:
        yield
    finally:
        with _f32_lock:
            _f32_users -= 1
            if _f32_users == 0:
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32) = _f32_saved
