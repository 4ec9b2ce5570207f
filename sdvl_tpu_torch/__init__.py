"""PyTorch/CUDA port of the semi-direct visual SLAM system in ``sdvl_tpu``.

Same sub-packages and module names as the JAX package (``core ops solvers
state pipeline io utils cli dist viz``) so that every function's
counterpart is easy to find; the command-line program is ``python -m
sdvl_tpu_torch.cli.run``. The port imports ``torch``, ``numpy`` and the
standard library only (the live-camera source and the live viewer's windows
need OpenCV, the map figures of ``--viz`` matplotlib; each imports it when
used). Entry points take an explicit ``device``
that defaults to ``"cuda"`` and raise when that device is absent; nothing
falls back to the CPU on its own.

TF32 is switched off at import: the small normal-equation solves and the
corner scores must stay true float32 to agree with the reference.
"""

import functools

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"


# never evicted: a captured CUDA graph keeps reading the tensors it was
# given, so a constant must live as long as the process
@functools.lru_cache(maxsize=None)
def _const(values, dtype, device: str) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def const(values, dtype, device) -> torch.Tensor:
    """A small constant tensor (a number or a tuple of numbers) on ``device``,
    uploaded once and then reused: ``torch.tensor(..., device="cuda")`` copies
    from the host and waits for the stream on every call, which a per-frame
    code path must not do. The result is shared; never write to it in
    place."""
    return _const(values, dtype, str(device))


def require_device(device) -> torch.device:
    """The ``torch.device`` an entry point was asked for, or an error: a
    CUDA device that this machine does not have is never replaced by the
    CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' explicitly to run on the CPU"
        )
    return dev
