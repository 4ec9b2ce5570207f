"""Peaks of the chip and the bytes a kernel has to move.

One NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at its 700 W power
limit): HBM3 at 3.35 TB/s, 67 TFLOP/s in float32 outside the tensor
cores."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def detect_bytes(height: int, width: int, levels: int, cell: int) -> int:
    """Bytes the detection kernel (``csrc/detect.cu``) has to move for one
    frame: each float32 pyramid level read once and its float32 score map
    written once, and one int64 key per cell of every level (the bound of
    the port's kernel table)."""
    px = cells = 0
    for lvl in range(levels):
        h, w = height >> lvl, width >> lvl
        px += h * w
        cells += (h // cell) * (w // cell)
    return 2 * 4 * px + 8 * cells
