"""Axis layout shared by all VM fields (the part of
rodynrf_tpu/ops/grid_sample.py this slice needs; reference
tensorBase.py:326-327)."""

MAT_MODE = ((0, 1), (0, 2), (1, 2))
VEC_MODE = (2, 1, 0)


def _strided_len(n: int, stride: int) -> int:
    """Texel count of the stride-s virtual grid plane[..., ::s]."""
    return (n + stride - 1) // stride
