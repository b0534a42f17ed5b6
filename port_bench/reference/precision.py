"""Rounding to TF32, the precision of the control (float32's nearest lower
step where float32 runs with TF32 off): a float32 value with its mantissa
rounded to TF32's 10 bits, to nearest, ties to even."""

import torch


def tf32(x):
    """`x` rounded to TF32's precision, returned in float64."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    lsb = (b >> 13) & 1
    b = ((b + 0x0FFF + lsb) >> 13) << 13
    return b.view(torch.float32).to(torch.float64)
