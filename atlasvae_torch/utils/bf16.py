"""Distances between bfloat16 values in units of their last place, for the
checks that hold the bf16 kernels and paths against their plain versions
(the card's tests and chip_smoke.py)."""

import torch


def ulps_apart(a, b):
    """Elementwise distance of two bfloat16 tensors in bf16 ulps: the
    difference of their bit patterns read as ordered integers (-0 and +0
    both 0)."""

    def ordered(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)

    return (ordered(a) - ordered(b)).abs()


def ulp(t):
    """One bfloat16 ulp at each element of t (8 significant bits), 0 where
    t is 0."""
    mant, exp = torch.frexp(t.float())
    return torch.where(t == 0, 0.0, torch.ldexp(torch.ones_like(mant), exp - 8))
