"""One assertion for the port's tests that compare arrays: on failure it names
what was compared and gives the largest gap beyond the bar, with its index
and both values, so that a failure seen once leaves its numbers in the log.
Imports neither JAX nor the JAX package (the card's tests use it too)."""

import numpy as np


def assert_close(got, want, what, rtol=0.0, atol=0.0):
    """|got - want| <= atol + rtol * |want| everywhere, NaNs equal."""
    got = np.asarray(got.detach().cpu() if hasattr(got, "detach") else got, np.float64)
    want = np.asarray(want.detach().cpu() if hasattr(want, "detach") else want, np.float64)
    assert got.shape == want.shape, f"{what}: shape {got.shape} != {want.shape}"
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    gap = np.where(same, 0.0, np.abs(got - want))
    excess = np.where(same, -1.0, np.nan_to_num(gap - (atol + rtol * np.abs(want)), nan=np.inf))
    if got.size and excess.max() > 0:
        at = np.unravel_index(int(np.argmax(excess)), got.shape)
        raise AssertionError(
            f"{what}: {int((excess > 0).sum())} of {got.size} over atol {atol} + rtol {rtol}; "
            f"largest gap {gap[at]:.6g} at index {tuple(int(i) for i in at)} "
            f"(got {got[at]!r}, want {want[at]!r}); largest gap anywhere {np.nanmax(gap):.6g}")
