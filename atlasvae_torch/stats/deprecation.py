"""Warn-once deprecation decorators for the legacy BumpHunter API (a copy
of ``atlasvae/stats/deprecation.py``).

ref OE-VAE/BumpHunter/util.py:1-60 — the reference keeps its pre-rename
public surface (CamelCase methods such as ``BumpScan``; ``Npe`` /
``Nworker`` / ``useSideBand`` keyword arguments) alive through
FutureWarning shims, so scripts written against old pyBumpHunter keep
running.  Drop-in users may rely on that surface; the rebuilt
BumpHunter1D carries the same shims with the same warning category.
"""

import functools
import warnings

_warned_funcs = set()
_warned_args = set()


def deprecated(instruction):
    """Mark a function deprecated; warn once per process with
    *instruction* on what to call instead (ref util.py:41-60)."""

    def decorator(func):
        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            if func not in _warned_funcs:
                warnings.warn(
                    f"{func.__qualname__} is deprecated and will be removed"
                    f" in a future release. {instruction}",
                    category=FutureWarning, stacklevel=2)
                _warned_funcs.add(func)
            return func(*args, **kwargs)

        return wrapper

    return decorator


def warn_legacy_arg(func_name, oldarg, newarg):
    """Warn once that deprecated kwarg *oldarg* was passed to *func_name*
    (ref util.py:10-39; the reference's decorator only warns — the actual
    value remapping is inline in each callee, ref bumphunter_1dim.py:290-295
    — so a plain helper is the honest shape here)."""
    if (func_name, oldarg) not in _warned_args:
        warnings.warn(
            f"The argument {oldarg} of {func_name} is deprecated and will"
            f" be removed in a future release. Use {newarg} instead.",
            category=FutureWarning, stacklevel=3)
        _warned_args.add((func_name, oldarg))
