"""Console banner of the program arguments (a copy of ``args_banner`` from
``atlasvae/utils/logging.py``: the port imports nothing of the JAX
package), and the host-clock times of a pipeline's steps."""

import time


def args_banner(args):
    """Tabulated program-arguments banner."""
    items = vars(args).items() if hasattr(args, "__dict__") else dict(args).items()
    rows = [(str(k), str(v)) for k, v in items]
    key_w = max((len(k) for k, _ in rows), default=0)
    val_w = max((len(v) for _, v in rows), default=0)
    sep = "+" + "-" * (key_w + 2) + "+" + "-" * (val_w + 2) + "+"
    lines = [sep]
    for k, v in rows:
        lines.append(f"| {k:<{key_w}} | {v:<{val_w}} |")
    lines.append(sep)
    return "\n".join(lines)


class StepTimes(dict):
    """{step name: host-clock ms}: ``steps("name", fn, *args)`` returns
    ``fn(*args)`` and records how long it took.  A step whose result is a
    host array has waited for the device."""

    def __call__(self, name, fn, *args, **kwargs):
        start = time.perf_counter()
        out = fn(*args, **kwargs)
        self[name] = (time.perf_counter() - start) * 1e3
        return out
