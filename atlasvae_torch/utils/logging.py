"""Console banner of the program arguments.  Copy of ``args_banner`` from
``atlasvae/utils/logging.py`` (the port imports nothing of the JAX
package)."""


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
