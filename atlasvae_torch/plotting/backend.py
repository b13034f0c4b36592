"""matplotlib for the drawing functions, loaded at their first call.

The machine with the card has no matplotlib, so no module of the port
imports it at import time: each drawing function asks ``pyplot()`` for it,
and an entry point that will draw checks first with ``require_matplotlib``,
before it loads any data."""


def pyplot():
    """``matplotlib.pyplot`` on the non-interactive Agg backend."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def require_matplotlib(option):
    """Raise ImportError, naming matplotlib and ``option``, where matplotlib
    cannot be imported."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as exc:
        raise ImportError(f"{option} draws its plots with matplotlib, which cannot be "
                          f"imported here ({exc}); pass --plotting OFF to run without "
                          "drawing") from exc
