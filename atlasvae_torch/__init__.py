"""atlasvae_torch — the PyTorch/CUDA port of atlasvae for an NVIDIA H100.

The JAX package ``atlasvae`` is the reference; this package mirrors its
layout (``models``, ``ops``, ``losses``, ``eval``, ``train``, ``data``,
``utils``, ``cli``) and imports nothing of it.  Every Pallas kernel on a
ported path is a hand-written CUDA kernel here (``csrc/``), built with
``nvcc`` at first use, with a plain PyTorch twin beside it that is the CPU
path.  Entry points run on ``device="cuda"`` unless the caller asks for the
CPU.  Importing the package touches neither CUDA nor ``nvcc``.
"""

import torch

__version__ = "0.1.0"


def resolve_device(device="cuda"):
    """``torch.device(device)``, refusing a CUDA device when there is none
    (no silent fall-back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() "
                           "is False; pass device='cpu' to run on the CPU")
    return device
