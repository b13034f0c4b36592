"""Model input assembly.  The training loop itself comes with the training
slice; counterpart of ``features`` in ``atlasvae/train/loop.py``."""

import numpy as np
import torch


def features(sample):
    """Assemble the model input matrix from a sample dict: constituents,
    then HLVs, whichever are present (tensors or arrays)."""
    if "constituents" in sample and "HLVs" in sample:
        parts = [sample["constituents"], sample["HLVs"]]
        if isinstance(parts[0], torch.Tensor):
            return torch.cat(parts, dim=1)
        return np.hstack(parts)
    if "constituents" in sample:
        return sample["constituents"]
    return sample["HLVs"]
