from .bumphunter import (BumpHunter1D, BumpHunterInterface, scan_histograms,
                         batched_bump_sigma, batched_local_sigma,
                         bump_sigma_sharded)
from .fit import fit_gaussian, gaussian

__all__ = ["BumpHunter1D", "BumpHunterInterface", "scan_histograms",
           "batched_bump_sigma", "batched_local_sigma", "bump_sigma_sharded",
           "fit_gaussian", "gaussian"]
