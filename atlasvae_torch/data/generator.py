"""Memory-budgeted streaming sample generator with host prefetch.

Counterpart of ``atlasvae/data/generator.py``: an epoch is a sequence of
"loads", each a chunk of the background HDF5 bounded by a host-memory
budget (``load_size = 1e9*mem_gb / n_const / n_dims / 4`` jets).  Each load
is: read chunk -> OoD pairing -> reweighting -> scaling, all on the host
(CPU tensors and numpy); the training device receives only the packed
batches (train/step.py).  A single-load epoch is prepared once and handed
out as the same objects every epoch, so ``LoadCache`` finds it on the
device by identity.  A multi-load epoch prepares load k+1 on a worker
thread while the trainer consumes load k (one load of double buffering);
a load that fails on the worker is raised in the consumer.  With an
``output_dir`` the first load's m and pt distributions (background and OoD
after reweighting, before scaling) are drawn there as ``train_*.png``.
"""

import queue
import threading

import numpy as np

from .loader import load_data
from .pairing import ood_pairing
from .weights import reweight_sample
from .scalers import apply_scaler

_HOST = "cpu"


class BatchGenerator:
    def __init__(self, bkg_data, ood_data, n_const, n_dims, n_bkg, ood_sample=None,
                 weight_type="X-S", cuts=(), constituents="ON", hlvs="ON", hlv_list=None,
                 bin_sizes=None, hlv_scaler=None, const_scaler=None, is_train=False,
                 mem_gb=30, pairing_seed=0, output_dir=None):
        self.bkg_data = bkg_data
        self.ood_data = ood_data
        self.n_const = n_const
        self.n_dims = n_dims
        self.n_bkg = list(n_bkg)
        self.ood_sample = ood_sample
        self.weight_type = weight_type
        self.cuts = cuts
        self.constituents = constituents
        self.hlvs = hlvs
        self.hlv_list = hlv_list
        self.bin_sizes = bin_sizes
        self.hlv_scaler = hlv_scaler
        self.const_scaler = const_scaler
        self.is_train = is_train
        self.pairing_seed = pairing_seed
        self.output_dir = output_dir
        span = self.n_bkg[1] - self.n_bkg[0]
        self.load_size = min(span, int(1e9 * mem_gb / max(n_const * n_dims * 4, 1)))
        # a single-load epoch is the same prepared load every epoch (fixed
        # pairing and reweighting seeds): prepare it once
        self._cache = {} if len(self) == 1 else None

    def __len__(self):
        span = self.n_bkg[1] - self.n_bkg[0]
        return int(np.ceil(span / self.load_size))

    def __getitem__(self, gen_idx):
        if self._cache is not None and gen_idx in self._cache:
            return self._cache[gen_idx]
        load = self._prepare_load(gen_idx)
        if self._cache is not None:
            self._cache[gen_idx] = load
        return load

    def _scale(self, sample, tag):
        if "constituents" in sample:
            sample["constituents"] = apply_scaler(sample["constituents"], self.n_dims,
                                                  self.const_scaler, tag, device=_HOST)
        if "HLVs" in sample:
            sample["HLVs"] = apply_scaler(sample["HLVs"], self.n_dims, self.hlv_scaler, tag,
                                          device=_HOST)

    def _prepare_load(self, gen_idx):
        tag = "training" if self.is_train else "validation"
        print(f"\nLOADING QCD {tag.upper()} SAMPLE")
        lo = gen_idx * self.load_size + self.n_bkg[0]
        hi = min((gen_idx + 1) * self.load_size + self.n_bkg[0], self.n_bkg[1])
        bkg_sample = load_data(self.bkg_data, (lo, hi), self.cuts, self.n_const, self.n_dims,
                               self.constituents, self.hlvs, self.hlv_list, device=_HOST)
        ood_sample = self.ood_sample if self.ood_sample is not None else bkg_sample
        ood_sample = ood_pairing(bkg_sample, ood_sample, seed=self.pairing_seed + gen_idx)
        if self.bin_sizes is not None:
            bkg_sample, ood_sample = reweight_sample(bkg_sample, ood_sample, self.bin_sizes,
                                                     self.weight_type)
        if self.output_dir is not None and gen_idx == 0:
            from ..plotting.distributions import sample_distributions
            merged = {key: np.concatenate([bkg_sample[key], ood_sample[key]])
                      for key in ("m", "pt", "weights", "JZW")}
            sample_distributions(merged, self.ood_data, self.output_dir, "train",
                                 self.weight_type, self.bin_sizes)
        self._scale(bkg_sample, "QCD")
        if self.ood_sample is None:
            # a caller's OoD sample arrives scaled; the self-paired fallback
            # was drawn from the raw background load, so scale it too
            self._scale(ood_sample, "OoD")
        return bkg_sample, ood_sample

    def __iter__(self):
        """Double-buffered iteration: load k+1 on a worker thread while the
        trainer consumes load k."""
        n = len(self)
        if n == 1:
            yield self[0]
            return
        out = queue.Queue(maxsize=1)

        def worker():
            for i in range(n):
                try:
                    load = self[i]
                except BaseException as exc:  # handed to the consumer, which raises it
                    out.put(exc)
                    return
                out.put(load)

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        for _ in range(n):
            item = out.get()
            if isinstance(item, BaseException):
                thread.join()
                raise item
            yield item
        thread.join()
