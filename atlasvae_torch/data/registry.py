"""Dataset registry: logical sample names -> HDF5 paths.

Copy of ``atlasvae/data/registry.py`` (the port imports nothing of the
JAX package).

Mirrors the reference's host-keyed ``get_file`` map
(ref OE-VAE/utils.py:12-33) with the same logical names, but resolves
the data directory from the ``ATLASVAE_DATA_DIR`` environment variable
(falling back to ``./data``) and supports runtime registration so tests
and the synthetic-data path can inject files.
"""

import os
from pathlib import Path

# Logical name -> file name, matching the reference registry
# (ref OE-VAE/utils.py:15-32).
DATA_FILES = {
    "QCD-Geneva": "formatted_converted_20210629_QCDjj_pT_450_1200_nevents_10M_dPhifixed_float32.h5",
    "top-Geneva": "formatted_converted_20211213_ttbar_allhad_pT_450_1200_nevents_10M_dPhifixed_float32.h5",
    "2HDM-Geneva": "formatted_converted_delphes_H_HpHm_generation_mh2_5000_mhc_500_nevents_1M_float32.h5",
    "VZ-Geneva": "formatted_converted_delphes_z_zprime_tt_allhad_MVz_5000_MT_500_nevents_1M_float32.h5",
    "QCD-Delphes": "Delphes_dijet.h5",
    "top-Delphes": "Delphes_ttbar.h5",
    "QCD-topo": "Atlas_topo-dijet.h5",
    "top-topo": "Atlas_topo-ttbar.h5",
    "QCD-UFO": "Atlas_UFO-dijet.h5",
    "top-UFO": "Atlas_UFO-ttbar.h5",
    "BSM": "Atlas_BSM.h5",
    "OoD-W": "resamples_oe_w.h5",
    "OoD-H": "formatted_converted_Outliers_delphes_H_HpHm_generationredo_float32.h5",
}

_OVERRIDES = {}
_WARNED_SYNTHETIC = set()


def data_dir():
    return Path(os.environ.get("ATLASVAE_DATA_DIR", "data"))


def register_file(data_type, path):
    """Register/override the HDF5 path for a logical sample name."""
    _OVERRIDES[data_type] = str(path)


def get_file(data_type):
    """Resolve a logical sample name (or literal path) to an HDF5 path.

    Resolution order: runtime registration -> production file name in
    the data dir -> ``synthetic_<name>.h5`` in the data dir (so CLI
    processes find datasets generated by ensure_synthetic_registry
    without re-registering) -> literal path.
    """
    if data_type in _OVERRIDES:
        return _OVERRIDES[data_type]
    if data_type in DATA_FILES:
        path = data_dir() / DATA_FILES[data_type]
        if path.is_file():
            return str(path)
        synthetic = data_dir() / f"synthetic_{data_type}.h5"
        if synthetic.is_file():
            if data_type not in _WARNED_SYNTHETIC:
                _WARNED_SYNTHETIC.add(data_type)
                print(f"WARNING: production file for {data_type!r} not found; "
                      f"using SYNTHETIC data at {synthetic}")
            return str(synthetic)
        return str(path)
    if os.path.isfile(data_type):
        return data_type
    raise KeyError(
        f"unknown dataset {data_type!r}: not registered, not in DATA_FILES, "
        f"and not a file path"
    )
