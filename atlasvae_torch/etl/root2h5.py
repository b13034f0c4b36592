"""ROOT -> HDF5 conversion (ref tools/root2h5.py, tools/root_utils.py).

Reading goes through :mod:`atlasvae_torch.etl.source` (uproot when installed,
the built-in :mod:`atlasvae_torch.etl.rootio` reader otherwise), so the full
pipeline — branch reading, JZW/DSID synthesis, MeV->GeV, weight scaling,
jet canonicalization, shuffled HDF5 write — runs and is tested without
any external ROOT stack.  The TLorentzVector math is re-derived in
``lorentz.py`` (no PyROOT).

Physics constants (DSIDs, cross sections in fb, filter efficiencies,
event counts / weight sums, luminosities) are detector metadata carried
over verbatim from ref tools/root2h5.py:38-95.  The full 171-branch
ntuple catalog lives in :mod:`atlasvae_torch.etl.branches`; ``convert`` can
pass any of its scalar branches through with ``extra_branches``.

The output goes through :mod:`atlasvae_torch.data.hdf5`: lzf-chunked where
h5py is installed, as the JAX package writes it, and contiguous and
uncompressed through ``LiteFile`` where it is not (the same values).
"""

import os

import numpy as np

from ..data import hdf5

from .lorentz import (pt_eta_phi_m_to_epxpypz, canonicalize_jets,
                      pt_order_jets, summed_4v)
from . import rootnative
from .source import open_tree
from . import branches as branch_catalog

SCALARS = [
    "rljet_m_calo", "rljet_m_comb", "rljet_pt_calo", "rljet_pt_comb",
    "rljet_ECF3", "rljet_C2", "rljet_D2", "rljet_Tau1_wta", "rljet_Tau2_wta",
    "rljet_Tau3_wta", "rljet_Tau32_wta", "rljet_FoxWolfram2",
    "rljet_PlanarFlow", "rljet_Angularity", "rljet_Aplanarity",
    "rljet_ZCut12", "rljet_Split12", "rljet_Split23", "rljet_KtDR",
    "rljet_Qw", "rljet_eta", "rljet_phi",
]  # ref tools/root2h5.py:28-32
JET_VAR = ["rljet_assoc_cluster_pt", "rljet_assoc_cluster_eta",
           "rljet_assoc_cluster_phi"]
OTHERS = ["weight_mc", "weight_pileup", "rljet_topTag_DNN19_qqb_score",
          "rljet_n_constituents"]
# branches stored in MeV upstream, converted to GeV (ref root_utils.py:50)
MEV_SCALARS = ["rljet_m_calo", "rljet_m_comb", "rljet_pt_calo",
               "rljet_pt_comb"]

LUMINOSITY = {"topo-dijet": 36.07456, "topo-ttbar": 36.07456,
              "UFO-dijet": 58.45010, "UFO-ttbar": 58.45010, "BSM": 58.45010}

# DSID weight tables (ref tools/root2h5.py:45-95)
_TABLES = {
    "topo-dijet": dict(
        dsids=["361023", "361024", "361025", "361026", "361027",
               "361028", "361029", "361030", "361031", "361032"],
        cross_sec=[26454000000.00, 254630000.000, 4553500.0, 257530.0, 16215.0,
                   625.04, 19.639, 1.1962, 0.042259, 0.0010367],
        filt_eff=[3.2012e-04, 5.3137e-04, 9.2395e-04, 9.4270e-04, 3.9280e-04,
                  1.0166e-02, 1.2077e-02, 5.9083e-03, 2.6734e-03, 4.2592e-04],
        denom=[15362751, 15925231, 15993500, 17834000, 15983000,
               15999000, 13915500, 13985000, 15948000, 15995600]),
    "UFO-dijet": dict(
        dsids=["364703", "364704", "364705", "364706", "364707",
               "364708", "364709", "364710", "364711", "364712"],
        cross_sec=[26450000000.00, 254610000.000, 4552900.0, 257540.0, 16215.0,
                   625.06, 19.639, 1.1962, 0.042263, 0.0010367],
        filt_eff=[1.1658e-02, 1.3366e-02, 1.4526e-02, 9.4734e-03, 1.1097e-02,
                  1.0156e-02, 1.2056e-02, 5.8933e-03, 2.6730e-03, 4.2889e-04],
        denom=[258.536, 8.67297, 0.345287, 0.0389311, 0.00535663,
               0.00154999, 0.000271431, 3.20958e-05, 1.6965e-05, 9.86921e-06]),
    "topo-ttbar": dict(
        dsids=["410284", "410285", "410286", "410287", "410288"],
        cross_sec=[7.2978e+05, 7.2976e+05, 7.2978e+05, 7.2975e+05, 7.2975e+05],
        filt_eff=[3.8208e-03, 1.5782e-03, 6.9112e-04, 4.1914e-04, 2.3803e-04],
        denom=[3.17751e+08, 1.00548e+08, 4.96933e+07, 3.87139e+07, 2.32803e+07]),
    "UFO-ttbar": dict(
        dsids=["410284", "410285", "410286", "410287", "410288"],
        cross_sec=[7.2978e+05, 7.2976e+05, 7.2978e+05, 7.2975e+05, 7.2975e+05],
        filt_eff=[3.8208e-03, 1.5782e-03, 6.9112e-04, 4.1914e-04, 2.3803e-04],
        denom=[4.23372e+08, 1.78314e+08, 8.72442e+07, 8.33126e+07, 3.69924e+07]),
    # ref tools/root2h5.py:75-91
    "BSM": dict(
        dsids=["302321", "302326", "302331", "310464", "310465", "310466",
               "310467", "310468", "310469", "310470", "310471", "310472",
               "310473", "310474", "310475", "310476", "310477", "450279",
               "450280", "450281", "450282", "450283", "450284", "450291",
               "450292", "450293", "450294", "450295", "450296", "449929",
               "449930", "503739"],
        cross_sec=[2.7610e+02, 4.6380e+01, 1.1160e+01, 2.5712e-03, 2.8366e-04,
                   5.0358e-05, 1.1463e-05, 2.5735e-03, 2.8576e-04, 5.0138e-05,
                   1.1473e-05, 2.5757e-03, 2.8336e-04, 5.0392e-05, 1.1403e-05,
                   2.5715e-03, 2.8401e-04, 1.0342e+00, 6.1132e+00, 2.0469e+01,
                   1.0501e+00, 4.1859e+00, 1.1302e+00, 3.7231e-02, 2.1800e-01,
                   7.3190e-01, 3.3723e-02, 1.2120e-01, 2.8290e-02, 1.0211e+00,
                   1.0214e+00, 3.4485e+00],
        filt_eff=[1.0000e+00, 1.0000e+00, 1.0000e+00, 4.6361e-01, 7.7126e-01,
                  8.7641e-01, 9.2337e-01, 6.5735e-01, 8.5953e-01, 9.2481e-01,
                  9.4986e-01, 2.8195e-01, 6.5096e-01, 8.0945e-01, 8.7866e-01,
                  5.2363e-01, 8.0082e-01, 1.0000e+00, 1.0000e+00, 1.0000e+00,
                  1.0000e+00, 1.0000e+00, 1.0000e+00, 1.0000e+00, 1.0000e+00,
                  1.0000e+00, 1.0000e+00, 1.0000e+00, 1.0000e+00, 1.0000e+00,
                  1.0000e+00, 1.0000e+00],
        denom=[59663., 69940., 59977., 40000., 40000., 40000., 40000., 40000.,
               40000., 39998., 40000., 40000., 40000., 40000., 40000., 39999.,
               40000., 19325., 19636., 19924., 19823., 19962., 19990., 17729.,
               18670., 20216.7, 19431.4, 20355.3, 20336.5, 100998., 101026.,
               378.34]),
}

_DIJET = ("topo-dijet", "UFO-dijet")


def id_weights(sample_type):
    """DSID -> per-event weight = xsec * filter-eff / N
    (ref tools/root2h5.py:92-95)."""
    t = _TABLES[sample_type]
    return dict(zip(t["dsids"],
                    np.array(t["cross_sec"]) * np.array(t["filt_eff"])
                    / np.array(t["denom"])))


def final_jets(pt, eta, phi, n_constituents=None, n_workers=None):
    """Constituent (pt, eta, phi) arrays -> processed flat (E,px,py,pz)
    blocks + summed kinematics (ref tools/root_utils.py:55-90
    ``final_jets``/``transform_jets``, vectorized; MeV->GeV upstream).

    pt/eta/phi: lists of per-jet variable-length arrays, or (J, C)
    arrays zero-padded.  Uses the fused native kernel
    (``rootnative.final_jets_native``) when available — one pass per
    jet, no full-block temporaries — with the numpy pipeline as the
    value-identical fallback.
    """
    if isinstance(pt, np.ndarray) and pt.ndim == 2:
        pt_a, eta_a, phi_a = pt, eta, phi
    else:
        n_max = n_constituents or max((len(p) for p in pt), default=1)
        pt_a = np.zeros((len(pt), max(n_max, 1)))
        eta_a, phi_a = np.zeros_like(pt_a), np.zeros_like(pt_a)
        for i, (p, e, f) in enumerate(zip(pt, eta, phi)):
            k = min(len(p), n_max)
            pt_a[i, :k], eta_a[i, :k], phi_a[i, :k] = p[:k], e[:k], f[:k]
    # the worker bound honors --n_workers / ATLASVAE_ETL_WORKERS like
    # the file-read fan-out does
    native = rootnative.final_jets_native(
        pt_a, eta_a, phi_a, n_workers=n_workers or _etl_workers())
    if native is not None:
        return native
    jets_ptep = np.stack([pt_a, eta_a, phi_a, np.zeros_like(pt_a)],
                         axis=-1).astype(np.float64)
    alive = jets_ptep[..., 0] > 0
    p4 = pt_eta_phi_m_to_epxpypz(jets_ptep[..., 0], jets_ptep[..., 1],
                                 jets_ptep[..., 2], jets_ptep[..., 3])
    p4 = p4 * alive[..., None]
    p4 = canonicalize_jets(p4)
    p4 = pt_order_jets(p4)
    out = summed_4v(p4)
    flat = p4.reshape(len(p4), -1).astype(np.float16)
    return {"constituents": flat, "E": np.float16(out["E"]),
            "pt_calo": np.float16(out["pt_calo"]),
            "m_calo": np.float16(out["m_calo"])}


def get_files(input_path, data_paths):
    """Recursive (.root path, DSID) discovery.  The DSID is the third
    dot-separated token of the dataset directory name
    (ref tools/root_utils.py:10-13 keys files the same way)."""
    pairs = []
    for path in data_paths:
        tokens = os.path.basename(path.rstrip("/")).split(".")
        dsid = tokens[2] if len(tokens) > 2 else "0"
        for root, _, names in os.walk(os.path.join(input_path, path)):
            pairs += [(os.path.join(root, n), dsid)
                      for n in sorted(names) if n.endswith(".root")]
    return sorted(pairs)


def count_constituents(file_pairs, tree="nominal", sources=None):
    """Max constituent multiplicity over all files
    (ref tools/root_utils.py:157-167: max of rljet_n_constituents)."""
    top = 0
    for path, _ in file_pairs:
        src = (sources or {}).get(path) or open_tree(path, tree)
        if sources is not None:
            sources[path] = src
        arr = src.scalar("rljet_n_constituents")
        if len(arr):
            top = max(top, int(np.max(arr)))
    return top


def _etl_workers():
    """Worker count for the per-file read fan-out: ATLASVAE_ETL_WORKERS
    env, else min(16, cpu count) — the analog of the reference's
    mp.Pool over (file x branch) products (ref tools/root_utils.py:20-23).
    Threads instead of processes: zlib/lz4 decompression and the native
    basket decoder release the GIL, and threads share the mmapped file
    buffers for free."""
    env = os.environ.get("ATLASVAE_ETL_WORKERS")
    if env:
        return max(1, int(env))
    return max(1, min(16, os.cpu_count() or 1))


def read_root_files(file_pairs, var_list, sample_type, weights_table,
                    n_constituents, tree="nominal", sources=None,
                    optional=(), n_workers=None):
    """Branch reader (ref tools/root_utils.py:16-52 ``get_data`` /
    ``root_conversion``).

    Per file: scalars reshaped to (n,), the four MeV kinematics /1000,
    ``weight_mc`` scaled by the per-DSID table; constituent branches take
    the leading jet's list, zero-pad/truncate to ``n_constituents``,
    cluster pt /1000, float16.  Dijet samples gain a synthesized ``JZW``
    (int8 index into the DSID table); ttbar/BSM gain ``DSID`` (int32).
    Files are read by a thread pool of ``n_workers`` (default
    ``_etl_workers()``); the output order is always the ``file_pairs``
    order, independent of worker count.
    """
    var_list = list(var_list)
    if sample_type in _DIJET:
        var_list += ["JZW"]
    elif sample_type in _TABLES:
        var_list += ["DSID"]
    out = {key: [] for key in var_list}
    dsid_order = list(weights_table)
    srcs = {path: (sources or {}).get(path) or open_tree(path, tree)
            for path, _ in file_pairs}
    # optional (extra) branches missing from ANY tree are dropped with a
    # warning — convert's contract is "pass through when present", and a
    # partial column would misalign the concatenated rows
    for key in optional:
        if key in out and any(key not in src for src in srcs.values()):
            print(f"WARNING: extra branch '{key}' absent from some input "
                  "trees -> dropped")
            del out[key]
    var_list = list(out)
    def _one_file(pair):
        path, dsid = pair
        src = srcs[path]
        n = src.num_entries
        cols = {}
        for key in var_list:
            if key == "JZW":
                idx = dsid_order.index(dsid) if dsid in dsid_order else -1
                cols[key] = np.full(n, idx, np.int8)
            elif key == "DSID":
                cols[key] = np.full(n, int(dsid), np.int32)
            elif key in JET_VAR:
                padded = src.leading_padded(key, n_constituents)
                if key == "rljet_assoc_cluster_pt":
                    padded /= 1000.0           # MeV -> GeV
                cols[key] = np.float16(padded)
            else:
                # native dtype preserved, as the reference writes each
                # branch in its ntuple dtype (ref tools/root_utils.py:47-51)
                # — int columns (counts, eventNumber, ...) must not be
                # rounded through float64
                arr = np.asarray(src.scalar(key))
                if key in MEV_SCALARS:
                    arr = np.float64(arr) / 1000.0   # MeV -> GeV
                if key == "weight_mc" and dsid in weights_table:
                    arr = np.float64(arr) * weights_table[dsid]
                cols[key] = arr
        return cols

    n_workers = min(n_workers or _etl_workers(), max(len(file_pairs), 1))
    if n_workers > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(n_workers) as pool:
            per_file = list(pool.map(_one_file, file_pairs))
    else:
        per_file = [_one_file(pair) for pair in file_pairs]
    for cols in per_file:                      # file_pairs order
        for key, arr in cols.items():
            out[key].append(arr)
    return {key: np.concatenate(val) for key, val in out.items()}


def convert(input_path, output_path, sample_type, n_constituents="unknown",
            tag=0, seed=0, tree="nominal", extra_branches=(),
            n_workers=None):
    """Full conversion flow (ref tools/root2h5.py:110-133).

    ``extra_branches``: names from the full ntuple catalog
    (:mod:`atlasvae_torch.etl.branches`) to pass through as additional scalar
    columns when present in the tree.  ``n_workers`` threads read files
    concurrently (default: min(16, cpu count), the analog of the
    reference's mp.Pool fan-out, ref tools/root_utils.py:20-23).
    """
    table = _TABLES.get(sample_type, {})
    weights_table = id_weights(sample_type) if sample_type in _TABLES else {}
    if sample_type in _DIJET:
        id_list = [table["dsids"][int(tag)]]
        output_file = f"{sample_type}_{id_list[0]}.h5"
    else:
        id_list = table.get("dsids", [])
        output_file = f"{sample_type}.h5"
    if not os.path.isdir(input_path):
        raise SystemExit(f"input_path '{input_path}' does not exist — point "
                         "it at a directory of ROOT ntuples "
                         "(ref tools/root2h5.py input layout)")
    data_paths = sorted(p for p in os.listdir(input_path)
                        if len(p.split(".")) > 2 and p.split(".")[2] in id_list)
    if not data_paths:
        raise SystemExit(f"no ROOT files matching DSIDs {id_list} under "
                         f"'{input_path}'")
    file_pairs = get_files(input_path, data_paths)
    unknown = set(extra_branches) - set(branch_catalog.catalog())
    if unknown:
        raise ValueError(f"extra_branches not in the ntuple catalog: "
                         f"{sorted(unknown)}")
    var_list = SCALARS + JET_VAR + OTHERS + [
        b for b in extra_branches
        if b not in SCALARS + JET_VAR + OTHERS
        and b not in branch_catalog.JAGGED]
    sources = {}  # one open (mmapped) tree per file across both passes
    if n_constituents == "unknown":
        n_constituents = count_constituents(file_pairs, tree, sources=sources)
    data = read_root_files(file_pairs, var_list, sample_type, weights_table,
                           int(n_constituents), tree, sources=sources,
                           optional=tuple(extra_branches),
                           n_workers=n_workers)
    pt, eta, phi = (data.pop(k) for k in JET_VAR)
    data.update(final_jets(np.float64(pt), np.float64(eta), np.float64(phi),
                           n_workers=n_workers))
    data["weights"] = (LUMINOSITY[sample_type] * data.pop("weight_mc")
                       * data.pop("weight_pileup"))
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(data["weights"]))
    os.makedirs(output_path, exist_ok=True)
    with hdf5.File(os.path.join(output_path, output_file), "w") as f:
        for key, val in data.items():
            f.create_dataset(key, data=np.asarray(val)[order],
                             compression="lzf")
    return os.path.join(output_path, output_file)
