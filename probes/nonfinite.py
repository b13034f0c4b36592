#!/usr/bin/env python3
"""NaN and inf through every route of K1-K6, this tree's kernels and earlier
trees', against this tree's plain versions, on one NVIDIA GPU.

    python3 probes/nonfinite.py [--build NAME=DIR ...] [--out build/probe_nonfinite.json]

Runs ``chip_smoke.parity_nonfinite`` (every route of K1-K6 at a main path's
shape on inputs with NaN, +inf and -inf planted, against its plain version)
with this tree's kernels, then with the kernels of every tree named by
``--build NAME=DIR`` (e.g. the parent commit, ``git archive``d into a
directory .gitignore lists; its ``atlasvae_torch/`` is enough), loaded in
the same process as ``atlasvae_torch_<NAME>``: their wrappers take the
place of this tree's, and the plain versions, the reference, stay this
tree's.  A route that parts from its plain version is counted, not raised,
so an earlier tree's counts show what a change repaired.  Prints the
``[nonfinite]`` lines, then one JSON object as its last line: per tree and
route, the calls, the calls and elements that parted and the elements of
each kind on both sides.
"""

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# the kernel wrappers parity_nonfinite calls, by module
WRAPPERS = {"fused_mlp": ("fused_mlp_apply",), "fused_vae": ("stack_forward", "stack_backward"),
            "emd_cuda": ("emd_sinkhorn",),
            "fused_conv_cuda": ("conv_pool_relu", "conv_pool_relu_backward")}
PARTED = ("finite_apart", "inf_to_nan", "nan_to_inf", "inf_signs_apart", "over_bar")


def load_tree(name, root):
    """An earlier tree's package loaded as atlasvae_torch_<name>; its ops
    modules named in WRAPPERS."""
    pkg = f"atlasvae_torch_{name}"
    spec = importlib.util.spec_from_file_location(
        pkg, root / "atlasvae_torch" / "__init__.py",
        submodule_search_locations=[str(root / "atlasvae_torch")])
    module = importlib.util.module_from_spec(spec)
    sys.modules[pkg] = module
    spec.loader.exec_module(module)
    return {m: importlib.import_module(f"{pkg}.ops.{m}") for m in WRAPPERS}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--build", action="append", default=[], metavar="NAME=DIR")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("probes/nonfinite.py: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke
    ours = {m: importlib.import_module(f"atlasvae_torch.ops.{m}") for m in WRAPPERS}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    case = chip_smoke._nonfinite_case

    def counted(rows, *a):
        try:
            case(rows, *a)
        except AssertionError:
            rows[-1]["parted"] = True

    chip_smoke._nonfinite_case = counted
    trees = [("this", None)] + [tuple(item.split("=", 1)) for item in args.build]
    saved = {(m, f): getattr(ours[m], f) for m, fs in WRAPPERS.items() for f in fs}
    device = torch.device("cuda")
    report = {"card": smi, "trees": {}}
    for name, tree in trees:
        if tree is not None:
            theirs = load_tree(name, Path(tree).resolve())
            for m, fs in WRAPPERS.items():
                for f in fs:
                    setattr(ours[m], f, getattr(theirs[m], f))
        print(f"[tree] {name}", flush=True)
        try:
            rows = chip_smoke.parity_nonfinite(torch.Generator(device).manual_seed(1234), device)
        finally:
            for (m, f), fn in saved.items():
                setattr(ours[m], f, fn)
        routes = {}
        for r in rows:
            total = routes.setdefault(r["route"], {"calls": 0, "calls_parted": 0})
            total["calls"] += 1
            total["calls_parted"] += bool(r.get("parted"))
            for k, v in r.items():
                if isinstance(v, int) and not isinstance(v, bool):
                    total[k] = total.get(k, 0) + v
        for total in routes.values():
            total["elements_parted"] = sum(total.get(k, 0) for k in PARTED)
        report["trees"][name] = routes
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
