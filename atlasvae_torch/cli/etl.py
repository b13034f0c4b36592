"""ETL entry point: ROOT -> HDF5 conversion and shuffle-merging.

Mirrors the reference's root2h5 CLI (ref tools/root2h5.py:10-16:
sample_type / n_constituents / merging / tag flags).  ROOT reading uses
uproot when installed and the built-in atlasvae_torch.etl.rootio reader
otherwise; the merging path works on any HDF5 directory.  HDF5 goes
through atlasvae_torch.data.hdf5: with h5py the files are lzf-chunked as
the JAX package writes them, without it (LiteFile) contiguous and
uncompressed, with the same values.  Nothing here touches the card, so
there is no --device flag.

    python -m atlasvae_torch.cli.etl --sample_type topo-dijet --tag 1 \
        --input_path ntuples/ --output_path h5/
    python -m atlasvae_torch.cli.etl --merging ON --input_path h5/
"""

import sys
from argparse import ArgumentParser


def build_parser():
    parser = ArgumentParser()
    parser.add_argument("--sample_type", default="topo-dijet",
                        choices=["topo-dijet", "topo-ttbar", "UFO-dijet",
                                 "UFO-ttbar", "BSM"])
    parser.add_argument("--n_constituents", default="unknown")
    parser.add_argument("--merging", default="OFF")
    # list-valued as in the reference (ref tools/root2h5.py:15 nargs='+');
    # only the first tag selects the DSID block (ref :100 args.tag[0])
    parser.add_argument("--tag", "--names-list", nargs="+", default=[0])
    # uproot array-library knob (ref :14, root2h5.sh:12-13); accepted for
    # drop-in command lines, irrelevant here (reading is vectorized
    # regardless of backend)
    parser.add_argument("--library", default="np", choices=["np", "ak"])
    parser.add_argument("--input_path", default=".")
    parser.add_argument("--output_path", default=".")
    parser.add_argument("--tree", default="nominal")
    parser.add_argument("--n_workers", type=int, default=None,
                        help="file-read thread pool size (default: "
                             "min(16, cpus); ref tools/root_utils.py:20-23 "
                             "mp.Pool analog)")
    parser.add_argument("--extra_branches", nargs="+", default=[],
                        help="extra scalar branches from the full ntuple "
                             "catalog (atlasvae_torch.etl.branches) to pass through")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ..etl.merging import file_processing
    from ..etl.root2h5 import convert

    n_const = args.n_constituents
    if n_const != "unknown":
        n_const = int(n_const)
    if args.merging.upper() == "ON":
        out = file_processing(args.input_path, n_const)
        print("Merged into:", out)
        return 0
    out = convert(args.input_path, args.output_path, args.sample_type,
                  n_const, int(args.tag[0]), tree=args.tree,
                  extra_branches=args.extra_branches,
                  n_workers=args.n_workers)
    print("Converted to:", out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
