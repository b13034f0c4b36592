"""Batch anomaly-scoring entry point (serving path) on PyTorch/CUDA.

Counterpart of ``atlasvae/cli/score.py``: stream an HDF5 sample through a
trained OE-VAE (or, with ``--model_type aae``, an OE-AAE) in chunks, apply
the HLV (and constituent) scalers, and write ``score_<metric>``, ``m``,
``pt`` and ``weights`` to an output HDF5.  The VAE runs its forward
(encoder through the stack-forward kernel, decoder through the fused
dense-stack kernel on CUDA) and the requested per-jet metrics (EMD through
the Sinkhorn kernel on CUDA, in constituents mode); the AAE writes its three
discriminants, ``score_Autoencoder``, ``score_Discriminator`` and
``score_Auto+Disc`` (``eval/aae_eval.py::get_data``, unmapped).
Runs on ``--device cuda`` unless asked for the CPU.  ``--n_devices N``
above 1 (0: every visible card; 1 under ``--device cpu``) scores on N ranks
(``parallel/multihost.py::launch``): each predicts the chunk and the
EMD/KSD jet axes are split over the ranks; rank 0 alone writes.

    python -m atlasvae_torch.cli.score --data QCD-Geneva --model_in model.npz \\
        --HLV_scaler_in HLV_RobustScaler.pkl --metrics MAE Latent --output scores.h5
    python -m atlasvae_torch.cli.score --data QCD-Geneva --model_in model.npz \\
        --constituents ON --HLVs OFF --n_const 100 --FC_layers 256 128 64 32 \\
        --const_scaler_in const_QuantileTransformer.pkl \\
        --metrics MAE Latent KLD JSD EMD KSD --output scores.h5
    python -m atlasvae_torch.cli.score --data QCD-Geneva --model_in AAE.npz \\
        --model_type aae --HLV_scaler_in HLV_RobustScaler.pkl --output scores.h5
"""

import contextlib
import sys
import time
from argparse import ArgumentParser

import numpy as np

from ..parallel.mesh import is_writer
from ..parallel.multihost import cli_ranks, launch


def build_parser():
    parser = ArgumentParser()
    parser.add_argument("--data", required=True,
                        help="logical sample name or HDF5 path")
    parser.add_argument("--model_in", required=True)
    parser.add_argument("--model_type", default="vae", choices=["vae", "aae"])
    parser.add_argument("--FC_layers", default=[80, 40, 20, 10], type=int, nargs="+")
    parser.add_argument("--layers_sizes", default=[100, 100, 100], type=int, nargs="+")
    parser.add_argument("--n_jets", default=1e9, type=float)
    parser.add_argument("--n_const", default=20, type=int)
    parser.add_argument("--n_dims", default=3, type=int)
    parser.add_argument("--constituents", default="OFF")
    parser.add_argument("--HLVs", default="ON")
    parser.add_argument("--HLV_scaler_in", default="")
    parser.add_argument("--const_scaler_in", default="")
    parser.add_argument("--metrics", default=["MAE", "Latent"], nargs="+")
    parser.add_argument("--n_iter", default=1, type=int)
    parser.add_argument("--chunk", default=1_000_000, type=float)
    parser.add_argument("--output", default="scores.h5")
    parser.add_argument("--n_devices", default=0, type=int,
                        help="ranks the EMD/KSD jet axes are split over, one a card "
                             "(0 = all cards; 1 under --device cpu)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to score on (default cuda)")
    return parser


def main(argv=None):
    import torch
    from .. import resolve_device
    from ..data import load_data, apply_scaler, hdf5, HLV_LIST
    from ..data.scalers import Scaler
    from ..models import VAEConfig, init_vae, vae_apply, AAEConfig, init_aae
    from ..train.checkpoint import load_pytree
    from ..train.loop import features
    from ..eval import compute_metric_bank

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    n_ranks = cli_ranks(args.n_devices, device)
    placed = launch(main, (list(sys.argv[1:] if argv is None else argv),), n_ranks, device)
    if placed is None:
        return 0
    mesh, device = placed
    on = lambda v: v.upper() == "ON" if isinstance(v, str) else bool(v)
    hlv_list = list(HLV_LIST)
    input_dim = (args.n_dims * args.n_const) * on(args.constituents) + \
        len(hlv_list) * on(args.HLVs)

    if args.model_type == "vae":
        template = init_vae(torch.Generator().manual_seed(0),
                            VAEConfig(fc_layers=tuple(args.FC_layers), input_dim=input_dim),
                            device=device)
    else:
        template = init_aae(torch.Generator().manual_seed(0),
                            AAEConfig(input_dim=input_dim, ae_layers=tuple(args.layers_sizes)),
                            device=device)
    params = load_pytree(args.model_in, template)
    hlv_scaler = Scaler.load(args.HLV_scaler_in) if args.HLV_scaler_in else None
    const_scaler = Scaler.load(args.const_scaler_in) if args.const_scaler_in else None

    start = time.time()
    total = 0
    chunk = int(args.chunk)
    n_jets = int(args.n_jets)
    with torch.inference_mode(), (hdf5.File(args.output, "w") if is_writer(mesh)
                                  else contextlib.nullcontext()) as out:
        dsets = {}
        offset = 0
        while offset < n_jets:
            hi = min(offset + chunk, n_jets)
            sample = load_data(args.data, (offset, hi), (),
                               args.n_const, args.n_dims, args.constituents,
                               args.HLVs, hlv_list, verbose=False, device=device)
            n = len(sample["m"])
            if n == 0:
                break
            for key, scaler in (("HLVs", hlv_scaler), ("constituents", const_scaler)):
                if key in sample:
                    sample[key] = apply_scaler(torch.as_tensor(sample[key], device=device),
                                               args.n_dims, scaler, verbose=False)
            x_true = features(sample).contiguous()
            if args.model_type == "vae":
                # one generator per iteration, seeded with its index, as the
                # JAX entry point draws with PRNGKey(i) for every chunk
                preds = torch.stack(
                    [vae_apply(params, x_true, torch.Generator(device).manual_seed(i))[0]
                     for i in range(args.n_iter)], dim=-1)
                x_pred = preds.mean(dim=-1)
                scores = compute_metric_bank(x_true, x_pred, params, tuple(args.metrics),
                                             normal_losses=False, device=device, mesh=mesh)
            else:
                from ..eval.aae_eval import get_data
                scores = get_data(params, sample, np.ones(n, int), x_true.cpu().numpy(),
                                  normal_loss="OFF", deco="OFF")
            record = {**{f"score_{k}": v for k, v in scores.items()},
                      "m": sample["m"], "pt": sample["pt"],
                      "weights": sample["weights"]}
            for key, val in record.items():
                if out is None:         # ranks above 0 write nothing
                    break
                val = np.asarray(val, np.float32)
                if key not in dsets:
                    dsets[key] = out.create_dataset(
                        key, shape=(0,), maxshape=(None,), dtype=np.float32,
                        chunks=(min(chunk, 1 << 16),))
                ds = dsets[key]
                ds.resize((total + n,))
                ds[total:total + n] = val
            total += n
            offset += chunk
            if n < chunk:
                break
    rate = total / max(time.time() - start, 1e-9)
    print(f"Scored {total} jets -> {args.output} ({rate:,.0f} jets/s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
