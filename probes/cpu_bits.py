#!/usr/bin/env python3
"""Probe whether the port's plain float32 path on this machine's CPU gives
the same bits call after call (ROADMAP Queue 3: the CPU side of
tests/test_torch_cuda_kernels.py::test_vae_apply_on_cuda_matches_cpu).

    python3 probes/cpu_bits.py [--calls 20]

Builds that test's inputs (seed 3: a canonical VAE at random init, 777 rows,
injected noise) on the CPU and runs ``vae_apply`` on them ``--calls`` times
in one process under each setting: the process's default threads, 1 thread,
8 threads, and each of those with ``torch.backends.mkldnn.enabled = False``.
For each setting prints how many calls gave the first call's bits, how many
distinct results there were, and each output's largest gap to a float64 run
of the same model.  Needs no card.  Prints one JSON object as its last line.
"""

import argparse
import hashlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def precision_state():
    """Every process-wide setting that may move a float32 product on the CPU
    (the fp32_precision knobs where this torch has them)."""
    import torch
    state = {"threads": torch.get_num_threads(), "mkldnn": torch.backends.mkldnn.enabled,
             "float32_matmul_precision": torch.get_float32_matmul_precision(),
             "deterministic": torch.are_deterministic_algorithms_enabled()}
    for name, obj in (("fp32_precision", torch.backends),
                      ("mkldnn.fp32_precision", torch.backends.mkldnn),
                      ("mkldnn.matmul.fp32_precision", getattr(torch.backends.mkldnn, "matmul", None)),
                      ("cuda.matmul.fp32_precision", torch.backends.cuda.matmul)):
        if obj is not None and hasattr(obj, "fp32_precision"):
            state[name] = str(obj.fp32_precision)
    return state


def measure(calls):
    """The test's CPU side ``calls`` times under each setting, as a report."""
    import torch
    from atlasvae_torch.models import VAEConfig, init_vae, vae_apply
    from atlasvae_torch.train.checkpoint import tree_map

    gen = torch.Generator().manual_seed(3)
    params = init_vae(gen, VAEConfig(), device="cpu")
    x = torch.randn((777, 12), generator=gen)
    noise = torch.randn((777, 10), generator=gen)
    f64 = vae_apply(tree_map(lambda t: t.double(), params), x.double(), noise=noise.double())
    default_threads = torch.get_num_threads()
    report = {"torch": torch.__version__, "cpu_capability": torch.backends.cpu.get_cpu_capability(),
              "default_threads": default_threads, "state": precision_state(), "settings": []}
    for threads in (default_threads, 1, 8):
        for mkldnn in (True, False):
            torch.set_num_threads(threads)
            torch.backends.mkldnn.enabled = mkldnn
            digests, gaps = [], []
            for _ in range(calls):
                out = vae_apply(params, x, noise=noise)
                digests.append(hashlib.sha1(b"".join(t.numpy().tobytes() for t in out)).hexdigest())
                gaps.append(max(float((o.double() - r).abs().max()) for o, r in zip(out, f64)))
            row = dict(threads=threads, mkldnn=mkldnn, calls=calls,
                       same_as_first=sum(d == digests[0] for d in digests),
                       distinct=len(set(digests)), gap_to_f64_max=max(gaps),
                       gap_to_f64_min=min(gaps))
            report["settings"].append(row)
            print("[cpu_bits] " + json.dumps(row), flush=True)
    torch.set_num_threads(default_threads)
    torch.backends.mkldnn.enabled = True
    return report


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=20)
    args = ap.parse_args()
    print(json.dumps(measure(args.calls)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
