"""Stack forward with linear heads: hand-written CUDA kernel K2 and its plain twin.

Counterpart of the forward half of ``atlasvae/ops/fused_vae.py``.
``stack_forward`` runs a ReLU hidden stack and then ``n_heads`` linear
heads on the last hidden activation in one launch of
``csrc/fused_vae.cu``; ``fused_encoder`` is the VAE encoder (heads mean and
logvar) on it.  On a CPU tensor both run ``stack_forward_plain``.  Forward
only: the backward kernel (``_stack_bwd_kernel``) and its
``autograd.Function`` come with the training slice.
"""

import ctypes

import torch

from . import cuda_build

# Kernel launches made by stack_forward (reset and read by chip_smoke.py).
launches = 0


def stack_forward_plain(x, hidden, heads):
    """Plain PyTorch version of the kernel: ``hidden`` and ``heads`` are
    lists of (w, b) with w shaped (in, out).  Returns a tuple of head
    outputs."""
    h = x
    for w, b in hidden:
        h = torch.relu(h @ w + b)
    return tuple(h @ w + b for w, b in heads)


def _entry():
    fn = cuda_build.load("fused_vae").atlasvae_stack_forward
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def stack_forward(x, hidden, heads):
    """Hidden ReLU stack + linear heads in one kernel on a CUDA tensor; the
    plain version on a CPU tensor."""
    global launches
    if x.device.type == "cpu":
        return stack_forward_plain(x, hidden, heads)
    if x.device.type != "cuda":
        raise ValueError(f"stack_forward: unsupported device {x.device}")
    cuda_build.check_stack(x, hidden, heads, "stack_forward")
    outs = [torch.empty((x.shape[0], w.shape[1]), device=x.device, dtype=torch.float32)
            for w, _ in heads]
    dims = cuda_build.int_array([x.shape[1]] + [w.shape[1] for w, _ in hidden])
    ws = cuda_build.pointer_array([w for w, _ in hidden])
    bs = cuda_build.pointer_array([b for _, b in hidden])
    head_dims = cuda_build.int_array([w.shape[1] for w, _ in heads])
    hws = cuda_build.pointer_array([w for w, _ in heads])
    hbs = cuda_build.pointer_array([b for _, b in heads])
    out_ptrs = cuda_build.pointer_array(outs)
    fn = _entry()
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), x.shape[0], len(hidden), ctypes.addressof(dims),
                 ctypes.addressof(ws), ctypes.addressof(bs), len(heads),
                 ctypes.addressof(head_dims), ctypes.addressof(hws), ctypes.addressof(hbs),
                 ctypes.addressof(out_ptrs), torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "stack_forward kernel")
    launches += 1
    return tuple(outs)


def _encoder_pairs(enc_params):
    hidden = [(l["w"], l["b"]) for l in enc_params["hidden"]]
    heads = [(enc_params["mean"]["w"], enc_params["mean"]["b"]),
             (enc_params["logvar"]["w"], enc_params["logvar"]["b"])]
    return hidden, heads


def fused_encoder(enc_params, x):
    """Encoder hidden stack + (mean, logvar) heads in one kernel."""
    return stack_forward(x, *_encoder_pairs(enc_params))

