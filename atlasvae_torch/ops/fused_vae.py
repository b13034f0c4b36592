"""Dense stack with linear heads: hand-written CUDA kernels K2 (forward) and
K3 (backward), their plain twins, and the autograd Functions around them.

Counterpart of ``atlasvae/ops/fused_vae.py``.  ``stack_forward`` runs a ReLU
hidden stack and then ``n_heads`` linear heads on the last hidden
activation in one launch of ``csrc/fused_vae.cu``; ``stack_backward``
recomputes that forward per tile of rows, backpropagates head gradients
through the heads and the ReLU masks and sums dW/db over all rows in
``csrc/fused_vae_bwd.cu`` (plus one launch that reduces its per-CTA
partial sums in a fixed order).  ``FusedEncoder`` and ``FusedDecoder`` are
the ``torch.autograd.Function`` counterparts of the JAX custom VJPs: K2
forward, K3 backward; the encoder returns a zero gradient for its input
(data in every training graph), the decoder returns dz.  On a CPU tensor
every wrapper runs its plain version.
"""

import ctypes
import functools

import torch

from . import cuda_build

# Kernel launches made by stack_forward (K2) and stack_backward (K3); reset
# and read by chip_smoke.py.
launches = 0
backward_launches = 0


def stack_forward_plain(x, hidden, heads):
    """Plain PyTorch version of the kernel: ``hidden`` and ``heads`` are
    lists of (w, b) with w shaped (in, out).  Returns a tuple of head
    outputs."""
    h = x
    for w, b in hidden:
        h = torch.relu(h @ w + b)
    return tuple(h @ w + b for w, b in heads)


@functools.cache
def _forward_entry():
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
    fn = _forward_entry()
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), x.shape[0], len(hidden), ctypes.addressof(dims),
                 ctypes.addressof(ws), ctypes.addressof(bs), len(heads),
                 ctypes.addressof(head_dims), ctypes.addressof(hws), ctypes.addressof(hbs),
                 ctypes.addressof(out_ptrs), torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "stack_forward kernel")
    launches += 1
    return tuple(outs)


def stack_backward_plain(x, hidden, heads, head_grads, want_dx):
    """Plain PyTorch version of K3, the counterpart of ``_stack_bwd``:
    recompute the forward, then dW_head = h_last^T g and db = sum g per
    head, g_hidden = sum_k g_k W_k^T, and per hidden layer (last first)
    mask by act > 0, dW = a^T g, db = sum g, g = g W^T.  Returns
    (dws, dbs, dx) with the hidden layers first, then the heads; dx is None
    unless ``want_dx``."""
    acts = [x]
    for w, b in hidden:
        acts.append(torch.relu(acts[-1] @ w + b))
    n_hidden = len(hidden)
    dws = [None] * (n_hidden + len(heads))
    dbs = [None] * (n_hidden + len(heads))
    g_hidden = torch.zeros_like(acts[-1])
    for k, ((w, _), g) in enumerate(zip(heads, head_grads)):
        dws[n_hidden + k] = acts[-1].T @ g
        dbs[n_hidden + k] = g.sum(dim=0)
        g_hidden = g_hidden + g @ w.T
    g = g_hidden
    for i in range(n_hidden - 1, -1, -1):
        g = g * (acts[i + 1] > 0)
        dws[i] = acts[i].T @ g
        dbs[i] = g.sum(dim=0)
        if i > 0 or want_dx:
            g = g @ hidden[i][0].T
    return dws, dbs, (g if want_dx else None)


@functools.cache
def _backward_entries():
    lib = cuda_build.load("fused_vae_bwd")
    parts = lib.atlasvae_stack_backward_parts
    parts.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_void_p]
    parts.restype = ctypes.c_int
    fn = lib.atlasvae_stack_backward
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return parts, fn


@functools.cache
def _n_parts(batch, dims, head_dims):
    """How many per-CTA partial slices K3 writes for this batch and stack."""
    n_parts = _backward_entries()[0](batch, len(dims) - 1, cuda_build.int_array(dims),
                                     len(head_dims), cuda_build.int_array(head_dims))
    if n_parts < 0:
        raise ValueError("stack_backward: the stack's tile does not fit a CTA's shared "
                         "memory (too wide)")
    return n_parts


def stack_backward(x, hidden, heads, head_grads, want_dx):
    """K3 on a CUDA tensor (the plain version on a CPU tensor): the
    gradients of ``stack_forward(x, hidden, heads)`` for the head-output
    gradients ``head_grads``, as (dws, dbs, dx)."""
    global backward_launches
    if x.device.type == "cpu":
        return stack_backward_plain(x, hidden, heads, head_grads, want_dx)
    if x.device.type != "cuda":
        raise ValueError(f"stack_backward: unsupported device {x.device}")
    cuda_build.check_stack(x, hidden, heads, "stack_backward")
    batch = x.shape[0]
    if len(head_grads) != len(heads):
        raise ValueError(f"stack_backward: {len(heads)} heads, {len(head_grads)} gradients")
    for g, (w, _) in zip(head_grads, heads):
        if (g.device != x.device or g.dtype != torch.float32 or not g.is_contiguous()
                or tuple(g.shape) != (batch, w.shape[1])):
            raise ValueError(f"stack_backward: a head gradient must be contiguous float32 "
                             f"({batch}, {w.shape[1]}) on {x.device}, got {g.dtype} "
                             f"{tuple(g.shape)} on {g.device}")
    if batch == 0:
        raise ValueError("stack_backward: empty batch")
    shapes = [tuple(w.shape) for w, _ in list(hidden) + list(heads)]
    sizes = [n for k, m in shapes for n in (k * m, m)]
    grads = torch.empty(sum(sizes), device=x.device, dtype=torch.float32)
    dx = torch.empty_like(x) if want_dx else None
    dims = (x.shape[1],) + tuple(w.shape[1] for w, _ in hidden)
    head_dims = tuple(w.shape[1] for w, _ in heads)
    n_parts = _n_parts(batch, dims, head_dims)
    dims, head_dims = cuda_build.int_array(dims), cuda_build.int_array(head_dims)
    partial = torch.empty((n_parts, grads.numel()), device=x.device, dtype=torch.float32)
    ws = cuda_build.pointer_array([w for w, _ in hidden])
    bs = cuda_build.pointer_array([b for _, b in hidden])
    hws = cuda_build.pointer_array([w for w, _ in heads])
    gs = cuda_build.pointer_array(head_grads)
    with torch.cuda.device(x.device):
        err = _backward_entries()[1](
            x.data_ptr(), batch, len(hidden), ctypes.addressof(dims), ctypes.addressof(ws),
            ctypes.addressof(bs), len(heads), ctypes.addressof(head_dims),
            ctypes.addressof(hws), ctypes.addressof(gs), dx.data_ptr() if want_dx else None,
            partial.data_ptr(), n_parts, grads.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "stack_backward kernel")
    backward_launches += 1
    flat = grads.split(sizes)
    dws = [flat[2 * i].view(shape) for i, shape in enumerate(shapes)]
    dbs = [flat[2 * i + 1] for i in range(len(shapes))]
    return dws, dbs, dx


def _pairs(leaves, n_heads):
    """Flat [w, b, w, b, ...] -> (hidden pairs, head pairs)."""
    pairs = list(zip(leaves[0::2], leaves[1::2]))
    return pairs[:-n_heads], pairs[-n_heads:]


def _interleave(dws, dbs):
    return [t for pair in zip(dws, dbs) for t in pair]


class FusedEncoder(torch.autograd.Function):
    """Encoder hidden stack + (mean, logvar) heads: K2 forward, K3
    backward.  The input gets a zero gradient, as the JAX custom VJP
    gives (``atlasvae/ops/fused_vae.py:272``)."""

    @staticmethod
    def forward(ctx, x, *leaves):
        ctx.save_for_backward(x, *leaves)
        return stack_forward(x, *_pairs(leaves, 2))

    @staticmethod
    def backward(ctx, *head_grads):
        x, *leaves = ctx.saved_tensors
        dws, dbs, _ = stack_backward(x, *_pairs(leaves, 2),
                                     [g.contiguous() for g in head_grads], want_dx=False)
        return (torch.zeros_like(x), *_interleave(dws, dbs))


class FusedDecoder(torch.autograd.Function):
    """Decoder hidden stack + linear output head: K2 forward with one head,
    K3 backward with dz."""

    @staticmethod
    def forward(ctx, z, *leaves):
        ctx.save_for_backward(z, *leaves)
        return stack_forward(z, *_pairs(leaves, 1))[0]

    @staticmethod
    def backward(ctx, g):
        z, *leaves = ctx.saved_tensors
        dws, dbs, dz = stack_backward(z, *_pairs(leaves, 1), [g.contiguous()], want_dx=True)
        return (dz, *_interleave(dws, dbs))


def _leaves(layers):
    return [t for layer in layers for t in (layer["w"], layer["b"])]


def fused_encoder(enc_params, x):
    """Encoder hidden stack + (mean, logvar) heads, differentiable."""
    return FusedEncoder.apply(x, *_leaves(enc_params["hidden"] + [enc_params["mean"],
                                                                  enc_params["logvar"]]))


def fused_decoder(dec_params, z):
    """Decoder hidden stack + linear output head, differentiable."""
    return FusedDecoder.apply(z, *_leaves(dec_params["hidden"] + [dec_params["out"]]))
