"""What one flipped ReLU tie can move in K3's gradients, for the checks that
hold K3 (``ops/fused_vae.py::stack_backward``) against its plain version at
a stack whose hidden ReLU inputs can sit at 0 to float32 rounding (a
2048-wide input).  Used by tests/test_torch_cuda_kernels.py and
chip_smoke.py.  Imports neither JAX nor the JAX package.

A tie is a hidden unit's ReLU input z with |z| at most TIE_REL times the sum
of its terms' magnitudes (in float64): about 8 float32 roundings of that
sum; two float32 orders of the same sum part by less.  One side's sum may
land above 0 and the other's below, so a unit that passes g on one side
blocks it on the other.

``single_flip_allowance`` gives, for each element of dW, db and dx, the
most that any ONE tie's flip moves it: the largest single flip, not the sum
over the ties, so it does not grow with the number of ties and a check that
adds it to its bar lets through no more than one flip explains at each
element."""

import torch

TIE_REL = 2.0 ** -21


def single_flip_allowance(x, hidden, heads, head_grads, want_dx):
    """(dws, dbs, dx, n_ties): float64 tensors of the shapes of
    ``stack_backward_plain``'s leaves (dx None without want_dx), each element
    the largest |change| one flipped tie makes to it, 0 where no tie reaches,
    and the number of ties.

    In float64: the forward finds the ties; for each tie, its row's head
    gradients are carried down with that one unit's mask flipped.  The
    change of the row's masked gradient dg at each layer below moves dW by
    |a| |dg| (a the row's input to that layer), db by |dg| and dx by the
    row's |dg W^T|; the tie's own activation (0 on one side, |z| on the
    other) moves the row of the layer above it by |z| |g|."""
    d64 = torch.float64
    xs = x.to(d64)
    hid = [(w.to(d64), b.to(d64)) for w, b in hidden]
    hds = [(w.to(d64), b.to(d64)) for w, b in heads]
    gs = [g.to(d64) for g in head_grads]
    acts, ties, zs = [xs], [], []
    for w, b in hid:
        z = acts[-1] @ w + b
        ties.append(z.abs() <= TIE_REL * (acts[-1].abs() @ w.abs() + b.abs()))
        zs.append(z)
        acts.append(torch.relu(z))
    n_hidden = len(hid)
    dws = [torch.zeros_like(w) for w, _ in hid + hds]
    dbs = [torch.zeros_like(b) for _, b in hid + hds]
    dx = torch.zeros_like(xs) if want_dx else None
    found = [t.nonzero() for t in ties]   # (row, unit) of each tie, layer by layer
    n_ties = sum(len(f) for f in found)
    if n_ties == 0:
        return dws, dbs, dx, 0
    g_top = sum(g @ w.T for g, (w, _) in zip(gs, hds))     # dL/da_L, unmasked

    def descend(rows, flip_layer=None, flip_unit=None):
        """The masked gradients dL/dz_l (l = n_hidden .. 1, then dx's) of
        ``rows``, with unit flip_unit[i] of layer flip_layer flipped in row i."""
        g, out = g_top[rows], [None] * (n_hidden + 1)
        for l in range(n_hidden - 1, -1, -1):
            mask = (acts[l + 1][rows] > 0).to(d64)
            if flip_layer == l:
                at = torch.arange(len(rows), device=mask.device)
                mask[at, flip_unit] = 1.0 - mask[at, flip_unit]
            g = g * mask
            out[l + 1] = g
            g = g @ hid[l][0].T
        out[0] = g
        return out

    for l, f in enumerate(found):
        if not len(f):
            continue
        rows, units = f[:, 0], f[:, 1]
        base, moved = descend(rows), descend(rows, l, units)
        for k in range(n_hidden + 1):
            delta = (moved[k] - base[k]).abs()      # one tie a row of delta
            if k == 0:
                for t in range(len(rows)) if want_dx else ():
                    r = int(rows[t])
                    torch.maximum(dx[r], delta[t], out=dx[r])
                continue
            inputs = acts[k - 1][rows].abs()
            for t in range(len(rows)):
                torch.maximum(dws[k - 1], torch.outer(inputs[t], delta[t]), out=dws[k - 1])
            torch.maximum(dbs[k - 1], delta.amax(dim=0), out=dbs[k - 1])
        # the tie's own activation moves row `unit` of the layer above it
        above = [base[l + 2]] if l + 1 < n_hidden else [g[rows] for g in gs]
        leaves = [l + 1] if l + 1 < n_hidden else range(n_hidden, n_hidden + len(gs))
        tie_z = zs[l][rows, units].abs()
        for leaf, g in zip(leaves, above):
            for t in range(len(rows)):
                u = int(units[t])
                torch.maximum(dws[leaf][u], tie_z[t] * g[t].abs(), out=dws[leaf][u])
    return dws, dbs, dx, n_ties


def largest_over_bar(allow, bars):
    """max over the leaves of max(allowance) / bar: how far beyond its bar
    the allowance lets a leaf go."""
    return max((float(a.max()) / bar if bar > 0 else 0.0) for a, bar in zip(allow, bars))
