"""Dense stack with linear heads: hand-written CUDA kernels K2 (forward) and
K3 (backward), their plain twins, and the autograd Functions around them.

Counterpart of ``atlasvae/ops/fused_vae.py``.  ``stack_forward`` runs a ReLU
hidden stack and then ``n_heads`` linear heads on the last hidden
activation in one launch of ``csrc/fused_vae.cu``.  ``stack_backward``
backpropagates head gradients through the heads and the ReLU masks and sums
dW/db over all rows (``csrc/fused_vae_bwd.cu``), by one of two routes that
``backward_plan`` picks from the stack's shape: the fused body keeps the
whole stack's weights in shared memory and recomputes the forward per
128-row tile, one CTA an SM, and adds its CTAs' partial sums in a fixed
order inside the same launch (stacks no wider than 128 whose weights and
tile fit); the layer-wise route runs one persistent launch per product over
the whole batch on K1/K2's ``wgmma`` mainloop (3xTF32), with the hidden
activations in a device scratch buffer, then one launch that adds the
per-split partial sums in a fixed order (every other stack, constituents
mode among them).  ``FusedEncoder``
and ``FusedDecoder`` are the ``torch.autograd.Function`` counterparts of the
JAX custom VJPs: K2 forward, K3 backward; the encoder returns a zero
gradient for its input (data in every training graph), the decoder returns
dz.  On a CPU tensor every wrapper runs its plain version.
"""

import ctypes
import dataclasses
import functools

import torch

from . import cuda_build

# Kernel launches made by stack_forward (K2: its fused body, and its
# layer-wise route) and stack_backward (K3: the same two); reset and read by
# chip_smoke.py.
launches = 0
layered_launches = 0
backward_launches = 0
layered_backward_launches = 0
# K3's layer-wise recompute alone (stack_recompute), a measuring aid
recompute_launches = 0


def stack_forward_plain(x, hidden, heads):
    """Plain PyTorch version of the kernel: ``hidden`` and ``heads`` are
    lists of (w, b) with w shaped (in, out).  Returns a tuple of head
    outputs."""
    h = x
    for w, b in hidden:
        h = torch.relu(h @ w + b)
    return tuple(h @ w + b for w, b in heads)


# K1 and K2's routes.  A stack whose widths are all at most FUSED_MAX_WIDTH,
# of at most FUSED_MAX_HIDDEN hidden layers, whose weights fit one CTA of the
# fused body (forward_smem) runs as one launch of it (csrc/dense_stack.cuh),
# every activation of a warp's rows in registers.  Any other stack is cut into
# segments (forward_plan), launched in order by one C call
# (csrc/stack_layers.cuh): a run of narrow layers stays on the fused body, one
# launch for as many layers as fit a CTA (at most FUSED_MAX_HIDDEN hidden
# layers and the layer after them), and each wide layer is one row product
# over the whole batch.  The shape alone decides.
FUSED_SEGMENT, ROW_SEGMENT = 0, 1
FUSED_MAX_WIDTH = 128
FUSED_MAX_HIDDEN = 8            # kMaxHidden: the hidden layers one fused launch takes
# The fused body's CTA (csrc/dense_stack.cuh): 8 warps, or 4 where 8 warps'
# buffers do not fit, each warp FUSED_BLOCK_ROWS rows (an m16 tile) at a time.
FUSED_WARPS = (8, 4)            # kStackWarps, then half
FUSED_BLOCK_ROWS = 16           # kBlockRows
# A row segment's tile (csrc/gemm_wgmma.cuh): ROW_TILE_ROWS rows (two
# warpgroups of 64) x FORWARD_TILE_COLS[tile] columns, k in stages of
# ROW_STAGE_K, walked by one persistent CTA on each of the card's SMs.
# _forward_tile picks the column tile from the shape by a cost in clocks of
# an SM: whole rounds of tiles over CARD_SMS CTAs, each tile ROW_TILE_CLOCKS
# (its epilogue, the round's tail) plus a stage's 12 wgmma m64nNk8 of two
# warpgroups (N / 2 clocks each at TF32's rate: 12 N a stage) and
# ROW_STAGE_CLOCKS beside them.  The constants are a model; on an H100 the
# other tile took 5-27% longer at 7 of the 8 layer-wise shapes
# probes/stack_forward.py times at 10,000 and 65,536 rows, and 2% less at
# emd_slice's decoder (PERF.md, Findings).
FORWARD_TILE_COLS = (128, 64)
ROW_TILE_ROWS = 128
ROW_STAGE_K = 32
CARD_SMS = 132                  # an H100 SXM's SMs
ROW_TILE_CLOCKS = 3000
ROW_STAGE_CLOCKS = 200


@functools.cache
def forward_smem(dims, head_dims):
    """The bytes of shared memory a CTA of the fused body takes for a stack
    of input/hidden widths ``dims`` and head widths ``head_dims``, or None
    where it does not take it: each layer's B fragments (per k8 step and n8
    tile 128 floats: hi and lo of two weights a lane) and bias (8 floats an
    n8 tile), then each warp's x buffer (16 rows of dims[0]) and stage (16
    rows of the heads), which the staged copies of every leaf's W (each
    rounded to 4 floats) overlay at the CTA's start; 8 warps, else 4.  The
    mirror of plan_dense_stack."""
    total = sum(head_dims)
    widths = tuple(dims) + (total,)
    if min(widths) < 1 or max(widths) > FUSED_MAX_WIDTH or len(dims) - 1 > FUSED_MAX_HIDDEN:
        return None
    floats = sum(128 * _ceil(k, 8) * _ceil(n, 8) + 8 * _ceil(n, 8)
                 for k, n in zip(widths, widths[1:]))
    raw = sum(_round4(k * n) for k, n in zip(dims, dims[1:])) + \
        sum(_round4(dims[-1] * n) for n in head_dims)
    for warps in FUSED_WARPS:
        smem = 4 * (floats + max(warps * FUSED_BLOCK_ROWS * (dims[0] + total), raw))
        if smem <= MAX_SMEM:
            return smem
    return None


@dataclasses.dataclass(frozen=True)
class Segment:
    """Layers [first, last) of a stack, counted with the heads as layer
    len(dims) - 1 of width sum(head_dims).

    kind  FUSED_SEGMENT: one launch of the fused body; a segment that ends
          before the heads writes its last layer, with ReLU, as its one head.
          ROW_SEGMENT: one layer, one row product over the batch, bias and
          ReLU (or, for the heads, the last layer's activation) in its
          epilogue; the heads' columns are one product, each head written to
          its own output.
    tile  ROW_SEGMENT: the FORWARD_TILE_COLS index of its column tile.
    out   the scratch buffer (0 or 1) it writes, or -1: the stack's outputs."""
    kind: int
    first: int
    last: int
    tile: int = 0
    out: int = -1

    def ints(self):
        return (self.kind, self.first, self.last, self.tile, self.out)


@dataclasses.dataclass(frozen=True)
class ForwardPlan:
    """How K1/K2 run one stack at one batch size: its segments in order, the
    floats of the two scratch buffers the segments pass activations in (each
    a multiple of 4, so that the next starts 16-byte aligned), and those of
    the row segments' split weights (split_floats each, in segment order),
    which follow them in one allocation."""
    segments: tuple
    buf_floats: tuple = (0, 0)
    wsplit_floats: int = 0

    @property
    def route(self):
        one = len(self.segments) == 1 and self.segments[0].kind == FUSED_SEGMENT
        return "fused" if one else "layers"

    @property
    def scratch_bytes(self):
        return 4 * (sum(self.buf_floats) + self.wsplit_floats)


def _forward_tile(batch, k, n):
    """The column tile (its FORWARD_TILE_COLS index) of a row product of
    ``batch`` rows, ``k`` deep, ``n`` columns: the least cost in clocks of an
    SM, whole rounds of tiles times a tile's (see ROW_TILE_CLOCKS); on a tie
    the wider."""
    stages = _ceil(k, ROW_STAGE_K)

    def cost(t):
        cols = FORWARD_TILE_COLS[t]
        ctas = _ceil(batch, ROW_TILE_ROWS) * _ceil(n, cols)
        return _ceil(ctas, CARD_SMS) * (ROW_TILE_CLOCKS + stages * (12 * cols + ROW_STAGE_CLOCKS)), t
    return min(range(len(FORWARD_TILE_COLS)), key=cost)


def split_floats(k, n, tile):
    """Floats of a row product's split weights (csrc/gemm_wgmma.cuh,
    split_weights_kernel): W^T's hi and lo TF32 words, n rounded up to whole
    column tiles and k to whole stages."""
    cols = FORWARD_TILE_COLS[tile]
    return 2 * _ceil(n, cols) * cols * _ceil(k, ROW_STAGE_K) * ROW_STAGE_K


@functools.cache
def forward_plan(batch, dims, head_dims):
    """K1/K2's segments and scratch for a stack of input/hidden widths
    ``dims`` and head widths ``head_dims`` at ``batch`` rows."""
    widths = tuple(dims) + (sum(head_dims),)
    narrow = [max(widths[l], widths[l + 1]) <= FUSED_MAX_WIDTH for l in range(len(dims))]
    spans, first = [], 0
    for l in range(1, len(dims) + 1):
        if l == len(dims) or not (narrow[l] and narrow[l - 1]):
            spans.append((first, l))
            first = l
    # a narrow run is cut into pieces that one fused launch takes: as many
    # layers as fit (forward_smem; any one layer does), at most
    # FUSED_MAX_HIDDEN hidden layers and their head
    pieces = []
    for first, last in spans:
        a = first
        while a < last:
            b = a + 1
            while narrow[a] and b < last and forward_smem(
                    widths[a:b + 1], tuple(head_dims) if b + 1 == len(dims) else (widths[b + 1],)):
                b += 1
            pieces.append((a, b))
            a = b
    segments, bufs, wsplit = [], [0, 0], 0
    for i, (first, last) in enumerate(pieces):
        final = i == len(pieces) - 1
        out = -1 if final else i % 2
        if not final:
            bufs[out] = max(bufs[out], _ceil(batch * widths[last], 4) * 4)
        if narrow[first]:
            segments.append(Segment(FUSED_SEGMENT, first, last, out=out))
        else:
            tile = _forward_tile(batch, widths[first], widths[last])
            segments.append(Segment(ROW_SEGMENT, first, last, tile, out))
            wsplit += split_floats(widths[first], widths[last], tile)
    return ForwardPlan(tuple(segments), tuple(bufs), wsplit)


@functools.cache
def _forward_entries():
    lib = cuda_build.load("fused_vae")
    fused = lib.atlasvae_stack_forward
    fused.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fused.restype = ctypes.c_int
    layers = lib.atlasvae_stack_forward_layers
    layers.argtypes = fused.argtypes[:-1] + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    layers.restype = ctypes.c_int
    return fused, layers


def layered_args(plan, x):
    """The arguments (n_segments, segment ints, buffer 0, buffer 1, split
    weights) that a layered plan adds to its C call, and what must stay alive
    until the call returns: the scratch tensor holding all three and the
    ints."""
    b0, b1 = plan.buf_floats
    scratch = torch.empty(b0 + b1 + plan.wsplit_floats, device=x.device, dtype=torch.float32)
    base = scratch.data_ptr()
    segs = cuda_build.int_array([v for seg in plan.segments for v in seg.ints()])
    return (len(plan.segments), ctypes.addressof(segs), base if b0 else None,
            base + 4 * b0 if b1 else None,
            base + 4 * (b0 + b1) if plan.wsplit_floats else None), (scratch, segs)


@functools.cache
def shape_array(widths):
    """The C array of a stack's widths, built once a shape."""
    return cuda_build.int_array(widths)


def stack_forward(x, hidden, heads):
    """Hidden ReLU stack + linear heads on a CUDA tensor: one kernel, or the
    segments of ``forward_plan``; the plain version on a CPU tensor."""
    global launches, layered_launches
    if x.device.type == "cpu":
        return stack_forward_plain(x, hidden, heads)
    if x.device.type != "cuda":
        raise ValueError(f"stack_forward: unsupported device {x.device}")
    cuda_build.check_stack(x, hidden, heads, "stack_forward")
    batch = x.shape[0]
    dims = (x.shape[1],) + tuple(w.shape[1] for w, _ in hidden)
    head_widths = tuple(w.shape[1] for w, _ in heads)
    plan = forward_plan(batch, dims, head_widths)
    outs = [torch.empty((batch, n), device=x.device, dtype=torch.float32) for n in head_widths]
    c_dims, c_heads = shape_array(dims), shape_array(head_widths)
    # one C array: the hidden weights, their biases, the head weights, their biases, the outputs
    n_h, n_k = len(hidden), len(heads)
    ptrs = cuda_build.pointer_array([w for w, _ in hidden] + [b for _, b in hidden]
                                    + [w for w, _ in heads] + [b for _, b in heads] + outs)
    at, size = ctypes.addressof(ptrs), ctypes.sizeof(ctypes.c_void_p)
    common = (x.data_ptr(), batch, n_h, ctypes.addressof(c_dims), at, at + size * n_h, n_k,
              ctypes.addressof(c_heads), at + size * 2 * n_h, at + size * (2 * n_h + n_k),
              at + size * (2 * n_h + 2 * n_k))
    fused, layers = _forward_entries()
    with cuda_build.on_device(x):
        stream = torch.cuda.current_stream().cuda_stream
        if plan.route == "fused":
            err = fused(*common, stream)
        else:
            args, _keep = layered_args(plan, x)   # _keep: the scratch, until the call returns
            err = layers(*common, *args, stream)
    cuda_build.check(err, f"stack_forward kernel ({plan.route} route)")
    if plan.route == "fused":
        launches += 1
    else:
        layered_launches += 1
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


# K3's routes.  The fused body (csrc/fused_vae_bwd.cu, stack_bwd_kernel)
# keeps the whole stack's weights and every activation and gradient of a
# 128-row tile in shared memory, and sums dW/db in 4 x 4 blocks (db as the
# row of a ones column), at most FUSED_MAX_BLOCKS of them; it takes a stack
# of at most FUSED_MAX_HIDDEN hidden layers whose widths are all at most 128
# and whose weights and tile fit a CTA (_fused_layout mirrors plan_fused_bwd).
# Every other stack takes the layer-wise route: one persistent launch per
# product over the whole batch on csrc/gemm_wgmma.cuh (the row products as
# K1/K2's, column tile from _forward_tile; a weight gradient's CTA tile
# ROW_TILE_ROWS of its rows by a column tile, the batch cut into splits of a
# whole number of ROW_STAGE_K rows, as many as fill CARD_SMS CTAs but none
# under SPLIT_MIN_ROWS rows), with the activations in a device scratch
# buffer.  The shape alone decides.
FUSED_ROWS = 128                # kBwdRows: 16 warps of 8 rows
FUSED_THREADS = 512
FUSED_MAX_PARTS = 132           # kBwdMaxParts: CTAs and partial slices, one an SM of an H100
FUSED_MIN_ROWS = 32             # kBwdMinRows: fewest rows a CTA takes
FUSED_MAX_BLOCKS = 2 * FUSED_THREADS  # kMaxBlocks a thread
MAX_SMEM = 232448               # a CTA's shared memory on sm_90
SPLIT_MIN_ROWS = 256            # fewest batch rows a weight gradient's split sums
MAX_ROWS = 2 ** 31 - 1          # the layer-wise route's batch: int32 TMA coordinates


@dataclasses.dataclass(frozen=True)
class BackwardPlan:
    """How K3 runs one stack at one batch size, and the device scratch it
    allocates (float32 counts).

    route        "fused" or "layers".
    n_parts      fused: CTAs and partial slices (fewer on a card of fewer
                 SMs), each slice 16 x n_blocks floats.
    n_blocks     fused: the stack's 4 x 4 dW/db blocks.
    row_tiles    layers: FORWARD_TILE_COLS index of each row product,
                 indexed as the recompute of hidden layer l (l < L), the
                 heads' gradient (L), and the gradient through hidden layer
                 i (L + 1 + i).
    splits       layers: (FORWARD_TILE_COLS index, splits, rows per split)
                 of each weight gradient, hidden layers first, then the
                 heads together.
    act_floats   layers: the hidden activations, batch x each hidden width,
                 each rounded up to 4.
    partial_floats  per-split dW/db slices (fused: per-CTA; layers: of the
                 weight gradients of more than one split).
    wsplit_floats   layers: the pre-pass's split weights (and the
                 recompute's column norms).
    chain_width  layers: the widest hidden layer that a re-decided ReLU
                 input's row is rebuilt through (0 for fewer than two hidden
                 layers); the wrapper adds chain_floats(sms) of scratch."""
    route: str
    n_parts: int = 0
    n_blocks: int = 0
    row_tiles: tuple = ()
    splits: tuple = ()
    act_floats: int = 0
    partial_floats: int = 0
    wsplit_floats: int = 0
    chain_width: int = 0

    def chain_floats(self, sms):
        """The rebuilt rows' buffers: two rows for each CTA, a CTA on each of
        ``sms`` SMs at most."""
        return sms * 2 * self.chain_width

    @property
    def scratch_bytes(self):
        """On a card of CARD_SMS SMs."""
        return 4 * (self.act_floats + self.partial_floats + self.wsplit_floats
                    + self.chain_floats(CARD_SMS))


def _ceil(a, b):
    return -(-a // b)


def _round4(n):
    return _ceil(n, 4) * 4


def _bwd_pitch(n):
    """A weight row's pitch in the fused body: a multiple of 4 floats that is
    4 mod 8 (bwd_pitch)."""
    p = _round4(n)
    return p + 4 if p // 4 % 2 == 0 else p


def _fused_layout(dims, head_dims, want_dx):
    """(4 x 4 dW/db blocks, shared memory bytes) of the fused body for a
    stack, as plan_fused_bwd in fused_vae_bwd.cu lays it out: each layer's
    weights (hidden: dims + 1 rows with the bias, rounded to 4; the heads
    concatenated) at _bwd_pitch, then per row of a 128-row tile every
    activation with its ones column, the heads' gradient, every hidden
    layer's gradient and dx's stage, each rounded to 4 floats."""
    head_total = sum(head_dims)
    widths = list(dims[1:]) + [head_total]
    floats = sum((_round4(k + 1) if i < len(dims) - 1 else k) * _bwd_pitch(n)
                 for i, (k, n) in enumerate(zip(dims, widths)))
    blocks = sum(_ceil(k + 1, 4) * _ceil(n, 4) for k, n in zip(dims, widths))
    floats += FUSED_ROWS * (sum(_round4(d + 1) for d in dims) + _round4(head_total)
                            + sum(_round4(d) for d in dims[1:]) + (_round4(dims[0]) if want_dx else 0))
    return blocks, 4 * floats


def _fused_fits(dims, head_dims, want_dx):
    """The fused body takes the stack: mirror of plan_fused_bwd."""
    if max(max(dims), sum(head_dims)) > FUSED_MAX_WIDTH or len(dims) - 1 > FUSED_MAX_HIDDEN:
        return False
    blocks, smem = _fused_layout(dims, head_dims, want_dx)
    return blocks <= FUSED_MAX_BLOCKS and smem <= MAX_SMEM


def _dw_split(batch, m, n):
    """(FORWARD_TILE_COLS index, splits, rows per split) of an m x n weight
    gradient summed over the batch: the column tile that pads n least (on a
    tie the wider), and as many splits of whole stages as keep its tiles x
    splits within one CTA an SM, none under SPLIT_MIN_ROWS rows."""
    tile = min(range(len(FORWARD_TILE_COLS)),
               key=lambda t: (_ceil(n, FORWARD_TILE_COLS[t]) * FORWARD_TILE_COLS[t], t))
    tiles = _ceil(m, ROW_TILE_ROWS) * _ceil(n, FORWARD_TILE_COLS[tile])
    splits = max(1, min(CARD_SMS // tiles, batch // SPLIT_MIN_ROWS))
    rows = _ceil(_ceil(batch, splits), ROW_STAGE_K) * ROW_STAGE_K
    return tile, _ceil(batch, rows), rows


def _recompute_layout(batch, dims):
    """The recompute's column tiles and what it takes of the scratch: (row
    tiles, floats of its split weights and column norms, activation floats,
    the chain width: the widest hidden layer below the last)."""
    tiles = tuple(_forward_tile(batch, k, n) for k, n in zip(dims, dims[1:]))
    wsplit = sum(split_floats(k, n, t) + _ceil(n, FORWARD_TILE_COLS[t]) * FORWARD_TILE_COLS[t]
                 for (k, n), t in zip(zip(dims, dims[1:]), tiles))
    return tiles, wsplit, sum(_round4(batch * n) for n in dims[1:]), max(dims[1:-1], default=0)


@functools.cache
def backward_plan(batch, dims, head_dims, want_dx):
    """K3's route and scratch for a stack of input/hidden widths ``dims``
    and head widths ``head_dims`` at ``batch`` rows.  The layer-wise route
    takes any depth and width (persistent launches: no grid bound) up to
    MAX_ROWS rows."""
    if _fused_fits(dims, head_dims, want_dx):
        n_parts = min(_ceil(batch, FUSED_MIN_ROWS), FUSED_MAX_PARTS)
        n_blocks = _fused_layout(dims, head_dims, want_dx)[0]
        return BackwardPlan("fused", n_parts=n_parts, n_blocks=n_blocks,
                            partial_floats=n_parts * 16 * n_blocks)
    if batch > MAX_ROWS:
        raise ValueError(f"stack_backward: at most 2**31 - 1 rows, got {batch}")
    n_hidden, head_total = len(dims) - 1, sum(head_dims)
    rec_tiles, wsplit, act_floats, chain_width = _recompute_layout(batch, dims)
    # the gradients one layer down: the heads' (k = their widths together,
    # n = the last hidden width), then each hidden layer's (k = its output)
    down = [(head_total, dims[-1])] + [(dims[i + 1], dims[i]) for i in range(n_hidden)]
    down_tiles = tuple(_forward_tile(batch, k, n) for k, n in down)
    # run: the heads' where a hidden layer or dx follows, a hidden layer's but the input one's
    # unless dx is wanted
    run = [n_hidden > 0 or want_dx] + [i > 0 or want_dx for i in range(n_hidden)]
    wsplit += sum(split_floats(k, n, t) for (k, n), t, r in zip(down, down_tiles, run) if r)
    layers = [(dims[i], dims[i + 1]) for i in range(n_hidden)] + [(dims[-1], head_total)]
    splits = tuple(_dw_split(batch, m, n) for m, n in layers)
    return BackwardPlan("layers", row_tiles=rec_tiles + down_tiles, splits=splits,
                        act_floats=act_floats,
                        partial_floats=sum(s * (m + 1) * n for (_, s, _), (m, n)
                                           in zip(splits, layers) if s > 1),
                        wsplit_floats=wsplit, chain_width=chain_width)


@functools.cache
def _backward_entries():
    lib = cuda_build.load("fused_vae_bwd")
    fused = lib.atlasvae_stack_backward
    fused.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fused.restype = ctypes.c_int
    layers = lib.atlasvae_stack_backward_layers
    layers.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    layers.restype = ctypes.c_int
    recompute = lib.atlasvae_stack_recompute
    recompute.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_void_p, ctypes.c_void_p]
    recompute.restype = ctypes.c_int
    return fused, layers, recompute


@functools.cache
def _stack_layout(dims, head_dims):
    """What stack_backward builds once a shape: the C arrays of the widths,
    and where each leaf's gradient lies in the flat parameter vector
    ([dW_0, db_0, ...]) as (shape, stride, offset) of dW and of db, with the
    vector's length last."""
    shapes = list(zip(dims, dims[1:])) + [(dims[-1], n) for n in head_dims]
    dw, db, off = [], [], 0
    for k, n in shapes:
        dw.append(((k, n), (n, 1), off))
        db.append(((n,), (1,), off + k * n))
        off += k * n + n
    return cuda_build.int_array(dims), cuda_build.int_array(head_dims), (dw, db, off)


_COUNTERS = {}


@functools.cache
def _device_sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _barrier_counter(device, stream):
    """The fused body's two integers of grid-barrier state for one stream:
    0 before each launch and left 0 by it (its last CTA resets them), so one
    buffer serves every call that stream makes."""
    key = (device, stream)
    if key not in _COUNTERS:
        _COUNTERS[key] = torch.zeros(2, dtype=torch.int32, device=device)
    return _COUNTERS[key]


def stack_backward(x, hidden, heads, head_grads, want_dx):
    """K3 on a CUDA tensor (the plain version on a CPU tensor): the
    gradients of ``stack_forward(x, hidden, heads)`` for the head-output
    gradients ``head_grads``, as (dws, dbs, dx).  The route follows
    ``backward_plan``."""
    global backward_launches, layered_backward_launches
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
    dims = (x.shape[1],) + tuple(w.shape[1] for w, _ in hidden)
    head_dims = tuple(w.shape[1] for w, _ in heads)
    plan = backward_plan(batch, dims, head_dims, bool(want_dx))
    c_dims, c_head_dims, leaf_views = _stack_layout(dims, head_dims)
    grads = torch.empty(leaf_views[-1], device=x.device, dtype=torch.float32)
    dx = torch.empty_like(x) if want_dx else None
    # one C array: the hidden weights, their biases, the head weights, the head gradients
    n_h, n_k = len(hidden), len(heads)
    ptrs = cuda_build.pointer_array([w for w, _ in hidden] + [b for _, b in hidden]
                                    + [w for w, _ in heads] + list(head_grads))
    at = ctypes.addressof(ptrs)
    fused, layers, _ = _backward_entries()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    size = ctypes.sizeof(ctypes.c_void_p)
    common = (x.data_ptr(), batch, n_h, ctypes.addressof(c_dims), at, at + size * n_h, n_k,
              ctypes.addressof(c_head_dims), at + size * 2 * n_h,
              at + size * (2 * n_h + n_k), dx.data_ptr() if want_dx else None)
    with torch.cuda.device(x.device):
        if plan.route == "fused":
            counter = _barrier_counter(x.device, stream)
            partial = torch.empty(plan.partial_floats, device=x.device, dtype=torch.float32)
            err = fused(*common, partial.data_ptr(), plan.n_parts, grads.data_ptr(),
                        counter.data_ptr(), stream)
        else:
            # one allocation: the split weights, the rebuilt rows, the
            # activations, the slices
            chain = plan.chain_floats(_device_sms(x.device))
            scratch = torch.empty(plan.wsplit_floats + chain + plan.act_floats
                                  + plan.partial_floats, device=x.device, dtype=torch.float32)
            base = scratch.data_ptr()
            row_tiles = cuda_build.int_array(plan.row_tiles)
            splits = cuda_build.int_array([v for split in plan.splits for v in split])
            err = layers(*common, base, base + 4 * plan.wsplit_floats, plan.chain_width,
                         base + 4 * (plan.wsplit_floats + chain),
                         base + 4 * (plan.wsplit_floats + chain + plan.act_floats),
                         ctypes.addressof(row_tiles), ctypes.addressof(splits), grads.data_ptr(),
                         stream)
    cuda_build.check(err, f"stack_backward kernel ({plan.route} route)")
    if plan.route == "fused":
        backward_launches += 1
    else:
        layered_backward_launches += 1
    dws = [grads.as_strided(shape, stride, off) for shape, stride, off in leaf_views[0]]
    dbs = [grads.as_strided(shape, stride, off) for shape, stride, off in leaf_views[1]]
    return dws, dbs, dx


def stack_recompute_plain(x, hidden):
    """Plain version of the layer-wise route's recompute: every hidden
    activation relu(a W + b), first layer first."""
    acts = [x]
    for w, b in hidden:
        acts.append(torch.relu(acts[-1] @ w + b))
    return acts[1:]


def stack_recompute(x, hidden, redecide=True, counts=False):
    """The recompute of K3's layer-wise route alone on a CUDA tensor (its
    pre-pass and row products; the plain version on a CPU tensor): the
    hidden activations as stack_backward decides their ReLU masks, for
    counting where those differ from K2's forward and from the plain
    version.  ``redecide=False`` leaves its ReLU near-ties as the 3xTF32
    products decide them (stack_backward re-decides them), to measure what
    the re-decision does.  ``counts``: also return
    how many elements each layer re-decided (a CUDA tensor; zeros on the
    CPU), as (activations, counts)."""
    global recompute_launches
    if x.device.type == "cpu":
        acts = stack_recompute_plain(x, hidden)
        return (acts, torch.zeros(len(hidden), dtype=torch.int32)) if counts else acts
    if x.device.type != "cuda":
        raise ValueError(f"stack_recompute: unsupported device {x.device}")
    if not hidden:
        raise ValueError("stack_recompute: no hidden layer")
    cuda_build.check_stack(x, hidden[:-1], hidden[-1:], "stack_recompute")
    batch = x.shape[0]
    if batch == 0 or batch > MAX_ROWS:
        raise ValueError(f"stack_recompute: 1 to 2**31 - 1 rows, got {batch}")
    dims = (x.shape[1],) + tuple(w.shape[1] for w, _ in hidden)
    tiles, wsplit, act_floats, chain_width = _recompute_layout(batch, dims)
    chain = _device_sms(x.device) * 2 * chain_width
    scratch = torch.empty(wsplit + chain + act_floats, device=x.device, dtype=torch.float32)
    redecided = torch.zeros(len(hidden), device=x.device, dtype=torch.int32)
    ptrs = cuda_build.pointer_array([w for w, _ in hidden] + [b for _, b in hidden])
    at, size = ctypes.addressof(ptrs), ctypes.sizeof(ctypes.c_void_p)
    c_dims, c_tiles = shape_array(dims), cuda_build.int_array(tiles)
    _, _, recompute = _backward_entries()
    with torch.cuda.device(x.device):
        base = scratch.data_ptr()
        err = recompute(x.data_ptr(), batch, len(hidden), ctypes.addressof(c_dims), at,
                        at + size * len(hidden), base, base + 4 * wsplit, chain_width,
                        base + 4 * (wsplit + chain), ctypes.addressof(c_tiles), int(redecide),
                        redecided.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(err, "stack_recompute kernel")
    recompute_launches += 1
    acts, off = [], wsplit + chain
    for n in dims[1:]:
        acts.append(scratch[off:off + batch * n].view(batch, n))
        off += _round4(batch * n)
    return (acts, redecided) if counts else acts


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
