"""Non-finite and near-FLT_MAX values made inside a dense stack.

A plant in a stack's input reaches a later layer only as NaN: x w sums inf
with the zeros of the other columns, and inf * 0 is NaN.  So these cases
make their values inside the stack instead, from finite inputs (or a NaN),
on weights edited so that one column, ``LANE``, carries the value from layer
to layer as a single element:

* the first hidden layer is the identity (zero bias) with column ``LANE + 1``
  of the input also added into column ``LANE``;
* every later layer (hidden or head) takes input ``LANE`` with weight 1 into
  output ``LANE`` and with a negative weight into every other output, and
  adds input ``LANE + 1`` into output ``LANE`` with weight 1 too.

A value v > 0 at input ``LANE`` of such a layer is v at output ``LANE`` and
-v |w| elsewhere, which a ReLU makes 0: +inf stays one +inf, and a value near
FLT_MAX stays one finite value there, as a ReLU output that the next
layer's product reads.  The heads show +inf at ``LANE`` and -inf elsewhere.
The rows, in ``plant_inside``:

* ``nan``: x[LANE] NaN: the whole row NaN from the first layer on;
* ``inf``: x[LANE] = x[LANE + 1] = 3e38: the first layer's sum, 6e38, is
  +inf in every order (its only other terms are x times 0); and x[LANE] =
  2e38, x[LANE + 1] = 1.2e38: finite after the first layer (3.2e38 and
  1.2e38), +inf in the second (4.4e38), again in every order;
* ``-inf``: x[LANE] = x[LANE + 1] = -3e38: -inf before the first ReLU, 0
  after it;
* every pattern also plants ``NEAR_MAX`` rows: 0x7F7FF000, the smallest
  float whose TF32 rounding is inf, at x[LANE] with x[LANE + 1] = 0: it
  stays finite through every layer.

The functions take numpy arrays or torch tensors, on any device, and edit
them in place.
"""

import struct

LANE = 5
NEAR_MAX = struct.unpack("<f", struct.pack("<I", 0x7F7FF000))[0]
PATTERNS = {"nan": [(float("nan"), 0.0)],
            "inf": [(3e38, 3e38), (2e38, 1.2e38)],
            "-inf": [(-3e38, -3e38)]}


def route_stack(hidden, heads, lane=LANE):
    """Edits the (w, b) pairs of a stack, hidden layers then heads, as the
    module docstring says."""
    w, b = hidden[0]
    w[...] = 0
    for i in range(min(w.shape)):
        w[i, i] = 1
    w[lane + 1, lane] = 1
    b[...] = 0
    for w, _ in list(hidden[1:]) + list(heads):
        w[lane, :] = -abs(w[lane, :])
        w[lane, lane] = 1
        w[lane + 1, lane] = 1


def plant_inside(x, plants, rows, lane=LANE):
    """Plants the patterns ``plants`` (keys of PATTERNS) and NEAR_MAX in the
    rows ``rows`` of x, in turn; returns the rows that got NEAR_MAX."""
    values = [v for p in plants for v in PATTERNS[p]] + [(NEAR_MAX, 0.0)]
    near = []
    for i, r in enumerate(rows):
        x[r, lane], x[r, lane + 1] = values[i % len(values)]
        if values[i % len(values)][0] == NEAR_MAX:
            near.append(r)
    return near
