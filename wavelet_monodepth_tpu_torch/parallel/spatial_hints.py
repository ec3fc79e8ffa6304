"""Height-banded (spatial) inference: the active band layout, the halo
exchange of windowed ops, the gathers and the reductions across bands.

Counterpart of `wavelet_monodepth_tpu/parallel/spatial_hints.py` and of
what JAX's GSPMD partitioner inserts under `parallel/mesh.py::
jit_spatial_forward`. Torch has no partitioner, so the port does it by
hand: each rank of a spatial group of R ranks runs the forward on its
band of rows, and the ops that need more than their band call the
functions below.

Band layout. Rank r holds rows [r * H / R, (r + 1) * H / R) of every
tensor whose global height H divides by R with at least 2 rows a band
(`Layout.banded`); any other tensor is held whole on every rank
("replicated": JAX's rule replicates below 2 rows a band,
`spatial_hints.py:48`; GSPMD pads uneven bands, the port does not, so it
replicates them). A tensor is in this layout or in full height, and its
global height says which: a band holds H / R rows, never H. `hint`
moves a tensor into the layout (a replicated tensor upsampled into a
banded height is sliced, with no communication), `gather` back to full
height.

Halos. A windowed op with kernel k, stride s and pad p along H, from a
banded input to a banded output, takes p rows from the band above and
k - p - s from the band below (`halo`): 3x3 s1 1/1, 3x3 s2 1/0, the 7x7
s2 p3 stem 3/2, max_pool2d(3, 2, 1) 1/0, 1x1 0/0, avg_pool2d(2, 2) 0/0,
the mask dilations (3x3, 5x5) 1/1 and 2/2, and the polyphase fold's
low-res 2x2 conv 1/1 (`ops/convops.upconv1_polyphase`: it keeps h + 1
rows of its h, a band b + 1 of its b). Only the first and last
bands pad at the image border, in the op's own mode ("zero", "reflect",
"replicate" or "-inf" for the max pools, `assemble`); the horizontal
padding is unchanged. An op whose output is replicated gathers its
input first. Halos and gathers go through all_gather on the spatial
group; with gloo the tensors go through the host, as gloo's collectives
take (the `mesh._comm_device` rule).

Global heights: the encoder and decoder know the height of every tensor
they make. `mark` tags a tensor that leaves a module with its global
height (`rows_of` reads it), so the decoder learns the features' heights
and `mesh.spatial_forward` knows which outputs to gather. Inside a
module, the decoder scopes the global height of the tensors it works on
with `at_rows`; the shared ops read that scope alone (`band_of`,
`global_shape`, `reduce_rows`, `hint` without rows): the padded convs and
dilations of `ops/image.py`, and the threshold, masks and counts of
`ops/sparse.py`.

Everything is off unless `active` is entered (`mesh.spatial_forward`
enters it): the one-card and data-parallel paths are untouched.
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

_LAYOUT: contextvars.ContextVar = contextvars.ContextVar(
    "wmd_spatial_layout", default=None)
_ROWS: contextvars.ContextVar = contextvars.ContextVar(
    "wmd_spatial_rows", default=None)
# the attribute `mark` sets on a tensor: its global height
_TAG = "_wmd_global_rows"


def halo(k: int, s: int, p: int) -> tuple[int, int]:
    """(rows from the band above, rows from the band below) of a window
    op with kernel k, stride s and pad p along H. The polyphase fold's
    2x2 VALID conv on x0 padded by 1 takes 1/1, not halo(2, 1, 1): its
    output has one row more than its input, so a band yields b + 1 rows,
    which interleave into the 2b rows of its output band."""
    return p, k - p - s


@dataclass(frozen=True)
class Layout:
    """One rank's place in its spatial group: `size` ranks (R) band the
    height, this one is `index` (r). `group` is the process group of the
    band (None: the default group)."""

    size: int
    index: int
    group: Any = None

    def banded(self, rows: int) -> bool:
        """Whether a tensor of `rows` global rows is held in bands."""
        return self.size > 1 and rows % self.size == 0 \
            and rows // self.size >= 2

    def band(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's rows of a full-height tensor."""
        b = x.shape[dim] // self.size
        return x.narrow(dim, self.index * b, b)

    def is_band(self, x: torch.Tensor, rows: int, dim: int = 1) -> bool:
        """Whether `x`, a tensor of `rows` global rows, is this rank's band
        (False: it is whole). Raises on a height that is neither."""
        h = x.shape[dim]
        if self.banded(rows) and h == rows // self.size:
            return True
        if h == rows:
            return False
        raise ValueError(f"a tensor of {h} rows is neither the band nor "
                         f"the whole of {rows} global rows over "
                         f"{self.size} ranks")

    # --- collectives -------------------------------------------------------

    def _comm(self, t: torch.Tensor) -> torch.Tensor:
        """`t` on the device the group's backend takes: NCCL the card's,
        gloo the host's."""
        if dist.get_backend(self.group) == "nccl":
            return t.contiguous()
        return t.to("cpu").contiguous()

    def _all_gather(self, t: torch.Tensor) -> list:
        mine = self._comm(t)
        got = [torch.empty_like(mine) for _ in range(self.size)]
        dist.all_gather(got, mine, group=self.group)
        return [g.to(t.device) for g in got]

    def all_reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        """`t` reduced elementwise over the group: "sum", "max" or "min"."""
        out = self._comm(t.clone())
        dist.all_reduce(out, {"sum": dist.ReduceOp.SUM,
                              "max": dist.ReduceOp.MAX,
                              "min": dist.ReduceOp.MIN}[op],
                        group=self.group)
        return out.to(t.device)

    def gather(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The full-height tensor of which `x` is this rank's band."""
        return torch.cat(self._all_gather(x), dim)

    def pad_rows(self, x: torch.Tensor, top: int, bottom: int, mode: str,
                 dim: int = 1) -> torch.Tensor:
        """This band with `top` rows of the band above and `bottom` of the
        band below, or the border's padding in `mode` at the image's
        first and last rows."""
        if top == 0 and bottom == 0:
            return x
        n = x.shape[dim]
        if top > n or bottom > n:
            raise ValueError(f"halo {top}/{bottom} exceeds a band of {n} "
                             "rows")
        edges = self._all_gather(torch.cat(
            [x.narrow(dim, 0, bottom), x.narrow(dim, n - top, top)], dim))
        r = self.index
        above = (edges[r - 1].narrow(dim, bottom, top) if r > 0 else None)
        below = (edges[r + 1].narrow(dim, 0, bottom)
                 if r < self.size - 1 else None)
        return assemble(x, above, below, top, bottom, mode, dim)


def assemble(band: torch.Tensor, above: Optional[torch.Tensor],
             below: Optional[torch.Tensor], top: int, bottom: int,
             mode: str, dim: int = 1) -> torch.Tensor:
    """`band` between its halos: `above` / `below` are the neighbours'
    rows, or None at the image's first / last band, which pads `top` /
    `bottom` rows in `mode` instead ("zero", "reflect", "replicate",
    "-inf"). The communication-free half of `Layout.pad_rows`."""
    n = band.shape[dim]

    def border(count: int, first: bool) -> torch.Tensor:
        if mode in ("zero", "-inf"):
            shape = list(band.shape)
            shape[dim] = count
            return band.new_full(shape, 0.0 if mode == "zero"
                                 else float("-inf"))
        if mode == "reflect":
            start = 1 if first else n - 1 - count
            return band.narrow(dim, start, count).flip(dim)
        if mode == "replicate":
            edge = band.narrow(dim, 0 if first else n - 1, 1)
            return torch.cat([edge] * count, dim)
        raise ValueError(f"unknown pad mode {mode!r}")

    parts = []
    if top:
        parts.append(above if above is not None else border(top, True))
    parts.append(band)
    if bottom:
        parts.append(below if below is not None else border(bottom, False))
    return torch.cat(parts, dim) if len(parts) > 1 else band


# --- the context -------------------------------------------------------------

@contextlib.contextmanager
def active(layout: Layout):
    """Run the enclosed forward in bands of `layout` (`mesh.make_mesh`
    builds it; `mesh.spatial_forward` enters this)."""
    tok = _LAYOUT.set(layout)
    try:
        yield layout
    finally:
        _LAYOUT.reset(tok)


def current() -> Optional[Layout]:
    """The active layout, or None outside `active`."""
    return _LAYOUT.get()


_NO_SCOPE = contextlib.nullcontext()


@contextlib.contextmanager
def _scope(rows: Optional[int]):
    tok = _ROWS.set(rows)
    try:
        yield
    finally:
        _ROWS.reset(tok)


def at_rows(rows: Optional[int]):
    """The global height of the tensors that the enclosed ops take (None:
    whole tensors). A no-op outside `active`."""
    return _NO_SCOPE if _LAYOUT.get() is None else _scope(rows)


def upsampled():
    """The `at_rows` scope of a 2x upsample of the scope's tensors."""
    rows = _ROWS.get()
    return at_rows(None if rows is None else 2 * rows)


def downsampled():
    """The `at_rows` scope of the tensor that a 2x upsample into the
    scope's tensors reads (the polyphase fold's x0)."""
    rows = _ROWS.get()
    return at_rows(None if rows is None else rows // 2)


def band_of(x: torch.Tensor, dim: int = 1) -> Optional[Layout]:
    """The active layout when `x` is a band under the `at_rows` scope,
    else None (no layout, no scope, or a whole tensor)."""
    layout, rows = _LAYOUT.get(), _ROWS.get()
    if layout is None or rows is None:
        return None
    return layout if layout.is_band(x, rows, dim) else None


def global_shape(x: torch.Tensor, dim: int = 1) -> tuple:
    """`x`'s shape at its global height under the `at_rows` scope."""
    layout = band_of(x, dim)
    shape = tuple(x.shape)
    if layout is None:
        return shape
    return shape[:dim] + (shape[dim] * layout.size,) + shape[dim + 1:]


def mark(x: torch.Tensor, rows: int) -> torch.Tensor:
    """Tag `x` with its global height under an active layout; returns x."""
    if _LAYOUT.get() is not None:
        setattr(x, _TAG, int(rows))
    return x


def rows_of(x: torch.Tensor, dim: int = 1) -> int:
    """The global height of `x`: its tag under an active layout, else its
    own height."""
    if _LAYOUT.get() is not None:
        tag = getattr(x, _TAG, None)
        if tag is not None:
            return tag
    return x.shape[dim]


def hint(x: torch.Tensor, rows: Optional[int] = None, dim: int = 1
         ) -> torch.Tensor:
    """`x`, of `rows` global rows (by default the `at_rows` scope's), in
    the band layout: a whole tensor of a banded height is sliced to this
    rank's band, a band of a replicated height is gathered; tagged. The
    identity outside `active` or with no height (JAX's `hint`, which
    constrains the sharding the same way)."""
    layout = _LAYOUT.get()
    if layout is None:
        return x
    if rows is None:
        rows = _ROWS.get()
    if rows is None:
        return x
    if layout.banded(rows) and x.shape[dim] == rows:
        x = layout.band(x, dim)
    elif not layout.banded(rows) and x.shape[dim] != rows:
        x = layout.gather(x, dim)
    return mark(x, rows)


def hint_features(features) -> tuple[list, list]:
    """(the features, their global heights): under an active layout each
    feature in the band layout at its global height (`rows_of`; a whole
    feature of a banded height is sliced), as the decoders take them;
    unchanged outside one."""
    features = [hint(f, rows_of(f)) for f in features]
    return features, [rows_of(f) for f in features]


def gather(x: torch.Tensor, rows: Optional[int], dim: int = 1
           ) -> torch.Tensor:
    """`x`, of `rows` global rows, in full height on every rank."""
    layout = _LAYOUT.get()
    if layout is None or rows is None or not layout.is_band(x, rows, dim):
        return x
    return layout.gather(x, dim)


def reduce_rows(t: torch.Tensor, x: torch.Tensor, op: str) -> torch.Tensor:
    """`t`, a per-image reduction of `x` over its rows, reduced over the
    bands too ("sum", "max", "min") when `x` is a band under the
    `at_rows` scope."""
    layout = band_of(x)
    return t if layout is None else layout.all_reduce(t, op)


def window(x: torch.Tensor, rows: int, k: int, s: int, p: int, mode: str,
           run) -> tuple[torch.Tensor, int]:
    """A windowed op along H of NCHW `x` (`rows` global rows) with kernel
    k, stride s, pad p: `run(x, ph)` applies it with H padding ph and its
    own horizontal padding. Banded in and out, the band runs between its
    halos (ph = 0); banded in, replicated out, the input is gathered
    first; whole in, whole out. Returns (y, its global rows), y tagged."""
    layout = _LAYOUT.get()
    out_rows = (rows + 2 * p - k) // s + 1
    if layout is None:
        return run(x, p), out_rows
    if not layout.is_band(x, rows, 2):
        return mark(run(x, p), out_rows), out_rows
    if not layout.banded(out_rows):
        return mark(run(layout.gather(x, 2), p), out_rows), out_rows
    if rows != s * out_rows:
        raise ValueError(f"a {k}x{k} stride-{s} window over {rows} rows "
                         f"gives {out_rows}, not a band of each input band")
    # a negative bottom halo (1x1 s2: -1) is rows the window never reads
    top, bottom = (max(h, 0) for h in halo(k, s, p))
    y = run(layout.pad_rows(x, top, bottom, mode, 2), 0)
    if y.shape[2] != out_rows // layout.size:
        raise ValueError(f"a {k}x{k} stride-{s} window gave {y.shape[2]} "
                         f"rows of a {out_rows // layout.size}-row band")
    return mark(y, out_rows), out_rows


def conv2d(conv: torch.nn.Conv2d, x: torch.Tensor, rows: int
           ) -> tuple[torch.Tensor, int]:
    """`conv(x)` (NCHW, zero padding) on `x` of `rows` global rows, banded
    by `window`."""
    k, s, p = conv.kernel_size[0], conv.stride[0], conv.padding[0]
    pw = conv.padding[1]
    return window(x, rows, k, s, p, "zero", lambda t, ph: F.conv2d(
        t, conv.weight, conv.bias, conv.stride, (ph, pw), conv.dilation,
        conv.groups))


def max_pool2d(x: torch.Tensor, rows: int, k: int, s: int, p: int
               ) -> tuple[torch.Tensor, int]:
    """`F.max_pool2d(x, k, s, p)` (NCHW) on `x` of `rows` global rows,
    banded by `window` (-inf at the image border, as the pool pads)."""
    return window(x, rows, k, s, p, "-inf",
                  lambda t, ph: F.max_pool2d(t, k, s, (ph, p)))


def avg_pool2d(x: torch.Tensor, rows: int, k: int = 2, s: int = 2
               ) -> tuple[torch.Tensor, int]:
    """`F.avg_pool2d(x, k, s)` (NCHW, no padding: DenseNet's transitions)
    on `x` of `rows` global rows, banded by `window`: k = s = 2 has no
    halo on even bands."""
    return window(x, rows, k, s, 0, "zero",
                  lambda t, ph: F.avg_pool2d(t, k, s))
