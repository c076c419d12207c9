"""The spatial mesh axis: each image's rows split over the ranks of a (data ×
spatial) grid (`onda_tpu/parallel/mesh.py::make_mesh(shape=(d, s),
axes=("data", "spatial"))`, whose halo exchanges GSPMD writes; here they are
written by hand).

Row ownership. A tensor of H rows, at any resolution (the image, the stem's
output, the pool's, the 1/8+1 feature grid), is split into s contiguous
blocks, the first H % s of them one row longer (`split`): 129 rows as 65/64,
65 as 33/32. The rank at spatial index r holds block r. Every activation of
the model is split so, which leaves elementwise work, BatchNorm's
normalisation and the residual adds alone; what reads other rows does not:

* A windowed op (a convolution whose kernel or stride in H is above 1, the
  ceil-mode max pool): output row o reads input rows [o·st − p,
  o·st − p + d·(k − 1)]. `fetch_rows` gives each rank the input rows its
  block of output rows reads, from whichever ranks hold them (a dilation of
  24 on a 9-row grid, or on a 33-row block, reaches past the neighbour), in
  one gather over the spatial group of what each rank must send; the op then
  runs with H padding only at the global edges (zeros for a convolution,
  −inf for the pool, whose ceil row exists only on the last rank). Its
  backward returns each fetched row's gradient to its owner, which adds it
  (one more gather).
* Reductions over H (BatchNorm's statistics, GroupNorm's, the SE block's
  mean) are sums and counts over the spatial group (`distributed.summed`,
  `distributed.pixel_means`), in `models.layers` and `models.deeplabv2`.

A rank sees only its own block, so the global height of a tensor comes from
a table (`begin`, `global_height`) that the model's entry fills with the
image's height (which the spatial axis must divide) and each windowed op
with its output's. At every spatial index the blocks of the resolutions of
one forward must differ in height, which `register` checks alike on every
rank.

The exchange plan is a pure function of the heights and the op's geometry
(`row_plan`, `window_plan`), and the exchange itself is an argument
(default: `distributed.gather_spatial`), so one process can run every
block's op against the unsharded op by slicing, its ranks being threads
(tests/test_torch_spatial.py).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..ops.interp import resize_nearest
from . import distributed as dist

_HEIGHTS: dict = {}  # this rank's block height → the global height, in this forward
_KNOWN: set = set()  # the global heights registered in this forward


def active() -> bool:
    """Whether the ranks form a spatial axis above 1."""
    return dist.spatial_world() > 1


def split(n: int, s: int) -> tuple:
    """(start, stop) of each of s contiguous blocks of n rows, the first
    n % s of them one row longer."""
    base, extra = divmod(n, s)
    out, start = [], 0
    for r in range(s):
        stop = start + base + (r < extra)
        out.append((start, stop))
        start = stop
    return tuple(out)


def shard_rows(x: torch.Tensor, dim: int = 2, rank: int | None = None,
               size: int | None = None) -> torch.Tensor:
    """Spatial index `rank`'s block (default: this rank's) of a whole
    tensor's rows along `dim` (2 for NCHW images, 1 for (N, H, W) labels)."""
    size = dist.spatial_world() if size is None else size
    rank = dist.spatial_rank() if rank is None else rank
    a, b = split(x.shape[dim], size)[rank]
    return x.narrow(dim, a, b - a)


# ---------------------------------------------------------------------------
# the global heights of one forward
# ---------------------------------------------------------------------------


def begin(image: torch.Tensor) -> None:
    """At the model's entry: the table holds the image's global height,
    the spatial axis's size times this rank's block (the axis divides it)."""
    _HEIGHTS.clear()
    _KNOWN.clear()
    register(image.shape[2] * dist.spatial_world())


def register(height: int) -> None:
    """Enter a global height in the table; raise ValueError where its block
    at some spatial index is as high as another height's there (every rank
    checks every index, so all raise alike)."""
    if height in _KNOWN:
        return
    s = dist.spatial_world()
    blocks = [b - a for a, b in split(height, s)]
    for known in _KNOWN:
        if any(x == y for x, y in zip(blocks, (b - a for a, b in split(known, s)))):
            raise ValueError(f"rows of {height} and {known} split over {s} spatial ranks give "
                             f"blocks of one height ({blocks}): a rank could not tell them apart")
    _KNOWN.add(height)
    _HEIGHTS[blocks[dist.spatial_rank()]] = height


def rows(local: int) -> int:
    """The global height of a tensor of `local` rows here: itself off a
    spatial axis."""
    return global_height(local) if active() else local


def global_pixels(n: int, h: int, w: int) -> int:
    """The pixels of the global batch of which this rank holds n samples of
    h rows and w columns: n · the rows' global height · w · the data axis."""
    return n * rows(h) * w * dist.data_world()


def global_height(local: int) -> int:
    """The global height of a tensor of which this rank holds `local` rows."""
    if local not in _HEIGHTS:
        raise RuntimeError(f"no tensor of this forward has a block of {local} rows here (known: "
                           f"{sorted(_HEIGHTS.items())}); the model's entry calls `begin`")
    return _HEIGHTS[local]


# ---------------------------------------------------------------------------
# the exchange plans
# ---------------------------------------------------------------------------


class RowPlan(NamedTuple):
    """Which rows of a tensor of `sum of blocks` rows each rank fetches."""
    blocks: tuple   # (start, stop) of each rank's rows
    want: tuple     # each rank's wanted rows (global, sorted, unique)
    send: tuple     # per rank j: ((i, rows of j that i wants), ...) for i != j, in order of i
    width: int      # rows of the forward's buffer: the longest send (0: no exchange)
    back: int       # rows of the backward's buffer: the most rows a rank fetched

    def offset(self, j: int, i: int) -> int:
        """Where rank i's rows start in rank j's send buffer."""
        return sum(len(rows) for k, rows in self.send[j] if k < i)

    def back_offset(self, i: int, j: int) -> int:
        """Where the rows rank i fetched from rank j start in i's backward buffer."""
        return sum(len(self.pieces(i)[k]) for k in range(j) if k != i)

    @functools.lru_cache(maxsize=None)  # noqa: B019 - plans are few and live as long
    def pieces(self, i: int) -> tuple:
        """Rank i's wanted rows, by the rank that holds them."""
        return tuple(tuple(x for x in self.want[i] if a <= x < b) for a, b in self.blocks)


@functools.lru_cache(maxsize=None)
def row_plan(n: int, s: int, want: tuple) -> RowPlan:
    """The plan of an exchange in which spatial index i fetches the rows
    want[i] of a tensor of n rows split by `split`."""
    blocks = split(n, s)
    send = tuple(tuple((i, tuple(x for x in rows if a <= x < b))
                       for i, rows in enumerate(want) if i != j)
                 for j, (a, b) in enumerate(blocks))
    width = max(sum(len(rows) for _, rows in sj) for sj in send)
    back = max(sum(1 for x in rows if not a <= x < b)
               for rows, (a, b) in zip(want, blocks))
    return RowPlan(blocks, want, send, width, back)


class WindowPlan(NamedTuple):
    rows: RowPlan
    out_height: int
    edges: tuple  # per rank: (padding rows above, below its fetched rows)


@functools.lru_cache(maxsize=None)
def window_plan(height: int, s: int, k: int, stride: int, pad: int, dilation: int,
                ceil: bool = False) -> WindowPlan:
    """The fetch of a windowed op in H (kernel k, stride, padding, dilation;
    `ceil`: PyTorch's ceil-mode output height, as the max pool takes it) on
    a tensor of `height` rows: each rank's block of output rows, the input
    rows it reads and the padding rows beyond the global edges."""
    span = dilation * (k - 1)
    if ceil:
        out = -(-(height + 2 * pad - span - 1) // stride) + 1
        if (out - 1) * stride >= height + pad:
            out -= 1
    else:
        out = (height + 2 * pad - span - 1) // stride + 1
    blocks = split(out, s)
    if min(b - a for a, b in split(height, s) + blocks) < 1:
        raise ValueError(f"{height} rows in, {out} rows out over {s} spatial ranks leave a rank "
                         "without rows")
    want, edges = [], []
    for o0, o1 in blocks:
        lo, hi = o0 * stride - pad, (o1 - 1) * stride - pad + span + 1
        want.append(tuple(range(max(lo, 0), min(hi, height))))
        edges.append((max(0, -lo), max(0, hi - height)))
    return WindowPlan(row_plan(height, s, tuple(want)), out, tuple(edges))


# ---------------------------------------------------------------------------
# the fetch
# ---------------------------------------------------------------------------


def _rows(x: torch.Tensor, rows, start: int) -> torch.Tensor:
    """Rows `rows` (global, sorted) of x's dim 2, x holding rows from `start`."""
    if rows[-1] - rows[0] + 1 == len(rows):
        return x[:, :, rows[0] - start:rows[-1] - start + 1]
    return x.index_select(2, torch.tensor([v - start for v in rows], device=x.device))


def _fetch(x, plan: RowPlan, r: int, exchange) -> torch.Tensor:
    start = plan.blocks[r][0]
    gathered = None
    if plan.width:
        buf = x.new_zeros((x.shape[0], x.shape[1], plan.width, x.shape[3]))
        at = 0
        for _, rows in plan.send[r]:
            if rows:
                buf[:, :, at:at + len(rows)] = _rows(x, rows, start)
                at += len(rows)
        gathered = exchange(buf)
    parts = []
    for j, rows in enumerate(plan.pieces(r)):
        if not rows:
            continue
        if j == r:
            parts.append(_rows(x, rows, start))
        else:
            at = plan.offset(j, r)
            parts.append(gathered[j][:, :, at:at + len(rows)])
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=2)


def _add_rows(out: torch.Tensor, rows, start: int, part: torch.Tensor) -> None:
    """out's rows `rows` (global, sorted; out holds rows from `start`) += part."""
    if rows[-1] - rows[0] + 1 == len(rows):
        out[:, :, rows[0] - start:rows[-1] - start + 1] += part
    else:
        out.index_add_(2, torch.tensor([v - start for v in rows], device=out.device), part)


def _return(g, plan: RowPlan, r: int, exchange, local: int) -> torch.Tensor:
    start = plan.blocks[r][0]
    out = g.new_zeros((g.shape[0], g.shape[1], local, g.shape[3]))
    sent, at = [], 0
    for j, rows in enumerate(plan.pieces(r)):
        part = g[:, :, at:at + len(rows)]
        at += len(rows)
        if j == r and rows:
            _add_rows(out, rows, start, part)
        elif rows:
            sent.append(part)
    if plan.back:
        buf = g.new_zeros((g.shape[0], g.shape[1], plan.back, g.shape[3]))
        if sent:
            n = sum(p.shape[2] for p in sent)
            buf[:, :, :n] = torch.cat(sent, dim=2)
        gathered = exchange(buf)
        for i in range(len(plan.blocks)):
            rows = plan.pieces(i)[r]
            if i != r and rows:
                at = plan.back_offset(i, r)
                _add_rows(out, rows, start, gathered[i][:, :, at:at + len(rows)])
    return out


class _FetchRows(torch.autograd.Function):
    """Forward: the rows `plan.want[r]` of a row-split (N, C, h, W) tensor,
    from the ranks that hold them. Backward: each fetched row's gradient
    back to its owner, added to the gradient of its own rows."""

    @staticmethod
    def forward(ctx, x, plan, r, exchange):
        ctx.plan, ctx.r, ctx.exchange, ctx.local = plan, r, exchange, x.shape[2]
        return _fetch(x, plan, r, exchange)

    @staticmethod
    def backward(ctx, g):
        return _return(g.contiguous(), ctx.plan, ctx.r, ctx.exchange, ctx.local), None, None, None


def fetch_rows(x: torch.Tensor, plan: RowPlan, r: int, exchange=None) -> torch.Tensor:
    """Spatial index r's wanted rows (`plan.want[r]`) of the row-split
    (N, C, h, W) tensor of which x is r's block: x itself where they are
    its own rows and no rank fetches any; differentiable. `exchange(buf)`
    stacks every spatial rank's buf (default: `distributed.gather_spatial`)."""
    exchange = exchange or dist.gather_spatial
    a, b = plan.blocks[r]
    if not plan.width and plan.want[r] == tuple(range(a, b)):
        return x
    return _FetchRows.apply(x, plan, r, exchange)


# ---------------------------------------------------------------------------
# the windowed ops
# ---------------------------------------------------------------------------


def _window(x, height, k, stride, pad, dilation, ceil, r, s, exchange, fill):
    plan = window_plan(height, s, k, stride, pad, dilation, ceil)
    win = fetch_rows(x, plan.rows, r, exchange)
    top, bottom = plan.edges[r]
    if top or bottom:
        win = F.pad(win, (0, 0, top, bottom), value=fill)
    return win, plan.out_height


def conv2d_rows(x, weight, bias, stride, padding, dilation, height: int, r: int, s: int,
                exchange=None):
    """(this rank's block of a row-split convolution's output, the
    output's global height): x is spatial index r's block of an input of
    `height` rows; stride, padding, dilation are (H, W) pairs."""
    win, out = _window(x, height, weight.shape[2], stride[0], padding[0], dilation[0], False,
                       r, s, exchange, 0.0)
    return F.conv2d(win, weight, bias, stride, (0, padding[1]), dilation), out


def max_pool_rows(x, window: int, stride: int, padding: int, height: int, r: int, s: int,
                  exchange=None):
    """(this rank's block of a row-split ceil-mode max pool's output, its
    global height)."""
    win, out = _window(x, height, window, stride, padding, 1, True, r, s, exchange,
                       float("-inf"))
    return F.max_pool2d(win, window, stride, (0, padding), ceil_mode=True), out


def conv2d(x, weight, bias, stride, padding, dilation):
    """A convolution of this rank's rows on the spatial axis (the output's
    height entered in the table)."""
    y, out = conv2d_rows(x, weight, bias, stride, padding, dilation,
                         global_height(x.shape[2]), dist.spatial_rank(), dist.spatial_world())
    register(out)
    return y


def max_pool_ceil(x, window: int, stride: int, padding: int):
    """The ceil-mode max pool of this rank's rows on the spatial axis."""
    y, out = max_pool_rows(x, window, stride, padding, global_height(x.shape[2]),
                           dist.spatial_rank(), dist.spatial_world())
    register(out)
    return y


def resize_nearest_labels(labels: torch.Tensor, out_hw) -> torch.Tensor:
    """This rank's rows of the nearest resize (`ops.interp.resize_nearest`'s
    rule) of row-split (N, H, W) labels to the global size `out_hw`: each
    rank fetches the label rows its output rows read, wherever they lie."""
    s, r = dist.spatial_world(), dist.spatial_rank()
    h_in, (h_out, w_out) = global_height(labels.shape[1]), out_hw
    index = torch.arange(h_in, dtype=torch.float32).view(1, 1, h_in, 1)
    source = resize_nearest(index, (h_out, 1)).view(-1).long().tolist()
    want = tuple(tuple(sorted(set(source[a:b]))) for a, b in split(h_out, s))
    plan = row_plan(h_in, s, want)
    rows = fetch_rows(labels[:, None], plan, r)[:, 0]
    o0, o1 = split(h_out, s)[r]
    pick = torch.tensor([want[r].index(v) for v in source[o0:o1]], device=labels.device)
    return resize_nearest(rows.index_select(1, pick), (o1 - o0, w_out))
