"""The spatial axis's windowed ops (`onda_torch/parallel/spatial.py`) in one
process: every spatial rank's block of a convolution or of the ceil-mode
max pool, its ranks run as threads that exchange through shared slots,
against the unsharded op by slicing, forward and backward.

The cases cover the geometry DeepLab-v2 gives the ops (kernels 1, 3 and 7,
strides 1 and 2, dilations up to the ASPP's 24, whose window reaches past
the neighbouring block on a 9-row grid) at heights whose blocks are even
(64) and uneven (9, 65) over 2 and 4 ranks. The inputs are float64, so the
only difference from the unsharded op is the order of a few sums: the bound
is 1e-6 of each result's largest entry. The grid's guards (`mesh`) and the
row table (`spatial.register`) are held here too.
"""

import threading

import pytest
import torch
import torch.nn.functional as F

from onda_torch.parallel import distributed, mesh, spatial

BOUND = 1e-6
HEIGHTS, SHARDS = (9, 64, 65), (2, 4)
CONVS = [(1, stride, 1) for stride in (1, 2)] + [
    (k, stride, d) for k in (3, 7) for stride in (1, 2) for d in (1, 2, 4, 24)]


class Slots:
    """An exchange among `size` threads: each puts its buffer in its slot,
    and every one reads the stack of all of them."""

    def __init__(self, size: int):
        self.slots = [None] * size
        self.barrier = threading.Barrier(size, timeout=60)

    def exchange(self, r):
        def run(buf):
            self.slots[r] = buf
            self.barrier.wait()
            out = torch.stack(self.slots)
            self.barrier.wait()
            return out
        return run


def _threads(size, fn):
    """fn(r) on `size` threads at once; their results in rank order."""
    out, errors = [None] * size, []

    def run(r):
        try:
            out[r] = fn(r)
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def _gap(got, want):
    return ((got - want).abs().max() / want.abs().max().clamp(min=1e-30)).item()


def _case(op, height, shards, seed=0):
    """op(x, r, exchange) → (this rank's output block, the global output
    height) on every rank against op(x, None, None) unsharded: forward,
    and the backward of a seeded weighting of the output (the input's and
    the weight's gradients)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, 3, height, 5, generator=g, dtype=torch.float64)
    w = torch.randn(4, 3, 7, 3, generator=g, dtype=torch.float64)
    xs, ws = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    want, _ = op(xs, ws, None, None)
    gy = torch.randn(want.shape, generator=g, dtype=torch.float64)
    (want * gy).sum().backward()
    slots = Slots(shards)

    def rank(r):
        xr = spatial.shard_rows(x, 2, r, shards).clone().requires_grad_(True)
        wr = w.clone().requires_grad_(True)
        y, out_height = op(xr, wr, r, slots.exchange(r))
        (y * spatial.shard_rows(gy, 2, r, shards)).sum().backward()
        return y.detach(), out_height, xr.grad, wr.grad

    got = _threads(shards, rank)
    assert all(h == want.shape[2] for _, h, _, _ in got)
    y = torch.cat([r[0] for r in got], dim=2)
    assert y.shape == want.shape
    assert _gap(y, want) <= BOUND
    assert _gap(torch.cat([r[2] for r in got], dim=2), xs.grad) <= BOUND
    if ws.grad is not None and ws.grad.abs().max() > 0:
        assert _gap(sum(r[3] for r in got), ws.grad) <= BOUND


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("height", HEIGHTS)
@pytest.mark.parametrize("k,stride,dilation", CONVS + [("pool", 2, 1)])
def test_windowed_op_matches_the_unsharded_op(k, stride, dilation, height, shards):
    """A convolution (padding d·(k − 1)/2, as the model's) or the 3×3
    stride-2 ceil-mode max pool of the stem, on `shards` blocks of
    `height` rows, equals the unsharded op's rows, forward and backward."""
    if k == "pool":
        def op(x, w, r, exchange):
            if r is None:
                return F.max_pool2d(x, 3, 2, 1, ceil_mode=True), None
            return spatial.max_pool_rows(x, 3, 2, 1, height, r, shards, exchange)
    else:
        pad = dilation * (k - 1) // 2

        def op(x, w, r, exchange):
            w = w[:, :, :k, :1 if k == 1 else 3]
            wpad = 0 if k == 1 else 1
            if r is None:
                return F.conv2d(x, w, None, (stride, 1), (pad, wpad), (dilation, 1)), None
            return spatial.conv2d_rows(x, w, None, (stride, 1), (pad, wpad), (dilation, 1),
                                       height, r, shards, exchange)
    _case(op, height, shards)


def test_far_rows_come_from_beyond_the_neighbour():
    """The ASPP's dilation 24 on the 9-row grid of a 64-pixel image over 4
    ranks: every rank reads rows of ranks that are not its neighbours."""
    plan = spatial.window_plan(9, 4, 3, 1, 24, 24)
    assert plan.rows.blocks == ((0, 3), (3, 5), (5, 7), (7, 9))
    assert plan.edges[0] == (24, 18) and plan.rows.width > 0
    for r, want in enumerate(plan.rows.want):
        holders = {j for j, rows in enumerate(plan.rows.pieces(r)) if rows}
        assert holders - {r - 1, r, r + 1}, (r, want)


def test_uneven_blocks_and_the_ceil_row():
    """The pool's 129 rows at 1024x512 split 65/64, the 65-row feature grid
    33/32; the ceil row (128) is the last rank's, whose window reads one
    padding row below the input and two rows of rank 0."""
    assert spatial.split(129, 2) == ((0, 65), (65, 129))
    assert spatial.split(65, 2) == ((0, 33), (33, 65))
    plan = spatial.window_plan(256, 2, 3, 2, 1, 1, ceil=True)
    assert plan.out_height == 129
    assert plan.rows.want[1] == tuple(range(129, 256)) and plan.edges[1] == (0, 2)
    assert plan.rows.want[0] == tuple(range(0, 130)) and plan.edges[0] == (1, 0)


def test_a_rank_without_rows_raises():
    with pytest.raises(ValueError, match="without rows"):
        spatial.window_plan(3, 4, 3, 1, 1, 1)


def test_heights_a_rank_cannot_tell_apart_raise(monkeypatch):
    """The row table refuses two global heights whose blocks have one height
    at some spatial index (65 and 64 over 2 ranks: 32 rows at index 1)."""
    monkeypatch.setitem(distributed._GRID, "sp", 2)
    spatial._HEIGHTS.clear()
    spatial._KNOWN.clear()
    try:
        spatial.register(65)
        with pytest.raises(ValueError, match="tell them apart"):
            spatial.register(64)
        spatial.register(129)
        assert spatial.global_height(65) == 129 and spatial.global_height(33) == 65
    finally:
        spatial._HEIGHTS.clear()
        spatial._KNOWN.clear()


def test_grid_guards(monkeypatch):
    """`spatial_grid` takes a (data, spatial) shape whose product is the
    ranks and whose data axis divides the batch; on a spatial grid
    `resolve` keeps it for the PROTO_ONLINE adapter only and refuses
    OTHERS.TENSOR_PARALLEL beside it."""
    from onda_torch.config import cfg_from_file

    monkeypatch.setattr(distributed, "world", lambda: 4)
    with pytest.raises(ValueError, match="must divide the ranks"):
        mesh.spatial_grid((1, 3))
    with pytest.raises(ValueError, match="does not divide the data axis"):
        mesh.spatial_grid((2, 2), batch_size=3)
    with pytest.raises(ValueError, match="does not combine"):
        distributed.form_grid(2, 2)
    cfg = cfg_from_file("configs/hybrid_switch.yml")
    cfg.TRAINING.BATCH_SIZE = 2
    monkeypatch.setitem(distributed._GRID, "sp", 2)
    monkeypatch.setattr(distributed, "rank", lambda: 3)
    assert (distributed.data_world(), distributed.data_rank()) == (2, 1)
    assert (distributed.spatial_world(), distributed.spatial_rank()) == (2, 1)
    assert (distributed.pixel_world(), distributed.pixel_rank()) == (4, 3)
    assert mesh.resolve(cfg, spatial=True) == (2, 1)
    with pytest.raises(ValueError, match="PROTO_ONLINE bootstrap and fused step only"):
        mesh.resolve(cfg)
    cfg.OTHERS.TENSOR_PARALLEL = 2
    with pytest.raises(ValueError, match="does not combine with the spatial axis"):
        mesh.resolve(cfg, spatial=True)
    cfg.OTHERS.TENSOR_PARALLEL = None
    cfg.TRAINING.BATCH_SIZE = 3
    with pytest.raises(ValueError, match="does not divide the data axis"):
        mesh.resolve(cfg, spatial=True)
    # the adapter's host work that JAX does not run on the axis raises first
    from onda_torch.methods.proto_online import ProtoOnlineAdapter

    for call in (lambda: ProtoOnlineAdapter.evaluate(None, []),
                 lambda: ProtoOnlineAdapter.train(None, None, [], {}),
                 lambda: ProtoOnlineAdapter.test_on_samples(None, {})):
        with pytest.raises(ValueError, match="does not run on a spatial axis"):
            call()
