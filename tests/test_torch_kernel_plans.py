"""The launch plans of the hand-written kernels, on the CPU.

K2 (csrc/bn_stats.cu) takes its geometry from `onda_torch/ops/kernels.py`;
K1 (csrc/pseudo_labels.cu) sizes its persistent grid itself, from the card's
occupancy. These tests replay, in numpy, how each kernel cuts its input: K2's
blocks and their split of every plane piece into a scalar head, a 16-byte
body and a scalar tail, against the tensor's byte offsets; K1's persistent
blocks and their tiles of pixels, for any grid the launch may pick. They
check that every element and every pixel is covered exactly once, that K2's
clusters and grids stay within what the card allows, and that the constants
the K2 plan assumes are the ones in the CUDA source.

The `cuda`-marked test at the end runs the kernels themselves against their
plain versions; it skips without a card. This file imports no JAX, so that
`python -m pytest -m cuda tests/test_torch_kernel_plans.py` runs on the card.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from onda_torch.ops import kernels as K
from onda_torch.ops import prototypes as TP

CSRC = Path(K.__file__).resolve().parents[1] / "csrc"
H100_SMS = 132
K1_TILE = 128  # pixels a block takes at a time (csrc/pseudo_labels.cu: kTile)

# the distinct BatchNorm inputs of DeepLabv2-R50 at batch 4, 1024x512 (NCHW)
R50_BN_SHAPES = [(4, 64, 256, 512), (4, 64, 129, 257), (4, 256, 129, 257), (4, 128, 65, 129),
                 (4, 512, 65, 129), (4, 256, 65, 129), (4, 1024, 65, 129), (4, 2048, 65, 129)]
ODD_SHAPES = [(1, 1, 1, 1), (2, 3, 5, 7), (3, 17, 32, 24), (1, 2048, 65, 129)]
ITEMSIZE = {"f32": 4, "bf16": 2}


def k2_pieces(shape, itemsize, base, plan):
    """Every (start, end) byte interval the kernel reads, as arrays with the
    kind of each (0 head, 1 16-byte body, 2 tail), its channel and the end of
    the plane piece it belongs to."""
    n, c, h, w = shape
    hw, m = h * w, n * h * w
    per_vec = 16 // itemsize
    chans = np.arange(c, dtype=np.int64)
    starts, ends, kinds, owners, piece_ends = [], [], [], [], []
    for r in range(plan.cluster):
        lo, hi = r * plan.span, min((r + 1) * plan.span, m)
        assert lo < hi, f"block {r} of {plan} is empty"
        plane, off = divmod(lo, hw)
        while lo < hi:
            length = min(hw - off, hi - lo)
            start = base + ((plane * c + chans) * hw + off) * itemsize
            mis = start % 16
            head = np.minimum(np.where(mis == 0, 0, (16 - mis) // itemsize), length)
            nvec = (length - head) // per_vec
            cuts = [start, start + head * itemsize, start + (head + nvec * per_vec) * itemsize,
                    start + length * itemsize]
            for kind in range(3):
                starts.append(cuts[kind])
                ends.append(cuts[kind + 1])
                kinds.append(np.full(c, kind))
                owners.append(chans)
                piece_ends.append(cuts[3])
            lo += length
            plane += 1
            off = 0
    return tuple(np.concatenate(a) for a in (starts, ends, kinds, owners, piece_ends))


@pytest.mark.parametrize("base_elems", [0, 1], ids=["aligned", "odd_start"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", R50_BN_SHAPES + ODD_SHAPES, ids=str)
def test_k2_plan_covers_every_element_once(shape, dtype, base_elems):
    itemsize = ITEMSIZE[dtype]
    n, c, h, w = shape
    base = 4096 + base_elems * itemsize  # a plane that starts at an odd element
    plan = K.bn_stats_plan(n, c, h * w, itemsize)
    assert 1 <= plan.cluster <= K.K2_MAX_CLUSTER
    assert (plan.cluster - 1) * plan.span < n * h * w <= plan.cluster * plan.span
    pieces = k2_pieces(shape, itemsize, base, plan)
    keep = pieces[1] > pieces[0]
    order = np.argsort(pieces[0][keep], kind="stable")
    start, end, kind, owner, piece_end = (a[keep][order] for a in pieces)
    # exactly once: the intervals tile the tensor's bytes without gap or overlap
    assert start[0] == base and end[-1] == base + n * c * h * w * itemsize
    np.testing.assert_array_equal(start[1:], end[:-1])
    # each interval lies in one plane, and that plane belongs to its channel
    plane_bytes = h * w * itemsize
    first, last = (start - base) // plane_bytes, (end - 1 - base) // plane_bytes
    np.testing.assert_array_equal(first, last)
    np.testing.assert_array_equal(first % c, owner)
    # 16-byte loads in the body; scalars only before the first boundary and after the last
    body = kind == 1
    assert (start[body] % 16 == 0).all() and ((end[body] - start[body]) % 16 == 0).all()
    assert ((end[~body] - start[~body]) < 16).all()
    head = kind == 0  # a head stops at the first boundary, or takes a piece too short to reach it
    assert ((end[head] % 16 == 0) | (end[head] == piece_end[head])).all()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", R50_BN_SHAPES, ids=str)
def test_k2_plan_fills_the_card(shape, dtype):
    """At every main-path shape: enough blocks for all SMs and none reading
    less than K2_MIN_BLOCK_BYTES. The grid is (cluster, C) with clusters of
    (cluster, 1, 1), so the cluster divides it by construction."""
    itemsize = ITEMSIZE[dtype]
    n, c, h, w = shape
    plan = K.bn_stats_plan(n, c, h * w, itemsize)
    assert plan.cluster <= K.K2_MAX_CLUSTER
    assert plan.cluster * c >= H100_SMS
    smallest = n * h * w - (plan.cluster - 1) * plan.span
    assert min(plan.span, smallest) * itemsize >= K.K2_MIN_BLOCK_BYTES
    assert plan.span % K.K2_SPAN_ALIGN == 0


def test_r50_bn_shapes_are_the_main_path_shapes():
    from onda_torch.models import build_deeplab_v2
    from onda_torch.models.layers import TorchBatchNorm

    with torch.device("meta"):
        model = build_deeplab_v2(19, (3, 4, 6, 3), "ProDA")
    shapes = []
    for mod in model.modules():
        if isinstance(mod, TorchBatchNorm):
            mod.register_forward_pre_hook(lambda m, args: shapes.append(tuple(args[0].shape)))
    model(torch.empty(4, 3, 512, 1024, device="meta"))
    assert len(shapes) == 53
    assert set(shapes) == set(R50_BN_SHAPES)


K1_CASES = [(4 * 65 * 129, 256, 19), (4 * 65 * 129, 256, 1), (4 * 65 * 129, 256, 32),
            (700, 256, 19), (1, 256, 19), (700, 4, 32), (4 * 128 * 256, 768, 19)]
H100_SMEM_BLOCK, H100_SMEM_SM, SMEM_RESERVED = 232448, 233472, 1024  # opt-in, per SM, per block


@pytest.mark.parametrize("n_pix,n_feat,n_cls", K1_CASES)
def test_k1_plan_covers_every_pixel_once(n_pix, n_feat, n_cls):
    """K1's persistent walk covers every pixel once for any grid its launch
    picks: min(tiles, resident blocks a SM * SMs)."""
    tiles = -(-n_pix // K1_TILE)
    for per_sm in (1, 2, 3):
        grid = min(tiles, per_sm * H100_SMS)
        seen = np.zeros(n_pix, np.int64)
        for block in range(grid):  # the walk of csrc/pseudo_labels.cu
            mine = (tiles - 1 - block) // grid + 1  # the kernel's count of its tiles
            walk = list(range(block, tiles, grid))
            assert len(walk) == mine
            for tile in walk:
                rows = np.arange(tile * K1_TILE, min((tile + 1) * K1_TILE, n_pix))
                assert rows.size > 0
                seen[rows] += 1
        np.testing.assert_array_equal(seen, 1)
        if n_pix >= H100_SMS * K1_TILE:
            assert grid >= H100_SMS  # every SM gets a block at the main path's size


def _constants(name):
    text = (CSRC / name).read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", text)}


def k1_smem_bytes(n_feat, n_cls):
    """csrc/pseudo_labels.cu's `smem_bytes`: the scaled prototypes, the
    scale, their norms, the ring of kStages stages and the tile's cross
    products and norms, in f32."""
    k = _constants("pseudo_labels.cu")
    assert "constexpr int kRow = kChunk + 4;" in (CSRC / "pseudo_labels.cu").read_text()
    fpad = -(-n_feat // k["kChunk"]) * k["kChunk"]
    cp = -(-n_cls // 4) * 4
    stage = max(k["kTile"] * (k["kChunk"] + 4), k["kTile"] * (n_cls | 1))
    return 4 * (fpad * cp + fpad + cp + k["kStages"] * stage + k["kTile"] * (cp + 2))


@pytest.mark.parametrize("n_feat,blocks_per_sm", [(256, 2), (768, 1)],
                         ids=["deeplab_f256", "segformer_f768"])
def test_k1_shared_memory_at_the_models_widths(n_feat, blocks_per_sm):
    """A block's shared memory at C = 19 opts in past 48 KB (the launch sets
    cudaFuncAttributeMaxDynamicSharedMemorySize) and stays under the H100's
    227 KB a block: about 104 KiB at DeepLab's F = 256 (two blocks a SM),
    146 KiB at SegFormer's F = 768 (one)."""
    smem = k1_smem_bytes(n_feat, 19)
    assert 48 * 1024 < smem <= H100_SMEM_BLOCK
    assert H100_SMEM_SM // (smem + SMEM_RESERVED) == blocks_per_sm
    assert smem == {256: 106576, 768: 149584}[n_feat]
    assert k1_smem_bytes(2048, 32) > H100_SMEM_BLOCK  # refused: the cuda test's wide case


def test_plan_constants_match_the_sources():
    k1, k2 = _constants("pseudo_labels.cu"), _constants("bn_stats.cu")
    assert (k1["kTile"], k1["kMaxC"]) == (K1_TILE, K.K1_MAX_CLASSES)
    assert (k2["kThreads"], k2["kMaxCluster"]) == (K.K2_THREADS, K.K2_MAX_CLUSTER)


@pytest.mark.cuda
@pytest.mark.parametrize("n_pix,n_cls", [(700, 19), (700, 1), (700, 32), (1, 19)])
def test_cuda_kernels_match_plain(n_pix, n_cls):
    """K1 and K2 on the card against their plain versions, at small and
    adversarial shapes (the full-size check is chip_smoke.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    n_feat = 256
    feat = torch.randn(n_pix, n_feat, device="cuda", generator=g)
    # protos as a row slice of a larger table: 4-byte aligned only
    table = torch.randn(n_cls + 1, n_feat, device="cuda", generator=g).view(-1)[1:]
    protos = table[:n_cls * n_feat].view(n_cls, n_feat)
    prior = torch.rand(n_pix, n_cls, device="cuda", generator=g) + 0.05
    prior = prior / prior.sum(-1, keepdim=True)
    scale = 0.5 + torch.rand(n_feat, device="cuda", generator=g)
    tau = torch.tensor(20.0, device="cuda")
    soft, hard, pmax = K.pseudo_labels(feat, protos, prior, tau, 0.3, scale)
    w_soft, w_hard, w_pmax = TP.pseudo_labels_plain(feat, protos, prior, tau, 0.3, scale)
    torch.testing.assert_close(soft, w_soft, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(pmax, w_pmax, rtol=1e-4, atol=1e-5)
    assert (hard == w_hard).float().mean() > 0.999
    # F = 2048 at C = 32 needs more shared memory than a block may have: refused
    wide = torch.zeros(n_pix, 2048, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA error"):
        K.pseudo_labels(wide, torch.zeros(32, 2048, device="cuda"),
                        torch.full((n_pix, 32), 1 / 32, device="cuda"), tau, 0.3)
    for shape in ((3, 17, 32, 24), (1, 1, 1, 1), (2, 3, 5, 7), (1, 2048, 65, 129)):
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn(shape, device="cuda", generator=g) + 0.5).to(dtype)
            odd = torch.empty(x.numel() + 1, dtype=dtype, device="cuda")[1:].view(shape)
            odd.copy_(x)  # a plane that starts at an odd element
            x64 = x.double()
            w_mean, w_var = x64.mean(dim=(0, 2, 3)), x64.var(dim=(0, 2, 3), unbiased=False)
            amax = x64.abs().max().item()
            for xl in (x, x.contiguous(memory_format=torch.channels_last), odd):
                mean, var = K.bn_stats(xl)
                again = K.bn_stats(xl)
                assert torch.equal(mean, again[0]) and torch.equal(var, again[1])
                # against float64, as chip_smoke.py holds it; where the variance
                # is 0 (one value a channel) only the f32 rounding of x² is left
                torch.testing.assert_close(mean.double(), w_mean, rtol=0, atol=1e-6 * amax)
                torch.testing.assert_close(var.double(), w_var, rtol=1e-4, atol=1e-6 * amax**2)


@pytest.mark.cuda
def test_cuda_k1_at_the_segformer_width():
    """K1 at SegFormer-B5's main path: F = 768 on the 1/4 grid of a b4
    1024x512 batch (P = 131,072), C = 19, against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(1)
    n_pix, n_feat, n_cls = 4 * 128 * 256, 768, 19
    protos = torch.randn(n_cls, n_feat, device="cuda", generator=g)
    pick = torch.randint(0, n_cls, (n_pix,), device="cuda", generator=g)
    feat = protos[pick] + 2.0 * torch.randn(n_pix, n_feat, device="cuda", generator=g)
    prior = torch.rand(n_pix, n_cls, device="cuda", generator=g) + 0.05
    prior = prior / prior.sum(-1, keepdim=True)
    scale = 0.5 + torch.rand(n_feat, device="cuda", generator=g)
    tau = torch.tensor(20.0, device="cuda")
    soft, hard, pmax = K.pseudo_labels(feat, protos, prior, tau, 0.3, scale)
    w_soft, w_hard, w_pmax = TP.pseudo_labels_plain(feat, protos, prior, tau, 0.3, scale)
    torch.testing.assert_close(soft, w_soft, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(pmax, w_pmax, rtol=1e-4, atol=1e-5)
    assert (hard == w_hard).float().mean() > 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("channels_last", [False, True], ids=["nchw", "channels_last"])
def test_cuda_k2_statistics_are_the_variance_of_its_moments(dtype, channels_last):
    """K2's variance is E[x²] − E[x]² of its own raw moments in f64, rounded
    product then difference (no FMA), as `layers.bn_train` takes it from the
    moments under data parallelism: the same bits, here on channels whose
    variance is small beside their mean, where a fused multiply-add's one
    rounding would differ."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(7)
    for shape in [(2, 2048, 5, 5), (4, 256, 9, 9), (3, 17, 33, 25)] * 20:
        c = shape[1]
        spread = 0.02 + 0.5 * torch.rand(1, c, 1, 1, device="cuda", generator=g)
        x = (torch.randn(shape, device="cuda", generator=g) * spread
             + 8 * torch.randn(1, c, 1, 1, device="cuda", generator=g)).to(dtype)
        if channels_last:
            x = x.contiguous(memory_format=torch.channels_last)
        mean, var = K.bn_stats(x)
        raw = K.bn_moments(x)
        assert torch.equal(mean, raw[0].float())
        assert torch.equal(var, torch.clamp(raw[1] - raw[0] * raw[0], min=0.0).float())


# ---------------------------------------------------------------------------
# The BatchNorm passes (csrc/bn_norm.cu): bn_apply_kernel, bn_grad_sums_kernel
# and bn_grad_dx_kernel share one NCHW geometry, `bn_pass_plan`; each block
# splits its plane pieces as K2's do, so K2's replay checks them.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("base_elems", [0, 1], ids=["aligned", "odd_start"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", R50_BN_SHAPES + ODD_SHAPES + [(4, 256, 1, 1), (3, 17, 33, 25)],
                         ids=str)
def test_bn_pass_plan_covers_every_element_once(shape, dtype, base_elems):
    itemsize = ITEMSIZE[dtype]
    n, c, h, w = shape
    base = 4096 + base_elems * itemsize
    plan = K.bn_pass_plan(n, c, h * w, itemsize)
    assert (plan.blocks - 1) * plan.span < n * h * w <= plan.blocks * plan.span
    assert plan.span % K.K2_SPAN_ALIGN == 0
    start, end, kind, owner, _ = k2_pieces(shape, itemsize, base, K.K2Plan(plan.blocks, plan.span))
    keep = end > start
    order = np.argsort(start[keep], kind="stable")
    start, end, kind, owner = (a[keep][order] for a in (start, end, kind, owner))
    assert start[0] == base and end[-1] == base + n * c * h * w * itemsize
    np.testing.assert_array_equal(start[1:], end[:-1])
    plane_bytes = h * w * itemsize
    first = (start - base) // plane_bytes
    np.testing.assert_array_equal(first, (end - 1 - base) // plane_bytes)
    np.testing.assert_array_equal(first % c, owner)
    body = kind == 1
    assert (start[body] % 16 == 0).all() and ((end[body] - start[body]) % 16 == 0).all()


def _fed_bn_shapes(family):
    """The BatchNorm input shapes the port feeds in `family` (chip_smoke.py's
    meta-device walks of the models)."""
    import chip_smoke as CS

    if family == "r50":  # and R101, ProDA-R101: the same shapes, more of them
        return {s for b in (1, 2, 4, 8) for s in CS.bn_input_shapes(torch, batch=b)}
    if family == "deeplab_v3":
        return {s for config in CS.V3_FULL for s in CS.v3_bn_shapes(torch, *config, 4, CS.MAIN_HW)}
    if family == "tensor_parallel":
        return {s for b in (2, 4) for s in CS.bn_input_shapes(torch, batch=b, tp=CS.TP_SIZE)}
    assert family == "spatial"
    return {s for (d, sp), _, _ in CS.SP_GRIDS.values() for r in range(sp)
            for s in CS.bn_input_shapes(torch, batch=CS.SP_BATCH // d, rows=(sp, r))}


@pytest.mark.parametrize("family", ["r50", "deeplab_v3", "tensor_parallel", "spatial"])
def test_bn_pass_plan_fills_the_card(family):
    """At every BatchNorm shape the port feeds, down to the ASPP pooling
    branch's (4, 256, 1, 1): at least a block for every SM, and no block
    under BN_MIN_BLOCK_BYTES where its channel holds more."""
    shapes = _fed_bn_shapes(family)
    if family == "deeplab_v3":
        assert (4, 256, 1, 1) in shapes
    for dtype, itemsize in ITEMSIZE.items():
        for n, c, h, w in shapes:
            plan = K.bn_pass_plan(n, c, h * w, itemsize)
            assert plan.blocks * c >= H100_SMS, (n, c, h, w, dtype, plan)
            channel_bytes = n * h * w * itemsize
            smallest = n * h * w - (plan.blocks - 1) * plan.span
            if channel_bytes >= K.BN_MIN_BLOCK_BYTES:
                assert plan.blocks == 1 or smallest * itemsize >= K.BN_MIN_BLOCK_BYTES / 2
                assert plan.span * itemsize >= K.BN_MIN_BLOCK_BYTES
            assert plan.blocks * c <= 2 * K.BN_TARGET_BLOCKS + c


def test_bn_cl_plan_covers_every_row_once():
    """channels_last: the reduction's chunks of rows tile the N*H*W rows."""
    for m in (1, 1023, 1024, 1025, 4 * 65 * 129):
        plan = K.bn_cl_plan(m)
        rows = np.zeros(m, np.int64)
        for b in range(plan.blocks):
            rows[b * plan.span:min((b + 1) * plan.span, m)] += 1
        np.testing.assert_array_equal(rows, 1)
        assert (plan.blocks - 1) * plan.span < m
    assert K.bn_flat_blocks(1) == 1 and K.bn_flat_blocks(10**9) == K.BN_TARGET_BLOCKS


def test_bn_plan_constants_match_the_source():
    bn = _constants("bn_norm.cu")
    assert (bn["kThreads"], bn["kClChannels"]) == (K.BN_THREADS, K.BN_CL_CHANNELS)


def test_bn_kernel_names_stay_off_the_k1_k2_meters():
    """The benchmark bills device time to K1 and K2 by substrings of kernel
    names; no BatchNorm pass may carry one."""
    text = (CSRC / "bn_norm.cu").read_text()
    names = set(re.findall(r"__global__ void __launch_bounds__\(kThreads\)\s+(\w+)", text))
    assert names == {"bn_apply_kernel", "bn_grad_sums_kernel", "bn_grad_dx_kernel",
                     "bn_apply_cl_kernel", "bn_grad_sums_cl_kernel", "bn_grad_dx_cl_kernel"}
    for name in names:
        for meter in ("bn_stats_cluster_kernel", "stats_cl_kernel", "finalize_kernel",
                      "pseudo_labels_kernel"):
            assert meter not in name
    assert set(K.bn_launches) == {"bn_apply_kernel", "bn_grad_sums_kernel", "bn_grad_dx_kernel"}
    assert set(K.launches) == {"pseudo_labels_kernel", "bn_stats_kernel"}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", R50_BN_SHAPES + [(4, 256, 1, 1), (3, 17, 33, 25), (1, 1, 1, 1)],
                         ids=str)
def test_cuda_bn_passes_match_plain(shape, dtype):
    """bn_apply (train with the running update, and eval), bn_grad_sums and
    bn_grad_dx on the card against their plain versions, at the R50 shapes
    and odd ones, in K2's four layouts: chip_smoke.py phase 4's check, whose
    docstring gives each tolerance and its reason."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import chip_smoke as CS

    x, dy, gamma, beta, rm, rv = CS.bn_case(torch, shape, torch.Generator(device="cuda").manual_seed(3))
    CS.check_bn_once(torch, K, x.to(dtype), dy.to(dtype), gamma, beta, rm, rv, f"{shape} {dtype}")
