"""The two CUDA kernels of mmnc_tpu_torch against their plain versions on
the card. Marked `cuda`: they skip where no CUDA device is present (a
CUDA kernel has no interpret mode). On a host with an H100:

    python -m pytest tests/test_torch_cuda.py -m cuda

Tolerance: float32 sums over up to 25*300 products taken in another order
than cuBLAS/cuDNN, so 1e-4 relative to the largest output. The model
tests at the end hold the card's integers (symbols, indexes, stream
bytes) exactly equal to the CPU port's, and a train step on the card
to the CPU port's (logs within rtol 1e-4, each gradient within 1e-3 x
max|g_cpu| of its tensor, as chip_smoke.py's phase 7). The graph tests
hold a K-step call replayed as one CUDA graph to eager steps (within
1e-6 x max|p|, chip_smoke's bound), find its GDN launches among the
profiler's records of the graph, and check that a step that cannot be
captured raises. The card's Adam (capturable) is held to the CPU port's
(not capturable) on the card's own gradients, graphed and eager, within
rtol 1e-4 / atol 1e-6, and a checkpoint the card writes resumes on the
CPU and back. The serving programs' graphs (`graphs.py`) are held to
their eager programs bitwise under deterministic cuDNN, at the bench's
rgb width and at shared4, in float32 and bf16, also after an Adam step
and a `load_state_dict` changed the parameters in place, and a captured
deconv+IGDN launch (split and tiled plans, and bf16 on the tensor cores)
to an eager one. deconv+IGDN's bf16 path on the tensor cores ("tiled_mma")
and the CUDA-core tiled path at the same shapes are held stage by stage
as chip_smoke holds them (`check_deconv_bf16`), and a "tiled_mma" plan
with float32 x or without a kernel raises.
"""

import contextlib

import numpy as np
import pytest
import torch

import chip_smoke
from mmnc_tpu_torch import build_model, graphs
from mmnc_tpu_torch.models.streaming import stream_roundtrip
from mmnc_tpu_torch.ops.deconv_igdn import (deconv_igdn_cuda,
                                            deconv_igdn_plain, launch_plan,
                                            tile_shape)
from mmnc_tpu_torch.ops.gdn import (MAX_CHANNELS, GDNBackwardPlan,
                                   GDNFunction, GDNPlan, gdn,
                                   gdn_backward_cuda, gdn_backward_plain,
                                   gdn_backward_plan, gdn_cuda, gdn_plain,
                                   gdn_plan)
from mmnc_tpu_torch.train import (create_train_state, make_eval_step,
                                  make_train_step)
from mmnc_tpu_torch.weights import scale_conv_kernels

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want):
    err = (got - want).abs().max().item()
    assert err <= 1e-4 * max(1.0, want.abs().max().item()), err


@pytest.mark.parametrize("n,c", [(1000, 3), (4099, 50), (777, 100),
                                 (64, 128), (5, 100)])
@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_kernel_matches_plain(device, n, c, inverse):
    g = torch.Generator(device="cpu").manual_seed(n + c)
    x = torch.randn(n, c, generator=g).to(device)
    gamma = (0.1 * torch.eye(c) + 0.01 * torch.rand(c, c, generator=g)).to(device)
    beta = (1 + 0.1 * torch.rand(c, generator=g)).to(device)
    before = gdn_cuda.launches
    got = gdn(x, gamma, beta, inverse)
    assert gdn_cuda.launches == before + 1
    _close(got, gdn_plain(x, gamma, beta, inverse))


def _gdn_inputs(device, n, c, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(n, c, generator=g).to(device)
    gamma = (0.1 * torch.eye(c) + 0.01 * torch.rand(c, c, generator=g)).to(device)
    beta = (1 + 0.1 * torch.rand(c, generator=g)).to(device)
    return x, gamma, beta


@pytest.mark.parametrize("n", [1, 5, 8, 4099])
@pytest.mark.parametrize("c", [3, 37, 50, 100, 128])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("variant", [None, "rows", "split"])
def test_gdn_kernel_plans_match_plain(device, n, c, inverse, variant):
    """Every plan variant at ragged row counts, N below one warp's rows,
    and C below, at and above the path's: each instantiation (C padded to
    4, 52, 100, 128, and the generic one at 37); two launches are bitwise
    equal (no atomics, no split of the input channels)."""
    x, gamma, beta = _gdn_inputs(device, n, c, n * c)
    plan = gdn_plan(n, c, variant)
    got = gdn_cuda(x, gamma, beta, inverse, plan=plan)
    again = gdn_cuda(x, gamma, beta, inverse, plan=plan)
    torch.cuda.synchronize()
    _close(got, gdn_plain(x, gamma, beta, inverse))
    assert torch.equal(got, again)


# one compress + decompress of one 256 px image: the head and g_a at
# 256**2 / 4**s rows, IGDN of the decoder head at 32x32 and 64x64
_GDN_PATH_BATCH_1 = ([(65536, 50, False)]
                     + [(4 ** (8 - s), 100, False) for s in range(1, 9)]
                     + [(1024, 50, True), (4096, 50, True)])


@pytest.mark.parametrize("n,c,inverse", _GDN_PATH_BATCH_1)
def test_gdn_kernel_path_shapes_match_plain(device, n, c, inverse):
    x, gamma, beta = _gdn_inputs(device, n, c, n)
    got = gdn_cuda(x, gamma, beta, inverse)
    again = gdn_cuda(x, gamma, beta, inverse)
    torch.cuda.synchronize()
    _close(got, gdn_plain(x, gamma, beta, inverse))
    assert torch.equal(got, again)


@pytest.mark.parametrize("plan", [
    GDNPlan(8, 64, 112, 5, 2), GDNPlan(8, 64, 112, 5, 3),
    GDNPlan(8, 64, 112, 5, 4), GDNPlan(8, 64, 28, 4, 2),
    GDNPlan(2, 32, 56, 7, 4), GDNPlan(2, 16, 84, 2, 2),
    GDNPlan(2, 128, 28, 3, 3), GDNPlan(8, 64, 112, 40, 2)])
def test_gdn_kernel_rings_and_slices_match_plain(device, plan):
    """Blocks that walk many tiles through rings of 2-4 stages, blocks
    with one tile beside blocks with two (47 tiles over 40 blocks), and
    slices that do not divide C (100 over 56 and 84)."""
    x, gamma, beta = _gdn_inputs(device, 3001, 100, 11)
    got = gdn_cuda(x, gamma, beta, False, plan=plan)
    torch.cuda.synchronize()
    _close(got, gdn_plain(x, gamma, beta, False))


def test_gdn_kernel_takes_rows_off_16_byte_boundaries(device):
    x, gamma, beta = _gdn_inputs(device, 77, 50, 5)
    shifted = torch.empty(x.numel() + 1, device=device)[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16
    got = gdn_cuda(shifted, gamma, beta, True)
    torch.cuda.synchronize()
    _close(got, gdn_plain(x, gamma, beta, True))


def _deconv_inputs(device, shape, cout, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    cin = shape[-1]
    x = torch.randn(*shape, generator=g).to(device)
    w = (torch.rand(5, 5, cin, cout, generator=g) * 2 - 1).to(device) \
        / (25 * cin) ** 0.5
    b = (0.1 * torch.randn(cout, generator=g)).to(device)
    gamma = (0.1 * torch.eye(cout)
             + 0.01 * torch.rand(cout, cout, generator=g)).to(device)
    beta = (1 + 0.1 * torch.rand(cout, generator=g)).to(device)
    return x, w, b, gamma, beta


# the multi-task heads' narrow widths (Cout 1, 3, 10, 17, 21 from Cin 21,
# 42, 120) on ragged inputs, batch 1 and 2
_NARROW_DECONVS = [((b, h, w, cin), cout)
                   for cin in (21, 42, 120) for cout in (1, 3, 10, 17, 21)
                   for b, h, w in ((1, 5, 7), (2, 17, 17))]


@pytest.mark.parametrize("shape,cout", [((2, 1, 1, 100), 100),
                                        ((2, 2, 2, 100), 100),
                                        ((3, 5, 6, 100), 100),
                                        ((2, 8, 8, 100), 50),
                                        ((1, 13, 9, 50), 3),
                                        ((1, 17, 33, 3), 3)]
                         + _NARROW_DECONVS)
@pytest.mark.parametrize("mode", ["igdn", "gdn", None])
@pytest.mark.parametrize("tiled", [False, True])
def test_deconv_igdn_kernel_matches_plain(device, shape, cout, mode, tiled):
    """The launch plan's variant, and the tiled variant at every shape
    (the small shapes' plan is the split one); two launches are bitwise
    equal."""
    x, w, b, gamma, beta = _deconv_inputs(device, shape, cout, cout)
    plan = ("tiled", *tile_shape(*shape, cout), 1) if tiled else None
    got = deconv_igdn_cuda(x, w, b, gamma, beta, mode, plan=plan)
    again = deconv_igdn_cuda(x, w, b, gamma, beta, mode, plan=plan)
    torch.cuda.synchronize()
    _close(got, deconv_igdn_plain(x, w, b, gamma, beta, mode))
    assert torch.equal(got, again)


@pytest.mark.parametrize("shape,cout", [((8, 1, 1, 128), 100),
                                        ((8, 2, 2, 100), 100),
                                        ((1, 3, 3, 100), 100),
                                        ((2, 4, 4, 50), 64),
                                        ((1, 1, 1, 128), 100),
                                        ((1, 2, 2, 100), 100)])
@pytest.mark.parametrize("mode", ["igdn", "gdn", None])
def test_deconv_igdn_split_path_matches_plain(device, shape, cout, mode):
    """The cluster split-K path at the latent stages' shapes and at shapes
    whose Cin the cluster size does not divide; two launches are bitwise
    equal (the partial sums are added in rank order)."""
    assert launch_plan(*shape, cout)[0] == "split"
    x, w, b, gamma, beta = _deconv_inputs(device, shape, cout, cout)
    got = deconv_igdn_cuda(x, w, b, gamma, beta, mode)
    again = deconv_igdn_cuda(x, w, b, gamma, beta, mode)
    torch.cuda.synchronize()
    _close(got, deconv_igdn_plain(x, w, b, gamma, beta, mode))
    assert torch.equal(got, again)


@pytest.mark.parametrize("shape,cout,plan", [
    ((1, 3, 3, 100), 100, ("split", 2, 2, 8)),
    ((2, 5, 6, 50), 64, ("split", 4, 4, 2)),
    ((8, 4, 4, 100), 100, ("split", 4, 4, 8)),
    ((3, 2, 3, 3), 40, ("split", 1, 1, 8))])
def test_deconv_igdn_split_tiles_match_plain(device, shape, cout, plan):
    """Every tile size of the split kernel, ragged tiles and ranks with
    no input channel (Cin 3 over 8) included."""
    x, w, b, gamma, beta = _deconv_inputs(device, shape, cout, 7)
    got = deconv_igdn_cuda(x, w, b, gamma, beta, "igdn", plan=plan)
    torch.cuda.synchronize()
    _close(got, deconv_igdn_plain(x, w, b, gamma, beta, "igdn"))


def test_deconv_igdn_split_takes_weights_off_16_byte_boundaries(device):
    x, w, b, gamma, beta = _deconv_inputs(device, (2, 2, 2, 100), 100, 3)
    shifted = torch.empty(w.numel() + 1, device=device)[1:].view(w.shape)
    shifted.copy_(w)
    assert shifted.data_ptr() % 16
    got = deconv_igdn_cuda(x, shifted, b, gamma, beta, "igdn",
                           plan=("split", 2, 2, 8))
    torch.cuda.synchronize()
    _close(got, deconv_igdn_plain(x, w, b, gamma, beta, "igdn"))


def test_kernel_wrappers_raise_on_unsupported_input(device):
    x = torch.randn(8, 200, device=device)
    with pytest.raises(ValueError):
        gdn_cuda(x.double()[:, :4], torch.eye(4, device=device).double(),
                 torch.ones(4, device=device).double(), False)
    x, gamma, beta = _gdn_inputs(device, 64, 100, 0)
    for plan in (GDNPlan(3, 128, 112, 1, 2), GDNPlan(8, 100, 112, 1, 2),
                 GDNPlan(8, 128, 100, 1, 2), GDNPlan(8, 128, 112, 0, 2),
                 GDNPlan(8, 128, 112, 1, 5), GDNPlan(8, 256, 112, 1, 2),
                 GDNPlan(2, 8, 28, 1, 2)):
        with pytest.raises(ValueError):
            gdn_cuda(x, gamma, beta, False, plan=plan)
    x, w, b, gamma, beta = _deconv_inputs(device, (1, 2, 2, 8), 8, 0)
    for plan in (("split", 1, 1, 16), ("split", 1, 2, 4), ("split", 3, 3, 4),
                 ("tiled", 1, 1, 2), ("other", 1, 1, 1)):
        with pytest.raises(ValueError):
            deconv_igdn_cuda(x, w, b, gamma, beta, "igdn", plan=plan)


@pytest.mark.parametrize("n", [5, 777, 4099, 32768])
@pytest.mark.parametrize("c", [168, 192, 300])
@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_kernel_wide_channels_match_plain(device, n, c, inverse):
    """C above 128: channel-sliced plans of the generic instantiation; two
    launches are bitwise equal."""
    x, gamma, beta = _gdn_inputs(device, n, c, n + c)
    before = gdn_cuda.launches
    got = gdn(x, gamma, beta, inverse)
    again = gdn(x, gamma, beta, inverse)
    torch.cuda.synchronize()
    assert gdn_cuda.launches == before + 2
    _close(got, gdn_plain(x, gamma, beta, inverse))
    assert torch.equal(got, again)


@pytest.mark.parametrize("n", [5, 777, 4099])
@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_kernel_at_max_channels_matches_plain(device, n, inverse):
    """C = MAX_CHANNELS, the widest C any plan fits: blocks of 16 rows x
    28 output channels over all C input channels, in all but 192 of the
    231,424 bytes of shared memory a block may have."""
    x, gamma, beta = _gdn_inputs(device, n, MAX_CHANNELS, n)
    plan = gdn_plan(n, MAX_CHANNELS)
    assert (plan.tile_rows, plan.slice) == (16, 28)
    got = gdn_cuda(x, gamma, beta, inverse, plan=plan)
    again = gdn_cuda(x, gamma, beta, inverse, plan=plan)
    torch.cuda.synchronize()
    _close(got, gdn_plain(x, gamma, beta, inverse))
    assert torch.equal(got, again)


@pytest.mark.parametrize("shape,cout,tile", [((9, 16, 16, 570), 570, (4, 4)),
                                             ((8, 4, 4, 1024), 1024, (1, 4))])
def test_deconv_igdn_widest_tiles_match_plain(device, shape, cout, tile):
    """The "tiled_l2" plan where its tile alone nearly fills shared
    memory: 4x4 tiles at Cin = Cout = 570 (230,280 of 231,424 bytes), 1x4
    tiles at 1024."""
    plan = launch_plan(*shape, cout)
    assert plan == ("tiled_l2", *tile, 1)
    x, w, b, gamma, beta = _deconv_inputs(device, shape, cout, cout)
    got = deconv_igdn_cuda(x, w, b, gamma, beta, "igdn")
    torch.cuda.synchronize()
    _close(got, deconv_igdn_plain(x, w, b, gamma, beta, "igdn"))


@pytest.mark.parametrize("shape,cout,plan", [
    ((8, 1, 1, 128), 300, None), ((2, 2, 2, 300), 300, None),
    ((3, 4, 5, 300), 300, None), ((2, 9, 7, 150), 300, ("tiled_l2", 2, 4, 1)),
    ((2, 4, 4, 192), 192, ("tiled", 4, 4, 1))])
@pytest.mark.parametrize("mode", ["igdn", "gdn", None])
def test_deconv_igdn_wide_cout_matches_plain(device, shape, cout, plan, mode):
    """Cout = 300 reads gamma from global memory ("tiled_l2"); the 4x4 tile
    at Cin = Cout = 192 holds gamma in 225,024 bytes of shared memory."""
    if plan is None:
        assert launch_plan(*shape, cout)[0] == "tiled_l2"
    x, w, b, gamma, beta = _deconv_inputs(device, shape, cout, cout)
    got = deconv_igdn_cuda(x, w, b, gamma, beta, mode, plan=plan)
    torch.cuda.synchronize()
    _close(got, deconv_igdn_plain(x, w, b, gamma, beta, mode))


def _seeded_pair(device):
    """The c=4, m=8 codec from one seed on the CPU and on the card (the
    same weights: drawn on the CPU), conv kernels scaled so the symbols
    are not all zero, and the same coding tables."""
    models = []
    for dev in ("cpu", device):
        model = scale_conv_kernels(build_model(1, ["rgb"], latent_channels=8,
                                               conv_channels=4, device=dev,
                                               seed=3))
        model.update_bottleneck_values()
        models.append(model)
    batch = {"rgb": np.random.default_rng(4).random(
        (2, 256, 256, 3)).astype(np.float32)}
    return models, batch


def test_card_integers_and_stream_equal_the_cpu_port(device):
    """Symbols, indexes and packed stream bytes on the card equal the CPU
    port's (which tests/test_torch_codec.py holds equal to the JAX
    package's), and the CPU decodes the card's stream to what it decodes
    from its own."""
    (cpu, card), batch = _seeded_pair(device)
    want = [t.numpy() for t in cpu._compress_device(batch)]
    got = [t.cpu().numpy() for t in card._compress_device(batch)]
    for name, g, w in zip(("y", "z", "indexes"), got, want):
        mismatches = int((g != w).sum())
        assert mismatches == 0, f"{name}: {mismatches} of {w.size} differ"
    assert (want[0] != 0).any()
    ans_cpu, n_cpu = cpu.compress(batch)
    ans_card, n_card = card.compress(batch)
    assert n_card == n_cpu and ans_card["strings"] == ans_cpu["strings"]
    np.testing.assert_array_equal(cpu.decompress(ans_card)["rgb"].numpy(),
                                  cpu.decompress(ans_cpu)["rgb"].numpy())
    np.testing.assert_allclose(card.decompress(ans_card)["rgb"].cpu().numpy(),
                               cpu.decompress(ans_cpu)["rgb"].numpy(),
                               rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("impl", ["v2", "v1"])
def test_card_stream_equals_its_compress(device, impl):
    """stream_roundtrip on the card (pinned slots, a copy stream, coder
    threads) against its compress/decompress, batch by batch."""
    (_, card), batch = _seeded_pair(device)
    rng = np.random.default_rng(5)
    batches = [{"rgb": torch.from_numpy(rng.random(
        (2, 256, 256, 3), dtype=np.float32)).to(device)} for _ in range(5)]
    results = list(stream_roundtrip(card, batches, depth=2, impl=impl))
    torch.cuda.synchronize()
    for b, (x_hats, n_bytes) in zip(batches, results):
        ans, n_ref = card.compress(b)
        assert n_bytes == n_ref
        ref = card.decompress(ans)["rgb"]
        assert (x_hats["rgb"] - ref).abs().max().item() <= 1e-5


@pytest.mark.parametrize("c", [3, 50, 100])
@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_backward_on_card_matches_cpu_closed_form(device, c, inverse):
    """GDNFunction on the card (the kernel forward, the closed-form
    backward in torch) against the CPU's plain forward and closed form."""
    x, gamma, beta = _gdn_inputs(torch.device("cpu"), 4099, c, c)
    w = torch.randn(4099, c, generator=torch.Generator().manual_seed(c))
    grads = []
    for dev in ("cpu", device):
        args = [a.detach().to(dev).requires_grad_(True) for a in (x, gamma, beta)]
        before = gdn_cuda.launches
        out = GDNFunction.apply(*args, inverse)
        assert gdn_cuda.launches == before + (str(dev) != "cpu")
        before = gdn_backward_cuda.launches
        torch.sum(torch.sin(out) * w.to(dev)).backward()
        assert gdn_backward_cuda.launches == before + (str(dev) != "cpu")
        grads.append([a.grad.cpu() for a in args])
    for got, want in zip(grads[1], grads[0]):
        _close(got, want)


def _backward_inputs(device, n, c, seed, dtype=torch.float32):
    """x, the gradient g, gamma, beta; for bf16 x and g in bf16 and gamma
    rounded to bf16 values held in float32, as the bf16 layer has them."""
    x, gamma, beta = _gdn_inputs(device, n, c, seed)
    g = torch.randn(n, c, generator=torch.Generator().manual_seed(seed + 1))
    g = g.to(device)
    if dtype == torch.bfloat16:
        x, g, gamma = x.to(dtype), g.to(dtype), gamma.to(dtype).float()
    return x, g, gamma, beta


def _check_backward(x, g, gamma, beta, inverse, plan=None):
    """The backward kernel against gdn_backward_plain (dx, dgamma, dbeta
    within 1e-4 x max(1, |plain|max) each, a bf16 dx 2^-7) and a second
    launch bitwise equal; one launch counted each."""
    before = gdn_backward_cuda.launches
    got = gdn_backward_cuda(x, g, gamma, beta, inverse, plan=plan)
    again = gdn_backward_cuda(x, g, gamma, beta, inverse, plan=plan)
    torch.cuda.synchronize()
    assert gdn_backward_cuda.launches == before + 2
    want = gdn_backward_plain(x, g, gamma, beta, inverse)
    for k, (a, w) in enumerate(zip(got, want)):
        assert a.dtype == w.dtype and a.shape == w.shape
        tol = 2.0 ** -7 if k == 0 and x.dtype == torch.bfloat16 else 1e-4
        err = (a.float() - w.float()).abs().max().item()
        assert err <= tol * max(1.0, w.float().abs().max().item()), (k, err)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# the train path's C (rgb: 3, 50, 100; shared4: 1, 10, 17, 21, 42, 168),
# ragged row counts, fewer rows than a tile, and the forward's widest C
_BACKWARD_SHAPES = [(4099, 1), (4099, 3), (1031, 10), (1031, 17),
                    (4099, 21), (1031, 42), (4099, 50), (777, 100),
                    (333, 168), (5, 100), (1, 3), (257, MAX_CHANNELS)]


@pytest.mark.parametrize("n,c", _BACKWARD_SHAPES)
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gdn_backward_kernel_matches_plain(device, n, c, inverse, dtype):
    _check_backward(*_backward_inputs(device, n, c, n + c, dtype), inverse)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gdn_backward_kernel_takes_unaligned_rows_and_strided_gradients(
        device, dtype):
    """x a view 4 bytes off a 16-byte boundary (the kernel loads scalars),
    g the transpose of a contiguous tensor (the wrapper copies it)."""
    n, c = 1031, 50
    x, g, gamma, beta = _backward_inputs(device, n, c, 11, dtype)
    base = torch.empty(n * c + 8, device=device, dtype=dtype)
    off = base[2:2 + n * c].view(n, c)
    off.copy_(x)
    assert off.data_ptr() % 16
    strided = g.t().contiguous().t()
    assert not strided.is_contiguous()
    _check_backward(off, strided, gamma, beta, False)
    _check_backward(off, strided, gamma, beta, True)


@pytest.mark.parametrize("c,plan", [
    (100, GDNBackwardPlan(4, 64, 5, True)),
    (100, GDNBackwardPlan(2, 16, 7, True)),
    (100, GDNBackwardPlan(4, 32, 3, False)),
    (100, GDNBackwardPlan(2, 32, 4, False)),
    (100, GDNBackwardPlan(2, 64, 9, True)),
    (50, GDNBackwardPlan(2, 64, 5, True, 1)),
    (50, GDNBackwardPlan(2, 32, 7, True, 2)),
    (21, GDNBackwardPlan(2, 32, 6, True, 3)),
    (3, GDNBackwardPlan(2, 128, 4, True, 8)),
    (100, GDNBackwardPlan(2, 64, 9, True, 1, 512)),
    (90, GDNBackwardPlan(2, 64, 4, True, 1, 512)),
    (100, GDNBackwardPlan(2, 32, 9, True, 0, 512, True)),
    (100, GDNBackwardPlan(2, 16, 7, True, 0, 512, True)),
    (50, GDNBackwardPlan(2, 64, 5, True, 0, 256, True)),
    (50, GDNBackwardPlan(2, 16, 7, True, 0, 512, True)),
    (63, GDNBackwardPlan(2, 32, 5, True, 0, 256, True)),
    (127, GDNBackwardPlan(2, 16, 6, True, 0, 512, True)),
    (21, GDNBackwardPlan(2, 64, 3, True, 0, 256, True)),
    (3, GDNBackwardPlan(2, 48, 4, True, 0, 256, True))])
@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_backward_kernel_forced_plans_match_plain(device, c, plan,
                                                      inverse):
    """Each instantiation (2 and 4 rows a thread, gamma in shared or in
    global memory, P3's sums added each tile or kept by 1-8 warps a warp
    tile, 256 or 512 threads; the tensor cores at 256 and 512 threads,
    tiles of 16-64 rows, C from 3 to 127) with blocks walking several
    tiles each."""
    _check_backward(*_backward_inputs(device, 1031, c, 5), inverse,
                    plan=plan)


def test_gdn_backward_kernel_refuses_what_it_has_no_kernel_for(device):
    x, g, gamma, beta = _backward_inputs(device, 64, 10, 3)
    for args in ((x.half(), g.half(), gamma, beta),
                 (x, g.to(torch.bfloat16), gamma, beta),
                 (x, g, gamma.double(), beta), (x, g[:-1], gamma, beta),
                 (x.cpu(), g, gamma, beta)):
        with pytest.raises(ValueError):
            gdn_backward_cuda(*args, False)
    for plan in (GDNBackwardPlan(4, 48, 1, True),
                 GDNBackwardPlan(2, 40, 1, True, 0, 256, True)):
        with pytest.raises(ValueError):
            gdn_backward_cuda(x, g, gamma, beta, False, plan=plan)


def _tensor_core_train_shapes():
    """(rows, C, inverse, dtype) of every distinct (I)GDN of the rgb train
    step at 16 in float32 and bf16 and of shared4's at 16 and 2 in float32
    whose backward the plan gives the tensor cores."""
    lay = chip_smoke.paper_layout(*chip_smoke.PAPER["shared4"])
    rgb = chip_smoke.gdn_train_shapes(chip_smoke.TRAIN_BATCH)
    f32 = set(rgb + chip_smoke.mt_gdn_shapes(lay, 16, train=True)
              + chip_smoke.mt_gdn_shapes(lay, 2, train=True))
    return ([(n, c, inv, torch.float32) for n, c, inv in sorted(f32)
             if gdn_backward_plan(n, c).mma]
            + [(n, c, inv, torch.bfloat16) for n, c, inv in sorted(set(rgb))
               if gdn_backward_plan(n, c).mma])


@pytest.mark.parametrize("n,c,inverse,dtype", _tensor_core_train_shapes())
def test_gdn_backward_tensor_cores_match_plain_at_train_shapes(
        device, n, c, inverse, dtype):
    """The tensor-core path (3xTF32) under its plan at every rgb, bf16 and
    shared4 train shape it takes: dx, dgamma and dbeta within 1e-4 x
    max(1, |plain|max) (a bf16 dx 2^-7), bitwise repeatable."""
    _check_backward(*_backward_inputs(device, n, c, n + c, dtype), inverse)


@pytest.mark.parametrize("n", [4099, 333])
@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_backward_at_c655_takes_the_cuda_cores(device, n, inverse):
    """At C = 655 split gamma does not fit a block: the plan stays on the
    CUDA cores (gamma from global memory) and matches the plain
    version."""
    plan = gdn_backward_plan(n, MAX_CHANNELS)
    assert not plan.mma and not plan.smem_gamma
    _check_backward(*_backward_inputs(device, n, MAX_CHANNELS, n), inverse)


def _train_models(device):
    """The c=4, m=8 codec from one seed on the CPU and on the card, conv
    kernels scaled (non-trivial y and z), lmbda 1e-2."""
    return [scale_conv_kernels(build_model(
        1, ["rgb"], latent_channels=8, conv_channels=4, lmbda=1e-2,
        device=dev, seed=3)) for dev in ("cpu", device)]


def _train_inputs(model, device):
    rng = np.random.default_rng(6)
    batch = {"rgb": torch.from_numpy(rng.random(
        (2, 256, 256, 3), dtype=np.float32)).to(device)}
    noise = {k: torch.from_numpy(rng.uniform(-0.5, 0.5, s).astype(
        np.float32)).to(device) for k, s in model.latent_shapes(batch).items()}
    return batch, noise


def test_train_step_on_card_matches_cpu_port(device):
    got = []
    for model in _train_models(device):
        batch, noise = _train_inputs(model, model.device)
        state = create_train_state(model, 10, 1e-4, 1e-3)
        _, logs = make_train_step(model, clip_norm=5.0)(state, batch,
                                                        noise=noise)
        got.append(({k: v.item() for k, v in logs.items()},
                    {n: p.grad.cpu() for n, p in model.named_parameters()}))
    (logs_c, grads_c), (logs_g, grads_g) = got
    assert set(logs_g) == set(logs_c)
    for key, want in logs_c.items():
        np.testing.assert_allclose(logs_g[key], want, rtol=1e-4, err_msg=key)
    for name, want in grads_c.items():
        err = (grads_g[name] - want).abs().max().item()
        assert err <= 1e-3 * want.abs().max().item(), (name, err)


def test_train_remat_and_eval_launch_counts(device):
    """18 GDN launches and no deconv+IGDN a train step (the forward runs
    unfused under grad), 36 with remat (the backward recomputes the
    forward), 11 GDN and 7 deconv+IGDN an eval step (decode fused)."""
    _, model = _train_models(device)
    batch, noise = _train_inputs(model, device)
    state = create_train_state(model, 10, 1e-4, 1e-3)
    for remat, want in ((False, 18), (True, 36)):
        step = make_train_step(model, remat=remat)
        gdn0, dec0 = gdn_cuda.launches, deconv_igdn_cuda.launches
        step(state, batch, noise=noise)
        torch.cuda.synchronize()
        assert (gdn_cuda.launches - gdn0, deconv_igdn_cuda.launches - dec0) \
            == (want, 0)
    gdn0, dec0 = gdn_cuda.launches, deconv_igdn_cuda.launches
    logs = make_eval_step(model)(batch)
    assert (gdn_cuda.launches - gdn0, deconv_igdn_cuda.launches - dec0) \
        == (11, 7)
    assert all(torch.isfinite(v).item() for v in logs.values())


# the multi-task codecs' new widths: GDN at the upsample stacks' 10, the
# heads' 21 and 42 (shared4: conv 42, four tasks), one-channel depth and
# the 17 semantic logits (unfused in a train step)
@pytest.mark.parametrize("n", [5, 4099, 32768, 524288])
@pytest.mark.parametrize("c", [1, 10, 17, 21, 42])
@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_kernel_multitask_widths_match_plain(device, n, c, inverse):
    x, gamma, beta = _gdn_inputs(device, n, c, n + c)
    got = gdn_cuda(x, gamma, beta, inverse)
    again = gdn_cuda(x, gamma, beta, inverse)
    torch.cuda.synchronize()
    _close(got, gdn_plain(x, gamma, beta, inverse))
    assert torch.equal(got, again)


# deconv+IGDN at the multi-task decode's new shapes: depth's Cin = Cout =
# 1, semantic's 21 -> 17 logits, shared4's first upsample stage (120 -> 10
# at 1x1, one 1x1 tile a block) and the mixed paper config's g_s (300 ->
# 96, split), its 16x16 head stage on 2x4 tiles
@pytest.mark.parametrize("shape,cout", [((8, 128, 128, 1), 1),
                                        ((8, 64, 64, 21), 17),
                                        ((8, 128, 128, 17), 17),
                                        ((8, 1, 1, 120), 10),
                                        ((8, 4, 4, 10), 10),
                                        ((8, 1, 1, 300), 96),
                                        ((8, 4, 4, 96), 96),
                                        ((8, 16, 16, 96), 48)])
@pytest.mark.parametrize("mode", ["igdn", None])
def test_deconv_igdn_multitask_shapes_match_plain(device, shape, cout, mode):
    x, w, b, gamma, beta = _deconv_inputs(device, shape, cout, cout)
    got = deconv_igdn_cuda(x, w, b, gamma, beta, mode)
    torch.cuda.synchronize()
    _close(got, deconv_igdn_plain(x, w, b, gamma, beta, mode))
    assert torch.equal(got, deconv_igdn_cuda(x, w, b, gamma, beta, mode))


@pytest.mark.parametrize("lo,hi", [(60, 120), (240, 300), (0, 60)])
def test_deconv_igdn_takes_a_channel_slice_of_channels_last(device, lo, hi):
    """A disjoint head's input: a channel slice of y_hat (NCHW in
    channels_last memory), seen as NHWC, is not contiguous; the wrapper
    copies it before the launch."""
    y = torch.randn(8, 300, 1, 1, generator=torch.Generator().manual_seed(lo)
                    ).to(device).contiguous(memory_format=torch.channels_last)
    x = y[:, lo:hi].permute(0, 2, 3, 1)
    assert not x.is_contiguous()
    _, w, b, gamma, beta = _deconv_inputs(device, (8, 1, 1, hi - lo), 10, 1)
    before = deconv_igdn_cuda.launches
    got = deconv_igdn_cuda(x, w, b, gamma, beta, "igdn")
    torch.cuda.synchronize()
    assert deconv_igdn_cuda.launches == before + 1
    _close(got, deconv_igdn_plain(x.contiguous(), w, b, gamma, beta, "igdn"))


def test_shared4_card_integers_and_stream_equal_the_cpu_port(device):
    """The paper's shared4 (model 4, four tasks, latent 300, conv 42) on
    one 256 px image from one seed, conv kernels scaled: the card's
    symbols, indexes and packed stream bytes (full and per slice) equal
    the CPU port's, and its partial decode is within rtol 1e-3 / atol
    1e-4 of the CPU's."""
    tasks = ["rgb", "depth_euclidean", "normal", "semantic"]
    models = []
    for dev in ("cpu", device):
        model = scale_conv_kernels(build_model(4, tasks, 300, 42, device=dev,
                                               seed=0))
        model.update_bottleneck_values()
        models.append(model)
    cpu, card = models
    batch = cpu.example_batch(1, seed=2)
    want = [t.numpy() for t in cpu._compress_device(batch)]
    got = [t.cpu().numpy() for t in card._compress_device(batch)]
    for name, g, w in zip(("y", "z", "indexes"), got, want):
        mismatches = int((g != w).sum())
        assert mismatches == 0, f"{name}: {mismatches} of {w.size} differ"
    assert (want[0] != 0).any() and (want[1] != 0).any()
    assert card.compress(batch)[0] == cpu.compress(batch)[0]
    ans_card, _ = card.compress_partial(batch)
    assert ans_card == cpu.compress_partial(batch)[0]
    got = card.decompress_tasks(ans_card, ["semantic", "depth_euclidean"])
    want = cpu.decompress_tasks(ans_card, ["semantic", "depth_euclidean"])
    for task in want:
        np.testing.assert_allclose(got[task].cpu().numpy(),
                                   want[task].numpy(), rtol=1e-3, atol=1e-4)


# --- the data pipeline and the loop on the card ---------------------------

def _scenes(n, image_size=256):
    from mmnc_tpu_torch.data import SyntheticMultiTaskDataset, prerender

    return prerender(SyntheticMultiTaskDataset(
        ["rgb", "semantic"], size=n, image_size=image_size, style="clevr"))


def test_prefetched_batches_equal_the_host_batches(device):
    from mmnc_tpu_torch.data import BatchLoader, prefetch_to_device

    loader = BatchLoader(_scenes(24, 128), 4)
    a = torch.randn(1024, 1024, device=device)
    n = 0
    for host, dev in zip(loader.epoch(0), prefetch_to_device(
            loader.epoch(0), size=3, device=device)):
        for _ in range(4):  # keep the consumer's stream busy
            a = torch.tanh(a @ a / 1024.0)
        for t, x in host.items():
            assert dev[t].is_cuda
            assert torch.equal(dev[t].cpu(), torch.from_numpy(x)), (n, t)
        n += 1
    assert n == 6


def test_device_cache_gather_equals_the_cpu_port(device):
    from mmnc_tpu_torch.data import DeviceResidentDataset

    rng = np.random.default_rng(0)
    arrays = {"rgb": rng.random((16, 32, 32, 3), dtype=np.float32),
              "signed": rng.random((16, 32, 32, 3), dtype=np.float32) * 2 - 1,
              "semantic": np.floor(rng.random((16, 32, 32, 1),
                                              dtype=np.float32) * 16.99)}
    card = DeviceResidentDataset(arrays, device=device)
    cpu = DeviceResidentDataset(arrays, device="cpu")
    assert card._scales == cpu._scales
    for idx in ([0, 3, 15, 3], list(range(16))):
        got, want = card.get_batch(idx), cpu.get_batch(idx)
        for t in arrays:
            assert got[t].is_cuda
            assert torch.equal(got[t].cpu(), want[t]), t


def test_resumed_fit_on_card_equals_uninterrupted(device, tmp_path):
    from mmnc_tpu_torch.data import BatchLoader
    from mmnc_tpu_torch.train import fit

    data = _scenes(4)

    def run(out, epochs, **kw):
        model = build_model(1, ["rgb"], latent_channels=8, conv_channels=4,
                            lmbda=1e-2, learning_rate_main=1e-4,
                            device=device)
        state, _ = fit(model, BatchLoader(data, 2), epochs=epochs,
                       out_dir=str(out), log_images=False,
                       compute_metrics=False, log_every=1, **kw)
        return model, state

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        run(tmp_path / "a", 1, schedule_total_steps=4)
        resumed, s_r = run(tmp_path / "a", 2, resume=True)
        whole, s_w = run(tmp_path / "b", 2)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert s_r.step == s_w.step == 4 and s_r.total_steps == 4
    for (name, p), q in zip(whole.named_parameters(), resumed.parameters()):
        assert torch.equal(p, q), name
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(s_w.optimizer.state[p][k],
                               s_r.optimizer.state[q][k]), (name, k)


# --- analysis and data parallelism on the card -----------------------------

def test_analysis_on_card_equals_the_cpu_port(device):
    """check_bpp, encode_eval, channel_bpp, swap_latent_slices and
    average_channels of the disjoint codec (rgb + mono, m=8, c=4, kernels
    scaled) on the card and on the CPU from one seed: bytes and symbols
    equal, floats within rtol 1e-3 / atol 1e-4."""
    from mmnc_tpu_torch import analysis

    models = []
    for dev in ("cpu", device):
        model = scale_conv_kernels(build_model(
            3, ["rgb", "mono"], latent_channels=8, conv_channels=4,
            device=dev, seed=3))
        model.update_bottleneck_values()
        models.append(model)
    cpu, card = models
    batch_a = cpu.example_batch(2, seed=1)
    batch_b = cpu.example_batch(2, seed=7)
    want, got = (analysis.check_bpp(m, batch_a) for m in (cpu, card))
    assert got["bytes"] == want["bytes"] > 0
    assert got["actual_bpp"] == want["actual_bpp"]
    for k in ("estimated_bpp", "estimated_bpp_legacy"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-4)
    for a, b in zip(card.encode_eval(batch_a), cpu.encode_eval(batch_a)):
        assert torch.equal(a.cpu(), b)
    want, got = (analysis.channel_bpp(m, batch_a) for m in (cpu, card))
    for k in ("y", "z"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-4)
    for probe in (lambda m: analysis.swap_latent_slices(m, batch_a, batch_b,
                                                        range(4)),
                  lambda m: analysis.average_channels(m, batch_a, [0, 5])):
        want, got = probe(cpu), probe(card)
        for t in want:
            np.testing.assert_allclose(got[t].cpu().numpy(),
                                       want[t].numpy(), rtol=1e-3, atol=1e-4)


def _card_fit(mesh, data, out_dir, steps, eager=False):
    """fit of the c=4, m=8 rgb codec for `steps` steps at a global batch
    of 4 under deterministic cuDNN, on the card (mesh None) or as a rank;
    with `eager` the loop's multi-step is made of eager steps and the
    programs run under `graphs.disabled()` (chip_smoke's eager reference):
    -> (rank 0's train losses, the parameters, GDN launches counted
    through the wrapper (none for a replayed call), each train call's
    kind: "eager", "capture" or "replay")."""
    import json
    import os

    import chip_smoke
    from mmnc_tpu_torch.data import BatchLoader
    from mmnc_tpu_torch.train import fit, loop

    device = mesh.device if mesh is not None else torch.device("cuda")
    name = ("single" if mesh is None else f"ranks{mesh.world_size}") + (
        "_eager" if eager else "")
    torch.backends.cudnn.deterministic = True
    model = build_model(1, ["rgb"], latent_channels=8, conv_channels=4,
                        lmbda=1e-2, learning_rate_main=1e-4, device=device)
    make = (chip_smoke.eager_multi_step if eager
            else loop.make_multi_train_step)
    calls = []

    def made(*args, **kwargs):
        multi = make(*args, **kwargs)
        stats = getattr(multi, "stats", None)

        def call(*a, **k):
            before = dict(stats) if stats is not None else None
            out = multi(*a, **k)
            calls.append(chip_smoke.call_kind(stats, before))
            return out
        return call

    original = loop.make_multi_train_step
    loop.make_multi_train_step = made
    before = gdn_cuda.launches
    try:
        with graphs.disabled() if eager else contextlib.nullcontext():
            fit(model, BatchLoader(data, 4), epochs=1, max_steps=steps,
                run_name=name, out_dir=out_dir, log_every=1,
                log_images=False, compute_metrics=True,
                n_devices=None if mesh is None else mesh.world_size)
    finally:
        loop.make_multi_train_step = original
    trace = []
    if mesh is None or mesh.lead:
        with open(os.path.join(out_dir, name, f"{name}.metrics.jsonl")) as f:
            trace = [r["train/loss"] for r in map(json.loads, f)
                     if "train/loss" in r]
    return (trace, {k: v.cpu().numpy() for k, v in model.state_dict().items()},
            gdn_cuda.launches - before, calls)


def test_two_gloo_ranks_on_one_card_equal_one_process(device, tmp_path):
    """2 ranks on cuda:0 over gloo (which reduces CUDA tensors; NCCL takes
    one rank per card) against one process: 3 steps, the loss trace within
    rtol 1e-4, parameters within rtol 2e-4 / atol 2e-6, the ranks' equal,
    18 GDN launches a rank step, every call eager (gloo's collectives go
    through the host: no graph)."""
    from mmnc_tpu_torch.parallel import launch

    data = _scenes(12)
    deterministic = torch.backends.cudnn.deterministic
    try:
        trace, params, _, _ = _card_fit(None, data, str(tmp_path), 3)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (r_trace, r_params, n0, c0), (_, r_params1, n1, c1) = launch(
        _card_fit, 2, "cuda:0", data, str(tmp_path), 3, backend="gloo",
        timeout=300)
    assert n0 == n1 == 3 * 18
    assert c0 == c1 == ["eager"] * 3
    assert len(trace) == 3
    np.testing.assert_allclose(r_trace, trace, rtol=1e-4)
    for name, p in params.items():
        np.testing.assert_array_equal(r_params1[name], r_params[name])
        np.testing.assert_allclose(r_params[name], p, rtol=2e-4, atol=2e-6,
                                   err_msg=name)


def _card_fit_and_eager(mesh, data, out_dir, steps):
    return (_card_fit(mesh, data, out_dir, steps),
            _card_fit(mesh, data, out_dir, steps, eager=True))


def test_nccl_fit_step_at_world_size_one(device, tmp_path):
    """fit on one NCCL rank (its mesh of one: the all-reduces captured in
    its graphs) for 4 steps: a warm-up, a capture and two replays, 18 GDN
    launches a step counted for the first two (a replay's run in its
    graph), and its losses and parameters bitwise those of the same rank
    run eagerly (deterministic cuDNN)."""
    from mmnc_tpu_torch.parallel import launch

    ((graphed, eager),) = launch(_card_fit_and_eager, 1, "cuda", _scenes(16),
                                 str(tmp_path), 4, timeout=300)
    (trace, params, launches, calls), (e_trace, e_params, e_launches,
                                       e_calls) = graphed, eager
    assert calls == ["eager", "capture", "replay", "replay"]
    assert e_calls == ["eager"] * 4
    assert launches == 2 * 18 and e_launches == 4 * 18
    assert len(trace) == 4 and np.all(np.isfinite(trace)) and trace == e_trace
    for name, p in e_params.items():
        np.testing.assert_array_equal(params[name], p, err_msg=name)


def _nccl_replays_after_load(mesh, batches):
    """On one NCCL rank, graphed and then eager (chip_smoke's eager
    multi-step, the eval step under `graphs.disabled()`), deterministic
    cuDNN: three one-step calls, a load_state_dict of the state after the
    first (model and TrainState: the graph is dropped), three more calls,
    then the mesh eval step three times -> (losses, eval logs, parameters,
    the train call's stats, the eval step's stats)."""
    import copy

    import chip_smoke
    from mmnc_tpu_torch.parallel import shard_train_state
    from mmnc_tpu_torch.train import make_multi_train_step

    torch.backends.cudnn.deterministic = True
    batches = [{k: v.to(mesh.device) for k, v in b.items()} for b in batches]
    out = []
    for eager in (False, True):
        model = _graph_model(mesh.device)
        state = create_train_state(model, 10, 1e-4, 1e-3)
        shard_train_state(state, model, mesh)
        multi = (chip_smoke.eager_multi_step if eager
                 else make_multi_train_step)(model, 1, compute_metrics=True,
                                             clip_norm=5.0, mesh=mesh)
        evals = make_eval_step(model, mesh=mesh)
        gen = torch.Generator(device=mesh.device)
        losses = []
        with graphs.disabled() if eager else contextlib.nullcontext():
            for i in range(3):
                state, logs = multi(state, [batches[i]], gen, 21)
                losses.append(logs["train/loss"].item())
                if i == 0:
                    saved = copy.deepcopy((model.state_dict(),
                                           state.state_dict()))
            model.load_state_dict(saved[0])
            state.load_state_dict(saved[1])
            for i in range(3):
                state, logs = multi(state, [batches[i + 1]], gen, 21)
                losses.append(logs["train/loss"].item())
            vals = [{k: v.item() for k, v in evals(batches[0]).items()}
                    for _ in range(3)]
        torch.cuda.synchronize()
        out.append((losses, vals, {k: v.cpu().numpy()
                                   for k, v in model.state_dict().items()},
                    {k: v for k, v in getattr(multi, "stats", {}).items()
                     if k != "capture_s"},
                    {k: v for k, v in evals.stats.items()
                     if k != "capture_s"}))
    return out


def test_nccl_graphs_replay_after_load_state_dict_and_in_eval(device):
    """One NCCL rank: the train graph after a load_state_dict (dropped,
    warmed up and captured anew, replayed) and the mesh eval step's graph
    (a warm-up, a capture, a replay), bitwise equal to the same rank run
    eagerly: losses, eval logs and parameters."""
    from mmnc_tpu_torch.parallel import launch

    batches = [{k: v.cpu() for k, v in b.items()}
               for b in _graph_batches("cpu", 4)]
    ((graphed, eager),) = launch(_nccl_replays_after_load, 1, "cuda",
                                 batches, timeout=300)
    losses, vals, params, stats, eval_stats = graphed
    assert (stats["eager"], stats["captures"], stats["replays"]) == (2, 2, 4)
    assert (eval_stats["eager"], eval_stats["captures"],
            eval_stats["replays"]) == (1, 1, 2)
    assert eager[4]["eager"] == 3 and eager[4]["captures"] == 0
    assert losses == eager[0] and vals == eager[1]
    assert all(v == vals[0] for v in vals)
    for name, p in eager[2].items():
        np.testing.assert_array_equal(params[name], p, err_msg=name)


def test_nccl_ranks_across_cards_equal_one_process(device, tmp_path):
    """One NCCL rank on each card of the machine against one process at
    the global batch of 4: as the gloo test (needs two cards or more), and
    every rank's calls replay a graph with the all-reduce captured (a
    warm-up, a capture, a replay)."""
    from mmnc_tpu_torch.parallel import launch

    cards = torch.cuda.device_count()
    if cards < 2 or 4 % cards:
        pytest.skip(f"needs 2 or 4 CUDA devices, found {cards}")
    data = _scenes(12)
    deterministic = torch.backends.cudnn.deterministic
    try:
        trace, params, _, _ = _card_fit(None, data, str(tmp_path), 3)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    ranks = launch(_card_fit, cards, "cuda", data, str(tmp_path), 3,
                   timeout=300)
    r_trace, r_params, _, _ = ranks[0]
    assert [n for _, _, n, _ in ranks] == [2 * 18] * cards
    assert [c for _, _, _, c in ranks] == [["eager", "capture",
                                            "replay"]] * cards
    np.testing.assert_allclose(r_trace, trace, rtol=1e-4)
    for name, p in params.items():
        for _, other, _, _ in ranks[1:]:
            np.testing.assert_array_equal(other[name], r_params[name])
        np.testing.assert_allclose(r_params[name], p, rtol=2e-4, atol=2e-6,
                                   err_msg=name)


# --- K steps a call, the multi-task stream, the sharded compress ----------

def test_multi_step_on_card_equals_sequential_steps(device):
    """K = 3 steps in one call of make_multi_train_step against 3 single
    steps, each reseeded at step_seed(seed, step), under deterministic
    cuDNN: parameters bitwise equal, 3 x 18 GDN launches a call."""
    from mmnc_tpu_torch.train import make_multi_train_step
    from mmnc_tpu_torch.train.step import step_seed

    rng = np.random.default_rng(8)
    batches = [{"rgb": torch.from_numpy(rng.random(
        (2, 256, 256, 3), dtype=np.float32)).to(device)} for _ in range(3)]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        models = []
        for k in (1, 3):
            model = scale_conv_kernels(build_model(
                1, ["rgb"], latent_channels=8, conv_channels=4, lmbda=1e-2,
                device=device, seed=3))
            state = create_train_state(model, 10, 1e-4, 1e-3)
            gen = torch.Generator(device=device)
            before = gdn_cuda.launches
            if k == 1:
                step = make_train_step(model, compute_metrics=False)
                for batch in batches:
                    gen.manual_seed(step_seed(21, state.step))
                    state, _ = step(state, batch, gen)
            else:
                state, _ = make_multi_train_step(model, 3)(state, batches,
                                                           gen, 21)
            torch.cuda.synchronize()
            assert state.step == 3 and gdn_cuda.launches - before == 3 * 18
            models.append(model)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    for (name, p), q in zip(models[0].named_parameters(),
                            models[1].parameters()):
        assert torch.equal(p, q), name


def test_shared4_stream_on_card_equals_its_compress(device):
    """The paper's shared4 (model 4, four tasks, latent 300, conv 42)
    streamed on the card in both layouts: each batch's bytes are its
    compress's, each task's x_hat within 1e-5 of its decompress, 35 GDN
    and 28 deconv+IGDN launches a batch with the programs eager
    (`graphs.disabled()`); then the stream through the programs' graphs
    (a warm-up, a capture, a replay), the same checks."""
    tasks = ["rgb", "depth_euclidean", "normal", "semantic"]
    model = scale_conv_kernels(build_model(4, tasks, 300, 42, device=device,
                                           seed=0))
    model.update_bottleneck_values()
    batches = [{t: torch.from_numpy(x).to(device) for t, x in
                model.example_batch(2, seed=s).items()} for s in range(3)]
    for impl, graphed in (("v2", False), ("v1", False), ("v2", True),
                          ("v1", True)):
        gdn0, dec0 = gdn_cuda.launches, deconv_igdn_cuda.launches
        with contextlib.nullcontext() if graphed else graphs.disabled():
            results = list(stream_roundtrip(model, batches, depth=2,
                                            impl=impl))
        torch.cuda.synchronize()
        launches = (gdn_cuda.launches - gdn0,
                    deconv_igdn_cuda.launches - dec0)
        # v1 computes the indexes once more, from the decoded z (no kernel)
        if not graphed:
            assert launches == (3 * 35, 3 * 28), (impl, launches)
        for b, (x_hats, n_bytes) in zip(batches, results):
            ans, n_ref = model.compress(b)
            assert n_bytes == n_ref
            ref = model.decompress(ans)
            for t in tasks:
                assert (x_hats[t] - ref[t]).abs().max().item() <= 1e-5, t


def _sharded_compress(mesh, batch):
    from mmnc_tpu_torch.parallel import compress_device_fused_sharded

    model = scale_conv_kernels(build_model(
        4, ["rgb", "semantic"], latent_channels=9, conv_channels=8,
        device=mesh.device, seed=2))
    return [t.cpu().numpy() for t in
            compress_device_fused_sharded(model, batch, mesh)]


def test_sharded_compress_on_two_gloo_ranks_equals_one_process(device):
    """2 ranks on cuda:0 over gloo, each compressing its 2 rows of a
    batch of 4: the gathered symbols, indexes and max_abs bitwise equal
    one process's `_compress_device_fused`."""
    from mmnc_tpu_torch.parallel import launch

    model = scale_conv_kernels(build_model(
        4, ["rgb", "semantic"], latent_channels=9, conv_channels=8,
        device=device, seed=2))
    batch = model.example_batch(4, seed=5)
    want = [t.cpu().numpy() for t in model._compress_device_fused(batch)]
    ranks = launch(_sharded_compress, 2, "cuda:0", batch, backend="gloo",
                   timeout=300)
    assert (want[0] != 0).any()
    for got in ranks:
        for name, g, w in zip(("y", "z", "indexes", "max_abs"), got, want):
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_sharded_compress_across_cards_equals_one_process(device):
    """One NCCL rank on each card (needs 2 or 4), each compressing 2 rows:
    the gathered int16 symbols (moved as bytes: NCCL has no int16), uint8
    indexes and max_abs bitwise equal one process's."""
    from mmnc_tpu_torch.parallel import launch

    cards = torch.cuda.device_count()
    if cards < 2 or 4 % cards:
        pytest.skip(f"needs 2 or 4 CUDA devices, found {cards}")
    model = scale_conv_kernels(build_model(
        4, ["rgb", "semantic"], latent_channels=9, conv_channels=8,
        device=device, seed=2))
    batch = model.example_batch(2 * cards, seed=5)
    want = [t.cpu().numpy() for t in model._compress_device_fused(batch)]
    for got in launch(_sharded_compress, cards, "cuda", batch, timeout=300):
        for name, g, w in zip(("y", "z", "indexes", "max_abs"), got, want):
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)


# --- the bf16 activation path ----------------------------------------------
# GDN computes in float32 and rounds once at the store; its plain version
# is the JAX package's bf16 chain, which rounds at four points: at most
# one bf16 ulp apart, within 2^-7 of max(1, |plain|). deconv+IGDN is held
# stage by stage as chip_smoke.py holds it (`check_deconv_bf16`): its
# sums rounded as cuDNN's but where the exact sum lies within float32
# summation error of a bf16 rounding boundary (the two sum in other
# orders), y bitwise the rounded sum plus the bias, rounded, and the
# output within 2^-7 of the plain epilogue on the kernel's own y. The
# parameters hold bf16 values, as the bf16 layers hand them over.
BF16_TOL = 2.0 ** -7


def _bf16_values(*tensors):
    return [t.to(torch.bfloat16).float() for t in tensors]


@pytest.mark.parametrize("n", [5, 777, 4099, 32768])
@pytest.mark.parametrize("c", [1, 3, 21, 50, 100, 168])
@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_kernel_bf16_matches_plain(device, n, c, inverse):
    """bf16 x (and output), float32 gamma and beta, at the widths of the
    rgb and shared4 paths and C = 168 (channel-sliced plans); ragged tiles
    whose last 1-7 values are not a whole 16 bytes; two launches bitwise
    equal."""
    import chip_smoke

    x, gamma, beta = _gdn_inputs(device, n, c, n + c)
    x, (gamma,) = x.to(torch.bfloat16), _bf16_values(gamma)
    before = gdn_cuda.launches
    got = gdn(x, gamma, beta, inverse)
    again = gdn(x, gamma, beta, inverse)
    torch.cuda.synchronize()
    assert gdn_cuda.launches == before + 2
    chip_smoke.check_close(torch, got, gdn_plain(x, gamma, beta, inverse),
                           BF16_TOL, "gdn")
    assert torch.equal(got, again)


@pytest.mark.parametrize("variant", ["rows", "split"])
@pytest.mark.parametrize("n,c", [(4099, 50), (3001, 100), (61, 37)])
def test_gdn_kernel_bf16_plans_match_plain(device, variant, n, c):
    import chip_smoke

    x, gamma, beta = _gdn_inputs(device, n, c, 7)
    x, (gamma,) = x.to(torch.bfloat16), _bf16_values(gamma)
    got = gdn_cuda(x, gamma, beta, False, plan=gdn_plan(n, c, variant))
    chip_smoke.check_close(torch, got, gdn_plain(x, gamma, beta, False),
                           BF16_TOL, "gdn")


@pytest.mark.parametrize("shape,cout,plan", [
    ((2, 1, 1, 128), 100, "split"), ((8, 2, 2, 100), 100, "split"),
    ((8, 4, 4, 100), 100, "split"), ((3, 3, 3, 42), 40, "split"),
    ((2, 16, 16, 100), 50, "tiled"), ((1, 13, 9, 50), 3, "tiled"),
    ((2, 17, 33, 3), 3, "tiled"), ((2, 16, 16, 42), 21, "tiled"),
    ((2, 2, 2, 300), 300, "tiled_l2"), ((2, 9, 7, 150), 300, "tiled_l2"),
    ((1, 5, 7, 21), 1, "tiled"), ((2, 17, 17, 42), 3, "tiled"),
    ((1, 5, 7, 120), 10, "tiled"), ((2, 17, 17, 21), 17, "tiled"),
    ((1, 17, 17, 42), 21, "tiled"), ((1, 1, 1, 120), 10, "tiled"),
    ((1, 4, 4, 10), 10, "tiled")])
@pytest.mark.parametrize("mode", ["igdn", "gdn", None])
def test_deconv_igdn_kernel_bf16_matches_plain(device, shape, cout, plan,
                                               mode):
    """All three variants with bf16 x and output (the split one's staged
    input by plain loads at odd channel offsets: Cin 42 over clusters of
    up to 8), and the tiled kernel at the split shapes too, held stage by
    stage; two launches bitwise equal. The tiled kernel also at the
    multi-task heads' narrow widths on ragged inputs and at batch 1, with
    Cin split into slices (the 1x1 and 4x4 inputs at Cout 10)."""
    import chip_smoke

    x, w, b, gamma, beta = _deconv_inputs(device, shape, cout, cout)
    x = x.to(torch.bfloat16)
    w, b, gamma = _bf16_values(w, b, gamma)
    chosen = launch_plan(*shape, cout)
    assert chosen[0] == plan
    plans = [chosen] + ([("tiled", *tile_shape(*shape, cout), 1)]
                        if plan == "split" else [])
    for p in plans:
        chip_smoke.check_deconv_bf16(torch, x, w, b, gamma, beta, mode, p,
                                     f"deconv_igdn {shape} {cout} {p}")


# the bf16 stages where cuDNN beat the CUDA-core kernel (batch 8), the
# bench's (batch 64) and ragged ones, with the tensor-core plan forced
# where the launch plan keeps the CUDA cores (tiles cut by the image's
# edge; Cin 17 and 21 staged by plain loads, 50 by 4-byte copies, 32 by
# 16-byte ones)
_MMA_DECONVS = [((8, 32, 32, 50), 50, None), ((8, 16, 16, 100), 50, None),
                ((8, 64, 64, 21), 17, None), ((8, 128, 128, 17), 17, None),
                ((8, 32, 32, 21), 21, None), ((64, 16, 16, 100), 50, None),
                ((64, 32, 32, 50), 50, None), ((8, 16, 16, 42), 21, None),
                ((1, 13, 9, 17), 21, (8, 8)), ((1, 9, 16, 50), 17, (4, 8)),
                ((2, 17, 33, 17), 17, (8, 16)), ((1, 5, 24, 21), 17, (4, 8)),
                ((2, 3, 16, 32), 21, (2, 8)), ((1, 8, 8, 100), 50, (8, 8)),
                # conv 192's 32x32 stage (kNT 6, two N groups) and the
                # plans of kNT 5, 8, 6 in one group and 1
                ((8, 32, 32, 96), 96, None), ((8, 32, 32, 40), 40, None),
                ((8, 32, 32, 64), 64, None), ((8, 32, 32, 48), 48, None),
                ((1, 32, 32, 21), 21, None)]


@pytest.mark.parametrize("shape,cout,tile", _MMA_DECONVS, ids=str)
@pytest.mark.parametrize("mode", ["igdn", "gdn", None])
def test_deconv_igdn_tensor_core_path_bf16_matches_plain(device, shape, cout,
                                                         tile, mode):
    """The bf16 tiled path on the tensor cores ("tiled_mma"), and the
    CUDA-core tiled path forced at the same shape, held stage by stage
    (chip_smoke.check_deconv_bf16: the sums round as cuDNN's but at a
    boundary within float32 summation error, y bitwise the rounded sum
    plus the bias, rounded, the epilogue within 2^-7, two launches bitwise
    equal)."""
    import chip_smoke

    x, w, b, gamma, beta = _deconv_inputs(device, shape, cout, cout)
    x = x.to(torch.bfloat16)
    w, b, gamma = _bf16_values(w, b, gamma)
    plan = launch_plan(*shape, cout, dtype=torch.bfloat16)
    if tile is not None:
        plan = ("tiled_mma", *tile, 1)
    assert plan[0] == "tiled_mma"
    for p in (plan, ("tiled", *tile_shape(*shape, cout), 1)):
        chip_smoke.check_deconv_bf16(torch, x, w, b, gamma, beta, mode, p,
                                     f"deconv_igdn {shape} {cout} {p}")


def test_tensor_core_plan_refuses_float32_and_plans_without_a_kernel(device):
    """A "tiled_mma" plan launches its kernel or raises: float32 x, tiles
    whose width is not a multiple of 8 and Cout <= 4 have no kernel, and
    nothing is launched."""
    x, w, b, gamma, beta = _deconv_inputs(device, (2, 16, 16, 42), 21, 0)
    xb = x.to(torch.bfloat16)
    _, w3, b3, gamma3, beta3 = _deconv_inputs(device, (2, 16, 16, 42), 3, 0)
    before = deconv_igdn_cuda.launches
    for args, plan in (((x, w, b, gamma, beta), ("tiled_mma", 8, 8, 1)),
                       ((xb, w, b, gamma, beta), ("tiled_mma", 4, 4, 1)),
                       ((xb, w3, b3, gamma3, beta3), ("tiled_mma", 8, 8, 1)),
                       ((xb, w, b, gamma, beta), ("tiled_mma", 8, 8, 2))):
        with pytest.raises(ValueError):
            deconv_igdn_cuda(*args, "igdn", plan=plan)
    assert deconv_igdn_cuda.launches == before
    assert launch_plan(2, 16, 16, 42, 21)[0] == "tiled"


@pytest.mark.parametrize("shape,cout", [((8, 16, 16, 100), 50),
                                        ((8, 32, 32, 21), 21)])
def test_captured_tensor_core_deconv_igdn_launch_equals_eager(device, shape,
                                                              cout):
    """One bf16 launch on the tensor cores captured into a graph and
    replayed on new inputs equals an eager launch on them bitwise."""
    plan = launch_plan(*shape, cout, dtype=torch.bfloat16)
    assert plan[0] == "tiled_mma"
    x, w, b, gamma, beta = _deconv_inputs(device, shape, cout, 1)
    w, b, gamma = _bf16_values(w, b, gamma)
    x = x.to(torch.bfloat16)
    eager = deconv_igdn_cuda(x, w, b, gamma, beta, "igdn", plan=plan)
    static = torch.zeros_like(x)
    stream = graphs.capture_stream(x.device)
    graphs.warm_up(lambda: deconv_igdn_cuda(static, w, b, gamma, beta,
                                            "igdn", plan=plan),
                   stream=stream)
    graph, out = graphs.capture(
        lambda: deconv_igdn_cuda(static, w, b, gamma, beta, "igdn",
                                 plan=plan), stream)
    for seed in (2, 3):
        x2 = _deconv_inputs(device, shape, cout, seed)[0].to(torch.bfloat16)
        static.copy_(x2)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, deconv_igdn_cuda(x2, w, b, gamma, beta,
                                                 "igdn", plan=plan)), seed
    static.copy_(x)
    graph.replay()
    assert torch.equal(out, eager)


def test_kernel_wrappers_refuse_other_activation_types(device):
    """float16 x, or bf16 parameters, raise: nothing is cast behind the
    caller's back."""
    x, gamma, beta = _gdn_inputs(device, 64, 50, 0)
    for args in ((x.half(), gamma, beta), (x.bfloat16(), gamma.bfloat16(),
                                           beta)):
        with pytest.raises(ValueError):
            gdn_cuda(*args, False)
    x, w, b, gamma, beta = _deconv_inputs(device, (1, 4, 4, 8), 8, 0)
    for args in ((x.half(), w, b, gamma, beta),
                 (x.bfloat16(), w.bfloat16(), b, gamma, beta)):
        with pytest.raises(ValueError):
            deconv_igdn_cuda(*args, "igdn")


def test_bf16_codec_on_card(device):
    """The bf16 rgb codec (c=4, m=8) on the card: its launches go through
    the bf16 kernels (9 GDN a compress, 2 GDN + 7 deconv+IGDN a
    decompress), stream bytes equal compress's, decompress equals the
    eval forward bitwise under deterministic cuDNN, and the card's y,
    symbols and x_hats agree with the CPU port's bf16 codec."""
    models = []
    for dev in ("cpu", device):
        model = scale_conv_kernels(build_model(
            1, ["rgb"], latent_channels=8, conv_channels=4, device=dev,
            seed=3, dtype=torch.bfloat16))
        model.update_bottleneck_values()
        models.append(model)
    cpu, card = models
    batch = {"rgb": torch.from_numpy(np.random.default_rng(4).random(
        (2, 256, 256, 3)).astype(np.float32)).to(device)}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        x_hat = card(batch)[0]["rgb"]
        gdn0, dec0 = gdn_cuda.launches, deconv_igdn_cuda.launches
        ans, n_bytes = card.compress(batch)
        assert (gdn_cuda.launches - gdn0, deconv_igdn_cuda.launches - dec0) \
            == (9, 0)
        decoded = card.decompress(ans)["rgb"]
        torch.cuda.synchronize()
        assert (gdn_cuda.launches - gdn0, deconv_igdn_cuda.launches - dec0) \
            == (11, 7)
        assert decoded.dtype == torch.bfloat16
        assert torch.equal(decoded, x_hat)
        for impl in ("v2", "v1"):
            (streamed, stream_bytes), = stream_roundtrip(card, [batch],
                                                         impl=impl)
            torch.cuda.synchronize()
            assert stream_bytes == n_bytes and streamed["rgb"].dtype == \
                torch.bfloat16
    finally:
        torch.backends.cudnn.deterministic = deterministic
    with torch.no_grad():
        y_card = card.model.analyze(card._inputs(batch))[0].float().cpu()
        y_cpu = cpu.model.analyze(cpu._inputs(
            {"rgb": batch["rgb"].cpu()}))[0].float()
        y_hat = torch.round(y_cpu)
        r_card = card.model.synthesize_from_y(y_hat.to(device))[0]
        r_cpu = cpu.model.synthesize_from_y(y_hat)[0]
    # the kernels round fewer times than the CPU's chain, and the
    # difference passes through ~20 bf16 layers: 2^-4 of max(1, |cpu|), as
    # chip_smoke.py's BF16_CPU_RTOL
    for got, want in ((y_card, y_cpu), (r_card.float().cpu(), r_cpu.float())):
        err = (got - want).abs().max().item()
        assert err <= 2.0 ** -4 * max(1.0, want.abs().max().item()), err


# --- the K-step call as one CUDA graph --------------------------------------

def _graph_model(device):
    return scale_conv_kernels(build_model(
        1, ["rgb"], latent_channels=8, conv_channels=4, lmbda=1e-2,
        device=device, seed=3))


def _graph_batches(device, n):
    rng = np.random.default_rng(8)
    return [{"rgb": torch.from_numpy(rng.random(
        (2, 256, 256, 3), dtype=np.float32)).to(device)} for _ in range(n)]


def test_graphed_multi_step_equals_eager_steps(device):
    """Three calls of K = 2 (a warm-up, a capture, a replay) against six
    eager steps reseeded at step_seed(seed, step), under deterministic
    cuDNN: losses and parameters within 1e-6 x max|p| (chip_smoke's
    bound); 2 x 18 GDN launches counted for the warm-up and the capture,
    none for the replay, which launches through its graph."""
    from mmnc_tpu_torch.train import make_multi_train_step
    from mmnc_tpu_torch.train.step import step_seed

    batches = _graph_batches(device, 2)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = []
        for graphed in (False, True):
            model = _graph_model(device)
            state = create_train_state(model, 10, 1e-4, 1e-3)
            gen = torch.Generator(device=device)
            step = make_train_step(model, clip_norm=5.0)
            multi = make_multi_train_step(model, 2, compute_metrics=True,
                                          clip_norm=5.0)
            losses, launches = [], []
            for _ in range(3):
                before = gdn_cuda.launches
                if graphed:
                    state, logs = multi(state, batches, gen, 21)
                else:
                    for batch in batches:
                        gen.manual_seed(step_seed(21, state.step))
                        state, logs = step(state, batch, gen)
                torch.cuda.synchronize()
                launches.append(gdn_cuda.launches - before)
                losses.append(logs["train/loss"].item())
            assert state.step == 6
            runs.append((model, losses, launches, dict(multi.stats)))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (eager, e_losses, e_launches, _), (model, losses, launches, stats) = runs
    assert e_launches == [36, 36, 36] and launches == [36, 36, 0]
    assert (stats["eager"], stats["captures"], stats["replays"]) == (1, 1, 2)
    np.testing.assert_allclose(losses, e_losses, rtol=1e-6)
    for (name, p), q in zip(eager.named_parameters(), model.parameters()):
        err = (q - p).abs().max().item()
        assert err <= 1e-6 * p.abs().max().item(), (name, err)


def test_graphed_gdn_launches_land_in_the_graph(device):
    """A replay's profiler records hold the call's 2 x 18 GDN kernels and
    2 x 18 GDN backward kernels, launched by the graph
    (chip_smoke.graph_launches), and no deconv+IGDN."""
    import chip_smoke
    from mmnc_tpu_torch.train import make_multi_train_step

    model = _graph_model(device)
    state = create_train_state(model, 10, 1e-4, 1e-3)
    multi = make_multi_train_step(model, 2)
    gen = torch.Generator(device=device)
    batches = _graph_batches(device, 2)
    for _ in range(2):
        state, _ = multi(state, batches, gen, 21)
    before = gdn_cuda.launches
    prof = chip_smoke.profile_device(
        torch, lambda: multi(state, batches, gen, 21), tries=1)
    assert gdn_cuda.launches == before
    assert multi.stats["replays"] == 2
    assert prof["graph"] == {"gdn": 36, "deconv_igdn": 0,
                             "gdn_backward": 36}, prof["kernels"]


def test_graph_capture_failure_raises(device):
    """A step that cannot be captured (a host read of a device value)
    raises at the capture; nothing carries on eagerly, and the state's
    step count stays."""
    from mmnc_tpu_torch.train import make_multi_train_step

    model = _graph_model(device)
    aux_loss = model.aux_loss

    def synced():
        loss = aux_loss()
        loss.item()
        return loss

    model.aux_loss = synced
    state = create_train_state(model, 10, 1e-4, 1e-3)
    multi = make_multi_train_step(model, 1)
    gen = torch.Generator(device=device)
    batches = _graph_batches(device, 1)
    state, _ = multi(state, batches, gen, 21)  # the warm-up runs eagerly
    with pytest.raises(RuntimeError):
        multi(state, batches, gen, 21)
    assert state.step == 1
    assert (multi.stats["eager"], multi.stats["replays"]) == (1, 0)
    torch.cuda.synchronize()


@pytest.mark.parametrize("eager", ["float", "device_lr"])
def test_eager_rate_updates_as_a_captured_slot(device, eager):
    """Four updates of the card's Adam (capturable) on the same gradients,
    the main rate a 0-d float32 device tensor (a captured update's slot)
    against an eager update's: `TrainState.apply_gradients` with a float
    writes it into `device_lr`, and the two are bitwise one update. Adam
    handed the float itself rounds its update otherwise (why `device_lr`
    exists): its parameters are not all bitwise the slot's."""
    from mmnc_tpu_torch.train.state import cosine_lr

    gen = torch.Generator().manual_seed(4)
    init = _graph_model("cpu").state_dict()
    shapes = [p.shape for p in _graph_model("cpu").parameters()]
    grads = [[torch.randn(s, generator=gen) * 1e-2 for s in shapes]
             for _ in range(4)]
    runs = []
    for side in ("slot", eager):
        model = _graph_model(device)
        model.load_state_dict(init)
        state = create_train_state(model, 4, 1e-3, 1e-3)
        assert all(g["capturable"] for g in state.optimizer.param_groups)
        main = state.optimizer.param_groups[0]
        for i, step_grads in enumerate(grads):
            for p, g in zip(model.parameters(), step_grads):
                p.grad = g.to(device)
            lr = cosine_lr(i, 4, 1e-3, 1e-8)
            if side == "slot":
                state.apply_gradients(torch.tensor(lr, dtype=torch.float32,
                                                   device=device))
            elif side == "device_lr":
                state.apply_gradients(lr)
                assert main["lr"] is state.device_lr
            else:
                main["lr"] = lr
                state.optimizer.step()
        runs.append((model, state))
    (model_s, state_s), (model_e, state_e) = runs
    same = []
    for p, q in zip(model_s.parameters(), model_e.parameters()):
        same.append(torch.equal(p, q))
        for key, v in state_s.optimizer.state[p].items():
            same.append(torch.equal(state_e.optimizer.state[q][key], v))
    assert all(same) == (eager == "device_lr"), (
        f"{eager}: {sum(same)} of {len(same)} tensors bitwise the slot's")


def test_card_updates_equal_the_cpu_adam_and_resume_on_the_cpu(device,
                                                               tmp_path):
    """Four calls of K = 1 on the card, graphed (a warm-up, a capture,
    replays) and eager (`make_train_step`), from one seed state, batches
    and injected noise: after each call the CPU port's Adam (not
    capturable) steps a CPU copy on the gradients the card's update read,
    and every parameter, Adam moment and step count of the card's state
    is within rtol 1e-4 / atol 1e-6 of the CPU's (`chip_smoke.
    hold_update_to_cpu`; the gradients themselves are held to the CPU
    port's by test_train_step_on_card_matches_cpu_port). Then the graphed
    state is saved on the card and restored on the CPU through
    `restore_checkpoint`: not capturable, every tensor on the CPU and
    bitwise the card's; the CPU port's loss on the next batch is the
    card's next call's (rtol 1e-4), and the resumed CPU Adam stepped on
    that call's gradients matches the card's update. Last, the CPU's
    checkpoint is restored on the card (capturable, tensors on the card,
    bitwise the CPU's) and its next update matches the CPU Adam's."""
    import chip_smoke
    from mmnc_tpu_torch.train import make_multi_train_step
    from mmnc_tpu_torch.utils.checkpoint import (restore_checkpoint,
                                                 save_checkpoint)

    batches = _graph_batches(device, 6)
    rng = np.random.default_rng(12)
    probe = _graph_model("cpu")
    noises = [{k: torch.from_numpy(rng.uniform(-0.5, 0.5, s).astype(
        np.float32)).to(device) for k, s in probe.latent_shapes(b).items()}
        for b in batches]

    def fresh(on):
        model = _graph_model(on)
        return model, create_train_state(model, 10, 1e-4, 1e-3)

    def cpu_twin(model):
        twin, twin_state = fresh("cpu")
        twin.load_state_dict(model.state_dict())
        return twin, twin_state

    def same_state(a, a_state, b, b_state, on):
        assert a_state.step == b_state.step
        for (name, p), q in zip(a.named_parameters(), b.parameters()):
            assert q.device.type == on and torch.equal(p.cpu(), q.cpu())
            got, want = b_state.optimizer.state[q], a_state.optimizer.state[p]
            assert got.keys() == want.keys(), name
            for key, v in want.items():
                assert got[key].device.type == on, (name, key)
                assert torch.equal(got[key].cpu(), v.cpu()), (name, key)
        assert all(g["capturable"] == (on == "cuda")
                   for g in b_state.optimizer.param_groups)

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for graphed in (False, True):
            model, state = fresh(device)
            twin, twin_state = cpu_twin(model)
            if graphed:
                multi = make_multi_train_step(model, 1, compute_metrics=True,
                                              clip_norm=5.0)

                def call(i):
                    return multi(state, batches[i:i + 1],
                                 noise=noises[i])[1]
            else:
                step = make_train_step(model, clip_norm=5.0)

                def call(i):
                    return step(state, batches[i], noise=noises[i])[1]
            for i in range(4):
                call(i)
                chip_smoke.hold_update_to_cpu(model, state, twin, twin_state,
                                              f"graphed={graphed} call {i}")
        stats = multi.stats
        assert (stats["eager"], stats["captures"], stats["replays"]) == \
            (1, 1, 3)

        path = save_checkpoint(str(tmp_path / "card"), state.step, model,
                               state, {})
        payload, _ = restore_checkpoint(path, "cpu")
        cpu, cpu_state = fresh("cpu")
        cpu.load_state_dict(payload["model"])
        cpu_state.load_state_dict(payload["optimizer"])
        same_state(model, state, cpu, cpu_state, "cpu")
        with torch.no_grad():
            cpu_loss = cpu.loss_and_logs(
                {"rgb": batches[4]["rgb"].cpu()}, training=True,
                noise={k: v.cpu() for k, v in noises[4].items()})[0]
        logs = call(4)
        assert stats["replays"] == 4
        np.testing.assert_allclose(logs["train/loss"].item(),
                                   cpu_loss.item(), rtol=1e-4)
        chip_smoke.hold_update_to_cpu(model, state, cpu, cpu_state,
                                      "resumed on the CPU")

        path = save_checkpoint(str(tmp_path / "cpu"), cpu_state.step, cpu,
                               cpu_state, {})
        payload, _ = restore_checkpoint(path, device)
        back, back_state = fresh(device)
        back.load_state_dict(payload["model"])
        back_state.load_state_dict(payload["optimizer"])
        same_state(cpu, cpu_state, back, back_state, "cuda")
        make_multi_train_step(back, 1, clip_norm=5.0)(
            back_state, batches[5:], noise=noises[5])
        chip_smoke.hold_update_to_cpu(back, back_state, cpu, cpu_state,
                                      "resumed on the card")
    finally:
        torch.backends.cudnn.deterministic = deterministic


# --- the serving programs as CUDA graphs (graphs.py) ------------------------

def _serving_model(device, name, dtype=torch.float32, seed=0):
    """The bench's rgb codec (latent 128, conv 100) or shared4 (model 4,
    four tasks, latent 300, conv 42), conv kernels scaled, tables built."""
    if name == "rgb":
        args = (1, ["rgb"], 128, 100)
    else:
        args = (4, ["rgb", "depth_euclidean", "normal", "semantic"], 300, 42)
    model = scale_conv_kernels(build_model(*args, lmbda=1e-2, device=device,
                                           seed=seed, dtype=dtype))
    model.update_bottleneck_values()
    return model


def _serving_batch(model, device, seed=1):
    return {t: torch.from_numpy(x).to(device)
            for t, x in model.example_batch(2, seed=seed).items()}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [torch.as_tensor(tree)]


def _bitwise(got, want, what):
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w.cpu()), what


def _serving_calls(model, batch):
    """{program: call}: every wrapped program of the serving path, on
    inputs from the batch's eager compress."""
    with graphs.disabled():
        y_sym, z_sym, _ = model._compress_device(batch)
    y_hat = y_sym.float()
    z_host = z_sym.cpu().numpy()
    y_shape = tuple(y_sym.shape[1:3])
    last = model.n_tasks - 1
    step = make_eval_step(model)
    return {
        "_eval_forward": lambda: model(batch),
        "encode_eval": lambda: model.encode_eval(batch),
        "decode_from_latents": lambda: model.decode_from_latents(y_hat),
        "_compress_device": lambda: model._compress_device(batch),
        "_compress_device_lean": lambda: model._compress_device_lean(batch),
        "_compress_device_fused": lambda: model._compress_device_fused(
            batch),
        "_decompress_indexes_u8": lambda: model._decompress_indexes_u8(
            z_sym, y_shape),
        "_decompress_indexes": lambda: model._decompress_indexes(z_host,
                                                                 y_shape),
        "_synthesize_from_symbols": lambda: model._synthesize_from_symbols(
            y_sym.to(torch.int16)),
        "_decompress_synthesize": lambda: model._decompress_synthesize(
            y_hat),
        "_synthesize_task": lambda: model._synthesize_task(y_hat, last),
        "eval_step": lambda: step(batch),
    }


@pytest.fixture
def deterministic_cudnn():
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["rgb", "shared4"])
def test_graphed_programs_equal_eager_bitwise(device, deterministic_cudnn,
                                              name, dtype):
    """Every serving program three times (a warm-up, a capture, a replay)
    against the eager program under deterministic cuDNN: bitwise equal;
    the replay launches nothing through the kernel wrappers."""
    model = _serving_model(device, name, dtype)
    calls = _serving_calls(model, _serving_batch(model, device))
    for program, call in calls.items():
        with graphs.disabled():
            want = call()
        for i in range(3):
            gdn0, dec0 = gdn_cuda.launches, deconv_igdn_cuda.launches
            got = call()
            torch.cuda.synchronize()
            _bitwise(got, want, f"{program} call {i}")
            if i == 2:
                assert (gdn_cuda.launches, deconv_igdn_cuda.launches) == (
                    gdn0, dec0), program
    # two calls run a program of another name
    names = {"decode_from_latents": "_decompress_synthesize",
             "_decompress_indexes": "_decompress_indexes_device"}
    for program in calls:
        stats = graphs.stats(model, names.get(program, program))
        assert stats["captures"] == 1 and stats["replays"] >= 2, program


@pytest.mark.parametrize("shape,cout,plan", [
    ((8, 1, 1, 128), 100, None), ((8, 2, 2, 100), 100, None),
    ((8, 4, 4, 100), 100, None), ((8, 1, 1, 120), 42, None),
    ((8, 16, 16, 100), 50, None), ((8, 4, 4, 42), 42, ("tiled", 2, 2, 1))])
def test_captured_deconv_igdn_launch_equals_eager(device, shape, cout, plan):
    """One deconv+IGDN launch captured into a graph (split plans at the
    latent stages, the tiled one elsewhere and forced at a split shape)
    and replayed on new inputs equals an eager launch on them bitwise."""
    plan = plan or launch_plan(*shape, cout)
    x, w, b, gamma, beta = _deconv_inputs(device, shape, cout, 1)
    eager = deconv_igdn_cuda(x, w, b, gamma, beta, "igdn", plan=plan)
    static = torch.zeros_like(x)
    stream = graphs.capture_stream(x.device)
    graphs.warm_up(lambda: deconv_igdn_cuda(static, w, b, gamma, beta,
                                            "igdn", plan=plan),
                   stream=stream)
    graph, out = graphs.capture(
        lambda: deconv_igdn_cuda(static, w, b, gamma, beta, "igdn",
                                 plan=plan), stream)
    for seed in (2, 3):
        x2 = _deconv_inputs(device, shape, cout, seed)[0]
        static.copy_(x2)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, deconv_igdn_cuda(x2, w, b, gamma, beta,
                                                 "igdn", plan=plan)), seed
    static.copy_(x)
    graph.replay()
    assert torch.equal(out, eager)


def test_replay_after_adam_and_load_state_dict_equals_eager(
        device, deterministic_cudnn):
    """The rgb decompress's synthesis and the eval step captured; then an
    eager Adam step and a load_state_dict of other weights change the
    parameters in place: after each, the replays (no new warm-up) equal
    the eager programs on the new parameters bitwise."""
    model = _serving_model(device, "rgb")
    batch = _serving_batch(model, device)
    with graphs.disabled():
        y_hat = model._compress_device(batch)[0].float()
    step = make_eval_step(model)
    for _ in range(2):
        model._decompress_synthesize(y_hat)
        step(batch)
    state = create_train_state(model, 10, 1e-4, 1e-3)
    train = make_train_step(model, clip_norm=5.0)
    other = _serving_model(device, "rgb", seed=1).state_dict()
    for update in ("adam", "load_state_dict"):
        if update == "adam":
            train(state, batch, torch.Generator(device=device).manual_seed(0))
        else:
            model.load_state_dict(other)
        replays = [graphs.stats(model, n)["replays"]
                   for n in ("_decompress_synthesize", "eval_step")]
        got = model._decompress_synthesize(y_hat), step(batch)
        assert [graphs.stats(model, n)["replays"] for n in (
            "_decompress_synthesize", "eval_step")] == [r + 1 for r in
                                                        replays]
        with graphs.disabled():
            want = model._decompress_synthesize(y_hat), step(batch)
        _bitwise(got, want, update)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_graphed_round_trip_and_stream_equal_eager(device, deterministic_cudnn,
                                                   dtype):
    """compress -> decompress and both stream layouts of the rgb codec,
    three batches, graphed against `graphs.disabled()`: the same bytes
    and bitwise the same x_hats, in float32 and bf16."""
    model = _serving_model(device, "rgb", dtype)
    batches = [_serving_batch(model, device, s) for s in (1, 2, 3)]

    def trips():
        out = []
        for b in batches:
            ans, n = model.compress(b)
            out.append((ans["strings"], n, model.decompress(ans)))
        return out

    with graphs.disabled():
        want = trips()
        streams = {impl: list(stream_roundtrip(model, batches, impl=impl))
                   for impl in ("v2", "v1")}
    got = trips()
    for (s, n, x), (ws, wn, wx) in zip(got, want):
        assert s == ws and n == wn
        _bitwise(x, wx, "decompress")
    for impl, eager in streams.items():
        results = list(stream_roundtrip(model, batches, impl=impl))
        torch.cuda.synchronize()
        for (x, n), (wx, wn) in zip(results, eager):
            assert n == wn
            _bitwise(x, wx, f"stream {impl}")
