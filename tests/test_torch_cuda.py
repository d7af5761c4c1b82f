"""The two CUDA kernels of mmnc_tpu_torch against their plain versions on
the card. Marked `cuda`: they skip where no CUDA device is present (a
CUDA kernel has no interpret mode). On a host with an H100:

    python -m pytest tests/test_torch_cuda.py -m cuda

Tolerance: float32 sums over up to 25*100 products taken in another order
than cuBLAS/cuDNN, so 1e-4 relative to the largest output.
"""

import pytest
import torch

from mmnc_tpu_torch.ops.deconv_igdn import (deconv_igdn_cuda,
                                            deconv_igdn_plain, launch_plan,
                                            tile_shape)
from mmnc_tpu_torch.ops.gdn import (GDNPlan, gdn, gdn_cuda, gdn_plain,
                                   gdn_plan)

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


@pytest.mark.parametrize("shape,cout", [((2, 1, 1, 100), 100),
                                        ((2, 2, 2, 100), 100),
                                        ((3, 5, 6, 100), 100),
                                        ((2, 8, 8, 100), 50),
                                        ((1, 13, 9, 50), 3),
                                        ((1, 17, 33, 3), 3)])
@pytest.mark.parametrize("mode", ["igdn", "gdn", None])
@pytest.mark.parametrize("tiled", [False, True])
def test_deconv_igdn_kernel_matches_plain(device, shape, cout, mode, tiled):
    """The launch plan's variant, and the tiled variant at every shape
    (the small shapes' plan is the split one)."""
    x, w, b, gamma, beta = _deconv_inputs(device, shape, cout, cout)
    plan = ("tiled", *tile_shape(shape[0], shape[1], shape[2], cout), 1) \
        if tiled else None
    got = deconv_igdn_cuda(x, w, b, gamma, beta, mode, plan=plan)
    torch.cuda.synchronize()
    _close(got, deconv_igdn_plain(x, w, b, gamma, beta, mode))


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
        gdn_cuda(x, torch.eye(200, device=device), torch.ones(200, device=device),
                 False)
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
