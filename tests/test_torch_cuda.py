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
                                            deconv_igdn_plain)
from mmnc_tpu_torch.ops.gdn import gdn, gdn_cuda, gdn_plain

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


@pytest.mark.parametrize("shape,cout", [((2, 1, 1, 100), 100),
                                        ((2, 2, 2, 100), 100),
                                        ((3, 5, 6, 100), 100),
                                        ((2, 8, 8, 100), 50),
                                        ((1, 13, 9, 50), 3),
                                        ((1, 17, 33, 3), 3)])
@pytest.mark.parametrize("mode", ["igdn", "gdn", None])
def test_deconv_igdn_kernel_matches_plain(device, shape, cout, mode):
    g = torch.Generator(device="cpu").manual_seed(cout)
    cin = shape[-1]
    x = torch.randn(*shape, generator=g).to(device)
    w = (torch.rand(5, 5, cin, cout, generator=g) * 2 - 1).to(device) \
        / (25 * cin) ** 0.5
    b = (0.1 * torch.randn(cout, generator=g)).to(device)
    gamma = (0.1 * torch.eye(cout)
             + 0.01 * torch.rand(cout, cout, generator=g)).to(device)
    beta = (1 + 0.1 * torch.rand(cout, generator=g)).to(device)
    got = deconv_igdn_cuda(x, w, b, gamma, beta, mode)
    torch.cuda.synchronize()
    _close(got, deconv_igdn_plain(x, w, b, gamma, beta, mode))


def test_kernel_wrappers_raise_on_unsupported_input(device):
    x = torch.randn(8, 200, device=device)
    with pytest.raises(ValueError):
        gdn_cuda(x, torch.eye(200, device=device), torch.ones(200, device=device),
                 False)
    with pytest.raises(ValueError):
        gdn_cuda(x.double()[:, :4], torch.eye(4, device=device).double(),
                 torch.ones(4, device=device).double(), False)
