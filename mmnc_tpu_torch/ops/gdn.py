"""(I)GDN over channel-minor rows: kernel 1 of the port.

Replaces mmnc_tpu/ops/gdn_pallas.py:_gdn_forward (kernel body
`_gdn_kernel`, reached from `gdn_pallas_2d` / `gdn_pallas`) with the
hand-written CUDA kernel `csrc/gdn.cu`. On the H100 the op sits near the
balance of bytes and f32 FMAs (C/4 FLOP per byte: C = 50 is bound by
bytes, C = 100 by FMAs); the kernel reads each row once, keeps gamma,
beta and the squared rows in shared memory, and writes each row once. See
the source for the design.

`gdn(x, gamma, beta, inverse)` mirrors `gdn_pallas`: x is NHWC (or any
channels-last tensor), gamma (C, C) in [out, in] layout, beta (C,). It is
an autograd Function whose backward is the closed form of
gdn_pallas.py:85-101, written in torch (a backward kernel comes with
training). A CPU tensor takes the plain version `gdn_plain`; a CUDA tensor
launches the kernel or raises.
"""

import ctypes
import functools

import torch

from . import _build

MAX_CHANNELS = 128


def gdn_plain(x2d, gamma, beta, inverse: bool):
    """The einsum chain: x * (r)sqrt(x^2 @ gamma^T + beta) over (N, C) rows."""
    norm = (x2d * x2d) @ gamma.t() + beta
    return x2d * (torch.sqrt(norm) if inverse else torch.rsqrt(norm))


@functools.cache
def _entry():
    fn = _build.load("gdn").mmnc_gdn_forward
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def tile_rows(n: int, c: int) -> int:
    """Rows per block: enough (4-row group, channel) items for 256 threads,
    no more rows than there are (a multiple of 4)."""
    return min(64 if c >= 16 else 256, (n + 3) // 4 * 4)


def gdn_cuda(x2d, gamma, beta, inverse: bool):
    """Launch csrc/gdn.cu on CUDA float32 tensors; raises on anything else."""
    n, c = x2d.shape
    if not (x2d.is_cuda and gamma.is_cuda and beta.is_cuda):
        raise ValueError("gdn_cuda takes CUDA tensors")
    if x2d.dtype != torch.float32 or gamma.dtype != torch.float32 \
            or beta.dtype != torch.float32:
        raise ValueError("gdn_cuda takes float32 tensors")
    if gamma.shape != (c, c) or beta.shape != (c,):
        raise ValueError(f"gamma {tuple(gamma.shape)} / beta "
                         f"{tuple(beta.shape)} do not match C={c}")
    if c > MAX_CHANNELS:
        raise ValueError(f"gdn_cuda supports C <= {MAX_CHANNELS}, got {c}")
    x2d, gamma, beta = x2d.contiguous(), gamma.contiguous(), beta.contiguous()
    out = torch.empty_like(x2d)
    rc = _entry()(x2d.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                  out.data_ptr(), n, c, tile_rows(n, c), int(inverse),
                  torch.cuda.current_stream(x2d.device).cuda_stream)
    _build.check_launch(rc, "gdn")
    gdn_cuda.launches += 1
    return out


gdn_cuda.launches = 0


def gdn_rows(x2d, gamma, beta, inverse: bool):
    """Forward on (N, C) rows: the plain version on the CPU, else the kernel."""
    if x2d.device.type == "cpu":
        return gdn_plain(x2d, gamma, beta, inverse)
    return gdn_cuda(x2d, gamma, beta, inverse)


class GDNFunction(torch.autograd.Function):
    """(N, C) x (C, C) x (C,) -> (N, C), closed-form backward."""

    @staticmethod
    def forward(ctx, x2d, gamma, beta, inverse):
        ctx.save_for_backward(x2d, gamma, beta)
        ctx.inverse = inverse
        return gdn_rows(x2d, gamma, beta, inverse)

    @staticmethod
    def backward(ctx, g):
        x, gamma, beta = ctx.saved_tensors
        x2 = x * x
        norm = x2 @ gamma.t() + beta
        if ctx.inverse:
            s = torch.sqrt(norm)
            u = g * x / s
            dx = g * s + x * (u @ gamma)
            dgamma = 0.5 * (u.t() @ x2)
            dbeta = 0.5 * u.sum(0)
        else:
            r = torch.rsqrt(norm)
            u = g * x * (r * r * r)
            dx = g * r - x * (u @ gamma)
            dgamma = -0.5 * (u.t() @ x2)
            dbeta = -0.5 * u.sum(0)
        return dx, dgamma, dbeta, None


def gdn(x, gamma, beta, inverse: bool = False):
    """Channels-last wrapper: x (..., C), gamma (C, C) [out, in], beta (C,)."""
    c = x.shape[-1]
    y = GDNFunction.apply(x.contiguous().view(-1, c), gamma, beta, inverse)
    return y.view(x.shape)
