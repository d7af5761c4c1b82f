"""Image quality metrics (mmnc_tpu/ops/metrics.py): PSNR, mIoU, SSIM and
MS-SSIM on NHWC tensors.

* PSNR: one global MSE over the whole batch, explicit data_range.
* PSNR and mIoU also come as sufficient statistics (`*_stats`), which a
  data-parallel step sums over its ranks before `*_from_stats`.
* MS-SSIM with pytorch_msssim.ms_ssim semantics: 5 scales, weights
  (0.0448, 0.2856, 0.3001, 0.2363, 0.1333), an 11-tap separable Gaussian
  window (sigma 1.5) applied VALID per channel, K1 = 0.01, K2 = 0.03, 2x2
  average pooling between scales that zero-pads odd sizes on both sides
  (zeros counted), cs and ssim relu'd, the weighted product taken per
  channel and averaged over (batch, channel) at the end.

Every result is a 0-d tensor on the inputs' device; nothing is copied to
or from the host.
"""

import torch
import torch.nn.functional as F

MS_SSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def squared_error_stats(pred, target):
    """PSNR's sufficient statistics: (summed squared error, count), a
    float64 (2,) tensor; statistics of several shards add up."""
    sse = torch.sum((pred.float() - target.float()) ** 2)
    # the count filled on the device: no copy from the host, which a
    # captured train step could not make
    count = torch.full((), pred.numel(), dtype=torch.float64,
                       device=sse.device)
    return torch.stack([sse.double(), count])


def psnr_from_stats(stats, data_range: float):
    """10 log10(R^2 / mse) of the mse that `stats` hold, as float32."""
    mse = (stats[0] / stats[1]).float()
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp_min(mse, 1e-12))


def psnr(pred, target, data_range: float):
    """PSNR of one global MSE over the whole batch."""
    return psnr_from_stats(squared_error_stats(pred, target), data_range)


def miou_stats(pred_labels, target_labels, num_classes: int = 17):
    """mIoU's sufficient statistics: per class the intersection, the
    union and the target's pixel count, a float64 (3, num_classes)
    tensor; statistics of several shards add up."""
    classes = torch.arange(num_classes, device=pred_labels.device)[:, None]
    p = pred_labels.reshape(1, -1).long() == classes
    t = target_labels.reshape(1, -1).long() == classes
    return torch.stack([(p & t).sum(1), (p | t).sum(1), t.sum(1)]).double()


def miou_from_stats(stats):
    """Mean intersection-over-union over the classes present in the
    target, from `miou_stats`, as float32."""
    inter, union, count = stats.float()
    present = (count > 0).float()
    return torch.sum(inter / union.clamp_min(1) * present) / torch.clamp_min(
        present.sum(), 1.0)


def miou(pred_labels, target_labels, num_classes: int = 17):
    """Mean intersection-over-union over the classes present in the
    target; integer label maps of any shape."""
    return miou_from_stats(miou_stats(pred_labels, target_labels,
                                      num_classes))


def _gaussian_kernel(size: int, sigma: float, device):
    x = torch.arange(size, dtype=torch.float32, device=device) \
        - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / torch.sum(g)


def _filter(x, win):
    """Separable VALID filtering of each channel of NCHW x by `win`."""
    c, k = x.shape[1], win.shape[0]
    x = F.conv2d(x, win.view(1, 1, k, 1).expand(c, 1, k, 1), groups=c)
    return F.conv2d(x, win.view(1, 1, 1, k).expand(c, 1, 1, k), groups=c)


def _ssim_components(x, y, data_range, win, k1=0.01, k2=0.03):
    """NCHW x, y -> per-channel means (B, C) of ssim and cs."""
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu_x, mu_y = _filter(x, win), _filter(y, win)
    mu_xx, mu_yy, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sigma_xx = _filter(x * x, win) - mu_xx
    sigma_yy = _filter(y * y, win) - mu_yy
    sigma_xy = _filter(x * y, win) - mu_xy
    cs = (2 * sigma_xy + c2) / (sigma_xx + sigma_yy + c2)
    ssim_map = ((2 * mu_xy + c1) / (mu_xx + mu_yy + c1)) * cs
    return ssim_map.mean(dim=(2, 3)), cs.mean(dim=(2, 3))


def _nchw(x):
    return x.float().permute(0, 3, 1, 2)


def ssim(pred, target, data_range: float, win_size: int = 11,
         win_sigma: float = 1.5):
    win = _gaussian_kernel(win_size, win_sigma, pred.device)
    s, _ = _ssim_components(_nchw(pred), _nchw(target), data_range, win)
    return torch.mean(s)


def _avg_pool2(x):
    """torch avg_pool2d(kernel_size=2, padding=size % 2) on NCHW x, the
    downsampler pytorch_msssim uses between scales."""
    return F.avg_pool2d(x, 2, padding=(x.shape[2] % 2, x.shape[3] % 2))


def ms_ssim(pred, target, data_range: float, win_size: int = 11,
            win_sigma: float = 1.5, weights=MS_SSIM_WEIGHTS):
    """Multi-scale SSIM averaged over batch and channels; NHWC inputs."""
    win = _gaussian_kernel(win_size, win_sigma, pred.device)
    x, y = _nchw(pred), _nchw(target)
    val = None
    for i, w in enumerate(weights):
        s, cs = _ssim_components(x, y, data_range, win)
        if i < len(weights) - 1:
            term = torch.relu(cs) ** w
            x, y = _avg_pool2(x), _avg_pool2(y)
        else:
            term = torch.relu(s) ** w
        val = term if val is None else val * term
    return torch.mean(val)
