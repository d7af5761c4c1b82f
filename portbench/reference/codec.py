"""The codec in plain PyTorch: the reference the benchmark judges the
program's outputs by.

The published model (a scale hyperprior with GDN, per-task encoder and
decoder heads; models 1-4: single task, mixed, disjoint and shared
latents): each task's encoder head (conv3x3 + GDN, then 5 x [conv5x5/2 +
GDN]) feeds one ScaleHyperprior over the concatenated channels, g_a (3 x
[conv5x5/2 + GDN] + conv5x5/2), h_a on |y| (conv3x3, ReLU, 2 x conv5x5/2
with a ReLU between), h_s (2 x [deconv5x5/2, ReLU], conv3x3, ReLU), a
factorized entropy bottleneck over z and a Gaussian conditional over y.
The mixed latent is decoded by g_s (3 x [deconv5x5/2 + IGDN] +
deconv5x5/2) and one decoder head a task (deconv + IGDN, conv3x3 + IGDN,
deconv + IGDN, conv3x3 + IGDN, deconv + IGDN, deconv + IGDN, conv3x3);
disjoint and shared latents are cut into equal channel blocks, and each
task's head (an upsample stack of 3 x [deconv + IGDN] + deconv, then a
decoder head) takes its block, shared also the last (shared) block.
Parameters are named as the model's published state_dict names them
(`model.input_heads.{t}.{i}.weight`, `model.compressor.g_a.{i}.beta`,
...), GDN's in its non-negative reparametrisation.

`Numerics` says how a product is computed: float32 activations (with
TF32 off; float64 for the wide reference of the train check), or bfloat16 activations with float32 parameters (every layer
rounds its input, its weight and its output to bf16 and sums in float32;
the entropy models in float32), and for a control the next precision
below: each product's operands rounded to TF32's 10-bit mantissa in
place of float32, fp8 (e4m3) in place of bf16.

Imports nothing of the program, of the JAX package or of JAX.
"""

import math
from collections import OrderedDict, namedtuple

import torch
import torch.nn.functional as F

# the non-negative reparametrisation of GDN's beta and gamma
REPARAM_OFFSET = 2.0 ** -18
PEDESTAL = REPARAM_OFFSET ** 2
BETA_MIN = 1e-6
# the factorized prior's MLP, its tails and the likelihoods' floor
FILTERS = (3, 3, 3, 3)
LIKELIHOOD_BOUND = 1e-9
TAIL_MASS = 1e-9
# the Gaussian conditional's scale floor and its 64 log-spaced scales
SCALE_BOUND = 0.11
SCALES = (0.11, 256.0, 64)

# task -> (input channels, output channels, reconstruction loss)
TASKS = {"rgb": (3, 3, "mse"), "depth_euclidean": (1, 1, "mse"),
         "normal": (3, 3, "mse"), "semantic": (1, 17, "cross-entropy"),
         "mono": (1, 1, "mse")}
# model class -> (latent variant, loss weighting)
MODELS = {"SingleTaskCompressor": ("mixed", "none"),
          "MultiTaskMixedLatentCompressor": ("mixed", "uncertainty"),
          "MultiTaskDisjointLatentCompressor": ("disjoint", "uncertainty"),
          "MultiTaskSharedLatentCompressor": ("shared", "uncertainty")}

Layer = namedtuple("Layer", "name kind cin cout k s")


def variant(cfg):
    return MODELS[cfg["model"]]


def latent_split(cfg):
    """(latent channels, channels a task's block): the disjoint and shared
    latents are cut into equal blocks (shared: one more, shared)."""
    m, n_tasks = cfg["latent_channels"], len(cfg["tasks"])
    kind = variant(cfg)[0]
    if kind == "mixed":
        return m, m
    blocks = n_tasks + (1 if kind == "shared" else 0)
    return (m // blocks) * blocks, m // blocks


def _conv(name, cin, cout, k=5, s=2):
    return Layer(name, "conv", cin, cout, k, s)


def _deconv(name, cin, cout):
    return Layer(name, "deconv", cin, cout, 5, 2)


def _gdn(name, c, inverse=False):
    return Layer(name, "igdn" if inverse else "gdn", c, c, 0, 1)


def _relu(name):
    return Layer(name, "relu", 0, 0, 0, 1)


def _decoder_head(p, cin, cout):
    mid = cin // 2
    return [_deconv(f"{p}.0", cin, mid), _gdn(f"{p}.1", mid, True),
            _conv(f"{p}.2", mid, mid, 3, 1), _gdn(f"{p}.3", mid, True),
            _deconv(f"{p}.4", mid, mid), _gdn(f"{p}.5", mid, True),
            _conv(f"{p}.6", mid, mid, 3, 1), _gdn(f"{p}.7", mid, True),
            _deconv(f"{p}.8", mid, cout), _gdn(f"{p}.9", cout, True),
            _deconv(f"{p}.10", cout, cout), _gdn(f"{p}.11", cout, True),
            _conv(f"{p}.12", cout, cout, 3, 1)]


def stacks(cfg):
    """{stack: [Layer, ...]} (input and output heads: one list a task)."""
    tasks, c = cfg["tasks"], cfg["conv_channels"]
    kind = variant(cfg)[0]
    n = c * len(tasks)
    m, per = latent_split(cfg)
    out = {"input_heads": [], "output_heads": []}
    for t, task in enumerate(tasks):
        p = f"model.input_heads.{t}"
        head = [_conv(f"{p}.0", TASKS[task][0], c // 2, 3, 1),
                _gdn(f"{p}.1", c // 2)]
        width = c // 2
        for j in range(5):
            head += [_conv(f"{p}.{2 + 2 * j}", width, c),
                     _gdn(f"{p}.{3 + 2 * j}", c)]
            width = c
        out["input_heads"].append(head)
    p = "model.compressor"
    out["g_a"] = [_conv(f"{p}.g_a.0", n, n), _gdn(f"{p}.g_a.1", n),
                  _conv(f"{p}.g_a.2", n, n), _gdn(f"{p}.g_a.3", n),
                  _conv(f"{p}.g_a.4", n, n), _gdn(f"{p}.g_a.5", n),
                  _conv(f"{p}.g_a.6", n, m)]
    out["h_a"] = [_conv(f"{p}.h_a.0", m, n, 3, 1), _relu(f"{p}.h_a.1"),
                  _conv(f"{p}.h_a.2", n, n), _relu(f"{p}.h_a.3"),
                  _conv(f"{p}.h_a.4", n, n)]
    out["h_s"] = [_deconv(f"{p}.h_s.0", n, n), _relu(f"{p}.h_s.1"),
                  _deconv(f"{p}.h_s.2", n, n), _relu(f"{p}.h_s.3"),
                  _conv(f"{p}.h_s.4", n, m, 3, 1), _relu(f"{p}.h_s.5")]
    out["g_s"] = None
    if kind == "mixed":
        out["g_s"] = [_deconv(f"{p}.g_s.0", m, n), _gdn(f"{p}.g_s.1", n, True),
                      _deconv(f"{p}.g_s.2", n, n), _gdn(f"{p}.g_s.3", n, True),
                      _deconv(f"{p}.g_s.4", n, n), _gdn(f"{p}.g_s.5", n, True),
                      _deconv(f"{p}.g_s.6", n, n)]
    for t, task in enumerate(tasks):
        p = f"model.output_heads.{t}"
        cout = TASKS[task][1]
        if kind == "mixed":
            out["output_heads"].append(_decoder_head(p, n, cout))
            continue
        cc = c // len(tasks)
        width = per * (2 if kind == "shared" else 1)
        out["output_heads"].append(
            [_deconv(f"{p}.0", width, cc), _gdn(f"{p}.1", cc, True),
             _deconv(f"{p}.2", cc, cc), _gdn(f"{p}.3", cc, True),
             _deconv(f"{p}.4", cc, cc), _gdn(f"{p}.5", cc, True),
             _deconv(f"{p}.6", cc, c)] + _decoder_head(f"{p}.7", c, cout))
    return out


def parameter_shapes(cfg):
    """OrderedDict {state_dict name: shape} of every parameter."""
    shapes = OrderedDict()
    st = stacks(cfg)
    layers = [la for head in st["input_heads"] for la in head] + st["g_a"] \
        + (st["g_s"] or []) + st["h_a"] + st["h_s"] \
        + [la for head in st["output_heads"] for la in head]
    for la in layers:
        if la.kind == "conv":
            shapes[f"{la.name}.weight"] = (la.cout, la.cin, la.k, la.k)
        elif la.kind == "deconv":
            shapes[f"{la.name}.weight"] = (la.cin, la.cout, la.k, la.k)
        if la.kind in ("conv", "deconv"):
            shapes[f"{la.name}.bias"] = (la.cout,)
        elif la.kind in ("gdn", "igdn"):
            shapes[f"{la.name}.beta"] = (la.cin,)
            shapes[f"{la.name}.gamma"] = (la.cin, la.cin)
    n = cfg["conv_channels"] * len(cfg["tasks"])
    eb = "model.compressor.entropy_bottleneck"
    filters = (1,) + FILTERS + (1,)
    for k in range(len(FILTERS) + 1):
        shapes[f"{eb}._matrix{k}"] = (n, filters[k + 1], filters[k])
        shapes[f"{eb}._bias{k}"] = (n, filters[k + 1], 1)
        if k < len(FILTERS):
            shapes[f"{eb}._factor{k}"] = (n, filters[k + 1], 1)
    shapes[f"{eb}.quantiles"] = (n, 1, 3)
    if variant(cfg)[1] == "uncertainty":
        shapes["loss_balancer.log_vars"] = (len(cfg["tasks"]),)
    return shapes


# -- numerics ---------------------------------------------------------------

def round_tf32(t):
    """float32 values rounded to TF32's 10-bit mantissa (nearest, ties to
    even), as the tensor cores' TF32 mode takes its operands."""
    i = t.float().contiguous().view(torch.int32).to(torch.int64)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.to(torch.int32).view(torch.float32).view(t.shape)


def round_fp8(t):
    """Values rounded to fp8 e4m3 (clamped to its range), kept in t's type."""
    return t.float().clamp(-448.0, 448.0).to(torch.float8_e4m3fn).to(t.dtype)


class Numerics:
    """The reference's arithmetic: `act` the activations' type (float32,
    bfloat16, or float64 with float64 parameters); `control` None, or "tf32" (float32 products from operands
    rounded to TF32) or "fp8" (every bf16 rounding an fp8 e4m3 one)."""

    def __init__(self, act=torch.float32, control=None):
        if control not in (None, "tf32", "fp8"):
            raise ValueError(f"unknown control {control!r}")
        self.act, self.control = act, control

    @property
    def f32(self):
        """Full-precision products: float32, or float64 for the wide
        reference that tells a gradient from rounding (`control.py`)."""
        return self.act in (torch.float32, torch.float64)

    def operand(self, t):
        """A float32 product's operand (rounded with a straight-through
        gradient under grad)."""
        if self.control != "tf32":
            return t
        r = round_tf32(t.detach())
        return t + (r - t).detach() if t.requires_grad else r

    def rnd(self, t):
        """t rounded to the activations' type (bf16 path)."""
        t = t.to(self.act)
        return round_fp8(t) if self.control == "fp8" else t


def wide(t):
    """t in float32, or as it is where it is float64."""
    return t if t.dtype == torch.float64 else t.float()


# -- bounds with the model's gradients ----------------------------------------

class _LowerBound(torch.autograd.Function):
    """max(x, bound); the gradient passes where x >= bound or where it
    pushes x up (g < 0)."""

    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp_min(x, bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        keep = (x >= ctx.bound) | (g < 0)
        return torch.where(keep, g, torch.zeros_like(g)), None


def lower_bound(x, bound):
    return _LowerBound.apply(x, bound)


def abs_(x):
    """|x| whose gradient at 0 is +g."""
    return torch.where(x >= 0, x, -x)


def nonneg(reparam, minimum=0.0):
    bound = float((minimum + PEDESTAL) ** 0.5)
    out = lower_bound(reparam, bound)
    return out * out - PEDESTAL


def gdn_parameters(params, name):
    """(gamma (out, in), beta) of GDN layer `name` after the
    reparametrisation."""
    return (nonneg(params[f"{name}.gamma"]),
            nonneg(params[f"{name}.beta"], BETA_MIN))


# -- layers (NCHW) -----------------------------------------------------------

def conv(x, w, b, la, num):
    geo = dict(stride=la.s, padding=la.k // 2)
    op = F.conv2d
    if la.kind == "deconv":
        geo["output_padding"] = la.s - 1
        op = F.conv_transpose2d
    if num.f32:
        return op(num.operand(x), num.operand(w), b, **geo)
    y = op(x.float(), num.rnd(w).float(), None, **geo)
    return num.rnd(num.rnd(y).float() + num.rnd(b).float().view(-1, 1, 1))


def gdn(x, gamma, beta, inverse, num):
    """x * (r)sqrt(beta + gamma @ x^2) over the channels of NCHW x; in bf16
    computed in float32 from gamma's bf16 values and rounded once."""
    if num.f32:
        xs = x.permute(0, 2, 3, 1)
        norm = torch.matmul(num.operand(xs * xs),
                            num.operand(gamma).t()) + beta
        out = xs * (torch.sqrt(norm) if inverse else torch.rsqrt(norm))
        return out.permute(0, 3, 1, 2)
    xs = x.float().permute(0, 2, 3, 1)
    norm = torch.matmul(xs * xs, num.rnd(gamma).float().t()) + beta
    out = xs * (torch.sqrt(norm) if inverse else torch.rsqrt(norm))
    return num.rnd(out.permute(0, 3, 1, 2))


def run(layers, params, x, num):
    for la in layers:
        if la.kind in ("conv", "deconv"):
            x = conv(x, params[f"{la.name}.weight"], params[f"{la.name}.bias"],
                     la, num)
        elif la.kind == "relu":
            x = F.relu(x)
        else:
            gamma, beta = gdn_parameters(params, la.name)
            x = gdn(x, gamma, beta, la.kind == "igdn", num)
    return x


# -- entropy models ----------------------------------------------------------

def _softplus(x):
    """log(1 + e^x), in the form that neither overflows nor underflows."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def eb_logits(params, x, detach=False):
    """The factorized prior's cumulative logits at x, (C, 1, N)."""
    eb = "model.compressor.entropy_bottleneck"
    logits = x
    last = len(FILTERS)
    for k in range(last + 1):
        m, b = params[f"{eb}._matrix{k}"], params[f"{eb}._bias{k}"]
        if detach:
            m, b = m.detach(), b.detach()
        logits = torch.matmul(_softplus(m), logits) + b
        if k < last:
            f = params[f"{eb}._factor{k}"]
            if detach:
                f = f.detach()
            logits = logits + torch.tanh(f) * torch.tanh(logits)
    return logits


def _interval(lower, upper):
    sign = -torch.sign(lower + upper).detach()
    return abs_(torch.sigmoid(sign * upper) - torch.sigmoid(sign * lower))


def eb_likelihood(params, z_hat):
    b, c, h, w = z_hat.shape
    v = wide(z_hat).permute(1, 0, 2, 3).reshape(c, 1, -1)
    lik = lower_bound(_interval(eb_logits(params, v - 0.5),
                                eb_logits(params, v + 0.5)), LIKELIHOOD_BOUND)
    return lik.reshape(c, b, h, w).permute(1, 0, 2, 3)


def medians(params):
    return params["model.compressor.entropy_bottleneck.quantiles"][:, 0, 1]


def _phi(x):
    return 0.5 * torch.special.erfc(-(2 ** -0.5) * x)


def gaussian_likelihood(values, scales):
    s = lower_bound(wide(scales), SCALE_BOUND)
    v = abs_(wide(values))
    return lower_bound(_phi((0.5 - v) / s) - _phi((-0.5 - v) / s),
                       LIKELIHOOD_BOUND)


def scale_table():
    lo, hi, n = SCALES
    return torch.exp(torch.linspace(math.log(lo), math.log(hi), n,
                                    dtype=torch.float64)).float()


def scale_indexes(scales):
    """The smallest table scale >= each scale (int64)."""
    s = torch.clamp_min(scales.float(), SCALE_BOUND)
    table = scale_table().to(s.device)
    return (s.unsqueeze(-1) > table[:-1]).sum(-1)


def aux_loss(params):
    q = params["model.compressor.entropy_bottleneck.quantiles"]
    logits = eb_logits(params, q, detach=True)
    target = math.log(2.0 / TAIL_MASS - 1.0)
    signs = torch.tensor([-1.0, 0.0, 1.0], device=q.device)
    return torch.sum(abs_(logits - target * signs))


# -- the codec ---------------------------------------------------------------

class Codec:
    """The reference codec of configuration `cfg` over `params` ({state_dict
    name: float32 tensor}) in the arithmetic `num`."""

    def __init__(self, cfg, params, num=None):
        self.cfg, self.params = cfg, params
        self.num = num or Numerics()
        self.stacks = stacks(cfg)
        self.kind, self.weighting = variant(cfg)
        self.latent, self.per = latent_split(cfg)

    def _run(self, layers, x):
        return run(layers, self.params, x, self.num)

    def analyze(self, batch):
        """{task: NHWC float32} -> (y, z) NCHW in the activations' type."""
        heads = zip(self.cfg["tasks"], self.stacks["input_heads"])
        hs = [self._run(head, batch[t].permute(0, 3, 1, 2) if self.num.f32
                        else self.num.rnd(batch[t].permute(0, 3, 1, 2)))
              for t, head in heads]
        y = self._run(self.stacks["g_a"], torch.cat(hs, dim=1))
        return y, self._run(self.stacks["h_a"], abs_(y))

    def hyper_scales(self, z_hat):
        z = z_hat if self.num.f32 else self.num.rnd(z_hat)
        return self._run(self.stacks["h_s"], z)

    def symbols(self, y, z):
        """-> (y_sym, z_sym, indexes), NCHW float32 (indexes int64): y
        rounded, z rounded around the prior's medians, y's scale indexes
        from h_s of the rounded z (its top-left corner, y's extent)."""
        med = medians(self.params).view(1, -1, 1, 1)
        y_sym = torch.round(y.float())
        z_sym = torch.round(z.float() - med)
        scales = self.hyper_scales(z_sym + med)
        return y_sym, z_sym, scale_indexes(
            scales[:, :, :y.shape[2], :y.shape[3]])

    def synthesize(self, y_hat):
        """NCHW y_hat (float32 values) -> {task: NHWC float32}."""
        u = y_hat if self.num.f32 else self.num.rnd(y_hat)
        if self.stacks["g_s"] is not None:
            u = self._run(self.stacks["g_s"], u)
        out = {}
        for i, (task, head) in enumerate(zip(self.cfg["tasks"],
                                             self.stacks["output_heads"])):
            x = u
            if self.kind != "mixed":
                own = u[:, i * self.per:(i + 1) * self.per]
                x = own if self.kind == "disjoint" else torch.cat(
                    [own, u[:, -self.per:]], dim=1)
            out[task] = wide(self._run(head, x).permute(0, 2, 3, 1))
        return out

    # training (float32) ----------------------------------------------------

    def train_forward(self, batch, noise):
        """Noise-quantized forward: batch {task: NHWC}, noise {"y", "z"}
        NHWC -> (x_hats {task: NHWC}, likelihoods {"y", "z"} NHWC)."""
        y, z = self.analyze(batch)
        z_hat = z + noise["z"].permute(0, 3, 1, 2).to(z.dtype)
        z_lik = eb_likelihood(self.params, z_hat)
        scales = self._run(self.stacks["h_s"], z_hat)
        if not self.cfg.get("legacy_broadcast", True):
            scales = scales[:, :, :y.shape[2], :y.shape[3]]
        y_hat = y + noise["y"].permute(0, 3, 1, 2).to(y.dtype)
        y_lik = gaussian_likelihood(y_hat, scales)
        x_hats = self.synthesize(y_hat)
        return x_hats, {"y": y_lik.permute(0, 2, 3, 1),
                        "z": z_lik.permute(0, 2, 3, 1)}

    def loss(self, batch, noise):
        """The main loss, lmbda * reconstruction + rate."""
        x_hats, lik = self.train_forward(batch, noise)
        tasks = self.cfg["tasks"]
        losses = torch.stack([reconstruction_loss(x_hats[t], batch[t],
                                                  TASKS[t][2])
                              for t in tasks])
        if self.weighting == "uncertainty":
            log_vars = self.params["loss_balancer.log_vars"]
            rec = torch.sum((torch.exp(-log_vars) * losses + log_vars)
                            * (losses != 0).to(losses.dtype))
        else:
            rec = losses.sum()
        b, h, w, _ = x_hats[tasks[0]].shape
        pixels = b * h * w

        def bpp(lk):
            return torch.sum(torch.log(lk)) / -math.log(2.0) / pixels

        z_bpp = bpp(lik["z"])
        n = len(tasks)
        if self.kind == "mixed":
            rate = (bpp(lik["y"]) + z_bpp) / n
        else:
            c = self.per
            rate = (sum(bpp(lik["y"][..., i * c:(i + 1) * c])
                        for i in range(n)) + z_bpp) / n
            if self.kind == "shared":
                rate = rate + bpp(lik["y"][..., -c:]) / n
        return self.cfg["lmbda"] * rec + rate


def reconstruction_loss(x_hat, x, kind):
    x_hat, x = wide(x_hat), wide(x)
    if kind == "mse":
        sq = torch.sum((x - x_hat) ** 2, dim=(1, 2, 3))
        return torch.mean(sq) / x.shape[-1]
    if kind == "cross-entropy":
        log_p = torch.log_softmax(x_hat, dim=-1)
        return -torch.mean(torch.gather(log_p, -1, x[..., :1].long()))
    raise ValueError(f"unknown loss {kind!r}")
