"""The weights of a cell, made on the device from the seed.

One `torch.Generator` on the device, seeded with the run's seed, draws
one uniform tensor for every parameter of the configuration at once (in
`reference.codec.parameter_shapes` order); each parameter takes its slice
and a rule by its kind, in float32, the type the codec keeps its
parameters in. Both sides get the same tensors: the program through
`load_state_dict`, the reference as they are.

The rules (a configuration's `assumed` key names their constants):
* conv and deconv kernels: U(-a, a) with a = sqrt(1 / (k * k * Cin)), as
  the codec's init draws them, times a gain by stack (`encoder_gain` for
  the input heads and g_a, `hyper_gain` for h_a and h_s,
  `decoder_gain` for g_s and the output heads; the frozen gains of the
  port's bench, under which the coder sees real symbols); biases
  U(-`bias`, `bias`);
* GDN: beta U(1 - `gdn_beta`, 1 + `gdn_beta`), gamma `gdn_diagonal` on
  the diagonal and U(0, `gdn_off_diagonal`) off it, both stored in the
  non-negative reparametrisation;
* the factorized prior: the codec's init matrices, biases U(-1/2, 1/2),
  factors U(-`prior_factor`, `prior_factor`), medians
  U(-`prior_median`, `prior_median`) with tails at 10 + U(0,
  `prior_tail`) from them;
* uncertainty weights U(-`log_var`, `log_var`).
"""

import math

import torch

from .reference import codec


def make_weights(cfg, seed: int, device) -> dict:
    """{state_dict name: float32 tensor on `device`} from `seed`."""
    a = cfg["assumed"]
    shapes = codec.parameter_shapes(cfg)
    sizes = [math.prod(s) for s in shapes.values()]
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = torch.rand(sum(sizes), generator=gen, device=device)
    out = {}
    for (name, shape), u in zip(shapes.items(), draw.split(sizes)):
        u = u.view(shape)
        sym = 2 * u - 1
        if name.endswith(".weight"):
            cin = shape[1] if _is_conv(name, cfg) else shape[0]
            limit = math.sqrt(1.0 / (shape[-1] * shape[-1] * cin))
            out[name] = sym * limit * _gain(name, a)
        elif name.endswith(".bias"):
            out[name] = sym * a["bias"]
        elif name.endswith(".beta"):
            out[name] = torch.sqrt(1 + a["gdn_beta"] * sym + codec.PEDESTAL)
        elif name.endswith(".gamma"):
            eye = torch.eye(shape[0], device=device)
            gamma = eye * a["gdn_diagonal"] + (1 - eye) * u * a[
                "gdn_off_diagonal"]
            out[name] = torch.sqrt(gamma + codec.PEDESTAL)
        elif "._matrix" in name:
            scale = 10.0 ** (1.0 / (len(codec.FILTERS) + 1))
            out[name] = torch.full(shape, math.log(math.expm1(
                1.0 / scale / shape[1])), device=device)
        elif "._bias" in name:
            out[name] = u - 0.5
        elif "._factor" in name:
            out[name] = sym * a["prior_factor"]
        elif name.endswith(".quantiles"):
            med = sym[:, :, 1:2] * a["prior_median"]
            tails = 10.0 + u[:, :, ::2] * a["prior_tail"]
            out[name] = torch.cat([med - tails[:, :, :1], med,
                                   med + tails[:, :, 1:]], dim=2)
        elif name.endswith("log_vars"):
            out[name] = sym * a["log_var"]
        else:
            raise KeyError(f"no rule for parameter {name}")
    return out


def _is_conv(name, cfg):
    layer = name.rsplit(".", 1)[0]
    for stack in codec.stacks(cfg).values():
        for la in _flat(stack):
            if la.name == layer:
                return la.kind == "conv"
    raise KeyError(name)


def _flat(stack):
    if stack is None:
        return []
    if stack and isinstance(stack[0], list):
        return [la for head in stack for la in head]
    return stack


def _gain(name, a):
    """The frozen gain rule of the port's bench: h_a and h_s, then g_s and
    the output heads, then the rest (input heads, g_a)."""
    if ".h_a." in name or ".h_s." in name:
        return a["hyper_gain"]
    if ".g_s." in name or "output_heads" in name:
        return a["decoder_gain"]
    return a["encoder_gain"]
