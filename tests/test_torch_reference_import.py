"""Reference-checkpoint import into the port
(`mmnc_tpu_torch.utils.torch_import.import_reference_state_dict`) on the
CPU.

Torch modules with the reference's exact module naming are built here,
as tests/test_torch_import.py builds them (no download): a mixed codec
(model 2: rgb + depth, m=8, c=4) and a shared one (model 4: rgb + depth,
m=9, c=4), each with CompressAI's GDN (parameters in the reparametrised
space, with its `*_reparam.pedestal` / `lower_bound.bound` buffers), an
entropy bottleneck with `_matrix{k}`/`_bias{k}`/`_factor{k}`/`quantiles`
and the `_offset`/`_quantized_cdf`/`_cdf_length` buffers, a Gaussian
conditional's buffers and the loss balancer's `log_vars`. Their params
are perturbed by 0.02 x N(0, 1), so nothing sits at its init value.

The state_dict (raw, or wrapped as a Lightning checkpoint) loads into the
port. The port's latents y and z, its hyper-synthesised scales, its
decode of the rounded y and its eval forward (x_hats and likelihoods)
equal mmnc_tpu's after JAX's importer and the reference module's, at
tests/test_torch_import.py's rtol 1e-3 / atol 1e-4. With raw_gdn=True the
port's parameters equal JAX's raw import; a missing key raises KeyError
naming it; a model without uncertainty weighting skips `log_vars`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from mmnc_tpu.models import build_model as j_build_model
from mmnc_tpu.utils.torch_import import (
    import_reference_state_dict as j_import_reference_state_dict)

from mmnc_tpu_torch import build_model
from mmnc_tpu_torch.utils.torch_import import import_reference_state_dict
from mmnc_tpu_torch.weights import state_dict_from_jax

PED = 2.0 ** -36
RTOL, ATOL = 1e-3, 1e-4
TASKS = ("rgb", "depth_euclidean")
IN_CHS = (3, 1)
C = 4
# variant: (model number, latent channels)
CONFIGS = {"mixed": (2, 8), "shared": (4, 9)}


@pytest.fixture(autouse=True)
def two_threads():
    """Torch on 2 threads: the tests share the host's cores with other test
    processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


class _Reparam(nn.Module):
    """CompressAI's NonNegativeParametrizer buffers."""

    def __init__(self, minimum=0.0):
        super().__init__()
        self.register_buffer("pedestal", torch.tensor([PED]))
        self.lower_bound = nn.Module()
        self.lower_bound.register_buffer(
            "bound", torch.tensor([(minimum + PED) ** 0.5]))


class RefGDN(nn.Module):
    """CompressAI's GDN: beta and gamma in the reparametrised space."""

    def __init__(self, c, inverse=False):
        super().__init__()
        self.inverse = inverse
        self.beta = nn.Parameter(torch.sqrt(torch.ones(c) + PED))
        self.gamma = nn.Parameter(torch.sqrt(0.1 * torch.eye(c) + PED))
        self.beta_reparam = _Reparam(1e-6)
        self.gamma_reparam = _Reparam()

    def forward(self, x):
        beta = torch.clamp(self.beta, min=(1e-6 + PED) ** 0.5) ** 2 - PED
        gamma = torch.clamp(self.gamma, min=PED ** 0.5) ** 2 - PED
        norm = nn.functional.conv2d(x * x, gamma.view(*gamma.shape, 1, 1),
                                    beta)
        return x * torch.sqrt(norm) if self.inverse else x * torch.rsqrt(norm)


class RefEntropyBottleneck(nn.Module):
    """CompressAI's EntropyBottleneck state: filters (3, 3, 3, 3)."""

    def __init__(self, c):
        super().__init__()
        dims = (1, 3, 3, 3, 3, 1)
        for k in range(5):
            self.register_parameter(f"_matrix{k}", nn.Parameter(
                torch.full((c, dims[k + 1], dims[k]), 0.3)))
            self.register_parameter(f"_bias{k}", nn.Parameter(
                torch.zeros(c, dims[k + 1], 1)))
            if k < 4:
                self.register_parameter(f"_factor{k}", nn.Parameter(
                    torch.zeros(c, dims[k + 1], 1)))
        self.quantiles = nn.Parameter(
            torch.tensor([-10.0, 0.0, 10.0]).repeat(c, 1, 1))
        self.register_buffer("_offset", torch.zeros(c, dtype=torch.int32))
        self.register_buffer("_quantized_cdf",
                             torch.zeros(c, 24, dtype=torch.int32))
        self.register_buffer("_cdf_length", torch.zeros(c, dtype=torch.int32))


class RefGaussianConditional(nn.Module):
    """CompressAI's GaussianConditional buffers."""

    def __init__(self):
        super().__init__()
        self.register_buffer("scale_table", torch.linspace(0.11, 256, 64))
        self.register_buffer("scale_bound", torch.tensor([0.11]))
        self.register_buffer("_offset", torch.zeros(64, dtype=torch.int32))
        self.register_buffer("_quantized_cdf",
                             torch.zeros(64, 24, dtype=torch.int32))
        self.register_buffer("_cdf_length", torch.zeros(64, dtype=torch.int32))


def _conv(i, o, k=5, s=2):
    return nn.Conv2d(i, o, k, stride=s, padding=k // 2)


def _deconv(i, o, k=5, s=2):
    return nn.ConvTranspose2d(i, o, k, stride=s, output_padding=s - 1,
                              padding=k // 2)


def _enc_head(in_ch, c):
    layers = [_conv(in_ch, c // 2, 3, 1), RefGDN(c // 2), _conv(c // 2, c),
              RefGDN(c)]
    for _ in range(4):
        layers += [_conv(c, c), RefGDN(c)]
    return nn.Sequential(*layers)


def _dec_head(in_ch, out_ch):
    mid = in_ch // 2
    return nn.Sequential(
        _deconv(in_ch, mid), RefGDN(mid, True),
        _conv(mid, mid, 3, 1), RefGDN(mid, True),
        _deconv(mid, mid), RefGDN(mid, True),
        _conv(mid, mid, 3, 1), RefGDN(mid, True),
        _deconv(mid, out_ch), RefGDN(out_ch, True),
        _deconv(out_ch, out_ch), RefGDN(out_ch, True),
        _conv(out_ch, out_ch, 3, 1))


def _upsample_plus_head(slice_in, conv_channels, n_tasks, out_ch):
    cc = conv_channels // n_tasks
    return nn.Sequential(
        _deconv(slice_in, cc), RefGDN(cc, True),
        _deconv(cc, cc), RefGDN(cc, True),
        _deconv(cc, cc), RefGDN(cc, True),
        _deconv(cc, conv_channels),
        _dec_head(conv_channels, out_ch))


class RefCodec(nn.Module):
    """The reference's state_dict layout for a mixed or shared codec over
    `in_chs` tasks (each task's output width its input width)."""

    def __init__(self, variant, m, c=C, in_chs=IN_CHS):
        super().__init__()
        n = c * len(in_chs)
        self.variant = variant
        self.cpt = m // (len(in_chs) + 1)
        compressor = {
            "g_a": nn.Sequential(
                _conv(n, n), RefGDN(n), _conv(n, n), RefGDN(n),
                _conv(n, n), RefGDN(n), _conv(n, m)),
            "h_a": nn.Sequential(
                _conv(m, n, 3, 1), nn.ReLU(), _conv(n, n), nn.ReLU(),
                _conv(n, n)),
            "h_s": nn.Sequential(
                _deconv(n, n), nn.ReLU(), _deconv(n, n), nn.ReLU(),
                _conv(n, m, 3, 1), nn.ReLU()),
            "entropy_bottleneck": RefEntropyBottleneck(n),
            "gaussian_conditional": RefGaussianConditional(),
        }
        if variant == "mixed":
            compressor["g_s"] = nn.Sequential(
                _deconv(m, n), RefGDN(n, True), _deconv(n, n),
                RefGDN(n, True), _deconv(n, n), RefGDN(n, True),
                _deconv(n, n))
            heads = [_dec_head(n, oc) for oc in in_chs]
        else:
            heads = [_upsample_plus_head(2 * self.cpt, c, len(in_chs), oc)
                     for oc in in_chs]
        self.model = nn.ModuleDict({
            "input_heads": nn.ModuleList([_enc_head(ic, c) for ic in in_chs]),
            "compressor": nn.ModuleDict(compressor),
            "output_heads": nn.ModuleList(heads),
        })
        self.loss_balancer = nn.ParameterDict(
            {"log_vars": nn.Parameter(torch.zeros(len(in_chs)))})

    @torch.no_grad()
    def forward_paths(self, xs):
        comp = self.model["compressor"]
        stacked = torch.cat([h(x) for h, x in
                             zip(self.model["input_heads"], xs)], dim=1)
        y = comp["g_a"](stacked)
        z = comp["h_a"](torch.abs(y))
        scales = comp["h_s"](torch.round(z))
        y_hat = torch.round(y)
        if self.variant == "mixed":
            u = comp["g_s"](y_hat)
            recs = [head(u) for head in self.model["output_heads"]]
        else:
            c = self.cpt
            recs = [head(torch.cat([y_hat[:, t * c:(t + 1) * c],
                                    y_hat[:, -c:]], dim=1))
                    for t, head in enumerate(self.model["output_heads"])]
        return y, z, scales, recs


def _reference(variant, seed):
    torch.manual_seed(seed)
    ref = RefCodec(variant, CONFIGS[variant][1]).eval()
    with torch.no_grad():
        for p in ref.parameters():
            p.add_(0.02 * torch.randn_like(p))
    return ref


def _port(variant, number=None):
    number = number or CONFIGS[variant][0]
    return build_model(number, TASKS, latent_channels=CONFIGS[variant][1],
                       conv_channels=C, device="cpu", seed=11)


def _jax_import(jmodel, state_dict, raw_gdn=False):
    """JAX's importer: with every module and the entropy bottleneck in the
    state_dict it gives the whole params tree (no init to graft onto)."""
    return {"params": j_import_reference_state_dict(state_dict, jmodel,
                                                    raw_gdn=raw_gdn)}


def _nchw(x):
    return np.transpose(np.asarray(x), (0, 3, 1, 2))


@pytest.fixture(scope="module", params=list(CONFIGS))
def imported(request):
    """The reference module, the port and mmnc_tpu's codec after each
    importer, a batch, and the reference's state_dict."""
    variant = request.param
    ref = _reference(variant, seed=3)
    sd = ref.state_dict()
    for key in ("model.compressor.gaussian_conditional.scale_table",
                "model.input_heads.0.1.beta_reparam.pedestal",
                "model.input_heads.0.1.gamma_reparam.lower_bound.bound",
                "model.compressor.entropy_bottleneck._quantized_cdf"):
        assert key in sd  # CompressAI's buffers are there to skip
    port = import_reference_state_dict(
        {"state_dict": sd, "epoch": 7, "global_step": 700}, _port(variant))
    jmodel = j_build_model(CONFIGS[variant][0], TASKS,
                           latent_channels=CONFIGS[variant][1],
                           conv_channels=C)
    variables = _jax_import(jmodel, sd)
    rng = np.random.default_rng(7)
    batch = {t: rng.random((2, 256, 256, c)).astype(np.float32)
             for t, c in zip(TASKS, IN_CHS)}
    return ref, port, jmodel, variables, batch, sd


def test_imported_parameters_equal_the_references(imported):
    ref, port, *_, sd = imported
    got = port.state_dict()
    params = {k for k, _ in ref.named_parameters()}
    assert set(got) == params
    for key in got:
        assert torch.equal(got[key], sd[key]), key


def test_latents_and_decode_equal_the_reference_and_mmnc_tpu(imported):
    ref, port, jmodel, variables, batch, _ = imported
    ty, tz, tscales, trecs = ref.forward_paths(
        [torch.from_numpy(_nchw(batch[t])) for t in TASKS])
    with torch.no_grad():
        py, pz = port.model.analyze(port._inputs(batch))
        pscales = port.model.compressor.hyper_synthesize(torch.round(pz))
    jy, jz = jmodel.net.apply(variables, {t: jnp.asarray(x)
                                          for t, x in batch.items()},
                              method=type(jmodel.net).analyze)
    for name, got, want_ref, want_jax in (("y", py, ty, jy),
                                          ("z", pz, tz, jz)):
        np.testing.assert_allclose(got.numpy(), want_ref.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=f"{name} vs reference")
        np.testing.assert_allclose(got.numpy(), _nchw(want_jax), rtol=RTOL,
                                   atol=ATOL, err_msg=f"{name} vs mmnc_tpu")
    np.testing.assert_allclose(pscales.numpy(), tscales.numpy(), rtol=RTOL,
                               atol=ATOL, err_msg="scales vs reference")
    y_hat = torch.round(py).permute(0, 2, 3, 1)
    recs = port.decode_from_latents(y_hat)
    jrecs = jmodel.decode_from_latents(variables, jnp.asarray(y_hat.numpy()),
                                       None)
    for t, task in enumerate(TASKS):
        got = _nchw(recs[task].numpy())
        np.testing.assert_allclose(got, trecs[t].numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=f"{task} vs reference")
        np.testing.assert_allclose(got, _nchw(jrecs[task]), rtol=RTOL,
                                   atol=ATOL, err_msg=f"{task} vs mmnc_tpu")


def test_eval_forward_equals_mmnc_tpus(imported):
    _, port, jmodel, variables, batch, _ = imported
    x_hats, liks = port(batch)
    j_hats, j_liks = jmodel.forward(variables, {t: jnp.asarray(x) for t, x
                                                in batch.items()})
    for task in TASKS:
        np.testing.assert_allclose(x_hats[task].numpy(),
                                   np.asarray(j_hats[task]), rtol=RTOL,
                                   atol=ATOL, err_msg=task)
    for k in ("y", "z"):
        np.testing.assert_allclose(liks[k].numpy(), np.asarray(j_liks[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("variant", list(CONFIGS))
def test_raw_gdn_equals_jax_raw_import(variant):
    ref = _reference(variant, seed=4)
    sd = ref.state_dict()
    port = import_reference_state_dict(sd, _port(variant), raw_gdn=True)
    jmodel = j_build_model(CONFIGS[variant][0], TASKS,
                           latent_channels=CONFIGS[variant][1],
                           conv_channels=C)
    want = state_dict_from_jax(jax.device_get(
        _jax_import(jmodel, sd, raw_gdn=True)["params"]))
    got = port.state_dict()
    assert set(got) == set(want)
    n_gdn = 0
    for key, w in want.items():
        np.testing.assert_allclose(got[key].numpy(), w.numpy(), rtol=1e-6,
                                   atol=0, err_msg=key)
        if key.endswith((".beta", ".gamma")):
            n_gdn += 1
            assert not torch.equal(got[key], sd[key]), key
    assert n_gdn > 0


@pytest.mark.parametrize("missing", [
    "model.compressor.g_a.0.weight", "model.input_heads.1.3.gamma",
    "model.output_heads.0.12.bias",
    "model.compressor.entropy_bottleneck._bias3"])
def test_a_missing_key_raises_naming_it(missing):
    sd = dict(_reference("mixed", seed=5).state_dict())
    del sd[missing]
    with pytest.raises(KeyError, match=missing.replace(".", "\\.")):
        import_reference_state_dict(sd, _port("mixed"))


def test_optional_keys_keep_the_models_values():
    """No entropy bottleneck (so no `_matrix0`), no `_factor{k}`, no
    `quantiles`, no `log_vars`: the model keeps its own."""
    sd = {k: v for k, v in _reference("mixed", seed=6).state_dict().items()
          if "entropy_bottleneck" not in k and "log_vars" not in k}
    port = _port("mixed")
    before = {k: v.clone() for k, v in port.state_dict().items()}
    import_reference_state_dict(sd, port)
    for key, v in port.state_dict().items():
        if "entropy_bottleneck" in key or "log_vars" in key:
            assert torch.equal(v, before[key]), key
        else:
            assert torch.equal(v, sd[key]), key


def test_a_model_without_uncertainty_weighting_skips_log_vars():
    """The single-task codec (mixed machinery, no loss balancer) from a
    reference state_dict of one task that carries `log_vars`."""
    torch.manual_seed(8)
    ref = RefCodec("mixed", 8, in_chs=(3,))
    sd = ref.state_dict()
    assert "loss_balancer.log_vars" in sd
    port = build_model(1, ["rgb"], latent_channels=8, conv_channels=C,
                       device="cpu")
    import_reference_state_dict(sd, port)
    got = port.state_dict()
    assert "loss_balancer.log_vars" not in got
    for key, v in got.items():
        assert torch.equal(v, sd[key]), key


def test_a_wrong_shape_raises():
    sd = dict(_reference("mixed", seed=5).state_dict())
    sd["model.compressor.g_a.1.beta"] = torch.ones(3)
    with pytest.raises(RuntimeError,
                       match="size mismatch for model.compressor.g_a.1.beta"):
        import_reference_state_dict(sd, _port("mixed"))
