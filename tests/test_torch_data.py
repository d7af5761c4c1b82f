"""The port's data pipeline against mmnc_tpu's on the CPU: synthetic scenes
(both styles, every task, three seeds), the prerender cache key and
cross-reading of caches, BatchLoader's batches, CLEVR samples from a PNG
fixture, the device-resident dataset's gathered batches (bitwise) and
prefetch on the CPU. MNIST is not tested: it needs torchvision, which
neither package's tests have."""

import importlib

import numpy as np
import pytest
import torch
from PIL import Image

from mmnc_tpu.data import clevr as j_clevr
from mmnc_tpu.data import device_cache as j_device_cache
from mmnc_tpu.data import loader as j_loader
from mmnc_tpu.data import synthetic as j_synthetic

from mmnc_tpu_torch import data
from mmnc_tpu_torch.data.task_configs import SEM_CLASSES

# the modules (each package's data/__init__ exports a function of the name)
j_prerender = importlib.import_module("mmnc_tpu.data.prerender")
t_prerender = importlib.import_module("mmnc_tpu_torch.data.prerender")

ALL_TASKS = ["rgb", "depth_euclidean", "normal", "semantic", "mono"]


def _bitwise(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("style", ["legacy", "clevr"])
@pytest.mark.parametrize("seed", [0, 7, 10 ** 6])
def test_synthetic_samples_equal_jax_bytes(style, seed):
    kw = dict(size=4, image_size=64, seed=seed, style=style)
    j = j_synthetic.SyntheticMultiTaskDataset(ALL_TASKS, **kw)
    t = data.SyntheticMultiTaskDataset(ALL_TASKS, **kw)
    for i in (0, 3):
        sj, st = j[i], t[i]
        assert list(sj) == list(st) == ALL_TASKS
        for task in ALL_TASKS:
            _bitwise(sj[task], st[task])


def test_synthetic_full_size_clevr_sample_equals_jax():
    j = j_synthetic.SyntheticMultiTaskDataset(["rgb", "semantic"], size=2,
                                              style="clevr")
    t = data.SyntheticMultiTaskDataset(["rgb", "semantic"], size=2,
                                       style="clevr")
    for task in ("rgb", "semantic"):
        _bitwise(j[1][task], t[1][task])


@pytest.mark.parametrize("style", ["legacy", "clevr"])
def test_prerender_cache_key_equals_jax(style, tmp_path):
    kw = dict(size=5, image_size=32, seed=3, style=style)
    j = j_synthetic.SyntheticMultiTaskDataset(["rgb", "normal"], **kw)
    t = data.SyntheticMultiTaskDataset(["rgb", "normal"], **kw)
    assert (t_prerender._dataset_cache_key(t)
            == j_prerender._dataset_cache_key(j))
    jc = j_clevr.CLEVRDataset(str(tmp_path), ["rgb"], "val", 64)
    tc = data.CLEVRDataset(str(tmp_path), ["rgb"], "val", 64)
    assert (t_prerender._dataset_cache_key(tc)
            == j_prerender._dataset_cache_key(jc))


def _counting(dataset):
    """Count the scenes `dataset` renders (an instance attribute, so the
    class name in the cache key is unchanged)."""
    calls = []
    render = dataset._render

    def counted(index):
        calls.append(index)
        return render(index)

    dataset._render = counted
    return calls


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_prerender_cache(writer, tmp_path):
    kw = dict(size=6, image_size=32, seed=5, style="clevr")
    tasks = ["rgb", "semantic"]
    j = j_synthetic.SyntheticMultiTaskDataset(tasks, **kw)
    t = data.SyntheticMultiTaskDataset(tasks, **kw)
    first, second = ((t_prerender.prerender, t), (j_prerender.prerender, j))
    if writer == "jax":
        first, second = second, first
    written = first[0](first[1], str(tmp_path))
    calls = _counting(second[1])
    read = second[0](second[1], str(tmp_path))
    # prerender renders sample 0 to learn the tasks, then hits the cache
    assert calls == [0]
    for task in tasks:
        _bitwise(written.arrays[task], read.arrays[task])


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("prerendered", [False, True])
def test_batch_loader_equals_jax_over_two_epochs(shuffle, workers,
                                                 prerendered):
    kw = dict(size=10, image_size=32, seed=1)
    jd = j_synthetic.SyntheticMultiTaskDataset(["rgb", "depth_euclidean"],
                                               **kw)
    td = data.SyntheticMultiTaskDataset(["rgb", "depth_euclidean"], **kw)
    if prerendered:
        jd, td = j_prerender.prerender(jd), t_prerender.prerender(td)
    jl = j_loader.BatchLoader(jd, 3, shuffle=shuffle, num_epochs=2,
                              num_workers=workers)
    tl = data.BatchLoader(td, 3, shuffle=shuffle, num_epochs=2,
                          num_workers=workers)
    jb, tb = list(jl), list(tl)
    jl.close()
    tl.close()
    assert len(jb) == len(tb) == 6  # drop_last: 3 batches an epoch
    for a, b in zip(jb, tb):
        assert list(a) == list(b)
        for task in a:
            _bitwise(a[task], b[task])


@pytest.fixture(scope="module")
def clevr_root(tmp_path_factory):
    """tests/test_clevr.py's kind of fixture: 512 px PNGs of rgb (8-bit),
    depth (16-bit) and semantic labels (classes in G), plus normals."""
    root = tmp_path_factory.mktemp("clevr_port")
    rng = np.random.default_rng(0)
    for i in range(2):
        d = root / "rgb" / "val"
        d.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 255, (512, 512, 3), dtype=np.uint8)
                        ).save(d / f"point_{i}_view_0_domain_rgb.png")
        d = root / "normal" / "val"
        d.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 255, (512, 512, 3), dtype=np.uint8)
                        ).save(d / f"point_{i}_view_0_domain_normal.png")
        d = root / "depth_euclidean" / "val"
        d.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 8000, (512, 512), dtype=np.uint16)
                        ).save(
            d / f"point_{i}_view_0_domain_depth_euclidean.png")
        d = root / "semantic" / "val"
        d.mkdir(parents=True, exist_ok=True)
        sem = np.zeros((512, 512, 3), np.uint8)
        sem[..., 1] = rng.choice(np.asarray(SEM_CLASSES, np.uint8),
                                 size=(512, 512))
        Image.fromarray(sem).save(d / f"point_{i}_view_0_domain_semantic.png")
    return str(root)


@pytest.mark.parametrize("image_size", [256, 512])
def test_clevr_samples_equal_jax(clevr_root, image_size):
    tasks = ["rgb", "normal", "depth_euclidean", "semantic"]
    j = j_clevr.CLEVRDataset(clevr_root, tasks, "val", image_size)
    t = data.CLEVRDataset(clevr_root, tasks, "val", image_size)
    assert len(j) == len(t)
    for i in range(2):
        sj, st = j[i], t[i]
        for task in tasks:
            _bitwise(sj[task], st[task])


def _cache_arrays():
    rng = np.random.default_rng(0)
    return {"rgb": rng.random((12, 16, 16, 3), dtype=np.float32),
            "normal": rng.random((12, 16, 16, 3), dtype=np.float32) * 2 - 1,
            "semantic": np.floor(rng.random((12, 16, 16, 1),
                                            dtype=np.float32) * 16.99),
            "wide": rng.random((12, 16, 16, 2), dtype=np.float32) * 7.3 - 2.2}


@pytest.mark.parametrize("quantize", [True, False])
def test_device_cache_batches_bitwise_equal_jax(quantize):
    arrays = _cache_arrays()
    j = j_device_cache.DeviceResidentDataset(arrays, quantize=quantize)
    t = data.DeviceResidentDataset(arrays, quantize=quantize, device="cpu")
    assert t.device_resident and t._scales == j._scales
    for idx in ([0, 5, 11, 5], [3], list(range(12))):
        bj, bt = j.get_batch(idx), t.get_batch(idx)
        for task in arrays:
            assert bt[task].device.type == "cpu"
            _bitwise(bj[task], bt[task].numpy())
            # within half a quantization step of the host data, plus the
            # float32 rounding of the step and of the result (a few ulps)
            lo, hi = t._scales.get(task, (0.0, 1.0))
            err = np.abs(bt[task].numpy() - arrays[task][idx]).max()
            ulps = 4 * np.finfo(np.float32).eps * max(abs(lo), abs(hi))
            assert err <= (hi - lo) / 65535 / 2 + ulps if quantize \
                else err == 0
    sj, st = j[7], t[7]
    for task in arrays:
        _bitwise(sj[task], st[task])


def test_device_cache_subset_shares_storage():
    t = data.DeviceResidentDataset(_cache_arrays(), device="cpu")
    view = t.subset_tasks(["semantic", "rgb"])
    assert view.tasks == ["semantic", "rgb"] and view.device_resident
    assert view._dev["rgb"].data_ptr() == t._dev["rgb"].data_ptr()
    assert set(view._scales) == {"semantic", "rgb"}
    batch = view.get_batch([1, 2])
    assert list(batch) == ["semantic", "rgb"]
    _bitwise(batch["rgb"].numpy(), t.get_batch([1, 2])["rgb"].numpy())


def test_device_cache_through_batch_loader():
    arrays = _cache_arrays()
    j = j_loader.BatchLoader(j_device_cache.DeviceResidentDataset(arrays), 4)
    t = data.BatchLoader(data.DeviceResidentDataset(arrays, device="cpu"), 4)
    for a, b in zip(j.epoch(1), t.epoch(1)):
        for task in arrays:
            _bitwise(a[task], b[task].numpy())


def test_prefetch_on_the_cpu_yields_the_host_batches():
    loader = data.BatchLoader(data.SyntheticMultiTaskDataset(
        ["rgb", "semantic"], size=8, image_size=32), 2)
    host = list(loader.epoch(0))
    stats = {}
    got = list(data.prefetch_to_device(loader.epoch(0), device="cpu",
                                       stats=stats))
    assert len(got) == len(host) == 4 and stats["batches"] == 4
    for h, g in zip(host, got):
        for task in h:
            assert isinstance(g[task], torch.Tensor)
            _bitwise(h[task], g[task].numpy())


def test_prefetch_without_a_card_or_device_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    loader = data.BatchLoader(data.SyntheticMultiTaskDataset(
        ["rgb"], size=4, image_size=32), 2)
    # raised by the call, before a batch is asked for
    with pytest.raises(RuntimeError, match="no CUDA device"):
        data.prefetch_to_device(loader.epoch(0))


def test_device_cache_without_a_card_or_device_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        data.DeviceResidentDataset(_cache_arrays())
