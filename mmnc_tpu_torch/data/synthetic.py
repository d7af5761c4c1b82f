"""Procedural multi-task dataset: aligned rgb / depth / normal / semantic.

A copy of mmnc_tpu/data/synthetic.py: the same numpy generator, so the
same seed gives the same bytes in both packages. The class keeps its
name, which the prerender cache key hashes.

Capability stand-in for Taskonomized CLEVR (reference C12) that needs no
downloads: each index renders a deterministic scene of colored primitives
on a ground plane and derives every modality from the same geometry, so
the cross-task structure the multi-task codecs exploit is real. Used by
tests, the training-demo CLI, and the benchmark.

Two render styles:

* ``style="clevr"`` — matches the *statistics* of the reference data
  (src/datasets/clevr.py: CLEVR renders resized 512->256): a fixed
  8-color CLEVR palette, 3 shape classes x 2 sizes, 3..7 objects with
  perspective-ish ground placement, Lambertian shading, soft ground
  shadows, and analytically antialiased rgb edges. Label modalities
  (depth/normal/semantic) stay hard-edged, mirroring the reference's
  NEAREST resize for labels vs bilinear for rgb
  (src/datasets/transforms.py:76-83). Low scene entropy by design —
  CLEVR's whole point is a small describable vocabulary, which is what
  makes the paper's 1x1xM global-latent codec work (DESIGN.md "The PSNR
  plateau").
* ``style="legacy"`` — the round 1-3 renderer (aliased edges, continuous
  random colors). Kept so earlier prerender caches/tests stay valid.

Conventions match the reference data pipeline (SURVEY.md C12-C14):
float32 NHWC in [0,1]; depth_euclidean is 1-channel; normal is 3-channel
in [0,1] (n/2+0.5); semantic is 1-channel float class indices 0..16;
mono is 1-channel grayscale.
"""

from typing import Sequence

import numpy as np

_ALL_TASKS = ("rgb", "depth_euclidean", "normal", "semantic", "mono")

# CLEVR's 8 fixed object colors (gray, red, blue, green, brown, purple,
# cyan, yellow), unit-scaled.
_CLEVR_PALETTE = np.array([
    [87, 87, 87], [173, 35, 35], [42, 75, 215], [29, 105, 20],
    [129, 74, 25], [129, 38, 192], [41, 208, 208], [255, 238, 51],
], np.float32) / 255.0

_LIGHT = np.array([-0.35, -0.5, 0.79], np.float32)  # toward upper-left
_LIGHT /= np.linalg.norm(_LIGHT)


class SyntheticMultiTaskDataset:
    def __init__(self, tasks: Sequence[str], size: int = 1024,
                 image_size: int = 256, seed: int = 0,
                 style: str = "legacy"):
        for t in tasks:
            assert t in _ALL_TASKS, f"unknown task {t}"
        assert style in ("legacy", "clevr"), style
        self.tasks = list(tasks)
        self.size = size
        self.image_size = image_size
        self.seed = seed
        self.style = style

    def __len__(self):
        return self.size

    def _render(self, index: int):
        if self.style == "clevr":
            return self._render_clevr(index)
        return self._render_legacy(index)

    # --- clevr style -------------------------------------------------------

    def _render_clevr(self, index: int):
        n = self.image_size
        rng = np.random.default_rng((self.seed << 20) + index)
        yy, xx = (np.mgrid[0:n, 0:n].astype(np.float32) + 0.5) / n

        # uniform gray ground with a soft vertical light falloff
        ground_shade = 0.62 + 0.10 * yy
        rgb = np.repeat(ground_shade[..., None], 3, axis=-1)
        depth = 0.92 - 0.45 * yy               # far at top, near at bottom
        normal = np.zeros((n, n, 3), np.float32)
        normal[..., 1] = -0.45
        normal[..., 2] = 0.893                 # tilted-up ground
        sem = np.zeros((n, n), np.float32)

        n_obj = int(rng.integers(3, 8))
        objs = []
        for _ in range(n_obj):
            gz = rng.random()                  # 0 near .. 1 far
            objs.append({
                "gz": gz,
                "cx": 0.12 + 0.76 * rng.random(),
                "cy": 0.78 - 0.50 * gz + 0.06 * rng.random(),
                "size_idx": int(rng.integers(0, 2)),
                "color_idx": int(rng.integers(0, 8)),
                "shape": int(rng.integers(0, 3)),   # sphere, cube, cylinder
            })
        # paint far -> near; the z-test still guards edge cases
        objs.sort(key=lambda o: -o["gz"])

        px = 1.5 / n                           # ~1.5px antialiasing band
        for o in objs:
            scale = 1.0 - 0.55 * o["gz"]       # perspective shrink
            r = (0.055, 0.095)[o["size_idx"]] * scale
            cx, cy, gz = o["cx"], o["cy"], o["gz"]
            z = 0.35 + 0.5 * gz
            color = _CLEVR_PALETTE[o["color_idx"]]
            dx, dy = xx - cx, yy - cy

            if o["shape"] == 0:          # sphere
                u = np.sqrt(dx * dx + dy * dy) / r
                alpha = np.clip((1.0 - u) * (r / px), 0.0, 1.0)
                h = np.sqrt(np.clip(1.0 - u * u, 0.0, 1.0))
                obj_n = np.stack([dx / r, dy / r, h], -1)
                obj_n /= np.maximum(
                    np.linalg.norm(obj_n, axis=-1, keepdims=True), 1e-6)
                obj_depth = z - 0.08 * h * r / 0.095
            elif o["shape"] == 1:        # cube (front face + lit top strip)
                w_, h_ = r * 0.92, r * 0.92
                ax = np.clip((w_ - np.abs(dx)) / px, 0.0, 1.0)
                ay = np.clip((h_ - np.abs(dy)) / px, 0.0, 1.0)
                alpha = ax * ay
                top = (cy - dy) < (cy - h_ + 0.38 * r)   # top strip
                obj_n = np.zeros((n, n, 3), np.float32)
                obj_n[..., 1] = np.where(top, -0.83, 0.0)
                obj_n[..., 2] = np.where(top, 0.55, 1.0)
                obj_depth = np.full((n, n), z, np.float32)
            else:                        # cylinder: body + elliptical cap
                w_, h_ = r * 0.75, r * 1.1
                theta = np.clip(dx / w_, -1.0, 1.0)
                body_ax = np.clip((w_ - np.abs(dx)) / px, 0.0, 1.0)
                body_ay = np.clip((h_ - np.abs(dy)) / px, 0.0, 1.0)
                body = body_ax * body_ay
                cap_u = np.sqrt((dx / w_) ** 2
                                + ((dy + h_) / (0.35 * w_)) ** 2)
                cap = np.clip((1.0 - cap_u) * (0.35 * w_ / px), 0.0, 1.0)
                alpha = np.maximum(body, cap)
                s = np.sqrt(np.clip(1.0 - theta * theta, 0.0, 1.0))
                obj_n = np.stack(
                    [theta, np.zeros_like(theta), s], -1)
                obj_n = np.where(cap[..., None] > body[..., None],
                                 np.array([0.0, -0.83, 0.55], np.float32),
                                 obj_n)
                obj_depth = np.full((n, n), z, np.float32)

            lam = np.clip(np.sum(obj_n * _LIGHT, axis=-1), 0.0, 1.0)
            shade = (0.35 + 0.65 * lam)[..., None]
            obj_rgb = color * shade

            zmask = (alpha > 0.0) & (obj_depth <= depth)
            a = np.where(zmask, alpha, 0.0)[..., None]
            rgb = rgb * (1.0 - a) + obj_rgb * a
            hard = (a[..., 0] > 0.5)
            depth = np.where(hard, obj_depth, depth)
            normal = np.where(hard[..., None], obj_n, normal)
            cls = 1.0 + o["color_idx"] * 2 + o["size_idx"]
            sem = np.where(hard, cls, sem)

            # soft elliptical contact shadow, offset along the light;
            # applied immediately so nearer objects painted later cover it
            sx = cx + 0.35 * r * _LIGHT[0] / max(_LIGHT[2], 0.3)
            sy = cy + r * 0.55
            su = np.sqrt(((xx - sx) / (1.5 * r)) ** 2
                         + ((yy - sy) / (0.55 * r)) ** 2)
            soft = np.clip(1.0 - su, 0.0, 1.0) ** 2
            sh = 1.0 - 0.35 * soft * (sem == 0)
            rgb = rgb * sh[..., None]
        out = {
            "rgb": np.clip(rgb, 0, 1).astype(np.float32),
            "depth_euclidean": depth[..., None].astype(np.float32),
            "normal": np.clip(normal * 0.5 + 0.5, 0, 1).astype(np.float32),
            "semantic": sem[..., None].astype(np.float32),
            "mono": np.clip(rgb.mean(-1, keepdims=True), 0, 1)
                      .astype(np.float32),
        }
        return out

    # --- legacy style ------------------------------------------------------

    def _render_legacy(self, index: int):
        n = self.image_size
        rng = np.random.default_rng((self.seed << 20) + index)

        yy, xx = np.mgrid[0:n, 0:n].astype(np.float32) / n

        # ground plane: depth grows toward the top of the image
        depth = 0.55 + 0.4 * (1.0 - yy)
        normal = np.zeros((n, n, 3), np.float32)
        normal[..., 1] = 0.85   # up-facing ground
        normal[..., 2] = 0.53
        base = 0.25 + 0.15 * rng.random()
        rgb = np.stack([np.full((n, n), base + 0.05 * c, np.float32)
                        for c in range(3)], -1)
        rgb *= (0.8 + 0.4 * yy)[..., None]
        sem = np.zeros((n, n), np.float32)

        n_obj = rng.integers(3, 8)
        for _ in range(n_obj):
            cx, cy = rng.random(2) * 0.8 + 0.1
            r = 0.05 + 0.12 * rng.random()
            color = rng.random(3) * 0.8 + 0.2
            z = 0.2 + 0.6 * rng.random()
            kind = rng.integers(0, 2)
            if kind == 0:  # sphere
                d2 = ((xx - cx) ** 2 + (yy - cy) ** 2) / (r ** 2)
                mask = d2 < 1.0
                h = np.sqrt(np.clip(1.0 - d2, 0, 1))
                obj_depth = z - 0.1 * h * r
                nx = (xx - cx) / r
                ny = (yy - cy) / r
                obj_n = np.stack([nx, ny, h], -1)
                obj_n /= np.maximum(
                    np.linalg.norm(obj_n, axis=-1, keepdims=True), 1e-6)
                cls = 1 + int(rng.integers(0, 8))
            else:  # axis-aligned box
                w_, h_ = r, r * (0.5 + rng.random())
                mask = (np.abs(xx - cx) < w_) & (np.abs(yy - cy) < h_)
                obj_depth = np.full((n, n), z, np.float32)
                obj_n = np.zeros((n, n, 3), np.float32)
                obj_n[..., 2] = 1.0
                cls = 9 + int(rng.integers(0, 8))

            vis = mask & (obj_depth < depth)
            depth = np.where(vis, obj_depth, depth)
            shade = 0.6 + 0.4 * (1 - z)
            for c in range(3):
                rgb[..., c] = np.where(vis, color[c] * shade, rgb[..., c])
            for c in range(3):
                normal[..., c] = np.where(vis, obj_n[..., c], normal[..., c])
            sem = np.where(vis, float(cls), sem)

        out = {
            "rgb": np.clip(rgb, 0, 1),
            "depth_euclidean": depth[..., None],
            "normal": np.clip(normal * 0.5 + 0.5, 0, 1),
            "semantic": sem[..., None],
            "mono": np.clip(rgb.mean(-1, keepdims=True), 0, 1),
        }
        return out

    def __getitem__(self, index: int):
        scene = self._render(index)
        return {t: scene[t].astype(np.float32) for t in self.tasks}
