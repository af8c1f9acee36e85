"""Export for serving: the detector as a self-contained ``torch.export``
artifact (counterpart of ``faster_rcnn_pytorch_tpu/serving.py``).

:func:`export_predict` captures ``predict`` at a fixed threshold, for one
canvas bucket and batch, as a ``torch.export`` program (``.pt2``). A
serving host loads it with :func:`load_artifact` and calls it with no
model code, no checkpoint plumbing and no config object: just ``(images,
extents) -> packed detections``. The RoI and NMS kernels are
``torch.library`` ops (``ops/library.py``), so the program calls them by
name: on the card it launches the hand-written kernels, on the CPU their
plain versions.

Artifact calling convention (one call per canvas bucket, the JAX
package's, so a client of either server sends the same thing):

  images  [B, H, W, 3] float32 - normalized canvas batch (the loader's
          contract: ImageNet-normalized, zero-padded to the canvas)
  extents [B, 2] float32       - valid (w, h) fraction per image
  ->      [B, D, 7] float32    - per-detection (x1, y1, x2, y2 in [0,1]
          canvas coords, label, score, valid>0.5)

An artifact is for one device: its constants (the canvas anchors, and the
weights unless they are a sidecar) live on the device it was traced on.
With a params sidecar (:data:`PARAMS_SIDECAR`, the serving-dtype weights,
shared by every bucket) the program takes the weights as its first
argument and holds none of them.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Callable

import torch
from torch import nn

from faster_rcnn_pytorch_tpu_torch.models.faster_rcnn import device_anchors, predict

#: the params sidecar's file name inside an export dir (one per dir).
PARAMS_SIDECAR = "weights.pt"

CALL = (
    "(images [B,H,W,3] f32, extents [B,2] f32) -> [B,D,7] "
    "f32 (x1,y1,x2,y2 canvas-[0,1], label, score, valid)"
)


def pack_detections(det) -> torch.Tensor:
    """``Detections -> [B, D, 7]`` float32 (x1, y1, x2, y2, label, score,
    valid): one buffer to copy to the host per batch."""
    return torch.cat(
        [
            det.boxes.float(),
            det.labels[..., None].float(),
            det.scores[..., None].float(),
            det.valid[..., None].float(),
        ],
        dim=-1,
    )


class ServingModule(nn.Module):
    """``predict`` at a fixed threshold as ``(images, extents) -> packed
    [B, D, 7]``. The model's weights are as it holds them: prepare it with
    ``utils/runtime.py::prepare_for_inference`` (serving dtype, FrozenBN
    in float32)."""

    def __init__(self, model, cfg, score_threshold: float | None = None):
        super().__init__()
        self.model = model
        self.cfg = cfg
        self.score_threshold = score_threshold

    def forward(self, images: torch.Tensor, extents: torch.Tensor) -> torch.Tensor:
        return pack_detections(predict(self.model, self.cfg, images, extents, self.score_threshold))


def make_serving_module(model, cfg, score_threshold: float | None = None):
    """The serving module of an inference-ready model (the JAX package's
    ``make_serving_fn``)."""
    return ServingModule(model, cfg, score_threshold).eval()


def serving_params(model) -> dict[str, torch.Tensor]:
    """The model's weights and buffers by name, each shared tensor once:
    the params sidecar, and the first argument of a sidecar program."""
    params = dict(model.named_parameters())
    params.update(model.named_buffers())
    return {k: v.detach() for k, v in params.items()}


class _ParamsAsArgs(nn.Module):
    """``(params, images, extents) -> packed``: the serving module with its
    model's tensors replaced by ``params`` (``torch.func.functional_call``).
    It runs a copy of the model whose own tensors are on the meta device
    (tracing through ``functional_call`` may leave its tensors swapped), held
    outside the module tree: a program exported from it holds no weight."""

    def __init__(self, serving: ServingModule):
        super().__init__()
        skeleton = copy.deepcopy(serving)
        skeleton.model.to("meta")
        object.__setattr__(self, "serving", skeleton)

    def forward(self, params: dict[str, torch.Tensor], images, extents):
        named = {f"model.{k}": v for k, v in params.items()}
        return torch.func.functional_call(self.serving, named, (images, extents))


def export_predict(
    model,
    cfg,
    canvas_hw: tuple[int, int],
    batch: int,
    score_threshold: float | None = None,
    params_as_args: bool = False,
) -> torch.export.ExportedProgram:
    """Export the predict program of an inference-ready model for one
    (canvas, batch) bucket, on the model's device, at the static shapes
    ``images [batch, h, w, 3]`` and ``extents [batch, 2]``. With
    ``params_as_args`` the program takes :func:`serving_params` as its
    first argument instead of holding the weights. Save it with
    :func:`save_artifact`."""
    device = next(model.parameters()).device
    h, w = canvas_hw
    images = torch.zeros((batch, h, w, 3), dtype=torch.float32, device=device)
    extents = torch.ones((batch, 2), dtype=torch.float32, device=device)
    device_anchors(model, h, w, device)  # made eagerly: a constant of the program
    serving = make_serving_module(model, cfg, score_threshold)
    with torch.no_grad():
        if params_as_args:
            args = (serving_params(model), images, extents)
            exported = torch.export.export(_ParamsAsArgs(serving), args)
        else:
            exported = torch.export.export(serving, (images, extents))
    exported.example_inputs = None  # torch.export.save would write them (the weights)
    return exported


def save_artifact(exported: torch.export.ExportedProgram, path: str) -> None:
    """``torch.export.save`` to ``path`` (atomic: a temporary file, then a
    rename)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        torch.export.save(exported, f)
    os.replace(tmp, path)


def load_artifact(path: str) -> Callable[..., torch.Tensor]:
    """A saved artifact as its callable program (the ``frcnn::*`` ops are
    registered first: the program calls them by name)."""
    from faster_rcnn_pytorch_tpu_torch.ops import library  # noqa: F401

    return torch.export.load(path).module()


def artifact_name(canvas_hw: tuple[int, int], batch: int, platform: str | None = None) -> str:
    """``predict_{h}x{w}_b{B}.pt2``; with ``platform`` (several devices
    exported into one dir) ``predict_{h}x{w}_b{B}_{platform}.pt2``."""
    suffix = f"_{platform}" if platform else ""
    return f"predict_{canvas_hw[0]}x{canvas_hw[1]}_b{batch}{suffix}.pt2"


def save_params_sidecar(model, path: str) -> None:
    """The serving-dtype weights (:func:`serving_params`) as one
    ``torch.save`` file (atomic write)."""
    tmp = path + ".tmp"
    torch.save({k: v.cpu() for k, v in serving_params(model).items()}, tmp)
    os.replace(tmp, path)


def load_params_sidecar(path: str, device) -> dict[str, torch.Tensor]:
    """The sidecar's weights on ``device``, loaded once and handed to every
    bucket's program on every call."""
    return torch.load(path, map_location=device, weights_only=True)


class ExportedDetector:
    """Manifest-driven serving entry point: routes each request to the
    artifact of its ``(batch, canvas)`` bucket for one platform (``cuda``
    or ``cpu``; ``None`` takes every entry, for a dir of one platform).

    >>> det = ExportedDetector("./export", "cuda")
    >>> packed = det(images, extents)   # shapes pick the artifact

    Artifacts load lazily on first use and are cached. Inputs are tensors
    on the platform's device; ``buckets()`` lists the ``(batch, (h, w))``
    combinations.
    """

    def __init__(self, export_dir: str, platform: str | None = None):
        self.export_dir = export_dir
        self.platform = platform
        with open(os.path.join(export_dir, "manifest.json")) as f:
            self.manifest = json.load(f)
        self._index: dict[tuple[int, int, int], str] = {}
        self._entry: dict[tuple[int, int, int], dict] = {}
        for e in self.manifest["artifacts"]:
            if platform is not None and platform not in e.get("platforms", [platform]):
                continue
            h, w = e["canvas_hw"]
            key = (int(e["batch"]), int(h), int(w))
            self._index[key] = os.path.join(export_dir, e["file"])
            self._entry[key] = e
        self._cache: dict[tuple[int, int, int], Callable] = {}
        self._sidecar_params = None  # lazy, shared across buckets

    def buckets(self) -> list[tuple[int, tuple[int, int]]]:
        return [(b, (h, w)) for (b, h, w) in sorted(self._index)]

    def __call__(self, images: torch.Tensor, extents: torch.Tensor) -> torch.Tensor:
        b, h, w = int(images.shape[0]), int(images.shape[1]), int(images.shape[2])
        key = (b, h, w)
        if key not in self._index:
            raise ValueError(
                f"no artifact for batch={b} canvas={h}x{w}; available: {self.buckets()}"
            )
        if key not in self._cache:
            call = load_artifact(self._index[key])
            if self._entry[key].get("params_as_args"):
                if self._sidecar_params is None:
                    path = self.manifest.get("params_file", PARAMS_SIDECAR)
                    self._sidecar_params = load_params_sidecar(
                        os.path.join(self.export_dir, path), images.device
                    )
                params = self._sidecar_params
                self._cache[key] = lambda img, ext, _c=call, _p=params: _c(_p, img, ext)
            else:
                self._cache[key] = call
        with torch.no_grad():
            return self._cache[key](images, extents)


def write_manifest(out_dir: str, entries: list[dict], opts=None, extra: dict | None = None) -> str:
    """``manifest.json`` describing the artifacts: calling convention,
    canvas buckets, platforms, class metadata.

    Merges with an existing manifest in ``out_dir`` (entries keyed by file
    name): exporting extra batch sizes into the same directory must not
    orphan the earlier artifacts.
    """
    prev_path = os.path.join(out_dir, "manifest.json")
    if os.path.exists(prev_path):
        try:
            with open(prev_path) as f:
                prev = json.load(f).get("artifacts", [])
        except (OSError, ValueError):
            prev = []
        new_files = {e["file"] for e in entries}
        entries = [e for e in prev if e.get("file") not in new_files] + entries
    manifest = {"format": "torch.export", "call": CALL, "artifacts": entries}
    if opts is not None:
        manifest["model_generation"] = opts.model_generation
        manifest["data_type"] = opts.data_type
        manifest["num_classes"] = opts.num_classes
        manifest["score_threshold"] = opts.thres
    if extra:
        manifest.update(extra)
    path = os.path.join(out_dir, "manifest.json")
    with open(path, "w") as f:
        json.dump(manifest, f, indent=2)
    return path
