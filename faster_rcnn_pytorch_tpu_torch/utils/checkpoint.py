"""Train-state checkpoints: save, resume and retention, torch-native.

Counterpart of the save/load/naming/pruning half of
``faster_rcnn_pytorch_tpu/utils/checkpoint.py``. A checkpoint holds
``{"model", "optimizer", "step", "metadata"}`` at
``{log_dir}/{name}/saves/{name}.{epoch}.pt`` plus a ``best`` copy, in
one of two backends (``--ckpt_backend``):

* ``flax`` (the default): one ``torch.save`` file, written atomically
  (tmp file, then ``os.replace``);
* ``orbax``: a directory written by ``torch.distributed.checkpoint``
  (the model's and the momentum's tensors under flat keys, the rest as
  JSON), into ``<path>.tmp`` and renamed when complete.
  ``--async_checkpoint`` writes it with ``dcp.async_save``: the state is
  copied to host memory, then written while training goes on; at most
  one save is in flight, and :func:`wait_for_checkpoints` finishes it
  (before a prune, a new save, a load, and the end of a run).

Whatever the world size and ``--model_parallel``, a checkpoint holds the
single-device state in the reference layout, both classifier aliases
included: the fc6/fc7 shards and their momentum are gathered first (a
collective: every rank calls :func:`save_checkpoint`), then global rank 0
alone writes it, without a process group (``no_dist``), so each file has
one writer. A load reads the single-device state on every rank and keeps
this rank's shards. :func:`load_checkpoint` tells the backends apart by
whether the path is a file or a directory. The suffix is ``.pt``, not the
JAX package's ``.ckpt``, so a flax checkpoint is never read as a torch one. Reference-layout ``.pth``/``.pth.tar``
weights are read by ``utils/convert.load_reference_checkpoint``.
:func:`init_params` is every CLI's starting weights (the JAX package's
``main.init_params``: a seeded fresh init, with ``--pretrained_backbone``
an ImageNet backbone, or a reference import, with ``--checkpoint
pretrained`` the released demo detector), and
:func:`resolve_and_load_params` the eval CLIs' checkpoint policy (the
JAX package's function of that name).
"""

from __future__ import annotations

import json
import os
import re
import shutil

import torch

from faster_rcnn_pytorch_tpu_torch.parallel import tensor_parallel as tp
from faster_rcnn_pytorch_tpu_torch.parallel.mesh import layout

SUFFIX = ".pt"
BACKENDS = ("flax", "orbax")


def checkpoint_path(log_dir: str, name: str, epoch: int | str) -> str:
    return os.path.join(log_dir, name, "saves", f"{name}.{epoch}{SUFFIX}")


def _payload(state, metadata: dict | None) -> dict:
    """The single-device checkpoint of ``state`` (shards gathered over the
    model group: a collective)."""
    group = layout().model_group
    return {
        "model": tp.gather_state_dict(state.model, group),
        "optimizer": tp.gather_optimizer_state(state.model, state.optimizer, group),
        "step": state.step,
        "metadata": metadata or {},
    }


def save_checkpoint(
    path: str,
    state,
    metadata: dict | None = None,
    backend: str = "flax",
    async_save: bool = False,
) -> None:
    """Write ``state`` (a ``parallel.train_step.TrainState``) in the
    single-device layout. Every rank calls it; global rank 0 writes.
    ``backend`` ``orbax`` writes a directory, with ``async_save``
    without waiting for the write (module docstring)."""
    if backend not in BACKENDS:
        raise ValueError(f"--ckpt_backend must be one of {BACKENDS}, not {backend!r}")
    payload = _payload(state, metadata)
    if layout().rank != 0:
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if backend == "orbax":
        _save_dir(path, payload, async_save)
        return
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


# The directory save in flight: (future, tmp dir, final path).
_PENDING: list = []
_CPU_GROUP = []


def _flatten(payload: dict) -> dict:
    """Flat keys for DCP; a tensor held under two names (the classifier's
    aliases) is written once and the second name recorded."""
    flat, aliases, seen = {}, {}, {}
    for k, v in payload["model"].items():
        key = (v.data_ptr(), tuple(v.shape), v.stride())
        if key in seen:
            aliases[k] = seen[key]
        else:
            seen[key] = k
            flat[f"model/{k}"] = v
    for i, st in payload["optimizer"]["state"].items():
        for k, v in st.items():
            flat[f"optimizer/{i}/{k}"] = v
    flat["extra"] = json.dumps(
        {
            "param_groups": payload["optimizer"]["param_groups"],
            "step": payload["step"],
            "metadata": payload["metadata"],
            "aliases": aliases,
        }
    )
    return flat


def _unflatten(flat: dict) -> dict:
    extra = json.loads(flat.pop("extra"))
    model, state = {}, {}
    for key, v in flat.items():
        kind, _, rest = key.partition("/")
        if kind == "model":
            model[rest] = v
        else:
            i, _, k = rest.partition("/")
            state.setdefault(int(i), {})[k] = v
    for alias, name in extra["aliases"].items():
        model[alias] = model[name]
    optimizer = {"state": state, "param_groups": extra["param_groups"]}
    return {"model": model, "optimizer": optimizer, "step": extra["step"], "metadata": extra["metadata"]}


def _async_group():
    """``dcp.async_save`` asks a process group with a CPU backend of a run
    that has one: a gloo group of rank 0 alone (made by rank 0 only) when
    the run's group is NCCL. None without a process group."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return None
    if torch.device("cpu") in dist.group.WORLD._device_types:
        return dist.group.WORLD
    if not _CPU_GROUP:
        _CPU_GROUP.append(dist.new_group([0], backend="gloo", use_local_synchronization=True))
    return _CPU_GROUP[0]


def _save_dir(path: str, payload: dict, async_save: bool) -> None:
    import torch.distributed.checkpoint as dcp

    wait_for_checkpoints()  # at most one save in flight
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    flat = _flatten(payload)
    if async_save:
        future = dcp.async_save(flat, checkpoint_id=tmp, no_dist=True, process_group=_async_group())
        _PENDING.append((future, tmp, path))
        return
    dcp.save(flat, checkpoint_id=tmp, no_dist=True)
    _finish(tmp, path)


def _finish(tmp: str, path: str) -> None:
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.replace(tmp, path)


def saving() -> bool:
    """Whether a directory save is still being written."""
    return any(not future.done() for future, _, _ in _PENDING)


def wait_for_checkpoints() -> None:
    """Block until the directory save in flight (if any) is written, then
    move it to its path. Call it before exit."""
    while _PENDING:
        future, tmp, path = _PENDING.pop()
        future.result()
        _finish(tmp, path)


def _read(path: str, model_only: bool = False) -> dict:
    """A checkpoint of either backend as ``{"model", "optimizer", "step",
    "metadata"}`` of CPU tensors (``model_only``: the model and the
    metadata; a file's optimizer state is then mapped, not read)."""
    wait_for_checkpoints()
    if not os.path.isdir(path):
        return torch.load(path, map_location="cpu", weights_only=True, mmap=model_only)
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint import FileSystemReader
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    reader = FileSystemReader(path)
    template = {}
    for key, md in reader.read_metadata().state_dict_metadata.items():
        if model_only and key.startswith("optimizer/"):
            continue
        if isinstance(md, TensorStorageMetadata):
            template[key] = torch.empty(md.size, dtype=md.properties.dtype)
        else:
            template[key] = None
    dcp.load(template, storage_reader=reader, no_dist=True)
    return _unflatten(template)


def load_checkpoint(path: str, state):
    """Restore ``state`` in place from ``path`` (a file or a directory);
    returns ``(state, metadata)``. A split model keeps its shards of the
    single-device state; tensors land on the model's device."""
    payload = _read(path)
    lay = layout()
    rank, size = lay.model_rank, lay.model_parallel
    state.model.load_state_dict(
        tp.shard_state_dict(state.model, payload["model"], rank, size), strict=True
    )
    state.optimizer.load_state_dict(
        tp.shard_optimizer_state(state.model, state.optimizer, payload["optimizer"], rank, size)
    )
    state.step = int(payload["step"])
    return state, payload["metadata"]


def resolve_and_load_params(opts, model: torch.nn.Module) -> str:
    """Load the weights ``opts.checkpoint`` names into ``model`` (the
    counterpart of the JAX package's ``main.init_params`` followed by its
    ``resolve_and_load_params``, one policy for the eval CLIs). Returns a
    note for the console.

    * ``pretrained``, ``*.pth`` / ``*.pth.tar``: reference-layout weights,
      imported by :func:`init_params` (``pretrained`` is the released demo
      detector, ``utils/pretrained.py::fetch("frcnn_demo")``).
    * ``*.pt``: a port train checkpoint (a file, or a directory of the
      ``orbax`` backend), which must exist; only its ``model`` entry is
      loaded (``strict=True``).
    * empty: the run's ``{log_dir}/{name}/saves/{name}.{test_epoch}.pt``.
      If it is missing, the model keeps :func:`init_params`' fresh init
      (seeded by ``opts.seed``, the backbone from
      ``--pretrained_backbone`` if given) and the note names the missing
      path.
    * anything else: ``ValueError``, before any weight is read. Going on
      with random weights after a typo in the path is the worst failure
      an eval CLI can have.

    As in the JAX package, :func:`init_params` runs first in every case
    but a reference import, and a port checkpoint then overwrites all of
    it.
    """
    ckpt = opts.checkpoint
    reference = ckpt == "pretrained" or ckpt.endswith((".pth.tar", ".pth"))
    if ckpt and not reference and not ckpt.endswith(SUFFIX):
        raise ValueError(
            f"--checkpoint {ckpt!r}: expected a port {SUFFIX} checkpoint, reference "
            ".pth/.pth.tar weights or 'pretrained'"
        )
    path = ckpt or checkpoint_path(opts.log_dir, opts.name, opts.test_epoch)
    if ckpt and not reference and not os.path.exists(path):
        raise FileNotFoundError(f"--checkpoint {ckpt!r}: no such file")
    note = init_params(model, opts)
    if reference:
        return note
    if not os.path.exists(path):
        return f"no checkpoint at {path}; {note}"
    payload = _read(path, model_only=True)
    model.load_state_dict(payload["model"], strict=True)
    return f"loaded {path} (epoch {payload['metadata'].get('epoch')})"


# ------------------------------------------------------ pretrained weights


def resolve_weight_specs(opts) -> None:
    """Turn the weight flags into local paths, in place: ``--checkpoint
    pretrained`` becomes the fetched demo detector's path, and, unless
    the checkpoint is a reference import (which never takes it),
    ``--pretrained_backbone`` becomes its weights file's path
    (``utils/pretrained.py``: ``auto``, a registry name or a path). A
    download happens here; resolving paths again is a no-op. ``main`` and
    ``test`` call it in the parent before they start a process a card, so
    that one process per host fetches and the ranks receive paths."""
    from faster_rcnn_pytorch_tpu_torch.utils.pretrained import fetch, resolve_backbone

    if opts.checkpoint == "pretrained":
        opts.checkpoint = fetch("frcnn_demo")
    if opts.pretrained_backbone and not opts.checkpoint.endswith((".pth.tar", ".pth")):
        opts.pretrained_backbone = resolve_backbone(opts.pretrained_backbone, opts.model_generation)


def init_params(model: torch.nn.Module, opts) -> str:
    """The weights every CLI starts from (the JAX package's
    ``main.init_params``), loaded into ``model`` in place; returns a note.
    A reference ``.pth``/``.pth.tar`` (or ``pretrained``) is imported
    whole, through :func:`load_reference_weights`; otherwise the model
    gets the fresh init seeded by ``opts.seed`` (the JAX package's
    distributions, ``models/faster_rcnn.py::init_detector_weights``) and
    then, with ``--pretrained_backbone``, the ImageNet backbone
    (:func:`load_pretrained_backbone`). A port ``.pt`` checkpoint is
    loaded over this by the caller."""
    from faster_rcnn_pytorch_tpu_torch.models.faster_rcnn import init_detector_weights

    resolve_weight_specs(opts)
    if opts.checkpoint.endswith((".pth.tar", ".pth")):
        load_reference_weights(model, opts.checkpoint, opts.model_generation)
        return f"imported torch checkpoint {opts.checkpoint}"
    init_detector_weights(model, torch.Generator().manual_seed(opts.seed))
    note = f"fresh init with seed {opts.seed}"
    if opts.pretrained_backbone:
        load_pretrained_backbone(model, opts.pretrained_backbone, opts.model_generation)
        note += f", backbone from {opts.pretrained_backbone}"
    return note


def _check_into(model: torch.nn.Module, sd: dict, what: str) -> dict:
    """The model's own tensors for the keys of ``sd``; ``ValueError``
    naming ``what`` and the first keys at fault unless each key exists in
    the model with the same shape. Nothing is loaded before the check."""
    own = model.state_dict()
    missing = [k for k in sd if k not in own]
    shapes = [
        f"{k}: model {tuple(own[k].shape)}, file {tuple(sd[k].shape)}"
        for k in sd
        if k in own and own[k].shape != sd[k].shape
    ]
    if missing or shapes:
        raise ValueError(
            f"{what}: {len(missing)} keys the model lacks {missing[:3]}, "
            f"{len(shapes)} shapes that differ {shapes[:3]}"
        )
    return own


def load_reference_weights(model: torch.nn.Module, path: str, generation: str) -> dict:
    """Import a reference-layout detector (``{"model_state_dict": ...}``
    or a bare state dict, ``utils/convert.load_reference_checkpoint``)
    into ``model`` whole, and return the state dict read. A file of the
    other generation, or of another class count, raises ``ValueError``
    naming ``generation`` before any tensor is copied: the model is never
    left half loaded."""
    from faster_rcnn_pytorch_tpu_torch.utils.convert import load_reference_checkpoint

    sd = load_reference_checkpoint(path)
    what = f"{path} is not a {generation} detector of {model.num_classes} classes"
    own = _check_into(model, sd, what)
    absent = sorted(set(own) - set(sd))
    if absent:
        raise ValueError(f"{what}: it lacks {len(absent)} of the model's keys {absent[:3]}")
    model.load_state_dict(sd, strict=True)
    return sd


def import_torchvision_vgg16(sd: dict) -> dict:
    """torchvision's ``vgg16`` ImageNet state dict -> the port's
    ``extractor.*`` entries (the JAX ``import_torchvision_vgg16``). The
    port's ``VGG16Features`` keeps torchvision's indices, so this is a key
    map: ``features.{i}.*`` at ``TORCH_VGG16_CONV_INDICES`` become
    ``extractor.{i}.*``. ``classifier.*`` is ignored: the reference
    bootstraps ``vgg16(pretrained=True).features[:-1]`` and inits its own
    FCs (models/model.py:275-281)."""
    from faster_rcnn_pytorch_tpu_torch.models.vgg import TORCH_VGG16_CONV_INDICES

    return {
        f"extractor.{i}.{leaf}": sd[f"features.{i}.{leaf}"]
        for i in TORCH_VGG16_CONV_INDICES
        for leaf in ("weight", "bias")
    }


_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def import_torchvision_resnet50(sd: dict) -> dict:
    """torchvision's ``resnet50`` ImageNet state dict -> the port's
    ``backbone.body.*`` entries (the JAX ``import_torchvision_resnet50``):
    ``conv1``, ``bn1`` and ``layer{1-4}.{b}.{conv,bn}{1-3}`` /
    ``downsample.{0,1}``, FrozenBN statistics included. ``fc.*`` and
    ``num_batches_tracked`` (absent from the ImageNet file, and read by
    nothing) are not imported; the FPN convs keep the fresh init, as in
    the reference (models/new_model.py:372)."""
    from faster_rcnn_pytorch_tpu_torch.models.resnet import STAGE_SIZES

    names = ["conv1.weight", *(f"bn1.{leaf}" for leaf in _BN_LEAVES)]
    for stage, blocks in enumerate(STAGE_SIZES):
        for b in range(blocks):
            t = f"layer{stage + 1}.{b}"
            for ci in (1, 2, 3):
                names += [f"{t}.conv{ci}.weight", *(f"{t}.bn{ci}.{leaf}" for leaf in _BN_LEAVES)]
            if f"{t}.downsample.0.weight" in sd:
                names += [f"{t}.downsample.0.weight"]
                names += [f"{t}.downsample.1.{leaf}" for leaf in _BN_LEAVES]
    return {f"backbone.body.{k}": sd[k] for k in names}


def load_pretrained_backbone(model: torch.nn.Module, spec: str, generation: str) -> None:
    """Load an ImageNet backbone into ``model`` in place (the JAX
    ``load_pretrained_backbone``): ``spec`` is a path, ``auto`` or a
    registry name, resolved by ``utils/pretrained.py::resolve_backbone``;
    VGG16 for ``legacy``, ResNet50 for ``fpn`` and ``cascade``. A key the model lacks or
    a shape that differs raises ``ValueError`` naming it, before anything
    is copied; an unknown generation raises too."""
    from faster_rcnn_pytorch_tpu_torch.utils.convert import load_reference_checkpoint
    from faster_rcnn_pytorch_tpu_torch.utils.pretrained import resolve_backbone

    importers = {
        "legacy": import_torchvision_vgg16,
        "fpn": import_torchvision_resnet50,
        "cascade": import_torchvision_resnet50,
    }
    if generation not in importers:
        raise ValueError(f"unknown generation: {generation!r}")
    path = resolve_backbone(spec, generation)
    new = importers[generation](load_reference_checkpoint(path))
    own = _check_into(model, new, f"backbone import shape mismatch from {path}")
    with torch.no_grad():
        for k, v in new.items():
            own[k].copy_(v)


def prune_checkpoints(log_dir: str, name: str, keep_last: int) -> list[str]:
    """Delete all but the newest ``keep_last`` per-epoch checkpoints (0
    keeps all), files or directories, after the save in flight is
    written. The ``best`` copy is never deleted. Global rank 0 prunes (it
    wrote them). Returns the removed paths."""
    if keep_last <= 0 or layout().rank != 0:
        return []
    wait_for_checkpoints()
    saves = os.path.dirname(checkpoint_path(log_dir, name, 0))
    if not os.path.isdir(saves):
        return []
    pat = re.compile(re.escape(name) + r"\.(\d+)" + re.escape(SUFFIX))
    epochs = sorted(int(m.group(1)) for f in os.listdir(saves) if (m := pat.fullmatch(f)))
    removed = []
    for e in epochs[: max(len(epochs) - keep_last, 0)]:
        path = checkpoint_path(log_dir, name, e)
        if os.path.isdir(path):
            shutil.rmtree(path)
        else:
            os.remove(path)
        removed.append(path)
    return removed


def load_detector(opts):
    """The demo and export CLIs' detector: ``opts.num_classes`` set by data
    type (VOC 21; COCO 81 legacy, 91 FPN), the model built with the
    dataset's label offset, and its weights as
    :func:`resolve_and_load_params` resolves them. Returns ``(model, cfg,
    note)``, the model float32 on the CPU."""
    from faster_rcnn_pytorch_tpu_torch.models.faster_rcnn import build_model, label_offset_for

    if opts.data_type == "voc":
        opts.num_classes = 21
    elif opts.model_generation == "legacy":
        opts.num_classes = 81
    else:
        opts.num_classes = 91
    model, cfg = build_model(
        opts.model_generation,
        opts.num_classes,
        label_offset=label_offset_for(opts.model_generation, opts.data_type),
    )
    note = resolve_and_load_params(opts, model)
    return model, cfg, note


def save_torch_checkpoint(path: str, model: torch.nn.Module, epoch: int = 0) -> None:
    """Write the reference-format ``.pth.tar`` blob ``{"epoch",
    "model_state_dict"}`` (the JAX package's ``save_torch_checkpoint``):
    the model's state dict is already in the reference layout, so the
    reference's resume path loads it. Float32 CPU tensors, atomic write."""
    blob = {
        "epoch": epoch,
        "model_state_dict": {k: v.detach().float().cpu().clone() for k, v in model.state_dict().items()},
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)
