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
:func:`resolve_and_load_params` is the eval CLI's checkpoint policy (the
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
    counterpart of the JAX package's ``resolve_and_load_params``, one
    policy for the eval CLIs). Returns a note for the console.

    * ``*.pth`` / ``*.pth.tar``: reference-layout weights, imported by
      ``utils/convert.load_reference_checkpoint``.
    * ``*.pt``: a port train checkpoint (a file, or a directory of the
      ``orbax`` backend), which must exist; only its ``model`` entry is
      loaded (``strict=True``).
    * empty: the run's ``{log_dir}/{name}/saves/{name}.{test_epoch}.pt``.
      If it is missing, the model gets the fresh init seeded by
      ``opts.seed`` and the note names the missing path.
    * anything else: ``ValueError``. Going on with random weights after a
      typo in the path is the worst failure an eval CLI can have.
    """
    ckpt = opts.checkpoint
    if ckpt.endswith((".pth.tar", ".pth")):
        from faster_rcnn_pytorch_tpu_torch.utils.convert import load_reference_checkpoint

        model.load_state_dict(load_reference_checkpoint(ckpt), strict=True)
        return f"imported torch checkpoint {ckpt}"
    if ckpt and not ckpt.endswith(SUFFIX):
        raise ValueError(
            f"--checkpoint {ckpt!r}: expected a port {SUFFIX} checkpoint or "
            "reference .pth/.pth.tar weights"
        )
    path = ckpt or checkpoint_path(opts.log_dir, opts.name, opts.test_epoch)
    if not os.path.exists(path):
        if ckpt:  # an explicit path must exist
            raise FileNotFoundError(f"--checkpoint {ckpt!r}: no such file")
        from faster_rcnn_pytorch_tpu_torch.models.faster_rcnn import init_weights

        init_weights(model, torch.Generator().manual_seed(opts.seed))
        return f"no checkpoint at {path}; fresh init with seed {opts.seed}"
    payload = _read(path, model_only=True)
    model.load_state_dict(payload["model"], strict=True)
    return f"loaded {path} (epoch {payload['metadata'].get('epoch')})"


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
