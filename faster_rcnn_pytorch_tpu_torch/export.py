"""Serving-export CLI of the port (counterpart of
``faster_rcnn_pytorch_tpu/export.py``): checkpoint -> ``torch.export``
artifacts.

``python -m faster_rcnn_pytorch_tpu_torch.export --data_type voc \
      --test_epoch best --export_dir ./export``

Exports the predict program for both canvas orientation buckets
(``canvas_buckets(resize, max_size)``, the loader's two static shapes) at
``--batch_size`` and ``--dtype``, plus a ``manifest.json`` describing the
calling convention (``serving.py``). Weights as the ``test`` CLI resolves
them. The device is ``utils.runtime.select_device``'s (the card, or the
CPU under ``FRT_TORCH_DEVICE=cpu``), and:

* ``--export_platforms ""``: one artifact per bucket for that device;
  ``cpu``: traced on the CPU, where the program runs the plain versions of
  the kernels; ``cpu,cuda``: one artifact per bucket and device, the device
  in the file name and each entry's ``platforms`` (``cuda`` needs the card);
* ``--params_sidecar``: the programs take the weights as an argument, from
  one ``weights.pt`` shared by every bucket, instead of holding them;
* ``--export_torch PATH``: write the reference ``.pth.tar`` blob
  ``{"epoch", "model_state_dict"}`` instead of artifacts.
"""

from __future__ import annotations

import os
import sys
import time


def _platforms(opts, device) -> list[str]:
    """The devices to export for: ``cpu`` and, with a card selected,
    ``cuda``."""
    names = [p.strip() for p in opts.export_platforms.split(",") if p.strip()]
    names = names or [device.type]
    for p in names:
        if p not in ("cpu", "cuda"):
            raise ValueError(f"--export_platforms: unknown platform {p!r} (cpu, cuda)")
        if p == "cuda" and device.type != "cuda":
            raise ValueError("--export_platforms cuda needs the card (FRT_TORCH_DEVICE=cpu is set)")
    return list(dict.fromkeys(names))


def main(argv=None) -> int:
    import torch

    from faster_rcnn_pytorch_tpu_torch.config import load_options
    from faster_rcnn_pytorch_tpu_torch.data.loader import canvas_buckets
    from faster_rcnn_pytorch_tpu_torch.serving import (
        PARAMS_SIDECAR,
        artifact_name,
        export_predict,
        save_artifact,
        save_params_sidecar,
        write_manifest,
    )
    from faster_rcnn_pytorch_tpu_torch.utils.checkpoint import load_detector, save_torch_checkpoint
    from faster_rcnn_pytorch_tpu_torch.utils.runtime import (
        apply_matmul_precision,
        prepare_for_inference,
        select_device,
        set_numerics,
    )

    opts = load_options(argv)
    dtype = set_numerics(opts.dtype)
    apply_matmul_precision(opts.matmul_precision)
    device = select_device()
    model, cfg, note = load_detector(opts)
    print(note, flush=True)

    if opts.export_torch:
        save_torch_checkpoint(opts.export_torch, model)
        size_mb = os.path.getsize(opts.export_torch) / 1e6
        print(f"wrote torch checkpoint {opts.export_torch} ({size_mb:.1f} MB)", flush=True)
        return 0

    platforms = _platforms(opts, device)
    os.makedirs(opts.export_dir, exist_ok=True)
    entries = []
    for platform in platforms:
        target = device if platform == device.type else torch.device("cpu")
        model = prepare_for_inference(model, target, dtype)
        for canvas in canvas_buckets(opts.resize, opts.max_size):
            t0 = time.time()
            exported = export_predict(
                model, cfg, canvas, opts.batch_size, score_threshold=opts.thres,
                params_as_args=opts.params_sidecar,
            )
            fname = artifact_name(canvas, opts.batch_size, platform if len(platforms) > 1 else None)
            path = os.path.join(opts.export_dir, fname)
            save_artifact(exported, path)
            entry = {
                "file": fname,
                "canvas_hw": list(canvas),
                "batch": opts.batch_size,
                "platforms": [platform],
                "dtype": opts.dtype,
            }
            if opts.params_sidecar:
                entry["params_as_args"] = True
            entries.append(entry)
            print(
                f"exported {fname} ({os.path.getsize(path) / 1e6:.1f} MB, platforms=[{platform!r}], "
                f"{time.time() - t0:.1f} s)",
                flush=True,
            )

    extra = None
    if opts.params_sidecar:
        spath = os.path.join(opts.export_dir, PARAMS_SIDECAR)
        save_params_sidecar(model, spath)
        print(
            f"wrote params sidecar {PARAMS_SIDECAR} ({os.path.getsize(spath) / 1e6:.1f} MB, "
            "shared by all buckets)",
            flush=True,
        )
        extra = {"params_file": PARAMS_SIDECAR}
    mpath = write_manifest(opts.export_dir, entries, opts, extra=extra)
    print(f"wrote {mpath}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
