"""The shapes-VOC accuracy recipe through the port's ``main``.

``ACCURACY_SHAPES.json`` records the JAX package training each generation
from random init on generated scenes (``legacy_voc_shapes``,
``fpn_voc_shapes``). This runs the same recipe on the port:

1. ``python tools/make_shapes_voc.py <root> 800 160`` (a subprocess: 3
   classes, 320 px scenes, seeds 0 and 1);
2. ``python -m faster_rcnn_pytorch_tpu_torch.main --data_type voc
   --data_root <root> --resize 320 --max_size 512 --epoch N --batch_size 8
   --lr 1e-3`` (plus ``--model_generation fpn``), the record's command
   with the package's name changed, read line by line as it prints.

Per epoch it reports the VOC AP50 (``epoch N: mAP = X``), the train
loop's img/s (the images of steps 2 to the last over the time from the
epoch's first step line to its ``total`` line: no warm-up step, no eval,
no checkpoint save; the steps still queued on the card when the loop
ends are left out, at most a step or two of 100) and the epoch's wall
time (from one ``mAP`` line to the next: train, eval and saves); and the
card's name and power limit.

With ``--test`` it then takes the best checkpoint through the port's
``test`` CLI at ``--dtype float32`` (TF32 off) and ``bfloat16``
(:func:`test_best`): both mAPs and the greedy pairing of their
detections, on the recipe's 160 test scenes and on ``N_CHECK`` (800)
test scenes of the same generator under ``--check_root``.

``python -m faster_rcnn_pytorch_tpu_torch.tools.shapes_recipe
--generation legacy|fpn [--epochs 25] [--test] [--root build/shapes_voc]
[--check_root build/shapes_check] [--log_dir build/shapes_logs] [--out
result.json]`` runs ``main`` as a
subprocess on a GPU host (``chip_smoke.py`` phase 28 runs it in-process
for 8 epochs with :func:`run_in_process`, then :func:`test_best` on the
800 scenes).
Without a card ``main`` raises, as every CLI of the port does, unless
``FRT_TORCH_DEVICE=cpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import pickle
import re
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
N_TRAIN, N_TEST = 800, 160
# The dtype check's test scenes: the same generator's test split (its
# first 160 are the recipe's), large enough that the float32-bfloat16 mAP
# difference is not the rounding of a few detections on 160 scenes
# (there it spreads to 0.019 run to run, in either direction)
N_CHECK = 800
RECIPE = ("--data_type", "voc", "--resize", "320", "--max_size", "512", "--batch_size", "8", "--lr", "1e-3")
STEP_LINE = re.compile(r"^epoch (\d+) \[(\d+)(?:/\d+)?\].* loss: (\S+) ")
TOTAL_LINE = re.compile(r"^epoch (\d+) total: ")
MAP_LINE = re.compile(r"^epoch (\d+): mAP = ([0-9.]+|nan)$")


def make_data(root: str, n_train: int = N_TRAIN, n_test: int = N_TEST) -> None:
    """The scenes of ``tools/make_shapes_voc.py`` under ``root``."""
    script = os.path.join(REPO, "tools", "make_shapes_voc.py")
    subprocess.run([sys.executable, script, root, str(n_train), str(n_test)], check=True, timeout=900)


def recipe_argv(generation: str, root: str, epochs: int, *extra: str) -> list[str]:
    """``main``'s arguments for the recipe; ``extra`` only for logging and
    housekeeping flags."""
    gen = ("--model_generation", "fpn") if generation == "fpn" else ()
    return ["--data_root", root, *RECIPE[:2], *gen, *RECIPE[2:], "--epoch", str(epochs), *extra]


def steps_per_epoch(root: str, batch_size: int = 8) -> int:
    """The recipe's train steps an epoch: the train split's scenes over
    the batch (800 / 8 = 100)."""
    jpg = os.path.join(root, "VOCtrainval_2007", "VOCdevkit", "VOC2007", "JPEGImages")
    return len(os.listdir(jpg)) // batch_size


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


class EpochClock:
    """Reads ``main``'s output lines as they come, each with the time it
    arrived, into per-epoch records."""

    def __init__(self, steps: int, batch_size: int = 8):
        self.batch_size, self.steps = batch_size, steps  # images a step, steps an epoch
        self.t0 = time.perf_counter()
        self.losses: list[float] = []  # every logged step loss (the window's mean)
        self.first: dict[int, float] = {}  # epoch -> time of its first step line
        self.trained: dict[int, float] = {}  # epoch -> time of its "total" line
        self.maps: dict[int, tuple[float, float]] = {}  # epoch -> (time, AP50)

    def line(self, text: str) -> None:
        t = time.perf_counter()
        if m := STEP_LINE.match(text):
            self.losses.append(float(m.group(3)))
            self.first.setdefault(int(m.group(1)), t)
        elif m := TOTAL_LINE.match(text):
            self.trained[int(m.group(1))] = t
        elif m := MAP_LINE.match(text):
            self.maps[int(m.group(1))] = (t, float(m.group(2)))

    def summary(self) -> dict:
        epochs = sorted(self.maps)
        curve = [self.maps[e][1] for e in epochs]
        img_s, wall = [], []
        for e in epochs:
            img_s.append(self.batch_size * (self.steps - 1) / (self.trained[e] - self.first[e]))
            prev = self.maps[e - 1][0] if e - 1 in self.maps else self.t0
            wall.append(self.maps[e][0] - prev)
        return {
            "epochs": epochs,
            "map_by_epoch": curve,
            "best_map": max(curve) if curve else float("nan"),
            "final_map": curve[-1] if curve else float("nan"),
            "train_img_s_by_epoch": img_s,
            "epoch_wall_s_by_epoch": wall,
            "train_img_s_median": statistics.median(img_s) if img_s else float("nan"),
            "epoch_wall_s_median": statistics.median(wall[1:] or wall) if wall else float("nan"),
            "losses_logged": len(self.losses),
            "losses_finite": all(math.isfinite(v) for v in self.losses),
            "wall_s": time.perf_counter() - self.t0,
        }


class _Tee:
    """A stdout that also hands each whole line to an :class:`EpochClock`."""

    def __init__(self, out, clock: EpochClock):
        self.out, self.clock, self.buf = out, clock, ""

    def write(self, s: str) -> int:
        self.out.write(s)
        self.buf += s
        *lines, self.buf = self.buf.split("\n")
        for ln in lines:
            self.clock.line(ln)
        return len(s)

    def flush(self) -> None:
        self.out.flush()


def run_in_process(argv: list[str], steps: int) -> dict:
    """``main.main(argv)`` in this process (its kernels' launch counters
    count here), its output timed line by line; the summary (``steps``:
    train steps an epoch)."""
    from faster_rcnn_pytorch_tpu_torch import main as main_mod

    clock = EpochClock(steps)
    with contextlib.redirect_stdout(_Tee(sys.stdout, clock)):
        rc = main_mod.main(argv)
    if rc != 0:
        raise RuntimeError(f"main exited {rc}")
    return clock.summary()


def run_subprocess(argv: list[str], steps: int, log_path: str | None = None) -> dict:
    """``python -m faster_rcnn_pytorch_tpu_torch.main argv`` as a
    subprocess, its output timed line by line (and kept in ``log_path``);
    the summary. Raises if it fails."""
    cmd = [sys.executable, "-u", "-m", "faster_rcnn_pytorch_tpu_torch.main", *argv]
    print(" ".join(cmd), flush=True)
    clock = EpochClock(steps)
    log = open(log_path, "w") if log_path else contextlib.nullcontext()
    with log, subprocess.Popen(
        cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    ) as proc:
        for ln in proc.stdout:
            clock.line(ln.rstrip("\n"))
            if log_path:
                log.write(ln)
            if STEP_LINE.match(ln) or TOTAL_LINE.match(ln) or MAP_LINE.match(ln):
                print(ln, end="", flush=True)
    if proc.returncode:
        raise RuntimeError(f"main exited {proc.returncode}; its output is in {log_path}")
    return clock.summary()


def make_check_data(root: str) -> None:
    """``N_CHECK`` test scenes (and one train scene: the loader wants both
    splits) under ``root``."""
    make_data(root, 1, N_CHECK)


def test_best(generation: str, root: str, log_dir: str, name: str) -> tuple[dict, str]:
    """The run's best checkpoint through the port's ``test`` CLI in this
    process on the test scenes under ``root``, at ``--dtype float32``
    (TF32 off) and ``bfloat16``: each mAP, and the greedy pairing of their
    detections (:func:`pairing`)."""
    from faster_rcnn_pytorch_tpu_torch import test as test_mod

    gen = ("--model_generation", "fpn") if generation == "fpn" else ()
    maps, dumps = {}, {}
    for dtype in ("float32", "bfloat16"):
        dumps[dtype] = os.path.join(log_dir, f"{name}_{dtype}.pkl")
        argv = [
            "--data_root", root, *RECIPE[:2], *gen, *RECIPE[2:6], "--dtype", dtype, "--log_dir", log_dir,
            "--name", name, "--test_epoch", "best", "--dump_detections", dumps[dtype],
        ]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = test_mod.main(argv)
        print(out.getvalue(), end="", flush=True)
        found = re.findall(r"^mAP = ([0-9.]+)$", out.getvalue(), re.M)
        if rc != 0 or len(found) != 1:
            raise RuntimeError(f"test {' '.join(argv)} exited {rc}, {len(found)} mAP lines")
        maps[dtype] = float(found[0])
    return maps, pairing(dumps["float32"], dumps["bfloat16"])


def pairing(a_path: str, b_path: str) -> str:
    """The greedy pairing (``evaluation/diff.py``) of two dumps of one
    set's detections, summed over the images."""
    from faster_rcnn_pytorch_tpu_torch.evaluation.diff import detections_agree, greedy_match

    dumps = []
    for path in (a_path, b_path):
        with open(path, "rb") as f:
            dumps.append(pickle.load(f)["predictions"])
    a, b = dumps
    if a.keys() != b.keys():
        raise ValueError("the two dumps hold other images")
    paired = larger = agree = 0
    ds = db = 0.0
    for img in a:
        pairs = greedy_match(a[img], b[img])
        n = max(len(a[img]["scores"]), len(b[img]["scores"]))
        paired += len(pairs)
        larger += n
        # an image without detections in either dump agrees
        agree += detections_agree(a[img], b[img], score_tol=math.inf, box_tol=math.inf)[0] or not n
        if pairs:
            i, j = (np.array(x) for x in zip(*pairs))
            ds = max(ds, float(np.abs(np.asarray(a[img]["scores"])[i] - np.asarray(b[img]["scores"])[j]).max()))
            db = max(db, float(np.abs(np.asarray(a[img]["boxes"])[i] - np.asarray(b[img]["boxes"])[j]).max()))
    return (
        f"{paired} of {larger} detections paired (label, IoU >= 0.99), {agree} of {len(a)} images with "
        f"99% paired; paired score |d| <= {ds:.4f}, box |d| <= {db:.2f} px"
    )


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--generation", choices=("legacy", "fpn"), default="legacy")
    p.add_argument("--epochs", type=int, default=25)
    p.add_argument("--root", default=os.path.join(REPO, "build", "shapes_voc"))
    p.add_argument("--check_root", default=os.path.join(REPO, "build", "shapes_check"))
    p.add_argument("--log_dir", default=os.path.join(REPO, "build", "shapes_logs"))
    p.add_argument("--out", default="", help="also write the result here as JSON")
    p.add_argument("--test", action="store_true", help="then the best checkpoint through the test CLI, float32 and bfloat16")
    args = p.parse_args(argv)
    device = card() if os.environ.get("FRT_TORCH_DEVICE") != "cpu" else "cpu (FRT_TORCH_DEVICE)"
    print(device, flush=True)
    if not os.path.isdir(os.path.join(args.root, "VOCtest_2007")):
        make_data(args.root)
    name = f"shapes_{args.generation}"
    log = os.path.join(args.log_dir, f"{name}.log")
    os.makedirs(args.log_dir, exist_ok=True)
    argv = recipe_argv(args.generation, args.root, args.epochs, "--log_dir", args.log_dir, "--name", name)
    summary = run_subprocess(argv, steps_per_epoch(args.root), log)
    result = {"generation": args.generation, "device": device, "argv": argv, **summary}
    if args.test:
        result["test_map"], result["test_pairing"] = test_best(args.generation, args.root, args.log_dir, name)
        if not os.path.isdir(os.path.join(args.check_root, "VOCtest_2007")):
            make_check_data(args.check_root)
        result["check_map"], result["check_pairing"] = test_best(
            args.generation, args.check_root, args.log_dir, name
        )
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
