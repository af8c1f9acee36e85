"""Padded-canvas batch loader with threaded host prefetch.

Replaces the reference's torch ``DataLoader`` + collate stack
(datasets/build.py:8-150, new_datasets/coco_dataset.py:37-66) with a
TPU-first design:

* **static canvas buckets** — every batch is padded onto one of two
  fixed canvases (landscape ``base x max`` or portrait ``max x base``,
  /16-aligned), so XLA compiles exactly two shapes instead of one per
  image size. Batches are drawn within an orientation group
  ("aspect-ratio grouping"), generalising the reference's pad-to-/32
  collate which still produced per-batch dynamic shapes,
* boxes are emitted normalised to **canvas** [0,1] with the true image
  extent ``(w_frac, h_frac)`` carried alongside (the reference normalises
  to the image, datasets/transforms_.py:307-316; extent == (1,1) is that
  special case),
* gt padded to ``max_gt`` slots with a validity mask,
* worker threads decode/augment ahead of the device step (the role torch
  DataLoader's C++ worker pool plays in the reference); an optional
  native decode hook can be installed via
  :func:`set_image_loader`.

Distributed data parallelism: pass ``shard_id`` / ``num_shards`` to give
each host a disjoint slice per epoch — the DistributedSampler equivalent
(datasets/build.py:90-98).
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Callable, Iterator, Sequence

import numpy as np
from PIL import Image

from faster_rcnn_pytorch_tpu_torch.data.mosaic import load_mosaic
from faster_rcnn_pytorch_tpu_torch.data.voc import Record

_image_loader: Callable[[str], np.ndarray] | None = None


def set_image_loader(fn: Callable[[str], np.ndarray] | None) -> None:
    """Install a custom (e.g. native) path -> uint8 HWC RGB decoder."""
    global _image_loader
    _image_loader = fn


def load_image(path: str) -> np.ndarray:
    """Decode a path to uint8 HWC RGB.

    Default is PIL: its bundled libjpeg-turbo (SIMD) measured 10.3 ms vs
    12.9 ms for the native libjpeg path on a 640x480 q90 JPEG. The
    native decoder (``native.native_image_loader``) remains installable
    via :func:`set_image_loader` for environments without PIL's turbo
    build.
    """
    if _image_loader is not None:
        return _image_loader(path)
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def canvas_buckets(
    size: int, max_size: int, align: int = 16
) -> list[tuple[int, int]]:
    """The loader's static canvas shapes for a (resize, max_size) config:
    landscape and (when distinct) portrait. Single source of truth shared
    with the serving export — exported artifacts are shape-specialized
    and must match the batches this module produces."""
    base = _round_up(size, align)
    cap = _round_up(max_size, align)
    return [(base, cap)] if cap == base else [(base, cap), (cap, base)]


class DetectionLoader:
    """Iterates fixed-shape batches over a list of :class:`Record`."""

    def __init__(
        self,
        records: Sequence[Record],
        transform,
        batch_size: int = 1,
        size: int = 800,
        max_size: int = 1333,
        max_gt: int = 100,
        shuffle: bool = True,
        mosaic_prob: float = 0.0,
        num_workers: int = 4,
        shard_id: int = 0,
        num_shards: int = 1,
        drop_last: bool = True,
        seed: int = 0,
        align: int = 16,
    ):
        self.records = list(records)
        self.transform = transform
        self.batch_size = batch_size
        self.size = size
        self.max_gt = max_gt
        self.shuffle = shuffle
        self.mosaic_prob = mosaic_prob
        self.num_workers = num_workers
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.drop_last = drop_last
        self.seed = seed
        # Two static canvases: landscape and portrait.
        buckets = canvas_buckets(size, max_size, align)
        self.canvas_land = buckets[0]  # (h, w)
        self.canvas_port = buckets[-1]
        self.records_by_id = {r.image_id: r for r in self.records}

    def __len__(self):
        n = len(self._shard_indices(0))
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    # ---------------------------------------------------------- internals

    def _shard_indices(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self.records))
        if self.shuffle:
            rs = np.random.RandomState(self.seed + epoch)
            rs.shuffle(idx)
        return idx[self.shard_id :: self.num_shards]

    def _prepare_one(self, rec: Record, rng: np.random.RandomState):
        image = load_image(rec.image_path)
        boxes, labels = rec.boxes, rec.labels
        if self.mosaic_prob and rng.rand() < self.mosaic_prob:
            others = [
                self.records[rng.randint(len(self.records))] for _ in range(3)
            ]
            items = [(image, boxes, labels)] + [
                (load_image(o.image_path), o.boxes, o.labels) for o in others
            ]
            image, boxes, labels = load_mosaic(items, self.size, rng)
        image, boxes, labels = self.transform(image, boxes, labels, rng)
        return image, boxes, labels

    def _to_canvas(self, image, boxes, labels, rec: Record, landscape: bool):
        canvas_h, canvas_w = self.canvas_land if landscape else self.canvas_port
        image, boxes = self._clamp_to_canvas(image, boxes, canvas_h, canvas_w)
        h, w = image.shape[:2]
        from faster_rcnn_pytorch_tpu_torch.data import native

        out = native.normalize_into_canvas(image, canvas_h, canvas_w)
        meta = self._meta_for(h, w, boxes, labels, rec, canvas_h, canvas_w)
        return {"image": out, **meta}

    def _meta_for(self, h, w, boxes, labels, rec: Record, canvas_h, canvas_w):
        """Everything in a batch item except the pixels."""
        g = self.max_gt
        gt_boxes = np.zeros((g, 4), np.float32)
        gt_labels = np.zeros((g,), np.int32)
        gt_mask = np.zeros((g,), bool)
        n = min(len(boxes), g)
        if n:
            norm = np.array(
                [canvas_w, canvas_h, canvas_w, canvas_h], np.float32
            )
            gt_boxes[:n] = boxes[:n] / norm
            gt_labels[:n] = labels[:n]
            gt_mask[:n] = True
        return {
            "extent": np.array([w / canvas_w, h / canvas_h], np.float32),
            "gt_boxes": gt_boxes,
            "gt_labels": gt_labels,
            "gt_mask": gt_mask,
            "image_id": np.int64(rec.image_id),
            "orig_hw": np.array([rec.height, rec.width], np.int32),
            "resized_hw": np.array([h, w], np.int32),
        }

    def _batches_for_epoch(self, epoch: int):
        """Group by orientation, then emit batch index lists."""
        idx = self._shard_indices(epoch)
        land, port = [], []
        for i in idx:
            r = self.records[i]
            (land if r.width >= r.height else port).append(i)
        rs = np.random.RandomState(self.seed * 7919 + epoch)
        batches = []
        for group, is_land in ((land, True), (port, False)):
            for s in range(0, len(group), self.batch_size):
                b = group[s : s + self.batch_size]
                if len(b) < self.batch_size:
                    if self.drop_last or not b:
                        continue
                    b = b + group[: self.batch_size - len(b)]
                batches.append((b, is_land))
        if self.shuffle:
            rs.shuffle(batches)
        return batches

    def _make_batch(self, batch_spec, epoch):
        members, landscape = batch_spec
        items = []
        for i in members:
            rng = np.random.RandomState(
                (self.seed * 1_000_003 + epoch * 97 + int(i)) % (2**31)
            )
            rec = self.records[i]
            image, boxes, labels = self._prepare_one(rec, rng)
            items.append(self._to_canvas(image, boxes, labels, rec, landscape))
        # One canvas per batch -> identical shapes by construction.
        return {k: np.stack([it[k] for it in items]) for k in items[0]}

    def _clamp_to_canvas(self, image, boxes, canvas_h, canvas_w):
        """Safety clamp (transform guarantees <= canvas for defaults)."""
        h, w = image.shape[:2]
        if h > canvas_h or w > canvas_w:
            scale = min(canvas_h / h, canvas_w / w)
            image, boxes = _rescale(image, boxes, scale)
        return image, boxes

    def _make_batch_raw(self, batch_spec, epoch, img_out):
        """Worker half of the process pipeline: decode + augment +
        resize; the uint8 images land in ``img_out`` ``[B, ch, cw, 3]``
        (a shared-memory slot — the pad region is left untouched, the
        consumer's normalize pads from the per-image ``resized_hw``).
        Returns the batch dict WITHOUT ``image``."""
        members, landscape = batch_spec
        canvas_h, canvas_w = (
            self.canvas_land if landscape else self.canvas_port
        )
        items = []
        for slot_i, i in enumerate(members):
            rng = np.random.RandomState(
                (self.seed * 1_000_003 + epoch * 97 + int(i)) % (2**31)
            )
            rec = self.records[i]
            image, boxes, labels = self._prepare_one(rec, rng)
            image, boxes = self._clamp_to_canvas(
                image, boxes, canvas_h, canvas_w
            )
            h, w = image.shape[:2]
            img_out[slot_i, :h, :w] = image
            items.append(
                self._meta_for(h, w, boxes, labels, rec, canvas_h, canvas_w)
            )
        return {k: np.stack([it[k] for it in items]) for k in items[0]}

    def _finish_batch(self, meta, img_view, landscape):
        """Consumer half: normalize + pad each uint8 image into the
        float32 canvas (native, GIL-free) and attach to the batch."""
        from faster_rcnn_pytorch_tpu_torch.data import native

        canvas_h, canvas_w = (
            self.canvas_land if landscape else self.canvas_port
        )
        b = meta["resized_hw"].shape[0]
        imgs = np.empty((b, canvas_h, canvas_w, 3), np.float32)
        for i in range(b):
            h, w = (int(v) for v in meta["resized_hw"][i])
            imgs[i] = native.normalize_into_canvas(
                img_view[i, :h, :w], canvas_h, canvas_w
            )
        return {"image": imgs, **meta}

    # ------------------------------------------------------------- public

    def epoch(self, epoch: int = 0) -> Iterator[dict]:
        """Yield batches with background worker prefetch.

        ``num_workers > 0`` uses worker PROCESSES (like the reference's
        torch DataLoader): the decode/augment path is GIL-bound
        pure-Python/numpy, so thread workers cannot scale it on any
        host — they serialize on the GIL and only add switching
        overhead (measured on this image's 1-core host: 73 img/s inline
        -> 65/36/13 img/s at 1/2/4 threads). Worker count is capped at
        cpu_count-1; set ``FRT_LOADER_MP=thread`` to force the legacy
        thread pool (or ``spawn`` to avoid fork)."""
        batches = self._batches_for_epoch(epoch)
        if not batches:
            return
        import os

        # Workers only help with spare cores: parallelism beyond
        # cpu_count-1 (one core stays with the consumer/train loop) is
        # pure scheduling overhead — measured 73 -> 15 img/s from
        # oversubscribing a 1-core host with 8 workers.
        workers = min(self.num_workers, max((os.cpu_count() or 1) - 1, 0))
        if workers <= 0:
            for members in batches:
                yield self._make_batch(members, epoch)
            return

        mode = os.environ.get("FRT_LOADER_MP", "fork")
        if mode == "thread":
            yield from self._epoch_threaded(batches, epoch, workers)
        else:
            yield from self._epoch_processes(batches, epoch, mode, workers)

    def _epoch_processes(self, batches, epoch: int, mp_context: str, workers: int):
        """Process-pool prefetch: deterministic batch order, pixels via
        a shared-memory slot ring.

        Workers write RESIZED UINT8 images into fixed shared-memory
        slots and send only the small metadata through the queue; the
        consumer runs the native (GIL-releasing) normalize+pad into the
        float32 canvas and recycles the slot. Shipping the float32
        canvases themselves through ``mp.Queue`` measured a hard ~165
        MB/s pickle+pipe ceiling (22 img/s at any worker count); uint8
        shared memory moves ~4x fewer bytes with two memcpys and no
        pickling of pixels. Slot count bounds memory and provides
        backpressure (workers block on ``free_q``)."""
        import multiprocessing as mp
        from multiprocessing import shared_memory

        ctx = mp.get_context(mp_context)
        ch, cw = self.canvas_land  # same byte count as portrait
        slot_shape = (self.batch_size, ch, cw, 3)
        n_slots = 2 * workers + 2
        shms = [
            shared_memory.SharedMemory(
                create=True, size=int(np.prod(slot_shape))
            )
            for _ in range(n_slots)
        ]
        task_q = ctx.Queue()
        out_q = ctx.Queue()
        free_q = ctx.Queue()
        for s in range(n_slots):
            free_q.put(s)
        for pos, members in enumerate(batches):
            task_q.put((pos, members))
        for _ in range(workers):
            task_q.put(None)  # one stop sentinel per worker

        procs = [
            ctx.Process(
                target=_mp_worker,
                args=(
                    self,
                    epoch,
                    task_q,
                    out_q,
                    free_q,
                    [s.name for s in shms],
                    slot_shape,
                ),
                daemon=True,
            )
            for _ in range(workers)
        ]
        for p in procs:
            p.start()
        try:
            views = [
                np.ndarray(slot_shape, np.uint8, buffer=s.buf) for s in shms
            ]
            pending: dict[int, dict] = {}
            next_pos = 0
            received = 0
            while received < len(batches):
                # Bounded get + liveness check: a worker killed without
                # cleanup (OOM killer, native-decode segfault) takes any
                # task it had claimed with it — with all tasks pre-queued
                # nobody re-runs it, so an unbounded get would hang the
                # train loop forever (torch DataLoader raises here too).
                # A dead worker is only FATAL once nothing arrives for a
                # while (survivors may still be delivering; a startup
                # crash before claiming a task loses nothing) or once no
                # worker is left alive.
                stall = 0.0
                fatal_stall = float(
                    os.environ.get("FRT_LOADER_DEATH_TIMEOUT", "120")
                )
                while True:
                    try:
                        pos, slot, landscape, meta = out_q.get(timeout=5.0)
                        break
                    except queue.Empty:
                        stall += 5.0
                        dead = [
                            p.exitcode
                            for p in procs
                            if not p.is_alive() and p.exitcode not in (0, None)
                        ]
                        all_dead = dead and not any(
                            p.is_alive() for p in procs
                        )
                        if dead and (all_dead or stall >= fatal_stall):
                            raise RuntimeError(
                                "loader worker process(es) died with exit "
                                f"code(s) {dead} and no batch arrived for "
                                f"{stall:.0f}s — a claimed batch was "
                                "likely lost (out of memory / native "
                                "crash in decode?)"
                            )
                if isinstance(meta, str):  # worker traceback
                    raise RuntimeError(f"loader worker failed:\n{meta}")
                # Finish (and free the slot) in ARRIVAL order so slot
                # recycling never waits on batch ordering.
                view = views[slot]
                if not landscape:
                    view = view.reshape(self.batch_size, cw, ch, 3)
                batch = self._finish_batch(meta, view, landscape)
                free_q.put(slot)
                pending[pos] = batch
                received += 1
                while next_pos in pending:
                    yield pending.pop(next_pos)
                    next_pos += 1
        finally:
            # Normal exhaustion: workers exited on their sentinel. On
            # abandonment (generator closed early) they would block on
            # free_q/out_q forever — terminate them.
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=5)
            for q in (task_q, out_q, free_q):
                q.cancel_join_thread()
            for s in shms:
                s.close()
                s.unlink()

    def _epoch_threaded(self, batches, epoch: int, workers: int):
        out_q: queue.Queue = queue.Queue(maxsize=2 * workers)
        task_q: queue.Queue = queue.Queue()
        for pos, members in enumerate(batches):
            task_q.put((pos, members))

        def worker():
            while True:
                try:
                    pos, members = task_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    out_q.put((pos, self._make_batch(members, epoch)))
                except Exception as e:  # surface worker errors to consumer
                    out_q.put((pos, e))

        threads = [
            threading.Thread(target=worker, daemon=True)
            for _ in range(workers)
        ]
        for t in threads:
            t.start()
        # Re-order to deterministic sequence.
        pending: dict[int, dict] = {}
        next_pos = 0
        received = 0
        while received < len(batches):
            pos, batch = out_q.get()
            if isinstance(batch, Exception):
                raise batch
            pending[pos] = batch
            received += 1
            while next_pos in pending:
                yield pending.pop(next_pos)
                next_pos += 1


def _mp_worker(loader, epoch, task_q, out_q, free_q, shm_names, slot_shape):
    """Worker-process loop: grab a free shared-memory slot, decode +
    augment + resize the batch's uint8 images into it, send the small
    metadata through the queue. Blocking task gets until the stop
    sentinel; errors travel back as a traceback string (exceptions may
    not pickle)."""
    import traceback
    from multiprocessing import shared_memory

    shms = [shared_memory.SharedMemory(name=n) for n in shm_names]
    b, ch, cw, _ = slot_shape
    try:
        while True:
            task = task_q.get()
            if task is None:
                return
            pos, batch_spec = task
            landscape = batch_spec[1]
            slot = free_q.get()
            shape = (b, ch, cw, 3) if landscape else (b, cw, ch, 3)
            view = np.ndarray(shape, np.uint8, buffer=shms[slot].buf)
            try:
                meta = loader._make_batch_raw(batch_spec, epoch, view)
                out_q.put((pos, slot, landscape, meta))
            except Exception:
                free_q.put(slot)
                out_q.put((pos, -1, False, traceback.format_exc()))
    finally:
        for s in shms:
            s.close()


def _rescale(image, boxes, scale):
    h, w = image.shape[:2]
    nw, nh = int(w * scale), int(h * scale)
    im = np.asarray(Image.fromarray(image).resize((nw, nh), Image.BILINEAR))
    if len(boxes):
        boxes = boxes * np.array([nw / w, nh / h, nw / w, nh / h], np.float32)
    return im, boxes


def build_dataloader(opts) -> tuple[DetectionLoader, DetectionLoader]:
    """Config -> (train_loader, test_loader); counterpart of
    datasets/build.py:8 / new_datasets/build.py:9. ``opts`` is a
    :class:`..config.Options`."""
    from faster_rcnn_pytorch_tpu_torch.data.transforms import (
        EvalTransform,
        TrainAugment,
    )

    if opts.data_type == "voc":
        from faster_rcnn_pytorch_tpu_torch.data.voc import (
            download_voc,
            load_voc_records,
        )

        download_voc(opts.data_root)
        train_recs = load_voc_records(opts.data_root, "trainval")
        test_recs = load_voc_records(opts.data_root, "test")
        if not train_recs and not test_recs:
            raise FileNotFoundError(
                f"no VOC records found under {opts.data_root!r}"
            )
        opts.num_classes = 21
    elif opts.data_type == "coco":
        import os

        from faster_rcnn_pytorch_tpu_torch.data.coco import (
            download_coco,
            load_coco_records,
        )

        download_coco(opts.data_root)
        ann = os.path.join(opts.data_root, "annotations")
        train_recs, _ = load_coco_records(
            os.path.join(opts.data_root, "train2017"),
            os.path.join(ann, "instances_train2017.json"),
            contiguous=opts.model_generation == "legacy",
        )
        test_recs, _ = load_coco_records(
            os.path.join(opts.data_root, "val2017"),
            os.path.join(ann, "instances_val2017.json"),
            contiguous=opts.model_generation == "legacy",
        )
        opts.num_classes = 81 if opts.model_generation == "legacy" else 91
    else:
        raise ValueError(f"unknown data_type {opts.data_type!r}")

    train_tf = TrainAugment(size=opts.resize, max_size=opts.max_size)
    test_tf = EvalTransform(size=opts.resize, max_size=opts.max_size)
    per_host_batch = max(opts.batch_size // opts.num_hosts, 1)
    train = DetectionLoader(
        train_recs,
        train_tf,
        batch_size=per_host_batch,
        size=opts.resize,
        max_size=opts.max_size,
        shuffle=True,
        mosaic_prob=0.5 if opts.mosaic_transform else 0.0,
        max_gt=opts.max_gt,
        num_workers=opts.num_workers,
        shard_id=opts.host_id,
        num_shards=opts.num_hosts,
        seed=opts.seed,
    )
    test = DetectionLoader(
        test_recs,
        test_tf,
        batch_size=max(getattr(opts, "eval_batch_size", 1), 1),
        size=opts.resize,
        max_size=opts.max_size,
        shuffle=False,
        num_workers=opts.num_workers,
        shard_id=opts.host_id,
        num_shards=opts.num_hosts,
        drop_last=False,
        seed=opts.seed,
    )
    return train, test
