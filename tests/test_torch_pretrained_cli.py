"""The port's CLIs honour ``--pretrained_backbone`` and ``--checkpoint
pretrained`` as the JAX package's ``main.init_params`` does.

A cache (``FRT_CACHE_DIR``) is staged once for the module, offline: the
torchvision-layout ``vgg16-397923af.pth`` of
``tests/test_torch_pretrained_backbone.py`` and a ``frcnn.best.pth.tar``
written by the port's ``save_torch_checkpoint`` from a seeded legacy VOC
model. Each of ``main``, ``test``, ``demo`` and ``export`` runs on the CPU
with one flag up to the point where its weights are final (``main`` and
``test``: the call of ``apply_tensor_parallel``; ``demo`` and ``export``:
``prepare_for_inference``), where the model is taken and the run stopped;
the data loader is replaced by a stub, so no data is read. The model's
state dict must equal exactly ``export_legacy_torch_state_dict`` of the
params that the JAX ``init_params`` returns from the same cache:

* ``--checkpoint pretrained``: JAX fetches and imports the staged
  detector whole;
* ``--pretrained_backbone auto``: JAX starts from its fresh init, here
  replaced by the port's seeded one (``init_detector_weights``, which
  draws the JAX distributions from another stream;
  ``init_detector_params`` returns it, imported through
  ``import_legacy_torch_params``, so that the two fresh inits agree),
  and merges the staged VGG16 into it.

``main`` and ``test`` with several processes resolve both flags in the
parent: ``torch.multiprocessing.spawn`` is replaced by a recorder (real
ranks would take minutes), the port's ``fetch`` by a counter, and the
ranks' options must hold the staged file's path after one fetch.
"""

import importlib
import shutil

import numpy as np
import pytest
import torch

from faster_rcnn_pytorch_tpu_torch.models import faster_rcnn as pfr
from faster_rcnn_pytorch_tpu_torch.utils import checkpoint as ck
from faster_rcnn_pytorch_tpu_torch.utils import pretrained as pt
from tests.test_torch_pretrained_backbone import torchvision_vgg16_state_dict

FLAGS = {
    "backbone": ("--pretrained_backbone", "auto"),
    "checkpoint": ("--checkpoint", "pretrained"),
}
STOP_AT = {  # where each CLI's weights are final
    "main": ("faster_rcnn_pytorch_tpu_torch.parallel.tensor_parallel", "apply_tensor_parallel"),
    "test": ("faster_rcnn_pytorch_tpu_torch.parallel.tensor_parallel", "apply_tensor_parallel"),
    "demo": ("faster_rcnn_pytorch_tpu_torch.utils.runtime", "prepare_for_inference"),
    "export": ("faster_rcnn_pytorch_tpu_torch.utils.runtime", "prepare_for_inference"),
}


class _Stop(Exception):
    pass


def _seeded_legacy(seed: int):
    model, _ = pfr.build_model("legacy", 21)
    return pfr.init_detector_weights(model, torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    """The cache root, the staged files' paths, and the JAX package's
    state dict for each flag (``export_legacy_torch_state_dict``)."""
    from faster_rcnn_pytorch_tpu.config import Options
    from faster_rcnn_pytorch_tpu.main import init_params
    from faster_rcnn_pytorch_tpu.models import faster_rcnn as jfr
    from faster_rcnn_pytorch_tpu.utils import checkpoint as jck

    root = tmp_path_factory.mktemp("frt_cache")
    cache = root / "checkpoints"
    cache.mkdir()
    paths = {
        "backbone": str(cache / pt.CHECKPOINTS["vgg16"][1]),
        "checkpoint": str(cache / pt.CHECKPOINTS["frcnn_demo"][1]),
    }
    torch.save(torchvision_vgg16_state_dict(seed=21), paths["backbone"])
    model = _seeded_legacy(0)  # the CLIs' fresh init (--seed 0)
    # copies: the importer keeps views of its inputs, and the model is re-seeded next
    fresh = jck.import_legacy_torch_params({k: v.numpy().copy() for k, v in model.state_dict().items()}, 21)
    pfr.init_weights(model, torch.Generator().manual_seed(7))
    ck.save_torch_checkpoint(paths["checkpoint"], model)
    del model
    jmodel, _ = jfr.build_model("legacy", num_classes=21)
    want = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FRT_CACHE_DIR", str(root))
        mp.setattr(jfr, "init_detector_params", lambda model, rng: fresh)
        for flag, (name, value) in FLAGS.items():
            opts = Options(num_classes=21, **{name[2:]: value})
            want[flag] = jck.export_legacy_torch_state_dict(init_params(jmodel, opts))
            assert opts.checkpoint in ("", paths["checkpoint"])
    yield root, paths, want
    shutil.rmtree(root, ignore_errors=True)  # 1.1 GB of staged files


@pytest.fixture
def cpu_cache(staged, monkeypatch):
    monkeypatch.setenv("FRT_CACHE_DIR", str(staged[0]))
    monkeypatch.setenv("FRT_TORCH_DEVICE", "cpu")
    return staged


def _no_data(monkeypatch):
    from faster_rcnn_pytorch_tpu_torch import main as main_mod
    from faster_rcnn_pytorch_tpu_torch.data import loader

    monkeypatch.setattr(loader, "build_dataloader", lambda opts, **kw: (None, None))
    monkeypatch.setattr(main_mod, "_preflight", lambda *args: None)


def _argv(tmp_path, *flags):
    absent = str(tmp_path / "absent")
    return ["--data_root", absent, "--demo_root", absent, "--log_dir", str(tmp_path / "logs"), *flags]


CASES = [(cli, flag) for cli in STOP_AT for flag in FLAGS]


@pytest.mark.parametrize("cli,flag", CASES, ids=[f"{c}-{f}" for c, f in CASES])
def test_cli_loads_the_weights_jax_init_params_loads(cli, flag, cpu_cache, tmp_path, capsys, monkeypatch):
    _, paths, want = cpu_cache
    _no_data(monkeypatch)
    taken = []

    def stop(model, *args, **kwargs):
        taken.append(model)
        raise _Stop

    module, name = STOP_AT[cli]
    monkeypatch.setattr(importlib.import_module(module), name, stop)
    main = importlib.import_module(f"faster_rcnn_pytorch_tpu_torch.{cli}").main
    with pytest.raises(_Stop):
        main(_argv(tmp_path, *FLAGS[flag]))
    out = capsys.readouterr().out
    if flag == "checkpoint":
        assert f"imported torch checkpoint {paths['checkpoint']}" in out, out
    else:
        assert f"fresh init with seed 0, backbone from {paths['backbone']}" in out, out
    (model,) = taken
    got = model.state_dict()
    assert set(got) == set(want[flag])
    for k, v in want[flag].items():
        assert torch.equal(got[k], torch.from_numpy(np.asarray(v))), k


@pytest.mark.parametrize("cli", ["main", "test"])
@pytest.mark.parametrize("flag", list(FLAGS))
def test_the_parent_fetches_once_and_the_ranks_get_paths(cli, flag, cpu_cache, tmp_path, monkeypatch):
    _, paths, _ = cpu_cache
    fetched, spawned = [], []
    real_fetch = pt.fetch

    def counting_fetch(name):
        fetched.append(name)
        return real_fetch(name)

    def spawn(fn, args, nprocs, join):
        spawned.append((list(fetched), args[0], nprocs))

    monkeypatch.setattr(pt, "fetch", counting_fetch)
    monkeypatch.setattr(torch.multiprocessing, "spawn", spawn)
    main = importlib.import_module(f"faster_rcnn_pytorch_tpu_torch.{cli}").main
    assert main(_argv(tmp_path, "--num_devices", "2", "--batch_size", "2", *FLAGS[flag])) == 0
    (before_spawn, opts, nprocs), = spawned
    assert nprocs == 2
    assert before_spawn == fetched == ["vgg16" if flag == "backbone" else "frcnn_demo"]
    if flag == "backbone":
        assert opts.pretrained_backbone == paths["backbone"]
    else:
        assert opts.checkpoint == paths["checkpoint"]
    ck.resolve_weight_specs(opts)  # what each rank's init_params does first
    assert len(fetched) == 1
