"""The port's CLIs refuse the flags they cannot honour yet.

Each of ``main``, ``test``, ``demo`` and ``export`` must raise the
``NotImplementedError`` that names the ROADMAP.md item porting a flag
(item 14: parallelism and the scale flags; item 15: pretrained weights)
wherever its JAX counterpart honours that flag, and before it selects a
device or reads data or weights: the loaders, the checkpoint resolution
and the device choice are replaced here by functions that fail the test.
A flag that a CLI's JAX counterpart ignores is not refused by that CLI.
"""

import pytest

from faster_rcnn_pytorch_tpu_torch.config import load_options
from faster_rcnn_pytorch_tpu_torch.utils import runtime

TEST_REFUSES = (
    (("--num_devices", "2"), "item 14"),
    (("--model_parallel", "2"), "item 14"),
    (("--pretrained_backbone", "x"), "item 15"),
    (("--checkpoint", "pretrained"), "item 15"),
)
WEIGHT_FLAGS = TEST_REFUSES[2:]  # demo and export: through the JAX main.init_params
MAIN_REFUSES = (
    (("--num_devices", "2"), "item 14"),
    (("--coordinator", "localhost:1234"), "item 14"),
    (("--model_parallel", "2"), "item 14"),
    (("--num_hosts", "2"), "item 14"),
    (("--remat_backbone", "true"), "item 14"),
    (("--pretrained_backbone", "vgg.pth"), "item 15"),
    (("--checkpoint", "pretrained"), "item 15"),
    (("--ckpt_backend", "orbax"), "item 14"),
    (("--async_checkpoint", "true"), "item 14"),
)
CASES = (
    [("test", flags, item) for flags, item in TEST_REFUSES]
    + [(cli, flags, item) for cli in ("demo", "export") for flags, item in WEIGHT_FLAGS]
    + [("main", flags, item) for flags, item in MAIN_REFUSES]
)


def _forbid(monkeypatch, module, name):
    def read(*args, **kwargs):
        raise AssertionError(f"{module.__name__}.{name} ran before the refusal")

    monkeypatch.setattr(module, name, read)


@pytest.fixture
def nothing_read(monkeypatch):
    """Every way a CLI reaches data, weights or a device fails the test."""
    from faster_rcnn_pytorch_tpu_torch.data import loader
    from faster_rcnn_pytorch_tpu_torch.utils import checkpoint, convert

    for module, name in (
        (loader, "build_dataloader"),
        (checkpoint, "load_detector"),
        (checkpoint, "resolve_and_load_params"),
        (checkpoint, "load_checkpoint"),
        (convert, "load_reference_checkpoint"),
        (runtime, "select_device"),
        (runtime, "set_numerics"),
    ):
        _forbid(monkeypatch, module, name)


@pytest.mark.parametrize(
    "cli,flags,item", CASES, ids=[f"{c}-{f[0][2:]}" for c, f, _ in CASES]
)
def test_cli_refuses_flag_before_reading_anything(cli, flags, item, nothing_read, tmp_path):
    import importlib

    main = importlib.import_module(f"faster_rcnn_pytorch_tpu_torch.{cli}").main
    argv = ["--data_root", str(tmp_path / "absent"), "--demo_root", str(tmp_path / "absent"), *flags]
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md Queue A {item}$") as err:
        main(argv)
    assert str(err.value).startswith(flags[0])


@pytest.mark.parametrize("cli", ("main", "test", "demo", "export"))
def test_cli_refuses_exactly_what_its_jax_counterpart_honours(cli):
    """The refusal table per CLI: each flag alone is refused by the CLIs
    listed above for it and by no other."""
    refused = {
        "main": MAIN_REFUSES,
        "test": TEST_REFUSES,
        "demo": WEIGHT_FLAGS,
        "export": WEIGHT_FLAGS,
    }[cli]
    refused = {flags[0] for flags, _ in refused}
    for flags, _ in MAIN_REFUSES:
        opts = load_options(list(flags))
        if flags[0] in refused:
            with pytest.raises(NotImplementedError):
                runtime.refuse_unported(opts, cli)
        else:
            runtime.refuse_unported(opts, cli)
    runtime.refuse_unported(load_options([]), cli)  # the defaults pass
