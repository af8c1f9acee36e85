"""The port's released-weights registry and gated downloader
(``faster_rcnn_pytorch_tpu_torch/utils/pretrained.py``).

The cases of ``tests/test_pretrained_fetch.py``, run on the port's copy,
all offline: the cache-hit path needs no network, a download comes from a
``file://`` URL or from a local ``http.server`` that plays Google Drive's
confirm-token interstitial (``_DriveHandler`` of that file). The minimum
artifact size is cut to 4 KiB for the staged payloads (``small_artifacts``),
and the registry, the auto specs, the size floor and the cache directory
are held equal to the JAX package's: a file staged once serves both.
"""

import os

import pytest

from faster_rcnn_pytorch_tpu.utils import pretrained as jax_pt
from faster_rcnn_pytorch_tpu_torch.utils import pretrained as pt
from tests.test_pretrained_fetch import _DriveHandler, fake_drive  # noqa: F401


@pytest.fixture()
def cache(tmp_path, monkeypatch):
    monkeypatch.setenv("FRT_CACHE_DIR", str(tmp_path))
    return tmp_path / "checkpoints"


@pytest.fixture()
def small_artifacts(monkeypatch):
    monkeypatch.setattr(pt, "MIN_ARTIFACT_BYTES", 4096)


@pytest.fixture()
def entry(monkeypatch):
    """Register a test artifact for the test only."""

    def add(name, url, fname):
        monkeypatch.setitem(pt.CHECKPOINTS, name, (url, fname))

    return add


def test_registry_and_cache_are_the_jax_packages(tmp_path, monkeypatch):
    assert pt.CHECKPOINTS == jax_pt.CHECKPOINTS
    assert pt._AUTO_SPECS == jax_pt._AUTO_SPECS
    assert pt.MIN_ARTIFACT_BYTES == jax_pt.MIN_ARTIFACT_BYTES
    monkeypatch.delenv("FRT_CACHE_DIR", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert pt.cache_dir() == jax_pt.cache_dir() == str(
        tmp_path / ".cache" / "faster_rcnn_pytorch_tpu" / "checkpoints"
    )


def test_cache_dir_env_override(cache):
    assert pt.cache_dir() == str(cache) == jax_pt.cache_dir()


def test_fetch_reuses_existing_file(cache):
    cache.mkdir(parents=True)
    staged = cache / pt.CHECKPOINTS["vgg16"][1]
    staged.write_bytes(b"weights")
    assert pt.fetch("vgg16") == str(staged)
    assert staged.read_bytes() == b"weights"  # untouched


def test_fetch_unknown_name():
    with pytest.raises(KeyError, match="unknown pretrained artifact"):
        pt.fetch("nope")


def test_fetch_failure_names_url_and_dest(cache, entry):
    entry("vgg16", "file:///nonexistent/x.pth", "x.pth")
    with pytest.raises(RuntimeError, match="stage the file manually") as err:
        pt.fetch("vgg16")
    assert "file:///nonexistent/x.pth" in str(err.value)
    assert str(cache / "x.pth") in str(err.value)
    assert not os.path.exists(cache / "x.pth.part")  # no truncated leftover


def _fake_ckpt_bytes() -> bytes:
    """zip magic, padded past the (cut) size floor."""
    return b"PK\x03\x04" + b"\0" * pt.MIN_ARTIFACT_BYTES


def test_fetch_downloads_via_url(cache, tmp_path, small_artifacts, entry):
    src = tmp_path / "src.pth"
    payload = _fake_ckpt_bytes()
    src.write_bytes(payload)
    entry("_test", f"file://{src}", "dl.pth")
    dest = pt.fetch("_test")
    assert dest == str(cache / "dl.pth")
    assert open(dest, "rb").read() == payload
    assert not os.path.exists(dest + ".part")


def test_fetch_rejects_implausible_bytes(cache, tmp_path, small_artifacts, entry):
    src = tmp_path / "src.pth"
    src.write_bytes(b"Bandwidth limit exceeded" * 400)
    entry("_test", f"file://{src}", "dl.pth")
    with pytest.raises(RuntimeError, match="unrecognized leading bytes"):
        pt.fetch("_test")
    assert not os.path.exists(cache / "dl.pth")
    assert not os.path.exists(cache / "dl.pth.part")


def test_fetch_rejects_truncated_zip(cache, tmp_path, small_artifacts, entry):
    src = tmp_path / "src.pth"
    src.write_bytes(b"PK\x03\x04tiny")
    entry("_test", f"file://{src}", "dl.pth")
    with pytest.raises(RuntimeError, match="implausibly small"):
        pt.fetch("_test")
    assert not os.path.exists(cache / "dl.pth")


@pytest.mark.parametrize("mode", ["form", "href"])
def test_fetch_follows_drive_interstitial(cache, fake_drive, small_artifacts, entry, mode):  # noqa: F811
    payload = _fake_ckpt_bytes()
    base = fake_drive(mode, payload)
    entry("_drive", f"{base}/uc?export=download&id=14Obb", "d.pth.tar")
    dest = pt.fetch("_drive")
    assert open(dest, "rb").read() == payload


def test_fetch_never_caches_interstitial(cache, fake_drive, entry):  # noqa: F811
    base = fake_drive("html_forever")
    entry("_drive", f"{base}/uc?export=download&id=14Obb", "d.pth.tar")
    with pytest.raises(RuntimeError, match="HTML"):
        pt.fetch("_drive")
    assert not os.path.exists(cache / "d.pth.tar")
    assert not os.path.exists(cache / "d.pth.tar.part")


def test_resolve_backbone_path_passthrough(tmp_path):
    p = tmp_path / "w.pth"
    p.write_bytes(b"x")
    assert pt.resolve_backbone(str(p), "legacy") == str(p)


@pytest.mark.parametrize(
    "spec,generation,name",
    [
        ("auto", "legacy", "vgg16"),
        ("imagenet", "fpn", "resnet50"),
        ("vgg16", "fpn", "vgg16"),  # an explicit registry name wins
    ],
)
def test_resolve_backbone_specs(cache, spec, generation, name):
    cache.mkdir(parents=True)
    staged = cache / pt.CHECKPOINTS[name][1]
    staged.write_bytes(b"w")
    assert pt.resolve_backbone(spec, generation) == str(staged)
    assert jax_pt.resolve_backbone(spec, generation) == str(staged)


def test_resolve_backbone_typo_raises():
    with pytest.raises(ValueError, match="not a file"):
        pt.resolve_backbone("/no/such/weights.pth", "legacy")
