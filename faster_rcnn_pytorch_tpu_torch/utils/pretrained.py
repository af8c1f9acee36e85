"""Released-weights registry and gated downloader.

The port's own copy of ``faster_rcnn_pytorch_tpu/utils/pretrained.py``
(the port imports nothing of the JAX package). Both packages read the
same cache (``FRT_CACHE_DIR``, default
``~/.cache/faster_rcnn_pytorch_tpu/checkpoints``): a file staged once
serves both.

Counterpart of the reference's ``download_url_pretrained.py`` (gdown
fetch of the released demo checkpoint into ``torch.hub``'s cache,
models/model_.py:300-312) and of its implicit torchvision
``pretrained=True`` ImageNet fetches (models/model.py:275-281,
models/new_model.py:372).

Same contract as :func:`data.voc.download_voc`: idempotent (an existing
file is reused untouched), and in an egress-less environment the fetch
raises with instructions naming the URL and the destination so the user
can stage the file out of band.
"""

from __future__ import annotations

import os

# Stable public artifact URLs. The two ImageNet entries are the exact
# torchvision weight files the reference resolves through
# ``vgg16(pretrained=True)`` / ``resnet_fpn_backbone('resnet50',
# IMAGENET1K_V1)``; ``frcnn_demo`` is the repo author's released
# VOC-trained legacy detector (Google Drive id from models/model_.py:304,
# served via the gdown-style uc endpoint).
CHECKPOINTS: dict[str, tuple[str, str]] = {
    "vgg16": (
        "https://download.pytorch.org/models/vgg16-397923af.pth",
        "vgg16-397923af.pth",
    ),
    "resnet50": (
        "https://download.pytorch.org/models/resnet50-0676ba61.pth",
        "resnet50-0676ba61.pth",
    ),
    "frcnn_demo": (
        "https://drive.google.com/uc?export=download"
        "&id=14ObbUCsP7DsDd2kMcnIxJRpnAFsT-9Lj",
        "frcnn.best.pth.tar",
    ),
}

# Specs accepted by --pretrained_backbone that mean "the ImageNet weights
# for whichever backbone this generation uses" (reference: a bare
# pretrained=True flag).
_AUTO_SPECS = frozenset({"auto", "imagenet", "true", "1"})


def cache_dir() -> str:
    """Download cache (reference: ``torch.hub.get_dir()/checkpoints``).

    ``FRT_CACHE_DIR`` overrides; default ``~/.cache/faster_rcnn_pytorch_tpu``.
    """
    root = os.environ.get("FRT_CACHE_DIR") or os.path.join(
        os.path.expanduser("~"), ".cache", "faster_rcnn_pytorch_tpu"
    )
    return os.path.join(root, "checkpoints")


#: smallest plausible size (bytes) for a released weight file — a Drive
#: interstitial / proxy error page is a few KB; the real artifacts are
#: 98 MB (resnet50) to ~1 GB (frcnn_demo).
MIN_ARTIFACT_BYTES = 1 << 20


class ArtifactValidationError(RuntimeError):
    """Downloaded bytes are not a plausible checkpoint (HTML page,
    truncated body, unknown format) — never cached."""


def _looks_like_checkpoint(path: str) -> str | None:
    """None if ``path`` plausibly holds torch/numpy weights, else a
    human-readable reason it does not.

    Accepted magics: zip (``PK\\x03\\x04`` — the modern
    ``torch.save`` zipfile container), a pickle protocol-2+ stream
    (``\\x80`` — legacy ``torch.save``, which the reference's released
    ``.pth.tar`` files use), or a ustar tar. Rejected outright: HTML —
    the Google-Drive large-file confirmation page that a cookie-less
    ``urlretrieve`` receives (reference avoids this via gdown,
    download_url_pretrained.py:6-17).
    """
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(512)
        f.seek(257)
        tar_magic = f.read(5)
    low = head.lstrip()[:256].lower()
    if low.startswith(b"<") or b"<html" in low or b"<!doctype" in low:
        return "got an HTML page (Google Drive interstitial / proxy error?)"
    ok_magic = (
        head.startswith(b"PK\x03\x04")
        or head.startswith(b"\x80")
        or tar_magic == b"ustar"
    )
    if not ok_magic:
        return f"unrecognized leading bytes {head[:8]!r}"
    if size < MIN_ARTIFACT_BYTES:
        return f"implausibly small ({size} bytes < {MIN_ARTIFACT_BYTES})"
    return None


def _drive_confirm_request(body: bytes, url: str):
    """Given the HTML of a Drive "can't scan for viruses" interstitial,
    build the follow-up request that yields the real bytes.

    Two historical shapes (both handled by gdown): a ``confirm=<token>``
    query parameter advertised via a ``download_warning*`` cookie or an
    ``confirm=`` href, and the current hidden-input form posting to
    ``drive.usercontent.google.com/download``. Returns a full URL or
    None when no continuation is recognizable.
    """
    import html.parser
    import re
    import urllib.parse

    text = body.decode("utf-8", "replace")

    class _FormParser(html.parser.HTMLParser):
        """First form's action + its named inputs — attribute order is
        not contractual in Drive's markup, so a real parser, not a
        regex (gdown does the same for the same reason)."""

        def __init__(self):
            super().__init__()
            self.action = None
            self.fields: dict[str, str] = {}
            self._in_form = False

        def handle_starttag(self, tag, attrs):
            a = dict(attrs)
            if tag == "form" and self.action is None and a.get("action"):
                self.action = a["action"]
                self._in_form = True
            elif tag == "input" and self._in_form and a.get("name"):
                self.fields[a["name"]] = a.get("value") or ""

        def handle_endtag(self, tag):
            if tag == "form":
                self._in_form = False

    p = _FormParser()
    p.feed(text)
    if p.action and p.fields:
        # Drive serves the form action absolute
        # (drive.usercontent.google.com); resolve relative ones anyway.
        action = urllib.parse.urljoin(url, p.action)
        sep = "&" if "?" in action else "?"
        return action + sep + urllib.parse.urlencode(p.fields)
    m = re.search(r"confirm=([0-9A-Za-z_\-]+)", text)
    if m:
        sep = "&" if "?" in url else "?"
        return f"{url}{sep}confirm={m.group(1)}"
    return None


def _download(url: str, tmp: str) -> None:
    """Stream ``url`` into ``tmp``, following one Drive confirm-token
    interstitial if served. Raises :class:`ArtifactValidationError` when
    the final body is HTML (so a captive page can never be cached)."""
    import http.cookiejar
    import shutil
    import urllib.request

    # Cookie jar: Drive's old-style confirm flow requires the session
    # cookie from the interstitial to accompany the confirm request.
    opener = urllib.request.build_opener(
        urllib.request.HTTPCookieProcessor(http.cookiejar.CookieJar())
    )

    def get(u):
        req = urllib.request.Request(u, headers={"User-Agent": "frcnn-tpu/1.0"})
        return opener.open(req, timeout=60)

    resp = get(url)
    ctype = resp.headers.get("Content-Type", "")
    if "text/html" in ctype:
        body = resp.read(4 << 20)  # interstitials are a few KB
        nxt = _drive_confirm_request(body, url)
        if nxt is None:
            raise ArtifactValidationError(
                "server returned an HTML page with no recognizable "
                "download continuation"
            )
        resp = get(nxt)
        if "text/html" in resp.headers.get("Content-Type", ""):
            raise ArtifactValidationError(
                "confirm-token follow-up still returned HTML"
            )
    with open(tmp, "wb") as f:
        shutil.copyfileobj(resp, f, 1 << 20)


def fetch(name: str) -> str:
    """Return a local path for registry entry ``name``, downloading into
    :func:`cache_dir` if absent. The downloaded bytes are validated
    (magic + size, :func:`_looks_like_checkpoint`) BEFORE the atomic
    rename, so a captive HTML response can never poison the cache.
    Raises ``RuntimeError`` with staging instructions when the download
    fails (e.g. no network egress)."""
    try:
        url, fname = CHECKPOINTS[name]
    except KeyError:
        raise KeyError(
            f"unknown pretrained artifact {name!r}; "
            f"known: {sorted(CHECKPOINTS)}"
        ) from None
    dest = os.path.join(cache_dir(), fname)
    if os.path.exists(dest):
        return dest
    os.makedirs(cache_dir(), exist_ok=True)

    tmp = dest + ".part"
    try:
        print(f"downloading {url} -> {dest} ...")
        _download(url, tmp)
        reason = _looks_like_checkpoint(tmp)
        if reason is not None:
            raise ArtifactValidationError(reason)
        os.replace(tmp, dest)  # atomic: no truncated file on a re-run
    except Exception as e:  # noqa: BLE001 — any failure gets instructions
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"could not download {name!r} from {url} ({e}). If this "
            f"environment has no network egress, stage the file manually "
            f"at {dest} and re-run."
        ) from e
    return dest


def resolve_backbone(spec: str, generation: str) -> str:
    """Map a ``--pretrained_backbone`` value to a local weights path.

    * an existing path — used as-is (the round-2 behavior);
    * ``auto`` / ``imagenet`` / ``true`` / ``1`` — the ImageNet weights
      for this generation's backbone (vgg16 for legacy, resnet50 for
      fpn), fetched into the cache if needed;
    * a registry name (``vgg16`` / ``resnet50``) — that entry;
    * anything else — error (a typo'd path must not silently fall back
      to random weights).
    """
    if os.path.exists(spec):
        return spec
    low = spec.lower()
    if low in _AUTO_SPECS:
        name = "vgg16" if generation == "legacy" else "resnet50"
        return fetch(name)
    if low in CHECKPOINTS:
        return fetch(low)
    raise ValueError(
        f"--pretrained_backbone {spec!r}: not a file, not one of "
        f"{sorted(_AUTO_SPECS)} and not a registry entry "
        f"{sorted(CHECKPOINTS)}"
    )
