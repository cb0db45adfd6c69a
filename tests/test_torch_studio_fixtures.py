"""The studio fixtures (`tests/data/studio/`, written by
`tools/make_studio_fixtures.py`): the BLP, FTEX, PSD, PCX, DCX, PFM and
16-bit PGM files the studio city does not carry. Each decodes, in PIL and
in the port (from its path, as the bake reads it), to the RGBA digest of
`manifest.json`, which `chip_smoke.py::studio_phase` checks on the card's
host, where there is no PIL; a file marked "white" (BLP2's raw BGRA, which
PIL has no decoder for) raises what the bake turns white in both; the LAB
PSD gives PIL's bytes (once "unported", now converted as LittleCMS
does)."""
import hashlib
import io
import json
import os

import numpy as np
import pytest
from PIL import Image

from kajiya_tpu_torch.scene import textures

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "studio")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)


def test_manifest_lists_every_kind():
    assert len(MANIFEST) == 19
    assert sum(bool(r.get("white")) for r in MANIFEST.values()) == 1
    assert [n for n, r in MANIFEST.items() if r.get("unported")] == []
    assert sum(r["bytes"] for r in MANIFEST.values()) < 200_000


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_fixture_matches_manifest(name):
    rec = MANIFEST[name]
    path = os.path.join(FIXTURES, name)
    with open(path, "rb") as f:
        data = f.read()
    assert len(data) == rec["bytes"]
    if rec.get("white"):
        with pytest.raises(Exception):
            Image.open(io.BytesIO(data)).convert("RGBA")
        with pytest.raises((OSError, ValueError)):
            textures._decode_image(path)
        return
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    assert hashlib.sha256(want.tobytes()).hexdigest() == rec["rgba_sha256"]
    if rec.get("unported"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            textures._decode_image(path)
        return
    got = textures._decode_image(path)
    assert list(got.shape) == rec["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == rec["rgba_sha256"]
