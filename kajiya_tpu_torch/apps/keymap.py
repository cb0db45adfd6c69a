"""TOML keymap loading (port of `kajiya_tpu/apps/keymap.py`, itself the
counterpart of `view/src/keymap.rs:11-31`).

Maps action names to keys for an interactive frontend; the headless viewer
carries it so embedders get the same config surface.
"""
from __future__ import annotations

import tomllib

DEFAULT_KEYMAP = {
    "move_forward": "w", "move_backward": "s",
    "move_left": "a", "move_right": "d",
    "move_up": "e", "move_down": "q",
    "boost": "shift", "slow": "ctrl",
    "toggle_reference": "space",
    "sun_rotate": "mouse_right",
    "look": "mouse_left",
}


def load_keymap(path: str | None = None) -> dict:
    """Load a TOML keymap, falling back to defaults for missing actions."""
    km = dict(DEFAULT_KEYMAP)
    if path:
        with open(path, "rb") as f:
            doc = tomllib.load(f)
        for k, v in doc.get("bindings", doc).items():
            if isinstance(v, str):
                km[k] = v
    return km
