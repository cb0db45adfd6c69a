"""Persisted viewer state (port of `kajiya_tpu/apps/persisted.py`, the
counterpart of `view_state.ron` round-tripping, `view/src/main.rs:88-121` +
`persisted.rs`): camera, sun, exposure, scene elements survive across runs.
JSON on disk (RON-equivalent role)."""
from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass, field


@dataclass
class PersistedState:
    camera_position: list = field(default_factory=lambda: [0.0, 1.0, 8.0])
    camera_forward: list = field(default_factory=lambda: [0.0, 0.0, -1.0])
    vertical_fov: float = 52.0
    sun_direction: list = field(default_factory=lambda: [0.35, 0.8, 0.5])
    ev_shift: float = 0.0
    emissive_multiplier: float = 1.0
    use_emissive: bool = True
    sequence: dict | None = None

    def save(self, path: str = "view_state.json"):
        with open(path, "w") as f:
            json.dump(asdict(self), f, indent=2)

    @classmethod
    def load(cls, path: str = "view_state.json") -> "PersistedState":
        if not os.path.exists(path):
            return cls()
        with open(path) as f:
            d = json.load(f)
        st = cls()
        for k, v in d.items():
            if hasattr(st, k):
                setattr(st, k, v)
        return st
