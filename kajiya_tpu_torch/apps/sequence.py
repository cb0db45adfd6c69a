"""Camera/sun keyframe sequencer with Catmull-Rom playback; numpy only, a copy
of `kajiya_tpu/apps/sequence.py`.

Role of `view/src/sequence.rs` + the playback in `runtime.rs:510-601`:
record keyframes (camera position/direction, sun direction, duration per
segment), interpolate smoothly, and drive offline renders / turntables.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Keyframe:
    t: float                      # seconds from sequence start
    cam_pos: np.ndarray
    cam_dir: np.ndarray
    sun_dir: np.ndarray | None = None


@dataclass
class Sequence:
    keys: list = field(default_factory=list)

    def add(self, t, cam_pos, cam_dir, sun_dir=None):
        self.keys.append(Keyframe(
            t=float(t),
            cam_pos=np.asarray(cam_pos, np.float32),
            cam_dir=np.asarray(cam_dir, np.float32),
            sun_dir=None if sun_dir is None else np.asarray(sun_dir, np.float32)))
        self.keys.sort(key=lambda k: k.t)
        return self

    @property
    def duration(self):
        return self.keys[-1].t if self.keys else 0.0

    def sample(self, t: float) -> Keyframe:
        """Catmull-Rom interpolated state at time t (clamped ends)."""
        ks = self.keys
        if not ks:
            raise ValueError("empty sequence")
        if len(ks) == 1 or t <= ks[0].t:
            return ks[0]
        if t >= ks[-1].t:
            return ks[-1]
        i = max(1, next(j for j in range(1, len(ks)) if ks[j].t > t))
        p1, p2 = ks[i - 1], ks[i]
        p0 = ks[max(i - 2, 0)]
        p3 = ks[min(i + 1, len(ks) - 1)]
        u = (t - p1.t) / max(p2.t - p1.t, 1e-6)

        def cr(a, b, c, d):
            return _catmull_rom(a, b, c, d, u)

        pos = cr(p0.cam_pos, p1.cam_pos, p2.cam_pos, p3.cam_pos)
        dirn = cr(p0.cam_dir, p1.cam_dir, p2.cam_dir, p3.cam_dir)
        dirn = dirn / max(np.linalg.norm(dirn), 1e-8)
        sun = None
        if p1.sun_dir is not None and p2.sun_dir is not None:
            s0 = p0.sun_dir if p0.sun_dir is not None else p1.sun_dir
            s3 = p3.sun_dir if p3.sun_dir is not None else p2.sun_dir
            sun = cr(s0, p1.sun_dir, p2.sun_dir, s3)
            sun = sun / max(np.linalg.norm(sun), 1e-8)
        return Keyframe(t=t, cam_pos=pos, cam_dir=dirn, sun_dir=sun)

    # --- persistence (RON-ish via simple repr; the reference persists RON)
    def to_dict(self):
        return {"keys": [
            {"t": k.t, "cam_pos": k.cam_pos.tolist(),
             "cam_dir": k.cam_dir.tolist(),
             "sun_dir": None if k.sun_dir is None else k.sun_dir.tolist()}
            for k in self.keys]}

    @classmethod
    def from_dict(cls, d):
        s = cls()
        for k in d["keys"]:
            s.add(k["t"], k["cam_pos"], k["cam_dir"], k.get("sun_dir"))
        return s


def _catmull_rom(p0, p1, p2, p3, u):
    u2, u3 = u * u, u * u * u
    return (p1 * (2.0) + (p2 - p0) * u
            + (2.0 * p0 - 5.0 * p1 + 4.0 * p2 - p3) * u2
            + (-p0 + 3.0 * p1 - 3.0 * p2 + p3) * u3) * 0.5


# ----------------------------------------------------------------------------
# Sun controller (`view/src/persisted.rs:24-130`: a latent 2D state mapped
# to a sun direction so dragging feels continuous across the zenith)
# ----------------------------------------------------------------------------

class SunController:
    def __init__(self, towards=(0.35, 0.8, 0.5)):
        d = np.asarray(towards, np.float32)
        d = d / np.linalg.norm(d)
        self._dir = d

    @property
    def direction(self):
        return self._dir

    def rotate(self, d_azimuth: float, d_elevation: float):
        """Incremental rotation in radians (the latent-space controller's
        user-visible behavior)."""
        x, y, z = self._dir
        az = np.arctan2(z, x) + d_azimuth
        el = np.clip(np.arcsin(np.clip(y, -1, 1)) + d_elevation,
                     -0.49 * np.pi, 0.49 * np.pi)
        c = np.cos(el)
        self._dir = np.asarray(
            [c * np.cos(az), np.sin(el), c * np.sin(az)], np.float32)
        return self._dir
