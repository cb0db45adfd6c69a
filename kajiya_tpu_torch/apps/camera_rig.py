"""Smoothed FPS camera rig (Position + YawPitch + Smooth); numpy only, a copy
of `kajiya_tpu/apps/camera_rig.py`.

Role of the dolly-rig stack in `view/src/runtime.rs:69-73,192-286`: WASD-style
translation in camera space, yaw/pitch look, and critically-damped smoothing
of both position and rotation for the interactive viewer.
"""
from __future__ import annotations

import numpy as np


class CameraRig:
    def __init__(self, position=(0.0, 1.0, 8.0), yaw: float = 0.0,
                 pitch: float = 0.0, smooth: float = 12.0):
        self.target_pos = np.asarray(position, np.float32)
        self.target_yaw = float(yaw)
        self.target_pitch = float(pitch)
        self.pos = self.target_pos.copy()
        self.yaw = self.target_yaw
        self.pitch = self.target_pitch
        self.smooth = smooth

    # --- input
    def translate(self, right: float, up: float, fwd: float, speed: float = 1.0):
        """Move in view space (WASD + QE)."""
        f = self.forward
        r = np.asarray([np.cos(self.target_yaw), 0.0,
                        -np.sin(self.target_yaw)], np.float32)
        u = np.asarray([0.0, 1.0, 0.0], np.float32)
        self.target_pos = (self.target_pos
                           + (r * right + u * up + f * fwd) * speed)

    def look(self, d_yaw: float, d_pitch: float):
        self.target_yaw += d_yaw
        self.target_pitch = float(np.clip(self.target_pitch + d_pitch,
                                          -0.49 * np.pi, 0.49 * np.pi))

    # --- per-frame update
    def update(self, dt: float):
        t = 1.0 - np.exp(-self.smooth * dt)
        self.pos = self.pos + (self.target_pos - self.pos) * t
        self.yaw = self.yaw + (self.target_yaw - self.yaw) * t
        self.pitch = self.pitch + (self.target_pitch - self.pitch) * t
        return self.pos, self.forward_smoothed

    @property
    def forward(self):
        cy, sy = np.cos(self.target_yaw), np.sin(self.target_yaw)
        cp, sp = np.cos(self.target_pitch), np.sin(self.target_pitch)
        return np.asarray([-sy * cp, sp, -cy * cp], np.float32)

    @property
    def forward_smoothed(self):
        cy, sy = np.cos(self.yaw), np.sin(self.yaw)
        cp, sp = np.cos(self.pitch), np.sin(self.pitch)
        return np.asarray([-sy * cp, sp, -cy * cp], np.float32)
