"""Numpy top-down renderer: dependency-free `rgb_array` frames.

A copy of the JAX package's `NumpyTopDownRenderer` that reads the port's
tensors, on any device, through one host copy each. It renders the terrain
heightmap as a hillshaded basemap (computed once) and overlays each
helicopter's position and heading. Entirely host-side; consumes an EnvState.
"""
from __future__ import annotations

import numpy as np


def host(t) -> np.ndarray:
    """A tensor's values as a numpy array on the host."""
    return t.detach().cpu().numpy()


class NumpyTopDownRenderer:
    def __init__(self, core_env, width: int = 512, height: int = 512):
        self.env = core_env
        self.width, self.height = width, height
        hmap = host(core_env.terrain.hmap)
        # Simple hillshade from north-west illumination.
        gy, gx = np.gradient(hmap)
        shade = 0.5 + 0.25 * np.tanh(0.02 * (gx - gy))
        rel = (hmap - hmap.min()) / max(float(hmap.max() - hmap.min()), 1e-6)
        base = np.stack([
            shade * (0.35 + 0.45 * rel),        # R
            shade * (0.45 + 0.40 * rel),        # G
            shade * (0.30 + 0.30 * rel),        # B
        ], axis=-1)
        self._basemap = (np.clip(base, 0, 1) * 255).astype(np.uint8)

    def render(self, env_state, mode: str = "rgb_array"):
        # no GUI backend required: "human" returns the frame too
        return self._draw(env_state)

    def _draw(self, es) -> np.ndarray:
        h, w = self._basemap.shape[:2]
        img = self._basemap.copy()
        xyz = host(es.heli.xyz).reshape(-1, 3)
        euler = host(es.heli.euler).reshape(-1, 3)
        ns, ew = self.env.terrain.ns_max, self.env.terrain.ew_max
        for pos, eul in zip(xyz, euler):
            # NED -> pixel (the terrain lookup's mapping, ops/terrain.py)
            px = int(np.clip(pos[0] / (ns / h) + h // 2, 0, h - 1))
            py = int(np.clip(pos[1] / (ew / w) + w // 2, 0, w - 1))
            # marker: red disc + yellow heading tick
            yy, xx = np.ogrid[-4:5, -4:5]
            disc = yy * yy + xx * xx <= 16
            y0, y1 = max(py - 4, 0), min(py + 5, h)
            x0, x1 = max(px - 4, 0), min(px + 5, w)
            img[y0:y1, x0:x1][disc[:y1 - y0, :x1 - x0]] = (220, 40, 40)
            dy = int(round(6 * np.sin(eul[2])))
            dx = int(round(6 * np.cos(eul[2])))
            ty, tx = np.clip(py + dy, 0, h - 1), np.clip(px + dx, 0, w - 1)
            img[ty, tx] = (255, 230, 40)
        return img

    def close(self):
        pass
