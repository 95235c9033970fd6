# Frozen copy of heligym_tpu_torch/ops/terrain.py for the benchmark's plain reference;
# it imports nothing of the port and is not edited with it.
"""Terrain heightmap: a device tensor + gather-based planar interpolation.

The heightmap is the copy beside the reference (`../data/terrain.npz`). The reference's clamp and indexing
behaviour is reproduced, including its two quirks, because the landing-gear
and crash logic are sensitive to them:
  * the y-clamp uses shape[0] (harmless on the square 1024^2 map);
  * the interpolation factors use the *decremented* edge indices.

`packed` is the (H*W, 3) texel table: row y*W+x holds the three texels
`ground_height` reads at cell (y, x) — (middle, north, east), the edge
decrement pre-applied — so one lookup is one row gather. The fused CUDA step
gathers from the same table.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .mathx import cdiv

_ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "data")


@dataclasses.dataclass(frozen=True, eq=False)
class Terrain:
    """Static terrain data: `hmap` (H, W) float32 heights [ft] and the
    `packed` (H*W, 3) texel table, on one device."""
    hmap: torch.Tensor
    ns_max: float           # [ft] north-south span
    ew_max: float           # [ft] east-west span
    packed: torch.Tensor

    def to(self, device) -> "Terrain":
        return dataclasses.replace(self, hmap=self.hmap.to(device),
                                   packed=self.packed.to(device))


def _pack_texels(hmap_np: np.ndarray) -> np.ndarray:
    """(H*W, 3) float32: per cell the exact (middle, north, east) texels of
    `ground_height`'s sampling pattern, edge-decrement quirk included.
    Bit-exact copies of hmap."""
    h, w = hmap_np.shape
    y, x = np.mgrid[0:h, 0:w]
    # NB: mirrors ground_height exactly — x decrements against h, y against w
    # (the reference's shape[0] quirk; identical on the square maps shipped).
    x_d = np.where(x == h - 1, h - 2, x)
    y_d = np.where(y == w - 1, w - 2, y)
    return np.stack([hmap_np[y, x], hmap_np[y_d, x_d + 1],
                     hmap_np[y_d + 1, x_d]], axis=-1).reshape(h * w, 3)


def _terrain(hmap32: np.ndarray, env, device) -> Terrain:
    return Terrain(hmap=torch.from_numpy(hmap32).to(device),
                   ns_max=env.NS_MAX, ew_max=env.EW_MAX,
                   packed=torch.from_numpy(_pack_texels(hmap32)).to(device))


def load_terrain(env, device="cpu", asset_dir: str = _ASSET_DIR) -> Terrain:
    """Load the heightmap asset and scale it like the reference does:
    raw/uint_max * MAX_GR_ALT, computed in float64 then narrowed to
    float32."""
    path = os.path.join(asset_dir, env.HMAP_PATH if env.HMAP_PATH.endswith(".npz")
                        else "terrain.npz")
    with np.load(path) as z:
        hmap_raw = z["hmap_raw"]
    hmap = (hmap_raw / np.iinfo(hmap_raw.dtype).max) * env.MAX_GR_ALT
    return _terrain(np.asarray(hmap, dtype=np.float32), env, device)


def flat_terrain(env, height: float = 0.0, size: int = 64, device="cpu") -> Terrain:
    """Constant-height terrain."""
    return _terrain(np.full((size, size), float(height), dtype=np.float32),
                    env, device)


def ground_height(terrain: Terrain, x, y, hmap=None) -> torch.Tensor:
    """Terrain height [ft] under NED position (x, y), scalar or (B,).

    `hmap` selects the table: `terrain.packed` (the default, one row gather
    per position) or the (H, W) map / its flat (H*W,) form (three element
    gathers). Both give bit-identical heights."""
    h, w = terrain.hmap.shape        # static grid geometry
    hmap = terrain.packed if hmap is None else hmap
    x_scale = terrain.ns_max / h     # ft per pixel, north-south
    y_scale = terrain.ew_max / w     # ft per pixel, east-west

    x_loc = cdiv(x, x_scale) + h // 2
    y_loc = cdiv(y, y_scale) + w // 2
    # Clamp into the map. NB: the y-clamp uses shape[0], the reference's
    # quirk (equal for square maps).
    x_loc = torch.clamp(x_loc, 0.0, float(h - 1))
    y_loc = torch.clamp(y_loc, 0.0, float(h - 1))

    # A NaN position indexes cell 0 (as the XLA gather does) and yields a NaN
    # height through the interpolation factors below.
    x_ind = torch.floor(torch.nan_to_num(x_loc, nan=0.0)).long()
    y_ind = torch.floor(torch.nan_to_num(y_loc, nan=0.0)).long()

    if hmap.ndim == 2 and hmap.shape == (h * w, 3):
        # packed texel table: the edge-decrement quirk is pre-applied per row
        texels = hmap[y_ind * w + x_ind]
        middle, north, east = texels[..., 0], texels[..., 1], texels[..., 2]
        x_ind = torch.where(x_ind == h - 1, h - 2, x_ind)
        y_ind = torch.where(y_ind == w - 1, w - 2, y_ind)
    else:
        flat = hmap.reshape(-1)
        middle = flat[y_ind * w + x_ind]
        # Edge back-off before sampling the forward neighbours; the
        # interpolation factors below intentionally use the decremented
        # indices.
        x_ind = torch.where(x_ind == h - 1, h - 2, x_ind)
        y_ind = torch.where(y_ind == w - 1, w - 2, y_ind)
        north = flat[y_ind * w + (x_ind + 1)]
        east = flat[(y_ind + 1) * w + x_ind]

    return (middle
            + (north - middle) * (x_loc - x_ind.to(x_loc.dtype))
            + (east - middle) * (y_loc - y_ind.to(y_loc.dtype)))


def ground_touching_altitude(params, terrain: Terrain, x, y, hmap=None) -> torch.Tensor:
    """Sea-level altitude at which the CG touches ground."""
    return ground_height(terrain, x, y, hmap=hmap) + params.HELI.WL_CG / 12.0
