"""Rendering of the port's env state, outside the step path.

* `NumpyTopDownRenderer`: always available; a shaded top-down view of the
  terrain heightmap with the helicopter pose overlaid.
* `NativeRenderer`: the JAX package's C++ software rasterizer
  (`heligym_tpu/render/native/*.cpp`, read from disk, not forked), built by
  `native_api` with g++ into `build/heligym_tpu_torch/` at first use; the
  perspective 3D view, the HUD and the human-mode viewers.

Both read the state's tensors through host copies, so a state on the card
renders as its CPU copy does.
"""
from __future__ import annotations

from .native_api import NativeRenderer, native_available
from .topdown import NumpyTopDownRenderer


def get_renderer(core_env, prefer_native: bool = True, **native_kwargs):
    """The native rasterizer where it builds, else the numpy top-down view.
    `native_kwargs` (camera_mode=..., width=...) reach the native renderer."""
    if prefer_native and native_available():
        return NativeRenderer(core_env, **native_kwargs)
    return NumpyTopDownRenderer(core_env)


__all__ = ["NativeRenderer", "NumpyTopDownRenderer", "get_renderer",
           "native_available"]
