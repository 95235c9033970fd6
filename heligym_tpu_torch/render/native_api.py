"""ctypes binding and OO facade of the native software renderer.

The C++ is the JAX package's (`heligym_tpu/render/native/`: softrender.cpp,
api.cpp, x11sink.cpp), read from disk as the port reads that package's
YAML airframes and terrain asset; nothing of it is imported or forked.
`build` compiles it with g++ at first use, as its CMakeLists.txt has CMake
do (-O2 -fPIC -std=gnu++17, one object per source, linked with -ldl), into
`build/heligym_tpu_torch/render_<hash>.so` beside the CUDA kernels' builds;
the hash covers the sources, headers and flags, so an edited source is
rebuilt and a stale library never loads. It never reads or writes the JAX
package's own `render/lib/`.

`Renderer` has the reference renderer's entry-point names and NED ->
graphics-frame conversions; `NativeRenderer` draws an EnvState of the port
(on any device, through host copies) as the JAX package's does.
"""
from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import math
import os
import shutil
import subprocess
from typing import Optional

import numpy as np

from ..ops.cuda.build import BUILD_DIR
from ..ops.terrain import _ASSET_DIR
from ..utils.constants import FT2MTR
from .topdown import host

NATIVE_DIR = os.path.join(os.path.dirname(_ASSET_DIR), "render", "native")
SOURCES = ("softrender.cpp", "api.cpp", "x11sink.cpp")
# CMakeLists.txt's build: CMAKE_CXX_FLAGS_RELEASE "-O2", C++17 with CMake's
# default GNU extensions, position-independent code, ${CMAKE_DL_LIBS}
CXX_FLAGS = ("-O2", "-fPIC", "-std=gnu++17")
LINK_FLAGS = ("-ldl",)


def library_path() -> str:
    """The library's path for the sources on disk and the flags."""
    digest = hashlib.sha256(repr((CXX_FLAGS, LINK_FLAGS)).encode())
    for path in sorted(glob.glob(os.path.join(NATIVE_DIR, "*.cpp"))
                       + glob.glob(os.path.join(NATIVE_DIR, "*.h"))):
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + f.read())
    return os.path.join(BUILD_DIR, f"render_{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library if it is missing, as CMake does: one g++ per
    source, all started together, then the link; returns its path. Raises
    RuntimeError when there is no C++ compiler or the build fails."""
    path = library_path()
    if os.path.exists(path):
        return path
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("the native renderer needs a C++ compiler (g++)")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    objs = [f"{tmp}.{os.path.splitext(s)[0]}.o" for s in SOURCES]
    procs = []
    try:
        for src, obj in zip(SOURCES, objs):
            procs.append(subprocess.Popen(
                [cxx, *CXX_FLAGS, "-c", os.path.join(NATIVE_DIR, src), "-o", obj],
                stderr=subprocess.PIPE, text=True))
        errs = [p.communicate(timeout=300)[1] for p in procs]
        link = subprocess.run([cxx, *CXX_FLAGS, "-shared", *objs, "-o", tmp, *LINK_FLAGS],
                              capture_output=True, text=True, timeout=300)
        if any(p.returncode for p in procs) or link.returncode:
            raise RuntimeError("the native renderer's build failed:\n"
                               + "".join(errs) + link.stderr)
        os.replace(tmp, path)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in objs + [tmp]:
            if os.path.exists(f):
                os.unlink(f)
    return path


@functools.lru_cache(maxsize=None)
def _load():
    """The loaded library with every entry point's signature, or None where
    it cannot be built."""
    try:
        lib = ctypes.CDLL(build())
    except (RuntimeError, OSError, subprocess.TimeoutExpired):
        return None
    c = ctypes
    lib.create_window.restype = c.c_void_p
    lib.create_window.argtypes = [c.c_uint, c.c_uint, c.c_char_p]
    lib.render.argtypes = [c.c_void_p]
    lib.close.argtypes = [c.c_void_p]
    lib.is_close.restype = c.c_bool
    lib.is_close.argtypes = [c.c_void_p]
    lib.destroy_window.argtypes = [c.c_void_p]
    lib.create_model.restype = c.c_void_p
    lib.create_model.argtypes = [c.c_char_p, c.c_char_p, c.c_char_p]
    lib.create_terrain_model.restype = c.c_void_p
    lib.create_terrain_model.argtypes = [
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        c.c_int, c.c_int, c.c_float, c.c_float, c.c_float]
    lib.create_terrain_model_textured.restype = c.c_void_p
    lib.create_terrain_model_textured.argtypes = [
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        c.c_int, c.c_int, c.c_float, c.c_float, c.c_float]
    lib.create_terrain_model_textured2.restype = c.c_void_p
    lib.create_terrain_model_textured2.argtypes = [
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        c.c_int, c.c_int, c.c_float, c.c_float, c.c_float,
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        c.c_int, c.c_int]
    lib.create_procedural_model.restype = c.c_void_p
    lib.create_procedural_model.argtypes = [c.c_char_p]
    lib.destroy_model.argtypes = [c.c_void_p]
    lib.add_permanent_to_window.argtypes = [c.c_void_p, c.c_void_p]
    lib.add_instantaneous_to_window.argtypes = [c.c_void_p, c.c_void_p]
    lib.translate_model.argtypes = [c.c_void_p, c.c_float, c.c_float, c.c_float]
    lib.rotate_model.argtypes = [c.c_void_p, c.c_float, c.c_float, c.c_float, c.c_float]
    lib.scale_model.argtypes = [c.c_void_p, c.c_float, c.c_float, c.c_float]
    lib.get_fps.restype = c.c_float
    lib.get_fps.argtypes = [c.c_void_p]
    lib.set_fps.argtypes = [c.c_void_p, c.c_float]
    lib.get_camera.restype = c.c_void_p
    lib.get_camera.argtypes = [c.c_void_p]
    lib.set_camera_pos.argtypes = [c.c_void_p, c.c_float, c.c_float, c.c_float]
    lib.get_camera_pos.restype = c.POINTER(c.c_float)
    lib.get_camera_pos.argtypes = [c.c_void_p]
    lib.set_camera_look_at.argtypes = [c.c_void_p, c.c_float, c.c_float, c.c_float]
    lib.camera_process_keyboard.argtypes = [c.c_void_p, c.c_int, c.c_float]
    lib.camera_process_mouse.argtypes = [c.c_void_p, c.c_float, c.c_float,
                                         c.c_bool]
    lib.camera_process_scroll.argtypes = [c.c_void_p, c.c_float]
    lib.get_camera_zoom.restype = c.c_float
    lib.get_camera_zoom.argtypes = [c.c_void_p]
    lib.set_supersampling.argtypes = [c.c_void_p, c.c_int]
    lib.is_visible.restype = c.c_bool
    lib.is_visible.argtypes = [c.c_void_p]
    lib.hide_window.argtypes = [c.c_void_p]
    lib.show_window.argtypes = [c.c_void_p]
    lib.create_guiTextVector.restype = c.c_int
    lib.create_guiTextVector.argtypes = [c.c_void_p, c.c_char_p, c.c_float,
                                         c.c_float, c.c_float, c.c_float]
    lib.add_guiText.argtypes = [c.c_void_p, c.c_int, c.c_int,
                                c.POINTER(c.c_char_p),
                                np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")]
    lib.set_guiText.argtypes = [c.c_void_p, c.c_int,
                                np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")]
    lib.rotate_MR.argtypes = [c.c_void_p, c.c_float, c.c_float, c.c_float]
    lib.rotate_TR.argtypes = [c.c_void_p, c.c_float, c.c_float, c.c_float]
    lib.get_frame.argtypes = [c.c_void_p,
                              np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")]
    lib.get_width.restype = c.c_int
    lib.get_width.argtypes = [c.c_void_p]
    lib.get_height.restype = c.c_int
    lib.get_height.argtypes = [c.c_void_p]
    # X11 presentation sink (x11sink.cpp): libX11 is dlopen'd at RUNTIME by
    # the native library, so these entry points always exist — they just
    # report unavailability on headless hosts.
    lib.native_display_available.restype = c.c_int
    lib.window_show_native.restype = c.c_int
    lib.window_show_native.argtypes = [c.c_void_p]
    lib.window_present_native.restype = c.c_int
    lib.window_present_native.argtypes = [c.c_void_p]
    lib.window_hide_native.argtypes = [c.c_void_p]
    return lib


def native_available() -> bool:
    return _load() is not None


def _load_terrain_texture():
    """Full-resolution terrain texture from the terrain asset (None if it has
    none), sampled bilinearly per fragment by the rasterizer, so texture
    detail does not depend on the mesh decimation step."""
    try:
        with np.load(os.path.join(_ASSET_DIR, "terrain.npz")) as z:
            if "tex_raw" not in z.files:
                return None
            return z["tex_raw"][:, :, :3].astype(np.float32) / 255.0
    except (OSError, ValueError):
        return None


class Renderer:
    """OO facade over the C ABI with the reference's NED->GL conversions
    (api.py:68-119): GL x = north, GL y = up (-down), GL z = east."""

    def __init__(self, w: int = 800, h: int = 600, title: str = "heligym-tpu"):
        self._lib = _load()
        if self._lib is None:
            raise RuntimeError("native renderer library unavailable")
        self.window = self._lib.create_window(w, h, title.encode())
        self.width, self.height = w, h
        self.camera = self._lib.get_camera(self.window)

    # window ------------------------------------------------------------
    def render(self):
        self._lib.render(self.window)

    def close(self):
        self._lib.close(self.window)

    def is_close(self) -> bool:
        return self._lib.is_close(self.window)

    def terminate(self):
        if self.window:
            self._lib.destroy_window(self.window)
            self.window = None

    def get_frame(self) -> np.ndarray:
        out = np.empty((self.height, self.width, 3), np.uint8)
        self._lib.get_frame(self.window, out)
        return out

    def is_visible(self) -> bool:
        return self._lib.is_visible(self.window)

    def hide_window(self):
        self._lib.hide_window(self.window)

    def show_window(self):
        self._lib.show_window(self.window)

    def get_fps(self) -> float:
        return self._lib.get_fps(self.window)

    def set_fps(self, fps: float):
        self._lib.set_fps(self.window, fps)

    # models ------------------------------------------------------------
    def create_model(self, path: Optional[str] = None,
                     vertex_shader_path: str = "", fragment_shader_path: str = "",
                     abs_path: Optional[str] = None):
        p = (abs_path or path or "procedural://heli").encode()
        return self._lib.create_model(p, vertex_shader_path.encode(),
                                      fragment_shader_path.encode())

    def create_terrain_model(self, hmap_m: np.ndarray, ns_size_m: float,
                             ew_size_m: float, texture_rgb=None):
        """Terrain mesh straight from the heightmap (meters) — replaces the
        reference's assimp terrain.obj load with the actual physics terrain.
        `texture_rgb`: optional (TH, TW, 3) float [0,1] texture, sampled
        bilinearly per fragment (same-shape-as-mesh arrays still work as
        per-vertex colors via the legacy entry point)."""
        hmap_m = np.ascontiguousarray(hmap_m, np.float32)
        if texture_rgb is not None:
            tex = np.ascontiguousarray(texture_rgb, np.float32)
            if tex.shape[:2] == hmap_m.shape:
                return self._lib.create_terrain_model_textured(
                    hmap_m, tex, hmap_m.shape[0], hmap_m.shape[1],
                    float(ns_size_m), float(ew_size_m), 1.0)
            return self._lib.create_terrain_model_textured2(
                hmap_m, hmap_m.shape[0], hmap_m.shape[1],
                float(ns_size_m), float(ew_size_m), 1.0,
                tex, tex.shape[0], tex.shape[1])
        return self._lib.create_terrain_model(
            hmap_m, hmap_m.shape[0], hmap_m.shape[1],
            float(ns_size_m), float(ew_size_m), 1.0)

    def add_permanent_object_to_window(self, model):
        self._lib.add_permanent_to_window(self.window, model)

    def add_instantanous_object_to_window(self, model):
        self._lib.add_instantaneous_to_window(self.window, model)

    # transforms (NED -> GL exactly as reference api.py) -----------------
    def translate_model(self, model, x, y, z):
        self._lib.translate_model(model, x, -z, y)

    def rotate_model(self, model, phi, theta, psi):
        self._lib.rotate_model(model, -psi, 0, 1, 0)
        self._lib.rotate_model(model, theta, 0, 0, 1)
        self._lib.rotate_model(model, phi, 1, 0, 0)

    def scale_model(self, model, x, y, z):
        self._lib.scale_model(model, x, -z, y)

    def rotate_MR(self, model, phi, theta, psi):
        self._lib.rotate_MR(model, phi, -psi, theta)

    def rotate_TR(self, model, phi, theta, psi):
        self._lib.rotate_TR(model, phi, -psi, theta)

    # camera -------------------------------------------------------------
    def set_camera_pos(self, x, y, z):
        self._lib.set_camera_pos(self.camera, x, -z, y)

    def get_camera_pos(self):
        p = self._lib.get_camera_pos(self.camera)
        return [p[0], p[1], p[2]]

    def look_at(self, x, y, z):
        self._lib.set_camera_look_at(self.camera, x, -z, y)

    # fly-camera input surface (reference camera.cpp:39-96, fed by the GLFW
    # callbacks in gWindow.cpp:260-309; here events come from the caller —
    # notebook widget, video-path scripter, etc.)
    CAM_FORWARD, CAM_BACKWARD, CAM_LEFT, CAM_RIGHT = 0, 1, 2, 3
    CAM_UP, CAM_DOWN, CAM_BOOST = 4, 5, 6

    def process_keyboard(self, direction: int, dt: float):
        self._lib.camera_process_keyboard(self.camera, direction, dt)

    def process_mouse(self, dx: float, dy: float, constrain_pitch=True):
        self._lib.camera_process_mouse(self.camera, dx, dy, constrain_pitch)

    def process_scroll(self, dy: float):
        self._lib.camera_process_scroll(self.camera, dy)

    def get_zoom(self) -> float:
        return self._lib.get_camera_zoom(self.camera)

    def set_supersampling(self, factor: int):
        """SSAA factor: 1 = off, 2 (default) ~= the reference's 4x MSAA."""
        self._lib.set_supersampling(self.window, factor)

    def coord_from_graphics_to_ned(self, x, y, z):
        return x, z, -y

    # OS-window presentation (x11sink.cpp; the reference's GLFW window role,
    # gWindow.cpp:260-309) --------------------------------------------------
    def display_available(self) -> bool:
        """True when a real X display can be opened (libX11 + DISPLAY)."""
        return bool(self._lib.native_display_available())

    def show_native_window(self) -> int:
        """Open an OS window presenting this renderer's framebuffer.
        0 = ok; -1 no libX11, -2 no display, -3 unsupported visual."""
        return self._lib.window_show_native(self.window)

    def present_native_window(self) -> int:
        """Blit the current frame + pump mouse/scroll/keyboard events into
        the fly camera. Bitmask: 1 = close requested, 2 = camera input."""
        return self._lib.window_present_native(self.window)

    def hide_native_window(self):
        self._lib.window_hide_native(self.window)

    # gui text -----------------------------------------------------------
    def create_guiText(self, title, pos_x, pos_y, size_x, size_y):
        return self._lib.create_guiTextVector(self.window, title.encode(),
                                              pos_x, pos_y, size_x, size_y)

    def add_guiText(self, gui_id, fmts, vals):
        arr = (ctypes.c_char_p * len(fmts))(*[f.encode() for f in fmts])
        vals = np.ascontiguousarray(np.asarray(vals, np.float32))
        self._lib.add_guiText(self.window, gui_id, len(fmts), arr, vals)

    def set_guiText(self, gui_id, fmts, vals):
        vals = np.ascontiguousarray(np.asarray(vals, np.float32))
        self._lib.set_guiText(self.window, gui_id, vals)


class NativeRenderer:
    """High-level EnvState renderer: drives the `Renderer` facade exactly the
    way the reference env drives its renderer (helicopter.py:140-183) —
    rotor-uniform updates, ft->m NED translation, chase camera — and returns
    rgb frames."""

    OBS_LABELS = [
        "POWER      : %5.2f HP", "LON_VEL    : %5.2f FT/S",
        "LAT_VEL    : %5.2f FT/S", "DWN_VEL    : %5.2f FT/S",
        "N_VEL      : %5.2f FT/S", "E_VEL      : %5.2f FT/S",
        "DES_RATE   : %5.2f FT/S", "ROLL       : %5.2f RAD",
        "PITCH      : %5.2f RAD", "YAW        : %5.2f RAD",
        "ROLL_RATE  : %5.2f R/S", "PITCH_RATE : %5.2f R/S",
        "YAW_RATE   : %5.2f R/S", "N_POS      : %5.2f FT",
        "E_POS      : %5.2f FT", "ALT        : %5.2f FT",
        "GR_ALT     : %5.2f FT",
    ]

    def __init__(self, core_env, width: int = 1024, height: int = 768,
                 terrain_res: int = 256, camera_mode: str = "chase",
                 orbit_frames: int = 400):
        self.env = core_env
        self.camera_mode = camera_mode   # "chase" (reference) | "orbit"
        self.orbit_frames = orbit_frames  # render() calls per full orbit
        self._frame = 0
        self.renderer = Renderer(width, height)
        # No FPS cap in headless rgb_array use: frames are produced at sim
        # pace. Callers wanting realtime pacing (interactive viewing) opt in
        # with renderer.set_fps(50.0) — the preciseSleep throttle is
        # implemented (softrender.cpp::precise_sleep, gWindow.cpp:193-221).

        hmap_ft = host(core_env.terrain.hmap)
        step = max(1, hmap_ft.shape[0] // terrain_res)
        hmap_m = hmap_ft[::step, ::step] * FT2MTR
        self.terrain = self.renderer.create_terrain_model(
            hmap_m, core_env.terrain.ns_max * FT2MTR,
            core_env.terrain.ew_max * FT2MTR,
            texture_rgb=_load_terrain_texture())
        self.renderer.add_permanent_object_to_window(self.terrain)

        self.heli_obj = self.renderer.create_model("procedural://heli")
        self.renderer.add_permanent_object_to_window(self.heli_obj)

        self.gui_id = self.renderer.create_guiText("OBSERVATIONS", 8.0, 8.0,
                                                   250.0, 0.0)
        fmts = ["FPS        : %3.0f"] + self.OBS_LABELS
        self.renderer.add_guiText(self.gui_id, fmts, np.zeros(len(fmts)))
        self._fmts = fmts

    def render(self, env_state, mode: str = "rgb_array"):
        if mode not in ("rgb_array", "human"):
            raise ValueError(f"unsupported render mode {mode!r} "
                             "(rgb_array | human)")
        if mode == "human":
            self._ensure_viewer()     # raises RuntimeError when headless
            self._pump_viewer_keys()  # fly-cam events BEFORE camera update
        heli = env_state.heli
        xyz = host(heli.xyz).reshape(-1, 3)[0]
        euler = host(heli.euler).reshape(-1, 3)[0]
        betas = host(heli.betas).reshape(-1, 2)[0]
        psi_mr = float(host(heli.psi_mr).reshape(-1)[0])
        psi_tr = float(host(heli.psi_tr).reshape(-1)[0])
        obs = host(env_state.obs).reshape(-1, 17)[0]

        r = self.renderer
        vals = np.concatenate([[r.get_fps()], obs]).astype(np.float32)
        r.set_guiText(self.gui_id, self._fmts, vals)

        r.rotate_MR(self.heli_obj, betas[1], betas[0], psi_mr)
        r.rotate_TR(self.heli_obj, 0.0, psi_tr, 0.0)
        x_m, y_m, z_m = (float(xyz[0]) * FT2MTR, float(xyz[1]) * FT2MTR,
                         float(xyz[2]) * FT2MTR)
        r.translate_model(self.heli_obj, x_m, y_m, z_m)
        r.rotate_model(self.heli_obj, float(euler[0]), float(euler[1]),
                       float(euler[2]))
        if self._fly_cam:
            pass  # free camera: keyboard/arrow events own the pose
        elif self.camera_mode == "orbit":
            # slow cinematic orbit around the heli (uses the same pose API a
            # caller-driven fly-cam would; see process_mouse/process_keyboard)
            ang = 2.0 * math.pi * (self._frame / max(self.orbit_frames, 1))
            r.set_camera_pos(x_m + 30.0 * math.sin(ang),
                             y_m + 30.0 * math.cos(ang), z_m - 9.0)
        else:
            # chase camera 30 m east of the heli (helicopter.py:175-177),
            # looking at it
            r.set_camera_pos(x_m, y_m + 30.0, z_m)
        if not self._fly_cam:
            r.look_at(x_m, y_m, z_m)
        self._frame += 1
        if not r.is_visible():
            r.show_window()
        r.render()
        frame = r.get_frame()
        if mode == "human":
            self._viewer.show(frame)
            return None   # gymnasium: human mode renders for a human,
        return frame      # returns nothing; rgb_array returns the frame

    # ------------------------------------------------- human-mode viewer
    # The reference's human mode is a GLFW window whose mouse/scroll
    # callbacks drive Camera::ProcessMouseMovement/Scroll
    # (gWindow.cpp:260-309). Here human mode picks the best available sink:
    # a real X11 window when a display exists (render/native/x11sink.cpp —
    # mouse-drag orbit, scroll zoom, WASD fly-cam, all driving the same
    # sr::Camera), else the in-terminal viewer (render/terminal_viewer.py)
    # whose raw-mode keyboard drives the SAME camera_process_* C API.
    _fly_cam = False
    _viewer = None
    viewer_quit = False   # latched when the user presses q / Escape

    def _ensure_viewer(self, **kw):
        if self._viewer is None:
            r = self.renderer
            if (not kw.get("force_terminal")
                    and r.display_available()
                    and r.show_native_window() == 0):
                self._viewer = _NativeWindowViewer(self)
                r.set_fps(50.0)   # realtime pacing via precise_sleep
            else:
                from .terminal_viewer import TerminalViewer
                kw.pop("force_terminal", None)
                self._viewer = TerminalViewer(**kw)
                r.set_fps(0.0)    # viewer owns pacing

    def _pump_viewer_keys(self):
        r = self.renderer
        dt = 1.0 / max(self._viewer.fps, 1e-6)
        for key in self._viewer.poll_keys():
            if key == "q":
                self.viewer_quit = True
            elif key == "c":
                self._fly_cam = not self._fly_cam
            elif key in ("w", "a", "s", "d", "r", "f"):
                self._fly_cam = True
                from .terminal_viewer import _KEY_DIRECTIONS
                r.process_keyboard(_KEY_DIRECTIONS[key], dt)
            elif key in ("up", "down", "left", "right"):
                self._fly_cam = True
                dx = {"left": -10.0, "right": 10.0}.get(key, 0.0)
                dy = {"up": 10.0, "down": -10.0}.get(key, 0.0)
                r.process_mouse(dx, dy)
            elif key in ("+", "="):
                r.process_scroll(1.0)
            elif key == "-":
                r.process_scroll(-1.0)

    def close(self):
        if self._viewer is not None:
            self._viewer.close()
            self._viewer = None
        self.renderer.terminate()


class _NativeWindowViewer:
    """Human-mode sink over the X11 presentation window: `show` blits the
    just-rendered framebuffer and pumps window events straight into the
    native fly camera (the C side handles drag/scroll/WASD — no Python
    key loop). Duck-typed to the TerminalViewer interface NativeRenderer
    drives (fps / poll_keys / show / close)."""

    fps = 50.0

    def __init__(self, host: "NativeRenderer"):
        self.host = host

    def poll_keys(self):
        return []   # events are consumed natively in present

    def show(self, frame):
        del frame   # the C sink reads the renderer's own framebuffer
        res = self.host.renderer.present_native_window()
        if res & 2:
            # user touched the camera: hand the pose over to the fly-cam
            # (stop re-scripting the chase camera every frame)
            self.host._fly_cam = True
        if res & 1:
            self.host.viewer_quit = True

    def close(self):
        self.host.renderer.hide_native_window()
