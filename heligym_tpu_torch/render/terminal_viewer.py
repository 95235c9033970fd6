"""In-terminal "human" render mode: ANSI truecolor half-block blit + raw-mode
keyboard fly-cam (a copy of the JAX package's `render/terminal_viewer.py`).

A card's machine is headless: there is no X server to open a window on, so
human mode displays where its user looks, the terminal. Each character cell
shows two pixels through the upper-half-block glyph (fg = top pixel, bg =
bottom pixel, 24-bit SGR colour), and the keyboard (raw cbreak mode,
non-blocking) feeds the native renderer's `camera_process_keyboard/mouse/
scroll` C API: WASD/RF fly, arrows look, +/- zoom, c toggles chase/fly, q
quits.

A declared "human" mode with no TTY attached raises RuntimeError instead of
silently degrading to rgb_array.
"""
from __future__ import annotations

import os
import select
import shutil
import sys
import time

import numpy as np

# camera_process_keyboard direction codes (`native_api.Renderer.CAM_*`)
_KEY_DIRECTIONS = {
    "w": 0, "s": 1, "a": 2, "d": 3,   # forward / back / left / right
    "r": 4, "f": 5,                   # up / down
}
# arrow keys -> process_mouse yaw/pitch deltas (degrees-equivalent px)
_ARROWS = {"A": (0.0, 10.0), "B": (0.0, -10.0), "C": (10.0, 0.0),
           "D": (-10.0, 0.0)}


class TerminalViewer:
    """Blit RGB frames into the terminal and pump keyboard events.

    `out_fd` / `in_fd` default to stdout / stdin; pass explicit fds (e.g. a
    pty pair) for testing. Raises RuntimeError when the output is not a TTY
    unless `force=True` — "human" render mode must fail loudly headless.
    """

    def __init__(self, out_fd: int | None = None, in_fd: int | None = None,
                 fps: float = 30.0, max_cols: int = 0, force: bool = False):
        try:   # a captured/replaced stdout (pytest, pipes) has no fileno
            self.out_fd = sys.stdout.fileno() if out_fd is None else out_fd
            self.in_fd = sys.stdin.fileno() if in_fd is None else in_fd
        except (AttributeError, OSError, ValueError) as e:
            raise RuntimeError(
                "render_mode='human' needs a TTY to display in "
                f"(stdout has no usable file descriptor: {e}). Use "
                "render_mode='rgb_array' for headless frame capture.")
        if not force and not os.isatty(self.out_fd):
            raise RuntimeError(
                "render_mode='human' needs a TTY to display in (stdout is "
                "not a terminal). Use render_mode='rgb_array' for headless "
                "frame capture: human mode is an in-terminal viewer where no "
                "X display is available.")
        self.fps = fps
        self.max_cols = max_cols
        self._last_frame_t = 0.0
        self._raw_saved = None
        self._open = True
        # alternate screen + hidden cursor; restored by close()
        self._write(b"\x1b[?1049h\x1b[?25l")
        if os.isatty(self.in_fd):
            import termios
            import tty
            self._raw_saved = termios.tcgetattr(self.in_fd)
            tty.setcbreak(self.in_fd)

    # ------------------------------------------------------------------ io
    def _write(self, data: bytes):
        os.write(self.out_fd, data)

    def poll_keys(self) -> list[str]:
        """Drain pending keystrokes without blocking. Arrow keys are decoded
        to 'up'/'down'/'left'/'right'; everything else is the raw char."""
        keys = []
        buf = b""
        while True:
            rd, _, _ = select.select([self.in_fd], [], [], 0)
            if not rd:
                break
            chunk = os.read(self.in_fd, 64)
            if not chunk:
                break
            buf += chunk
        i = 0
        names = {"A": "up", "B": "down", "C": "right", "D": "left"}
        while i < len(buf):
            if buf[i:i + 2] == b"\x1b[" and i + 2 < len(buf) \
                    and chr(buf[i + 2]) in names:
                keys.append(names[chr(buf[i + 2])])
                i += 3
            else:
                keys.append(chr(buf[i]))
                i += 1
        return keys

    # ---------------------------------------------------------------- blit
    def _target_size(self, h: int, w: int) -> tuple[int, int]:
        """(rows_px, cols) fitting the terminal, preserving aspect ratio.
        One text row displays TWO pixel rows (half blocks)."""
        ts = shutil.get_terminal_size(fallback=(100, 40))
        cols = ts.columns if self.max_cols <= 0 else min(ts.columns,
                                                         self.max_cols)
        rows_px = max(2, (ts.lines - 1) * 2)
        scale = min(cols / w, rows_px / h)
        return max(2, int(h * scale)) & ~1, max(1, int(w * scale))

    def show(self, frame: np.ndarray):
        """Display one (H, W, 3) uint8 frame, pacing to `fps`."""
        if not self._open:
            return
        h, w = frame.shape[:2]
        th, tw = self._target_size(h, w)
        yi = (np.arange(th) * (h / th)).astype(np.int32)
        xi = (np.arange(tw) * (w / tw)).astype(np.int32)
        small = frame[yi][:, xi]                       # (th, tw, 3)
        top, bot = small[0::2], small[1::2]            # (th/2, tw, 3) each
        out = [b"\x1b[H"]
        for rt, rb in zip(top, bot):
            row = []
            last = None
            for (r1, g1, b1), (r2, g2, b2) in zip(rt, rb):
                sgr = (r1, g1, b1, r2, g2, b2)
                if sgr != last:   # run-length: only emit SGR on change
                    row.append(b"\x1b[38;2;%d;%d;%d;48;2;%d;%d;%dm" % sgr)
                    last = sgr
                row.append("▀".encode())
            row.append(b"\x1b[0m\x1b[K\n")
            out.append(b"".join(row))
        self._write(b"".join(out))
        if self.fps > 0:
            dt = 1.0 / self.fps - (time.monotonic() - self._last_frame_t)
            if dt > 0:
                time.sleep(dt)
        self._last_frame_t = time.monotonic()

    def close(self):
        if not self._open:
            return
        self._open = False
        if self._raw_saved is not None:
            import termios
            termios.tcsetattr(self.in_fd, termios.TCSADRAIN, self._raw_saved)
        self._write(b"\x1b[0m\x1b[?25h\x1b[?1049l")
