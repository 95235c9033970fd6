#!/usr/bin/env python
"""Render a short hover trajectory of the PyTorch port to an animated GIF
with the native C++ software rasterizer (headless: no display). The port's
counterpart of examples/render_demo.py.

    python examples/torch_render_demo.py [--out hover.gif] [--steps 100] [--cpu]

The env steps on the CUDA card unless `--cpu` is given; the renderer reads
the state through host copies. `imageio` is imported only to write the GIF.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from heligym_tpu_torch.envs import HeliEnv, HoverTask  # noqa: E402
from heligym_tpu_torch.render import get_renderer  # noqa: E402


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="hover.gif")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--every", type=int, default=4)
    ap.add_argument("--size", type=int, default=480)
    ap.add_argument("--cpu", action="store_true", help="step the env on the CPU")
    return ap


def render_frames(steps: int = 100, every: int = 4, device=None, seed: int = 0):
    """Frames (H, W, 3) uint8 of every `every`-th step of a hover at the
    trim action, from the trim."""
    env = HeliEnv.build("aw109", task=HoverTask(), device=device)
    tr = env.trim_result()
    es, _ = env.reset_from_trim(tr)
    gen = torch.Generator(device=env.device).manual_seed(seed)
    renderer = get_renderer(env)
    frames = []
    action = tr.action.to(env.device)
    with torch.no_grad():
        for t in range(steps):
            es, _ = env.step(es, action, gen)
            if t % every == 0:
                frames.append(np.asarray(renderer.render(es)))
    renderer.close()
    return frames


def main(argv=None):
    args = build_parser().parse_args(argv)
    frames = render_frames(args.steps, args.every, "cpu" if args.cpu else None)
    import imageio.v2 as imageio
    imageio.mimsave(args.out, frames, duration=0.08, loop=0)
    print(f"wrote {args.out}: {len(frames)} frames {frames[0].shape}")
    return frames


if __name__ == "__main__":
    main()
