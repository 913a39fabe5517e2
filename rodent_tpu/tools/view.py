"""view: interactive progressive viewer (the driver.cpp GUI loop, terminal
form).

The reference driver opens an SDL2 window with mouse-look + arrow-key
camera movement and restarts progressive accumulation whenever the camera
moves (src/driver/driver.cpp:60-135, 279-325). Accelerator hosts have
no display server, so this viewer renders to the terminal instead:
each frame is drawn with ANSI truecolor half-block characters (two image
rows per character cell), and keys are read raw from the tty between
progressive iterations. Camera semantics match the reference exactly:

  rotate(yaw, pitch): dir rotated about right by -pitch then about up by
      -yaw, basis re-orthonormalized     (driver.cpp:41-47)
  move(x, y, z): eye += right*x + up*y + dir*z   (driver.cpp:49-51)
  any movement resets the accumulation iteration to 0
      (driver.cpp:98-112)
  +/- scale the movement speed by 1.1 / 0.9      (driver.cpp:113-114)

Controls: arrows = move (up/down along dir, left/right strafe; the
reference's arrow keys), w/s = pitch, a/d = yaw (the mouse-look analog),
+/- = speed, p = save PNG, q or ESC = quit.

Scriptable for tests and headless runs: --keys supplies a key sequence
consumed one per iteration (arrows spelled as U/D/L/R), --iters bounds
the loop; with --keys the tty is never touched.

Usage:
  python -m rodent_tpu.tools.view scene.obj --eye 0 1 2.7 --dir 0 0 -1
"""
from __future__ import annotations

import argparse
import shutil
import sys
import time
from functools import partial

import numpy as np


def rotate_about(v, axis, angle):
    """Rodrigues rotation of v about a unit axis (float3.h rotate)."""
    v = np.asarray(v, np.float64)
    axis = np.asarray(axis, np.float64)
    c, s = np.cos(angle), np.sin(angle)
    return v * c + np.cross(axis, v) * s + axis * np.dot(axis, v) * (1 - c)


class CameraRig:
    """Mutable eye/dir/right/up basis with the reference driver's
    rotate/move semantics (driver.cpp:24-51)."""

    def __init__(self, eye, dirv, up):
        self.eye = np.asarray(eye, np.float64)
        d = np.asarray(dirv, np.float64)
        self.dir = d / np.linalg.norm(d)
        r = np.cross(self.dir, np.asarray(up, np.float64))
        self.right = r / np.linalg.norm(r)
        u = np.cross(self.right, self.dir)
        self.up = u / np.linalg.norm(u)

    def rotate(self, yaw, pitch):
        d = rotate_about(self.dir, self.right, -pitch)
        d = rotate_about(d, self.up, -yaw)
        self.dir = d / np.linalg.norm(d)
        r = np.cross(self.dir, self.up)
        self.right = r / np.linalg.norm(r)
        u = np.cross(self.right, self.dir)
        self.up = u / np.linalg.norm(u)

    def move(self, x, y, z):
        self.eye = self.eye + self.right * x + self.up * y + self.dir * z


ROT_STEP = 0.05  # radians per keypress (mouse-look analog)


def apply_key(rig, key, tspeed):
    """One key event -> (moved, quit, save, tspeed). Key names: U/D/L/R
    are the arrow keys (move, driver.cpp:106-110), w/s/a/d rotate
    (mouse-look, driver.cpp:96-99), +/- speed, p save, q/ESC quit."""
    moved = save = quit_ = False
    if key in ("q", "\x1b"):
        quit_ = True
    elif key == "U":
        rig.move(0, 0, tspeed)
        moved = True
    elif key == "D":
        rig.move(0, 0, -tspeed)
        moved = True
    elif key == "L":
        rig.move(-tspeed, 0, 0)
        moved = True
    elif key == "R":
        rig.move(tspeed, 0, 0)
        moved = True
    elif key == "w":
        rig.rotate(0.0, -ROT_STEP)
        moved = True
    elif key == "s":
        rig.rotate(0.0, ROT_STEP)
        moved = True
    elif key == "a":
        rig.rotate(-ROT_STEP, 0.0)
        moved = True
    elif key == "d":
        rig.rotate(ROT_STEP, 0.0)
        moved = True
    elif key == "+":
        tspeed *= 1.1
    elif key == "-":
        tspeed *= 0.9
    elif key == "p":
        save = True
    return moved, quit_, save, tspeed


def ansi_frame(img):
    """uint8 (H, W, 3) image -> ANSI truecolor string, two image rows per
    text line via the upper-half-block glyph (fg = top row, bg = bottom).
    H is rounded down to even."""
    h = img.shape[0] & ~1
    lines = []
    for y in range(0, h, 2):
        top, bot = img[y], img[y + 1]
        cells = []
        for x in range(img.shape[1]):
            tr, tg, tb = (int(top[x, 0]), int(top[x, 1]), int(top[x, 2]))
            br, bg_, bb = (int(bot[x, 0]), int(bot[x, 1]), int(bot[x, 2]))
            cells.append(f"\x1b[38;2;{tr};{tg};{tb}m"
                         f"\x1b[48;2;{br};{bg_};{bb}m▀")
        lines.append("".join(cells) + "\x1b[0m")
    return "\n".join(lines)


class _TtyKeys:
    """Raw non-blocking tty key source; arrow escape sequences are decoded
    to U/D/L/R. Falls back to no keys when stdin is not a tty."""

    def __init__(self):
        self.enabled = sys.stdin.isatty()
        self._fd = None
        self._saved = None

    def __enter__(self):
        if self.enabled:
            import termios
            import tty
            self._fd = sys.stdin.fileno()
            self._saved = termios.tcgetattr(self._fd)
            tty.setcbreak(self._fd)
        return self

    def __exit__(self, *exc):
        if self._saved is not None:
            import termios
            termios.tcsetattr(self._fd, termios.TCSADRAIN, self._saved)

    def poll(self):
        """All pending keys (non-blocking)."""
        if not self.enabled:
            return []
        import select
        keys = []
        while select.select([sys.stdin], [], [], 0)[0]:
            ch = sys.stdin.read(1)
            if ch == "":
                # EOF (pty master closed): select keeps reporting readable
                # while read returns '' — translate to quit instead of
                # spinning at 100% CPU
                keys.append("q")
                self.enabled = False
                break
            if ch == "\x1b" and select.select([sys.stdin], [], [], 0)[0]:
                seq = sys.stdin.read(1)
                if seq == "[" and select.select([sys.stdin], [], [],
                                                0)[0]:
                    code = sys.stdin.read(1)
                    arrow = {"A": "U", "B": "D", "D": "L",
                             "C": "R"}.get(code)
                    if arrow:
                        keys.append(arrow)
                    continue
                continue
            keys.append(ch)
        return keys


def main(argv=None):
    p = argparse.ArgumentParser(prog="view")
    p.add_argument("scene")
    p.add_argument("--eye", type=float, nargs=3, default=(0.0, 0.0, 0.0))
    p.add_argument("--dir", type=float, nargs=3, default=(0.0, 0.0, 1.0))
    p.add_argument("--up", type=float, nargs=3, default=(0.0, 1.0, 0.0))
    p.add_argument("--fov", type=float, default=60.0)
    p.add_argument("--width", type=int, default=0,
                   help="render width (0: fit the terminal)")
    p.add_argument("--height", type=int, default=0)
    p.add_argument("--spp", type=int, default=1,
                   help="samples per progressive iteration")
    p.add_argument("--max-path-len", type=int, default=8)
    p.add_argument("--iters", type=int, default=0,
                   help="stop after N iterations (0 = until quit)")
    p.add_argument("--keys", default=None,
                   help="scripted key sequence (one per iteration; "
                        "U/D/L/R = arrows) instead of reading the tty")
    p.add_argument("-o", "--output", default="view.png",
                   help="PNG written by the p key / at exit")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--quiet", action="store_true",
                   help="suppress the ANSI frame output (tests)")
    args = p.parse_args(argv)

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from ..io import png
    from ..render import film as film_mod
    from ..render.camera import Camera
    from ..render.compiler import compile_obj, select_render_policy
    from ..render.integrator import render_iteration_persistent

    if args.width and args.height:
        W, H = args.width, args.height
    else:
        cols, rows = shutil.get_terminal_size((80, 24))
        W = args.width or min(cols, 160)
        H = args.height or max(2 * (rows - 2), 2) & ~1

    scene = compile_obj(args.scene, max_path_len=args.max_path_len)
    policy = select_render_policy(scene.device)
    rig = CameraRig(args.eye, args.dir, args.up)
    tspeed = 0.1

    scripted = list(args.keys) if args.keys is not None else None
    film = film_mod.new_film(W, H)
    iter_count = 0
    total = 0
    out = sys.stdout

    # The production render entry treats the camera as a STATIC jit
    # argument (scene-as-code: the converter bakes it into the program,
    # converter.cpp:654-661) — correct for offline renders, but an
    # interactive camera would recompile on every move. The viewer step
    # instead feeds the camera basis as dynamic arrays into the raw
    # (unjitted) iteration body; one compile serves every camera pose.
    raw_iteration = render_iteration_persistent.__wrapped__

    class _DynCam:
        """Attribute bag quacking like render.camera.Camera with traced
        fields (only eye/dir/right/up/w/h are read inside the step)."""

        def __init__(self, vals):
            self.eye = vals["eye"]
            self.dir = vals["dir"]
            self.right = vals["right"]
            self.up = vals["up"]
            self.w = vals["w"]
            self.h = vals["h"]

    @partial(jax.jit, static_argnames=("spp",), donate_argnames=("film",))
    def _step(device, cvals, film, spp, it):
        return raw_iteration(device, _DynCam(cvals), film, W, H, spp, it,
                             **policy)

    def render_one():
        nonlocal film, iter_count
        cam = Camera.make(tuple(rig.eye), tuple(rig.dir), tuple(rig.up),
                          args.fov, W, H)
        import jax.numpy as jnp
        cvals = {
            "eye": tuple(jnp.float32(v) for v in cam.eye),
            "dir": tuple(jnp.float32(v) for v in cam.dir),
            "right": tuple(jnp.float32(v) for v in cam.right),
            "up": tuple(jnp.float32(v) for v in cam.up),
            "w": jnp.float32(cam.w), "h": jnp.float32(cam.h),
        }
        film = _step(scene.device, cvals, film, args.spp, iter_count)
        iter_count += 1
        return film_mod.tonemap(film, W, H, iter_count)

    def save(img):
        png.write_png(args.output, img)

    with _TtyKeys() if scripted is None else _DummyCtx() as keysrc:
        while True:
            t0 = time.perf_counter()
            img = render_one()
            dt = time.perf_counter() - t0
            total += 1
            if not args.quiet:
                out.write("\x1b[H\x1b[2J" + ansi_frame(img) + "\n")
                out.write(f"iter {iter_count}  {W}x{H}  spp {args.spp}  "
                          f"{W * H * args.spp / dt / 1e6:.2f} Msamples/s  "
                          f"[arrows move, wasd look, +/- speed, p save, "
                          f"q quit]\n")
                out.flush()
            if scripted is not None:
                keys = [scripted.pop(0)] if scripted else []
            else:
                keys = keysrc.poll()
            stop = False
            for k in keys:
                moved, quit_, dosave, tspeed = apply_key(rig, k, tspeed)
                if dosave:
                    save(img)
                if moved:
                    film = film_mod.new_film(W, H)
                    iter_count = 0
                if quit_:
                    stop = True
            if stop or (args.iters and total >= args.iters):
                break
    if args.output:
        save(film_mod.tonemap(film, W, H, max(iter_count, 1)))
    return 0


class _DummyCtx:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def poll(self):
        return []


if __name__ == "__main__":
    sys.exit(main())
